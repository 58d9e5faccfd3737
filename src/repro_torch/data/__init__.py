"""Federated datasets (the port of ``repro.data``)."""
