"""Federated datasets and the batching pipeline (the port of ``repro.data``)."""
