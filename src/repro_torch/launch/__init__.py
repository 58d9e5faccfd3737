"""Launchers of the port: ``serve`` (batched prefill and decode)."""
