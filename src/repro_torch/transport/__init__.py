"""Transport-level reference workloads (the port of ``repro.transport``)."""
