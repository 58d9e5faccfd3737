"""The model stack of the port (dense kind): config, layers, attention,
blocks, transformer and the ``ModelBundle`` API."""
