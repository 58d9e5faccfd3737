"""Weighted multi-client aggregation: CUDA kernels (``kernel``), their plain
versions (``ref``) and the tree layer (``ops``)."""
