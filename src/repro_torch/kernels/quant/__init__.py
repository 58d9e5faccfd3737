"""Blockwise int8 quantize / dequantize: CUDA kernels (``kernel``), their
plain versions (``ref``) and the flat/tree layer (``ops``)."""
