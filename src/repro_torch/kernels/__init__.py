"""Kernels written by hand for Hopper, each beside its plain PyTorch version.

* ``agg``   — the aggregation fold (order-exact and fused weighted sum);
* ``quant`` — blockwise int8 quantize / dequantize (the ``int8_blocks`` codec);
* ``build`` — the shared nvcc build and ``ctypes`` load, and what every
  wrapper does around a launch (device checks, stream, launch counts).
"""
