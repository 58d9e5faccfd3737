"""Kernels written by hand for Hopper, each beside its plain PyTorch version.

* ``agg`` — the aggregation fold (order-exact and fused weighted sum).
"""
