"""Channel payload compression (the port of ``repro.fl.compression``).

The socket-path consumers live in ``repro_torch.transport.wire``: the
``int8`` codec builds on ``quantize_int8``, the ``topk<frac>`` codec on
``topk_sparsify``/``topk_densify``, and ``int8_blocks`` on the blockwise
kernels of ``repro_torch.kernels.quant``. Everything runs on the input's
device.
"""
from __future__ import annotations

from typing import Tuple

import torch


def quantize_int8(x: torch.Tensor,
                  whole: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization. Returns (q, 0-d scale).

    Both divides are by tensors (IEEE on every device). ``whole=False``:
    ``x`` is a model rank's block of the tensor, and the scale is the whole
    tensor's (the blocks' absmax, maxed over the group)."""
    xf = x.to(torch.float32)
    absmax = xf.abs().amax()
    if not whole:
        from repro_torch.launch import tensor_parallel as tp

        absmax = tp.all_reduce_max(absmax)
    one = torch.ones((), dtype=torch.float32, device=x.device)
    scale = torch.where(absmax > 0, absmax / torch.tensor(127.0, device=x.device), one)
    q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def topk_sparsify(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep the k largest-magnitude entries of a flattened tensor.

    Returns (values, flat int64 indices), largest magnitude first and, among
    equal magnitudes, lower index first: ``jax.lax.top_k``'s order, from a
    stable descending sort (``torch.topk`` promises no order among ties)."""
    flat = x.reshape(-1)
    k = min(int(k), flat.shape[0])
    order = torch.sort(flat.abs(), descending=True, stable=True).indices[:k]
    return flat[order], order


def topk_densify(values: torch.Tensor, idx: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    size = 1
    for s in shape:
        size *= s
    out = torch.zeros((size,), dtype=values.dtype, device=values.device)
    out[idx.to(torch.int64)] = values
    return out.reshape(shape)


def compression_ratio(shape: Tuple[int, ...], k: int, index_bytes: int = 4) -> float:
    """Wire-bytes ratio of top-k vs dense f32 (for bandwidth accounting)."""
    size = 1
    for s in shape:
        size *= s
    dense = 4 * size
    sparse = k * (4 + index_bytes)
    return sparse / dense
