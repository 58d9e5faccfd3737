"""Int8 channel-payload compression for flat buffers and trees (the port of
``repro.kernels.quant.ops``).

Dispatch is by device: every call goes through the wrappers of
``kernel.py``, which launch the CUDA kernels for CUDA tensors and run the
plain versions for CPU tensors. Both give the bits of the JAX package's
jitted ``quantize_flat`` on the CPU (see ``ref.py`` for its scale).
"""
from __future__ import annotations

from typing import Any, List, Tuple

import torch

from repro_torch.core.tree import tree_flatten, tree_unflatten
from repro_torch.kernels.quant import kernel
from repro_torch.kernels.quant.kernel import BLOCK


def quantize_flat(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: flat (N,) -> (q (NB, BLOCK) int8, scale (NB, 1) f32), the tail
    block padded with zeros."""
    n = x.shape[0]
    pad = (-n) % BLOCK
    if pad == 0 and x.dtype == torch.float32 and x.is_contiguous():
        xp = x  # already whole blocks: no copy
    else:
        xp = torch.cat([x.to(torch.float32), x.new_zeros(pad, dtype=torch.float32)])
    return kernel.quantize_blocks(xp.view(-1, BLOCK))


def dequantize_flat(q: torch.Tensor, scale: torch.Tensor, n: int) -> torch.Tensor:
    """The first ``n`` values of the dequantized blocks, as a flat view."""
    return kernel.dequantize_blocks(q, scale).view(-1)[:n]


def compress_tree(tree: Any) -> Tuple[dict, Tuple[Any, List[Tuple[torch.Size, torch.dtype]], int]]:
    """tree of tensors -> (``{"q", "scale"}``, spec for ``decompress_tree``)."""
    leaves, treedef = tree_flatten(tree)
    flat = torch.cat([leaf.reshape(-1).to(torch.float32) for leaf in leaves])
    q, s = quantize_flat(flat)
    spec = (treedef, [(leaf.shape, leaf.dtype) for leaf in leaves], flat.shape[0])
    return {"q": q, "scale": s}, spec


def decompress_tree(payload: dict, spec: Tuple[Any, list, int]) -> Any:
    treedef, shapes, n = spec
    flat = dequantize_flat(payload["q"], payload["scale"], n)
    out, offset = [], 0
    for shape, dtype in shapes:
        size = 1
        for d in shape:
            size *= d
        out.append(flat[offset:offset + size].reshape(shape).to(dtype))
        offset += size
    return tree_unflatten(treedef, out)
