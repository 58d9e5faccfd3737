"""Plain PyTorch versions of the quant kernels (the port of
``repro.kernels.quant.ref``).

Each does the operations of its kernel in ``csrc/quant.cu``: the kernel
wrappers (``kernel.py``) run these for CPU tensors, and ``chip_smoke.py``
holds the kernels against them on the card.

The arithmetic is the JAX package's as XLA compiles it on the CPU (its
``quantize_flat`` is jitted): the constant divide ``max(absmax, 1e-30) /
127`` becomes a multiply by float32(1/127), so the scale is that multiply,
not an IEEE divide; ``x / scale`` stays an IEEE divide (by a tensor, IEEE on
every device). ``torch.round`` rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

from typing import Tuple

import torch

# float32(1/127), 0x3c010204: what XLA multiplies by for ``/ 127.0``
INV_127 = float.fromhex("0x1.020408p-7")


def quantize_blocks(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (NB, BLOCK) f32 -> (q (NB, BLOCK) int8, scale (NB, 1) f32):
    ``scale = max(absmax, 1e-30) * f32(1/127)``, ``q = clip(round(x / scale))``.
    A NaN in a block makes its scale NaN (its q is then undefined)."""
    absmax = x.abs().amax(dim=1, keepdim=True)
    scale = absmax.clamp_min(1e-30) * torch.tensor(INV_127, device=x.device)
    q = torch.round(x / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_blocks(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """q (NB, BLOCK) int8, scale (NB, 1) f32 -> (NB, BLOCK) f32: ``q * scale``."""
    return q.to(torch.float32) * scale
