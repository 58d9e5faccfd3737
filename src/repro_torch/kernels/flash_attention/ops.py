"""Flash attention on the model's (B, S, H, D) layout (the port of
``repro.kernels.flash_attention.ops``).

The JAX wrapper moves the head axis forward and pads both sequences to tile
multiples on the host before its kernel. Here the wrapper of ``kernel.py``
reads the (B, S, H, D) tensors through their strides and the kernels mask
the ragged edges themselves, so no copy is made: CPU tensors go to the plain
version, CUDA tensors to one of the two kernels (by dtype and head dim), or
the call raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_bhsd


def flash_attention(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, Skv, Hkv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """(B, Sq, H, D) in q's dtype. ``block_q`` and ``block_k`` are accepted
    for parity with the JAX package's signature only: the CUDA kernels fix
    their own tiles and the plain version has none, so they change nothing
    and are only checked to be positive."""
    if block_q <= 0 or block_k <= 0:
        raise ValueError(f"block sizes must be positive, got {block_q} and {block_k}")
    out = flash_attention_bhsd(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window,
    )
    return out.transpose(1, 2)
