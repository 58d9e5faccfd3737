"""Plain PyTorch version of the flash-attention kernel (the port of
``repro.kernels.flash_attention.ref``).

It computes what ``csrc/flash.cu`` computes, the straightforward way: upcast
to float32, the grouped product times ``D**-0.5``, the causal, window and
padding masks at -1e30, a softmax over the whole row, the product with V,
and the output in q's dtype. The kernel wrapper (``kernel.py``) runs it for
CPU tensors, and ``chip_smoke.py`` holds the kernel against it on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def reference_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Skv, Hkv, D)
    v: torch.Tensor,  # (B, Skv, Hkv, D)
    *,
    causal: bool = True,
    window: int = 0,
    kv_len: int = 0,
) -> torch.Tensor:
    """Masked GQA attention on the model's (B, S, H, D) layout: q head ``h``
    reads kv head ``h // (H / Hkv)``. Keys at ``kpos >= kv_len`` are masked
    (``kv_len`` 0: none); ``causal`` keeps ``kpos <= qpos``; ``window > 0``
    keeps ``kpos > qpos - window``."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qf = q.to(torch.float32).reshape(B, Sq, Hkv, G, D)
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * (D**-0.5)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if kv_len:
        mask &= kpos < kv_len
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    scores = torch.where(mask, scores, torch.tensor(NEG_INF, device=q.device))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, vf)
    return out.reshape(B, Sq, H, D).to(q.dtype)
