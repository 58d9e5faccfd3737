"""GQA attention: the chunked full-sequence form and the single-token decode
form (the port of ``repro.models.attention``).

This is the ``attn_impl="xla"`` path, the plain attention: ``chunked_attention``
walks query chunks of ``q_chunk`` rows, so one chunk's score matrix is live
at a time. ``attn_impl="flash"`` replaces it with the flash kernel
(``repro_torch.kernels.flash_attention``, forward only), and
``chip_smoke.py`` holds the two against each other on the card. The JAX
package's ``use_scan`` form drives the same chunks with ``lax.scan`` and
gives the same values, with each chunk under ``jax.checkpoint``; the port
keeps the loop and, with ``recompute`` (``cfg.scan_attn_chunks``) while
gradients are recorded, runs each chunk under ``torch.utils.checkpoint``,
so the backward recomputes a chunk's scores instead of keeping them.

Scores and the products with V accumulate in float32, as the JAX einsums do
with ``preferred_element_type``: bfloat16 operands are widened to float32
(exactly) before the product, since a bfloat16 einsum here would round its
output to bfloat16.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_apply, dense_init

Tree = Dict[str, torch.Tensor]

NEG_INF = -1e30


def attn_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> Tree:
    return {
        "wq": dense_init(gen, cfg.d_model, cfg.q_dim, dtype, bias=cfg.qkv_bias),
        "wk": dense_init(gen, cfg.d_model, cfg.kv_dim, dtype, bias=cfg.qkv_bias),
        "wv": dense_init(gen, cfg.d_model, cfg.kv_dim, dtype, bias=cfg.qkv_bias),
        "wo": dense_init(gen, cfg.q_dim, cfg.d_model, dtype),
    }


def project_q(p: Tree, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    B, S, _ = x.shape
    return dense_apply(p["wq"], x).reshape(B, S, cfg.num_heads, cfg.head_dim)


def project_kv(p: Tree, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, _ = x.shape
    k = dense_apply(p["wk"], x).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = dense_apply(p["wv"], x).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    return k, v


def _grouped_scores(qc: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """qc: (B, Cq, Hkv, G, Dh), k: (B, Skv, Hkv, Dh) -> (B, Hkv, G, Cq, Skv) f32."""
    return torch.einsum("bqhgd,bkhd->bhgqk", qc.to(torch.float32), k.to(torch.float32))


def _grouped_out(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """w: (B, Hkv, G, Cq, Skv), v: (B, Skv, Hkv, Dh) -> (B, Cq, Hkv, G, Dh) f32."""
    return torch.einsum("bhgqk,bkhd->bqhgd", w.to(torch.float32), v.to(torch.float32))


def _attend_chunk(
    qc: torch.Tensor,  # (B, cq, Hkv, G, Dh)
    k: torch.Tensor,
    v: torch.Tensor,
    qpos: torch.Tensor,  # (cq,)
    *,
    causal: bool,
    window: int,
    scale: float,
) -> torch.Tensor:
    B, cq, Hkv, G, Dh = qc.shape
    Skv = k.shape[1]
    kpos = torch.arange(Skv, device=k.device)
    scores = _grouped_scores(qc, k) * scale  # f32 (B, Hkv, G, cq, Skv)
    # the additive f32 bias of the JAX package (masked entries -1e30, or
    # -2e30 where both masks hit)
    bias = torch.zeros((cq, Skv), dtype=torch.float32, device=k.device)
    if causal:
        bias += torch.where(kpos[None, :] <= qpos[:, None], 0.0, NEG_INF)
    if window:
        bias += torch.where(kpos[None, :] > qpos[:, None] - window, 0.0, NEG_INF)
    w = torch.softmax(scores + bias, dim=-1)
    # probabilities rounded to V's dtype before the product, as in the JAX
    # package (there so that a bf16 V is not upcast and materialized)
    out = _grouped_out(w.to(v.dtype), v)
    return out.reshape(B, cq, Hkv * G, Dh)


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    q_chunk: int = 1024,
    q_offset: int = 0,
    recompute: bool = False,
) -> torch.Tensor:
    """Masked attention, blocked over query chunks.

    q: (B, Sq, H, Dh); k, v: (B, Skv, Hkv, Dh). Returns (B, Sq, H, Dh) in q's
    dtype. ``window > 0`` keeps the last ``window`` positions (sliding-window
    attention). ``recompute`` (the JAX package's ``use_scan``: same values)
    recomputes each chunk in the backward when gradients are recorded.
    """
    B, Sq, H, Dh = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    scale = Dh**-0.5
    chunk = min(q_chunk, Sq)
    recompute = recompute and torch.is_grad_enabled()

    def attend(qc, k, v, qpos):
        return _attend_chunk(qc, k, v, qpos, causal=causal, window=window,
                             scale=scale).to(q.dtype)

    outs = []
    for lo in range(0, Sq, chunk):
        cq = min(chunk, Sq - lo)
        qc = q[:, lo:lo + cq].reshape(B, cq, Hkv, G, Dh)
        qpos = q_offset + lo + torch.arange(cq, device=q.device)
        outs.append(checkpoint(attend, qc, k, v, qpos, use_reentrant=False) if recompute
                    else attend(qc, k, v, qpos))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    *,
    cache_len: torch.Tensor,
    window: int = 0,
) -> torch.Tensor:
    """One-token attention against a KV cache.

    q: (B, 1, H, Dh); caches: (B, S, Hkv, Dh); cache_len: () or (B,), the
    number of valid cache positions (the new token's k/v already written).
    """
    B, _, H, Dh = q.shape
    Skv, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    scale = Dh**-0.5
    qc = q.reshape(B, 1, Hkv, G, Dh)
    scores = _grouped_scores(qc, k_cache) * scale  # (B, Hkv, G, 1, Skv)
    kpos = torch.arange(Skv, device=q.device)
    cache_len = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    valid = kpos[None, :] < cache_len  # (B or 1, Skv)
    if window:
        valid &= kpos[None, :] >= cache_len - window
    scores = torch.where(valid[:, None, None, None, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = _grouped_out(w, v_cache)
    return out.reshape(B, 1, H, Dh).to(q.dtype)


def attn_output(p: Tree, out: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    B, S = out.shape[:2]
    return dense_apply(p["wo"], out.reshape(B, S, cfg.q_dim))
