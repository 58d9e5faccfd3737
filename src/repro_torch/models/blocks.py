"""Transformer blocks with a uniform (init, apply) interface (the port of
``repro.models.blocks``, dense kind).

``block_apply(p, x, positions, cache, mode, cfg, kind)`` returns
``(y, new_cache, aux)``:

* mode ``"full"``: causal self-attention over the whole sequence (prefill).
  If ``cache`` is not None it is filled and returned.
* mode ``"decode"``: x is (B, 1, d); the per-layer cache holds the KV ring
  buffer and the absolute position of each slot.

Attention caches are ring buffers of ``window`` slots when the config uses
sliding-window attention, else full-length buffers. Keys are rotated (RoPE)
at write time at their absolute position, so decode never re-rotates the
cache. The cache is updated in place (the JAX package's serve step donates
it, so XLA does the same): the returned tree has the JAX package's
structure and values, and its tensors are the ones passed in.

Only the ``dense`` kind is ported. ``moe``, ``hymba``, ``mlstm`` and
``slstm`` raise ``NotImplementedError`` (ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    apply_mrope,
    apply_rope,
    dense_apply,
    mlp_apply,
    mlp_init,
    rmsnorm_apply,
    rmsnorm_init,
)

Tree = Dict[str, torch.Tensor]


def _not_ported(kind: str) -> NotImplementedError:
    return NotImplementedError(
        f"block kind {kind!r} is not ported yet: only 'dense' is "
        "(ROADMAP Queue 1 item 8)")


# ===================================================================== #
# attention sub-block
# ===================================================================== #
def _rotate(x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.rope_type == "mrope":
        return apply_mrope(x, positions, cfg.mrope_sections, cfg.rope_theta)
    if cfg.rope_type == "rope":
        return apply_rope(x, positions, cfg.rope_theta)
    return x


def _text_positions(positions: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The scalar position stream used for masking (mrope: temporal)."""
    return positions[0] if cfg.rope_type == "mrope" else positions


def attn_cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype: torch.dtype,
                    device: torch.device) -> Tree:
    window = cfg.sliding_window
    W = min(window, max_len) if window else max_len
    shape = (batch, W, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((W,), -1, dtype=torch.int32, device=device),
    }


def _attn_core_full(
    p: Tree,
    h: torch.Tensor,
    positions: torch.Tensor,
    cache: Optional[Tree],
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, Optional[Tree]]:
    """Full-sequence causal attention; optionally fills the cache (prefill)."""
    q = attn.project_q(p, h, cfg)
    k, v = attn.project_kv(p, h, cfg)
    q = _rotate(q, positions, cfg)
    k = _rotate(k, positions, cfg)
    if cfg.attn_impl == "flash":
        out = flash_attention(q, k, v, causal=True, window=cfg.sliding_window)
    else:
        out = attn.chunked_attention(
            q, k, v, causal=True, window=cfg.sliding_window, q_chunk=cfg.q_chunk,
            recompute=cfg.scan_attn_chunks)
    new_cache = None
    if cache is not None:
        S = h.shape[1]
        W = cache["k"].shape[1]
        tpos = _text_positions(positions, cfg)
        if W >= S:
            cache["k"][:, :S] = k
            cache["v"][:, :S] = v
            cache["pos"][:S] = tpos[0]
        else:  # ring buffer smaller than the prefill: keep the last W
            cache["k"].copy_(k[:, -W:])
            cache["v"].copy_(v[:, -W:])
            cache["pos"].copy_(tpos[0, -W:])
        new_cache = {"k": cache["k"], "v": cache["v"], "pos": cache["pos"]}
    return attn.attn_output(p, out, cfg), new_cache


def _attn_core_decode(
    p: Tree,
    h: torch.Tensor,
    positions: torch.Tensor,
    cache: Tree,
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, Tree]:
    """One-token attention against the (ring) cache. h: (B, 1, d)."""
    q = attn.project_q(p, h, cfg)
    k, v = attn.project_kv(p, h, cfg)
    q = _rotate(q, positions, cfg)
    k = _rotate(k, positions, cfg)
    tpos = _text_positions(positions, cfg)
    cur = tpos[0, :1].to(torch.int32)  # absolute position of the new token, (1,)
    k_cache, v_cache, pos = cache["k"], cache["v"], cache["pos"]
    # the slot as a device tensor: the step never waits for the card
    slot = torch.remainder(cur, k_cache.shape[1]).to(torch.long)
    k_cache.index_copy_(1, slot, k)
    v_cache.index_copy_(1, slot, v)
    pos.index_copy_(0, slot, cur)
    # mask: slots holding positions in (cur - window, cur] (ring semantics)
    valid = (pos >= 0) & (pos <= cur)
    if cfg.sliding_window:
        valid &= pos > cur - cfg.sliding_window
    scale = cfg.head_dim**-0.5
    B = h.shape[0]
    qc = q.reshape(B, 1, cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, -1)
    scores = attn._grouped_scores(qc, k_cache) * scale  # (B, Hkv, G, 1, W) f32
    scores = torch.where(valid[None, None, None, None, :], scores, attn.NEG_INF)
    w = torch.softmax(scores, dim=-1)
    # probabilities in the value dtype before the product, as in the JAX package
    out = attn._grouped_out(w.to(v_cache.dtype), v_cache)
    out = out.reshape(B, 1, cfg.q_dim).to(h.dtype)
    return dense_apply(p["wo"], out), {"k": k_cache, "v": v_cache, "pos": pos}


# ===================================================================== #
# block kinds
# ===================================================================== #
def block_init(gen: torch.Generator, cfg: ModelConfig, kind: str, dtype: torch.dtype) -> Tree:
    if kind != "dense":
        raise _not_ported(kind)
    d = cfg.d_model
    return {
        "ln1": rmsnorm_init(d, dtype, gen.device),
        "attn": attn.attn_init(gen, cfg, dtype),
        "ln2": rmsnorm_init(d, dtype, gen.device),
        "mlp": mlp_init(gen, d, cfg.d_ff, dtype),
    }


def block_cache_init(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     dtype: torch.dtype, device: torch.device) -> Tree:
    if kind != "dense":
        raise _not_ported(kind)
    return {"attn": attn_cache_init(cfg, batch, max_len, dtype, device)}


def block_apply(
    p: Tree,
    x: torch.Tensor,
    positions: torch.Tensor,
    cache: Optional[Tree],
    mode: str,
    cfg: ModelConfig,
    kind: str,
) -> Tuple[torch.Tensor, Optional[Tree], torch.Tensor]:
    """Returns (y, new_cache, aux_loss); a dense block's aux loss is 0."""
    if kind != "dense":
        raise _not_ported(kind)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache: Optional[Tree] = dict(cache) if cache is not None else None
    h = rmsnorm_apply(p["ln1"], x, cfg.norm_eps)
    if mode == "decode":
        a, ac = _attn_core_decode(p["attn"], h, positions, cache["attn"], cfg)
    else:
        a, ac = _attn_core_full(p["attn"], h, positions, cache["attn"] if cache else None, cfg)
    if new_cache is not None:
        new_cache["attn"] = ac
    x = x + a
    h = rmsnorm_apply(p["ln2"], x, cfg.norm_eps)
    return x + mlp_apply(p["mlp"], h, cfg.activation), new_cache, aux


def layer_kinds(cfg: ModelConfig) -> Tuple[str, ...]:
    """The repeating pattern of block kinds (one period of the layer stack)."""
    if cfg.family == "ssm":
        period = cfg.slstm_every or 1
        kinds = ["mlstm"] * period
        if cfg.slstm_every:
            kinds[-1] = "slstm"
        return tuple(kinds)
    if cfg.family == "hybrid":
        return ("hymba",)
    if cfg.is_moe:
        if cfg.moe_every > 1:
            pattern = ["dense"] * cfg.moe_every
            pattern[-1] = "moe"
            return tuple(pattern)
        return ("moe",)
    return ("dense",)
