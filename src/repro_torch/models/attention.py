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

Under a model group (``launch.tensor_parallel``) whose size divides the
query heads, each rank computes its block of heads: ``wq`` column-parallel
over whole heads, ``wo`` row-parallel with its output summed over the
group. Each rank's query heads read the KV heads the GQA map gives them:
its own block of ``wk`` / ``wv`` where the KV heads divide the group, else
the whole leaves (gathered at use where the rule cut them into part-heads)
and the heads sliced out; where its query heads straddle KV heads (12
query and 3 KV heads at 2 ranks), each query head gets its KV head, so the
rank attends as MHA. Where the group does not divide the query heads
(Hymba's 25), attention computes replicated on whole, gathered leaves: at
Hymba's published widths it is the one part of the layer that does (its
SSD runs on the rank's slice of every head's P, its MLP on its blocks,
``models.blocks``), and each decode step reads its K/V cache, cut on the
sequence (5 KV heads), whole. A KV
cache is stored by ``launch.sharding.cache_pspec``: its block of heads
where the KV heads divide the group, else its block of the sequence
(written by position, read whole through a gather) or whole.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.launch import tensor_parallel as tp
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_apply, dense_init, keep_whole

Tree = Dict[str, torch.Tensor]

NEG_INF = -1e30


def attn_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
              keep: Callable = keep_whole) -> Tree:
    return {
        "wq": keep(("wq",), dense_init(gen, cfg.d_model, cfg.q_dim, dtype, bias=cfg.qkv_bias)),
        "wk": keep(("wk",), dense_init(gen, cfg.d_model, cfg.kv_dim, dtype, bias=cfg.qkv_bias)),
        "wv": keep(("wv",), dense_init(gen, cfg.d_model, cfg.kv_dim, dtype, bias=cfg.qkv_bias)),
        "wo": keep(("wo",), dense_init(gen, cfg.q_dim, cfg.d_model, dtype)),
    }


@dataclasses.dataclass(frozen=True)
class HeadSplit:
    """The query heads a rank computes and the KV heads they read."""

    split: bool  # the query heads are split over the group
    n_q: int  # the rank's query heads
    kv_lo: int  # the first KV head they read
    n_kv: int  # the KV heads they read
    kv_whole: bool  # K/V are projected for every KV head (then sliced)
    # where the rank's query heads straddle KV heads (its groups are not
    # whole): the KV head, from kv_lo, that each of its query heads reads
    kv_of_q: Optional[Tuple[int, ...]] = None


def head_split(cfg: ModelConfig) -> HeadSplit:
    """The rank's heads under the running group (all of them without one).
    A rank whose query heads straddle KV heads reads KV heads ``q_lo // G``
    through ``(q_lo + n_q - 1) // G``, each query head its own."""
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    group = tp.current_group()
    if group is None or H % group.size:
        return HeadSplit(False, H, 0, Hkv, group is not None)
    n_q = H // group.size
    q_lo, G = group.rank * n_q, H // Hkv
    kv_lo = q_lo // G
    n_kv = (q_lo + n_q - 1) // G + 1 - kv_lo
    kv_of_q = None
    if n_q % G and G % n_q:  # neither whole groups nor inside one
        kv_of_q = tuple((q_lo + i) // G - kv_lo for i in range(n_q))
    return HeadSplit(True, n_q, kv_lo, n_kv, Hkv % group.size != 0, kv_of_q)


def rank_weights(p: Tree, cfg: ModelConfig, hs: HeadSplit) -> Tree:
    """The attention leaves as the rank computes with them: its own blocks
    where they match its heads; whole leaves (gathered at use where the
    rule cut them) where they do not. A whole leaf inside a split
    computation passes ``copy_to_group``, so its gradient sums the ranks'."""
    if tp.current_group() is None:
        return p
    out = dict(p)

    def whole(name, dim_of, full, split):
        leaf = {k: tp.gather_at_use(x, dim_of(k), full) for k, x in p[name].items()}
        out[name] = {k: tp.copy_to_group(x) for k, x in leaf.items()} if split else leaf

    if hs.kv_whole:
        for name in ("wk", "wv"):
            whole(name, lambda k: -1, cfg.kv_dim, hs.split)
    if not hs.split:
        whole("wq", lambda k: -1, cfg.q_dim, False)
        whole("wo", lambda k: 0, cfg.q_dim, False)
    return out


def enter(x: torch.Tensor, hs: HeadSplit) -> torch.Tensor:
    """The replicated input of a head-split attention (f)."""
    return tp.copy_to_group(x) if hs.split else x


def kv_heads(k: torch.Tensor, hs: HeadSplit) -> torch.Tensor:
    """The KV heads the rank's query heads read, from K/V of whole heads;
    where they straddle KV heads, one KV head a query head (the attention
    and the flash kernels take whole groups only)."""
    k = k if k.shape[2] == hs.n_kv else k[:, :, hs.kv_lo:hs.kv_lo + hs.n_kv]
    if hs.kv_of_q is None:
        return k
    return k.index_select(2, torch.tensor(hs.kv_of_q, device=k.device))


def project_q(p: Tree, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    B, S, _ = x.shape
    return dense_apply(p["wq"], x).reshape(B, S, -1, cfg.head_dim)


def project_kv(p: Tree, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, _ = x.shape
    k = dense_apply(p["wk"], x).reshape(B, S, -1, cfg.head_dim)
    v = dense_apply(p["wv"], x).reshape(B, S, -1, cfg.head_dim)
    return k, v


# --------------------------------------------------------------------- #
# KV caches stored by the sharding rule
# --------------------------------------------------------------------- #
def _seq_block(leaf: torch.Tensor, W: int) -> int:
    """The first position of a cache leaf's block of the sequence (0 when
    the leaf holds every position)."""
    if not tp.is_block(leaf.shape[1], W):
        return 0
    return tp.current_group().rank * leaf.shape[1]


def cache_fill(leaf: torch.Tensor, src: torch.Tensor, W: int) -> None:
    """Write ``src`` (B, n, Hkv, Dh), the values of slots [0, n) of a cache
    of ``W`` slots, into the rank's block of it."""
    lo = _seq_block(leaf, W)
    n = max(0, min(leaf.shape[1], src.shape[1] - lo))
    if n == leaf.shape[1] and n == src.shape[1]:
        leaf.copy_(src)
    elif n:
        leaf[:, :n] = src[:, lo:lo + n]


def cache_write_slot(leaf: torch.Tensor, slot: torch.Tensor, x: torch.Tensor, W: int) -> None:
    """Write ``x`` (B, 1, Hkv, Dh) at ``slot`` (a (1,) device tensor) of a
    cache of ``W`` slots, where the rank's block holds that slot."""
    if not tp.is_block(leaf.shape[1], W):
        leaf.index_copy_(1, slot, x)
        return
    local = slot - _seq_block(leaf, W)
    inside = (local >= 0) & (local < leaf.shape[1])
    idx = torch.clamp(local, 0, leaf.shape[1] - 1)
    leaf.index_copy_(1, idx, torch.where(inside, x, leaf.index_select(1, idx)))


def cache_read(leaf: torch.Tensor, W: int) -> torch.Tensor:
    """The cache's every slot: the rank's leaf, or the ranks' blocks of the
    sequence gathered."""
    return tp.gather_block(leaf, 1) if tp.is_block(leaf.shape[1], W) else leaf


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
        outs.append(tp.checkpoint(attend, qc, k, v, qpos) if recompute
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


def attn_output(p: Tree, out: torch.Tensor, cfg: ModelConfig,
                hs: HeadSplit = None) -> torch.Tensor:
    """``wo`` of the heads' outputs; summed over the group where the heads
    are split (row-parallel)."""
    B, S = out.shape[:2]
    y = dense_apply(p["wo"], out.reshape(B, S, -1))
    return tp.reduce_from_group(y) if hs is not None and hs.split else y
