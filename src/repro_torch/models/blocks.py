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

Kinds:

``dense``  pre-norm GQA attention + gated MLP
``moe``    attention + the expert MLP of ``models.moe`` (its router's aux
           loss is the block's aux loss)
``hymba``  parallel attention heads + SSD (Mamba-2) heads, each path
           normed and the two averaged, then the MLP
``mlstm``  matrix-memory LSTM block: the SSD sub-block at expand 2
``slstm``  scalar-memory LSTM block (``ssd.slstm_scan``)

The recurrent kinds' caches hold float32 state (``ssd``: ``(B, H, N, P)``;
``slstm``: ``c``, ``n``, ``m`` of ``(B, d)``), written in place like the
attention caches.

Under a model group (``launch.tensor_parallel``) attention splits by heads
(``models.attention``), the MLP and the MoE experts by their blocks, and
the recurrent sub-blocks by their value columns where the group divides
them (``launch.sharding.recurrent_split``): the SSD on the rank's slice of
every head's P (v, z, the state's P and ``out``'s rows; q, k and the
decays whole), the sLSTM on its slice of d (each gate's columns, the
``c``/``n``/``m`` state and ``out``'s rows), each finished by ``out``
row-parallel, its partial sums added over the group. The state is the
rank's block of the cache, read and written in place: it is never whole.
Where the group does not divide them, the sub-block computes replicated on
its leaves gathered at use (its state then is whole on every rank).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.launch import sharding as shd
from repro_torch.launch import tensor_parallel as tp
from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    apply_mrope,
    apply_rope,
    dense_apply,
    dense_init,
    keep_below,
    keep_whole,
    mlp_apply,
    mlp_init,
    rmsnorm_apply,
    rmsnorm_init,
)
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.models.ssd import slstm_scan, softplus, ssd_chunked, ssd_decode_step

Tree = Dict[str, torch.Tensor]


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
    hs = attn.head_split(cfg)
    p = attn.rank_weights(p, cfg, hs)
    h = attn.enter(h, hs)
    q = attn.project_q(p, h, cfg)
    k, v = attn.project_kv(p, h, cfg)
    q = _rotate(q, positions, cfg)
    k = _rotate(k, positions, cfg)
    ka, va = attn.kv_heads(k, hs), attn.kv_heads(v, hs)
    if cfg.attn_impl == "flash":
        out = flash_attention(q, ka, va, causal=True, window=cfg.sliding_window)
    else:
        out = attn.chunked_attention(
            q, ka, va, causal=True, window=cfg.sliding_window, q_chunk=cfg.q_chunk,
            recompute=cfg.scan_attn_chunks)
    new_cache = None
    if cache is not None:
        S = h.shape[1]
        W = cache["pos"].shape[0]
        tpos = _text_positions(positions, cfg)
        if W >= S:
            attn.cache_fill(cache["k"], k, W)
            attn.cache_fill(cache["v"], v, W)
            cache["pos"][:S] = tpos[0]
        else:  # ring buffer smaller than the prefill: keep the last W,
            # position p at slot p mod W, where a decode step writes it
            # (the JAX package keeps them at slots 0..W-1: ROADMAP fault n)
            r = S % W
            attn.cache_fill(cache["k"], torch.roll(k[:, -W:], r, dims=1), W)
            attn.cache_fill(cache["v"], torch.roll(v[:, -W:], r, dims=1), W)
            cache["pos"].copy_(torch.roll(tpos[0, -W:], r))
        new_cache = {"k": cache["k"], "v": cache["v"], "pos": cache["pos"]}
    return attn.attn_output(p, out, cfg, hs), new_cache


def _attn_core_decode(
    p: Tree,
    h: torch.Tensor,
    positions: torch.Tensor,
    cache: Tree,
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, Tree]:
    """One-token attention against the (ring) cache. h: (B, 1, d)."""
    hs = attn.head_split(cfg)
    p = attn.rank_weights(p, cfg, hs)
    h = attn.enter(h, hs)
    q = attn.project_q(p, h, cfg)
    k, v = attn.project_kv(p, h, cfg)
    q = _rotate(q, positions, cfg)
    k = _rotate(k, positions, cfg)
    tpos = _text_positions(positions, cfg)
    cur = tpos[0, :1].to(torch.int32)  # absolute position of the new token, (1,)
    k_cache, v_cache, pos = cache["k"], cache["v"], cache["pos"]
    W = pos.shape[0]
    # the slot as a device tensor: the step never waits for the card
    slot = torch.remainder(cur, W).to(torch.long)
    attn.cache_write_slot(k_cache, slot, k, W)
    attn.cache_write_slot(v_cache, slot, v, W)
    pos.index_copy_(0, slot, cur)
    # mask: slots holding positions in (cur - window, cur] (ring semantics)
    valid = (pos >= 0) & (pos <= cur)
    if cfg.sliding_window:
        valid &= pos > cur - cfg.sliding_window
    scale = cfg.head_dim**-0.5
    B = h.shape[0]
    kc = attn.kv_heads(attn.cache_read(k_cache, W), hs)
    vc = attn.kv_heads(attn.cache_read(v_cache, W), hs)
    qc = q.reshape(B, 1, kc.shape[2], hs.n_q // kc.shape[2], -1)
    scores = attn._grouped_scores(qc, kc) * scale  # (B, Hkv, G, 1, W) f32
    scores = torch.where(valid[None, None, None, None, :], scores, attn.NEG_INF)
    w = torch.softmax(scores, dim=-1)
    # probabilities in the value dtype before the product, as in the JAX package
    out = attn._grouped_out(w.to(vc.dtype), vc)
    out = out.reshape(B, 1, -1).to(h.dtype)
    return attn.attn_output(p, out, cfg, hs), {"k": k_cache, "v": v_cache, "pos": pos}


# ===================================================================== #
# SSD (Mamba-2) sub-block: hymba's parallel SSM path and the mlstm block
# ===================================================================== #
def ssd_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
             keep: Callable = keep_whole) -> Tree:
    d = cfg.d_model
    d_i, H, N = cfg.ssd_dims
    dev = gen.device
    return {
        "in_xz": keep(("in_xz",), dense_init(gen, d, 2 * d_i, dtype)),  # value path + gate z
        # k (B) and q (C), per head
        "in_bc": keep(("in_bc",), dense_init(gen, d, 2 * H * N, dtype)),
        "in_dt": keep(("in_dt",), dense_init(gen, d, H, dtype)),
        "a_log": keep(("a_log",), torch.zeros((H,), dtype=torch.float32, device=dev)),
        "d_skip": keep(("d_skip",), torch.ones((H,), dtype=torch.float32, device=dev)),
        "out": keep(("out",), dense_init(gen, d_i, d, dtype)),
    }


def ssd_state_init(cfg: ModelConfig, batch: int, device: torch.device) -> Tree:
    d_i, H, N = cfg.ssd_dims
    return {"state": torch.zeros((batch, H, N, d_i // H), dtype=torch.float32, device=device)}


def _split(cfg: ModelConfig, kind: str) -> bool:
    """Whether the running group splits the recurrent sub-block ``kind``
    into its slices (``sharding.recurrent_split``): each rank then holds
    its blocks of the leaves cut in groups and of the state, and computes
    its slice; else the sub-block computes replicated."""
    group = tp.current_group()
    return group is not None and shd.recurrent_split(cfg, kind, group.size)


def _ssd_weights(p: Tree, cfg: ModelConfig, split: bool) -> Tree:
    """The SSD leaves as the rank computes with them. Split: its own blocks
    of ``in_xz`` (its slice of every head's value and gate columns) and
    ``out`` (the same rows); ``in_bc`` and ``in_dt`` whole (gathered at use
    where the rule cut them), they, ``a_log`` and ``d_skip`` entering the
    split computation through ``copy_to_group`` (each rank's gradient of
    them is its slice's share: summed over the group). Not split: every
    leaf whole (gathered at use where the rule cut it)."""
    d_i, H, N = cfg.ssd_dims
    small = {"in_bc": {"w": tp.gather_at_use(p["in_bc"]["w"], 1, 2 * H * N)},
             "in_dt": {"w": tp.gather_at_use(p["in_dt"]["w"], 1, H)}}
    if not split:
        return dict(p, **small, in_xz={"w": tp.gather_at_use(p["in_xz"]["w"], 1, 2 * d_i)},
                    out={"w": tp.gather_at_use(p["out"]["w"], 0, d_i)})
    small = {name: {"w": tp.copy_to_group(leaf["w"])} for name, leaf in small.items()}
    return dict(p, **small, a_log=tp.copy_to_group(p["a_log"]),
                d_skip=tp.copy_to_group(p["d_skip"]))


def _ssd_project(p: Tree, h: torch.Tensor, cfg: ModelConfig):
    """The projections of h: v and z of the leaves' value columns (the
    rank's slice where ``in_xz`` is its block), q, k and the decays of
    every head."""
    B, S, _ = h.shape
    d_i, H, N = cfg.ssd_dims
    xv, z = torch.chunk(dense_apply(p["in_xz"], h), 2, dim=-1)  # (B, S, H * P) each
    # (B, S, H, 2N) before the split: k and q interleave per head
    kk, qq = torch.chunk(dense_apply(p["in_bc"], h).reshape(B, S, H, 2 * N), 2, dim=-1)
    dt = softplus(dense_apply(p["in_dt"], h).to(torch.float32))  # (B, S, H) > 0
    a = -torch.exp(p["a_log"])  # (H,) < 0
    log_decay = a * dt  # (B, S, H) < 0
    v = xv.reshape(B, S, H, -1)
    return qq, kk, v, log_decay, dt, z, xv


def _ssd_output(p: Tree, y: torch.Tensor, xv: torch.Tensor, z: torch.Tensor,
                split: bool) -> torch.Tensor:
    """The skip term and the gate on y (..., H, P), in y's dtype, then
    ``out`` (row-parallel where split: the ranks' partial sums added)."""
    H, P = y.shape[-2:]
    y = y + xv.reshape(y.shape) * p["d_skip"][:, None].to(y.dtype)
    y = y.reshape(*y.shape[:-2], H * P) * torch.nn.functional.silu(z.to(torch.float32)).to(y.dtype)
    y = dense_apply(p["out"], y)
    return tp.reduce_from_group(y) if split else y


def _ssd_enter(p: Tree, h: torch.Tensor, cfg: ModelConfig):
    """(split, the leaves as the rank computes with them, the projections
    of h): a split sub-block takes h through ``copy_to_group``."""
    split = _split(cfg, "ssd")
    p = _ssd_weights(p, cfg, split)
    return split, p, _ssd_project(p, tp.copy_to_group(h) if split else h, cfg)


def ssd_apply_full(p: Tree, h: torch.Tensor, cache: Optional[Tree],
                   cfg: ModelConfig) -> Tuple[torch.Tensor, Optional[Tree]]:
    split, p, (qq, kk, v, log_decay, dt, z, xv) = _ssd_enter(p, h, cfg)
    init = cache["state"] if cache is not None else None
    y, final = ssd_chunked(qq, kk, v, log_decay, dt, chunk=cfg.ssd_chunk, initial_state=init)
    out = _ssd_output(p, y, xv, z, split)
    if cache is None:
        return out, None
    cache["state"].copy_(final)
    return out, {"state": cache["state"]}


def ssd_apply_decode(p: Tree, h: torch.Tensor, cache: Tree,
                     cfg: ModelConfig) -> Tuple[torch.Tensor, Tree]:
    split, p, (qq, kk, v, log_decay, dt, z, xv) = _ssd_enter(p, h, cfg)
    y, new_state = ssd_decode_step(cache["state"], qq[:, 0], kk[:, 0], v[:, 0],
                                   log_decay[:, 0], dt[:, 0])
    out = _ssd_output(p, y[:, None], xv, z, split)
    cache["state"].copy_(new_state)
    return out, {"state": cache["state"]}


# ===================================================================== #
# block kinds
# ===================================================================== #
def block_init(gen: torch.Generator, cfg: ModelConfig, kind: str, dtype: torch.dtype,
               keep: Callable = keep_whole) -> Tree:
    """A block's parameters, each part passed to ``keep`` as it is drawn
    (``layers.keep_below``)."""
    d = cfg.d_model
    dev = gen.device

    def norm(name):
        return keep((name,), rmsnorm_init(d, dtype, dev))

    if kind in ("dense", "moe"):
        p = {
            "ln1": norm("ln1"),
            "attn": attn.attn_init(gen, cfg, dtype, keep_below(keep, "attn")),
            "ln2": norm("ln2"),
        }
        if kind == "moe":
            p["moe"] = moe_init(gen, cfg, dtype, keep_below(keep, "moe"))
        else:
            p["mlp"] = mlp_init(gen, d, cfg.d_ff, dtype, keep_below(keep, "mlp"))
        return p
    if kind == "hymba":
        return {
            "ln1": norm("ln1"),
            "attn": attn.attn_init(gen, cfg, dtype, keep_below(keep, "attn")),
            "ssd": ssd_init(gen, cfg, dtype, keep_below(keep, "ssd")),
            "ln_attn": norm("ln_attn"),
            "ln_ssm": norm("ln_ssm"),
            "ln2": norm("ln2"),
            "mlp": mlp_init(gen, d, cfg.d_ff, dtype, keep_below(keep, "mlp")),
        }
    if kind == "mlstm":
        return {"ln1": norm("ln1"), "ssd": ssd_init(gen, cfg, dtype, keep_below(keep, "ssd"))}
    if kind == "slstm":
        return {
            "ln1": norm("ln1"),
            "gates": keep(("gates",), dense_init(gen, d, 4 * d, dtype)),
            "out": keep(("out",), dense_init(gen, d, d, dtype)),
        }
    raise ValueError(f"unknown block kind {kind!r}")


def block_cache_init(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     dtype: torch.dtype, device: torch.device) -> Tree:
    if kind in ("dense", "moe"):
        return {"attn": attn_cache_init(cfg, batch, max_len, dtype, device)}
    if kind == "hymba":
        return {
            "attn": attn_cache_init(cfg, batch, max_len, dtype, device),
            "ssd": ssd_state_init(cfg, batch, device),
        }
    if kind == "mlstm":
        return {"ssd": ssd_state_init(cfg, batch, device)}
    if kind == "slstm":
        shape = (batch, cfg.d_model)
        return {"c": torch.zeros(shape, dtype=torch.float32, device=device),
                "n": torch.zeros(shape, dtype=torch.float32, device=device),
                "m": torch.full(shape, -1e30, dtype=torch.float32, device=device)}
    raise ValueError(f"unknown block kind {kind!r}")


def _attention(p: Tree, h: torch.Tensor, positions: torch.Tensor, cache: Optional[Tree],
               decode: bool, cfg: ModelConfig) -> Tuple[torch.Tensor, Optional[Tree]]:
    if decode:
        return _attn_core_decode(p, h, positions, cache, cfg)
    return _attn_core_full(p, h, positions, cache, cfg)


def block_apply(
    p: Tree,
    x: torch.Tensor,
    positions: torch.Tensor,
    cache: Optional[Tree],
    mode: str,
    cfg: ModelConfig,
    kind: str,
) -> Tuple[torch.Tensor, Optional[Tree], torch.Tensor]:
    """Returns (y, new_cache, aux_loss); the aux loss is a moe block's
    router load-balancing loss, 0 for the other kinds."""
    decode = mode == "decode"
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache: Optional[Tree] = dict(cache) if cache is not None else None
    sub = (lambda name: cache[name] if cache else None)

    if kind in ("dense", "moe"):
        h = rmsnorm_apply(p["ln1"], x, cfg.norm_eps)
        a, ac = _attention(p["attn"], h, positions, sub("attn"), decode, cfg)
        if new_cache is not None:
            new_cache["attn"] = ac
        x = x + a
        h = rmsnorm_apply(p["ln2"], x, cfg.norm_eps)
        if kind == "moe":
            m, aux = moe_apply(p["moe"], h, cfg)
        else:
            m = mlp_apply(p["mlp"], h, cfg.activation, cfg.d_ff)
        return x + m, new_cache, aux

    if kind == "hymba":
        h = rmsnorm_apply(p["ln1"], x, cfg.norm_eps)
        a, ac = _attention(p["attn"], h, positions, sub("attn"), decode, cfg)
        if decode:
            s, sc = ssd_apply_decode(p["ssd"], h, cache["ssd"], cfg)
        else:
            s, sc = ssd_apply_full(p["ssd"], h, sub("ssd"), cfg)
        if new_cache is not None:
            new_cache["attn"], new_cache["ssd"] = ac, sc
        # per-path output norm, averaged fusion (in the model's dtype)
        fused = 0.5 * (rmsnorm_apply(p["ln_attn"], a, cfg.norm_eps)
                       + rmsnorm_apply(p["ln_ssm"], s, cfg.norm_eps))
        x = x + fused
        h = rmsnorm_apply(p["ln2"], x, cfg.norm_eps)
        return x + mlp_apply(p["mlp"], h, cfg.activation, cfg.d_ff), new_cache, aux

    if kind == "mlstm":
        h = rmsnorm_apply(p["ln1"], x, cfg.norm_eps)
        if decode:
            s, sc = ssd_apply_decode(p["ssd"], h, cache["ssd"], cfg)
        else:
            s, sc = ssd_apply_full(p["ssd"], h, sub("ssd"), cfg)
        if new_cache is not None:
            new_cache["ssd"] = sc
        return x + s, new_cache, aux

    if kind == "slstm":
        # split: the rank's slice of d (its block of each gate's columns,
        # of the state and of out's rows), out's partial sums added; else
        # replicated, on leaves gathered at use
        d = cfg.d_model
        split = _split(cfg, "slstm")
        h = rmsnorm_apply(p["ln1"], x, cfg.norm_eps)
        if split:
            gates, out, h = p["gates"], p["out"], tp.copy_to_group(h)
        else:
            gates = {"w": tp.gather_at_use(p["gates"]["w"], 1, 4 * d)}
            out = {"w": tp.gather_at_use(p["out"]["w"], 0, d)}
        i_g, f_g, z_g, o_g = torch.chunk(dense_apply(gates, h), 4, dim=-1)
        init = (cache["c"], cache["n"], cache["m"]) if cache else None
        hs, carry = slstm_scan(i_g, f_g, z_g, o_g, initial=init)
        if cache is not None:
            for name, value in zip(("c", "n", "m"), carry):
                cache[name].copy_(value)
            new_cache = {"c": cache["c"], "n": cache["n"], "m": cache["m"]}
        y = dense_apply(out, hs)
        return x + (tp.reduce_from_group(y) if split else y), new_cache, aux

    raise ValueError(f"unknown block kind {kind!r}")


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
