"""Mixture-of-Experts layer: top-k routing with per-block capacity,
scatter dispatch, batched expert products (the port of
``repro.models.moe``).

Tokens are cut into routing blocks (``route_blocks``; the sharding
profile's ``min_blocks`` takes part, ``models.shard_ctx``), and each block
routes on its own: top-k experts per token, the weights renormalised, each
slot's rank within its expert from a running count of the one-hot expert
ids, slots past the capacity ``C`` dropped. Kept slots are added into a
dense buffer of ``C`` rows per expert and block; dropped slots add zeros
into row 0 of expert 0, which only an adding scatter keeps exact.

The JAX package keeps the buffer block-major, (nb, E, C, d); the port keeps
it expert-major, (E, nb, C, d), so each expert product is one batched
matmul over the experts, ``(E, nb·C, d) @ (E, d, ff)``, with the same
per-row sums. The products accumulate in float32 and keep float32 where
the JAX package's ``preferred_element_type`` does: the gate and up
products stay float32 until ``h`` is cast to the buffer's dtype; the down
product rounds once to it. The expert FFN's backward is written out
(``_ExpertFFN``): it recomputes the activations from the inputs, as the
JAX package's custom VJP does, and keeps nothing else.

Router aux loss: the load-balancing loss ``E * sum_e f_e * P_e`` per block
(f the routed-token fraction, P the mean router probability), averaged over
the blocks.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _normal, dense_init, mlp_apply, mlp_init
from repro_torch.models.shard_ctx import get_profile

Tree = Dict[str, torch.Tensor]

ROUTE_BLOCK = 2048  # tokens per routing block (capacity enforced per block)


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> Tree:
    """A float32 router, the experts' stacked weights (E, d, ff) x2 and
    (E, ff, d), and the shared expert where the config has one."""
    d, ff, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    p: Tree = {
        "router": dense_init(gen, d, E, torch.float32),  # router math stays f32
        "gate": _normal(gen, (E, d, ff)).to(dtype) * d**-0.5,
        "up": _normal(gen, (E, d, ff)).to(dtype) * d**-0.5,
        "down": _normal(gen, (E, ff, d)).to(dtype) * ff**-0.5,
    }
    if cfg.shared_expert:
        p["shared"] = mlp_init(gen, d, cfg.d_ff, dtype)
    return p


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    cap = int(cfg.capacity_factor * n_tokens * cfg.experts_per_token / cfg.num_experts)
    # round the expert batch up to a multiple of 8
    return max(8, -(-cap // 8) * 8)


def route_blocks(n_tokens: int) -> int:
    """The number of routing blocks of ``n_tokens`` tokens: a multiple of
    the active profile's ``min_blocks`` where the tokens allow one, about
    ``ROUTE_BLOCK`` tokens each, dividing ``n_tokens``."""
    prof = get_profile()
    min_blocks = prof["min_blocks"] if prof else 1
    if n_tokens % min_blocks == 0 and n_tokens // min_blocks >= 8:
        nb = min_blocks * max(1, n_tokens // (ROUTE_BLOCK * min_blocks))
    else:
        nb = max(1, n_tokens // ROUTE_BLOCK)
    while n_tokens % nb:
        nb -= 1
    return nb


def router_probs(p: Tree, x: torch.Tensor) -> torch.Tensor:
    """x: (..., d) -> (..., E) softmax router probabilities (float32)."""
    logits = torch.matmul(x.to(torch.float32), p["router"]["w"])
    return torch.softmax(logits, dim=-1)


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, ties to the
    lower index (a stable descending sort; ``torch.topk`` promises no tie
    order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(p: Tree, xb: torch.Tensor, cfg: ModelConfig, C: int):
    """Route every block of xb (nb, N, d): the expert-major buffer
    (E, nb, C, d) and the combine metadata (expert ids, ranks, slot
    weights, each (nb, N·k), and the per-block aux loss (nb,))."""
    nb, N, d = xb.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    probs = router_probs(p, xb)  # (nb, N, E)
    top_w, top_e = _top_k(probs, k)  # (nb, N, k)
    top_w = top_w / torch.clamp(torch.sum(top_w, dim=-1, keepdim=True), min=1e-9)

    oh = F.one_hot(top_e, E).to(torch.int32)  # (nb, N, k, E)
    frac = torch.mean(torch.sum(oh, dim=2).to(torch.float32), dim=1) / k  # (nb, E)
    aux = E * torch.sum(frac * torch.mean(probs, dim=1), dim=-1)  # (nb,)

    # rank of each slot within its expert: the running count of earlier
    # same-expert slots in the block
    ids = top_e.reshape(nb, N * k)
    cum = torch.cumsum(oh.reshape(nb, N * k, E), dim=1, dtype=torch.int32)
    rank = torch.gather(cum, 2, ids[..., None])[..., 0] - 1
    del oh, cum
    keep = rank < C
    safe_rank = torch.where(keep, rank, 0).to(torch.long)
    safe_ids = torch.where(keep, ids, 0)

    xf_rep = torch.repeat_interleave(xb, k, dim=1)  # (nb, N·k, d): slot -> token
    contrib = torch.where(keep[..., None], xf_rep, torch.zeros((), dtype=xb.dtype,
                                                                 device=xb.device))
    del xf_rep
    blk = torch.arange(nb, device=xb.device)[:, None].expand(nb, N * k)
    buf = torch.zeros((E, nb, C, d), dtype=xb.dtype, device=xb.device).index_put(
        (safe_ids, blk, safe_rank), contrib, accumulate=True)
    w_flat = (top_w.reshape(nb, N * k) * keep).to(torch.float32)
    return buf, (safe_ids, safe_rank, w_flat, aux)


def _combine(out: torch.Tensor, meta, k: int, dtype: torch.dtype) -> torch.Tensor:
    """Each token's output: its slots' expert rows (zero weight where
    dropped), weighted and summed in float32, cast to ``dtype``.
    out: (E, nb, C, d) -> (nb, N, d)."""
    safe_ids, safe_rank, w_flat, _ = meta
    nb, M = safe_ids.shape
    blk = torch.arange(nb, device=out.device)[:, None].expand(nb, M)
    gathered = out[safe_ids, blk, safe_rank]  # (nb, N·k, d)
    y = torch.einsum("bnkd,bnk->bnd", gathered.view(nb, M // k, k, -1).to(torch.float32),
                     w_flat.view(nb, M // k, k))
    return y.to(dtype)


def _bmm(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """``a @ b`` batched over the experts, accumulated in float32 and
    rounded once to ``out_dtype``: one cuBLAS call on the card; on the CPU a
    bfloat16 product is computed in float32."""
    if a.is_cuda:
        if out_dtype == a.dtype:
            return torch.bmm(a, b)
        return torch.bmm(a, b, out_dtype=out_dtype)
    return torch.bmm(a.to(torch.float32), b.to(torch.float32)).to(out_dtype)


def _expert_ffn_bwd(buf, gate, up, down, gbar):
    """The JAX package's ``_expert_ffn_bwd``: the activations recomputed in
    float32, every gradient product in float32, cast to its input's dtype."""
    f32 = torch.float32
    gbar = gbar.to(f32)
    g = _bmm(buf, gate, f32)
    u = _bmm(buf, up, f32)
    sg = torch.sigmoid(g)
    silu_g = g * sg
    h = silu_g * u
    d_down = torch.bmm(h.transpose(1, 2), gbar)  # (E, ff, d)
    d_h = torch.bmm(gbar, down.to(f32).transpose(1, 2))  # (E, R, ff)
    d_u = d_h * silu_g
    d_g = d_h * u * (sg + silu_g * (1.0 - sg))
    bf = buf.to(f32).transpose(1, 2)
    d_gate = torch.bmm(bf, d_g)
    d_up = torch.bmm(bf, d_u)
    d_buf = torch.bmm(d_g, gate.to(f32).transpose(1, 2))
    d_buf = d_buf + torch.bmm(d_u, up.to(f32).transpose(1, 2))
    return (d_buf.to(buf.dtype), d_gate.to(gate.dtype), d_up.to(up.dtype),
            d_down.to(down.dtype))


class _ExpertFFN(torch.autograd.Function):
    """The experts' gated FFN on the expert-major buffer (E, R, d), with the
    JAX package's hand-written backward (recompute, no stash)."""

    @staticmethod
    def forward(ctx, buf, gate, up, down):
        ctx.save_for_backward(buf, gate, up, down)
        g = _bmm(buf, gate, torch.float32)
        u = _bmm(buf, up, torch.float32)
        h = F.silu(g, inplace=True).mul_(u).to(buf.dtype)
        del g, u
        return _bmm(h, down, buf.dtype)

    @staticmethod
    def backward(ctx, gbar):
        return _expert_ffn_bwd(*ctx.saved_tensors, gbar)


def expert_ffn(buf: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
               down: torch.Tensor) -> torch.Tensor:
    """buf (E, R, d) -> (E, R, d) in buf's dtype."""
    return _ExpertFFN.apply(buf, gate, up, down)


def moe_apply(p: Tree, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y: (B, S, d), aux_loss: 0-d float32)."""
    B, S, d = x.shape
    N = B * S
    E, k = cfg.num_experts, cfg.experts_per_token
    nb = route_blocks(N)
    block = N // nb
    C = _capacity(block, cfg)
    buf, meta = _route(p, x.reshape(nb, block, d), cfg, C)
    out = expert_ffn(buf.view(E, nb * C, d), p["gate"], p["up"], p["down"])
    del buf
    y = _combine(out.view(E, nb, C, d), meta, k, x.dtype).reshape(B, S, d)
    if cfg.shared_expert:
        y = y + mlp_apply(p["shared"], x, cfg.activation)
    return y, torch.mean(meta[3])
