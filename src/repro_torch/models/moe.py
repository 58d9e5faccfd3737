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

On a grid whose batch rows are split over client ranks
(``tensor_parallel.row_share``), the routing blocks are the one-process
run's on the global token count: a rank with N/D of the N tokens routes
its nb/D whole blocks where D divides nb, each with the capacity of the
one-process block; where nb divides D, each block spans D/nb ranks, and a
slot's rank within its expert adds the slots of the block's earlier ranks
(their per-expert counts, all-reduced over the rows). The aux loss a rank
returns is its share: the ranks' shares sum to the mean over all nb blocks.

Under a model group (``launch.tensor_parallel``) whose size divides the
experts, each rank holds a block of them (``(E/m, d, ff)``). The router is
replicated: every rank routes every token alike. Each rank dispatches the
full token set to its own experts only, runs them, and combines their rows
in float32; the ranks' combines are summed over the group, then rounded
once. The dispatch input and the combine weights pass ``copy_to_group``,
so their gradients, partial on each rank, are summed. A shared expert
splits as the MLP does. Where the group does not divide the experts, they
compute replicated.

On a grid whose ``data`` axis holds FSDP's blocks, the expert leaves stay
the rank's blocks (``(E/m, d/D, ff)``, ``(E/m, ff/D, d)``) until the
expert FFN uses them: it gathers one leaf over ``data`` and takes its
product before it gathers the next (``_ExpertFFN``), in slices of its
experts where three whole leaves would take more than ``GATHER_SHARE`` of
the rank's memory share. Where they fit, a training forward keeps them
for the backward, as gathering the layer at once did; where they do not,
each is freed after its product and the backward gathers it again, slice
by slice, each leaf's gradient summed over the rows and cut to the block.
A Llama4 expert leaf is 5.37 GB whole a rank in bfloat16 (the rank's
experts over ``model``): four grid ranks on one 80 GB card gather it in
four slices of 16 experts, so a rank holds 1.34 GB of expert leaves whole
where gathering a layer at once held 16.1.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.launch import tensor_parallel as tp
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (_normal, dense_init, keep_below, keep_whole, mlp_apply,
                                       mlp_init)
from repro_torch.models.shard_ctx import constrain, get_profile

Tree = Dict[str, torch.Tensor]

ROUTE_BLOCK = 2048  # tokens per routing block (capacity enforced per block)


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
             keep: Callable = keep_whole) -> Tree:
    """A float32 router, the experts' stacked weights (E, d, ff) x2 and
    (E, ff, d), and the shared expert where the config has one. Each
    expert leaf's float32 draw is passed to ``keep`` before the cast and
    the scale, which act on each element alone: a rank casts its block
    only, and holds one leaf's draw whole at a time (Llama4's 21.5 GB)."""
    d, ff, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    p: Tree = {
        # router math stays f32
        "router": keep(("router",), dense_init(gen, d, E, torch.float32)),
        "gate": keep(("gate",), _normal(gen, (E, d, ff))).to(dtype) * d**-0.5,
        "up": keep(("up",), _normal(gen, (E, d, ff))).to(dtype) * d**-0.5,
        "down": keep(("down",), _normal(gen, (E, ff, d))).to(dtype) * ff**-0.5,
    }
    if cfg.shared_expert:
        p["shared"] = mlp_init(gen, d, cfg.d_ff, dtype, keep_below(keep, "shared"))
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


def _straddle(counts: torch.Tensor, span: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """A block spread over ``span`` consecutive client ranks, this rank's
    per-expert slot counts ``counts`` (1, E): the slots of the block's
    earlier ranks and of the whole block, each (1, E), from one all-reduce
    of every rank's counts over the rows group."""
    me, ranks = tp.row_share()
    every = torch.zeros((ranks,) + tuple(counts.shape[1:]), dtype=counts.dtype,
                        device=counts.device)
    every[me] = counts[0]
    every = tp.rows_sum(every)
    first = me - me % span
    return (torch.sum(every[first:me], dim=0, keepdim=True),
            torch.sum(every[first:first + span], dim=0, keepdim=True))


def _route(p: Tree, xb: torch.Tensor, cfg: ModelConfig, C: int,
           experts: Optional[Tuple[int, int]] = None, rows: Optional[torch.Tensor] = None,
           span: int = 1):
    """Route every block of xb (nb, N, d): the expert-major buffer
    (E, nb, C, d) and the combine metadata (expert ids, ranks, slot
    weights, each (nb, N·k), and the per-block aux loss (nb,)).
    ``experts`` = (lo, n) keeps the buffer of experts [lo, lo + n) only:
    the other experts' slots take zero weight and add zeros into row 0.
    ``rows`` (xb's values) are the rows scattered, when not xb itself.
    ``span`` > 1: xb is this rank's part of one block spread over that many
    client ranks (``_straddle``); its aux is the rank's share of the
    block's."""
    nb, N, d = xb.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    probs = router_probs(p, xb)  # (nb, N, E)
    top_w, top_e = _top_k(probs, k)  # (nb, N, k)
    top_w = top_w / torch.clamp(torch.sum(top_w, dim=-1, keepdim=True), min=1e-9)

    oh = F.one_hot(top_e, E).to(torch.int32)  # (nb, N, k, E)
    ids = top_e.reshape(nb, N * k)
    cum = torch.cumsum(oh.reshape(nb, N * k, E), dim=1, dtype=torch.int32)
    if span == 1:
        frac = torch.mean(torch.sum(oh, dim=2).to(torch.float32), dim=1) / k  # (nb, E)
        aux = E * torch.sum(frac * torch.mean(probs, dim=1), dim=-1)  # (nb,)
    else:
        before, total = _straddle(cum[:, -1], span)
        cum = cum + before[:, None, :]
        n_block = N * span
        frac = total.to(torch.float32) / (n_block * k)
        aux = E * torch.sum(frac * (torch.sum(probs, dim=1) / n_block), dim=-1)

    # rank of each slot within its expert: the running count of earlier
    # same-expert slots in the block
    rank = torch.gather(cum, 2, ids[..., None])[..., 0] - 1
    del oh, cum
    keep = rank < C
    w_flat = (top_w.reshape(nb, N * k) * keep).to(torch.float32)
    lo, n_e = experts or (0, E)
    if n_e != E:  # this rank's experts only
        keep = keep & (ids >= lo) & (ids < lo + n_e)
    safe_rank = torch.where(keep, rank, 0).to(torch.long)
    safe_ids = torch.where(keep, ids - lo, 0)

    xf_rep = torch.repeat_interleave(xb if rows is None else rows, k, dim=1)  # slot -> token
    contrib = torch.where(keep[..., None], xf_rep, torch.zeros((), dtype=xb.dtype,
                                                                 device=xb.device))
    del xf_rep
    blk = torch.arange(nb, device=xb.device)[:, None].expand(nb, N * k)
    buf = torch.zeros((n_e, nb, C, d), dtype=xb.dtype, device=xb.device).index_put(
        (safe_ids, blk, safe_rank), contrib, accumulate=True)
    if n_e != E:
        # the slot weights pass f before the mask of this rank's experts:
        # the router's gradient then sums every rank's slots
        w_flat = tp.copy_to_group(w_flat) * keep
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


EXPERT_LEAVES = ("gate", "up", "down")
# the part of a rank's memory share (``tp.ModelGroup.memory_share``) that
# the expert leaves it gathers may take at once: three whole leaves, kept
# from the forward for the backward, or else one slice of experts of each
GATHER_SHARE = 0.25


def gathered_at_use(path: Tuple[Any, ...]) -> bool:
    """Whether the leaf at ``path`` of a layer is an expert leaf, which the
    expert FFN gathers over ``data`` itself as it uses it
    (``transformer.data_whole`` gathers every other split leaf as the layer
    begins). The MLP's ``gate`` / ``up`` / ``down`` are dicts, not leaves."""
    return bool(path) and path[-1] in EXPERT_LEAVES


def _at_use(x: torch.Tensor, full: int) -> torch.Tensor:
    """An expert leaf whole along dim 1 (``full`` long): itself where it
    is, else its ``data`` block gathered (``tp.gather_data``, looked up as
    the module's attribute at each call)."""
    return x if x.shape[1] == full else tp.gather_data(x, 1)


def _experts_at_once(gate: torch.Tensor, d: int, group) -> int:
    """How many experts the FFN takes at a time: all of them where the
    leaves are whole, the group sets no bound or three whole leaves fit in
    ``GATHER_SHARE`` of the rank's memory share, else the most whose three
    leaves' slices fit, dividing the experts. Each expert's rows are its
    own products, so slices change no row's sums (on a card shared by the
    four ranks of a grid, Llama4's 5.37 GB leaf a rank goes in four slices
    of 16 experts; Qwen3-MoE's 1.61 GB float32 leaf whole)."""
    E = gate.shape[0]
    if gate.shape[1] == d or group is None or group.memory_share is None:
        return E
    three = 3 * gate.numel() * gate.element_size() * d // gate.shape[1]
    budget = GATHER_SHARE * group.memory_share
    return max((n for n in range(1, E + 1) if E % n == 0 and three * n <= budget * E), default=1)


def _expert_ffn_fwd(buf, gate, up, down, kept: Optional[list] = None) -> torch.Tensor:
    """The FFN's forward on experts whose leaves are gathered at use, each
    freed after its product, or appended to ``kept`` for the backward."""
    d, ff = buf.shape[-1], gate.shape[-1]

    def use(x, full):
        w = _at_use(x, full)
        if kept is not None:
            kept.append(w)
        return w

    g = _bmm(buf, use(gate, d), torch.float32)
    u = _bmm(buf, use(up, d), torch.float32)
    h = F.silu(g, inplace=True).mul_(u).to(buf.dtype)
    del g, u
    return _bmm(h, use(down, ff), buf.dtype)


def _block_grad(g: torch.Tensor, x: torch.Tensor, group) -> torch.Tensor:
    """The gradient of ``x`` from its whole leaf's float32 gradient ``g``,
    cast to x's dtype: where ``x`` is a ``data`` block, summed over the
    rows in that dtype and cut to the block, as ``tp.gather_data``'s
    backward does."""
    g = g.to(x.dtype)
    return g if g.shape == x.shape else tp.data_block_grad(g, 1, group)


def _expert_ffn_bwd(buf, gate, up, down, gbar, group=None, whole=None):
    """The JAX package's ``_expert_ffn_bwd``: the activations recomputed in
    float32, every gradient product in float32, cast to its input's dtype.
    ``whole``: the leaves whole, kept by the forward; else leaves that are
    ``data`` blocks are gathered again as each product needs them, one at
    a time (down, up, gate, then up again). Their gradients are summed
    over the rows and cut to the block (``group``: the forward's). The
    products and sums are those of the whole leaves."""
    f32 = torch.float32
    d, ff = buf.shape[-1], gate.shape[-1]

    def leaf(i, full):
        return whole[i] if whole else _at_use((gate, up, down)[i], full)

    gbar = gbar.to(f32)
    d_h = torch.bmm(gbar, leaf(2, ff).to(f32).transpose(1, 2))  # (E, R, ff)
    u = _bmm(buf, leaf(1, d), f32)
    g_w = leaf(0, d)
    g = _bmm(buf, g_w, f32)
    sg = torch.sigmoid(g)
    silu_g = g * sg
    del g
    d_g = d_h * u * (sg + silu_g * (1.0 - sg))
    d_buf = torch.bmm(d_g, g_w.to(f32).transpose(1, 2))
    del g_w, sg
    bf = buf.to(f32).transpose(1, 2)
    d_gate = _block_grad(torch.bmm(bf, d_g), gate, group)
    del d_g
    d_down = _block_grad(torch.bmm((silu_g * u).transpose(1, 2), gbar), down, group)  # (E, ff, d)
    del u
    d_u = d_h * silu_g
    del d_h, silu_g
    d_up = _block_grad(torch.bmm(bf, d_u), up, group)
    d_buf = d_buf + torch.bmm(d_u, leaf(1, d).to(f32).transpose(1, 2))
    return d_buf.to(buf.dtype), d_gate, d_up, d_down


def _joined(parts: list) -> tuple:
    """The experts' slices' results, each joined along the experts."""
    return parts[0] if len(parts) == 1 else tuple(torch.cat(p) for p in zip(*parts))


class _ExpertFFN(torch.autograd.Function):
    """The experts' gated FFN on the expert-major buffer (E, R, d), with the
    JAX package's hand-written backward (recompute, no stash). Expert
    leaves that are ``data`` blocks (an FSDP grid) are gathered one at a
    time, each freed after its product, in slices of experts
    (``_experts_at_once``). Where the experts go at once, a forward that
    needs a backward keeps the three whole leaves for it; else the
    backward gathers them again, slice by slice. So a rank holds at most
    three whole expert leaves, and those only where they fit its share."""

    @staticmethod
    def forward(ctx, buf, gate, up, down, grad: bool):
        # the backward may run on autograd's device thread, outside the
        # forward's group context
        ctx.group = tp.data_group()
        E = gate.shape[0]
        n = _experts_at_once(gate, buf.shape[-1], ctx.group)
        gathered = gate.shape[1] != buf.shape[-1]
        kept = [] if gathered and n == E and grad and any(ctx.needs_input_grad) else None
        ctx.n = n
        outs = [_expert_ffn_fwd(buf[lo:lo + n], gate[lo:lo + n], up[lo:lo + n], down[lo:lo + n],
                                kept) for lo in range(0, E, n)]
        ctx.save_for_backward(buf, gate, up, down, *(kept or ()))
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    @staticmethod
    def backward(ctx, gbar):
        buf, gate, up, down, *whole = ctx.saved_tensors
        n = ctx.n
        with tp.use_group(ctx.group):
            grads = _joined([_expert_ffn_bwd(buf[e], gate[e], up[e], down[e], gbar[e], ctx.group,
                                             whole)
                             for e in (slice(lo, lo + n) for lo in range(0, gate.shape[0], n))])
        return grads + (None,)


def expert_ffn(buf: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
               down: torch.Tensor) -> torch.Tensor:
    """buf (E, R, d) -> (E, R, d) in buf's dtype; the expert leaves whole
    or the rank's ``data`` blocks of them (dim 1)."""
    return _ExpertFFN.apply(buf, gate, up, down, torch.is_grad_enabled())


def moe_apply(p: Tree, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y: (B, S, d), aux_loss: 0-d float32)."""
    B, S, d = x.shape
    N = B * S
    E, k = cfg.num_experts, cfg.experts_per_token
    me, ranks = tp.row_share()
    nb = route_blocks(N * ranks)  # the one-process blocks of every rank's tokens
    block = N * ranks // nb
    C = _capacity(block, cfg)
    span = 1
    if nb % ranks == 0:
        nb //= ranks  # this rank's whole blocks
    elif ranks % nb == 0:
        nb, span, block = 1, ranks // nb, N  # this rank's part of one block
    else:
        raise ValueError(f"{nb} routing blocks of {N * ranks} tokens neither divide nor are "
                         f"divided by {ranks} client ranks")
    n_e = p["gate"].shape[0]
    split = tp.is_block(n_e, E)
    experts = rows = None
    if split:  # this rank's experts; the dispatch rows pass f
        experts = (tp.current_group().rank * n_e, n_e)
        rows = tp.copy_to_group(x).reshape(nb, block, d)
    buf, meta = _route(p, x.reshape(nb, block, d), cfg, C, experts, rows, span)
    prof = get_profile()
    if prof is not None:  # the JAX package's dispatch-layout pin
        buf = constrain(buf, (prof["batch"] or None, None, None, None))
    out = expert_ffn(buf.view(n_e, nb * C, d), p["gate"], p["up"], p["down"])
    del buf
    # split: the ranks' float32 combines are summed, then rounded once
    y = _combine(out.view(n_e, nb, C, d), meta, k, torch.float32 if split else x.dtype)
    y = y.reshape(B, S, d)
    if split:
        y = tp.reduce_from_group(y).to(x.dtype)
    if cfg.shared_expert:
        y = y + mlp_apply(p["shared"], x, cfg.activation, cfg.d_ff)
    if ranks == 1:
        return y, torch.mean(meta[3])
    # this rank's share of the mean over the one-process run's blocks
    return y, torch.sum(meta[3]) / (nb * ranks // span)
