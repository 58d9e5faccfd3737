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
product rounds once to it. The expert FFN's backward is written out, as
the JAX package's custom VJP is, in three autograd functions (``_Product``
for the gate and up products, ``_Down``), so that autograd hands each
expert leaf its gradient on its own: the float32 gate and up products are
kept for it (the JAX package recomputes them: the same values), every
gradient product is float32, and the buffer's two terms meet in float32
and are cast once.

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
where gathering a layer at once held 16.1. The backward's slices are sized
by what it holds of a slice (``_backward_experts``: the leaf, its float32
widening, its float32 gradient and that gradient's cast), from the rank's
share, or in one process from the card's memory (``tp.memory_share``).
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


def _expert_ffn_fwd(buf, gate, up, down) -> torch.Tensor:
    """The FFN's forward on experts whose leaves are gathered at use, each
    freed after its product (serving: nothing is kept for a backward)."""
    d, ff = buf.shape[-1], gate.shape[-1]
    g = _bmm(buf, _at_use(gate, d), torch.float32)
    u = _bmm(buf, _at_use(up, d), torch.float32)
    h = F.silu(g, inplace=True).mul_(u).to(buf.dtype)
    del g, u
    return _bmm(h, _at_use(down, ff), buf.dtype)


def _block_grad(g: torch.Tensor, x: torch.Tensor, group) -> torch.Tensor:
    """The gradient of ``x`` from its whole leaf's float32 gradient ``g``,
    cast to x's dtype: where ``x`` is a ``data`` block, summed over the
    rows in that dtype and cut to the block, as ``tp.gather_data``'s
    backward does."""
    g = g.to(x.dtype)
    return g if g.shape == x.shape else tp.data_block_grad(g, 1, group)


def _backward_experts(w: torch.Tensor, full: int, share: Optional[int]) -> int:
    """How many experts of the leaf ``w`` (the rank's block, dim 1 ``full``
    long whole) a backward product takes at a time: all of them without a
    bound (``share`` None), else the most, dividing the experts, whose
    slice's whole leaf (gathered or kept), its float32 widening, its
    float32 gradient and that gradient's cast to the leaf's dtype fit in
    ``GATHER_SHARE`` of ``share`` (Llama4's 5.37 GB bf16 leaf a grid rank
    in slices of 8 of its 64 experts; the whole 10.7 GB leaf of one process
    on a card in slices of 32)."""
    E = w.shape[0]
    if share is None:
        return E
    per = w.numel() // E * full // w.shape[1] * (2 * w.element_size() + 8)
    budget = GATHER_SHARE * share
    return max((n for n in range(1, E + 1) if E % n == 0 and per * n <= budget), default=1)


def _slices(E: int, n: int):
    return [slice(lo, lo + n) for lo in range(0, E, n)]


def _joined(parts: list) -> torch.Tensor:
    return parts[0] if len(parts) == 1 else torch.cat(parts)


class _Budget:
    """What a training forward's expert products know of their rank: the
    forward's group (the backward may run on autograd's device thread,
    outside the forward's group context), the forward's experts a slice
    (``_experts_at_once``), whether it keeps the whole gathered leaves for
    the backward (all experts at once), and the memory share the backward
    sizes its slices by (``_backward_experts``)."""

    def __init__(self, gate: torch.Tensor, d: int):
        self.group = tp.data_group()
        self.n = _experts_at_once(gate, d, self.group)
        self.keep = gate.shape[1] != d and self.n == gate.shape[0]
        self.share = tp.memory_share(gate.device)


class _Product(torch.autograd.Function):
    """``x32 @ w`` of the FFN's gate or up leaf, float32 out (E, R, ff):
    the buffer ``x32`` is the expert-major buffer widened to float32 (its
    products take it in ``dtype``, exact), ``w`` whole or the rank's
    ``data`` block, gathered at use slice by slice (kept whole where
    ``budget.keep``). Backward, each a float32 product: the buffer's term
    ``dy @ w^T`` (w gathered again, slice by slice, where not kept), which
    autograd adds in float32 to the other leaf's term, and w's gradient
    ``x32^T @ dy``, summed over the rows and cut to w's block
    (``_block_grad``): autograd hands it to w alone."""

    @staticmethod
    def forward(ctx, x32, w, dtype, budget):
        x = x32.to(dtype)
        d = x.shape[-1]
        parts, kept = [], None
        for s in _slices(w.shape[0], budget.n):
            ws = _at_use(w[s], d)
            parts.append(_bmm(x[s], ws, torch.float32))
            if budget.keep:
                kept = ws
            del ws
        ctx.budget = budget
        ctx.save_for_backward(x32, w, *(() if kept is None else (kept,)))
        return _joined(parts)

    @staticmethod
    def backward(ctx, dy):
        x32, w, *kept = ctx.saved_tensors
        b = ctx.budget
        d = x32.shape[-1]
        n = _backward_experts(w, d, b.share)
        d_x, d_w = torch.empty_like(x32), torch.empty_like(w)
        with tp.use_group(b.group):
            for s in _slices(w.shape[0], n):
                ws = kept[0][s] if kept else _at_use(w[s], d)
                d_x[s] = torch.bmm(dy[s], ws.to(torch.float32).transpose(1, 2))
                del ws
                d_w[s] = _block_grad(torch.bmm(x32[s].transpose(1, 2), dy[s]), w[s], b.group)
        return d_x, d_w, None, None


class _Down(torch.autograd.Function):
    """``silu(g) * u`` rounded to ``dtype``, times the FFN's down leaf
    ``w`` (whole or the rank's ``data`` block, gathered at use), rounded
    once to ``dtype``; g and u are the float32 gate and up products, kept
    for the backward (the JAX package's custom VJP recomputes them from
    the buffer: the same values). Backward, in float32: ``d_h = gbar @
    w^T`` (w gathered again, slice by slice, where not kept), g's and u's
    cotangents, and w's gradient ``(silu(g) * u)^T @ gbar``, cut to w's
    block: autograd hands it to w before the gate and up products'
    backward runs."""

    @staticmethod
    def forward(ctx, g, u, w, dtype, budget):
        ff = g.shape[-1]
        parts, kept = [], None
        for s in _slices(w.shape[0], budget.n):
            h = F.silu(g[s]).mul_(u[s]).to(dtype)
            ws = _at_use(w[s], ff)
            parts.append(_bmm(h, ws, dtype))
            if budget.keep:
                kept = ws
            del h, ws
        ctx.budget = budget
        ctx.save_for_backward(g, u, w, *(() if kept is None else (kept,)))
        return _joined(parts)

    @staticmethod
    def backward(ctx, gbar):
        g, u, w, *kept = ctx.saved_tensors
        b = ctx.budget
        ff = g.shape[-1]
        n = _backward_experts(w, ff, b.share)
        gbar = gbar.to(torch.float32)
        d_g, d_u, d_w = torch.empty_like(g), torch.empty_like(u), torch.empty_like(w)
        with tp.use_group(b.group):
            for s in _slices(w.shape[0], n):
                ws = kept[0][s] if kept else _at_use(w[s], ff)
                d_h = torch.bmm(gbar[s], ws.to(torch.float32).transpose(1, 2))  # (n, R, ff)
                del ws
                sg = torch.sigmoid(g[s])
                silu_g = g[s] * sg
                d_g[s] = d_h * u[s] * (sg + silu_g * (1.0 - sg))
                del sg
                d_w[s] = _block_grad(torch.bmm((silu_g * u[s]).transpose(1, 2), gbar[s]), w[s],
                                     b.group)
                d_u[s] = d_h * silu_g
                del d_h, silu_g
        return d_g, d_u, d_w, None, None


class StackSlice:
    """An expert leaf of a stack of one group (``scan_layers`` with G = 1),
    as its layer holds it: the stack's one slice is taken (a view) where
    the expert FFN uses the leaf, so its autograd node comes right before
    that product's. Autograd then hands the leaf its gradient as soon as the
    product's backward makes it, before the other expert products' backward
    runs; a slice taken as the stack begins (``torch.unbind``) would hold
    all three gradients until the group's backward is done."""

    def __init__(self, stack: torch.Tensor):
        self.stack = stack

    @property
    def shape(self) -> torch.Size:
        return self.stack.shape[1:]

    def take(self) -> torch.Tensor:
        return self.stack.squeeze(0)


def _take(x) -> torch.Tensor:
    return x.take() if isinstance(x, StackSlice) else x


def expert_ffn(buf: torch.Tensor, gate, up, down) -> torch.Tensor:
    """buf (E, R, d) -> (E, R, d) in buf's dtype; the expert leaves whole
    or the rank's ``data`` blocks of them (dim 1), or ``StackSlice``s of
    either. Serving takes each slice of experts through its three products
    in turn. A forward that records gradients runs three autograd
    functions (``_Product`` for gate and up, ``_Down``), each leaf taken
    just before its own, with the JAX package's hand-written backward: the
    float32 products, and the buffer's two terms added in float32 and cast
    once. So autograd hands each expert leaf its gradient on its own, and
    a rank holds one expert leaf's gradient at a time."""
    d = buf.shape[-1]
    if not (torch.is_grad_enabled() and (buf.requires_grad or any(
            isinstance(x, StackSlice) or x.requires_grad for x in (gate, up, down)))):
        gate, up, down = _take(gate), _take(up), _take(down)
        n = _experts_at_once(gate, d, tp.data_group())
        return _joined([_expert_ffn_fwd(buf[s], gate[s], up[s], down[s])
                        for s in _slices(gate.shape[0], n)])
    x32 = buf.to(torch.float32)
    gate = _take(gate)
    budget = _Budget(gate, d)
    g = _Product.apply(x32, gate, buf.dtype, budget)
    u = _Product.apply(x32, _take(up), buf.dtype, budget)
    return _Down.apply(g, u, _take(down), buf.dtype, budget)


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
    n_e = p["gate"].shape[0]  # a leaf or a StackSlice
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
