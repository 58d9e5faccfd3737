"""The federated train step: TAG plan × model × strategy → one step function
(the port of ``repro.fl.fedstep``).

The TAG is lowered to an ``AggregationPlan`` (``repro_torch.core.
mesh_lowering``). The JAX package runs the step under ``shard_map``, manual
over the client axes, so each client is a slice of the device mesh and each
aggregation stage a ``psum`` with its channel's wire policy. On one card the
mesh is a plain description of named axis sizes (``Mesh``), and its clients
are *virtual*: the step runs them in turn, and folds each client's float32
delta into the stages' running float32 sums as soon as it exists, leaf by
leaf, so N clients' deltas are never held at once (``fold_plan``). A
Python loop, not ``torch.func.vmap``, which would hold N copies of the
model's parameters and activations.

Semantics per round (classic FedAvg-style local SGD), as in the JAX package:
  1. every client (one index on the client axes; it takes the batch rows of
     its linear index, the last client axis fastest) takes ``local_steps``
     SGD steps on microbatches of its shard;
  2. client delta = local_params - global_params in float32 (optional DP
     clip and noise; under partial participation, times the client's 0/1
     draw);
  3. the plan reduces the deltas stage by stage (e.g. the mean over ``data``
     within each pod, then over ``pod`` in the channel's wire dtype);
  4. the root strategy (FedAvg/FedAdam/...) applies the mean, renormalized
     over the clients that participated.

Randomness: each client draws from its own ``torch.Generator`` on the
step's device, seeded from (step seed, client index, stream); ``jax.random``
streams differ from torch's, so the participation draws and the DP noise
can be passed in (``made_it``, ``noise``) to reproduce the JAX package's.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.mesh_lowering import AggregationPlan, Mesh, StageSum, fold_plan
from repro_torch.core.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from repro_torch.fl.privacy import DPConfig, clip_and_noise
from repro_torch.fl.strategies import ServerStrategy

Tree = Any
Batch = Dict[str, Any]
LossFn = Callable[[Tree, Batch, torch.Generator], torch.Tensor]
# called with "local" (a client's SGD), "reduce" (its delta into the stage
# sums, the stage means) and "apply" (the root strategy) as each begins,
# and "done" at the end: a tracer's hook
SegmentHook = Callable[[str], None]


@dataclasses.dataclass(frozen=True)
class FedStepConfig:
    local_steps: int = 1
    local_lr: float = 1e-2
    dp: Optional[DPConfig] = None
    # gradient instead of weight-delta exchange (local_steps == 1 fast path)
    exchange: str = "delta"  # "delta" | "grad"
    # each client makes the round's straggler deadline with probability
    # ``participation``; missed clients contribute a zero delta and the
    # aggregate renormalizes over the clients that did participate
    participation: float = 1.0


_STREAMS = {"loss": 0, "dp": 1, "participation": 0x5EED}


def client_generator(seed: int, client: int, stream: str, device: Any) -> torch.Generator:
    """The generator of ``client``'s ``stream`` ("loss", "dp" or
    "participation") in the step seeded ``seed``, on ``device``."""
    key = f"{int(seed)}:{int(client)}:{_STREAMS[stream]}".encode()
    value = int.from_bytes(hashlib.sha256(key).digest()[:8], "little") & ((1 << 63) - 1)
    return torch.Generator(device=torch.device(device)).manual_seed(value)


def batch_to_device(batch: Batch, device: torch.device) -> Batch:
    """Every leaf of ``batch`` (numpy or tensor) as a tensor on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v,
                               device=device) for k, v in batch.items()}


def batch_size(batch: Batch) -> int:
    """Rows of a batch: dim 0 of every leaf, dim 1 of ``positions`` (the
    three M-RoPE streams lead)."""
    k, v = next(iter(batch.items()))
    return int(v.shape[1] if k == "positions" else v.shape[0])


def split_batch(batch: Batch, parts: int, i: int) -> Batch:
    """Rows ``[i*b, (i+1)*b)`` of every leaf, ``b = rows // parts``."""
    n = batch_size(batch)
    if n % parts:
        raise ValueError(f"a batch of {n} rows does not split into {parts} equal parts")
    b = n // parts
    rows = slice(i * b, (i + 1) * b)
    return {k: (v[:, rows] if k == "positions" else v[rows]) for k, v in batch.items()}


def _drain(xs: List[Any], fn: Callable[[int, Any], Any]):
    """``fn(i, xs[i])`` for each i in turn, dropping ``xs[i]`` as it goes
    (so a client's copy of the model is freed leaf by leaf)."""
    for i in range(len(xs)):
        x, xs[i] = xs[i], None
        yield fn(i, x)


GradSink = Callable[[int, torch.Tensor], None]


def value_and_grad(loss_fn: LossFn, leaves: Sequence[torch.Tensor], treedef: Any,
                   batch: Batch, gen: torch.Generator) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The loss at the parameters ``leaves`` and its gradient, leaf by leaf."""
    grads: List[Optional[torch.Tensor]] = [None] * len(leaves)
    loss = grad_each(loss_fn, leaves, treedef, batch, gen, grads.__setitem__)
    return loss, grads


def grad_each(loss_fn: LossFn, leaves: Sequence[torch.Tensor], treedef: Any, batch: Batch,
              gen: torch.Generator, on_grad: GradSink) -> torch.Tensor:
    """The loss at the parameters ``leaves``; autograd hands leaf j's
    gradient to ``on_grad(j, g)`` as soon as it is whole (a post-accumulate
    hook, on autograd's thread, under no_grad) and drops it after.
    ``on_grad`` may step ``leaves[j]`` in place: a leaf's gradient is whole
    once the nodes that use it have run, and a remat group's recompute
    reads its leaves before their nodes run (autograd's version counter
    raises where a saved leaf changed)."""
    xs = [x.detach().requires_grad_(True) for x in leaves]
    done = [False] * len(xs)

    def hook(j: int):
        def run(x: torch.Tensor) -> None:
            g, x.grad = x.grad, None
            with torch.no_grad():
                on_grad(j, g)
            done[j] = True

        return run

    handles = [x.register_post_accumulate_grad_hook(hook(j)) for j, x in enumerate(xs)]
    try:
        with torch.enable_grad():
            loss = loss_fn(tree_unflatten(treedef, xs), batch, gen)
            loss.backward()
    finally:
        for h in handles:
            h.remove()
    missing = [j for j, ok in enumerate(done) if not ok]
    if missing:
        raise RuntimeError(f"parameter leaves {missing} were not used in the loss")
    return loss.detach()


# a leaf of more elements is updated in pieces of as many: the update's
# temporaries and float32 delta then never span a whole expert leaf
UPDATE_PIECE = 1 << 26


def _pieces(w: torch.Tensor, *others: Optional[torch.Tensor]) -> list:
    """``w`` and ``others`` (of w's shape, or None) cut alike, in memory
    order, into pieces of ``UPDATE_PIECE`` elements (w whole where it is
    smaller, or not contiguous: a piece must be a view of w)."""
    if w.numel() <= UPDATE_PIECE or not w.is_contiguous():
        return [(w,) + others]
    cut = [x.reshape(-1).split(UPDATE_PIECE) if x is not None else None for x in (w,) + others]
    return [tuple(c[i] if c is not None else None for c in cut) for i in range(len(cut[0]))]


def update_leaf(j: int, w: torch.Tensor, g: torch.Tensor, lr: float, rows: Any = None,
                base: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
    """Leaf ``j``'s SGD step once its gradient ``g`` is whole: ``g`` summed
    over the grid's rows group ``rows`` where given (a leaf that no gather
    summed), then ``w - lr * g`` in w's dtype, written into ``w``. With
    ``base`` (the leaf as the round began; ``w`` itself for a round of one
    step), the float32 sum of the squares of the round's delta ``w_new -
    base``, as ``sum_of_squares`` sums a leaf. A leaf of more than
    ``UPDATE_PIECE`` elements is updated and summed in pieces. Looked up at
    each call, so that a caller may wrap it."""
    from repro_torch.launch import tensor_parallel as tp

    if rows is not None:
        g = tp.rows_sum(g, rows)
    sq = None
    for wp, gp, bp in _pieces(w, g, base):
        update = lr * gp.to(wp.dtype)
        if bp is None:
            wp.sub_(update)
            continue
        new = wp - update
        s = torch.sum(torch.square((new - bp).to(torch.float32)))
        sq = s if sq is None else sq + s
        wp.copy_(new)
    return sq


def local_round(loss_fn: LossFn, leaves: List[torch.Tensor], treedef: Any, batch: Batch,
                gen: torch.Generator, steps: int, lr: float,
                gathered: Optional[Sequence[bool]] = None, donate: bool = False
                ) -> Tuple[List[torch.Tensor], torch.Tensor, Optional[List[torch.Tensor]]]:
    """``steps`` SGD steps on the ``steps`` microbatches of a client's
    batch; returns the local parameters' leaves, the last step's loss and,
    with ``donate``, each leaf's float32 sum of squares of its delta over
    the round. Each leaf is stepped as soon as autograd has made its
    gradient (``update_leaf``), and the gradient dropped. ``donate``: the
    round takes ``leaves`` over and steps them in place (a round of more
    than one step keeps a copy of each leaf as it began, for its delta);
    else the first step steps a copy of each leaf, the client's own.

    On a grid whose rows are split over client ranks, each rank takes its
    rows of each microbatch (microbatch first, as the JAX package's
    ``(k, B/k)`` reshape cuts them), and each gradient is summed over the
    rows group: the leaves gathered over ``data`` at use (``gathered[j]``)
    are summed by the gather's backward, the others in ``update_leaf``."""
    from repro_torch.launch import tensor_parallel as tp

    me, ranks = tp.row_share()
    rows = tp.rows_group() if ranks > 1 else None
    out = list(leaves)
    sums: Optional[List[Optional[torch.Tensor]]] = [None] * len(out) if donate else None
    first: List[Optional[torch.Tensor]] = [None] * len(out)
    loss = None
    for i in range(steps):
        micro = split_batch(batch, steps, i)
        if ranks > 1:
            micro = split_batch(micro, ranks, me)
        last = i == steps - 1

        def on_grad(j: int, g: torch.Tensor, i: int = i, last: bool = last) -> None:
            w = out[j]
            if i == 0 and not donate:
                w = out[j] = w.clone()
            elif i == 0 and steps > 1:
                first[j] = w.clone()
            base = None
            if donate and last:
                base = w if steps == 1 else first[j]
            summed = rows if gathered is None or not gathered[j] else None
            sq = update_leaf(j, w, g, lr, summed, base)
            if base is not None:
                sums[j], first[j] = sq, None

        loss = grad_each(loss_fn, out, treedef, micro, gen, on_grad)
    return out, loss, sums


def sum_of_squares(leaves: Sequence[torch.Tensor],
                   sharded: Optional[Sequence[bool]] = None,
                   data: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """The sum of the squares of every leaf's elements. Under a model group
    (``sharded[i]``: the ranks hold blocks of leaf i), the blocks' sums are
    summed over the group and the replicated leaves counted once; on a grid
    (``data[i]``: the ``data`` ranks hold blocks of leaf i), those blocks'
    sums are summed over the ``data`` axis as well."""
    return summed_over_blocks([torch.sum(torch.square(x)) for x in leaves], sharded, data)


def summed_over_blocks(sums: Sequence[torch.Tensor],
                       sharded: Optional[Sequence[bool]] = None,
                       data: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """The total of per-leaf sums ``sums`` (each of the rank's block of its
    leaf) over the whole leaves, as ``sum_of_squares`` totals them."""
    from repro_torch.launch import tensor_parallel as tp

    parts: Dict[Tuple[bool, bool], torch.Tensor] = {}
    for i, s in enumerate(sums):
        key = (sharded is not None and sharded[i], data is not None and data[i])
        parts[key] = s if key not in parts else parts[key] + s
    total = None
    for (over_model, over_data), s in parts.items():
        if over_model:
            s = tp.all_reduce_sum(s)
        if over_data:
            s = tp.data_sum(s)
        total = s if total is None else total + s
    return total


def make_fl_train_step(
    loss_fn: LossFn,
    strategy: ServerStrategy,
    plan: AggregationPlan,
    mesh: Mesh,
    config: FedStepConfig = FedStepConfig(),
    blocks: Any = None,
) -> Callable[..., Tuple[Tree, Tree, Dict[str, torch.Tensor]]]:
    """Build ``step(params, server_state, batch, seed, *, made_it=None,
    noise=None, on_segment=None) -> (params, server_state, metrics)``.

    ``batch`` leaves lead with the global batch dim (``positions``: dim 1)
    and are moved to the parameters' device; client ``c`` (linear index
    over ``plan.all_axes``) takes rows ``[c*b, (c+1)*b)``. ``made_it[c]``
    (0 or 1) replaces client c's participation draw, ``noise[c]`` (one
    standard-normal array per parameter leaf) its DP noise draw.
    ``metrics``: ``loss`` (the clients' mean last-step loss), ``delta_norm``
    (of the aggregate) and ``participants``, 0-d float32 tensors.
    ``blocks`` (a ``launch.sharding.LeafBlocks``: a model rank's step) says
    which parameter leaves the rank holds blocks of and how, for
    ``delta_norm`` (``sum_of_squares``), the DP clip norm and noise
    (``clip_and_noise``) and the int8 wire's scales (``StageSum``), which
    are the whole leaves'.
    """
    sharded = None if blocks is None else blocks.sharded
    if config.exchange not in ("delta", "grad"):
        raise ValueError(f"unknown exchange {config.exchange!r}")
    client_axes = plan.all_axes
    sizes = {a: mesh.shape[a] for a in client_axes}
    n_total = 1
    for a in client_axes:
        n_total *= sizes[a]
    k = config.local_steps
    lr = config.local_lr

    def client_index(coords: Dict[str, int]) -> int:
        idx = 0
        for a in client_axes:
            idx = idx * sizes[a] + coords[a]
        return idx

    def step(params: Tree, server_state: Tree, batch: Batch, seed: int, *,
             made_it: Optional[Sequence[float]] = None,
             noise: Optional[Sequence[Sequence[Any]]] = None,
             on_segment: Optional[SegmentHook] = None):
        mark = on_segment or (lambda label: None)
        p_leaves, treedef = tree_flatten(params)
        device = p_leaves[0].device
        batch = batch_to_device(batch, device)
        losses: List[torch.Tensor] = []
        drawn: List[torch.Tensor] = []

        def fold(acc: StageSum, coords: Dict[str, int]) -> None:
            c = client_index(coords)
            shard = split_batch(batch, n_total, c)
            mark("local")
            gen = client_generator(seed, c, "loss", device)
            if config.exchange == "grad":
                loss, grads = value_and_grad(loss_fn, p_leaves, treedef, shard, gen)
                deltas = _drain(grads, lambda i, g: (-lr * g).to(torch.float32))
            else:
                local, loss, _ = local_round(loss_fn, p_leaves, treedef, shard, gen, k, lr)
                deltas = _drain(local, lambda i, w: (w - p_leaves[i]).to(torch.float32))
            losses.append(loss)
            mark("reduce")
            if config.dp is not None:
                # under partial participation the aggregate is a mean over
                # ~participation*N clients: the noise is calibrated to that
                n_eff = max(1, int(round(config.participation * n_total)))
                deltas = tree_leaves(clip_and_noise(
                    tree_unflatten(treedef, list(deltas)), config.dp,
                    client_generator(seed, c, "dp", device), n_eff,
                    noise=None if noise is None else noise[c], blocks=blocks))
            m = None
            if config.participation < 1.0:
                if made_it is not None:
                    m = torch.tensor(float(made_it[c]), dtype=torch.float32, device=device)
                else:
                    g = client_generator(seed, c, "participation", device)
                    m = (torch.rand((), generator=g, device=device)
                         < config.participation).to(torch.float32)
                drawn.append(m)
            for i, d in enumerate(deltas):
                acc.add_leaf(i, d if m is None else d * m, donate=True)
            acc.end_member(treedef)

        tree = fold_plan(fold, plan, sizes, sharded)
        if config.participation < 1.0:
            n_part = torch.stack(drawn).sum()
            # the stage means divide by all N clients: renormalize to the
            # mean over the clients that made the deadline
            renorm = (torch.tensor(float(n_total), device=device)
                      / torch.clamp(n_part, min=1.0))
            tree = tree_map(lambda d: d * renorm, tree)
        else:
            n_part = torch.tensor(float(n_total), dtype=torch.float32, device=device)
        d_leaves = tree_leaves(tree)
        del tree
        delta_norm = torch.sqrt(sum_of_squares(d_leaves, sharded))
        # the aggregate in the parameters' dtypes, float32 leaves freed as
        # they are cast
        cast = []
        for i, p in enumerate(p_leaves):
            cast.append(d_leaves[i].to(p.dtype))
            d_leaves[i] = None
        mark("apply")
        new_params, new_root = strategy.apply(params, tree_unflatten(treedef, cast),
                                              server_state["stages"]["root"])
        del cast
        stages = dict(server_state["stages"])
        stages["root"] = new_root
        mean_loss = torch.stack([x.to(torch.float32) for x in losses]).sum() / torch.tensor(
            float(n_total), device=device)
        mark("done")
        metrics = {"loss": mean_loss, "delta_norm": delta_norm, "participants": n_part}
        return new_params, {"stages": stages}, metrics

    return step


def init_server_state(strategy: ServerStrategy, plan: AggregationPlan, params: Tree) -> Tree:
    """Server-side state for the plan's root strategy."""
    return {"stages": {"root": strategy.init(params)}}
