"""TAG → mesh lowering (the port of ``repro.core.mesh_lowering``).

A TAG is compiled into an ``AggregationPlan``: an ordered list of
aggregation *stages*, one per channel on the trainer→…→global-aggregator
path, each bound to

* the mesh axes (client axes) its reduction spans,
* a collective kind (``psum``),
* the channel's wire policy (``wire_dtype``: the payload is cast or
  quantized before it crosses the axis), and
* a per-stage server strategy name.

The plan logic (``AggregationStage``, ``AggregationPlan``,
``_aggregation_path``, ``lower_tag_to_mesh``) needs no framework and is the
JAX package's, so both packages lower every template to equal plans.

The reductions run over *virtual* clients. The JAX package's client axes are
device axes of a mesh, and a stage is a ``psum`` (or, for a low-precision
wire on the CPU, a gather and a float32 sum) inside ``shard_map``. On one
card the clients of an axis take turns, and a stage is a running float32 sum
(``StageSum``) that each member's tree is folded into as soon as it exists,
so a stage never holds its members' trees at once:

* ``f32`` wire: the float32 sum;
* ``bf16`` / ``f16`` wire: each member's tree cast to the wire dtype, then
  summed in float32 (the JAX package's CPU form, gather then float32 sum);
* ``int8`` wire: per-tensor ``quantize_int8`` of each member, then a
  float32 dequantize-accumulate.

The mean divides the sum by the member count (or the summed weights) with
an IEEE divide by a 0-d tensor, and casts back to each leaf's dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.tag import TAG, Channel, TagError
from repro_torch.core.tree import tree_flatten, tree_unflatten
from repro_torch.fl.compression import dequantize_int8, quantize_int8

Tree = Any

# wire_dtype -> the dtype a member's tree is cast to before it is summed
# ("" is float32, as in the JAX package; "int8": per-tensor codes and a scale)
_CAST_DTYPES = {"": torch.float32, "f32": torch.float32, "bf16": torch.bfloat16,
                "f16": torch.float16}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A mesh as a plain description of named axis sizes, e.g.
    ``Mesh((("data", 2), ("model", 1)))``; it holds no devices. Its client
    axes are virtual clients on one device."""

    axes: Tuple[Tuple[str, int], ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self.axes)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(a for a, _ in self.axes)


@dataclasses.dataclass(frozen=True)
class AggregationStage:
    """One reduction stage of the lowered TAG."""

    channel: str
    axes: Tuple[str, ...]  # mesh axes the reduction spans
    wire_dtype: str = "f32"
    strategy: str = "fedavg"  # server strategy applied *after* this stage
    collective: str = "psum"


@dataclasses.dataclass(frozen=True)
class AggregationPlan:
    """Ordered aggregation stages from leaf trainers to the global root."""

    tag_name: str
    stages: Tuple[AggregationStage, ...]

    @property
    def all_axes(self) -> Tuple[str, ...]:
        out: List[str] = []
        for s in self.stages:
            out.extend(a for a in s.axes if a not in out)
        return tuple(out)


def _aggregation_path(tag: TAG) -> List[Channel]:
    """Walk the TAG from the data-consumer role upward along aggregation
    channels (channels whose funcTags include 'aggregate' or 'allreduce')."""
    consumers = tag.data_consumers()
    if not consumers:
        raise TagError(f"TAG {tag.name!r} has no data-consumer role to lower")
    if len(consumers) > 1:
        raise TagError("mesh lowering supports a single data-consumer role")
    path: List[Channel] = []
    current = consumers[0].name
    visited = {current}
    while True:
        nxt: Optional[Channel] = None
        for ch in tag.channels_of(current):
            other = ch.other_end(current)
            tags = set(ch.func_tags.for_role(other)) | set(ch.func_tags.for_role(current))
            if {"aggregate", "allreduce"} & tags:
                if ch.pair[0] == ch.pair[1]:
                    # p2p ring channel: reduction among peers, no upward hop
                    path.append(ch)
                    nxt = None
                    break
                if other not in visited:
                    path.append(ch)
                    visited.add(other)
                    current = other
                    nxt = ch
                    break
        if nxt is None:
            break
    if not path:
        raise TagError(f"TAG {tag.name!r} has no aggregation channels")
    return path


def lower_tag_to_mesh(
    tag: TAG,
    mesh_axes: Sequence[str],
    stage_strategies: Optional[Dict[str, str]] = None,
) -> AggregationPlan:
    """Assign each aggregation channel of ``tag`` to mesh axes, innermost
    (fastest) axis first.

    ``mesh_axes`` are the *reduction* axes available, ordered fast→slow —
    e.g. ``("data",)`` or ``("data", "pod")``. The last channel on the path
    absorbs any leftover axes so the plan always reduces over the full
    client extent of the mesh.
    """
    stage_strategies = stage_strategies or {}
    path = _aggregation_path(tag)
    axes = list(mesh_axes)
    if len(path) > len(axes):
        # more hierarchy levels than mesh axes: merge the innermost levels
        merged = path[: len(path) - len(axes) + 1]
        path = [merged[0]] + path[len(merged):]
    stages: List[AggregationStage] = []
    for i, ch in enumerate(path):
        span = tuple(axes[i:]) if i == len(path) - 1 else (axes[i],)
        stages.append(
            AggregationStage(
                channel=ch.name,
                axes=span,
                wire_dtype=ch.wire_dtype,
                strategy=stage_strategies.get(ch.name, "fedavg"),
                collective="psum",
            )
        )
    return AggregationPlan(tag_name=tag.name, stages=tuple(stages))


def _on_wire(x: torch.Tensor, wire: str, whole: bool = True) -> torch.Tensor:
    """One member's float32 leaf as it arrives from the wire, in float32
    (``whole=False``: ``x`` is a model rank's block of the leaf, and an int8
    scale is the whole leaf's)."""
    if wire in _CAST_DTYPES:
        return x if wire in ("", "f32") else x.to(_CAST_DTYPES[wire]).to(torch.float32)
    q, scale = quantize_int8(x, whole)  # "int8"
    return dequantize_int8(q, scale)


class StageSum:
    """The running float32 sum of one stage's members under its wire policy.

    ``add(tree, weight)`` folds one member's tree in (scaled by ``weight``
    first, as a weighted stage scales before the collective). A caller that
    frees each leaf as it goes folds them one by one with ``add_leaf``, then
    calls ``end_member``. ``mean`` divides by the member count, or by the
    summed weights, and casts each leaf back to the dtype its members had.
    ``sharded[i]``: leaf i is a model rank's block (its int8 scale is the
    whole leaf's).
    """

    def __init__(self, stage: AggregationStage, sharded: Optional[Sequence[bool]] = None):
        if stage.wire_dtype not in _CAST_DTYPES and stage.wire_dtype != "int8":
            raise ValueError(f"unknown wire dtype {stage.wire_dtype!r}")
        self.stage = stage
        self.sums: List[torch.Tensor] = []
        self.dtypes: List[torch.dtype] = []
        self.members = 0
        self.weight_sum: Optional[torch.Tensor] = None
        self.treedef: Any = None
        self.sharded = sharded

    def add_leaf(self, i: int, leaf: torch.Tensor,
                 weight: Optional[torch.Tensor] = None, donate: bool = False) -> None:
        """Fold leaf ``i`` of a member in; with ``donate`` the sum may keep
        the leaf's storage (the caller no longer reads it)."""
        x = leaf.to(torch.float32)
        if weight is not None:
            x = x * weight.to(device=x.device, dtype=torch.float32)
        x = _on_wire(x, self.stage.wire_dtype, not (self.sharded and self.sharded[i]))
        if i == len(self.sums):  # the first member: the sum owns its storage
            self.sums.append(x.clone() if x is leaf and not donate else x)
            self.dtypes.append(leaf.dtype)
        else:
            self.sums[i].add_(x)

    def end_member(self, treedef: Any, weight: Optional[torch.Tensor] = None) -> None:
        self.treedef = treedef
        self.members += 1
        if weight is not None:
            w = weight.to(torch.float32)
            self.weight_sum = w.clone() if self.weight_sum is None else self.weight_sum + w

    def add(self, tree: Tree, weight: Optional[torch.Tensor] = None) -> None:
        leaves, treedef = tree_flatten(tree)
        for i, leaf in enumerate(leaves):
            self.add_leaf(i, leaf, weight)
        self.end_member(treedef, weight)

    def mean(self) -> Tree:
        if not self.members:
            raise ValueError(f"stage {self.stage.channel!r} has no members")
        denom = self.weight_sum if self.weight_sum is not None else torch.tensor(
            float(self.members))
        sums, self.sums = self.sums, []
        out = []
        for i, dtype in enumerate(self.dtypes):
            s, sums[i] = sums[i], None  # divided in place: no second copy of the sums
            out.append(s.div_(denom.to(device=s.device, dtype=torch.float32)).to(dtype))
        return tree_unflatten(self.treedef, out)


def stage_reduce_mean(
    trees: Sequence[Tree],
    stage: AggregationStage,
    weights: Optional[Sequence[torch.Tensor]] = None,
) -> Tree:
    """Weighted-mean reduction of the trees of a stage's members (the
    clients along its axes, in axis order) under the channel's wire policy.

    ``weights`` are the members' aggregation weights (e.g. #samples);
    ``None`` means uniform."""
    acc = StageSum(stage)
    for i, tree in enumerate(trees):
        acc.add(tree, None if weights is None else torch.as_tensor(weights[i]))
    return acc.mean()


def _coords_of(axes: Sequence[str], axis_sizes: Dict[str, int]) -> List[Dict[str, int]]:
    """Every coordinate over ``axes``, the last axis fastest."""
    out: List[Dict[str, int]] = [{}]
    for a in axes:
        out = [dict(c, **{a: i}) for c in out for i in range(axis_sizes[a])]
    return out


Fold = Callable[[StageSum, Dict[str, int]], None]


def fold_plan(fold: Fold, plan: AggregationPlan, axis_sizes: Dict[str, int],
              sharded: Optional[Sequence[bool]] = None) -> Tree:
    """Run every stage of the plan, the clients taking turns.

    ``fold(acc, coords)`` folds the client at ``coords`` (its index on each
    client axis) into the first stage's running sum ``acc``; it is called
    once per client. The last stage's mean is returned; each of its members
    is the mean of the stage before over the group at that coordinate.
    Groups are reduced one at a time, so one running sum per stage is live.
    ``sharded``: which leaves are a model rank's blocks (``StageSum``)."""
    return _reduce(plan.stages, {}, fold, axis_sizes, sharded)


def _reduce(stages: Sequence[AggregationStage], outer: Dict[str, int], fold: Fold,
            axis_sizes: Dict[str, int], sharded: Optional[Sequence[bool]]) -> Tree:
    # a module function, not a closure calling itself: such a closure is a
    # reference cycle that would keep ``fold`` (and the caller's trees) alive
    # until the garbage collector's next full pass
    stage = stages[-1]
    acc = StageSum(stage, sharded)
    for coords in _coords_of(stage.axes, axis_sizes):
        at = dict(outer, **coords)
        if len(stages) > 1:
            acc.add(_reduce(stages[:-1], at, fold, axis_sizes, sharded))
        else:
            fold(acc, at)
    return acc.mean()


def apply_plan(
    member_tree: Callable[[Dict[str, int]], Tree],
    plan: AggregationPlan,
    axis_sizes: Dict[str, int],
    weight: Optional[Callable[[Dict[str, int]], torch.Tensor]] = None,
) -> Tree:
    """Run every stage of the plan over the clients' update trees:
    ``member_tree(coords)`` is the update of the client at ``coords``, and
    ``weight(coords)`` its aggregation weight, consumed by the first (leaf)
    reduction."""

    def fold(acc, coords):
        acc.add(member_tree(coords), None if weight is None else weight(coords))

    return fold_plan(fold, plan, axis_sizes)
