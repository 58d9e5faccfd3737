"""Tensor parallelism over a ``model`` axis of processes: the port's stand-in
for GSPMD's collectives.

The JAX package stores each leaf by its ``PartitionSpec`` and lets the
partitioner insert the collectives. Here a ``model`` axis of size m is m
processes, each holding its block of every leaf (``launch.sharding``), and
the model code (``repro_torch.models``) computes on its own block and calls
the collectives below itself:

* column-parallel layers take a replicated input through ``copy_to_group``
  (Megatron's f: identity forward, all-reduce backward);
* row-parallel layers hand their partial output to ``reduce_from_group``
  (Megatron's g: all-reduce forward, identity backward);
* a leaf whose block does not match the compute's split is gathered at use
  (``gather_at_use``: an all-reduce of the zero-padded block, exact, since
  one term of each sum is nonzero), and each such gather is counted.

All-reduce is used, with sum and max, broadcast for FSDP's data blocks
(``gather_data``), and point-to-point sends of host copies for their
gradients' reduces to the blocks' owners: gloo takes the first two on
CUDA tensors, where it does not take every collective. A counting group (``ModelGroup.counting``) has
no process group behind it: its collectives only advance its counters and
return their input, so a rank's step runs alone (under fake tensors, as
``launch.dryrun`` counts a step's collectives). The backend is chosen by
rule: ``nccl`` when the ranks are on distinct cards, ``gloo`` when ranks
share a card or run on the CPU (NCCL refuses two ranks on one device). Gloo takes CUDA tensors for
all-reduce and broadcast; a backend that refuses them raises, nothing is
rerouted.

The model code finds the group of the call in a context variable
(``use_group``), which ``models.api.build_model(cfg, device, group)`` sets
around every call of its bundle; no group, or a group of one, is the
one-process model.

A grid (``GroupPool(devices, axes)``) makes the client axes ``pod`` and
``data`` processes too, one for each device of the mesh: the rank's
``ModelGroup`` then also holds its client coordinate, the group of the
ranks that share its ``model`` coordinate (its rows group: the batch rows
and the gradients are split and summed over ``pod`` x ``data``) and the
group of those that also share its ``pod`` coordinate (the ``data`` axis,
over which FSDP stores a second dim of its leaves). ``gather_data``
gathers such a leaf at use (forward: the ranks' blocks all-gathered over
``data``, one broadcast from each, counted as a gathered leaf; backward: the whole leaf's gradient
summed over the rows group into the rank's block: one reduce a data rank, each block to its
owner, where the rows are the data axis, else an all-reduce cut to the block),
``reduce_from_rows``
sums a rank's share of a loss over the rows. Every all-reduce counts on
its axis: ``model`` or ``data`` (the client axes). A rank also holds its
share of its device's memory (``ModelGroup.memory_share``), by which the
MoE expert FFN sizes what it gathers at once (``models.moe``).

``GroupPool`` spawns one process per entry of ``devices`` with a
``file://`` rendezvous in a temp directory and runs functions on all of
them; ``run_model_group`` is a pool for one call. A pool on the cards
builds the kernel libraries first, in the parent, so a compile error shows
once. A rank's error, a dead rank or a timeout ends the pool and raises
with the rank's traceback: a call never hangs.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import datetime
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
import torch.utils.checkpoint

_GROUP: contextvars.ContextVar = contextvars.ContextVar("model_group", default=None)


Axes = Tuple[Tuple[str, int], ...]
# the counters: every all-reduce of the rank (count, bytes), those over the
# client axes among them, the leaves gathered at use over each axis, and the
# reduces of a gathered leaf's gradient blocks to their owners over data
_COUNTERS = ("all_reduces", "all_reduce_bytes", "data_all_reduces", "data_all_reduce_bytes",
             "gathered_leaves", "gathered_bytes", "data_gathered_leaves", "data_gathered_bytes",
             "data_reduces", "data_reduce_bytes")


@dataclasses.dataclass
class ModelGroup:
    """One rank's view of the mesh: its ``model`` rank and the axis size,
    the ``model`` axis's process group (``None`` for a group of one), the
    backend, the rank's device, its client axes (``clients``: the sizes of
    ``pod`` and ``data`` as processes, ``(("data", 1),)`` when the model
    axis alone is processes) and its linear index over them
    (``client_rank``, the last axis fastest), the rows group (``rows_pg``:
    the ranks sharing its ``model`` coordinate) and the ``data`` axis group
    (``data_pg``: those that also share its ``pod`` coordinate), the
    bytes of its device's memory that are its own (``memory_share``: the
    device's memory over the ranks on it; ``None`` on the CPU and in a
    counting group, no bound), and the rank's counters (``_COUNTERS``)."""

    rank: int
    size: int
    pg: Any = None
    backend: str = "none"
    device: torch.device = torch.device("cpu")
    clients: Axes = (("data", 1),)
    client_rank: int = 0
    rows_pg: Any = None
    data_pg: Any = None
    memory_share: Optional[int] = None
    all_reduces: int = 0
    all_reduce_bytes: int = 0
    data_all_reduces: int = 0
    data_all_reduce_bytes: int = 0
    gathered_leaves: int = 0
    gathered_bytes: int = 0
    data_gathered_leaves: int = 0
    data_gathered_bytes: int = 0
    data_reduces: int = 0
    data_reduce_bytes: int = 0

    @property
    def rows(self) -> int:
        """The ranks the batch rows are split over: ``pod`` x ``data``."""
        n = 1
        for _, k in self.clients:
            n *= k
        return n

    @property
    def data_size(self) -> int:
        """The ``data`` axis's size (the blocks of an FSDP leaf's data dim)."""
        return dict(self.clients).get("data", 1)

    @property
    def world(self) -> int:
        return self.rows * self.size

    @property
    def mesh(self):
        """The mesh the rank's parameters are stored by."""
        from repro_torch.core.mesh_lowering import Mesh

        return Mesh(tuple(self.clients) + (("model", self.size),))

    @property
    def model_mesh(self):
        """The ``model`` axis alone: the mesh of the rank's own rows."""
        from repro_torch.core.mesh_lowering import Mesh

        return Mesh((("data", 1), ("model", self.size)))

    @property
    def coords(self) -> Dict[str, int]:
        out, idx = {}, self.client_rank
        for name, k in reversed(self.clients):
            out[name] = idx % k
            idx //= k
        return {**{a: out[a] for a, _ in self.clients}, "model": self.rank}

    def counters(self) -> Dict[str, int]:
        out = {k: getattr(self, k) for k in _COUNTERS}
        out["model_all_reduces"] = self.all_reduces - self.data_all_reduces
        out["model_all_reduce_bytes"] = self.all_reduce_bytes - self.data_all_reduce_bytes
        # every collective over the client axes: their all-reduces, the
        # data gathers' all-gathers (a gather's bytes: its whole leaf's) and
        # the gradient blocks' reduces (each its block's bytes)
        out["data_collectives"] = (self.data_all_reduces + self.data_gathered_leaves
                                   + self.data_reduces)
        out["data_collective_bytes"] = (self.data_all_reduce_bytes + self.data_gathered_bytes
                                        + self.data_reduce_bytes)
        return out

    def reset_counters(self) -> None:
        for k in _COUNTERS:
            setattr(self, k, 0)

    @classmethod
    def counting(cls, size: int, rank: int = 0, device: Any = "cpu", clients: Axes = (("data", 1),),
                 client_rank: int = 0, memory_share: Optional[int] = None) -> "ModelGroup":
        """Rank ``rank`` of a model axis of ``size`` (at ``client_rank`` of
        a grid's ``clients``, with ``memory_share``) with no processes
        behind it: each collective is counted, as on a real group, and
        returns its input unchanged (the values are not the group's)."""
        return cls(rank=rank, size=size, backend="count", device=torch.device(device),
                   clients=tuple(clients), client_rank=client_rank, memory_share=memory_share)


def current_group() -> Optional[ModelGroup]:
    """The group of the running call when its ``model`` axis is split, or
    ``None`` (one process on the model axis)."""
    g = _GROUP.get()
    return g if g is not None and g.size > 1 else None


def rows_group() -> Optional[ModelGroup]:
    """The group of the running call when its batch rows are split over
    client ranks (a grid), or ``None``."""
    g = _GROUP.get()
    return g if g is not None and g.rows > 1 else None


def data_group() -> Optional[ModelGroup]:
    """The group of the running call when its ``data`` axis has more than
    one rank (FSDP's data-dim blocks), or ``None``."""
    g = _GROUP.get()
    return g if g is not None and g.data_size > 1 else None


@contextlib.contextmanager
def use_group(group: Optional[ModelGroup]) -> Iterator[None]:
    token = _GROUP.set(group)
    try:
        yield
    finally:
        _GROUP.reset(token)


def bind(fn: Callable, group: Optional[ModelGroup]) -> Callable:
    """``fn`` run under ``group`` (``fn`` itself without one)."""
    if group is None or group.world == 1:
        return fn

    def run(*a, **k):
        with use_group(group):
            return fn(*a, **k)

    return run


def is_block(local: int, full: int) -> bool:
    """Whether a dim of ``local`` is this rank's block of one of ``full``
    (``False``: the dim is whole). Raises for any other size."""
    if local == full:
        return False
    group = current_group()
    if group is None or local * group.size != full:
        raise ValueError(f"a dim of {local} is neither whole ({full}) nor a block of it over "
                         f"{group.size if group else 1} ranks")
    return True


def checkpoint(fn: Callable, *args: Any) -> Any:
    """``torch.utils.checkpoint`` of ``fn`` whose recompute in the backward
    runs in the context of the forward: its group and its sharding profile
    (``models.shard_ctx``, whose ``min_blocks`` cuts the MoE routing
    blocks). The backward may run outside the call that set them, and on
    the card it runs on autograd's device thread, which does not inherit
    the caller's context variables."""
    context = contextvars.copy_context()

    def run(*a):
        return context.copy().run(fn, *a)

    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False)


# --------------------------------------------------------------------- #
# collectives
# --------------------------------------------------------------------- #
def _all_reduce_(x: torch.Tensor, op, group: ModelGroup, over: str = "model") -> torch.Tensor:
    """All-reduce ``x`` in place over the group's ``model`` axis, its rows
    (``over="rows"``: pod x data) or its ``data`` axis (counted; the last
    two as client-axis all-reduces)."""
    nbytes = x.numel() * x.element_size()
    group.all_reduces += 1
    group.all_reduce_bytes += nbytes
    if over != "model":
        group.data_all_reduces += 1
        group.data_all_reduce_bytes += nbytes
    if group.backend != "count":
        pg = {"model": group.pg, "rows": group.rows_pg, "data": group.data_pg}[over]
        dist.all_reduce(x, op=op, group=pg)
    return x


def all_reduce_sum(x: torch.Tensor, group: Optional[ModelGroup] = None) -> torch.Tensor:
    """The sum of ``x`` over the group, a new tensor (no autograd)."""
    group = group or current_group()
    if group is None or group.size == 1:
        return x
    return _all_reduce_(x.detach().clone(), dist.ReduceOp.SUM, group)


def all_reduce_max(x: torch.Tensor, group: Optional[ModelGroup] = None) -> torch.Tensor:
    """The elementwise max of ``x`` over the group, a new tensor (no
    autograd: a max is used as a constant shift)."""
    group = group or current_group()
    if group is None or group.size == 1:
        return x
    return _all_reduce_(x.detach().clone(), dist.ReduceOp.MAX, group)


class _CopyToGroup(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.contiguous().clone(), dist.ReduceOp.SUM, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """Megatron's g: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_(x.contiguous().clone(), dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor) -> torch.Tensor:
    """A replicated input entering a split computation (f)."""
    group = current_group()
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor) -> torch.Tensor:
    """The sum over the group of the partial outputs ``x`` (g)."""
    group = current_group()
    return x if group is None else _ReduceFromGroup.apply(x, group)


class _GatherAtUse(torch.autograd.Function):
    """The whole leaf from every rank's block along ``dim``; the gradient
    of the whole leaf is the same on every rank (a replicated computation),
    so the block's gradient is its slice."""

    @staticmethod
    def forward(ctx, x, dim, group):
        n = x.shape[dim]
        ctx.dim, ctx.lo, ctx.n = dim, group.rank * n, n
        shape = list(x.shape)
        shape[dim] = n * group.size
        full = x.new_zeros(shape)
        full.narrow(dim, ctx.lo, n).copy_(x)
        group.gathered_leaves += 1
        group.gathered_bytes += full.numel() * full.element_size()
        return _all_reduce_(full, dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.lo, ctx.n), None, None


def gather_at_use(x: torch.Tensor, dim: int, full: int) -> torch.Tensor:
    """``x`` whole along ``dim`` (``full`` long): itself where it already
    is, else gathered from the group's blocks (counted)."""
    if not is_block(x.shape[dim], full):
        return x
    return _GatherAtUse.apply(x, dim, current_group())


def gather_block(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along ``dim``, in rank
    order (no autograd; counted as a gather): a leaf's whole from blocks
    that a computation produced, such as a KV cache cut on the sequence."""
    group = current_group()
    if group is None:
        return x
    with torch.no_grad():
        return _GatherAtUse.apply(x.detach(), dim, group)


def gather_columns(x: torch.Tensor, offset: int, width: int,
                   group: Optional[ModelGroup] = None) -> torch.Tensor:
    """The whole last dim (``width`` columns) from the group's blocks: ``x``
    holds the columns ``[offset, offset + x.shape[-1])``. One all-reduce of
    the zero-padded whole (exact: one term of each sum is nonzero; no
    autograd)."""
    group = group or current_group()
    if group is None or group.size == 1:
        return x
    full = x.new_zeros(tuple(x.shape[:-1]) + (width,))
    full[..., offset:offset + x.shape[-1]] = x.detach()
    return _all_reduce_(full, dist.ReduceOp.SUM, group)


def global_argmax(x: torch.Tensor, offset: int, width: int,
                  group: Optional[ModelGroup] = None) -> torch.Tensor:
    """The argmax over the group's vocab blocks along the last dim: ``x``
    holds the columns ``[offset, offset + x.shape[-1])`` of ``width``. Ties
    go to the lowest index, as ``jnp.argmax`` breaks them: the global max
    by an all-reduce max, then the least index holding it by an all-reduce
    max of the negated indices."""
    group = group or current_group()
    local = torch.argmax(x, dim=-1) + offset
    if group is None or group.size == 1:
        return local
    vals = torch.amax(x, dim=-1)
    top = all_reduce_max(vals.to(torch.float32), group)
    hit = vals.to(torch.float32) == top
    neg = torch.where(hit, -local, torch.full_like(local, -width))
    return -all_reduce_max(neg, group)


# --------------------------------------------------------------------- #
# the client axes of a grid
# --------------------------------------------------------------------- #
class _GatherData(torch.autograd.Function):
    """FSDP's gather at use: the leaf whole along ``dim`` from the ``data``
    ranks' blocks (an all-gather over ``data``, made of one broadcast from
    each data rank, exact: for a 1 GB bf16 leaf on one H100 shared by a
    (data 2, model 2) grid, 0.81-0.84 s where gloo's own all-gather took
    1.35-1.36 s and the zero-padded all-reduce 1.42-1.47 s,
    ``tools/gloo_allreduce_rates.py``). Each rank computes
    on its own rows, so the whole leaf's gradient is a partial sum: the
    backward sums it over the rows group (pod x data) into the rank's block
    (``_rows_block``: a reduce-scatter, written as one reduce a data rank,
    the forward's broadcasts run backwards)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        n = x.shape[dim]
        ctx.dim, ctx.lo, ctx.n, ctx.group = dim, group.coords["data"] * n, n, group
        # the blocks in data order, each a contiguous slice of one buffer,
        # then moved to their place along dim (a copy where dim > 0)
        count = group.backend == "count"
        blocks = (x.new_zeros if count else x.new_empty)((group.data_size,) + tuple(x.shape))
        blocks[group.coords["data"]] = x
        for i in range(0 if count else group.data_size):
            dist.broadcast(blocks[i], src=dist.get_global_rank(group.data_pg, i),
                           group=group.data_pg)
        shape = list(x.shape)
        shape[dim] = n * group.data_size
        group.data_gathered_leaves += 1
        group.data_gathered_bytes += blocks.numel() * blocks.element_size()
        return blocks.movedim(0, dim).reshape(shape)

    @staticmethod
    def backward(ctx, g):
        return _rows_block(g, ctx.dim, ctx.lo, ctx.n, ctx.group), None, None


def _rows_block(g: torch.Tensor, dim: int, lo: int, n: int, group: ModelGroup) -> torch.Tensor:
    """The whole leaf's gradient ``g`` of this rank's rows summed over the
    rows group, cut to the block ``[lo, lo + n)`` along ``dim``. Where the
    rows group is the ``data`` axis (no ``pod`` axis of more than one),
    each data block is reduced to its owner (``_reduce_to_owners``: half
    the bytes of an all-reduce, and at data 2 the same two-term sums); else
    the whole leaf is all-reduced over the rows and cut."""
    if group.rows == group.data_size:
        return _reduce_to_owners(g, dim, n, group)
    # the incoming gradient is summed in place where it is a buffer of its
    # own (a whole leaf's: one copy fewer at the backward's peak)
    own = g.is_contiguous() and g._base is None
    g = _all_reduce_(g if own else g.contiguous().clone(), dist.ReduceOp.SUM, group, "rows")
    # a copy of the block, so that the whole leaf's sum is freed here
    return g.narrow(dim, lo, n).clone(memory_format=torch.contiguous_format)


def _reduce_to_owners(g: torch.Tensor, dim: int, n: int, group: ModelGroup) -> torch.Tensor:
    """The rank's ``data`` block (``n`` long along ``dim``) of the sum over
    the data group of each rank's whole-leaf gradient ``g``: each block
    reduced to its owner, counted as one reduce a data rank at its block's
    bytes. Written as point-to-point sends: every rank sends its block i to
    data rank i and receives the other ranks' blocks of its own (on a card
    through pinned host copies: gloo sends host memory), then sums the
    terms in data order. Each rank moves half an all-reduce's bytes, and at
    data 2 the sums are the all-reduce's two-term sums. (gloo's own
    ``dist.reduce`` of a card's block took 2.09-2.16 s for a 1 GB bf16
    leaf's gradient on an H100 shared by a (data 2, model 2) grid, where
    the all-reduce took 1.44-1.48 s, ``tools/gloo_allreduce_rates.py``.)"""
    me, size = group.coords["data"], group.data_size
    own = g.narrow(dim, me * n, n)
    group.data_reduces += size
    group.data_reduce_bytes += size * own.numel() * own.element_size()
    if group.backend == "count":
        return own.clone(memory_format=torch.contiguous_format)
    pg = group.data_pg
    card = g.is_cuda

    def on_host(x: torch.Tensor) -> torch.Tensor:
        if not card:
            return x.contiguous()
        return torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(x)

    got, works = {}, []
    for i in range(size):
        if i == me:
            continue
        peer = dist.get_global_rank(pg, i)
        got[i] = torch.empty(own.shape, dtype=own.dtype, pin_memory=card)
        works.append(dist.isend(on_host(g.narrow(dim, i * n, n)), dst=peer, group=pg))
        works.append(dist.irecv(got[i], src=peer, group=pg))
    for w in works:
        w.wait()
    total = None
    for i in range(size):
        term = own if i == me else got.pop(i).to(g.device)
        total = term if total is None else total + term
    # the block as a buffer of its own, so that the whole leaf's gradient is
    # freed here
    if total._base is not None or not total.is_contiguous():
        total = total.clone(memory_format=torch.contiguous_format)
    return total


def gather_data(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` whole along ``dim`` over the ``data`` axis (itself when the
    running group has one data rank)."""
    group = data_group()
    return x if group is None else _GatherData.apply(x, dim, group)


def data_block_grad(g: torch.Tensor, dim: int, group: ModelGroup) -> torch.Tensor:
    """The gradient of the rank's ``data`` block along ``dim`` from the
    whole leaf's gradient ``g`` on the rank's rows: ``gather_data``'s
    backward, for a leaf gathered at use inside a hand-written backward."""
    n = g.shape[dim] // group.data_size
    return _rows_block(g, dim, group.coords["data"] * n, n, group)


class _ReduceFromRows(torch.autograd.Function):
    """A rank's share summed over the rows group: all-reduce forward,
    identity backward (each rank's gradient is of its own share)."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_(x.contiguous().clone(), dist.ReduceOp.SUM, group, "rows")

    @staticmethod
    def backward(ctx, g):
        return g, None


def reduce_from_rows(x: torch.Tensor) -> torch.Tensor:
    """The sum over the rows group of each rank's share ``x`` (itself when
    the rows are not split)."""
    group = rows_group()
    return x if group is None else _ReduceFromRows.apply(x, group)


def rows_sum(x: torch.Tensor, group: Optional[ModelGroup] = None) -> torch.Tensor:
    """The sum of ``x`` over the rows group, a new tensor (no autograd)."""
    group = group or rows_group()
    if group is None:
        return x
    return _all_reduce_(x.detach().clone(), dist.ReduceOp.SUM, group, "rows")


def data_sum(x: torch.Tensor, group: Optional[ModelGroup] = None) -> torch.Tensor:
    """The sum of ``x`` over the ``data`` axis, a new tensor (no
    autograd)."""
    group = group or data_group()
    if group is None:
        return x
    return _all_reduce_(x.detach().clone(), dist.ReduceOp.SUM, group, "data")


def memory_share(device: Any) -> Optional[int]:
    """The bytes of ``device``'s memory that the running call may count
    on: its group's share (``ModelGroup.memory_share``: None, no bound, on
    the CPU and in a counting group), or without a group a whole card's
    (None on the CPU)."""
    group = _GROUP.get()
    if group is not None:
        return group.memory_share
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_properties(device).total_memory


def row_share() -> Tuple[int, int]:
    """(this rank's block, the number of blocks) of the batch rows."""
    group = rows_group()
    return (0, 1) if group is None else (group.client_rank, group.rows)


# --------------------------------------------------------------------- #
# processes
# --------------------------------------------------------------------- #
def choose_backend(devices: Sequence[Any]) -> str:
    """``nccl`` for ranks on distinct cards, ``gloo`` for ranks that share a
    card or run on the CPU."""
    devs = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devs) and len({d.index for d in devs}) == len(devs):
        return "nccl"
    if any(d.type == "cuda" for d in devs) and not all(d.type == "cuda" for d in devs):
        raise ValueError(f"a group mixes the CPU and cards: {devices}")
    return "gloo"


def build_kernels() -> None:
    """Compile every kernel library of the port (one ``nvcc`` per source,
    started together) unless it is built already."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels.agg import kernel as agg_kernel
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.quant import kernel as qkernel

    libraries = (agg_kernel.LIBRARY, qkernel.LIBRARY, fkernel.LIBRARY, fkernel.SM90_LIBRARY,
                 fkernel.SM90_D256_LIBRARY)
    with ThreadPoolExecutor(len(libraries)) as pool:
        for fut in [pool.submit(lib.compile) for lib in libraries]:
            fut.result()


def grid_place(axes: Axes, index: int) -> Dict[str, Any]:
    """Where process ``index`` of the mesh ``axes`` (row-major: the last
    axis fastest) sits, as ``ModelGroup``'s fields: its ``model`` rank and
    the axis size, the client axes and its index over them."""
    from repro_torch.core.mesh_lowering import Mesh
    from repro_torch.launch.sharding import mesh_coords

    me = mesh_coords(Mesh(tuple(axes)))[index]
    clients = tuple((a, n) for a, n in axes if a != "model")
    client_rank = 0
    for a, n in clients:
        client_rank = client_rank * n + me[a]
    return {"rank": me.get("model", 0), "size": dict(axes).get("model", 1),
            "clients": clients or (("data", 1),), "client_rank": client_rank}


def _grid_groups(index: int, axes: Axes) -> ModelGroup:
    """The group of process ``index`` of the mesh ``axes``, its process
    groups made by ``dist.new_group``: every rank makes every group, in the
    same order, as the call asks."""
    from repro_torch.core.mesh_lowering import Mesh
    from repro_torch.launch.sharding import mesh_coords

    coords = mesh_coords(Mesh(axes))
    clients = tuple(a for a, _ in axes if a != "model")

    def make(key: Callable[[Dict[str, int]], Any]) -> Any:
        members: Dict[Any, List[int]] = {}
        for i, c in enumerate(coords):
            members.setdefault(key(c), []).append(i)
        mine = None
        for ranks in members.values():
            if len(ranks) == len(coords):
                pg = dist.group.WORLD
            elif len(ranks) == 1:
                pg = None
            else:
                pg = dist.new_group(ranks)
            if index in ranks:
                mine = pg
        return mine

    model_pg = make(lambda c: tuple(c[a] for a in clients))
    rows_pg = make(lambda c: c.get("model", 0))
    pods = dict(axes).get("pod", 1)
    data_pg = rows_pg if pods == 1 else make(lambda c: (c.get("pod", 0), c.get("model", 0)))
    return ModelGroup(pg=model_pg, rows_pg=rows_pg, data_pg=data_pg, **grid_place(axes, index))


def _worker(rank: int, devices: List[str], axes: Axes, backend: str, init_file: str,
            timeout_s: float, tasks, results) -> None:
    size = len(devices)
    try:
        device = torch.device(devices[rank])
        if device.type == "cuda":
            torch.cuda.set_device(device)
        torch.set_num_threads(1)
        dist.init_process_group(backend, init_method=f"file://{init_file}", world_size=size,
                                rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
        group = _grid_groups(rank, axes)
        group.backend, group.device = backend, device
        if device.type == "cuda":
            group.memory_share = (torch.cuda.get_device_properties(device).total_memory
                                  // devices.count(devices[rank]))
        results.put((rank, "ready", None))
    except Exception:  # noqa: BLE001 - reported to the parent
        results.put((rank, "error", traceback.format_exc()))
        return
    while True:
        task = tasks.get()
        if task is None:
            break
        fn, args = pickle.loads(task)
        try:
            group.reset_counters()
            results.put((rank, "ok", pickle.dumps(fn(group, *args))))
        except Exception:  # noqa: BLE001 - reported to the parent
            results.put((rank, "error", traceback.format_exc()))
            break
    dist.destroy_process_group()


@dataclasses.dataclass
class RankResult:
    rank: int
    value: Any


class GroupError(RuntimeError):
    """A rank failed, died or timed out; the message holds its traceback."""


class GroupPool:
    """One process per entry of ``devices``, joined in a process group,
    running functions ``fn(group, *args)`` on every rank at once. ``fn``
    must be importable by name (a module-level function) and return host
    objects. Any rank's failure closes the pool and raises ``GroupError``.

    ``axes`` (a mesh's ``(name, size)`` pairs, their product the number of
    devices) lays the ranks out on a grid in row-major order, the ``model``
    axis fastest; by default every rank is on the ``model`` axis."""

    def __init__(self, devices: Sequence[Any], *, timeout_s: float = 300.0,
                 axes: Optional[Axes] = None):
        self.devices = [str(torch.device(d)) for d in devices]
        self.axes = tuple(axes or (("data", 1), ("model", len(self.devices))))
        n = 1
        for _, k in self.axes:
            n *= k
        if n != len(self.devices) or "model" not in dict(self.axes):
            raise ValueError(f"a grid {self.axes} for {len(self.devices)} devices")
        self.backend = choose_backend(self.devices)
        if any(torch.device(d).type == "cuda" for d in self.devices):
            build_kernels()  # here, once, so that a compile error shows before any rank
        self.timeout_s = timeout_s
        self._dir = tempfile.mkdtemp(prefix="model_group_")
        ctx = mp.get_context("spawn")
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in self.devices]
        self._procs = []
        saved = os.environ.get("OMP_NUM_THREADS")
        os.environ["OMP_NUM_THREADS"] = "1"
        try:
            for rank in range(len(self.devices)):
                p = ctx.Process(target=_worker, args=(
                    rank, self.devices, self.axes, self.backend,
                    os.path.join(self._dir, "rendezvous"),
                    timeout_s, self._tasks[rank], self._results), daemon=True)
                p.start()
                self._procs.append(p)
        finally:
            if saved is None:
                os.environ.pop("OMP_NUM_THREADS", None)
            else:
                os.environ["OMP_NUM_THREADS"] = saved
        self._collect(timeout_s)

    @property
    def size(self) -> int:
        return len(self.devices)

    def _collect(self, timeout_s: float) -> List[RankResult]:
        deadline = time.monotonic() + timeout_s
        got: Dict[int, RankResult] = {}
        while len(got) < self.size:
            try:
                rank, status, payload = self._results.get(timeout=1.0)
            except queue.Empty:
                dead = [i for i, p in enumerate(self._procs) if p.exitcode is not None]
                if dead:
                    self.close()
                    raise GroupError(f"rank {dead[0]} exited with code "
                                     f"{self._procs[dead[0]].exitcode} and no result")
                if time.monotonic() > deadline:
                    self.close()
                    raise GroupError(f"ranks {sorted(set(range(self.size)) - set(got))} gave "
                                     f"no result within {timeout_s} s")
                continue
            if status == "error":
                self.close()
                raise GroupError(f"rank {rank} failed:\n{payload}")
            got[rank] = RankResult(rank, payload)
        return [got[r] for r in range(self.size)]

    def run(self, fn: Callable, *args: Any, timeout_s: Optional[float] = None) -> List[RankResult]:
        """``fn(group, *args)`` on every rank; each rank's value, in rank
        order."""
        if not self._procs:
            raise GroupError("the pool is closed")
        task = pickle.dumps((fn, args))
        for q in self._tasks:
            q.put(task)
        results = self._collect(timeout_s or self.timeout_s)
        for r in results:
            r.value = pickle.loads(r.value)
        return results

    def close(self) -> None:
        procs, self._procs = self._procs, []
        for q in self._tasks:
            try:
                q.put(None)
            except (OSError, ValueError):
                pass
        deadline = time.monotonic() + 5
        while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
            try:  # drain what the ranks still send, so that none blocks in its exit
                self._results.get(timeout=0.1)
            except queue.Empty:
                pass
        for p in procs:
            p.join(timeout=5)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self) -> "GroupPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def run_model_group(fn: Callable, devices: Sequence[Any], *args: Any,
                    timeout_s: float = 300.0, axes: Optional[Axes] = None) -> List[RankResult]:
    """``fn(group, *args)`` on one process per entry of ``devices`` (on the
    grid ``axes``); each rank's value, in rank order."""
    with GroupPool(devices, timeout_s=timeout_s, axes=axes) as pool:
        return pool.run(fn, *args, timeout_s=timeout_s)
