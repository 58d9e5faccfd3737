"""Role base programs — the user programming model (§4.4, Fig. 4/5), the
port of ``repro.core.roles``.

Base classes implement the full tasklet workflow for each standard role
(trainer, aggregator, global aggregator); a user subclass only fills in
``initialize / load_data / train / evaluate``. Weight trees hold
``torch.Tensor``s on the job's device (``RoleContext.device``). Derived
topologies extend these by chain surgery (Table 1): ``DistributedTrainer``
and ``HybridTrainer`` below, the coordinated roles in
``repro_torch.core.roles_coord``.
"""
from __future__ import annotations

import abc
import queue
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.convert import tree_from_numpy
from repro_torch.core.channels import ChannelEnd, ChannelManager
from repro_torch.core.composer import CloneComposer, Composer, Loop, Tasklet
from repro_torch.core.expansion import WorkerConfig
from repro_torch.core.tag import TAG
from repro_torch.core.tree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.kernels.agg.ops import (
    aggregate_tree,
    divide,
    fold_into,
    stack_client_trees,
)


class RoleContext:
    """Everything a worker needs at runtime: its config, channel ends, the
    job hyperparameters, the torch device its tensors live on and a handle
    on the per-channel clocks (for emulated compute time).

    Role bodies reach the transport exclusively through ``ChannelEnd``.
    """

    def __init__(
        self,
        worker: WorkerConfig,
        tag: TAG,
        channels: ChannelManager,
        hyperparams: Optional[Dict[str, Any]] = None,
        static_members: Optional[Dict[str, List[str]]] = None,
        device: Any = "cpu",
    ) -> None:
        self.worker = worker
        self.tag = tag
        self.channels = channels
        self.hyperparams = dict(hyperparams or {})
        # channel -> sorted worker ids in this worker's group on that channel,
        # computed statically from the expansion (no join races).
        self.static_members = dict(static_members or {})
        self.device = torch.device(device)
        self._ends: Dict[str, ChannelEnd] = {}
        self._clock_ends: Dict[str, ChannelEnd] = {}

    def end(self, channel: str) -> ChannelEnd:
        if channel not in self._ends:
            group = self.worker.group_of(channel)
            self._ends[channel] = self.channels.end(channel, group, self.worker.worker_id)
        return self._ends[channel]

    def clock_end(self, channel: str) -> ChannelEnd:
        """An end usable for clock/poison queries without joining the
        channel (joining as a side effect would corrupt the membership)."""
        if channel in self._ends:
            return self._ends[channel]
        if channel not in self._clock_ends:
            group = self.worker.group_of(channel)
            self._clock_ends[channel] = self.channels.end(
                channel, group, self.worker.worker_id, join=False
            )
        return self._clock_ends[channel]

    def advance_clock(self, channel: str, seconds: float) -> None:
        self.clock_end(channel).advance(seconds)

    def now(self, channel: str) -> float:
        return self.clock_end(channel).now()

    def set_clock(self, channel: str, at: float) -> None:
        self.clock_end(channel).set_clock(at)


def bridge_clock(ctx: "RoleContext", channel: str) -> None:
    """Carry a worker's latest virtual time onto ``channel``'s backend.

    A node on several channels (an intermediate aggregator: receiver below,
    sender above) has one clock per backend; without bridging, a send on the
    other channel would depart *before* the work that produced it finished,
    undercounting tree round times."""
    t = max(ctx.now(c) for c in ctx.worker.groups)
    ctx.set_clock(channel, t)


def await_peer(ctx: "RoleContext", end: "ChannelEnd", timeout: float = 5.0) -> str:
    """First peer on ``end``, waiting out transient empty membership."""
    me = ctx.worker.worker_id
    deadline = time.monotonic() + timeout
    while True:
        peers = end.ends()
        if peers:
            return peers[0]
        end.check_poison()
        if time.monotonic() >= deadline:
            raise RuntimeError(
                f"{me}: no peer on channel {end.channel!r} after {timeout}s "
                "(did the only upstream worker drop without a re-join?)"
            )
        time.sleep(0.01)


def weighted_mean(updates: Sequence[Tuple[Any, float]]) -> Tuple[Optional[Any], float]:
    """Sample-weighted mean of client model trees.

    Returns ``(mean_tree, total_samples)``; ``(None, 0.0)`` when no update
    carries positive weight. Uniform float32 tensor trees go through one
    stacked exact fold per leaf (``aggregate_tree(exact=True)``); any other
    trees through the streaming fold (numpy's promotion for leaves that are
    not float32 tensors). Both give the JAX package's ``weighted_mean``
    bit for bit, in its dtypes. Unlike the JAX package there is no
    size threshold and no ``fused`` switch: a CUDA tree always goes through
    the kernels, a CPU tree through their plain versions.
    """
    total = 0.0
    for _, n in updates:
        total += n
    if not updates or total <= 0:
        return None, 0.0
    stacked = stack_client_trees([w for w, _ in updates])
    leaves = tree_leaves(stacked) if stacked is not None else []
    if leaves:
        w = torch.tensor(
            [float(n) for _, n in updates], dtype=torch.float32, device=leaves[0].device
        )
        return aggregate_tree(stacked, w, denom=total, exact=True), total
    acc = StreamingMean()
    for weights, n in updates:
        acc.fold(weights, n)
    return acc.finalize()


class StreamingMean:
    """O(1)-memory streaming counterpart of ``weighted_mean``.

    ``fold(weights, n)`` absorbs one client update at a time — callers feed
    updates in sorted-src order — and ``finalize()`` returns
    ``(mean_tree, total_samples)`` (``(None, 0.0)`` when nothing carried
    positive weight). Only the running accumulator tree is retained, and it
    is updated in place.

    Bit-identity: each fold is the IEEE ``scale then add`` of the JAX
    package's sequential path (``fmul`` by float32(n), ``fadd`` into the
    accumulator, which starts from the first scaled update), and
    ``finalize`` one IEEE divide by float32(total), on the kernels for
    float32 tensor leaves. Any other leaf folds with numpy's promotion, as
    that path does: ``{"w": int32[4]}`` gives a float64 mean, a bfloat16
    leaf a float32 one, a Python scalar a numpy float64. The parity is with
    the JAX package's sequential (CPU) fold: its fused path, which it takes
    on an accelerator for trees of 16 384 elements or more, gives other
    dtypes on leaves that are not float32. With ``device`` set (the job's
    device), a tensor leaf on another device raises ``TypeError``, so a CUDA
    job never folds its tensors on the host.
    """

    def __init__(self, device: Any = None) -> None:
        self.device = None if device is None else torch.device(device)
        self._acc: Any = None
        self._total = 0.0
        self.count = 0
        self.peak_buffered = 0

    def _check_device(self, tree: Any) -> None:
        if self.device is None:
            return
        for leaf in tree_leaves(tree):
            if isinstance(leaf, torch.Tensor) and leaf.device != self.device:
                raise TypeError(f"update leaf on {leaf.device}; the job runs on {self.device}")

    def fold(self, weights: Any, n: float) -> None:
        self._check_device(weights)
        n = float(n)
        self._total += n
        self.count += 1
        self.peak_buffered = max(self.peak_buffered, 1)
        self._acc = fold_into(self._acc, weights, n)

    def partial(self) -> Tuple[Optional[Any], float]:
        """The raw running state: ``(weighted_sum_tree, total_weight)``,
        unfinalized, so a downstream fold over several partials divides once
        by the grand total exactly like :meth:`finalize` does."""
        return self._acc, self._total

    def fold_partial(self, acc: Any, total: float, count: int = 1) -> None:
        """Absorb another accumulator's raw ``(acc, total)`` partial.

        Partials are pre-scaled sums, so folding adds them with weight 1.0
        (``fmul(p, 1.0)`` is ``p`` bit for bit); callers feed partials in
        sorted-shard order. ``count`` carries the number of source updates
        inside the partial."""
        if acc is None or count <= 0:
            return
        self._check_device(acc)
        self._total += float(total)
        self.count += int(count)
        self.peak_buffered = max(self.peak_buffered, 1)
        self._acc = fold_into(self._acc, acc, 1.0)

    def finalize(self) -> Tuple[Optional[Any], float]:
        if self._acc is None or self._total <= 0:
            return None, 0.0
        return divide(self._acc, self._total), self._total


def _float64_copy(x: Any, device: torch.device) -> torch.Tensor:
    """A new float64 tensor of ``x`` (a tensor, numpy array or scalar) on
    ``device``, as ``np.asarray(x, dtype=np.float64)``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float64, copy=True)
    return torch.from_numpy(np.array(x, dtype=np.float64)).to(device)


def _fold_allreduce(
    me: str,
    own_weights: Any,
    own_samples: float,
    received: Sequence[Tuple[str, Any]],
    device: Any,
) -> Tuple[Any, int]:
    """Sample-weighted mean of own + received models, folded in sorted
    worker-id order so every ring member, whatever the arrival order, lands
    on byte-identical consensus weights.

    The JAX package folds in float64 numpy: ``x.astype(float64) * n``, an
    add, then ``(acc / total).astype(float32)``. Here the same operations
    run on ``device``, leaf by leaf, into one float64 accumulator updated in
    place, so the only temporary is one leaf's scaled copy. The divide is by
    a 0-d float64 tensor: a CUDA ``tensor / python_float`` is a reciprocal
    multiply, not an IEEE divide."""
    contributions = sorted(
        [(me, {"weights": own_weights, "num_samples": own_samples})] + list(received),
        key=lambda t: t[0],
    )
    device = torch.device(device)
    samples = [float(msg.get("num_samples", 1)) for _, msg in contributions]
    total = 0.0
    for n in samples:
        total += n
    flats = []
    treedef = None
    for _, msg in contributions:
        leaves, td = tree_flatten(msg["weights"])
        if treedef is not None and td != treedef:
            raise ValueError(f"tree structures differ: {treedef!r} vs {td!r}")
        treedef = td
        flats.append(leaves)
    total_t = torch.tensor(total, dtype=torch.float64, device=device)
    out = []
    for i in range(len(flats[0])):
        acc = None
        for leaves, n in zip(flats, samples):
            scaled = _float64_copy(leaves[i], device)
            scaled.mul_(n)
            if acc is None:
                acc = scaled
            else:
                acc.add_(scaled)
            del scaled  # not alive beside the accumulator during the divide
        out.append(acc.div_(total_t).to(torch.float32))
    return tree_unflatten(treedef, out), int(total)


class Role(abc.ABC):
    """Base of all role programs. ``compose()`` builds the tasklet chain,
    ``run()`` executes it."""

    def __init__(self, ctx: RoleContext) -> None:
        self.ctx = ctx
        self.config = ctx.hyperparams
        self.composer: Optional[Composer] = None
        self._work_done = False
        self.rounds = int(self.config.get("rounds", 3))
        self._round = 0
        self.metrics: List[Dict[str, float]] = []
        self._protocol: Any = None  # lazily-bound RoundProtocol

    # -------- user-implemented core functions (paper Fig. 5) ---------- #
    def initialize(self) -> None:  # pragma: no cover - overridden
        pass

    def load_data(self) -> None:  # pragma: no cover - overridden
        pass

    def train(self) -> None:  # pragma: no cover - overridden
        pass

    def evaluate(self) -> None:  # pragma: no cover - overridden
        pass

    @abc.abstractmethod
    def compose(self) -> None:
        ...

    # -------------------------- round protocol ------------------------ #
    def _protocol_channel(self) -> Optional[str]:
        """The channel whose TAG ``protocol`` attribute selects this role's
        round protocol; ``None`` resolves the ``weight-sync`` default."""
        return None

    def _protocol_name(self, channel: Optional[str]) -> str:
        """``round_protocol`` hyperparam > TAG channel attribute > default."""
        name = str(self.config.get("round_protocol", "") or "")
        if not name and channel is not None:
            for c in self.ctx.tag.channels_of(self.ctx.worker.role):
                if c.name == channel and getattr(c, "protocol", ""):
                    name = c.protocol
                    break
        return name or "weight-sync"

    @property
    def protocol(self) -> Any:
        """The ``RoundProtocol`` bound to this role, resolved lazily on first
        use (subclasses may rebind their protocol channel after
        ``__init__``)."""
        if self._protocol is None:
            from repro_torch.core.protocols import make_protocol

            channel = self._protocol_channel()
            self._protocol = make_protocol(
                self._protocol_name(channel), self, channel
            )
        return self._protocol

    def pre_run(self) -> None:
        """Join this worker's channels. Runs before any chain executes (the
        runtime barriers between pre_run and run to avoid join races)."""
        for channel in self.ctx.worker.groups:
            self.ctx.end(channel)

    def run(self) -> None:
        if self.composer is None:
            self.compose()
        assert self.composer is not None
        self.protocol.rewrite_chain(self.composer)
        self.composer.run()

    def on_dropped(self, at: float) -> None:
        """Cancellation hook: the runtime calls this when the worker's virtual
        clock crossed its scheduled dropout time. Leaves every joined channel
        so peers' ``ends()`` stop seeing the dead worker."""
        self.metrics.append({"dropped_at": at})
        for end in list(self.ctx._ends.values()):
            end.leave()


# ====================================================================== #
# Classical / Hierarchical FL roles
# ====================================================================== #
class Trainer(Role):
    """Leaf trainer: fetch global weights, train locally, upload update.

    What crosses the wire each step lives in the channel's
    ``RoundProtocol`` (default ``weight-sync``); the chain below is only the
    shape of a round. ``train`` must not modify the fetched tensors in
    place: the in-process transport delivers the server's tensors by
    reference.
    """

    param_channel = "param-channel"

    def __init__(self, ctx: RoleContext) -> None:
        super().__init__(ctx)
        self.weights: Any = None
        self.num_samples: int = int(self.config.get("num_samples", 1))
        self._server_version: Optional[int] = None
        # a trainer on a single unconventionally-named channel binds to it
        # without a subclass
        chans = [c.name for c in ctx.tag.channels_of(ctx.worker.role)]
        if chans and self.param_channel not in chans and len(chans) == 1:
            self.param_channel = chans[0]

    def _protocol_channel(self) -> Optional[str]:
        return self.param_channel

    # ----------------------------- tasklets --------------------------- #
    def fetch(self) -> None:
        self.protocol.fetch()

    def upload(self) -> None:
        self.protocol.upload()

    def compose(self) -> None:
        with Composer() as composer:
            self.composer = composer
            tl_load = Tasklet("load", self.load_data)
            tl_init = Tasklet("init", self.initialize)
            tl_fetch = Tasklet("fetch", self.fetch)
            tl_train = Tasklet("train", self.train)
            tl_eval = Tasklet("evaluate", self.evaluate)
            tl_upload = Tasklet("upload", self.upload)
            loop = Loop(loop_check_fn=lambda: self._work_done)
            tl_load >> tl_init >> loop(
                tl_fetch >> tl_train >> tl_eval >> tl_upload
            )


class _AggregatorBase(Role):
    """Shared distribute/aggregate machinery for aggregator-like roles.

    The job's ``init_weights`` (numpy arrays or tensors) are carried onto
    the job's device at construction."""

    down_channel = "param-channel"  # towards trainers

    def __init__(self, ctx: RoleContext) -> None:
        super().__init__(ctx)
        self.weights: Any = tree_from_numpy(self.config.get("init_weights"), ctx.device)
        self.agg_weights: Any = None
        self.agg_samples: int = 0
        self._server_version: Optional[int] = None
        # high-water mark of client update trees held at once while folding:
        # the streaming path keeps this at 1 regardless of group size
        self.peak_buffered: int = 0

    def _protocol_channel(self) -> Optional[str]:
        return self.down_channel

    def distribute(self) -> None:
        self.protocol.distribute()

    def aggregate(self) -> None:
        self.protocol.aggregate()


class Aggregator(_AggregatorBase):
    """Intermediate aggregator of H-FL: aggregates its group, relays upward."""

    up_channel = "global-channel"

    def fetch(self) -> None:
        end = self.ctx.end(self.up_channel)
        msg = end.recv(await_peer(self.ctx, end))
        self.weights = msg["weights"]
        self._server_version = msg.get("version", self._server_version)
        self._work_done = bool(msg.get("done", False))
        bridge_clock(self.ctx, self.down_channel)

    def upload(self) -> None:
        if self._work_done:
            return
        end = self.ctx.end(self.up_channel)
        bridge_clock(self.ctx, self.up_channel)
        self.ctx.advance_clock(
            self.up_channel, float(self.config.get("compute_time", 0.0))
        )
        end.send(
            await_peer(self.ctx, end),
            self.protocol.pack_update(
                self.weights, self.agg_samples, self._server_version
            ),
        )

    def compose(self) -> None:
        with Composer() as composer:
            self.composer = composer
            tl_init = Tasklet("init", self.initialize)
            tl_fetch = Tasklet("fetch", self.fetch)
            tl_dist = Tasklet("distribute", self.distribute)
            tl_agg = Tasklet("aggregate", self.aggregate)
            tl_upload = Tasklet("upload", self.upload)
            loop = Loop(loop_check_fn=lambda: self._work_done)
            tl_init >> loop(tl_fetch >> tl_dist >> tl_agg >> tl_upload)


class GlobalAggregator(_AggregatorBase):
    """Root aggregator: drives the rounds and owns the global model."""

    down_channel = "param-channel"

    def check_rounds(self) -> None:
        self._round += 1
        self.metrics.append({"round": self._round})
        if self._round >= self.rounds:
            self._work_done = True

    def end_of_train(self) -> None:
        if self._work_done:
            # final broadcast tells everyone to exit their loops
            self.distribute()

    def compose(self) -> None:
        with Composer() as composer:
            self.composer = composer
            tl_init = Tasklet("init", self.initialize)
            tl_dist = Tasklet("distribute", self.distribute)
            tl_agg = Tasklet("aggregate", self.aggregate)
            tl_eval = Tasklet("evaluate", self.evaluate)
            tl_round = Tasklet("check_rounds", self.check_rounds)
            tl_end = Tasklet("end_of_train", self.end_of_train)
            loop = Loop(loop_check_fn=lambda: self._work_done)
            tl_init >> loop(
                tl_dist >> tl_agg >> tl_eval >> tl_round
            ) >> tl_end


class HFLGlobalAggregator(GlobalAggregator):
    """Global aggregator of H-FL: same workflow, down channel is the
    aggregator-facing channel."""

    down_channel = "global-channel"


class _AutoChannelGlobalAggregator(GlobalAggregator):
    """Root aggregator that binds to ``global-channel`` or ``param-channel``,
    whichever its TAG role has, else its only channel."""

    def __init__(self, ctx: RoleContext) -> None:
        super().__init__(ctx)
        chans = [c.name for c in ctx.tag.channels_of(ctx.worker.role)]
        for preferred in ("global-channel", "param-channel"):
            if preferred in chans:
                self.down_channel = preferred
                break
        else:
            self.down_channel = chans[0]


# The original root-aggregator class: the runtime uses it to recognize the
# root of the aggregation tree.
GlobalAggregatorBase = GlobalAggregator

# Make GlobalAggregator channel-aware by default.
GlobalAggregator = _AutoChannelGlobalAggregator  # type: ignore[misc]


# ====================================================================== #
# Distributed / Hybrid roles
# ====================================================================== #
class DistributedTrainer(Trainer):
    """Distributed learning (Fig 2b): ring all-reduce among trainers, no
    aggregator. Reuses the Trainer chain; fetch/upload are replaced by an
    allreduce tasklet via the Table 1 API."""

    ring_channel = "ring-channel"

    def __init__(self, ctx: RoleContext) -> None:
        super().__init__(ctx)
        # no aggregator to fetch initial weights from: start from the job's
        # init_weights (every trainer starts identically)
        if self.weights is None:
            self.weights = tree_from_numpy(self.config.get("init_weights"), ctx.device)

    def allreduce(self) -> None:
        end = self.ctx.end(self.ring_channel)
        # send in sorted-peer order and drain one mailbox per peer in the
        # same order, then fold in sorted worker-id order: ring results are
        # run-to-run reproducible on every backend
        peers = sorted(end.ends())
        update = {"weights": self.weights, "num_samples": self.num_samples}
        for peer in peers:
            end.send(peer, update)
        received = [(src, end.recv(src)) for src in peers]
        self.weights, _ = _fold_allreduce(
            end.me, self.weights, float(self.num_samples), received, self.ctx.device
        )
        self._round += 1
        if self._round >= self.rounds:
            self._work_done = True

    def compose(self) -> None:
        super().compose()
        assert self.composer is not None
        with CloneComposer(self.composer) as composer:
            self.composer = composer
            tl_ar = Tasklet("allreduce", self.allreduce)
            composer.get_tasklet("fetch").remove()
            composer.get_tasklet("upload").replace_with(tl_ar)


class HybridTrainer(Trainer):
    """Hybrid FL (Fig 2e): intra-cluster all-reduce on the fast P2P channel;
    only the cluster leader uploads to / fetches from the global aggregator.

    Leadership is elected: the leader is the lowest-ranked live member of
    the cluster (static expansion order filtered by ring membership), so a
    cluster survives its leader dropping mid-round. Each round the leader's
    in-cluster re-broadcast pins the round cohort and a monotonically
    increasing ``cluster_round`` stamp; the all-reduce exchanges only within
    the pinned cohort and discards stale stamps, so a worker re-joining
    mid-round syncs up at the next round broadcast.

    Known limitation (as in the JAX package): a leader that drops after the
    aggregator sent it the round weights but before its in-cluster
    re-broadcast loses that broadcast; under a sync aggregator the cluster
    then only recovers at the next round's distribute.
    """

    ring_channel = "ring-channel"

    def __init__(self, ctx: RoleContext) -> None:
        super().__init__(ctx)
        self._cluster_round = 0
        self._cohort: List[str] = []
        self._said_hello = False

    def _live_members(self) -> List[str]:
        """Static cluster members filtered to the ones currently on the ring
        (in static order: rank survives dropouts and re-joins)."""
        me = self.ctx.worker.worker_id
        end = self.ctx.end(self.ring_channel)
        live = set(end.ends()) | {me}
        static = self.ctx.static_members.get(self.ring_channel)
        if static:
            return [m for m in static if m in live]
        return sorted(live)

    def _cluster_rank(self) -> Tuple[int, List[str]]:
        members = self._live_members()
        return members.index(self.ctx.worker.worker_id), members

    def pre_run(self) -> None:
        """Non-leaders never join the uplink channel, so the aggregator's
        ``ends()`` sees exactly one leader per cluster."""
        self.ctx.end(self.ring_channel)
        rank, _ = self._cluster_rank()
        if rank == 0:
            self.ctx.end(self.param_channel)

    def cluster_allreduce(self) -> None:
        if self._work_done:
            return
        end = self.ctx.end(self.ring_channel)
        me = end.me
        cohort = [m for m in (self._cohort or self._live_members()) if m != me]
        if not cohort:
            self._cluster_samples = self.num_samples
            self._cluster_round += 1
            return
        update = {
            "weights": self.weights,
            "num_samples": self.num_samples,
            "cluster_round": self._cluster_round,
        }
        live = set(end.ends())
        for peer in sorted(cohort):
            if peer in live:  # skip cohort members that already dropped
                end.send(peer, update)
        received = []
        for src in sorted(cohort):  # sorted per-src drain: deterministic
            msg = self._recv_cluster(end, src)
            if msg is not None:
                received.append((src, msg))
        self.weights, self._cluster_samples = _fold_allreduce(
            me, self.weights, float(self.num_samples), received, self.ctx.device
        )
        self._cluster_round += 1

    def _recv_cluster(self, end: ChannelEnd, src: str) -> Optional[Dict[str, Any]]:
        """One cohort member's round-stamped all-reduce contribution.

        Tolerates mid-round dropout (``None``: fold without the dead member)
        and skips stale messages: leftover round broadcasts share the
        leader's mailbox, and a re-joined worker's mailbox can hold
        contributions from rounds it missed."""
        deadline = time.monotonic() + float(self.config.get("grace", 30.0))
        while True:
            try:
                msg = end.recv(src, timeout=0.25)
            except queue.Empty:
                end.check_poison()
                if src not in end.ends():
                    return None  # dropped mid-round
                if time.monotonic() >= deadline:
                    raise RuntimeError(
                        f"{end.me}: cluster member {src!r} sent no round-"
                        f"{self._cluster_round} all-reduce contribution"
                    )
                continue
            if "members" in msg:
                continue  # a round broadcast this worker already moved past
            if "hello" in msg:
                if int(msg["hello"]) < self._cluster_round:
                    # a fresh incarnation of ``src`` (re-joined mid-job): no
                    # contribution is coming this round
                    return None
                continue  # cold-start hello; src will still contribute
            if int(msg.get("cluster_round", self._cluster_round)) != self._cluster_round:
                continue  # stale contribution from a missed round
            return msg

    def fetch(self) -> None:
        """The elected leader fetches from the aggregator and re-broadcasts
        in-cluster with the round cohort pinned; everyone else waits for the
        broadcast, re-electing whenever the current leader drops."""
        ring = self.ctx.end(self.ring_channel)
        if not self._said_hello:
            # first fetch of this incarnation: announce it, so a peer
            # mid-all-reduce stops waiting for a contribution this
            # incarnation never saw the round broadcast for
            hello = {"hello": self._cluster_round}
            for m in self._live_members():
                if m != ring.me:
                    ring.send(m, hello)
            self._said_hello = True
        deadline = time.monotonic() + float(self.config.get("grace", 30.0))
        while True:
            rank, members = self._cluster_rank()
            if rank == 0:
                super().fetch()  # joins the uplink on first election
                self._cohort = members
                bcast = {
                    "weights": self.weights,
                    "done": self._work_done,
                    "cluster_round": self._cluster_round,
                    "members": members,
                }
                # relay the server version so a member promoted to leader
                # mid-job echoes it on its first upload
                if self._server_version is not None:
                    bcast["version"] = self._server_version
                ring.broadcast(bcast)
                return
            try:
                msg = ring.recv(members[0], timeout=0.25)
            except queue.Empty:
                ring.check_poison()
                if time.monotonic() >= deadline:
                    raise RuntimeError(
                        f"{ring.me}: no round broadcast from cluster leader "
                        f"{members[0]!r}"
                    )
                continue  # leader may have dropped: re-elect and retry
            if "members" not in msg:
                continue  # an all-reduce leftover from a round this worker missed
            if int(msg.get("cluster_round", 0)) < self._cluster_round:
                continue  # stale round broadcast
            self.weights = msg["weights"]
            self._work_done = bool(msg.get("done", False))
            self._server_version = msg.get("version", self._server_version)
            self._cluster_round = int(msg.get("cluster_round", self._cluster_round))
            self._cohort = list(msg.get("members", members))
            return

    def upload(self) -> None:
        """Only the cluster leader uploads one cluster-level model. The
        leader is re-resolved against the round cohort's live members, so a
        mid-round leader dropout promotes the next cohort member."""
        if self._work_done:
            return
        me = self.ctx.worker.worker_id
        ring = self.ctx.end(self.ring_channel)
        live = set(ring.ends()) | {me}
        leaders = [m for m in (self._cohort or [me]) if m in live]
        if not leaders or leaders[0] != me:
            return
        end = self.ctx.end(self.param_channel)  # a promoted leader joins here
        end.send(
            await_peer(self.ctx, end),
            self.protocol.pack_update(
                self.weights,
                getattr(self, "_cluster_samples", self.num_samples),
                self._server_version,
            ),
        )

    def compose(self) -> None:
        super().compose()
        assert self.composer is not None
        with CloneComposer(self.composer) as composer:
            self.composer = composer
            tl_ar = Tasklet("cluster_allreduce", self.cluster_allreduce)
            composer.get_tasklet("upload").insert_before(tl_ar)
