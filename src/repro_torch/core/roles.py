"""Role base programs — the user programming model (§4.4, Fig. 4/5), the
port of ``repro.core.roles``.

Base classes implement the full tasklet workflow for each standard role
(trainer, aggregator, global aggregator); a user subclass only fills in
``initialize / load_data / train / evaluate``. Weight trees hold
``torch.Tensor``s on the job's device (``RoleContext.device``).

Not ported yet: the distributed and hybrid roles and ``_fold_allreduce``.
"""
from __future__ import annotations

import abc
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.convert import tree_from_numpy
from repro_torch.core.channels import ChannelEnd, ChannelManager
from repro_torch.core.composer import Composer, Loop, Tasklet
from repro_torch.core.expansion import WorkerConfig
from repro_torch.core.tag import TAG
from repro_torch.core.tree import tree_leaves
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
    trees through the streaming fold, whose errors surface as the JAX
    package's sequential path raises them. Both are bit-identical to the
    JAX package's ``weighted_mean``. Unlike the JAX package there is no
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
    package (``fmul`` by float32(n), ``fadd`` into the accumulator, which
    starts from the first scaled update), and ``finalize`` one IEEE divide
    by float32(total). Leaves must be float32 tensors; a numpy leaf raises
    ``TypeError``. With ``device`` set (the job's device), a leaf on another
    device raises ``TypeError`` too, so a CUDA job never folds on the host.
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
            where = getattr(leaf, "device", type(leaf).__name__)
            if not isinstance(leaf, torch.Tensor) or where != self.device:
                raise TypeError(f"update leaf on {where}; the job runs on {self.device}")

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
