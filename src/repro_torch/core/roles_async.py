"""Asynchronous and semi-synchronous aggregator programs (root and
intermediate), the port of ``repro.core.roles_async``.

These are the lowering targets of ``RuntimePolicy``: the same TAG whose
aggregation tree is built from ``GlobalAggregator`` / ``Aggregator``
subclasses executes

* ``mode="sync"``     — the classic barriered rounds (unchanged base class);
* ``mode="deadline"`` — semi-sync partial participation: each round closes at
  a straggler deadline on the virtual clock; late updates are excluded (and
  discarded by model-version check when they eventually arrive);
* ``mode="async"``    — FedBuff-style buffered async aggregation (Nguyen et
  al. 2022): the server reacts to whichever trainer finishes first, weights
  each update by its staleness, and applies the buffer every K updates.

Lowering is hierarchy-wide: ``RuntimePolicy.tiers`` assigns a mode per
role, so an intermediate H-FL aggregator can collect from its group under
its own deadline (``DeadlineAggregatorMixin``) or FedBuff buffer
(``AsyncAggregatorMixin``) and relay staleness-annotated partial aggregates
upward. ``make_policy_program(base_cls, mode)`` grafts the matching mixin
onto the user's aggregator class, so user ``initialize``/``evaluate`` hooks
survive the lowering.

Device: weights, snapshots, deltas and the strategy's accumulator are
tensors on the job's device. A deadline round folds through
``StreamingMean`` (the fold kernel's tree entry, then its divide); an async
server folds each update at arrival through the strategy's
``accumulate_stream`` (the same tree entry, on an explicit zeros
accumulator). A restored checkpoint's tensors go onto the job's device
before any fold.
"""
from __future__ import annotations

import json
import os
import queue
import time
from typing import Any, Dict, List, Optional, Tuple, Type

import numpy as np
import torch

from repro_torch import checkpoint
from repro_torch.core.channels import WorkerDropped, recv_any_multi
from repro_torch.core.composer import Composer, Loop, Tasklet
from repro_torch.core.protocols import pack_broadcast, pack_update
from repro_torch.core.roles import Role, StreamingMean, await_peer, bridge_clock
from repro_torch.core.tree import tree_map


def _tree_sub(a: Any, b: Any) -> Any:
    """``a - b`` leaf by leaf; both trees on the job's device."""
    return tree_map(torch.sub, a, b)


def _tree_copy(t: Any) -> Any:
    return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else np.asarray(x), t)


def _json_py(o: Any) -> Any:
    """JSON fallback keeping checkpointed logs equal (under ``==``) to the
    live ones: numpy scalars and 0-d tensors to their Python counterparts."""
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, torch.Tensor):
        return o.tolist()
    raise TypeError(f"not JSON-serializable: {type(o).__name__}")


class _SnapshotStore:
    """Bounded per-version weight snapshots for staleness-based deltas.

    A policy server needs the snapshot a trainer trained from to compute the
    update's delta. The store keeps only versions within the maximum
    staleness observed so far (plus a one-version margin) and clamps
    requests for evicted versions to the oldest retained snapshot, reporting
    the clamp so the caller can log the staleness it weighted with.
    """

    def __init__(self) -> None:
        self._snaps: Dict[int, Any] = {}
        self._window = 1  # max staleness observed so far

    def __len__(self) -> int:
        return len(self._snaps)

    def versions(self) -> List[int]:
        return sorted(self._snaps)

    @property
    def window(self) -> int:
        return self._window

    def put(self, version: int, weights: Any, keep_from: Optional[int] = None) -> None:
        """Store ``version`` and evict what no live client can still need.

        ``keep_from`` is the version-vector floor: the oldest version any
        tracked client was last handed (minus an in-flight margin). Without
        it, eviction falls back to the observed-staleness window alone."""
        self._snaps[version] = weights
        floor = version - self._window - 1
        if keep_from is not None:
            floor = min(floor, keep_from)
        for v in [v for v in self._snaps if v < floor]:
            del self._snaps[v]

    def base_for(self, trained_from: int, current: int) -> Tuple[Any, int, bool]:
        """``(base_weights, effective_staleness, clamped)`` for an update that
        trained from ``trained_from`` while the server is at ``current``."""
        if trained_from in self._snaps:
            staleness = max(0, current - trained_from)
            clamped = False
        else:
            trained_from = min(self._snaps)
            staleness = max(0, current - trained_from)
            clamped = True
        self._window = max(self._window, staleness)
        return self._snaps[trained_from], staleness, clamped


class _PolicyBase:
    """Shared policy plumbing for the deadline/async mixins (any tier)."""

    def __init__(self, ctx) -> None:
        super().__init__(ctx)
        # the mixins lower how weight-sync rounds run, no other round
        # protocol: fail at program-build time rather than deadlock mid-round
        declared = str(self.config.get("round_protocol", "") or "")
        if not declared:
            for c in ctx.tag.channels_of(ctx.worker.role):
                if getattr(c, "protocol", "") and c.protocol != "weight-sync":
                    declared = c.protocol
                    break
        if declared and declared != "weight-sync":
            raise RuntimeError(
                f"runtime policies (deadline/async) only lower the "
                f"'weight-sync' round protocol, but role "
                f"{ctx.worker.role!r} declares {declared!r}; run this "
                "topology under the sync policy"
            )

    def _policy(self) -> Any:
        pol = self.config.get("runtime_policy")
        if pol is None:
            raise RuntimeError("policy-lowered aggregator needs 'runtime_policy'")
        # per-tier overrides: this role's view of the policy's knobs
        return pol.for_role(self.ctx.worker.role)

    def _down(self):
        return self.ctx.end(self.down_channel)

    def _trainers(self) -> List[str]:
        return sorted(self._down().ends())

    # ------------------------- checkpoint-restart ---------------------- #
    # Periodic crash checkpoints, keyed by the ``checkpoint_every`` and
    # ``checkpoint_dir`` hyperparams (both required). Each policy server
    # writes under its own subdirectory, so every tier checkpoints alone.
    def _ckpt_every(self) -> int:
        return int(self.config.get("checkpoint_every", 0) or 0)

    def _ckpt_dir(self) -> Optional[str]:
        base = str(self.config.get("checkpoint_dir", "") or "")
        if self._ckpt_every() <= 0 or not base:
            return None
        return os.path.join(base, self.ctx.worker.worker_id)

    def _ckpt_state(self) -> Dict[str, Any]:  # pragma: no cover - overridden
        raise NotImplementedError

    def _maybe_checkpoint(self) -> None:
        """Persist the server state tree every ``checkpoint_every`` versions
        (atomic, step-indexed: ``repro_torch.checkpoint``)."""
        directory = self._ckpt_dir()
        if directory is None or self._version % self._ckpt_every() != 0:
            return
        checkpoint.save(directory, self._version, self._ckpt_state())

    def _collect_deadline(
        self, expected: List[str], version: int, round_start: float
    ) -> Tuple[List[Tuple[str, Any, float]], List[Tuple[str, Any, float]], set, float]:
        """Drain ``version``-stamped updates from ``expected`` until the
        straggler deadline (virtual clock) or the wall-clock grace expires.

        Returns ``(on_time, late, remaining, round_end)``, each update as
        ``(src, msg, arrival)``, after advancing this worker's down-channel
        clock to the round end (and honoring its own dropout schedule)."""
        pol = self._policy()
        deadline = round_start + float(pol.deadline)
        end = self._down()
        remaining = set(expected)
        arrived: List[Tuple[str, Any, float]] = []
        grace_end = time.monotonic() + float(pol.grace)
        while remaining:
            timeout = grace_end - time.monotonic()
            if timeout <= 0:
                break
            # peers scheduled to drop before the deadline may still have
            # delivered an on-time update: keep draining, but only briefly.
            # drop_time is read once per peer (a concurrent re-join clears it)
            live = []
            for t in remaining:
                drop_at = end.drop_time(t)
                if drop_at is None or drop_at > deadline:
                    live.append(t)
            if not live:
                timeout = min(timeout, 0.25)
            try:
                src, msg, arrival = end.recv_any(
                    sorted(remaining), timeout=timeout, advance=False
                )
            except queue.Empty:
                if not live:
                    break
                continue
            if msg.get("version") != version:
                continue  # stale leftover from a missed deadline: discard
            arrived.append((src, msg, arrival))
            remaining.discard(src)

        on_time = [a for a in arrived if a[2] <= deadline]
        late = [a for a in arrived if a[2] > deadline]
        # partial-participation floor: admit the earliest stragglers if the
        # deadline left too few updates (extends the round past the deadline)
        need = max(0, int(pol.min_participants) - len(on_time))
        if need:
            late.sort(key=lambda a: a[2])
            on_time.extend(late[:need])
            late = late[need:]

        # the round closes at the deadline when anyone was cut or missing,
        # else at the last on-time arrival
        cut = bool(late) or bool(remaining)
        last_arrival = max((a[2] for a in on_time), default=round_start)
        round_end = max(deadline if cut else last_arrival, last_arrival)
        if not np.isfinite(round_end):
            round_end = last_arrival
        me = self.ctx.worker.worker_id
        end.set_clock(round_end)
        drop_at = end.drop_time()
        if drop_at is not None and round_end > drop_at:
            raise WorkerDropped(me, drop_at)
        return on_time, late, remaining, round_end


class _DeadlineBase(_PolicyBase):
    """Shared round plumbing of the deadline root and intermediate mixins:
    version-stamped round opening, deadline-bounded collection with
    participation logging, and the sub-round version counter."""

    def __init__(self, ctx) -> None:
        super().__init__(ctx)
        self._version = 0
        self._round_start = 0.0
        self._expected: List[str] = []
        self.participation_log: List[Dict[str, Any]] = []

    def _open_round(self, done: bool = False) -> None:
        """Stamp the current weights with the sub-round version (echoed by
        the group, used to discard leftovers from missed deadlines) and
        start the round clock."""
        end = self._down()
        self._expected = self._trainers()
        self._round_start = self.ctx.now(self.down_channel)
        end.send_many(
            self._expected, pack_broadcast(self.weights, done, self._version)
        )

    def _close_round(self) -> None:
        """Collect under the deadline, fold the on-time updates into the
        model, log participation and bump the sub-round version."""
        on_time, late, remaining, round_end = self._collect_deadline(
            self._expected, self._version, self._round_start
        )
        # fold in sorted-src order, not arrival order: virtual-arrival ties
        # are broken by thread timing, so an arrival-order fold would make
        # seeded deadline rounds drift by an ulp from run to run
        acc = StreamingMean(device=self.ctx.device)
        for _, m, _ in sorted(on_time, key=lambda a: a[0]):
            acc.fold(m["weights"], float(m.get("num_samples", 1)))
        agg, total = acc.finalize()
        if agg is not None:
            self.agg_weights = agg
            self.agg_samples = int(total)
            self.weights = agg
        else:
            # nothing arrived on time: keep the current model and carry zero
            # sample weight so an upstream tier ignores the relay
            self.agg_samples = 0
        self.participation_log.append(
            {
                "round": self._version,
                "included": sorted(s for s, _, _ in on_time),
                "excluded": sorted(s for s, _, _ in late),
                "missing": sorted(remaining),
                "round_time": round_end - self._round_start,
            }
        )
        self.peak_buffered = max(self.peak_buffered, acc.peak_buffered)
        # the sync aggregate step's metrics; policy collection classifies
        # each update on its own, so no hub reduce: frames equal folds
        self.metrics.append({
            "agg_folds": acc.count,
            "agg_frames": acc.count,
            "peak_buffered": self.peak_buffered,
        })
        self._version += 1
        self._maybe_checkpoint()

    def _ckpt_state(self) -> Dict[str, Any]:
        meta = {
            "participation_log": self.participation_log,
            "metrics": self.metrics,
        }
        return {
            "weights": self.weights,
            "version": np.int64(self._version),
            "meta": np.array(json.dumps(meta, default=_json_py)),
        }


class DeadlineRootMixin(_DeadlineBase):
    """Per-round straggler deadline on the virtual clock (semi-sync root)."""

    # --------------------------- tasklets ----------------------------- #
    def begin_round(self) -> None:
        self._open_round()

    def collect(self) -> None:
        self._close_round()

    def check_rounds(self) -> None:
        if not self.participation_log:
            raise RuntimeError(
                "DeadlineRootMixin.check_rounds ran with an empty "
                "participation_log: the deadline workflow requires "
                "begin_round >> collect before check_rounds — did a subclass "
                "reorder the tasklet chain?"
            )
        self._round += 1
        self.metrics.append(
            {
                "round": self._round,
                "round_time": self.participation_log[-1]["round_time"],
            }
        )
        if self._round >= self.rounds:
            self._work_done = True

    def end_of_train(self) -> None:
        end = self._down()
        end.send_many(self._trainers(), pack_broadcast(self.weights, True))

    def compose(self) -> None:
        with Composer() as composer:
            self.composer = composer
            tl_init = Tasklet("init", self.initialize)
            tl_begin = Tasklet("begin_round", self.begin_round)
            tl_collect = Tasklet("collect", self.collect)
            tl_eval = Tasklet("evaluate", self.evaluate)
            tl_round = Tasklet("check_rounds", self.check_rounds)
            tl_end = Tasklet("end_of_train", self.end_of_train)
            loop = Loop(loop_check_fn=lambda: self._work_done)
            tl_init >> loop(
                tl_begin >> tl_collect >> tl_eval >> tl_round
            ) >> tl_end


class _BufferedAsyncBase(_PolicyBase):
    """Shared FedBuff machinery of the async root and async intermediate."""

    def __init__(self, ctx) -> None:
        super().__init__(ctx)
        self._version = 0
        self._snapshots = _SnapshotStore()
        self._strategy = None
        self._strategy_state = None
        self._greeted: set = set()
        # client -> last version handed to it (the downward version vector);
        # bounds snapshot eviction so a slow client's base stays available
        self._version_vector: Dict[str, int] = {}
        self.staleness_log: List[Dict[str, Any]] = []
        # high-water mark of unabsorbed delta trees held at once: each delta
        # is folded into the strategy state at arrival, so this stays 1
        self.peak_buffered = 0

    def _init_strategy(self) -> None:
        from repro_torch.fl.strategies import get_strategy

        pol = self._policy()
        name = str(self.config.get("async_strategy", "fedbuff"))
        if name == "fedbuff":
            self._strategy = get_strategy(
                "fedbuff",
                buffer_size=int(pol.buffer_size),
                server_lr=float(self.config.get("server_lr", 1.0)),
                staleness_exp=float(pol.staleness_exp),
            )
        elif name == "fedasync":
            self._strategy = get_strategy(
                "fedasync",
                alpha=float(self.config.get("async_alpha", 0.6)),
                staleness_exp=float(pol.staleness_exp),
            )
        else:
            raise ValueError(
                f"async mode needs a buffered strategy, got {name!r} "
                "(one of: fedbuff, fedasync)"
            )
        self._strategy_state = self._strategy.init(self.weights)

    def _send_weights(self, end, client: str, version: int, done: bool = False) -> None:
        """Send the current weights to ``client`` and record the handed-out
        version in the version vector (drives snapshot retention)."""
        self._version_vector[client] = version
        end.send(client, pack_broadcast(self.weights, done, version))

    def _snapshot_floor(self) -> int:
        """Oldest version a tracked client may still be training from: its
        last handed version minus one (an upload based on the previous
        hand-out can still be in flight when a new one is sent)."""
        if not self._version_vector:
            return self._version
        return min(self._version_vector.values()) - 1

    def _prune_version_vector(self, members: set) -> None:
        """Forget clients that left the channel, so a dead straggler cannot
        pin old snapshots in memory forever, and clients whose scheduled
        dropout lies before this server's clock with no message of theirs
        waiting here: they are dead in virtual time though their leave may
        not have reached the channel yet (over processes it comes a
        wall-clock moment after the drop, and without this rule the vector
        would depend on that moment). An upload sent before the drop and
        still waiting keeps its sender, and so its base snapshot."""
        end = self._down()
        scheduled = bool(self._version_vector) and bool(self._policy().dropouts)
        now = end.now() if scheduled else 0.0
        for t in list(self._version_vector):
            if t not in members:
                del self._version_vector[t]
                continue
            at = end.drop_time(t) if scheduled else None
            if at is not None and at < now and end.earliest([t]) is None:
                del self._version_vector[t]

    def _absorb(self, src: str, msg: Any, arrival: float) -> bool:
        """Fold one update into the strategy state at arrival
        (``accumulate_stream``: one tree fold); when the strategy reports a
        full buffer, apply it, bump the local version and snapshot. Returns
        True when a new version was produced.

        The delta and its staleness are resolved against the snapshot the
        sender trained from; no delta tree is retained, so server memory is
        O(1) in client count and buffer size."""
        # an unstamped update (sync-tier sender) counts as fresh, not maximal
        trained_from = int(msg.get("version", self._version))
        base, staleness, clamped = self._snapshots.base_for(
            trained_from, self._version
        )
        delta = _tree_sub(msg["weights"], base)
        entry = {
            "src": src, "staleness": staleness, "version": self._version,
            "arrival": arrival,
        }
        if clamped:
            entry["clamped"] = True
        self.staleness_log.append(entry)
        self.peak_buffered = max(self.peak_buffered, 1)
        # the JAX package's ``fused_aggregation`` switch changes nothing here
        self._strategy_state = self._strategy.accumulate_stream(
            self._strategy_state, delta, int(staleness)
        )
        del delta
        if not bool(self._strategy.ready(self._strategy_state)):
            return False
        # ``apply`` returns new tensors: nothing else holds them, so they
        # are the snapshot as they are
        self.weights, self._strategy_state = self._strategy.apply(
            self.weights, None, self._strategy_state
        )
        self._version += 1
        self._snapshots.put(
            self._version, self.weights, keep_from=self._snapshot_floor()
        )
        self._maybe_checkpoint()
        return True

    def _ckpt_state(self) -> Dict[str, Any]:
        """The full FedBuff server state as one checkpointable tree: model
        weights, version and version vector, the snapshot store, the
        streaming strategy state ({"acc": tree, "count": int32}) and the
        JSON-able logs and metrics as a 0-d string leaf, so a restore
        reproduces the server's observable history too."""
        meta = {
            "staleness_log": self.staleness_log,
            "metrics": self.metrics,
            "round": int(getattr(self, "_round", 0)),
            "peak_buffered": int(self.peak_buffered),
            "snapshot_window": int(self._snapshots.window),
        }
        return {
            "weights": self.weights,
            "version": np.int64(self._version),
            "version_vector": {
                c: np.int64(v) for c, v in self._version_vector.items()
            },
            "snapshots": {
                str(v): w for v, w in self._snapshots._snaps.items()
            },
            "strategy": self._strategy_state,
            "meta": np.array(json.dumps(meta, default=_json_py)),
        }

    def _restore_latest(self) -> bool:
        """Crash recovery: rebuild the server from its newest checkpoint.

        Returns False (cold start) when checkpointing is off or no step has
        been written yet. On restore the whole state tree comes back, its
        tensors on the job's device (the strategy's ``count`` on the host,
        where ``init`` keeps it); a ``restored_step`` metric marks the
        resume, and the greeting set is reset so the caller re-admits every
        live client with the restored weights."""
        directory = self._ckpt_dir()
        if directory is None:
            return False
        step = checkpoint.latest_step(directory)
        if step is None:
            return False
        tree = checkpoint.load_tree(directory, step, device=self.ctx.device)
        meta = json.loads(str(tree["meta"]))
        self.weights = tree["weights"]
        self._version = int(tree["version"])
        self._version_vector = {
            c: int(v) for c, v in tree.get("version_vector", {}).items()
        }
        self._snapshots._snaps = {
            int(v): w for v, w in tree["snapshots"].items()
        }
        self._snapshots._window = int(meta["snapshot_window"])
        state = dict(tree["strategy"])
        if isinstance(state.get("count"), torch.Tensor):
            state["count"] = state["count"].cpu()
        self._strategy_state = state
        self.staleness_log = list(meta["staleness_log"])
        self.metrics = list(meta["metrics"])
        self._round = int(meta["round"])
        self.peak_buffered = int(meta["peak_buffered"])
        self._greeted = set()
        self.metrics.append({"restored_step": int(step)})
        return True


class AsyncRootMixin(_BufferedAsyncBase):
    """FedBuff-style buffered asynchronous aggregation at the root.

    The server is purely reactive: it processes updates in virtual-arrival
    order (``recv_any``), weights each by staleness (server version now minus
    the version the client trained from), and applies the buffered average
    every ``buffer_size`` updates. Trainers never barrier: each gets fresh
    weights back right after its upload is absorbed.
    """

    def bootstrap(self) -> None:
        self._init_strategy()
        if self._restore_latest():
            # restarted server: every current trainer gets the restored
            # weights (and version), so an upload lost to the crash is
            # simply trained again
            end = self._down()
            self._greeted = set(self._trainers())
            for t in sorted(self._greeted):
                self._send_weights(end, t, self._version)
            return
        self._snapshots.put(0, _tree_copy(self.weights))
        end = self._down()
        self._greeted = set(self._trainers())
        for t in sorted(self._greeted):
            self._send_weights(end, t, 0)
        # step-0 checkpoint: a crash before the first version restores here
        self._maybe_checkpoint()

    def _target_versions(self) -> int:
        pol = self._policy()
        if pol.max_updates is not None:
            return int(pol.max_updates)
        return self.rounds

    def serve(self) -> None:
        pol = self._policy()
        end = self._down()
        trainers = self._trainers()
        if not trainers:
            self._work_done = True  # everyone dropped: nothing left to serve
            return
        # greet members that joined (or re-joined) since the last look at
        # the channel: they start from the current weights
        current = set(trainers)
        for t in sorted(current - self._greeted):
            self._send_weights(end, t, self._version)
        self._greeted = current  # forget leavers so a re-join is greeted again
        self._prune_version_vector(current)
        try:
            src, msg, arrival = end.recv_any(trainers, timeout=float(pol.grace))
        except queue.Empty:
            if set(self._trainers()) != current:
                return  # membership changed while waiting: re-greet first
            # no update within the wall-clock grace: everyone is gone, or
            # training is slower than grace; record the early stop so an
            # under-trained result is distinguishable from a completed run
            self.metrics.append(
                {
                    "early_stop": True,
                    "version": self._version,
                    "target_versions": self._target_versions(),
                }
            )
            self._work_done = True
            return
        # a zero-sample relay (an intermediate whose whole group missed its
        # deadline) carries no training content: skip it, but still hand
        # fresh weights back
        if float(msg.get("num_samples", 1)) > 0 and self._absorb(src, msg, arrival):
            self._round = self._version
            self.evaluate()
            self.metrics.append({"round": self._version, "virtual_time": arrival})
            if self._version >= self._target_versions():
                self._work_done = True
                return
        # hand the uploader fresh weights so it keeps training (no barrier)
        self._send_weights(end, src, self._version)

    def finish(self) -> None:
        end = self._down()
        end.send_many(self._trainers(), pack_broadcast(self.weights, True))

    def compose(self) -> None:
        with Composer() as composer:
            self.composer = composer
            tl_init = Tasklet("init", self.initialize)
            tl_boot = Tasklet("bootstrap", self.bootstrap)
            tl_serve = Tasklet("serve", self.serve)
            tl_finish = Tasklet("finish", self.finish)
            loop = Loop(loop_check_fn=lambda: self._work_done)
            tl_init >> tl_boot >> loop(tl_serve) >> tl_finish


# ====================================================================== #
# Intermediate-aggregator mixins (hierarchy-wide lowering)
# ====================================================================== #
class DeadlineAggregatorMixin(_DeadlineBase):
    """Per-sub-round straggler deadline for an intermediate aggregator.

    Keeps the base ``Aggregator`` chain (fetch >> distribute >> aggregate >>
    upload), so it works under any root policy: only the group collection
    is deadline-bounded. Broadcasts stamp a local sub-round version (echoed
    by the trainers) while uploads echo the root's version, set by the base
    ``Aggregator.fetch``, so the root staleness-weights the relay correctly.
    """

    def distribute(self) -> None:
        self._open_round(done=self._work_done)

    def aggregate(self) -> None:
        if self._work_done:
            return  # peers were just told to exit; nothing will arrive
        self._close_round()


class AsyncAggregatorMixin(_BufferedAsyncBase):
    """FedBuff-style buffered aggregation at an intermediate tier.

    The node receives trainer updates on the down channel and root
    broadcasts on the up channel: ``serve()`` takes both in virtual-arrival
    order through ``recv_any_multi``. Trainer staleness is measured against
    the node's local sub-version; every buffer flush relays the partial
    aggregate upward with the flushed updates' staleness
    (``tier_staleness``) and the last root version seen (``version``). A
    root broadcast rebases the node: the new global weights become the next
    local version.
    """

    def __init__(self, ctx) -> None:
        super().__init__(ctx)
        self._root_version: Optional[int] = None
        self._buffer_samples = 0.0
        self._buffer_staleness: List[int] = []
        self.relay_log: List[Dict[str, Any]] = []

    def _up(self):
        return self.ctx.end(self.up_channel)

    def bootstrap(self) -> None:
        up = self._up()
        msg = up.recv(await_peer(self.ctx, up))
        self.weights = msg["weights"]
        self._root_version = msg.get("version")
        self._work_done = bool(msg.get("done", False))
        self._init_strategy()
        bridge_clock(self.ctx, self.down_channel)
        self._snapshots.put(0, _tree_copy(self.weights))
        if self._work_done:
            return
        end = self._down()
        self._greeted = set(self._trainers())
        for t in sorted(self._greeted):
            self._send_weights(end, t, 0)

    def serve(self) -> None:
        pol = self._policy()
        down = self._down()
        up = self._up()
        trainers = self._trainers()
        current = set(trainers)
        for t in sorted(current - self._greeted):
            self._send_weights(down, t, self._version)
        self._greeted = current
        self._prune_version_vector(current)
        roots = up.ends()
        sources = [(down, sorted(current)), (up, sorted(roots))]
        try:
            end, src, msg, arrival = recv_any_multi(
                sources, timeout=float(pol.grace)
            )
        except queue.Empty:
            if set(self._trainers()) != current:
                return  # membership changed while waiting: re-greet first
            if current or roots:
                self.metrics.append({"early_stop": True, "version": self._version})
                # a barriered root above would block forever on this silent
                # exit: relay once to unblock its round, then leave. Updates
                # streamed into the strategy state but never applied are not
                # in self.weights, so the relay carries zero sample weight
                self._buffer_samples = 0.0
                self._buffer_staleness = []
                self._relay_up()
            self._work_done = True
            up.leave()
            return
        if end is up:
            # root direction: rebase on the new global model
            self.weights = msg["weights"]
            self._root_version = msg.get("version", self._root_version)
            self._work_done = bool(msg.get("done", False))
            if self._work_done:
                return
            self._version += 1
            self._snapshots.put(
                self._version, _tree_copy(self.weights),
                keep_from=self._snapshot_floor(),
            )
            bridge_clock(self.ctx, self.down_channel)
            return
        # trainer direction: buffer the update; on flush, relay upward
        # (zero-sample updates carry no content: skip, as the root does)
        if float(msg.get("num_samples", 1)) > 0:
            self._buffer_samples += float(msg.get("num_samples", 1))
            flushed = self._absorb(src, msg, arrival)
            self._buffer_staleness.append(int(self.staleness_log[-1]["staleness"]))
            if flushed:
                self._relay_up()
        self._send_weights(down, src, self._version)

    def _relay_up(self) -> None:
        up = self._up()
        roots = up.ends()
        if not roots:
            return
        bridge_clock(self.ctx, self.up_channel)
        self.ctx.advance_clock(
            self.up_channel, float(self.config.get("compute_time", 0.0))
        )
        update: Dict[str, Any] = pack_update(
            self.weights, int(self._buffer_samples), self._root_version
        )
        update["tier_staleness"] = list(self._buffer_staleness)
        up.send(roots[0], update)
        self.relay_log.append(
            {
                "version": self._version,
                "num_samples": int(self._buffer_samples),
                "tier_staleness": list(self._buffer_staleness),
                "root_version": self._root_version,
            }
        )
        self._buffer_samples = 0.0
        self._buffer_staleness = []

    def finish(self) -> None:
        end = self._down()
        end.send_many(self._trainers(), pack_broadcast(self.weights, True))

    def compose(self) -> None:
        with Composer() as composer:
            self.composer = composer
            tl_init = Tasklet("init", self.initialize)
            tl_boot = Tasklet("bootstrap", self.bootstrap)
            tl_serve = Tasklet("serve", self.serve)
            tl_finish = Tasklet("finish", self.finish)
            loop = Loop(loop_check_fn=lambda: self._work_done)
            tl_init >> tl_boot >> loop(tl_serve) >> tl_finish


_PROGRAM_CACHE: Dict[Tuple[type, str], type] = {}

_ROOT_MIXINS: Dict[str, type] = {
    "deadline": DeadlineRootMixin,
    "async": AsyncRootMixin,
}

_AGG_MIXINS: Dict[str, type] = {
    "deadline": DeadlineAggregatorMixin,
    "async": AsyncAggregatorMixin,
}


def make_policy_program(base_cls: Type[Role], mode: str) -> Type[Role]:
    """Graft the policy mixin for ``mode`` onto an aggregator class.

    Root aggregators (``GlobalAggregator`` subclasses) get the root mixin
    family; intermediate H-FL aggregators (``Aggregator`` subclasses) the
    intermediate family, so the whole aggregation tree lowers tier by tier.
    """
    from repro_torch.core.roles import Aggregator, GlobalAggregatorBase

    if issubclass(base_cls, GlobalAggregatorBase):
        family = _ROOT_MIXINS
    elif issubclass(base_cls, Aggregator):
        family = _AGG_MIXINS
    else:
        raise TypeError(
            f"cannot policy-lower {base_cls.__name__}: not a GlobalAggregator "
            "or Aggregator subclass"
        )
    if mode not in family:
        raise ValueError(f"unknown policy mode {mode!r}; known: {sorted(family)}")
    key = (base_cls, mode)
    if key not in _PROGRAM_CACHE:
        mixin = family[mode]
        _PROGRAM_CACHE[key] = type(
            f"{mode.capitalize()}{base_cls.__name__}", (mixin, base_cls), {}
        )
    return _PROGRAM_CACHE[key]
