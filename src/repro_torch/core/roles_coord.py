"""Coordinated FL (CO-FL) roles — the paper's §6.1 extension case study
(the port of ``repro.core.roles_coord``).

CO-FL = H-FL + a coordinator connected to every other role (Fig. 1d / Fig. 8).
Each derived role inherits its H-FL base and *surgically edits* the inherited
tasklet chain (Table 1 API) instead of re-implementing it — this file is the
LOC-reduction artifact behind the paper's Table 3.

The coordinator implements the paper's load-balancing scheme (Fig. 10):
aggregators report model-upload delays; after three consecutive rounds of
significant delay discrepancy the straggler is excluded with binary backoff
(1, 2, 4, 8, 16 rounds), being re-admitted once between backoff windows to
probe whether the congestion cleared.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.core.composer import CloneComposer, Composer, Loop, Tasklet
from repro_torch.core.roles import (
    Aggregator,
    GlobalAggregator,
    Role,
    RoleContext,
    Trainer,
    weighted_mean,
)

COORD_TRAINER = "coord-trainer-channel"
COORD_AGG = "coord-agg-channel"
COORD_GLOBAL = "coord-global-channel"


class CoordTrainer(Trainer):
    """Trainer that asks the coordinator which aggregator to talk to."""

    def __init__(self, ctx: RoleContext) -> None:
        super().__init__(ctx)
        self.assigned_agg: Optional[str] = None

    def get_assignment(self) -> None:
        end = self.ctx.end(COORD_TRAINER)
        msg = end.recv(end.ends()[0])
        self.assigned_agg = msg.get("aggregator")
        self._work_done = bool(msg.get("done", False))

    def fetch(self) -> None:
        if self._work_done or self.assigned_agg is None:
            return
        end = self.ctx.end(self.param_channel)
        msg = end.recv(self.assigned_agg)
        self.weights = msg["weights"]

    def upload(self) -> None:
        if self._work_done or self.assigned_agg is None:
            return
        end = self.ctx.end(self.param_channel)
        self.ctx.advance_clock(
            self.param_channel, float(self.config.get("compute_time", 0.0))
        )
        end.send(
            self.assigned_agg,
            {"weights": self.weights, "num_samples": self.num_samples},
        )

    def compose(self) -> None:
        super().compose()
        assert self.composer is not None
        with CloneComposer(self.composer) as composer:
            self.composer = composer
            tl_assign = Tasklet("get_assignment", self.get_assignment)
            composer.get_tasklet("fetch").insert_before(tl_assign)


class CoordAggregator(Aggregator):
    """Aggregator that reports upload delay and honors coordinator exclusion."""

    def __init__(self, ctx: RoleContext) -> None:
        super().__init__(ctx)
        self.active = True
        self.assigned_trainers: List[str] = []

    def get_assignment(self) -> None:
        end = self.ctx.end(COORD_AGG)
        msg = end.recv(end.ends()[0])
        self.active = bool(msg.get("active", True))
        self.assigned_trainers = list(msg.get("trainers", []))
        self._coord_round = msg.get("round")
        self._work_done = bool(msg.get("done", False))

    def fetch(self) -> None:
        if self._work_done or not self.active:
            return
        super().fetch()
        self._work_done = False  # termination is the coordinator's job here

    def distribute(self) -> None:
        if self._work_done or not self.active:
            return
        end = self.ctx.end(self.down_channel)
        end.send_many(
            self.assigned_trainers, {"weights": self.weights, "done": False}
        )

    def aggregate(self) -> None:
        if self._work_done or not self.active:
            return
        end = self.ctx.end(self.down_channel)
        updates = [
            (msg["weights"], float(msg.get("num_samples", 1)))
            for _, msg in end.recv_fifo(self.assigned_trainers)
        ]
        # a stacked exact fold on the job's device (``weighted_mean``); the
        # JAX package's ``fused_aggregation`` switch changes nothing here
        mean, total = weighted_mean(updates)
        if mean is not None:
            self.weights = mean
            self.agg_samples = int(total)

    def upload(self) -> None:
        if self._work_done or not self.active:
            return
        end = self.ctx.end(self.up_channel)
        t0 = self.ctx.now(self.up_channel)
        super().upload()
        delay = self.ctx.now(self.up_channel) - t0
        self.report(delay)

    def report(self, delay: float) -> None:
        end = self.ctx.end(COORD_AGG)
        end.send(
            end.ends()[0],
            {"delay": delay, "round": getattr(self, "_coord_round", None)},
        )

    def compose(self) -> None:
        super().compose()
        assert self.composer is not None
        with CloneComposer(self.composer) as composer:
            self.composer = composer
            tl_assign = Tasklet("get_assignment", self.get_assignment)
            composer.get_tasklet("fetch").insert_before(tl_assign)


class CoordGlobalAggregator(GlobalAggregator):
    """Fig. 9 verbatim: insert get_coord_ends before distribute, drop
    end_of_train (the coordinator now announces the end of training)."""

    down_channel = "global-channel"

    def __init__(self, ctx: RoleContext) -> None:
        super().__init__(ctx)
        self.active_aggs: List[str] = []

    def get_coord_ends(self) -> None:
        end = self.ctx.end(COORD_GLOBAL)
        msg = end.recv(end.ends()[0])
        self.active_aggs = list(msg.get("active_aggs", []))
        self._work_done = bool(msg.get("done", False))

    def distribute(self) -> None:
        if self._work_done:
            return
        end = self.ctx.end(self.down_channel)
        end.send_many(self.active_aggs, {"weights": self.weights, "done": False})

    def aggregate(self) -> None:
        if self._work_done:
            return
        end = self.ctx.end(self.down_channel)
        t0 = self.ctx.now(self.down_channel)
        updates = [
            (msg["weights"], float(msg.get("num_samples", 1)))
            for _, msg in end.recv_fifo(self.active_aggs)
        ]
        mean, _total = weighted_mean(updates)
        if mean is not None:
            self.weights = mean
        self.metrics.append(
            {"round": self._round, "round_time": self.ctx.now(self.down_channel) - t0}
        )

    def check_rounds(self) -> None:
        self._round += 1  # round bookkeeping only; coordinator decides the end

    def compose(self) -> None:
        super().compose()
        assert self.composer is not None
        with CloneComposer(self.composer) as composer:
            self.composer = composer
            tl_coord_ends = Tasklet("get_coord_ends", self.get_coord_ends)
            tl = self.composer.get_tasklet("distribute")
            tl.insert_before(tl_coord_ends)
            tl = self.composer.get_tasklet("end_of_train")
            tl.remove()


class Coordinator(Role):
    """New role: client/aggregator assignment + straggler load balancing."""

    def __init__(self, ctx: RoleContext) -> None:
        super().__init__(ctx)
        self.delay_threshold = float(self.config.get("delay_threshold", 3.0))
        self.consecutive_needed = int(self.config.get("consecutive_delays", 3))
        self._consecutive: Dict[str, int] = {}
        self._backoff: Dict[str, int] = {}  # rounds of next exclusion window
        self._excluded_until: Dict[str, int] = {}
        self.decisions: List[Dict[str, Any]] = []

    # --------------------------- helpers ------------------------------ #
    def _members(self, channel: str) -> List[str]:
        members = self.ctx.static_members.get(channel)
        if members:
            return [m for m in members if m != self.ctx.worker.worker_id]
        return self.ctx.end(channel).ends()

    def active_aggregators(self) -> List[str]:
        aggs = self._members(COORD_AGG)
        return [a for a in aggs if self._excluded_until.get(a, 0) <= self._round]

    # --------------------------- tasklets ----------------------------- #
    def assign(self) -> None:
        done = self._round >= self.rounds
        aggs = self._members(COORD_AGG)
        active = self.active_aggregators() or aggs
        trainers = self._members(COORD_TRAINER)
        # round-robin trainer -> active aggregator assignment (bipartite links)
        assignment = {
            t: active[i % len(active)] for i, t in enumerate(sorted(trainers))
        }
        per_agg: Dict[str, List[str]] = {a: [] for a in aggs}
        for t, a in assignment.items():
            per_agg[a].append(t)
        tr_end = self.ctx.end(COORD_TRAINER)
        for t in trainers:
            tr_end.send(t, {"aggregator": assignment.get(t), "done": done})
        ag_end = self.ctx.end(COORD_AGG)
        for a in aggs:
            ag_end.send(
                a,
                {
                    "active": a in active,
                    "trainers": per_agg.get(a, []),
                    "round": self._round,
                    "done": done,
                },
            )
        gl_end = self.ctx.end(COORD_GLOBAL)
        gl_end.send_many(
            self._members(COORD_GLOBAL), {"active_aggs": active, "done": done}
        )
        self._active_now = active
        if done:
            self._work_done = True

    def collect_delay(self) -> None:
        if self._work_done:
            return
        import queue as _queue

        end = self.ctx.end(COORD_AGG)
        delays: Dict[str, float] = {}
        # dropout-tolerant collect: react to reports in arrival order and
        # stop waiting (wall-clock grace) for aggregators that died mid-round
        # instead of deadlocking the control loop
        grace = float(self.config.get("coord_grace", 30.0))
        remaining = set(self._active_now)
        while remaining:
            try:
                a, msg, _ = end.recv_any(sorted(remaining), timeout=grace)
            except _queue.Empty:
                break
            # a report tagged with an older round is a leftover from a
            # grace-window miss — discard it and keep waiting for the
            # current round's report so the stream never desynchronizes
            rnd = msg.get("round")
            if rnd is not None and rnd != self._round:
                continue
            delays[a] = float(msg.get("delay", 0.0))
            remaining.discard(a)
        for a in remaining:
            # a missing report reads as an infinitely slow round: exclude
            # with the same binary backoff used for measured stragglers, so
            # an aggregator that was merely slow (not dead) gets re-probed
            window = self._backoff.get(a, 0) * 2 or 1
            self._backoff[a] = window
            self._excluded_until[a] = self._round + 1 + window
        self.load_balance(delays)
        self.decisions.append(
            {"round": self._round, "delays": delays, "active": list(self._active_now)}
        )

    def load_balance(self, delays: Dict[str, float]) -> None:
        """Binary-backoff exclusion of aggregators with outlier upload delay."""
        if len(delays) < 2:
            # a lone (possibly re-admitted) aggregator can't be compared;
            # nothing to do this round
            self._round += 1
            return
        med = float(np.median(list(delays.values())))
        for a, d in delays.items():
            slow = med > 0 and d > self.delay_threshold * med
            if not slow:
                self._consecutive[a] = 0
                self._backoff[a] = 0
                continue
            if self._backoff.get(a, 0) > 0:
                # probe round after a backoff window: still congested -> double
                window = self._backoff[a] * 2
            else:
                self._consecutive[a] = self._consecutive.get(a, 0) + 1
                if self._consecutive[a] < self.consecutive_needed:
                    continue
                window = 1
            self._backoff[a] = window
            self._excluded_until[a] = self._round + 1 + window
            self._consecutive[a] = 0
        self._round += 1

    def compose(self) -> None:
        with Composer() as composer:
            self.composer = composer
            tl_assign = Tasklet("assign", self.assign)
            tl_collect = Tasklet("collect_delay", self.collect_delay)
            loop = Loop(loop_check_fn=lambda: self._work_done)
            composer.set_chain(loop(tl_assign >> tl_collect))
