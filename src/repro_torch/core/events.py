"""The port's copy of ``repro.core.events`` (framework-free). Only the
thread binding (``repro_torch.core.runtime.JobRuntime``) exists in the port.

Deployment-agnostic event engine for event-driven job execution.

``EventEngine`` is the scheduling/supervision core that used to live inside
``JobRuntime._run_events``: per-worker arrival release in virtual-time order,
mid-round dropout bookkeeping, orphan cascade when a parent dies with live
children, and re-join re-parenting. The engine never touches threads,
processes or programs directly — it manipulates workers only through two
narrow surfaces:

* a :class:`WorkerHandle` per worker (``start`` / ``kill`` / ``restart`` /
  ``wait``), supplied by the deployment binding; and
* the clock/drop/poison operations already on ``TransportBackend``, exposed
  here as the :class:`EngineTransport` protocol.

Bindings:

* ``repro.core.runtime.JobRuntime`` — one daemon *thread* per worker against
  the per-channel emulation backends (the Flame-in-a-box deployment);
* ``repro.launch.spawn.MultiprocLauncher`` — one OS *process* per worker
  against a ``TransportHub``, with dropout enforced hub-side and re-join
  mapped onto a respawn.

Because both deployments run the same engine, a deadline/async
``RuntimePolicy`` job with a dropout/re-join schedule produces the same
participation sets and lifecycle events whether the workers are threads or
real processes — the paper's "deployment detail, not application logic"
claim extended to execution semantics (§6.2).
"""
from __future__ import annotations

import dataclasses
import heapq
import threading
from typing import Dict, List, Mapping, Optional, Protocol, Sequence, Tuple

from repro_torch.core.channels import ChannelManager
from repro_torch.core.expansion import WorkerConfig
from repro_torch.core.tag import Channel as ChannelSpec


@dataclasses.dataclass(order=True)
class _Event:
    time: float
    seq: int
    kind: str = dataclasses.field(compare=False)
    worker: str = dataclasses.field(compare=False)


class VirtualEventLoop:
    """Minimal virtual-clock event queue driving worker lifecycle events.

    Virtual time is decoupled from wall-clock time, so the loop never sleeps:
    it releases lifecycle events (worker starts) in virtual-time order and
    records every transition in ``log`` for the JobResult timeline.
    """

    def __init__(self) -> None:
        self._heap: List[_Event] = []
        self._seq = 0
        self.log: List[Tuple[float, str, str]] = []

    def schedule(self, time: float, kind: str, worker: str) -> None:
        heapq.heappush(self._heap, _Event(float(time), self._seq, kind, worker))
        self._seq += 1

    def record(self, time: float, kind: str, worker: str) -> None:
        self.log.append((float(time), kind, worker))

    def drain(self):
        while self._heap:
            ev = heapq.heappop(self._heap)
            self.record(ev.time, ev.kind, ev.worker)
            yield ev


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seeded, declarative chaos schedule injected at the transport layer.

    Extends the engine's lifecycle vocabulary (arrival / dropout / re-join)
    with infrastructure faults, so every chaos scenario is a reproducible
    seeded test rather than a flake:

    * ``conn_resets`` — ``worker -> at``: the hub severs that worker's
      connection (without replying) the first time a frame naming the
      worker arrives at virtual time >= ``at``. The session layer's
      reconnect-resume-retransmit makes the retried op exactly-once.
    * ``hub_crashes`` — ``shard -> at``: the hub (or the named shard of a
      ``ShardedTransportHub``; ``""`` means the root/single hub) kills its
      listener and severs every live connection once fabric time passes
      ``at``, then restarts accepting on the same port.
    * ``server_restarts`` — ``worker -> (drop_at, rejoin_at)``: a server
      role is killed and respawned through the supervisor's standby path;
      on re-join it restores from its latest ``repro.checkpoint`` step and
      re-greets its live clients through the session layer.
    * ``seed`` — folded into the deterministic reconnect-backoff jitter.

    ``RuntimePolicy.faults`` carries the plan; ``conn_resets`` and
    ``hub_crashes`` work in any mode (the sync path included), while
    ``server_restarts`` are folded into the policy's dropout/re-join
    schedule and therefore imply event-driven execution.
    """

    conn_resets: Mapping[str, float] = dataclasses.field(default_factory=dict)
    hub_crashes: Mapping[str, float] = dataclasses.field(default_factory=dict)
    server_restarts: Mapping[str, Tuple[float, float]] = dataclasses.field(
        default_factory=dict
    )
    seed: int = 0


class EngineTransport(Protocol):
    """The slice of transport state the engine manipulates.

    These are exactly the clock/drop/poison/membership ops of
    ``TransportBackend`` — a hub-backed deployment passes its single backend
    straight through, while the per-channel thread deployment fans each call
    out to every backend a worker touches (:class:`ChannelManagerTransport`).
    """

    def set_drop(self, worker: str, at: float) -> None: ...
    def clear_drop(self, worker: str) -> None: ...
    def set_clock(self, worker: str, at: float) -> None: ...
    def poison(self, worker: str, at: float) -> None: ...
    def peers(self, channel: str, group: str, me: str) -> List[str]: ...


class WorkerHandle(Protocol):
    """One worker as seen by the engine: a start/kill/restart/wait surface.

    The binding owns everything behind it — program construction, channel
    joins, threads or OS processes, result marshalling. Completion (including
    a ``WorkerDropped`` unwind) is reported back by the binding via
    :meth:`EventEngine.worker_dropped`; the engine answers with the re-join
    directive and drives ``restart``/``kill`` accordingly.
    """

    def start(self, at: float) -> None:
        """Begin executing the worker, arriving at virtual time ``at``.

        The engine has already moved the worker's clocks to ``at`` (late
        arrivals); a dynamic-join binding joins the channels now."""
        ...

    def restart(self, at: float) -> None:
        """Re-join after a dropout: rebuild worker state, re-enter the
        channels and run again (transport drop/clock state is already reset
        by the engine)."""
        ...

    def kill(self, at: float) -> None:
        """Hard-stop a dropped worker that will not re-join. A thread binding
        has nothing to do (the ``WorkerDropped`` unwind already ended the
        chain); a process binding reclaims the OS process."""
        ...

    def wait(self, timeout: float) -> bool:
        """Block until the worker fully exited; False if still running after
        ``timeout`` seconds."""
        ...


class ChannelManagerTransport:
    """:class:`EngineTransport` over per-channel backends (thread binding).

    The emulation deployment instantiates one backend per channel spec, so a
    worker's drop/clock/poison state must be kept consistent on *every*
    backend its channels live on; membership queries go to the one backend
    owning the channel.
    """

    def __init__(self, channels: ChannelManager, workers: Sequence[WorkerConfig]):
        self._channels = channels
        self._by_id = {w.worker_id: w for w in workers}

    def _backends_of(self, worker: str):
        return [self._channels.backend(ch) for ch in self._by_id[worker].groups]

    def set_drop(self, worker: str, at: float) -> None:
        for backend in self._backends_of(worker):
            backend.set_drop(worker, at)

    def clear_drop(self, worker: str) -> None:
        for backend in self._backends_of(worker):
            backend.clear_drop(worker)

    def set_clock(self, worker: str, at: float) -> None:
        for backend in self._backends_of(worker):
            backend.set_clock(worker, at)

    def poison(self, worker: str, at: float) -> None:
        for backend in self._backends_of(worker):
            backend.poison(worker, at)

    def peers(self, channel: str, group: str, me: str) -> List[str]:
        return self._channels.backend(channel).peers(channel, group, me)


class EventEngine:
    """Arrival/dropout/re-join supervisor above the deployment boundary.

    One instance drives one job run. The engine owns the virtual event loop
    (every lifecycle transition lands in ``loop.log``), the ``dropped``
    ledger surfaced on ``JobResult``, and the orphan-cascade topology logic;
    the binding owns execution. Thread-safe where bindings call in from
    worker threads (``worker_dropped``/``rejoin``/``record``).
    """

    def __init__(
        self,
        policy,  # RuntimePolicy (untyped to avoid the runtime<->events cycle)
        workers: Sequence[WorkerConfig],
        spec_of,  # Callable[[str], ChannelSpec]
        transport: EngineTransport,
    ) -> None:
        self.policy = policy
        self.workers = list(workers)
        self.by_id: Dict[str, WorkerConfig] = {w.worker_id: w for w in self.workers}
        self._spec_of = spec_of
        self.transport = transport
        self.loop = VirtualEventLoop()
        self.dropped: Dict[str, float] = {}
        self._lock = threading.Lock()
        self._handles: Dict[str, WorkerHandle] = {}
        # a typo'd worker id in any schedule silently distorts the
        # experiment's timing — reject all of them up front
        for field in ("arrivals", "dropouts", "rejoins"):
            for wid in getattr(self.policy, field):
                if wid not in self.by_id:
                    raise KeyError(f"{field} entry for unknown worker {wid!r}")

    # ------------------------------------------------------------------ #
    # schedule queries
    # ------------------------------------------------------------------ #
    @property
    def dynamic_join(self) -> bool:
        """Late arrivals join their channels at start time when any tier is
        policy-lowered; barriered sync servers cannot handle membership
        growth, so there an arrival only offsets the worker's clock."""
        return bool(self.policy.is_lowering)

    def arrival(self, worker_id: str) -> float:
        return float(self.policy.arrivals.get(worker_id, 0.0))

    def initial_cohort(self) -> List[WorkerConfig]:
        """Workers that must join their channels before anyone runs (no join
        races among the t<=0 cohort; everyone when joins are static)."""
        return [w for w in self.workers if self.policy.joins_at_start(w.worker_id)]

    def arm_dropouts(self) -> None:
        """Install the dropout schedule on the transport: a worker dies the
        moment any channel operation would carry its clock past the time."""
        for wid, at in self.policy.dropouts.items():
            self.transport.set_drop(wid, at)

    def record(self, at: float, kind: str, worker: str) -> None:
        with self._lock:
            self.loop.record(at, kind, worker)

    @property
    def events(self) -> List[Tuple[float, str, str]]:
        with self._lock:
            return sorted(self.loop.log)

    # ------------------------------------------------------------------ #
    # the run loop
    # ------------------------------------------------------------------ #
    def bind(self, handles: Dict[str, WorkerHandle]) -> None:
        self._handles = dict(handles)

    def run(
        self,
        handles: Optional[Dict[str, WorkerHandle]] = None,
        timeout: float = 120.0,
    ) -> List[str]:
        """Release every worker's start event in virtual-time order, then
        wait out the handles. Returns the ids still running after
        ``timeout`` (the binding shapes them into its timeout error)."""
        if handles is not None:
            self.bind(handles)
        for w in self.workers:
            self.loop.schedule(self.arrival(w.worker_id), "start", w.worker_id)
        started: List[str] = []
        for ev in self.loop.drain():
            if ev.time > 0.0:
                # late arrival: clocks start at the arrival time; a
                # dynamic-join binding joins its channels in start()
                self.transport.set_clock(ev.worker, ev.time)
            self._handles[ev.worker].start(ev.time)
            started.append(ev.worker)
        return [w for w in started if not self._handles[w].wait(timeout)]

    # ------------------------------------------------------------------ #
    # dropout / re-join supervision
    # ------------------------------------------------------------------ #
    def worker_dropped(self, worker_id: str, at: float) -> Optional[float]:
        """A worker's execution ended in a dropout at virtual time ``at``.

        Records the transition, and when no re-join is scheduled poisons the
        workers it orphaned (before the binding lets the dead worker leave
        its channels: a child probing peers in between must see either its
        parent or the poison, never a limbo state) and hard-kills the worker
        through its handle. Returns the scheduled re-join time, or None when
        the worker stays dead."""
        at = float(at)
        with self._lock:
            self.dropped[worker_id] = at
            self.loop.record(at, "dropout", worker_id)
        rejoin_at = self.policy.rejoins.get(worker_id)
        if rejoin_at is None:
            self._cascade_orphans(worker_id, at)
            handle = self._handles.get(worker_id)
            if handle is not None:
                handle.kill(at)
            return None
        return float(rejoin_at)

    def rejoin(self, worker_id: str, at: float) -> None:
        """Re-admit a dropped worker at virtual time ``at``: reset its
        drop/poison/clock state on the transport, record the transition and
        restart it through its handle."""
        at = float(at)
        self.transport.clear_drop(worker_id)
        self.transport.set_clock(worker_id, at)
        with self._lock:
            self.loop.record(at, "rejoin", worker_id)
        self._handles[worker_id].restart(at)

    def _cascade_orphans(self, worker_id: str, at: float) -> None:
        """A dead worker with no re-join scheduled may leave 'children'
        behind: workers whose only distribute-side peer it was. Poison them
        so their pending/next receive surfaces as a dropout instead of
        silently hanging until the recv timeout."""
        w = self.by_id[worker_id]
        for ch_name, group in w.groups.items():
            spec: ChannelSpec = self._spec_of(ch_name)
            a, b = spec.pair
            if a == b or w.role not in (a, b):
                continue
            # only cascade downstream: the dead worker must have been a
            # distributor (parent) on this channel
            if "distribute" not in spec.func_tags.for_role(w.role):
                continue
            child_role = spec.other_end(w.role)
            members = self.transport.peers(ch_name, group, worker_id)
            if any(m.rsplit("-", 1)[0] == w.role for m in members):
                continue  # a replica parent remains in the group
            for child in members:
                if child.rsplit("-", 1)[0] != child_role:
                    continue
                self.transport.poison(child, at)
                with self._lock:
                    self.loop.record(at, "orphaned", child)
