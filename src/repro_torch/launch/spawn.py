"""Multi-process job launcher: an expanded TAG as a real process tree (§5.3),
the port of ``repro.launch.spawn``.

The driver/worker split of the multiproc transport:

* the **driver** (this process) expands the JobSpec, starts a
  ``TransportHub`` that owns all channel state, starts one OS process per
  worker, and collects a ``JobResult``;
* each **worker process** rebuilds its ``RoleContext`` against a
  ``ChannelManager`` whose every channel routes through a socket to the hub
  (``MultiprocBackend``) and runs its role program unchanged, the same
  classes that run on threads against ``InprocBackend``.

Two deployment knobs, both invisible in a seeded job's observables:

* ``pool_size=N`` runs every logical worker on one of N recycled **pool
  hosts** (``_HostPool``): a host pays its interpreter, torch import and
  CUDA context once and runs each assigned worker as a thread. An
  event-driven job still starts a worker only at its arrival event.
* ``sharded=True`` partitions the hub by the TAG's groupBy labels
  (``ShardedTransportHub``): one broker per group plus a root.

Devices: ``run_job_multiproc(job, device=None)`` resolves ``None`` to the
card, like ``run_job``, and raises where there is none. Every child and
pool host is started with the ``spawn`` method (a forked child would
inherit the driver's CUDA context, which CUDA does not allow) and resolves
the device it is given; a child that finds no card fails, and the error
lands in ``JobResult.errors``: nothing falls back to the CPU. The hub lives
in the driver and folds a reduced topic on the job's device. Each
``RemoteProgram`` carries its process's kernel launch counts and peak device
memory, and the weights of every program land on the job's device.

Event-driven jobs (deadline and async ``RuntimePolicy`` modes, dropout and
re-join schedules) bind the deployment-agnostic ``EventEngine`` to a
driver-side **process supervisor**: dropout is enforced hub-side
(``set_drop``), orphans are poisoned hub-side, and a re-join is a task
assigned to a warm standby host. A policy's ``FaultPlan`` arms the hub
(``conn_resets``, ``hub_crashes``; ``server_restarts`` run as a dropout and
re-join), and the fabric's recovery counters land on the root program's
metrics as ``transport_recovery``.
"""
from __future__ import annotations

import dataclasses
import multiprocessing
import queue as queue_mod
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.convert import resolve_device
from repro_torch.core.channels import (
    RECOVERY_COUNTERS,
    ChannelManager,
    LinkModel,
    WorkerDropped,
)
from repro_torch.core.events import EventEngine
from repro_torch.core.expansion import JobSpec, WorkerConfig, expand
from repro_torch.core.registry import ResourceRegistry
from repro_torch.core.roles import GlobalAggregatorBase, RoleContext
from repro_torch.core.runtime import (
    JobResult,
    RuntimePolicy,
    resolve_policy_class,
    resolve_program,
    static_membership,
    validate_policy_tiers,
)
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.transport.multiproc import (
    ShardedTransportHub,
    TransportHub,
    make_backend_factory,
)

__all__ = ["MultiprocLauncher", "RemoteProgram", "run_job_multiproc"]


@dataclasses.dataclass
class RemoteProgram:
    """Driver-side stub for a program that ran in a worker process.

    Carries the result surface across the process boundary: ``weights`` (on
    the job's device) and ``metrics`` always; the policy servers' logs,
    version and version vector when the worker ran one; ``is_root``, the
    worker-side ``isinstance(prog, GlobalAggregatorBase)`` verdict.
    ``launches`` are the kernel launch counts of the process that ran the
    worker, when it finished (a pool host's workers share one process), and
    ``peak_device_bytes`` that process's peak device memory (None on the
    CPU)."""

    worker_id: str
    role: str
    weights: Any = None
    metrics: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    is_root: bool = False
    participation_log: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    staleness_log: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    relay_log: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    version: Optional[int] = None
    version_vector: Dict[str, int] = dataclasses.field(default_factory=dict)
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    peak_device_bytes: Optional[int] = None


def _kernel_launches() -> Dict[str, int]:
    from repro_torch.kernels.agg import kernel as agg_kernel
    from repro_torch.kernels.quant import kernel as quant_kernel

    return {fn.__name__: int(fn.launches) for fn in agg_kernel.KERNELS + quant_kernel.KERNELS}


@dataclasses.dataclass(frozen=True)
class _ShmLeaf:
    """Where one tensor leaf of a summary's weights lies in its shared
    memory block."""

    offset: int
    shape: Tuple[int, ...]
    dtype: str


def _weights_to_shm(weights: Any) -> Any:
    """A tree's tensors copied into one new shared-memory block, the tree
    returned with ``_ShmLeaf`` placeholders and the block's name.

    A multiprocessing queue's pipe moves a tree of gigabytes at tens of
    MB/s (PERF.md §6); a shared block costs one copy on each side. The
    child leaves the block to the driver, which copies the leaves out and
    unlinks it (``_weights_from_shm``)."""
    from multiprocessing import shared_memory

    leaves = [
        x.detach().cpu().contiguous() for x in tree_leaves(weights) if isinstance(x, torch.Tensor)
    ]
    total = sum(x.numel() * x.element_size() for x in leaves)
    if total == 0:
        return weights
    shm = shared_memory.SharedMemory(create=True, size=total)
    offset = 0

    def place(x: Any) -> Any:
        nonlocal offset
        if not isinstance(x, torch.Tensor):
            return x
        x = x.detach().cpu().contiguous()
        nbytes = x.numel() * x.element_size()
        leaf = _ShmLeaf(offset, tuple(x.shape), str(x.dtype).removeprefix("torch."))
        if nbytes:
            dst = torch.frombuffer(shm.buf, dtype=torch.uint8, count=nbytes, offset=offset)
            dst.copy_(x.reshape(-1).view(torch.uint8))
            del dst
        offset += nbytes
        return leaf

    try:
        return {"shm": shm.name, "tree": tree_map(place, weights)}
    finally:
        shm.close()


def _weights_from_shm(packed: Any, device: torch.device) -> Any:
    """The tree ``_weights_to_shm`` packed, its tensors copied onto
    ``device``; the shared block is unlinked."""
    from multiprocessing import shared_memory

    if not (isinstance(packed, dict) and set(packed) == {"shm", "tree"}):
        return packed
    shm = shared_memory.SharedMemory(name=packed["shm"])
    try:
        def take(x: Any) -> Any:
            if not isinstance(x, _ShmLeaf):
                return x
            dtype = getattr(torch, x.dtype)
            n = 1
            for d in x.shape:
                n *= d
            src = torch.frombuffer(shm.buf, dtype=dtype, count=n, offset=x.offset) if n \
                else torch.empty(0, dtype=dtype)
            out = src.reshape(x.shape).to(device, copy=True)
            del src
            return out

        return tree_map(take, packed["tree"])
    finally:
        shm.close()
        shm.unlink()


def _program_summary(prog: Any, device: torch.device) -> Dict[str, Any]:
    """The result surface of a worker, for the trip to the driver; its
    weights' tensors ride in a shared-memory block."""
    summary: Dict[str, Any] = {
        "weights": _weights_to_shm(getattr(prog, "weights", None)),
        "metrics": list(getattr(prog, "metrics", [])),
        "is_root": isinstance(prog, GlobalAggregatorBase),
        "launches": _kernel_launches(),
        "peak_device_bytes": (
            int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else None
        ),
    }
    for log in ("participation_log", "staleness_log", "relay_log"):
        if hasattr(prog, log):
            summary[log] = list(getattr(prog, log))
    if hasattr(prog, "_version"):
        summary["version"] = int(prog._version)
    if hasattr(prog, "_version_vector"):
        summary["version_vector"] = dict(prog._version_vector)
    return summary


def _remote_program(
    wid: str, role: str, summary: Dict[str, Any], device: torch.device
) -> RemoteProgram:
    return RemoteProgram(
        worker_id=wid,
        role=role,
        weights=_weights_from_shm(summary.get("weights"), device),
        metrics=list(summary.get("metrics", [])),
        is_root=bool(summary.get("is_root", False)),
        participation_log=list(summary.get("participation_log", [])),
        staleness_log=list(summary.get("staleness_log", [])),
        relay_log=list(summary.get("relay_log", [])),
        version=summary.get("version"),
        version_vector=dict(summary.get("version_vector", {})),
        launches=dict(summary.get("launches", {})),
        peak_device_bytes=summary.get("peak_device_bytes"),
    )


def _worker_body(
    address: Any,
    job: JobSpec,
    worker: WorkerConfig,
    hyperparams: Dict[str, Any],
    static_members: Dict[str, List[str]],
    program_cls: Optional[type],
    barrier: Any,
    result_q: Any,
    barrier_timeout: float,
    policy: Optional[RuntimePolicy],
    device: str,
    drop_ack: Any = None,
) -> None:
    """One logical worker's run, the same on a dedicated process and on a
    pool host's thread: every channel op is an RPC keyed by ``worker_id``.

    ``address`` is one hub address or a shard address map; ``barrier`` is
    None for a worker that joins late (an arrival or a re-join); ``device``
    is the job's device, resolved here (a missing card raises, and the
    error is reported). Dropout is a two-phase report: ``dropping`` goes up
    before ``on_dropped`` leaves the channels, and the worker waits on
    ``drop_ack`` until the driver has recorded the drop and poisoned any
    orphans, so a child probing its peers sees its parent or the poison,
    never a limbo state."""
    worker_id = worker.worker_id
    pol = policy or RuntimePolicy()
    passed_barrier = False
    channels: Optional[ChannelManager] = None
    try:
        dev = resolve_device(device)
        channels = ChannelManager(
            job.tag.channels,
            backend_factory=make_backend_factory(address, client_key=worker_id, device=dev),
            device=dev,
        )
        if pol.is_lowering:
            overrides = {worker.role: program_cls} if program_cls is not None else {}
            cls = resolve_policy_class(worker, pol, overrides)
            hyperparams = dict(hyperparams)
            hyperparams.setdefault("runtime_policy", pol)
        else:
            cls = program_cls if program_cls is not None else resolve_program(worker.program)
        # the workers behind the barrier join their channels at once
        cohort = None
        if barrier is not None:
            cohort = {m for ms in static_members.values() for m in ms
                      if pol.joins_at_start(m)}
        ctx = RoleContext(
            worker, job.tag, channels, hyperparams=hyperparams,
            static_members=static_members, device=dev, start_cohort=cohort,
        )
        prog = cls(ctx)
        prog.pre_run()
        # the threaded runtime's barrier between pre_run and run: no worker
        # may see a half-joined group
        if barrier is not None:
            barrier.wait(timeout=barrier_timeout)
        passed_barrier = True
        try:
            prog.run()
        except WorkerDropped as e:
            result_q.put((worker_id, "dropping", float(e.at)))
            if drop_ack is not None:
                drop_ack.wait(timeout=5.0)
            try:
                prog.on_dropped(e.at)
            except BaseException as hook_err:  # noqa: BLE001
                result_q.put((
                    worker_id, "err",
                    (type(hook_err).__name__, f"on_dropped hook failed: {hook_err}"),
                ))
                return
            result_q.put((worker_id, "dropped", (float(e.at), _program_summary(prog, dev))))
            return
        result_q.put((worker_id, "ok", _program_summary(prog, dev)))
    except BaseException as exc:  # noqa: BLE001 - marshalled to the driver
        # a failure before the barrier breaks it, so healthy peers fail fast
        # instead of waiting out the job; after it, an abort could race
        # peers still draining the released barrier
        if barrier is not None and not passed_barrier:
            try:
                barrier.abort()
            except Exception:
                pass
        try:
            result_q.put((worker_id, "err", (type(exc).__name__, str(exc))))
        except Exception:
            pass
    finally:
        # pool hosts outlive many workers: release the hub sockets here
        if channels is not None:
            try:
                channels.close()
            except Exception:
                pass


def _worker_entry(*args: Any) -> None:
    """Entry point of a dedicated (one-worker) process."""
    _worker_body(*args)


def _pool_host_entry(
    address: Any,
    job: JobSpec,
    membership: Dict[Tuple[str, str], List[str]],
    task_q: Any,
    ack_q: Any,
    result_q: Any,
    barrier: Any,
    barrier_timeout: float,
    policy: Optional[RuntimePolicy],
    device: str,
) -> None:
    """Entry point of a recycled pool host: serves worker assignments from
    ``task_q`` until the ``None`` sentinel, each ``(worker, hp_overrides,
    program_cls, use_barrier)`` on its own thread. ``ack_q`` carries the
    driver's drop acknowledgements, routed by a dispatcher thread to the
    event of the worker they name."""
    acks: Dict[str, threading.Event] = {}
    acks_lock = threading.Lock()

    def _ack_loop() -> None:
        while True:
            try:
                wid = ack_q.get()
            except (EOFError, OSError):
                return
            if wid is None:
                return
            with acks_lock:
                ev = acks.get(str(wid))
            if ev is not None:
                ev.set()

    threading.Thread(target=_ack_loop, name="pool-host-ack", daemon=True).start()
    while True:
        try:
            task = task_q.get()
        except (EOFError, OSError):
            return
        if task is None:
            return
        worker, overrides, program_cls, use_barrier = task
        hp = dict(job.hyperparams)
        hp.update(overrides or {})
        static = {ch: membership[(ch, group)] for ch, group in worker.groups.items()}
        ack = threading.Event()
        with acks_lock:
            acks[worker.worker_id] = ack
        threading.Thread(
            target=_worker_body,
            args=(
                address, job, worker, hp, static, program_cls,
                barrier if use_barrier else None, result_q, barrier_timeout,
                policy, device, ack,
            ),
            name=f"flame-{worker.worker_id}",
            daemon=True,
        ).start()


def _rejoin_high_water(policy: RuntimePolicy) -> int:
    """Standby-pool size: the most re-join windows ``[drop_at, rejoin_at)``
    open at once. A warmth knob, never a correctness bound: hosts run
    workers as threads, so disjoint windows share one host."""
    marks: List[Tuple[float, int]] = []
    for wid, rejoin_at in policy.rejoins.items():
        drop_at = float(policy.dropouts.get(wid, 0.0))
        marks.append((drop_at, 1))
        marks.append((max(float(rejoin_at), drop_at), -1))
    # at equal times the freed slot serves the newly opened window
    marks.sort(key=lambda m: (m[0], m[1]))
    cur = peak = 0
    for _, delta in marks:
        cur += delta
        peak = max(peak, cur)
    return max(peak, 1 if policy.rejoins else 0)


class _HostPool:
    """Driver-side pool of recycled worker-host processes: the whole
    deployment with ``pool_size``, or the shared re-join standby pool of a
    one-process-per-worker deployment. Assignment picks the least-loaded
    live host."""

    def __init__(
        self,
        launcher: "MultiprocLauncher",
        address: Any,
        result_q: Any,
        barrier: Any,
        barrier_timeout: float,
        size: int,
    ) -> None:
        self._lock = threading.Lock()
        self._hosts: List[Dict[str, Any]] = []
        self._owner: Dict[str, Dict[str, Any]] = {}
        for i in range(max(1, int(size))):
            task_q = launcher._ctx.Queue()
            ack_q = launcher._ctx.Queue()
            proc = launcher._ctx.Process(
                target=_pool_host_entry,
                args=(
                    address, launcher.job, launcher._membership, task_q, ack_q,
                    result_q, barrier, barrier_timeout, launcher.policy,
                    str(launcher.device),
                ),
                name=f"flame-pool-host-{i}",
                daemon=True,
            )
            proc.start()
            self._hosts.append({"proc": proc, "task_q": task_q, "ack_q": ack_q, "load": 0})

    def assign(
        self,
        worker: WorkerConfig,
        hp_overrides: Optional[Dict[str, Any]],
        program_cls: Optional[type],
        use_barrier: bool,
    ) -> Any:
        """Queue one worker onto the least-loaded live host; returns the
        host process (the liveness handle crash detection watches)."""
        with self._lock:
            live = [h for h in self._hosts if h["proc"].is_alive()]
            host = min(live or self._hosts, key=lambda h: h["load"])
            host["load"] += 1
            self._owner[worker.worker_id] = host
        host["task_q"].put((worker, dict(hp_overrides or {}), program_cls, bool(use_barrier)))
        return host["proc"]

    def owns(self, wid: str) -> bool:
        return wid in self._owner

    def procs(self) -> List[Any]:
        with self._lock:
            return [h["proc"] for h in self._hosts]

    def ack(self, wid: str) -> None:
        with self._lock:
            host = self._owner.get(wid)
        if host is not None:
            host["ack_q"].put(wid)

    def release(self, wid: str) -> None:
        """A hosted worker reached a terminal state: free its load slot."""
        with self._lock:
            host = self._owner.pop(wid, None)
            if host is not None:
                host["load"] = max(0, host["load"] - 1)

    def close(self) -> None:
        with self._lock:
            hosts, self._hosts = self._hosts, []
            self._owner.clear()
        for h in hosts:
            # sentinel first: an idle host exits on its own; _reap then
            # terminates anything still busy
            for q in (h["task_q"], h["ack_q"]):
                try:
                    q.put_nowait(None)
                except Exception:
                    pass
        MultiprocLauncher._reap([h["proc"] for h in hosts])
        for h in hosts:
            for q in (h["task_q"], h["ack_q"]):
                try:
                    q.close()
                except Exception:
                    pass


class MultiprocLauncher:
    """Expand, deploy and run a JobSpec as one OS process per worker (or on
    ``pool_size`` recycled hosts), on ``device``.

    Any ``RuntimePolicy`` runs here: the barriered sync execution and the
    event-driven modes. A plain sync job's hub folds real elapsed time into
    its clocks; an event-driven job runs pure virtual clocks, as the
    threaded event runtime does, so schedules mean the same on both
    deployments.
    """

    def __init__(
        self,
        job: JobSpec,
        registry: Optional[ResourceRegistry] = None,
        link_models: Optional[Dict[Tuple[str, str], LinkModel]] = None,
        per_worker_hyperparams: Optional[Dict[str, Dict[str, Any]]] = None,
        program_overrides: Optional[Dict[str, type]] = None,
        policy: Optional[RuntimePolicy] = None,
        pool_size: Optional[int] = None,
        sharded: bool = False,
        device: Any = None,
    ) -> None:
        self.device = resolve_device(device)
        self.job = job
        self.workers = expand(job, registry)
        self.link_models = dict(link_models or {})
        self.per_worker_hyperparams = dict(per_worker_hyperparams or {})
        self.program_overrides = dict(program_overrides or {})
        self.policy = policy or RuntimePolicy()
        validate_policy_tiers(self.policy, job.tag)
        self.wall_clock = not self.policy.is_event_driven
        self.pool_size = None if pool_size is None else max(1, int(pool_size))
        self._shard_keys = (
            sorted({g for c in job.tag.channels for g in c.group_by}) if sharded else []
        )
        # spawn, never fork: a forked child would inherit the driver's CUDA
        # context (and its threads)
        self._ctx = multiprocessing.get_context("spawn")
        self._membership = static_membership(self.workers, job.tag)

    # ------------------------------------------------------------------ #
    def _make_hub(self) -> Any:
        """One ``TransportHub``, or a ``ShardedTransportHub`` when sharding
        is asked for and the TAG has groupBy labels; both fold reduced
        topics on the job's device."""
        if self._shard_keys:
            hub: Any = ShardedTransportHub(
                self._shard_keys, wall_clock=self.wall_clock, device=self.device
            )
        else:
            hub = TransportHub(wall_clock=self.wall_clock, device=self.device)
        for c in self.job.tag.channels:
            hub.set_wire_dtype(c.name, c.wire_dtype)
        for (channel, worker), model in self.link_models.items():
            hub.set_link(channel, worker, model)
        if self.policy.faults is not None:
            try:
                hub.arm_faults(self.policy.faults)
            except ValueError:
                hub.close()
                raise
        return hub

    def _spawn(
        self, w: WorkerConfig, address: Any, barrier: Any,
        result_q: Any, barrier_timeout: float, drop_ack: Any = None,
    ) -> Any:
        hp = dict(self.job.hyperparams)
        hp.update(self.per_worker_hyperparams.get(w.worker_id, {}))
        static = {ch: self._membership[(ch, group)] for ch, group in w.groups.items()}
        p = self._ctx.Process(
            target=_worker_entry,
            args=(
                address, self.job, w, hp, static, self.program_overrides.get(w.role),
                barrier, result_q, barrier_timeout, self.policy, str(self.device), drop_ack,
            ),
            name=f"flame-{w.worker_id}",
            daemon=True,
        )
        p.start()
        return p

    @staticmethod
    def _reap(procs: List[Any], grace: float = 5.0) -> None:
        """Hard stop: a hung child must never wedge the driver. The children
        share one ``grace`` to exit on their own; the rest are terminated."""
        deadline = time.monotonic() + grace
        for p in procs:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=5.0)
            if p.is_alive():  # pragma: no cover - last resort
                p.kill()
                p.join(timeout=5.0)

    # ------------------------------------------------------------------ #
    def run(self, timeout: float = 120.0) -> JobResult:
        if self.policy.is_event_driven:
            return self._run_events(timeout)
        return self._run_sync(timeout)

    def _run_sync(self, timeout: float) -> JobResult:
        """The barriered sync deployment."""
        hub = self._make_hub()
        result_q = self._ctx.Queue()
        barrier = self._ctx.Barrier(len(self.workers))
        procs: Dict[str, Any] = {}
        pool: Optional[_HostPool] = None
        programs: Dict[str, Any] = {}
        errors: Dict[str, BaseException] = {}
        deadline = time.monotonic() + timeout
        by_id = {w.worker_id: w for w in self.workers}
        pending = set(by_id)

        def _absorb(wid: str, status: str, payload: Any) -> None:
            pending.discard(wid)
            if status == "ok":
                programs[wid] = _remote_program(wid, by_id[wid].role, payload, self.device)
            else:
                etype, emsg = payload
                errors[wid] = RuntimeError(f"[{etype}] {emsg}")

        try:
            if self.pool_size is not None:
                pool = _HostPool(
                    self, hub.worker_address, result_q, barrier, timeout,
                    min(self.pool_size, len(self.workers)),
                )
                for w in self.workers:
                    procs[w.worker_id] = pool.assign(
                        w, self.per_worker_hyperparams.get(w.worker_id, {}),
                        self.program_overrides.get(w.role), use_barrier=True,
                    )
            else:
                for w in self.workers:
                    procs[w.worker_id] = self._spawn(
                        w, hub.worker_address, barrier, result_q, timeout
                    )
            # drain results before joining: a child blocks on its queue's
            # feeder thread until the driver consumes its summary
            while pending:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    item = result_q.get(timeout=min(remaining, 0.5))
                except queue_mod.Empty:
                    if all(procs[wid].is_alive() for wid in pending):
                        continue
                    # a pending worker died: one more poll for its buffered
                    # result, then fail the whole tree fast
                    try:
                        item = result_q.get(timeout=0.5)
                    except queue_mod.Empty:
                        break
                _absorb(*item)
            # a worker may have exited with its result still in the pipe
            while pending:
                try:
                    item = result_q.get(timeout=0.5)
                except queue_mod.Empty:
                    break
                _absorb(*item)
            if pending:
                crashed = sorted(wid for wid in pending if not procs[wid].is_alive())
                alive = sorted(wid for wid in pending if procs[wid].is_alive())
                if alive and not crashed:
                    errors["__timeout__"] = TimeoutError(
                        f"{len(alive)} worker processes still running after {timeout}s: {alive}"
                    )
                for wid in crashed:
                    errors.setdefault(wid, RuntimeError(
                        f"worker process {wid!r} exited without a result "
                        f"(exitcode={procs[wid].exitcode})"
                    ))
                for wid in alive:
                    if crashed:
                        errors.setdefault(wid, RuntimeError(
                            f"worker process {wid!r} torn down after peer crash: {crashed}"
                        ))
                    else:
                        errors.setdefault(wid, TimeoutError(
                            f"worker process {wid!r} hung past the {timeout}s "
                            "deadline (killed by the driver)"
                        ))
        finally:
            if pool is not None:
                pool.close()
            else:
                # a worker still pending here hung or lost a peer: no grace
                self._reap(list(procs.values()), grace=0.0 if pending else 5.0)
            result_q.close()
            hub.close()
        return self._finalize(hub, programs, errors)

    def _run_events(self, timeout: float) -> JobResult:
        """The event-driven deployment: the engine bound to a process
        supervisor."""
        hub = self._make_hub()
        engine = EventEngine(
            self.policy, self.workers,
            spec_of=self.job.tag.channel, transport=hub.engine_transport,
        )
        supervisor = _ProcessSupervisor(self, hub, engine, timeout)
        try:
            engine.arm_dropouts()
            supervisor.prespawn_standbys()
            engine.bind({
                w.worker_id: _ProcessWorkerHandle(supervisor, w) for w in self.workers
            })
            supervisor.start_pump()
            alive = engine.run(timeout=timeout)
            supervisor.stop_pump()
            errors = supervisor.errors
            if alive:
                # pending is the terminal-state ledger: a re-joined worker's
                # pre-dropout summary already sits in programs
                still = sorted(
                    wid for wid in alive if wid in supervisor.pending and wid not in errors
                )
                if still:
                    errors["__timeout__"] = TimeoutError(
                        f"{len(still)} worker processes still running after {timeout}s: {still}"
                    )
                    for wid in still:
                        errors[wid] = TimeoutError(
                            f"worker process {wid!r} hung past the {timeout}s "
                            "deadline (killed by the driver)"
                        )
        finally:
            supervisor.close()
            hub.close()
        return self._finalize(
            hub, supervisor.programs, supervisor.errors,
            dropped=engine.dropped, events=engine.events,
        )

    def _finalize(
        self,
        hub: Any,
        programs: Dict[str, Any],
        errors: Dict[str, BaseException],
        dropped: Optional[Dict[str, float]] = None,
        events: Optional[List[Tuple[float, str, str]]] = None,
    ) -> JobResult:
        # a sharded fabric's stats are summed over its hubs: each topic
        # lives on one hub, so the sums equal a single hub's totals
        stats = hub.stats
        channel_bytes = {
            c.name: stats.get(f"bytes:{c.name}", 0.0) for c in self.job.tag.channels
        }
        channel_stats = {
            c.name: {
                "bytes": float(stats.get(f"bytes:{c.name}", 0.0)),
                "msgs": float(stats.get(f"msgs:{c.name}", 0.0)),
                **{key: float(stats[f"{key}:{c.name}"])
                   for key in ("hub_reduced", "hub_partials") if f"{key}:{c.name}" in stats},
            }
            for c in self.job.tag.channels
        }
        for w in self.workers:  # stubs for workers that returned nothing
            programs.setdefault(w.worker_id, RemoteProgram(worker_id=w.worker_id, role=w.role))
        # the fabric's recovery counters ride the root program's metrics, so
        # a caller reads that recovery happened off the job result
        recovery = {
            key.rstrip(":"): float(stats[key]) for key in RECOVERY_COUNTERS if stats.get(key)
        }
        if recovery:
            for prog in programs.values():
                if prog.is_root:
                    prog.metrics.append({"transport_recovery": recovery})
                    break
        return JobResult(
            workers=self.workers,
            programs=programs,
            channel_bytes=channel_bytes,
            channel_stats=channel_stats,
            errors=errors,
            dropped=dict(dropped or {}),
            events=list(events or []),
        )


class _ProcessSupervisor:
    """Driver-side supervision of an event-driven process tree: the
    result-queue pump feeding worker outcomes to the ``EventEngine``, the
    process table, the re-join standby pool (or the whole host pool with
    ``pool_size``), and the fast-fail teardown for workers that die without
    reporting."""

    def __init__(
        self, launcher: MultiprocLauncher, hub: Any, engine: EventEngine, timeout: float
    ) -> None:
        self.launcher = launcher
        self.hub = hub
        self.engine = engine
        self.timeout = timeout
        self.deadline = time.monotonic() + timeout
        self.result_q = launcher._ctx.Queue()
        self.by_id = {w.worker_id: w for w in launcher.workers}
        self.initial = {w.worker_id for w in engine.initial_cohort()}
        self.barrier = launcher._ctx.Barrier(len(self.initial)) if self.initial else None
        self.procs: Dict[str, Any] = {}  # wid -> live or most recent process
        self.pool: Optional[_HostPool] = None
        if launcher.pool_size is not None:
            self.pool = _HostPool(
                launcher, hub.worker_address, self.result_q, self.barrier,
                timeout, min(launcher.pool_size, max(1, len(launcher.workers))),
            )
        self.standby_pool: Optional[_HostPool] = None
        self.drop_acks: Dict[str, Any] = {}  # wid -> dedicated process's ack
        # wid -> the engine's re-join directive, recorded at "dropping"
        self._rejoin_at: Dict[str, Optional[float]] = {}
        # wid -> its (channel, group) memberships when it dropped
        self._memberships: Dict[str, List[Tuple[str, str]]] = {}
        self.programs: Dict[str, Any] = {}
        self.errors: Dict[str, BaseException] = {}
        self.pending: set = set(self.by_id)
        self.done: Dict[str, threading.Event] = {wid: threading.Event() for wid in self.by_id}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._pump_thread: Optional[threading.Thread] = None

    # ------------------------------ spawn ------------------------------ #
    def prespawn_standbys(self) -> None:
        """Warm the re-join standby pool now, concurrently with the job, so
        a re-join lands without a process start-up. Pooled deployments have
        warm hosts already."""
        if self.pool is not None or not self.launcher.policy.rejoins:
            return
        self.standby_pool = _HostPool(
            self.launcher, self.hub.worker_address, self.result_q, None,
            self.timeout, _rejoin_high_water(self.launcher.policy),
        )

    def _assign(self, wid: str, pool: _HostPool, use_barrier: bool) -> None:
        w = self.by_id[wid]
        self.procs[wid] = pool.assign(
            w, self.launcher.per_worker_hyperparams.get(wid, {}),
            self.launcher.program_overrides.get(w.role), use_barrier=use_barrier,
        )

    def spawn(self, wid: str) -> None:
        """The engine's arrival directive: start the worker at its arrival
        event, never earlier."""
        if self.pool is not None:
            self._assign(wid, self.pool, use_barrier=wid in self.initial)
            return
        barrier = self.barrier if wid in self.initial else None
        ack = self.launcher._ctx.Event()
        self.drop_acks[wid] = ack
        self.procs[wid] = self.launcher._spawn(
            self.by_id[wid], self.hub.worker_address, barrier, self.result_q,
            self.timeout, drop_ack=ack,
        )

    def signal_rejoin(self, wid: str) -> None:
        """The engine's re-join directive. The worker's channel memberships
        at its dropout are restored hub-side at once, as the threaded
        runtime's restart joins at once; the new incarnation's own joins,
        a task assignment and a process hop later, find them in place. A
        server opening its next round meanwhile addresses the worker, as
        on threads, instead of missing it (or finishing before it joins)."""
        pool = self.pool or self.standby_pool
        if pool is None:  # pragma: no cover - the engine re-joins scheduled ids
            raise RuntimeError(f"no re-join standby pool for worker {wid!r}")
        transport = self.hub.engine_transport
        for channel, group in self._memberships.pop(wid, []):
            transport.join(channel, group, wid)
        self._assign(wid, pool, use_barrier=False)

    def _send_ack(self, wid: str) -> None:
        for pool in (self.pool, self.standby_pool):
            if pool is not None and pool.owns(wid):
                pool.ack(wid)
                return
        ack = self.drop_acks.get(wid)
        if ack is not None:
            ack.set()

    # ------------------------------ pump ------------------------------- #
    def start_pump(self) -> None:
        self._pump_thread = threading.Thread(
            target=self._pump, name="spawn-supervisor-pump", daemon=True
        )
        self._pump_thread.start()

    def stop_pump(self) -> None:
        self._stop.set()
        if self._pump_thread is not None:
            self._pump_thread.join(timeout=5.0)

    def _finish(self, wid: str, error: Optional[BaseException] = None) -> None:
        with self._lock:
            self.pending.discard(wid)
            if error is not None:
                self.errors.setdefault(wid, error)
        for pool in (self.pool, self.standby_pool):
            if pool is not None:
                pool.release(wid)
        self.done[wid].set()

    def _absorb(self, wid: str, status: str, payload: Any) -> None:
        role = self.by_id[wid].role
        device = self.launcher.device
        if status == "ok":
            with self._lock:
                self.programs[wid] = _remote_program(wid, role, payload, device)
            self._finish(wid)
        elif status == "err":
            etype, emsg = payload
            self._finish(wid, error=RuntimeError(f"[{etype}] {emsg}"))
        elif status == "dropping":
            # phase 1: record the drop and poison orphans now, before the
            # worker leaves its channels (whose list a re-join restores)
            self._memberships[wid] = self.hub.engine_transport.memberships(wid)
            self._rejoin_at[wid] = self.engine.worker_dropped(wid, float(payload))
            self._send_ack(wid)
        elif status == "dropped":
            at, summary = payload
            for pool in (self.pool, self.standby_pool):
                if pool is not None:
                    pool.release(wid)
            # keep the dropped worker's last state; a re-joined run's final
            # state overwrites it
            with self._lock:
                self.programs[wid] = _remote_program(wid, role, summary, device)
            rejoin_at = self._rejoin_at.pop(wid, None)
            if rejoin_at is None:
                self._finish(wid)
            else:
                try:
                    self.engine.rejoin(wid, rejoin_at)
                except BaseException as exc:  # noqa: BLE001
                    self._finish(wid, error=exc)
        else:
            self._finish(wid, error=RuntimeError(f"unknown worker status {status!r}"))

    def _pump(self) -> None:
        while self.pending and not self._stop.is_set():
            remaining = self.deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self.result_q.get(timeout=min(remaining, 0.25))
            except queue_mod.Empty:
                if self._check_crashed():
                    break
                continue
            self._absorb(*item)
        while self.pending:  # results still buffered in the pipe
            try:
                item = self.result_q.get(timeout=0.5)
            except queue_mod.Empty:
                break
            self._absorb(*item)

    def _check_crashed(self) -> bool:
        """A worker process that died without reporting can never complete,
        and its barriered peers would wait out the job for it: record the
        crash and tear the tree down. True when the pump should stop."""
        dead = [
            wid for wid in list(self.pending)
            if (proc := self.procs.get(wid)) is not None and not proc.is_alive()
        ]
        if not dead:
            return False
        try:  # one more poll: the result may still be in the pipe
            self._absorb(*self.result_q.get(timeout=0.5))
            return False
        except queue_mod.Empty:
            pass
        crashed = sorted(wid for wid in dead if wid in self.pending)
        if not crashed:
            return False
        for wid in crashed:
            self._finish(wid, error=RuntimeError(
                f"worker process {wid!r} exited without a result "
                f"(exitcode={self.procs[wid].exitcode})"
            ))
        for wid in sorted(self.pending):
            proc = self.procs.get(wid)
            if proc is not None and proc.is_alive():
                proc.terminate()
            self._finish(wid, error=RuntimeError(
                f"worker process {wid!r} torn down after peer crash: {crashed}"
            ))
        return True

    # ----------------------------- teardown ---------------------------- #
    def close(self) -> None:
        self._stop.set()
        if self._pump_thread is not None:
            self._pump_thread.join(timeout=5.0)
        if self.pool is None:
            # reap the dedicated processes; a re-joined worker's entry points
            # at a standby host, which the pool's close below stops
            hosts = (
                {id(p) for p in self.standby_pool.procs()}
                if self.standby_pool is not None else set()
            )
            MultiprocLauncher._reap(
                [p for p in self.procs.values() if p is not None and id(p) not in hosts]
            )
        for pool in (self.pool, self.standby_pool):
            if pool is not None:
                pool.close()
        self.result_q.close()


class _ProcessWorkerHandle:
    """``WorkerHandle`` binding one engine worker to OS processes."""

    def __init__(self, supervisor: _ProcessSupervisor, worker: WorkerConfig) -> None:
        self._sup = supervisor
        self._wid = worker.worker_id

    def start(self, at: float) -> None:
        self._sup.spawn(self._wid)

    def restart(self, at: float) -> None:
        self._sup.signal_rejoin(self._wid)

    def kill(self, at: float) -> None:
        """Nothing to do eagerly: the directive arrives while the process
        waits for its drop ack; it exits after reporting, and teardown reaps
        any that does not."""

    def wait(self, timeout: float) -> bool:
        # past the pump's deadline nothing sets the done event
        remaining = max(0.0, self._sup.deadline - time.monotonic()) + 1.0
        return self._sup.done[self._wid].wait(min(timeout, remaining))


def run_job_multiproc(
    job: JobSpec,
    registry: Optional[ResourceRegistry] = None,
    *,
    device: Any = None,
    **kwargs: Any,
) -> JobResult:
    """Run ``job`` as a process tree on ``device`` (default: CUDA, raising
    when no CUDA device is present), mirroring ``run_job``. The remaining
    keyword arguments are ``MultiprocLauncher``'s, plus ``timeout`` (seconds,
    default 120)."""
    timeout = float(kwargs.pop("timeout", 120.0))
    return MultiprocLauncher(job, registry, device=device, **kwargs).run(timeout=timeout)
