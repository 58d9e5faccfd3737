"""In-process job runtime — the Flame-in-a-box (fiab) analogue (§5.3), the
port of ``repro.core.runtime``.

Executes an expanded job under a ``RuntimePolicy`` in ``sync`` mode: every
worker joins, barriers, and runs its tasklet chain to completion on its own
thread. Arrival/dropout/re-join schedules run through the same
``EventEngine`` as the JAX package. The ``deadline`` and ``async`` lowerings
are not ported yet and raise ``NotImplementedError``.

Device: ``run_job`` runs on CUDA by default and raises when no CUDA device
is present, unless the caller passes ``device="cpu"``; it never falls back
to the CPU on its own. The device rides on every ``RoleContext``.
"""
from __future__ import annotations

import dataclasses
import importlib
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.channels import ChannelManager, LinkModel, WorkerDropped
from repro_torch.core.events import (
    ChannelManagerTransport,
    EventEngine,
    FaultPlan,
)
from repro_torch.core.expansion import JobSpec, WorkerConfig, expand
from repro_torch.core.registry import ResourceRegistry
from repro_torch.core.roles import GlobalAggregatorBase, Role, RoleContext
from repro_torch.core.tag import TAG

# TAG program paths name the JAX package's classes (``repro.core.roles.
# Trainer``), so a TAG serializes identically in both packages; the port
# resolves them to its own modules of the same name.
_REFERENCE_PREFIX = "repro."
_PORT_PREFIX = "repro_torch."


def resolve_program(path: str) -> type:
    """Import a role program class from its dotted path; ``repro.*`` paths
    resolve to the port's module of the same name."""
    module, _, name = path.rpartition(".")
    if not module:
        raise ImportError(f"program path {path!r} is not dotted")
    if module.startswith(_REFERENCE_PREFIX):
        module = _PORT_PREFIX + module[len(_REFERENCE_PREFIX):]
    mod = importlib.import_module(module)
    try:
        return getattr(mod, name)
    except AttributeError:
        raise ImportError(f"program {name!r} not found in {module}") from None


def resolve_device(device: Any = None) -> torch.device:
    """The job's device: CUDA when ``device`` is None. Raises when CUDA is
    asked for (or defaulted to) and absent, instead of running on the CPU."""
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: run_job runs on the card by default; pass "
                "device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def static_membership(
    workers: Sequence[WorkerConfig], tag: TAG
) -> Dict[Tuple[str, str], List[str]]:
    """(channel, group) -> sorted member worker ids, from the expansion."""
    members: Dict[Tuple[str, str], List[str]] = {}
    for w in workers:
        for ch, group in w.groups.items():
            members.setdefault((ch, group), []).append(w.worker_id)
    return {k: sorted(v) for k, v in members.items()}


@dataclasses.dataclass
class RuntimePolicy:
    """How a TAG's logical rounds lower to execution semantics.

    The same JobSpec runs under any mode — the policy is a deployment detail,
    exactly like the channel backend choice (§6.2 of the paper).

    Field groups (each field's comment below carries the details):

    * ``mode`` + ``tiers`` — what lowering each tier of the aggregation tree
      runs. ``tiers`` maps role name -> mode string or override dict
      (``{"mode": ..., <TIER_PARAM_KEYS>...}``); unlisted roles follow the
      root-only default.
    * ``arrivals`` / ``dropouts`` / ``rejoins`` — the virtual-time worker
      schedule the ``EventEngine`` enforces identically on the threaded and
      process deployments. Validated: every re-join needs a matching earlier
      dropout. Over processes, the re-join standby pool is sized by the
      concurrent-dropout high-water mark of these windows.
    * ``deadline`` / ``min_participants`` — deadline-mode round bounds.
    * ``buffer_size`` / ``staleness_exp`` / ``max_updates`` — async
      (FedBuff) server knobs.
    * ``grace`` — wall-clock quiet-channel patience; the only wall-clock
      field (everything above is virtual time).
    """

    mode: str = "sync"  # "sync" | "deadline" | "async"
    # role name -> mode (or parameter-override dict), lowering *every* tier
    # of the aggregation tree: intermediate H-FL aggregators listed here
    # collect from their group under their own deadline / FedBuff buffer and
    # relay staleness-annotated partial aggregates upward. Roles not listed
    # default to the root-only behavior: the root aggregator runs ``mode``,
    # everything else is sync. ``tiers={}`` (the default) is bit-identical to
    # root-only lowering.
    #
    # A value is either a plain mode string ("deadline") or an override dict
    # {"mode": "deadline", "deadline": 1.5, "buffer_size": 3, ...} so an edge
    # tier can run tighter knobs than the core; keys other than "mode" fall
    # back to the policy-wide fields (see ``TIER_PARAM_KEYS``).
    tiers: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # worker_id -> virtual arrival time (seconds); absent workers arrive at 0
    arrivals: Dict[str, float] = dataclasses.field(default_factory=dict)
    # worker_id -> virtual time at which the worker drops mid-round
    dropouts: Dict[str, float] = dataclasses.field(default_factory=dict)
    # worker_id -> virtual time at which a dropped worker re-joins
    rejoins: Dict[str, float] = dataclasses.field(default_factory=dict)
    # deadline mode: round closes this many virtual seconds after broadcast
    deadline: float = float("inf")
    # deadline mode: keep admitting the earliest stragglers up to this floor
    min_participants: int = 0
    # async mode: FedBuff buffer size (updates per server version)
    buffer_size: int = 2
    staleness_exp: float = 0.5
    # async mode: stop after this many server versions (default: job rounds)
    max_updates: Optional[int] = None
    # wall-clock seconds a policy server waits on a quiet channel before
    # concluding that no further update is coming (dropped/hung workers)
    grace: float = 5.0
    # seeded transport-layer chaos schedule (see ``FaultPlan``); its
    # server_restarts entries are folded into dropouts/rejoins below, while
    # conn_resets/hub_crashes are armed on the hub by the process launcher
    # (the threaded deployment has no transport to fault — the plan is
    # silently inert there, preserving cross-deployment equivalence of the
    # fault-free observables)
    faults: Optional[FaultPlan] = None

    MODES = ("sync", "deadline", "async")
    # numeric knobs a tiers override dict may set per role
    TIER_PARAM_KEYS = (
        "deadline", "min_participants", "buffer_size", "staleness_exp", "grace",
    )

    def __post_init__(self) -> None:
        if self.faults is not None:
            # a server restart IS a dropout + re-join as far as scheduling
            # goes — fold it in before validation so is_event_driven flips
            # and the supervisor sizes its standby pool for the respawn
            for wid, (drop_at, rejoin_at) in self.faults.server_restarts.items():
                self.dropouts.setdefault(wid, float(drop_at))
                self.rejoins.setdefault(wid, float(rejoin_at))
        if self.mode not in self.MODES:
            raise ValueError(
                f"unknown RuntimePolicy.mode {self.mode!r}; one of {self.MODES}"
            )
        for role, entry in self.tiers.items():
            if isinstance(entry, dict):
                if "mode" not in entry:
                    raise ValueError(
                        f"RuntimePolicy.tiers override dict for role {role!r} "
                        "needs a 'mode' key"
                    )
                unknown = set(entry) - {"mode"} - set(self.TIER_PARAM_KEYS)
                if unknown:
                    raise ValueError(
                        f"unknown RuntimePolicy.tiers override key(s) "
                        f"{sorted(unknown)} for role {role!r}; allowed: "
                        f"{('mode',) + self.TIER_PARAM_KEYS}"
                    )
                mode = entry["mode"]
            else:
                mode = entry
            if mode not in self.MODES:
                raise ValueError(
                    f"unknown RuntimePolicy.tiers mode {mode!r} for role "
                    f"{role!r}; one of {self.MODES}"
                )
        for wid, t in self.rejoins.items():
            if wid not in self.dropouts:
                raise ValueError(
                    f"rejoin for {wid!r} has no matching dropout entry"
                )
            if t <= self.dropouts[wid]:
                raise ValueError(
                    f"rejoin time for {wid!r} must be after its dropout"
                )

    def tier_mode(self, role: str) -> Optional[str]:
        """The mode a ``tiers`` entry assigns to ``role`` (None if absent)."""
        entry = self.tiers.get(role)
        if entry is None:
            return None
        return entry["mode"] if isinstance(entry, dict) else entry

    def for_role(self, role: str) -> "RuntimePolicy":
        """This policy as seen by ``role``: tiers override dicts replace the
        policy-wide numeric knobs; a plain-string (or absent) entry shares
        them — keeping plain strings working exactly as before."""
        entry = self.tiers.get(role)
        if not isinstance(entry, dict):
            return self
        overrides = {k: v for k, v in entry.items() if k != "mode"}
        if not overrides:
            return self
        return dataclasses.replace(self, mode=entry["mode"], **overrides)

    @property
    def is_lowering(self) -> bool:
        """True when any tier of the tree is policy-lowered (non-sync)."""
        return self.mode != "sync" or any(
            self.tier_mode(r) != "sync" for r in self.tiers
        )

    @property
    def is_event_driven(self) -> bool:
        return bool(
            self.is_lowering or self.arrivals or self.dropouts or self.rejoins
        )


def validate_policy_tiers(policy: RuntimePolicy, tag: TAG) -> None:
    """Reject a ``tiers`` entry naming a role the TAG does not have — a
    typo'd role name would silently lower nothing while still flipping the
    runtime into event-driven mode. Shared by every deployment binding."""
    role_names = {r.name for r in tag.roles}
    for role in policy.tiers:
        if role not in role_names:
            raise KeyError(
                f"RuntimePolicy.tiers entry for unknown role {role!r}; "
                f"TAG roles: {sorted(role_names)}"
            )


def policy_tier_mode(w: WorkerConfig, cls: type, policy: RuntimePolicy) -> str:
    """Per-tier policy resolution: an explicit ``tiers`` entry wins; the
    root aggregator defaults to the policy's ``mode``; every other role defaults to sync."""
    explicit = policy.tier_mode(w.role)
    if explicit is not None:
        return explicit
    if issubclass(cls, GlobalAggregatorBase):
        return policy.mode
    return "sync"


def resolve_policy_class(
    w: WorkerConfig,
    policy: RuntimePolicy,
    program_overrides: Optional[Dict[str, type]] = None,
) -> type:
    """The program class for ``w`` under ``policy``: the user's class in a
    sync tier. Deadline and async tiers are not ported yet."""
    overrides = program_overrides or {}
    if w.role in overrides:
        cls = overrides[w.role]
    else:
        cls = resolve_program(w.program)
    mode = policy_tier_mode(w, cls, policy)
    if mode != "sync":
        raise NotImplementedError(
            f"RuntimePolicy mode {mode!r} for role {w.role!r}: the deadline and "
            "async lowerings are not ported yet (ROADMAP Queue 1 item 3)"
        )
    return cls


@dataclasses.dataclass
class JobResult:
    workers: List[WorkerConfig]
    programs: Dict[str, Role]
    channel_bytes: Dict[str, float]
    errors: Dict[str, BaseException]
    # event-driven extras (empty under the classic sync path)
    dropped: Dict[str, float] = dataclasses.field(default_factory=dict)
    events: List[Tuple[float, str, str]] = dataclasses.field(default_factory=list)

    def program(self, worker_id: str) -> Role:
        return self.programs[worker_id]

    def global_weights(self) -> Any:
        """The root aggregator's weights: a tree of tensors on the job's
        device (``repro_torch.convert.tree_to_numpy`` carries it to numpy)."""
        for prog in self.programs.values():
            if isinstance(prog, GlobalAggregatorBase):
                return prog.weights
        # custom root programs that don't subclass GlobalAggregator still
        # resolve by the conventional role name
        for wid, prog in self.programs.items():
            if wid.startswith("global-aggregator") and hasattr(prog, "weights"):
                return prog.weights
        for prog in self.programs.values():
            if hasattr(prog, "weights"):
                return prog.weights
        return None


class JobRuntime:
    """Expand + deploy + run a JobSpec entirely in-process on ``device``."""

    def __init__(
        self,
        job: JobSpec,
        registry: Optional[ResourceRegistry] = None,
        link_models: Optional[Dict[Tuple[str, str], LinkModel]] = None,
        per_worker_hyperparams: Optional[Dict[str, Dict[str, Any]]] = None,
        program_overrides: Optional[Dict[str, type]] = None,
        policy: Optional[RuntimePolicy] = None,
        device: Any = None,
    ) -> None:
        self.device = resolve_device(device)
        self.job = job
        self.workers = expand(job, registry)
        self.channels = ChannelManager(job.tag.channels)
        self.link_models = dict(link_models or {})
        self.per_worker_hyperparams = dict(per_worker_hyperparams or {})
        self.program_overrides = dict(program_overrides or {})
        self.policy = policy or RuntimePolicy()
        validate_policy_tiers(self.policy, job.tag)
        self._membership = static_membership(self.workers, job.tag)
        for (channel, worker), model in self.link_models.items():
            self.channels.backend(channel).set_link(channel, worker, model)

    # ------------------------------------------------------------------ #
    # program construction
    # ------------------------------------------------------------------ #
    def _build_program(self, w: WorkerConfig) -> Role:
        cls = resolve_policy_class(w, self.policy, self.program_overrides)
        hp = dict(self.job.hyperparams)
        hp.update(self.per_worker_hyperparams.get(w.worker_id, {}))
        static = {
            ch: self._membership[(ch, group)] for ch, group in w.groups.items()
        }
        ctx = RoleContext(
            w, self.job.tag, self.channels, hyperparams=hp, static_members=static,
            device=self.device,
        )
        return cls(ctx)

    # ------------------------------------------------------------------ #
    # execution
    # ------------------------------------------------------------------ #
    def run(self, timeout: float = 120.0) -> JobResult:
        if self.policy.is_event_driven:
            return self._run_events(timeout)
        return self._run_sync(timeout)

    def _channel_bytes(self) -> Dict[str, float]:
        return {
            c.name: self.channels.total_bytes(c.name) for c in self.job.tag.channels
        }

    def _run_sync(self, timeout: float) -> JobResult:
        """Classic barriered execution: all joins, a barrier, then every
        chain on its own thread."""
        programs: Dict[str, Role] = {}
        errors: Dict[str, BaseException] = {}
        for w in self.workers:
            programs[w.worker_id] = self._build_program(w)
        # phase 1: joins (so no worker sees a half-joined group)
        for prog in programs.values():
            prog.pre_run()
        # phase 2: chains on threads
        threads: List[threading.Thread] = []

        def _runner(wid: str, prog: Role) -> None:
            try:
                prog.run()
            except BaseException as e:  # noqa: BLE001 - surfaced to caller
                errors[wid] = e

        for wid, prog in programs.items():
            t = threading.Thread(target=_runner, args=(wid, prog), daemon=True)
            threads.append(t)
            t.start()
        for t in threads:
            t.join(timeout=timeout)
        alive = [t for t in threads if t.is_alive()]
        if alive:
            errors["__timeout__"] = TimeoutError(
                f"{len(alive)} workers still running after {timeout}s"
            )
        return JobResult(
            workers=self.workers,
            programs=programs,
            channel_bytes=self._channel_bytes(),
            errors=errors,
        )

    def _run_events(self, timeout: float) -> JobResult:
        """Event-driven execution: a thread-backed binding of the
        ``EventEngine``, which owns arrival/dropout/re-join scheduling,
        event recording and the orphan cascade."""
        programs: Dict[str, Role] = {}
        errors: Dict[str, BaseException] = {}
        for w in self.workers:
            programs[w.worker_id] = self._build_program(w)

        engine = EventEngine(
            self.policy,
            self.workers,
            spec_of=self.channels.spec,
            transport=ChannelManagerTransport(self.channels, self.workers),
        )
        engine.arm_dropouts()
        for w in engine.initial_cohort():
            programs[w.worker_id].pre_run()

        handles = {
            w.worker_id: _ThreadWorkerHandle(self, w, engine, programs, errors)
            for w in self.workers
        }
        alive = engine.run(handles, timeout)
        if alive:
            errors["__timeout__"] = TimeoutError(
                f"{len(alive)} workers still running after {timeout}s"
            )
        return JobResult(
            workers=self.workers,
            programs=programs,
            channel_bytes=self._channel_bytes(),
            errors=errors,
            dropped=engine.dropped,
            events=engine.events,
        )


class _ThreadWorkerHandle:
    """``WorkerHandle`` binding one engine worker to a daemon thread.

    The thread runs the worker's tasklet chain; a ``WorkerDropped`` unwind is
    reported to the engine, whose re-join directive is executed on the *same*
    thread (rebuild program, re-enter channels, run the new chain) so the
    binding keeps exactly one thread per worker."""

    def __init__(
        self,
        runtime: "JobRuntime",
        worker: WorkerConfig,
        engine: EventEngine,
        programs: Dict[str, Role],
        errors: Dict[str, BaseException],
    ) -> None:
        self._runtime = runtime
        self._worker = worker
        self._engine = engine
        self._programs = programs
        self._errors = errors
        self._thread: Optional[threading.Thread] = None

    def start(self, at: float) -> None:
        wid = self._worker.worker_id
        if at > 0.0 and self._engine.dynamic_join:
            # late arrival joins its channels now (dynamic membership);
            # the engine already moved its clocks to the arrival time
            self._programs[wid].pre_run()
        self._thread = threading.Thread(
            target=self._runner, name=f"worker-{wid}", daemon=True
        )
        self._thread.start()

    def _runner(self) -> None:
        wid = self._worker.worker_id
        prog = self._programs[wid]
        try:
            prog.run()
        except WorkerDropped as e:
            rejoin_at = self._engine.worker_dropped(wid, e.at)
            try:
                prog.on_dropped(e.at)
            except BaseException as hook_err:  # noqa: BLE001
                self._errors[wid] = hook_err
                return
            if rejoin_at is None:
                return
            try:
                self._engine.rejoin(wid, rejoin_at)
            except BaseException as e2:  # noqa: BLE001
                self._errors[wid] = e2
        except BaseException as e:  # noqa: BLE001 - surfaced to caller
            self._errors[wid] = e

    def restart(self, at: float) -> None:
        """Engine re-join directive: rebuild the program (transport state is
        already reset), re-enter the channels and run the new chain on the
        calling (original worker) thread — including any nested dropout."""
        wid = self._worker.worker_id
        prog = self._runtime._build_program(self._worker)
        self._programs[wid] = prog
        prog.pre_run()
        self._runner()

    def kill(self, at: float) -> None:
        """Nothing to reclaim: the ``WorkerDropped`` unwind already ended the
        chain, and a thread cannot be force-killed."""

    def wait(self, timeout: float) -> bool:
        if self._thread is None:
            return True
        self._thread.join(timeout=timeout)
        return not self._thread.is_alive()



def run_job(
    job: JobSpec,
    registry: Optional[ResourceRegistry] = None,
    *,
    device: Any = None,
    **kwargs: Any,
) -> JobResult:
    """Run ``job`` in-process on ``device`` (default: CUDA, raising when no
    CUDA device is present). The remaining keyword arguments are
    ``JobRuntime``'s, plus ``timeout`` (seconds, default 120)."""
    timeout = float(kwargs.pop("timeout", 120.0))
    return JobRuntime(job, registry, device=device, **kwargs).run(timeout=timeout)
