"""Management plane (§5): apiserver, controller, deployer, agent, notifier
(the port of ``repro.mgmt.plane``).

The paper implements these in Golang over K8s/MongoDB. Here the same
component split runs in-process: the controller owns job state and TAG
expansion, deployers abstract resource orchestrators (an ``InprocDeployer``
plays the role of the minikube cluster in fiab), agents wrap worker
lifecycle, and the notifier pushes events. The full workflow of Fig. 7 —
register → submit → expand → notify → deploy → run → report → revoke — is
exercised end-to-end by the integration tests.

Device: an ``APIServer`` runs its jobs on ``device`` (default: CUDA, raising
when no CUDA device is present; pass ``"cpu"`` to run on the CPU). Agents
build their programs and channels there, and the whole-job runners
(``JOB_RUNNERS``) get it as their ``device``.
"""
from __future__ import annotations

import collections
import dataclasses
import enum
import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.channels import ChannelManager, LinkModel, TransportBackend
from repro_torch.core.expansion import JobSpec, WorkerConfig, expand
from repro_torch.core.registry import ComputeSpec, RegistryError, ResourceRegistry
from repro_torch.core.roles import Role, RoleContext
from repro_torch.convert import resolve_device
from repro_torch.core.runtime import (
    JobResult,
    RuntimePolicy,
    resolve_program,
    run_job,
    static_membership,
)
from repro_torch.core.tag import DatasetSpec

# deployment name -> whole-job runner. Jobs submitted to the control plane
# pick a *deployment*, not a code path: "inproc" policy jobs run on the
# thread-backed event runtime, "multiproc" jobs on the process-tree spawner
# — both bindings of the same EventEngine, driven through one API surface.
def _run_multiproc(*args: Any, **kwargs: Any) -> JobResult:
    from repro_torch.launch.spawn import run_job_multiproc  # local: avoid cycle

    return run_job_multiproc(*args, **kwargs)


JOB_RUNNERS: Dict[str, Callable[..., JobResult]] = {
    "inproc": run_job,
    "multiproc": _run_multiproc,
}


class JobState(enum.Enum):
    SUBMITTED = "submitted"
    EXPANDED = "expanded"
    DEPLOYING = "deploying"
    RUNNING = "running"
    COMPLETED = "completed"
    FAILED = "failed"
    TERMINATED = "terminated"


@dataclasses.dataclass
class Event:
    kind: str  # "deploy" | "revoke" | "status"
    job_id: str
    payload: Dict[str, Any] = dataclasses.field(default_factory=dict)


class Notifier:
    """Push-based event channel from controller to deployers/agents."""

    def __init__(self) -> None:
        self._subs: Dict[str, List[Callable[[Event], None]]] = collections.defaultdict(list)
        self._lock = threading.Lock()

    def subscribe(self, kind: str, cb: Callable[[Event], None]) -> None:
        with self._lock:
            self._subs[kind].append(cb)

    def publish(self, event: Event) -> None:
        with self._lock:
            subs = list(self._subs.get(event.kind, []))
        for cb in subs:
            cb(event)


class Deployer:
    """Integration interface for resource orchestrators (§5.1). Subclass and
    implement ``create_instance``/``delete_instance`` to integrate K8s, Docker
    Swarm, a GPU cluster launcher, etc."""

    orchestrator = "abstract"

    def __init__(self, compute: ComputeSpec):
        self.compute = compute

    def create_instance(self, worker: WorkerConfig, job: "JobRecord") -> "Agent":
        raise NotImplementedError

    def delete_instance(self, worker_id: str) -> None:
        raise NotImplementedError


class Agent:
    """Thin per-worker client: fetches code/config, runs the worker as a
    child task, reports status (sandbox boundary of §5.1)."""

    def __init__(self, worker: WorkerConfig, job: "JobRecord", apiserver: "APIServer"):
        self.worker = worker
        self.job = job
        self.apiserver = apiserver
        self.status = "created"
        self._thread: Optional[threading.Thread] = None
        self.program: Optional[Role] = None
        self.error: Optional[BaseException] = None

    def fetch_task(self) -> Role:
        """Step 8 of Fig. 7: retrieve code + task configuration by job id."""
        rec = self.job
        cls = rec.program_overrides.get(self.worker.role) or resolve_program(
            self.worker.program
        )
        hp = dict(rec.spec.hyperparams)
        hp.update(rec.per_worker_hyperparams.get(self.worker.worker_id, {}))
        static = {
            ch: rec.membership[(ch, group)]
            for ch, group in self.worker.groups.items()
        }
        ctx = RoleContext(
            self.worker, rec.spec.tag, rec.channels, hp, static_members=static,
            device=rec.device,
        )
        self.program = cls(ctx)
        return self.program

    def start(self) -> None:
        prog = self.fetch_task()
        prog.pre_run()
        self.status = "joined"

    def run(self) -> None:
        assert self.program is not None

        def _run() -> None:
            self.status = "running"
            try:
                self.program.run()
                self.status = "completed"
            except BaseException as e:  # noqa: BLE001
                self.error = e
                self.status = "failed"
            finally:
                self.apiserver.report_worker_status(
                    self.job.spec.job_id, self.worker.worker_id, self.status
                )

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def join(self, timeout: float) -> bool:
        if self._thread is None:
            return True
        self._thread.join(timeout)
        return not self._thread.is_alive()

    def terminate(self) -> None:
        # cooperative: set the work-done flag; chains exit at the next check
        if self.program is not None:
            self.program._work_done = True


class InprocDeployer(Deployer):
    """The fiab deployer: "containers" are threads in this process."""

    orchestrator = "inproc"

    def __init__(self, compute: ComputeSpec):
        super().__init__(compute)
        self.agents: Dict[str, Agent] = {}
        self.apiserver: Optional["APIServer"] = None

    def create_instance(self, worker: WorkerConfig, job: "JobRecord") -> Agent:
        assert self.apiserver is not None
        agent = Agent(worker, job, self.apiserver)
        self.agents[worker.worker_id] = agent
        return agent

    def delete_instance(self, worker_id: str) -> None:
        agent = self.agents.pop(worker_id, None)
        if agent is not None:
            agent.terminate()


@dataclasses.dataclass
class JobRecord:
    spec: JobSpec
    state: JobState = JobState.SUBMITTED
    workers: List[WorkerConfig] = dataclasses.field(default_factory=list)
    channels: Optional[ChannelManager] = None
    membership: Dict[Tuple[str, str], List[str]] = dataclasses.field(default_factory=dict)
    agents: Dict[str, Agent] = dataclasses.field(default_factory=dict)
    worker_status: Dict[str, str] = dataclasses.field(default_factory=dict)
    per_worker_hyperparams: Dict[str, Dict[str, Any]] = dataclasses.field(
        default_factory=dict
    )
    program_overrides: Dict[str, type] = dataclasses.field(default_factory=dict)
    link_models: Dict[Tuple[str, str], LinkModel] = dataclasses.field(
        default_factory=dict
    )
    # optional transport override: route every channel of this job through a
    # caller-provided backend (e.g. a MultiprocBackend client pointed at a
    # TransportHub) instead of the per-spec registry lookup
    backend_factory: Optional[Callable[[Any], TransportBackend]] = None
    # deployment selection: "inproc" (default) runs agent threads in this
    # process; "multiproc" hands the whole job to the process-tree spawner.
    # A job with an event-driven RuntimePolicy routes through the matching
    # EventEngine binding on either deployment. A chaos schedule rides here
    # too: ``RuntimePolicy.faults`` (a ``FaultPlan``) travels through this
    # record verbatim and is armed into the hub fabric by the multiproc
    # runner — the mgmt plane treats faults as job data, not a code path.
    deployment: str = "inproc"
    policy: Optional[RuntimePolicy] = None
    run_timeout: float = 120.0
    # deployment-specific runner knobs, forwarded verbatim to the selected
    # JOB_RUNNERS entry. For "multiproc": ``pool_size`` (recycled worker-host
    # processes) and ``sharded`` (one hub per groupBy label + root router).
    deploy_options: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # the job's device (the APIServer's), for agents, channels and runners
    device: Any = None
    result: Optional[JobResult] = None
    runner_thread: Optional[threading.Thread] = None
    runner_error: Optional[BaseException] = None

    @property
    def routed(self) -> bool:
        """True when this job runs through a whole-job runner (deployment
        choice or event-driven policy) instead of per-worker agents."""
        return self.deployment != "inproc" or (
            self.policy is not None and self.policy.is_event_driven
        )


class Controller:
    """Core unit: state management, TAG expansion, deployment orchestration,
    job monitoring (§5.1 "Controller")."""

    def __init__(self, registry: ResourceRegistry, notifier: Notifier):
        self.registry = registry
        self.notifier = notifier
        self.db: Dict[str, JobRecord] = {}  # the MongoDB stand-in
        self.deployers: Dict[str, Deployer] = {}
        notifier.subscribe("worker-status", self._on_worker_status)

    # -------------------- compute registration ------------------------ #
    def register_deployer(self, deployer: Deployer) -> None:
        self.registry.register_compute(deployer.compute)
        self.deployers[deployer.compute.compute_id] = deployer

    # ------------------------- job lifecycle -------------------------- #
    def submit(self, record: JobRecord) -> None:
        if record.deployment not in JOB_RUNNERS:
            raise ValueError(
                f"unknown deployment {record.deployment!r}; "
                f"one of {sorted(JOB_RUNNERS)}"
            )
        self.db[record.spec.job_id] = record
        record.workers = expand(record.spec, self.registry)
        record.membership = static_membership(record.workers, record.spec.tag)
        if not record.routed:
            # agent deployment owns the channel fabric in this process; a
            # routed job's runner builds its own (threaded event runtime or
            # the spawner's TransportHub)
            record.channels = ChannelManager(
                record.spec.tag.channels, backend_factory=record.backend_factory,
                device=record.device,
            )
            for (channel, worker), model in record.link_models.items():
                record.channels.backend(channel).set_link(channel, worker, model)
        record.state = JobState.EXPANDED
        self.notifier.publish(
            Event("deploy", record.spec.job_id, {"workers": record.workers})
        )

    def deploy(self, job_id: str) -> None:
        record = self.db[job_id]
        record.state = JobState.DEPLOYING
        if record.routed:
            self._deploy_routed(record)
            return
        for w in record.workers:
            deployer = self._deployer_for(w.compute_id)
            agent = deployer.create_instance(w, record)
            record.agents[w.worker_id] = agent
        for agent in record.agents.values():
            agent.start()  # fetch code/config + channel joins
        for agent in record.agents.values():
            agent.run()
        record.state = JobState.RUNNING

    def _deploy_routed(self, record: JobRecord) -> None:
        """Whole-job deployment: the selected runner (threaded event runtime
        or process-tree spawner) executes the job on a background thread and
        reports one JobResult back into the record."""
        runner = JOB_RUNNERS[record.deployment]

        def _run() -> None:
            try:
                result = runner(
                    record.spec,
                    self.registry,
                    policy=record.policy,
                    link_models=record.link_models or None,
                    per_worker_hyperparams=record.per_worker_hyperparams or None,
                    program_overrides=record.program_overrides or None,
                    timeout=record.run_timeout,
                    device=record.device,
                    **record.deploy_options,
                )
                if record.state is not JobState.TERMINATED:
                    record.result = result
            except BaseException as exc:  # noqa: BLE001 - surfaced via wait()
                record.runner_error = exc
            finally:
                if record.state is not JobState.TERMINATED:
                    for w in record.workers:
                        self.notifier.publish(Event(
                            "worker-status", record.spec.job_id,
                            {
                                "worker_id": w.worker_id,
                                "status": self._routed_status(record, w.worker_id),
                            },
                        ))

        record.runner_thread = threading.Thread(
            target=_run, name=f"job-runner-{record.spec.job_id}", daemon=True
        )
        record.runner_thread.start()
        record.state = JobState.RUNNING

    @staticmethod
    def _routed_status(record: JobRecord, worker_id: str) -> str:
        if record.result is None:
            return "failed"
        if worker_id in record.result.errors:
            return "failed"
        if worker_id in record.result.dropped:
            return "dropped"
        return "completed"

    def _deployer_for(self, compute_id: str) -> Deployer:
        if compute_id in self.deployers:
            return self.deployers[compute_id]
        # realm-synthesized compute (library mode): fall back to any deployer
        if self.deployers:
            return next(iter(self.deployers.values()))
        raise RegistryError(f"no deployer for compute {compute_id!r}")

    def wait(self, job_id: str, timeout: float = 120.0) -> JobState:
        record = self.db[job_id]
        if record.routed:
            return self._wait_routed(record, timeout)
        deadline = time.monotonic() + timeout
        for agent in record.agents.values():
            remaining = max(0.0, deadline - time.monotonic())
            agent.join(remaining)
        statuses = {a.status for a in record.agents.values()}
        if statuses <= {"completed"}:
            record.state = JobState.COMPLETED
        elif "failed" in statuses:
            record.state = JobState.FAILED
        self.notifier.publish(Event("revoke", job_id, {}))
        # release socket-backed transports only once the job actually ended —
        # a timed-out wait leaves a RUNNING job's channels alive
        if record.state in (JobState.COMPLETED, JobState.FAILED):
            if record.channels is not None:
                record.channels.close()
        return record.state

    def _wait_routed(self, record: JobRecord, timeout: float) -> JobState:
        if record.state in (
            JobState.COMPLETED, JobState.FAILED, JobState.TERMINATED
        ):
            return record.state  # already settled: don't re-publish revoke
        thread = record.runner_thread
        if thread is None:
            return record.state  # submitted but never deployed
        thread.join(timeout=timeout)
        if thread.is_alive():
            return record.state  # still RUNNING
        if record.runner_error is not None or record.result is None:
            record.state = JobState.FAILED
        elif record.result.errors:
            record.state = JobState.FAILED
        else:
            record.state = JobState.COMPLETED
        self.notifier.publish(Event("revoke", record.spec.job_id, {}))
        return record.state

    def terminate(self, job_id: str) -> None:
        """Stop a job. Agent-deployed jobs terminate cooperatively (work-done
        flag per worker). A routed job has no mid-run cancel yet: its runner
        owns the worker tree and reaps it at ``run_timeout`` latest — the
        record is marked TERMINATED immediately and a late result is
        discarded rather than written into a terminated job."""
        record = self.db[job_id]
        for agent in record.agents.values():
            agent.terminate()
        record.state = JobState.TERMINATED
        if record.channels is not None:
            record.channels.close()  # release socket-backed transports

    def _on_worker_status(self, event: Event) -> None:
        record = self.db.get(event.job_id)
        if record is not None:
            record.worker_status[event.payload["worker_id"]] = event.payload["status"]


class APIServer:
    """REST-API façade: the user/CLI entry point (§5.1 "APIserver")."""

    def __init__(self, registry: Optional[ResourceRegistry] = None, device: Any = None):
        self.device = resolve_device(device)
        self.registry = registry or ResourceRegistry()
        self.notifier = Notifier()
        self.controller = Controller(self.registry, self.notifier)
        self._job_counter = itertools.count()

    # ------------------------- registration --------------------------- #
    def register_compute(self, deployer: Deployer) -> None:
        if isinstance(deployer, InprocDeployer):
            deployer.apiserver = self
        self.controller.register_deployer(deployer)

    def register_dataset(self, spec: DatasetSpec) -> None:
        self.registry.register_dataset(spec)

    # ------------------------- job endpoints -------------------------- #
    def create_job(
        self,
        spec: JobSpec,
        per_worker_hyperparams: Optional[Dict[str, Dict[str, Any]]] = None,
        program_overrides: Optional[Dict[str, type]] = None,
        link_models: Optional[Dict[Tuple[str, str], LinkModel]] = None,
        backend_factory: Optional[Callable[[Any], TransportBackend]] = None,
        deployment: str = "inproc",
        policy: Optional[RuntimePolicy] = None,
        run_timeout: float = 120.0,
        deploy_options: Optional[Dict[str, Any]] = None,
    ) -> str:
        """Submit a job. ``deployment`` picks where it runs ("inproc"
        threads or a "multiproc" process tree) and ``policy`` how its rounds
        lower (sync/deadline/async + dropout/re-join schedules) — both are
        deployment details of the same TAG, never application logic.
        ``deploy_options`` are runner knobs for the chosen deployment, e.g.
        ``{"pool_size": 4, "sharded": True}`` for "multiproc"."""
        record = JobRecord(
            spec=spec,
            per_worker_hyperparams=dict(per_worker_hyperparams or {}),
            program_overrides=dict(program_overrides or {}),
            link_models=dict(link_models or {}),
            backend_factory=backend_factory,
            deployment=deployment,
            policy=policy,
            run_timeout=run_timeout,
            deploy_options=dict(deploy_options or {}),
            device=self.device,
        )
        self.controller.submit(record)
        return spec.job_id

    def start_job(self, job_id: str) -> None:
        self.controller.deploy(job_id)

    def wait_job(self, job_id: str, timeout: float = 120.0) -> JobState:
        return self.controller.wait(job_id, timeout)

    def terminate_job(self, job_id: str) -> None:
        self.controller.terminate(job_id)

    def job(self, job_id: str) -> JobRecord:
        return self.controller.db[job_id]

    def report_worker_status(self, job_id: str, worker_id: str, status: str) -> None:
        self.notifier.publish(
            Event("worker-status", job_id, {"worker_id": worker_id, "status": status})
        )
