"""The port's management plane (``repro_torch.mgmt.plane``) on the CPU:
twins of the management-plane cases of ``test_mgmt_misc.py`` and of the
control-plane cases of ``test_multiproc_policy.py`` and
``test_pooled_sharded.py``.

Every job runs with ``device="cpu"`` (the ``APIServer``'s device), each
process job with its own timeout; where the reference compares weights,
the port's are held byte-equal to the JAX package's run with a trainer that
is exact in both, or to the port's threaded run of the same job.
"""
import numpy as np
import pytest
import torch

import repro.core.expansion as jexp
import repro.core.registry as jreg
import repro.core.tag as jtag
import repro.core.topologies as jtop
import repro.mgmt.plane as jplane
from _torch_programs import TRAINER
from repro_torch.convert import tree_to_numpy
from repro_torch.core.expansion import JobSpec
from repro_torch.core.registry import ComputeSpec
from repro_torch.core.runtime import RuntimePolicy, run_job
from repro_torch.core.tag import DatasetSpec
from repro_torch.core.topologies import classical_fl, hierarchical_fl
from repro_torch.launch.spawn import run_job_multiproc
from repro_torch.mgmt import plane
from repro_torch.mgmt.plane import JOB_RUNNERS, APIServer, InprocDeployer, JobState
from repro_torch.transport.multiproc import TransportHub, hub_backend_factory

_RNG = np.random.default_rng(7)
W0 = {
    "w": (0.01 * _RNG.normal(size=(32, 10))).astype(np.float32),
    "b": np.zeros((10,), np.float32),
}


def _api(n, mod=plane, reg=None, **kw):
    """An API server with one in-process deployer and ``n`` datasets."""
    if mod is plane:
        api = APIServer(device="cpu")
        api.register_compute(InprocDeployer(ComputeSpec("c0", realm="default")))
        datasets = tuple(DatasetSpec(name=f"d{i}", realm="default") for i in range(n))
    else:
        api = jplane.APIServer()
        api.register_compute(jplane.InprocDeployer(jreg.ComputeSpec("c0", realm="default")))
        datasets = tuple(jtag.DatasetSpec(name=f"d{i}", realm="default") for i in range(n))
    for d in datasets:
        api.register_dataset(d)
    return api, datasets


def test_full_job_lifecycle_matches_reference():
    """Register, submit, expand, deploy, run, report: the agents' job
    completes with the JAX package's worker set and global weights."""
    out = []
    for mod, spec, top in ((plane, JobSpec, classical_fl), (jplane, jexp.JobSpec, jtop.classical_fl)):
        api, datasets = _api(3, mod)
        job_id = api.create_job(spec(tag=top(), datasets=datasets, hyperparams={
            "rounds": 2, "init_weights": {"w": np.ones(4, np.float32)}}))
        api.start_job(job_id)
        assert api.wait_job(job_id, timeout=60) == mod.JobState.COMPLETED
        rec = api.job(job_id)
        assert len(rec.workers) == 4  # 3 trainers + 1 aggregator
        root = rec.agents["global-aggregator-0"].program
        out.append(np.asarray(tree_to_numpy(root.weights)["w"]).tobytes())
        assert set(rec.worker_status.values()) == {"completed"}
    assert out[0] == out[1]


def test_job_lifecycle_over_transport_hub():
    """Every channel of an agent-deployed job through a socket hub: the
    deployer and agents are unchanged, the traffic crosses the hub."""
    api, datasets = _api(2)
    with TransportHub(device="cpu") as hub:
        job_id = api.create_job(
            JobSpec(tag=classical_fl(), datasets=datasets,
                    hyperparams={"rounds": 2, "init_weights": {"w": np.ones(4, np.float32)}}),
            backend_factory=hub_backend_factory(hub.address, device="cpu"))
        api.start_job(job_id)
        assert api.wait_job(job_id, timeout=60) == JobState.COMPLETED
        assert hub.backend.stats.get("bytes:param-channel", 0.0) > 0


def test_policy_job_routed_through_event_runtime():
    """An event-driven policy job submitted to the control plane runs on the
    threaded event runtime; its result, drops included, lands on the record,
    with the JAX package's drops and worker states."""
    states = []
    for mod, spec, top, rt in ((plane, JobSpec, classical_fl, RuntimePolicy),
                               (jplane, jexp.JobSpec, jtop.classical_fl, jplane.RuntimePolicy)):
        api, datasets = _api(3, mod)
        job_id = api.create_job(
            spec(tag=top(), datasets=datasets,
                 hyperparams={"rounds": 2, "init_weights": {"w": np.ones(4, np.float32)}}),
            policy=rt(mode="deadline", deadline=5.0, grace=2.0, dropouts={"trainer-1": 0.5}),
            per_worker_hyperparams={"trainer-1": {"compute_time": 1.0}}, run_timeout=60.0)
        rec = api.job(job_id)
        assert rec.routed and rec.channels is None
        api.start_job(job_id)
        assert api.wait_job(job_id, timeout=60) == mod.JobState.COMPLETED
        assert rec.result is not None and not rec.result.errors
        states.append((rec.result.dropped, dict(rec.worker_status)))
    assert states[0] == states[1]
    assert states[0][0] == {"trainer-1": 0.5}
    assert states[0][1]["trainer-1"] == "dropped"
    assert states[0][1]["global-aggregator-0"] == "completed"


def test_unknown_deployment_rejected():
    api = APIServer(device="cpu")
    with pytest.raises(ValueError):
        api.create_job(JobSpec(tag=classical_fl(),
                               datasets=(DatasetSpec(name="d0", realm="default"),),
                               hyperparams={}), deployment="k8s")
    assert sorted(JOB_RUNNERS) == sorted(jplane.JOB_RUNNERS) == ["inproc", "multiproc"]


def test_control_plane_defaults_to_the_card(monkeypatch):
    """The API server, like ``run_job`` and ``run_job_multiproc``, runs on
    the card unless told otherwise, and raises where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        APIServer()
    job = JobSpec(tag=classical_fl(), datasets=(DatasetSpec(name="d0"),),
                  hyperparams={"rounds": 1, "init_weights": {"w": np.ones(2, np.float32)}})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_job_multiproc(job)


def test_job_picks_multiproc_deployment():
    """The control plane routes a job onto the process tree by name, with
    the same submit/start/wait surface: an async job whose server reaches
    its update target."""
    api, datasets = _api(2)
    job_id = api.create_job(
        JobSpec(tag=classical_fl(trainer_program=TRAINER), datasets=datasets,
                hyperparams={"rounds": 2, "init_weights": W0}),
        deployment="multiproc", policy=RuntimePolicy(mode="async", buffer_size=1, grace=3.0),
        run_timeout=60.0)
    api.start_job(job_id)
    assert api.wait_job(job_id, timeout=90) == JobState.COMPLETED
    rec = api.job(job_id)
    assert rec.result is not None and not rec.result.errors
    assert rec.result.program("global-aggregator-0").version == 2
    assert not np.array_equal(tree_to_numpy(rec.result.global_weights())["w"], W0["w"])


def test_create_job_forwards_pool_and_shard_knobs():
    """``deploy_options`` reach the process runner verbatim: a multiproc job
    runs pooled and sharded, byte-equal to the threaded run of the job."""
    api, _ = _api(0)

    def job():
        return JobSpec(
            tag=hierarchical_fl(groups=("west", "east"),
                                dataset_groups={"west": ("d0", "d1"), "east": ("d2", "d3")},
                                trainer_program=TRAINER),
            datasets=tuple(DatasetSpec(name=f"d{i}") for i in range(4)),
            hyperparams={"rounds": 2, "init_weights": W0})
    spec = job()
    for d in spec.datasets:
        api.register_dataset(d)
    job_id = api.create_job(spec, deployment="multiproc",
                            deploy_options={"pool_size": 2, "sharded": True}, run_timeout=60.0)
    api.start_job(job_id)
    assert api.wait_job(job_id, timeout=90) == JobState.COMPLETED
    rec = api.job(job_id)
    assert rec.result is not None and not rec.result.errors
    base = run_job(job(), device="cpu", timeout=60)
    a, b = tree_to_numpy(rec.result.global_weights()), tree_to_numpy(base.global_weights())
    assert all(a[k].tobytes() == b[k].tobytes() for k in W0)
