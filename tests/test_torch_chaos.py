"""The port's transport fault plane on the CPU: twins of ``test_chaos.py``.

Every scenario is a seeded ``FaultPlan`` (connection resets, hub and
hub-shard crashes, a server restart) run through the port's
``run_job_multiproc(device="cpu")`` and held byte-equal to its fault-free
twin and to the JAX package's faulted run of the same job: weights, channel
bytes, drops and events. Both packages run a trainer whose update is exact
(``HalfTrainer``), so the bytes can be equal across them. The
``transport_recovery`` metric shows that each fault fired. Also here: a
faulted ``reduce_plan`` 1 job on an ``int8_blocks`` channel, whose hub
folds every upload exactly once, and ``InprocBackend.fabric_time`` against
the JAX package's.

Every job has its own ``timeout``; torch runs two intra-op threads in this
process (the hub's), as the other process-plane files do.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core.channels as jch
import repro.core.events as jev
import repro.core.expansion as jexp
import repro.core.runtime as jrt
import repro.core.tag as jtag
import repro.core.topologies as jtop
import repro.launch.spawn as jspawn
import repro_torch.core.channels as tch
import repro_torch.core.roles as troles
from _jax_programs import TRAINER as JAX_TRAINER
from _torch_programs import TRAINER
from repro_torch.convert import tree_to_numpy
from repro_torch.core.events import FaultPlan
from repro_torch.core.expansion import JobSpec
from repro_torch.core.runtime import RuntimePolicy
from repro_torch.core.tag import DatasetSpec
from repro_torch.core.topologies import classical_fl, hierarchical_fl
from repro_torch.launch.spawn import run_job_multiproc

pytestmark = pytest.mark.chaos

_RNG = np.random.default_rng(7)
W0 = {
    "w": (0.01 * _RNG.normal(size=(32, 10))).astype(np.float32),
    "b": np.zeros((10,), np.float32),
}
HIER = dict(groups=("west", "east"),
            dataset_groups={"west": ("d0", "d1"), "east": ("d2", "d3")})


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this process's torch work: the suite runs
    six files at once on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# the same jobs in both packages: (topologies, expansion, tag, trainer path)
PORT = (classical_fl, hierarchical_fl, JobSpec, DatasetSpec, TRAINER)
REF = (jtop.classical_fl, jtop.hierarchical_fl, jexp.JobSpec, jtag.DatasetSpec, JAX_TRAINER)


def _classical_job(pkg, rounds=2, n_datasets=3, codec=None, **extra_hp):
    classical, _, job_spec, dataset, trainer = pkg
    tag = classical(trainer_program=trainer)
    if codec is not None:
        tag = dataclasses.replace(tag, channels=tuple(
            dataclasses.replace(c, codec=codec) for c in tag.channels))
    return job_spec(tag=tag, datasets=tuple(dataset(name=f"d{i}") for i in range(n_datasets)),
                    hyperparams={"rounds": rounds, "init_weights": W0, **extra_hp})


def _hier_job(pkg, rounds=2):
    _, hier, job_spec, dataset, trainer = pkg
    return job_spec(tag=hier(**HIER, trainer_program=trainer),
                    datasets=tuple(dataset(name=f"d{i}") for i in range(4)),
                    hyperparams={"rounds": rounds, "init_weights": W0})


def _observables(res):
    assert not res.errors, res.errors
    return {
        "weights": {k: v.tobytes() for k, v in sorted(tree_to_numpy(res.global_weights()).items())},
        "channel_bytes": dict(res.channel_bytes),
        "dropped": dict(res.dropped),
        "events": list(res.events),
    }


def _ref_observables(res):
    assert not res.errors, res.errors
    return {
        "weights": {k: np.asarray(v).tobytes() for k, v in sorted(res.global_weights().items())},
        "channel_bytes": dict(res.channel_bytes),
        "dropped": dict(res.dropped),
        "events": list(res.events),
    }


def _recovery(res):
    for m in res.program("global-aggregator-0").metrics:
        if "transport_recovery" in m:
            return m["transport_recovery"]
    return None


def _both_faulted(job_fn, plan, timeout, **kw):
    """The port's fault-free and faulted runs and the JAX package's faulted
    run of one job."""
    clean = run_job_multiproc(job_fn(PORT), device="cpu", timeout=timeout,
                              policy=RuntimePolicy(), **kw)
    faulted = run_job_multiproc(job_fn(PORT), device="cpu", timeout=timeout,
                                policy=RuntimePolicy(faults=FaultPlan(**plan)), **kw)
    ref = jspawn.run_job_multiproc(job_fn(REF), timeout=timeout,
                                   policy=jrt.RuntimePolicy(faults=jev.FaultPlan(**plan)), **kw)
    return clean, faulted, ref


def test_hub_crash_and_conn_reset_byte_identical():
    """A sync job with a hub crash and a worker's connection reset ends
    byte-equal to its fault-free run and to the JAX package's faulted run:
    lost frames are sent again by the session layer and run exactly once."""
    clean, faulted, ref = _both_faulted(
        _classical_job, {"conn_resets": {"trainer-1": 0.5}, "hub_crashes": {"": 1.0}}, 120)
    assert _observables(faulted) == _observables(clean) == _ref_observables(ref)
    rec = _recovery(faulted)
    assert rec is not None and rec["hub_restarts"] >= 1.0 and rec["resumes"] >= 1.0
    assert _recovery(clean) is None


def test_hub_shard_crash_on_sharded_fabric():
    """A hub-shard crash on the sharded fabric (a hub per group) recovers
    the same way: the H-FL job matches the fault-free sharded run and the
    JAX package's faulted one byte for byte."""
    clean, faulted, ref = _both_faulted(_hier_job, {"hub_crashes": {"west": 0.5}}, 180,
                                        sharded=True)
    assert _observables(faulted) == _observables(clean) == _ref_observables(ref)
    rec = _recovery(faulted)
    assert rec is not None and rec["hub_restarts"] >= 1.0


def test_unknown_shard_key_rejected():
    """Arming a crash for a shard the fabric does not host is a
    configuration error in both packages, single hub or sharded."""
    plan = {"hub_crashes": {"nope": 1.0}}
    for sharded, job in ((False, _classical_job), (True, _hier_job)):
        with pytest.raises(ValueError, match="unknown hub_crash shard key"):
            run_job_multiproc(job(PORT), device="cpu", timeout=60, sharded=sharded,
                              policy=RuntimePolicy(faults=FaultPlan(**plan)))
        with pytest.raises(ValueError, match="unknown hub_crash shard key"):
            jspawn.run_job_multiproc(job(REF), timeout=60, sharded=sharded,
                                     policy=jrt.RuntimePolicy(faults=jev.FaultPlan(**plan)))


def test_fedbuff_restart_resumes_from_checkpoint(tmp_path):
    """A FedBuff server killed mid-job (``server_restarts``) restores from
    its latest checkpoint and ends with the absorbed sequence, version
    vector and final weights of the fault-free run, and of the JAX
    package's restarted run."""
    per_worker = {"trainer-0": {"compute_time": 1.0},
                  "trainer-1": {"compute_time": 50.0}}  # never finishes an upload
    pol = dict(mode="async", buffer_size=1, grace=3.0, dropouts={"trainer-1": 0.5})
    restart = {"server_restarts": {"global-aggregator-0": (2.5, 3.0)}}
    clean = run_job_multiproc(_classical_job(PORT, rounds=3, n_datasets=2), device="cpu",
                              timeout=120, policy=RuntimePolicy(**pol),
                              per_worker_hyperparams=per_worker)
    runs = []
    for pkg, spawn, policy, plan in ((PORT, run_job_multiproc, RuntimePolicy, FaultPlan),
                                     (REF, jspawn.run_job_multiproc, jrt.RuntimePolicy,
                                      jev.FaultPlan)):
        kw = {"device": "cpu"} if pkg is PORT else {}
        ckpt_dir = tmp_path / ("port" if pkg is PORT else "ref")
        runs.append(spawn(
            _classical_job(pkg, rounds=3, n_datasets=2, checkpoint_every=1,
                           checkpoint_dir=str(ckpt_dir)),
            timeout=120, policy=policy(**pol, faults=plan(**restart)),
            per_worker_hyperparams=per_worker, **kw))
    res, ref = runs
    assert not res.errors and not ref.errors and not clean.errors

    def _absorbed(r):
        return [(e["src"], e["version"], e["staleness"])
                for e in r.program("global-aggregator-0").staleness_log]

    assert _absorbed(res) == _absorbed(clean) == _absorbed(ref)
    assert _absorbed(res) == [("trainer-0", v, 0) for v in range(3)]
    glob, rglob = res.program("global-aggregator-0"), ref.program("global-aggregator-0")
    assert glob.version == rglob.version == 3
    assert glob.version_vector == clean.program("global-aggregator-0").version_vector
    assert glob.version_vector == rglob.version_vector
    # v2 was the newest checkpoint when the server died at t=2.5
    assert {"restored_step": 2} in glob.metrics and {"restored_step": 2} in rglob.metrics
    assert res.dropped["global-aggregator-0"] == 2.5
    assert (2.5, "dropout", "global-aggregator-0") in res.events
    assert (3.0, "rejoin", "global-aggregator-0") in res.events
    assert res.events == ref.events and res.dropped == ref.dropped
    w = _observables(res)["weights"]
    assert w == _observables(clean)["weights"] == _ref_observables(ref)["weights"]
    assert w["w"] != W0["w"].tobytes()  # training happened


def test_faulted_coded_reduce_job_folds_every_upload_once(monkeypatch):
    """A ``reduce_plan`` 1 job on an ``int8_blocks`` channel, its hub
    decoding and folding each upload in this process, under a connection
    reset and a hub crash: byte-equal to its fault-free run and to the JAX
    package's faulted run, with as many hub folds as uploads in both port
    runs (a frame sent again after a fault is answered from the replay
    cache, never folded twice)."""
    folds = []
    fold_into = troles.fold_into

    def counting(acc, tree, w):
        folds.append(1)
        return fold_into(acc, tree, w)

    monkeypatch.setattr(troles, "fold_into", counting)

    def job(pkg):
        return _classical_job(pkg, codec="int8_blocks", reduce_plan=1)

    plan = {"conn_resets": {"trainer-1": 0.5}, "hub_crashes": {"": 1.0}}
    clean = run_job_multiproc(job(PORT), device="cpu", timeout=120)
    clean_folds, folds[:] = len(folds), []
    faulted = run_job_multiproc(job(PORT), device="cpu", timeout=120,
                                policy=RuntimePolicy(faults=FaultPlan(**plan)))
    faulted_folds = len(folds)
    ref = jspawn.run_job_multiproc(job(REF), timeout=120,
                                   policy=jrt.RuntimePolicy(faults=jev.FaultPlan(**plan)))
    assert _observables(faulted) == _observables(clean) == _ref_observables(ref)
    # 2 rounds x 3 trainers, each upload folded once by the hub
    assert faulted_folds == clean_folds == 6
    for res in (clean, faulted):
        stats = res.channel_stats["param-channel"]
        assert stats["hub_reduced"] == 6 and stats["hub_partials"] == 2
    rec = _recovery(faulted)
    assert rec is not None and rec["hub_restarts"] >= 1.0 and rec["resumes"] >= 1.0


def test_fabric_time_matches_reference():
    """``InprocBackend.fabric_time`` is the largest worker clock, 0 with no
    worker, in both packages."""
    port, ref = tch.InprocBackend("p"), jch.InprocBackend("r")
    for be in (port, ref):
        assert be.fabric_time() == 0.0
        be.join("ch", "g", "a-0")
        be.join("ch", "g", "b-0")
        be.advance("a-0", 1.5)
        be.set_clock("b-0", 0.75)
        be.advance("b-0", 2.0)
    assert port.fabric_time() == ref.fabric_time() == 2.75


def test_server_restart_leaves_the_callers_schedule_alone():
    """A ``FaultPlan``'s server restart is folded into the policy's own
    dropout and re-join schedule, not into the dicts the caller passed: a
    fault-free policy built from the same dict keeps its schedule (the JAX
    package's ``RuntimePolicy`` writes the restart into the caller's dict)."""
    drops = {"trainer-1": 0.5}
    restart = FaultPlan(server_restarts={"global-aggregator-0": (2.5, 3.0)})
    faulted = RuntimePolicy(mode="async", dropouts=drops, faults=restart)
    clean = RuntimePolicy(mode="async", dropouts=drops)
    assert faulted.dropouts == {"trainer-1": 0.5, "global-aggregator-0": 2.5}
    assert faulted.rejoins == {"global-aggregator-0": 3.0}
    assert drops == clean.dropouts == {"trainer-1": 0.5} and clean.rejoins == {}
    ref_drops = {"trainer-1": 0.5}
    jrt.RuntimePolicy(mode="async", dropouts=ref_drops, faults=jev.FaultPlan(
        server_restarts={"global-aggregator-0": (2.5, 3.0)}))
    assert ref_drops == {"trainer-1": 0.5, "global-aggregator-0": 2.5}
