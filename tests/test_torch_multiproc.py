"""The port's process launcher (``repro_torch.launch.spawn``) on the CPU:
twins of ``test_multiproc_job.py`` and ``test_protocol_multiproc.py``.

Every process job runs with ``device="cpu"`` and is held byte-equal to the
port's threaded ``run_job`` of the same job, with a trainer whose update is
exact (``_torch_programs.HalfTrainer``); where the reference's own test
compares with its threaded run, the JAX package's threaded run of the same
update gives the same bytes too. Program classes that workers import live
in ``_torch_programs``. Every job has its own ``timeout``.
"""
import time

import numpy as np
import pytest
import torch

import repro.core.expansion as jexp
import repro.core.roles as jroles
import repro.core.runtime as jrt
import repro.core.tag as jtag
import repro.core.topologies as jtop
from _torch_programs import (
    HYBRID_TRAINER,
    TRAINER,
    BadPreRunTrainer,
    FailingAggregator,
    FailingTrainer,
    HardCrashTrainer,
    SleepyTrainer,
)
from repro_torch.convert import tree_to_numpy
from repro_torch.core.expansion import JobSpec
from repro_torch.core.runtime import RuntimePolicy, run_job
from repro_torch.core.tag import DatasetSpec
from repro_torch.core.topologies import (classical_fl, gossip_fl, hierarchical_fl, hybrid_fl,
                                          vertical_fl)
from repro_torch.launch.spawn import MultiprocLauncher, run_job_multiproc

_RNG = np.random.default_rng(7)
W0 = {
    "w": (0.01 * _RNG.normal(size=(32, 10))).astype(np.float32),
    "b": np.zeros((10,), np.float32),
}


class JaxHalfTrainer(jroles.Trainer):
    """``HalfTrainer`` in the JAX package."""

    def train(self):
        if self.weights is not None:
            idx = int(self.ctx.worker.dataset[1:])
            self.weights = {k: np.asarray(v, np.float32) * 0.5 + 0.25 * (idx + 1)
                            for k, v in self.weights.items()}
            self.num_samples = 10 + idx


def _classical_job(rounds=3, n_datasets=3):
    return JobSpec(
        tag=classical_fl(trainer_program=TRAINER),
        datasets=tuple(DatasetSpec(name=f"d{i}") for i in range(n_datasets)),
        hyperparams={"rounds": rounds, "init_weights": W0},
    )


def _hier_kwargs():
    return dict(groups=("west", "east"),
                dataset_groups={"west": ("d0", "d1"), "east": ("d2", "d3")})


def _bytes(tree):
    return {k: v.tobytes() for k, v in tree_to_numpy(tree).items()}


def _assert_programs_byte_equal(res_in, res_mp):
    assert not res_in.errors, res_in.errors
    assert not res_mp.errors, res_mp.errors
    assert sorted(res_in.programs) == sorted(res_mp.programs)
    for wid in res_in.programs:
        a = tree_to_numpy(res_in.programs[wid].weights)
        b = tree_to_numpy(res_mp.programs[wid].weights)
        assert sorted(a) == sorted(b), wid
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), (wid, k)


# ---------------------------------------------------------------------- #
# byte identity across deployments
# ---------------------------------------------------------------------- #
def test_seeded_sync_fedavg_inproc_vs_multiproc():
    """The transport-layer acceptance criterion: the same seeded sync job
    gives byte-equal global weights and the same wire accounting on threads
    and on a process tree, and the JAX package's threaded run the same."""
    res_in = run_job(_classical_job(), device="cpu", timeout=60)
    assert not res_in.errors, res_in.errors
    res_mp = run_job_multiproc(_classical_job(), device="cpu", timeout=60)
    assert not res_mp.errors, res_mp.errors
    assert _bytes(res_in.global_weights()) == _bytes(res_mp.global_weights())
    assert res_in.channel_bytes == res_mp.channel_bytes
    w = tree_to_numpy(res_mp.global_weights())
    assert w["w"].dtype == np.float32 and not np.array_equal(w["w"], W0["w"])
    # weights land on the job's device; each process reports its launches
    assert res_mp.global_weights()["w"].device.type == "cpu"
    root = res_mp.program("global-aggregator-0")
    assert root.is_root and root.peak_device_bytes is None
    assert root.launches and not any(root.launches.values())  # CPU: plain versions
    ref = jrt.run_job(jexp.JobSpec(
        tag=jtop.classical_fl(),
        datasets=tuple(jtag.DatasetSpec(name=f"d{i}") for i in range(3)),
        hyperparams={"rounds": 3, "init_weights": W0}), timeout=60,
        program_overrides={"trainer": JaxHalfTrainer})
    assert not ref.errors and ref.channel_bytes == res_in.channel_bytes
    assert all(w[k].tobytes() == np.asarray(ref.global_weights()[k]).tobytes() for k in W0)


def test_hierarchical_sync_job_over_multiproc():
    job = JobSpec(
        tag=hierarchical_fl(**_hier_kwargs(), trainer_program=TRAINER),
        datasets=tuple(DatasetSpec(name=f"d{i}") for i in range(4)),
        hyperparams={"rounds": 2, "init_weights": W0},
    )
    res_in = run_job(job, device="cpu", timeout=60)
    res_mp = run_job_multiproc(job, device="cpu", timeout=60)
    assert not res_in.errors and not res_mp.errors, (res_in.errors, res_mp.errors)
    assert _bytes(res_in.global_weights()) == _bytes(res_mp.global_weights())
    # both tiers moved bytes over the hub
    assert res_mp.channel_bytes == res_in.channel_bytes
    assert res_mp.channel_bytes["param-channel"] > 0
    assert res_mp.channel_bytes["global-channel"] > 0


@pytest.mark.parametrize("template", ["vertical", "gossip"])
def test_protocol_topology_inproc_vs_multiproc_byte_identical(template):
    """The vertical and gossip protocols, added by TAG templates and protocol
    classes only: every worker's weights byte-equal on threads and over
    processes, and the vertical head's loss trajectory equal too."""
    if template == "vertical":
        def job():
            return JobSpec(tag=vertical_fl(), hyperparams={"rounds": 2},
                           datasets=tuple(DatasetSpec(name=f"d{i}") for i in range(3)))
    else:
        zeros = {"w": np.zeros((32, 10), np.float32), "b": np.zeros((10,), np.float32)}

        def job():
            return JobSpec(tag=gossip_fl(trainer_program=TRAINER),
                           datasets=tuple(DatasetSpec(name=f"d{i}") for i in range(4)),
                           hyperparams={"rounds": 2, "init_weights": zeros})
    res_in = run_job(job(), device="cpu", timeout=60)
    res_mp = run_job_multiproc(job(), device="cpu", timeout=60)
    _assert_programs_byte_equal(res_in, res_mp)
    if template == "vertical":
        losses = [[m["vertical_loss"] for m in res.program("head-0").metrics
                   if "vertical_loss" in m] for res in (res_in, res_mp)]
        assert losses[0] == losses[1] and len(losses[0]) == 2


def test_hybrid_job_over_processes_byte_equal_to_threads():
    """``hybrid_fl`` over processes: 4 trainers in 2 clusters (c0: d0, d1;
    c1: d2, d3), 2 rounds. The ring members join in any order over
    processes; each cluster must still elect one leader, the one the
    threaded run elects, so that every program's weights are byte-equal to
    ``run_job``'s and each cluster uploads once a round."""
    job = JobSpec(
        tag=hybrid_fl(groups=("c0", "c1"), dataset_groups={"c0": ("d0", "d1"), "c1": ("d2", "d3")},
                      trainer_program=HYBRID_TRAINER),
        datasets=tuple(DatasetSpec(name=f"d{i}") for i in range(4)),
        hyperparams={"rounds": 2, "init_weights": W0},
    )
    res_in = run_job(job, device="cpu", timeout=60)
    res_mp = run_job_multiproc(job, device="cpu", timeout=60)
    _assert_programs_byte_equal(res_in, res_mp)
    assert res_in.channel_bytes == res_mp.channel_bytes
    root = res_mp.program("global-aggregator-0")
    assert [m["agg_folds"] for m in root.metrics if "agg_folds" in m] == [2, 2]
    w = tree_to_numpy(res_mp.global_weights())
    assert not np.array_equal(w["w"], W0["w"])


# ---------------------------------------------------------------------- #
# failure handling
# ---------------------------------------------------------------------- #
def test_worker_errors_marshalled_to_driver():
    res = run_job_multiproc(
        _classical_job(rounds=1, n_datasets=2), device="cpu", timeout=60,
        program_overrides={"trainer": FailingTrainer, "global-aggregator": FailingAggregator},
    )
    assert set(res.errors) >= {"trainer-0", "trainer-1", "global-aggregator-0"}
    assert "boom: load_data" in str(res.errors["trainer-0"])
    assert "boom: initialize" in str(res.errors["global-aggregator-0"])


def test_pre_barrier_failure_breaks_barrier_fast():
    """A worker failing before the start barrier aborts it, so the healthy
    workers fail fast instead of waiting out the job's timeout."""
    t0 = time.monotonic()
    res = run_job_multiproc(
        _classical_job(rounds=1, n_datasets=2), device="cpu", timeout=60,
        program_overrides={"trainer": BadPreRunTrainer},
    )
    assert "boom: pre_run" in str(res.errors["trainer-0"])
    assert "global-aggregator-0" in res.errors  # the broken barrier, surfaced
    assert time.monotonic() - t0 < 30.0


def test_hung_child_is_killed_not_wedged(assert_children_reaped):
    t0 = time.monotonic()
    res = run_job_multiproc(
        _classical_job(rounds=1, n_datasets=2), device="cpu", timeout=8.0,
        program_overrides={"trainer": SleepyTrainer},
    )
    assert "__timeout__" in res.errors
    assert time.monotonic() - t0 < 60.0
    assert_children_reaped()


def test_hard_crash_without_report_tears_tree_down(assert_children_reaped):
    """A worker dying before the barrier without reporting (``os._exit``)
    tears the tree down promptly: no zombie children, no waiting out the
    job's timeout; the crashed worker is labelled as crashed and its live
    peers as torn down after it. (``trainer-0`` alone crashes: with every
    trainer crashing, the first crash could tear ``trainer-0`` down while
    its process still started up, before it could crash.)"""
    t0 = time.monotonic()
    res = run_job_multiproc(
        _classical_job(rounds=1, n_datasets=2), device="cpu", timeout=60,
        program_overrides={"trainer": HardCrashTrainer},
    )
    assert time.monotonic() - t0 < 30.0
    assert "exited without a result (exitcode=3)" in str(res.errors["trainer-0"])
    for wid in ("trainer-1", "global-aggregator-0"):
        assert "torn down after peer crash: ['trainer-0']" in str(res.errors[wid]), res.errors
    assert "__timeout__" not in res.errors
    assert_children_reaped()


def test_unknown_tier_role_rejected_up_front():
    with pytest.raises(KeyError):
        MultiprocLauncher(_classical_job(), device="cpu",
                          policy=RuntimePolicy(mode="async", tiers={"nope": "async"}))


def test_child_without_a_card_fails_in_errors(monkeypatch):
    """No fallback: the driver asks for the card where there is none and
    raises; a child handed the card where there is none fails, and its error
    lands in ``JobResult.errors`` instead of the job running on the CPU."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_job_multiproc(_classical_job(rounds=1, n_datasets=1))
    launcher = MultiprocLauncher(_classical_job(rounds=1, n_datasets=1), device="cpu")
    launcher.device = torch.device("cuda", 0)  # what the children are given
    res = launcher.run(timeout=60)
    assert set(res.errors) >= {"trainer-0", "global-aggregator-0"}
    assert all("no CUDA device" in str(res.errors[w]) for w in ("trainer-0", "global-aggregator-0"))
