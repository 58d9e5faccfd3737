"""Pooled hosts and sharded hubs over the port's processes, on the CPU:
twins of ``test_pooled_sharded.py``.

``pool_size`` (recycled worker hosts) and ``sharded`` (one hub per groupBy
label plus a root) are deployment knobs: a seeded job, dropout and re-join
included, gives byte-equal observables to the port's threaded run. The
standby-pool sizing is held to the JAX package's. Every job has its own
``timeout``.
"""
import numpy as np
import pytest

import repro.core.runtime as jrt
from _torch_programs import TRAINER
from repro.launch.spawn import _rejoin_high_water as jax_rejoin_high_water
from repro_torch.convert import tree_to_numpy
from repro_torch.core import channels as tch
from repro_torch.core.expansion import JobSpec
from repro_torch.core.runtime import RuntimePolicy, run_job
from repro_torch.core.tag import DatasetSpec
from repro_torch.core.topologies import classical_fl, hierarchical_fl
from repro_torch.launch.spawn import _rejoin_high_water, run_job_multiproc

_RNG = np.random.default_rng(11)
W0 = {
    "w": (0.01 * _RNG.normal(size=(32, 10))).astype(np.float32),
    "b": np.zeros((10,), np.float32),
}


def _hier_job(rounds=2):
    return JobSpec(
        tag=hierarchical_fl(groups=("west", "east"),
                            dataset_groups={"west": ("d0", "d1"), "east": ("d2", "d3")},
                            trainer_program=TRAINER),
        datasets=tuple(DatasetSpec(name=f"d{i}") for i in range(4)),
        hyperparams={"rounds": rounds, "init_weights": W0})


def _grouped_job(rounds=2):
    """A grouped flat topology: the param channel spans the west, east and
    default groups, three hub shards plus the root with ``sharded=True``."""
    return JobSpec(
        tag=classical_fl(groups=("west", "east"), trainer_program=TRAINER),
        datasets=tuple(DatasetSpec(name=f"d{i}") for i in range(4)),
        hyperparams={"rounds": rounds, "init_weights": W0})


def _observables(res):
    assert not res.errors, res.errors
    glob = res.program("global-aggregator-0")
    return {
        "participation": [
            (e["round"], list(e["included"]), list(e["excluded"]), list(e["missing"]))
            for e in getattr(glob, "participation_log", [])
        ],
        "dropped": dict(res.dropped),
        "events": list(res.events),
        "channel_bytes": dict(res.channel_bytes),
        "weights": {k: v.tobytes() for k, v in tree_to_numpy(res.global_weights()).items()},
    }


def test_rejoin_job_matches_threads_bytewise(assert_children_reaped):
    """A grouped deadline job with a trainer dropout and re-join on 2 pool
    hosts and one hub per group plus a root: participation, events, wire
    accounting and weights byte-equal to the threaded run; the merged shard
    stats equal the single-backend totals because each topic lives on one
    shard."""
    kw = dict(policy=RuntimePolicy(mode="deadline", deadline=10.0, grace=4.0,
                                   dropouts={"trainer-2": 0.5}, rejoins={"trainer-2": 1.5}),
              per_worker_hyperparams={f"trainer-{i}": {"compute_time": 1.0} for i in range(4)})
    base = run_job(_grouped_job(), device="cpu", timeout=60, **kw)
    ps = run_job_multiproc(_grouped_job(), device="cpu", timeout=60, pool_size=2, sharded=True,
                           **kw)
    assert ps.dropped == {"trainer-2": 0.5}
    assert (1.5, "rejoin", "trainer-2") in ps.events
    obs = _observables(ps)
    assert obs["participation"][0][3] == ["trainer-2"]
    assert "trainer-2" in obs["participation"][1][1]
    assert _observables(base) == obs
    assert_children_reaped()


def test_sync_pooled_sharded_weights_match():
    """Seeded sync H-FL, no policy: pooled and sharded gives the threaded
    run's global weights and per-channel wire bytes exactly."""
    base = run_job(_hier_job(), device="cpu", timeout=60)
    ps = run_job_multiproc(_hier_job(), device="cpu", timeout=60, pool_size=2, sharded=True)
    assert _observables(base) == _observables(ps)


def test_sharded_deadline_job_matches_threads():
    """A grouped deadline job over the sharded fabric (one ``send_many``
    per owning shard) against the threaded run, and against the single hub
    with one process per worker."""
    kw = dict(policy=RuntimePolicy(mode="deadline", deadline=10.0, grace=30.0),
              per_worker_hyperparams={f"trainer-{i}": {"compute_time": 1.0} for i in range(4)})
    base = run_job(_grouped_job(), device="cpu", timeout=60, **kw)
    sharded = run_job_multiproc(_grouped_job(), device="cpu", timeout=60, pool_size=2,
                                sharded=True, **kw)
    single = run_job_multiproc(_grouped_job(), device="cpu", timeout=60, **kw)
    assert _observables(base) == _observables(sharded) == _observables(single)


def test_reduced_hierarchical_rejoin_on_pooled_shards_matches_threads():
    """The hub reduce plane on the shard hubs: H-FL at ``reduce_plan`` 2
    under a deadline root, an intermediate aggregator dropped and re-joined
    on a pool host; its sync tier's uploads are folded by its group's hub.
    Byte-equal to the threaded run, with a partial per shard per round."""
    def job():
        spec = _hier_job(rounds=3)
        return JobSpec(tag=spec.tag, datasets=spec.datasets,
                       hyperparams={**spec.hyperparams, "reduce_plan": 2})
    kw = dict(policy=RuntimePolicy(mode="deadline", deadline=10.0, grace=4.0,
                                   dropouts={"aggregator-1": 1.5},
                                   rejoins={"aggregator-1": 2.5}),
              per_worker_hyperparams={f"trainer-{i}": {"compute_time": 1.0} for i in range(4)})
    base = run_job(job(), device="cpu", timeout=60, **kw)
    ps = run_job_multiproc(job(), device="cpu", timeout=60, pool_size=2, sharded=True, **kw)
    obs = _observables(ps)
    assert obs == _observables(base)
    assert ps.dropped == {"aggregator-1": 1.5} and (2.5, "rejoin", "aggregator-1") in ps.events
    assert obs["participation"][1][3] == ["aggregator-1"]
    stats = ps.channel_stats["param-channel"]
    assert stats["hub_partials"] == stats["hub_reduced"] > 0


@pytest.mark.parametrize("dropouts,rejoins,hosts", [
    ({"a-0": 1.0, "b-0": 4.0, "c-0": 2.0}, {"a-0": 2.0, "b-0": 5.0, "c-0": 3.5}, 1),
    ({"a-0": 1.0, "b-0": 1.5}, {"a-0": 3.0, "b-0": 3.5}, 2),
])
def test_standby_pool_sizing_matches_reference(dropouts, rejoins, hosts):
    """The re-join standby pool is sized by the most windows open at once:
    disjoint windows share one host, overlapping ones add hosts."""
    kw = dict(mode="deadline", deadline=5.0, grace=1.0, dropouts=dropouts, rejoins=rejoins)
    assert _rejoin_high_water(RuntimePolicy(**kw)) == hosts
    assert jax_rejoin_high_water(jrt.RuntimePolicy(**kw)) == hosts


class TestShardedFanoutTransparency:
    def test_sharded_deadline_job_identical_fanout_on_vs_off(self):
        """``test_pooled_sharded.py``'s twin: the ``send_many`` path over the
        sharded fabric (one encode per owning shard, fan-out in the hub) is
        invisible: a grouped deadline job gives the same observables with
        it on and off, pooled and sharded, on one hub and on threads."""
        kw = dict(policy=RuntimePolicy(mode="deadline", deadline=10.0, grace=30.0),
                  per_worker_hyperparams={f"trainer-{i}": {"compute_time": 1.0}
                                          for i in range(4)})
        runs = {}
        for enabled in (True, False):
            with tch.switches(fanout=enabled):
                runs["sharded", enabled] = _observables(run_job_multiproc(
                    _grouped_job(), device="cpu", timeout=120, pool_size=2, sharded=True, **kw))
                runs["threads", enabled] = _observables(
                    run_job(_grouped_job(), device="cpu", timeout=60, **kw))
        with tch.switches(fanout=True):
            runs["single", True] = _observables(
                run_job_multiproc(_grouped_job(), device="cpu", timeout=120, **kw))
        first = runs["sharded", True]
        assert all(obs == first for obs in runs.values()), sorted(runs)
        assert len(first["participation"]) == 2 and first["channel_bytes"]["param-channel"] > 0

