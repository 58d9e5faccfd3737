"""Deadline and async ``RuntimePolicy`` jobs over the port's process tree,
on the CPU: twins of ``test_multiproc_policy.py``.

The same seeded policy job, dropout and re-join schedules included, gives
the same participation sets, version vectors, lifecycle events and (where
the reference compares them) weights and wire bytes on the port's threaded
runtime and on ``repro_torch.launch.spawn``; the threaded runs are held to
the JAX package's participation, events and drops. Schedules force every
ordering by virtual times, as the reference's do. Every job has its own
``timeout``.
"""
import numpy as np

import repro.core.expansion as jexp
import repro.core.runtime as jrt
import repro.core.tag as jtag
import repro.core.topologies as jtop
from _torch_programs import TRAINER, FanoutProbeAggregator, SlowRejoinTrainer
from repro_torch.convert import tree_to_numpy
from repro_torch.core import channels as tch
from repro_torch.core.expansion import JobSpec
from repro_torch.core.runtime import RuntimePolicy, run_job
from repro_torch.core.tag import DatasetSpec
from repro_torch.core.topologies import classical_fl, hierarchical_fl
from repro_torch.launch.spawn import run_job_multiproc

_RNG = np.random.default_rng(7)
W0 = {
    "w": (0.01 * _RNG.normal(size=(32, 10))).astype(np.float32),
    "b": np.zeros((10,), np.float32),
}


def _classical_job(rounds=2, n_datasets=3, pkg="port"):
    if pkg == "port":
        return JobSpec(tag=classical_fl(trainer_program=TRAINER),
                       datasets=tuple(DatasetSpec(name=f"d{i}") for i in range(n_datasets)),
                       hyperparams={"rounds": rounds, "init_weights": W0})
    # the JAX package's trainer: only participation, versions, drops and
    # events are compared with it
    return jexp.JobSpec(tag=jtop.classical_fl(),
                        datasets=tuple(jtag.DatasetSpec(name=f"d{i}") for i in range(n_datasets)),
                        hyperparams={"rounds": rounds, "init_weights": W0})


def _participation(res):
    return [
        {k: (list(e[k]) if k != "round" else e[k])
         for k in ("round", "included", "excluded", "missing")}
        for e in res.program("global-aggregator-0").participation_log
    ]


def _three_ways(policy_kw, per_worker, rounds=2, n_datasets=3):
    """The job on the port's threads, the port's processes and the JAX
    package's threads."""
    res_in = run_job(_classical_job(rounds, n_datasets), device="cpu", timeout=60,
                     policy=RuntimePolicy(**policy_kw), per_worker_hyperparams=per_worker)
    res_mp = run_job_multiproc(_classical_job(rounds, n_datasets), device="cpu", timeout=60,
                               policy=RuntimePolicy(**policy_kw),
                               per_worker_hyperparams=per_worker)
    ref = jrt.run_job(_classical_job(rounds, n_datasets, pkg="jax"), timeout=60,
                      policy=jrt.RuntimePolicy(**policy_kw), per_worker_hyperparams=per_worker)
    for res in (res_in, res_mp, ref):
        assert not res.errors, res.errors
    return res_in, res_mp, ref


def test_deadline_participation_sets_match_inproc():
    """A deadline job with a straggler and a mid-round dropout: per-round
    participation sets, the dropout ledger and the lifecycle events equal
    across deployments and packages."""
    res_in, res_mp, ref = _three_ways(
        dict(mode="deadline", deadline=2.0, grace=5.0, dropouts={"trainer-1": 0.7}),
        {"trainer-0": {"compute_time": 0.5}, "trainer-1": {"compute_time": 0.5},
         "trainer-2": {"compute_time": 5.0}})
    part = _participation(res_mp)
    assert _participation(res_in) == part == _participation(ref)
    assert part[0]["included"] == ["trainer-0", "trainer-1"]
    assert part[0]["excluded"] == ["trainer-2"]
    assert part[1]["missing"] == ["trainer-1"]
    assert res_in.dropped == res_mp.dropped == ref.dropped == {"trainer-1": 0.7}
    assert res_in.events == res_mp.events == ref.events
    w_in, w_mp = tree_to_numpy(res_in.global_weights()), tree_to_numpy(res_mp.global_weights())
    assert all(w_in[k].tobytes() == w_mp[k].tobytes() for k in W0)


def test_async_version_vector_matches_inproc():
    """An async FedBuff job whose second trainer drops before its first
    upload: the absorbed-update sequence, final version, version vector,
    drops and weights equal across deployments. Wire bytes are not compared:
    the server broadcasts right after each absorb, and whether one of those
    broadcasts still finds the dropped trainer on the channel is decided by
    thread timing (one message more or less on a loaded host)."""
    res_in, res_mp, ref = _three_ways(
        dict(mode="async", buffer_size=1, grace=3.0, dropouts={"trainer-1": 0.5}),
        {"trainer-0": {"compute_time": 1.0}, "trainer-1": {"compute_time": 50.0}},
        rounds=3, n_datasets=2)
    glob_in, glob_mp = res_in.program("global-aggregator-0"), res_mp.program("global-aggregator-0")

    def _absorbed(log):
        return [(e["src"], e["version"], e["staleness"]) for e in log]

    assert _absorbed(glob_in.staleness_log) == _absorbed(glob_mp.staleness_log) \
        == _absorbed(ref.program("global-aggregator-0").staleness_log) \
        == [("trainer-0", v, 0) for v in range(3)]
    assert glob_in._version == glob_mp.version == 3
    assert glob_in._version_vector["trainer-0"] == glob_mp.version_vector["trainer-0"] == 2
    assert res_in.dropped == res_mp.dropped == ref.dropped == {"trainer-1": 0.5}
    assert res_in.events == res_mp.events == ref.events
    w_in, w_mp = tree_to_numpy(res_in.global_weights()), tree_to_numpy(res_mp.global_weights())
    assert w_in["w"].tobytes() == w_mp["w"].tobytes()
    assert not np.array_equal(w_mp["w"], W0["w"])


def test_rejoin_respawns_worker_and_matches_inproc():
    """Dropout and re-join over processes: the worker's process ends on the
    hub-enforced dropout and it comes back on a warm standby host; it misses
    the round it died in and is included in the next, as on threads."""
    res_in, res_mp, ref = _three_ways(
        dict(mode="deadline", deadline=10.0, grace=4.0,
             dropouts={"trainer-2": 0.5}, rejoins={"trainer-2": 1.5}),
        {f"trainer-{i}": {"compute_time": 1.0} for i in range(3)})
    part = _participation(res_mp)
    assert _participation(res_in) == part == _participation(ref)
    assert part[0]["missing"] == ["trainer-2"]
    assert "trainer-2" in part[1]["included"]
    assert res_in.dropped == res_mp.dropped == {"trainer-2": 0.5}
    assert (1.5, "rejoin", "trainer-2") in res_mp.events
    assert res_in.events == res_mp.events == ref.events


def test_slow_rejoin_process_is_still_addressed_by_the_next_round():
    """The re-joined worker's process takes a second to start: its channel
    memberships are restored hub-side at the re-join, so the deadline
    root's next round still addresses it and waits for it, as on threads
    (without the restore it missed that round, or the root finished first
    and the worker waited out its receive)."""
    kw = dict(policy=RuntimePolicy(mode="deadline", deadline=10.0, grace=4.0,
                                   dropouts={"trainer-2": 0.5}, rejoins={"trainer-2": 1.5}),
              per_worker_hyperparams={f"trainer-{i}": {"compute_time": 1.0} for i in range(3)},
              program_overrides={"trainer": SlowRejoinTrainer})
    res_in = run_job(_classical_job(), device="cpu", timeout=60, **kw)
    res_mp = run_job_multiproc(_classical_job(), device="cpu", timeout=60, **kw)
    assert not res_in.errors and not res_mp.errors, (res_in.errors, res_mp.errors)
    part = _participation(res_mp)
    assert part == _participation(res_in)
    assert part[0]["missing"] == ["trainer-2"] and "trainer-2" in part[1]["included"]
    assert res_in.events == res_mp.events
    w_in, w_mp = tree_to_numpy(res_in.global_weights()), tree_to_numpy(res_mp.global_weights())
    assert all(w_in[k].tobytes() == w_mp[k].tobytes() for k in W0)


def test_unfired_dropout_reclaims_standby_at_teardown(assert_children_reaped):
    """A standby whose dropout never fires is warmed but never used; the
    teardown stops it: a clean result, full participation, no children
    left."""
    res_mp = run_job_multiproc(
        _classical_job(rounds=1), device="cpu", timeout=60,
        policy=RuntimePolicy(mode="deadline", deadline=10.0, grace=4.0,
                             dropouts={"trainer-1": 900.0}, rejoins={"trainer-1": 901.0}),
        per_worker_hyperparams={f"trainer-{i}": {"compute_time": 1.0} for i in range(3)})
    assert not res_mp.errors, res_mp.errors
    assert res_mp.dropped == {}
    assert _participation(res_mp)[0]["included"] == ["trainer-0", "trainer-1", "trainer-2"]
    assert_children_reaped()


def test_intermediate_dropout_surfaces_same_orphans_as_inproc():
    """An H-FL intermediate aggregator dropping for good: its children are
    poisoned hub-side and surface in ``dropped`` and ``orphaned`` events as
    on threads, and the surviving subtree still moves the global model."""
    def job():
        return JobSpec(
            tag=hierarchical_fl(groups=("west", "east"),
                                dataset_groups={"west": ("d0", "d1"), "east": ("d2", "d3")},
                                trainer_program=TRAINER),
            datasets=tuple(DatasetSpec(name=f"d{i}") for i in range(4)),
            hyperparams={"rounds": 3, "init_weights": W0})
    kw = dict(policy=RuntimePolicy(mode="async", tiers={"aggregator": "async"}, grace=3.0,
                                   buffer_size=2, dropouts={"aggregator-0": 0.5}),
              per_worker_hyperparams={f"trainer-{i}": {"compute_time": 1.0} for i in range(4)})
    res_in = run_job(job(), device="cpu", timeout=60, **kw)
    res_mp = run_job_multiproc(job(), device="cpu", timeout=60, **kw)
    assert not res_in.errors and not res_mp.errors, (res_in.errors, res_mp.errors)
    assert res_in.dropped == res_mp.dropped
    assert res_mp.dropped.get("aggregator-0") == 0.5
    orphans = [{w for _, kind, w in res.events if kind == "orphaned"} for res in (res_in, res_mp)]
    assert orphans[0] == orphans[1] and len(orphans[1]) == 2
    assert all(res_mp.dropped[w] == 0.5 for w in orphans[1])
    assert not np.array_equal(tree_to_numpy(res_mp.global_weights())["w"], W0["w"])


# ---------------------------------------------------------------------- #
# the broadcast fan-out switch: TestBroadcastFanoutTransparency
# ---------------------------------------------------------------------- #
class TestBroadcastFanoutTransparency:
    """The ``send_many`` broadcast path is a performance switch only:
    seeded jobs give byte-equal observables with it on and off, on the
    threaded runtime and over processes, whose workers take the switch
    from the inherited environment."""

    @staticmethod
    def _observables(res):
        assert not res.errors, res.errors
        out = {
            "dropped": res.dropped,
            "events": res.events,
            "channel_bytes": res.channel_bytes,
            "weights": {k: v.tobytes() for k, v in tree_to_numpy(res.global_weights()).items()},
        }
        if getattr(res.program("global-aggregator-0"), "participation_log", None):
            out["participation"] = _participation(res)
        return out

    @staticmethod
    def _both(run):
        out = []
        for enabled in (True, False):
            with tch.switches(fanout=enabled):
                out.append(run())
        return out

    def test_switch_routes_broadcasts(self):
        """On: one backend ``send_many`` per broadcast; off: one ``send``
        per destination; the same mailboxes either way."""
        calls = []

        class Spy(tch.InprocBackend):
            """Records the calls made from outside (the backend's ``send``
            and ``send_many`` call each other)."""

            depth = 0

            def _outer(self, name, fn, *a):
                if not self.depth:
                    calls.append(name)
                self.depth += 1
                try:
                    fn(*a)
                finally:
                    self.depth -= 1

            def send(self, *a):
                self._outer("send", super().send, *a)

            def send_many(self, *a):
                self._outer("send_many", super().send_many, *a)

        got = []
        for enabled, want in ((True, ["send_many"]), (False, ["send"] * 3)):
            be, calls[:] = Spy(), []
            for w in ("agg-0", "t-0", "t-1", "t-2"):
                be.join("ch", "default", w)
            with tch.switches(fanout=enabled):
                tch.ChannelEnd(be, "ch", "default", "agg-0").broadcast({"v": 1})
            assert calls == want and tch.broadcast_fanout_enabled()
            got.append([be.recv("ch", "default", t, "agg-0", 1.0) for t in ("t-0", "t-1", "t-2")])
        assert got[0] == got[1] == [{"v": 1}] * 3

    def test_sync_job_identical_fanout_on_vs_off(self):
        def job():
            return _classical_job(rounds=2)

        on_in, off_in = self._both(lambda: run_job(job(), device="cpu", timeout=60))
        assert self._observables(on_in) == self._observables(off_in)
        probe = {"global-aggregator": FanoutProbeAggregator}
        on_mp, off_mp = self._both(lambda: run_job_multiproc(
            job(), device="cpu", timeout=120, program_overrides=probe))
        assert self._observables(on_mp) == self._observables(off_mp)
        # across deployments, with the fan-out on in both
        assert self._observables(on_in) == self._observables(on_mp)
        # the spawned root took the switch from its environment
        assert [res.program("global-aggregator-0").metrics[0] for res in (on_mp, off_mp)] == [
            {"fanout": True}, {"fanout": False}]

    def test_deadline_job_identical_fanout_on_vs_off(self):
        kw = dict(policy=RuntimePolicy(mode="deadline", deadline=2.0, grace=5.0,
                                       dropouts={"trainer-1": 0.7}),
                  per_worker_hyperparams={"trainer-0": {"compute_time": 0.5},
                                          "trainer-1": {"compute_time": 0.5},
                                          "trainer-2": {"compute_time": 5.0}})
        on_in, off_in = self._both(lambda: run_job(_classical_job(), device="cpu", timeout=60,
                                                   **kw))
        assert self._observables(on_in) == self._observables(off_in)
        on_mp, off_mp = self._both(lambda: run_job_multiproc(
            _classical_job(), device="cpu", timeout=120, **kw))
        assert self._observables(on_mp) == self._observables(off_mp)
        assert self._observables(on_in) == self._observables(on_mp)
        # the schedule bit: the straggler excluded, the dropout recorded
        assert _participation(on_mp)[0]["excluded"] == ["trainer-2"]
        assert on_mp.dropped == {"trainer-1": 0.7}

