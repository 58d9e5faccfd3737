"""The port's hub reduce plane on the CPU: twins of ``test_hub_reduce.py``.

``reduce_plan`` is a performance switch: at one shard a seeded sync job is
byte-equal with and without it (the backend folds in the same sorted-source
order the server would), above one shard it is deterministic and within
1e-6 of the unreduced mean, and the kill switch and the policy modes leave
it off. The in-process jobs are held byte-equal to the JAX package's with a
trainer whose update is exact in both (``HalfTrainer``); so is the
``int8_blocks`` loopback job, where the hub decodes each update before it
folds: the question whether plan 1 stays byte-invisible on a coded channel,
asked of both packages. Process jobs run with ``device="cpu"``, each with
its own ``timeout``. Also here: the client's fire-and-forget ack window.
"""
import dataclasses
import os
import sys
import threading
import time

import numpy as np
import pytest

import repro.core.channels as jch
import repro.core.expansion as jexp
import repro.core.roles as jroles
import repro.core.runtime as jrt
import repro.core.tag as jtag
import repro.core.topologies as jtop
import repro_torch.core.expansion as texp
import repro_torch.core.tag as ttag
import repro_torch.core.topologies as ttop
from _torch_programs import TRAINER, HalfTrainer
from repro_torch.convert import tree_to_numpy
from repro_torch.core import channels as tch
from repro_torch.core.channels import WorkerDropped, reduce_blocks
from repro_torch.core.expansion import JobSpec
from repro_torch.core.runtime import RuntimePolicy, run_job
from repro_torch.core.tag import DatasetSpec
from repro_torch.core.topologies import classical_fl
from repro_torch.launch.spawn import run_job_multiproc
from repro_torch.transport.multiproc import MultiprocBackend, TransportHub

_RNG = np.random.default_rng(7)
W0 = {
    "w": (0.01 * _RNG.normal(size=(32, 10))).astype(np.float32),
    "b": np.zeros((10,), np.float32),
}


class JaxHalfTrainer(jroles.Trainer):
    def train(self):
        if self.weights is not None:
            idx = int(self.ctx.worker.dataset[1:])
            self.weights = {k: np.asarray(v, np.float32) * 0.5 + 0.25 * (idx + 1)
                            for k, v in self.weights.items()}
            self.num_samples = 10 + idx


def _hp(reduce_plan, rounds, init):
    hp = {"rounds": rounds, "init_weights": init}
    if reduce_plan is not None:
        hp["reduce_plan"] = reduce_plan
    return hp


def _job(reduce_plan=None, rounds=2, n_datasets=3, trainer=TRAINER, codec=None):
    tag = classical_fl(trainer_program=trainer)
    if codec is not None:
        tag = dataclasses.replace(tag, channels=tuple(
            dataclasses.replace(c, backend="multiproc", codec=codec) for c in tag.channels))
    return JobSpec(tag=tag, datasets=tuple(DatasetSpec(name=f"d{i}") for i in range(n_datasets)),
                   hyperparams=_hp(reduce_plan, rounds, W0))


def _ref_job(reduce_plan=None, rounds=2, n_datasets=3, codec=None):
    tag = jtop.classical_fl()
    if codec is not None:
        tag = dataclasses.replace(tag, channels=tuple(
            dataclasses.replace(c, backend="multiproc", codec=codec) for c in tag.channels))
    return jexp.JobSpec(tag=tag,
                        datasets=tuple(jtag.DatasetSpec(name=f"d{i}") for i in range(n_datasets)),
                        hyperparams=_hp(reduce_plan, rounds, W0))


def _observables(res):
    assert not res.errors, res.errors
    return {
        "dropped": res.dropped,
        "events": res.events,
        "channel_bytes": res.channel_bytes,
        "weights": {k: v.tobytes() for k, v in tree_to_numpy(res.global_weights()).items()},
    }


def _ref_weights(res):
    assert not res.errors, res.errors
    return {k: np.asarray(v).tobytes() for k, v in res.global_weights().items()}


def _agg_frames(res):
    prog = res.program("global-aggregator-0")
    return [m["agg_frames"] for m in prog.metrics if "agg_frames" in m]


def _with_reduce_env(enabled, fn):
    prev = os.environ.get("REPRO_HUB_REDUCE")
    os.environ["REPRO_HUB_REDUCE"] = "1" if enabled else "0"
    tch.set_hub_reduce(enabled)
    try:
        return fn()
    finally:
        if prev is None:
            os.environ.pop("REPRO_HUB_REDUCE", None)
        else:
            os.environ["REPRO_HUB_REDUCE"] = prev
        tch.set_hub_reduce(prev is None or prev not in ("0", "false"))


# ---------------------------------------------------------------------- #
# the partition
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("srcs,shards", [
    ([f"t-{i}" for i in range(10, 0, -1)], 3), ([], 2), (["a"], 0), (["a"], -1),
    (["b", "a"], 1), (["b", "a"], 5), ([f"w-{i}" for i in range(7)], 4),
])
def test_reduce_blocks_match_reference(srcs, shards):
    blocks = reduce_blocks(srcs, shards)
    assert blocks == jch.reduce_blocks(srcs, shards)
    if blocks:
        assert [s for b in blocks for s in b] == sorted(srcs)
        sizes = [len(b) for b in blocks]
        assert max(sizes) - min(sizes) <= 1 and sizes == sorted(sizes, reverse=True)


# ---------------------------------------------------------------------- #
# jobs on threads
# ---------------------------------------------------------------------- #
def test_sync_inproc_plan1_bitwise_identical():
    off = run_job(_job(), device="cpu", timeout=60)
    on = run_job(_job(reduce_plan=1), device="cpu", timeout=60)
    assert _observables(on) == _observables(off)
    assert _agg_frames(on) == [1, 1] and _agg_frames(off) == [3, 3]
    assert all(m["agg_folds"] == 3 for m in on.program("global-aggregator-0").metrics
               if "agg_folds" in m)


@pytest.mark.parametrize("codec", [None, "int8_blocks"])
def test_plan1_byte_equal_to_reference(codec):
    """Plan 1 against the JAX package's plan 1 and its unreduced job, in
    process and, with ``int8_blocks``, over the socket loopback, where the
    hub dequantizes each update before folding it and sends the partial
    uncoded: all four byte-equal."""
    kw = dict(device="cpu", timeout=60, program_overrides={"trainer": HalfTrainer})
    port_on = run_job(_job(1, codec=codec), **kw)
    port_off = run_job(_job(None, codec=codec), **kw)
    ref_on = jrt.run_job(_ref_job(1, codec=codec), timeout=60,
                         program_overrides={"trainer": JaxHalfTrainer})
    ref_off = jrt.run_job(_ref_job(None, codec=codec), timeout=60,
                          program_overrides={"trainer": JaxHalfTrainer})
    got = _observables(port_on)["weights"]
    assert got == _observables(port_off)["weights"] == _ref_weights(ref_on) \
        == _ref_weights(ref_off)
    assert port_on.channel_bytes == ref_on.channel_bytes
    assert _agg_frames(port_on) == _agg_frames(ref_on) == [1, 1]


def test_sync_inproc_multishard_deterministic():
    off = run_job(_job(), device="cpu", timeout=60)
    a = run_job(_job(reduce_plan=2), device="cpu", timeout=60)
    b = run_job(_job(reduce_plan=2), device="cpu", timeout=60)
    assert _observables(a) == _observables(b)
    assert _agg_frames(a) == [2, 2]
    wa, wo = tree_to_numpy(a.global_weights()), tree_to_numpy(off.global_weights())
    for k in W0:
        np.testing.assert_allclose(wa[k], wo[k], rtol=1e-6)


def test_kill_switch_forces_per_frame_path():
    off = run_job(_job(), device="cpu", timeout=60)
    killed = _with_reduce_env(False, lambda: run_job(_job(reduce_plan=2), device="cpu",
                                                     timeout=60))
    assert _observables(killed) == _observables(off)
    assert _agg_frames(killed) == [3, 3]


def test_deadline_policy_ignores_reduce_plan():
    kw = dict(device="cpu", timeout=60,
              policy=RuntimePolicy(mode="deadline", deadline=5.0, grace=5.0),
              per_worker_hyperparams={f"trainer-{i}": {"compute_time": 0.5} for i in range(3)})
    off = run_job(_job(), **kw)
    on = run_job(_job(reduce_plan=2), **kw)
    assert _observables(on) == _observables(off)
    assert all(m["agg_folds"] == 3 for m in on.program("global-aggregator-0").metrics
               if "agg_folds" in m)


# ---------------------------------------------------------------------- #
# jobs over processes
# ---------------------------------------------------------------------- #
def test_sync_multiproc_plan1_bitwise_identical():
    off = run_job_multiproc(_job(), device="cpu", timeout=60)
    on = run_job_multiproc(_job(reduce_plan=1), device="cpu", timeout=60)
    assert _observables(on) == _observables(off)
    assert _agg_frames(on) == [1, 1]
    on_in = run_job(_job(reduce_plan=1), device="cpu", timeout=60)
    assert _observables(on) == _observables(on_in)
    stats = on.channel_stats["param-channel"]
    assert stats["hub_reduced"] == 6.0 and stats["hub_partials"] == 2.0


def test_pooled_sharded_fabric_deterministic():
    kw = dict(device="cpu", timeout=60, pool_size=2, sharded=True)
    a = run_job_multiproc(_job(reduce_plan=2), **kw)
    b = run_job_multiproc(_job(reduce_plan=2), **kw)
    assert _observables(a) == _observables(b)
    assert _agg_frames(a) == [2, 2]
    on_in = run_job(_job(reduce_plan=2), device="cpu", timeout=60)
    assert _observables(a) == _observables(on_in)
    off = run_job(_job(), device="cpu", timeout=60)
    wa, wo = tree_to_numpy(a.global_weights()), tree_to_numpy(off.global_weights())
    for k in W0:
        np.testing.assert_allclose(wa[k], wo[k], rtol=1e-6)


# ---------------------------------------------------------------------- #
# the client's fire-and-forget ack window
# ---------------------------------------------------------------------- #
def _hub_client():
    hub = TransportHub(device="cpu")
    return hub, MultiprocBackend(hub.address, device="cpu")


def test_self_drain_caps_inflight_acks():
    hub, be = _hub_client()
    try:
        be.MAX_PENDING_ACKS = 4
        ch, g = "ack-ch", "default"
        for w in ("a-0", "b-0"):
            be.join(ch, g, w)
        for i in range(20):
            be.send(ch, g, "a-0", "b-0", {"i": i})
            assert len(be._state().unacked) <= 4, len(be._state().unacked)
        assert be.stats[f"msgs:{ch}"] == 20.0
        assert not be._state().unacked
        assert [be.recv(ch, g, "b-0", "a-0", timeout=5.0)["i"] for _ in range(20)] \
            == list(range(20))
    finally:
        be.close()
        hub.close()


def test_deferred_fault_surfaces_first_at_next_sync_op():
    hub, be = _hub_client()
    try:
        ch, g = "ack-ch", "default"
        for w in ("a-0", "b-0"):
            be.join(ch, g, w)
        be.set_drop("a-0", -1.0)  # every send from a-0 now faults hub-side
        be.send(ch, g, "a-0", "b-0", {"i": 0})
        be.send(ch, g, "a-0", "b-0", {"i": 1})
        assert len(be._state().unacked) == 2
        with pytest.raises(WorkerDropped):
            be.now("a-0")
        assert not be._state().unacked
        assert be.now("b-0") >= 0.0
    finally:
        be.close()
        hub.close()


# ---------------------------------------------------------------------- #
# the decode pool: test_hub_reduce.py::TestRecvOrderedDecodePool
# ---------------------------------------------------------------------- #
class TestRecvOrderedDecodePool:
    """``recv_ordered`` through the decode pool equals the sequential
    sorted loop: the same yield order and payloads, the same clock effect,
    a failure surfacing at its sorted position; at most ``workers + 1``
    payloads are held at once; and over a hub every receive counter is
    exact however the pool's threads interleave."""

    SRCS = sorted(f"t-{i}" for i in range(5))

    def _incast(self, be=None):
        be = be or tch.InprocBackend()
        for w in ("agg-0", *self.SRCS):
            be.join("up", "default", w)
        return be, tch.ChannelEnd(be, "up", "default", "agg-0")

    def _run(self, workers, skip=None, timeout=5.0):
        with tch.switches(decode_pool=workers):
            be, end = self._incast()
            for i, s in enumerate(self.SRCS):
                be.advance(s, 0.5 * (5 - i))  # later sources arrive earlier
                if s != skip:
                    be.send("up", "default", s, "agg-0", {"weights": {"w": np.float32(i)}})
            seen = []
            try:
                for s, m in end.recv_ordered(self.SRCS, timeout=timeout):
                    seen.append((s, np.asarray(m["weights"]["w"]).tobytes()))
            except Exception as e:  # noqa: BLE001 - compared across modes
                seen.append(type(e).__name__)
            return seen, be.now("agg-0")

    def test_defaults_match_reference(self):
        assert tch.decode_pool_workers() == jch.decode_pool_workers() == 4
        assert tch.broadcast_fanout_enabled() and jch.broadcast_fanout_enabled()

    def test_pooled_equals_sequential(self):
        seq = self._run(workers=0)
        assert [s for s, _ in seq[0]] == self.SRCS
        for workers in (2, 4, 8):
            assert self._run(workers=workers) == seq

    def test_failure_surfaces_at_sorted_position(self):
        """All but the middle source upload: both modes yield the two
        earlier sources, then raise ``queue.Empty`` at the middle one."""
        for workers in (0, 4):
            seen, _ = self._run(workers, skip=self.SRCS[2], timeout=0.2)
            assert seen[:2] == self._run(0)[0][:2] and seen[2:] == ["Empty"], (workers, seen)

    def test_holds_at_most_workers_plus_one_payloads(self):
        """A backend that counts the payloads fetched and not yet released
        by the consumer: the pool never runs more than ``workers`` ahead of
        the payload being folded."""
        class Counting(tch.InprocBackend):
            def __init__(self):
                super().__init__()
                self.lock, self.held, self.peak = threading.Lock(), 0, 0

            def recv(self, *args):
                msg = super().recv(*args)
                with self.lock:
                    self.held += 1
                    self.peak = max(self.peak, self.held)
                return msg

        with tch.switches(decode_pool=2):
            be, end = self._incast(Counting())
            srcs = sorted(f"u-{i:02d}" for i in range(12))
            for s in srcs:
                be.join("up", "default", s)
                be.send("up", "default", s, "agg-0", {"x": 1})
            for _ in end.recv_ordered(srcs, timeout=5.0):
                with be.lock:
                    be.held -= 1  # the consumer folded and dropped it
            assert be.held == 0 and 2 <= be.peak <= 3, be.peak

    def test_held_count_reaches_workers_plus_one_and_no_more(self):
        """``decode_pool_held``: a consumer that waits at each payload for
        the pool's fetches to land sees the count reach ``workers + 1``
        (fewer near the end) and the high-water mark stop there; a receive
        closed early counts nothing after."""
        srcs = sorted(f"u-{i:02d}" for i in range(7))
        for workers in (2, 3):
            bound = workers + 1
            with tch.switches(decode_pool=workers):
                be, end = self._incast()
                for s in srcs:
                    be.join("up", "default", s)
                    be.send("up", "default", s, "agg-0", {"x": 1})
                tch.reset_decode_pool_held("agg-0")
                seen = []
                for i, _ in enumerate(end.recv_ordered(srcs, timeout=5.0)):
                    want = min(bound, len(srcs) - i)
                    deadline = time.monotonic() + 5.0
                    while tch.decode_pool_held("agg-0")[0] < want and time.monotonic() < deadline:
                        time.sleep(0.001)
                    seen.append(tch.decode_pool_held("agg-0")[0])
                assert seen == [min(bound, len(srcs) - i) for i in range(len(srcs))], (workers, seen)
                assert tch.decode_pool_held("agg-0") == (0, bound)
                for s in srcs:
                    be.send("up", "default", s, "agg-0", {"x": 1})
                tch.reset_decode_pool_held("agg-0")
                for _ in end.recv_ordered(srcs, timeout=5.0):
                    break
                time.sleep(0.05)  # fetches still running when it closed land
                assert tch.decode_pool_held("agg-0")[0] == 0

    def test_four_groups_in_one_process_equal_sequential_and_reference(self):
        """A threaded ``hierarchical_fl`` job of 4 groups: the root and its
        4 intermediate aggregators receive through their pools in one
        process, so the root's fetches alone could hold 4 threads. With the
        pool at 4 the job is byte-equal to the pool at 0 and to the JAX
        package's job, which runs at its pool 0: its one process-wide pool
        deadlocks on this job (the root's fetches take every thread while
        the intermediates' fetches, which feed them, wait in its queue)."""
        groups = {f"g{i}": (f"d{2 * i}", f"d{2 * i + 1}") for i in range(4)}

        def job(top, exp, tag_mod):
            return exp.JobSpec(
                tag=top.hierarchical_fl(groups=tuple(groups), dataset_groups=groups),
                datasets=tuple(tag_mod.DatasetSpec(name=f"d{i}") for i in range(8)),
                hyperparams=_hp(None, 2, W0))

        def folds(res):
            return {w: [m["agg_folds"] for m in p.metrics if "agg_folds" in m]
                    for w, p in res.programs.items()}

        port = {}
        for workers in (4, 0):
            with tch.switches(decode_pool=workers):
                res = run_job(job(ttop, texp, ttag), device="cpu", timeout=60,
                              program_overrides={"trainer": HalfTrainer})
            port[workers] = (_observables(res), folds(res))
        prev = jch.decode_pool_workers()
        jch.set_decode_pool(0)
        try:
            ref = jrt.run_job(job(jtop, jexp, jtag), timeout=60,
                              program_overrides={"trainer": JaxHalfTrainer})
        finally:
            jch.set_decode_pool(prev)
        assert port[4] == port[0]
        obs, agg_folds = port[4]
        assert obs["weights"] == _ref_weights(ref)
        assert obs["channel_bytes"] == ref.channel_bytes and agg_folds == folds(ref)
        assert agg_folds["global-aggregator-0"] == [4, 4]

    def test_hub_counters_exact_under_the_pool(self):
        """Pooled receives over a hub, with a short switch interval: every
        payload arrives, and the client's ``payload_decodes:`` and the
        hub's message counters count each frame once."""
        hub, be = _hub_client()
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            with tch.switches(decode_pool=8):
                srcs = sorted(f"s-{i:02d}" for i in range(24))
                for w in ("agg-0", *srcs):
                    be.join("up", "default", w)
                end = tch.ChannelEnd(be, "up", "default", "agg-0")
                for rnd in range(3):
                    for i, s in enumerate(srcs):
                        be.send("up", "default", s, "agg-0",
                                {"w": np.full(64, i + rnd, np.float32)})
                    got = [(s, int(m["w"][0]))
                           for s, m in end.recv_ordered(srcs, timeout=10.0)]
                    assert got == [(s, i + rnd) for i, s in enumerate(srcs)]
            stats = be.stats
            assert stats["payload_decodes:up"] == 3 * len(srcs)
            assert stats["msgs:up"] == 3 * len(srcs)
        finally:
            sys.setswitchinterval(old)
            be.close()
            hub.close()

