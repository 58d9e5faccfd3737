"""The port's socket transport (``repro_torch.transport.multiproc``) and its
coded channels, against the JAX package's, on the CPU.

* the port's conformance suite over every registered backend (the
  ``multiproc`` loopback included), over clients of one shared hub and over
  the routers of a sharded fabric, the three session checks (a blocked
  receive across a severed connection, a duplicate send, an evicted
  replay) among them;
* the loopback twins of the codec and collision cases of
  ``tests/test_transport_conformance.py``;
* small ``classical_fl`` jobs with the param channel on the loopback, per
  codec, through the port's ``run_job(device="cpu")`` and the JAX package's
  ``run_job``: with deterministic updates the global weights are byte-equal
  and the channel accounting (bytes, raw bytes, codec ratio, encode and
  decode counts) equal; the seeded SGD job agrees within one quantization
  step.

Every hub binds port 0, every receive has a timeout, and every hub or
manager is closed in ``finally`` (or by a fixture).
"""
import dataclasses
import socket as socket_mod

import numpy as np
import pytest
import torch

import repro.core.roles as jroles
import repro.core.runtime as jruntime
import repro.core.tag as jtag
import repro.core.topologies as jtop
import repro_torch.core.roles as troles
import repro_torch.core.runtime as truntime
import repro_torch.core.tag as ttag
import repro_torch.core.topologies as ttop
from repro.core.expansion import JobSpec as JJobSpec
from repro.transport.conformance import SeededSGDTrainer as JSeededSGDTrainer
from repro_torch import transport as _transport  # noqa: F401 - registers multiproc
from repro_torch.convert import tree_to_numpy
from repro_torch.core.channels import ChannelManager, LinkModel, registered_backends
from repro_torch.core.channels import backend_factory as registry_factory
from repro_torch.core.expansion import JobSpec
from repro_torch.kernels.quant import kernel as qkernel
from repro_torch.transport.conformance import CONFORMANCE_CHECKS, SeededSGDTrainer, run_conformance
from repro_torch.transport.multiproc import (
    LoopbackMultiprocBackend,
    MultiprocBackend,
    ShardedTransportHub,
    ShardRouter,
    TransportHub,
    hub_backend_factory,
    sharded_backend_factory,
)
from repro_torch.transport.wire import WireError, registered_codecs

TIMEOUT = 10.0


@pytest.fixture
def tracked():
    """Backends and managers made in a test, closed on teardown."""
    made = []
    yield made
    for obj in made:
        obj.close()


def _registry_factory(name, made):
    make = registry_factory(name)

    def factory():
        be = make()
        if hasattr(be, "close"):
            made.append(be)
        set_device = getattr(be, "set_device", None)
        if set_device is not None:
            set_device("cpu")
        return be

    return factory


def _manager(made, codec="", backend="multiproc"):
    mgr = ChannelManager(
        [ttag.Channel(name="ch", pair=("a", "b"), backend=backend, codec=codec)], device="cpu"
    )
    made.append(mgr)
    return mgr, mgr.end("ch", "default", "a-0"), mgr.end("ch", "default", "b-0")


# ------------------------------------------------------------------ #
# conformance
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("backend_name", registered_backends())
@pytest.mark.parametrize("check_name", sorted(CONFORMANCE_CHECKS))
def test_registered_backend_conformance(backend_name, check_name, tracked):
    run_conformance(_registry_factory(backend_name, tracked), checks=[check_name])


@pytest.mark.parametrize("check_name", sorted(CONFORMANCE_CHECKS))
def test_shared_hub_conformance(check_name, tracked):
    """Many clients of one hub, distinct from the loopback flavor (a private
    hub per backend)."""
    hub = TransportHub(device="cpu")
    tracked.append(hub)

    def factory():
        client = MultiprocBackend(hub.address, device="cpu")
        tracked.insert(0, client)
        return client

    run_conformance(factory, checks=[check_name])


@pytest.mark.parametrize("check_name", sorted(CONFORMANCE_CHECKS))
def test_sharded_hub_conformance(check_name, tracked):
    """Clients of a sharded fabric (``ShardRouter``), the checks' group
    owned by a shard hub and every worker-scoped op fanned out to it and the
    root."""
    fabric = ShardedTransportHub(["default"], device="cpu")
    tracked.append(fabric)

    def factory():
        router = ShardRouter(fabric.addresses, device="cpu")
        tracked.insert(0, router)
        return router

    run_conformance(factory, checks=[check_name])


def test_multiproc_is_registered_and_deferred_parts_raise():
    """The sharded fabric, its router and factory and the client's
    ``install_reduce`` work (they raised before the process plane was
    ported); so does the fault plane, which raised before this slice: a
    hub crash (``arm_faults`` or ``simulate_crash``) and a severed client
    (``_chaos_break_conn``) are recovered by the session layer on a single
    hub and on a shard of the fabric, a duplicate frame is answered from
    the replay cache and an evicted one refused, and an unknown shard key
    is a ``ValueError``."""
    from repro_torch.core.events import FaultPlan

    assert "multiproc" in registered_backends()
    fabric = ShardedTransportHub(["g0"], device="cpu")
    router = ShardRouter(fabric.addresses, device="cpu")
    hub = TransportHub(device="cpu")
    client = MultiprocBackend(hub.address, device="cpu")
    try:
        assert sorted(fabric.addresses) == ["", "g0"]
        other = sharded_backend_factory(fabric.addresses, device="cpu")(None)
        assert isinstance(other, ShardRouter) and other is not router
        other.close()
        for group in ("g0", "default"):
            router.join("ch", group, "a-0")
            router.join("ch", group, "b-0")
            router.send("ch", group, "a-0", "b-0", {"x": group})
            assert router.recv("ch", group, "b-0", "a-0", timeout=TIMEOUT) == {"x": group}
        # each group's topic lives on one hub only
        assert fabric.shards["g0"].backend.peers("ch", "g0", "a-0") == ["b-0"]
        assert fabric.root.backend.peers("ch", "g0", "a-0") == []
        assert fabric.stats["msgs:ch"] == 2.0
        client.install_reduce("ch", "g", "b-0", ["a-0"])
        client.install_reduce("ch", "g", "b-0", [], 0)

        # a hub crash armed at fabric time 0 fires on the next frame
        for bad in (hub, fabric):
            with pytest.raises(ValueError, match="unknown hub_crash shard key"):
                bad.arm_faults(FaultPlan(hub_crashes={"nope": 1.0}))
        port = hub.address[1]
        hub.arm_faults(FaultPlan(hub_crashes={"": 0.0}))
        client.join("ch", "g", "a-0")
        client.join("ch", "g", "b-0")
        hub.simulate_crash()
        client.send("ch", "g", "a-0", "b-0", {"y": 1})
        assert client.recv("ch", "g", "b-0", "a-0", timeout=TIMEOUT) == {"y": 1}
        client._chaos_break_conn()
        assert client.now("a-0") == 0.0
        assert hub.address[1] == port and hub.stats["hub_restarts:"] == 2.0
        assert hub.stats["resumes:"] >= 2.0 and hub.stats["msgs:ch"] == 1.0
        result, status, _ = client._chaos_duplicate("now", "a-0")
        assert result == 0.0 and status == "ok" and hub.stats["replays:"] >= 1.0
        status, value = client._chaos_probe_evicted()
        assert status == "err" and "replay window" in str(value)

        fabric.arm_faults(FaultPlan(hub_crashes={"g0": 0.0}))
        router.send("ch", "g0", "a-0", "b-0", {"z": 1})
        fabric.simulate_crash("")
        router._chaos_break_conn()
        assert router.recv("ch", "g0", "b-0", "a-0", timeout=TIMEOUT) == {"z": 1}
        assert fabric.shards["g0"].stats["hub_restarts:"] == 1.0
        assert fabric.root.stats["hub_restarts:"] == 1.0
        assert fabric.stats["msgs:ch"] == 3.0
    finally:
        for obj in (client, router, hub, fabric):
            obj.close()


# ------------------------------------------------------------------ #
# loopback twins of the codec and collision cases
# ------------------------------------------------------------------ #
def test_marker_key_payload_crosses_socket_unharmed(tracked):
    _, ea, eb = _manager(tracked)
    tricky = {"__wire_codec__": "int8", "payload": {"x": 1}}
    ea.send("b-0", tricky)
    assert eb.recv("a-0", timeout=TIMEOUT) == tricky


def test_codec_channel_over_multiproc_loopback(tracked):
    _, ea, eb = _manager(tracked, codec="int8")
    w = torch.linspace(-1.0, 1.0, 128)
    ea.send("b-0", {"weights": {"w": w}, "num_samples": 3})
    got = eb.recv("a-0", timeout=TIMEOUT)
    assert got["num_samples"] == 3 and got["weights"]["w"].dtype == torch.float32
    assert float((got["weights"]["w"] - w).abs().max()) <= 1.0 / 127.0 + 1e-7


@pytest.mark.parametrize("codec_name", registered_codecs())
def test_codec_channel_over_multiproc(codec_name, tracked):
    mgr, ea, eb = _manager(tracked, codec=codec_name)
    w = torch.linspace(-1.0, 1.0, 8192)
    ea.send("b-0", {"weights": {"w": w}, "num_samples": 3})
    got = eb.recv("a-0", timeout=TIMEOUT)
    got_w = got["weights"]["w"]
    assert got["num_samples"] == 3 and got_w.shape == w.shape and got_w.dtype == torch.float32
    assert isinstance(got_w, torch.Tensor) and got_w.device.type == "cpu"
    if codec_name.startswith("int8"):
        assert float((got_w - w).abs().max()) <= 1.0 / 127.0 + 1e-6
    ratio = mgr.codec_ratio("ch")
    assert ratio is not None and 0.0 < ratio < 0.8


@pytest.mark.parametrize("codec_name", registered_codecs())
def test_sentinel_collisions_cross_the_socket(codec_name, tracked):
    from repro_torch.transport.conformance import CODEC_SENTINEL_FIXTURES

    _, ea, eb = _manager(tracked, codec=codec_name)
    for prefix, fixtures in CODEC_SENTINEL_FIXTURES.items():
        if codec_name.startswith(prefix):
            for sentinel in fixtures:
                ea.send("b-0", {"blob": sentinel, "n": 1})
                got = eb.recv("a-0", timeout=TIMEOUT)
                assert got["n"] == 1 and set(got["blob"]) == set(sentinel)


@pytest.mark.parametrize("codec,expect_ratio", [("int8", 0.30), ("topk0.1", 0.30), ("int8_blocks", 0.30)])
def test_emulated_accounting_honors_codec(codec, expect_ratio, tracked):
    mgr, ea, _ = _manager(tracked, codec=codec, backend="inproc")
    be = mgr.backend("ch")
    be.set_link("ch", "a-0", LinkModel(bandwidth=1000.0))
    ea.send("b-0", {"w": torch.zeros(1000)})
    stats = mgr.channel_stats("ch")
    assert stats["raw_bytes"] == 4000.0
    assert stats["bytes"] < 4000.0 * expect_ratio
    assert mgr.codec_ratio("ch") == stats["bytes"] / 4000.0
    assert be.now("a-0") == stats["bytes"] / 1000.0


def test_uncoded_channel_accounting_unchanged(tracked):
    mgr, ea, _ = _manager(tracked, backend="inproc")
    ea.send("b-0", {"w": torch.zeros(1000)})
    assert mgr.total_bytes("ch") == 4000.0 and mgr.codec_ratio("ch") is None


def test_unknown_codec_fails_fast_and_closes_the_hub(monkeypatch):
    closed = []
    orig = LoopbackMultiprocBackend.close
    monkeypatch.setattr(LoopbackMultiprocBackend, "close", lambda self: (closed.append(self), orig(self)))
    with pytest.raises(WireError):
        ChannelManager([ttag.Channel(name="ch", pair=("a", "b"), backend="multiproc", codec="zip9")],
                       device="cpu")
    assert len(closed) == 1


def test_channel_spec_can_select_multiproc_backend(tracked):
    mgr, ea, eb = _manager(tracked)
    ea.send("b-0", {"x": torch.arange(3, dtype=torch.float32)})
    got = eb.recv("a-0", timeout=TIMEOUT)
    assert torch.equal(got["x"], torch.arange(3, dtype=torch.float32))
    assert mgr.total_bytes("ch") == 12.0


def test_hub_backend_factory_routes_every_channel_through_one_client():
    """A manager built with ``hub_backend_factory`` puts every channel on one
    client of a shared hub, each channel with its own codec."""
    hub = TransportHub()
    mgr = None
    try:
        mgr = ChannelManager(
            [ttag.Channel(name="p", pair=("a", "b"), codec="int8_blocks"),
             ttag.Channel(name="m", pair=("a", "b"))],
            backend_factory=hub_backend_factory(hub.address, device="cpu"),
        )
        assert mgr.backend("p") is mgr.backend("m")
        x = torch.linspace(-1.0, 1.0, 5000)
        for ch in ("p", "m"):
            mgr.end(ch, "default", "a-0").send("b-0", {"x": x})
        coded = mgr.end("p", "default", "b-0").recv("a-0", timeout=TIMEOUT)["x"]
        plain = mgr.end("m", "default", "b-0").recv("a-0", timeout=TIMEOUT)["x"]
        assert torch.equal(plain, x) and not torch.equal(coded, x)
        assert float((coded - x).abs().max()) <= 1.0 / 127
        assert mgr.channel_stats("p")["payload_encodes"] == 1.0
        assert "raw_bytes" in mgr.channel_stats("p") and "raw_bytes" not in mgr.channel_stats("m")
    finally:
        if mgr is not None:
            mgr.close()
        hub.close()


def test_loopback_without_a_device_needs_the_card(monkeypatch, tracked):
    """No silent CPU: a client told no device puts received tensors on the
    card, and raises where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mgr = ChannelManager([ttag.Channel(name="ch", pair=("a", "b"), backend="multiproc")])
    tracked.append(mgr)
    ea, eb = mgr.end("ch", "default", "a-0"), mgr.end("ch", "default", "b-0")
    ea.send("b-0", {"x": torch.ones(2)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eb.recv("a-0", timeout=TIMEOUT)


# ------------------------------------------------------------------ #
# sessions: a broken connection is recovered exactly once
# ------------------------------------------------------------------ #
def test_call_reconnects_once_on_broken_pipe():
    hub = TransportHub()
    client = MultiprocBackend(hub.address, device="cpu")
    try:
        client.join("ch", "g", "a-0")
        assert client.peers("ch", "g", "b-0") == ["a-0"]
        near, far = socket_mod.socketpair()
        far.close()
        client._local.sock = near
        assert client.peers("ch", "g", "b-0") == ["a-0"]
    finally:
        client.close()
        hub.close()


def test_non_idempotent_op_retried_exactly_once():
    hub = TransportHub()
    client = MultiprocBackend(hub.address, device="cpu")
    try:
        client.join("ch", "g", "a-0")
        client.join("ch", "g", "b-0")
        near, far = socket_mod.socketpair()
        far.close()
        client._local.sock = near
        client.send("ch", "g", "a-0", "b-0", {"x": 1})
        client.now("a-0")  # ack barrier
        assert hub.backend.peek("ch", "g", "b-0", "a-0") == {"x": 1}
        assert client.recv("ch", "g", "b-0", "a-0", TIMEOUT) == {"x": 1}
        assert hub.backend.peek("ch", "g", "b-0", "a-0") is None
        assert hub.stats.get("resumes:", 0.0) >= 1.0
    finally:
        client.close()
        hub.close()


def test_second_fault_surfaces():
    hub = TransportHub()
    client = MultiprocBackend(hub.address, device="cpu")
    client.CONNECT_RETRIES = 1
    try:
        client.join("ch", "g", "a-0")
        hub.close()
        near, far = socket_mod.socketpair()
        far.close()
        client._local.sock = near
        with pytest.raises(OSError):
            client.peers("ch", "g", "b-0")
    finally:
        client.close()


# ------------------------------------------------------------------ #
# jobs against the JAX package
# ------------------------------------------------------------------ #
def _coded(tag, codec, mod):
    return dataclasses.replace(tag, channels=tuple(
        dataclasses.replace(c, backend="multiproc", codec=codec) for c in tag.channels))


def _update(weights, idx, asarray):
    # exact binary fractions: the same float32 bits in numpy and torch
    return {k: asarray(v) * 0.5 + 0.25 * (idx + 1) for k, v in weights.items()}


class JaxHalfTrainer(jroles.Trainer):
    def train(self):
        if self.weights is not None:
            idx = int(self.ctx.worker.dataset[1:])
            self.weights = _update(self.weights, idx, lambda v: np.asarray(v, np.float32))
            self.num_samples = 10 + idx


class PortHalfTrainer(troles.Trainer):
    def train(self):
        if self.weights is not None:
            idx = int(self.ctx.worker.dataset[1:])
            self.weights = _update(self.weights, idx, lambda v: v)
            self.num_samples = 10 + idx


def _jax_job(job, trainer):
    rt = jruntime.JobRuntime(job, program_overrides={"trainer": trainer})
    stats = {}
    close = rt.channels.close

    def snapshot_then_close():
        for c in job.tag.channels:
            stats[c.name] = rt.channels.channel_stats(c.name)
        close()

    rt.channels.close = snapshot_then_close
    res = rt.run(timeout=60)
    assert not res.errors, res.errors
    return res, stats


def _jobs(codec, w0, jtrainer, ttrainer, n=3, rounds=2):
    from repro.core.tag import DatasetSpec as JDatasetSpec
    from repro_torch.core.tag import DatasetSpec

    jjob = JJobSpec(tag=_coded(jtop.classical_fl(), codec, jtag),
                    datasets=tuple(JDatasetSpec(name=f"d{i}") for i in range(n)),
                    hyperparams={"rounds": rounds, "init_weights": w0})
    tjob = JobSpec(tag=_coded(ttop.classical_fl(), codec, ttag),
                   datasets=tuple(DatasetSpec(name=f"d{i}") for i in range(n)),
                   hyperparams={"rounds": rounds, "init_weights": w0})
    jres, jstats = _jax_job(jjob, jtrainer)
    qkernel.reset_launches()
    tres = truntime.run_job(tjob, device="cpu", timeout=60,
                            program_overrides={"trainer": ttrainer})
    assert not tres.errors, tres.errors
    return jres, jstats, tres


@pytest.mark.parametrize("codec", ["", "int8", "int8_blocks", "topk0.25"])
def test_loopback_job_equals_jax(codec):
    rng = np.random.default_rng(21)
    w0 = {"w": rng.normal(size=(40, 129)).astype(np.float32),
          "b": rng.normal(size=(129,)).astype(np.float32)}
    jres, jstats, tres = _jobs(codec, w0, JaxHalfTrainer, PortHalfTrainer)
    jw, tw = jres.global_weights(), tree_to_numpy(tres.global_weights())
    assert all(np.asarray(jw[k]).tobytes() == tw[k].tobytes() for k in jw)
    assert tres.channel_bytes == jres.channel_bytes
    assert tres.channel_stats == jstats
    stats = tres.channel_stats["param-channel"]
    if codec:
        assert stats["raw_bytes"] > 0 and 0 < stats["codec_ratio"] < 1
    # on the CPU the wrappers run the plain versions: no launch is counted
    assert qkernel.quantize_blocks.launches == 0


def test_seeded_sgd_loopback_job_agrees_within_one_quantization_step():
    rng = np.random.default_rng(17)
    w0 = {"w": (0.01 * rng.normal(size=(32, 10))).astype(np.float32),
          "b": np.zeros((10,), np.float32)}
    jres, jstats, tres = _jobs("int8_blocks", w0, JSeededSGDTrainer, SeededSGDTrainer, n=4, rounds=3)
    jw, tw = jres.global_weights(), tree_to_numpy(tres.global_weights())
    step = max(float(np.abs(np.asarray(jw[k])).max()) for k in jw) / 127.0
    for k in jw:
        np.testing.assert_allclose(tw[k], np.asarray(jw[k]), rtol=0, atol=step)
    assert tres.channel_bytes == jres.channel_bytes
    assert tres.channel_stats == jstats


@pytest.mark.parametrize("env", [None, "0", "2", "7"])
def test_connect_retries_env_sets_attempts_per_call(monkeypatch, env):
    """``REPRO_CONNECT_RETRIES``, read on each call, overrides
    ``CONNECT_RETRIES``: a hub that never answers is dialled that many
    times more than once, as the JAX package's client dials it."""
    import repro.transport.multiproc as jmp
    from repro_torch.transport.multiproc import MultiprocBackend

    attempts = []

    def refuse(address, timeout=None):
        attempts.append(address)
        raise ConnectionRefusedError("no hub")

    monkeypatch.setattr(socket_mod, "create_connection", refuse)
    monkeypatch.setattr("time.sleep", lambda s: None)
    if env is None:
        monkeypatch.delenv("REPRO_CONNECT_RETRIES", raising=False)
    else:
        monkeypatch.setenv("REPRO_CONNECT_RETRIES", env)
    counts = []
    for be in (MultiprocBackend(("127.0.0.1", 9), client_key="t-0", device="cpu"),
               jmp.MultiprocBackend(("127.0.0.1", 9), client_key="t-0")):
        attempts.clear()
        with pytest.raises(OSError):
            be._connect()
        counts.append(len(attempts))
    want = 1 + (MultiprocBackend.CONNECT_RETRIES if env is None else int(env))
    assert counts == [want, want]

