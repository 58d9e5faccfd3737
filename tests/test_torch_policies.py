"""The port's deadline and async runtime policies against the JAX package's.

Twins of ``test_async_runtime.py`` (not ``TestFedStepParticipation`` nor
``TestDeadlineSelector``), ``test_hier_policy.py``, ``test_event_engine.py``,
``TestSeededJobBitEquality`` of ``test_fused_agg.py``, the deadline guard of
``test_protocols.py`` and ``test_hybrid_dropout.py``, plus the checkpoint
restart of an async server. The port runs on the CPU.

Deadline rounds fold the on-time updates in sorted-source order, so a
deadline job with the "add one" trainer (no products) is byte-equal to the
JAX package's: weights, participation logs, events and channel bytes. So is
an async job with one trainer and ``buffer_size=1``, the only deterministic
async order. Multi-trainer async runs absorb updates in an order decided by
thread timing, so they are held to their structure: versions, staleness
logs, relays, participation and events.
"""
import os
import queue
import threading

import numpy as np
import pytest
import torch

import repro.core.events as jev
import repro.core.expansion as jexp
import repro.core.roles as jroles
import repro.core.roles_async as jasync
import repro.core.runtime as jrt
import repro.core.tag as jtag
import repro.core.topologies as jtop
import repro_torch.core.events as tev
import repro_torch.core.expansion as texp
import repro_torch.core.roles as troles
import repro_torch.core.roles_async as tasync
import repro_torch.core.runtime as trt
import repro_torch.core.tag as ttag
import repro_torch.core.topologies as ttop
from repro.transport.conformance import SeededSGDTrainer as JaxSGDTrainer
from repro_torch.transport.conformance import SeededSGDTrainer

W0 = {"w": np.full((8,), 2.0, np.float32), "b": np.zeros((2, 2), np.float32)}
SGD_RTOL, SGD_ATOL = 1e-5, 1e-6
# wall-clock patience of the policy servers in jobs where every update
# arrives: it is never waited out there, so it only has to outlast a loaded
# test host (the reference tests' 1.5-2 s can cut an on-time update there);
# jobs with dropouts keep the reference's values, which decide their timing
GRACE = 10.0


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this file's torch work, as the other files
    that run jobs on threads pin them: the suite runs six files at once on
    the CPU, and each job's trainer threads would otherwise each open eight
    OpenMP threads on a host already running dozens."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class AddOneTrainer(troles.Trainer):
    def train(self):
        if self.weights is not None:
            self.weights = {k: v + 1.0 for k, v in self.weights.items()}


class JaxAddOneTrainer(jroles.Trainer):
    def train(self):
        if self.weights is not None:
            self.weights = {k: np.asarray(v) + 1.0 for k, v in self.weights.items()}


class ScaleAddTrainer(troles.Trainer):
    """``0.75 w + 1``: rounds at every step, so an async replay that takes
    a wrong base or weight shows in the bits."""

    def train(self):
        if self.weights is not None:
            self.weights = {k: v * 0.75 + 1.0 for k, v in self.weights.items()}


class JaxScaleAddTrainer(jroles.Trainer):
    def train(self):
        if self.weights is not None:
            self.weights = {k: np.asarray(v) * 0.75 + 1.0 for k, v in self.weights.items()}


PORT = dict(exp=texp, rt=trt, tag=ttag, top=ttop, roles=troles, add_one=AddOneTrainer,
            scale_add=ScaleAddTrainer, sgd=SeededSGDTrainer, port=True)
REF = dict(exp=jexp, rt=jrt, tag=jtag, top=jtop, roles=jroles, add_one=JaxAddOneTrainer,
           scale_add=JaxScaleAddTrainer, sgd=JaxSGDTrainer, port=False)


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bytes(tree):
    return {k: _host(v).tobytes() for k, v in sorted(tree.items())}


def _classical(pkg, n=4, rounds=3, **hp):
    return pkg["exp"].JobSpec(
        tag=pkg["top"].classical_fl(),
        datasets=tuple(pkg["tag"].DatasetSpec(name=f"d{i}") for i in range(n)),
        hyperparams={"rounds": rounds, "init_weights": W0, **hp},
    )


def _hier(pkg, rounds=2, **hp):
    names = ["d0", "d1", "d2", "d3"]
    tag = pkg["top"].hierarchical_fl(
        groups=("west", "east"),
        dataset_groups={"west": ("d0", "d1"), "east": ("d2", "d3")})
    return pkg["exp"].JobSpec(
        tag=tag, datasets=tuple(pkg["tag"].DatasetSpec(name=n) for n in names),
        hyperparams={"rounds": rounds, "init_weights": W0, **hp})


def _run(pkg, job, trainer="add_one", policy=None, **kw):
    overrides = dict(kw.pop("program_overrides", {}))
    if trainer is not None:
        overrides.setdefault("trainer", pkg[trainer])
    pol = None if policy is None else pkg["rt"].RuntimePolicy(**policy)
    extra = {"device": "cpu"} if pkg["port"] else {}
    res = pkg["rt"].run_job(job, timeout=60, policy=pol, program_overrides=overrides, **extra,
                            **kw)
    assert not res.errors, res.errors
    return res


def _both(job_fn, policy=None, **kw):
    """The same job through both packages: (port result, JAX result)."""
    return tuple(_run(pkg, job_fn(pkg), policy=dict(policy) if policy else None, **kw)
                 for pkg in (PORT, REF))


def _same_deadline_job(port, ref, root="global-aggregator-0"):
    """Byte-equal weights, equal participation logs, events, drops and
    channel bytes."""
    assert _bytes(port.global_weights()) == _bytes(ref.global_weights())
    assert port.program(root).participation_log == ref.program(root).participation_log
    assert port.events == ref.events and port.dropped == ref.dropped
    assert port.channel_bytes == ref.channel_bytes


# ---------------------------------------------------------------------- #
# test_async_runtime.py
# ---------------------------------------------------------------------- #
def test_policy_validation_rejects_bad_modes():
    with pytest.raises(ValueError):
        trt.RuntimePolicy(mode="semi-sync")
    with pytest.raises(ValueError):
        trt.RuntimePolicy(dropouts={"w": 2.0}, rejoins={"w": 1.0})


def test_sync_policy_matches_legacy_bit_for_bit():
    legacy = _run(PORT, _classical(PORT, rounds=2))
    policy = _run(PORT, _classical(PORT, rounds=2), policy={"mode": "sync"})
    ref = _run(REF, _classical(REF, rounds=2), policy={"mode": "sync"})
    assert _bytes(legacy.global_weights()) == _bytes(policy.global_weights())
    assert _bytes(policy.global_weights()) == _bytes(ref.global_weights())
    assert legacy.channel_bytes == policy.channel_bytes == ref.channel_bytes
    assert policy.dropped == {} and policy.events == []


@pytest.mark.parametrize("mode", ["sync", "deadline", "async"])
def test_same_tag_completes_and_progresses_in_every_mode(mode):
    policy = {"sync": {"mode": "sync"},
              "deadline": {"mode": "deadline", "deadline": 50.0, "grace": GRACE},
              "async": {"mode": "async", "buffer_size": 2, "grace": GRACE}}[mode]
    port, ref = _both(lambda p: _classical(p, rounds=3), policy)
    assert float(port.global_weights()["w"][0]) > float(W0["w"][0])
    if mode == "deadline":
        _same_deadline_job(port, ref)
    elif mode == "sync":
        assert _bytes(port.global_weights()) == _bytes(ref.global_weights())
    else:
        for res in (port, ref):
            glob = res.program("global-aggregator-0")
            assert glob._version == 3 and len(glob.staleness_log) == 6
            assert all(e["staleness"] >= 0 for e in glob.staleness_log)


def test_dropout_mid_round_excluded_and_recorded():
    pol = {"mode": "deadline", "deadline": 10.0, "grace": 1.0, "dropouts": {"trainer-2": 0.5}}
    port, ref = _both(lambda p: _classical(p, rounds=3), pol, trainer=None,
                      per_worker_hyperparams={"trainer-2": {"compute_time": 1.0}})
    assert port.dropped == {"trainer-2": 0.5}
    assert (0.5, "dropout", "trainer-2") in port.events
    log = port.program("global-aggregator-0").participation_log
    assert "trainer-2" not in log[0]["included"]
    assert "trainer-2" not in log[-1]["included"] and "trainer-2" not in log[-1]["missing"]
    _same_deadline_job(port, ref)


def test_async_job_survives_dropout():
    pol = {"mode": "async", "buffer_size": 2, "grace": 1.5, "dropouts": {"trainer-0": 0.5}}
    port, ref = _both(lambda p: _classical(p, rounds=4), pol, trainer=None,
                      per_worker_hyperparams={"trainer-0": {"compute_time": 1.0}})
    for res in (port, ref):
        assert res.dropped == {"trainer-0": 0.5}
        assert res.program("global-aggregator-0")._version == 4


def _upload_gate(base):
    """``base`` whose ``trainer-0`` sends its fourth upload (virtual 1.2)
    only once ``trainer-1`` has sent its upload (1.0): the server then
    finds that upload waiting before its clock can pass 1.2, however the
    job's threads are scheduled on a loaded host (unguarded, a late
    ``trainer-1`` thread can miss every version or upload after the
    server's clock passed its drop)."""
    sent = threading.Event()

    class Gated(base):
        def upload(self):
            me = self.ctx.worker.worker_id
            if me == "trainer-0":
                self._uploads = getattr(self, "_uploads", 0) + 1
                if self._uploads == 4:
                    assert sent.wait(30.0), "trainer-1 never uploaded"
            try:
                super().upload()
            finally:
                if me == "trainer-1":
                    sent.set()

    return Gated


def test_async_upload_sent_just_before_a_dropout_keeps_its_base():
    """``trainer-1`` uploads at 1.0 and is dropped at 1.1, while
    ``trainer-0`` uploads every 0.3 and sends its 1.2 upload only after
    ``trainer-1``'s upload left. That upload is absorbed once, against its
    own base (no clamped entry); the server's clock then passes the drop
    with nothing of ``trainer-1`` waiting, which forgets it; the versions,
    absorbed sources, drops, events and final version vector equal the JAX
    package's."""
    pol = {"mode": "async", "buffer_size": 1, "grace": 1.5, "dropouts": {"trainer-1": 1.1}}
    port, ref = (
        _run(pkg, _classical(pkg, n=2, rounds=6), trainer=None, policy=dict(pol),
             program_overrides={"trainer": _upload_gate(pkg["add_one"])},
             per_worker_hyperparams={"trainer-0": {"compute_time": 0.3},
                                     "trainer-1": {"compute_time": 1.0}})
        for pkg in (PORT, REF))

    def absorbed(res):
        return sorted(e["src"] for e in res.program("global-aggregator-0").staleness_log)

    for res in (port, ref):
        log = res.program("global-aggregator-0").staleness_log
        assert res.dropped == {"trainer-1": 1.1}
        assert absorbed(res).count("trainer-1") == 1
        assert not any(e.get("clamped") for e in log), log
    glob, rglob = port.program("global-aggregator-0"), ref.program("global-aggregator-0")
    assert glob._version == rglob._version == 6
    assert absorbed(port) == absorbed(ref)
    assert glob._version_vector == rglob._version_vector
    assert port.events == ref.events


def test_on_time_update_from_doomed_worker_still_counts():
    pol = {"mode": "deadline", "deadline": 2.0, "grace": 1.5, "dropouts": {"trainer-2": 1.5}}
    port, ref = _both(lambda p: _classical(p, n=3, rounds=2), pol, trainer=None,
                      per_worker_hyperparams={f"trainer-{i}": {"compute_time": 1.0}
                                              for i in range(3)})
    log = port.program("global-aggregator-0").participation_log
    assert "trainer-2" in log[0]["included"] and "trainer-2" not in log[1]["included"]
    _same_deadline_job(port, ref)


def test_rejoin_after_dropout():
    pol = {"mode": "deadline", "deadline": 10.0, "grace": 1.0,
           "dropouts": {"trainer-3": 0.5}, "rejoins": {"trainer-3": 1.5}}
    port, ref = _both(lambda p: _classical(p, rounds=4), pol, trainer=None,
                      per_worker_hyperparams={"trainer-3": {"compute_time": 1.0}})
    assert (1.5, "rejoin", "trainer-3") in port.events
    log = port.program("global-aggregator-0").participation_log
    assert "trainer-3" not in log[0]["included"] and "trainer-3" in log[-1]["included"]
    _same_deadline_job(port, ref)


def test_straggler_past_deadline_excluded():
    pol = {"mode": "deadline", "deadline": 2.0, "grace": GRACE}
    port, ref = _both(lambda p: _classical(p, rounds=3), pol,
                      per_worker_hyperparams={"trainer-1": {"compute_time": 5.0}})
    for entry in port.program("global-aggregator-0").participation_log:
        assert entry["excluded"] == ["trainer-1"]
        assert entry["round_time"] == pytest.approx(2.0)
    _same_deadline_job(port, ref)


def test_min_participants_extends_past_deadline():
    pol = {"mode": "deadline", "deadline": 2.0, "grace": GRACE, "min_participants": 4}
    port, ref = _both(lambda p: _classical(p, rounds=2), pol,
                      per_worker_hyperparams={"trainer-1": {"compute_time": 5.0}})
    log = port.program("global-aggregator-0").participation_log
    assert "trainer-1" in log[0]["included"] and log[0]["round_time"] >= 5.0
    _same_deadline_job(port, ref)


def test_late_arrival_joins_async_job():
    pol = {"mode": "async", "buffer_size": 2, "grace": 2.0, "arrivals": {"trainer-1": 2.0}}
    port, ref = _both(lambda p: _classical(p, rounds=3), pol, trainer=None)
    for res in (port, ref):
        assert (2.0, "start", "trainer-1") in res.events


def test_async_runtime_matches_sequential_reference():
    """One trainer and ``buffer_size=1``: a deterministic sequential server,
    byte-equal to the JAX package, staleness log included."""
    pol = {"mode": "async", "buffer_size": 1, "grace": GRACE}
    port, ref = _both(lambda p: _classical(p, n=1, rounds=3), pol)
    glob = port.program("global-aggregator-0")
    assert [e["staleness"] for e in glob.staleness_log] == [0, 0, 0]
    np.testing.assert_array_equal(port.global_weights()["w"].numpy(), W0["w"] + 3.0)
    assert glob.staleness_log == ref.program("global-aggregator-0").staleness_log
    assert _bytes(port.global_weights()) == _bytes(ref.global_weights())


@pytest.mark.parametrize("strategy", ["fedbuff", "fedasync"])
def test_single_trainer_async_job_byte_equal(strategy):
    """The rounding trainer through both buffered strategies, with a server
    learning rate whose products round: every version's bits are the JAX
    package's."""
    pol = {"mode": "async", "buffer_size": 1, "grace": GRACE, "staleness_exp": 1.0}
    port, ref = _both(
        lambda p: _classical(p, n=1, rounds=4, async_strategy=strategy, server_lr=0.7,
                             async_alpha=0.3), pol, trainer="scale_add")
    assert _bytes(port.global_weights()) == _bytes(ref.global_weights())
    assert port.channel_bytes == ref.channel_bytes


# ---------------------------------------------------------------------- #
# the async server's checkpoint restart
# ---------------------------------------------------------------------- #
def _restart(pkg, d, rounds):
    hp = {"checkpoint_every": 1, "checkpoint_dir": str(d)}
    return _run(pkg, _classical(pkg, n=1, rounds=rounds, **hp), trainer="scale_add",
                policy={"mode": "async", "buffer_size": 1, "grace": GRACE})


def test_async_checkpoint_restart_matches_reference(tmp_path):
    """A second ``run_job`` on the same checkpoint directory restores the
    server at its newest step and runs on to the new target, as the JAX
    package does: same weights, versions, logs and files."""
    out = {}
    for name, pkg in (("port", PORT), ("ref", REF)):
        d = tmp_path / name
        first = _restart(pkg, d, 2)
        second = _restart(pkg, d, 4)
        g1, g2 = first.program("global-aggregator-0"), second.program("global-aggregator-0")
        out[name] = (_bytes(first.global_weights()), _bytes(second.global_weights()),
                     g2._version, [m for m in g2.metrics if "restored_step" in m],
                     g2.staleness_log, sorted(os.listdir(d / "global-aggregator-0")))
        assert g1._version == 2
    assert out["port"] == out["ref"]
    assert out["port"][3] == [{"restored_step": 2}] and out["port"][2] == 4


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_async_server_restores_the_other_packages_checkpoint(tmp_path, writer):
    """A checkpoint directory written by one package's server restarts the
    other's: the restarted jobs land on the same bytes."""
    pkgs = {"ref": REF, "port": PORT}
    reader = "port" if writer == "ref" else "ref"
    _restart(pkgs[writer], tmp_path, 2)
    crossed = _restart(pkgs[reader], tmp_path, 4)
    same = tmp_path / "same"
    _restart(pkgs[reader], same, 2)
    straight = _restart(pkgs[reader], same, 4)
    assert _bytes(crossed.global_weights()) == _bytes(straight.global_weights())
    glob = crossed.program("global-aggregator-0")
    assert {"restored_step": 2} in glob.metrics and glob._version == 4


def test_deadline_server_checkpoints_its_rounds(tmp_path):
    hp = {"checkpoint_every": 1, "checkpoint_dir": str(tmp_path)}
    pol = {"mode": "deadline", "deadline": 5.0, "grace": GRACE}
    port = _run(PORT, _classical(PORT, rounds=2, **hp), policy=pol)
    from repro import checkpoint as jck

    tree = jck.load_tree(str(tmp_path / "global-aggregator-0"), 2)
    assert int(tree["version"]) == 2
    assert _bytes(tree["weights"]) == _bytes(port.global_weights())


# ---------------------------------------------------------------------- #
# test_fused_agg.py: TestSeededJobBitEquality
# ---------------------------------------------------------------------- #
def _sgd_job(pkg, n=4, rounds=3, **hp):
    rng = np.random.default_rng(7)
    w0 = {"w": (0.01 * rng.normal(size=(32, 10))).astype(np.float32),
          "b": np.zeros((10,), np.float32)}
    return pkg["exp"].JobSpec(
        tag=pkg["top"].classical_fl(),
        datasets=tuple(pkg["tag"].DatasetSpec(name=f"d{i}") for i in range(n)),
        hyperparams={"rounds": rounds, "init_weights": w0, **hp})


@pytest.mark.parametrize("mode", ["sync", "deadline", "async"])
def test_seeded_job_fused_switch_changes_no_bits(mode):
    """``fused_aggregation`` changes no byte of the port's weights, which
    agree with the JAX package's within the SGD job's float32 tolerance
    (torch and numpy BLAS round the trainers' products differently)."""
    n = 1 if mode == "async" else 4
    rounds = 4 if mode == "async" else 3
    policy = {"sync": None, "deadline": {"mode": "deadline", "deadline": 50.0, "grace": GRACE},
              "async": {"mode": "async", "buffer_size": 2, "grace": GRACE}}[mode]
    results = [_run(PORT, _sgd_job(PORT, n, rounds, fused_aggregation=fused), trainer="sgd",
                    policy=policy).global_weights() for fused in (True, False)]
    assert _bytes(results[0]) == _bytes(results[1])
    ref = _run(REF, _sgd_job(REF, n, rounds), trainer="sgd", policy=policy).global_weights()
    for k in ref:
        np.testing.assert_allclose(results[0][k].numpy(), np.asarray(ref[k]),
                                   rtol=SGD_RTOL, atol=SGD_ATOL)


def test_seeded_job_repeats_its_bytes_at_any_thread_count():
    """The port's seeded SGD job gives the same bytes at 1, 2 and 8 intra-op
    threads: its trainer sums with torch's reductions, whose order depends
    on the shapes, not with a BLAS that picks its order at run time."""
    n = torch.get_num_threads()
    runs = []
    try:
        for threads in (1, 2, 8):
            torch.set_num_threads(threads)
            runs.append(_bytes(_run(PORT, _sgd_job(PORT), trainer="sgd").global_weights()))
    finally:
        torch.set_num_threads(n)
    assert runs[0] == runs[1] == runs[2]


# ---------------------------------------------------------------------- #
# test_hier_policy.py
# ---------------------------------------------------------------------- #
_PER_WORKER = {f"trainer-{i}": {"compute_time": 0.5 + 0.25 * i} for i in range(4)}


def _hrun(pkg, policy, rounds=2, per_worker=None, trainer="add_one"):
    return _run(pkg, _hier(pkg, rounds=rounds), trainer=trainer, policy=policy,
                per_worker_hyperparams=_PER_WORKER if per_worker is None else per_worker)


def test_tier_validation_matches_reference():
    for pkg in (PORT, REF):
        with pytest.raises(ValueError):
            pkg["rt"].RuntimePolicy(tiers={"aggregator": "semi-sync"})
        pol = pkg["rt"].RuntimePolicy(mode="sync", tiers={"trainer": "async"}, grace=1.0)
        kw = {"device": "cpu"} if pkg["port"] else {}
        with pytest.raises(ValueError, match="neither a GlobalAggregator"):
            pkg["rt"].run_job(_hier(pkg), timeout=30, policy=pol, **kw)
        pol = pkg["rt"].RuntimePolicy(mode="sync", tiers={"aggregater": "deadline"},
                                      deadline=2.0, grace=1.0)
        with pytest.raises(KeyError, match="unknown role"):
            pkg["rt"].JobRuntime(_hier(pkg), policy=pol, **kw)


@pytest.mark.parametrize("mode", ["deadline", "async"])
def test_empty_tiers_bit_identical_to_root_only(mode):
    """``tiers={}``, or a tiers entry naming only the root, lowers as the
    root-only policy does. Deadline rounds are deterministic: bytes equal
    across the variants and to the JAX package. An async root over sync
    aggregators absorbs their relays in an order thread timing decides
    (with these compute times, nearly always one order), so the async
    variants are held to their structure."""
    knobs = {"deadline": 5.0, "grace": GRACE, "buffer_size": 2}
    variants = [{"mode": mode, **knobs}, {"mode": mode, "tiers": {}, **knobs},
                {"mode": "sync", "tiers": {"global-aggregator": mode}, **knobs}]
    runs = [_hrun(PORT, pol) for pol in variants] + [_hrun(REF, variants[0])]
    for res in runs:
        glob = res.program("global-aggregator-0")
        assert type(glob).__name__.startswith(mode.capitalize())
        assert float(res.global_weights()["w"][0]) > float(W0["w"][0])
        if mode == "async":
            assert glob._version == 2 and len(glob.staleness_log) == 4
    if mode == "deadline":
        for res in runs[1:3]:
            assert _bytes(res.global_weights()) == _bytes(runs[0].global_weights())
            assert res.channel_bytes == runs[0].channel_bytes
        _same_deadline_job(runs[0], runs[3])


def test_sync_tiers_match_legacy_sync():
    legacy = _hrun(PORT, None)
    tiered = _hrun(PORT, {"mode": "sync", "tiers": {}})
    ref = _hrun(REF, {"mode": "sync", "tiers": {}})
    assert _bytes(tiered.global_weights()) == _bytes(legacy.global_weights())
    assert _bytes(tiered.global_weights()) == _bytes(ref.global_weights())
    assert tiered.channel_bytes == legacy.channel_bytes == ref.channel_bytes


def test_mode_only_dict_equivalent_to_plain_string():
    plain = _hrun(PORT, {"mode": "sync", "tiers": {"aggregator": "deadline"},
                         "deadline": 2.0, "grace": GRACE})
    as_dict = _hrun(PORT, {"mode": "sync", "tiers": {"aggregator": {"mode": "deadline"}},
                           "deadline": 2.0, "grace": GRACE})
    ref = _hrun(REF, {"mode": "sync", "tiers": {"aggregator": "deadline"},
                      "deadline": 2.0, "grace": GRACE})
    assert _bytes(plain.global_weights()) == _bytes(as_dict.global_weights())
    assert _bytes(plain.global_weights()) == _bytes(ref.global_weights())
    assert plain.channel_bytes == as_dict.channel_bytes == ref.channel_bytes


def _straggler_west():
    per_worker = {f"trainer-{i}": {"compute_time": 0.5} for i in range(4)}
    per_worker["trainer-3"] = {"compute_time": 50.0}
    return per_worker


@pytest.mark.parametrize("tier", ["deadline", {"mode": "deadline", "deadline": 2.0}])
def test_edge_tier_deadline_cuts_group_straggler(tier):
    """A straggler inside one group is cut by its intermediate's deadline
    (the policy-wide one, or a per-tier override of a lax one)."""
    deadline = 2.0 if tier == "deadline" else 100.0
    pol = {"mode": "sync", "tiers": {"aggregator": tier}, "deadline": deadline, "grace": GRACE}
    port = _hrun(PORT, pol, per_worker=_straggler_west())
    ref = _hrun(REF, pol, per_worker=_straggler_west())
    log = port.program("aggregator-0").participation_log
    assert "trainer-3" in log[0]["excluded"] and log[0]["round_time"] == pytest.approx(2.0)
    assert log == ref.program("aggregator-0").participation_log
    assert _bytes(port.global_weights()) == _bytes(ref.global_weights())


def test_edge_tier_buffer_size_override():
    pol = {"mode": "async", "buffer_size": 2, "grace": GRACE,
           "tiers": {"aggregator": {"mode": "async", "buffer_size": 1}}}
    agg = _hrun(PORT, pol, rounds=3).program("aggregator-0")
    assert agg.relay_log
    assert all(len(e["tier_staleness"]) == 1 for e in agg.relay_log)


@pytest.mark.parametrize("root", ["sync", "deadline", "async"])
@pytest.mark.parametrize("mid", ["sync", "deadline", "async"])
def test_all_tier_combos_complete_and_progress(root, mid):
    pol = {"mode": root, "tiers": {"aggregator": mid}, "deadline": 5.0, "grace": GRACE,
           "buffer_size": 2}
    port, ref = _hrun(PORT, pol), _hrun(REF, pol)
    assert float(port.global_weights()["w"][0]) > float(W0["w"][0])
    if "async" not in (root, mid):
        assert _bytes(port.global_weights()) == _bytes(ref.global_weights())
        assert port.channel_bytes == ref.channel_bytes


def test_async_middle_relays_staleness_annotated_aggregates():
    pol = {"mode": "async", "tiers": {"aggregator": "async"}, "grace": GRACE, "buffer_size": 2}
    res = _hrun(PORT, pol, rounds=3)
    agg = res.program("aggregator-0")
    assert agg.relay_log and all(len(e["tier_staleness"]) >= 1 for e in agg.relay_log)
    assert res.program("global-aggregator-0").staleness_log


def test_orphans_surfaced_when_intermediate_dies():
    pol = {"mode": "async", "tiers": {"aggregator": "async"}, "grace": 1.5, "buffer_size": 2,
           "dropouts": {"aggregator-0": 0.5}}
    per_worker = {f"trainer-{i}": {"compute_time": 1.0} for i in range(4)}
    for pkg in (PORT, REF):
        res = _hrun(pkg, pol, rounds=3, per_worker=per_worker)
        assert res.dropped == {"aggregator-0": 0.5, "trainer-2": 0.5, "trainer-3": 0.5}
        assert {w for _, kind, w in res.events if kind == "orphaned"} == {"trainer-2", "trainer-3"}
        assert float(res.global_weights()["w"][0]) > float(W0["w"][0])


def test_children_reparented_on_intermediate_rejoin():
    pol = {"mode": "async", "tiers": {"aggregator": "async"}, "grace": 1.5, "buffer_size": 2,
           "dropouts": {"aggregator-0": 0.5}, "rejoins": {"aggregator-0": 1.5}}
    per_worker = {f"trainer-{i}": {"compute_time": 1.0} for i in range(4)}
    res = _hrun(PORT, pol, rounds=3, per_worker=per_worker)
    assert set(res.dropped) == {"aggregator-0"}
    assert (1.5, "rejoin", "aggregator-0") in res.events
    assert not any(kind == "orphaned" for _, kind, _ in res.events)


def test_snapshot_store_evicts_and_clamps_as_the_reference():
    stores = (tasync._SnapshotStore(), jasync._SnapshotStore())
    for v in range(10):
        stores[0].put(v, {"w": torch.full((2,), float(v))})
        stores[1].put(v, {"w": np.full((2,), float(v), np.float32)})
    assert stores[0].versions() == stores[1].versions() and len(stores[0]) <= 3
    for trained_from, current in ((0, 9), (9, 9), (8, 9)):
        (tb, ts_, tc), (jb, js_, jc) = (s.base_for(trained_from, current) for s in stores)
        assert (ts_, tc) == (js_, jc)
        assert tb["w"].numpy().tobytes() == np.asarray(jb["w"]).tobytes()
    assert stores[0].window == stores[1].window
    keep = tasync._SnapshotStore()
    for v in range(6):
        keep.put(v, {"w": torch.zeros(1)}, keep_from=1)
    assert keep.versions() == [1, 2, 3, 4, 5]


def test_async_root_snapshots_stay_bounded():
    res = _run(PORT, _classical(PORT, n=1, rounds=8),
               policy={"mode": "async", "buffer_size": 1, "grace": GRACE})
    glob = res.program("global-aggregator-0")
    assert glob._version == 8
    assert len(glob._snapshots) < 8 and len(glob._snapshots) <= glob._snapshots.window + 2


def test_check_rounds_before_collect_raises_descriptive_error():
    rt = trt.JobRuntime(_hier(PORT), device="cpu",
                        policy=trt.RuntimePolicy(mode="deadline", deadline=2.0, grace=1.0))
    root = next(w for w in rt.workers if w.role == "global-aggregator")
    prog = rt._build_program(root)
    assert isinstance(prog, tasync.DeadlineRootMixin)
    with pytest.raises(RuntimeError, match="participation_log"):
        prog.check_rounds()


def test_make_policy_program_families_match_reference():
    for base, mode in ((troles.GlobalAggregator, "deadline"), (troles.GlobalAggregator, "async"),
                       (troles.Aggregator, "deadline"), (troles.Aggregator, "async")):
        cls = tasync.make_policy_program(base, mode)
        ref = jasync.make_policy_program(getattr(jroles, base.__name__), mode)
        assert cls.__name__ == ref.__name__
        assert [c.__name__ for c in cls.__mro__[:2]] == [c.__name__ for c in ref.__mro__[:2]]
        assert tasync.make_policy_program(base, mode) is cls
    with pytest.raises(TypeError, match="cannot policy-lower"):
        tasync.make_policy_program(troles.Trainer, "async")
    with pytest.raises(ValueError, match="unknown policy mode"):
        tasync.make_policy_program(troles.GlobalAggregator, "sync")


def test_async_strategy_must_be_buffered():
    rt = trt.JobRuntime(_classical(PORT, n=1, rounds=1, async_strategy="fedavg"), device="cpu",
                        policy=trt.RuntimePolicy(mode="async", buffer_size=1, grace=1.0))
    root = next(w for w in rt.workers if w.role == "global-aggregator")
    with pytest.raises(ValueError, match="buffered strategy"):
        rt._build_program(root)._init_strategy()


# ---------------------------------------------------------------------- #
# test_event_engine.py: the port's engine against the JAX package's
# ---------------------------------------------------------------------- #
class FakeTransport:
    def __init__(self, members=None):
        self.calls = []
        self.members = dict(members or {})

    def set_drop(self, worker, at):
        self.calls.append(("set_drop", worker, at))

    def clear_drop(self, worker):
        self.calls.append(("clear_drop", worker))

    def set_clock(self, worker, at):
        self.calls.append(("set_clock", worker, at))

    def poison(self, worker, at):
        self.calls.append(("poison", worker, at))

    def peers(self, channel, group, me):
        return [m for m in self.members.get((channel, group), []) if m != me]


class FakeHandle:
    def __init__(self):
        self.calls = []

    def start(self, at):
        self.calls.append(("start", at))

    def restart(self, at):
        self.calls.append(("restart", at))

    def kill(self, at):
        self.calls.append(("kill", at))

    def wait(self, timeout):
        self.calls.append(("wait", timeout))
        return True


def _engine(pkg_ev, pkg_exp, pkg_tag, pkg_rt, policy, ids, members=None):
    param = pkg_tag.Channel(
        name="param-channel", pair=("trainer", "aggregator"),
        func_tags=pkg_tag.FuncTags({"trainer": ("fetch", "upload"),
                                    "aggregator": ("distribute", "aggregate")}))
    workers = [pkg_exp.WorkerConfig(worker_id=w, role=w.rsplit("-", 1)[0], program="",
                                    compute_id="c0", groups={"param-channel": "default"})
               for w in ids]
    transport = FakeTransport(members)
    eng = pkg_ev.EventEngine(pkg_rt.RuntimePolicy(**policy), workers,
                             spec_of={"param-channel": param}.__getitem__, transport=transport)
    return eng, workers, transport


_IDS = ["aggregator-0", "trainer-0", "trainer-1"]
_ALL = {("param-channel", "default"): _IDS}


def _engine_script(name, pkg_ev, pkg_exp, pkg_tag, pkg_rt):
    """Drive one scenario of ``test_event_engine.py``; returns what it saw."""
    mods = (pkg_ev, pkg_exp, pkg_tag, pkg_rt)
    if name == "cohort":
        out = []
        for pol in ({"arrivals": {"trainer-1": 2.0}},
                    {"mode": "async", "arrivals": {"trainer-1": 2.0}}):
            eng, _, _ = _engine(*mods, pol, _IDS)
            out.append((eng.dynamic_join, [w.worker_id for w in eng.initial_cohort()]))
        return out
    if name == "unknown_worker":
        out = []
        for key in ("arrivals", "dropouts"):
            with pytest.raises(KeyError):
                _engine(*mods, {key: {"ghost-0": 1.0}}, _IDS)
            out.append(key)
        return out
    if name == "arm":
        eng, _, tr = _engine(*mods, {"dropouts": {"trainer-0": 1.5}}, _IDS)
        eng.arm_dropouts()
        return tr.calls
    if name == "run_order":
        eng, workers, tr = _engine(*mods, {"mode": "async", "arrivals": {"trainer-0": 3.0}}, _IDS)
        handles = {w.worker_id: FakeHandle() for w in workers}
        alive = eng.run(handles, timeout=5.0)
        return alive, eng.events, tr.calls, {k: h.calls for k, h in handles.items()}
    if name in ("cascade", "no_cascade", "replica"):
        ids = _IDS + (["aggregator-1"] if name == "replica" else [])
        dropped = "trainer-0" if name == "no_cascade" else "aggregator-0"
        eng, workers, tr = _engine(*mods, {"dropouts": {dropped: 0.5}}, ids,
                                   {("param-channel", "default"): ids})
        handles = {w.worker_id: FakeHandle() for w in workers}
        eng.bind(handles)
        rejoin = eng.worker_dropped(dropped, 0.5)
        return rejoin, eng.dropped, eng.events, tr.calls, {k: h.calls for k, h in handles.items()}
    if name == "rejoin":
        eng, workers, tr = _engine(*mods, {"dropouts": {"trainer-0": 0.5},
                                           "rejoins": {"trainer-0": 1.5}}, _IDS)
        handles = {w.worker_id: FakeHandle() for w in workers}
        eng.bind(handles)
        at = eng.worker_dropped("trainer-0", 0.5)
        eng.rejoin("trainer-0", at)
        return at, eng.events, tr.calls, {k: h.calls for k, h in handles.items()}
    raise KeyError(name)


@pytest.mark.parametrize("scenario", ["cohort", "unknown_worker", "arm", "run_order",
                                      "cascade", "no_cascade", "replica", "rejoin"])
def test_event_engine_matches_reference(scenario):
    port = _engine_script(scenario, tev, texp, ttag, trt)
    ref = _engine_script(scenario, jev, jexp, jtag, jrt)
    assert port == ref
    if scenario == "cascade":
        assert {w for _, k, w in port[2] if k == "orphaned"} == {"trainer-0", "trainer-1"}
    if scenario == "replica":
        assert not [c for c in port[3] if c[0] == "poison"]


# ---------------------------------------------------------------------- #
# the policy guard of test_protocols.py, and test_hybrid_dropout.py
# ---------------------------------------------------------------------- #
def test_policy_lowering_rejects_non_weight_sync():
    for pkg in (PORT, REF):
        job = pkg["exp"].JobSpec(
            tag=pkg["top"].vertical_fl(),
            datasets=tuple(pkg["tag"].DatasetSpec(name=f"d{i}") for i in range(2)),
            hyperparams={"rounds": 2})
        kw = {"device": "cpu"} if pkg["port"] else {}
        with pytest.raises(RuntimeError, match="weight-sync"):
            pkg["rt"].run_job(job, timeout=30, **kw, policy=pkg["rt"].RuntimePolicy(
                mode="deadline", deadline=5.0, grace=1.0))


def _clocked_hybrid(pkg):
    return type("ClockedHybridTrainer", (pkg["roles"].HybridTrainer,), {
        "train": lambda self: self.ctx.advance_clock(
            self.ring_channel, float(self.config.get("train_time", 1.0)))})


def _hybrid_job(pkg, rounds):
    tag = pkg["top"].hybrid_fl(groups=("c0", "c1"),
                               dataset_groups={"c0": ("d0", "d1"), "c1": ("d2", "d3")})
    return pkg["exp"].JobSpec(
        tag=tag, datasets=tuple(pkg["tag"].DatasetSpec(name=f"d{i}") for i in range(4)),
        hyperparams={"rounds": rounds, "init_weights": W0, "grace": 5.0})


HYBRID_CASES = {
    "happy_path": ({}, 4),
    "non_leader_dropout": ({"dropouts": {"trainer-1": 1.5}}, 4),
    "leader_dropout": ({"dropouts": {"trainer-0": 1.5}}, 4),
    "dropout_then_rejoin": ({"dropouts": {"trainer-1": 1.5}, "rejoins": {"trainer-1": 2.5}}, 5),
    "second_leader_dropout": ({"dropouts": {"trainer-2": 1.5}}, 4),
}
# the cases whose cluster leaders never change: which leader uploads each
# round is fixed, so participation and weights are the JAX package's; a
# promoted leader (or a re-joined member) joins the param channel at a
# moment thread timing decides, so those cases are held to their structure
# in both packages, as test_hybrid_dropout.py holds the reference
HYBRID_EXACT = ("happy_path", "non_leader_dropout")


# the trainer each leader-change case promotes to cluster leader (or, for
# the re-join, brings back on the uplink's cluster)
HYBRID_PROMOTED = {"leader_dropout": "trainer-1", "second_leader_dropout": "trainer-3",
                   "dropout_then_rejoin": "trainer-1"}


def _reference_hybrid(case, pol, rounds):
    """The JAX package's run of a hybrid case. A leader-change case is run
    again, at most twice, when its only error is the promoted trainer's
    ``queue.Empty``: the reference's promoted leader can join the uplink
    after the deadline root's last broadcast and then waits out its 30 s
    receive (open in the reference, ROADMAP Queue 3). Any other error fails."""
    for attempt in range(3):
        res = REF["rt"].run_job(
            _hybrid_job(REF, rounds), timeout=60, policy=REF["rt"].RuntimePolicy(**pol),
            program_overrides={"trainer": _clocked_hybrid(REF)})
        promoted = HYBRID_PROMOTED.get(case)
        known_race = (promoted is not None and set(res.errors) == {promoted}
                      and isinstance(res.errors[promoted], queue.Empty))
        if not known_race or attempt == 2:
            break
    assert not res.errors, res.errors
    return res


@pytest.mark.parametrize("case", sorted(HYBRID_CASES))
def test_hybrid_deadline_dropouts_match_reference(case):
    """``test_hybrid_dropout.py`` under its deadline root, in both packages:
    drops and events equal; where no leader changes, the participation logs
    and the global weights' bytes too (the cluster all-reduce folds in
    float64, the root in sorted-source order). The port's run gets no
    retry."""
    extra, rounds = HYBRID_CASES[case]
    pol = {"mode": "deadline", "deadline": 50.0, "grace": 3.0, **extra}
    port = _run(PORT, _hybrid_job(PORT, rounds), trainer=None, policy=pol,
                program_overrides={"trainer": _clocked_hybrid(PORT)})
    ref = _reference_hybrid(case, pol, rounds)
    assert port.dropped == ref.dropped and port.events == ref.events
    if case in HYBRID_EXACT:
        assert (port.program("global-aggregator-0").participation_log
                == ref.program("global-aggregator-0").participation_log)
        assert _bytes(port.global_weights()) == _bytes(ref.global_weights())
    for res in (port, ref):
        glob = res.program("global-aggregator-0")
        log = glob.participation_log
        assert glob._round >= rounds
        assert all(len(e["included"]) <= 2 for e in log)
        assert np.isfinite(_host(res.global_weights()["w"])).all()
        if case == "leader_dropout":
            assert "trainer-1" in set().union(*(e["included"] for e in log))
            assert "trainer-0" not in log[-1]["included"] and "trainer-0" not in log[-1]["missing"]
        if case == "non_leader_dropout":
            assert any("trainer-0" in e["included"] for e in log if e["round"] >= 2)
        if case == "dropout_then_rejoin":
            assert (2.5, "rejoin", "trainer-1") in res.events
        if case == "second_leader_dropout":
            assert np.isfinite(_host(res.program("trainer-3").weights["w"])).all()


# the root's last broadcast has gone out (set when its chain returns)
_ROOT_DONE = threading.Event()


class _DoneSignallingRoot(troles.GlobalAggregator):
    def run(self):
        try:
            super().run()
        finally:
            _ROOT_DONE.set()


class _LateJoinHybrid(troles.HybridTrainer):
    """``trainer-1`` holds its own first join of the uplink (param channel)
    until the root has sent its last broadcast: the ordering behind the
    reference's ``queue.Empty`` in the leader-dropout case, planted."""

    def __init__(self, ctx):
        super().__init__(ctx)
        if ctx.worker.worker_id == "trainer-1":
            own_end = ctx.end

            def held_end(channel):
                if channel == self.param_channel and channel not in ctx._ends:
                    assert _ROOT_DONE.wait(timeout=30.0), "the root never finished"
                return own_end(channel)

            ctx.end = held_end

    def train(self):
        self.ctx.advance_clock(self.ring_channel, float(self.config.get("train_time", 1.0)))


def test_hybrid_promoted_leader_late_join_completes():
    """Leader dropout with the promoted leader's own uplink join planted
    after the deadline root's last broadcast: the job completes (the
    dropped leader hands its uplink membership to its successor as it
    leaves), with the drop and lifecycle events of an unplanted run and the
    dropped leader in no later round."""
    pol = {"mode": "deadline", "deadline": 50.0, "grace": 3.0,
           "dropouts": {"trainer-0": 1.5}}
    plain = _run(PORT, _hybrid_job(PORT, 4), trainer=None, policy=pol,
                 program_overrides={"trainer": _clocked_hybrid(PORT)})
    _ROOT_DONE.clear()
    res = _run(PORT, _hybrid_job(PORT, 4), trainer=None, policy=pol,
               program_overrides={"trainer": _LateJoinHybrid,
                                  "global-aggregator": _DoneSignallingRoot})
    assert _ROOT_DONE.is_set()
    assert res.dropped == plain.dropped == {"trainer-0": 1.5}
    assert res.events == plain.events
    log = res.program("global-aggregator-0").participation_log
    assert len(log) == 4
    assert all("trainer-0" not in e["included"] for e in log[1:])
    assert "trainer-0" not in log[-1]["missing"]
    assert np.isfinite(_host(res.global_weights()["w"])).all()
    assert np.isfinite(_host(res.program("trainer-1").weights["w"])).all()
