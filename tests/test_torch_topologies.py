"""The remaining topologies of the port against the JAX package's.

Twins of the distributed, hybrid and coordinated cases of
``test_jobs_e2e.py``, of the sync cases of ``test_protocols.py`` (vertical
FL, gossip, the registries), of ``test_hybrid_dropout.py``'s non-leader
dropout under the sync policy, and of ``benchmarks/bench_coordinated.py``'s
straggler scenario at a small size. The port runs on the CPU.

The jobs whose trainers only add seeded noise fold without any product:
``_fold_allreduce`` in float64, the stacked and the streaming exact folds in
float32. Their weights must be byte-equal to the JAX package's. The
vertical job multiplies with torch CPU BLAS on one side and numpy BLAS on the
other, which round differently, so it is held to ``SGD_RTOL``/``SGD_ATOL``
(the seeded SGD job's float32 tolerance in ``test_torch_jobs.py``).
"""
import hashlib

import ml_dtypes
import numpy as np
import pytest
import torch

import repro.core.channels as jch
import repro.core.composer as jcomp
import repro.core.expansion as jexp
import repro.core.protocols as jproto
import repro.core.roles as jroles
import repro.core.roles_coord as jcoord
import repro.core.runtime as jrt
import repro.core.tag as jtag
import repro.core.topologies as jtop
import repro_torch.core.channels as tch
import repro_torch.core.composer as tcomp
import repro_torch.core.expansion as texp
import repro_torch.core.protocols as tproto
import repro_torch.core.roles as troles
import repro_torch.core.roles_coord as tcoord
import repro_torch.core.runtime as trt
import repro_torch.core.tag as ttag
import repro_torch.core.topologies as ttop
from repro_torch.convert import tree_from_numpy, tree_to_numpy
from repro_torch.core.tree import tree_leaves

W0 = {"w": np.full((8,), 2.0, np.float32), "b": np.zeros((2, 2), np.float32)}
SGD_RTOL, SGD_ATOL = 1e-5, 1e-6
CPU = torch.device("cpu")

# the two packages side by side: (tag, expansion, runtime, topologies,
# channels, roles, coordinated roles, protocols, composer); the port's first
PORT = dict(tag=ttag, exp=texp, rt=trt, top=ttop, ch=tch, roles=troles, coord=tcoord,
            proto=tproto, comp=tcomp, port=True)
REF = dict(tag=jtag, exp=jexp, rt=jrt, top=jtop, ch=jch, roles=jroles, coord=jcoord,
           proto=jproto, comp=jcomp, port=False)


# ---------------------------------------------------------------------- #
# seeded trainers: the same numpy noise in both packages, added in float32
# ---------------------------------------------------------------------- #
def _noise(dataset, step, shape):
    seed = int(hashlib.sha256(f"{dataset}:{step}".encode()).hexdigest()[:12], 16)
    return (0.01 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _noise_trainer(base, port):
    """``base`` with a ``train`` that adds seeded noise to every leaf and
    reports ``3 + dataset index`` samples."""

    def train(self):
        if self.weights is None:
            return
        self._noise_step = getattr(self, "_noise_step", 0) + 1
        ds = self.ctx.worker.dataset
        self.num_samples = 3 + int(ds[1:])
        if port:
            self.weights = {k: v + torch.from_numpy(_noise(ds, self._noise_step, tuple(v.shape)))
                            for k, v in self.weights.items()}
        else:
            self.weights = {k: np.asarray(v) + _noise(ds, self._noise_step, np.shape(v))
                            for k, v in self.weights.items()}

    return type(f"Noise{base.__name__}", (base,), {"train": train})


def _datasets(pkg, n):
    return tuple(pkg["tag"].DatasetSpec(name=f"d{i}") for i in range(n))


def _run(pkg, tag, n, rounds=2, hp=None, **kw):
    job = pkg["exp"].JobSpec(tag=tag, datasets=_datasets(pkg, n),
                             hyperparams={"rounds": rounds, **(hp or {})})
    extra = {"device": "cpu"} if pkg["port"] else {}
    res = pkg["rt"].run_job(job, timeout=60, **extra, **kw)
    assert not res.errors, res.errors
    return res


def _run_pair(make_tag, n, rounds=2, hp=None, trainer_base=None, **kw):
    """The same job through both packages (``make_tag(topologies)``); with
    ``trainer_base(pkg)`` the trainers add seeded noise."""
    out = []
    for pkg in (PORT, REF):
        extra = dict(kw)
        if trainer_base is not None:
            extra["program_overrides"] = {
                "trainer": _noise_trainer(trainer_base(pkg), pkg["port"])}
        out.append(_run(pkg, make_tag(pkg["top"]), n, rounds, hp, **extra))
    return out


def _bytes(tree):
    return [np.asarray(x).tobytes() for x in tree_leaves(tree_to_numpy(tree))]


def _ref_bytes(tree):
    import jax

    return [np.asarray(x).tobytes() for x in jax.tree_util.tree_leaves(tree)]


def _worker_bytes(ours, ref):
    """Every program's weights, byte-equal between the packages."""
    assert set(ours.programs) == set(ref.programs)
    for wid in ours.programs:
        if not hasattr(ref.programs[wid], "weights"):  # the coordinator holds none
            assert not hasattr(ours.programs[wid], "weights"), wid
            continue
        w, rw = ours.programs[wid].weights, ref.programs[wid].weights
        if rw is None:
            assert w is None, wid
            continue
        assert _bytes(w) == _ref_bytes(rw), wid


# ---------------------------------------------------------------------- #
# _fold_allreduce
# ---------------------------------------------------------------------- #
def test_fold_allreduce_byte_equal_with_unsorted_arrivals():
    rng = np.random.default_rng(3)

    def tree():
        return {"w": rng.normal(size=(5, 7)).astype(np.float32) * 1e3,
                "b": rng.normal(size=(3,)).astype(np.float32),
                "h": rng.normal(size=(4,)).astype(ml_dtypes.bfloat16)}

    own, others = tree(), {f"trainer-{i}": tree() for i in (4, 0, 3, 1)}
    samples = {"trainer-4": 7.0, "trainer-0": 2.5, "trainer-3": 11.0, "trainer-1": 1.0}
    arrivals = ["trainer-3", "trainer-0", "trainer-4", "trainer-1"]
    ref_recv = [(s, {"weights": others[s], "num_samples": samples[s]}) for s in arrivals]
    want, want_total = jroles._fold_allreduce("trainer-2", own, 5.0, ref_recv)
    port_recv = [(s, {"weights": tree_from_numpy(m["weights"], CPU), "num_samples": m["num_samples"]})
                 for s, m in ref_recv]
    got, total = troles._fold_allreduce("trainer-2", tree_from_numpy(own, CPU), 5.0,
                                        port_recv, CPU)
    assert total == want_total == 26
    for k in want:
        assert got[k].dtype == torch.float32 and want[k].dtype == np.float32
        assert got[k].numpy().tobytes() == want[k].tobytes(), k
    # arrival order does not matter: the fold runs in sorted worker-id order
    again, _ = troles._fold_allreduce("trainer-2", tree_from_numpy(own, CPU), 5.0,
                                      port_recv[::-1], CPU)
    assert _bytes(again) == _bytes(got)


def test_fold_allreduce_leaves_its_inputs_alone():
    a = {"w": torch.arange(6, dtype=torch.float64)}
    b = {"w": torch.ones(6, dtype=torch.float64)}
    keep = (a["w"].clone(), b["w"].clone())
    mean, total = troles._fold_allreduce("t-0", a, 1.0, [("t-1", {"weights": b, "num_samples": 3})],
                                         CPU)
    assert total == 4 and mean["w"].dtype == torch.float32
    assert torch.equal(a["w"], keep[0]) and torch.equal(b["w"], keep[1])
    np.testing.assert_array_equal(mean["w"].numpy(), ((np.arange(6) + 3) / 4).astype(np.float32))


# ---------------------------------------------------------------------- #
# distributed, hybrid, coordinated
# ---------------------------------------------------------------------- #
def _hybrid(top):
    return top.hybrid_fl(groups=("c0", "c1"), dataset_groups={"c0": ("d0", "d1"), "c1": ("d2", "d3")})


def _coordinated(top, n=4, replicas=2):
    return top.coordinated_fl(aggregator_replicas=replicas,
                              dataset_groups={"default": tuple(f"d{i}" for i in range(n))})


def test_distributed_fl_consensus_byte_equal():
    ours, ref = _run_pair(lambda top: top.distributed_fl(), 3, hp={"init_weights": W0},
                          trainer_base=lambda pkg: pkg["roles"].DistributedTrainer)
    _worker_bytes(ours, ref)
    ws = [_bytes(p.weights) for p in ours.programs.values()]
    assert all(w == ws[0] for w in ws[1:])
    assert _bytes(ours.programs["trainer-0"].weights) != _bytes(tree_from_numpy(W0, CPU))
    assert ours.channel_bytes == ref.channel_bytes


def test_distributed_fl_no_op_trainers_keep_weights():
    ours, ref = _run_pair(lambda top: top.distributed_fl(), 3, hp={"init_weights": W0})
    for p in ours.programs.values():
        np.testing.assert_array_equal(tree_to_numpy(p.weights)["w"], W0["w"])
    _worker_bytes(ours, ref)


def test_hybrid_fl_leader_upload_byte_equal():
    ours, ref = _run_pair(_hybrid, 4, hp={"init_weights": W0},
                          trainer_base=lambda pkg: pkg["roles"].HybridTrainer)
    assert _bytes(ours.global_weights()) == _ref_bytes(ref.global_weights())
    _worker_bytes(ours, ref)
    assert ours.channel_bytes == ref.channel_bytes
    assert ours.channel_bytes["ring-channel"] > 0 and ours.channel_bytes["param-channel"] > 0
    # one leader per cluster on the uplink: the aggregator saw two sources
    folds = [m["agg_folds"] for m in ours.program("global-aggregator-0").metrics if "agg_folds" in m]
    assert folds == [2, 2]


def test_coordinated_fl_three_rounds_byte_equal():
    ours, ref = _run_pair(_coordinated, 4, rounds=3, hp={"init_weights": W0},
                          trainer_base=lambda pkg: pkg["coord"].CoordTrainer)
    assert _bytes(ours.global_weights()) == _ref_bytes(ref.global_weights())
    assert _bytes(ours.global_weights()) != _bytes(tree_from_numpy(W0, CPU))
    _worker_bytes(ours, ref)
    assert ours.channel_bytes == ref.channel_bytes
    coord, rcoord = ours.program("coordinator-0"), ref.program("coordinator-0")
    assert coord.decisions == rcoord.decisions and len(coord.decisions) == 3


def test_coordinated_programs_resolve_from_the_tag():
    tag = ttop.coordinated_fl()
    progs = {r.name: trt.resolve_program(r.program) for r in tag.roles}
    assert progs == {"trainer": tcoord.CoordTrainer, "aggregator": tcoord.CoordAggregator,
                     "global-aggregator": tcoord.CoordGlobalAggregator,
                     "coordinator": tcoord.Coordinator}
    assert trt.resolve_program("repro.core.roles.HybridTrainer") is troles.HybridTrainer
    assert trt.resolve_program("repro.core.roles.DistributedTrainer") is troles.DistributedTrainer


def test_coordinated_straggler_decisions_match_reference():
    """``bench_coordinated.py``'s scenario at a small size: one aggregator's
    uplink is throttled; the coordinator excludes it with binary backoff.
    Its decisions and the global aggregator's per-round times are the JAX
    package's."""
    out = []
    for pkg in (PORT, REF):
        links = {("global-channel", "aggregator-1"): pkg["ch"].LinkModel(bandwidth=500.0),
                 ("global-channel", "aggregator-0"): pkg["ch"].LinkModel(bandwidth=1e9)}
        res = _run(pkg, _coordinated(pkg["top"], n=6), 6, rounds=10,
                   hp={"init_weights": W0, "delay_threshold": 1.5, "consecutive_delays": 3},
                   link_models=links)
        coord = res.program("coordinator-0")
        times = [m["round_time"] for m in res.program("global-aggregator-0").metrics
                 if "round_time" in m]
        out.append((coord.decisions, times, res.channel_bytes))
    assert out[0] == out[1]
    decisions, times, _ = out[0]
    assert any("aggregator-1" not in d["active"] for d in decisions)
    assert len(times) == 10


def test_hybrid_non_leader_dropout_under_sync_matches_reference():
    """``test_hybrid_dropout.py``'s non-leader dropout, under the sync
    policy: the leader folds its cluster without the dead member."""
    out = []
    for pkg in (PORT, REF):
        clocked = type("ClockedHybridTrainer", (pkg["roles"].HybridTrainer,), {
            "train": lambda self: self.ctx.advance_clock(self.ring_channel, 1.0)})
        policy = pkg["rt"].RuntimePolicy(mode="sync", dropouts={"trainer-1": 1.5}, grace=3.0)
        res = _run(pkg, _hybrid(pkg["top"]), 4, rounds=4,
                   hp={"init_weights": W0, "grace": 5.0}, policy=policy,
                   program_overrides={"trainer": clocked})
        w = res.global_weights()
        out.append((res.dropped, res.events, _bytes(w) if pkg["port"] else _ref_bytes(w),
                    res.channel_bytes))
    assert out[0] == out[1]
    assert out[0][0] == {"trainer-1": 1.5}
    assert (1.5, "dropout", "trainer-1") in out[0][1]


@pytest.mark.parametrize("template", ["coordinated", "hybrid", "vertical"])
@pytest.mark.parametrize("mode", ["deadline", "async"])
def test_policy_lowering_of_new_topologies_matches_reference(template, mode):
    """The templates with a root aggregator under a deadline or async
    policy, with the JAX package's outcome: the coordinated aggregators
    override ``compose()`` and refuse the lowering (``ValueError``), the
    vertical protocol is not weight-sync (``RuntimeError``), and the hybrid
    job completes with the reference's participation (distributed and
    gossip have no aggregator tier to lower)."""
    outcomes = []
    for pkg in (PORT, REF):
        job = pkg["exp"].JobSpec(tag=pkg["top"].get_template(template)(),
                                 datasets=_datasets(pkg, 2),
                                 hyperparams={"rounds": 1, "init_weights": W0})
        extra = {"device": "cpu"} if pkg["port"] else {}
        try:
            res = pkg["rt"].run_job(job, timeout=60, **extra,
                                    policy=pkg["rt"].RuntimePolicy(mode=mode, grace=10.0))
        except (ValueError, RuntimeError) as e:
            outcomes.append((type(e), str(e)))
            continue
        assert not res.errors, res.errors
        glob = res.program("global-aggregator-0")
        outcomes.append((glob._version if mode == "async" else glob.participation_log,
                         res.dropped, res.channel_bytes))
    assert outcomes[0] == outcomes[1]
    if template == "hybrid":  # the cluster leader uploads, once
        assert outcomes[0][0] == (1 if mode == "async" else [{
            "round": 0, "included": ["trainer-0"], "excluded": [], "missing": [],
            "round_time": 0.0}])
    else:
        assert outcomes[0][0] is {"coordinated": ValueError, "vertical": RuntimeError}[template]


# ---------------------------------------------------------------------- #
# vertical FL
# ---------------------------------------------------------------------- #
def _vertical(pkg, rounds=3, n_parties=3, **hp):
    return _run(pkg, pkg["top"].vertical_fl(), n_parties, rounds, hp)


def _head_losses(res):
    return [m["vertical_loss"] for m in res.program("head-0").metrics if "vertical_loss" in m]


def test_vertical_agrees_with_reference_within_tolerance():
    ours, ref = _vertical(PORT, rounds=4), _vertical(REF, rounds=4)
    np.testing.assert_allclose(_head_losses(ours), _head_losses(ref), rtol=SGD_RTOL, atol=SGD_ATOL)
    for wid in ours.programs:
        w, rw = tree_to_numpy(ours.programs[wid].weights), ref.programs[wid].weights
        assert set(w) == set(rw)
        for k in w:
            assert w[k].dtype == np.float32 and w[k].shape == np.shape(rw[k])
            np.testing.assert_allclose(w[k], rw[k], rtol=SGD_RTOL, atol=SGD_ATOL)
    assert ours.channel_bytes == ref.channel_bytes
    assert not np.allclose(tree_to_numpy(ours.program("party-0").weights)["w"], 0.0)


def test_vertical_dataset_is_the_reference_one():
    cfg = tproto._vertical_config({"vertical_seed": 5, "vertical_samples": 64})
    assert cfg == jproto._vertical_config({"vertical_seed": 5, "vertical_samples": 64})
    for a, b in zip(tproto._vertical_dataset(cfg), jproto._vertical_dataset(cfg)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    for rnd, step in ((0, 0), (3, 2), (17, 3)):
        assert np.array_equal(tproto._batch_indices(cfg, rnd, step),
                              jproto._batch_indices(cfg, rnd, step))
    assert tproto._role_of("party-12") == jproto._role_of("party-12") == "party"


def test_vertical_loss_decreases_over_rounds():
    losses = _head_losses(_vertical(PORT, rounds=4))
    assert len(losses) == 4
    assert losses[-1] < losses[0]


def test_vertical_seeded_runs_are_byte_identical():
    a, b = _vertical(PORT), _vertical(PORT)
    for wid in a.programs:
        assert _bytes(a.programs[wid].weights) == _bytes(b.programs[wid].weights)


def test_vertical_parties_hold_disjoint_column_blocks():
    res = _vertical(PORT, n_parties=3, vertical_features=32)
    widths = [res.program(f"party-{i}").weights["w"].shape[0] for i in range(3)]
    assert sum(widths) == 32 and all(w > 0 for w in widths)


def test_vertical_latency_dominated_traffic_shape():
    res = _vertical(PORT, rounds=2, vertical_steps=4)
    ref = _vertical(REF, rounds=2, vertical_steps=4)
    chans = res.program("head-0").ctx.channels
    assert chans.total_msgs("activation-channel") >= 2 * 27
    assert chans.total_msgs("activation-channel") == \
        ref.program("head-0").ctx.channels.total_msgs("activation-channel")


# ---------------------------------------------------------------------- #
# gossip
# ---------------------------------------------------------------------- #
def test_gossip_noop_trainers_keep_consensus():
    res = _run(PORT, ttop.gossip_fl(backend="inproc"), 4, 3, {"init_weights": W0})
    for p in res.programs.values():
        np.testing.assert_array_equal(tree_to_numpy(p.weights)["w"], W0["w"])


def test_gossip_noise_trainers_byte_equal():
    ours, ref = _run_pair(lambda top: top.gossip_fl(backend="inproc"), 4, rounds=3,
                          hp={"init_weights": W0}, trainer_base=lambda pkg: pkg["roles"].Trainer)
    _worker_bytes(ours, ref)
    assert ours.channel_bytes == ref.channel_bytes
    ws = [_bytes(p.weights) for p in ours.programs.values()]
    assert ws[0] != ws[1]  # three rounds on a ring of four: consensus not yet complete


def test_gossip_seeded_sgd_agrees_with_reference():
    init = {"w": np.zeros((32, 10), np.float32), "b": np.zeros((10,), np.float32)}
    out = []
    for pkg in (PORT, REF):
        tag = pkg["top"].gossip_fl(backend="inproc",
                                   trainer_program="repro.transport.conformance.SeededSGDTrainer")
        out.append(_run(pkg, tag, 4, 3, {"init_weights": init}))
    ours, ref = out
    for wid in ours.programs:
        w, rw = tree_to_numpy(ours.programs[wid].weights), ref.programs[wid].weights
        for k in w:
            np.testing.assert_allclose(w[k], np.asarray(rw[k]), rtol=SGD_RTOL, atol=SGD_ATOL)
    assert all(np.isfinite(tree_to_numpy(p.weights)["w"]).all() for p in ours.programs.values())


def test_gossip_two_members_average_to_midpoint():
    class BiasTrainer(troles.Trainer):
        def train(self):
            k = float(self.ctx.worker.worker_id[-1])
            self.weights = {n: v + k for n, v in self.weights.items()}

    res = _run(PORT, ttop.gossip_fl(backend="inproc"), 2, 1, {"init_weights": W0},
               program_overrides={"trainer": BiasTrainer})
    w0 = tree_to_numpy(res.program("trainer-0").weights)["w"]
    w1 = tree_to_numpy(res.program("trainer-1").weights)["w"]
    np.testing.assert_array_equal(w0, w1)
    np.testing.assert_allclose(w0, W0["w"] + 0.5)


@pytest.mark.parametrize("pkg", [PORT, REF], ids=["port", "reference"])
def test_gossip_rewrite_chain_requires_trainer_shape(pkg):
    class FakeRole:
        weights = None
        config = {}

    comp = pkg["comp"]
    with comp.Composer() as c:
        t1 = comp.Tasklet("serve", lambda: None)
        t2 = comp.Tasklet("finish", lambda: None)
        t1 >> t2
    proto = pkg["proto"].GossipAvg(FakeRole(), "gossip-channel")
    with pytest.raises(comp.ComposerError, match="fetch"):
        proto.rewrite_chain(c)


# ---------------------------------------------------------------------- #
# registries
# ---------------------------------------------------------------------- #
def test_protocol_registry_matches_reference():
    assert tproto.registered_protocols() == jproto.registered_protocols()
    assert {"weight-sync", "vertical-split", "gossip-avg"} <= set(tproto.registered_protocols())
    with pytest.raises(ValueError, match="already registered"):
        tproto.register_protocol("weight-sync", tproto.GossipAvg)
    tproto.register_protocol("weight-sync", tproto.WeightSync)  # same factory: idempotent
    with pytest.raises(KeyError, match="unknown round protocol"):
        tproto.make_protocol("no-such-protocol", None, None)


def test_every_template_runs_on_the_port():
    assert ttop.registered_templates() == jtop.registered_templates()
    for name in ("coordinated", "hybrid", "distributed", "gossip"):
        res = _run(PORT, ttop.get_template(name)(), 5, 2, {"init_weights": W0})
        assert res.programs, name
    assert _run(PORT, ttop.vertical_fl(), 2, 2).programs


# ---------------------------------------------------------------------- #
# the streaming fold's repairs: bfloat16 leaves, strided leaves
# ---------------------------------------------------------------------- #
def test_streaming_mean_bf16_twin():
    rng = np.random.default_rng(11)
    ups = [(rng.normal(size=4096).astype(np.float32).astype(ml_dtypes.bfloat16),
            float(rng.integers(50, 501))) for _ in range(8)]
    ref = jroles.StreamingMean(fused=False)
    ours = troles.StreamingMean(device="cpu")
    for x, n in ups:
        ref.fold({"x": x}, n)
        ours.fold(tree_from_numpy({"x": x}, CPU), n)
    want, want_total = ref.finalize()
    got, total = ours.finalize()
    assert total == want_total
    assert want["x"].dtype == np.float32 and got["x"].dtype == torch.float32
    assert got["x"].numpy().tobytes() == want["x"].tobytes()
    # weighted_mean falls back to the streaming fold for such trees
    mean, _ = troles.weighted_mean([(tree_from_numpy({"x": x}, CPU), n) for x, n in ups])
    assert mean["x"].numpy().tobytes() == want["x"].tobytes()


def test_streaming_mean_folds_strided_leaves():
    rng = np.random.default_rng(12)
    a, b = (rng.normal(size=(4, 3)).astype(np.float32) for _ in range(2))
    ref = jroles.StreamingMean(fused=False)
    ours = troles.StreamingMean(device="cpu")
    for x, n in ((a.T, 2.0), (b.T, 5.0), (a.T, 1.0)):
        ref.fold({"x": x}, n)
        ours.fold({"x": torch.from_numpy(x.T.copy()).t()}, n)
    want, _ = ref.finalize()
    got, _ = ours.finalize()
    assert got["x"].shape == want["x"].shape == (3, 4)
    assert got["x"].numpy().tobytes() == np.ascontiguousarray(want["x"]).tobytes()


def test_classical_job_with_strided_init_weights():
    a = np.arange(12, dtype=np.float32).reshape(3, 4) / 7
    out = []
    for pkg in (PORT, REF):
        out.append(_run(pkg, pkg["top"].classical_fl(), 2, 2, {"init_weights": {"w": a.T}}))
    ours, ref = out
    got = tree_to_numpy(ours.global_weights())["w"]
    assert got.shape == (4, 3)
    assert np.ascontiguousarray(got).tobytes() == np.ascontiguousarray(ref.global_weights()["w"]).tobytes()
