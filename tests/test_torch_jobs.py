"""Seeded in-process jobs of the port against the same jobs of the JAX package.

Twins of ``test_jobs_e2e.py``: the classical and hierarchical jobs with the
"add one" trainer have no matmul, so their global weights must be
byte-equal, with equal ``channel_bytes`` and fold metrics. The seeded SGD
job multiplies with torch CPU BLAS on one side and numpy BLAS on the other,
which round differently, so it is held to a float32 tolerance instead.
"""
import numpy as np
import pytest
import torch

import repro.core.channels as jch
import repro.core.expansion as jexp
import repro.core.runtime as jrt
import repro.core.tag as jtag
import repro.core.topologies as jtop
import repro_torch.core.channels as tch
import repro_torch.core.expansion as texp
import repro_torch.core.runtime as trt
import repro_torch.core.tag as ttag
import repro_torch.core.topologies as ttop
from repro.core.roles import Trainer as JaxTrainer
from repro.transport.conformance import SeededSGDTrainer as JaxSGDTrainer
from repro_torch.convert import tree_to_numpy
from repro_torch.core.roles import Trainer
from repro_torch.transport.conformance import SeededSGDTrainer

W0 = {"w": np.full((8,), 2.0, np.float32), "b": np.zeros((2, 2), np.float32)}
_RNG = np.random.default_rng(17)
SGD_W0 = {
    "w": (0.01 * _RNG.normal(size=(32, 10))).astype(np.float32),
    "b": np.zeros((10,), np.float32),
}
_GROUPS = {"west": ("d0", "d1"), "east": ("d2", "d3")}
# torch CPU BLAS against numpy BLAS: float32 products summed in another
# order, over 3 rounds of one SGD step each
SGD_RTOL, SGD_ATOL = 1e-5, 1e-6


class AddOneTrainer(Trainer):
    def train(self):
        if self.weights is not None:
            self.weights = {k: v + 1.0 for k, v in self.weights.items()}


class JaxAddOneTrainer(JaxTrainer):
    def train(self):
        if self.weights is not None:
            self.weights = {k: np.asarray(v) + 1.0 for k, v in self.weights.items()}


def _tags(mod, topology):
    if topology == "classical":
        return mod.classical_fl()
    return mod.hierarchical_fl(groups=("west", "east"), dataset_groups=_GROUPS)


def _run_pair(topology, trainers, init, rounds=2, n=4, **kw):
    """The same job through both packages; the port's on the CPU."""
    out = []
    for tag_mod, top, exp, rt, trainer in (
        (ttag, ttop, texp, trt, trainers[0]),
        (jtag, jtop, jexp, jrt, trainers[1]),
    ):
        job = exp.JobSpec(
            tag=_tags(top, topology),
            datasets=tuple(tag_mod.DatasetSpec(name=f"d{i}") for i in range(n)),
            hyperparams={"rounds": rounds, "init_weights": init},
        )
        extra = {"device": "cpu"} if rt is trt else {}
        res = rt.run_job(job, timeout=60, program_overrides={"trainer": trainer},
                         **extra, **kw)
        assert not res.errors, res.errors
        out.append(res)
    return out


def _fold_metrics(res):
    return {
        wid: [m for m in prog.metrics if "agg_folds" in m]
        for wid, prog in res.programs.items()
    }


@pytest.mark.parametrize("topology", ["classical", "hierarchical"])
def test_add_one_jobs_byte_equal(topology):
    ours, ref = _run_pair(topology, (AddOneTrainer, JaxAddOneTrainer), W0)
    w = tree_to_numpy(ours.global_weights())
    ref_w = ref.global_weights()
    for k in ("w", "b"):
        assert w[k].dtype == np.float32
        assert w[k].tobytes() == np.asarray(ref_w[k]).tobytes()
    np.testing.assert_array_equal(w["w"], W0["w"] + 2.0)
    assert ours.channel_bytes == ref.channel_bytes
    assert _fold_metrics(ours) == _fold_metrics(ref)
    assert any(_fold_metrics(ours).values())


@pytest.mark.parametrize("fused", [False, True])
def test_fused_aggregation_hyperparam_is_accepted(fused):
    """Jobs written for the JAX package still run: ``fused_aggregation`` is
    accepted and changes nothing (the port dispatches by device only)."""
    job = texp.JobSpec(
        tag=ttop.classical_fl(),
        datasets=tuple(ttag.DatasetSpec(name=f"d{i}") for i in range(3)),
        hyperparams={"rounds": 2, "init_weights": W0, "fused_aggregation": fused},
    )
    res = trt.run_job(job, device="cpu", timeout=60,
                      program_overrides={"trainer": AddOneTrainer})
    assert not res.errors, res.errors
    w = tree_to_numpy(res.global_weights())["w"]
    assert w.tobytes() == (W0["w"] + 2.0).tobytes()


def test_no_op_trainers_keep_weights_on_tensors():
    ours, ref = _run_pair("classical", (Trainer, JaxTrainer), W0, n=3)
    w = ours.global_weights()
    assert isinstance(w["w"], torch.Tensor) and w["w"].device.type == "cpu"
    assert tree_to_numpy(w)["w"].tobytes() == np.asarray(ref.global_weights()["w"]).tobytes()
    assert ours.channel_bytes == ref.channel_bytes


def test_seeded_sgd_job_agrees_within_tolerance():
    ours, ref = _run_pair(
        "classical", (SeededSGDTrainer, JaxSGDTrainer), SGD_W0, rounds=3
    )
    w = tree_to_numpy(ours.global_weights())
    ref_w = ref.global_weights()
    for k in ("w", "b"):
        np.testing.assert_allclose(w[k], np.asarray(ref_w[k]), rtol=SGD_RTOL, atol=SGD_ATOL)
    # training moved the weights: the comparison is not of two no-ops
    assert not np.allclose(w["w"], SGD_W0["w"], atol=1e-3)
    assert ours.channel_bytes == ref.channel_bytes


def test_late_arrival_sync_job_matches_events():
    """Arrival schedules run through the event engine in sync mode: the
    lifecycle events and virtual clocks match the JAX package's."""
    policy_kw = {"arrivals": {"trainer-1": 2.5}}
    results = []
    for rt, trainer, top, tag_mod, exp in (
        (trt, AddOneTrainer, ttop, ttag, texp),
        (jrt, JaxAddOneTrainer, jtop, jtag, jexp),
    ):
        job = exp.JobSpec(
            tag=top.classical_fl(),
            datasets=tuple(tag_mod.DatasetSpec(name=f"d{i}") for i in range(3)),
            hyperparams={"rounds": 2, "init_weights": W0},
        )
        extra = {"device": "cpu"} if rt is trt else {}
        res = rt.run_job(job, timeout=60, program_overrides={"trainer": trainer},
                         policy=rt.RuntimePolicy(**policy_kw), **extra)
        assert not res.errors, res.errors
        agg = next(p for w, p in res.programs.items() if w.startswith("global"))
        results.append((res.events, res.channel_bytes, agg.ctx.now("param-channel"),
                        np.asarray(tree_to_numpy(res.global_weights())["w"]).tobytes()))
    assert results[0] == results[1]


def test_mqtt_links_match_virtual_clocks():
    link = {"bandwidth": 1000.0, "latency": 0.25}
    results = []
    for rt, trainer, top, tag_mod, exp, chmod in (
        (trt, AddOneTrainer, ttop, ttag, texp, tch),
        (jrt, JaxAddOneTrainer, jtop, jtag, jexp, jch),
    ):
        job = exp.JobSpec(
            tag=top.classical_fl(backend="mqtt-emu"),
            datasets=tuple(tag_mod.DatasetSpec(name=f"d{i}") for i in range(3)),
            hyperparams={"rounds": 2, "init_weights": W0},
        )
        links = {("param-channel", f"trainer-{i}"): chmod.LinkModel(**link) for i in range(3)}
        extra = {"device": "cpu"} if rt is trt else {}
        res = rt.run_job(job, timeout=60, program_overrides={"trainer": trainer},
                         link_models=links, **extra)
        assert not res.errors, res.errors
        clocks = sorted((w, p.ctx.now("param-channel")) for w, p in res.programs.items())
        results.append((clocks, res.channel_bytes))
    assert results[0] == results[1]


# ------------------------------------------------------------------ #
# what the port does not run yet raises instead of running otherwise
# ------------------------------------------------------------------ #
def _port_job(**hp):
    return texp.JobSpec(
        tag=ttop.classical_fl(),
        datasets=(ttag.DatasetSpec(name="d0"),),
        hyperparams={"rounds": 1, "init_weights": W0, **hp},
    )


def test_policy_lowering_not_ported_raises():
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        trt.run_job(_port_job(), device="cpu", policy=trt.RuntimePolicy(mode="async"))


def test_reduce_plan_not_ported_raises():
    runtime = trt.JobRuntime(_port_job(reduce_plan=1), device="cpu")
    root = next(w for w in runtime.workers if w.role == "global-aggregator")
    prog = runtime._build_program(root)
    prog.pre_run()
    with pytest.raises(NotImplementedError, match="hub reduce plane .* Queue 1 item 6"):
        prog.distribute()


def test_policy_validation_matches_reference():
    for kw in ({"mode": "bogus"}, {"rejoins": {"trainer-0": 1.0}},
               {"dropouts": {"trainer-0": 2.0}, "rejoins": {"trainer-0": 1.0}}):
        with pytest.raises(ValueError):
            trt.RuntimePolicy(**kw)
        with pytest.raises(ValueError):
            jrt.RuntimePolicy(**kw)
