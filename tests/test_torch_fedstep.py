"""The port's mesh lowering, DP and federated step (``repro_torch.core.
mesh_lowering``, ``fl.privacy``, ``fl.fedstep``) against the JAX package's,
on the CPU.

Inputs are made with numpy from fixed seeds and fed to both sides. Where
the JAX side needs more than one client, it runs in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` on a ``(4,)`` or a
``(2, 2)`` mesh (one process per test module), and the port runs the same
clients as virtual clients in turn. Tolerances:

* plans: equal, field by field, for every template.
* ``stage_reduce_mean``: float32 and float16/bfloat16 wires within 1e-6
  (the sums of 2 or 4 float32 terms in another order: a few ulp of values
  of order 1); int8 within 1 code step (``absmax / 127``), since a scale an
  ulp away can move a value across a rounding boundary.
* fed steps on the linear least-squares model of ``TestFedStep``: loss,
  ``delta_norm`` and parameters within rtol 2e-5, atol 1e-6 per step (f32
  products summed in other orders, carried through up to 10 steps);
  the bfloat16 cross-pod wire within 2**-7 relative of the delta (one
  bfloat16 rounding may land on the other side) -- checked on the
  parameters after one step, before FedAdam's normalization amplifies it;
  participants equal.
* the DP clip (no noise) within 1e-6; with noise, the JAX package's draws
  are injected and the step held as above; the port's own draws are held
  by their spread.
"""
import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro.core import mesh_lowering as jml
from repro.core import topologies as jtop
from repro.fl import fedstep as jfs
from repro.fl import privacy as jdp
from repro.fl.strategies import get_strategy as jget_strategy
from repro_torch.core import mesh_lowering as tml
from repro_torch.core import topologies as ttop
from repro_torch.core.tag import TagError
from repro_torch.fl import fedstep as tfs
from repro_torch.fl import privacy as tdp
from repro_torch.fl.strategies import get_strategy as tget_strategy

ROOT = Path(__file__).resolve().parents[1]
STEP_RTOL, STEP_ATOL = 2e-5, 1e-6
TEMPLATES = ["classical_fl", "hierarchical_fl", "coordinated_fl", "hybrid_fl",
             "distributed_fl", "vertical_fl", "gossip_fl"]
W_TRUE = np.array([[1.0], [-2.0], [0.5]], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this file's torch work: the suite runs six
    files at once on the CPU, and eight threads in each slowed a 4 s
    launcher case to 240 s."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _plan_fields(plan):
    return (plan.tag_name, tuple(dataclasses.astuple(s) for s in plan.stages))


# ---------------------------------------------------------------------- #
# TestMeshLowering
# ---------------------------------------------------------------------- #
class TestMeshLowering:
    def test_classical_plan_single_stage(self):
        plan = tml.lower_tag_to_mesh(ttop.classical_fl(), ("data",))
        assert len(plan.stages) == 1
        assert plan.stages[0].axes == ("data",)

    def test_hierarchical_plan_two_stage(self):
        plan = tml.lower_tag_to_mesh(ttop.hierarchical_fl(), ("data", "pod"))
        assert [s.axes for s in plan.stages] == [("data",), ("pod",)]
        assert plan.stages[0].channel == "param-channel"
        assert plan.stages[1].channel == "global-channel"

    def test_distributed_plan(self):
        plan = tml.lower_tag_to_mesh(ttop.distributed_fl(), ("data",))
        assert plan.stages[0].channel == "ring-channel"

    def test_wire_dtype_carried(self):
        plan = tml.lower_tag_to_mesh(ttop.hierarchical_fl(agg_wire_dtype="int8"), ("data", "pod"))
        assert plan.stages[1].wire_dtype == "int8"

    @pytest.mark.parametrize("axes", [("data",), ("data", "pod"), ("data", "pod", "slice")])
    @pytest.mark.parametrize("template", TEMPLATES)
    def test_plans_equal_for_every_template(self, template, axes):
        """Equal plans (or the same refusal) for each template, on one, two
        and three client axes, with a per-stage strategy map."""
        jtag, ttag = getattr(jtop, template)(), getattr(ttop, template)()
        strategies = {"global-channel": "fedadam", "param-channel": "fedavg"}
        try:
            want = _plan_fields(jml.lower_tag_to_mesh(jtag, axes, strategies))
        except Exception as e:  # the reference refuses: the port must too
            with pytest.raises(TagError, match=re.escape(str(e))):
                tml.lower_tag_to_mesh(ttag, axes, strategies)
            return
        got = _plan_fields(tml.lower_tag_to_mesh(ttag, axes, strategies))
        assert got == want
        jplan = jml.lower_tag_to_mesh(jtag, axes)
        assert tml.lower_tag_to_mesh(ttag, axes).all_axes == jplan.all_axes

    @pytest.mark.parametrize("wire", ["f32", "bf16", "f16", "int8"])
    def test_stage_reduce_mean_wire_dtypes_one_client(self, wire):
        """The JAX package's case: one client, the mean is the value
        through the wire (its tolerance), and equal to the reference's."""
        mesh = compat.make_mesh((1,), ("data",))
        jstage = jml.AggregationStage(channel="c", axes=("data",), wire_dtype=wire)
        x = np.array([1.0, -2.0, 3.0], np.float32)
        want = compat.shard_map(
            lambda t: jml.stage_reduce_mean(t, jstage), mesh=mesh,
            in_specs=(jax.sharding.PartitionSpec(),),
            out_specs=jax.sharding.PartitionSpec(),
        )({"w": jnp.asarray(x)})
        tstage = tml.AggregationStage(channel="c", axes=("data",), wire_dtype=wire)
        got = tml.stage_reduce_mean([{"w": torch.from_numpy(x)}], tstage)
        tol = 0.05 if wire == "int8" else 1e-2
        np.testing.assert_allclose(_np(got["w"]), x, atol=tol)
        step = np.abs(x).max() / 127 if wire == "int8" else 0.0
        np.testing.assert_allclose(_np(got["w"]), np.asarray(want["w"]), atol=step + 1e-6)

    def test_unknown_wire_dtype_raises(self):
        stage = tml.AggregationStage(channel="c", axes=("data",), wire_dtype="fp4")
        with pytest.raises(ValueError, match="unknown wire dtype"):
            tml.stage_reduce_mean([{"w": torch.ones(2)}], stage)


# ---------------------------------------------------------------------- #
# the JAX side on 4 host devices, in a subprocess
# ---------------------------------------------------------------------- #
_JAX_MULTI = r'''
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.core import mesh_lowering as ml
from repro.core.topologies import classical_fl, hierarchical_fl
from repro.fl import fedstep as fs
from repro.fl.privacy import DPConfig
from repro.fl.strategies import get_strategy

inp = dict(np.load(sys.argv[1]))
spec = json.loads(sys.argv[3])
out = {}
assert len(jax.devices()) == 4

# stage_reduce_mean over 4 clients: a (4,) mesh and a (2, 2) mesh
for mesh_shape, names in (((4,), ("data",)), ((2, 2), ("data", "pod"))):
    mesh = compat.make_mesh(mesh_shape, names)
    for wire in spec["wires"]:
        for weighted in (False, True):
            stage = ml.AggregationStage(channel="c", axes=names, wire_dtype=wire)
            def f(x, w, stage=stage, weighted=weighted):
                t = {"a": x[0, 0], "b": x[0, 0][:3] * 2.0}
                return ml.stage_reduce_mean(t, stage, weight=w[0] if weighted else None)
            r = compat.shard_map(f, mesh=mesh, in_specs=(P(names), P(names)),
                                 out_specs=P())(jnp.asarray(inp["x"]), jnp.asarray(inp["w"]))
            for k in r:
                out[f"stage/{len(names)}/{wire}/{int(weighted)}/{k}"] = np.asarray(r[k])
    # apply_plan of a two-stage plan
    if len(names) == 2:
        plan = ml.lower_tag_to_mesh(hierarchical_fl(agg_wire_dtype="bf16"), ("data", "pod"))
        r = compat.shard_map(lambda x: ml.apply_plan({"a": x[0, 0]}, plan), mesh=mesh,
                             in_specs=(P(names),), out_specs=P())(jnp.asarray(inp["x"]))
        out["apply_plan/a"] = np.asarray(r["a"])

# fed steps: the linear least-squares model of TestFedStep
def loss_fn(p, batch, rng):
    return jnp.mean((batch["x"] @ p["w"] + p["b"] - batch["y"]) ** 2)

for case in spec["steps"]:
    names = tuple(case["axes"])
    mesh = compat.make_mesh((4,) if len(names) == 1 else (2, 2), names)
    tag = (classical_fl() if len(names) == 1
           else hierarchical_fl(agg_wire_dtype=case["wire"]))
    plan = ml.lower_tag_to_mesh(tag, names)
    dp = DPConfig(**case["dp"]) if case["dp"] else None
    cfg = fs.FedStepConfig(local_steps=case["local_steps"], local_lr=0.05, dp=dp,
                           exchange=case["exchange"], participation=case["participation"])
    strat = get_strategy(case["strategy"])
    step = jax.jit(fs.make_fl_train_step(loss_fn, strat, plan, mesh, cfg))
    params = {"w": jnp.zeros((3, 1)), "b": jnp.zeros((1,))}
    state = fs.init_server_state(strat, plan, params)
    batch = {"x": jnp.asarray(inp["bx"]), "y": jnp.asarray(inp["by"])}
    rng = jax.random.key(0)
    name = case["name"]
    for i in range(case["rounds"]):
        r_i = jax.random.fold_in(rng, i)
        # the draws each client makes inside the step (client index over
        # the plan's axes, the last fastest)
        for c in range(4):
            rc = jax.random.fold_in(r_i, c)
            out[f"{name}/made_it/{i}/{c}"] = np.asarray(
                jax.random.bernoulli(jax.random.fold_in(rc, 0x5EED), cfg.participation),
                np.float32)
            ks = jax.random.split(rc, 2)
            for j, (k, shape) in enumerate(zip(ks, [(1,), (3, 1)])):  # leaves b, w
                out[f"{name}/noise/{i}/{c}/{j}"] = np.asarray(
                    jax.random.normal(k, shape, jnp.float32))
        params, state, m = step(params, state, batch, r_i)
        for k in m:
            out[f"{name}/metric/{i}/{k}"] = np.asarray(m[k])
        for k in params:
            out[f"{name}/param/{i}/{k}"] = np.asarray(params[k])
np.savez(sys.argv[2], **out)
'''

WIRES = ["f32", "bf16", "f16", "int8"]
STEP_CASES = [
    dict(name="classical_fedavg", axes=["data"], wire="f32", strategy="fedavg", local_steps=2,
         exchange="delta", participation=1.0, dp=None, rounds=10),
    dict(name="classical_fedadam", axes=["data"], wire="f32", strategy="fedadam", local_steps=2,
         exchange="delta", participation=1.0, dp=None, rounds=10),
    dict(name="classical_grad", axes=["data"], wire="f32", strategy="fedavg", local_steps=1,
         exchange="grad", participation=1.0, dp=None, rounds=5),
    dict(name="hier_f32", axes=["data", "pod"], wire="f32", strategy="fedadam", local_steps=2,
         exchange="delta", participation=1.0, dp=None, rounds=10),
    dict(name="hier_bf16", axes=["data", "pod"], wire="bf16", strategy="fedavg", local_steps=2,
         exchange="delta", participation=1.0, dp=None, rounds=1),
    dict(name="participation", axes=["data"], wire="f32", strategy="fedavg", local_steps=1,
         exchange="delta", participation=0.5, dp=None, rounds=10),
    dict(name="dp_clip", axes=["data"], wire="f32", strategy="fedavg", local_steps=2,
         exchange="delta", participation=1.0, dp=dict(clip_norm=0.05, noise_multiplier=0.0),
         rounds=5),
    dict(name="dp_noise", axes=["data", "pod"], wire="f32", strategy="fedavg", local_steps=2,
         exchange="delta", participation=0.75, dp=dict(clip_norm=0.5, noise_multiplier=0.3),
         rounds=5),
]


def _inputs():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(4, 1, 6)).astype(np.float32)  # one (1, 6) shard per client
    x[2] *= 40.0  # a client of another magnitude
    w = rng.uniform(0.5, 3.0, size=(4, 1)).astype(np.float32)
    bx = rng.normal(size=(16, 3)).astype(np.float32)
    by = (bx @ W_TRUE + 0.3).astype(np.float32)
    return {"x": x, "w": w, "bx": bx, "by": by}


@pytest.fixture(scope="module")
def jax_multi(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_multi")
    inp = _inputs()
    np.savez(d / "in.npz", **inp)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
               "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")
    spec = json.dumps({"wires": WIRES, "steps": STEP_CASES})
    proc = subprocess.run([sys.executable, "-c", _JAX_MULTI, str(d / "in.npz"),
                           str(d / "out.npz"), spec],
                          capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return inp, dict(np.load(d / "out.npz"))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("n_axes", [1, 2])
def test_stage_reduce_mean_over_four_clients(jax_multi, n_axes, wire, weighted):
    """4 clients on a (4,) mesh or a (2, 2) mesh (one stage over both
    axes), against ``stage_reduce_mean`` inside ``shard_map``."""
    inp, out = jax_multi
    axes = ("data",) if n_axes == 1 else ("data", "pod")
    stage = tml.AggregationStage(channel="c", axes=axes, wire_dtype=wire)
    trees = [{"a": torch.from_numpy(inp["x"][c, 0]), "b": torch.from_numpy(inp["x"][c, 0][:3] * 2.0)}
             for c in range(4)]
    weights = [torch.from_numpy(inp["w"][c]) for c in range(4)] if weighted else None
    got = tml.stage_reduce_mean(trees, stage, weights)
    for k in ("a", "b"):
        want = out[f"stage/{n_axes}/{wire}/{int(weighted)}/{k}"]
        # one int8 code step of the largest member, scaled as the mean scales it
        scale = max(float(np.abs(_np(t[k]) * (_np(weights[c]) if weighted else 1)).max())
                    for c, t in enumerate(trees)) / 127
        tol = scale if wire == "int8" else 1e-6 * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(_np(got[k]), want, rtol=0, atol=tol)
        assert got[k].dtype == torch.float32


def test_apply_plan_two_stages_over_four_clients(jax_multi):
    """``hierarchical_fl`` (bf16 cross-pod wire) on the (2, 2) mesh: the
    mean over ``data`` within each pod, then over ``pod`` in bf16."""
    inp, out = jax_multi
    plan = tml.lower_tag_to_mesh(ttop.hierarchical_fl(agg_wire_dtype="bf16"), ("data", "pod"))
    sizes = {"data": 2, "pod": 2}
    seen = []

    def member(coords):
        c = coords["data"] * 2 + coords["pod"]
        seen.append(c)
        return {"a": torch.from_numpy(inp["x"][c, 0])}

    got = tml.apply_plan(member, plan, sizes)
    assert seen == [0, 2, 1, 3]  # pod by pod, data within a pod; linear index d*2 + p
    np.testing.assert_allclose(_np(got["a"]), out["apply_plan/a"], rtol=0, atol=1e-6)


# ---------------------------------------------------------------------- #
# fed steps over 4 clients, against the JAX package's jitted step
# ---------------------------------------------------------------------- #
def _loss(p, batch, gen):
    return torch.mean((batch["x"] @ p["w"] + p["b"] - batch["y"]) ** 2)


def _run_port_case(case, inp, out, inject=True):
    names = tuple(case["axes"])
    mesh = tml.Mesh(tuple((a, 4 if len(names) == 1 else 2) for a in names))
    tag = (ttop.classical_fl() if len(names) == 1
           else ttop.hierarchical_fl(agg_wire_dtype=case["wire"]))
    plan = tml.lower_tag_to_mesh(tag, names)
    dp = tdp.DPConfig(**case["dp"]) if case["dp"] else None
    cfg = tfs.FedStepConfig(local_steps=case["local_steps"], local_lr=0.05, dp=dp,
                            exchange=case["exchange"], participation=case["participation"])
    strat = tget_strategy(case["strategy"])
    step = tfs.make_fl_train_step(_loss, strat, plan, mesh, cfg)
    params = {"w": torch.zeros((3, 1)), "b": torch.zeros((1,))}
    state = tfs.init_server_state(strat, plan, params)
    batch = {"x": inp["bx"], "y": inp["by"]}
    name = case["name"]
    history = []
    for i in range(case["rounds"]):
        kw = {}
        if inject:
            kw["made_it"] = [float(out[f"{name}/made_it/{i}/{c}"]) for c in range(4)]
            kw["noise"] = [[out[f"{name}/noise/{i}/{c}/{j}"] for j in range(2)] for c in range(4)]
        params, state, m = step(params, state, batch, i, **kw)
        history.append((m, params))
    return history


@pytest.mark.parametrize("case", STEP_CASES, ids=lambda c: c["name"])
def test_fed_step_over_four_clients_matches_reference(jax_multi, case):
    """``TestFedStep`` / ``TestFedStepParticipation`` at N = 4: FedAvg and
    FedAdam, the gradient exchange, a two-stage plan with f32 and bf16
    cross-pod wires, partial participation and DP with the reference's
    draws injected; every round's metrics and parameters."""
    inp, out = jax_multi
    name = case["name"]
    for i, (m, params) in enumerate(_run_port_case(case, inp, out)):
        assert float(m["participants"]) == float(out[f"{name}/metric/{i}/participants"])
        if case["participation"] < 1.0:
            drawn = sum(float(out[f"{name}/made_it/{i}/{c}"]) for c in range(4))
            assert float(m["participants"]) == drawn  # the injected draws are the step's
        for k in ("loss", "delta_norm"):
            np.testing.assert_allclose(float(m[k]), out[f"{name}/metric/{i}/{k}"],
                                       rtol=STEP_RTOL, atol=STEP_ATOL, err_msg=f"round {i} {k}")
        for k in ("w", "b"):
            want = out[f"{name}/param/{i}/{k}"]
            if case["wire"] == "bf16":
                # one bf16 rounding of a delta may land on the other side
                tol = 2.0**-7 * float(np.abs(want).max())
                np.testing.assert_allclose(_np(params[k]), want, rtol=0, atol=tol)
            else:
                np.testing.assert_allclose(_np(params[k]), want, rtol=STEP_RTOL, atol=STEP_ATOL,
                                           err_msg=f"round {i} {k}")
    if case["strategy"] == "fedavg" and case["participation"] == 1.0 and case["rounds"] >= 5:
        assert float(m["loss"]) < float(out[f"{name}/metric/0/loss"])


def test_fed_step_own_draws_participation_spread(jax_multi):
    """The port's own Bernoulli draws (no injection): 40 rounds of 4
    clients at p = 0.5 give a participant count within 4 sigma of 80, and
    the step renormalizes (a round with no participant is a no-op)."""
    inp, out = jax_multi
    case = dict(STEP_CASES[5], rounds=40)
    counts = [float(m["participants"]) for m, _ in _run_port_case(case, inp, out, inject=False)]
    assert abs(sum(counts) - 80) < 4 * np.sqrt(160 * 0.25)
    assert min(counts) >= 0 and max(counts) <= 4


# ---------------------------------------------------------------------- #
# TestFedStep at one client: the JAX package's cases, side by side
# ---------------------------------------------------------------------- #
def _one_client(wire="f32", dp=None, local_steps=2, strategy="fedavg", participation=1.0):
    """Both steps on the JAX test's setup: 1-client mesh, 8 x 3 batch."""
    jmesh = compat.make_mesh((1,), ("data",))
    jplan = jml.lower_tag_to_mesh(jtop.classical_fl(wire_dtype=wire), ("data",))
    jstrat = jget_strategy(strategy)

    def jloss(p, batch, rng):
        return jnp.mean((batch["x"] @ p["w"] - batch["y"]) ** 2)

    jcfg = jfs.FedStepConfig(local_steps=local_steps, local_lr=0.05,
                             dp=jdp.DPConfig(**dp) if dp else None, participation=participation)
    jstep = jax.jit(jfs.make_fl_train_step(jloss, jstrat, jplan, jmesh, jcfg))
    x = np.random.default_rng(3).normal(size=(8, 3)).astype(np.float32)
    batch = {"x": x, "y": x @ W_TRUE}

    tplan = tml.lower_tag_to_mesh(ttop.classical_fl(wire_dtype=wire), ("data",))
    tstrat = tget_strategy(strategy)

    def tloss(p, b, gen):
        return torch.mean((b["x"] @ p["w"] - b["y"]) ** 2)

    tcfg = tfs.FedStepConfig(local_steps=local_steps, local_lr=0.05,
                             dp=tdp.DPConfig(**dp) if dp else None, participation=participation)
    tstep = tfs.make_fl_train_step(tloss, tstrat, tplan, tml.Mesh((("data", 1),)), tcfg)
    jp = {"w": jnp.zeros((3, 1))}
    tp = {"w": torch.zeros((3, 1))}
    return (jstep, jfs.init_server_state(jstrat, jplan, jp), jp,
            tstep, tfs.init_server_state(tstrat, tplan, tp), tp, batch)


def _run_both(rounds, **kw):
    jstep, js, jp, tstep, ts, tp, batch = _one_client(**kw)
    rng = jax.random.key(0)
    rows = []
    for i in range(rounds):
        r = jax.random.fold_in(rng, i)
        rc = jax.random.fold_in(r, 0)
        inject = {}
        if kw.get("participation", 1.0) < 1.0:
            inject["made_it"] = [float(jax.random.bernoulli(jax.random.fold_in(rc, 0x5EED),
                                                            kw["participation"]))]
        if kw.get("dp") and kw["dp"].get("noise_multiplier", 0) > 0:
            inject["noise"] = [[np.asarray(jax.random.normal(jax.random.split(rc, 1)[0], (3, 1)))]]
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in batch.items()}, r)
        tp, ts, tm = tstep(tp, ts, batch, i, **inject)
        rows.append((jm, jp, tm, tp))
    return rows


def _assert_rows(rows, rtol=STEP_RTOL, atol=STEP_ATOL):
    for i, (jm, jp, tm, tp) in enumerate(rows):
        for k in ("loss", "delta_norm", "participants"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=rtol, atol=atol,
                                       err_msg=f"round {i} {k}")
        np.testing.assert_allclose(_np(tp["w"]), np.asarray(jp["w"]), rtol=rtol, atol=atol,
                                   err_msg=f"round {i} w")


class TestFedStep:
    def test_loss_decreases(self):
        rows = _run_both(20)
        _assert_rows(rows)
        assert float(rows[-1][2]["loss"]) < float(rows[0][2]["loss"]) * 0.5

    @pytest.mark.parametrize("wire", ["bf16", "int8"])
    def test_wire_dtypes_still_converge(self, wire):
        rows = _run_both(20, wire=wire)
        assert float(rows[-1][2]["loss"]) < 1.0
        # one client: bf16 rounds a delta the same way on both sides; int8
        # moves by at most a code step where the scale is an ulp away
        tol = 1e-5 if wire == "bf16" else 5e-3
        _assert_rows(rows[:5], rtol=tol, atol=tol)

    def test_dp_clip_and_noise_runs(self):
        rows = _run_both(3, dp=dict(clip_norm=0.5, noise_multiplier=0.01))
        assert np.isfinite(float(rows[0][2]["loss"]))
        _assert_rows(rows)

    def test_dp_clip_is_exact(self):
        """Clipping alone (no noise) to a norm below the delta's."""
        rows = _run_both(5, dp=dict(clip_norm=0.05, noise_multiplier=0.0))
        _assert_rows(rows)
        assert abs(float(rows[0][2]["delta_norm"]) - 0.05) < 1e-6

    def test_fedadam_server(self):
        rows = _run_both(25, strategy="fedadam")
        assert float(rows[-1][2]["loss"]) < 2.0
        _assert_rows(rows)


class TestFedStepParticipation:
    def test_partial_participation_renormalizes(self):
        """``tests/test_async_runtime.py::TestFedStepParticipation``: one
        client at p = 0.75 with the reference's Bernoulli draws injected;
        either it participates (the full mean) or the round is a no-op."""
        rows = _run_both(30, local_steps=1, participation=0.75)
        _assert_rows(rows)
        participated = sum(float(r[2]["participants"]) for r in rows)
        assert 0 < participated < 30
        assert float(rows[-1][2]["loss"]) < 1.0


# ---------------------------------------------------------------------- #
# DP alone
# ---------------------------------------------------------------------- #
def _dp_tree(rng):
    return {"a": rng.normal(size=(5, 4)).astype(np.float32), "b": rng.normal(size=(7,)).astype(np.float32)}


@pytest.mark.parametrize("clip", [0.1, 1.0, 100.0])
def test_clip_by_global_norm_matches_reference(clip):
    tree = _dp_tree(np.random.default_rng(1))
    want, wnorm = jdp.clip_by_global_norm({k: jnp.asarray(v) for k, v in tree.items()}, clip)
    got, gnorm = tdp.clip_by_global_norm({k: torch.from_numpy(v) for k, v in tree.items()}, clip)
    np.testing.assert_allclose(float(gnorm), float(wnorm), rtol=1e-6)
    for k in tree:
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), rtol=1e-6, atol=1e-7)


def test_clip_and_noise_with_injected_noise_matches_reference():
    tree = _dp_tree(np.random.default_rng(2))
    cfg_j, cfg_t = jdp.DPConfig(0.5, 0.8), tdp.DPConfig(0.5, 0.8)
    key = jax.random.key(5)
    want = jdp.clip_and_noise({k: jnp.asarray(v) for k, v in tree.items()}, cfg_j, key, 3)
    keys = jax.random.split(key, 2)
    noise = [np.asarray(jax.random.normal(k, tree[n].shape, jnp.float32))
             for k, n in zip(keys, sorted(tree))]
    got = tdp.clip_and_noise({k: torch.from_numpy(v) for k, v in tree.items()}, cfg_t,
                             num_clients=3, noise=noise)
    for k in tree:
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), rtol=1e-6, atol=1e-6)


def test_clip_and_noise_own_draws_have_the_stated_spread():
    """sigma = noise_multiplier * clip / n: the port's draws (a seeded
    torch generator) have that standard deviation within 2%."""
    cfg = tdp.DPConfig(clip_norm=1.0, noise_multiplier=2.0)
    zeros = {"w": torch.zeros(200_000)}
    gen = torch.Generator().manual_seed(0)
    got = tdp.clip_and_noise(zeros, cfg, gen, num_clients=4)["w"]
    assert abs(float(got.std()) - 0.5) < 0.01 and abs(float(got.mean())) < 0.01
    assert tdp.clip_and_noise(zeros, cfg, torch.Generator().manual_seed(0), 4)["w"].equal(got)


@pytest.mark.parametrize("axes", [("data",), ("data", "pod")])
def test_step_frees_the_old_trees_without_the_garbage_collector(axes):
    """With the collector off, the parameters passed in and every client's
    copy are freed once the caller drops them: the step leaves no reference
    cycle behind (one held the old parameters of a 3B model round after
    round on the card until a full collection)."""
    import gc
    import weakref

    mesh = tml.Mesh(tuple((a, 2) for a in axes))
    tag = ttop.classical_fl() if len(axes) == 1 else ttop.hierarchical_fl()
    plan = tml.lower_tag_to_mesh(tag, axes)
    strat = tget_strategy("fedadam")
    step = tfs.make_fl_train_step(_loss, strat, plan, mesh, tfs.FedStepConfig(local_steps=2))
    params = {"w": torch.zeros((3, 1)), "b": torch.zeros((1,))}
    state = tfs.init_server_state(strat, plan, params)
    x = np.random.default_rng(0).normal(size=(8, 3)).astype(np.float32)
    batch = {"x": x, "y": x @ W_TRUE}
    gc.collect()
    gc.disable()
    try:
        old = weakref.ref(params["w"])
        params, state, _ = step(params, state, batch, 0)
        assert old() is None
        old = weakref.ref(params["w"])
        params, state, _ = step(params, state, batch, 1)
        assert old() is None
    finally:
        gc.enable()


# ---------------------------------------------------------------------- #
# the one-client step: donated, each gradient applied as it is made
# ---------------------------------------------------------------------- #
ONE = (("data", 1), ("model", 1))
# name -> (arch, config changes, local steps): the reduced configs
DONATED = {
    "dense_tied": ("qwen2_5_3b", dict(fl_axes=("pod",)), 2),
    "moe": ("qwen3_moe_235b_a22b", {}, 2),
    "llama4_remat": ("llama4_maverick_400b_a17b", {}, 1),
    "llama4_stacked_period": ("llama4_maverick_400b_a17b", dict(scan_layers=True, num_layers=2),
                              1),
    "moe_stacked_remat": ("qwen3_moe_235b_a22b", dict(scan_layers=True, remat=True), 2),
    "llama4_bf16": ("llama4_maverick_400b_a17b", dict(param_dtype="bfloat16"), 1),
}


def _donated_case(name):
    import _torch_tp_programs as prog
    from repro_torch.configs import get_config

    arch, changes, k = DONATED[name]
    cfg = dataclasses.replace(get_config(arch, reduced=True), **changes)
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (8, 16)).astype(np.int32)
    return cfg, prog, {"tokens": tokens}, dict(local_steps=k, local_lr=0.05)


@pytest.mark.parametrize("name", list(DONATED))
def test_donated_step_is_byte_equal_to_the_functional_step(name):
    """``build_train_step``'s one-client step takes the parameters it is
    given over: each leaf is stepped in place as soon as autograd has made
    its gradient (``update_leaf``), and ``delta_norm`` is summed leaf by
    leaf as it is stepped. Its new leaves, loss and ``delta_norm`` are the
    functional step's (every gradient at once, new tensors, the deltas
    summed at the end), bit for bit: dense with tied embeddings, MoE, the
    remat Llama4 period, a stack of one period, a stack of MoE groups under
    remat, bfloat16, one and two local steps; the returned leaves are the
    given tensors. In the MoE configs no more than one expert leaf's
    gradient is alive at once where the expert leaves are not a stack of
    several groups."""
    cfg, prog, batch, fed = _donated_case(name)
    res = prog.streamed_step_rank(None, cfg, ONE, 3, batch, 7, fed)
    assert all(res["equal"]) and res["loss_equal"] and res["norm_equal"]
    assert res["in_place"]
    if cfg.is_moe:
        # the expert leaves: one of each a MoE layer, or a stack of each
        leaves = 1 if cfg.scan_layers else cfg.num_layers // cfg.moe_every
        assert res["expert_updates"] == 3 * leaves * fed["local_steps"]
        if not cfg.scan_layers or cfg.num_layers == cfg.moe_every:
            assert res["most_alive"] == 1


@pytest.mark.parametrize("name", ["moe", "llama4_remat", "llama4_stacked_period"])
def test_sliced_expert_backward_is_byte_equal_in_one_process(name, monkeypatch):
    """One process on whole expert leaves slices the experts' backward by
    the card's memory (``tp.memory_share``): forced to one expert a slice,
    the step is the unsliced functional step's, bit for bit."""
    from repro_torch.models import moe

    cfg, prog, batch, fed = _donated_case(name)
    taken = []
    backward_experts = moe._backward_experts
    monkeypatch.setattr(moe, "_backward_experts",
                        lambda *a: taken.append(backward_experts(*a)) or taken[-1])
    res = prog.streamed_step_rank(None, cfg, ONE, 3, batch, 7, fed, share=1)
    assert all(res["equal"]) and res["loss_equal"] and res["norm_equal"]
    # the built step's backward products, one expert a slice, then the
    # functional step's (no bound: all of them at once)
    half = len(taken) // 2
    assert half and set(taken[:half]) == {1} and set(taken[half:]) == {cfg.num_experts}
