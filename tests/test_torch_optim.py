"""The port's local optimizers and schedules (``repro_torch.optim``)
against the JAX package's (``repro.optim``), eagerly on the CPU, over 5
steps from the same parameters and gradients (numpy, seeded), on float32
and bfloat16 parameters.

Tolerances: plain SGD byte-equal (one product in the gradient's promoted
dtype); momentum and AdamW within rtol 1e-6 on float32 (``pow`` and the
products may round an ulp apart; roots are correctly rounded on both
sides) and, on bfloat16 parameters, within one bfloat16 ulp (2**-8
relative) of the JAX value; the schedules within rtol 1e-6 (``cos``) at
step 0, the warm-up edge, mid-decay and past the end.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as jopt
from repro.optim import schedules as jsch
from repro_torch import optim as topt
from repro_torch.convert import optimizer_state_from_numpy

STEPS = 5


def _np(x):
    x = np.asarray(x) if not isinstance(x, torch.Tensor) else (
        x.float().numpy() if x.is_floating_point() else x.numpy())
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _tree(rng, dtype):
    shapes = {"w": (16, 8), "b": (8,), "emb": {"e": (5, 3)}}

    def draw(s):
        return rng.standard_normal(s).astype(np.float32)

    return {k: ({kk: draw(vv) for kk, vv in v.items()} if isinstance(v, dict) else draw(v))
            for k, v in shapes.items()}


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _pair(tree, dtype):
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                        torch.bfloat16)
    return (_map(lambda a: jnp.asarray(a, jdt), tree),
            _map(lambda a: torch.from_numpy(a).to(tdt), tree))


def _run(jo, to, dtype, seed=0):
    rng = np.random.default_rng(seed)
    jp, tp = _pair(_tree(rng, dtype), dtype)
    js, ts = jo.init(jp), to.init(tp)
    out = []
    for _ in range(STEPS):
        jg, tg = _pair(_tree(rng, dtype), dtype)
        ju, js = jo.update(jg, js, jp)
        tu, ts = to.update(tg, ts, tp)
        jp, tp = jopt.apply_updates(jp, ju), topt.apply_updates(tp, tu)
        out.append((ju, tu, jp, tp))
    return out, (js, ts)


def _close(got, want, dtype, rtol):
    gl = [_np(x) for x in jax.tree_util.tree_leaves(_map(lambda x: x, got))]
    wl = [_np(x) for x in jax.tree_util.tree_leaves(_map(lambda x: x, want))]
    for g, w in zip(gl, wl):
        assert g.dtype == w.dtype or (g.dtype, w.dtype) == (np.float32, np.float32)
        if rtol == 0:
            np.testing.assert_array_equal(g, w)
        elif dtype == "bfloat16":
            np.testing.assert_allclose(g, w, rtol=2.0**-8, atol=0)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-12)


def _dtypes(got, want):
    for g, w in zip(jax.tree_util.tree_leaves(_map(lambda x: x, got)),
                    jax.tree_util.tree_leaves(_map(lambda x: x, want))):
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sgd_is_byte_equal(dtype):
    steps, _ = _run(jopt.sgd(lr=0.05), topt.sgd(lr=0.05), dtype)
    for ju, tu, jp, tp in steps:
        _dtypes(tu, ju)  # a bf16 gradient's update is float32, as JAX promotes
        _close(tu, ju, dtype, 0)
        _close(tp, jp, dtype, 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sgd_with_momentum(dtype):
    steps, (js, ts) = _run(jopt.sgd(lr=0.05, momentum=0.9), topt.sgd(lr=0.05, momentum=0.9),
                           dtype)
    for ju, tu, jp, tp in steps:
        _dtypes(tu, ju)
        _close(tp, jp, dtype, 1e-6)
    _close(ts["mom"], js["mom"], dtype, 1e-6)
    assert int(ts["step"]) == int(js["step"]) == STEPS


@pytest.mark.parametrize("schedule", ["constant", "warmup_cosine"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw(dtype, schedule):
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    if schedule == "constant":
        jo, to = jopt.adamw(lr=1e-2, **kw), topt.adamw(lr=1e-2, **kw)
    else:
        jo = jopt.adamw(lr=jsch.linear_warmup_cosine(1e-2, 2, 8, 1e-3), **kw)
        to = topt.adamw(lr=topt.linear_warmup_cosine(1e-2, 2, 8, 1e-3), **kw)
    steps, (js, ts) = _run(jo, to, dtype, seed=1)
    for ju, tu, jp, tp in steps:
        _dtypes(tu, ju)
        _close(tu, ju, dtype, 1e-6)
        _close(tp, jp, dtype, 1e-6)
    for key in ("m", "v"):
        _dtypes(ts[key], js[key])
        _close(ts[key], js[key], "float32", 1e-6)
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == STEPS


def test_adamw_state_carries_over_from_the_jax_package():
    """3 steps in the JAX package, its state carried as numpy
    (``optimizer_state_from_numpy``), 2 more in the port: the JAX package's
    5-step parameters."""
    jo, to = jopt.adamw(lr=1e-2), topt.adamw(lr=1e-2)
    rng = np.random.default_rng(3)
    p0 = _tree(rng, "float32")
    grads = [_tree(rng, "float32") for _ in range(5)]
    jp = _map(jnp.asarray, p0)
    js = jo.init(jp)
    for i in range(5):
        if i == 3:
            ts = optimizer_state_from_numpy(jax.tree_util.tree_map(np.asarray, js), "cpu")
            tp = _map(lambda a: torch.from_numpy(np.asarray(a).copy()), jp)
        if i >= 3:
            tu, ts = to.update(_map(torch.from_numpy, grads[i]), ts, tp)
            tp = topt.apply_updates(tp, tu)
        ju, js = jo.update(_map(jnp.asarray, grads[i]), js, jp)
        jp = jopt.apply_updates(jp, ju)
    _close(tp, jp, "float32", 1e-6)
    assert int(ts["step"]) == 5
    with pytest.raises(ValueError, match="step"):
        optimizer_state_from_numpy({"step": np.zeros((), np.int64), "m": {}, "v": {}}, "cpu")
    with pytest.raises(ValueError, match="float32"):
        optimizer_state_from_numpy({"step": np.zeros((), np.int32),
                                    "m": {"w": np.zeros(2, np.float64)}, "v": {}}, "cpu")


def test_get_optimizer_and_apply_updates():
    assert set(topt.__all__) >= {"sgd", "adamw", "apply_updates", "get_optimizer", "constant",
                                 "cosine_decay", "linear_warmup_cosine"}
    o = topt.get_optimizer("sgd", lr=0.5)
    p = {"w": torch.ones(3, dtype=torch.bfloat16)}
    u, s = o.update({"w": torch.ones(3, dtype=torch.bfloat16)}, o.init(p), p)
    assert u["w"].dtype == torch.float32
    assert topt.apply_updates(p, u)["w"].dtype == torch.bfloat16
    with pytest.raises(KeyError):
        topt.get_optimizer("lamb")
    np.testing.assert_array_equal(topt.apply_updates(p, u)["w"].float().numpy(),
                                  np.full(3, 0.5, np.float32))


SCHEDULES = [("constant", (0.3,)), ("cosine_decay", (1e-2, 10, 1e-4)),
             ("cosine_decay", (3.0, 7)), ("linear_warmup_cosine", (1e-2, 4, 20, 1e-3)),
             ("linear_warmup_cosine", (0.5, 0, 5))]


@pytest.mark.parametrize("name,args", SCHEDULES, ids=lambda v: str(v))
def test_schedules(name, args):
    jfn, tfn = getattr(jsch, name)(*args), getattr(topt, name)(*args)
    for step in (0, 1, 3, 4, 5, 10, 12, 20, 25, 100):
        want = np.asarray(jfn(jnp.asarray(step, jnp.int32)))
        got = tfn(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0 and want.dtype == np.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
