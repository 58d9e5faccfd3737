"""The port's mixture-of-experts block (``repro_torch.models.moe``, the
``moe`` kind of ``models.blocks``) against the JAX package's, on the CPU,
at the reduced Qwen3-MoE-235B-A22B (2 layers, d_model 256, 4 heads of 32,
4 experts top-2, expert width 128, vocab 512) and the reduced
Llama-4-Maverick (4 layers, dense and MoE interleaved, 4 experts top-1 and
a shared expert).

Weights come from the JAX package's init and are carried across with
``params_from_jax``; inputs are made with numpy. Tolerances (float32):

* MoE layer outputs atol 1e-5, aux losses rtol 1e-6 (the same routing; the
  two sides reduce in other orders);
* logits atol 2e-4 (the JAX package's teacher-forcing bound,
  ``tests/test_models.py``), loss rtol 1e-5 and gradients per leaf within
  1e-4 of the leaf's largest magnitude, as ``tests/test_torch_train.py``
  holds the dense models;
* the expert FFN's gradients against ``jax.vjp`` of the JAX package's
  custom VJP: per leaf within 1e-5 of its largest magnitude.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as jmoe
import repro.models.shard_ctx as jshard
import repro_torch.models.moe as tmoe
from repro.configs import get_config as jax_get_config
from repro.launch.steps import _with_moe_profile as jax_with_moe_profile
from repro.models import transformer as jtransformer
from repro.models.api import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.mesh_lowering import Mesh
from repro_torch.core.tree import tree_flatten, tree_map, tree_unflatten
from repro_torch.fl.fedstep import value_and_grad
from repro_torch.launch.steps import _with_moe_profile
from repro_torch.models import shard_ctx, transformer
from repro_torch.models.api import build_model

CPU = torch.device("cpu")
MOE_ARCHS = ["qwen3_moe_235b_a22b", "llama4_maverick_400b_a17b"]
B = 2
LAYER_ATOL, AUX_RTOL = 1e-5, 1e-6
F32_LOGITS_ATOL, LOSS_RTOL, GRAD_REL = 2e-4, 1e-5, 1e-4


def _host(tree):
    """A JAX tree as numpy arrays, dict key order kept."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_host(v) for v in tree)
    return np.asarray(tree)


def _t(tree):
    return params_from_jax(_host(tree), CPU)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _cfg(arch="qwen3_moe_235b_a22b", **kw):
    """The same reduced config in both packages."""
    jcfg = dataclasses.replace(jax_get_config(arch, reduced=True), **kw)
    tcfg = dataclasses.replace(get_config(arch, reduced=True), **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _x(cfg, seed, shape):
    return np.random.default_rng(seed).normal(size=shape + (cfg.d_model,)).astype(np.float32)


def _moe_both(jcfg, tcfg, p, x):
    jy, jaux = jmoe.moe_apply(p, jnp.asarray(x), jcfg)
    ty, taux = tmoe.moe_apply(_t(p), torch.from_numpy(x), tcfg)
    return (ty, taux), (jy, jaux)


def _assert_moe_equal(got, want):
    (ty, taux), (jy, jaux) = got, want
    assert ty.dtype == torch.float32 and tuple(ty.shape) == tuple(jy.shape)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), atol=LAYER_ATOL, rtol=0)
    assert taux.shape == () and taux.dtype == torch.float32
    np.testing.assert_allclose(float(taux), float(jaux), rtol=AUX_RTOL)


# ------------------------------------------------------------------ #
# the layer
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("arch,capacity_factor", [
    ("qwen3_moe_235b_a22b", 1.25), ("qwen3_moe_235b_a22b", 0.1),
    ("qwen3_moe_235b_a22b", 8.0), ("llama4_maverick_400b_a17b", 1.25)])
def test_moe_apply_matches_jax(arch, capacity_factor):
    """The default capacity, one that drops most slots and one that drops
    none; the shared expert (Llama-4)."""
    jcfg, tcfg = _cfg(arch, capacity_factor=capacity_factor)
    p = jmoe.moe_init(jax.random.key(0), jcfg, jnp.float32)
    _assert_moe_equal(*_moe_both(jcfg, tcfg, p, _x(jcfg, 1, (2, 32))))


def test_init_structure_and_carried_leaves():
    """``moe_init``: the JAX package's keys, shapes and dtypes (the router
    float32 in a bfloat16 tree); ``params_from_jax`` carries the stacked
    expert leaves and the router bit for bit, stacked per layer group too."""
    jcfg, tcfg = _cfg(param_dtype="bfloat16", scan_layers=True)
    jparams = jax_build_model(jcfg).init(jax.random.key(0))
    tparams = build_model(tcfg, "cpu").init(torch.Generator().manual_seed(0))
    jl = jax.tree_util.tree_flatten_with_path(jparams)[0]
    tl, _ = tree_flatten(tparams)
    assert len(tl) == len(jl)
    carried, _ = tree_flatten(_t(jparams))
    for (path, want), mine, got in zip(jl, tl, carried):
        want = np.asarray(want)
        assert tuple(mine.shape) == want.shape == tuple(got.shape), path
        assert str(mine.dtype).replace("torch.", "") == str(want.dtype) == str(got.dtype).replace(
            "torch.", ""), path
        bits = got.view(torch.int16) if got.dtype == torch.bfloat16 else got
        assert bits.numpy().tobytes() == want.tobytes(), path
    moe = tparams["groups"][0]["moe"]
    assert list(moe) == list(jparams["groups"][0]["moe"])  # stacked: sorted keys
    E, d, ff = tcfg.num_experts, tcfg.d_model, tcfg.moe_d_ff
    G = tcfg.num_layers
    assert moe["router"]["w"].dtype == torch.float32 and moe["router"]["w"].shape == (G, d, E)
    assert moe["gate"].shape == (G, E, d, ff) and moe["gate"].dtype == torch.bfloat16
    assert moe["down"].shape == (G, E, ff, d)
    _, lcfg = _cfg("llama4_maverick_400b_a17b")
    lp = build_model(lcfg, "cpu").init(torch.Generator().manual_seed(0))
    assert [list(layer) for layer in lp["layers"]] == [
        ["ln1", "attn", "ln2", "mlp"], ["ln1", "attn", "ln2", "moe"]] * 2
    assert list(lp["layers"][1]["moe"]) == ["router", "gate", "up", "down", "shared"]


def test_expert_ffn_backward_matches_jax_vjp():
    """The hand-written backward against ``jax.vjp`` of the JAX package's
    ``_expert_ffn`` (its custom VJP) on the same buffer and cotangent; the
    port's buffer is expert-major, (E, nb·C, d)."""
    rng = np.random.default_rng(3)
    nb, E, C, d, ff = 2, 4, 8, 32, 16
    buf = rng.normal(size=(nb, E, C, d)).astype(np.float32)
    gate, up = (0.2 * rng.normal(size=(E, d, ff)).astype(np.float32) for _ in range(2))
    down = 0.2 * rng.normal(size=(E, ff, d)).astype(np.float32)
    gbar = rng.normal(size=(nb, E, C, d)).astype(np.float32)
    jout, vjp = jax.vjp(lambda b, g, u, w: jmoe._expert_ffn(b, g, u, w, None),
                        *map(jnp.asarray, (buf, gate, up, down)))
    jgrads = vjp(jnp.asarray(gbar))

    def expert_major(a):
        return torch.from_numpy(np.ascontiguousarray(a.transpose(1, 0, 2, 3).reshape(E, nb * C, d)))

    xs = [expert_major(buf).requires_grad_(True)] + [
        torch.from_numpy(a).requires_grad_(True) for a in (gate, up, down)]
    out = tmoe.expert_ffn(*xs)
    np.testing.assert_allclose(_np(out), np.asarray(jout).transpose(1, 0, 2, 3).reshape(E, nb * C, d),
                               atol=1e-5, rtol=0)
    got = torch.autograd.grad(out, xs, expert_major(gbar))
    want = [np.asarray(jgrads[0]).transpose(1, 0, 2, 3).reshape(E, nb * C, d)] + [
        np.asarray(g) for g in jgrads[1:]]
    for name, g, w in zip(("buf", "gate", "up", "down"), got, want):
        np.testing.assert_allclose(_np(g), w, atol=1e-5 * float(np.abs(w).max()), rtol=0,
                                   err_msg=name)


def test_top_k_breaks_ties_toward_the_lower_index():
    """``jax.lax.top_k`` on rows full of ties, and on distinct values."""
    x = np.array([[0.25] * 4, [0.1, 0.4, 0.4, 0.1], [0.3, 0.1, 0.5, 0.1]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 2)
    tv, ti = tmoe._top_k(torch.from_numpy(x), 2)
    assert ti.tolist() == np.asarray(ji).tolist() == [[0, 1], [1, 2], [2, 0]]
    assert np.array_equal(_np(tv), np.asarray(jv))


# ------------------------------------------------------------------ #
# routing blocks and the sharding profile
# ------------------------------------------------------------------ #
def _reference_blocks(n_tokens, min_blocks):
    """``repro/models/moe.py``'s block count, written out."""
    if n_tokens % min_blocks == 0 and n_tokens // min_blocks >= 8:
        nb = min_blocks * max(1, n_tokens // (jmoe.ROUTE_BLOCK * min_blocks))
    else:
        nb = max(1, n_tokens // jmoe.ROUTE_BLOCK)
    while n_tokens % nb:
        nb -= 1
    return nb


@pytest.mark.parametrize("min_blocks", [1, 2])
def test_route_blocks_follow_the_profile(min_blocks):
    """The block split at ``min_blocks`` 1 and 2 against the reference's
    formula, and ``moe_apply`` under each profile against the JAX
    package's under the same one (at a capacity that drops slots, so the
    split shows in the output)."""
    for n in (2, 7, 8, 16, 30, 64, 2048, 4096, 6144, 16384, 20480):
        with shard_ctx.shard_profile(("data",), min_blocks=min_blocks):
            assert tmoe.route_blocks(n) == _reference_blocks(n, min_blocks), n
    assert tmoe.route_blocks(4096) == 2 and shard_ctx.get_profile() is None
    jcfg, tcfg = _cfg(capacity_factor=0.5)
    p = jmoe.moe_init(jax.random.key(0), jcfg, jnp.float32)
    x = _x(jcfg, 2, (2, 16))
    # the JAX package's profile constrains layouts: a one-device mesh
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    with jmesh, jshard.shard_profile(("data",), min_blocks=min_blocks):
        jy, jaux = jmoe.moe_apply(p, jnp.asarray(x), jcfg)
    with shard_ctx.shard_profile(("data",), min_blocks=min_blocks):
        ty, taux = tmoe.moe_apply(_t(p), torch.from_numpy(x), tcfg)
    _assert_moe_equal((ty, taux), (jy, jaux))
    if min_blocks == 2:  # two blocks of 16 route otherwise than one of 32
        y1, _ = tmoe.moe_apply(_t(p), torch.from_numpy(x), tcfg)
        assert not torch.equal(ty, y1)


def test_with_moe_profile_takes_the_reference_min_blocks():
    """``_with_moe_profile``: the profile's batch axes and ``min_blocks``
    from the mesh and the client axes, as the JAX package computes them
    (its one-device mesh), and the port's larger meshes."""
    cfg = get_config("qwen3_moe_235b_a22b", reduced=True)  # fsdp

    def profile_of(mesh, manual=()):
        return _with_moe_profile(shard_ctx.get_profile, cfg, mesh, manual)()

    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    want = jax_with_moe_profile(jshard.get_profile, jax_get_config(
        "qwen3_moe_235b_a22b", reduced=True), jmesh)()
    got = profile_of(Mesh((("data", 1), ("model", 1))))
    assert got == {k: want[k] for k in ("batch", "expert", "min_blocks")}
    assert profile_of(Mesh((("pod", 2), ("data", 2), ("model", 1))))["min_blocks"] == 4
    assert profile_of(Mesh((("pod", 2), ("data", 2), ("model", 1))), ("pod",))["min_blocks"] == 2
    dense = get_config("qwen2_5_3b", reduced=True)  # not fsdp: model is no batch axis
    prof = _with_moe_profile(shard_ctx.get_profile, dense, Mesh((("data", 2), ("model", 2))))()
    assert prof["batch"] == ("data",) and prof["min_blocks"] == 2
    assert shard_ctx.get_profile() is None


# ------------------------------------------------------------------ #
# invariants: tests/test_models.py::TestMoEInvariants
# ------------------------------------------------------------------ #
class TestMoEInvariants:
    def test_capacity_never_exceeded(self):
        """At tiny capacity the output stays finite and bounded, and equals
        the JAX package's."""
        jcfg, tcfg = _cfg(capacity_factor=0.1)
        p = jmoe.moe_init(jax.random.key(0), jcfg, jnp.float32)
        got, want = _moe_both(jcfg, tcfg, p, _x(jcfg, 1, (2, 32)))
        assert tuple(got[0].shape) == (2, 32, tcfg.d_model)
        assert bool(torch.isfinite(got[0]).all())
        _assert_moe_equal(got, want)

    def test_dropped_tokens_get_zero_expert_output(self):
        jsmall, tsmall = _cfg(capacity_factor=0.01)
        jbig, tbig = _cfg(capacity_factor=16.0)
        p = jmoe.moe_init(jax.random.key(0), jsmall, jnp.float32)
        x = _x(jsmall, 1, (1, 32))
        small, jsm = _moe_both(jsmall, tsmall, p, x)
        big, jbg = _moe_both(jbig, tbig, p, x)
        assert float(torch.linalg.norm(small[0])) < float(torch.linalg.norm(big[0]))
        _assert_moe_equal(small, jsm)
        _assert_moe_equal(big, jbg)

    def test_aux_loss_uniform_router_near_one(self):
        """A zero router: every row a tie, top-k by the lowest indices on
        both sides; aux near 1 and equal to the JAX package's."""
        jcfg, tcfg = _cfg()
        p = dict(jmoe.moe_init(jax.random.key(0), jcfg, jnp.float32))
        p["router"] = {"w": jnp.zeros_like(p["router"]["w"])}
        got, want = _moe_both(jcfg, tcfg, p, _x(jcfg, 1, (2, 64)))
        assert 0.9 < float(got[1]) < 1.1
        _assert_moe_equal(got, want)


# ------------------------------------------------------------------ #
# the model: tests/test_models.py's TestArchSmoke and teacher forcing
# ------------------------------------------------------------------ #
def _tokens(cfg, seed, seq):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(B, seq)).astype(np.int32)


def _assert_grads(got, want):
    gl, _ = tree_flatten(got)
    wl = jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        w = np.asarray(w)
        np.testing.assert_allclose(_np(g), w, rtol=0, atol=GRAD_REL * float(np.abs(w).max()) + 1e-12)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_and_train_step(arch):
    """``TestArchSmoke.test_forward_and_train_step``: the loss (router aux
    included) and its gradient against the JAX package's, then the
    reference's norm-clipped SGD step, which must not raise the loss."""
    jcfg, cfg = _cfg(arch)
    assert cfg.num_layers <= 2 * max(1, cfg.layer_period)
    assert cfg.d_model <= 512 and cfg.num_experts <= 4
    jb = jax_build_model(jcfg)
    key = jax.random.key(0)
    jparams = jb.init(key)
    toks = _tokens(cfg, 1, 24)
    jloss_fn = jax.jit(lambda p: jb.loss_fn(p, {"tokens": jnp.asarray(toks)}, key))
    jloss, jgrads = jax.jit(jax.value_and_grad(jloss_fn))(jparams)

    bundle = build_model(cfg, "cpu")
    leaves, treedef = tree_flatten(_t(jparams))
    batch = {"tokens": torch.from_numpy(toks)}
    loss, grads = value_and_grad(bundle.loss_fn, leaves, treedef, batch, None)
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    _assert_grads(tree_unflatten(treedef, grads), jgrads)
    gnorm = sum(float(torch.sum(torch.square(g))) for g in grads)
    assert np.isfinite(gnorm) and gnorm > 0
    # the router and the experts both learn
    tgrads = tree_unflatten(treedef, grads)
    moe = next(layer["moe"] for layer in tgrads["layers"] if "moe" in layer)
    assert float(moe["router"]["w"].abs().max()) > 0 and float(moe["gate"].abs().max()) > 0
    scale = 0.1 / max(1.0, np.sqrt(gnorm))
    new = tree_unflatten(treedef, [w - scale * g for w, g in zip(leaves, grads)])
    with torch.no_grad():
        loss2 = bundle.loss_fn(new, batch, None)
    assert float(loss2) < float(loss) + 1e-3
    jnew = jax.tree_util.tree_map(lambda w, g: w - scale * g, jparams, jgrads)
    np.testing.assert_allclose(float(loss2), float(jloss_fn(jnew)), rtol=LOSS_RTOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_shapes_and_finite(arch):
    """``TestArchSmoke.test_decode_shapes_and_finite``, the logits of the
    prefill and of a decode step held to the JAX package's too."""
    jcfg, cfg = _cfg(arch)
    jb, tb = jax_build_model(jcfg), build_model(cfg, "cpu")
    jparams = jb.init(jax.random.key(1))
    params = _t(jparams)
    toks = _tokens(cfg, 1, 16)
    jl, jc = jb.prefill(jparams, {"tokens": jnp.asarray(toks)}, jb.init_cache(B, 128))
    logits, cache = tb.prefill(params, {"tokens": torch.from_numpy(toks)}, tb.init_cache(B, 128))
    assert tuple(logits.shape) == (B, 1, cfg.vocab_size)
    np.testing.assert_allclose(_np(logits), np.asarray(jl), atol=F32_LOGITS_ATOL, rtol=0)
    tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
    assert np.array_equal(tok.numpy(), np.asarray(jnp.argmax(jl[:, -1:], -1)))
    logits2, _ = tb.serve_step(params, cache, {"token": tok})
    jl2, _ = jb.serve_step(jparams, jc, {"token": jnp.asarray(tok.numpy())})
    assert tuple(logits2.shape) == (B, 1, cfg.vocab_size)
    assert bool(torch.isfinite(logits2).all())
    np.testing.assert_allclose(_np(logits2), np.asarray(jl2), atol=F32_LOGITS_ATOL, rtol=0)


@pytest.mark.parametrize("scan_layers", [False, True])
def test_decode_matches_teacher_forcing(scan_layers):
    """``test_models.py::test_decode_matches_teacher_forcing`` for
    ``qwen3_moe_235b_a22b`` at ``capacity_factor`` 8.0 (no slot drops, so
    a decode step routes as the full forward does): incremental decode
    equals the full forward at the last position, and that forward equals
    the JAX package's."""
    jcfg, cfg = _cfg(capacity_factor=8.0, scan_layers=scan_layers)
    jparams = jax_build_model(jcfg).init(jax.random.key(2))
    params = _t(jparams)
    bundle = build_model(cfg, "cpu")
    toks = _tokens(cfg, 2, 16)
    full, _, _ = transformer.forward(params, cfg, tokens=torch.from_numpy(toks))
    jfull, _, _ = jtransformer.forward(jparams, jcfg, tokens=jnp.asarray(toks))
    np.testing.assert_allclose(_np(full), np.asarray(jfull), atol=F32_LOGITS_ATOL, rtol=0)
    t = torch.from_numpy(toks)
    _, cache = bundle.prefill(params, {"tokens": t[:, :-1]}, bundle.init_cache(B, 64))
    logits_d, _ = bundle.serve_step(params, cache, {"token": t[:, -1:]})
    np.testing.assert_allclose(_np(full[:, -1]), _np(logits_d[:, 0]), atol=F32_LOGITS_ATOL, rtol=0)


def test_bf16_model_forward_is_finite_and_near_float32():
    """The published dtype (bfloat16 experts, float32 router) at the
    reduced widths, on the JAX package's bfloat16 weights: logits finite
    and within the dense models' bfloat16 bound (2e-2 relative L2,
    ``tests/test_torch_models.py``) of the float32 forward of the same
    weights. (The JAX package's bfloat16 MoE does not run on the CPU: XLA's
    CPU dot has no bfloat16 x bfloat16 -> float32 batched product.)"""
    jcfg, cfg = _cfg(param_dtype="bfloat16", capacity_factor=8.0)
    params = _t(jax_build_model(jcfg).init(jax.random.key(4)))
    toks = torch.from_numpy(_tokens(cfg, 4, 16))
    logits, _, aux = transformer.forward(params, cfg, tokens=toks)
    f32 = dataclasses.replace(cfg, param_dtype="float32")
    params32 = tree_map(lambda x: x.float(), params)
    logits32, _, aux32 = transformer.forward(params32, f32, tokens=toks)
    assert logits.dtype == torch.float32 and bool(torch.isfinite(logits).all())
    a, b = _np(logits).astype(np.float64), _np(logits32).astype(np.float64)
    assert np.linalg.norm(a - b) / np.linalg.norm(b) <= 2e-2
    assert abs(float(aux) - float(aux32)) <= 2e-2 * float(aux32)
