"""The port's recurrences (``repro_torch.models.ssd``) and recurrent block
kinds (``hymba``, ``mlstm``, ``slstm`` in ``repro_torch.models.blocks``)
against the JAX package's, on the CPU, float32, inputs from a numpy seed.

Tolerances:

* the scan over chunks combines in ``jax.lax.associative_scan``'s tree
  order: bit-equal to the JAX package's eager scan;
* ``ssd_chunked``, ``ssd_decode_step`` and ``slstm_scan``: atol 1e-5 on
  outputs of magnitude up to about 10 (a few float32 ulps: the einsums and
  ``cumsum`` sum in another order, and XLA's exp, tanh and log are other
  approximations than torch's);
* the SSD sub-block and the blocks: atol 2e-5, the attention twins' bound
  (``tests/test_torch_models.py``), plus rtol 1e-5 for the mlstm block's
  residual stream, whose values reach about 20 (an ulp there is 2e-6);
* chunked against stepwise, on the port alone: the JAX package's own
  ``TestSSD`` bound, atol 1e-3;
* the bf16 blocks against the JAX package's eager blocks: outputs within a
  relative L2 of 1e-3 (a few outputs one bf16 ulp apart: 2.4e-4 at most),
  the float32 states within 1e-4 (1.8e-5 at most); a decode that rounds
  its state to bf16 reads 1.5e-3 to 1.9e-3 on the states.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.blocks as jblocks
import repro.models.ssd as jssd
import repro_torch.models.blocks as tblocks
import repro_torch.models.ssd as tssd
from repro.configs import get_config as jax_get_config
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax

CPU = torch.device("cpu")
SSD_ATOL = 1e-5
BLOCK_ATOL, BLOCK_RTOL = 2e-5, 1e-5
BF16_OUT_REL, BF16_STATE_REL = 1e-3, 1e-4


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_host(v) for v in tree)
    return np.asarray(tree)


def _t(tree):
    return params_from_jax(_host(tree), CPU)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(port, ref, atol, rtol=0.0):
    if isinstance(ref, dict):
        assert list(port) == list(ref), (list(port), list(ref))
        for k in ref:
            _close(port[k], ref[k], atol, rtol)
    elif isinstance(ref, (tuple, list)):
        assert len(port) == len(ref)
        for p, r in zip(port, ref):
            _close(p, r, atol, rtol)
    else:
        assert tuple(port.shape) == tuple(ref.shape)
        assert str(port.dtype).replace("torch.", "") == str(ref.dtype), (port.dtype, ref.dtype)
        np.testing.assert_allclose(_np(port), _np(ref), atol=atol, rtol=rtol)


def _inputs(seed, B, S, H, N, P):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, N)).astype(np.float32)
    k = (0.3 * rng.normal(size=(B, S, H, N))).astype(np.float32)
    v = rng.normal(size=(B, S, H, P)).astype(np.float32)
    ld = (-np.logaddexp(rng.normal(size=(B, S, H)), 0.0)).astype(np.float32)
    g = (1.0 / (1.0 + np.exp(-rng.normal(size=(B, S, H))))).astype(np.float32)
    s0 = rng.normal(size=(B, H, N, P)).astype(np.float32)
    return q, k, v, ld, g, s0


# ------------------------------------------------------------------ #
# the recurrences
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 13])
def test_chunk_scan_is_bit_equal_to_jax_associative_scan(n):
    rng = np.random.default_rng(n)
    p = rng.uniform(0.5, 1.0, size=(2, n, 3)).astype(np.float32)
    s = rng.normal(size=(2, n, 3, 4, 5)).astype(np.float32)

    def combine(x, y):
        return x[0] * y[0], x[1] * y[0][..., None, None] + y[1]

    want = jax.lax.associative_scan(combine, (jnp.asarray(p), jnp.asarray(s)), axis=1)
    got = tssd._associative_scan(tssd._chunk_combine, (torch.from_numpy(p), torch.from_numpy(s)), 1)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("S,chunk,with_init", [
    (64, 16, False),  # 4 chunks
    (64, 16, True),
    (80, 16, True),  # 5 chunks: an odd count through the tree scan
    (12, 16, False),  # shorter than the chunk: one chunk of 12
    (12, 16, True),
])
def test_ssd_chunked_matches_jax(S, chunk, with_init):
    q, k, v, ld, g, s0 = _inputs(S + with_init, 2, S, 3, 8, 16)
    init = s0 if with_init else None
    jy, jf = jssd.ssd_chunked(*(jnp.asarray(a) for a in (q, k, v, ld, g)), chunk=chunk,
                              initial_state=None if init is None else jnp.asarray(init))
    ty, tf = tssd.ssd_chunked(*(torch.from_numpy(a) for a in (q, k, v, ld, g)), chunk=chunk,
                              initial_state=None if init is None else torch.from_numpy(init))
    assert ty.dtype == torch.float32 and tf.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=SSD_ATOL, rtol=0)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=SSD_ATOL, rtol=0)


def test_ssd_chunked_refuses_a_ragged_sequence():
    q, k, v, ld, g, _ = _inputs(0, 1, 24, 2, 4, 8)
    with pytest.raises(ValueError, match="not divisible"):
        tssd.ssd_chunked(*(torch.from_numpy(a) for a in (q, k, v, ld, g)), chunk=16)


def test_ssd_chunked_keeps_the_value_dtype():
    q, k, v, ld, g, _ = _inputs(1, 1, 32, 2, 4, 8)
    y, final = tssd.ssd_chunked(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
                                torch.from_numpy(ld), torch.from_numpy(g), chunk=16)
    assert y.dtype == torch.bfloat16 and final.dtype == torch.float32


def test_ssd_decode_step_matches_jax():
    q, k, v, ld, g, s0 = _inputs(7, 2, 1, 3, 8, 16)
    args = (s0, q[:, 0], k[:, 0], v[:, 0], ld[:, 0], g[:, 0])
    jy, js = jssd.ssd_decode_step(*(jnp.asarray(a) for a in args))
    ty, ts = tssd.ssd_decode_step(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=SSD_ATOL, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=SSD_ATOL, rtol=0)


def test_chunked_matches_stepwise():
    """The twin of ``tests/test_models.py::TestSSD::test_chunked_matches_stepwise``
    on the port alone, at its bound."""
    q, k, v, ld, g, _ = _inputs(11, 2, 32, 2, 4, 8)
    q, k, v, ld, g = (torch.from_numpy(a) for a in (q, k, v, ld, g))
    y_chunk, final = tssd.ssd_chunked(q, k, v, ld, g, chunk=8)
    state = torch.zeros((2, 2, 4, 8))
    ys = []
    for t in range(32):
        y_t, state = tssd.ssd_decode_step(state, q[:, t], k[:, t], v[:, t], ld[:, t], g[:, t])
        ys.append(y_t)
    np.testing.assert_allclose(y_chunk.numpy(), torch.stack(ys, 1).numpy(), atol=1e-3)
    np.testing.assert_allclose(final.numpy(), state.numpy(), atol=1e-3)


@pytest.mark.parametrize("with_init", [False, True])
def test_slstm_scan_matches_jax(with_init):
    rng = np.random.default_rng(20 + with_init)
    # gates of magnitude ~3 with some beyond 20, where torch's softplus
    # would switch to its linear branch
    xs = [(3.0 * rng.normal(size=(2, 24, 16))).astype(np.float32) for _ in range(4)]
    xs[1][0, :3] = 25.0
    init = None
    if with_init:
        init = (rng.normal(size=(2, 16)).astype(np.float32),
                np.abs(rng.normal(size=(2, 16))).astype(np.float32) + 1.0,
                rng.normal(size=(2, 16)).astype(np.float32))
    jinit = None if init is None else tuple(jnp.asarray(a) for a in init)
    tinit = None if init is None else tuple(torch.from_numpy(a) for a in init)
    jh, jc = jssd.slstm_scan(*(jnp.asarray(a) for a in xs), initial=jinit)
    th, tc = tssd.slstm_scan(*(torch.from_numpy(a) for a in xs), initial=tinit)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=SSD_ATOL, rtol=0)
    for a, b in zip(tc, jc):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=SSD_ATOL, rtol=0)


def test_log_sigmoid_is_the_jax_packages_softplus():
    x = np.array([-80.0, -30.0, -20.5, -1.0, 0.0, 1.0, 20.5, 30.0], np.float32)
    want = np.asarray(-jax.nn.softplus(-jnp.asarray(x)))
    np.testing.assert_allclose(tssd.log_sigmoid(torch.from_numpy(x)).numpy(), want,
                               atol=0, rtol=1e-6)


# ------------------------------------------------------------------ #
# the SSD sub-block and the recurrent block kinds
# ------------------------------------------------------------------ #
def _cfgs(arch, **kw):
    jcfg = dataclasses.replace(jax_get_config(arch, reduced=True), **kw)
    tcfg = dataclasses.replace(get_config(arch, reduced=True), **kw)
    return jcfg, tcfg


def test_ssd_sub_block_matches_jax():
    jcfg, tcfg = _cfgs("hymba_1_5b")
    p = jblocks.ssd_init(jax.random.key(3), jcfg, jnp.float32)
    p["a_log"] = jnp.asarray(np.random.default_rng(3).normal(size=p["a_log"].shape), jnp.float32)
    p["d_skip"] = jnp.asarray(np.random.default_rng(4).normal(size=p["d_skip"].shape), jnp.float32)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 32, jcfg.d_model)).astype(np.float32)
    jc = jblocks.ssd_state_init(jcfg, 2, jnp.float32)
    tc = tblocks.ssd_state_init(tcfg, 2, CPU)
    _close(tc, jc, 0.0)
    jy, jc = jblocks.ssd_apply_full(p, jnp.asarray(x), jc, jcfg)
    ty, tc = tblocks.ssd_apply_full(_t(p), torch.from_numpy(x), tc, tcfg)
    _close(ty, jy, BLOCK_ATOL, BLOCK_RTOL)
    _close(tc, jc, BLOCK_ATOL, BLOCK_RTOL)
    jy0, _ = jblocks.ssd_apply_full(p, jnp.asarray(x), None, jcfg)
    ty0, none = tblocks.ssd_apply_full(_t(p), torch.from_numpy(x), None, tcfg)
    assert none is None
    _close(ty0, jy0, BLOCK_ATOL, BLOCK_RTOL)
    x1 = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
    jy, jc = jblocks.ssd_apply_decode(p, jnp.asarray(x1), jc, jcfg)
    ty, tc = tblocks.ssd_apply_decode(_t(p), torch.from_numpy(x1), tc, tcfg)
    _close(ty, jy, BLOCK_ATOL, BLOCK_RTOL)
    _close(tc, jc, BLOCK_ATOL, BLOCK_RTOL)


BLOCK_KINDS = [("hymba_1_5b", "hymba"), ("xlstm_1_3b", "mlstm"), ("xlstm_1_3b", "slstm")]


@pytest.mark.parametrize("arch,kind", BLOCK_KINDS, ids=[k for _, k in BLOCK_KINDS])
def test_recurrent_block_full_and_decode_match_jax(arch, kind):
    """Prefill a cache over 32 tokens (two SSD chunks of 16), then three
    decode steps, each against the JAX package's block on its init's
    parameters; and the forward without a cache."""
    jcfg, tcfg = _cfgs(arch)
    p = jblocks.block_init(jax.random.key(8), jcfg, kind, jnp.float32)
    tp = _t(p)
    rng = np.random.default_rng(8)
    S = 32
    x = rng.normal(size=(2, S, jcfg.d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)[None].repeat(2, 0)
    jc = jblocks.block_cache_init(jcfg, kind, 2, 48, jnp.float32)
    tc = tblocks.block_cache_init(tcfg, kind, 2, 48, torch.float32, CPU)
    _close(tc, jc, 0.0)
    jy, jc, _ = jblocks.block_apply(p, jnp.asarray(x), jnp.asarray(pos), jc, "full", jcfg, kind)
    ty, tc, aux = tblocks.block_apply(tp, torch.from_numpy(x), torch.from_numpy(pos), tc,
                                      "full", tcfg, kind)
    assert float(aux) == 0.0
    _close(ty, jy, BLOCK_ATOL, BLOCK_RTOL)
    _close(tc, jc, BLOCK_ATOL, BLOCK_RTOL)
    # no cache: the training forward
    jy0, none_j, _ = jblocks.block_apply(p, jnp.asarray(x), jnp.asarray(pos), None, "full", jcfg,
                                         kind)
    ty0, none_t, _ = tblocks.block_apply(tp, torch.from_numpy(x), torch.from_numpy(pos), None,
                                         "full", tcfg, kind)
    assert none_j is None and none_t is None
    _close(ty0, jy0, BLOCK_ATOL, BLOCK_RTOL)
    for step in range(3):
        x1 = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
        pos1 = np.full((2, 1), S + step, np.int32)
        jy, jc, _ = jblocks.block_apply(p, jnp.asarray(x1), jnp.asarray(pos1), jc, "decode",
                                        jcfg, kind)
        ty, tc, _ = tblocks.block_apply(tp, torch.from_numpy(x1), torch.from_numpy(pos1), tc,
                                        "decode", tcfg, kind)
        _close(ty, jy, BLOCK_ATOL, BLOCK_RTOL)
        _close(tc, jc, BLOCK_ATOL, BLOCK_RTOL)


@pytest.mark.parametrize("arch,kind", BLOCK_KINDS, ids=[k for _, k in BLOCK_KINDS])
def test_recurrent_block_trees_have_the_jax_structure(arch, kind):
    """Same keys in the same order, shapes and dtypes, bf16 model included:
    ``a_log`` and ``d_skip`` stay float32, the recurrent state too."""
    jcfg, tcfg = _cfgs(arch, param_dtype="bfloat16")
    jp = jblocks.block_init(jax.random.key(0), jcfg, kind, jnp.bfloat16)
    tp = tblocks.block_init(torch.Generator().manual_seed(0), tcfg, kind, torch.bfloat16)
    _close(tp, jp, atol=np.inf)
    jc = jblocks.block_cache_init(jcfg, kind, 2, 16, jnp.bfloat16)
    tc = tblocks.block_cache_init(tcfg, kind, 2, 16, torch.bfloat16, CPU)
    _close(tc, jc, 0.0)
    if kind != "slstm":
        assert tp["ssd"]["a_log"].dtype == torch.float32
        assert tp["ssd"]["d_skip"].dtype == torch.float32
        assert tp["ssd"]["in_xz"]["w"].dtype == torch.bfloat16


def _rel(port, ref):
    a, b = _np(port).astype(np.float64), _np(ref).astype(np.float64)
    return float(np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel()))


def _bf16_block_run(arch, kind, steps=8):
    """A bf16 block (random float32 ``a_log`` / ``d_skip``, so their casts
    show) over a prefill of 32 tokens and ``steps`` decode steps in both
    packages, JAX's eager: the largest relative L2 of the outputs and of
    the float32 state leaves."""
    jcfg, tcfg = _cfgs(arch, param_dtype="bfloat16")
    p = jblocks.block_init(jax.random.key(8), jcfg, kind, jnp.bfloat16)
    if kind != "slstm":
        rng = np.random.default_rng(3)
        p["ssd"]["a_log"] = jnp.asarray(0.5 * rng.normal(size=p["ssd"]["a_log"].shape), jnp.float32)
        p["ssd"]["d_skip"] = jnp.asarray(rng.normal(size=p["ssd"]["d_skip"].shape), jnp.float32)
    tp = _t(p)
    rng = np.random.default_rng(8)
    S = 32

    def inputs(n, start):
        x = rng.normal(size=(2, n, jcfg.d_model)).astype(np.float32)
        pos = np.arange(start, start + n, dtype=np.int32)[None].repeat(2, 0)
        return ((jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos)),
                (torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(pos)))

    jc = jblocks.block_cache_init(jcfg, kind, 2, 48, jnp.bfloat16)
    tc = tblocks.block_cache_init(tcfg, kind, 2, 48, torch.bfloat16, CPU)
    outs, states = [], []
    for i in range(steps + 1):
        (jx, jpos), (tx, tpos) = inputs(S, 0) if i == 0 else inputs(1, S + i - 1)
        mode = "full" if i == 0 else "decode"
        jy, jc, _ = jblocks.block_apply(p, jx, jpos, jc, mode, jcfg, kind)
        ty, tc, _ = tblocks.block_apply(tp, tx, tpos, tc, mode, tcfg, kind)
        assert ty.dtype == torch.bfloat16
        outs.append(_rel(ty, jy))
        state = tc["ssd"] if kind != "slstm" else tc
        jstate = jc["ssd"] if kind != "slstm" else jc
        states += [_rel(state[k], jstate[k]) for k in state]
        assert all(state[k].dtype == torch.float32 for k in state)
    return max(outs), max(states)


@pytest.mark.parametrize("arch,kind", BLOCK_KINDS, ids=[k for _, k in BLOCK_KINDS])
def test_recurrent_bf16_block_full_and_decode_match_jax(arch, kind, monkeypatch):
    """The bf16 blocks against the JAX package's: a prefill and 8 decode
    steps, each output and float32 state within the bf16 bounds. A decode
    that rounds its state to bf16 (planted here) reads above the state
    bound, so the bound can see a bf16 cast the reference does not make."""
    out, state = _bf16_block_run(arch, kind)
    assert out <= BF16_OUT_REL and state <= BF16_STATE_REL, (out, state)
    real_ssd, real_slstm = tblocks.ssd_decode_step, tblocks.slstm_scan

    def ssd_rounded(st, *a):
        return real_ssd(st.to(torch.bfloat16).float(), *a)

    def slstm_rounded(i, f, z, o, initial=None):
        if initial is not None and z.shape[1] == 1:
            c, n, m = initial
            initial = (c.bfloat16().float(), n.bfloat16().float(), m)
        return real_slstm(i, f, z, o, initial=initial)

    monkeypatch.setattr(tblocks, "ssd_decode_step", ssd_rounded)
    monkeypatch.setattr(tblocks, "slstm_scan", slstm_rounded)
    _, faulted = _bf16_block_run(arch, kind)
    assert faulted > BF16_STATE_REL, faulted
