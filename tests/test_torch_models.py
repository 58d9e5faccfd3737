"""The port's model stack (``repro_torch.models``) against the JAX
package's, on the CPU, at the reduced Qwen2.5-3B (2 layers, d_model 256,
GQA 4/2 heads of 32, vocab 512), reduced Qwen2-VL-2B, Gemma-7B (head dim
32 there, GeGLU, tied), DeepSeek-7B (MHA) and GLM4-9B (QKV bias), and the
reduced recurrent families: Hymba-1.5B
(hymba blocks, window 64, SSD chunk 16) and xLSTM-1.3B (16 layers: two
periods of 7 mlstm + 1 slstm). The encoder-decoder family has its own file
(``tests/test_torch_encdec.py``).

Weights come from the JAX package's init and are carried across with
``params_from_jax``; inputs are made with numpy. Tolerances:

* float32: layers atol 1e-5, attention atol 2e-5 (the flash kernel's),
  logits and caches atol 2e-4 (the JAX package's own teacher-forcing bound,
  ``tests/test_models.py``): the two sides reduce in other orders.
* bfloat16: logits within a relative L2 error of 2e-2, caches atol 5e-2:
  both sides round to bfloat16 at every product, and a sum taken in another
  order can land one bfloat16 ulp (2**-8 relative) away, which the next
  layers carry on.
* the reduced xLSTM's recurrent states: within 1e-3 of each leaf's largest
  value. Its 16 un-normed mLSTM layers grow the residual stream to about
  40 and amplify float32 rounding about a thousandfold: a 1e-7 relative
  perturbation of the embeddings alone moves the JAX package's own logits
  by up to 9.4e-5 (its logits stay within F32_LOGITS_ATOL of the port's).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as jattn
import repro.models.blocks as jblocks
import repro.models.layers as jlayers
import repro_torch.models.attention as tattn
import repro_torch.models.blocks as tblocks
import repro_torch.models.layers as tlayers
from repro.configs import get_config as jax_get_config
from repro.configs import long_decode_variant as jax_long_decode_variant
from repro.models.api import build_model as jax_build_model
from repro_torch.configs import ARCH_IDS, get_config, long_decode_variant
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer
from repro_torch.models.api import build_model

CPU = torch.device("cpu")
B = 2
F32_LOGITS_ATOL = 2e-4
STATE_REL = 1e-3
RECURRENT = ("hymba_1_5b", "xlstm_1_3b")
BF16_REL_L2, BF16_CACHE_ATOL = 2e-2, 5e-2


def _np(x):
    """A port tensor or a JAX array as float32 (or int) numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.kind in "fV" or x.dtype.name == "bfloat16" else x


def _host(tree):
    """A JAX tree as numpy arrays, keeping dict key order (``jax.device_get``
    would rebuild the dicts with sorted keys)."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_host(v) for v in tree)
    return np.asarray(tree)


def _t(x):
    return params_from_jax(_host(x), CPU)


def _dtype_name(x):
    return str(x.dtype).replace("torch.", "")


def assert_same_tree(port, ref, atol=0.0, values=True):
    """Same structure (dict key order, tuples), shapes, dtypes; leaves within
    ``atol``."""
    if isinstance(ref, dict):
        assert isinstance(port, dict) and list(port) == list(ref), (list(port), list(ref))
        for k in ref:
            assert_same_tree(port[k], ref[k], atol, values)
    elif isinstance(ref, (tuple, list)):
        assert type(port) is type(ref) and len(port) == len(ref)
        for p, r in zip(port, ref):
            assert_same_tree(p, r, atol, values)
    else:
        assert tuple(port.shape) == tuple(ref.shape)
        assert _dtype_name(port) == _dtype_name(ref), (port.dtype, ref.dtype)
        if values:
            np.testing.assert_allclose(_np(port), _np(ref), atol=atol, rtol=0)


def _clone(tree):
    """A copy of a tree of tensors, keeping dict key order."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_clone(v) for v in tree)
    return tree.clone()


def _rel_l2(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _cfg(arch="qwen2_5_3b", **kw):
    """The same reduced config in both packages."""
    jcfg = dataclasses.replace(jax_get_config(arch, reduced=True), **kw)
    tcfg = dataclasses.replace(get_config(arch, reduced=True), **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


# ------------------------------------------------------------------ #
# layers
# ------------------------------------------------------------------ #
def test_config_copies_are_the_jax_packages():
    for arch in ARCH_IDS:
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jax_get_config(arch))
        assert get_config(arch).param_count() == jax_get_config(arch).param_count()
    full = get_config("qwen2_5_3b")
    # the analytic count uses vocab_size; the tree holds padded_vocab rows
    assert full.param_count() == 3_085_936_640 and full.padded_vocab == 152_064
    lv, jlv = long_decode_variant(full), jax_long_decode_variant(jax_get_config("qwen2_5_3b"))
    assert dataclasses.asdict(lv) == dataclasses.asdict(jlv) and lv.sliding_window == 8192


LAYER_CASES = ["rmsnorm", "rope", "mrope", "swiglu", "geglu", "dense_bias"]


@pytest.mark.parametrize("case", LAYER_CASES)
def test_layers_match_jax(case):
    rng = np.random.default_rng(LAYER_CASES.index(case))
    x = rng.normal(size=(2, 12, 64)).astype(np.float32)
    if case == "rmsnorm":
        scale = rng.normal(size=(64,)).astype(np.float32)
        ref = jlayers.rmsnorm_apply({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6)
        out = tlayers.rmsnorm_apply({"scale": torch.from_numpy(scale)}, torch.from_numpy(x), 1e-6)
    elif case == "rope":
        xh = x.reshape(2, 12, 2, 32)
        pos = np.arange(12, dtype=np.int32)[None].repeat(2, 0) + 1000
        ref = jlayers.apply_rope(jnp.asarray(xh), jnp.asarray(pos), 1e6)
        out = tlayers.apply_rope(torch.from_numpy(xh), torch.from_numpy(pos), 1e6)
    elif case == "mrope":
        xh = x.reshape(2, 12, 2, 32)
        pos = rng.integers(0, 50, size=(3, 2, 12)).astype(np.int32)
        ref = jlayers.apply_mrope(jnp.asarray(xh), jnp.asarray(pos), (8, 4, 4), 1e6)
        out = tlayers.apply_mrope(torch.from_numpy(xh), torch.from_numpy(pos), (8, 4, 4), 1e6)
    elif case in ("swiglu", "geglu"):
        p = jlayers.mlp_init(jax.random.key(3), 64, 96, jnp.float32)
        ref = jlayers.mlp_apply(p, jnp.asarray(x), case)
        out = tlayers.mlp_apply(_t(p), torch.from_numpy(x), case)
    else:
        p = jlayers.dense_init(jax.random.key(4), 64, 48, jnp.float32, bias=True)
        p["b"] = jnp.asarray(rng.normal(size=(48,)).astype(np.float32))
        ref = jlayers.dense_apply(p, jnp.asarray(x))
        out = tlayers.dense_apply(_t(p), torch.from_numpy(x))
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-5, rtol=0)


def test_bf16_dot_and_unembed_round_as_jax():
    """``dot`` rounds the float32 sum once to bf16 and ``unembed_apply``
    returns float32, as the JAX package's ``preferred_element_type`` does."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 64)).astype(np.float32)
    w = rng.normal(size=(64, 40)).astype(np.float32)
    jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    tx, tw = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    out = tlayers.dot(tx, tw)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(out), _np(jlayers.dot(jx, jw)))
    logits = tlayers.unembed_apply({"emb": tw.t().contiguous()}, tx)
    assert logits.dtype == torch.float32
    ref = jlayers.unembed_apply({"emb": jw.T}, jx)
    np.testing.assert_allclose(_np(logits), _np(ref), atol=1e-4, rtol=0)


def test_bf16_logits_gradient_keeps_the_float32_cotangent():
    """The card's bf16 unembedding backward (``_Float32Logits``: the float32
    cotangent split into three bf16 terms) against JAX's vjp of the same
    bf16 operands, which transposes with the float32 cotangent and rounds
    once. Within one bf16 ulp (2**-7 relative) and at most 1% of elements
    off, from float32 sums in other orders; rounding the cotangent to bf16
    first puts about 43% of them off."""
    rng = np.random.default_rng(6)
    x = jnp.asarray(rng.normal(size=(64, 256)), jnp.bfloat16)
    emb = jnp.asarray(0.02 * rng.normal(size=(512, 256)), jnp.bfloat16)
    g = rng.normal(size=(64, 512)).astype(np.float32) * 1e-3
    _, vjp = jax.vjp(lambda a, e: jlayers.unembed_apply({"emb": e}, a), x, emb)
    want = vjp(jnp.asarray(g))
    tx = torch.from_numpy(_np(x)).bfloat16().requires_grad_(True)
    te = torch.from_numpy(_np(emb)).bfloat16().requires_grad_(True)
    got = torch.autograd.grad(tlayers._Float32Logits.apply(tx, te), (tx, te), torch.from_numpy(g))
    for mine, ref in zip(got, want):
        assert mine.dtype == torch.bfloat16
        a, b = mine.float().numpy(), _np(ref).astype(np.float32)
        assert np.all(np.abs(a - b) <= 2.0**-7 * np.abs(b))
        assert np.mean(a != b) <= 0.01, np.mean(a != b)


# ------------------------------------------------------------------ #
# attention
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("causal,window,q_chunk", [(True, 0, 8), (True, 6, 8), (False, 0, 32)])
def test_chunked_attention_matches_jax(causal, window, q_chunk):
    rng = np.random.default_rng(q_chunk + window)
    q = rng.normal(size=(2, 20, 4, 32)).astype(np.float32)
    k = rng.normal(size=(2, 20, 2, 32)).astype(np.float32)
    v = rng.normal(size=(2, 20, 2, 32)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_chunk=q_chunk, q_offset=3)
    ref = jattn.chunked_attention(*(jnp.asarray(a) for a in (q, k, v)), **kw)
    out = tattn.chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
    np.testing.assert_allclose(_np(out), _np(ref), atol=2e-5, rtol=0)


@pytest.mark.parametrize("window", [0, 5])
def test_decode_attention_matches_jax(window):
    rng = np.random.default_rng(9 + window)
    q = rng.normal(size=(2, 1, 4, 32)).astype(np.float32)
    kc = rng.normal(size=(2, 16, 2, 32)).astype(np.float32)
    vc = rng.normal(size=(2, 16, 2, 32)).astype(np.float32)
    for cache_len in (np.int32(11), np.array([7, 16], np.int32)):
        ref = jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                     cache_len=jnp.asarray(cache_len), window=window)
        out = tattn.decode_attention(torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
                                     cache_len=torch.from_numpy(np.asarray(cache_len)), window=window)
        np.testing.assert_allclose(_np(out), _np(ref), atol=2e-5, rtol=0)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_dense_block_matches_jax(attn_impl):
    jcfg, tcfg = _cfg(attn_impl=attn_impl)
    p = jblocks.block_init(jax.random.key(6), jcfg, "dense", jnp.float32)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(B, 10, jcfg.d_model)).astype(np.float32)
    pos = np.arange(10, dtype=np.int32)[None].repeat(B, 0)
    jc = jblocks.block_cache_init(jcfg, "dense", B, 16, jnp.float32)
    tc = tblocks.block_cache_init(tcfg, "dense", B, 16, torch.float32, CPU)
    assert_same_tree(tc, jc)
    jy, jc, _ = jblocks.block_apply(p, jnp.asarray(x), jnp.asarray(pos), jc, "full", jcfg, "dense")
    ty, tc, aux = tblocks.block_apply(_t(p), torch.from_numpy(x), torch.from_numpy(pos), tc,
                                      "full", tcfg, "dense")
    np.testing.assert_allclose(_np(ty), _np(jy), atol=2e-5, rtol=0)
    assert_same_tree(tc, jc, atol=2e-5)
    assert float(aux) == 0.0
    x1 = rng.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
    pos1 = np.full((B, 1), 10, np.int32)
    jy, jc, _ = jblocks.block_apply(p, jnp.asarray(x1), jnp.asarray(pos1), jc, "decode", jcfg, "dense")
    ty, tc, _ = tblocks.block_apply(_t(p), torch.from_numpy(x1), torch.from_numpy(pos1), tc,
                                    "decode", tcfg, "dense")
    np.testing.assert_allclose(_np(ty), _np(jy), atol=2e-5, rtol=0)
    assert_same_tree(tc, jc, atol=2e-5)


# ------------------------------------------------------------------ #
# prefill and serve steps
# ------------------------------------------------------------------ #
def _tokens(cfg, seed, seq):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(B, seq)).astype(np.int32)


def _serve_both(jcfg, tcfg, seq, steps, max_len, seed=0, vlm=False):
    """Prefill ``seq`` tokens and decode ``steps`` more in both packages on
    the JAX package's weights; returns [(port, jax)] of (logits, cache) per
    call, the prefill first. The port updates its cache in place, so each
    call's cache is recorded as a copy."""
    jb, tb = jax_build_model(jcfg), build_model(tcfg, "cpu")
    jparams = jb.init(jax.random.key(seed))
    tparams = _t(jparams)
    toks = _tokens(jcfg, seed, seq + steps)
    jbatch = {"tokens": jnp.asarray(toks[:, :seq])}
    tbatch = {"tokens": torch.from_numpy(toks[:, :seq])}
    if vlm:
        patches = 0.1 * np.random.default_rng(seed + 1).normal(
            size=(B, jcfg.vision_patches, jcfg.d_model)).astype(np.float32)
        pos = np.broadcast_to(np.arange(seq, dtype=np.int32)[None, None], (3, B, seq)).copy()
        pos[1:] //= 2  # distinct h/w streams
        jbatch.update(patch_embeds=jnp.asarray(patches), positions=jnp.asarray(pos))
        tbatch.update(patch_embeds=torch.from_numpy(patches), positions=torch.from_numpy(pos))
    jl, jc = jb.prefill(jparams, jbatch, jb.init_cache(B, max_len))
    tl, tc = tb.prefill(tparams, tbatch, tb.init_cache(B, max_len))
    out = [((tl, _clone(tc)), (jl, jc))]
    for i in range(steps):
        tok = toks[:, seq + i:seq + i + 1]
        jl, jc = jb.serve_step(jparams, jc, {"token": jnp.asarray(tok)})
        tl, tc = tb.serve_step(tparams, tc, {"token": torch.from_numpy(tok)})
        out.append(((tl, _clone(tc)), (jl, jc)))
    return out


def assert_states_close(port, ref, rel):
    """Same structure, dtypes and shapes; each leaf within ``rel`` of its
    largest magnitude (the recurrent states' tolerance)."""
    assert_same_tree(port, ref, values=False)
    for a, b in zip(_leaves(port), _leaves(_host(ref))):
        b = _np(b)
        np.testing.assert_allclose(_np(a), b, atol=rel * max(1.0, float(np.abs(b).max())), rtol=0)


def _check_calls(calls, dtype, state_rel=None):
    for (tl, tc), (jl, jc) in calls:
        assert tl.dtype == torch.float32 and tuple(tl.shape) == tuple(jl.shape)
        assert np.isfinite(_np(tl)).all()
        if dtype == "float32":
            np.testing.assert_allclose(_np(tl), _np(jl), atol=F32_LOGITS_ATOL, rtol=0)
            if state_rel:
                assert_states_close(tc, jc, state_rel)
            else:
                assert_same_tree(tc, jc, atol=F32_LOGITS_ATOL)
        else:
            assert _rel_l2(tl, jl) <= BF16_REL_L2
            assert_same_tree(tc, jc, atol=BF16_CACHE_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scan_layers", [False, True])
@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_prefill_and_serve_steps_match_jax(attn_impl, scan_layers, dtype):
    jcfg, tcfg = _cfg(attn_impl=attn_impl, scan_layers=scan_layers, param_dtype=dtype)
    calls = _serve_both(jcfg, tcfg, seq=40, steps=2, max_len=48)
    _check_calls(calls, dtype)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_gemma_reduced_matches_jax(attn_impl):
    """Gemma-7B's family traits at the reduced size: GeGLU, tied
    embeddings, as many kv heads as query heads."""
    jcfg, tcfg = _cfg("gemma_7b", attn_impl=attn_impl)
    assert tcfg.activation == "geglu" and tcfg.tie_embeddings
    assert tcfg.num_kv_heads == tcfg.num_heads
    calls = _serve_both(jcfg, tcfg, seq=40, steps=2, max_len=48)
    _check_calls(calls, "float32")


# the dense configs besides Qwen2.5-3B and Gemma-7B, reduced: DeepSeek-7B
# (MHA, 4/4 heads of 32), GLM4-9B (GQA 4/2, QKV bias, theta 1e6, untied)
DENSE = {"deepseek_7b": dict(num_kv_heads=4, qkv_bias=False, tie_embeddings=False),
         "glm4_9b": dict(num_kv_heads=2, qkv_bias=True, tie_embeddings=False,
                         rope_theta=1_000_000.0)}


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
@pytest.mark.parametrize("arch", list(DENSE))
def test_dense_reduced_matches_jax(arch, attn_impl):
    """The reduced DeepSeek-7B and GLM4-9B: prefill 40 tokens and decode 2
    more in both packages, float32, on the plain attention and the flash
    route; logits and caches within F32_LOGITS_ATOL."""
    jcfg, tcfg = _cfg(arch, attn_impl=attn_impl)
    assert {k: getattr(tcfg, k) for k in DENSE[arch]} == DENSE[arch]
    calls = _serve_both(jcfg, tcfg, seq=40, steps=2, max_len=48)
    _check_calls(calls, "float32")


@pytest.mark.parametrize("scan_layers", [False, True])
@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_prefill_and_serve_steps_match_jax(arch, scan_layers):
    """Prefill 32 tokens (two SSD chunks) and decode 3; Hymba's window of 64
    covers them, its attention on the flash route."""
    jcfg, tcfg = _cfg(arch, scan_layers=scan_layers, attn_impl="flash")
    calls = _serve_both(jcfg, tcfg, seq=32, steps=3, max_len=48)
    _check_calls(calls, "float32", state_rel=STATE_REL if arch == "xlstm_1_3b" else None)
    (_, tc), _ = calls[-1]
    assert int(tc["len"]) == 35


def _roll_ring(tree, shift):
    """A JAX cache tree with every ring buffer's slots (the ``k``, ``v`` and
    ``pos`` of an attention cache; a stacked leaf leads with its layer dim)
    rolled by ``shift``: the layout of a prefill longer than the window
    with position p at slot p mod W, which the port writes and the JAX
    package's decode steps assume (the JAX package's prefill keeps the
    last W positions at slots 0..W-1: ROADMAP fault n)."""
    if isinstance(tree, dict):
        if {"k", "v", "pos"} <= set(tree):
            return dict(tree, k=jnp.roll(tree["k"], shift, axis=-3),
                        v=jnp.roll(tree["v"], shift, axis=-3),
                        pos=jnp.roll(tree["pos"], shift, axis=-1))
        return {k: _roll_ring(v, shift) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_roll_ring(v, shift) for v in tree)
    return tree


def _serve_ring(jcfg, tcfg, seq, steps, max_len):
    """``_serve_both``'s calls, with the JAX side's decode steps run from
    its prefill's cache rolled into the ring layout (``_roll_ring``): the
    port's prefill cache against the rolled one, and each step's logits
    and cache against the JAX package's decode from there."""
    W = tcfg.sliding_window
    jb, tb = jax_build_model(jcfg), build_model(tcfg, "cpu")
    jparams = jb.init(jax.random.key(0))
    tparams = _t(jparams)
    toks = _tokens(jcfg, 0, seq + steps)
    jl, jc = jb.prefill(jparams, {"tokens": jnp.asarray(toks[:, :seq])}, jb.init_cache(B, max_len))
    jc = _roll_ring(jc, seq % W)
    tl, tc = tb.prefill(tparams, {"tokens": torch.from_numpy(toks[:, :seq])},
                        tb.init_cache(B, max_len))
    out = [((tl, _clone(tc)), (jl, jc))]
    for i in range(steps):
        tok = toks[:, seq + i:seq + i + 1]
        jl, jc = jb.serve_step(jparams, jc, {"token": jnp.asarray(tok)})
        tl, tc = tb.serve_step(tparams, tc, {"token": torch.from_numpy(tok)})
        out.append(((tl, _clone(tc)), (jl, jc)))
    return out, (jparams, toks)


def _long_decode_cfgs(attn_impl):
    """The reduced Qwen2.5-3B's long-decode variant (window 64) in both
    packages."""
    jcfg = dataclasses.replace(
        jax_long_decode_variant(jax_get_config("qwen2_5_3b")).reduced(), attn_impl=attn_impl)
    tcfg = dataclasses.replace(
        long_decode_variant(get_config("qwen2_5_3b")).reduced(), attn_impl=attn_impl)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg) and tcfg.sliding_window == 64
    return jcfg, tcfg


def _check_against_forward(calls, jcfg, jparams, toks, seq):
    """Each call's logits (the prefill's last position, then each decode
    step's) against the JAX package's uncached forward over the whole
    sequence at the same positions."""
    from repro.models import transformer as jtransformer

    full, _, _ = jtransformer.forward(jparams, jcfg, tokens=jnp.asarray(toks))
    for i, ((tl, _), _) in enumerate(calls):
        np.testing.assert_allclose(_np(tl[:, -1]), _np(full[:, seq - 1 + i]),
                                   atol=F32_LOGITS_ATOL, rtol=0)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_hymba_ring_cache_matches_jax(attn_impl):
    """Hymba's window of 64 with an 80-token prompt (five SSD chunks): the
    prefill keeps the last 64 keys at their ring slots (the JAX package's
    cache rolled by 80 mod 64), and the decode steps wrap the ring: logits
    and caches against the JAX package's decode from the rolled cache."""
    jcfg, tcfg = _cfg("hymba_1_5b", attn_impl=attn_impl)
    calls, _ = _serve_ring(jcfg, tcfg, seq=80, steps=3, max_len=90)
    (_, tc), _ = calls[-1]
    assert tc["layers"][0]["attn"]["k"].shape[1] == 64
    _check_calls(calls, "float32")


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_long_decode_variant_ring_cache_matches_jax(attn_impl):
    """Window 64 with an 80-token prompt: the prefill keeps the last 64 keys
    in a ring buffer (the JAX package's cache rolled by 80 mod 64) and the
    decode steps wrap it under the window mask; their logits against the
    JAX package's uncached forward (its own decode reads the wrong slots
    here), their caches against its decode from the rolled cache."""
    jcfg, tcfg = _long_decode_cfgs(attn_impl)
    calls, (jparams, toks) = _serve_ring(jcfg, tcfg, seq=80, steps=3, max_len=90)
    (_, tc), _ = calls[-1]
    assert tc["layers"][0]["attn"]["k"].shape[1] == 64
    assert int(tc["len"]) == 83
    _check_calls(calls, "float32")
    _check_against_forward(calls, jcfg, jparams, toks, 80)


@pytest.mark.parametrize("seq", [80, 112, 128])
def test_ring_cache_decode_matches_the_uncached_forward(seq):
    """A prefill past the window (64) that it does not divide (80, 112) or
    does (128), then 4 decode steps: the port's logits against the JAX
    package's uncached forward over the whole sequence (float32)."""
    jcfg, tcfg = _long_decode_cfgs("xla")
    tb = build_model(tcfg, "cpu")
    jparams = jax_build_model(jcfg).init(jax.random.key(seq))
    tparams = _t(jparams)
    toks = _tokens(jcfg, seq, seq + 4)
    tl, tc = tb.prefill(tparams, {"tokens": torch.from_numpy(toks[:, :seq])},
                        tb.init_cache(B, seq + 4))
    calls = [((tl, None), None)]
    for i in range(4):
        tl, tc = tb.serve_step(tparams, tc, {"token": torch.from_numpy(toks[:, seq + i:seq + i + 1])})
        calls.append(((tl, None), None))
    _check_against_forward(calls, jcfg, jparams, toks, seq)


def test_qwen2_vl_reduced_matches_jax():
    jcfg, tcfg = _cfg("qwen2_vl_2b", attn_impl="flash")
    assert tcfg.rope_type == "mrope" and tcfg.family == "vlm"
    calls = _serve_both(jcfg, tcfg, seq=24, steps=2, max_len=32, vlm=True)
    _check_calls(calls, "float32")


@pytest.mark.parametrize("scan_layers", [False, True])
@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_decode_matches_teacher_forcing(attn_impl, scan_layers):
    """The twin of ``tests/test_models.py::test_decode_matches_teacher_forcing``
    on the port's own init: incremental decode equals the full forward at
    the last position."""
    cfg = dataclasses.replace(get_config("qwen2_5_3b", reduced=True),
                              attn_impl=attn_impl, scan_layers=scan_layers)
    bundle = build_model(cfg, "cpu")
    params = bundle.init(torch.Generator().manual_seed(2))
    toks = torch.from_numpy(_tokens(cfg, 2, 16))
    full, _, _ = transformer.forward(params, cfg, tokens=toks)
    _, cache = bundle.prefill(params, {"tokens": toks[:, :-1]}, bundle.init_cache(B, 64))
    logits_d, _ = bundle.serve_step(params, cache, {"token": toks[:, -1:]})
    np.testing.assert_allclose(_np(full[:, -1]), _np(logits_d[:, 0]), atol=F32_LOGITS_ATOL, rtol=0)


@pytest.mark.parametrize("scan_layers", [False, True])
@pytest.mark.parametrize("arch", RECURRENT + ("gemma_7b",))
def test_recurrent_decode_matches_teacher_forcing(arch, scan_layers):
    """``tests/test_models.py::test_decode_matches_teacher_forcing``'s
    recurrent and Gemma cases on the port's own init: a prefill of 15
    tokens (one SSD chunk of 15) and a decode step against the full
    forward of 16, atol 2e-4."""
    cfg = dataclasses.replace(get_config(arch, reduced=True), scan_layers=scan_layers)
    bundle = build_model(cfg, "cpu")
    params = bundle.init(torch.Generator().manual_seed(2))
    toks = torch.from_numpy(_tokens(cfg, 2, 16))
    full, _, _ = transformer.forward(params, cfg, tokens=toks)
    _, cache = bundle.prefill(params, {"tokens": toks[:, :-1]}, bundle.init_cache(B, 64))
    logits_d, _ = bundle.serve_step(params, cache, {"token": toks[:, -1:]})
    np.testing.assert_allclose(_np(full[:, -1]), _np(logits_d[:, 0]), atol=F32_LOGITS_ATOL, rtol=0)


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_forward_and_train_step(arch):
    """``TestArchSmoke.test_forward_and_train_step`` for the recurrent
    families: the loss against the JAX package's (rtol 1e-5) on its weights,
    loss and gradients finite, and the reference's norm-clipped SGD step
    does not raise the loss."""
    from repro_torch.core.tree import tree_flatten, tree_unflatten
    from repro_torch.fl.fedstep import value_and_grad

    jcfg, tcfg = _cfg(arch)
    jb, tb = jax_build_model(jcfg), build_model(tcfg, "cpu")
    key = jax.random.key(0)
    jparams = jb.init(key)
    toks = _tokens(jcfg, 1, 64)
    jloss = jb.loss_fn(jparams, {"tokens": jnp.asarray(toks)}, key)
    params = _t(jparams)
    leaves, treedef = tree_flatten(params)
    batch = {"tokens": torch.from_numpy(toks)}
    loss, grads = value_and_grad(tb.loss_fn, leaves, treedef, batch, None)
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    gnorm = sum(float(torch.sum(torch.square(g.float()))) for g in grads)
    assert np.isfinite(gnorm) and gnorm > 0
    scale = 0.1 / max(1.0, np.sqrt(gnorm))
    new = tree_unflatten(treedef, [w - scale * g for w, g in zip(leaves, grads)])
    with torch.no_grad():
        loss2 = tb.loss_fn(new, batch, None)
    assert float(loss2) < float(loss) + 1e-3


@pytest.mark.parametrize("variant", ["layers", "groups_bf16"])
@pytest.mark.parametrize("arch", RECURRENT + ("gemma_7b",))
def test_recurrent_trees_have_the_jax_structure(arch, variant):
    """Parameters, caches and input specs with the JAX package's structure,
    shapes and dtypes: in a bf16 model the SSD's ``a_log`` and ``d_skip``
    and every recurrent state stay float32."""
    kw = {} if variant == "layers" else {"scan_layers": True, "param_dtype": "bfloat16"}
    jcfg, tcfg = _cfg(arch, **kw)
    jb, tb = jax_build_model(jcfg), build_model(tcfg, "cpu")
    assert_same_tree(tb.init_cache(B, 24), jb.init_cache(B, 24))
    jparams = jb.init(jax.random.key(0))
    tparams = tb.init(torch.Generator().manual_seed(0))
    assert_same_tree(tparams, jparams, values=False)
    assert_same_tree(_t(jparams), jparams)
    if arch != "gemma_7b":
        stack = tparams["groups"][0] if tcfg.scan_layers else tparams["layers"][0]
        assert stack["ssd"]["a_log"].dtype == stack["ssd"]["d_skip"].dtype == torch.float32
    from repro.models.config import SHAPES as JSHAPES
    from repro_torch.models.config import SHAPES
    for kind in ("prefill_32k", "decode_32k"):
        assert_same_tree(tb.input_specs(SHAPES[kind]), jb.input_specs(JSHAPES[kind]), values=False)


@pytest.mark.parametrize("variant", ["layers", "groups", "window", "bf16"])
def test_trees_have_the_jax_structure(variant):
    kw = {"layers": {}, "groups": {"scan_layers": True}, "window": {"sliding_window": 8},
          "bf16": {"param_dtype": "bfloat16", "scan_layers": True}}[variant]
    jcfg, tcfg = _cfg(**kw)
    jb, tb = jax_build_model(jcfg), build_model(tcfg, "cpu")
    assert_same_tree(tb.init_cache(B, 24), jb.init_cache(B, 24))
    jparams = jb.init(jax.random.key(0))
    assert_same_tree(tb.init(torch.Generator().manual_seed(0)), jparams, values=False)
    assert_same_tree(_t(jparams), jparams)
    for kind in ("prefill_32k", "decode_32k"):
        from repro.models.config import SHAPES as JSHAPES
        from repro_torch.models.config import SHAPES
        assert_same_tree(tb.input_specs(SHAPES[kind]), jb.input_specs(JSHAPES[kind]), values=False)


def test_init_draws_from_the_generator():
    cfg = get_config("qwen2_5_3b", reduced=True)
    bundle = build_model(cfg, "cpu")
    a = bundle.init(torch.Generator().manual_seed(1))
    b = bundle.init(torch.Generator().manual_seed(1))
    c = bundle.init(torch.Generator().manual_seed(2))
    assert torch.equal(a["embed"]["emb"], b["embed"]["emb"])
    assert not torch.equal(a["embed"]["emb"], c["embed"]["emb"])
    w = a["layers"][0]["attn"]["wq"]["w"]
    assert abs(float(w.std()) - cfg.d_model**-0.5) < 0.1 * cfg.d_model**-0.5
    assert torch.equal(a["layers"][0]["attn"]["wq"]["b"], torch.zeros(cfg.q_dim))


def test_what_is_not_ported_raises():
    """Every family of the JAX package builds, serves and trains, over a
    model axis too (tests/test_torch_tensor_parallel.py) and on a grid of
    data and model ranks (tests/test_torch_fsdp.py); ``build_train_step``
    refuses an FSDP config on a mesh whose data axis is larger than 1 given
    a group of the model axis alone (its data axis runs as processes), and
    any model axis > 1 without the rank's group."""
    from repro_torch.core.mesh_lowering import Mesh
    from repro_torch.launch.steps import build_train_step
    from repro_torch.launch.tensor_parallel import ModelGroup

    for arch in ("hymba_1_5b", "xlstm_1_3b", "seamless_m4t_medium"):
        bundle = build_model(get_config(arch, reduced=True), "cpu")
        assert bundle.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="runs as the grid"):
        build_train_step(get_config("qwen3_moe_235b_a22b", reduced=True),
                         Mesh((("data", 2), ("model", 2))), device="cpu",
                         group=ModelGroup(rank=0, size=2))
    with pytest.raises(ValueError, match="runs as 2 processes"):
        build_train_step(get_config("qwen2_5_3b", reduced=True),
                         Mesh((("data", 1), ("model", 2))), device="cpu")
    # training is ported (tests/test_torch_train.py): the loss is a 0-d
    # float32 tensor; only the forward-only flash kernel refuses to train
    cfg = get_config("qwen2_5_3b", reduced=True)
    bundle = build_model(cfg, "cpu")
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    loss = bundle.loss_fn(bundle.init(torch.Generator().manual_seed(0)), {"tokens": tokens}, None)
    assert loss.dtype == torch.float32 and loss.shape == ()
    flash = build_model(dataclasses.replace(cfg, attn_impl="flash"), "cpu")
    with pytest.raises(ValueError, match="forward only"):
        flash.loss_fn(flash.init(torch.Generator().manual_seed(0)), {"tokens": tokens}, None)
    with pytest.raises(ValueError, match="generator"):
        build_model(get_config("qwen2_5_3b", reduced=True), "meta").init(torch.Generator())


def test_build_model_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(get_config("qwen2_5_3b", reduced=True))


def test_full_config_prefill_shapes_on_meta():
    """The full Qwen2.5-3B (36 layers, scan_layers) through the port's
    prefill and a decode step on meta tensors: shapes and dtypes only, no
    memory, no arithmetic."""
    cfg = get_config("qwen2_5_3b")
    assert cfg.scan_layers and cfg.param_dtype == "bfloat16" and cfg.num_layers == 36
    dev = torch.device("meta")
    dt = torch.bfloat16
    layer = {
        "attn": {"wk": {"b": (cfg.kv_dim,), "w": (cfg.d_model, cfg.kv_dim)},
                 "wo": {"w": (cfg.q_dim, cfg.d_model)},
                 "wq": {"b": (cfg.q_dim,), "w": (cfg.d_model, cfg.q_dim)},
                 "wv": {"b": (cfg.kv_dim,), "w": (cfg.d_model, cfg.kv_dim)}},
        "ln1": {"scale": (cfg.d_model,)}, "ln2": {"scale": (cfg.d_model,)},
        "mlp": {"down": {"w": (cfg.d_ff, cfg.d_model)}, "gate": {"w": (cfg.d_model, cfg.d_ff)},
                "up": {"w": (cfg.d_model, cfg.d_ff)}},
    }

    def stacked(t):
        if isinstance(t, dict):
            return {k: stacked(v) for k, v in t.items()}
        return torch.empty((cfg.num_layers,) + t, dtype=dt, device=dev)

    params = {"embed": {"emb": torch.empty((cfg.padded_vocab, cfg.d_model), dtype=dt, device=dev)},
              "groups": (stacked(layer),),
              "ln_f": {"scale": torch.empty((cfg.d_model,), dtype=dt, device=dev)}}
    assert sum(x.numel() for x in _leaves(params)) == 3_086_200_832
    cache = transformer.init_cache(cfg, 2, 40, dev)
    toks = torch.zeros((2, 32), dtype=torch.int32, device=dev)
    h, cache, _ = transformer.forward_hidden(params, cfg, tokens=toks, cache=cache)
    assert h.shape == (2, 32, cfg.d_model) and h.dtype == dt
    logits, cache = transformer.decode_step(params, cfg, toks[:, :1], cache)
    assert logits.shape == (2, 1, cfg.vocab_size) and logits.dtype == torch.float32


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves(v)]
    return [tree]
