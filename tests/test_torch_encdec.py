"""The port's encoder-decoder family (``repro_torch.models.encdec``, the
``audio`` bundle of ``models.api``) against the JAX package's, on the CPU,
at the reduced SeamlessM4T-medium (2 encoder and 2 decoder layers, d_model
256, 4/4 heads of 32, 16 stub frames, vocab 512).

Weights come from the JAX package's init (``params_from_jax``); tokens and
frames (``0.1 * normal``) from a numpy seed. Tolerances are those of
``tests/test_torch_models.py``: float32 hidden states and logits atol 2e-4
(the JAX package's teacher-forcing bound), the loss rtol 1e-5
(``tests/test_torch_train.py``); bfloat16 logits within a relative L2 of
2e-2 and caches atol 5e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.encdec as jencdec
import repro_torch.models.blocks as tblocks
import repro_torch.models.encdec as tencdec
from repro.configs import get_config as jax_get_config
from repro.models.api import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.tree import tree_flatten, tree_unflatten
from repro_torch.fl.fedstep import value_and_grad
from repro_torch.models.api import build_model

from test_torch_models import _clone, _host, _np, _rel_l2, assert_same_tree

CPU = torch.device("cpu")
ARCH = "seamless_m4t_medium"
B = 2
ATOL = 2e-4
BF16_REL_L2, BF16_CACHE_ATOL = 2e-2, 5e-2


def _cfg(**kw):
    jcfg = dataclasses.replace(jax_get_config(ARCH, reduced=True), **kw)
    tcfg = dataclasses.replace(get_config(ARCH, reduced=True), **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _inputs(cfg, seed, seq):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, seq)).astype(np.int32)
    frames = (0.1 * rng.normal(size=(B, cfg.frontend_len, cfg.d_model))).astype(np.float32)
    return toks, frames


def _both(seed=0, **kw):
    jcfg, tcfg = _cfg(**kw)
    jparams = jencdec.init_params(jax.random.key(seed), jcfg)
    return jcfg, tcfg, jparams, params_from_jax(_host(jparams), CPU)


def test_encode_matches_jax():
    jcfg, tcfg, jp, tp = _both()
    _, frames = _inputs(jcfg, 0, 4)
    want = jencdec.encode(jp, jcfg, jnp.asarray(frames))
    got = tencdec.encode(tp, tcfg, torch.from_numpy(frames))
    assert got.shape == (B, jcfg.frontend_len, jcfg.d_model) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_decode_forward_matches_jax(attn_impl):
    jcfg, tcfg, jp, tp = _both(1, attn_impl=attn_impl)
    toks, frames = _inputs(jcfg, 1, 24)
    jmem = jencdec.encode(jp, jcfg, jnp.asarray(frames))
    tmem = tencdec.encode(tp, tcfg, torch.from_numpy(frames))
    jl, jc, jaux = jencdec.decode_forward(jp, jcfg, jnp.asarray(toks), jmem)
    tl, tc, taux = tencdec.decode_forward(tp, tcfg, torch.from_numpy(toks), tmem)
    assert jc is None and tc is None and float(taux) == float(jaux) == 0.0
    assert tl.shape == (B, 24, jcfg.vocab_size) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)


def test_lm_loss_and_train_step():
    """The loss against the JAX package's, and ``TestArchSmoke``'s step:
    loss and gradients finite, a norm-clipped SGD step does not raise the
    loss."""
    jcfg, tcfg, jp, tp = _both(2)
    toks, frames = _inputs(jcfg, 2, 32)
    jloss = jencdec.lm_loss(jp, jcfg, jnp.asarray(toks), jnp.asarray(frames))
    bundle = build_model(tcfg, "cpu")
    batch = {"tokens": torch.from_numpy(toks), "frames": torch.from_numpy(frames)}
    leaves, treedef = tree_flatten(tp)
    loss, grads = value_and_grad(bundle.loss_fn, leaves, treedef, batch, None)
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(tencdec.lm_loss(tp, tcfg, batch["tokens"], batch["frames"])),
                               float(jloss), rtol=1e-5)
    gnorm = sum(float(torch.sum(torch.square(g))) for g in grads)
    assert np.isfinite(gnorm) and gnorm > 0
    # every parameter takes part: the encoder through the cross-attention
    assert all(float(g.abs().max()) > 0 for g in grads)
    scale = 0.1 / max(1.0, np.sqrt(gnorm))
    new = tree_unflatten(treedef, [w - scale * g for w, g in zip(leaves, grads)])
    with torch.no_grad():
        loss2 = bundle.loss_fn(new, batch, None)
    assert float(loss2) < float(loss) + 1e-3


def _serve_both(jcfg, tcfg, seq, steps, max_len, seed=0):
    jb, tb = jax_build_model(jcfg), build_model(tcfg, "cpu")
    jparams = jb.init(jax.random.key(seed))
    tparams = params_from_jax(_host(jparams), CPU)
    toks, frames = _inputs(jcfg, seed, seq + steps)
    # both packages get the same float32 frames: the encoder runs in their
    # dtype and the cross K/V in the memory's, in a bf16 model too
    jl, jc = jb.prefill(jparams, {"tokens": jnp.asarray(toks[:, :seq]),
                                  "frames": jnp.asarray(frames)}, jb.init_cache(B, max_len))
    tl, tc = tb.prefill(tparams, {"tokens": torch.from_numpy(toks[:, :seq]),
                                  "frames": torch.from_numpy(frames)}, tb.init_cache(B, max_len))
    out = [((tl, _clone(tc)), (jl, jc))]
    for i in range(steps):
        tok = toks[:, seq + i:seq + i + 1]
        jl, jc = jb.serve_step(jparams, jc, {"token": jnp.asarray(tok)})
        tl, tc = tb.serve_step(tparams, tc, {"token": torch.from_numpy(tok)})
        out.append(((tl, _clone(tc)), (jl, jc)))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scan_layers", [False, True])
@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_prefill_and_serve_steps_match_jax(attn_impl, scan_layers, dtype):
    """Logits and the whole cache (self-attention rings, the cross K/V
    projected once at prefill, ``len``) after a prefill of 20 tokens and
    each of 3 decode steps, on float32 frames: a bf16 model's cross K/V are
    float32 in both packages. (The encoder-decoder stacks its layers either
    way: ``scan_layers`` changes nothing in either package.)"""
    jcfg, tcfg = _cfg(attn_impl=attn_impl, scan_layers=scan_layers, param_dtype=dtype)
    calls = _serve_both(jcfg, tcfg, seq=20, steps=3, max_len=32)
    for (tl, tc), (jl, jc) in calls:
        assert tc["layers"]["cross_k"].dtype == tc["layers"]["cross_v"].dtype == torch.float32
        assert tl.dtype == torch.float32
        assert tuple(tl.shape) == tuple(jl.shape) == (B, 1, jcfg.vocab_size)
        if dtype == "float32":
            np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL, rtol=0)
            assert_same_tree(tc, jc, atol=ATOL)
        else:
            assert _rel_l2(tl, jl) <= BF16_REL_L2
            assert_same_tree(tc, jc, atol=BF16_CACHE_ATOL)
    (_, tc), _ = calls[-1]
    assert int(tc["len"]) == 23


def test_decode_matches_teacher_forcing():
    """``tests/test_models.py::test_decode_matches_teacher_forcing``'s audio
    case on the port's own init: a prefill of 15 tokens and a decode step
    against the full decoder over 16, atol 2e-4."""
    cfg = get_config(ARCH, reduced=True)
    bundle = build_model(cfg, "cpu")
    params = bundle.init(torch.Generator().manual_seed(2))
    toks, frames = (torch.from_numpy(a) for a in _inputs(cfg, 2, 16))
    memory = tencdec.encode(params, cfg, frames)
    full, _, _ = tencdec.decode_forward(params, cfg, toks, memory)
    _, cache = bundle.prefill(params, {"tokens": toks[:, :-1], "frames": frames},
                              bundle.init_cache(B, 64))
    logits_d, _ = bundle.serve_step(params, cache, {"token": toks[:, -1:]})
    np.testing.assert_allclose(_np(full[:, -1]), _np(logits_d[:, 0]), atol=ATOL, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trees_have_the_jax_structure(dtype):
    """The stacked ``encoder`` / ``decoder`` trees and the cache in the JAX
    package's key order (its ``tree_map`` stacking sorts them), shapes and
    dtypes; the JAX tree carries across unchanged; the input specs match."""
    jcfg, tcfg = _cfg(param_dtype=dtype)
    jb, tb = jax_build_model(jcfg), build_model(tcfg, "cpu")
    assert_same_tree(tb.init_cache(B, 24), jb.init_cache(B, 24))
    jparams = jb.init(jax.random.key(0))
    tparams = tb.init(torch.Generator().manual_seed(0))
    assert_same_tree(tparams, jparams, values=False)
    assert_same_tree(params_from_jax(_host(jparams), CPU), jparams)
    assert tparams["encoder"]["attn"]["wq"]["w"].shape[0] == jcfg.encoder_layers
    from repro.models.config import SHAPES as JSHAPES
    from repro_torch.models.config import SHAPES
    for kind in ("prefill_32k", "decode_32k"):
        assert_same_tree(tb.input_specs(SHAPES[kind]), jb.input_specs(JSHAPES[kind]), values=False)


def test_flash_reaches_only_the_decoder_self_attention(monkeypatch):
    """Under ``attn_impl="flash"`` one flash call a decoder layer per
    prefill (the encoder and the cross-attention stay on the plain
    attention) and none per decode step."""
    calls = []
    real = tblocks.flash_attention

    def counting(q, k, v, **kw):
        calls.append((tuple(q.shape), kw["causal"]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(tblocks, "flash_attention", counting)
    cfg = dataclasses.replace(get_config(ARCH, reduced=True), attn_impl="flash")
    bundle = build_model(cfg, "cpu")
    params = bundle.init(torch.Generator().manual_seed(3))
    toks, frames = (torch.from_numpy(a) for a in _inputs(cfg, 3, 12))
    logits, cache = bundle.prefill(params, {"tokens": toks, "frames": frames},
                                   bundle.init_cache(B, 16))
    assert calls == [((B, 12, cfg.num_heads, cfg.head_dim), True)] * cfg.num_layers
    bundle.serve_step(params, cache, {"token": toks[:, :1]})
    assert len(calls) == cfg.num_layers


def test_generator_and_flash_training_refused():
    cfg = dataclasses.replace(get_config(ARCH, reduced=True), attn_impl="flash")
    with pytest.raises(ValueError, match="generator"):
        build_model(cfg, "meta").init(torch.Generator())
    bundle = build_model(cfg, "cpu")
    params = bundle.init(torch.Generator().manual_seed(0))
    toks, frames = _inputs(bundle.cfg, 0, 4)
    with pytest.raises(ValueError, match="forward only"):
        bundle.loss_fn(params, {"tokens": torch.from_numpy(toks),
                                "frames": torch.from_numpy(frames)}, None)


def test_bf16_model_encodes_in_the_frames_dtype():
    """A bf16 model on float32 frames: the encoder runs in float32 on the
    bf16 weights' values, as the JAX package's does, so its memory is
    float32 and within the float32 tolerance of JAX's."""
    jcfg, tcfg, jp, tp = _both(4, param_dtype="bfloat16")
    _, frames = _inputs(jcfg, 4, 4)
    want = jencdec.encode(jp, jcfg, jnp.asarray(frames))
    got = tencdec.encode(tp, tcfg, torch.from_numpy(frames))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
