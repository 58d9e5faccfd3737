"""The port's serve loop (``repro_torch.launch.serve``) on the CPU.

``main`` runs the JAX CLI's loop with ``--device cpu``; ``generate`` on the
JAX package's weights and prompts gives, at float32 and greedy, the token
ids of the JAX package's own loop (``repro.launch.serve``: ``prefill``,
argmax, ``serve_step``), under both attention implementations, for the
dense config and for the recurrent and encoder-decoder families (the audio
model on the loop's stub frames, zeros of (B, ``frontend_len``, d)).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.api import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve
from repro_torch.models.api import build_model


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_host(v) for v in tree)
    return np.asarray(tree)


def _jax_greedy(bundle, params, prompts, gen):
    """The JAX package's serve loop (``repro.launch.serve.main``), greedy."""
    B, S = prompts.shape
    cache = bundle.init_cache(B, S + gen)
    batch = {"tokens": jnp.asarray(prompts)}
    if bundle.cfg.family == "audio":
        batch["frames"] = jnp.zeros((B, bundle.cfg.frontend_len, bundle.cfg.d_model))
    logits, cache = bundle.prefill(params, batch, cache)
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    out = [tok]
    for _ in range(gen - 1):
        logits, cache = bundle.serve_step(params, cache, {"token": tok})
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        out.append(tok)
    return np.asarray(jnp.concatenate(out, axis=1))


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_greedy_tokens_equal_the_jax_loop(attn_impl):
    jcfg = dataclasses.replace(jax_get_config("qwen2_5_3b", reduced=True), attn_impl=attn_impl)
    tcfg = dataclasses.replace(get_config("qwen2_5_3b", reduced=True), attn_impl=attn_impl)
    jb, tb = jax_build_model(jcfg), build_model(tcfg, "cpu")
    jparams = jb.init(jax.random.key(0))
    prompts = np.random.default_rng(0).integers(0, jcfg.vocab_size, size=(3, 24)).astype(np.int32)
    want = _jax_greedy(jb, jparams, prompts, gen=8)
    out = serve.generate(tb, params_from_jax(_host(jparams), "cpu"), torch.from_numpy(prompts), 8)
    assert out.tokens.shape == (3, 8) and out.tokens.dtype == torch.int32
    np.testing.assert_array_equal(out.tokens.numpy(), want)
    assert out.all_finite
    assert out.prefill_s >= 0 and out.decode_s >= 0


@pytest.mark.parametrize("arch,prompt", [("hymba_1_5b", 32), ("xlstm_1_3b", 32),
                                         ("seamless_m4t_medium", 24)])
def test_recurrent_and_encdec_greedy_tokens_equal_the_jax_loop(arch, prompt):
    """Prompts of two SSD chunks for the recurrent families; the audio
    model on the loop's zero frames, and on given frames against the
    JAX package's prefill of the same frames."""
    jcfg = dataclasses.replace(jax_get_config(arch, reduced=True), attn_impl="flash")
    tcfg = dataclasses.replace(get_config(arch, reduced=True), attn_impl="flash")
    jb, tb = jax_build_model(jcfg), build_model(tcfg, "cpu")
    jparams = jb.init(jax.random.key(1))
    tparams = params_from_jax(_host(jparams), "cpu")
    prompts = np.random.default_rng(1).integers(0, jcfg.vocab_size, size=(2, prompt))
    prompts = prompts.astype(np.int32)
    want = _jax_greedy(jb, jparams, prompts, gen=6)
    out = serve.generate(tb, tparams, torch.from_numpy(prompts), 6)
    np.testing.assert_array_equal(out.tokens.numpy(), want)
    assert out.all_finite
    if jcfg.family == "audio":
        frames = (0.1 * np.random.default_rng(2).normal(
            size=(2, jcfg.frontend_len, jcfg.d_model))).astype(np.float32)
        jbatch = {"tokens": jnp.asarray(prompts), "frames": jnp.asarray(frames)}
        logits, _ = jb.prefill(jparams, jbatch, jb.init_cache(2, prompt + 1))
        got = serve.generate(tb, tparams, torch.from_numpy(prompts), 1,
                             frames=torch.from_numpy(frames))
        want = np.asarray(jnp.argmax(logits[:, -1:], -1))
        np.testing.assert_array_equal(got.tokens.numpy(), want)


@pytest.mark.parametrize("argv", [
    ["--reduced", "--device", "cpu", "--batch", "2", "--prompt-len", "12", "--gen", "4"],
    ["--arch", "qwen2_vl_2b", "--reduced", "--device", "cpu", "--attn-impl", "flash",
     "--batch", "2", "--prompt-len", "20", "--gen", "3", "--temperature", "0.8"],
    ["--arch", "xlstm_1_3b", "--reduced", "--device", "cpu", "--batch", "2", "--prompt-len", "16",
     "--gen", "3"],
    ["--arch", "seamless_m4t_medium", "--reduced", "--device", "cpu", "--attn-impl", "flash",
     "--batch", "2", "--prompt-len", "10", "--gen", "3"],
])
def test_main_runs_on_the_cpu(argv, capsys):
    assert serve.main(argv) == 0
    printed = capsys.readouterr().out
    assert "[serve] prefill" in printed and "[serve] sample token ids:" in printed


def test_sampling_follows_the_generator():
    cfg = get_config("qwen2_5_3b", reduced=True)
    bundle = build_model(cfg, "cpu")
    params = bundle.init(torch.Generator().manual_seed(0))
    prompts = torch.randint(0, cfg.vocab_size, (2, 10), generator=torch.Generator().manual_seed(1))

    def sample(seed):
        gen = torch.Generator().manual_seed(seed)
        return serve.generate(bundle, params, prompts, 6, temperature=1.0, generator=gen).tokens

    assert torch.equal(sample(5), sample(5))
    assert not torch.equal(sample(5), sample(6))
    with pytest.raises(ValueError, match="gen"):
        serve.generate(bundle, params, prompts, 0)


def test_main_needs_the_card_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced"])


def _numpy_seeded(tree, seed: int):
    """The JAX init's tree with every leaf drawn anew from numpy: each
    leaf's mean plus normal noise at its spread (0.02 where the init's is
    0: the norm scales and biases)."""
    rng = np.random.default_rng(seed)

    def draw(x):
        x = np.asarray(x)
        spread = max(float(np.std(x)), 0.02)
        return (float(np.mean(x)) + spread * rng.normal(size=x.shape)).astype(x.dtype)

    return jax.tree_util.tree_map(draw, tree)


def test_float32_flash_serving_at_head_dim_128_equals_the_jax_loop():
    """The float32 flash path at Qwen2.5's head dim and GQA 2:1 (the path
    ``flash.cu`` serves on the card): a reduced Qwen2.5 (2 layers, d_model
    256, 4/2 heads of 128), numpy-seeded weights, through the JAX package's
    serve loop (its Pallas kernel in interpret mode) and the port's (the
    plain version). Prefill logits within relative L2 1e-5 (float32 sums in
    other orders: they read 1.3e-6) and the greedy tokens equal."""
    over = dict(head_dim=128, num_heads=4, num_kv_heads=2, param_dtype="float32", attn_impl="flash")
    jcfg = dataclasses.replace(jax_get_config("qwen2_5_3b", reduced=True), **over)
    tcfg = dataclasses.replace(get_config("qwen2_5_3b", reduced=True), **over)
    jb, tb = jax_build_model(jcfg), build_model(tcfg, "cpu")
    host = _numpy_seeded(_host(jb.init(jax.random.key(0))), 27)
    jparams = jax.tree_util.tree_map(jnp.asarray, host)
    tparams = params_from_jax(host, "cpu")
    prompts = np.random.default_rng(3).integers(0, jcfg.vocab_size, size=(2, 40)).astype(np.int32)
    want_logits, _ = jb.prefill(jparams, {"tokens": jnp.asarray(prompts)}, jb.init_cache(2, 41))
    got_logits, _ = tb.prefill(tparams, {"tokens": torch.from_numpy(prompts)}, tb.init_cache(2, 41))
    want_logits = np.asarray(want_logits, np.float64)
    got = got_logits.double().numpy()
    assert got.shape == want_logits.shape
    assert np.linalg.norm(got - want_logits) / np.linalg.norm(want_logits) <= 1e-5
    want = _jax_greedy(jb, jparams, prompts, gen=6)
    out = serve.generate(tb, tparams, torch.from_numpy(prompts), 6)
    np.testing.assert_array_equal(out.tokens.numpy(), want)
    assert out.all_finite
