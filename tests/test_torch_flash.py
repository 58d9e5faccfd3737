"""The port's flash attention (``repro_torch.kernels.flash_attention``) against
the JAX package's, on the CPU.

On the CPU the port's wrapper runs the plain version (``ref.py``); it is
held against the JAX package's Pallas kernel in interpret mode and its
``reference_attention``, on the same numpy inputs, at the JAX package's own
tolerances (``tests/test_kernels.py``): atol 2e-5 in float32, 3e-2 in
bfloat16. The CUDA kernel's tiling cannot run here; its schedule (which KV
tiles a q tile visits, and the online softmax over them) is replayed in
numpy by ``_tiled_online_softmax`` and held to the same tolerance, so the
tile-skipping argument in ``csrc/flash.cu`` is tested on the CPU too. The
kernel itself is held against the plain version on the card by
``test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import reference_attention as jax_reference
from repro_torch.kernels.flash_attention import kernel, ref
from repro_torch.kernels.flash_attention.ops import flash_attention

F32_ATOL, BF16_ATOL = 2e-5, 3e-2
# the five cases of tests/test_kernels.py::TestFlashAttention
CASES = [
    (2, 128, 4, 2, 64, True, 0),   # GQA
    (1, 256, 4, 4, 32, True, 0),   # MHA
    (2, 192, 8, 1, 64, True, 64),  # MQA + sliding window
    (1, 128, 4, 2, 64, False, 0),  # bidirectional (encoder)
    (1, 200, 2, 2, 32, True, 0),   # unpadded -> padding path
]
# the CUDA kernel's (BQ, BK) per head dim (csrc/flash.cu, dispatch)
KERNEL_TILES = {32: (64, 64), 64: (64, 64), 128: (64, 32), 256: (32, 32)}


def _inputs(seed, B, S, H, Hkv, D, Skv=None):
    rng = np.random.default_rng(seed)
    Skv = S if Skv is None else Skv
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    k = rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32)
    return q, k, v


def _port(q, k, v, dtype=torch.float32, **kw):
    t = [torch.from_numpy(x).to(dtype) for x in (q, k, v)]
    out = flash_attention(*t, **kw)
    assert out.dtype == dtype and out.shape == t[0].shape
    return out.float().numpy()


@pytest.mark.parametrize("B,S,H,Hkv,D,causal,window", CASES)
def test_matches_jax_flash_and_reference(B, S, H, Hkv, D, causal, window):
    q, k, v = _inputs(S + H + window, B, S, H, Hkv, D)
    out = _port(q, k, v, causal=causal, window=window, block_q=64, block_k=64)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    pallas = np.asarray(jax_flash(jq, jk, jv, causal=causal, window=window, block_q=64, block_k=64))
    oracle = np.asarray(jax_reference(jq, jk, jv, causal=causal, window=window))
    np.testing.assert_allclose(out, pallas, atol=F32_ATOL)
    np.testing.assert_allclose(out, oracle, atol=F32_ATOL)


def test_bf16_matches_jax():
    q, k, v = _inputs(0, 1, 128, 4, 2, 64)
    out = _port(q, k, v, dtype=torch.bfloat16, block_q=64, block_k=64)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    pallas = jax_flash(jq, jk, jv, block_q=64, block_k=64)
    assert pallas.dtype == jnp.bfloat16
    oracle = jax_reference(jq, jk, jv)
    np.testing.assert_allclose(out, np.asarray(pallas, np.float32), atol=BF16_ATOL)
    np.testing.assert_allclose(out, np.asarray(oracle, np.float32), atol=BF16_ATOL)


@pytest.mark.parametrize("S", [64, 96, 160])
@pytest.mark.parametrize("D", [16, 32])
@pytest.mark.parametrize("block", [32, 64])
def test_block_shape_sweep(S, D, block):
    """The sweep of ``test_block_shape_sweep``: the port's result does not
    depend on the block sizes, the JAX kernel's at each of them agrees."""
    q, k, v = _inputs(S * D, 1, S, 2, 2, D)
    out = _port(q, k, v, block_q=block, block_k=block)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    pallas = np.asarray(jax_flash(jq, jk, jv, block_q=block, block_k=block))
    np.testing.assert_allclose(out, pallas, atol=F32_ATOL)
    np.testing.assert_allclose(out, np.asarray(jax_reference(jq, jk, jv)), atol=F32_ATOL)


def test_bf16_bits_cross_as_in_jax():
    """bf16 inputs rounded from the same float32 values are the same bits in
    both packages, so the bf16 comparisons above start from equal inputs."""
    x = np.random.default_rng(3).normal(size=1000).astype(np.float32)
    port = torch.from_numpy(x).to(torch.bfloat16).view(torch.uint16).numpy()
    assert port.tobytes() == x.astype(ml_dtypes.bfloat16).tobytes()


# ------------------------------------------------------------------ #
# the CUDA kernel's schedule, replayed in numpy
# ------------------------------------------------------------------ #
def _tiled_online_softmax(q, k, v, *, causal, window, BQ, BK):
    """(B, S, H, D) float32 -> (B, S, H, D): the tile ranges and the
    online-softmax updates of csrc/flash.cu (visit only the KV tiles with a
    valid key for some row of the q tile), in float32 numpy."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = np.float32(D**-0.5)
    neg = np.float32(-1e30)
    out = np.zeros_like(q)
    for q0 in range(0, Sq, BQ):
        rows = np.arange(q0, min(q0 + BQ, Sq))
        k_end = min(Skv, q0 + BQ) if causal else Skv
        k_begin = max(0, q0 - window + 1) if window > 0 else 0
        k_begin -= k_begin % BK
        for h in range(H):
            qt = q[:, rows, h]  # (B, r, D)
            m = np.full((B, len(rows)), neg, np.float32)
            l = np.zeros((B, len(rows)), np.float32)
            acc = np.zeros((B, len(rows), D), np.float32)
            for k0 in range(k_begin, k_end, BK):
                keys = np.arange(k0, min(k0 + BK, Skv))
                s = np.einsum("brd,bkd->brk", qt, k[:, keys, h // G]) * scale
                ok = keys[None, :] < Skv
                if causal:
                    ok = ok & (keys[None, :] <= rows[:, None])
                if window:
                    ok = ok & (keys[None, :] > rows[:, None] - window)
                s = np.where(ok[None], s, neg).astype(np.float32)
                m_new = np.maximum(m, s.max(-1))
                p = np.exp(s - m_new[..., None])
                alpha = np.exp(m - m_new)
                l = alpha * l + p.sum(-1)
                acc = acc * alpha[..., None] + np.einsum("brk,bkd->brd", p, v[:, keys, h // G])
                m = m_new
            out[:, rows, h] = acc / np.maximum(l, np.float32(1e-30))[..., None]
    return out


@pytest.mark.parametrize("B,S,H,Hkv,D,causal,window", CASES + [
    (1, 200, 4, 1, 128, True, 64),   # window rows whose first visited tiles are all masked
    (1, 130, 2, 2, 256, True, 0),    # D 256 tiles, ragged
    (1, 97, 2, 1, 32, False, 40),    # non-causal window
])
def test_kernel_schedule_matches_jax(B, S, H, Hkv, D, causal, window):
    q, k, v = _inputs(7 * S + D, B, S, H, Hkv, D)
    BQ, BK = KERNEL_TILES[D]
    tiled = _tiled_online_softmax(q, k, v, causal=causal, window=window, BQ=BQ, BK=BK)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    np.testing.assert_allclose(tiled, np.asarray(jax_reference(jq, jk, jv, causal=causal, window=window)),
                               atol=F32_ATOL)


# ------------------------------------------------------------------ #
# the wrapper
# ------------------------------------------------------------------ #
def test_wrapper_on_cpu_is_the_plain_version_and_does_not_count():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 2, 40, 4, 2, 32))
    kernel.reset_launches()
    out = kernel.flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                      causal=True, window=8)
    assert out.shape == (2, 4, 40, 32)
    assert torch.equal(out.transpose(1, 2), ref.reference_attention(q, k, v, causal=True, window=8))
    assert kernel.flash_attention_bhsd.launches == 0


def test_kv_len_masks_the_tail():
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, 1, 24, 2, 2, 32))
    short = ref.reference_attention(q, k[:, :20], v[:, :20], causal=False)
    masked = ref.reference_attention(q, k, v, causal=False, kv_len=20)
    torch.testing.assert_close(masked, short, atol=F32_ATOL, rtol=0)


def test_wrapper_refuses_what_neither_version_takes():
    q, k, v = (torch.from_numpy(x) for x in _inputs(4, 1, 16, 4, 2, 32))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="share a dtype"):
        flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        flash_attention(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="Hkv, Skv"):
        flash_attention(q, k, v[..., :16])
    with pytest.raises(ValueError, match="empty sequence"):
        flash_attention(q, k[:, :0], v[:, :0])
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, v, window=-1)
    with pytest.raises(ValueError, match="block sizes"):
        flash_attention(q, k, v, block_q=0)
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
