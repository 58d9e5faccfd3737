"""The port's flash attention (``repro_torch.kernels.flash_attention``) against
the JAX package's, on the CPU.

On the CPU the port's wrapper runs the plain version (``ref.py``); it is
held against the JAX package's Pallas kernel in interpret mode and its
``reference_attention``, on the same numpy inputs, at the JAX package's own
tolerances (``tests/test_kernels.py``): atol 2e-5 in float32, 3e-2 in
bfloat16. The CUDA kernels' tiling cannot run here. The schedule of
``csrc/flash.cu`` (which KV tiles a q tile visits and which of them each
warp's rows skip, and the online softmax over them in exp2) is replayed in
numpy by ``_tiled_online_softmax`` and held to the same tolerance, so its
tile-skipping argument is tested on the CPU too; the schedule and numerics
of the tensor-core kernels ``csrc/flash_sm90.cu`` and
``csrc/flash_sm90_d256.cu`` (two 64-row warpgroups per 128-row q tile,
128- or 64-key tiles, exp2, P rounded to bf16) by ``_sm90_replay`` at each
kernel's tiles, held to the bf16 limits their output meets on the card
(atol 3e-2, relative L2 5e-3). The wrapper's route table is tested here
with the launches replaced by recorders. The kernels themselves are held
against the plain version on the card by ``test_torch_gpu.py`` and
``chip_smoke.py``.
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
# the CUDA kernel's (q rows per block, keys per KV tile, q rows per warp)
# per head dim (csrc/flash.cu, Tile<D>)
KERNEL_TILES = {32: (128, 64, 16), 64: (128, 64, 16), 128: (128, 64, 16), 256: (64, 64, 8)}


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
def _tiled_online_softmax(q, k, v, *, causal, window, BQ, BK, RW):
    """(B, S, H, D) float32 -> (B, S, H, D): the tile ranges and the
    online-softmax updates of csrc/flash.cu, in float32 numpy: a block of
    BQ rows loads the KV tiles with a valid key for some of its rows; each
    warp's RW rows skip a loaded tile wholly masked for them; scores in
    log2 units (the scale times log2 e, rounded to float32 as the host
    computes it) and exp2."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    c = np.float32(float(np.float32(D**-0.5)) * np.log2(np.e))
    neg = np.float32(-1e30)
    out = np.zeros_like(q)
    for q0 in range(0, Sq, BQ):
        k_end = min(Skv, q0 + BQ) if causal else Skv
        k_begin = max(0, q0 - window + 1) if window > 0 else 0
        k_begin -= k_begin % BK
        for w0 in range(q0, min(q0 + BQ, Sq), RW):
            rows = np.arange(w0, min(w0 + RW, Sq))
            w1 = w0 + RW - 1
            for h in range(H):
                qt = q[:, rows, h]  # (B, r, D)
                m = np.full((B, len(rows)), neg, np.float32)
                l = np.zeros((B, len(rows)), np.float32)
                acc = np.zeros((B, len(rows), D), np.float32)
                for k0 in range(k_begin, k_end, BK):
                    if (causal and k0 > w1) or (window > 0 and k0 + BK - 1 <= w0 - window):
                        continue  # wholly masked for this warp's rows
                    keys = np.arange(k0, min(k0 + BK, Skv))
                    s = np.einsum("brd,bkd->brk", qt, k[:, keys, h // G]).astype(np.float32) * c
                    ok = keys[None, :] < Skv
                    if causal:
                        ok = ok & (keys[None, :] <= rows[:, None])
                    if window:
                        ok = ok & (keys[None, :] > rows[:, None] - window)
                    s = np.where(ok[None], s, neg).astype(np.float32)
                    m_new = np.maximum(m, s.max(-1))
                    p = np.exp2(s - m_new[..., None])
                    alpha = np.exp2(m - m_new)
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
    BQ, BK, RW = KERNEL_TILES[D]
    tiled = _tiled_online_softmax(q, k, v, causal=causal, window=window, BQ=BQ, BK=BK, RW=RW)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    np.testing.assert_allclose(tiled, np.asarray(jax_reference(jq, jk, jv, causal=causal, window=window)),
                               atol=F32_ATOL)


# ------------------------------------------------------------------ #
# the tensor-core kernel's schedule and numerics, replayed in numpy
# ------------------------------------------------------------------ #
# (q tile, KV tile, a warpgroup's rows) per head dim: kBQ, the KV tile and 64
# of csrc/flash_sm90.cu (D 32, 64, 128) and csrc/flash_sm90_d256.cu (D 256)
SM90_TILES = {32: (128, 64, 64), 64: (128, 128, 64), 128: (128, 128, 64), 256: (128, 64, 64)}
BF16_REL_L2 = 5e-3  # chip_smoke.py's FLASH_REL_L2 for bfloat16


def _bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).bfloat16().float().numpy()


def _sm90_replay(q, k, v, *, causal, window, tiles=None):
    """(B, S, H, D) float32 holding bf16 values -> (B, S, H, D) float32
    holding bf16 values: what the tensor-core kernels compute at ``tiles``
    = (q tile, KV tile, a warpgroup's rows), by default the kernel of q's
    head dim (``SM90_TILES``). The q tiles split into 64-row warpgroups
    that visit the same KV tiles; the
    mask applied only on a tile that crosses the diagonal, the window's edge
    or kv_len for some row of the warpgroup; scores in log2 units (the scale
    times log2 e, rounded to float32, as the host computes it) and exp2;
    P rounded to bf16 before P V; l kept as four partial sums per row, one
    per lane of the quad (the columns 2 (l % 4) + {0, 1} of each 8), summed
    over the quad at the end as the two shuffles do."""
    B, Sq, H, D = q.shape
    BQ, BK, HALF = SM90_TILES[D] if tiles is None else tiles
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    c = np.float32(float(np.float32(D**-0.5)) * np.log2(np.e))
    neg = np.float32(-1e30)
    lane_of_col = (np.arange(BK) % 8) // 2
    out = np.zeros_like(q)
    for q0 in range(0, Sq, BQ):
        k_end = min(Skv, q0 + BQ) if causal else Skv
        k_begin = max(0, q0 - window + 1) if window > 0 else 0
        k_begin -= k_begin % BK
        for lo in range(q0, q0 + BQ, HALF):
            rows = np.arange(lo, min(lo + HALF, Sq))
            if rows.size == 0:
                continue
            hi = lo + HALF - 1
            for h in range(H):
                qt = q[:, rows, h]
                m = np.full((B, rows.size), neg, np.float32)
                l4 = np.zeros((B, rows.size, 4), np.float32)
                acc = np.zeros((B, rows.size, D), np.float32)
                for k0 in range(k_begin, k_end, BK):
                    keys = np.arange(k0, k0 + BK)
                    kt = np.zeros((B, BK, D), np.float32)  # TMA fills past Skv with zeros
                    vt = np.zeros((B, BK, D), np.float32)
                    live = keys < Skv
                    kt[:, live] = k[:, keys[live], h // G]
                    vt[:, live] = v[:, keys[live], h // G]
                    s = np.einsum("brd,bkd->brk", qt, kt).astype(np.float32) * c
                    if (k0 + BK > Skv or (causal and k0 + BK - 1 > lo)
                            or (window > 0 and k0 <= hi - window)):
                        ok = keys[None, :] < Skv
                        if causal:
                            ok = ok & (keys[None, :] <= rows[:, None])
                        if window:
                            ok = ok & (keys[None, :] > rows[:, None] - window)
                        s = np.where(ok[None], s, neg)
                    m_new = np.maximum(m, s.max(-1))
                    alpha = np.exp2(m - m_new)
                    p = np.exp2(s - m_new[..., None]).astype(np.float32)
                    part = np.stack([p[..., lane_of_col == j].sum(-1) for j in range(4)], -1)
                    l4 = alpha[..., None] * l4 + part
                    acc = acc * alpha[..., None] + np.einsum("brk,bkd->brd", _bf16(p), vt)
                    m = m_new
                l = (l4[..., 0] + l4[..., 1]) + (l4[..., 2] + l4[..., 3])
                out[:, rows, h] = _bf16(acc / np.maximum(l, np.float32(1e-30))[..., None])
    return out


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("B,S,H,Hkv,D,causal,window", [
    (2, 256, 4, 2, 64, True, 0),     # D 64, causal, GQA
    (1, 384, 4, 2, 128, True, 0),    # D 128, causal
    (1, 256, 4, 4, 128, False, 0),   # non-causal
    (1, 400, 4, 1, 128, True, 100),  # window rows whose first visited tiles are all masked
    (2, 300, 4, 2, 64, True, 0),     # ragged S: the last q tile and KV tile run past it
    (1, 97, 2, 1, 64, False, 40),    # non-causal window, one ragged tile
    (1, 512, 8, 1, 128, True, 0),    # S 512, GQA 8:1
    # D 32: 64-key tiles, the 64-byte swizzle's head dim
    (1, 256, 4, 4, 32, True, 0),     # causal, MHA
    (1, 200, 2, 2, 32, True, 0),     # ragged S
    (1, 97, 2, 1, 32, False, 40),    # non-causal window, one ragged tile
    (1, 300, 8, 1, 32, True, 100),   # window rows whose first visited tiles are all masked
    (1, 256, 16, 1, 32, False, 0),   # non-causal, GQA 16:1
    # csrc/flash_sm90_d256.cu's tiles: 128-row q tiles, 64-key tiles
    (1, 256, 2, 2, 256, True, 0),    # D 256, causal
    (1, 192, 2, 1, 256, False, 0),   # non-causal
    (1, 320, 2, 1, 256, True, 100),  # window rows whose first visited tiles are all masked
    (2, 200, 2, 2, 256, True, 0),    # ragged S: the last q tile and KV tile run past it
    (1, 256, 8, 1, 256, True, 0),    # GQA 8:1
])
def test_sm90_kernel_replay_matches_jax(B, S, H, Hkv, D, causal, window):
    """The tensor-core kernels' schedule and numerics (at the tiles of the
    kernel that takes D) against the JAX package's reference and its
    Pallas kernel (interpret mode) on the same bf16 inputs: bf16 atol 3e-2
    and relative L2 5e-3, the limits their output is held to on the card."""
    q, k, v = (_bf16(x) for x in _inputs(11 * S + D + window, B, S, H, Hkv, D))
    replay = _sm90_replay(q, k, v, causal=causal, window=window)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    oracle = np.asarray(jax_reference(jq, jk, jv, causal=causal, window=window), np.float32)
    pallas = np.asarray(jax_flash(jq, jk, jv, causal=causal, window=window), np.float32)
    for want in (oracle, pallas):
        np.testing.assert_allclose(replay, want, atol=BF16_ATOL)
        assert _rel_l2(replay, want) <= BF16_REL_L2


def _other_key_lengths(Sq, Skv, causal, D):
    rng = np.random.default_rng(Sq + Skv)
    q = _bf16(rng.normal(size=(1, Sq, 4, D)))
    k, v = (_bf16(rng.normal(size=(1, Skv, 2, D))) for _ in range(2))
    replay = _sm90_replay(q, k, v, causal=causal, window=0)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    oracle = np.asarray(jax_reference(jq, jk, jv, causal=causal), np.float32)
    np.testing.assert_allclose(replay, oracle, atol=BF16_ATOL)
    assert _rel_l2(replay, oracle) <= BF16_REL_L2


@pytest.mark.parametrize("Sq,Skv,causal", [(100, 300, False), (100, 300, True), (300, 130, True)])
def test_sm90_replay_with_other_key_lengths(Sq, Skv, causal):
    """Queries and keys of different lengths (the wrapper passes kv_len =
    Skv): the replay against the JAX package's reference, bf16 limits."""
    _other_key_lengths(Sq, Skv, causal, 128)


@pytest.mark.parametrize("Sq,Skv,causal", [(100, 300, False), (100, 300, True), (300, 130, True)])
def test_sm90_d32_replay_with_other_key_lengths(Sq, Skv, causal):
    """The same at D 32, at csrc/flash_sm90.cu's 64-key tiles."""
    _other_key_lengths(Sq, Skv, causal, 32)


@pytest.mark.parametrize("Sq,Skv,causal", [(100, 300, False), (100, 300, True), (300, 130, True)])
def test_sm90_d256_replay_with_other_key_lengths(Sq, Skv, causal):
    """The same at D 256, at csrc/flash_sm90_d256.cu's tiles."""
    _other_key_lengths(Sq, Skv, causal, 256)


def test_sm90_replay_sees_a_dropped_tile():
    """The replay's limits can see a fault of the kernel's size: with the
    causal diagonal's mask skipped on the tiles that need it (the tile keys
    above the diagonal leak in), relative L2 reads far above 5e-3."""
    q, k, v = (_bf16(x) for x in _inputs(5, 1, 256, 2, 2, 64))
    good = _sm90_replay(q, k, v, causal=True, window=0)
    leaky = _sm90_replay(q, k, v, causal=False, window=0)
    oracle = np.asarray(jax_reference(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))), np.float32)
    assert _rel_l2(good, oracle) <= BF16_REL_L2 < _rel_l2(leaky, oracle)


# ------------------------------------------------------------------ #
# the wrapper
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("dtype,D,route", [
    (torch.bfloat16, 64, "flash_forward_sm90"),
    (torch.bfloat16, 128, "flash_forward_sm90"),
    (torch.bfloat16, 32, "flash_forward_sm90"),
    (torch.bfloat16, 256, "flash_forward_sm90_d256"),
    (torch.float32, 64, "flash_forward"),
    (torch.float32, 128, "flash_forward"),
    (torch.float32, 32, "flash_forward"),
    (torch.float32, 256, "flash_forward"),
])
def test_route_table(monkeypatch, dtype, D, route):
    """dtype and head dim alone pick the kernel (the table of kernel.py's
    docstring); the mask does not. Run on CPU tensors with the CUDA checks
    and the launches replaced by recorders."""
    called = []
    monkeypatch.setattr(kernel, "_check", lambda *a: True)
    monkeypatch.setattr(kernel, "ROUTES", {
        name: (lambda q, k, v, name=name, **kw: called.append(name) or q) for name in kernel.ROUTES})
    assert kernel.route_of(dtype, D) == route
    q, k, v = (torch.from_numpy(x).to(dtype).transpose(1, 2) for x in _inputs(0, 1, 16, 2, 1, D))
    for causal, window in [(True, 0), (False, 0), (True, 8)]:
        kernel.flash_attention_bhsd(q, k, v, causal=causal, window=window)
    assert called == [route] * 3


def test_tma_refuses_misaligned_bf16_and_does_not_reroute(monkeypatch):
    """A bf16 D-32, D-128 or D-256 tensor that TMA cannot read raises on its
    tensor-core route; it is not sent to flash.cu (which takes such tensors
    when called directly)."""
    B, S, H = 1, 16, 2
    monkeypatch.setattr(kernel, "_check", lambda *a: True)
    monkeypatch.setattr(kernel, "flash_forward", lambda *a, **kw: pytest.fail("rerouted"))
    monkeypatch.setitem(kernel.ROUTES, "flash_forward", kernel.flash_forward)
    for D in (32, 128, 256):
        flat = torch.zeros(B * S * H * D + 1, dtype=torch.bfloat16)
        shifted = flat[1:].view(B, S, H, D).transpose(1, 2)  # starts 2 bytes into a granule
        padded = torch.zeros(B, S, H, D + 4, dtype=torch.bfloat16)[..., :D].transpose(1, 2)
        good = torch.zeros(B, S, H, D, dtype=torch.bfloat16).transpose(1, 2)
        assert kernel.tma_strides(good) == (S * H * D, D, H * D)
        with pytest.raises(ValueError, match="16-byte-aligned"):
            kernel.flash_attention_bhsd(shifted, good, good)
        with pytest.raises(ValueError, match="multiples of 16 bytes"):  # rows of D + 4 elements
            kernel.flash_attention_bhsd(good, padded, good)
    # a dimension of one element is never stepped: its stride is rounded up, not refused
    single = torch.zeros(S * D, dtype=torch.bfloat16).as_strided((1, 1, S, D), (3, 5, D, 1))
    assert kernel.tma_strides(single) == (8, 8, D)


def test_routes_refuse_cpu_tensors_and_count_nothing():
    kernel.reset_launches()
    for D in (64, 256):
        q, k, v = (torch.from_numpy(x).bfloat16().transpose(1, 2)
                   for x in _inputs(3, 1, 16, 2, 1, D))
        for fn in (kernel.flash_forward, kernel.flash_forward_sm90, kernel.flash_forward_sm90_d256):
            with pytest.raises(ValueError, match="launches a CUDA kernel"):
                fn(q, k, v)
        kernel.flash_attention_bhsd(q, k, v)
    assert [fn.launches for fn in kernel.KERNELS] == [0, 0, 0, 0]


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
