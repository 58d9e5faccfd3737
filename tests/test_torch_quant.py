"""The port's quant layer (kernels/quant and fl/compression) against the JAX
package's, on the CPU.

The JAX package's ``quantize_flat`` is jitted; on the CPU it runs the jnp
reference, which XLA compiles with the constant divide ``/ 127.0`` turned
into a multiply by float32(1/127). The port's plain version does that
multiply, so q and scale are bit-equal to it; against the Pallas kernel in
interpret mode q is equal and the scale within one ulp (the JAX package's
own bound, ``tests/test_kernels.py``). Dequantize is bit-equal. The CUDA
kernels are held against the same plain versions on the card by
``test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.fl.compression as jcomp
import repro_torch.fl.compression as tcomp
from repro.kernels.quant.kernel import dequantize_blocks as jax_dequantize_blocks
from repro.kernels.quant.kernel import quantize_blocks as jax_quantize_blocks
from repro.kernels.quant.ops import compress_tree as jax_compress_tree
from repro.kernels.quant.ops import decompress_tree as jax_decompress_tree
from repro.kernels.quant.ops import dequantize_flat as jax_dequantize_flat
from repro.kernels.quant.ops import quantize_flat as jax_quantize_flat
from repro_torch.convert import tree_from_numpy, tree_to_numpy
from repro_torch.kernels.quant import kernel, ops, ref

BLOCK = 4096


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _jax_quant(x):
    q, s = jax_quantize_flat(jnp.asarray(x))
    return np.asarray(q), np.asarray(s)


def _port_quant(x):
    q, s = ops.quantize_flat(_t(x))
    return q.numpy(), s.numpy()


def _spread(rng, nb, n=None):
    """Blocks whose magnitudes span about 1e-6 to 1e3."""
    x = rng.normal(size=(nb, BLOCK)) * np.exp(rng.uniform(-14, 7, size=(nb, 1)))
    x = x.astype(np.float32).ravel()
    return x if n is None else x[:n]


def edge_case_input(rng):
    """Blocks of the chip's codec phase, at the CPU's size: all zero,
    all -0.0, subnormals, +-3e38 among small values, exact half-way ties at
    scales 1 and 2, then NaN and +-inf blocks (compared by scale)."""
    x = rng.normal(size=(9, BLOCK)).astype(np.float32)
    x[0] = 0.0
    x[1] = -0.0
    x[2] = np.sign(x[2]) * rng.uniform(0, 1.1e-38, BLOCK).astype(np.float32)
    x[3] *= np.float32(1e-3)
    x[3, :2] = (3e38, -3e38)
    k = rng.integers(-127, 127, BLOCK).astype(np.float32)
    x[4] = k + np.float32(0.5)
    x[4, 0] = 127.0
    x[5] = 2 * k + 1
    x[5, 0] = 254.0
    x[6, 17] = np.nan
    x[7, 5] = np.inf
    x[8, 9] = -np.inf
    return x


# ------------------------------------------------------------------ #
# the flat layer against the JAX package's CPU path: bit-equal
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("nb,n", [(1, None), (3, None), (257, None), (5, 3 * BLOCK + 1234), (1, 1)])
def test_quantize_flat_bit_equal_to_jax_cpu(nb, n):
    x = _spread(np.random.default_rng(nb + (n or 0)), nb, n)
    jq, js = _jax_quant(x)
    tq, ts = _port_quant(x)
    assert tq.shape == jq.shape and ts.shape == js.shape
    assert tq.tobytes() == jq.tobytes()
    assert ts.tobytes() == js.tobytes()
    d_jax = np.asarray(jax_dequantize_flat(jnp.asarray(jq), jnp.asarray(js), x.size))
    d_port = ops.dequantize_flat(_t(tq), _t(ts), x.size).numpy()
    assert d_port.shape == (x.size,) and d_port.tobytes() == d_jax.tobytes()


def test_scale_is_the_reciprocal_multiply_not_an_ieee_divide():
    """What the bit-equality rests on: the JAX package's jitted scale is
    ``max(absmax, 1e-30) * f32(1/127)``, which differs from the IEEE divide
    in some blocks; the port's plain version computes the same multiply."""
    x = _spread(np.random.default_rng(3), 512)
    _, js = _jax_quant(x)
    absmax = np.maximum(np.abs(x.reshape(-1, BLOCK)).max(1), np.float32(1e-30))
    recip = absmax * np.float32(ref.INV_127)
    ieee = absmax / np.float32(127)
    assert js.ravel().tobytes() == recip.tobytes()
    assert (js.ravel() != ieee).any()
    assert np.float32(ref.INV_127) == np.float32(1) / np.float32(127)


def test_edge_blocks_match_jax_cpu():
    x = edge_case_input(np.random.default_rng(9))
    jq, js = _jax_quant(x.ravel())
    tq, ts = _port_quant(x.ravel())
    assert tq[:6].tobytes() == jq[:6].tobytes()
    assert np.array_equal(ts, js, equal_nan=True)
    assert ts[4, 0] == 1.0 and ts[5, 0] == 2.0
    # half to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, -0.5 -> 0, -1.5 -> -2
    np.testing.assert_array_equal(tq[4], np.round(x[4]).astype(np.int8))
    np.testing.assert_array_equal(tq[5], np.round(x[5] / 2).astype(np.int8))
    assert not tq[:2].any() and not tq[2].any()
    assert ts[0, 0] == np.float32(1e-30) * np.float32(ref.INV_127)
    assert np.isnan(ts[6, 0]) and ts[7, 0] == np.inf and ts[8, 0] == np.inf
    d_jax = np.asarray(jax_dequantize_flat(jnp.asarray(jq), jnp.asarray(js), x.size))
    d_port = ops.dequantize_flat(_t(jq), _t(js), x.size).numpy()
    assert np.array_equal(d_port, d_jax, equal_nan=True)
    assert d_port[:6 * BLOCK].tobytes() == d_jax[:6 * BLOCK].tobytes()


def test_against_the_pallas_kernel_in_interpret_mode():
    """Pallas (interpreted) vs the port: q identical, scale within one ulp,
    dequantize of the same inputs bit-identical."""
    x = (np.random.default_rng(1).normal(size=(12, BLOCK)) * 2.5).astype(np.float32)
    pq, ps = jax_quantize_blocks(jnp.asarray(x), interpret=True)
    tq, ts = ref.quantize_blocks(_t(x))
    assert np.array_equal(np.asarray(pq), tq.numpy())
    ulps = np.abs(np.asarray(ps).view(np.int32).astype(np.int64) - ts.numpy().view(np.int32))
    assert ulps.max() <= 1
    pd = jax_dequantize_blocks(pq, ps, interpret=True)
    td = ref.dequantize_blocks(_t(np.asarray(pq)), _t(np.asarray(ps)))
    assert np.asarray(pd).tobytes() == td.numpy().tobytes()


def test_compress_tree_matches_jax():
    rng = np.random.default_rng(4)
    tree = {"w": rng.normal(size=(33, 7)).astype(np.float32),
            "b": [rng.normal(size=(5000,)).astype(np.float32), rng.normal(size=(3,)).astype(np.float64)]}
    jpay, jspec = jax_compress_tree(jax.tree_util.tree_map(jnp.asarray, tree))
    tpay, tspec = ops.compress_tree(tree_from_numpy(tree, "cpu"))
    assert tpay["q"].numpy().tobytes() == np.asarray(jpay["q"]).tobytes()
    assert tpay["scale"].numpy().tobytes() == np.asarray(jpay["scale"]).tobytes()
    assert tspec[2] == jspec[2]
    jback = jax_decompress_tree(jpay, jspec)
    tback = tree_to_numpy(ops.decompress_tree(tpay, tspec))
    for a, b in zip(jax.tree_util.tree_leaves(jback), jax.tree_util.tree_leaves(tback)):
        assert np.asarray(a).shape == b.shape
        assert np.asarray(a).astype(b.dtype).tobytes() == b.tobytes()


# ------------------------------------------------------------------ #
# wrapper contract
# ------------------------------------------------------------------ #
def test_wrappers_run_plain_versions_on_the_cpu_and_count_nothing():
    kernel.reset_launches()
    x = _t(_spread(np.random.default_rng(0), 2).reshape(2, BLOCK))
    q, s = kernel.quantize_blocks(x)
    pq, ps = ref.quantize_blocks(x)
    assert torch.equal(q, pq) and torch.equal(s, ps)
    assert torch.equal(kernel.dequantize_blocks(q, s), ref.dequantize_blocks(q, s))
    assert kernel.quantize_blocks.launches == 0 and kernel.dequantize_blocks.launches == 0


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(2, BLOCK)
    with pytest.raises(TypeError):
        kernel.quantize_blocks(x.double())
    with pytest.raises(ValueError):
        kernel.quantize_blocks(torch.zeros(2, 1024))
    with pytest.raises(ValueError):
        kernel.quantize_blocks(torch.zeros(BLOCK, 2).t())  # not contiguous
    with pytest.raises(ValueError, match="unsupported device"):
        kernel.quantize_blocks(torch.zeros(2, BLOCK, device="meta"))
    q = torch.zeros(2, BLOCK, dtype=torch.int8)
    with pytest.raises(ValueError):
        kernel.dequantize_blocks(q, torch.zeros(3, 1))
    with pytest.raises(TypeError):
        kernel.dequantize_blocks(q.float(), torch.zeros(2, 1))
    with pytest.raises(ValueError, match="different devices"):
        kernel.dequantize_blocks(q, torch.zeros(2, 1, device="meta"))


# ------------------------------------------------------------------ #
# fl/compression against the JAX package's
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_int8_matches_jax(seed):
    x = (np.random.default_rng(seed).normal(size=(64, 33)) * 10.0 ** (seed - 1)).astype(np.float32)
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    tq, ts = tcomp.quantize_int8(_t(x))
    assert tq.numpy().tobytes() == np.asarray(jq).tobytes()
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    jd = np.asarray(jcomp.dequantize_int8(jq, js))
    assert tcomp.dequantize_int8(tq, ts).numpy().tobytes() == jd.tobytes()


def test_quantize_int8_zero_tensor_scale_is_one():
    q, s = tcomp.quantize_int8(torch.zeros(5))
    assert float(s) == 1.0 and not q.any()


def test_topk_breaks_ties_by_lower_index_like_jax():
    rng = np.random.default_rng(5)
    x = rng.integers(-4, 5, size=(40, 7)).astype(np.float32)  # many ties
    for k in (1, 9, 100, 280, 500):
        jv, ji = jcomp.topk_sparsify(jnp.asarray(x), k)
        tv, ti = tcomp.topk_sparsify(_t(x), k)
        assert ti.numpy().astype(np.int32).tobytes() == np.asarray(ji).astype(np.int32).tobytes()
        assert tv.numpy().tobytes() == np.asarray(jv).tobytes()
        jd = np.asarray(jcomp.topk_densify(jv, ji, x.shape))
        assert tcomp.topk_densify(tv, ti, x.shape).numpy().tobytes() == jd.tobytes()


def test_compression_ratio_matches_jax():
    for shape, k in (((10, 10), 5), ((4097,), 100), ((3, 5, 7), 1)):
        assert tcomp.compression_ratio(shape, k) == jcomp.compression_ratio(shape, k)
