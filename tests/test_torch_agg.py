"""The port's aggregation (kernels/agg and the folds of core/roles) against
the JAX package's.

On the CPU the kernel wrappers run their plain PyTorch versions; the
order-exact entries must give the JAX package's bytes (twins of
``test_fused_agg.py``, ``test_streaming_agg.py`` and the agg cases of
``test_kernels.py``). The fused weighted sum may contract multiply-adds
into FMAs, so it is held to a relative bound instead. The CUDA kernels
themselves are held against the same plain versions on the card by
``test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.roles as jroles
import repro_torch.core.roles as troles
from repro.kernels.agg.kernel import fold_scaled
from repro.kernels.agg.ops import aggregate_flat as jax_aggregate_flat
from repro.kernels.agg.ops import aggregate_tree as jax_aggregate_tree
from repro.fl.strategies import _add_scaled, _scale_delta
from repro.kernels.agg.ref import reference_aggregate
from repro_torch.convert import tree_from_numpy, tree_to_numpy
from repro_torch.core import tree as ttree
from repro_torch.kernels.agg import kernel, ops, ref


def _bytes(tree):
    return [np.asarray(x).tobytes() for x in jax.tree_util.tree_leaves(tree)]


def _tbytes(tree):
    return _bytes(tree_to_numpy(tree))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _ragged_tree(rng, scale=1.0):
    return {
        "w": (scale * rng.normal(size=(33, 7))).astype(np.float32),
        "b": (scale * rng.normal(size=(7,))).astype(np.float32),
        "blocks": [
            (scale * rng.normal(size=(5, 2, 2))).astype(np.float32),
            (scale * rng.normal(size=(11,))).astype(np.float32),
        ],
    }


def _sum_bound(d, w, den, rtol=1e-6):
    """|kernel - plain| allowed for a weighted sum that may use FMAs:
    rtol times the sum of the magnitudes of its terms (the standard bound
    for a float32 sum; a bound relative to the result alone fails where the
    terms cancel)."""
    return rtol * (np.abs(w[:, None].astype(np.float64) * d).sum(0) / den)


# ------------------------------------------------------------------ #
# pytree helper: jax's flatten order
# ------------------------------------------------------------------ #
_Point = collections.namedtuple("_Point", ["y", "x"])


def _trees():
    dd = collections.defaultdict(list)
    dd["z"], dd["a"] = 1, 2
    return [
        {"b": 1, "a": [2, (3, None, 4)], "c": {"y": 5, "x": None}},
        [None, {"k": 1.5}, (), []],
        collections.OrderedDict([("z", 1), ("a", 2)]),
        _Point(y=1, x=[2, 3]),
        dd,
        None,
        7,
        {"t": np.zeros(3), "s": np.float32(1.0), "u": True},
    ]


@pytest.mark.parametrize("i", range(8))
def test_tree_flatten_order_equals_jax(i):
    tree = _trees()[i]
    leaves, treedef = ttree.tree_flatten(tree)
    ref_leaves = jax.tree_util.tree_leaves(tree)
    assert len(leaves) == len(ref_leaves) == treedef.num_leaves
    assert all(a is b for a, b in zip(leaves, ref_leaves))
    back = ttree.tree_unflatten(treedef, leaves)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    assert type(back) is type(tree)


def test_tree_map_rejects_other_structure():
    with pytest.raises(ValueError):
        ttree.tree_map(lambda a, b: a, {"w1": 1}, {"w2": 1})
    with pytest.raises(ValueError):
        jax.tree_util.tree_map(lambda a, b: a, {"w1": 1}, {"w2": 1})


def test_convert_round_trip_keeps_dtypes_and_structure():
    tree = {"a": np.arange(6, dtype=np.int32).reshape(2, 3),
            "b": [np.ones(2, np.float16), None, 3.0], "c": np.float64(2.5)}
    back = tree_to_numpy(tree_from_numpy(tree, "cpu"))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for x, y in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        assert np.asarray(x).tobytes() == np.asarray(y).tobytes()


# ------------------------------------------------------------------ #
# the stacked exact fold
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("C", [1, 2, 3, 7, 12])
@pytest.mark.parametrize("N", [1, 7, 130, 1000])
def test_exact_fold_bytes_equal_jax(C, N):
    rng = np.random.default_rng(C * 1000 + N)
    d = rng.normal(size=(C, N)).astype(np.float32)
    w = rng.uniform(1.0, 30.0, size=C).astype(np.float32)
    total = 0.0
    for c in range(C):
        total += float(w[c])
    ours = ops.aggregate_flat(_t(d), _t(w), denom=total, exact=True)
    ref_cpu = jax_aggregate_flat(d, w, denom=total, exact=True)
    assert ours.numpy().tobytes() == np.asarray(ref_cpu).tobytes()


@pytest.mark.parametrize("C,N", [(3, 130), (5, 1000)])
def test_exact_fold_bytes_equal_pallas_interpret(C, N):
    """The Pallas fold kernel itself, as test_fused_agg.py runs it."""
    rng = np.random.default_rng(7 + C)
    d = rng.normal(size=(C, N)).astype(np.float32)
    w = rng.uniform(1.0, 30.0, size=C).astype(np.float32)
    total = float(np.float64(w.astype(np.float64).sum()))
    scaled = jnp.asarray(d) * jnp.asarray(w)[:, None]
    via_pallas = fold_scaled(scaled, jnp.asarray([total], jnp.float32), interpret=True)
    ours = ops.aggregate_flat(_t(d), _t(w), denom=total, exact=True)
    assert ours.numpy().tobytes() == np.asarray(via_pallas).tobytes()
    via_ops = jax_aggregate_flat(d, w, denom=total, exact=True, interpret=True)
    assert ours.numpy().tobytes() == np.asarray(via_ops).tobytes()


def test_exact_fold_bf16_rows_widen_exactly():
    rng = np.random.default_rng(11)
    d16 = _t(rng.normal(size=(4, 257)).astype(np.float32)).to(torch.bfloat16)
    w = rng.uniform(1.0, 9.0, size=4).astype(np.float32)
    ours = ops.aggregate_flat(d16, _t(w), denom=17.0, exact=True)
    d_ref = jnp.asarray(d16.to(torch.float32).numpy()).astype(jnp.bfloat16)
    ref_out = jax_aggregate_flat(d_ref, w, denom=17.0, exact=True)
    assert ours.numpy().tobytes() == np.asarray(ref_out).tobytes()


def test_exact_fold_keeps_negative_zero():
    """An all -0.0 column keeps its sign: the fold starts from client 0's
    product, not from zeros (test_fused_agg.py's signed-zero case)."""
    updates = [
        ({"w": np.array([-0.0, 5.0], np.float32)}, 1.0),
        ({"w": np.array([-0.0, 3.0], np.float32)}, 1.0),
    ]
    tree = {"w": np.stack([u[0]["w"] for u in updates])}
    w = np.ones(2, np.float32)
    ref_out = jax_aggregate_tree(tree, w, denom=2.0, exact=True, interpret=True)
    ours = ops.aggregate_tree(tree_from_numpy(tree, "cpu"), w, denom=2.0, exact=True)
    assert _tbytes(ours) == _bytes(ref_out)
    assert np.signbit(ours["w"].numpy()[0])
    mean, _ = troles.weighted_mean([(tree_from_numpy(t, "cpu"), n) for t, n in updates])
    ref_mean, _ = jroles.weighted_mean(updates, fused=False)
    assert _tbytes(mean) == _bytes(ref_mean)


def test_aggregate_tree_ragged_bytes_equal():
    rng = np.random.default_rng(2)
    C = 5
    tree = {
        "a": rng.normal(size=(C, 3, 5)).astype(np.float32),
        "b": [rng.normal(size=(C, 7)).astype(np.float32),
              rng.normal(size=(C,)).astype(np.float32)],
    }
    w = rng.uniform(0.5, 4.0, size=C).astype(np.float32)
    ours = ops.aggregate_tree(tree_from_numpy(tree, "cpu"), w, denom=9.5, exact=True)
    ref_out = jax_aggregate_tree(tree, w, denom=9.5, exact=True)
    assert _tbytes(ours) == _bytes(ref_out)
    assert ours["a"].shape == (3, 5) and ours["b"][1].shape == ()


# ------------------------------------------------------------------ #
# the fused weighted sum
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("C,N", [(1, 17), (5, 1000), (8, 256)])
@pytest.mark.parametrize("with_denom", [False, True])
def test_weighted_aggregate_within_bound(C, N, with_denom):
    rng = np.random.default_rng(C + N)
    d = rng.normal(size=(C, N)).astype(np.float32)
    w = rng.uniform(0.01, 30.0, size=C).astype(np.float32)
    denom = 12.5 if with_denom else None
    ours = ops.aggregate_flat(_t(d), _t(w), denom=denom).numpy()
    ref_out = np.asarray(jax_aggregate_flat(d, w, denom=denom))
    den = denom if with_denom else max(float(w.astype(np.float64).sum()), 1e-30)
    assert (np.abs(ours - ref_out) <= _sum_bound(d, w, den)).all()
    if not with_denom:
        oracle = np.asarray(reference_aggregate(jnp.asarray(d), jnp.asarray(w)))
        assert (np.abs(ours - oracle) <= _sum_bound(d, w, den)).all()


def test_weighted_aggregate_tree_shapes():
    tree = {"a": torch.ones(4, 3, 5), "b": torch.zeros(4, 7)}
    out = ops.aggregate_tree(tree, torch.ones(4))
    assert out["a"].shape == (3, 5) and out["b"].shape == (7,)
    assert torch.equal(out["a"], torch.ones(3, 5))


# ------------------------------------------------------------------ #
# weighted_mean and StreamingMean
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("C", [1, 2, 3, 7, 12])
def test_weighted_mean_bytes_equal_jax(C):
    rng = np.random.default_rng(C)
    updates = [(_ragged_tree(rng), float(rng.integers(1, 40))) for _ in range(C)]
    ours, total = troles.weighted_mean(
        [(tree_from_numpy(t, "cpu"), n) for t, n in updates])
    for fused in (False, True):
        ref_mean, ref_total = jroles.weighted_mean(updates, fused=fused)
        assert total == ref_total
        assert _tbytes(ours) == _bytes(ref_mean)


def test_weighted_mean_edge_cases_match_jax():
    assert troles.weighted_mean([]) == (None, 0.0) == jroles.weighted_mean([])
    zero = [({"w": torch.ones(2)}, 0.0)]
    assert troles.weighted_mean(zero) == (None, 0.0)
    # trees of another structure or ragged shapes raise as the JAX
    # package's sequential path does
    for a, b in (({"w1": np.ones((4, 4), np.float32)}, {"w2": np.ones((4, 4), np.float32)}),
                 ({"w": np.ones((4, 4), np.float32)}, {"w": np.ones((2, 2), np.float32)})):
        with pytest.raises(ValueError):
            jroles.weighted_mean([(a, 1.0), (b, 1.0)], fused=True)
        with pytest.raises(ValueError):
            troles.weighted_mean([(tree_from_numpy(a, "cpu"), 1.0),
                                  (tree_from_numpy(b, "cpu"), 1.0)])


@pytest.mark.parametrize("n_clients", [1, 3, 17])
def test_streaming_mean_bytes_equal_jax(n_clients):
    rng = np.random.default_rng(5 + n_clients)
    updates = [(_ragged_tree(rng), float(rng.integers(1, 9))) for _ in range(n_clients)]
    ours, ref_acc = troles.StreamingMean(), jroles.StreamingMean(fused=False)
    for tree, n in updates:
        ours.fold(tree_from_numpy(tree, "cpu"), n)
        ref_acc.fold(tree, n)
    part, part_total = ours.partial()
    ref_part, ref_part_total = ref_acc.partial()
    assert part_total == ref_part_total
    assert _tbytes(part) == _bytes(ref_part)
    mean, total = ours.finalize()
    ref_mean, ref_total = ref_acc.finalize()
    assert total == ref_total
    assert _tbytes(mean) == _bytes(ref_mean)
    assert (ours.count, ours.peak_buffered) == (n_clients, 1)
    # the partial is not touched by finalize
    assert _tbytes(part) == _bytes(ref_part)


def test_streaming_fold_partial_bytes_equal_jax():
    rng = np.random.default_rng(23)
    partials = [(_ragged_tree(rng, 5.0), float(rng.integers(2, 30)), 3) for _ in range(4)]
    ours, ref_acc = troles.StreamingMean(), jroles.StreamingMean(fused=False)
    for acc, total, count in partials:
        ours.fold_partial(tree_from_numpy(acc, "cpu"), total, count)
        ref_acc.fold_partial(acc, total, count)
    ours.fold_partial(None, 3.0)
    assert ours.count == ref_acc.count == 12
    mean, total = ours.finalize()
    ref_mean, ref_total = ref_acc.finalize()
    assert total == ref_total
    assert _tbytes(mean) == _bytes(ref_mean)


def test_streaming_mean_empty_and_zero_weight():
    acc = troles.StreamingMean()
    assert acc.finalize() == (None, 0.0)
    acc.fold({"w": torch.ones(2)}, 0.0)
    assert acc.finalize() == (None, 0.0)


def _leaf_bytes(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.dtype, x.tobytes()


@pytest.mark.parametrize("dtype", [np.int32, np.float64])
def test_non_float32_leaves_differ_from_reference(dtype):
    """Once a known difference (ROADMAP Queue 3), now repaired: leaves that
    are not float32 tensors fold with numpy's promotion in both packages
    (int32 -> float64), in the same dtype and to the same bytes, whether
    they arrive as tensors, numpy arrays or Python and numpy scalars, in
    ``StreamingMean`` and in ``weighted_mean``."""
    rng = np.random.default_rng(11)
    updates = [
        ({"w": (rng.normal(size=4) * 50).astype(dtype), "h": (rng.normal(size=3) * 9).astype(np.float16),
          "s": int(rng.integers(0, 9)), "f": float(rng.normal()), "g": np.float32(rng.normal()),
          "i": np.int64(rng.integers(0, 9)), "f32": rng.normal(size=5).astype(np.float32)},
         n)
        for n in (2.0, 3.7, 1.3)
    ]
    ref_acc = jroles.StreamingMean(fused=False)
    for tree, n in updates:
        ref_acc.fold(tree, n)
    ref_mean, ref_total = ref_acc.finalize()
    ref_wm, _ = jroles.weighted_mean(updates, fused=False)
    assert np.asarray(ref_mean["w"]).dtype == np.float64
    for convert in (lambda t: t, lambda t: tree_from_numpy(t, "cpu")):
        acc = troles.StreamingMean(device="cpu")
        for tree, n in updates:
            acc.fold(convert(tree), n)
        mean, total = acc.finalize()
        wm, _ = troles.weighted_mean([(convert(t), n) for t, n in updates])
        assert total == ref_total
        for key in ref_mean:
            assert _leaf_bytes(mean[key]) == _leaf_bytes(ref_mean[key]), key
            assert _leaf_bytes(wm[key]) == _leaf_bytes(ref_wm[key]), key


def test_streaming_mean_rejects_leaves_off_the_job_device():
    """Nothing crosses to the host inside a round: tensors on another device
    than the job's raise. Numpy leaves fold on the host with numpy, as the
    JAX package folds them."""
    host = troles.StreamingMean()
    host.fold({"w": np.ones(3, np.float32)}, 1.0)
    assert _leaf_bytes(host.finalize()[0]["w"]) == _leaf_bytes(np.ones(3, np.float32))
    on_card = troles.StreamingMean(device="cuda:0")
    with pytest.raises(TypeError, match="cuda:0"):
        on_card.fold({"w": torch.ones(3)}, 1.0)
    with pytest.raises(TypeError, match="cuda:0"):
        on_card.fold_partial({"w": torch.ones(3)}, 1.0)
    assert on_card.count == 0


# ------------------------------------------------------------------ #
# wrapper contract
# ------------------------------------------------------------------ #
def test_divide_is_an_ieee_divide():
    rng = np.random.default_rng(1)
    x = rng.normal(size=1 << 16).astype(np.float32) * 1e3
    for total in (3.0, 7.0, 1e-3, 123456.789):
        out = kernel.exact_divide(_t(x), total)
        assert out.numpy().tobytes() == (x / np.float32(total)).tobytes()
        y = _t(x.copy())
        assert kernel.exact_divide(y, total, out=y) is y
        assert y.numpy().tobytes() == out.numpy().tobytes()


def test_fold_into_matches_numpy_and_is_in_place():
    rng = np.random.default_rng(4)
    a, b = (rng.normal(size=1001).astype(np.float32) for _ in range(2))
    acc = kernel.exact_fold_into(None, _t(a), 3.5)
    same = kernel.exact_fold_into(acc, _t(b), 0.25)
    assert same is acc
    assert acc.numpy().tobytes() == (a * np.float32(3.5) + b * np.float32(0.25)).tobytes()


def test_wrappers_reject_what_the_kernels_do_not_take():
    d, w, den = torch.ones(3, 8), torch.ones(3), torch.ones(1)
    with pytest.raises(TypeError):
        kernel.exact_fold(d.double(), w, den)
    with pytest.raises(ValueError):
        kernel.exact_fold(d, torch.ones(2), den)
    with pytest.raises(ValueError):
        kernel.exact_fold(d.reshape(-1), w, den)
    with pytest.raises(ValueError):
        kernel.exact_fold(torch.ones(8, 3).t(), w, den)
    with pytest.raises(ValueError):
        kernel.weighted_aggregate(d, w, torch.ones(2))
    with pytest.raises(ValueError):
        kernel.exact_fold(d.to("meta"), w.to("meta"), den.to("meta"))
    with pytest.raises(TypeError):
        kernel.exact_fold_into(None, torch.ones(4, dtype=torch.float64), 1.0)
    with pytest.raises(TypeError):
        kernel.exact_fold_into(None, np.ones(4, np.float32), 1.0)
    with pytest.raises(ValueError):
        kernel.exact_fold_into(torch.ones(4), torch.ones(5), 1.0)
    x = torch.ones(8)
    with pytest.raises(ValueError):
        kernel.exact_fold_into(x[:4], x[2:6], 1.0)  # overlapping update
    with pytest.raises(TypeError):
        kernel.exact_divide(torch.ones(4, dtype=torch.int32), 2.0)


def test_cpu_calls_launch_nothing():
    kernel.reset_launches()
    ops.aggregate_flat(torch.ones(2, 4), torch.ones(2), denom=2.0, exact=True)
    ops.aggregate_flat(torch.ones(2, 4), torch.ones(2))
    acc = ops.fold_into(None, {"w": torch.ones(3), "b": torch.ones(2)}, 2.0)
    ops.divide(ops.fold_into(acc, {"w": torch.ones(3), "b": torch.ones(2)}, 2.0), 2.0)
    kernel.exact_fold_into_tree(None, [torch.ones(4)] * (kernel.TREE_LEAVES + 1), 1.5)
    assert len(kernel.KERNELS) == 5
    assert [fn.launches for fn in kernel.KERNELS] == [0] * len(kernel.KERNELS)


def test_plain_versions_are_the_cpu_path():
    rng = np.random.default_rng(8)
    d = _t(rng.normal(size=(4, 33)).astype(np.float32))
    w = _t(rng.uniform(1, 5, size=4).astype(np.float32))
    den = torch.tensor([11.0])
    assert torch.equal(kernel.exact_fold(d, w, den), ref.exact_fold(d, w, den))
    assert torch.equal(kernel.weighted_aggregate(d, w, den), ref.weighted_aggregate(d, w, den))


# ------------------------------------------------------------------ #
# the tree entry of the streaming fold
# ------------------------------------------------------------------ #
# float32 leaf sizes of the mixed trees: empty, odd, a multiple of 4, more
# than a chunk and ragged
TREE_SIZES = (0, 1, 3, 4, 5, 4099, kernel.CHUNK + 3)
# csrc/agg.cu: kFoldThreads, kFoldUnroll
KERNEL_THREADS, KERNEL_UNROLL = 256, 4


def _offset_view(x: np.ndarray) -> torch.Tensor:
    """``x`` as a contiguous tensor whose data starts 4 bytes into its
    buffer, so it is not 16-byte aligned."""
    buf = torch.empty(x.size + 1, dtype=torch.float32)
    buf[1:] = _t(x.reshape(-1))
    return buf[1:].view(x.shape)


def _mixed_update(rng, scale=1.0):
    """A numpy tree of float32 leaves of every size in TREE_SIZES, an int32
    and a float64 leaf, a Python scalar and a float32 leaf that the torch
    twin holds at a 1-float offset ("view")."""
    tree = {f"f{n}": (scale * rng.normal(size=n)).astype(np.float32) for n in TREE_SIZES}
    tree["view"] = (scale * rng.normal(size=(7, 9))).astype(np.float32)
    tree["i"] = rng.integers(-50, 50, size=6).astype(np.int32)
    tree["d"] = (scale * rng.normal(size=5)).astype(np.float64)
    tree["s"] = float(rng.normal())
    return tree


def _torch_update(tree):
    out = tree_from_numpy(tree, "cpu")
    out["view"] = _offset_view(tree["view"])
    assert out["view"].data_ptr() % 16 != 0
    return out


@pytest.mark.parametrize("n_updates", [1, 2, 5])
def test_tree_fold_of_mixed_leaves_bytes_equal_jax(n_updates):
    rng = np.random.default_rng(100 + n_updates)
    updates = [(_mixed_update(rng), float(rng.integers(1, 60)) + 0.3) for _ in range(n_updates)]
    ours, ref_acc = troles.StreamingMean(device="cpu"), jroles.StreamingMean(fused=False)
    for tree, n in updates:
        ours.fold(_torch_update(tree), n)
        ref_acc.fold(tree, n)
    part, total = ours.partial()
    ref_part, ref_total = ref_acc.partial()
    assert total == ref_total
    for key in ref_part:
        assert _leaf_bytes(part[key]) == _leaf_bytes(ref_part[key]), key
    mean, _ = ours.finalize()
    ref_mean, _ = ref_acc.finalize()
    for key in ref_mean:
        assert _leaf_bytes(mean[key]) == _leaf_bytes(ref_mean[key]), key


@pytest.mark.parametrize("n_updates", [1, 3])
def test_tree_entry_bytes_equal_jax_scale_and_add(n_updates):
    """The tree entry (its plain version here) against the JAX package's
    jitted ``_scale_delta`` / ``_add_scaled`` chain, the fused
    ``StreamingMean.fold``, leaf for leaf."""
    rng = np.random.default_rng(7 * n_updates)
    leaves = [[(rng.normal(size=n) * 3).astype(np.float32) for n in TREE_SIZES]
              for _ in range(n_updates)]
    ws = [float(rng.uniform(1, 90)) for _ in range(n_updates)]
    accs, want = None, None
    for ds, w in zip(leaves, ws):
        tds = [_offset_view(d) if i % 2 else _t(d) for i, d in enumerate(ds)]
        out = kernel.exact_fold_into_tree(accs, tds, w)
        if accs is not None:
            assert all(a is b for a, b in zip(out, accs))  # in place
        accs = out
        scaled = [np.asarray(_scale_delta(d, np.float32(w))) for d in ds]
        want = scaled if want is None else [np.asarray(_add_scaled(a, x)) for a, x in zip(want, scaled)]
    assert [a.numpy().tobytes() for a in accs] == [x.tobytes() for x in want]
    fused = jroles.StreamingMean(fused=True)
    for ds, w in zip(leaves, ws):
        fused.fold({f"l{i}": d for i, d in enumerate(ds)}, w)
    assert [a.numpy().tobytes() for a in accs] == \
        [np.asarray(fused.partial()[0][f"l{i}"]).tobytes() for i in range(len(TREE_SIZES))]


def test_tree_fold_partial_of_mixed_leaves_bytes_equal_jax():
    rng = np.random.default_rng(31)
    partials = [(_mixed_update(rng, 4.0), float(rng.integers(2, 30)), 2) for _ in range(3)]
    ours, ref_acc = troles.StreamingMean(device="cpu"), jroles.StreamingMean(fused=False)
    for tree, total, count in partials:
        ours.fold_partial(_torch_update(tree), total, count)
        ref_acc.fold_partial(tree, total, count)
    assert ours.count == ref_acc.count == 6
    mean, total = ours.finalize()
    ref_mean, ref_total = ref_acc.finalize()
    assert total == ref_total
    for key in ref_mean:
        assert _leaf_bytes(mean[key]) == _leaf_bytes(ref_mean[key]), key


def test_fold_into_keeps_structure_and_folds_in_place():
    rng = np.random.default_rng(3)
    tree = _torch_update(_mixed_update(rng))
    acc = ops.fold_into(None, tree, 2.0)
    assert ttree.tree_flatten(acc)[1] == ttree.tree_flatten(tree)[1]
    before = {k: v for k, v in acc.items() if isinstance(v, torch.Tensor) and v.dtype == torch.float32}
    again = ops.fold_into(acc, tree, 3.0)
    assert all(again[k] is v for k, v in before.items())
    with pytest.raises(ValueError):
        ops.fold_into(acc, {"other": torch.ones(2)}, 1.0)


# the table builder ------------------------------------------------- #
def _chunk_spans(rows, chunks):
    """(leaf, first element, end) of every chunk of one launch, found as the
    kernel finds them: the leaf whose chunk0 is the last at or below it."""
    spans = []
    for c in range(chunks):
        i = max(j for j, row in enumerate(rows) if row[3] <= c)
        _, _, n, chunk0, _ = rows[i]
        e0 = (c - chunk0) * kernel.CHUNK
        assert e0 < n, "a chunk past its leaf's end"
        spans.append((i, e0, min(e0 + kernel.CHUNK, n)))
    return spans


@pytest.mark.parametrize("seed", range(4))
def test_fold_tables_cover_every_element_once(seed):
    rng = np.random.default_rng(seed)
    count = int(rng.integers(1, 3 * kernel.TREE_LEAVES))
    sizes = [int(rng.choice([1, 3, 4, 256, kernel.CHUNK - 1, kernel.CHUNK, kernel.CHUNK + 5,
                             int(rng.integers(1, 5 * kernel.CHUNK))])) for _ in range(count)]
    leaves = [(1 << 20) * i for i in range(count)]
    tables = kernel.fold_tables([(a, a + (1 << 19), n) for a, n in zip(leaves, sizes)])
    assert len(tables) == -(-count // kernel.TREE_LEAVES)
    seen = 0
    for rows, chunks in tables:
        assert 1 <= len(rows) <= kernel.TREE_LEAVES and rows[0][3] == 0
        assert chunks == sum(-(-row[2] // kernel.CHUNK) for row in rows)
        covered = collections.defaultdict(list)
        for i, e0, e1 in _chunk_spans(rows, chunks):
            covered[i].append((e0, e1))
        for i, row in enumerate(rows):
            spans = sorted(covered[i])
            assert spans[0][0] == 0 and spans[-1][1] == row[2]
            assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))  # no gap, no overlap
        assert [row[2] for row in rows] == sizes[seen:seen + len(rows)]
        seen += len(rows)
    assert seen == count


def test_fold_tables_split_more_than_a_table_and_flag_alignment():
    K = kernel.TREE_LEAVES
    leaves = [(4096 * i + 4 * (i % 4 == 1), 4096 * i + 8 * (i % 4 == 2), 7) for i in range(2 * K + 5)]
    tables = kernel.fold_tables(leaves)
    assert [len(rows) for rows, _ in tables] == [K, K, 5]
    flags = [row[4] for rows, _ in tables for row in rows]
    assert flags == [int(i % 4 in (0, 3)) for i in range(2 * K + 5)]
    assert kernel.fold_tables([]) == []


# a replay of the kernel's walk ------------------------------------- #
def _fold_replay(arena: np.ndarray, tables, w: float, first: bool, blocks: int):
    """numpy replay of ``fold_tree_kernel`` (csrc/agg.cu) on a float32
    ``arena``, whose byte offsets are the tables' addresses: each launch's
    grid of ``min(chunks, blocks)`` blocks walks the chunks with a grid
    stride, each block moving its leaf forward; in a chunk of an aligned
    leaf, KERNEL_THREADS threads take KERNEL_UNROLL packs of d and of acc
    each, all loaded before any is stored, then the elements after the last
    whole pack go one per thread (the whole chunk, for an unaligned leaf).
    Returns how often each element of the arena was written."""
    w32 = np.float32(w)
    writes = np.zeros(arena.size, np.int64)
    lanes = np.arange(KERNEL_THREADS)

    def fold(idx_acc, idx_d):
        s = arena[idx_d] * w32
        arena[idx_acc] = s if first else arena[idx_acc] + s
        np.add.at(writes, idx_acc, 1)

    for rows, chunks in tables:
        grid = min(chunks, blocks)
        for b in range(grid):
            i = 0
            for c in range(b, chunks, grid):
                while i + 1 < len(rows) and c >= rows[i + 1][3]:
                    i += 1
                acc, d, n, chunk0, aligned = rows[i]
                assert acc % 4 == 0 and d % 4 == 0
                a0, d0 = acc // 4, d // 4
                e0 = (c - chunk0) * kernel.CHUNK
                e1 = min(e0 + kernel.CHUNK, n)
                scalar0 = e0
                if aligned:
                    p1 = e1 // 4
                    for p in range(e0 // 4, p1, KERNEL_THREADS * KERNEL_UNROLL):
                        q = (p + np.arange(KERNEL_UNROLL)[:, None] * KERNEL_THREADS + lanes).ravel()
                        q = q[q < p1]
                        elems = (4 * q[:, None] + np.arange(4)).ravel()
                        fold(a0 + elems, d0 + elems)
                    scalar0 = p1 * 4
                for e in range(scalar0, e1, KERNEL_THREADS):
                    elems = e + lanes[lanes < e1 - e]
                    fold(a0 + elems, d0 + elems)
    return writes


@pytest.mark.parametrize("blocks", [1, 3, 528])
@pytest.mark.parametrize("many", [False, True])
def test_fold_replay_bytes_equal_plain_fold(blocks, many):
    """Leaves of TREE_SIZES (or 2 * TREE_LEAVES + 7 small ones) laid in one
    arena at 16-byte and at 4-byte offsets, folded twice (first, then
    later) by the replay and by the plain version: the same bytes, every
    accumulator element written once per fold and nothing else written."""
    rng = np.random.default_rng(blocks + 10 * many)
    sizes = [int(n) for n in rng.integers(1, 40, size=2 * kernel.TREE_LEAVES + 7)] if many \
        else [n for n in TREE_SIZES if n] * 2
    offsets, pos = [], 0
    for i, n in enumerate(sizes * 2):  # the update leaves, then the accumulator leaves
        pos += 4 - pos % 4 + (i % 3 == 1)  # aligned, or one float past
        offsets.append(pos)
        pos += n
    arena = torch.from_numpy(rng.normal(size=pos + 4).astype(np.float32))
    L = len(sizes)
    ds = [arena[o:o + n] for o, n in zip(offsets[:L], sizes)]
    accs = [arena[o:o + n] for o, n in zip(offsets[L:], sizes)]
    base = arena.data_ptr()
    assert base % 16 == 0
    tables = kernel.fold_tables(
        [(a.data_ptr() - base, d.data_ptr() - base, d.numel()) for a, d in zip(accs, ds)])
    assert len(tables) == (3 if many else 1)
    assert any(row[4] == 0 for rows, _ in tables for row in rows)
    assert any(row[4] == 1 for rows, _ in tables for row in rows)
    replay = arena.numpy().copy()
    for first, w in ((True, 3.7), (False, 0.61)):
        writes = _fold_replay(replay, tables, w, first, blocks)
        plain = ref.exact_fold_into_tree(None if first else plain, ds, w)
        for o, n, leaf in zip(offsets[L:], sizes, plain):
            assert replay[o:o + n].tobytes() == leaf.numpy().tobytes()
        acc_elems = np.concatenate([np.arange(o, o + n) for o, n in zip(offsets[L:], sizes)])
        assert (writes[acc_elems] == 1).all() and writes.sum() == acc_elems.size
    # the update leaves were only read
    for o, n, d in zip(offsets[:L], sizes, ds):
        assert replay[o:o + n].tobytes() == d.numpy().tobytes()


def test_fold_replay_sees_a_dropped_chunk():
    """A control: the replay with one chunk skipped is not byte-equal."""
    rng = np.random.default_rng(2)
    n = 3 * kernel.CHUNK + 1
    arena = rng.normal(size=2 * n + 4).astype(np.float32)
    tables = kernel.fold_tables([(4 * (n + 3), 0, n)])
    rows, chunks = tables[0]
    full = arena.copy()
    _fold_replay(full, tables, 2.5, True, 4)
    short = arena.copy()
    _fold_replay(short, [(rows, chunks - 1)], 2.5, True, 4)
    assert full.tobytes() != short.tobytes()


# overlap ----------------------------------------------------------- #
def test_tree_entry_refuses_overlap_across_leaves():
    buf = torch.zeros(64)
    a, b, c = buf[0:8], buf[8:16], buf[16:24]
    with pytest.raises(ValueError, match="overlaps"):  # acc 0 is update leaf 1
        kernel.exact_fold_into_tree([a, c], [buf[24:32], a], 1.0)
    with pytest.raises(ValueError, match="overlaps"):  # acc 1 inside update 0's span,
        # with update 1 between them in address order and clear of acc 1
        kernel.exact_fold_into_tree([buf[48:64], buf[34:36]], [buf[30:46], buf[31:33]], 1.0)
    with pytest.raises(ValueError, match="overlaps"):  # two accumulators share bytes
        kernel.exact_fold_into_tree([buf[0:8], buf[4:12]], [c, buf[24:32]], 1.0)
    with pytest.raises(ValueError, match="overlaps"):  # the same accumulator twice
        kernel.exact_fold_into_tree([a, a], [b, c], 1.0)
    with pytest.raises(ValueError, match="overlaps"):  # update spans an accumulator
        kernel.exact_fold_into_tree([b], [buf[4:12]], 1.0)
    # update leaves may share; neighbours that only touch do not overlap
    out = kernel.exact_fold_into_tree([a, b], [c, c], 2.0)
    assert out[0] is a and torch.equal(b, torch.zeros(8))


def test_tree_entry_refuses_what_the_kernel_does_not_take():
    with pytest.raises(TypeError):
        kernel.exact_fold_into_tree(None, [torch.ones(3), torch.ones(3, dtype=torch.float64)], 1.0)
    with pytest.raises(ValueError):
        kernel.exact_fold_into_tree([torch.ones(3)], [torch.ones(4)], 1.0)
    with pytest.raises(ValueError):
        kernel.exact_fold_into_tree([torch.ones(3)], [torch.ones(3), torch.ones(3)], 1.0)
    with pytest.raises(ValueError):
        kernel.exact_fold_into_tree(None, [torch.ones(4, 3).t()], 1.0)
    with pytest.raises(ValueError):
        kernel.exact_fold_into_tree(None, [torch.ones(3, device="meta")], 1.0)
    assert kernel.exact_fold_into_tree(None, [], 1.0) == []
