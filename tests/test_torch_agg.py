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


@pytest.mark.parametrize("dtype", [np.int32, np.float64])
def test_non_float32_leaves_differ_from_reference(dtype):
    """A known difference (ROADMAP Queue 3): the JAX package folds any numpy
    leaf with numpy's promotion (int32 -> float64); the port folds float32
    tensors only and raises instead of folding on another path."""
    tree = {"w": np.arange(4).astype(dtype)}
    ref_acc = jroles.StreamingMean(fused=False)
    ref_acc.fold(tree, 2.0)
    assert ref_acc.finalize()[0]["w"].dtype == np.float64
    with pytest.raises(TypeError):
        troles.StreamingMean().fold(tree_from_numpy(tree, "cpu"), 2.0)


def test_streaming_mean_rejects_leaves_off_the_job_device():
    """Nothing crosses to the host inside a round: numpy leaves raise, and
    so do tensors on another device than the job's."""
    with pytest.raises(TypeError):
        troles.StreamingMean().fold({"w": np.ones(3, np.float32)}, 1.0)
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
    ops.divide(ops.fold_into(None, {"w": torch.ones(3)}, 2.0), 2.0)
    assert [fn.launches for fn in kernel.KERNELS] == [0, 0, 0, 0]


def test_plain_versions_are_the_cpu_path():
    rng = np.random.default_rng(8)
    d = _t(rng.normal(size=(4, 33)).astype(np.float32))
    w = _t(rng.uniform(1, 5, size=4).astype(np.float32))
    den = torch.tensor([11.0])
    assert torch.equal(kernel.exact_fold(d, w, den), ref.exact_fold(d, w, den))
    assert torch.equal(kernel.weighted_aggregate(d, w, den), ref.weighted_aggregate(d, w, den))
