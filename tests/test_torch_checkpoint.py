"""The port's checkpoints against the JAX package's.

Twins of ``test_checkpoint_policy_state.py``, and the cross-package round
trip: the same tree written by either package gives a file with the same
keys and the same arrays (the zip bytes differ: timestamps), and restores
in the other package. Tensor leaves are written from the host and restored
onto a torch device; the port runs on the CPU here (the card's restore is
in ``test_torch_gpu.py``).
"""
import collections
import os

import jax
import numpy as np
import pytest
import torch

from repro import checkpoint as jck
from repro_torch import checkpoint as tck
from repro_torch.convert import tree_from_numpy
from repro_torch.core.tree import tree_leaves

CPU = torch.device("cpu")
PKGS = {"port": tck, "ref": jck}


def _policy_server_state():
    return {
        "version": np.int64(3),  # 0-d scalar
        "weights": {
            "w": np.arange(8, dtype=np.float32),
            "b": np.zeros((2, 2), np.float32),
        },
        "staleness_log": [
            {"staleness": np.int32(0), "arrival": np.float64(1.5)},
            {"staleness": np.int32(2), "arrival": np.float64(3.25)},
        ],
        "participation": {
            "included": [np.int32(0), np.int32(1)],  # dict-of-list metadata
            "round_time": np.float32(2.0),  # 0-d scalar leaf
        },
    }


def _like_zeros():
    return {
        "version": np.int64(0),
        "weights": {"w": np.zeros((8,), np.float32), "b": np.ones((2, 2), np.float32)},
        "staleness_log": [
            {"staleness": np.int32(0), "arrival": np.float64(0)},
            {"staleness": np.int32(0), "arrival": np.float64(0)},
        ],
        "participation": {"included": [np.int32(0), np.int32(0)], "round_time": np.float32(0)},
    }


def _with_tensors(tree):
    """The state as the port's servers hold it: weights as tensors."""
    out = dict(tree)
    out["weights"] = tree_from_numpy(tree["weights"], CPU)
    return out


def _leaves_np(tree):
    return [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x) for x in tree_leaves(tree)]


def _assert_equal(a, b):
    la, lb = _leaves_np(a), [np.asarray(x) for x in jax.tree_util.tree_leaves(b)]
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def _npz(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


# ---------------------------------------------------------------------- #
# the file: same keys, same arrays
# ---------------------------------------------------------------------- #
def test_file_keys_and_arrays_equal_the_reference(tmp_path):
    state = _policy_server_state()
    state["nested"] = {"z": [np.ones(3, np.float32), (np.int8(4), np.zeros((0, 2)))],
                       "a": collections.OrderedDict([("y", np.float16(1.5)), ("x", 7)])}
    jpath = jck.save(str(tmp_path / "ref"), 5, state)
    tpath = tck.save(str(tmp_path / "port"), 5, dict(state, weights=_with_tensors(state)["weights"]))
    assert os.path.basename(jpath) == os.path.basename(tpath) == "ckpt_00000005.npz"
    j, t = _npz(jpath), _npz(tpath)
    assert list(j) == list(t)
    for k in j:
        assert j[k].dtype == t[k].dtype and j[k].shape == t[k].shape and j[k].tobytes() == t[k].tobytes()


def test_namedtuple_fields_keyed_as_the_reference(tmp_path):
    Pair = collections.namedtuple("Pair", "lo hi")
    tree = {"p": Pair(np.zeros(2, np.float32), np.ones(2, np.float32))}
    j = _npz(jck.save(str(tmp_path / "ref"), 0, tree))
    t = _npz(tck.save(str(tmp_path / "port"), 0, tree))
    assert list(j) == list(t)


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port"), ("port", "port")])
def test_checkpoint_restores_across_packages(tmp_path, writer, reader):
    state = _policy_server_state()
    PKGS[writer].save(str(tmp_path), 3, state if writer == "ref" else _with_tensors(state))
    assert PKGS[reader].latest_step(str(tmp_path)) == 3
    like = _like_zeros()
    if reader == "port":
        like = _with_tensors(like)
    restored = PKGS[reader].restore(str(tmp_path), 3, like, strict=True)
    _assert_equal(restored, state)
    if reader == "port":
        assert isinstance(restored["weights"]["w"], torch.Tensor)
        assert isinstance(restored["version"], np.ndarray)  # like's leaf was numpy
    assert np.shape(restored["version"]) == ()
    assert np.shape(restored["participation"]["round_time"]) == ()


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_round_trip_preserves_dtypes(tmp_path, writer):
    state = _policy_server_state()
    PKGS[writer].save(str(tmp_path), 0, state)
    restored = tck.restore(str(tmp_path), 0, state)
    assert restored["version"].dtype == np.int64
    assert restored["weights"]["w"].dtype == np.float32
    assert restored["staleness_log"][0]["staleness"].dtype == np.int32
    t = tck.restore(str(tmp_path), 0, _with_tensors(state))
    assert t["weights"]["w"].dtype == torch.float32 and t["weights"]["b"].shape == (2, 2)


# ---------------------------------------------------------------------- #
# strict mode, missing keys, shapes
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("writer", ["port", "ref"])
@pytest.mark.parametrize("reader", ["port", "ref"])
def test_strict_rejects_unknown_keys(tmp_path, writer, reader):
    state = _policy_server_state()
    PKGS[writer].save(str(tmp_path), 1, state)
    subset = {k: state[k] for k in ("version", "weights", "staleness_log")}
    restored = PKGS[reader].restore(str(tmp_path), 1, subset)
    _assert_equal(restored, subset)
    with pytest.raises(KeyError, match="unknown key"):
        PKGS[reader].restore(str(tmp_path), 1, subset, strict=True)


def test_strict_accepts_exact_match(tmp_path):
    state = _policy_server_state()
    tck.save(str(tmp_path), 2, _with_tensors(state))
    _assert_equal(tck.restore(str(tmp_path), 2, _with_tensors(state), strict=True), state)


def test_missing_key_still_raises_in_both_modes(tmp_path):
    tck.save(str(tmp_path), 0, {"w": torch.ones(2)})
    wider = {"w": torch.ones(2), "extra": np.zeros((1,))}
    for strict in (False, True):
        with pytest.raises(KeyError, match="missing"):
            tck.restore(str(tmp_path), 0, wider, strict=strict)


def test_shape_mismatch_raises(tmp_path):
    tck.save(str(tmp_path), 0, {"w": torch.ones(2)})
    with pytest.raises(ValueError, match="shape mismatch"):
        tck.restore(str(tmp_path), 0, {"w": torch.ones(3)})


# ---------------------------------------------------------------------- #
# load_tree, latest_step, the atomic write
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("writer", ["port", "ref"])
def test_load_tree_matches_reference(tmp_path, writer):
    state = _policy_server_state()
    state["meta"] = np.array('{"round": 2}')
    PKGS[writer].save(str(tmp_path), 4, state)
    j = jck.load_tree(str(tmp_path), 4)
    t = tck.load_tree(str(tmp_path), 4, device=CPU)
    assert sorted(j) == sorted(t)
    assert sorted(t["staleness_log"]) == ["#0", "#1"]  # sequence indices stay keys
    assert isinstance(t["weights"]["w"], torch.Tensor)
    assert isinstance(t["meta"], np.ndarray) and str(t["meta"]) == '{"round": 2}'
    _assert_equal(t["weights"], j["weights"])
    assert t["weights"]["w"].device == CPU


def test_latest_step_and_atomic_write(tmp_path):
    d = str(tmp_path / "ck")
    assert tck.latest_step(d) is None
    for step in (0, 12, 3):
        tck.save(d, step, {"w": torch.full((2,), float(step))})
    open(os.path.join(d, "ckpt_00000099.npz.tmp"), "w").close()  # a torn write
    assert tck.latest_step(d) == jck.latest_step(d) == 12
    assert not [n for n in os.listdir(d) if n.endswith(".tmp") and "99" not in n]


def test_bfloat16_leaves_are_refused(tmp_path):
    with pytest.raises(TypeError, match="bfloat16"):
        tck.save(str(tmp_path), 0, {"w": torch.ones(2, dtype=torch.bfloat16)})
