"""Tensor parallelism in the port (``repro_torch.launch.tensor_parallel``,
the models under a ``ModelGroup``, ``build_serve_step`` /
``build_train_step`` at a ``model`` axis > 1) on the CPU.

Groups of 2 and 4 gloo processes run through ``GroupPool`` (one pool per
group size for the module; every call under a timeout); their rank
functions live in ``tests/_torch_tp_programs.py``, which imports the port
alone. Checks:

* the collectives: an all-reduce of float32 and bfloat16 tensors equals the
  local sum, the argmax over vocabulary blocks breaks ties to the lowest
  index, and Megatron's f/g adjoints (and a gather at use) give the
  one-process autograd's value and gradients;
* every arch id's reduced config at m = 2, and Qwen2.5-3B's at m = 4,
  against the one-process port under the same mesh profile: the prefill
  logits and 3 greedy decode steps (float32 logits within atol 2e-5, as
  the block twins of ``test_torch_models.py``, xLSTM within its
  ``CHAOTIC`` control; greedy tokens equal), one train step (parameters
  within rtol 2e-5 / atol 1e-6, as in ``test_torch_fedstep.py``; loss and
  ``delta_norm`` alike), and the per-rank parameter bytes;
* the recurrent blocks on their slices (the SSD on a slice of every head's
  P, the sLSTM on a slice of d): Hymba and xLSTM at m = 2 and 4 within
  ``F32_LOGITS_ATOL`` of one process, gathering exactly the small SSD
  leaves reckoned from the rule (never ``in_xz``, ``out``, ``gates`` or a
  state); each rank's block of ``in_xz`` its P-slice of xv and z, of
  ``out`` the same rows, of ``gates`` its d-slice of each gate, and
  ``unshard(shard(x))`` the leaf bit for bit;
* query heads that straddle KV heads (12 query and 3 KV heads at m = 2:
  groups of 4, 6 query heads a rank), on the plain attention and the
  flash route, against the one-process port and the JAX package;
* the gather counter: 0 for Qwen2.5-3B at m = 2; at m = 4 its K/V leaves
  (``kv_dim`` 64 cut into half heads) and the sequence-sharded cache;
* a planted fault, the last rank keeping its own partial sum of ``wo``,
  moves the logits far past the limit; a rank that raises fails the call
  with its traceback, and never hangs it;
* what spans whole leaves at m = 2: a DP round (the clip norm over the
  group, each rank's block of the whole leaf's noise) on (data 2, model 2)
  and a DP round with the int8 cross-pod wire (the whole leaf's scale) on
  (pod 2, data 1, model 2) against the one-process port (codes equal
  wherever the float32 inputs are) and, on the JAX package's draws,
  against its round; sampled tokens equal to the one-process run's; the
  dry run's counting group's all-reduces equal to the gloo group's;
* the JAX package's sharded ``build_serve_step`` (prefill and serve steps)
  on (1, 2) and (1, 4) meshes for Qwen2.5-3B and on (1, 2) for
  Qwen3-MoE-235B-A22B, SeamlessM4T-medium, Hymba-1.5B and xLSTM-1.3B, and
  its ``build_train_step``
  on (2, 2) for Qwen2.5-3B, on 4 forced host devices in one subprocess,
  held to the port's groups within ``F32_LOGITS_ATOL`` 2e-4 (two
  partitioned float32 programs whose sums run in other orders).
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_tp_programs as prog
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import tree_to_numpy, unshard_tree
from repro_torch.core.mesh_lowering import Mesh
from repro_torch.launch import tensor_parallel as tp
from repro_torch.launch.steps import build_serve_step, build_train_step
from repro_torch.models.api import build_model

ROOT = Path(__file__).resolve().parents[1]
LOGITS_ATOL = 2e-5
STEP_RTOL, STEP_ATOL = 2e-5, 1e-6
F32_LOGITS_ATOL = 2e-4
B, S, STEPS = 2, 32, 3
CALL_S = 120.0


@pytest.fixture(scope="module")
def pool2():
    with tp.GroupPool(["cpu"] * 2, timeout_s=CALL_S) as pool:
        yield pool


@pytest.fixture(scope="module")
def pool4():
    with tp.GroupPool(["cpu"] * 4, timeout_s=CALL_S) as pool:
        yield pool


def _params(cfg, seed=0):
    bundle = build_model(cfg, "cpu")
    return tree_to_numpy(bundle.init(torch.Generator().manual_seed(seed)))


def _inputs(cfg, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    frames = (rng.standard_normal((B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
              if cfg.family == "audio" else None)
    return tokens, frames


def _whole_logits(results, step):
    return np.concatenate([r.value["logits"][step] for r in results], axis=-1)


def _assert_serving(results, want, atol):
    for r in results:
        np.testing.assert_array_equal(r.value["tokens"], results[0].value["tokens"])
    np.testing.assert_array_equal(results[0].value["tokens"], want["tokens"])
    for step in range(STEPS + 1):
        got = _whole_logits(results, step)
        assert got.shape == want["logits"][step].shape
        np.testing.assert_allclose(got, want["logits"][step], rtol=0, atol=atol)


# ---------------------------------------------------------------------- #
# the collectives
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_all_reduce_and_argmax_over_blocks(pool2, dtype):
    res = pool2.run(prog.collectives_rank, dtype)
    base = (torch.arange(6, dtype=torch.float32) * 0.375)
    want = (base.to(getattr(torch, dtype)) + (base + 1).to(getattr(torch, dtype))).float()
    for r in res:
        np.testing.assert_array_equal(r.value["sum"], want.numpy())
        np.testing.assert_array_equal(r.value["argmax"], [1, 5])  # tie to rank 0; rank 1 wins


def test_megatron_adjoints_equal_one_process_autograd(pool2, pool4):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 8)).astype(np.float32)
    w = rng.standard_normal((8, 12)).astype(np.float32)
    v = rng.standard_normal((12, 5)).astype(np.float32)
    xt, wt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (x, w, v))
    y = torch.tanh(xt @ wt) @ vt
    torch.sum(y * y).backward()
    for pool in (pool2, pool4):
        res = pool.run(prog.adjoint_rank, x, w, v)
        n = 12 // pool.size
        for r in res:
            np.testing.assert_allclose(r.value["y"], y.detach().numpy(), rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(r.value["gx"], xt.grad.numpy(), rtol=1e-5, atol=1e-5)
            lo = r.rank * n
            np.testing.assert_allclose(r.value["gw"], wt.grad.numpy()[:, lo:lo + n], rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(r.value["gv"], vt.grad.numpy()[lo:lo + n], rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_array_equal(r.value["w_whole"], w)  # the gather is exact
            assert r.value["counters"]["gathered_leaves"] == 1
            assert r.value["counters"]["gathered_bytes"] == w.nbytes


def test_a_failing_rank_fails_the_call_with_its_traceback():
    with tp.GroupPool(["cpu"] * 2, timeout_s=60) as pool:
        with pytest.raises(tp.GroupError, match="planted rank failure"):
            pool.run(prog.failing_rank)
        with pytest.raises(tp.GroupError, match="closed"):
            pool.run(prog.failing_rank)


def test_backend_rule():
    assert tp.choose_backend(["cpu", "cpu"]) == "gloo"
    assert tp.choose_backend(["cuda:0", "cuda:0"]) == "gloo"  # NCCL refuses one card twice
    assert tp.choose_backend(["cuda:0", "cuda:1"]) == "nccl"
    with pytest.raises(ValueError, match="mixes"):
        tp.choose_backend(["cpu", "cuda:0"])


# ---------------------------------------------------------------------- #
# every arch at m = 2, Qwen2.5-3B at m = 4, against the one-process port
# ---------------------------------------------------------------------- #
def _serve_case(pool, arch, fault=False):
    cfg = get_config(arch, reduced=True)
    mesh_axes = (("data", 1), ("model", pool.size))
    params = _params(cfg)
    tokens, frames = _inputs(cfg)
    res = pool.run(prog.serve_rank, cfg, mesh_axes, params, tokens, frames, STEPS, fault)
    want = prog.serve_one_process(cfg, mesh_axes, params, tokens, frames, STEPS)
    return cfg, res, want


# xLSTM (16 exponentially gated layers) amplifies rounding: a relative 1e-7
# change of every parameter moves its one-process float32 logits by 2.9e-5
# (CPU), and its step moves its embedding by 1.3e-4 (lr 0.05, 2 local
# steps). Where its recurrent blocks compute on their slices, the split
# sums run in other orders, so a split run cannot meet the fixed bounds
# there. It is held to that control instead: no further from the
# one-process run than the one-process run is from itself after a relative
# 1e-7 change of every parameter (and never held looser than the bound).
CHAOTIC = {"xlstm_1_3b"}


def _serving_atol(cfg, arch, mesh_axes, atol):
    """``atol``, or for a ``CHAOTIC`` arch the larger of it and the
    one-process run's own distance after a relative 1e-7 change of every
    parameter (``_serve_case``'s draws and prompts)."""
    if arch not in CHAOTIC:
        return atol
    from repro_torch.core.tree import tree_map

    params = _params(cfg)
    tokens, frames = _inputs(cfg)
    want = prog.serve_one_process(cfg, mesh_axes, params, tokens, frames, STEPS)
    nudged = prog.serve_one_process(
        cfg, mesh_axes, tree_map(lambda x: (x * np.float32(1 + 1e-7)).astype(x.dtype), params),
        tokens, frames, STEPS)
    return max(atol, max(float(np.abs(a - b).max())
                         for a, b in zip(nudged["logits"], want["logits"])))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serving_at_m2_equals_one_process(pool2, arch):
    cfg, res, want = _serve_case(pool2, arch)
    _assert_serving(res, want, _serving_atol(cfg, arch, (("data", 1), ("model", 2)),
                                             LOGITS_ATOL))
    for r in res:  # every big leaf splits: a rank holds a little over half
        assert r.value["param_bytes"] <= 0.75 * want["param_bytes"]
    if arch == "qwen2_5_3b":
        assert all(r.value["counters"]["gathered_leaves"] == 0 for r in res)
        assert all(r.value["param_bytes"] <= 0.55 * want["param_bytes"] for r in res)


def test_serving_qwen_at_m4_gathers_kv_and_the_sequence_sharded_cache(pool4):
    cfg, res, want = _serve_case(pool4, "qwen2_5_3b")
    _assert_serving(res, want, LOGITS_ATOL)
    # per layer, each attention call gathers wk and wv (w and b) at use;
    # each decode step also reads the k and v caches whole
    layers = cfg.num_layers
    want_leaves = layers * 4 * (1 + STEPS) + layers * 2 * STEPS
    for r in res:
        assert r.value["counters"]["gathered_leaves"] == want_leaves


def test_a_skipped_wo_all_reduce_reads_above_the_limit(pool2):
    _, res, want = _serve_case(pool2, "qwen2_5_3b", fault=True)
    gap = np.abs(_whole_logits(res, 0) - want["logits"][0]).max()
    assert gap > 100 * LOGITS_ATOL


# ---------------------------------------------------------------------- #
# the recurrent blocks on their slices: the SSD on a slice of every head's
# P, the sLSTM on a slice of d (launch.sharding.recurrent_split)
# ---------------------------------------------------------------------- #
RECURRENT = ["hymba_1_5b", "xlstm_1_3b"]


def _reckoned_gathers(cfg, m, calls, ssd_whole=False):
    """The leaves a rank gathers at use in ``calls`` serving calls at a
    model axis of ``m``, and their bytes, reckoned from the rule: every
    SSD ``in_bc`` and ``in_dt`` that the rule cuts, whole at use (q, k and
    the decays of every head), and nothing else: the reduced Hymba's 4
    query and 4 KV heads split at m = 2 and 4, and no ``in_xz``, ``out``,
    ``gates`` or recurrent state is ever whole. With ``ssd_whole`` (a
    group that does not divide P) the SSD's ``in_xz`` and ``out`` too."""
    from repro_torch.launch import sharding
    from repro_torch.models.api import param_shapes

    mesh = Mesh((("data", 1), ("model", m)))
    n, nbytes = 0, 0
    whole = {("ssd", "in_bc"), ("ssd", "in_dt")}
    if ssd_whole:
        whole |= {("ssd", "in_xz"), ("ssd", "out")}

    def leaf(path, x):
        nonlocal n, nbytes
        spec = sharding.param_pspec(path, x, cfg, mesh)
        if tuple(path[-3:-1]) in whole and sharding.is_sharded(spec, "model", mesh):
            n += calls
            nbytes += calls * x.numel() * x.element_size()

    sharding.map_with_path(leaf, param_shapes(cfg))
    return n, nbytes


def _rule_param_bytes(cfg, m):
    """A rank's parameter bytes by the rule's block shapes."""
    from repro_torch.launch import sharding
    from repro_torch.models.api import param_shapes

    mesh = Mesh((("data", 1), ("model", m)))
    sizes = []
    sharding.map_with_path(lambda path, x: sizes.append(
        int(np.prod(sharding.shard_shape(x.shape, sharding.param_pspec(path, x, cfg, mesh), mesh)))
        * x.element_size()), param_shapes(cfg))
    return sum(sizes)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_blocks_serve_on_their_slices(pool2, pool4, arch, m):
    """Hymba and xLSTM at m = 2 and 4, their SSD sub-blocks on a slice of
    every head's P and the sLSTM on a slice of d: the prefill and 3 greedy
    decode steps equal the one-process port within ``F32_LOGITS_ATOL``,
    greedy tokens equal; each rank gathers exactly the reckoned small
    leaves (``_reckoned_gathers``: no ``in_xz``, ``out``, ``gates`` or
    state), and holds the rule's parameter bytes."""
    pool = pool2 if m == 2 else pool4
    cfg, res, want = _serve_case(pool, arch)
    _assert_serving(res, want, F32_LOGITS_ATOL)
    n, nbytes = _reckoned_gathers(cfg, m, 1 + STEPS)
    assert n > 0
    for r in res:
        c = r.value["counters"]
        assert (c["gathered_leaves"], c["gathered_bytes"]) == (n, nbytes)
        assert r.value["param_bytes"] == _rule_param_bytes(cfg, m)


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_blocks_compute_replicated_where_the_group_does_not_divide_p(pool4, arch):
    """256 SSD heads of P = 2 at m = 4: the rule cuts ``in_xz`` and ``out``
    in contiguous blocks and leaves the state whole, and the SSD computes
    replicated on them gathered at use (the counters say so: the reckoned
    gathers with ``in_xz`` and ``out``); the logits equal one process's
    within ``LOGITS_ATOL`` (xLSTM's sLSTM, d 256, still splits: its
    ``CHAOTIC`` control), greedy tokens equal."""
    from repro_torch.launch import sharding

    cfg = dataclasses.replace(get_config(arch, reduced=True), ssm_heads=256)
    assert not sharding.recurrent_split(cfg, "ssd", 4) and sharding.recurrent_split(cfg, "ssd", 2)
    mesh_axes = (("data", 1), ("model", 4))
    params = _params(cfg)
    tokens, frames = _inputs(cfg)
    res = pool4.run(prog.serve_rank, cfg, mesh_axes, params, tokens, frames, STEPS)
    want = prog.serve_one_process(cfg, mesh_axes, params, tokens, frames, STEPS)
    _assert_serving(res, want, _serving_atol(cfg, arch, mesh_axes, LOGITS_ATOL))
    n, nbytes = _reckoned_gathers(cfg, 4, 1 + STEPS, ssd_whole=True)
    for r in res:
        c = r.value["counters"]
        assert (c["gathered_leaves"], c["gathered_bytes"]) == (n, nbytes)


def _cut_columns(groups, width, m, r):
    """Rank r's indices of a dim of ``groups`` runs of ``width``: its
    ``width / m`` of every run."""
    b = width // m
    return [g * width + r * b + j for g in range(groups) for j in range(b)]


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("leaf", ["in_xz", "out", "gates"])
def test_recurrent_leaves_are_cut_in_slices_of_every_group(leaf, m):
    """Rank r's block of the SSD's ``in_xz`` is, for xv then z and each
    head h, the columns h*P + r*P/m ... (r+1)*P/m (its P-slice of both);
    of ``out``, the same rows of d_i; of the sLSTM's ``gates``, its d-slice
    of each of i, f, z and o. ``shard`` then ``unshard`` gives the whole
    leaf back bit for bit (float32 and bfloat16; numpy too), and every
    block has the rule's shape. The reduced xLSTM (Hymba's SSD leaves have
    the same shapes)."""
    from repro_torch.launch import sharding
    from repro_torch.models.api import param_shapes

    cfg = get_config("xlstm_1_3b", reduced=True)
    d_i, H, _ = cfg.ssd_dims
    P, d = d_i // H, cfg.d_model
    path = {"in_xz": ("layers", 0, "ssd", "in_xz", "w"), "out": ("layers", 0, "ssd", "out", "w"),
            "gates": ("layers", 7, "gates", "w")}[leaf]
    like = param_shapes(cfg)
    for k in path:
        like = like[k]
    mesh = Mesh((("data", 1), ("model", m)))
    spec = sharding.param_pspec(path, like, cfg, mesh)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(tuple(like.shape))
                         .astype(np.float32))
    for r in range(m):
        block = sharding.shard(x, spec, mesh, {"model": r})
        if leaf == "in_xz":
            want = x[:, _cut_columns(2 * H, P, m, r)]
        elif leaf == "out":
            want = x[_cut_columns(H, P, m, r)]
        else:
            want = x[:, _cut_columns(4, d, m, r)]
        assert torch.equal(block, want)
        assert block.shape == sharding.shard_shape(x.shape, spec, mesh) and block.is_contiguous()
    coords = sharding.mesh_coords(mesh)
    for t in (x, x.to(torch.bfloat16)):
        back = sharding.unshard([sharding.shard(t, spec, mesh, c) for c in coords], spec, mesh)
        bits = torch.int32 if t.dtype == torch.float32 else torch.int16
        assert torch.equal(back.view(bits), t.view(bits))
    a = x.numpy()
    back = sharding.unshard([sharding.shard(a, spec, mesh, c) for c in coords], spec, mesh)
    assert back.tobytes() == a.tobytes()


def _train_case(pool, arch, data=1):
    cfg = get_config(arch, reduced=True)
    params = _params(cfg)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    frames = (rng.standard_normal((4, cfg.frontend_len, cfg.d_model)).astype(np.float32)
              if cfg.family == "audio" else None)
    batch = prog.train_batch(cfg, tokens, frames)
    fed = dict(local_steps=2, local_lr=0.05)
    axes = (("data", data), ("model", pool.size))
    res = pool.run(prog.train_rank, cfg, axes, params, batch, 3, fed)
    one = prog.train_rank(None, cfg, axes, params, batch, 3, fed)
    got = unshard_tree([r.value["params"] for r in res], cfg, Mesh((("data", 1),
                                                                    ("model", pool.size))))
    return cfg, res, one, got


def _assert_trees_close(got, want):
    from repro_torch.core.tree import tree_leaves

    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        np.testing.assert_allclose(g, w, rtol=STEP_RTOL, atol=STEP_ATOL)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_at_m2_equals_one_process(pool2, arch):
    cfg, res, one, got = _train_case(pool2, arch)
    if arch in CHAOTIC:
        nudged = _train_control(cfg, 1e-7)
        from repro_torch.core.tree import tree_leaves

        for g, w, c in zip(tree_leaves(got), tree_leaves(one["params"]),
                           tree_leaves(nudged["params"])):
            assert np.abs(g - w).max() <= max(np.abs(c - w).max(), STEP_ATOL)
    else:
        _assert_trees_close(got, one["params"])
        for r in res:
            for k in ("loss", "delta_norm"):
                np.testing.assert_allclose(r.value["metrics"][k], one["metrics"][k],
                                           rtol=STEP_RTOL)


def _train_control(cfg, rel):
    """The one-process step of ``_train_case`` on parameters scaled by
    ``1 + rel``."""
    from repro_torch.core.tree import tree_map

    params = tree_map(lambda x: (x * np.float32(1 + rel)).astype(x.dtype), _params(cfg))
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    batch = prog.train_batch(cfg, tokens, None)
    return prog.train_rank(None, cfg, (("data", 1), ("model", 2)), params, batch, 3,
                           dict(local_steps=2, local_lr=0.05))


def test_train_step_qwen_at_m4_and_on_data2_model2(pool2, pool4):
    _, res, one, got = _train_case(pool4, "qwen2_5_3b")
    _assert_trees_close(got, one["params"])
    assert all(r.value["counters"]["gathered_leaves"] > 0 for r in res)  # K/V at m = 4
    _, res, one, got = _train_case(pool2, "qwen2_5_3b", data=2)  # 2 virtual clients a rank
    _assert_trees_close(got, one["params"])
    for k in ("loss", "delta_norm"):
        np.testing.assert_allclose(res[0].value["metrics"][k], one["metrics"][k], rtol=STEP_RTOL)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_a_ranks_cache_starts_as_the_one_process_cache(arch):
    """The rank's cache is allocated at its block shapes with each leaf's
    initial value by name (slot positions -1, the sLSTM stabilizer -1e30,
    the rest 0): on a group of one it is the one-process ``init_cache``,
    value for value and dtype for dtype."""
    from repro_torch.launch.sharding import map_with_path
    from repro_torch.models import api

    cfg = get_config(arch, reduced=True)
    want = build_model(cfg, "cpu").init_cache(2, 40)
    got = api._rank_cache(cfg, 2, 40, tp.ModelGroup(rank=0, size=1), torch.device("cpu"))
    flat = {}
    map_with_path(lambda path, x: flat.__setitem__(path, x), got)
    n = []
    map_with_path(lambda path, x: n.append(path) or torch.testing.assert_close(
        flat[path], x, rtol=0, atol=0), want)
    assert sorted(n) == sorted(flat)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_a_ranks_init_cuts_each_part_as_drawn(arch, monkeypatch):
    """A rank's ``init`` draws in the one-process order and cuts each part
    to its blocks as it is drawn: its tree is, byte for byte, the rank's
    blocks of the one-process tree, and a stacked part is cut one layer at
    a time (the rank never holds the whole stack)."""
    from repro_torch.launch import sharding
    from repro_torch.models import api

    cfg = get_config(arch, reduced=True)
    whole = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    mesh = Mesh((("data", 1), ("model", 2)))
    specs = sharding.param_specs(whole, cfg, mesh)
    rank_keep, parts = api._rank_keep, []

    def spy(cfg, group):
        keep = rank_keep(cfg, group)

        def cut(path, tree, stack=None):
            parts.append((path, stack))
            return keep(path, tree, stack)

        return cut

    monkeypatch.setattr(api, "_rank_keep", spy)
    for rank in range(2):
        parts.clear()
        group = tp.ModelGroup(rank=rank, size=2)
        got = build_model(cfg, "cpu", group).init(torch.Generator().manual_seed(0))
        want = sharding.shard_tree(whole, specs, mesh, group.coords)
        flat = {}
        sharding.map_with_path(lambda path, x: flat.__setitem__(path, x), got)
        seen = []
        sharding.map_with_path(lambda path, x: seen.append(path) or torch.testing.assert_close(
            flat[path], x, rtol=0, atol=0), want)
        assert sorted(seen) == sorted(flat)
        for path, stack in parts:
            if stack is not None:
                assert parts.count((path, stack)) == stack, (path, stack)


def test_builders_build_on_a_data2_model2_grid_and_refuse_a_missing_group():
    """Both builders build at (data 2, model 2) for the rank of a grid: the
    FSDP train step as one client over the grid, serving on the rank's rows.
    A model axis without its group, or a grid's step given a group of the
    model axis alone, is refused."""
    qwen, moe = get_config("qwen2_5_3b", reduced=True), get_config("qwen3_moe_235b_a22b",
                                                                    reduced=True)
    mesh = Mesh((("data", 2), ("model", 2)))
    grid = tp.ModelGroup(rank=0, size=2, clients=(("data", 2),), client_rank=1)
    with pytest.raises(ValueError, match="runs as 2 processes"):
        build_train_step(qwen, Mesh((("data", 1), ("model", 2))), device="cpu")
    bundle, setup = build_train_step(moe, mesh, device="cpu", group=grid)
    assert bundle.group is grid and setup.client_axes == () and setup.tag is None
    bundle, setup = build_serve_step(qwen, mesh, 8, 4, "cpu", grid)
    assert bundle.group is grid
    rows = setup.rows({"tokens": torch.arange(4)[:, None]})["tokens"]
    assert rows[:, 0].tolist() == [2, 3]  # the second data rank's rows
    with pytest.raises(ValueError, match="runs as the grid"):
        build_serve_step(qwen, mesh, 8, 4, "cpu", tp.ModelGroup(rank=0, size=2))
    bundle, setup = build_serve_step(qwen, Mesh((("data", 1), ("model", 1))), 8, 2, "cpu")
    assert bundle.group is None and setup.param_shardings["embed"]["emb"] == ("model", None)


def test_serve_launcher_over_two_ranks(capsys):
    from repro_torch.launch import serve

    assert serve.main(["--reduced", "--device", "cpu", "--ranks", "2", "--gen", "3",
                       "--batch", "2", "--prompt-len", "16"]) == 0
    out = capsys.readouterr().out
    assert "backend gloo" in out and "gathered leaves 0" in out
    tokens = [ln for ln in out.splitlines() if "sample token ids" in ln]
    assert serve.main(["--reduced", "--device", "cpu", "--gen", "3", "--batch", "2",
                       "--prompt-len", "16"]) == 0
    assert [ln for ln in capsys.readouterr().out.splitlines() if "sample token ids" in ln] == tokens


# ---------------------------------------------------------------------- #
# the JAX package's sharded steps on 4 host devices
# ---------------------------------------------------------------------- #
_JAX_TWINS = r'''
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.fl.fedstep import FedStepConfig
from repro.fl.privacy import DPConfig
from repro.launch.steps import build_serve_step, build_train_step

spec = json.loads(sys.argv[2])
out = {}
assert len(jax.devices()) == 4


def mesh_of(shape, names=("data", "model")):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), tuple(names))


def host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def save_tree(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + jax.tree_util.keystr(path)] = np.asarray(leaf)


for case in spec["serve"]:
    cfg = dataclasses.replace(get_config(case["arch"], reduced=True), **case.get("overrides", {}))
    mesh = mesh_of(tuple(case["mesh"]))
    inp = dict(np.load(case["inputs"]))
    B, S = inp["tokens"].shape
    steps = case["steps"]
    bundle, setup = build_serve_step(cfg, mesh, S + steps + 1, B)
    params = bundle.init(jax.random.key(0))
    name = case["name"]
    save_tree(name + "/params", params)
    params = jax.device_put(params, setup.param_shardings)
    cache = jax.device_put(bundle.init_cache(B, S + steps + 1), setup.cache_shardings)
    batch = {"tokens": jnp.asarray(inp["tokens"])}
    if cfg.family == "audio":
        batch["frames"] = jnp.asarray(inp["frames"])
    with mesh:
        prefill = jax.jit(setup.prefill)
        step = jax.jit(setup.serve_step)
        logits, cache = prefill(params, batch, cache)
        toks = []
        for i in range(steps + 1):
            out[f"{name}/logits/{i}"] = np.asarray(logits)
            tok = jnp.argmax(logits[:, -1], axis=-1)
            toks.append(np.asarray(tok))
            if i < steps:
                logits, cache = step(params, cache, {"token": tok[:, None].astype(jnp.int32)})
    out[f"{name}/tokens"] = np.stack(toks, 1)

for case in spec["train"]:
    cfg = get_config(case["arch"], reduced=True)
    names = case.get("names", ["data", "model"])
    mesh = mesh_of(tuple(case["mesh"]), names)
    inp = dict(np.load(case["inputs"]))
    dp = DPConfig(**case["dp"]) if case.get("dp") else None
    fed = FedStepConfig(local_steps=2, local_lr=0.05, dp=dp)
    bundle, setup = build_train_step(cfg, mesh, fed, cross_pod_wire=case.get("wire", "f32"),
                                     strategy_name=case.get("strategy"))
    params = bundle.init(jax.random.key(0))
    name = case["name"]
    save_tree(name + "/params0", params)
    if dp is not None:  # the fed step's draws: client c's leaf j
        leaves = jax.tree_util.tree_leaves(params)
        clients = int(np.prod([n for a, n in zip(names, case["mesh"]) if a != "model"]))
        for c in range(clients):
            keys = jax.random.split(jax.random.fold_in(jax.random.key(3), c), len(leaves))
            for j, (k, leaf) in enumerate(zip(keys, leaves)):
                out[f"{name}/noise/{c}/{j}"] = np.asarray(
                    jax.random.normal(k, leaf.shape, jnp.float32))
    state = setup.init_state(params)
    params = jax.device_put(params, setup.in_shardings[0])
    state = jax.device_put(state, setup.in_shardings[1])
    with mesh:
        step = jax.jit(setup.step)
        params, state, m = step(params, state, {"tokens": jnp.asarray(inp["tokens"])},
                                jax.random.key(3))
    save_tree(name + "/params1", params)
    for k in m:
        out[f"{name}/metric/{k}"] = np.asarray(m[k])
np.savez(sys.argv[1], **out)
'''

JAX_SERVE = [("qwen2_5_3b", (1, 2)), ("qwen2_5_3b", (1, 4)), ("qwen3_moe_235b_a22b", (1, 2)),
             ("seamless_m4t_medium", (1, 2)), ("hymba_1_5b", (1, 2)), ("xlstm_1_3b", (1, 2))]
JAX_TRAIN = [("qwen2_5_3b", (2, 2))]
# DP (clip and noise) on (data 2, model 2), and DP with the int8 cross-pod
# wire on (pod 2, data 1, model 2), FedAvg at the root (a linear apply)
DP = dict(clip_norm=0.5, noise_multiplier=0.3)
JAX_WHOLE_LEAF = {"dp": dict(mesh=(2, 2), names=("data", "model"), wire="f32"),
                  "dp_int8": dict(mesh=(2, 1, 2), names=("pod", "data", "model"), wire="int8")}


# query heads that straddle KV heads at m = 2: groups of 4, 6 query heads a rank
STRADDLE = dict(num_heads=12, num_kv_heads=3)


def _straddle_cfg(attn_impl):
    return dataclasses.replace(get_config("qwen2_5_3b", reduced=True), attn_impl=attn_impl,
                               **STRADDLE)


def _case_name(arch, mesh):
    return f"{arch}@{mesh[0]}x{mesh[1]}"


@pytest.fixture(scope="module")
def jax_twins(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_twins")
    spec = {"serve": [], "train": []}
    for arch, mesh in JAX_SERVE:
        cfg = get_config(arch, reduced=True)
        tokens, frames = _inputs(cfg)
        path = d / f"{_case_name(arch, mesh)}.npz"
        np.savez(path, tokens=tokens, **({"frames": frames} if frames is not None else {}))
        spec["serve"].append(dict(arch=arch, mesh=mesh, inputs=str(path), steps=STEPS,
                                  name=_case_name(arch, mesh)))
    cfg = _straddle_cfg("xla")
    tokens, _ = _inputs(cfg)
    path = d / "straddle.npz"
    np.savez(path, tokens=tokens)
    spec["serve"].append(dict(arch="qwen2_5_3b", mesh=(1, 2), inputs=str(path), steps=STEPS,
                              name="straddle@1x2", overrides=STRADDLE))
    for arch, mesh in JAX_TRAIN:
        rng = np.random.default_rng(2)
        tokens = rng.integers(0, get_config(arch, reduced=True).vocab_size, (4, 16))
        path = d / f"train_{_case_name(arch, mesh)}.npz"
        np.savez(path, tokens=tokens.astype(np.int32))
        spec["train"].append(dict(arch=arch, mesh=mesh, inputs=str(path),
                                  name="train/" + _case_name(arch, mesh)))
    for name, case in JAX_WHOLE_LEAF.items():
        path = d / f"train_{name}.npz"
        np.savez(path, tokens=_whole_leaf_batch()["tokens"])
        spec["train"].append(dict(arch="qwen2_5_3b", mesh=case["mesh"], names=case["names"],
                                  wire=case["wire"], dp=DP, strategy="fedavg",
                                  inputs=str(path), name="train/" + name))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
               "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")
    proc = subprocess.run([sys.executable, "-c", _JAX_TWINS, str(d / "out.npz"),
                           json.dumps(spec)], capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return spec, dict(np.load(d / "out.npz"))


def _jax_tree(out, prefix, like):
    """The saved JAX leaves under ``prefix`` in the structure of ``like``."""
    from repro_torch.launch.sharding import map_with_path

    def leaf(path, _):
        key = prefix + "".join(f"[{k}]" if isinstance(k, int) else f"['{k}']" for k in path)
        return out[key]

    return map_with_path(leaf, like)


@pytest.mark.parametrize("arch,mesh", JAX_SERVE, ids=[_case_name(*c) for c in JAX_SERVE])
def test_sharded_serving_equals_the_jax_packages(jax_twins, pool2, pool4, arch, mesh):
    spec, out = jax_twins
    case = next(c for c in spec["serve"] if c["name"] == _case_name(arch, mesh))
    cfg = get_config(arch, reduced=True)
    params = _jax_tree(out, case["name"] + "/params", _params(cfg))
    inp = dict(np.load(case["inputs"]))
    pool = pool2 if mesh[1] == 2 else pool4
    res = pool.run(prog.serve_rank, cfg, (("data", 1), ("model", mesh[1])), params,
                   inp["tokens"], inp.get("frames"), STEPS)
    want = {"tokens": out[case["name"] + "/tokens"],
            "logits": [out[f"{case['name']}/logits/{i}"][..., :cfg.vocab_size]
                       for i in range(STEPS + 1)]}
    _assert_serving(res, want, F32_LOGITS_ATOL)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_straddling_query_heads_equal_one_process_and_the_jax_packages(jax_twins, pool2,
                                                                        attn_impl):
    """12 query and 3 KV heads at m = 2 (groups of 4, 6 query heads a
    rank): rank 0 reads KV heads 0-1, rank 1 KV heads 1-2, each query head
    its own. Prefill and 3 greedy decode steps, on the plain attention and
    the flash route, equal the one-process port within ``LOGITS_ATOL`` and
    the JAX package's sharded serving within ``F32_LOGITS_ATOL``."""
    from repro_torch.models import attention

    cfg = _straddle_cfg(attn_impl)
    for rank, kv_lo, kv_of_q in ((0, 0, (0, 0, 0, 0, 1, 1)), (1, 1, (0, 0, 1, 1, 1, 1))):
        with tp.use_group(tp.ModelGroup(rank=rank, size=2)):
            hs = attention.head_split(cfg)
        assert (hs.n_q, hs.kv_lo, hs.n_kv, hs.kv_of_q) == (6, kv_lo, 2, kv_of_q)
    spec, out = jax_twins
    params = _jax_tree(out, "straddle@1x2/params", _params(cfg))
    tokens, _ = _inputs(cfg)
    mesh_axes = (("data", 1), ("model", 2))
    res = pool2.run(prog.serve_rank, cfg, mesh_axes, params, tokens, None, STEPS)
    _assert_serving(res, prog.serve_one_process(cfg, mesh_axes, params, tokens, None, STEPS),
                    LOGITS_ATOL)
    want = {"tokens": out["straddle@1x2/tokens"],
            "logits": [out[f"straddle@1x2/logits/{i}"][..., :cfg.vocab_size]
                       for i in range(STEPS + 1)]}
    _assert_serving(res, want, F32_LOGITS_ATOL)


@pytest.mark.parametrize("arch,mesh", JAX_TRAIN, ids=[_case_name(*c) for c in JAX_TRAIN])
def test_sharded_train_step_equals_the_jax_packages(jax_twins, pool2, arch, mesh):
    spec, out = jax_twins
    case = next(c for c in spec["train"] if c["name"] == "train/" + _case_name(arch, mesh))
    cfg = get_config(arch, reduced=True)
    like = _params(cfg)
    params = _jax_tree(out, case["name"] + "/params0", like)
    tokens = dict(np.load(case["inputs"]))["tokens"]
    res = pool2.run(prog.train_rank, cfg, (("data", mesh[0]), ("model", mesh[1])), params,
                    {"tokens": tokens}, 3, dict(local_steps=2, local_lr=0.05))
    got = unshard_tree([r.value["params"] for r in res], cfg, Mesh((("data", 1),
                                                                    ("model", mesh[1]))))
    want = _jax_tree(out, case["name"] + "/params1", like)
    from repro_torch.core.tree import tree_leaves

    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=F32_LOGITS_ATOL)
    for k in ("loss", "delta_norm"):
        np.testing.assert_allclose(res[0].value["metrics"][k], out[f"{case['name']}/metric/{k}"],
                                   rtol=1e-4)


# ---------------------------------------------------------------------- #
# what spans whole leaves at m = 2: the DP clip norm and noise, the int8
# wire's per-tensor scale, sampling over the vocabulary
# ---------------------------------------------------------------------- #
def _whole_leaf_batch():
    cfg = get_config("qwen2_5_3b", reduced=True)
    rng = np.random.default_rng(4)
    return {"tokens": rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)}


def _whole_leaf_round(jax_twins, pool2, name):
    """The DP round ``name`` of ``JAX_WHOLE_LEAF`` from the JAX package's
    parameters: the port at m = 2 on its own draws, the one-process port
    on them (the same draws: each rank draws every leaf whole and keeps its
    block), the port at m = 2 on the JAX package's draws, and the JAX
    package's round."""
    spec, out = jax_twins
    case = JAX_WHOLE_LEAF[name]
    cfg = get_config("qwen2_5_3b", reduced=True)
    like = _params(cfg)
    params = _jax_tree(out, f"train/{name}/params0", like)
    axes = tuple(zip(case["names"], case["mesh"]))
    fed = dict(local_steps=2, local_lr=0.05, dp=DP)
    batch = _whole_leaf_batch()
    clients = 2
    n_leaves = len(_leaves(like))
    noise = [[out[f"train/{name}/noise/{c}/{j}"] for j in range(n_leaves)]
             for c in range(clients)]
    own = pool2.run(prog.train_rank, cfg, axes, params, batch, 3, fed, "fedavg", case["wire"])
    one = prog.train_rank(None, cfg, axes, params, batch, 3, fed, "fedavg", case["wire"])
    injected = pool2.run(prog.train_rank, cfg, axes, params, batch, 3, fed, "fedavg",
                         case["wire"], noise)
    mesh = Mesh((("data", 1), ("model", 2)))
    want = _jax_tree(out, f"train/{name}/params1", like)
    return cfg, own, one, injected, want, {k: float(out[f"train/{name}/metric/{k}"])
                                           for k in ("loss", "delta_norm")}, mesh


def _leaves(tree):
    from repro_torch.core.tree import tree_leaves

    return tree_leaves(tree)


def test_dp_round_at_m2_equals_one_process_and_the_jax_packages(jax_twins, pool2):
    """A DP round (clip 0.5, noise multiplier 0.3) over (data 2, model 2):
    the clip norm over whole leaves and each rank's block of the whole
    leaf's noise give the one-process round (float32 bound of this file),
    and on the JAX package's draws the JAX package's round (its twin's
    bound, ``test_sharded_train_step_equals_the_jax_packages``)."""
    cfg, own, one, injected, want, want_m, mesh = _whole_leaf_round(jax_twins, pool2, "dp")
    _assert_trees_close(unshard_tree([r.value["params"] for r in own], cfg, mesh),
                        one["params"])
    for r in own:
        for k in ("loss", "delta_norm"):
            np.testing.assert_allclose(r.value["metrics"][k], one["metrics"][k], rtol=STEP_RTOL)
    got = unshard_tree([r.value["params"] for r in injected], cfg, mesh)
    for g, w in zip(_leaves(got), _leaves(want)):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=F32_LOGITS_ATOL)
    for k in ("loss", "delta_norm"):
        np.testing.assert_allclose(injected[0].value["metrics"][k], want_m[k], rtol=1e-4)
    # the noise moved the round: the clipped, noised deltas are not the plain ones
    plain = prog.train_rank(None, cfg, (("data", 2), ("model", 2)), tree_to_numpy(
        unshard_tree([r.value["params"] for r in own], cfg, mesh)), _whole_leaf_batch(), 3,
        dict(local_steps=2, local_lr=0.05), "fedavg")
    assert plain["metrics"]["delta_norm"] != own[0].value["metrics"]["delta_norm"]


def test_int8_wire_at_pod2_model2_takes_the_whole_leafs_scale(jax_twins, pool2):
    """DP and the int8 cross-pod wire over (pod 2, data 1, model 2): each
    rank's codes equal the one-process codes' block wherever the float32
    inputs are equal (the scale is the whole leaf's absmax, maxed over the
    ranks), the parameters within one code step of the one-process round's
    and, on the JAX package's draws, of the JAX package's round."""
    from repro_torch.launch import sharding as tshd

    cfg, own, one, injected, want, _, mesh = _whole_leaf_round(jax_twins, pool2, "dp_int8")
    blocks = [tshd.LeafBlocks.of_params(_params(cfg), cfg, mesh, {"model": r}) for r in range(2)]
    n_leaves = len(blocks[0].shapes)
    assert len(one["codes"]) == 2 * n_leaves  # each pod's mean, leaf by leaf
    equal_inputs = 0
    for r in own:
        assert len(r.value["codes"]) == len(one["codes"])
        for k, ((x, q), (x1, q1)) in enumerate(zip(r.value["codes"], one["codes"])):
            i = k % n_leaves
            xb, qb = blocks[r.rank].cut(i, x1), blocks[r.rank].cut(i, q1)
            same = x == xb
            equal_inputs += int(same.sum())
            np.testing.assert_array_equal(q[same], qb[same])
            assert np.abs(q.astype(np.int32) - qb.astype(np.int32)).max() <= 1
    assert equal_inputs > 0
    # one int8 code step of the largest pod member, halved by the mean of 2
    steps = [max(np.abs(x1).max() for k, (x1, _) in enumerate(one["codes"]) if k % n_leaves == i)
             / 127 for i in range(n_leaves)]
    got = unshard_tree([r.value["params"] for r in own], cfg, mesh)
    for i, (g, w) in enumerate(zip(_leaves(got), _leaves(one["params"]))):
        np.testing.assert_allclose(g, w, rtol=0, atol=steps[i] / 2 + STEP_ATOL)
    got = unshard_tree([r.value["params"] for r in injected], cfg, mesh)
    for i, (g, w) in enumerate(zip(_leaves(got), _leaves(want))):
        np.testing.assert_allclose(g, w, rtol=0, atol=steps[i] / 2 + F32_LOGITS_ATOL)


@pytest.mark.parametrize("arch", ["qwen2_5_3b", "qwen3_moe_235b_a22b"])
def test_sampling_at_m2_equals_one_process(pool2, arch):
    """2 prompts, 8 tokens at temperature 1 from seed 0: every rank gathers
    the last position's vocabulary blocks and draws with the same seeded
    generator, so its tokens are the one-process run's (the JAX package's
    ``jax.random`` draws are another stream, so the twin is the port's)."""
    cfg = get_config(arch, reduced=True)
    params = _params(cfg)
    tokens, _ = _inputs(cfg)
    res = pool2.run(prog.sample_rank, cfg, params, tokens, 8, 1.0)
    want = prog.sample_rank(None, cfg, params, tokens, 8, 1.0)
    for r in res:
        np.testing.assert_array_equal(r.value["tokens"], want["tokens"])
    greedy = prog.sample_rank(None, cfg, params, tokens, 8, 0.0)
    assert not np.array_equal(greedy["tokens"], want["tokens"])  # it sampled


# ---------------------------------------------------------------------- #
# the counting group (launch.dryrun) against the gloo group
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["qwen2_5_3b", "qwen3_moe_235b_a22b", "hymba_1_5b",
                                  "xlstm_1_3b"])
def test_counting_group_counts_as_the_gloo_group(pool2, arch):
    """The dry run's counting group (fake tensors, no process group) at
    m = 2: the all-reduces (count and bytes) of each rank in a prefill and
    a decode step, and in a DP round with the int8 cross-pod wire, equal
    what each rank of the real two-rank group counts in the same call (the
    recurrent families' prompt two SSD chunks long)."""
    from repro_torch.fl.fedstep import FedStepConfig as TFed
    from repro_torch.fl.privacy import DPConfig as TDP
    from repro_torch.launch import dryrun

    cfg = get_config(arch, reduced=True)
    prompt = 24 if arch in ("qwen2_5_3b", "qwen3_moe_235b_a22b") else 2 * cfg.ssd_chunk
    real = pool2.run(prog.serve_counts_rank, cfg, 2, prompt)
    for r in real:
        assert dryrun.count_collectives(dryrun.serve_counts, 2, r.rank, cfg, 2, prompt) == r.value
        assert r.value["prefill"][0] > 0 and r.value["step"][0] > 0
    axes = (("pod", 2), ("data", 1), ("model", 2)) if arch == "qwen2_5_3b" else (
        ("data", 1), ("model", 2))
    wire = "int8" if arch == "qwen2_5_3b" else "f32"
    fed = dict(local_steps=1, local_lr=0.05, dp=DP)
    real = pool2.run(prog.train_counts_rank, cfg, axes, fed, (4, 16), wire)
    for r in real:
        got = dryrun.count_collectives(dryrun.train_counts, 2, r.rank, cfg, Mesh(axes),
                                       TFed(local_steps=1, local_lr=0.05, dp=TDP(**DP)),
                                       (4, 16), wire)
        assert got == tuple(r.value) and got[0] > 0
