"""The data axis as processes (``launch.tensor_parallel`` grids, FSDP's
``data``-dim blocks, data-parallel serving) on the CPU.

Two gloo pools of 4 processes (one for the module each): a (data 2,
model 2) grid and a (pod 2, data 1, model 2) grid. Their rank functions
live in ``tests/_torch_tp_programs.py``, which imports the port alone.
Checks, on the reduced configs in float32:

* the JAX package's sharded steps on 4 forced host devices (one
  subprocess for the module): the FSDP train step of Qwen3-MoE-235B-A22B
  (parameters within ``STEP_RTOL`` / ``STEP_ATOL`` of the one-process
  port's, and within the JAX twin's bound of the JAX package's) and its
  serving, and Qwen2.5-3B's and reduced Llama4's serving (logits within
  ``F32_LOGITS_ATOL``), at (data 2, model 2); Qwen2.5-3B's serving and the FSDP train step at
  (pod 2, data 1, model 2), where ``pod`` joins the row split and the
  gradient sum;
* the data gather's adjoint against one-process autograd;
* microbatch i's rows, joined over the data ranks, are the JAX package's
  microbatch i (its ``(k, B/k)`` reshape);
* the MoE routing blocks and the aux loss at data 2 equal the
  one-process ones, for whole blocks a rank and for one block spread over
  the ranks;
* the dry run's counting grid counts each rank's all-reduces by axis as
  the gloo grid does;
* reduced Llama4's expert leaves gathered one at a time by the expert FFN
  (one whole expert leaf alive at most, results equal to gathering every
  leaf as the layer begins), and a grid rank's init cutting each leaf to
  its block before it draws the next;
* the launchers at ``--ranks 6``: (data 3, model 2), rows joined in order,
  an FSDP config trained with its loss falling.
"""
import dataclasses
import json
import os
import subprocess
import sys
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_tp_programs as prog
from repro_torch.configs import get_config
from repro_torch.convert import tree_to_numpy, unshard_tree
from repro_torch.core.mesh_lowering import Mesh
from repro_torch.core.tree import tree_leaves
from repro_torch.fl.fedstep import split_batch
from repro_torch.launch import dryrun
from repro_torch.launch import tensor_parallel as tp
from repro_torch.models.api import build_model

ROOT = Path(__file__).resolve().parents[1]
STEP_RTOL, STEP_ATOL = 2e-5, 1e-6
F32_LOGITS_ATOL = 2e-4
B, S, STEPS = 4, 32, 3
CALL_S = 120.0
GRID = (("data", 2), ("model", 2))
PODS = (("pod", 2), ("data", 1), ("model", 2))
FED = dict(local_steps=2, local_lr=0.05)


@pytest.fixture(scope="module")
def grid():
    with tp.GroupPool(["cpu"] * 4, timeout_s=CALL_S, axes=GRID) as pool:
        yield pool


@pytest.fixture(scope="module")
def pods():
    with tp.GroupPool(["cpu"] * 4, timeout_s=CALL_S, axes=PODS) as pool:
        yield pool


def _params(cfg, seed=0):
    return tree_to_numpy(build_model(cfg, "cpu").init(torch.Generator().manual_seed(seed)))


def _tokens(cfg, rows, length, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (rows, length)).astype(np.int32)


def _joined(results, key, step=None):
    """The ranks' values as the whole batch: each client rank's vocabulary
    blocks side by side (model ranks fastest), the client ranks' rows in
    order."""
    m = 2
    vals = [r.value[key] if step is None else r.value[key][step] for r in results]
    return np.concatenate([np.concatenate(vals[i:i + m], axis=-1)
                           for i in range(0, len(vals), m)], axis=0)


# ---------------------------------------------------------------------- #
# the JAX package's sharded steps on 4 host devices
# ---------------------------------------------------------------------- #
_JAX_TWINS = r'''
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_config
from repro.fl.fedstep import FedStepConfig
from repro.launch.steps import build_serve_step, build_train_step

spec = json.loads(sys.argv[2])
out = {}
assert len(jax.devices()) == 4


def mesh_of(shape, names):
    return Mesh(np.array(jax.devices()[:4]).reshape(shape), tuple(names))


def save_tree(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + jax.tree_util.keystr(path)] = np.asarray(leaf)


for case in spec["serve"]:
    cfg = get_config(case["arch"], reduced=True)
    mesh = mesh_of(tuple(case["mesh"]), case["names"])
    tokens = np.asarray(case["tokens"], np.int32)
    Bn, Sn = tokens.shape
    steps = case["steps"]
    bundle, setup = build_serve_step(cfg, mesh, Sn + steps + 1, Bn)
    params = bundle.init(jax.random.key(0))
    name = case["name"]
    save_tree(name + "/params", params)
    params = jax.device_put(params, setup.param_shardings)
    cache = jax.device_put(bundle.init_cache(Bn, Sn + steps + 1), setup.cache_shardings)
    with mesh:
        prefill = jax.jit(setup.prefill)
        step = jax.jit(setup.serve_step)
        logits, cache = prefill(params, {"tokens": jnp.asarray(tokens)}, cache)
        for i in range(steps + 1):
            out[f"{name}/logits/{i}"] = np.asarray(logits)
            tok = jnp.argmax(logits[:, -1], axis=-1)
            if i < steps:
                logits, cache = step(params, cache, {"token": tok[:, None].astype(jnp.int32)})

for case in spec["train"]:
    cfg = get_config(case["arch"], reduced=True)
    mesh = mesh_of(tuple(case["mesh"]), case["names"])
    fed = FedStepConfig(local_steps=2, local_lr=0.05)
    bundle, setup = build_train_step(cfg, mesh, fed)
    assert setup.client_axes == ()
    params = bundle.init(jax.random.key(0))
    name = case["name"]
    save_tree(name + "/params0", params)
    state = setup.init_state(params)
    params = jax.device_put(params, setup.in_shardings[0])
    with mesh:
        step = jax.jit(setup.step)
        params, state, m = step(params, state, {"tokens": jnp.asarray(case["tokens"], jnp.int32)},
                                jax.random.key(3))
    save_tree(name + "/params1", params)
    for k in m:
        out[f"{name}/metric/{k}"] = np.asarray(m[k])
np.savez(sys.argv[1], **out)
'''

SERVE = {"moe@2x2": ("qwen3_moe_235b_a22b", GRID), "qwen@2x2": ("qwen2_5_3b", GRID),
         "qwen@2x1x2": ("qwen2_5_3b", PODS), "llama4@2x2": ("llama4_maverick_400b_a17b", GRID)}
# name -> (arch, grid): the reduced configs in float32 (reduced Llama4:
# dense and MoE layers interleaved, 4 experts top-1 and a shared expert,
# remat, as the published config)
TRAIN = {"moe@2x2": ("qwen3_moe_235b_a22b", GRID), "moe@2x1x2": ("qwen3_moe_235b_a22b", PODS),
         "llama4@2x2": ("llama4_maverick_400b_a17b", GRID)}
TRAIN_ARCH = "qwen3_moe_235b_a22b"


def _train_tokens(arch=TRAIN_ARCH):
    return _tokens(get_config(arch, reduced=True), 8, 16, 2)


@pytest.fixture(scope="module")
def jax_twins(tmp_path_factory):
    d = tmp_path_factory.mktemp("fsdp_twins")
    spec = {"serve": [], "train": []}
    for name, (arch, axes) in SERVE.items():
        spec["serve"].append(dict(
            arch=arch, mesh=[n for _, n in axes], names=[a for a, _ in axes], steps=STEPS,
            tokens=_tokens(get_config(arch, reduced=True), B, S, 1).tolist(), name=name))
    for name, (arch, axes) in TRAIN.items():
        spec["train"].append(dict(arch=arch, mesh=[n for _, n in axes],
                                  names=[a for a, _ in axes], tokens=_train_tokens(arch).tolist(),
                                  name="train/" + name))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
               "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")
    proc = subprocess.run([sys.executable, "-c", _JAX_TWINS, str(d / "out.npz"),
                           json.dumps(spec)], capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(d / "out.npz"))


def _jax_tree(out, prefix, like):
    from repro_torch.launch.sharding import map_with_path

    def leaf(path, _):
        key = prefix + "".join(f"[{k}]" if isinstance(k, int) else f"['{k}']" for k in path)
        return out[key]

    return map_with_path(leaf, like)


@pytest.mark.parametrize("name", list(SERVE))
def test_grid_serving_equals_the_jax_packages(jax_twins, grid, pods, name):
    """Each rank serves its rows (over pod x data) from the cache of its
    rows, FSDP's leaves gathered over data at use; the rows joined in
    order are the JAX package's batch, every step's logits within
    ``F32_LOGITS_ATOL``, and the greedy tokens equal."""
    arch, axes = SERVE[name]
    cfg = get_config(arch, reduced=True)
    params = _jax_tree(jax_twins, name + "/params", _params(cfg))
    tokens = _tokens(cfg, B, S, 1)
    pool = grid if axes == GRID else pods
    res = pool.run(prog.serve_rank, cfg, axes, params, tokens, None, STEPS)
    for step in range(STEPS + 1):
        want = jax_twins[f"{name}/logits/{step}"][..., :cfg.vocab_size]
        got = _joined(res, "logits", step)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_LOGITS_ATOL)
    tokens_by_rank = [r.value["tokens"] for r in res]
    for i in range(0, 4, 2):
        np.testing.assert_array_equal(tokens_by_rank[i], tokens_by_rank[i + 1])
    greedy = np.concatenate(tokens_by_rank[::2], axis=0)
    want = np.stack([np.argmax(jax_twins[f"{name}/logits/{i}"][:, -1, :cfg.vocab_size], -1)
                     for i in range(STEPS + 1)], 1)
    np.testing.assert_array_equal(greedy, want)
    counters = res[0].value["counters"]
    fsdp = cfg.param_sharding == "fsdp" and dict(axes)["data"] > 1
    assert (counters["data_gathered_leaves"] > 0) == fsdp
    assert counters["model_all_reduces"] > 0


@pytest.mark.parametrize("name", list(TRAIN))
def test_fsdp_train_step_equals_one_process_and_the_jax_packages(jax_twins, grid, pods, name):
    """One FSDP train step (2 local steps): every rank's (data, model)
    blocks, joined, within ``STEP_RTOL`` / ``STEP_ATOL`` of the one-process
    port's step under the grid's profile and within the JAX twin's bound of
    the JAX package's step; the loss is the global batch's on every rank.
    Reduced Llama4 too: its remat period, its expert leaves gathered by the
    expert FFN, each gradient applied as it is made."""
    arch, axes = TRAIN[name]
    cfg = get_config(arch, reduced=True)
    like = _params(cfg)
    params = _jax_tree(jax_twins, f"train/{name}/params0", like)
    batch = {"tokens": _train_tokens(arch)}
    pool = grid if axes == GRID else pods
    res = pool.run(prog.train_rank, cfg, axes, params, batch, 3, FED)
    one = prog.train_rank(None, cfg, axes, params, batch, 3, FED)
    got = unshard_tree([r.value["params"] for r in res], cfg, Mesh(axes))
    for g, w in zip(tree_leaves(got), tree_leaves(one["params"])):
        np.testing.assert_allclose(g, w, rtol=STEP_RTOL, atol=STEP_ATOL)
    want = _jax_tree(jax_twins, f"train/{name}/params1", like)
    # reduced Llama4 is held to the JAX package's step at the one-process
    # bound itself
    rtol, atol = (STEP_RTOL, STEP_ATOL) if arch == "llama4_maverick_400b_a17b" else (
        1e-4, F32_LOGITS_ATOL)
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)
    for r in res:
        for k in ("loss", "delta_norm"):
            np.testing.assert_allclose(r.value["metrics"][k], one["metrics"][k], rtol=STEP_RTOL)
            np.testing.assert_allclose(r.value["metrics"][k],
                                       jax_twins[f"train/{name}/metric/{k}"],
                                       rtol=min(rtol, 1e-4))
        assert r.value["counters"]["data_all_reduces"] > 0  # the gradient sums over the rows
    assert (res[0].value["counters"]["data_gathered_leaves"] > 0) == (axes == GRID)


@pytest.mark.parametrize("name,sliced", [(n, False) for n in TRAIN] + [("llama4@2x2", True)],
                         ids=list(TRAIN) + ["llama4@2x2-sliced"])
def test_streamed_grid_step_is_byte_equal_to_the_functional_step(grid, pods, name, sliced):
    """Each rank's one-client step takes its blocks over and steps each as
    soon as autograd has made its gradient, each gathered leaf's gradient
    reduced to its block's owner: its new blocks, loss and ``delta_norm``
    are, bit for bit, those of the functional step (every gradient at
    once, the gather's backward an all-reduce over the rows cut to the
    block, new tensors, the deltas summed at the end), at (data 2, model 2)
    and (pod 2, data 1, model 2); reduced Llama4 also with its rank's
    memory share one expert's (the expert FFN then takes one expert a
    slice, forward and backward). At (data 2, model 2) no more than one
    expert leaf's gradient is alive at once on a rank."""
    arch, axes = TRAIN[name]
    cfg = get_config(arch, reduced=True)
    pool = grid if axes == GRID else pods
    share = None
    if sliced:  # one expert's three whole float32 leaves fill the forward's share
        from repro_torch.models import moe

        share = int(3 * cfg.d_model * cfg.moe_d_ff * 4 / moe.GATHER_SHARE)
    res = pool.run(prog.streamed_step_rank, cfg, axes, _params(cfg),
                   {"tokens": _train_tokens(arch)}, 3, FED, share)
    for r in res:
        v = r.value
        assert all(v["equal"]) and v["loss_equal"] and v["norm_equal"] and v["in_place"]
        assert (v["counters"]["data_reduces"] > 0) == (axes == GRID)
        if axes == GRID:
            layers = cfg.num_layers // cfg.moe_every
            assert v["expert_updates"] == 3 * layers * FED["local_steps"]
            assert v["most_alive"] == 1


def test_reduce_to_owners_is_byte_equal_to_the_all_reduce_cut(grid):
    """The gradient of a leaf gathered over data, summed into the rank's
    block by a reduce of each data block to its owner (point-to-point
    sends, the owner adding), equals the whole leaf's all-reduce over the
    rows cut to the block, bit for bit, at data 2 (two terms: their order
    does not matter), in float32 and bfloat16, along dim 0 and dim 1; the
    block is a buffer of its own, and each rank counts one reduce a data
    rank at its block's bytes, no all-reduce."""
    for r in grid.run(prog.reduce_to_owners_rank, 5):
        for case, v in r.value.items():
            assert v["equal"] and v["own"], (r.rank, case)
            c = v["counters"]
            itemsize = 4 if case.startswith("float32") else 2
            assert (c["data_reduces"], c["data_reduce_bytes"]) == (2, 6 * 10 * 3 * itemsize)
            assert c["all_reduces"] == 0


def test_fsdp_train_step_with_remat_gathers_again_in_the_recompute(grid):
    """The published config's stacked, remat layers on the grid: the step
    equals the one-process port's, and each layer's data blocks are
    gathered twice a local step (the forward and the recompute), where
    without remat they are gathered once."""
    base = dataclasses.replace(get_config(TRAIN_ARCH, reduced=True), scan_layers=True)
    batch = {"tokens": _train_tokens()}
    gathered = {}
    for remat in (True, False):
        cfg = dataclasses.replace(base, remat=remat)
        params = _params(cfg)
        res = grid.run(prog.train_rank, cfg, GRID, params, batch, 3, FED)
        one = prog.train_rank(None, cfg, GRID, params, batch, 3, FED)
        got = unshard_tree([r.value["params"] for r in res], cfg, Mesh(GRID))
        for g, w in zip(tree_leaves(got), tree_leaves(one["params"])):
            np.testing.assert_allclose(g, w, rtol=STEP_RTOL, atol=STEP_ATOL)
        gathered[remat] = res[0].value["counters"]["data_gathered_leaves"]
    from repro_torch.launch.sharding import map_with_path
    from repro_torch.models import transformer

    split = []
    map_with_path(lambda path, spec: split.append("data" in spec),
                  transformer.param_specs_on(base, Mesh(GRID))["groups"])
    assert sum(split) > 0
    # each stacked leaf's layers, one gather more a local step each
    assert gathered[True] - gathered[False] == sum(split) * base.num_layers * FED["local_steps"]


def test_expert_leaves_are_gathered_one_at_a_time(grid):
    """Reduced Llama4 on the grid: the expert FFN gathers each expert leaf
    over data as it uses it, so in serving (a prefill and decode steps)
    never more than one whole expert leaf is alive. Where three whole
    leaves fit the rank's memory share (on the CPU, no bound) a train
    step's forward keeps them for the backward, as gathering them as the
    layer begins does; with a share that one expert's three leaves fill,
    the FFN takes its experts one at a time, frees each leaf after its
    product and gathers down, up and gate again in the backward (the
    products' float32 gate and up outputs kept for it), one alive at a
    time. The logits, the loss and the gradients of every
    block are the same, bit for bit, in the three ways."""
    from repro_torch.models import moe

    cfg = get_config("llama4_maverick_400b_a17b", reduced=True)
    moe_layers = cfg.num_layers // cfg.moe_every
    E = cfg.num_experts // 2
    one_expert = cfg.d_model * cfg.moe_d_ff * 4  # one expert's whole leaf, float32
    share = int(3 * one_expert / moe.GATHER_SHARE)
    res = grid.run(prog.expert_gathers_rank, cfg, GRID, _params(cfg), _tokens(cfg, B, S, 1), STEPS,
                   share)
    calls = 1 + STEPS
    for r in res:
        at_use, at_layer, sliced = r.value["at_use"], r.value["at_layer"], r.value["sliced"]
        assert sliced["serve"]["most_alive"] == 1 and sliced["train"]["most_alive"] == 1
        assert sliced["serve"]["gathers"] == 3 * E * moe_layers * calls
        assert sliced["train"]["gathers"] == (3 + 3) * E * moe_layers
        assert at_use["serve"]["most_alive"] == 1
        assert at_use["serve"]["gathers"] == at_layer["serve"]["gathers"] == 3 * moe_layers * calls
        # kept for the backward: every MoE layer's three at the end of the
        # forward, either way, and not gathered again
        assert at_layer["serve"]["most_alive"] == 3
        assert at_use["train"]["most_alive"] == at_layer["train"]["most_alive"] == 3 * moe_layers
        assert at_use["train"]["gathers"] == at_layer["train"]["gathers"] == 3 * moe_layers
        for way in (at_use, at_layer, sliced):
            assert way["serve"]["alive_after"] == way["train"]["alive_after"] == 0
        for other in (sliced, at_layer):
            for a, b in zip(other["logits"], at_use["logits"]):
                np.testing.assert_array_equal(a, b)
            assert other["loss"] == at_use["loss"]
            for a, b in zip(other["grads"], at_use["grads"]):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("scan_layers", [False, True], ids=["layers", "stacked"])
def test_a_grid_ranks_init_holds_one_whole_leaf_at_a_time(scan_layers, monkeypatch):
    """A (data 2, model 2) rank's init of reduced Llama4 draws in the
    one-process order and cuts each leaf to its block before it draws the
    next: at every draw the leaf drawn before it has been cut and no whole
    leaf it cut is alive. Each rank's tree is, byte for byte, the
    one-process draw cut by ``sharding.shard``."""
    from repro_torch.launch import sharding
    from repro_torch.models import layers, moe

    cfg = dataclasses.replace(get_config("llama4_maverick_400b_a17b", reduced=True),
                              scan_layers=scan_layers)
    mesh = Mesh(GRID)
    normal, shard = layers._normal, sharding.shard
    shapes = []

    def counting(gen, shape):
        shapes.append(tuple(shape))
        return normal(gen, shape)

    monkeypatch.setattr(layers, "_normal", counting)
    monkeypatch.setattr(moe, "_normal", counting)
    whole = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    specs = sharding.param_specs(whole, cfg, mesh)
    state = {"pending": None, "draws": 0, "cut": []}

    def held_whole():
        return [tuple(x.shape) for x in (r() for r in state["cut"]) if x is not None]

    def drawing(gen, shape):
        if gen.device.type == "meta":  # the specs' shapes, drawn on no device
            return normal(gen, shape)
        assert state["pending"] is None, f"draw {state['draws']}: {state['pending']} was not cut"
        assert not held_whole(), f"draw {state['draws']}: whole leaves alive {held_whole()}"
        state["pending"], state["draws"] = tuple(shape), state["draws"] + 1
        return normal(gen, shape)

    def cutting(leaf, spec, mesh, coords):
        if tuple(leaf.shape) == state["pending"]:
            state["pending"] = None
        if any(e is not None for e in spec):
            state["cut"].append(weakref.ref(leaf))
        return shard(leaf, spec, mesh, coords)

    monkeypatch.setattr(layers, "_normal", drawing)
    monkeypatch.setattr(moe, "_normal", drawing)
    monkeypatch.setattr(sharding, "shard", cutting)
    for c in sharding.mesh_coords(mesh):
        state.update(pending=None, draws=0, cut=[])
        group = tp.ModelGroup(rank=c["model"], size=2, clients=(("data", 2),),
                              client_rank=c["data"])
        got = build_model(cfg, "cpu", group).init(torch.Generator().manual_seed(0))
        assert state["pending"] is None and not held_whole()
        assert state["draws"] == len(shapes)  # the one-process draws, one for one
        want = sharding.shard_tree(whole, specs, mesh, c)
        flat = {}
        sharding.map_with_path(lambda path, x: flat.__setitem__(path, x), got)
        seen = []
        sharding.map_with_path(lambda path, x: seen.append(path) or torch.testing.assert_close(
            flat[path], x, rtol=0, atol=0), want)
        assert sorted(seen) == sorted(flat)


# ---------------------------------------------------------------------- #
# the pieces
# ---------------------------------------------------------------------- #
def test_data_gather_adjoint_equals_one_process_autograd(grid):
    """W's rows in data blocks, gathered at use; each rank's rows of x; the
    loss summed over the rows group: the loss, the gathered W and each
    block's gradient (summed over the rows in the gather's backward) are
    one-process autograd's."""
    rng = np.random.default_rng(7)
    w = rng.standard_normal((6, 5)).astype(np.float32)
    x = rng.standard_normal((4, 6)).astype(np.float32)
    wt = torch.from_numpy(w).requires_grad_(True)
    loss = torch.sum((torch.from_numpy(x) @ wt) ** 2)
    loss.backward()
    loss = loss.item()
    for r in grid.run(prog.data_gather_adjoint_rank, w, x):
        d = r.value
        np.testing.assert_allclose(d["loss"], loss, rtol=1e-6)
        np.testing.assert_array_equal(d["w_whole"], w)  # the gather is exact
        lo = (r.rank // 2) * 3  # the rank's data coordinate's rows
        np.testing.assert_allclose(d["gw"], wt.grad.numpy()[lo:lo + 3], rtol=1e-5, atol=1e-6)
        c = d["counters"]
        assert (c["data_gathered_leaves"], c["data_gathered_bytes"]) == (1, w.nbytes)
        # the loss's sum over the client axes, and the gradient's: a reduce
        # of each data block to its owner, counted at the block's bytes (the
        # gather is an all-gather, counted as the gathered leaf)
        assert c["data_all_reduces"] == 1 and c["model_all_reduces"] == 0
        assert (c["data_reduces"], c["data_reduce_bytes"]) == (2, w.nbytes)


@pytest.mark.parametrize("k,ranks", [(2, 2), (2, 4), (4, 2)])
def test_microbatch_rows_joined_over_data_are_the_jax_packages(k, ranks):
    """``local_round`` cuts the batch into k microbatches, then each
    microbatch over the client ranks: rank r's rows of microbatch i, joined
    over r, are row block i of the JAX package's ``(k, B/k)`` reshape."""
    import jax.numpy as jnp

    rows = 4 * k * ranks
    batch = {"tokens": np.arange(rows * 3, dtype=np.int32).reshape(rows, 3)}
    micro = jnp.asarray(batch["tokens"]).reshape((k, rows // k, 3))
    for i in range(k):
        mb = split_batch(batch, k, i)
        joined = np.concatenate([split_batch(mb, ranks, r)["tokens"] for r in range(ranks)])
        np.testing.assert_array_equal(joined, np.asarray(micro[i]))
    # splitting over the ranks first would give the last rank other rows
    last = ranks - 1
    first = split_batch(split_batch(batch, ranks, last), k, 0)["tokens"]
    assert not np.array_equal(first, split_batch(split_batch(batch, k, 0), ranks, last)["tokens"])


@pytest.mark.parametrize("seq", [32, 1], ids=["whole_blocks", "one_block_spread"])
def test_routing_blocks_and_aux_at_data2_equal_one_process(grid, seq):
    """``moe_apply`` on each rank's rows under the (data 2, model 2)
    profile: at 4 x 32 tokens each rank routes its 2 of the 4 one-process
    blocks, at 4 x 1 the one block spans both data ranks (its slots ranked
    after the other rank's). The rows joined equal the one-process output,
    and the ranks' aux shares sum to the one-process aux; a profile of
    other blocks gives another output (the blocks matter)."""
    # a capacity of 8 slots a block of 32 tokens (16 on average) drops slots,
    # and which ones depends on the blocks
    cfg = dataclasses.replace(get_config(TRAIN_ARCH, reduced=True), capacity_factor=0.5)
    rng = np.random.default_rng(11)
    d, E, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    p = {"router": rng.standard_normal((d, E)).astype(np.float32) * 3.0,
         "gate": rng.standard_normal((E, d, ff)).astype(np.float32) * d ** -0.5,
         "up": rng.standard_normal((E, d, ff)).astype(np.float32) * d ** -0.5,
         "down": rng.standard_normal((E, ff, d)).astype(np.float32) * ff ** -0.5}
    x = rng.standard_normal((4, seq, d)).astype(np.float32)
    res = grid.run(prog.moe_rows_rank, cfg, p, x, GRID)
    one = prog.moe_rows_rank(None, cfg, p, x, GRID)
    y = np.concatenate([res[i].value["y"] for i in (0, 2)], axis=0)
    np.testing.assert_allclose(y, one["y"], rtol=1e-5, atol=1e-6)
    for i in (0, 2):
        np.testing.assert_array_equal(res[i].value["y"], res[i + 1].value["y"])
    np.testing.assert_allclose(res[0].value["aux"] + res[2].value["aux"], one["aux"], rtol=1e-5)
    spread = res[0].value["counters"]["data_all_reduces"]
    assert spread == (1 if seq == 1 else 0)  # the other rank's slot counts
    if seq > 1:
        other = prog.moe_rows_rank(None, cfg, p, x, (("data", 1), ("model", 1)))
        assert not np.allclose(other["y"], one["y"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", ["qwen3_moe_235b_a22b", "qwen2_5_3b",
                                  "llama4_maverick_400b_a17b"])
def test_counting_grid_counts_as_the_gloo_grid(grid, arch):
    """The dry run's counting grid (fake tensors, no process group) at
    (data 2, model 2): each rank's collectives by axis (count, bytes; over
    data the all-reduces, the gathers and the gradient blocks' reduces to
    their owners) in a prefill, a decode step and, for the FSDP configs
    (Llama4's remat period too), a train step equal the gloo grid's."""
    from repro_torch.fl.fedstep import FedStepConfig

    cfg = get_config(arch, reduced=True)
    real = grid.run(prog.serve_counts_rank, cfg, 4, 24, True)
    for r in real:
        got = dryrun.count_grid_collectives(dryrun.serve_counts, GRID, r.rank, cfg, 4, 24, True)
        assert got == r.value
        assert (r.value["prefill"]["data"][0] > 0) == (cfg.param_sharding == "fsdp")
    if cfg.param_sharding == "fsdp":
        real = grid.run(prog.train_counts_rank, cfg, GRID, FED, (8, 16), "f32", True)
        for r in real:
            got = dryrun.count_grid_collectives(dryrun.train_counts, GRID, r.rank, cfg,
                                                Mesh(GRID), FedStepConfig(**FED), (8, 16),
                                                "f32", None, True)
            assert got == r.value and got["data"][0] > 0 and got["model"][0] > 0


def test_a_recompute_on_another_thread_keeps_the_routing_profile():
    """A remat layer's recompute runs in the backward, which on the card
    autograd runs on its device thread, outside the forward's context: the
    checkpoint carries the sharding profile there (its ``min_blocks`` cuts
    the routing blocks). The gradients from a backward on another thread
    equal those of a backward on this one."""
    import threading

    from repro_torch.core.tree import tree_flatten, tree_unflatten
    from repro_torch.launch.steps import _with_moe_profile

    cfg = dataclasses.replace(get_config(TRAIN_ARCH, reduced=True), scan_layers=True,
                              remat=True, capacity_factor=0.5)
    bundle = build_model(cfg, "cpu")
    leaves, treedef = tree_flatten(bundle.init(torch.Generator().manual_seed(0)))
    batch = {"tokens": torch.from_numpy(_tokens(cfg, 4, 32, 5))}
    loss_fn = _with_moe_profile(bundle.loss_fn, cfg, Mesh(GRID))

    def grads(on_thread):
        xs = [x.detach().requires_grad_(True) for x in leaves]
        with torch.enable_grad():
            loss = loss_fn(tree_unflatten(treedef, xs), batch, None)
        if on_thread:
            t = threading.Thread(target=loss.backward)
            t.start()
            t.join()
        else:
            loss.backward()
        return [x.grad for x in xs]

    here, there = grads(False), grads(True)
    assert all(g is not None for g in there)
    for a, b in zip(here, there):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------- #
# the launchers at --ranks 6: (data 3, model 2)
# ---------------------------------------------------------------------- #
def _rows(out):
    line = next(ln for ln in out.splitlines() if "every row's first token ids" in ln)
    return line.split(":", 1)[1].strip()


def test_serve_launcher_at_six_ranks_joins_the_rows_in_order(capsys):
    from repro_torch.launch import serve

    args = ["--reduced", "--device", "cpu", "--gen", "4", "--prompt-len", "16"]
    assert serve.main(args + ["--ranks", "6"]) == 0
    out = capsys.readouterr().out
    assert "grid {'data': 3, 'model': 2}" in out and "rows of 3 data ranks joined: (6, 4)" in out
    assert serve.main(args + ["--batch", "6"]) == 0
    assert _rows(out) == _rows(capsys.readouterr().out)


def test_train_launcher_at_six_ranks_trains_an_fsdp_config(capfd):
    from repro_torch.launch import train

    assert train.main(["--arch", "qwen3_moe_235b_a22b", "--reduced", "--device", "cpu",
                       "--ranks", "6", "--steps", "4", "--log-every", "1"]) == 0
    out = capfd.readouterr().out  # the first rank prints the steps
    assert "grid {'data': 3, 'model': 2}" in out and "clients over ()" in out
    losses = [float(ln.split("loss ")[1].split()[0]) for ln in out.splitlines()
              if ln.startswith("[train] step")]
    assert len(losses) == 4 and losses[-1] < losses[0]
