"""The port's training half (``models`` loss, ``data`` streams,
``launch.steps`` / ``launch.train``, ``convert``'s server states) against
the JAX package's, on the CPU, at the reduced configs (float32).

Weights come from the JAX package's init and are carried across with
``params_from_jax``, server states with ``tree_from_numpy``; batches
are the same numpy arrays. Where the JAX side needs several clients it runs
in a subprocess with 4 host devices (one per test module). Tolerances:

* loss: rtol 1e-5 (a mean cross-entropy of about 6 through 2 layers;
  ``tests/test_torch_models.py`` holds the logits to 2e-4 absolute, and
  a mean of log-softmax terms carries less than that);
* gradients: per leaf within 1e-4 of the leaf's largest magnitude
  (float32 products summed in other orders, through the backward);
* data streams: equal arrays (dtype, shape, bytes);
* a ``build_train_step`` round (FedAdam): loss rtol 1e-5, ``delta_norm``
  rtol 1e-4, parameters within 1e-4 absolute. FedAdam moves each
  parameter by ``0.01 * m / (sqrt(v) + 1e-3)``: about 0.01 per element
  wherever the delta exceeds 1e-3, a value the float32 differences of the
  delta (relative 1e-5) cannot flip, and at most half the delta's own
  difference below that; 1e-4 is a tenth of the smallest such step, and a
  sign error would read 0.02. With the bf16 cross-pod wire one bfloat16
  rounding may land on the other side: parameters within 2e-3 there.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro.configs import get_config as jax_get_config
from repro.data import datasets as jdata
from repro.data import pipeline as jpipe
from repro.fl.fedstep import FedStepConfig as JFedStepConfig
from repro.launch.steps import build_train_step as jax_build_train_step
from repro.models import transformer as jtransformer
from repro.models.api import build_model as jax_build_model
from repro_torch.checkpoint.checkpoint import latest_step
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, tree_from_numpy
from repro_torch.core.mesh_lowering import Mesh
from repro_torch.core.tree import tree_flatten, tree_unflatten
from repro_torch.data import datasets as tdata
from repro_torch.data import pipeline as tpipe
from repro_torch.fl.fedstep import FedStepConfig, value_and_grad
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_smoke_mesh, make_virtual_mesh
from repro_torch.launch.steps import build_train_step
from repro_torch.models import transformer
from repro_torch.models.api import build_model

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
LOSS_RTOL, GRAD_REL = 1e-5, 1e-4
NORM_RTOL, PARAM_ATOL, BF16_WIRE_PARAM_ATOL = 1e-4, 1e-4, 2e-3


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this file's torch work: the suite runs six
    files at once on the CPU, and eight threads in each slowed a 4 s
    launcher case to 240 s."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _host(tree):
    """A JAX tree as numpy arrays, dict key order kept."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_host(v) for v in tree)
    return np.asarray(tree)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _batch(cfg, seed, batch=2, seq=24):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, size=(batch, seq)).astype(np.int32)}
    if cfg.family == "vlm":
        out["patch_embeds"] = np.full((batch, cfg.vision_patches, cfg.d_model), 0.1, np.float32)
        out["positions"] = np.broadcast_to(
            np.arange(seq, dtype=np.int32)[None, None], (3, batch, seq)).copy()
    return out


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_grads(got, want):
    gl, _ = tree_flatten(got)
    wl = jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        w = np.asarray(w)
        np.testing.assert_allclose(_np(g), w, rtol=0, atol=GRAD_REL * float(np.abs(w).max()) + 1e-12)


# ---------------------------------------------------------------------- #
# the loss and its gradient: test_models.py's cases
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["qwen2_5_3b", "qwen2_vl_2b"])
def test_forward_and_train_step(arch):
    """``TestArchSmoke.test_forward_and_train_step`` (dense and vlm): the
    loss and its gradient against the JAX package's, then the reference's
    norm-clipped SGD step, which must not raise the loss, on both sides."""
    jcfg, cfg = jax_get_config(arch, reduced=True), get_config(arch, reduced=True)
    jb = jax_build_model(jcfg)
    key = jax.random.key(0)
    jparams = jb.init(key)
    batch = _batch(cfg, 1)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss_fn = jax.jit(lambda p: jb.loss_fn(p, jbatch, key))
    jloss, jgrads = jax.jit(jax.value_and_grad(jloss_fn))(jparams)

    bundle = build_model(cfg, "cpu")
    params = params_from_jax(_host(jparams), CPU)
    leaves, treedef = tree_flatten(params)
    loss, grads = value_and_grad(bundle.loss_fn, leaves, treedef, _tbatch(batch), None)
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    _assert_grads(tree_unflatten(treedef, grads), jgrads)

    gnorm = sum(float(torch.sum(torch.square(g))) for g in grads)
    assert np.isfinite(gnorm) and gnorm > 0
    scale = 0.1 / max(1.0, np.sqrt(gnorm))
    new = tree_unflatten(treedef, [w - scale * g for w, g in zip(leaves, grads)])
    with torch.no_grad():
        loss2 = bundle.loss_fn(new, _tbatch(batch), None)
    assert float(loss2) < float(loss) + 1e-3
    jnew = jax.tree_util.tree_map(lambda w, g: w - scale * g, jparams, jgrads)
    np.testing.assert_allclose(float(loss2), float(jloss_fn(jnew)), rtol=LOSS_RTOL)


def test_chunked_ce_matches_full():
    """``test_models.py::test_chunked_ce_matches_full``: the chunked
    (recomputed) cross-entropy equals the one-block one within 1e-4, and
    both equal the JAX package's."""
    cfg = get_config("qwen2_5_3b", reduced=True)
    jcfg = jax_get_config("qwen2_5_3b", reduced=True)
    jparams = jax_build_model(jcfg).init(jax.random.key(4))
    params = params_from_jax(_host(jparams), CPU)
    batch = _batch(cfg, 4, batch=2, seq=33)  # 64 targets: 16 chunks of 4
    l1 = build_model(cfg, "cpu").loss_fn(params, _tbatch(batch), None)
    l2 = build_model(dataclasses.replace(cfg, scan_attn_chunks=True), "cpu").loss_fn(
        params, _tbatch(batch), None)
    assert float(abs(l1 - l2)) < 1e-4
    jl = jax.jit(jax_build_model(dataclasses.replace(jcfg, scan_attn_chunks=True)).loss_fn)(
        jparams, {"tokens": jnp.asarray(batch["tokens"])}, None)
    np.testing.assert_allclose(float(l2), float(jl), rtol=LOSS_RTOL)


@pytest.mark.parametrize("use_scan", [False, True])
def test_chunked_ce_and_its_gradient_match_reference(use_scan):
    rng = np.random.default_rng(5)
    h = rng.normal(size=(2, 32, 16)).astype(np.float32)
    emb = (0.3 * rng.normal(size=(50, 16))).astype(np.float32)
    t = rng.integers(0, 50, size=(2, 32)).astype(np.int32)
    jl, (jgh, jge) = jax.jit(jax.value_and_grad(
        lambda h_, e_: jtransformer.chunked_ce(h_, {"emb": e_}, jnp.asarray(t), use_scan=use_scan),
        argnums=(0, 1)))(jnp.asarray(h), jnp.asarray(emb))
    th = torch.from_numpy(h).requires_grad_(True)
    te = torch.from_numpy(emb).requires_grad_(True)
    tl = transformer.chunked_ce(th, {"emb": te}, torch.from_numpy(t), use_scan=use_scan)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
    np.testing.assert_allclose(_np(th.grad), np.asarray(jgh), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_np(te.grad), np.asarray(jge), rtol=0, atol=1e-6)


@pytest.mark.parametrize("knob", ["remat", "scan_attn_chunks"])
def test_recompute_changes_no_value(knob):
    """``cfg.remat`` (a checkpoint around each scanned group) and the chunk
    recompute of ``scan_attn_chunks``: the same loss and gradients, bit for
    bit, as without; and the JAX package's, with its stacked parameters."""
    base = dataclasses.replace(get_config("qwen2_5_3b", reduced=True), scan_layers=True,
                               q_chunk=8)
    jbase = dataclasses.replace(jax_get_config("qwen2_5_3b", reduced=True), scan_layers=True,
                                q_chunk=8)
    on = dataclasses.replace(base, **{knob: True})
    jparams = jax_build_model(jbase).init(jax.random.key(2))
    batch = _batch(base, 6, seq=24)
    out = []
    for cfg in (base, on):
        params = params_from_jax(_host(jparams), CPU)
        leaves, treedef = tree_flatten(params)
        out.append(value_and_grad(build_model(cfg, "cpu").loss_fn, leaves, treedef,
                                  _tbatch(batch), None))
    assert out[0][0].item() == out[1][0].item()
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)
    jon = dataclasses.replace(jbase, **{knob: True})
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: jax_build_model(jon).loss_fn(
        p, {"tokens": jnp.asarray(batch["tokens"])}, None)))(jparams)
    np.testing.assert_allclose(float(out[1][0]), float(jloss), rtol=LOSS_RTOL)
    _assert_grads(tree_unflatten(treedef, out[1][1]), jgrads)


# ---------------------------------------------------------------------- #
# the LM data streams: equal arrays
# ---------------------------------------------------------------------- #
def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def test_synthetic_lm_shards_equal():
    want = jdata.synthetic_lm_shards(7, seq_len=16, num_seqs=10, vocab_size=97)
    got = tdata.synthetic_lm_shards(7, seq_len=16, num_seqs=10, vocab_size=97)
    assert [s.name for s in got] == [s.name for s in want]
    for g, w in zip(got, want):
        _same(g.x, w.x)
        _same(g.y, w.y)


@pytest.mark.parametrize("vocab,batch,seq,seed", [(512, 8, 128, 0), (151936, 4, 33, 3)])
def test_synthetic_lm_batches_equal(vocab, batch, seq, seed):
    jit_, tit = (jdata.synthetic_lm_batches(vocab, batch, seq, seed),
                 tdata.synthetic_lm_batches(vocab, batch, seq, seed))
    for _ in range(4):
        _same(next(tit), next(jit_))


def test_batch_pipeline_and_lm_batches_equal():
    shards_j = jdata.synthetic_lm_shards(3, seq_len=8, num_seqs=10, vocab_size=50)
    shards_t = tdata.synthetic_lm_shards(3, seq_len=8, num_seqs=10, vocab_size=50)
    for drop in (True, False):
        pj = jpipe.BatchPipeline(shards_j[1], 4, seed=2, drop_remainder=drop)
        pt = tpipe.BatchPipeline(shards_t[1], 4, seed=2, drop_remainder=drop)
        for e in range(3):
            bj, bt = list(pj.epoch(e)), list(pt.epoch(e))
            assert len(bj) == len(bt)
            for a, b in zip(bt, bj):
                _same(a["x"], b["x"])
                _same(a["y"], b["y"])
        _same(pt.sample(1)["x"], pj.sample(1)["x"])
    jit_, tit = jpipe.lm_batches(shards_j, 4, seed=1), tpipe.lm_batches(shards_t, 4, seed=1)
    for _ in range(11):  # past the end of an epoch of each shard
        a, b = next(tit), next(jit_)
        _same(a["tokens"], b["tokens"])
        _same(a["labels"], b["labels"])


# ---------------------------------------------------------------------- #
# build_train_step rounds: the JAX package's against the port's
# ---------------------------------------------------------------------- #
FED = dict(local_steps=2, local_lr=0.05)
ROUNDS, BATCH, SEQ = 2, 8, 16


def _train_batches(cfg):
    """The JAX driver's batches: its token stream, and for a VLM zero patch
    embeddings and text positions (M-RoPE's three streams lead)."""
    it = jdata.synthetic_lm_batches(vocab=cfg.vocab_size, batch=BATCH, seq=SEQ, seed=0)
    out = []
    for _ in range(ROUNDS):
        batch = {"tokens": next(it)}
        if cfg.family == "vlm":
            batch["patch_embeds"] = np.zeros((BATCH, cfg.vision_patches, cfg.d_model), np.float32)
            batch["positions"] = np.broadcast_to(
                np.arange(SEQ, dtype=np.int32)[None, None], (3, BATCH, SEQ)).copy()
        out.append(batch)
    return out


def _port_rounds(cfg, mesh, init_params, init_state, batches, cross_pod_wire="f32"):
    bundle, setup = build_train_step(cfg, mesh, FedStepConfig(**FED),
                                     cross_pod_wire=cross_pod_wire, device="cpu")
    params = params_from_jax(init_params, CPU)
    state = tree_from_numpy(init_state, CPU) if init_state is not None else setup.init_state(
        params)
    out = []
    for i, batch in enumerate(batches):
        params, state, m = setup.step(params, state, batch, i)
        # a copy: a one-client step takes the parameters it is given over
        out.append(({k: float(v) for k, v in m.items()}, _copied(params), state))
    return setup, out


def _copied(tree):
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [x.clone() for x in leaves])


def _assert_round(got_m, got_p, want_m, want_leaves, param_atol=PARAM_ATOL):
    np.testing.assert_allclose(got_m["loss"], want_m["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got_m["delta_norm"], want_m["delta_norm"], rtol=NORM_RTOL)
    leaves, _ = tree_flatten(got_p)
    assert len(leaves) == len(want_leaves)
    for g, w in zip(leaves, want_leaves):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0, atol=param_atol)


@pytest.mark.parametrize("arch", ["qwen2_5_3b", "qwen2_vl_2b"])
def test_one_client_round_matches_reference(arch):
    """The smoke mesh (data 1, model 1): ``classical_fl`` over one client,
    FedAdam, 2 rounds, the JAX package's server state carried across; for
    the VLM the microbatch split cuts M-RoPE ``positions`` on dim 1."""
    jcfg, cfg = jax_get_config(arch, reduced=True), get_config(arch, reduced=True)
    mesh = compat.make_mesh((1, 1), ("data", "model"))
    jbundle, jsetup = jax_build_train_step(jcfg, mesh, JFedStepConfig(**FED))
    jparams = jbundle.init(jax.random.key(0))
    jstate = jsetup.init_state(jparams)
    init_p, init_s = _host(jparams), _host(jstate)
    batches = _train_batches(cfg)
    step = jax.jit(jsetup.step)
    want = []
    for i, batch in enumerate(batches):
        jparams, jstate, jm = step(jparams, jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                                   jax.random.key(i))
        want.append(({k: float(v) for k, v in jm.items()}, jax.tree_util.tree_leaves(jparams)))
    setup, got = _port_rounds(cfg, make_smoke_mesh(), init_p, init_s, batches)
    assert setup.client_axes == ("data",) and setup.tag.name == "classical-fl"
    for (gm, gp, _), (wm, wl) in zip(got, want):
        _assert_round(gm, gp, wm, wl)
    m_leaves, _ = tree_flatten(got[-1][2]["stages"]["root"]["m"])
    for g, w in zip(m_leaves, jax.tree_util.tree_leaves(jstate["stages"]["root"]["m"])):
        # FedAdam's first moment is a tenth of the delta: the delta's relative
        # tolerance (some VLM leaves' deltas are in the hundreds)
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=NORM_RTOL, atol=1e-6)


def test_single_client_branch_matches_reference():
    """Clients on the pod axis and a mesh without one: the plain local-SGD
    step (no server state), the JAX package's degenerate branch."""
    jcfg = dataclasses.replace(jax_get_config("qwen2_5_3b", reduced=True), fl_axes=("pod",))
    cfg = dataclasses.replace(get_config("qwen2_5_3b", reduced=True), fl_axes=("pod",))
    mesh = compat.make_mesh((1, 1), ("data", "model"))
    jbundle, jsetup = jax_build_train_step(jcfg, mesh, JFedStepConfig(**FED))
    jparams = jbundle.init(jax.random.key(1))
    init_p = _host(jparams)
    batches = _train_batches(cfg)
    step = jax.jit(jsetup.step)
    want = []
    with mesh:  # its sharding constraints name the mesh's axes
        for i, batch in enumerate(batches):
            jparams, _, jm = step(jparams, (), {"tokens": jnp.asarray(batch["tokens"])},
                                  jax.random.key(i))
            want.append(({k: float(v) for k, v in jm.items()},
                         jax.tree_util.tree_leaves(jparams)))
    setup, got = _port_rounds(cfg, make_smoke_mesh(), init_p, None, batches)
    assert setup.client_axes == () and setup.tag is None and got[0][2] == ()
    for (gm, gp, _), (wm, wl) in zip(got, want):
        # plain SGD: no FedAdam normalization, the f32 difference itself
        _assert_round(gm, gp, wm, wl, param_atol=1e-6)


_JAX_ROUNDS = r'''
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro import compat
from repro.configs import get_config
from repro.data.datasets import synthetic_lm_batches
from repro.fl.fedstep import FedStepConfig
from repro.launch.steps import build_train_step

spec = json.loads(sys.argv[2])
assert len(jax.devices()) == 4
out = {}
def host(tree):
    if isinstance(tree, dict):
        return {k: host(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(host(v) for v in tree)
    return np.asarray(tree)
def put(prefix, tree):
    for i, leaf in enumerate(jax.tree_util.tree_leaves(tree)):
        out[f"{prefix}/{i}"] = np.asarray(leaf)
for case in spec["cases"]:
    cfg = get_config("qwen2_5_3b", reduced=True)
    mesh = compat.make_mesh(tuple(case["shape"]), tuple(case["names"]))
    bundle, setup = build_train_step(cfg, mesh, FedStepConfig(**spec["fed"]),
                                     cross_pod_wire=case["wire"])
    params = bundle.init(jax.random.key(0))
    state = setup.init_state(params)
    put(f"{case['name']}/init_params", params)
    put(f"{case['name']}/init_state", state)
    it = synthetic_lm_batches(vocab=cfg.vocab_size, batch=spec["batch"], seq=spec["seq"], seed=0)
    step = jax.jit(setup.step)
    for i in range(spec["rounds"]):
        params, state, m = step(params, state, {"tokens": jnp.asarray(next(it))},
                                jax.random.key(i))
        for k in m:
            out[f"{case['name']}/metric/{i}/{k}"] = np.asarray(m[k])
        put(f"{case['name']}/params/{i}", params)
np.savez(sys.argv[1], **out)
'''

MESH_CASES = [
    dict(name="classical_2", shape=[2, 1], names=["data", "model"], wire="f32"),
    dict(name="hier_2x2_bf16", shape=[2, 2, 1], names=["pod", "data", "model"], wire="bf16"),
]


@pytest.fixture(scope="module")
def jax_rounds(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_rounds")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
               "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")
    spec = json.dumps({"cases": MESH_CASES, "fed": FED, "rounds": ROUNDS, "batch": BATCH,
                       "seq": SEQ})
    proc = subprocess.run([sys.executable, "-c", _JAX_ROUNDS, str(d / "out.npz"), spec],
                          capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(d / "out.npz"))


def _leaves_of(out, prefix):
    n = sum(1 for k in out if k.startswith(prefix + "/"))
    return [out[f"{prefix}/{i}"] for i in range(n)]


@pytest.mark.parametrize("case", MESH_CASES, ids=lambda c: c["name"])
def test_virtual_client_rounds_match_reference(jax_rounds, case):
    """2 rounds of ``build_train_step`` on the reduced Qwen2.5-3B over 2
    virtual clients (``classical_fl`` on data 2) and over 4 (``hierarchical_fl``
    on pod 2 x data 2, bf16 cross-pod wire), against the JAX package's step on
    4 host devices: loss, ``delta_norm`` and every parameter each round."""
    out, name = jax_rounds, case["name"]
    cfg = get_config("qwen2_5_3b", reduced=True)
    jcfg = jax_get_config("qwen2_5_3b", reduced=True)
    # the trees' structure from a JAX init (values from the subprocess)
    jb = jax_build_model(jcfg)
    skeleton = jb.init(jax.random.key(0))
    treedef = jax.tree_util.tree_structure(skeleton)
    init_p = jax.tree_util.tree_unflatten(treedef, _leaves_of(out, f"{name}/init_params"))
    jstate_like = {"stages": {"root": {"m": skeleton, "v": skeleton}}}
    init_s = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jstate_like),
                                          _leaves_of(out, f"{name}/init_state"))
    pods = case["shape"][0] if case["names"][0] == "pod" else 1
    clients = case["shape"][1] if pods > 1 else case["shape"][0]
    mesh = make_virtual_mesh(clients, pods=pods)
    setup, got = _port_rounds(cfg, mesh, _host(init_p), _host(init_s),
                              _train_batches(cfg), cross_pod_wire=case["wire"])
    assert len(setup.client_axes) == (2 if pods > 1 else 1)
    atol = BF16_WIRE_PARAM_ATOL if case["wire"] == "bf16" else PARAM_ATOL
    for i, (gm, gp, _) in enumerate(got):
        wm = {k: float(out[f"{name}/metric/{i}/{k}"]) for k in ("loss", "delta_norm")}
        _assert_round(gm, gp, wm, _leaves_of(out, f"{name}/params/{i}"), param_atol=atol)
        assert gm["participants"] == clients * pods


def test_server_state_carries_across():
    """``init_server_state`` of FedAdam (m, v) carried to the port: the
    structure, dtypes and values; and a state the port made is the same."""
    jcfg = jax_get_config("qwen2_5_3b", reduced=True)
    jbundle, jsetup = jax_build_train_step(jcfg, compat.make_mesh((1, 1), ("data", "model")),
                                           JFedStepConfig(**FED))
    jstate = jsetup.init_state(jbundle.init(jax.random.key(0)))
    got = tree_from_numpy(jstate, CPU)  # JAX arrays convert through np.asarray
    assert list(got) == ["stages"] and list(got["stages"]) == ["root"]
    assert sorted(got["stages"]["root"]) == ["m", "v"]
    gl, _ = tree_flatten(got)
    wl = jax.tree_util.tree_leaves(jstate)
    for g, w in zip(gl, wl):
        assert g.dtype == torch.float32 and g.numpy().tobytes() == np.asarray(w).tobytes()
    _, setup = build_train_step(get_config("qwen2_5_3b", reduced=True), make_smoke_mesh(),
                                device="cpu")
    own = setup.init_state(params_from_jax(_host(jbundle.init(jax.random.key(0))), CPU))
    for a, b in zip(tree_flatten(own)[0], gl):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------- #
# the launcher
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("clients", [1, 2])
def test_train_launcher_reduced_on_cpu(clients, capsys):
    """``python -m repro_torch.launch.train --reduced --device cpu``: the
    reference's flags, its final ``losses[-1] < losses[0]`` assertion."""
    args = ["--reduced", "--device", "cpu", "--clients", str(clients)]  # 20 steps
    assert ttrain.main(args) == 0
    text = capsys.readouterr().out
    assert "done: first loss" in text and f"'data': {clients}" in text


def test_train_launcher_checkpoint(tmp_path):
    assert ttrain.main(["--reduced", "--device", "cpu", "--steps", "12", "--clients", "2",
                        "--checkpoint", str(tmp_path)]) == 0
    assert latest_step(str(tmp_path)) == 12


def test_model_axis_and_flash_training_refused():
    cfg = get_config("qwen2_5_3b", reduced=True)
    # a model axis of 2 is 2 processes (tests/test_torch_tensor_parallel.py):
    # without the rank's group the builder refuses
    with pytest.raises(ValueError, match="runs as 2 processes"):
        build_train_step(cfg, Mesh((("data", 1), ("model", 2))), device="cpu")
    bundle = build_model(dataclasses.replace(cfg, attn_impl="flash"), "cpu")
    params = bundle.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="forward only"):
        bundle.loss_fn(params, {"tokens": torch.zeros((1, 4), dtype=torch.int32)}, None)
