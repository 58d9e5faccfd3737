"""The port's sharding rules (``repro_torch.launch.sharding``) against the
JAX package's (``repro.launch.sharding``), and the port's meshes against
``repro.launch.mesh`` / the JAX train driver's device rule.

For every arch id the parameter tree of the full config (the JAX package's
``jax.eval_shape`` of its init, the port's meta-device init) and of the
reduced config, the caches (also the ``long_decode_variant`` where one
applies) and the batches of every shape kind get specs on the meshes
(16, 16), (2, 16, 16), (1, 2), (1, 4), (2, 2) and (4, 1): the port's specs
must equal the JAX package's ``PartitionSpec``s as tuples, leaf by leaf, on
the JAX package's ``AbstractMesh`` and the port's ``Mesh`` of the same
sizes. ``unshard(shard(x))`` must give ``x`` back byte for byte, from every
device's block.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as jget_config
from repro.configs import long_decode_variant as jlong_variant
from repro.launch import sharding as jshd
from repro.models.api import build_model as jbuild_model
from repro.models.config import ShapeConfig as JShape
from repro_torch.configs import ARCH_IDS, get_config, long_decode_variant
from repro_torch.core.mesh_lowering import Mesh
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tshd
from repro_torch.models import api as tapi
from repro_torch.models.config import ShapeConfig

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "1x2": ((1, 2), ("data", "model")), "1x4": ((1, 4), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")), "4x1": ((4, 1), ("data", "model"))}


def _meshes(name):
    shape, names = MESHES[name]
    return AbstractMesh(shape, names), Mesh(tuple(zip(names, shape)))


def _jnames(path):
    return tuple(jshd._names(path))


@functools.lru_cache(maxsize=None)
def _jax_params(arch, reduced):
    bundle = jbuild_model(jget_config(arch, reduced=reduced))
    leaves = jax.tree_util.tree_flatten_with_path(jax.eval_shape(bundle.init, jax.random.key(0)))[0]
    return tuple((path, leaf) for path, leaf in leaves)


@functools.lru_cache(maxsize=None)
def _jax_cache(arch, reduced, long, batch, max_len):
    cfg = jget_config(arch, reduced=reduced)
    if long:
        cfg = jlong_variant(cfg)
    bundle = jbuild_model(cfg)
    tree = jax.eval_shape(lambda: bundle.init_cache(batch, max_len))
    return tuple(jax.tree_util.tree_flatten_with_path(tree)[0])


def _port_leaves(tree):
    out = {}
    tshd.map_with_path(lambda path, leaf: out.__setitem__(tshd._names(path), leaf), tree)
    return out


def _compare(jleaves, tree, jrule, trule, cfg_j, cfg_t, mesh_name):
    jm, tm = _meshes(mesh_name)
    port = _port_leaves(tree)
    assert sorted(port) == sorted(_jnames(p) for p, _ in jleaves)
    n_sharded = 0
    for path, leaf in jleaves:
        names = _jnames(path)
        assert tuple(port[names].shape) == tuple(leaf.shape), names
        want = tuple(jrule(path, leaf, cfg_j, jm))
        got = trule(names_path(names), port[names], cfg_t, tm)
        assert got == want, (names, got, want)
        n_sharded += tshd.is_sharded(got)
    return n_sharded


def names_path(names):
    """A port path from the JAX names (``[i]`` back to an index)."""
    return tuple(int(n[1:-1]) if n.startswith("[") else n for n in names)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_jax_packages(arch, reduced, mesh_name):
    cfg_t = get_config(arch, reduced=reduced)
    n = _compare(_jax_params(arch, reduced), tapi.param_shapes(cfg_t), jshd.param_pspec,
                 tshd.param_pspec, jget_config(arch, reduced=reduced), cfg_t, mesh_name)
    if mesh_name in ("1x2", "16x16"):
        assert n > 0  # the rule shards something on every model axis > 1


def _cache_cases():
    for arch in ARCH_IDS:
        for reduced, batch, max_len in ((False, 8, 4096), (True, 2, 64), (True, 2, 66)):
            yield arch, reduced, False, batch, max_len
        if not get_config(arch).encoder_layers:  # the long_500k variant
            yield arch, False, True, 1, 65536


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,reduced,long,batch,max_len", list(_cache_cases()),
                         ids=lambda v: str(v))
def test_cache_specs_equal_the_jax_packages(arch, reduced, long, batch, max_len, mesh_name):
    cfg_t, cfg_j = get_config(arch, reduced=reduced), jget_config(arch, reduced=reduced)
    if long:
        cfg_t, cfg_j = long_decode_variant(cfg_t), jlong_variant(cfg_j)
    _compare(_jax_cache(arch, reduced, long, batch, max_len),
             tapi.cache_shapes(cfg_t, batch, max_len), jshd.cache_pspec, tshd.cache_pspec,
             cfg_j, cfg_t, mesh_name)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_specs_and_axes_equal_the_jax_packages(arch, mesh_name):
    jm, tm = _meshes(mesh_name)
    cfg_t, cfg_j = get_config(arch), jget_config(arch)
    assert tshd.batch_axes(cfg_t, tm) == jshd.batch_axes(cfg_j, jm)
    jbundle = jbuild_model(cfg_j)
    tbundle = tapi.build_model(cfg_t, "cpu")
    for kind, B, S in (("train", 256, 4096), ("prefill", 32, 2048), ("decode", 6, 1)):
        jspec = jbundle.input_specs(JShape(kind, S, B, kind))
        tspec = tbundle.input_specs(ShapeConfig(kind, S, B, kind))
        assert sorted(jspec) == sorted(tspec)
        want = {k: tuple(v) for k, v in jshd.batch_shardings(jspec, cfg_j, jm).items()
                for v in [v.spec]}
        assert tshd.batch_specs(tspec, cfg_t, tm) == want


@pytest.mark.parametrize("mesh_name", ["2x16x16", "1x2", "1x4", "2x2"])
@pytest.mark.parametrize("arch", ["qwen2_5_3b", "qwen3_moe_235b_a22b", "hymba_1_5b",
                                  "seamless_m4t_medium", "xlstm_1_3b"])
def test_unshard_of_shard_is_the_leaf_byte_for_byte(arch, mesh_name):
    """Every leaf of the reduced config (random bytes, float32 and a
    bfloat16 copy), cut into every device's block and put back (the 16 x 16
    and 4 x 1 meshes cut as the 2 x 16 x 16 and 2 x 2 ones do)."""
    _, tm = _meshes(mesh_name)
    cfg = get_config(arch, reduced=True)
    rng = np.random.default_rng(3)
    coords = tshd.mesh_coords(tm)
    for path, leaf in _port_leaves(tapi.param_shapes(cfg)).items():
        path = names_path(path)
        x = torch.from_numpy(rng.standard_normal(tuple(leaf.shape)).astype(np.float32))
        spec = tshd.param_pspec(path, x, cfg, tm)
        for t in (x, x.to(torch.bfloat16)):
            pieces = [tshd.shard(t, spec, tm, c) for c in coords]
            assert all(p.shape == tshd.shard_shape(t.shape, spec, tm) for p in pieces)
            back = tshd.unshard(pieces, spec, tm)
            bits = torch.int32 if t.dtype == torch.float32 else torch.int16
            assert back.dtype == t.dtype and torch.equal(back.view(bits), t.view(bits))
        # numpy leaves take the same path
        a = x.numpy()
        back = tshd.unshard([tshd.shard(a, spec, tm, c) for c in coords], spec, tm)
        assert back.tobytes() == a.tobytes()


def test_unshard_refuses_replicated_blocks_that_differ():
    tm = Mesh((("data", 2), ("model", 2)))
    spec = (None, "model")
    pieces = [torch.zeros(2, 2) for _ in range(4)]
    pieces[2] = torch.ones(2, 2)  # data 1, model 0 holds other values than data 0
    with pytest.raises(ValueError, match="differ"):
        tshd.unshard(pieces, spec, tm)


def test_production_meshes_are_the_jax_packages_sizes():
    assert tmesh.make_production_mesh().axes == (("data", 16), ("model", 16))
    assert tmesh.make_production_mesh(multi_pod=True).axes == (
        ("pod", 2), ("data", 16), ("model", 16))


@pytest.mark.parametrize("n,want", [(1, (1, 1)), (2, (1, 2)), (3, (3, 1)), (4, (1, 4)),
                                    (6, (3, 2)), (8, (1, 8)), (12, (3, 4)), (16, (2, 8))])
def test_mesh_for_devices_follows_the_jax_driver(n, want):
    """``repro.launch.train.make_mesh_for_devices``'s rule: model is the
    largest of 8, 4, 2 dividing n."""
    m = tmesh.make_mesh_for_devices(n)
    assert m.axes == (("data", want[0]), ("model", want[1]))
