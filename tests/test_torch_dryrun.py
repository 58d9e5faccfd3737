"""The port's dry run and roofline (``repro_torch.launch.dryrun``,
``repro_torch.launch.analysis``) against the JAX package's.

* ``Roofline``: the JAX package's ``TestHLOAnalysis.test_roofline_terms``
  arithmetic (``tests/test_mgmt_misc.py``) on the port's class, with the
  v5e constants of that test passed in, every field of ``to_dict`` equal to
  the JAX class's on the same inputs; the port's defaults are the H100's.
* Resident bytes a device: for every arch id at the four ``SHAPES`` on the
  six meshes of ``tests/test_torch_sharding.py``, the port's parameter and
  cache bytes a device equal the JAX package's rules
  (``repro.launch.sharding.param_pspec`` / ``cache_pspec``) applied to its
  ``jax.eval_shape`` trees (the long-decode variant's cache for
  ``long_500k``); ``skip_reason``, ``_local_steps`` and ``model_flops``
  equal the JAX module's.
* The counted step: under fake tensors a step counts the FLOPs and
  all-reduce bytes of the same step on real CPU tensors (and its bytes,
  exactly for a dense prefill); the extrapolation from 2 and 4 layer
  periods gives the count at 3 exactly for a dense and a recurrent model
  (each period does the same work), and xLSTM's along the length from 2
  and 3 SSD chunks the FLOPs and all-reduces at 5 (its bytes within 10%);
  a full prefill's FLOPs are the products' by hand.

``tests/test_torch_dryrun_table.py`` holds the ``--all`` table.
"""
import dataclasses
import functools
import json
import os

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as jget_config
from repro.configs import long_decode_variant as jlong_variant
from repro.launch import sharding as jshd
from repro.models.api import build_model as jbuild_model
from repro_torch.configs import ARCH_IDS, get_config, long_decode_variant
from repro_torch.core.mesh_lowering import Mesh
from repro_torch.launch import analysis, dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import tensor_parallel as tp
from repro_torch.models.config import SHAPES

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "1x2": ((1, 2), ("data", "model")), "1x4": ((1, 4), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")), "4x1": ((4, 1), ("data", "model"))}


def _jax_dryrun():
    """``repro.launch.dryrun``, whose import sets ``XLA_FLAGS`` for 512 host
    devices: restored at once (the backend of this process, if any, is up
    already; subprocesses keep their own)."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as jdry
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jdry


# ---------------------------------------------------------------------- #
# Roofline
# ---------------------------------------------------------------------- #
V5E = dict(peak_flops=197e12, hbm_bw=819e9, link_bw=50e9)


def test_roofline_terms():
    """The JAX package's ``test_roofline_terms`` on the port's class, its
    v5e constants passed in."""
    r = analysis.Roofline(
        arch="a", shape="s", mesh="16x16", chips=256,
        hlo_flops=256 * 197e12,  # exactly 1s of compute
        hlo_bytes=256 * 819e9,   # exactly 1s of HBM
        collective_bytes=50e9 * 2,  # 2s of the link
        model_flops=256 * 197e12 / 2, **V5E)
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(1.0)
    assert r.collective_s == pytest.approx(2.0)
    assert r.dominant == "collective"
    assert r.useful_ratio == pytest.approx(0.5)


@pytest.mark.parametrize("counts", [(3.1e17, 2.2e15, 4.4e9, 1.5e17), (1e12, 7e14, 0.0, 0.0),
                                    (0.0, 0.0, 0.0, 0.0)])
def test_roofline_dict_equals_the_jax_packages(counts):
    from repro.launch.analysis import Roofline as JRoofline

    flops, nbytes, coll, model = counts
    kw = dict(arch="a", shape="s", mesh="16x16", chips=256, hlo_flops=flops, hlo_bytes=nbytes,
              collective_bytes=coll, model_flops=model)
    assert analysis.Roofline(**kw, **V5E).to_dict() == JRoofline(**kw).to_dict()


def test_roofline_defaults_are_the_h100s():
    r = analysis.Roofline(arch="a", shape="s", mesh="1", chips=1, hlo_flops=989e12,
                          hlo_bytes=3.35e12, collective_bytes=450e9, model_flops=0.0)
    assert (r.compute_s, r.memory_s, r.collective_s) == (1.0, 1.0, 1.0)
    assert tmesh.HBM_PER_CARD == 85_017_493_504
    r32 = analysis.Roofline(arch="a", shape="s", mesh="1", chips=1, hlo_flops=67e12,
                            hlo_bytes=0.0, collective_bytes=0.0, model_flops=0.0,
                            peak_flops=tmesh.PEAK_FLOPS_F32)
    assert r32.compute_s == 1.0 and r32.dominant == "compute"


def test_collective_stats_of_a_counting_group():
    group = tp.ModelGroup.counting(4, rank=3, device="cpu")
    assert group.backend == "count" and group.pg is None
    assert analysis.CollectiveStats.of_group(group).total_count == 0
    x = torch.ones(5, 3)
    with tp.use_group(group):
        y = tp.all_reduce_sum(x)
        z = tp.gather_columns(torch.ones(2, 3), 6, 12)
    torch.testing.assert_close(y, x)  # counted, not reduced
    assert z.shape == (2, 12) and float(z[:, 6:9].sum()) == 6.0 and float(z.sum()) == 6.0
    stats = analysis.CollectiveStats.of_group(group)
    assert stats.by_kind == {"all-reduce": (2, 5 * 3 * 4 + 2 * 12 * 4)}
    assert stats.total_bytes == 156 and stats.total_count == 2


# ---------------------------------------------------------------------- #
# resident bytes a device, model_flops, skip_reason
# ---------------------------------------------------------------------- #
def _jmesh(name):
    shape, names = MESHES[name]
    return AbstractMesh(shape, names)


def _tmesh(name):
    shape, names = MESHES[name]
    return Mesh(tuple(zip(names, shape)))


def _jbytes(leaves, rule, cfg, mesh):
    total = 0
    for path, leaf in leaves:
        spec = tuple(rule(path, leaf, cfg, mesh))
        n = leaf.dtype.itemsize
        for d, e in zip(leaf.shape, spec + (None,) * (len(leaf.shape) - len(spec))):
            axes = () if e is None else (e if isinstance(e, tuple) else (e,))
            k = 1
            for a in axes:
                k *= mesh.shape[a]
            n *= d // k
        total += n
    return total


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    bundle = jbuild_model(jget_config(arch))
    tree = jax.eval_shape(bundle.init, jax.random.key(0))
    return tuple(jax.tree_util.tree_flatten_with_path(tree)[0])


@functools.lru_cache(maxsize=None)
def _jax_cache(arch, shape_name):
    shape = SHAPES[shape_name]
    cfg = jget_config(arch)
    if shape_name == "long_500k":
        cfg = jlong_variant(cfg)
    bundle = jbuild_model(cfg)
    tree = jax.eval_shape(lambda: bundle.init_cache(shape.global_batch, shape.seq_len))
    return tuple(jax.tree_util.tree_flatten_with_path(tree)[0])


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_device_bytes_equal_the_jax_rules(arch, shape_name, mesh_name):
    shape = SHAPES[shape_name]
    jcfg, tcfg = jget_config(arch), get_config(arch)
    jdry = _jax_dryrun()
    assert dryrun.skip_reason(tcfg, shape) == jdry.skip_reason(jcfg, shape)
    assert dryrun._local_steps(tcfg, shape) == jdry._local_steps(jcfg, shape)
    if dryrun.skip_reason(tcfg, shape):
        return
    if shape_name == "long_500k":
        jcfg, tcfg = jlong_variant(jcfg), long_decode_variant(tcfg)
    jm = _jmesh(mesh_name)
    got = dryrun.device_bytes(dataclasses.replace(tcfg, scan_layers=True), shape,
                              _tmesh(mesh_name))
    assert got["param_bytes"] == _jbytes(_jax_params(arch), jshd.param_pspec, jcfg, jm)
    if shape.kind == "train":
        assert got["cache_bytes"] == 0
    else:
        assert got["cache_bytes"] == _jbytes(_jax_cache(arch, shape_name), jshd.cache_pspec,
                                             jcfg, jm) > 0
    assert got["resident_bytes"] == got["param_bytes"] + got["cache_bytes"] + got["state_bytes"]


@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_the_jax_modules(arch, shape_name):
    """``model_flops`` as ``repro.launch.dryrun.lower_pair`` computes it
    (``2 * n_active * tokens * mult``, from the JAX config)."""
    shape = SHAPES[shape_name]
    jcfg = jget_config(arch)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 3 if shape.kind == "train" else 1
    want = 2.0 * jcfg.active_param_count() * tokens * mult
    assert dryrun.model_flops(get_config(arch), shape) == want


def test_state_bytes_are_fedadams_two_trees_cut_by_the_param_specs():
    cfg = get_config("qwen2_5_3b")
    for name in ("1x2", "16x16"):
        got = dryrun.device_bytes(cfg, SHAPES["train_4k"], _tmesh(name))
        assert cfg.server_strategy == "fedadam"
        assert got["state_bytes"] == 2 * got["param_bytes"]
    # the FSDP giants train as one client across pods: no server state
    moe = dryrun.device_bytes(get_config("qwen3_moe_235b_a22b"), SHAPES["train_4k"],
                              _tmesh("2x16x16"))
    assert moe["state_bytes"] == 0


# ---------------------------------------------------------------------- #
# the counted step
# ---------------------------------------------------------------------- #
def _real_counts(cfg, shape, mesh):
    """``count_step``'s counters on real CPU tensors (no fake mode)."""
    cfg = dataclasses.replace(cfg, attn_impl="xla")
    group = tp.ModelGroup.counting(mesh.shape.get("model", 1), device="cpu")
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad():
        fn, args = dryrun._rank_setup(cfg, shape, mesh, group)
        group.reset_counters()
        flops, nbytes = FlopCounterMode(display=False), dryrun._ByteCounter()
        with flops, nbytes:
            fn(*args)
    # every collective's bytes: the all-reduces and the data gathers' all-gathers
    return (float(flops.get_total_flops()), float(nbytes.bytes),
            group.all_reduce_bytes + group.data_gathered_bytes)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ["qwen2_5_3b", "qwen3_moe_235b_a22b", "hymba_1_5b"])
def test_fake_counts_equal_real_counts(arch, kind):
    """FLOPs and collective bytes equal. The bytes may not: ``matmul``
    picks ``mm`` or an expanded ``bmm`` by the strides its operands come
    with, and the MoE dispatch takes data-dependent paths, so fake and real
    tensors can take other ops (a dense prefill takes the same ones)."""
    from repro_torch.models.config import ShapeConfig

    cfg = get_config(arch, reduced=True)
    shape = ShapeConfig(kind, 32, 4, kind)
    mesh = Mesh((("data", 2), ("model", 2)))
    got = dryrun.count_step(cfg, shape, mesh)
    flops, nbytes, coll = _real_counts(cfg, shape, mesh)
    assert (got["flops"], got["collective_bytes"]) == (flops, coll)
    if (arch, kind) == ("qwen2_5_3b", "prefill"):
        assert got["bytes"] == nbytes
    assert got["bytes"] == pytest.approx(nbytes, rel=0.5)
    assert got["flops"] > 0 and got["collectives"]["all-reduce"][0] > 0


@pytest.mark.parametrize("arch", ["qwen2_5_3b", "xlstm_1_3b"])
def test_cost_pair_extrapolates_to_the_counted_depth(arch):
    """``c2 + (G - 2)(c4 - c2)/2`` at G = 3 periods equals the count of 3
    periods: each period does the same work (FLOPs, bytes, all-reduces)."""
    from repro_torch.models.blocks import layer_kinds
    from repro_torch.models.config import ShapeConfig

    cfg = get_config(arch, reduced=True)
    period = len(layer_kinds(cfg))
    cfg = dataclasses.replace(cfg, num_layers=3 * period)
    shape = ShapeConfig("train", 16, 8, "train")
    mesh = Mesh((("data", 2), ("model", 2)))
    pair = dryrun.cost_pair(cfg, shape, mesh)
    direct = dryrun.count_step(dataclasses.replace(cfg, scan_layers=False, remat=True), shape,
                               mesh)
    for key in ("flops", "bytes", "collective_bytes"):
        assert pair[key] == pytest.approx(direct[key], rel=1e-12), key


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_xlstm_counts_extrapolate_along_the_length(kind):
    """The recurrent family's step adds the same FLOPs and all-reduces with
    each SSD chunk from the second on: counted at 2 and 3 chunks and
    extrapolated, the counts at 5 exactly; the bytes within 10% (the chunk
    scan's combine grows faster than the chunks)."""
    from repro_torch.models.config import ShapeConfig

    cfg = get_config("xlstm_1_3b", reduced=True)
    c = cfg.ssd_chunk
    shape = ShapeConfig(kind, 5 * c, 4, kind)
    mesh = Mesh((("data", 2), ("model", 2)))
    got = dryrun.count_at_length(cfg, shape, mesh)
    want = dryrun.count_step(cfg, shape, mesh)
    for key in ("flops", "collective_bytes"):
        assert got[key] == pytest.approx(want[key], rel=1e-12), key
    assert got["collectives"] == pytest.approx(want["collectives"])
    assert got["bytes"] == pytest.approx(want["bytes"], rel=0.1)


def test_roofline_of_a_prefill_counts_the_products():
    """Qwen2.5-3B's prefill of 8 x 2048 at full depth on one card: the
    compute term's FLOPs are the products' (the dense layers' 2 x N x tokens
    less the embedding, the plain attention's full score and value products
    a layer, the last position's unembedding) to within 1%."""
    from repro_torch.models.config import ShapeConfig

    cfg = get_config("qwen2_5_3b")
    shape = ShapeConfig("prefill", 2048, 8, "prefill")
    mesh = Mesh((("data", 1), ("model", 1)))
    roof = dryrun.roofline_of(cfg, shape, mesh, dryrun.cost_pair(cfg, shape, mesh))
    tokens, d, D, H = 8 * 2048, cfg.d_model, cfg.head_dim, cfg.num_heads
    emb = cfg.padded_vocab * d
    layer = cfg.param_count() - cfg.vocab_size * d - d  # less the embedding and the final norm
    want = (2 * layer * tokens + 4 * 8 * 2048 * 2048 * D * H * cfg.num_layers
            + 2 * 8 * emb)
    assert roof.hlo_flops == pytest.approx(want, rel=1e-2)
    assert roof.compute_s == roof.hlo_flops / tmesh.PEAK_FLOPS_BF16
    assert roof.dominant == "memory" and roof.collective_s == 0.0


def test_main_writes_the_records(tmp_path):
    out = tmp_path / "records.json"
    assert dryrun.main(["--arch", "qwen2_5_3b", "--shape", "decode_32k", "--both-meshes",
                        "--out", str(out)]) == 0
    recs = json.loads(out.read_text())
    assert [r["mesh"] for r in recs] == ["16x16", "2x16x16"]
    single, multi = recs
    assert single["fits_hbm"] and "roofline" in single and "roofline" not in multi
    assert single["memory"]["param_bytes"] == multi["memory"]["param_bytes"]
    assert "not counted" in single["memory"]["activations"]
    assert set(single["roofline"]) == {
        "arch", "shape", "mesh", "chips", "hlo_flops", "hlo_bytes", "collective_bytes",
        "model_flops", "compute_s", "memory_s", "collective_s", "dominant", "useful_ratio"}
    assert single["roofline"]["chips"] == 256
    assert dryrun.main(["--arch", "seamless_m4t_medium", "--shape", "long_500k",
                        "--no-roofline"]) == 0
