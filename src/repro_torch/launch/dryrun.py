"""The dry run without a process per device (the port of
``repro.launch.dryrun``).

The JAX module compiles every (arch x shape x mesh) on 512 forced host
devices. The port needs no device at all: a mesh device is one rank of the
``model`` axis (``launch.tensor_parallel``) running its share of the batch,
and the dry run counts what that rank holds and does.

1. **Resident bytes a device**: the parameter, cache and server-state
   leaves of the config, each cut to its block by ``launch.sharding``'s
   rules (``param_pspec``, ``cache_pspec``; a server state's leaves by
   their parameters' specs), from the shapes alone (``api.param_shapes``,
   ``api.cache_shapes``). The JAX module's ``memory_analysis()`` peak also
   holds the step's activations and temporaries, which an eager program has
   no counterpart of before it runs: ``fits_hbm`` compares the *resident*
   bytes with the card's memory (``launch.mesh.HBM_PER_CARD``), and the
   record says that activations are left out.

2. **Cost pair** (single-pod, feeds ``launch.analysis.Roofline``): one
   device's step at 2x and 4x the layer period with ``local_steps=1``,
   under ``FakeTensorMode`` (tensors with shapes and dtypes, no data), and
   ``total = c2 + (G - 2) * (c4 - c2) / 2`` extrapolates to the full depth,
   as the JAX module does. Fake tensors, not the meta device: the fed step
   and DP draw from ``torch.Generator``s, which the meta device has none
   of. The step is the rank's (a counting ``ModelGroup``: its all-reduces
   are counted, none is made) on the device's rows of the batch (the batch
   over the client axes where it divides them, as ``batch_pspec`` splits
   it). The counting group is laid out on the processes the mesh asks for
   (``steps.grid_axes``): serving and an FSDP config's train step count
   the grid's first rank at the mesh's real ``data`` size, its gathers of
   FSDP's ``data`` blocks and its gradient sums over (pod, data) among the
   collectives (the model code's own: a layer's leaves gathered as it
   begins, a MoE layer's expert leaves gathered by the expert FFN one at a
   time, in slices and again in its backward where they do not fit the
   rank's memory share, ``models.moe``; a gather counts as a collective
   over ``data``); a ``tp`` config's train step counts one client of the fed
   step on the ``model`` axis. A batch that the rows do not divide is
   counted on the ``model`` axis alone with the rows whole, as the JAX
   guard replicates it.

   * FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` (the products:
     mm, bmm, addmm, einsum's bmm, convolutions, attention). Attention runs
     its plain route (``attn_impl="xla"``): where a config asks for flash,
     its FLOPs are the plain route's products, the masked blocks of the
     chunked attention included.
   * Bytes: every non-view op's input and output bytes (``_ByteCounter``),
     the traffic of eager PyTorch with nothing fused: an upper estimate of
     the HBM traffic.
   * Collective bytes: the rank's all-reduce bytes (the results' sizes, as
     the JAX module counts a collective), its data gathers' (whole leaves)
     and its gradient blocks' reduces to their owners (each block's bytes),
     from the counting group. The model code makes them, so the count
     follows its layout: the recurrent blocks on their slices sum their
     ``out`` over the group and gather only the SSD's ``in_bc`` and
     ``in_dt`` whole (``models.blocks``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2_5_3b --shape prefill_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --out results.json
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, get_config, long_decode_variant
from repro_torch.core.mesh_lowering import Mesh
from repro_torch.core.tree import tree_flatten, tree_leaves
from repro_torch.fl.fedstep import FedStepConfig
from repro_torch.fl.strategies import get_strategy
from repro_torch.launch import sharding as shd
from repro_torch.launch import tensor_parallel as tp
from repro_torch.launch.analysis import CollectiveStats, Roofline
from repro_torch.launch.mesh import (HBM_PER_CARD, PEAK_FLOPS_BF16, PEAK_FLOPS_F32,
                                     make_production_mesh)
from repro_torch.models.api import cache_shapes, param_shapes
from repro_torch.models.blocks import layer_kinds
from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig

def _local_steps(cfg: ModelConfig, shape: ShapeConfig) -> int:
    if shape.kind != "train":
        return 1
    # tp: 8 local steps microbatch the per-client batch (memory); fsdp archs
    # shard the batch over all 256 devices already — splitting further would
    # make the microbatch indivisible by the device count and SPMD would
    # drop the batch sharding entirely.
    return 8 if cfg.param_sharding == "tp" else 1


def skip_reason(cfg, shape):
    if shape.name == "long_500k" and cfg.encoder_layers:
        return "enc-dec with full cross-attention: no sub-quadratic variant (DESIGN.md)"
    return None


def _with_layers(cfg: ModelConfig, n: int) -> ModelConfig:
    if cfg.encoder_layers:
        return dataclasses.replace(cfg, num_layers=n, encoder_layers=n)
    return dataclasses.replace(cfg, num_layers=n)


def mesh_name(mesh: Mesh) -> str:
    return "x".join(str(n) for _, n in mesh.axes)


def _chips(mesh: Mesh) -> int:
    n = 1
    for _, size in mesh.axes:
        n *= size
    return n


def _client_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


# --------------------------------------------------------------------- #
# resident bytes a device
# --------------------------------------------------------------------- #
def _block_bytes(tree: Any, rule: Callable, cfg: ModelConfig, mesh: Mesh) -> int:
    """Bytes of one device's blocks of ``tree``'s leaves, each by
    ``rule(path, leaf, cfg, mesh)``."""
    total = [0]

    def leaf(path, x):
        shape = shd.shard_shape(x.shape, rule(path, x, cfg, mesh), mesh)
        n = 1
        for d in shape:
            n *= d
        total[0] += n * x.element_size()

    shd.map_with_path(leaf, tree)
    return total[0]


def _whole_bytes(tree: Any) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def _state_bytes(cfg: ModelConfig, params: Any, mesh: Mesh) -> int:
    """The root strategy's state a device: a part of the parameters' tree
    structure is cut by the parameters' specs, anything else is whole."""
    state = get_strategy(cfg.server_strategy).init(params)
    if not isinstance(state, dict):
        return _whole_bytes(state)
    shape_of = tree_flatten(params)[1]
    total = 0
    for part in state.values():
        if tree_flatten(part)[1] == shape_of:
            total += _block_bytes(part, shd.param_pspec, cfg, mesh)
        else:
            total += _whole_bytes(part)
    return total


def _train_clients(cfg: ModelConfig, mesh: Mesh) -> Tuple[str, ...]:
    """The client axes ``build_train_step`` runs the fed step over."""
    axes = tuple(a for a in cfg.fl_axes if a in mesh.axis_names)
    if cfg.param_sharding == "fsdp" and len(mesh.axes) > 2:
        return ()
    return axes


def device_bytes(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh) -> Dict[str, Any]:
    """Parameter, cache and server-state bytes a device of ``mesh`` holds
    for ``shape`` (``cfg`` already the long-decode variant where the shape
    asks for it): the cache of a serving shape, the root strategy's state
    of a federated train step. Activations are not counted."""
    params = param_shapes(cfg)
    out = {"param_bytes": _block_bytes(params, shd.param_pspec, cfg, mesh),
           "cache_bytes": 0, "state_bytes": 0}
    if shape.kind == "train":
        if _train_clients(cfg, mesh):
            out["state_bytes"] = _state_bytes(cfg, params, mesh)
    else:
        cache = cache_shapes(cfg, shape.global_batch, shape.seq_len)
        out["cache_bytes"] = _block_bytes(cache, shd.cache_pspec, cfg, mesh)
    out["resident_bytes"] = out["param_bytes"] + out["cache_bytes"] + out["state_bytes"]
    out["activations"] = "not counted (an eager step has no compiled peak)"
    return out


# --------------------------------------------------------------------- #
# counting a device's step
# --------------------------------------------------------------------- #
class _ByteCounter(TorchDispatchMode):
    """Sums the bytes of every tensor input and output of each op that
    makes a tensor and is not a view: eager traffic with nothing fused
    (queries such as ``prim.device`` move nothing)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [x for x in tree_leaves([out]) if isinstance(x, torch.Tensor)]
        if outs and not func.is_view:
            for x in tree_leaves([list(args), dict(kwargs or {})]) + outs:
                if isinstance(x, torch.Tensor):
                    self.bytes += x.numel() * x.element_size()
        return out


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode(allow_non_fake_inputs=True)


def _device_rows(rows: int, mesh: Mesh, axes: Tuple[str, ...]) -> int:
    """A device's rows of a batch of ``rows`` split over ``axes`` where
    their product divides it (``batch_pspec``'s guard), else all of them."""
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return rows // n if rows % n == 0 else rows


def lay_out(group: tp.ModelGroup, cfg: ModelConfig, mesh: Mesh, what: str, rows: int) -> bool:
    """Lay the counting ``group`` out as the first rank of the grid ``mesh``
    asks for (``steps.grid_axes``), when the grid's client ranks divide the
    ``rows`` of the batch; whether it did."""
    from repro_torch.launch.steps import grid_axes

    clients = grid_axes(cfg, mesh, what)[:-1]
    n = 1
    for _, k in clients:
        n *= k
    if n == 1 or rows % n:
        return False
    group.clients, group.client_rank = clients, 0
    return True


def _rank_setup(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh, group: tp.ModelGroup):
    """One device's step of ``shape`` as ``(fn, args)``, built and fed under
    the caller's fake mode: the fed step for one client (the device's) on
    its rows (one local step, as the cost pair takes it), or a prefill /
    decode step on its rows and its cache blocks. ``group`` (counting) is
    laid out on the mesh's grid where the batch divides its rows."""
    from repro_torch.launch.steps import build_serve_step, build_train_step

    rank_mesh = Mesh((("data", 1), ("model", group.size)))
    fed = FedStepConfig(local_steps=1, local_lr=1e-2)
    if shape.kind == "train":
        clients = _train_clients(cfg, mesh)
        grid = not clients and cfg.param_sharding == "fsdp" and lay_out(
            group, cfg, mesh, "train", shape.global_batch)
        if grid:  # the step takes the global batch and cuts the rank's rows
            B, step_mesh = shape.global_batch, mesh
        else:
            B = _device_rows(shape.global_batch, mesh, clients or _client_axes(mesh))
            step_mesh = Mesh(tuple((a, 1) for a in clients) + (("model", group.size),))
        bundle, setup = build_train_step(cfg, step_mesh, fed, device="cpu", group=group)
        params = bundle.init(torch.Generator().manual_seed(0))
        state = setup.init_state(params)
        batch = bundle.input_specs(dataclasses.replace(shape, global_batch=B))
        batch = {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in batch.items()}
        return setup.step, (params, state, batch, 0)
    if lay_out(group, cfg, mesh, "serve", shape.global_batch):
        B = shape.global_batch // group.rows
        bundle, setup = build_serve_step(cfg, mesh, shape.seq_len, shape.global_batch, "cpu",
                                         group)
    else:
        B = _device_rows(shape.global_batch, mesh, _client_axes(mesh))
        bundle, setup = build_serve_step(cfg, rank_mesh, shape.seq_len, B, "cpu", group)
    params = bundle.init(torch.Generator().manual_seed(0))
    cache = bundle.init_cache(B, shape.seq_len)
    batch = bundle.input_specs(dataclasses.replace(shape, global_batch=B))
    batch = {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in batch.items()}
    if shape.kind == "prefill":
        return setup.prefill, (params, batch, cache)
    return setup.serve_step, (params, cache, batch)


def count_step(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh) -> Dict[str, Any]:
    """One device's step of ``shape`` on ``mesh`` counted under fake
    tensors: FLOPs, bytes and its collectives (count and bytes)."""
    cfg = dataclasses.replace(cfg, attn_impl="xla")
    group = tp.ModelGroup.counting(mesh.shape.get("model", 1))
    with _fake_mode(), torch.no_grad() if shape.kind != "train" else contextlib.nullcontext():
        fn, args = _rank_setup(cfg, shape, mesh, group)
        group.reset_counters()
        flops = FlopCounterMode(display=False)
        nbytes = _ByteCounter()
        with flops, nbytes:
            fn(*args)
    colls = CollectiveStats.of_group(group)
    return {"flops": float(flops.get_total_flops()), "bytes": float(nbytes.bytes),
            "collective_bytes": float(colls.total_bytes), "collectives": dict(colls.by_kind)}


def count_collectives(fn: Callable[..., Any], size: int, rank: int, *args: Any) -> Any:
    """``fn(group, *args)`` under fake tensors on rank ``rank`` of a
    counting group of ``size``: the rank's step built and run with no
    process group behind it, its collectives counted as a real group's."""
    group = tp.ModelGroup.counting(size, rank)
    with _fake_mode():
        return fn(group, *args)


def count_grid_collectives(fn: Callable[..., Any], axes: Tuple[Tuple[str, int], ...],
                           index: int, *args: Any, memory_share: Optional[int] = None) -> Any:
    """``count_collectives`` for process ``index`` of the grid ``axes``
    (``tensor_parallel.GroupPool(..., axes=axes)``'s rank order), the rank
    holding ``memory_share`` bytes of its device (``None``: no bound; the
    MoE expert FFN sizes its gathers by it)."""
    place = tp.grid_place(axes, index)
    group = tp.ModelGroup.counting(place["size"], place["rank"], clients=place["clients"],
                                   client_rank=place["client_rank"], memory_share=memory_share)
    with _fake_mode():
        return fn(group, *args)


def _counts(group: tp.ModelGroup, by_axis: bool):
    if not by_axis:
        return group.all_reduces, group.all_reduce_bytes
    c = group.counters()
    return {"model": (c["model_all_reduces"], c["model_all_reduce_bytes"]),
            "data": (c["data_collectives"], c["data_collective_bytes"])}


def serve_counts(group: tp.ModelGroup, cfg: ModelConfig, batch: int,
                 prompt: int, by_axis: bool = False) -> Dict[str, Any]:
    """The rank's all-reduces (count, bytes) in a prefill of ``batch`` x
    ``prompt`` tokens and in one decode step after it (``build_serve_step``
    on the group's mesh, on the group's device: on a grid, the rank's rows
    of the batch); ``by_axis``: each as ``{"model": ..., "data": ...}``,
    the ``data`` entry every collective over the client axes (all-reduces
    and the data gathers' all-gathers)."""
    from repro_torch.launch.steps import build_serve_step

    dev = group.device
    bundle, setup = build_serve_step(cfg, group.mesh, prompt + 1, batch, dev, group)
    params = bundle.init(torch.Generator(device=dev).manual_seed(0))
    tokens = setup.rows({"tokens": torch.zeros((batch, prompt), dtype=torch.int32,
                                               device=dev)})["tokens"]
    cache = bundle.init_cache(tokens.shape[0], prompt + 1)
    out = {}
    with torch.no_grad():
        group.reset_counters()
        _, cache = setup.prefill(params, {"tokens": tokens}, cache)
        out["prefill"] = _counts(group, by_axis)
        group.reset_counters()
        setup.serve_step(params, cache, {"token": tokens[:, :1]})
        out["step"] = _counts(group, by_axis)
    return out


def train_counts(group: tp.ModelGroup, cfg: ModelConfig, mesh: Mesh, fed: FedStepConfig,
                 batch: Tuple[int, int], cross_pod_wire: str = "f32",
                 strategy_name: Optional[str] = None, by_axis: bool = False) -> Any:
    """The rank's all-reduces (count, bytes) in one ``build_train_step``
    round on ``mesh`` over a token batch of ``batch`` (rows, length), on the
    group's device; ``by_axis``: as ``{"model": ..., "data": ...}``."""
    from repro_torch.launch.steps import build_train_step

    dev = group.device
    bundle, setup = build_train_step(cfg, mesh, fed, cross_pod_wire, strategy_name, dev, group)
    params = bundle.init(torch.Generator(device=dev).manual_seed(0))
    state = setup.init_state(params)
    group.reset_counters()
    setup.step(params, state, {"tokens": torch.zeros(batch, dtype=torch.int32, device=dev)}, 0)
    return _counts(group, by_axis)


def _extrapolate(a: Dict[str, Any], b: Dict[str, Any], n: float) -> Dict[str, Any]:
    """``a + n * (b - a)`` of each count, the collectives' too."""
    out = {k: a[k] + n * (b[k] - a[k]) for k in ("flops", "bytes", "collective_bytes")}
    kinds = set(a["collectives"]) | set(b["collectives"])
    out["collectives"] = {
        k: tuple(x + n * (y - x) for x, y in zip(a["collectives"].get(k, (0, 0)),
                                                 b["collectives"].get(k, (0, 0))))
        for k in kinds}
    return out


def count_at_length(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh) -> Dict[str, Any]:
    """``count_step``; for the recurrent family with no attention (``ssm``:
    the chunked mLSTM and the sLSTM loop, one step per token) at a sequence
    longer than three SSD chunks, counted at two and at three chunks and
    extrapolated along the length: the sLSTM loop is counted at 512 and
    768 steps, not 32 768. From two chunks on, each chunk adds the same
    FLOPs and all-reduces, so those are exact; the bytes are an estimate
    (the chunk scan's combine grows faster than the chunks: 2.4% under at
    four chunks of the reduced config)."""
    c = cfg.ssd_chunk
    S = shape.seq_len
    if cfg.family != "ssm" or shape.kind == "decode" or S <= 3 * c or S % c:
        return count_step(cfg, shape, mesh)
    two = count_step(cfg, dataclasses.replace(shape, seq_len=2 * c), mesh)
    three = count_step(cfg, dataclasses.replace(shape, seq_len=3 * c), mesh)
    return _extrapolate(two, three, S // c - 2)


def cost_pair(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh) -> Dict[str, Any]:
    """The two counted depths and their extrapolation to ``cfg``'s
    (``total = c2 + (G - 2) * (c4 - c2) / 2``), a device's figures."""
    train = shape.kind == "train"
    period = len(layer_kinds(cfg))
    G = cfg.num_layers // period
    cost_cfg = dataclasses.replace(cfg, scan_layers=False, remat=train)
    c2 = count_at_length(_with_layers(cost_cfg, 2 * period), shape, mesh)
    c4 = count_at_length(_with_layers(cost_cfg, 4 * period), shape, mesh)
    return dict(_extrapolate(c2, c4, (G - 2) / 2.0), cost_2p=c2, cost_4p=c4)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """2 x active parameters x tokens, x3 to train (forward and backward)."""
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 3 if shape.kind == "train" else 1
    return 2.0 * n_active * tokens * mult


def roofline_of(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
                cost: Dict[str, Any], arch: str = "") -> Roofline:
    """The roofline of a device's extrapolated counts over the mesh's
    chips, at the card's peak for the parameters' dtype."""
    chips = _chips(mesh)
    peak = PEAK_FLOPS_F32 if cfg.param_dtype == "float32" else PEAK_FLOPS_BF16
    return Roofline(arch=arch or cfg.arch_id, shape=shape.name, mesh=mesh_name(mesh),
                    chips=chips, hlo_flops=cost["flops"] * chips,
                    hlo_bytes=cost["bytes"] * chips,
                    collective_bytes=cost["collective_bytes"],
                    model_flops=model_flops(cfg, shape), peak_flops=peak)


def lower_pair(arch, shape_name, multi_pod=False, roofline=True, verbose=True, mesh=None):
    """The record of one (arch, shape, mesh): resident bytes a device and,
    on a single-pod mesh with ``roofline``, the cost pair and its roofline.
    ``mesh`` (a ``Mesh``) replaces the production mesh ``multi_pod``
    names."""
    shape = SHAPES[shape_name]
    cfg = get_config(arch)
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    name = mesh_name(mesh)
    rec = {"arch": arch, "shape": shape_name, "mesh": name}
    reason = skip_reason(cfg, shape)
    if reason:
        rec["skipped"] = reason
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} SKIP: {reason}")
        return rec
    if shape.name == "long_500k":
        cfg = long_decode_variant(cfg)
    train = shape.kind == "train"
    k = _local_steps(cfg, shape)

    # ---- 1. resident bytes a device -------------------------------------- #
    t0 = time.time()
    mem = device_bytes(dataclasses.replace(cfg, scan_layers=True, remat=train), shape, mesh)
    rec["compile_s"] = time.time() - t0
    rec["memory"] = mem
    rec["fits_hbm"] = bool(mem["resident_bytes"] <= HBM_PER_CARD)
    rec["local_steps"] = k
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} @ {name}: resident/dev "
              f"{mem['resident_bytes'] / 2**30:.2f} GiB (params "
              f"{mem['param_bytes'] / 2**30:.2f}, cache {mem['cache_bytes'] / 2**30:.2f}, state "
              f"{mem['state_bytes'] / 2**30:.2f}; activations not counted) "
              f"fits={rec['fits_hbm']}")

    # ---- 2. cost pair: 2p/4p, local_steps=1 (single-pod only) ------------ #
    if roofline and "pod" not in mesh.axis_names:
        t1 = time.time()
        cost = cost_pair(cfg, shape, mesh)
        rec["cost_compile_s"] = time.time() - t1
        roof = roofline_of(cfg, shape, mesh, cost, arch)
        rec["roofline"] = roof.to_dict()
        rec["cost_2p"] = cost["cost_2p"]
        rec["cost_4p"] = cost["cost_4p"]
        if verbose:
            print(f"         roofline: dominant={roof.dominant} "
                  f"C={roof.compute_s * 1e3:.2f}ms M={roof.memory_s * 1e3:.2f}ms "
                  f"X={roof.collective_s * 1e3:.2f}ms useful={roof.useful_ratio:.2f} "
                  f"(counted in {rec['cost_compile_s']:.1f}s)")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-roofline", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    results, failures = [], 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    results.append(
                        lower_pair(arch, shape, multi_pod=mp,
                                   roofline=not args.no_roofline)
                    )
                except Exception as e:  # noqa: BLE001
                    failures += 1
                    print(f"[dryrun] {arch} x {shape} @ "
                          f"{'2x16x16' if mp else '16x16'} FAIL: "
                          f"{type(e).__name__}: {e}")
                    results.append(
                        {"arch": arch, "shape": shape,
                         "mesh": "2x16x16" if mp else "16x16",
                         "error": f"{type(e).__name__}: {e}"}
                    )
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
        print(f"[dryrun] wrote {len(results)} records to {args.out}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
