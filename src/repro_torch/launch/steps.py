"""Step builders: (arch config × mesh × TAG) → train and serve steps (the
port of ``repro.launch.steps``; ``launch/serve.py`` runs without a profile,
as the JAX package's ``launch/serve.py`` does).

``build_train_step`` lowers the FL topology (a TAG) to an
``AggregationPlan`` over the mesh's client axes and runs it inside the
train step (``fl.fedstep``): the clients are virtual, one after another on
the bundle's device, and each stage a float32 sum with its channel's wire
policy. Architectures whose FL clients live on the pod axis
(``fl_axes=("pod",)``) degrade to a plain single-client local-SGD step on a
mesh without a pod axis.

A ``model`` axis of m > 1 is m processes (``launch.tensor_parallel``): the
builders take the rank's ``group`` and return that rank's bundle and steps.
Every rank runs every virtual client in turn on its blocks of the
parameters; each stage's mean is taken block by block, which is
elementwise, so each rank's block of the mean is the block of the
one-process mean. What spans whole leaves is taken over the group:
``delta_norm`` and the DP clip norm sum the squares of the sharded leaves
over the group and count the replicated leaves once; DP noise is drawn for
the whole leaf and cut to the rank's block; the int8 wire's per-tensor
scale is the whole leaf's absmax (``launch.sharding.LeafBlocks``).

Where ``data`` is not a client axis, every device of the mesh is a process
(a grid: ``tensor_parallel.GroupPool(devices, axes=...)``, the axes of
``grid_axes``), and the builders take the rank's group of the grid:

* the one-client train step of an FSDP config (its clients live on
  ``pod``, which the JAX package folds into data parallelism): each rank
  holds its (data, model) block of every leaf, gathers a leaf's ``data``
  blocks at use, takes its rows of each microbatch over (pod, data), and
  sums each gradient over (pod, data) (``fl.fedstep.local_round``); the
  loss is the global batch's. The one-client step takes the parameters it
  is given over, as the JAX driver donates them: each leaf is stepped in
  place as soon as autograd has made its gradient, so a step holds one
  copy of the tree and the gradients not yet applied;
* serving on client axes larger than 1: each rank serves its rows of the
  batch (``ServeSetup.rows``) with the cache of its rows, FSDP configs
  gathering their leaves over ``data`` at use, ``tp`` configs holding them
  replicated over ``data``; the caller joins the rows in (pod, data) order.

A ``tp`` config's train step at ``data`` > 1 keeps its virtual clients
(a group of the ``model`` axis alone). At ``model`` 1 without a group,
both builders are one process on whole leaves.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.mesh_lowering import Mesh, lower_tag_to_mesh
from repro_torch.core.tag import TAG
from repro_torch.core.topologies import classical_fl, hierarchical_fl
from repro_torch.core.tree import tree_flatten, tree_unflatten
from repro_torch.fl.fedstep import (FedStepConfig, batch_to_device, client_generator,
                                   init_server_state, local_round, make_fl_train_step,
                                   split_batch, summed_over_blocks)
from repro_torch.fl.strategies import get_strategy
from repro_torch.launch import sharding as shd
from repro_torch.launch import tensor_parallel as tp
from repro_torch.models.api import ModelBundle, build_model, cache_shapes, param_shapes
from repro_torch.models.config import ModelConfig
from repro_torch.models.shard_ctx import shard_profile

Tree = Any


def _with_moe_profile(fn: Callable, cfg: ModelConfig, mesh: Mesh,
                      manual_axes: Tuple[str, ...] = ()) -> Callable:
    """``fn`` run under the mesh's sharding profile, as the JAX package
    traces its steps. The profile's batch axes are the mesh's batch axes
    less the client (manual) axes; its ``min_blocks``, their size, decides
    the MoE routing blocks. ``act``, ``stash`` and ``axis_sizes`` are the
    JAX package's layouts (the port pins none: ``models.shard_ctx``)."""
    auto_batch = tuple(a for a in shd.batch_axes(cfg, mesh) if a not in manual_axes)
    act = (auto_batch or None, None)
    if cfg.param_sharding == "fsdp":
        stash = (tuple(a for a in auto_batch if a != "model") or None,
                 ("model",) if "model" in auto_batch else None)
    else:
        stash = act
    min_blocks = 1
    for a in auto_batch:
        min_blocks *= mesh.shape[a]
    axis_sizes = dict(mesh.axes)

    def wrapped(*a, **k):
        with shard_profile(auto_batch, "model", min_blocks=min_blocks, act=act, stash=stash,
                           axis_sizes=axis_sizes):
            return fn(*a, **k)

    return wrapped


def grid_axes(cfg: ModelConfig, mesh: Mesh, what: str) -> Tuple[Tuple[str, int], ...]:
    """The axes of ``mesh`` that run as processes for ``what`` ("train" or
    "serve"): every axis where ``data`` is not a client axis (serving, an
    FSDP config's train step), else the ``model`` axis alone. A ``pod``
    axis of 1 is left out."""
    m = mesh.shape.get("model", 1)
    if what == "serve" or cfg.param_sharding == "fsdp":
        clients = tuple((a, mesh.shape[a]) for a in ("pod", "data") if a in mesh.axis_names)
        clients = tuple((a, n) for a, n in clients if a == "data" or n > 1)
        return (clients or (("data", 1),)) + (("model", m),)
    return (("data", 1), ("model", m))


def _model_group(cfg: ModelConfig, mesh: Mesh, group: Optional[tp.ModelGroup],
                 what: str) -> Optional[tp.ModelGroup]:
    """The rank's group the mesh asks for: None at model 1 without one (a
    single process on whole leaves), else a group laid out on the mesh's
    process axes (``grid_axes``)."""
    m = mesh.shape.get("model", 1)
    if group is None and m == 1:
        return None
    axes = grid_axes(cfg, mesh, what)
    n = 1
    for _, k in axes:
        n *= k
    if group is None:
        raise ValueError(f"a model axis of {m} runs as {n} processes: pass the rank's group "
                         f"(launch.tensor_parallel.run_model_group), got {group}")
    have, want = dict(group.clients), dict(axes[:-1])
    if group.size != m or any(have.get(a, 1) != want.get(a, 1) for a in set(have) | set(want)):
        raise ValueError(f"{cfg.arch_id} on {mesh.shape} runs as the grid {axes} ({n} "
                         f"processes); the group is {group.clients} x model {group.size}")
    return group


def _leaf_blocks(cfg: ModelConfig, group: Optional[tp.ModelGroup]) -> Optional[shd.LeafBlocks]:
    """How the group's rank holds each parameter leaf (None without a
    group)."""
    if group is None:
        return None
    return shd.LeafBlocks.of_params(param_shapes(cfg), cfg, group.mesh, group.coords)


@dataclasses.dataclass(frozen=True)
class TrainSetup:
    step: Callable[..., Tuple[Tree, Tree, Dict[str, torch.Tensor]]]
    init_state: Callable[[Tree], Tree]  # params -> server/opt state
    client_axes: Tuple[str, ...]
    tag: Optional[TAG]


def fl_tag_for_mesh(cfg: ModelConfig, client_axes: Tuple[str, ...],
                    cross_pod_wire: str = "f32") -> TAG:
    """The TAG driving the aggregation.

    Two client axes → hierarchical FL (edge aggregation over ``data``
    within each pod, global aggregation over ``pod`` with its own wire
    policy). One axis → classical FL.
    """
    if len(client_axes) >= 2:
        return hierarchical_fl(groups=("g0",), agg_wire_dtype=cross_pod_wire)
    return classical_fl()


def build_train_step(
    cfg: ModelConfig,
    mesh: Mesh,
    fed: FedStepConfig = FedStepConfig(),
    cross_pod_wire: str = "f32",
    strategy_name: Optional[str] = None,
    device: Any = None,
    group: Optional[tp.ModelGroup] = None,
) -> Tuple[ModelBundle, TrainSetup]:
    """The bundle on ``device`` (the card when None; raises without one) and
    the step ``step(params, state, batch, seed) -> (params, state,
    metrics)``. With a ``model`` axis of m > 1, the rank's bundle and step
    (``group``: the rank's ``ModelGroup`` of m)."""
    group = _model_group(cfg, mesh, group, "train")
    bundle = build_model(cfg, device, group)
    blocks = _leaf_blocks(cfg, group)
    client_axes = tuple(a for a in cfg.fl_axes if a in mesh.axis_names)
    if cfg.param_sharding == "fsdp" and len(mesh.axes) > 2:
        # the JAX package's FSDP giants train as one client across pods
        client_axes = ()
    strategy = get_strategy(strategy_name or cfg.server_strategy)

    if client_axes:
        tag = fl_tag_for_mesh(cfg, client_axes, cross_pod_wire)
        # order axes fast->slow: data (within a pod) first, pod last
        ordered = tuple(a for a in ("data", "pod") if a in client_axes) or client_axes
        plan = lower_tag_to_mesh(tag, ordered)
        step = _with_moe_profile(
            make_fl_train_step(bundle.loss_fn, strategy, plan, mesh, fed, blocks=blocks),
            cfg, mesh, manual_axes=client_axes)

        def init_state(params):
            return init_server_state(strategy, plan, params)

        return bundle, TrainSetup(tp.bind(step, group), init_state, client_axes, tag)

    # ---- one client: local SGD over local_steps microbatches --------------
    # (on a grid: each rank's rows of every microbatch, its blocks over data)
    over_data = None if blocks is None else blocks.sharded_over("data")

    # (the step takes ``params`` over, as the JAX driver donates them: each
    # leaf is stepped in place as soon as its gradient is whole, and the
    # returned tree holds the same tensors)

    def step(params, state, batch, seed):
        leaves, treedef = tree_flatten(params)
        batch = batch_to_device(batch, leaves[0].device)
        gen = client_generator(seed, 0, "loss", leaves[0].device)
        new, loss, sums = local_round(bundle.loss_fn, leaves, treedef, batch, gen,
                                      fed.local_steps, fed.local_lr, over_data, donate=True)
        sq = summed_over_blocks(sums, None if blocks is None else blocks.sharded, over_data)
        return tree_unflatten(treedef, new), state, {"loss": loss, "delta_norm": torch.sqrt(sq)}

    def init_state(params):
        return ()

    return bundle, TrainSetup(tp.bind(_with_moe_profile(step, cfg, mesh), group), init_state,
                              (), None)


# --------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------- #
def _no_split(batch: Dict[str, Any]) -> Dict[str, Any]:
    return batch


@dataclasses.dataclass(frozen=True)
class ServeSetup:
    serve_step: Callable
    prefill: Callable
    param_shardings: Tree  # the parameters' specs (launch.sharding.param_pspec)
    cache_shardings: Tree  # the cache's specs (launch.sharding.cache_pspec)
    # the rank's rows of a global batch (over pod x data; itself off a grid)
    rows: Callable[[Dict[str, Any]], Dict[str, Any]] = _no_split


def build_serve_step(cfg: ModelConfig, mesh: Mesh, max_len: int, batch: int,
                     device: Any = None,
                     group: Optional[tp.ModelGroup] = None) -> Tuple[ModelBundle, ServeSetup]:
    """The bundle on ``device`` and the serving steps under the mesh's
    profile: ``prefill(params, batch, cache)`` and ``serve_step(params,
    cache, batch)``, and the specs the parameters and the cache of
    ``batch`` x ``max_len`` are stored by. With a ``model`` axis of m > 1,
    or a grid, the rank's (``group``): it serves its rows of the batch
    (``rows``) from the cache of its rows (``bundle.init_cache(rows, ...)``)."""
    group = _model_group(cfg, mesh, group, "serve")
    bundle = build_model(cfg, device, group)
    p_specs = shd.param_specs(param_shapes(cfg), cfg, mesh)
    c_specs = shd.cache_specs(cache_shapes(cfg, batch, max_len), cfg, mesh)
    serve = _with_moe_profile(
        lambda params, cache, batch_in: bundle.serve_step(params, cache, batch_in), cfg, mesh)
    prefill = _with_moe_profile(
        lambda params, batch_in, cache: bundle.prefill(params, batch_in, cache), cfg, mesh)
    rows = _no_split
    if group is not None and group.rows > 1:
        me, n = group.client_rank, group.rows

        def rows(batch_in):
            return split_batch(batch_in, n, me)

    return bundle, ServeSetup(serve, prefill, p_specs, c_specs, rows)
