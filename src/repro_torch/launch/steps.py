"""Train-step builders: (arch config × mesh × TAG) → a train step (the port
of ``repro.launch.steps``, training half; the serving half is
``launch/serve.py``).

``build_train_step`` lowers the FL topology (a TAG) to an
``AggregationPlan`` over the mesh's client axes and runs it inside the
train step (``fl.fedstep``): the clients are virtual, one after another on
the bundle's device, and each stage a float32 sum with its channel's wire
policy. Architectures whose FL clients live on the pod axis
(``fl_axes=("pod",)``) degrade to a plain single-client local-SGD step on a
mesh without a pod axis.
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
                                   init_server_state, local_round, make_fl_train_step)
from repro_torch.fl.strategies import get_strategy
from repro_torch.models.api import ModelBundle, build_model
from repro_torch.models.config import ModelConfig

Tree = Any


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
) -> Tuple[ModelBundle, TrainSetup]:
    """The bundle on ``device`` (the card when None; raises without one) and
    the step ``step(params, state, batch, seed) -> (params, state,
    metrics)``."""
    if mesh.shape.get("model", 1) != 1:
        raise NotImplementedError(
            "tensor parallelism (a model axis over several cards) is not ported (ROADMAP Queue 1)")
    bundle = build_model(cfg, device)
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
        step = make_fl_train_step(bundle.loss_fn, strategy, plan, mesh, fed)

        def init_state(params):
            return init_server_state(strategy, plan, params)

        return bundle, TrainSetup(step, init_state, client_axes, tag)

    # ---- one client: local SGD over local_steps microbatches --------------
    def step(params, state, batch, seed):
        leaves, treedef = tree_flatten(params)
        batch = batch_to_device(batch, leaves[0].device)
        gen = client_generator(seed, 0, "loss", leaves[0].device)
        new, loss = local_round(bundle.loss_fn, leaves, treedef, batch, gen,
                                fed.local_steps, fed.local_lr)
        sq = None
        for a, b in zip(new, leaves):
            s = torch.sum(torch.square((a - b).to(torch.float32)))
            sq = s if sq is None else sq + s
        return tree_unflatten(treedef, new), state, {"loss": loss, "delta_norm": torch.sqrt(sq)}

    def init_state(params):
        return ()

    return bundle, TrainSetup(step, init_state, (), None)
