"""Carrying weight trees between the JAX package and the port, and the
port's rule for the device a job runs on.

The JAX package's parameter trees hold numpy arrays (as
``hyperparams["init_weights"]`` carries them, or as ``jax.device_get`` gives
a model's parameters, bfloat16 ones as ``ml_dtypes`` arrays) or arrays that
convert to numpy (``np.asarray``: a JAX array on the host); the port's hold
``torch.Tensor``s on the job's device. The functions keep structure and
dtypes; Python scalars and ``None`` pass through unchanged. A server state
(``fl.fedstep.init_server_state``: ``{"stages": {"root": ...}}``, FedAdam's
``m`` and ``v``, FedBuff's accumulator and 0-d count) carries with
``tree_from_numpy``, as parameters do; a local optimizer's state
(``repro.optim``: ``adamw``'s ``step``, ``m`` and ``v``, ``sgd``'s ``step``
and ``mom``) with ``optimizer_state_from_numpy``.
"""
from __future__ import annotations

import collections
from typing import Any

import numpy as np
import torch

from repro_torch.core.tree import tree_leaves, tree_map


def _to_tensor(leaf: Any, device: torch.device) -> Any:
    if isinstance(leaf, torch.Tensor):
        return leaf.to(device)
    if not isinstance(leaf, (np.ndarray, np.generic, int, float, bool, str)) and hasattr(
            leaf, "__array__"):
        leaf = np.asarray(leaf)
    if isinstance(leaf, (np.ndarray, np.generic)):
        arr = np.array(leaf, copy=True)
        if arr.dtype.name == "bfloat16":
            # ml_dtypes' bfloat16 (JAX's), which torch.from_numpy refuses:
            # carried as its 16-bit patterns, without importing ml_dtypes
            return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16).to(device)
        return torch.from_numpy(arr).to(device)
    return leaf


def tree_from_numpy(tree: Any, device: Any) -> Any:
    """A tree of numpy arrays (or tensors) as a tree of tensors on ``device``.

    Containers keep their type and their dicts their key order: the JAX
    package holds ``init_weights`` as given, and the order matters where
    leaves are concatenated (the ``int8_blocks`` codec's blocks)."""
    device = torch.device(device)

    def walk(node: Any) -> Any:
        if isinstance(node, dict):
            out = {k: walk(v) for k, v in node.items()}
            if type(node) is dict:
                return out
            if isinstance(node, collections.defaultdict):
                return collections.defaultdict(node.default_factory, out)
            return type(node)(out)
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, tuple):
            kids = [walk(v) for v in node]
            return type(node)(*kids) if hasattr(type(node), "_fields") else tuple(kids)
        return _to_tensor(node, device)

    return walk(tree)


def params_from_jax(tree: Any, device: Any) -> Any:
    """A JAX parameter or cache tree, given as numpy arrays, as the port's
    tree on ``device``: tuples, dict key order and dtypes kept, bfloat16
    leaves included. (``jax.device_get`` gives such arrays, with its dicts
    rebuilt in sorted key order, as a jitted JAX function returns them.)"""
    return tree_from_numpy(tree, device)


def optimizer_state_from_numpy(state: Any, device: Any) -> Any:
    """A ``repro.optim`` optimizer state given as numpy arrays (``step``, a
    0-d int32, and ``adamw``'s float32 ``m`` and ``v`` trees or ``sgd``'s
    ``mom`` tree or None) as the port's ``repro_torch.optim`` state on
    ``device``."""
    out = tree_from_numpy(state, device)
    step = out.get("step") if isinstance(out, dict) else None
    if not isinstance(step, torch.Tensor) or step.dim() != 0 or step.dtype != torch.int32:
        raise ValueError(f"an optimizer state's step is a 0-d int32 array, got {step!r}")
    for key in ("m", "v"):
        for x in tree_leaves(out.get(key)):
            if x.dtype != torch.float32:
                raise ValueError(f"adamw's {key} is float32, got {x.dtype}")
    return out


def tree_to_numpy(tree: Any) -> Any:
    """A tree of tensors as a tree of numpy arrays on the host."""
    return tree_map(
        lambda leaf: leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else leaf,
        tree,
    )


def resolve_device(device: Any = None) -> torch.device:
    """The job's device: CUDA when ``device`` is None. Raises when CUDA is
    asked for (or defaulted to) and absent, instead of running on the CPU."""
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card by default (run_job, "
                "build_model, serve); pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def shard_tree_from_numpy(tree: Any, cfg: Any, mesh: Any, rank: Any, device: Any) -> Any:
    """The block of every leaf of a parameter tree (numpy arrays, the JAX
    package's parameters) that a device of ``mesh`` holds
    (``launch.sharding.param_pspec``), as tensors on ``device``: ``rank``
    is the ``model`` rank (the other axes at 0), or a grid rank's
    coordinates (``ModelGroup.coords``: its ``data`` blocks too)."""
    from repro_torch.launch import sharding

    coords = dict(rank) if isinstance(rank, dict) else {"model": rank}
    specs = sharding.param_specs(tree, cfg, mesh)
    blocks = sharding.shard_tree(tree, specs, mesh, coords)
    return tree_from_numpy(blocks, device)


def unshard_tree(trees: Any, cfg: Any, mesh: Any) -> Any:
    """The whole parameter tree (numpy) from the ranks' trees (numpy or
    tensors): the ``model`` ranks' (``trees[r]``, in rank order; the ranks
    of the other axes hold the same blocks), or a grid's, one per device of
    ``mesh`` in its row-major order."""
    from repro_torch.launch import sharding

    host = [tree_to_numpy(t) for t in trees]
    return sharding.unshard_tree(host, sharding.param_specs(host[0], cfg, mesh), mesh)
