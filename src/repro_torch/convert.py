"""Carrying weight trees between the JAX package and the port, and the
port's rule for the device a job runs on.

The JAX package's parameter trees hold numpy arrays (as
``hyperparams["init_weights"]`` carries them); the port's hold
``torch.Tensor``s on the job's device. Both functions keep structure and
dtypes; Python scalars and ``None`` pass through unchanged.
"""
from __future__ import annotations

import collections
from typing import Any

import numpy as np
import torch

from repro_torch.core.tree import tree_map


def _to_tensor(leaf: Any, device: torch.device) -> Any:
    if isinstance(leaf, torch.Tensor):
        return leaf.to(device)
    if isinstance(leaf, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(leaf, copy=True)).to(device)
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
                "no CUDA device: run_job runs on the card by default; pass "
                "device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
