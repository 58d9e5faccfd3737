"""Carrying weight trees between the JAX package and the port.

The JAX package's parameter trees hold numpy arrays (as
``hyperparams["init_weights"]`` carries them); the port's hold
``torch.Tensor``s on the job's device. Both functions keep structure and
dtypes; Python scalars and ``None`` pass through unchanged.
"""
from __future__ import annotations

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
    """A tree of numpy arrays (or tensors) as a tree of tensors on ``device``."""
    device = torch.device(device)
    return tree_map(lambda leaf: _to_tensor(leaf, device), tree)


def tree_to_numpy(tree: Any) -> Any:
    """A tree of tensors as a tree of numpy arrays on the host."""
    return tree_map(
        lambda leaf: leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else leaf,
        tree,
    )
