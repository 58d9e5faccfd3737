"""Tree checkpointing to .npz, the port of ``repro.checkpoint``.

The file format is the JAX package's, so a checkpoint written by either
package restores in the other: one array per leaf, keyed by the leaf's path
joined by ``'/'`` (dict keys as ``str(key)``, sequence indices as ``#i``,
namedtuple fields as ``.name``), leaves in ``jax.tree_util``'s order (dict
keys sorted), written to ``ckpt_{step:08d}.npz`` through a temporary file
and ``os.replace`` (atomic). Tensor leaves go to the host with
``.cpu().numpy()``; ``restore`` and ``load_tree`` put numeric leaves back on
a torch device as tensors, and keep string leaves (a policy server's 0-d
``meta``) as numpy arrays.
"""
from __future__ import annotations

import os
import re
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.tree import _LEAF, _children, tree_flatten, tree_unflatten

Tree = Any
_SEP = "/"


def _path_keys(node: Any, prefix: Tuple[str, ...], out: List[Tuple[str, Any]]) -> None:
    kind, meta, kids = _children(node)
    if kind == _LEAF:
        out.append((_SEP.join(prefix), node))
        return
    if kind in ("dict", "ordereddict"):
        names = [str(k) for k in meta]
    elif kind == "defaultdict":
        names = [str(k) for k in meta[1]]
    elif kind == "namedtuple":
        names = [f".{f}" for f in meta._fields]
    else:  # list, tuple
        names = [f"#{i}" for i in range(len(kids))]
    for name, kid in zip(names, kids):
        _path_keys(kid, prefix + (name,), out)


def _flat_paths(tree: Tree) -> List[Tuple[str, Any]]:
    """``(key, leaf)`` in flatten order, keys as the JAX package joins them."""
    out: List[Tuple[str, Any]] = []
    _path_keys(tree, (), out)
    return out


def _host(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("bfloat16 leaves have no numpy dtype to checkpoint as")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _to_device(arr: np.ndarray, device: torch.device) -> Any:
    """A numeric array just read from a file (so ours to share) as a tensor
    on ``device``; strings stay numpy."""
    if arr.dtype.kind not in "biuf":
        return arr
    return torch.from_numpy(arr).to(device)


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step:08d}.npz")


def save(directory: str, step: int, tree: Tree) -> str:
    os.makedirs(directory, exist_ok=True)
    flat = {key: _host(leaf) for key, leaf in _flat_paths(tree)}
    path = _path(directory, step)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"ckpt_(\d+)\.npz", name)
        if m:
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def load_tree(directory: str, step: int, device: Any) -> Dict[str, Any]:
    """Load a checkpoint as a nested dict, no ``like`` template needed.

    Nesting comes back from the '/'-joined keys (``"#i"`` segments stay
    plain string keys), numeric leaves as tensors on ``device``. A restarted
    policy server rebuilds its state from this dict."""
    dev = torch.device(device)
    tree: Dict[str, Any] = {}
    with np.load(_path(directory, step)) as data:
        for key in data.files:
            node = tree
            parts = key.split(_SEP)
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = _to_device(data[key], dev)
    return tree


def restore(
    directory: str, step: int, like: Tree, strict: bool = False, device: Any = None
) -> Tree:
    """Restore into the structure of ``like`` (shapes checked, dtypes
    taken from ``like``). A tensor leaf of ``like`` comes back as a tensor
    on ``device`` (default: that leaf's device), any other leaf as a numpy
    array.

    With ``strict=True`` the checkpoint must hold exactly the keys of
    ``like``: unknown keys raise instead of being dropped."""
    with np.load(_path(directory, step)) as data:
        flat = {k: data[k] for k in data.files}
    dev = None if device is None else torch.device(device)
    _, treedef = tree_flatten(like)
    leaves = []
    seen = set()
    for key, leaf in _flat_paths(like):
        if key not in flat:
            raise KeyError(f"checkpoint missing key {key!r}")
        seen.add(key)
        arr = flat[key]
        shape = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else np.shape(leaf)
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(
                f"shape mismatch for {key!r}: ckpt {arr.shape} vs tree {tuple(shape)}"
            )
        if isinstance(leaf, torch.Tensor):
            t = torch.from_numpy(arr).to(leaf.dtype)
            leaves.append(t.to(leaf.device if dev is None else dev))
        else:
            leaves.append(arr.astype(np.asarray(leaf).dtype))
    if strict:
        extra = sorted(set(flat) - seen)
        if extra:
            raise KeyError(
                f"checkpoint has {len(extra)} unknown key(s) not in the "
                f"restore tree: {extra}"
            )
    return tree_unflatten(treedef, leaves)
