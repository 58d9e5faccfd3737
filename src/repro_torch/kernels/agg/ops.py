"""Weighted aggregation over trees of client tensors (the port of
``repro.kernels.agg.ops``).

* ``aggregate_flat`` / ``aggregate_tree`` — the stacked layout: leaves lead
  with the client dim C. ``exact=True`` is the order-exact fold the roles
  run, bit-identical to the sequential per-client accumulation;
  ``exact=False`` the fused ``(w @ d) / denom`` that may use FMAs.
* ``fold_into`` / ``divide`` — the streaming entries behind
  ``StreamingMean``: one update at a time, then one divide. The float32
  tensor leaves of an update go through the tree entry of the fold kernel
  in one call (one launch per ``kernel.TREE_LEAVES`` leaves), the divide
  leaf by leaf; any other leaf (an int, float64 or float16 tensor, a numpy
  array, a Python or numpy scalar) through a plain path with numpy's
  promotion, as the JAX package folds it: ``x * n`` (ints become float64),
  an add, ``x / total``. Tensors stay on their device there.

Dispatch is by device, never by size: every call goes through the wrappers
of ``kernel.py``, which launch the kernel for CUDA tensors and run the plain
version for CPU tensors. Both give the same bits on the exact entries.
``aggregate_tree`` launches once per leaf instead of concatenating the
leaves as the JAX package does: the fold is elementwise, so the bits are the
same and no concatenated copy is made.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.tree import tree_flatten, tree_map, tree_unflatten
from repro_torch.kernels.agg import kernel


def stack_client_trees(trees: Sequence[Any]) -> Optional[Any]:
    """Stack per-client trees into one tree whose leaves lead with the
    client dim C, or None when the trees are not uniform float32 tensor
    trees on one device (other structure, shapes, dtypes or devices), so
    callers fall back to the streaming fold and its error surface."""
    flat0, treedef = tree_flatten(trees[0])
    flats = [flat0]
    for tree in trees[1:]:
        leaves, td = tree_flatten(tree)
        if td != treedef:
            return None
        flats.append(leaves)
    stacked = []
    for i, ref in enumerate(flat0):
        rows = [leaves[i] for leaves in flats]
        for leaf in rows:
            if not (
                isinstance(leaf, torch.Tensor)
                and leaf.dtype == torch.float32
                and leaf.shape == ref.shape
                and leaf.device == ref.device
            ):
                return None
        stacked.append(torch.stack(rows))
    return tree_unflatten(treedef, stacked)


def aggregate_flat(
    deltas: torch.Tensor,  # (C, N)
    weights: Any,  # (C,)
    *,
    denom: Optional[float] = None,  # default: max(sum(weights), 1e-30)
    exact: bool = False,
) -> torch.Tensor:
    w = torch.as_tensor(weights, dtype=torch.float32, device=deltas.device)
    if denom is None:
        den = torch.clamp(w.sum(), min=1e-30).reshape(1)
    else:
        den = torch.tensor([float(denom)], dtype=torch.float32, device=deltas.device)
    deltas = deltas.contiguous()
    if exact:
        return kernel.exact_fold(deltas, w.contiguous(), den)
    return kernel.weighted_aggregate(deltas, w.contiguous(), den)


def aggregate_tree(
    client_trees: Any, weights: Any, *, denom: Optional[float] = None, exact: bool = False
) -> Any:
    """Leaves of ``client_trees`` lead with the client dim C; each output
    leaf keeps its input dtype."""

    def one(leaf: torch.Tensor) -> torch.Tensor:
        C = leaf.shape[0]
        out = aggregate_flat(leaf.reshape(C, -1), weights, denom=denom, exact=exact)
        return out.reshape(leaf.shape[1:]).to(leaf.dtype)

    return tree_map(one, client_trees)


def _is_f32_tensor(x: Any) -> bool:
    return isinstance(x, torch.Tensor) and x.dtype == torch.float32


def _scalar_like(x: torch.Tensor, value: float, dtype: torch.dtype) -> torch.Tensor:
    return torch.tensor(value, dtype=dtype, device=x.device)


def _plain_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype numpy gives ``x * python_float`` and ``x / python_float``:
    float32 for bfloat16 (ml_dtypes' bfloat16 has no arithmetic of its own),
    float64 for ints and bools, else the tensor's own."""
    if x.dtype == torch.bfloat16:
        return torch.float32
    return x.dtype if x.is_floating_point() else torch.float64


def _plain_scale(x: Any, w: float) -> Any:
    """``x * w`` with numpy's promotion of a Python float (``w`` rounded to
    the result's dtype first, ``_plain_dtype``); numpy leaves and scalars go
    through numpy itself."""
    if isinstance(x, torch.Tensor):
        dtype = _plain_dtype(x)
        return x.to(dtype) * _scalar_like(x, w, dtype)
    return np.asarray(x) * w


def _plain_divide(x: Any, total: float) -> Any:
    if isinstance(x, torch.Tensor):
        dtype = _plain_dtype(x)
        return x.to(dtype) / _scalar_like(x, total, dtype)
    return x / total


def _plain_fold(acc: Any, x: Any, w: float) -> Any:
    scaled = _plain_scale(x, w)
    if acc is None:
        return scaled
    return acc + scaled if isinstance(acc, torch.Tensor) else np.add(acc, scaled)


def fold_into(acc: Optional[Any], tree: Any, w: float) -> Any:
    """Fold one update tree with weight ``w`` into ``acc`` (None: start a new
    accumulator). Float32 accumulator leaves are updated in place, all in one
    call of the kernel's tree entry, which raises on any it does not take
    (leaves on two devices among them)."""
    leaves, treedef = tree_flatten(tree)
    if acc is None:
        accs = [None] * len(leaves)
    else:
        accs, acc_def = tree_flatten(acc)
        if acc_def != treedef:
            raise ValueError(f"tree structures differ: {acc_def!r} vs {treedef!r}")
    out = list(accs)
    idx = []
    for i, (a, x) in enumerate(zip(accs, leaves)):
        if _is_f32_tensor(x) and (a is None or _is_f32_tensor(a)):
            idx.append(i)
        else:
            out[i] = _plain_fold(a, x, w)
    # the kernel takes contiguous leaves only: a strided update (``a.T``) is
    # copied, and the first update's accumulator is allocated contiguous
    folded = kernel.exact_fold_into_tree(
        None if acc is None else [accs[i] for i in idx],
        [leaves[i].contiguous() for i in idx], w)
    for i, leaf in zip(idx, folded):
        out[i] = leaf
    return tree_unflatten(treedef, out)


def divide(tree: Any, total: float) -> Any:
    """A new tree of ``leaf / total``, each an IEEE divide (in the leaf's
    dtype)."""
    return tree_map(
        lambda x: kernel.exact_divide(x, total) if _is_f32_tensor(x) else _plain_divide(x, total),
        tree,
    )
