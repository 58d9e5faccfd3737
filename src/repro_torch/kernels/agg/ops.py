"""Weighted aggregation over trees of client tensors (the port of
``repro.kernels.agg.ops``).

* ``aggregate_flat`` / ``aggregate_tree`` — the stacked layout: leaves lead
  with the client dim C. ``exact=True`` is the order-exact fold the roles
  run, bit-identical to the sequential per-client accumulation;
  ``exact=False`` the fused ``(w @ d) / denom`` that may use FMAs.
* ``fold_into`` / ``divide`` — the streaming entries behind
  ``StreamingMean``: one update at a time, then one divide.

Dispatch is by device, never by size: every call goes through the wrappers
of ``kernel.py``, which launch the kernel for CUDA tensors and run the plain
version for CPU tensors. Both give the same bits on the exact entries.
``aggregate_tree`` launches once per leaf instead of concatenating the
leaves as the JAX package does: the fold is elementwise, so the bits are the
same and no concatenated copy is made.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

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


def fold_into(acc: Optional[Any], tree: Any, w: float) -> Any:
    """Fold one update tree with weight ``w`` into ``acc`` (None: start a new
    accumulator). Accumulator leaves are updated in place."""
    if acc is None:
        return tree_map(lambda x: kernel.exact_fold_into(None, x, w), tree)
    return tree_map(lambda a, x: kernel.exact_fold_into(a, x, w), acc, tree)


def divide(tree: Any, total: float) -> Any:
    """A new tree of ``leaf / total``, each an IEEE divide."""
    return tree_map(lambda x: kernel.exact_divide(x, total), tree)
