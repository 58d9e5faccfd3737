"""Name-based sharding rules: params / caches / batches -> partition specs
(the port of ``repro.launch.sharding``).

Policy, as in the JAX package:

* ``tp``   -- attention heads, ffn hidden, experts and vocab shard on
  ``model``; everything replicated over client axes (pod/data).
* ``fsdp`` -- additionally shards a second dim over ``data`` (archs too
  large to replicate per FL client; their clients live on the pod axis).

Every rule is divisibility-guarded: a dim that doesn't divide the mesh axis
is replicated on that axis (e.g. 4 KV heads on a 16-way model axis).
Stacked layer dims (scan-over-layers / encdec stacks) get a leading
``None``.

A spec is a tuple with one entry per dim: ``None``, an axis name, or a
tuple of axis names (the dim split over their product, the first axis
slowest), the entries of the JAX package's ``PartitionSpec``. The mesh is
the port's ``Mesh`` of named sizes. ``shard`` cuts one device's block out
of a leaf and ``unshard`` puts the blocks of every device back together;
``launch.tensor_parallel`` runs a model on the blocks of the ``model``
axis, one process per block.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.mesh_lowering import Mesh
from repro_torch.models.config import ModelConfig

Tree = Any
Spec = Tuple[Any, ...]

# parents whose "w" shards the OUTPUT dim on model (column parallel)
_COL_PARENTS = {"wq", "wk", "wv", "in_xz", "in_bc", "in_dt", "gates", "gate", "up"}
# parents whose "w" shards the INPUT dim on model (row parallel)
_ROW_PARENTS = {"wo", "out", "down"}


def _names(path: Sequence[Any]) -> Tuple[str, ...]:
    """A leaf's path as names: dict keys as themselves, sequence indices as
    ``[i]`` (the JAX package's ``DictKey`` / ``SequenceKey`` names)."""
    return tuple(f"[{k}]" if isinstance(k, int) else str(k) for k in path)


def _guard(spec: Sequence[Any], shape: Sequence[int], mesh: Mesh) -> Spec:
    """Drop axes that don't divide their dim; pad leading Nones to ndim."""
    spec = (None,) * (len(shape) - len(spec)) + tuple(spec)
    sizes = mesh.shape
    fixed: List[Any] = []
    for dim, ax in zip(shape, spec):
        if ax is None:
            fixed.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        axes = tuple(a for a in axes if a in mesh.axis_names)
        size = 1
        for a in axes:
            size *= sizes[a]
        if axes and dim % size == 0:
            fixed.append(axes if len(axes) > 1 else axes[0])
        else:
            fixed.append(None)
    return tuple(fixed)


def param_pspec(path, leaf, cfg: ModelConfig, mesh: Mesh) -> Spec:
    names = _names(path)
    last = names[-1]
    parent = names[-2] if len(names) >= 2 else ""
    fsdp = "data" if cfg.param_sharding == "fsdp" else None
    shape, ndim = tuple(leaf.shape), len(leaf.shape)

    if last == "emb":  # (V, d)
        return _guard(("model", fsdp), shape, mesh)
    if last in ("gate", "up", "down") and ndim >= 3:  # moe (E, d|ff, ff|d)
        return _guard(("model", fsdp, None), shape, mesh)
    if last == "w":
        if parent == "router":
            return _guard((None, None), shape, mesh)
        if parent in _COL_PARENTS:
            return _guard((fsdp, "model"), shape, mesh)
        if parent in _ROW_PARENTS:
            return _guard(("model", fsdp), shape, mesh)
        return _guard((None, None), shape, mesh)
    if last == "b":
        if parent in _COL_PARENTS:
            return _guard(("model",), shape, mesh)
        return _guard((None,), shape, mesh)
    # norms, a_log, d_skip, scalars
    return _guard((), shape, mesh)


def cache_pspec(path, leaf, cfg: ModelConfig, mesh: Mesh) -> Spec:
    names = _names(path)
    last = names[-1]
    shape = tuple(leaf.shape)
    if last in ("k", "v", "cross_k", "cross_v"):  # (B, W, Hkv, Dh)
        # batch over data; KV heads over model when they divide it, else
        # the sequence dim over model
        hkv = shape[-2]  # leaves may lead with a stacked layer dim
        model = mesh.shape.get("model", 1)
        if hkv % model == 0:
            return _guard(("data", None, "model", None), shape, mesh)
        return _guard(("data", "model", None, None), shape, mesh)
    if last == "state":  # (B, H, N, P)
        return _guard(("data", None, None, "model"), shape, mesh)
    if last in ("c", "n", "m"):  # slstm (B, d)
        return _guard(("data", "model"), shape, mesh)
    return _guard((), shape, mesh)


def batch_axes(cfg: ModelConfig, mesh: Mesh) -> Tuple[str, ...]:
    """Mesh axes the global token set is split over (flat MoE block dim)."""
    axes = [a for a in ("pod", "data") if a in mesh.axis_names]
    if cfg.param_sharding == "fsdp" and "model" in mesh.axis_names:
        # FSDP archs additionally split tokens over model (sequence
        # parallelism: B over pod/data, S over model)
        axes.append("model")
    return tuple(axes)


def batch_pspec(key: str, leaf, cfg: ModelConfig, mesh: Mesh) -> Spec:
    bd = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    shape = tuple(leaf.shape)
    if key == "positions":  # (3, B, S)
        return _guard((None, bd, None), shape, mesh)
    # tokens (B, S), frames (B, F, d), patch_embeds (B, P, d), token (B, 1)
    return _guard((bd,) + (None,) * (len(shape) - 1), shape, mesh)


# --------------------------------------------------------------------- #
# trees
# --------------------------------------------------------------------- #
def map_with_path(fn, tree: Tree, path: Tuple[Any, ...] = ()) -> Tree:
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples; a path
    holds dict keys and sequence indices. ``None`` stays ``None``."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
        return type(tree)(out)
    if tree is None:
        return None
    return fn(path, tree)


def param_specs(params: Tree, cfg: ModelConfig, mesh: Mesh) -> Tree:
    return map_with_path(lambda path, leaf: param_pspec(path, leaf, cfg, mesh), params)


def cache_specs(cache: Tree, cfg: ModelConfig, mesh: Mesh) -> Tree:
    return map_with_path(lambda path, leaf: cache_pspec(path, leaf, cfg, mesh), cache)


def batch_specs(batch: Dict[str, Any], cfg: ModelConfig, mesh: Mesh) -> Dict[str, Spec]:
    return {k: batch_pspec(k, v, cfg, mesh) for k, v in batch.items()}


# --------------------------------------------------------------------- #
# one device's block
# --------------------------------------------------------------------- #
def mesh_coords(mesh: Mesh) -> List[Dict[str, int]]:
    """Every device's coordinates, in the mesh's row-major order (the last
    axis fastest, as ``mesh.devices.flat`` runs)."""
    out: List[Dict[str, int]] = [{}]
    for name, size in mesh.axes:
        out = [dict(c, **{name: i}) for c in out for i in range(size)]
    return out


def _entry_axes(entry: Any) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def split_of(entry: Any, mesh: Mesh, coords: Dict[str, int]) -> Tuple[int, int]:
    """(number of blocks, this device's block) of a dim with spec ``entry``."""
    n, idx = 1, 0
    for a in _entry_axes(entry):
        n *= mesh.shape[a]
        idx = idx * mesh.shape[a] + coords.get(a, 0)
    return n, idx


def shard_shape(shape: Sequence[int], spec: Spec, mesh: Mesh) -> Tuple[int, ...]:
    """The block shape of a leaf of ``shape`` on any device."""
    return tuple(d // split_of(e, mesh, {})[0] for d, e in zip(shape, spec))


def _block(shape: Sequence[int], spec: Spec, mesh: Mesh, coords: Dict[str, int]):
    out = []
    for d, e in zip(shape, spec):
        n, i = split_of(e, mesh, coords)
        b = d // n
        out.append(slice(i * b, (i + 1) * b))
    return tuple(out)


def shard(leaf, spec: Spec, mesh: Mesh, coords: Dict[str, int]):
    """The block of ``leaf`` (a tensor or numpy array) that the device at
    ``coords`` holds: a view where the spec splits nothing, a copy
    otherwise (so the whole leaf can be freed)."""
    if len(spec) != len(leaf.shape):
        raise ValueError(f"spec {spec} does not fit a leaf of shape {tuple(leaf.shape)}")
    if all(e is None for e in spec):
        return leaf
    piece = leaf[_block(leaf.shape, spec, mesh, coords)]
    return piece.clone() if isinstance(piece, torch.Tensor) else np.array(piece, copy=True)


def unshard(pieces: Sequence[Any], spec: Spec, mesh: Mesh):
    """The whole leaf from every device's block (``pieces`` in
    ``mesh_coords`` order). Replicated copies must agree: a mismatch is an
    error, not a pick."""
    coords = mesh_coords(mesh)
    if len(pieces) != len(coords):
        raise ValueError(f"{len(pieces)} pieces for a mesh of {len(coords)} devices")
    first = pieces[0]
    shape = tuple(d * split_of(e, mesh, {})[0] for d, e in zip(first.shape, spec))
    if isinstance(first, torch.Tensor):
        full = torch.empty(shape, dtype=first.dtype, device=first.device)
        seen = torch.zeros(shape, dtype=torch.bool, device=first.device)
    else:
        full = np.empty(shape, dtype=first.dtype)
        seen = np.zeros(shape, dtype=bool)
    for c, piece in zip(coords, pieces):
        blk = _block(shape, spec, mesh, c)
        if bool(seen[blk].any()):
            same = (torch.equal(full[blk], piece) if isinstance(piece, torch.Tensor)
                    else np.array_equal(full[blk].view(np.uint8), np.asarray(piece).view(np.uint8)))
            if not same:
                raise ValueError(f"replicated blocks of a leaf with spec {spec} differ")
        full[blk] = piece
        seen[blk] = True
    return full


def shard_tree(tree: Tree, specs: Tree, mesh: Mesh, coords: Dict[str, int]) -> Tree:
    """Every leaf's block for the device at ``coords``."""
    return zip_map(lambda leaf, spec: shard(leaf, spec, mesh, coords), tree, specs)


def unshard_tree(trees: Sequence[Tree], specs: Tree, mesh: Mesh) -> Tree:
    """Every leaf whole from the devices' trees: one tree per device of the
    mesh (a grid's ranks, in ``mesh_coords`` order), or the ``model``
    ranks' trees (``trees[r]``, in rank order) where the devices of the
    other axes hold the same blocks."""
    coords = mesh_coords(mesh)
    if len(trees) == len(coords):
        index = list(range(len(coords)))
    else:
        index = [c.get("model", 0) for c in coords]
    return zip_map(lambda *leaves: unshard([leaves[1 + i] for i in index], leaves[-1], mesh),
                    trees[0], *trees, specs)


def zip_map(fn, tree: Tree, *others: Tree) -> Tree:
    """``fn(leaf, *other_leaves)`` over trees of ``tree``'s structure (a
    spec tree's tuples are leaves there)."""
    if isinstance(tree, dict):
        return {k: zip_map(fn, v, *(o[k] for o in others)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(zip_map(fn, v, *(o[i] for o in others)) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *others)


def is_sharded(spec: Optional[Spec], axis: str = "model", mesh: Optional[Mesh] = None) -> bool:
    """Whether ``spec`` splits a dim over ``axis`` (into more than one
    block: the axis is larger than 1 on ``mesh``, when given)."""
    if spec is None or not any(axis in _entry_axes(e) for e in spec):
        return False
    return mesh is None or mesh.shape.get(axis, 1) > 1


def split_dim(spec: Spec, axis: str, mesh: Mesh) -> Optional[int]:
    """The dim ``spec`` splits over ``axis`` into more than one block, or
    None."""
    if not is_sharded(spec, axis, mesh):
        return None
    return next(i for i, e in enumerate(spec) if axis in _entry_axes(e))


@dataclasses.dataclass(frozen=True)
class _Leaf:
    shape: Tuple[int, ...]
    spec: Spec


@dataclasses.dataclass(frozen=True)
class LeafBlocks:
    """How one device holds the leaves of a parameter tree, in
    ``tree_flatten`` order: each leaf's whole shape and spec on ``mesh``,
    and the device's coordinates. A computation over whole leaves (a clip
    norm, a draw of noise, an absmax) runs on a device's blocks through it."""

    shapes: Tuple[Tuple[int, ...], ...]
    specs: Tuple[Spec, ...]
    mesh: Mesh
    coords: Dict[str, int]

    @classmethod
    def of_params(cls, params: Tree, cfg: ModelConfig, mesh: Mesh,
                  coords: Dict[str, int]) -> "LeafBlocks":
        """The blocks of ``params`` (whole leaves: tensors, meta tensors or
        arrays) by ``param_pspec``."""
        from repro_torch.core.tree import tree_leaves

        leaves = tree_leaves(map_with_path(
            lambda path, x: _Leaf(tuple(x.shape), param_pspec(path, x, cfg, mesh)), params))
        return cls(tuple(x.shape for x in leaves), tuple(x.spec for x in leaves), mesh,
                   dict(coords))

    @property
    def sharded(self) -> List[bool]:
        """Whether the ``model`` ranks hold blocks of each leaf."""
        return self.sharded_over("model")

    def sharded_over(self, axis: str) -> List[bool]:
        """Whether the ranks of ``axis`` (``model`` or ``data``) hold blocks
        of each leaf (the axis larger than 1)."""
        return [is_sharded(s, axis, self.mesh) for s in self.specs]

    def cut(self, i: int, x):
        """The device's block of leaf ``i`` given whole (``x``): over every
        axis the spec names, ``data`` included."""
        return shard(x, self.specs[i], self.mesh, self.coords)
