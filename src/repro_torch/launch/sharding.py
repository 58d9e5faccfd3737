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

The recurrent sub-blocks compute on slices of their value columns
(``recurrent_split``): the SSD on a slice of every head's P, the sLSTM on a
slice of d. Three leaves whose ``model`` block by the rule is a contiguous
run of columns (rows) are cut there instead into that slice of each group
of the dim: the SSD's ``in_xz`` (its 2H groups of P columns: the value
path's heads, then the gate's) and ``out`` (its H groups of P rows), and
the sLSTM's ``gates`` (its four groups of d columns: i, f, z, o). Their
spec entry is ``InGroups("model", groups)``, a string equal to
``"model"``: the spec is the JAX package's, the block has the rule's size,
and ``block_view`` (under ``shard``, ``unshard`` and every cut of a whole
leaf) maps it to its positions in the whole leaf.
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


class InGroups(str):
    """A spec entry that splits its dim over an axis in ``groups`` equal
    runs, each cut alike: the dim read as (groups, n), a device's block is
    its block of n in every group. It equals the axis's name."""

    groups: int

    def __new__(cls, axis: str, groups: int):
        self = super().__new__(cls, axis)
        self.groups = groups
        return self

    def __reduce__(self):
        return InGroups, (str(self), self.groups)

    def __repr__(self) -> str:
        return f"InGroups({str(self)!r}, {self.groups})"


def recurrent_split(cfg: ModelConfig, kind: str, m: int) -> bool:
    """Whether a ``model`` axis of ``m`` splits the recurrent sub-block
    ``kind`` (``"ssd"``: every head's P value columns; ``"slstm"``: its d)
    into a slice a rank: where m > 1 divides that width. Then its leaves
    are cut in groups (``InGroups``) and its state on that dim; else the
    sub-block computes replicated."""
    if kind == "ssd":
        d_i, H, _ = cfg.ssd_dims
        width = d_i // H
    else:
        width = cfg.d_model
    return m > 1 and width % m == 0


def _in_groups(names: Tuple[str, ...], spec: Spec, cfg: ModelConfig, mesh: Mesh) -> Spec:
    """``spec`` with the ``model`` entry of a recurrent leaf cut in groups
    (``InGroups``) where ``recurrent_split`` splits its sub-block."""
    parent, owner = names[-2], names[-3] if len(names) >= 3 else ""
    m = mesh.shape.get("model", 1)
    _, H, _ = cfg.ssd_dims
    if owner == "ssd" and parent in ("in_xz", "out"):
        dim, groups, kind = (-1, 2 * H, "ssd") if parent == "in_xz" else (-2, H, "ssd")
    elif parent == "gates":
        dim, groups, kind = -1, 4, "slstm"
    else:
        return spec
    if spec[dim] != "model" or not recurrent_split(cfg, kind, m):
        return spec
    out = list(spec)
    out[dim] = InGroups("model", groups)
    return tuple(out)


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
            return _in_groups(names, _guard((fsdp, "model"), shape, mesh), cfg, mesh)
        if parent in _ROW_PARENTS:
            return _in_groups(names, _guard(("model", fsdp), shape, mesh), cfg, mesh)
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


def block_view(x, spec: Spec, mesh: Mesh, coords: Dict[str, int]):
    """The block of ``x`` (a tensor or numpy array) that the device at
    ``coords`` holds, as a view of ``x``: each dim its slice, a dim cut in
    groups (``InGroups``) read as (groups, n) and sliced on n, left as
    those two dims. This is the one map from a block to its positions in
    the whole leaf."""
    idx = []
    for d, e in zip(x.shape, spec):
        n, i = split_of(e, mesh, coords)
        b = d // n
        idx.append(slice(None) if isinstance(e, InGroups) else slice(i * b, (i + 1) * b))
    x = x[tuple(idx)]
    # from the last dim, so that each split leaves the earlier dims in place
    for k in reversed(range(len(spec))):
        if isinstance(spec[k], InGroups):
            n, i = split_of(spec[k], mesh, coords)
            g = spec[k].groups
            b = x.shape[k] // g // n
            x = x.reshape(tuple(x.shape[:k]) + (g, x.shape[k] // g) + tuple(x.shape[k + 1:]))
            x = x[(slice(None),) * (k + 1) + (slice(i * b, (i + 1) * b),)]
    return x


def shard(leaf, spec: Spec, mesh: Mesh, coords: Dict[str, int]):
    """The block of ``leaf`` (a tensor or numpy array) that the device at
    ``coords`` holds: a view where the spec splits nothing, a copy
    otherwise (so the whole leaf can be freed)."""
    if len(spec) != len(leaf.shape):
        raise ValueError(f"spec {spec} does not fit a leaf of shape {tuple(leaf.shape)}")
    if all(e is None for e in spec):
        return leaf
    piece = block_view(leaf, spec, mesh, coords)
    shape = shard_shape(leaf.shape, spec, mesh)
    if isinstance(piece, torch.Tensor):
        return piece.clone(memory_format=torch.contiguous_format).reshape(shape)
    return np.array(piece, copy=True, order="C").reshape(shape)


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
        blk, hit = block_view(full, spec, mesh, c), block_view(seen, spec, mesh, c)
        piece = piece.reshape(blk.shape)
        if bool(hit.any()):
            same = (torch.equal(blk, piece) if isinstance(piece, torch.Tensor)
                    else np.array_equal(np.ascontiguousarray(blk).view(np.uint8),
                                        np.ascontiguousarray(piece).view(np.uint8)))
            if not same:
                raise ValueError(f"replicated blocks of a leaf with spec {spec} differ")
        blk[...] = piece
        hit[...] = True
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
