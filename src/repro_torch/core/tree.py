"""A small pytree helper with ``jax.tree_util``'s flatten order.

Weight trees are nested containers of leaves (``torch.Tensor``s, numpy
arrays, Python scalars). Everything that depends on leaf order — byte
accounting, fold order, stacking — must see the leaves in the order the JAX
package sees them, so the rules are jax's:

* ``dict`` and ``defaultdict``: children in sorted-key order;
* ``OrderedDict``: children in insertion order;
* ``list``, ``tuple`` and namedtuples: children in order;
* ``None``: an empty subtree, not a leaf;
* anything else (tensors, arrays, Python and numpy scalars) is a leaf.

``torch.utils._pytree`` is private and keeps dict insertion order, so the
port does not use it.
"""
from __future__ import annotations

import collections
from typing import Any, Callable, List, Tuple

_LEAF = "leaf"


class TreeDef:
    """The structure of a tree with its leaves taken out."""

    __slots__ = ("kind", "meta", "children")

    def __init__(self, kind: str, meta: Any = None, children: Tuple["TreeDef", ...] = ()):
        self.kind = kind
        self.meta = meta
        self.children = children

    @property
    def num_leaves(self) -> int:
        if self.kind == _LEAF:
            return 1
        return sum(c.num_leaves for c in self.children)

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, TreeDef)
            and self.kind == other.kind
            and self.meta == other.meta
            and self.children == other.children
        )

    def __hash__(self) -> int:
        return hash((self.kind, self.children))

    def __repr__(self) -> str:
        if self.kind == _LEAF:
            return "*"
        return f"{self.kind}{self.meta if self.meta is not None else ''}{list(self.children)}"


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _children(node: Any) -> Tuple[str, Any, List[Any]]:
    """(kind, meta, children) of a container node, or ``(_LEAF, None, [])``."""
    if node is None:
        return "none", None, []
    t = type(node)
    if t is dict:
        keys = tuple(sorted(node))
        return "dict", keys, [node[k] for k in keys]
    if t is collections.defaultdict:
        keys = tuple(sorted(node))
        return "defaultdict", (node.default_factory, keys), [node[k] for k in keys]
    if t is collections.OrderedDict:
        keys = tuple(node)
        return "ordereddict", keys, [node[k] for k in keys]
    if t is list:
        return "list", len(node), list(node)
    if t is tuple:
        return "tuple", len(node), list(node)
    if _is_namedtuple(node):
        return "namedtuple", t, list(node)
    return _LEAF, None, []


# The walks are module functions that take their list or iterator as an
# argument. A nested function that calls itself is a reference cycle, and
# one that also captures the leaves keeps them (a model's parameters, on the
# card) alive until the garbage collector's next full pass.
def _flatten_into(node: Any, leaves: List[Any]) -> TreeDef:
    kind, meta, kids = _children(node)
    if kind == _LEAF:
        leaves.append(node)
        return TreeDef(_LEAF)
    return TreeDef(kind, meta, tuple(_flatten_into(k, leaves) for k in kids))


def tree_flatten(tree: Any) -> Tuple[List[Any], TreeDef]:
    leaves: List[Any] = []
    return leaves, _flatten_into(tree, leaves)


def _build(td: TreeDef, it: Any) -> Any:
    if td.kind == _LEAF:
        return next(it)
    kids = [_build(c, it) for c in td.children]
    if td.kind == "none":
        return None
    if td.kind == "dict":
        return dict(zip(td.meta, kids))
    if td.kind == "defaultdict":
        factory, keys = td.meta
        return collections.defaultdict(factory, zip(keys, kids))
    if td.kind == "ordereddict":
        return collections.OrderedDict(zip(td.meta, kids))
    if td.kind == "list":
        return kids
    if td.kind == "tuple":
        return tuple(kids)
    return td.meta(*kids)  # namedtuple


def tree_unflatten(treedef: TreeDef, leaves: List[Any]) -> Any:
    it = iter(leaves)
    out = _build(treedef, it)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("too many leaves for the tree structure")
    return out


def tree_leaves(tree: Any) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over corresponding leaves of ``tree`` and ``rest``.

    Raises ``ValueError`` when a tree of ``rest`` has another structure, as
    ``jax.tree_util.tree_map`` does."""
    leaves, treedef = tree_flatten(tree)
    others = []
    for r in rest:
        r_leaves, r_def = tree_flatten(r)
        if r_def != treedef:
            raise ValueError(f"tree structures differ: {treedef!r} vs {r_def!r}")
        others.append(r_leaves)
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])
