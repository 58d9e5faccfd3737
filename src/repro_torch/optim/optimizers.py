"""Local (client-side) optimizers, optax-style but self-contained (the port
of ``repro.optim.optimizers``).

An ``Optimizer`` is an (init, update) pair over tensor trees. Server-side
FL optimizers live in ``repro_torch.fl.strategies``. Every product and sum
runs in the dtype the JAX package's promotion gives it, written out: a
Python constant meets a tensor in that tensor's dtype (a 0-d tensor of it),
the learning rate is a float32 0-d tensor, so a bf16 gradient's update is
float32 (``-lr * g``), and float32 roots are correctly rounded
(``fl.strategies._sqrt``), as XLA takes them.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple, Union

import torch

from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.fl.strategies import _sqrt

Tree = Any
Schedule = Callable[[torch.Tensor], torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Tree], Tree]
    update: Callable[[Tree, Tree, Tree], Tuple[Tree, Tree]]  # (grads, state, params)


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """A Python constant as a 0-d tensor of ``like``'s dtype and device (a
    JAX weak-typed constant)."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def _lr_at(lr: Union[float, Schedule], step: torch.Tensor) -> torch.Tensor:
    if callable(lr):
        return lr(step)
    return torch.tensor(lr, dtype=torch.float32, device=step.device)


def _times(lr_t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``-lr_t * x`` with JAX's promotion: float32 for a narrower ``x``."""
    dtype = torch.promote_types(lr_t.dtype, x.dtype)
    return (-lr_t).to(dtype) * x.to(dtype)


def _step0(params: Tree) -> torch.Tensor:
    """The step counter, a 0-d int32 tensor on the parameters' device."""
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else torch.device("cpu")
    return torch.zeros((), dtype=torch.int32, device=device)


def sgd(lr: Union[float, Schedule] = 1e-2, momentum: float = 0.0) -> Optimizer:
    def init(params: Tree) -> Tree:
        mom = tree_map(torch.zeros_like, params) if momentum else None
        return {"step": _step0(params), "mom": mom}

    def update(grads: Tree, state: Tree, params: Tree) -> Tuple[Tree, Tree]:
        step = state["step"]
        lr_t = _lr_at(lr, step)
        if momentum:
            mom = tree_map(lambda m, g: _const(momentum, m) * m + g.to(m.dtype), state["mom"],
                           grads)
            upd = tree_map(lambda m: _times(lr_t, m), mom)
            return upd, {"step": step + 1, "mom": mom}
        upd = tree_map(lambda g: _times(lr_t, g), grads)
        return upd, {"step": step + 1, "mom": None}

    return Optimizer(init, update)


def adamw(
    lr: Union[float, Schedule] = 3e-4,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
) -> Optimizer:
    def init(params: Tree) -> Tree:
        return {
            "step": _step0(params),
            "m": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
            "v": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
        }

    def update(grads: Tree, state: Tree, params: Tree) -> Tuple[Tree, Tree]:
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        f32 = torch.float32
        m = tree_map(lambda m_, g: _const(b1, m_) * m_ + _const(1 - b1, m_) * g.to(f32),
                     state["m"], grads)
        v = tree_map(lambda v_, g: _const(b2, v_) * v_
                     + _const(1 - b2, v_) * torch.square(g.to(f32)), state["v"], grads)
        s = step.to(f32)
        one = torch.ones((), dtype=f32, device=s.device)
        bc1 = one - torch.pow(torch.tensor(b1, dtype=f32, device=s.device), s)
        bc2 = one - torch.pow(torch.tensor(b2, dtype=f32, device=s.device), s)

        def leaf(p, m_, v_):
            adam = (m_ / bc1) / (_sqrt(v_ / bc2) + _const(eps, v_))
            return _times(lr_t, adam + _const(weight_decay, v_) * p.to(f32)).to(p.dtype)

        upd = tree_map(leaf, params, m, v)
        return upd, {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def get_optimizer(name: str, **kwargs: Any) -> Optimizer:
    return {"sgd": sgd, "adamw": adamw}[name](**kwargs)
