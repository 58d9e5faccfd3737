"""Differential privacy for client updates (the port of ``repro.fl.privacy``).

Per-update clipping + Gaussian noise (DP-FedAvg, McMahan et al. 2018), on
the device of the update's leaves. The noise is drawn from an explicit
``torch.Generator``; ``jax.random`` and torch streams differ, so a caller
that must reproduce the JAX package's noise passes its standard-normal
draws in (``noise``).

On a rank of a model group (``blocks``: a ``launch.sharding.LeafBlocks``,
the leaves being the rank's blocks), the clip norm is the whole tree's:
the sum of the squares of the blocks is summed over the group and the
replicated leaves are counted once; and each leaf's noise is drawn whole,
in the one-process order, and cut to the rank's block, so every rank's
draws are the one-process run's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

Tree = Any


@dataclasses.dataclass(frozen=True)
class DPConfig:
    clip_norm: float = 1.0
    noise_multiplier: float = 0.0  # sigma = noise_multiplier * clip_norm / n

    def sigma(self, num_clients: int) -> float:
        return self.noise_multiplier * self.clip_norm / max(1, num_clients)


def global_norm(tree: Tree, sharded: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """float32 ``sqrt(sum over leaves of sum(x**2))``, leaves in tree order.
    With ``sharded`` (a model rank's blocks: whether leaf i is a block), the
    blocks' sum over the group plus the replicated leaves' sum."""
    from repro_torch.launch import tensor_parallel as tp

    total = own = None
    for i, x in enumerate(tree_leaves(tree)):
        sq = torch.sum(torch.square(x.to(torch.float32)))
        if sharded is not None and sharded[i]:
            own = sq if own is None else own + sq
        else:
            total = sq if total is None else total + sq
    if own is not None:
        own = tp.all_reduce_sum(own)
        total = own if total is None else own + total
    if total is None:
        total = torch.zeros((), dtype=torch.float32)
    return torch.sqrt(total)


def clip_by_global_norm(tree: Tree, clip_norm: float,
                        sharded: Optional[Sequence[bool]] = None) -> Tuple[Tree, torch.Tensor]:
    norm = global_norm(tree, sharded)
    floor = torch.tensor(1e-12, dtype=torch.float32, device=norm.device)
    clip = torch.tensor(clip_norm, dtype=torch.float32, device=norm.device)
    scale = torch.clamp(clip / torch.maximum(norm, floor), max=1.0)
    return tree_map(lambda x: x * scale.to(x.dtype), tree), norm


def clip_and_noise(
    tree: Tree,
    cfg: DPConfig,
    generator: Optional[torch.Generator] = None,
    num_clients: int = 1,
    noise: Optional[Sequence[torch.Tensor]] = None,
    blocks: Any = None,
) -> Tree:
    """Clip a client delta to ``clip_norm`` and add Gaussian noise calibrated
    for ``num_clients``-way aggregation.

    The noise of leaf i is ``sigma * z_i``: ``z_i`` standard normal float32,
    ``noise[i]`` where given (leaves in tree order), else drawn from
    ``generator`` on the leaf's device. With ``blocks`` (a model rank's
    ``LeafBlocks``), ``z_i`` is drawn (or given) whole and cut to the
    rank's block."""
    clipped, _ = clip_by_global_norm(tree, cfg.clip_norm,
                                     None if blocks is None else blocks.sharded)
    if cfg.noise_multiplier <= 0.0:
        return clipped
    sigma = cfg.sigma(num_clients)
    leaves, treedef = tree_flatten(clipped)
    if noise is not None and len(noise) != len(leaves):
        raise ValueError(f"{len(noise)} noise arrays for {len(leaves)} leaves")
    noised = []
    for i, x in enumerate(leaves):
        shape = x.shape if blocks is None else blocks.shapes[i]
        if noise is not None:
            z = noise[i] if isinstance(noise[i], torch.Tensor) else torch.from_numpy(
                np.array(noise[i], dtype=np.float32))
            z = z.to(device=x.device, dtype=torch.float32)
        else:
            z = torch.randn(shape, generator=generator, dtype=torch.float32, device=x.device)
        if blocks is not None:
            z = blocks.cut(i, z)
        noised.append(x + (sigma * z).to(x.dtype))
    return tree_unflatten(treedef, noised)
