"""The sharding profile shared by model modules (the port of
``repro.models.shard_ctx``).

The launcher activates a profile around a step (``launch.steps``); model
code reads it. The profile is the JAX package's: the batch axes, the expert
axis, ``min_blocks`` (the devices the MoE block dimension spans, which
decides how many routing blocks ``moe_apply`` cuts the tokens into, and so
each block's capacity and which tokens drop), the ``act`` and ``stash``
layouts and the mesh's ``axis_sizes``.

``constrain``, ``pin_activation`` and ``pin_stash`` return their input. In
the JAX package they pin GSPMD's layouts of activations (batch over the
batch axes, sequence over ``model`` in the stash); in the port activations
are replicated within the model group (``launch.tensor_parallel``: each
rank holds the whole batch, its block of the parameters, and calls the
collectives itself), so there is no layout to pin. The model code calls
them where the JAX package does, so the two read alike.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator, Optional, Tuple

import torch

_PROFILE: contextvars.ContextVar = contextvars.ContextVar("shard_profile", default=None)


def get_profile() -> Optional[dict]:
    return _PROFILE.get()


@contextlib.contextmanager
def shard_profile(batch_axes: Tuple[str, ...], expert_axis: str = "model",
                  min_blocks: int = 1, act=None, stash=None,
                  axis_sizes=None) -> Iterator[None]:
    """Activate a profile for the calls made inside the block.

    ``batch_axes``: mesh axes the flat MoE block dim spans. ``min_blocks``:
    devices the MoE block dim shards over. ``act`` / ``stash``: per-dim
    axes of (B, S, d) activations in the compute and stash layouts.
    ``axis_sizes``: {axis: size}."""
    token = _PROFILE.set({"batch": tuple(batch_axes), "expert": expert_axis,
                          "min_blocks": int(min_blocks), "act": act, "stash": stash,
                          "axis_sizes": dict(axis_sizes or {})})
    try:
        yield
    finally:
        _PROFILE.reset(token)


def constrain(t: torch.Tensor, spec) -> torch.Tensor:
    """``t`` itself: the port keeps no GSPMD layout to constrain."""
    del spec
    return t


def pin_activation(h: torch.Tensor) -> torch.Tensor:
    """``h`` itself: activations are replicated within the model group."""
    return h


def pin_stash(h: torch.Tensor) -> torch.Tensor:
    """``h`` itself: scan carries are replicated within the model group."""
    return h
