"""The sharding profile read by the MoE block (the port of
``repro.models.shard_ctx``).

The launcher activates a profile around a step (``launch.steps``); model
code reads it. The JAX package's profile also carries layouts for its
sharding constraints; the port runs a model on one card, pins no layout and
carries none. What it carries is what changes the result: ``min_blocks``
(the devices the MoE block dimension spans) decides how many routing blocks
``moe_apply`` cuts the tokens into, and so each block's capacity and which
tokens drop.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator, Optional, Tuple

_PROFILE: contextvars.ContextVar = contextvars.ContextVar("shard_profile", default=None)


def get_profile() -> Optional[dict]:
    return _PROFILE.get()


@contextlib.contextmanager
def shard_profile(batch_axes: Tuple[str, ...], expert_axis: str = "model",
                  min_blocks: int = 1) -> Iterator[None]:
    """Activate a profile for the calls made inside the block.

    ``batch_axes``: mesh axes the flat MoE block dim spans. ``min_blocks``:
    devices the MoE block dim shards over."""
    token = _PROFILE.set({"batch": tuple(batch_axes), "expert": expert_axis,
                          "min_blocks": int(min_blocks)})
    try:
        yield
    finally:
        _PROFILE.reset(token)
