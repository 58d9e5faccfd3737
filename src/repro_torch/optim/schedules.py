"""Learning-rate schedules: pure functions of a 0-d integer step tensor
returning a float32 0-d tensor (the port of ``repro.optim.schedules``).
Python constants enter in float32, as the JAX package's weak-typed
constants meet its float32 step."""
from __future__ import annotations

import math

import torch

_F32 = torch.float32


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=_F32, device=like.device)


def constant(value: float):
    def fn(step: torch.Tensor) -> torch.Tensor:
        return _f32(value, step)

    return fn


def cosine_decay(peak: float, total_steps: int, floor: float = 0.0):
    def fn(step: torch.Tensor) -> torch.Tensor:
        frac = torch.clamp(step.to(_F32) / _f32(max(1, total_steps), step), 0.0, 1.0)
        cos = torch.cos(_f32(math.pi, step) * frac)
        return _f32(floor, step) + _f32(0.5 * (peak - floor), step) * (_f32(1, step) + cos)

    return fn


def linear_warmup_cosine(peak: float, warmup_steps: int, total_steps: int, floor: float = 0.0):
    cos = cosine_decay(peak, max(1, total_steps - warmup_steps), floor)

    def fn(step: torch.Tensor) -> torch.Tensor:
        s = step.to(_F32)
        warm = _f32(peak, step) * s / _f32(max(1, warmup_steps), step)
        return torch.where(s < _f32(warmup_steps, step), warm, cos(step - warmup_steps))

    return fn
