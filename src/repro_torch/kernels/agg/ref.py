"""Plain PyTorch versions of the aggregation kernels.

Each function does the same operations in the same order as its kernel in
``csrc/agg.cu``. The kernel wrappers (``kernel.py``) run these for tensors
on the CPU, and ``chip_smoke.py`` holds the kernels against them on the card.

Division trap: on CUDA, ``tensor / python_float`` is lowered to a multiply
by the reciprocal, which is not an IEEE divide. Every divide here therefore
divides by a 0-d float32 tensor on the tensor's own device. A multiply by a
Python float is a plain float32 multiply on both devices.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch


def exact_fold(d: torch.Tensor, w: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """``(((d0*w0 + d1*w1) + ...) + d_{C-1}*w_{C-1}) / den``: (C, N) -> (N,) f32.

    The accumulator starts from client 0's product, not from zeros, so an
    all -0.0 column keeps its sign."""
    scaled = d.to(torch.float32) * w.to(torch.float32)[:, None]
    acc = scaled[0]
    for c in range(1, d.shape[0]):
        acc = acc + scaled[c]
    return acc / den[0]


def exact_fold_into(
    acc: Optional[torch.Tensor], d: torch.Tensor, w: float
) -> torch.Tensor:
    """Streaming fold of one update: ``d*w`` on the first, else ``acc += d*w``
    in place."""
    scaled = d * w
    if acc is None:
        return scaled
    return acc.add_(scaled)


def exact_fold_into_tree(
    accs: Optional[Sequence[torch.Tensor]], ds: Sequence[torch.Tensor], w: float
) -> List[torch.Tensor]:
    """The streaming fold of one update tree's leaves: ``exact_fold_into``
    leaf by leaf, in leaf order."""
    if accs is None:
        return [exact_fold_into(None, d, w) for d in ds]
    return [exact_fold_into(a, d, w) for a, d in zip(accs, ds)]


def exact_divide(
    x: torch.Tensor, den: float, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """``x / den`` as an IEEE divide; ``out`` may be ``x`` (in place)."""
    den_t = torch.tensor(den, dtype=torch.float32, device=x.device)
    if out is None:
        return x / den_t
    return torch.div(x, den_t, out=out)


def weighted_aggregate(
    d: torch.Tensor, w: torch.Tensor, den: torch.Tensor
) -> torch.Tensor:
    """``(sum_c w[c]*d[c]) / den`` in client order: (C, N) -> (N,) f32. The
    kernel may contract each multiply-add into an FMA; this version does not."""
    d32 = d.to(torch.float32)
    w32 = w.to(torch.float32)
    acc = d32[0] * w32[0]
    for c in range(1, d.shape[0]):
        acc = acc + d32[c] * w32[c]
    return acc / den[0]
