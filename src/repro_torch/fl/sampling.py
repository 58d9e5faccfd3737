"""Sample selection (paper Table 7; the port of ``repro.fl.sampling``):
Select-All and FedBalancer.

FedBalancer (Shin et al., MobiSys'22), simplified: each client keeps
per-sample losses and trains on samples whose loss falls inside a moving
[lt, ut] window, trading epochs for informative samples under a deadline.
The losses may be a torch tensor on any device or a numpy array; the
thresholds and the picks are taken on the host with numpy's quantile and
sort, as the JAX package takes them, so the returned indices (a numpy
int64 array) are equal to its own.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch


def _host(losses: Any) -> np.ndarray:
    if isinstance(losses, torch.Tensor):
        return losses.detach().cpu().numpy()
    return np.asarray(losses)


class SelectAllSampler:
    name = "all"

    def select(self, losses: Any, round_idx: int) -> np.ndarray:
        return np.arange(_host(losses).shape[0])

    def update_thresholds(self, losses: Any) -> None:
        pass


@dataclasses.dataclass
class FedBalancerSampler:
    """Loss-window sample selection with threshold ratio annealing."""

    lt_ratio: float = 0.0  # low-threshold percentile (anneals upward)
    ut_ratio: float = 1.0  # upper percentile
    step: float = 0.05
    min_keep: int = 8
    name: str = "fedbalancer"

    def __post_init__(self) -> None:
        self._lt: Optional[float] = None
        self._ut: Optional[float] = None

    def update_thresholds(self, losses: Any) -> None:
        losses = _host(losses)
        if losses.size == 0:
            return
        self._lt = float(np.quantile(losses, min(0.95, self.lt_ratio)))
        self._ut = float(np.quantile(losses, max(0.05, self.ut_ratio)))
        # anneal: trust the model more as training progresses
        self.lt_ratio = min(0.5, self.lt_ratio + self.step)

    def select(self, losses: Any, round_idx: int) -> np.ndarray:
        losses = _host(losses)
        if self._lt is None or self._ut is None:
            self.update_thresholds(losses)
        if self._lt is None or self._ut is None:
            raise ValueError("FedBalancerSampler.select needs at least one loss")
        mask = (losses >= self._lt) & (losses <= self._ut)
        idx = np.nonzero(mask)[0]
        if idx.size < self.min_keep:
            idx = np.argsort(losses)[::-1][: self.min_keep]
        return idx
