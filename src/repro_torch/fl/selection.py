"""Client selection (paper Table 7; the port of ``repro.fl.selection``):
Select-All, Random, Oort-style and deadline-aware.

Selectors run in the coordinator/aggregator role (or the launcher when
on-mesh) and return the subset of client ids participating in a round.
They are host code: the random picks come from numpy generators seeded as
the JAX package seeds them (``default_rng(seed + round_idx)``), so a
selector picks the same clients as its JAX twin, round for round.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence

import numpy as np


class SelectAll:
    name = "all"

    def select(self, clients: Sequence[str], k: int, round_idx: int) -> List[str]:
        return list(clients)

    def report(self, client: str, stat_util: float, duration: float) -> None:
        pass


@dataclasses.dataclass
class RandomSelector:
    seed: int = 0
    name: str = "random"

    def select(self, clients: Sequence[str], k: int, round_idx: int) -> List[str]:
        rng = np.random.default_rng(self.seed + round_idx)
        k = min(k, len(clients))
        return list(rng.choice(np.asarray(clients, dtype=object), size=k, replace=False))

    def report(self, client: str, stat_util: float, duration: float) -> None:
        pass


class OortSelector:
    """Oort (Lai et al. 2021), simplified: utility = statistical utility
    (root-sum-squared loss) x (T/duration)^alpha straggler penalty, with an
    epsilon-greedy exploration split and UCB-style staleness bonus."""

    name = "oort"

    def __init__(
        self,
        alpha: float = 2.0,
        epsilon: float = 0.2,
        target_duration: float = 1.0,
        seed: int = 0,
    ) -> None:
        self.alpha = alpha
        self.epsilon = epsilon
        self.target_duration = target_duration
        self.seed = seed
        self._util: Dict[str, float] = {}
        self._dur: Dict[str, float] = {}
        self._last_round: Dict[str, int] = {}

    def report(self, client: str, stat_util: float, duration: float) -> None:
        self._util[client] = float(stat_util)
        self._dur[client] = max(1e-6, float(duration))

    def _score(self, client: str, round_idx: int) -> float:
        util = self._util.get(client, 0.0)
        dur = self._dur.get(client, self.target_duration)
        penalty = (
            (self.target_duration / dur) ** self.alpha if dur > self.target_duration else 1.0
        )
        last = self._last_round.get(client, 0)
        staleness_bonus = math.sqrt(0.1 * math.log(max(round_idx, 1) + 1) / max(1, round_idx - last))
        return util * penalty + staleness_bonus

    def select(self, clients: Sequence[str], k: int, round_idx: int) -> List[str]:
        rng = np.random.default_rng(self.seed + round_idx)
        k = min(k, len(clients))
        explored = [c for c in clients if c not in self._util]
        n_explore = min(len(explored), max(1, int(self.epsilon * k)) if explored else 0)
        exploit_pool = sorted(
            (c for c in clients if c in self._util),
            key=lambda c: self._score(c, round_idx),
            reverse=True,
        )
        chosen = exploit_pool[: k - n_explore]
        if n_explore:
            chosen += list(
                rng.choice(np.asarray(explored, dtype=object), size=n_explore, replace=False)
            )
        # pad from remaining clients if the pools were thin
        for c in clients:
            if len(chosen) >= k:
                break
            if c not in chosen:
                chosen.append(c)
        for c in chosen:
            self._last_round[c] = round_idx
        return list(chosen)[:k]


class DeadlineAwareSelector:
    """Partial-participation selector for the runtime's deadline mode: skip
    clients whose last observed round duration exceeded the straggler
    deadline, but re-probe each after ``probe_every`` rounds so recovered
    clients are re-admitted (mirrors the coordinator's backoff probing)."""

    name = "deadline"

    def __init__(self, deadline: float = 1.0, probe_every: int = 4, seed: int = 0):
        self.deadline = float(deadline)
        self.probe_every = int(probe_every)
        self.seed = seed
        self._dur: Dict[str, float] = {}
        self._last_picked: Dict[str, int] = {}

    def report(self, client: str, stat_util: float, duration: float) -> None:
        self._dur[client] = float(duration)

    def predicted_on_time(self, client: str) -> bool:
        return self._dur.get(client, 0.0) <= self.deadline

    def select(self, clients: Sequence[str], k: int, round_idx: int) -> List[str]:
        k = min(k, len(clients))
        on_time = [c for c in clients if self.predicted_on_time(c)]
        due = [
            c
            for c in clients
            if not self.predicted_on_time(c)
            and round_idx - self._last_picked.get(c, 0) >= self.probe_every
        ]
        # reserve slots for due probes even when the on-time pool fills k,
        # or a recovered straggler would never be observed again
        n_probe = min(len(due), max(1, k // 4)) if due else 0
        chosen = due[:n_probe] + on_time[: k - n_probe]
        # pad from the stragglers if the on-time pool is too thin
        for c in clients:
            if len(chosen) >= k:
                break
            if c not in chosen:
                chosen.append(c)
        for c in chosen:
            self._last_picked[c] = round_idx
        return chosen[:k]


def get_selector(name: str, **kwargs):
    return {
        "all": SelectAll,
        "random": RandomSelector,
        "oort": OortSelector,
        "deadline": DeadlineAwareSelector,
    }[name](**kwargs)
