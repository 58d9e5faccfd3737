"""Federated datasets (the port of ``repro.data.datasets``): the synthetic
classification shards, as numpy arrays; a role moves them to its device in
``load_data``.

Flame registers dataset *metadata* (realm + url); the actual payload loading
is pluggable. For the reproduction we generate synthetic data deterministic
in the dataset name, so every worker materializes the same shard from
metadata alone — the same decoupling the paper's url field provides.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import numpy as np


def _seed_of(name: str) -> int:
    return int.from_bytes(hashlib.sha256(name.encode()).digest()[:4], "little")


@dataclasses.dataclass
class FederatedDataset:
    """One client's shard."""

    name: str
    x: np.ndarray
    y: np.ndarray

    @property
    def num_samples(self) -> int:
        return int(self.x.shape[0])


def synthetic_classification(
    name: str,
    num_samples: int = 128,
    num_features: int = 32,
    num_classes: int = 10,
    class_skew: Optional[np.ndarray] = None,
) -> FederatedDataset:
    """Linear-separable-ish synthetic classification shard (MNIST stand-in).

    A shared per-class prototype matrix (fixed seed) + per-shard noise, so
    shards are IID-consistent but clients see different samples; ``class_skew``
    induces label non-IID-ness.
    """
    proto_rng = np.random.default_rng(1234)
    prototypes = proto_rng.normal(size=(num_classes, num_features)).astype(np.float32)
    rng = np.random.default_rng(_seed_of(name))
    p = class_skew if class_skew is not None else np.full(num_classes, 1.0 / num_classes)
    y = rng.choice(num_classes, size=num_samples, p=p / p.sum())
    x = prototypes[y] + 0.8 * rng.normal(size=(num_samples, num_features)).astype(
        np.float32
    )
    return FederatedDataset(name=name, x=x.astype(np.float32), y=y.astype(np.int32))
