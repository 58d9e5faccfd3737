"""Federated datasets (the port of ``repro.data.datasets``): the synthetic
classification shards and the synthetic language-model streams, as numpy
arrays made by the JAX package's numpy calls (equal arrays for the same
names and seeds); a role or a step moves them to its device.

Flame registers dataset *metadata* (realm + url); the actual payload loading
is pluggable. For the reproduction we generate synthetic data deterministic
in the dataset name, so every worker materializes the same shard from
metadata alone — the same decoupling the paper's url field provides.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Iterator, List, Optional

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


def dirichlet_partition(
    num_clients: int,
    alpha: float = 0.5,
    num_classes: int = 10,
    samples_per_client: int = 128,
    num_features: int = 32,
    prefix: str = "client",
    seed: int = 0,
) -> List[FederatedDataset]:
    """Label-distribution-skewed federation (the standard Dirichlet split):
    client ``i`` draws its class mix from ``Dirichlet(alpha)`` with numpy's
    generator seeded by ``seed``, as the JAX package does, so the skews and
    the shards are equal to its own."""
    rng = np.random.default_rng(seed)
    shards = []
    for i in range(num_clients):
        skew = rng.dirichlet(np.full(num_classes, alpha))
        shards.append(
            synthetic_classification(
                f"{prefix}-{i}",
                num_samples=samples_per_client,
                num_features=num_features,
                num_classes=num_classes,
                class_skew=skew,
            )
        )
    return shards


def synthetic_lm_shards(
    num_clients: int,
    seq_len: int = 128,
    num_seqs: int = 64,
    vocab_size: int = 1024,
    prefix: str = "corpus",
) -> List[FederatedDataset]:
    """Synthetic token shards with client-specific n-gram structure (so the
    LM has something to learn and clients are non-IID)."""
    shards = []
    for i in range(num_clients):
        rng = np.random.default_rng(_seed_of(f"{prefix}-{i}"))
        # client-specific bigram transition sparsity
        base = rng.integers(0, vocab_size, size=(num_seqs, seq_len + 1))
        stride = 2 + (i % 5)
        base[:, 1::2] = (base[:, 0:-1:2] * stride + i) % vocab_size  # learnable pattern
        x = base[:, :-1].astype(np.int32)
        y = base[:, 1:].astype(np.int32)
        shards.append(FederatedDataset(name=f"{prefix}-{i}", x=x, y=y))
    return shards


def synthetic_lm_batches(vocab: int, batch: int, seq: int, seed: int = 0) -> Iterator[np.ndarray]:
    """Infinite iterator of (batch, seq) int32 token arrays with a learnable
    bigram pattern (odd positions are a deterministic function of the
    previous token), shared across batches."""
    rng = np.random.default_rng(seed)
    while True:
        toks = rng.integers(0, vocab, size=(batch, seq + 1))
        toks[:, 1::2] = (toks[:, 0:-1:2] * 3 + 7) % vocab
        yield toks[:, :seq].astype(np.int32)
