"""Batching pipeline (the port of ``repro.data.pipeline``): deterministic
shuffling and epoch iteration, numpy-side, so a step receives ready arrays
and moves them to its device. The batches equal the JAX package's for the
same shards and seed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Sequence

import numpy as np

from repro_torch.data.datasets import FederatedDataset


@dataclasses.dataclass
class BatchPipeline:
    dataset: FederatedDataset
    batch_size: int
    seed: int = 0
    drop_remainder: bool = True

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self.epoch(0)

    def epoch(self, epoch_idx: int) -> Iterator[Dict[str, np.ndarray]]:
        n = self.dataset.num_samples
        rng = np.random.default_rng(self.seed + epoch_idx)
        order = rng.permutation(n)
        stop = (n // self.batch_size) * self.batch_size if self.drop_remainder else n
        for i in range(0, stop, self.batch_size):
            idx = order[i : i + self.batch_size]
            yield {"x": self.dataset.x[idx], "y": self.dataset.y[idx]}

    def sample(self, batch_idx: int = 0) -> Dict[str, np.ndarray]:
        for i, b in enumerate(self.epoch(0)):
            if i == batch_idx:
                return b
        raise IndexError(batch_idx)


def lm_batches(
    shards: Sequence[FederatedDataset], batch_size: int, seed: int = 0
) -> Iterator[Dict[str, np.ndarray]]:
    """Round-robin over client shards producing {tokens, labels} batches."""
    pipes = [BatchPipeline(s, batch_size, seed=seed) for s in shards]
    iters = [iter(p.epoch(0)) for p in pipes]
    epoch = [0] * len(pipes)
    i = 0
    while True:
        k = i % len(pipes)
        try:
            b = next(iters[k])
        except StopIteration:
            epoch[k] += 1
            iters[k] = iter(pipes[k].epoch(epoch[k]))
            b = next(iters[k])
        yield {"tokens": b["x"], "labels": b["y"]}
        i += 1
