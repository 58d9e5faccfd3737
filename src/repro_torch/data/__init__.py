"""Federated datasets and the batching pipeline (the port of ``repro.data``)."""
from repro_torch.data.datasets import (
    FederatedDataset,
    dirichlet_partition,
    synthetic_classification,
    synthetic_lm_batches,
    synthetic_lm_shards,
)
from repro_torch.data.pipeline import BatchPipeline, lm_batches

__all__ = [
    "FederatedDataset",
    "dirichlet_partition",
    "synthetic_classification",
    "synthetic_lm_batches",
    "synthetic_lm_shards",
    "BatchPipeline",
    "lm_batches",
]
