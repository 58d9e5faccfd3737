"""Reference workload for cross-deployment equivalence (the port of
``repro.transport.conformance``'s ``SeededSGDTrainer``; the conformance
suite itself is not ported yet)."""
from __future__ import annotations

import torch

from repro_torch.core.roles import Trainer
from repro_torch.data.datasets import synthetic_classification


class SeededSGDTrainer(Trainer):
    """Deterministic softmax-regression trainer, seeded by the worker's
    dataset name: one gradient step per round, as the JAX package's numpy
    trainer takes. Its products are plain ``torch.matmul`` on the job's
    device, so against the JAX package it agrees within float32 rounding,
    not bit for bit."""

    def load_data(self) -> None:
        d = synthetic_classification(self.ctx.worker.dataset or "d0")
        self.x = torch.from_numpy(d.x).to(self.ctx.device)
        self.y = torch.from_numpy(d.y).to(self.ctx.device, torch.int64)
        self.num_samples = d.num_samples

    def train(self) -> None:
        if self.weights is None:
            return
        w = self.weights["w"].to(torch.float32).clone()
        b = self.weights["b"].to(torch.float32).clone()
        z = self.x @ w + b
        z = z - z.amax(dim=1, keepdim=True)
        e = torch.exp(z)
        p = e / e.sum(dim=1, keepdim=True)
        onehot = torch.eye(w.shape[1], dtype=torch.float32, device=w.device)[self.y]
        rows = torch.tensor(float(self.x.shape[0]), dtype=torch.float32, device=w.device)
        g = (p - onehot) / rows
        w -= 0.2 * (self.x.T @ g)
        b -= 0.2 * g.sum(dim=0)
        self.weights = {"w": w, "b": b}
