"""Quickstart: define a TAG, register data, run a federated job in-process.

This is the paper's user programming model end to end:
  1. pick a topology template (classical FL),
  2. write a trainer by subclassing ``Trainer`` (Fig. 5),
  3. register datasets as metadata,
  4. expand + run, entirely on this machine (Flame-in-a-box style), on the
     card unless told otherwise.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import numpy as np
import torch

from repro_torch.convert import tree_to_numpy
from repro_torch.core.expansion import JobSpec
from repro_torch.core.roles import Trainer
from repro_torch.core.runtime import run_job
from repro_torch.core.tag import DatasetSpec
from repro_torch.core.topologies import classical_fl
from repro_torch.examples import cli, job_device


# ----- 1. the user's ML logic (Fig. 5: implement 3 small functions) ------- #
class MeanTrainer(Trainer):
    """Each client pulls its local data's mean into the shared model."""

    def load_data(self):
        rng = np.random.default_rng(abs(hash(self.ctx.worker.dataset)) % 2**32)
        data = rng.normal(loc=3.0, scale=1.0, size=(256, 4)).astype(np.float32)
        # the local mean is data preparation: numpy's float32 mean, moved once
        self.local_mean = torch.from_numpy(data.mean(axis=0)).to(self.ctx.device)
        self.num_samples = len(data)

    def train(self):
        if self.weights is None:
            return
        self.weights = {"mu": 0.5 * self.weights["mu"] + 0.5 * self.local_mean}


def main(device=None) -> dict:
    dev = job_device(device)
    # ----- 2. the topology is a TAG; templates ship with the library ------ #
    tag = classical_fl()
    print("TAG:", tag.to_json()[:200], "...")

    # ----- 3. datasets register as metadata (realm + name), never as data - #
    datasets = tuple(DatasetSpec(name=f"clinic-{i}", realm="eu") for i in range(8))

    job = JobSpec(
        tag=tag,
        datasets=datasets,
        hyperparams={"rounds": 5, "init_weights": {"mu": np.zeros(4, np.float32)}},
    )

    # ----- 4. expand + run (the controller's job, in-process here) -------- #
    result = run_job(job, device=dev, program_overrides={"trainer": MeanTrainer}, timeout=60)
    assert not result.errors, result.errors
    weights = tree_to_numpy(result.global_weights())
    mu = weights["mu"]
    print("global mean estimate:", np.round(mu, 3), "(true mean ~3.0)")
    assert np.allclose(mu, 3.0, atol=0.3)
    print("quickstart OK")
    return {"weights": weights, "channel_bytes": result.channel_bytes}


if __name__ == "__main__":
    cli(main)
