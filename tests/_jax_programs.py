"""Program classes of the JAX package's process jobs that the port's chaos
twins run beside the port's own (``_torch_programs``).

Spawned workers import a program class by its module's name, so this module
imports the JAX package alone.
"""
import numpy as np

from repro.core.roles import Trainer

TRAINER = "_jax_programs.HalfTrainer"


class HalfTrainer(Trainer):
    """``_torch_programs.HalfTrainer`` in the JAX package: the same exact
    update, so both packages give the same bytes."""

    def train(self):
        if self.weights is not None:
            idx = int(self.ctx.worker.dataset[1:])
            self.weights = {k: np.asarray(v, np.float32) * 0.5 + 0.25 * (idx + 1)
                            for k, v in self.weights.items()}
            self.num_samples = 10 + idx
