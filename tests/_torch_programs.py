"""Program classes of the port's process-plane tests.

Spawned workers import a program class by its module's name, so these live
in a module that imports the port alone: a worker that re-imported a test
file would import JAX and the JAX package too, for nothing.
"""
import multiprocessing
import os
import time

from repro_torch.core.roles import GlobalAggregator, HybridTrainer, Trainer

# the trainer of the process-plane jobs: its update is elementwise and
# exact, so every deployment gives the same bytes (CPU products do not:
# MKL's thread count, which a loaded host may change, decides their bits)
TRAINER = "_torch_programs.HalfTrainer"


def half_update(weights, idx):
    """Exact binary fractions: the same float32 bits in numpy and torch."""
    return {k: v * 0.5 + 0.25 * (idx + 1) for k, v in weights.items()}


class HalfTrainer(Trainer):
    """A trainer whose update is bit-reproducible in both packages."""

    def train(self):
        if self.weights is not None:
            idx = int(self.ctx.worker.dataset[1:])
            self.weights = half_update(self.weights, idx)
            self.num_samples = 10 + idx


class FailingTrainer(Trainer):
    def load_data(self):
        raise RuntimeError("boom: load_data")


class FailingAggregator(GlobalAggregator):
    def initialize(self):
        raise RuntimeError("boom: initialize")


class SleepyTrainer(Trainer):
    def train(self):
        time.sleep(300.0)


class BadPreRunTrainer(Trainer):
    def pre_run(self):
        raise RuntimeError("boom: pre_run")


class HardCrashTrainer(Trainer):
    """``trainer-0`` dies before the barrier, reporting nothing; the other
    trainers start as usual, so the crash is always ``trainer-0``'s (when
    every trainer crashed, the launcher could tear ``trainer-0`` down
    while it still started up, after another's crash)."""

    def pre_run(self):
        if self.ctx.worker.worker_id == "trainer-0":
            os._exit(3)
        super().pre_run()


# the trainer of the hybrid process-plane job
HYBRID_TRAINER = "_torch_programs.HalfHybridTrainer"


class HalfHybridTrainer(HybridTrainer):
    """A hybrid cluster member with ``HalfTrainer``'s exact update."""

    train = HalfTrainer.train


class SlowRejoinTrainer(HalfTrainer):
    """``HalfTrainer``, whose re-joined incarnation (its clock at the
    re-join time or later) takes a second to start in a spawned worker
    process (a loaded host's process hop), and none on a thread."""

    def __init__(self, ctx):
        super().__init__(ctx)
        in_worker = multiprocessing.current_process().name.startswith("flame-")
        if in_worker and ctx.now("param-channel") >= 1.5:
            time.sleep(1.0)


class FanoutProbeAggregator(GlobalAggregator):
    """The global aggregator, recording in its metrics whether its process
    runs with the broadcast fan-out switch on."""

    def pre_run(self):
        from repro_torch.core.channels import broadcast_fanout_enabled

        self.metrics.append({"fanout": broadcast_fanout_enabled()})
        super().pre_run()
