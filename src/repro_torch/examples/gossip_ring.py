"""Serverless gossip ring: neighbor averaging with per-link top-k compression.

No aggregator anywhere: each trainer runs local SGD, then the ``gossip-avg``
round protocol averages its model with its two ring neighbors. The protocol
rewrites the trainer's tasklet chain at compose time (drop ``fetch``, swap
``upload`` for ``gossip``), so the stock ``Trainer`` role works unmodified.
Links optionally carry the ``topk`` error-feedback codec: gossip is where
per-link compression economics matter most.

Run:  PYTHONPATH=src python -m repro_torch.examples.gossip_ring [--device cpu]
"""
import numpy as np

from repro_torch.convert import resolve_device, tree_to_numpy
from repro_torch.core.expansion import JobSpec
from repro_torch.core.runtime import run_job
from repro_torch.core.tag import DatasetSpec
from repro_torch.core.topologies import gossip_fl
from repro_torch.examples import async_fedbuff, cli
from repro_torch.examples.async_fedbuff import CLASSES, FEATURES, accuracy

N, ROUNDS = 4, 5
CODECS = ("", "topk0.25")


class SGDTrainer(async_fedbuff.SGDTrainer):
    """Standard horizontal trainer (``async_fedbuff``'s, on labels without
    noise): gossip needs nothing special from it."""

    def load_data(self):
        rng = np.random.default_rng(abs(hash(self.ctx.worker.dataset)) % 2**32)
        w_true = np.random.default_rng(0).normal(size=(FEATURES, CLASSES))
        x = rng.normal(size=(128, FEATURES)).astype(np.float32)
        self.set_data(x, (x @ w_true).argmax(axis=1))


def run_ring(codec: str, device) -> dict:
    job = JobSpec(
        tag=gossip_fl(backend="inproc", codec=codec),
        datasets=tuple(DatasetSpec(name=f"edge-{i}") for i in range(N)),
        hyperparams={
            "rounds": ROUNDS,
            "init_weights": {
                "w": np.zeros((FEATURES, CLASSES), np.float32),
                "b": np.zeros((CLASSES,), np.float32),
            },
        },
    )
    res = run_job(job, device=device, program_overrides={"trainer": SGDTrainer}, timeout=120)
    assert not res.errors, res.errors
    accs = [accuracy(p.weights) for p in res.programs.values()]
    some = next(iter(res.programs.values()))
    gbytes = some.ctx.channels.total_bytes("gossip-channel")
    return {"accuracies": accs, "link_bytes": gbytes, "channel_bytes": res.channel_bytes,
            "weights": {wid: tree_to_numpy(p.weights) for wid, p in res.programs.items()}}


def main(device=None) -> dict:
    dev = resolve_device(device)
    out = {}
    print(f"{'codec':>9} | {'mean acc':>8} | {'spread':>7} | {'link bytes':>10}")
    for codec in CODECS:
        out[codec] = run = run_ring(codec, dev)
        accs = run["accuracies"]
        mean, spread = float(np.mean(accs)), float(np.max(accs) - np.min(accs))
        print(f"{codec or 'raw':>9} | {mean:8.3f} | {spread:7.4f} | {run['link_bytes']:>10}")
        assert mean > 0.5, f"ring failed to learn (acc={mean:.3f})"
    print("gossip_ring OK — aggregator-free averaging over a ring TAG")
    return out


if __name__ == "__main__":
    cli(main)
