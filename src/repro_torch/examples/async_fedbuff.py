"""Async FL: one TAG, three execution policies (sync / deadline / async).

The application logic, a softmax-regression trainer on synthetic federated
data, is written once. The ``RuntimePolicy`` alone decides whether the job
runs as barriered rounds, deadline-bounded partial participation, or fully
asynchronous FedBuff aggregation with staleness weighting. Half the clients
are emulated stragglers (16x slower on the virtual clock), so the three
policies show materially different round-completion times while all three
reach a useful model.

Run:  PYTHONPATH=src python -m repro_torch.examples.async_fedbuff [--device cpu]
"""
import numpy as np
import torch

from repro_torch.convert import tree_to_numpy
from repro_torch.core.expansion import JobSpec
from repro_torch.core.roles import Trainer
from repro_torch.core.runtime import RuntimePolicy, run_job
from repro_torch.core.tag import DatasetSpec
from repro_torch.core.topologies import classical_fl
from repro_torch.examples import cli, job_device

N_CLIENTS = 6
ROUNDS = 5
FEATURES, CLASSES = 16, 5
# wall-clock seconds a policy server waits on a quiet channel: the only
# wall-clock knob (every time in the table is virtual)
GRACE = 1.5


def _softmax(z):
    z = z - z.amax(dim=1, keepdim=True)
    e = torch.exp(z)
    return e / e.sum(dim=1, keepdim=True)


class SGDTrainer(Trainer):
    """Fig. 5 programming model: the same class serves every policy."""

    def load_data(self):
        rng = np.random.default_rng(abs(hash(self.ctx.worker.dataset)) % 2**32)
        w_true = np.random.default_rng(0).normal(size=(FEATURES, CLASSES))
        x = rng.normal(size=(128, FEATURES)).astype(np.float32)
        logits = x @ w_true + 0.5 * rng.normal(size=(128, CLASSES))
        self.set_data(x, logits.argmax(axis=1))

    def set_data(self, x, y):
        """The shard, drawn on the host, moved once to the job's device."""
        self.x = torch.from_numpy(x).to(self.ctx.device)
        self.onehot = torch.eye(CLASSES, dtype=torch.float32, device=self.ctx.device)[
            torch.from_numpy(y).to(self.ctx.device)]
        self.num_samples = len(x)

    def train(self):
        if self.weights is None:
            return
        w, b = self.weights["w"].clone(), self.weights["b"].clone()
        p = _softmax(self.x @ w + b)
        g = (p - self.onehot) / len(self.x)
        w -= 0.5 * (self.x.T @ g)
        b -= 0.5 * g.sum(dim=0)
        self.weights = {"w": w, "b": b}
        # note: the base Trainer.upload already advances the virtual clock by
        # config["compute_time"] — don't advance it again here


def accuracy(weights) -> float:
    """The share of 1 024 held-out samples the model labels right, on the
    weights' device."""
    rng = np.random.default_rng(123)
    w_true = np.random.default_rng(0).normal(size=(FEATURES, CLASSES))
    x = rng.normal(size=(1024, FEATURES)).astype(np.float32)
    y = (x @ w_true).argmax(axis=1)
    dev = weights["w"].device
    pred = (torch.from_numpy(x).to(dev) @ weights["w"] + weights["b"]).argmax(dim=1)
    return float((pred == torch.from_numpy(y).to(dev)).sum()) / len(y)


def root_logs(res) -> dict:
    """The root's virtual time and its policy logs (deadline participation,
    FedBuff staleness), as the table and the comparisons read them."""
    glob = res.program("global-aggregator-0")
    return {"virtual_time": glob.ctx.now(glob.down_channel),
            "participation": getattr(glob, "participation_log", None),
            "staleness": getattr(glob, "staleness_log", None)}


def run_policy(policy: RuntimePolicy, device) -> dict:
    job = JobSpec(
        tag=classical_fl(),
        datasets=tuple(DatasetSpec(name=f"d{i}") for i in range(N_CLIENTS)),
        hyperparams={
            "rounds": ROUNDS,
            "init_weights": {
                "w": np.zeros((FEATURES, CLASSES), np.float32),
                "b": np.zeros((CLASSES,), np.float32),
            },
        },
    )
    # half the fleet straggles: 8 virtual seconds of compute instead of 0.5
    per_worker = {
        f"trainer-{i}": {"compute_time": 8.0 if i % 2 else 0.5}
        for i in range(N_CLIENTS)
    }
    res = run_job(
        job,
        device=device,
        policy=policy,
        program_overrides={"trainer": SGDTrainer},
        per_worker_hyperparams=per_worker,
        timeout=120,
    )
    assert not res.errors, res.errors
    return {"accuracy": accuracy(res.global_weights()), **root_logs(res),
            "weights": tree_to_numpy(res.global_weights()), "channel_bytes": res.channel_bytes}


def policies() -> dict:
    return {
        "sync": RuntimePolicy(mode="sync"),
        "deadline": RuntimePolicy(mode="deadline", deadline=2.0, grace=GRACE),
        "async": RuntimePolicy(mode="async", buffer_size=2, grace=GRACE),
    }


def main(device=None) -> dict:
    dev = job_device(device)
    out = {}
    print(f"{'policy':>10} | {'accuracy':>8} | {'virtual time':>12}")
    for name, policy in policies().items():
        out[name] = run = run_policy(policy, dev)
        acc, t = run["accuracy"], run["virtual_time"]
        print(f"{name:>10} | {acc:8.3f} | {t:11.1f}s")
        assert acc > 0.5, f"{name} failed to learn (acc={acc:.3f})"
    print("async_fedbuff OK — same TAG, three execution policies")
    return out


if __name__ == "__main__":
    cli(main)
