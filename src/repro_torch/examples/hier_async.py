"""Hierarchical FL: one two-level TAG, nine execution-policy combinations.

The application logic, the softmax-regression trainer of ``async_fedbuff``
plus the stock intermediate and root aggregators, is written once. The
``RuntimePolicy`` alone decides, *per tier*, whether each level of the
aggregation tree runs barriered rounds, deadline-bounded partial
participation, or fully asynchronous FedBuff aggregation:

    RuntimePolicy(mode=<root>, tiers={"aggregator": <middle>})

Half the clients in every group are emulated stragglers (16x slower on the
virtual clock), so the combinations show materially different tree
round-completion times while all of them reach a useful model: the paper's
"execution semantics are a deployment detail of the TAG" claim, extended to
the whole hierarchy.

Run:  PYTHONPATH=src python -m repro_torch.examples.hier_async [--device cpu]
"""
import numpy as np

from repro_torch.convert import tree_to_numpy
from repro_torch.core.expansion import JobSpec
from repro_torch.core.runtime import RuntimePolicy, run_job
from repro_torch.core.tag import DatasetSpec
from repro_torch.core.topologies import hierarchical_fl
from repro_torch.examples import cli, job_device
from repro_torch.examples.async_fedbuff import CLASSES, FEATURES, SGDTrainer, accuracy, root_logs

N_GROUPS = 2
CLIENTS_PER_GROUP = 3
ROUNDS = 4
MODES = ("sync", "deadline", "async")
GRACE = 1.5  # wall-clock seconds a policy server waits on a quiet channel
# (root, middle) combinations whose model follows the order in which
# concurrent updates land, which thread timing decides (in the JAX package
# as here): an async tier absorbs updates as they arrive, and a deadline
# root over sync aggregators admits the first of two relays that reach it
# at the same virtual time. Their accuracies and times vary between runs.
ARRIVAL_ORDERED = frozenset(
    {(r, m) for r in MODES for m in MODES if "async" in (r, m)} | {("deadline", "sync")})


def _job() -> JobSpec:
    groups = tuple(f"g{i}" for i in range(N_GROUPS))
    names = [f"d{i}" for i in range(N_GROUPS * CLIENTS_PER_GROUP)]
    dataset_groups = {
        g: tuple(names[i * CLIENTS_PER_GROUP: (i + 1) * CLIENTS_PER_GROUP])
        for i, g in enumerate(groups)
    }
    return JobSpec(
        tag=hierarchical_fl(groups=groups, dataset_groups=dataset_groups),
        datasets=tuple(DatasetSpec(name=n) for n in names),
        hyperparams={
            "rounds": ROUNDS,
            "init_weights": {
                "w": np.zeros((FEATURES, CLASSES), np.float32),
                "b": np.zeros((CLASSES,), np.float32),
            },
        },
    )


def policy(root: str, middle: str) -> RuntimePolicy:
    return RuntimePolicy(
        mode=root,
        tiers={"aggregator": middle},
        deadline=2.0,
        min_participants=1,
        buffer_size=2,
        grace=GRACE,
    )


def run_combo(root: str, middle: str, device) -> dict:
    # half of every group straggles: 8 virtual seconds instead of 0.5
    per_worker = {
        f"trainer-{i}": {"compute_time": 8.0 if i % 2 else 0.5}
        for i in range(N_GROUPS * CLIENTS_PER_GROUP)
    }
    res = run_job(
        _job(),
        device=device,
        policy=policy(root, middle),
        program_overrides={"trainer": SGDTrainer},
        per_worker_hyperparams=per_worker,
        timeout=120,
    )
    assert not res.errors, res.errors
    return {"accuracy": accuracy(res.global_weights()), **root_logs(res),
            "weights": tree_to_numpy(res.global_weights()), "channel_bytes": res.channel_bytes}


def main(device=None) -> dict:
    dev = job_device(device)
    out = {}
    print(f"{'root':>10} | {'middle':>10} | {'accuracy':>8} | {'virtual time':>12}")
    for root in MODES:
        for middle in MODES:
            out[root, middle] = run = run_combo(root, middle, dev)
            acc, t = run["accuracy"], run["virtual_time"]
            print(f"{root:>10} | {middle:>10} | {acc:8.3f} | {t:11.1f}s")
            assert acc > 0.5, f"{root}/{middle} failed to learn (acc={acc:.3f})"
    print("hier_async OK — one H-FL TAG, nine per-tier execution policies")
    return out


if __name__ == "__main__":
    cli(main)
