"""Multiproc quickstart: the same seeded FL job as threads and as processes.

The classical-FL TAG runs twice: once on the in-process runtime (threads +
InprocBackend) and once as a real process tree (one OS process per worker,
messages over sockets through a TransportHub), both on the same device, and
the global weights are verified byte-identical: the transport is a
deployment detail, not application logic.

Run:  PYTHONPATH=src python -m repro_torch.examples.multiproc_quickstart [--device cpu]
"""
from __future__ import annotations

import numpy as np

from repro_torch.convert import tree_to_numpy
from repro_torch.core.expansion import JobSpec
from repro_torch.core.runtime import run_job
from repro_torch.core.tag import DatasetSpec
from repro_torch.core.topologies import classical_fl
from repro_torch.examples import cli, job_device
from repro_torch.launch.spawn import run_job_multiproc


def main(device=None) -> dict:
    dev = job_device(device)
    rng = np.random.default_rng(0)
    w0 = {
        "w": (0.01 * rng.normal(size=(32, 10))).astype(np.float32),
        "b": np.zeros((10,), np.float32),
    }
    job = JobSpec(
        # a repro.* program path, as the JAX script names it: the port's
        # runtime resolves it to repro_torch.transport.conformance
        tag=classical_fl(
            trainer_program="repro.transport.conformance.SeededSGDTrainer"
        ),
        datasets=tuple(DatasetSpec(name=f"d{i}") for i in range(3)),
        hyperparams={"rounds": 3, "init_weights": w0},
    )

    res_threads = run_job(job, device=dev, timeout=60)
    assert not res_threads.errors, res_threads.errors

    res_procs = run_job_multiproc(job, device=dev, timeout=120)
    assert not res_procs.errors, res_procs.errors

    wt = tree_to_numpy(res_threads.global_weights())
    wp = tree_to_numpy(res_procs.global_weights())
    for leaf in wt:
        assert wt[leaf].tobytes() == wp[leaf].tobytes()
    print(
        "multiproc_quickstart OK — byte-identical global weights: "
        f"threads vs {len(res_procs.workers)} worker processes "
        f"({res_procs.channel_bytes['param-channel']:.0f} B over the hub)"
    )
    # each worker process's kernel launches (its summary's counts)
    launches: dict = {}
    for prog in res_procs.programs.values():
        for name, n in prog.launches.items():
            launches[name] = launches.get(name, 0) + n
    return {"threads": wt, "processes": wp, "workers": len(res_procs.workers),
            "channel_bytes": res_procs.channel_bytes,
            "threads_channel_bytes": res_threads.channel_bytes,
            "process_launches": launches}


if __name__ == "__main__":
    cli(main)
