"""Developer programming model (§6.1): extend H-FL into a new topology
WITHOUT touching the core library.

We derive a "logging" variant of hierarchical FL where every role snapshots
metrics after each round, purely by surgical tasklet-chain edits (Table 1)
and a TAG tweak, mirroring how the paper derives CO-FL from H-FL.

Run:  PYTHONPATH=src python -m repro_torch.examples.topology_extension [--device cpu]
"""
import numpy as np
import torch

from repro_torch.convert import tree_to_numpy
from repro_torch.core.composer import CloneComposer, Tasklet
from repro_torch.core.expansion import JobSpec
from repro_torch.core.roles import GlobalAggregator
from repro_torch.core.runtime import run_job
from repro_torch.core.tag import DatasetSpec, diff_tags
from repro_torch.core.topologies import coordinated_fl, hierarchical_fl
from repro_torch.examples import cli, job_device

SNAPSHOTS = []


class SnapshottingGlobalAggregator(GlobalAggregator):
    """Inherit the workflow; insert one tasklet. Zero core-library changes."""

    def snapshot(self):
        if self.weights is not None:
            SNAPSHOTS.append(
                {"round": self._round,
                 "norm": float(torch.linalg.vector_norm(self.weights["w"]))}
            )

    def compose(self):
        super().compose()
        with CloneComposer(self.composer) as composer:
            self.composer = composer
            tl = Tasklet("snapshot", self.snapshot)
            composer.get_tasklet("check_rounds").insert_after(tl)


def main(device=None) -> dict:
    dev = job_device(device)
    SNAPSHOTS.clear()  # one job's snapshots a call
    # Table 4's H-FL -> CO-FL transformation is a bounded TAG edit:
    d = diff_tags(hierarchical_fl(), coordinated_fl())
    print("H-FL -> CO-FL TAG diff:",
          {k: len(v) for k, v in d.items()}, "->", d["added"])

    tag = hierarchical_fl(
        groups=("west", "east"),
        dataset_groups={"west": ("d0", "d1"), "east": ("d2", "d3")},
    )
    job = JobSpec(
        tag=tag,
        datasets=tuple(DatasetSpec(name=f"d{i}") for i in range(4)),
        hyperparams={"rounds": 3,
                     "init_weights": {"w": np.ones(16, np.float32)}},
    )
    res = run_job(
        job,
        device=dev,
        program_overrides={"global-aggregator": SnapshottingGlobalAggregator},
        timeout=60,
    )
    assert not res.errors, res.errors
    print("snapshots taken by the inserted tasklet:", SNAPSHOTS)
    assert len(SNAPSHOTS) == 3
    print("topology_extension OK")
    return {"tag_diff": d, "snapshots": list(SNAPSHOTS),
            "weights": tree_to_numpy(res.global_weights()), "channel_bytes": res.channel_bytes}


if __name__ == "__main__":
    cli(main)
