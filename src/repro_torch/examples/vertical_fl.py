"""Vertical FL: feature-split parties + a label-holding head, zero core edits.

Three hospitals each hold a *different slice of the feature columns* for the
same patients; only the head owns the labels. Instead of shipping model-sized
weight blobs, the ``vertical-split`` round protocol exchanges per-batch
partial activations (party -> head) and gradients (head -> party). The
topology is just a TAG template plus a ``RoundProtocol``: the base
``Trainer``/``GlobalAggregator`` roles and the runtime are untouched.

Run:  PYTHONPATH=src python -m repro_torch.examples.vertical_fl [--device cpu]
"""
from repro_torch.convert import resolve_device, tree_to_numpy
from repro_torch.core.expansion import JobSpec
from repro_torch.core.runtime import run_job
from repro_torch.core.tag import DatasetSpec
from repro_torch.core.topologies import vertical_fl
from repro_torch.examples import cli

PARTIES = 3
ROUNDS = 6


def main(device=None) -> dict:
    dev = resolve_device(device)
    tag = vertical_fl()
    # the protocol is declared on the channel, not buried in role code
    (chan,) = tag.channels
    print(f"channel {chan.name!r} carries round protocol {chan.protocol!r}")

    job = JobSpec(
        tag=tag,
        datasets=tuple(DatasetSpec(name=f"hospital-{i}") for i in range(PARTIES)),
        hyperparams={
            "rounds": ROUNDS,
            # vertical-split knobs: one shared synthetic table, split by rank
            "vertical_samples": 256,
            "vertical_features": 32,
            "vertical_classes": 4,
            "vertical_steps": 4,
            "vertical_lr": 0.5,
        },
    )
    res = run_job(job, device=dev, timeout=120)
    assert not res.errors, res.errors

    head = res.program("head-0")
    losses = [m["vertical_loss"] for m in head.metrics if "vertical_loss" in m]
    msgs = head.ctx.channels.total_msgs("activation-channel")
    print(f"{'round':>5} | {'head loss':>9}")
    for r, loss in enumerate(losses):
        print(f"{r:>5} | {loss:9.4f}")
    print(f"activation-channel traffic: {msgs} messages "
          f"({msgs / ROUNDS:.0f}/round — latency-bound, not bandwidth-bound)")
    assert losses[-1] < losses[0], "head loss should decrease"
    print("vertical_fl OK — feature-split training without touching the core")
    return {"losses": losses, "messages": msgs, "channel_bytes": res.channel_bytes,
            "weights": {wid: tree_to_numpy(p.weights) for wid, p in res.programs.items()}}


if __name__ == "__main__":
    cli(main)
