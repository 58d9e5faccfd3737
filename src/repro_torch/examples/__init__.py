"""The example programs of the port: the JAX package's ``examples/*.py``
written against ``repro_torch``, one module each, under the same names.

    python -m repro_torch.examples.quickstart                # on the card
    python -m repro_torch.examples.quickstart --device cpu   # on the CPU

Each module's ``main(device=None)`` runs on the card unless ``device`` says
otherwise, and raises where there is no card (as ``run_job`` does). It
prints its script's table and ``... OK`` line, asserts what its script
asserts, and returns what it prints (weights as numpy, accuracies, virtual
times, channel bytes and messages, losses, snapshots) as a dict.

The trainers are PyTorch code: data is drawn with numpy by the script's
expressions and seeds, moved once to the job's device, and trained there on
the tensors the roles hand them. Four scripts seed a trainer's data with
``abs(hash(dataset))``, which follows the interpreter's ``PYTHONHASHSEED``:
their accuracies change from one interpreter to the next, as the scripts'
do, and agree with the JAX package's within one process.
"""
from __future__ import annotations

import argparse
from typing import Any, Callable, Optional, Sequence

import torch

from repro_torch.convert import resolve_device

NAMES = ("quickstart", "topology_extension", "multiproc_quickstart", "async_fedbuff",
         "hier_async", "gossip_ring", "vertical_fl", "per_channel_backends")


def job_device(device: Any = None) -> torch.device:
    """The device an example whose aggregators fold runs on (the card when
    ``device`` is None, raising where there is none). On the card it builds
    and loads the fold kernels' library first: a build at the first fold
    would stall a round past a policy's wall-clock grace. A failed build
    raises."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        from repro_torch.kernels.agg import kernel

        kernel.build()
    return dev


def cli(main: Callable[[Optional[str]], Any], argv: Optional[Sequence[str]] = None) -> None:
    """``python -m repro_torch.examples.<name> [--device cpu]``."""
    ap = argparse.ArgumentParser(prog=f"python -m {main.__module__}")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(ap.parse_args(argv).device)
