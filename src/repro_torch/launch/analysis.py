"""Collective accounting and roofline terms (the port of
``repro.launch.analysis``).

The roofline terms divide a step's counts by the card's figures
(``launch.mesh``: NVIDIA H100 80GB HBM3 datasheet values, not
measurements):

  compute term    = FLOPs / (chips x peak FLOP/s of the step's dtype)
  memory term     = bytes / (chips x HBM bytes/s)
  collective term = collective bytes a device / link bytes/s

The JAX package counts its collectives by parsing XLA's HLO text
(``parse_collectives``); the port produces no HLO, so it has no such
parser. Its collectives are the ``launch.tensor_parallel`` all-reduces a
rank makes, which a counting ``ModelGroup`` counts without a process group
behind it (``launch.dryrun``); ``CollectiveStats.of_group`` reads them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.launch import mesh as hw


@dataclasses.dataclass
class CollectiveStats:
    # op kind -> (count, bytes), per device
    by_kind: Dict[str, Tuple[int, int]]

    @property
    def total_bytes(self) -> int:
        return sum(b for _, b in self.by_kind.values())

    @property
    def total_count(self) -> int:
        return sum(c for c, _ in self.by_kind.values())

    @classmethod
    def of_group(cls, group) -> "CollectiveStats":
        """A ``ModelGroup``'s counters: its all-reduces (a gather at use
        over ``model`` is one, counted in both), its all-gathers (FSDP's
        data gathers, at their whole leaves' bytes) and its reduces (the
        data gathers' gradient blocks, each to its owner at its bytes)."""
        kinds = {"all-reduce": (group.all_reduces, group.all_reduce_bytes),
                 "all-gather": (group.data_gathered_leaves, group.data_gathered_bytes),
                 "reduce": (group.data_reduces, group.data_reduce_bytes)}
        return cls(by_kind={k: v for k, v in kinds.items() if v[0]})


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float  # whole-program FLOPs (all chips)
    hlo_bytes: float  # whole-program memory traffic (all chips)
    collective_bytes: float  # per-device bytes on the wire
    model_flops: float  # 2*N*D a pass (x3 to train), N the active parameters
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    # the card's figures; the defaults are the H100's (bf16 peak)
    peak_flops: Optional[float] = None
    hbm_bw: Optional[float] = None
    link_bw: Optional[float] = None

    def __post_init__(self):
        peak = self.peak_flops or hw.PEAK_FLOPS_BF16
        hbm = self.hbm_bw or hw.HBM_BW
        link = self.link_bw or hw.LINK_BW
        self.compute_s = self.hlo_flops / (self.chips * peak)
        self.memory_s = self.hlo_bytes / (self.chips * hbm)
        # collective_bytes is already per-device wire traffic
        self.collective_s = self.collective_bytes / link

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes,
            "collective_bytes": self.collective_bytes,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "useful_ratio": self.useful_ratio,
        }
