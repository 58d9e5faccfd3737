"""The port's copy of ``repro.core.registry`` (framework-free).

Resource annotation and registration (§4.3).

Compute clusters and datasets register *independently*; the coupling happens
at deployment time via ``realm`` matching. Realms are hierarchical
slash-separated labels (``us/west``, ``us/west/k8s-3``): a dataset with realm
``us/west`` may be placed on any compute whose realm shares that prefix —
the logical accessibility boundary the paper uses for GDPR-style constraints.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Tuple

from repro_torch.core.tag import DatasetSpec


class RegistryError(KeyError):
    pass


@dataclasses.dataclass(frozen=True)
class ComputeSpec:
    """A registered compute cluster (deployer integration, §5.1)."""

    compute_id: str
    realm: str = "default"
    orchestrator: str = "inproc"  # "inproc" | "k8s" | "mesh" | ...
    capacity: int = 1_000_000  # max workers this cluster accepts
    properties: Dict[str, str] = dataclasses.field(default_factory=dict)


def realm_matches(resource_realm: str, compute_realm: str) -> bool:
    """True if a resource annotated ``resource_realm`` may run on a compute in
    ``compute_realm`` (prefix containment either way at segment granularity)."""
    r = resource_realm.strip("/").split("/")
    c = compute_realm.strip("/").split("/")
    if r == ["default"] or c == ["default"]:
        return True
    n = min(len(r), len(c))
    return r[:n] == c[:n]


class ResourceRegistry:
    """In-process metadata store: the controller's view of registered
    compute clusters and dataset metadata (never raw data)."""

    def __init__(self) -> None:
        self._computes: Dict[str, ComputeSpec] = {}
        self._datasets: Dict[str, DatasetSpec] = {}
        self._load: Dict[str, int] = {}
        self._rr = itertools.count()

    # ---------------------------------------------------------------- #
    # registration (step 1 of the paper's workflow)
    # ---------------------------------------------------------------- #
    def register_compute(self, spec: ComputeSpec) -> None:
        if spec.compute_id in self._computes:
            raise RegistryError(f"compute {spec.compute_id!r} already registered")
        self._computes[spec.compute_id] = spec
        self._load[spec.compute_id] = 0

    def register_dataset(self, spec: DatasetSpec) -> None:
        if spec.name in self._datasets:
            raise RegistryError(f"dataset {spec.name!r} already registered")
        self._datasets[spec.name] = spec

    def deregister_compute(self, compute_id: str) -> None:
        self._computes.pop(compute_id, None)
        self._load.pop(compute_id, None)

    # ---------------------------------------------------------------- #
    # lookups used by TAG expansion
    # ---------------------------------------------------------------- #
    def computes(self) -> Tuple[ComputeSpec, ...]:
        return tuple(self._computes.values())

    def datasets(self) -> Tuple[DatasetSpec, ...]:
        return tuple(self._datasets.values())

    def dataset(self, name: str) -> DatasetSpec:
        try:
            return self._datasets[name]
        except KeyError:
            raise RegistryError(f"dataset {name!r} not registered") from None

    def compute_for_realm(self, realm: str, soft: bool = False) -> str:
        """Pick the least-loaded registered compute matching ``realm``.

        ``soft=True`` (service roles) falls back to any compute when nothing
        matches; data consumers never fall back (privacy boundary is hard).
        """
        candidates = [
            c
            for c in self._computes.values()
            if realm_matches(realm, c.realm)
            and self._load[c.compute_id] < c.capacity
        ]
        if not candidates and soft:
            candidates = [
                c
                for c in self._computes.values()
                if self._load[c.compute_id] < c.capacity
            ]
        if not candidates:
            if not self._computes:
                # Library-only use (no management plane): synthesize a name so
                # expansion stays usable in pure-simulation tests.
                return f"compute/{realm}"
            raise RegistryError(f"no registered compute matches realm {realm!r}")
        chosen = min(candidates, key=lambda c: (self._load[c.compute_id], c.compute_id))
        self._load[chosen.compute_id] += 1
        return chosen.compute_id

    def release(self, compute_id: str, n: int = 1) -> None:
        if compute_id in self._load:
            self._load[compute_id] = max(0, self._load[compute_id] - n)
