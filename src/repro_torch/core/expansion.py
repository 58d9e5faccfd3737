"""The port's copy of ``repro.core.expansion`` (framework-free).

TAG expansion — Algorithm 1 of the paper (§4.2).

``expand(job)`` walks the TAG's roles and produces one ``WorkerConfig`` per
physical worker:

* data-consumer roles: one worker per dataset; the worker's group comes from
  the dataset's group (``datasetGroups``), the compute from the dataset's
  resolved compute id (realm matching, §4.3);
* other roles: one worker per ``groupAssociation`` entry × ``replica``, the
  compute decided from the groups' realms.

Pre/post checks validate the TAG and the expanded deployment respectively.
The expansion has no required role order: each role's spec is self-contained.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.registry import ResourceRegistry
from repro_torch.core.tag import DEFAULT_GROUP, TAG, DatasetSpec, Role, TagError


@dataclasses.dataclass(frozen=True)
class WorkerConfig:
    """A physical worker produced by expansion (one container in real Flame)."""

    worker_id: str
    role: str
    program: str
    compute_id: str
    # channel name -> group this worker joined on that channel
    groups: Dict[str, str]
    dataset: Optional[str] = None
    replica_index: int = 0

    def group_of(self, channel: str) -> str:
        return self.groups.get(channel, DEFAULT_GROUP)


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """User-submitted job configuration (§5.2): TAG + programs + data spec."""

    tag: TAG
    datasets: Tuple[DatasetSpec, ...] = ()
    job_id: str = "job-0"
    hyperparams: Dict[str, object] = dataclasses.field(default_factory=dict)


class ExpansionError(TagError):
    pass


def _pre_check(job: JobSpec) -> None:
    job.tag.validate()
    consumers = job.tag.data_consumers()
    if consumers and not job.datasets:
        raise ExpansionError("TAG has data-consumer roles but job has no datasets")
    declared = set(
        itertools.chain.from_iterable(job.tag.dataset_groups.values())
    )
    for d in job.datasets:
        if job.tag.dataset_groups and d.name not in declared:
            raise ExpansionError(
                f"dataset {d.name!r} not referenced by any datasetGroup"
            )


def _groups_of_datasets(job: JobSpec) -> Dict[str, Tuple[DatasetSpec, ...]]:
    """GetGroupsOfDataSets: group -> datasets, honoring datasetGroups metadata."""
    by_name = {d.name: d for d in job.datasets}
    if job.tag.dataset_groups:
        out: Dict[str, Tuple[DatasetSpec, ...]] = {}
        for group, names in job.tag.dataset_groups.items():
            members = []
            for n in names:
                if n not in by_name:
                    raise ExpansionError(f"datasetGroup references unknown dataset {n!r}")
                members.append(by_name[n])
            out[group] = tuple(members)
        return out
    return {DEFAULT_GROUP: tuple(job.datasets)}


def _group_assoc_by_group(role: Role, group: str) -> Dict[str, str]:
    """GetGroupAssocByGroupName: the association entry whose values contain
    ``group`` (data consumers join every channel in that entry's groups)."""
    for assoc in role.group_association:
        if group in assoc.values():
            return dict(assoc)
    # A data consumer with no explicit association joins all its channels in
    # the dataset's group (common case: a lone param channel).
    return {}


def _build_data_consumer_workers(
    role: Role, job: JobSpec, registry: Optional[ResourceRegistry]
) -> List[WorkerConfig]:
    workers: List[WorkerConfig] = []
    tag = job.tag
    groups = _groups_of_datasets(job)
    idx = 0
    for group in sorted(groups):
        for dataset in groups[group]:
            # GetComputeId: dataset-pinned compute, else realm matching.
            if dataset.compute_id is not None:
                compute = dataset.compute_id
            elif registry is not None:
                compute = registry.compute_for_realm(dataset.realm)
            else:
                compute = f"compute/{dataset.realm}"
            assoc = _group_assoc_by_group(role, group)
            ch_groups: Dict[str, str] = {}
            for ch in tag.channels_of(role.name):
                if ch.name in assoc:
                    ch_groups[ch.name] = assoc[ch.name]
                elif group in ch.groups():
                    ch_groups[ch.name] = group
                else:
                    ch_groups[ch.name] = DEFAULT_GROUP
            workers.append(
                WorkerConfig(
                    worker_id=f"{role.name}-{idx}",
                    role=role.name,
                    program=role.program,
                    compute_id=compute,
                    groups=ch_groups,
                    dataset=dataset.name,
                )
            )
            idx += 1
    return workers


def _build_service_workers(
    role: Role, job: JobSpec, registry: Optional[ResourceRegistry]
) -> List[WorkerConfig]:
    workers: List[WorkerConfig] = []
    idx = 0
    for assoc in role.group_association:
        for rep in range(role.replica):
            # DecideComputeId: realm of the first concrete group, else default.
            realm = "default"
            for g in assoc.values():
                if g != DEFAULT_GROUP:
                    realm = g
                    break
            if registry is not None:
                compute = registry.compute_for_realm(realm, soft=True)
            else:
                compute = f"compute/{realm}"
            workers.append(
                WorkerConfig(
                    worker_id=f"{role.name}-{idx}",
                    role=role.name,
                    program=role.program,
                    compute_id=compute,
                    groups=dict(assoc),
                    replica_index=rep,
                )
            )
            idx += 1
    return workers


def build_workers(
    role: Role, job: JobSpec, registry: Optional[ResourceRegistry] = None
) -> List[WorkerConfig]:
    """BuildWorkers(r, J) of Algorithm 1."""
    if role.is_data_consumer:
        return _build_data_consumer_workers(role, job, registry)
    return _build_service_workers(role, job, registry)


def _post_check(workers: Sequence[WorkerConfig], job: JobSpec) -> None:
    """PostCheck: every channel group must have workers on *both* ends
    (a channel end with no peers would deadlock the job)."""
    tag = job.tag
    for ch in tag.channels:
        a, b = ch.pair
        for group in ch.groups():
            ends_a = [
                w for w in workers if w.role == a and w.group_of(ch.name) == group
            ]
            ends_b = [
                w for w in workers if w.role == b and w.group_of(ch.name) == group
            ]
            if a == b:
                if len(ends_a) < 2 and len(ch.groups()) == 1:
                    raise ExpansionError(
                        f"p2p channel {ch.name!r} group {group!r} has <2 workers"
                    )
                continue
            if bool(ends_a) != bool(ends_b):
                raise ExpansionError(
                    f"channel {ch.name!r} group {group!r} is one-sided "
                    f"({a}:{len(ends_a)} vs {b}:{len(ends_b)})"
                )


def expand(
    job: JobSpec,
    registry: Optional[ResourceRegistry] = None,
    check: bool = True,
) -> List[WorkerConfig]:
    """Expand(J) of Algorithm 1: TAG -> physical deployment."""
    if check:
        _pre_check(job)
    workers: List[WorkerConfig] = []
    for role in job.tag.roles:
        workers.extend(build_workers(role, job, registry))
    if check:
        _post_check(workers, job)
    return workers
