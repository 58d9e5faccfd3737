"""The port's copy of ``repro.core.tag``: framework-free and kept identical,
so ``TAG.to_json`` is byte-equal across the two packages.

Topology Abstraction Graph (TAG) — the paper's central abstraction (§4.1).

A TAG is a logical graph: *roles* are vertices (worker abstractions), *channels*
are undirected edges (communication abstractions). The TAG is later *expanded*
(``repro.core.expansion``) into a physical deployment — a list of worker
configurations — and, on a TPU mesh, *lowered* (``repro.core.mesh_lowering``)
into a collective schedule.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple

DEFAULT_GROUP = "default"


class TagError(ValueError):
    """Raised when a TAG fails validation (pre/post checks of Algorithm 1)."""


@dataclasses.dataclass(frozen=True)
class FuncTags:
    """Maps each end-point role of a channel to the function tags it serves.

    Mirrors the paper's ``funcTags`` channel attribute: disambiguates which
    functions a role executes over a specific channel when the role is
    connected to several channels.
    """

    by_role: Dict[str, Tuple[str, ...]] = dataclasses.field(default_factory=dict)

    def for_role(self, role_name: str) -> Tuple[str, ...]:
        return self.by_role.get(role_name, ())


@dataclasses.dataclass(frozen=True)
class Channel:
    """An undirected edge between a pair of roles (§4.1 "Channel").

    Attributes
    ----------
    name:     unique channel name (referenced by ``Role.group_association``).
    pair:     the two role names this channel connects. A self-pair
              ``(r, r)`` expresses peer-to-peer channels (distributed FL).
    group_by: label-based grouping — the list of valid group labels on this
              channel (paper: ``groupBy``). Empty means single implicit
              ``default`` group.
    func_tags: per-role function-tag mapping (paper: ``funcTags``).
    backend:  communication backend for this channel. In the TPU adaptation a
              backend is a *collective policy* name registered in
              ``repro.core.channels`` ("inproc", "collective", "mqtt-emu",
              "p2p-emu"); per-channel backend selection is the paper's key
              flexibility claim (§6.2).
    wire_dtype: payload dtype on the wire ("bf16", "f32", "int8") — the TPU
              analogue of choosing a cheaper transport for a given channel.
    codec:    opt-in payload codec by registered name ("int8",
              "int8_blocks", "topk<frac>" — see ``repro.transport.wire``):
              socket-backed transports run it on the send path, shrinking
              real wire bytes; emulation backends use it for post-codec
              byte *accounting* only (their payloads never leave the
              process). Empty (default) sends raw payloads.
    protocol: round protocol run over this channel, by registered name
              ("weight-sync", "vertical-split", "gossip-avg" — see
              ``repro.core.protocols``). Controls *what* flows per round
              step, independent of runtime policy (sync/deadline/async)
              and deployment. Empty (default) means weight synchronisation,
              which is bit-identical to the pre-protocol behaviour.
    """

    name: str
    pair: Tuple[str, str]
    group_by: Tuple[str, ...] = ()
    func_tags: FuncTags = dataclasses.field(default_factory=FuncTags)
    backend: str = "inproc"
    wire_dtype: str = "f32"
    codec: str = ""
    protocol: str = ""

    def groups(self) -> Tuple[str, ...]:
        return self.group_by if self.group_by else (DEFAULT_GROUP,)

    def other_end(self, role_name: str) -> str:
        a, b = self.pair
        if role_name == a:
            return b
        if role_name == b:
            return a
        raise TagError(f"role {role_name!r} is not an end of channel {self.name!r}")


@dataclasses.dataclass(frozen=True)
class Role:
    """An executable worker unit carrying out a specific task (§4.1 "Role").

    Attributes
    ----------
    name:      unique role name.
    program:   dotted path / registry key of the program (Python class) bound
               to this role at job-composition time. Binding is *loose*: the
               same TAG can run different programs (paper §4.1).
    replica:   number of replicated workers per groupAssociation entry
               (non data-consumer roles only).
    is_data_consumer: if set, expansion creates one worker per dataset and the
               worker's group comes from the dataset's group.
    group_association: list of {channel_name: group} dicts; for non data
               consumers its length is the number of (pre-replica) workers.
    """

    name: str
    program: str = ""
    replica: int = 1
    is_data_consumer: bool = False
    group_association: Tuple[Dict[str, str], ...] = ()

    def channels_used(self) -> Tuple[str, ...]:
        seen: List[str] = []
        for assoc in self.group_association:
            for ch in assoc:
                if ch not in seen:
                    seen.append(ch)
        return tuple(seen)


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    """Metadata-only dataset registration (§4.3): realm + url, never raw data."""

    name: str
    url: str = ""
    realm: str = "default"
    group: str = DEFAULT_GROUP
    compute_id: Optional[str] = None  # resolved at deployment time via realms


@dataclasses.dataclass(frozen=True)
class TAG:
    """The condensed logical graph plus dataset grouping for expansion (§4.2)."""

    name: str
    roles: Tuple[Role, ...]
    channels: Tuple[Channel, ...]
    dataset_groups: Dict[str, Tuple[str, ...]] = dataclasses.field(default_factory=dict)

    # ------------------------------------------------------------------ #
    # lookups
    # ------------------------------------------------------------------ #
    def role(self, name: str) -> Role:
        for r in self.roles:
            if r.name == name:
                return r
        raise TagError(f"unknown role {name!r} in TAG {self.name!r}")

    def channel(self, name: str) -> Channel:
        for c in self.channels:
            if c.name == name:
                return c
        raise TagError(f"unknown channel {name!r} in TAG {self.name!r}")

    def channels_of(self, role_name: str) -> Tuple[Channel, ...]:
        return tuple(c for c in self.channels if role_name in c.pair)

    def data_consumers(self) -> Tuple[Role, ...]:
        return tuple(r for r in self.roles if r.is_data_consumer)

    # ------------------------------------------------------------------ #
    # validation (PreCheck of Algorithm 1)
    # ------------------------------------------------------------------ #
    def validate(self) -> None:
        role_names = [r.name for r in self.roles]
        if len(set(role_names)) != len(role_names):
            raise TagError("duplicate role names")
        chan_names = [c.name for c in self.channels]
        if len(set(chan_names)) != len(chan_names):
            raise TagError("duplicate channel names")
        for c in self.channels:
            for end in set(c.pair):
                if end not in role_names:
                    raise TagError(f"channel {c.name!r} references unknown role {end!r}")
        for r in self.roles:
            if r.replica < 1:
                raise TagError(f"role {r.name!r} has replica < 1")
            for assoc in r.group_association:
                for ch_name, group in assoc.items():
                    ch = self.channel(ch_name)
                    if r.name not in ch.pair:
                        raise TagError(
                            f"role {r.name!r} groupAssociation references channel "
                            f"{ch_name!r} it is not an end of"
                        )
                    if group not in ch.groups():
                        raise TagError(
                            f"group {group!r} not in channel {ch_name!r} groupBy "
                            f"{ch.groups()!r} (role {r.name!r})"
                        )
            if not r.is_data_consumer and not r.group_association:
                raise TagError(
                    f"non data-consumer role {r.name!r} needs >=1 groupAssociation entry"
                )
        # every role must touch at least one channel (a disconnected role can
        # never exchange model state)
        for r in self.roles:
            if not self.channels_of(r.name):
                raise TagError(f"role {r.name!r} is disconnected (no channels)")
        # dataset groups referenced by data consumers must exist
        for r in self.data_consumers():
            for assoc in r.group_association:
                for ch_name, group in assoc.items():
                    if group == DEFAULT_GROUP:
                        continue
                    if group not in self.dataset_groups and group not in self.channel(
                        ch_name
                    ).groups():
                        raise TagError(
                            f"data consumer {r.name!r} references unknown group {group!r}"
                        )

    # ------------------------------------------------------------------ #
    # (de)serialization — the "46 lines of configuration" artifact (§6.1)
    # ------------------------------------------------------------------ #
    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "roles": [
                {
                    "name": r.name,
                    "program": r.program,
                    "replica": r.replica,
                    "isDataConsumer": r.is_data_consumer,
                    "groupAssociation": [dict(a) for a in r.group_association],
                }
                for r in self.roles
            ],
            "channels": [
                {
                    "name": c.name,
                    "pair": list(c.pair),
                    "groupBy": list(c.group_by),
                    "funcTags": {k: list(v) for k, v in c.func_tags.by_role.items()},
                    "backend": c.backend,
                    "wireDtype": c.wire_dtype,
                    "codec": c.codec,
                    "protocol": c.protocol,
                }
                for c in self.channels
            ],
            "datasetGroups": {k: list(v) for k, v in self.dataset_groups.items()},
        }

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "TAG":
        roles = tuple(
            Role(
                name=r["name"],
                program=r.get("program", ""),
                replica=int(r.get("replica", 1)),
                is_data_consumer=bool(r.get("isDataConsumer", False)),
                group_association=tuple(dict(a) for a in r.get("groupAssociation", [])),
            )
            for r in d["roles"]
        )
        channels = tuple(
            Channel(
                name=c["name"],
                pair=tuple(c["pair"]),  # type: ignore[arg-type]
                group_by=tuple(c.get("groupBy", [])),
                func_tags=FuncTags(
                    {k: tuple(v) for k, v in c.get("funcTags", {}).items()}
                ),
                backend=c.get("backend", "inproc"),
                wire_dtype=c.get("wireDtype", "f32"),
                codec=c.get("codec", ""),
                protocol=c.get("protocol", ""),
            )
            for c in d["channels"]
        )
        tag = TAG(
            name=d["name"],
            roles=roles,
            channels=channels,
            dataset_groups={
                k: tuple(v) for k, v in d.get("datasetGroups", {}).items()
            },
        )
        tag.validate()
        return tag

    @staticmethod
    def from_json(s: str) -> "TAG":
        return TAG.from_dict(json.loads(s))


def diff_tags(old: TAG, new: TAG) -> Dict[str, List[str]]:
    """Structural diff between two TAGs — used to quantify topology
    transformations (paper Table 4: +, -, Δ per role/channel/metadata)."""
    out: Dict[str, List[str]] = {"added": [], "removed": [], "changed": []}
    old_roles = {r.name: r for r in old.roles}
    new_roles = {r.name: r for r in new.roles}
    for n in new_roles:
        if n not in old_roles:
            out["added"].append(f"role:{n}")
        elif new_roles[n] != old_roles[n]:
            out["changed"].append(f"role:{n}")
    for n in old_roles:
        if n not in new_roles:
            out["removed"].append(f"role:{n}")
    old_ch = {c.name: c for c in old.channels}
    new_ch = {c.name: c for c in new.channels}
    for n in new_ch:
        if n not in old_ch:
            out["added"].append(f"channel:{n}")
        elif new_ch[n] != old_ch[n]:
            out["changed"].append(f"channel:{n}")
    for n in old_ch:
        if n not in new_ch:
            out["removed"].append(f"channel:{n}")
    if old.dataset_groups != new.dataset_groups:
        out["changed"].append("metadata:datasetGroups")
    return out
