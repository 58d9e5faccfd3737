"""The port's copy of ``repro.core.topologies``. Program paths stay in the
``repro.`` namespace so TAGs serialize identically in both packages;
``repro_torch.core.runtime.resolve_program`` maps them onto the port.

Topology templates (paper §6.3): C-FL, H-FL, CO-FL, Hybrid, Distributed —
plus the protocol-pluggable additions (vertical FL, gossip ring).

Each builder returns a validated TAG. These are the "templates provided in
Flame" users pick from; transformations between them are small TAG edits
(quantified by ``repro.core.tag.diff_tags`` and the Table 4 reproduction).
Downstream topologies register through ``register_template`` (mirroring
``repro.transport.wire.register_codec``) instead of editing this module.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.tag import DEFAULT_GROUP, TAG, Channel, FuncTags, Role


def classical_fl(
    groups: Sequence[str] = (),
    backend: str = "inproc",
    trainer_program: str = "repro.core.roles.Trainer",
    aggregator_program: str = "repro.core.roles.GlobalAggregator",
    wire_dtype: str = "f32",
) -> TAG:
    """Fig 2c: trainers <-> one global aggregator over a single param channel."""
    param = Channel(
        name="param-channel",
        pair=("trainer", "global-aggregator"),
        group_by=tuple(groups),
        func_tags=FuncTags(
            {
                "trainer": ("fetch", "upload"),
                "global-aggregator": ("distribute", "aggregate"),
            }
        ),
        backend=backend,
        wire_dtype=wire_dtype,
    )
    trainer = Role(
        name="trainer",
        program=trainer_program,
        is_data_consumer=True,
        group_association=tuple({"param-channel": g} for g in (groups or (DEFAULT_GROUP,))),
    )
    agg = Role(
        name="global-aggregator",
        program=aggregator_program,
        group_association=({"param-channel": DEFAULT_GROUP},)
        if not groups
        else tuple({"param-channel": g} for g in groups),
    )
    # A single global aggregator serving several groups needs the channel to
    # carry a default group; keep one aggregator on the default group.
    if groups:
        param = Channel(
            name=param.name,
            pair=param.pair,
            group_by=tuple(set(groups) | {DEFAULT_GROUP}),
            func_tags=param.func_tags,
            backend=param.backend,
            wire_dtype=param.wire_dtype,
        )
        agg = Role(
            name="global-aggregator",
            program=aggregator_program,
            group_association=({"param-channel": DEFAULT_GROUP},),
        )
        trainer = Role(
            name="trainer",
            program=trainer_program,
            is_data_consumer=True,
            group_association=tuple({"param-channel": DEFAULT_GROUP} for _ in groups),
        )
    tag = TAG(name="classical-fl", roles=(trainer, agg), channels=(param,))
    tag.validate()
    return tag


def hierarchical_fl(
    groups: Sequence[str] = ("west", "east"),
    dataset_groups: Optional[Dict[str, Tuple[str, ...]]] = None,
    param_backend: str = "inproc",
    agg_backend: str = "inproc",
    replica: int = 1,
    trainer_program: str = "repro.core.roles.Trainer",
    aggregator_program: str = "repro.core.roles.Aggregator",
    global_program: str = "repro.core.roles.GlobalAggregator",
    param_wire_dtype: str = "f32",
    agg_wire_dtype: str = "f32",
) -> TAG:
    """Fig 3a: trainers -> per-group aggregators -> global aggregator."""
    groups = tuple(groups)
    param = Channel(
        name="param-channel",
        pair=("trainer", "aggregator"),
        group_by=groups,
        func_tags=FuncTags(
            {"trainer": ("fetch", "upload"), "aggregator": ("distribute", "aggregate")}
        ),
        backend=param_backend,
        wire_dtype=param_wire_dtype,
    )
    global_ch = Channel(
        name="global-channel",
        pair=("aggregator", "global-aggregator"),
        func_tags=FuncTags(
            {
                "aggregator": ("fetch", "upload"),
                "global-aggregator": ("distribute", "aggregate"),
            }
        ),
        backend=agg_backend,
        wire_dtype=agg_wire_dtype,
    )
    trainer = Role(
        name="trainer",
        program=trainer_program,
        is_data_consumer=True,
        group_association=tuple({"param-channel": g} for g in groups),
    )
    aggregator = Role(
        name="aggregator",
        program=aggregator_program,
        replica=replica,
        group_association=tuple(
            {"param-channel": g, "global-channel": DEFAULT_GROUP} for g in groups
        ),
    )
    global_agg = Role(
        name="global-aggregator",
        program=global_program,
        group_association=({"global-channel": DEFAULT_GROUP},),
    )
    tag = TAG(
        name="hierarchical-fl",
        roles=(trainer, aggregator, global_agg),
        channels=(param, global_ch),
        dataset_groups=dict(dataset_groups or {}),
    )
    tag.validate()
    return tag


def coordinated_fl(
    groups: Sequence[str] = ("default",),
    dataset_groups: Optional[Dict[str, Tuple[str, ...]]] = None,
    aggregator_replicas: int = 2,
    trainer_program: str = "repro.core.roles_coord.CoordTrainer",
    aggregator_program: str = "repro.core.roles_coord.CoordAggregator",
    global_program: str = "repro.core.roles_coord.CoordGlobalAggregator",
    coordinator_program: str = "repro.core.roles_coord.Coordinator",
) -> TAG:
    """Fig 1d / Fig 8: H-FL plus a coordinator connected to every other role.

    The bipartite trainer<->aggregator links come from a single shared group
    plus the aggregator ``replica`` attribute, exactly as §6.1 describes.
    """
    groups = tuple(groups)
    base = hierarchical_fl(
        groups=groups,
        dataset_groups=dataset_groups,
        replica=aggregator_replicas,
        trainer_program=trainer_program,
        aggregator_program=aggregator_program,
        global_program=global_program,
    )
    coord_channels = (
        Channel(
            name="coord-trainer-channel",
            pair=("coordinator", "trainer"),
            func_tags=FuncTags(
                {"coordinator": ("assign",), "trainer": ("get_assignment",)}
            ),
        ),
        Channel(
            name="coord-agg-channel",
            pair=("coordinator", "aggregator"),
            func_tags=FuncTags(
                {"coordinator": ("assign", "collect_delay"), "aggregator": ("report",)}
            ),
        ),
        Channel(
            name="coord-global-channel",
            pair=("coordinator", "global-aggregator"),
            func_tags=FuncTags(
                {"coordinator": ("steer",), "global-aggregator": ("get_coord_ends",)}
            ),
        ),
    )

    def _with_channel(role: Role, channel: str) -> Role:
        return Role(
            name=role.name,
            program=role.program,
            replica=role.replica,
            is_data_consumer=role.is_data_consumer,
            group_association=tuple(
                {**assoc, channel: DEFAULT_GROUP} for assoc in role.group_association
            ),
        )

    trainer = _with_channel(base.role("trainer"), "coord-trainer-channel")
    aggregator = _with_channel(base.role("aggregator"), "coord-agg-channel")
    global_agg = _with_channel(base.role("global-aggregator"), "coord-global-channel")
    coordinator = Role(
        name="coordinator",
        program=coordinator_program,
        group_association=(
            {
                "coord-trainer-channel": DEFAULT_GROUP,
                "coord-agg-channel": DEFAULT_GROUP,
                "coord-global-channel": DEFAULT_GROUP,
            },
        ),
    )
    tag = TAG(
        name="coordinated-fl",
        roles=(trainer, aggregator, global_agg, coordinator),
        channels=base.channels + coord_channels,
        dataset_groups=dict(base.dataset_groups),
    )
    tag.validate()
    return tag


def hybrid_fl(
    groups: Sequence[str] = ("c0", "c1", "c2", "c3", "c4"),
    dataset_groups: Optional[Dict[str, Tuple[str, ...]]] = None,
    intra_backend: str = "p2p-emu",
    uplink_backend: str = "mqtt-emu",
    trainer_program: str = "repro.core.roles.HybridTrainer",
    aggregator_program: str = "repro.core.roles.GlobalAggregator",
    uplink_wire_dtype: str = "f32",
) -> TAG:
    """Fig 2e: co-located trainers all-reduce over a fast intra-cluster P2P
    channel; one elected leader per cluster uploads over the slow channel."""
    groups = tuple(groups)
    ring = Channel(
        name="ring-channel",
        pair=("trainer", "trainer"),
        group_by=groups,
        func_tags=FuncTags({"trainer": ("allreduce",)}),
        backend=intra_backend,
    )
    uplink = Channel(
        name="param-channel",
        pair=("trainer", "global-aggregator"),
        group_by=(DEFAULT_GROUP,),
        func_tags=FuncTags(
            {
                "trainer": ("fetch", "upload"),
                "global-aggregator": ("distribute", "aggregate"),
            }
        ),
        backend=uplink_backend,
        wire_dtype=uplink_wire_dtype,
    )
    trainer = Role(
        name="trainer",
        program=trainer_program,
        is_data_consumer=True,
        group_association=tuple(
            {"ring-channel": g, "param-channel": DEFAULT_GROUP} for g in groups
        ),
    )
    agg = Role(
        name="global-aggregator",
        program=aggregator_program,
        group_association=({"param-channel": DEFAULT_GROUP},),
    )
    tag = TAG(
        name="hybrid-fl",
        roles=(trainer, agg),
        channels=(ring, uplink),
        dataset_groups=dict(dataset_groups or {}),
    )
    tag.validate()
    return tag


def distributed_fl(
    backend: str = "p2p-emu",
    trainer_program: str = "repro.core.roles.DistributedTrainer",
) -> TAG:
    """Fig 2b: no aggregator; trainers all-reduce among themselves."""
    ring = Channel(
        name="ring-channel",
        pair=("trainer", "trainer"),
        func_tags=FuncTags({"trainer": ("allreduce",)}),
        backend=backend,
    )
    trainer = Role(
        name="trainer",
        program=trainer_program,
        is_data_consumer=True,
        group_association=({"ring-channel": DEFAULT_GROUP},),
    )
    tag = TAG(name="distributed-fl", roles=(trainer,), channels=(ring,))
    tag.validate()
    return tag


def vertical_fl(
    backend: str = "inproc",
    party_program: str = "repro.core.roles.Trainer",
    head_program: str = "repro.core.roles.GlobalAggregator",
    codec: str = "",
) -> TAG:
    """Feature-split vertical FL: parties hold disjoint feature columns of the
    *same* samples; the head holds the labels. Per round the parties exchange
    per-batch partial activations / gradients with the head over one channel.

    The stock ``Trainer``/``GlobalAggregator`` programs run this unchanged:
    the channel's ``protocol="vertical-split"`` swaps what their
    fetch/upload/distribute/aggregate steps put on the wire, with zero new
    role classes and zero runtime edits (the tentpole claim of ISSUE 7).
    """
    act = Channel(
        name="activation-channel",
        pair=("party", "head"),
        func_tags=FuncTags(
            {"party": ("fetch", "upload"), "head": ("distribute", "aggregate")}
        ),
        backend=backend,
        codec=codec,
        protocol="vertical-split",
    )
    party = Role(
        name="party",
        program=party_program,
        is_data_consumer=True,
        group_association=({"activation-channel": DEFAULT_GROUP},),
    )
    head = Role(
        name="head",
        program=head_program,
        group_association=({"activation-channel": DEFAULT_GROUP},),
    )
    tag = TAG(name="vertical-fl", roles=(party, head), channels=(act,))
    tag.validate()
    return tag


def gossip_fl(
    backend: str = "p2p-emu",
    trainer_program: str = "repro.core.roles.Trainer",
    codec: str = "",
) -> TAG:
    """Serverless gossip ring: trainers average weights with their ring
    neighbors each round — no aggregator role at all.

    Like :func:`vertical_fl` this reuses the stock ``Trainer``; the
    channel's ``protocol="gossip-avg"`` rewrites the composed chain (drops
    ``fetch``, replaces ``upload`` with neighbor averaging) via the Table 1
    surgical-edit API. Pass ``codec="topk0.25"`` to run each ring link
    through the error-feedback sparsifier.
    """
    ring = Channel(
        name="gossip-channel",
        pair=("trainer", "trainer"),
        func_tags=FuncTags({"trainer": ("gossip",)}),
        backend=backend,
        codec=codec,
        protocol="gossip-avg",
    )
    trainer = Role(
        name="trainer",
        program=trainer_program,
        is_data_consumer=True,
        group_association=({"gossip-channel": DEFAULT_GROUP},),
    )
    tag = TAG(name="gossip-fl", roles=(trainer,), channels=(ring,))
    tag.validate()
    return tag


# ---------------------------------------------------------------------- #
# template registry — the extension entry point (mirrors register_codec)
# ---------------------------------------------------------------------- #
TemplateFactory = Callable[..., TAG]

TEMPLATES: Dict[str, TemplateFactory] = {}


def register_template(
    name: str, factory: TemplateFactory, *, overwrite: bool = False
) -> None:
    """Register a topology template under ``name``.

    Downstream packages call this at import time so their topologies are
    reachable by name (mgmt plane, benchmarks, docs) without editing core
    modules. Re-registering an existing name raises unless ``overwrite=True``.
    """
    if not overwrite and name in TEMPLATES:
        raise ValueError(
            f"template {name!r} already registered (pass overwrite=True to replace)"
        )
    TEMPLATES[name] = factory


def registered_templates() -> List[str]:
    return sorted(TEMPLATES)


def get_template(name: str) -> TemplateFactory:
    try:
        return TEMPLATES[name]
    except KeyError:
        raise KeyError(
            f"unknown template {name!r}; registered: {registered_templates()}"
        ) from None


register_template("classical", classical_fl)
register_template("hierarchical", hierarchical_fl)
register_template("coordinated", coordinated_fl)
register_template("hybrid", hybrid_fl)
register_template("distributed", distributed_fl)
register_template("vertical", vertical_fl)
register_template("gossip", gossip_fl)
