"""Flame core of the port: TAG abstraction, expansion, composer, channels.

Mesh lowering is not part of the port yet."""
from repro_torch.core import topologies
from repro_torch.core.channels import (
    ChannelManager,
    InprocBackend,
    LinkModel,
    TransportBackend,
    payload_bytes,
    register_backend,
    registered_backends,
)
from repro_torch.core.composer import Chain, CloneComposer, Composer, Loop, Tasklet
from repro_torch.core.expansion import JobSpec, WorkerConfig, expand
from repro_torch.core.registry import ComputeSpec, ResourceRegistry, realm_matches
from repro_torch.core.tag import TAG, Channel, DatasetSpec, FuncTags, Role, TagError, diff_tags

__all__ = [
    "TAG", "Channel", "Role", "FuncTags", "DatasetSpec", "TagError", "diff_tags",
    "JobSpec", "WorkerConfig", "expand",
    "ComputeSpec", "ResourceRegistry", "realm_matches",
    "Composer", "CloneComposer", "Chain", "Loop", "Tasklet",
    "ChannelManager", "InprocBackend", "LinkModel", "TransportBackend",
    "payload_bytes", "register_backend", "registered_backends",
    "topologies",
]
