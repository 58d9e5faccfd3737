"""Meshes of the port (the port of ``repro.launch.mesh``).

A mesh here is a ``Mesh``: named axis sizes, no devices. The JAX package's
meshes are device meshes of TPU pods; on one card the client axes (``data``,
``pod``) are virtual clients that the federated step runs in turn, and the
``model`` axis stays size 1 (tensor parallelism over several cards is not
ported: ROADMAP Queue 1). The JAX module's roofline constants are TPU
figures and have no counterpart here.
"""
from __future__ import annotations

from repro_torch.core.mesh_lowering import Mesh


def make_smoke_mesh() -> Mesh:
    """The one-client mesh with the production axis names."""
    return Mesh((("data", 1), ("model", 1)))


def make_virtual_mesh(clients: int, pods: int = 1) -> Mesh:
    """``clients`` virtual clients on the ``data`` axis, and ``pods`` groups
    of them on a ``pod`` axis when there is more than one pod."""
    if clients < 1 or pods < 1:
        raise ValueError(f"clients {clients} and pods {pods} must be >= 1")
    if pods > 1:
        return Mesh((("pod", pods), ("data", clients), ("model", 1)))
    return Mesh((("data", clients), ("model", 1)))
