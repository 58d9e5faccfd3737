"""Meshes of the port (the port of ``repro.launch.mesh``).

A mesh here is a ``Mesh``: named axis sizes, no devices. The client axes
(``data``, ``pod``) are virtual clients that the federated step runs in
turn; the ``model`` axis is one process per block of the sharded leaves
(``launch.tensor_parallel``), whatever cards those processes run on.

The roofline constants (``launch.analysis.Roofline``) are the card's:
datasheet figures of the NVIDIA H100 80GB HBM3 (SXM), not measurements,
and the card's memory as ``torch.cuda.get_device_properties(0)
.total_memory`` reports it there.
"""
from __future__ import annotations

from repro_torch.core.mesh_lowering import Mesh

# NVIDIA H100 80GB HBM3 (SXM) datasheet figures, per card (not measured)
PEAK_FLOPS_BF16 = 989e12  # dense bf16 on the tensor cores, FLOP/s
PEAK_FLOPS_F32 = 67e12  # float32 on the CUDA cores (no TF32), FLOP/s
HBM_BW = 3.35e12  # HBM3, bytes/s
LINK_BW = 450e9  # NVLink 4, one direction, bytes/s
# the card's memory, as torch reports it on that card (bytes)
HBM_PER_CARD = 85_017_493_504


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The JAX package's production meshes as sizes: (16, 16) over
    ("data", "model"), or (2, 16, 16) over ("pod", "data", "model")."""
    if multi_pod:
        return Mesh((("pod", 2), ("data", 16), ("model", 16)))
    return Mesh((("data", 16), ("model", 16)))


def make_smoke_mesh() -> Mesh:
    """The one-client mesh with the production axis names."""
    return Mesh((("data", 1), ("model", 1)))


def make_mesh_for_devices(n: int) -> Mesh:
    """The JAX train driver's mesh for ``n`` devices: ``model`` the largest
    of 8, 4 and 2 that divides ``n`` (1 when none does), ``data`` the rest."""
    if n < 1:
        raise ValueError(f"a mesh needs at least one device, got {n}")
    model = next((m for m in (8, 4, 2) if n % m == 0), 1)
    return Mesh((("data", n // model), ("model", model)))


def make_virtual_mesh(clients: int, pods: int = 1, model: int = 1) -> Mesh:
    """``clients`` virtual clients on the ``data`` axis, ``pods`` groups of
    them on a ``pod`` axis when there is more than one pod, and a ``model``
    axis of ``model`` ranks."""
    if clients < 1 or pods < 1 or model < 1:
        raise ValueError(f"clients {clients}, pods {pods} and model {model} must be >= 1")
    if pods > 1:
        return Mesh((("pod", pods), ("data", clients), ("model", model)))
    return Mesh((("data", clients), ("model", model)))
