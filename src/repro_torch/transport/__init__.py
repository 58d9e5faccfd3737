"""Transport subsystem of the port (``repro.transport``).

``repro_torch.core.channels`` defines the ``TransportBackend`` protocol and
the in-process backends; this package leaves the process boundary:

* ``wire``        — deterministic binary serialization of tensor/numpy
  trees (byte-identical to the JAX package's), socket framing, and the
  per-channel payload codecs (``int8``, ``int8_blocks``, ``topk<frac>``);
* ``multiproc``   — the ``TransportHub`` broker and its ``MultiprocBackend``
  client; importing this package registers the ``multiproc`` loopback
  backend, which gives one channel a private hub;
* ``conformance`` — the shared transport-conformance checks, the codec
  round-trip fixtures and the ``SeededSGDTrainer`` reference workload.
"""
from repro_torch.transport.multiproc import (
    LoopbackMultiprocBackend,
    MultiprocBackend,
    TransportHub,
)
from repro_torch.transport.wire import decode, encode

__all__ = [
    "LoopbackMultiprocBackend",
    "MultiprocBackend",
    "TransportHub",
    "encode",
    "decode",
]
