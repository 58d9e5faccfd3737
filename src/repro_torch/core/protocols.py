"""Round protocols — *what* flows on a channel per round step (the port of
``repro.core.protocols``).

``WeightSync`` is the classic FL protocol: broadcast weights down, train,
upload sample-weighted updates, fold a sorted-src streaming mean. A protocol
binds to a role instance lazily (``Role.protocol``) and may rewrite the
role's tasklet chain (``rewrite_chain``) through the Table 1 surgical-edit
API.

Resolution order for a role's protocol name: the ``round_protocol``
hyperparam, else the ``protocol`` attribute of the role's protocol channel
in the TAG, else ``weight-sync``. Register your own with
``register_protocol``. Not ported yet: ``vertical-split`` and
``gossip-avg``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.composer import Composer
from repro_torch.core.roles import Role, StreamingMean, await_peer


# ------------------------------------------------------------------ #
# weight-sync wire schema
# ------------------------------------------------------------------ #
def pack_broadcast(
    weights: Any, done: bool, version: Optional[int] = None
) -> Dict[str, Any]:
    """Server -> client round broadcast. Sync senders pass no ``version``
    (payloads — and so the emulated wire bytes — are unchanged in sync
    mode)."""
    msg: Dict[str, Any] = {"weights": weights, "done": done}
    if version is not None:
        msg["version"] = version
    return msg


def pack_update(
    weights: Any, num_samples: int, version: Optional[int] = None
) -> Dict[str, Any]:
    """Client -> server model update. ``version`` echoes the server version
    the sender trained from; omitted when the sender never saw one."""
    msg: Dict[str, Any] = {"weights": weights, "num_samples": num_samples}
    if version is not None:
        msg["version"] = version
    return msg


class RoundProtocol:
    """What flows on ``channel`` per round step, bound to one role program.

    Subclasses implement the four step bodies the standard chains delegate
    to (trainer side: ``fetch``/``upload``; aggregator side:
    ``distribute``/``aggregate``) and may override ``rewrite_chain``. State
    kept on the instance is per-worker.
    """

    name: str = ""

    pack_broadcast = staticmethod(pack_broadcast)
    pack_update = staticmethod(pack_update)

    def __init__(self, role: Role, channel: Optional[str]) -> None:
        self.role = role
        self.channel = channel

    def _end(self):
        assert self.channel is not None, f"{self.name}: no protocol channel"
        return self.role.ctx.end(self.channel)

    # ----------------------- trainer-side steps ----------------------- #
    def fetch(self) -> None:
        raise NotImplementedError(f"protocol {self.name!r} defines no fetch step")

    def upload(self) -> None:
        raise NotImplementedError(f"protocol {self.name!r} defines no upload step")

    # ---------------------- aggregator-side steps --------------------- #
    def distribute(self) -> None:
        raise NotImplementedError(
            f"protocol {self.name!r} defines no distribute step"
        )

    def aggregate(self) -> None:
        raise NotImplementedError(
            f"protocol {self.name!r} defines no aggregate step"
        )

    # ------------------------- chain surgery -------------------------- #
    def rewrite_chain(self, composer: Composer) -> None:
        """Optional hook: reshape the composed chain via the Table 1 API.
        The default protocol leaves the chain untouched."""
        return None


class WeightSync(RoundProtocol):
    """The classic FL round protocol, step for step the JAX package's."""

    name = "weight-sync"

    # ----------------------- trainer-side steps ----------------------- #
    def fetch(self) -> None:
        role = self.role
        end = self._end()
        msg = end.recv(await_peer(role.ctx, end))
        role.weights = msg["weights"]
        role._server_version = msg.get("version", role._server_version)
        role._work_done = bool(msg.get("done", False))

    def upload(self) -> None:
        role = self.role
        if role._work_done:
            return
        end = self._end()
        # emulated local compute time, if the harness configured one
        role.ctx.advance_clock(
            self.channel, float(role.config.get("compute_time", 0.0))
        )
        end.send(
            await_peer(role.ctx, end),
            pack_update(role.weights, role.num_samples, role._server_version),
        )

    # ---------------------- aggregator-side steps --------------------- #
    def distribute(self) -> None:
        role = self.role
        if not role._work_done and int(role.config.get("reduce_plan", 0) or 0) > 0:
            raise NotImplementedError(
                "reduce_plan: the hub reduce plane needs the wire format "
                "(transport/wire.py), which the port does not have yet "
                "(ROADMAP Queue 5/6)"
            )
        end = self._end()
        end.send_many(end.ends(), pack_broadcast(role.weights, role._work_done))

    def aggregate(self) -> None:
        role = self.role
        if role._work_done:
            return  # peers were just told to exit; nothing will arrive
        end = self._end()
        acc = StreamingMean(device=role.ctx.device)
        # stream per source in sorted-src order: one update is in flight at
        # a time and the accumulation order is independent of arrival order
        for _, msg in end.recv_ordered(end.ends()):
            acc.fold(msg["weights"], float(msg.get("num_samples", 1)))
        role.peak_buffered = max(role.peak_buffered, acc.peak_buffered)
        role.metrics.append({
            "agg_folds": acc.count,
            "agg_frames": acc.count,
            "peak_buffered": role.peak_buffered,
        })
        mean, total = acc.finalize()
        if mean is not None:
            role.agg_weights = mean
            role.agg_samples = int(total)
            role.weights = role.agg_weights


# ------------------------------------------------------------------ #
# registry
# ------------------------------------------------------------------ #
ProtocolFactory = Callable[[Role, Optional[str]], RoundProtocol]

PROTOCOLS: Dict[str, ProtocolFactory] = {}


def register_protocol(
    name: str, factory: ProtocolFactory, *, overwrite: bool = False
) -> ProtocolFactory:
    """Register a round protocol under ``name`` (a ``RoundProtocol``
    subclass, or any ``(role, channel) -> RoundProtocol`` factory)."""
    if not overwrite and name in PROTOCOLS and PROTOCOLS[name] is not factory:
        raise ValueError(
            f"round protocol {name!r} already registered; pass overwrite=True "
            "to replace it"
        )
    PROTOCOLS[name] = factory
    return factory


def registered_protocols() -> List[str]:
    return sorted(PROTOCOLS)


def make_protocol(name: str, role: Role, channel: Optional[str]) -> RoundProtocol:
    try:
        factory = PROTOCOLS[name]
    except KeyError:
        raise KeyError(
            f"unknown round protocol {name!r}; registered: {registered_protocols()}"
        ) from None
    return factory(role, channel)


register_protocol(WeightSync.name, WeightSync)
