"""Channel API and the in-process communication backends (the port of
``repro.core.channels``, §4.1 "Channel", Table 2).

The channel manager gives every role a uniform messaging surface —
``join/leave/send/recv/recv_fifo/peek/broadcast/ends/empty`` — whatever the
backend behind it. Backends registered here, all in-process:

* ``inproc``   — thread-safe queues with a per-link bandwidth/latency model
  on a virtual clock;
* ``mqtt-emu`` — inproc with a broker contention model: traffic to one
  topic (one receiver's subscription on a channel/group) serializes on the
  broker, distinct topics proceed in parallel;
* ``p2p-emu``  — inproc with per-link bandwidth (direct peering);
* ``collective`` — membership only during emulation.

Payloads are trees whose leaves are ``torch.Tensor``s; they move by
reference, never through the host. Wire cost is computed from leaf sizes
under the channel's ``wire_dtype`` (``payload_bytes``), counting exactly the
leaves and item sizes the JAX package counts.

Not ported yet: the hub reduce plane and wire codecs, which need
``transport/wire.py``; a channel with a codec raises ``NotImplementedError``.
"""
from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from typing import (
    Any,
    Callable,
    Dict,
    Iterable,
    List,
    Optional,
    Protocol,
    Sequence,
    Tuple,
)

import numpy as np
import torch

from repro_torch.core.tag import Channel as ChannelSpec
from repro_torch.core.tree import tree_leaves

_WIRE_BYTES = {"f32": 4, "bf16": 2, "f16": 2, "int8": 1}

_NOT_PORTED_WIRE = (
    "needs the wire format (transport/wire.py), which the port does not have "
    "yet (ROADMAP Queue 5/6)"
)


def payload_bytes(payload: Any, wire_dtype: str = "f32") -> int:
    """Bytes of a tree payload on the wire under ``wire_dtype``.

    ``wire_dtype`` caps the per-element width: a leaf already narrower than
    the wire dtype is counted at its own element size. A tensor is counted
    from ``numel()`` and ``element_size()``, so a CUDA leaf is never copied
    to the host to be counted."""
    per = _WIRE_BYTES.get(wire_dtype, 4)
    total = 0
    for leaf in tree_leaves(payload):
        if isinstance(leaf, torch.Tensor):
            size, itemsize = leaf.numel(), leaf.element_size()
        else:
            size = np.size(leaf) if hasattr(leaf, "shape") or np.ndim(leaf) else 1
            itemsize = getattr(getattr(leaf, "dtype", None), "itemsize", per)
        total += int(size) * min(per, int(itemsize))
    return total


@dataclasses.dataclass
class LinkModel:
    """Emulated link characteristics for an end (bandwidth in bytes/sec)."""

    bandwidth: float = float("inf")
    latency: float = 0.0

    def transfer_time(self, nbytes: int) -> float:
        bw = self.bandwidth if self.bandwidth > 0 else float("inf")
        return self.latency + (nbytes / bw if bw != float("inf") else 0.0)


@dataclasses.dataclass
class Message:
    src: str
    payload: Any
    nbytes: int
    arrival: float  # emulated arrival time (seconds on the virtual clock)


class WorkerDropped(RuntimeError):
    """Raised from a channel operation when the worker's virtual clock would
    cross its scheduled dropout time (mid-round dropout emulation)."""

    def __init__(self, worker: str, at: float) -> None:
        super().__init__(f"worker {worker!r} dropped out at t={at:.3f}s (virtual)")
        self.worker = worker
        self.at = at


class TransportBackend(Protocol):
    """The pluggable transport contract behind ``ChannelEnd``.

    Semantics every implementation must honor:

    * per-``(channel, group, dst, src)`` FIFO mailboxes;
    * ``recv``/``recv_any`` block (wall-clock) until delivery, ``queue.Empty``
      on timeout;
    * ``poison(worker)`` wakes any blocked receive of ``worker`` immediately
      with ``WorkerDropped``;
    * clock ops (``now``/``advance``/``set_clock``) keep a monotone per-worker
      time in seconds, and any operation carrying a worker's clock past its
      ``set_drop`` time raises ``WorkerDropped``.
    """

    name: str
    stats: Dict[str, float]

    # --------------------------- membership --------------------------- #
    def join(self, channel: str, group: str, worker: str) -> None: ...
    def leave(self, channel: str, group: str, worker: str) -> None: ...
    def peers(self, channel: str, group: str, me: str) -> List[str]: ...

    # ---------------------------- messaging --------------------------- #
    def send(self, channel: str, group: str, src: str, dst: str, payload: Any) -> None: ...
    def send_many(
        self, channel: str, group: str, src: str, dsts: Sequence[str], payload: Any
    ) -> None: ...
    def recv(
        self, channel: str, group: str, me: str, end: str, timeout: Optional[float]
    ) -> Any: ...
    def recv_any(
        self,
        channel: str,
        group: str,
        me: str,
        ends: Sequence[str],
        timeout: Optional[float],
        advance: bool = True,
    ) -> Tuple[str, Any, float]: ...
    def recv_fifo(
        self,
        channel: str,
        group: str,
        me: str,
        ends: Sequence[str],
        timeout: Optional[float],
    ) -> Iterable[Tuple[str, Any]]: ...
    def peek(self, channel: str, group: str, me: str, end: str) -> Optional[Any]: ...
    def earliest(
        self, channel: str, group: str, me: str, ends: Sequence[str]
    ) -> Optional[Tuple[float, str]]: ...

    # ------------------- failure emulation / cancel -------------------- #
    def set_drop(self, worker: str, at: float) -> None: ...
    def clear_drop(self, worker: str) -> None: ...
    def drop_time(self, worker: str) -> Optional[float]: ...
    def poison(self, worker: str, at: float) -> None: ...
    def check_poison(self, worker: str) -> None: ...

    # ------------------------- configuration -------------------------- #
    def set_link(self, channel: str, worker: str, model: LinkModel) -> None: ...
    def set_wire_dtype(self, channel: str, dtype: str) -> None: ...
    def link(self, channel: str, worker: str) -> LinkModel: ...

    # ----------------------------- clocks ------------------------------ #
    def now(self, worker: str) -> float: ...
    def advance(self, worker: str, seconds: float) -> None: ...
    def set_clock(self, worker: str, at: float) -> None: ...



class ChannelEnd:
    """One worker's handle on a channel — implements Table 2.

    ``peer_role`` (when set) restricts ``ends()`` to workers of the role at
    the other end of the channel; ``peer_selector`` is the hook for the
    paper's "chosen peer selection logic" (Table 2).
    """

    def __init__(
        self,
        backend: TransportBackend,
        channel: str,
        group: str,
        me: str,
        peer_role: Optional[str] = None,
        peer_selector: Optional[Callable[[List[str]], List[str]]] = None,
    ):
        self._backend = backend
        self.channel = channel
        self.group = group
        self.me = me
        self.peer_role = peer_role
        self.peer_selector = peer_selector
        self._joined = False

    # ----------------------------- lifecycle -------------------------- #
    def join(self) -> None:
        self._backend.join(self.channel, self.group, self.me)
        self._joined = True

    def leave(self) -> None:
        self._backend.leave(self.channel, self.group, self.me)
        self._joined = False

    # ----------------------------- messaging -------------------------- #
    def send(self, end: str, msg: Any) -> None:
        self._backend.send(self.channel, self.group, self.me, end, msg)

    def recv(self, end: str, timeout: Optional[float] = 30.0) -> Any:
        return self._backend.recv(self.channel, self.group, self.me, end, timeout)

    def recv_fifo(self, ends: Sequence[str], timeout: Optional[float] = 30.0):
        """Yield (end, message) for each end, in arrival (FIFO) order."""
        return self._backend.recv_fifo(self.channel, self.group, self.me, ends, timeout)

    def recv_any(
        self,
        ends: Sequence[str],
        timeout: Optional[float] = 30.0,
        advance: bool = True,
    ) -> Tuple[str, Any, float]:
        """Earliest available message from any of ``ends``:
        ``(end, payload, virtual_arrival)``. Raises ``queue.Empty`` on
        timeout."""
        return self._backend.recv_any(
            self.channel, self.group, self.me, ends, timeout, advance=advance
        )

    def peek(self, end: str) -> Optional[Any]:
        return self._backend.peek(self.channel, self.group, self.me, end)

    def earliest(self, ends: Sequence[str]) -> Optional[Tuple[float, str]]:
        """Non-consuming ``(arrival, end)`` of the earliest available message
        from any of ``ends`` on this channel, or ``None``."""
        return self._backend.earliest(self.channel, self.group, self.me, ends)

    def send_many(self, ends: Sequence[str], msg: Any) -> None:
        """Send one payload to several destinations through the backend's
        ``send_many``: ordering, clocks and byte accounting equal the
        per-destination ``send`` loop."""
        if not ends:
            return
        if len(ends) > 1:
            self._backend.send_many(self.channel, self.group, self.me, list(ends), msg)
        else:
            self.send(ends[0], msg)

    def broadcast(self, msg: Any) -> None:
        self.send_many(self.ends(), msg)

    def recv_ordered(self, ends: Sequence[str], timeout: Optional[float] = 30.0):
        """Receive one message from each of ``ends``, yielding
        ``(end, payload)`` in sorted-``ends`` order — the fold order that
        keeps aggregation bit-identical whatever the arrival order."""
        for end in sorted(ends):
            yield end, self.recv(end, timeout=timeout)

    # ----------------------------- topology --------------------------- #
    def ends(self) -> List[str]:
        peers = self._backend.peers(self.channel, self.group, self.me)
        if self.peer_role is not None:
            peers = [p for p in peers if p.rsplit("-", 1)[0] == self.peer_role]
        if self.peer_selector is not None:
            peers = self.peer_selector(peers)
        return peers

    def empty(self) -> bool:
        return not self.ends()

    # ------------------- clocks / failure emulation -------------------- #
    def now(self) -> float:
        return self._backend.now(self.me)

    def advance(self, seconds: float) -> None:
        self._backend.advance(self.me, seconds)

    def set_clock(self, at: float) -> None:
        self._backend.set_clock(self.me, at)

    def check_poison(self) -> None:
        self._backend.check_poison(self.me)

    def drop_time(self, worker: Optional[str] = None) -> Optional[float]:
        return self._backend.drop_time(worker if worker is not None else self.me)


class InprocBackend:
    """Thread-safe in-process message transport with an emulated clock.

    Every (channel, group) is a mailbox keyed by (dst, src). Virtual time
    advances by each message's modeled transfer duration; ``recv`` blocks
    the receiving thread until real delivery, while each message's
    ``arrival`` records the *emulated* completion time.
    """

    def __init__(self, name: str = "inproc", shared_broker: bool = False):
        self.name = name
        self.shared_broker = shared_broker
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)  # signaled on every delivery
        self._members: Dict[Tuple[str, str], List[str]] = collections.defaultdict(list)
        self._boxes: Dict[Tuple[str, str, str, str], "queue.Queue[Message]"] = {}
        self._links: Dict[Tuple[str, str], LinkModel] = {}
        self._wire_dtype: Dict[str, str] = {}
        # broker contention is per *topic* — one receiver's subscription on a
        # (channel, group): transfers to the same receiver serialize on the
        # broker uplink, distinct topics proceed in parallel (§6.2)
        self._broker_free_at: Dict[Tuple[str, str, str], float] = collections.defaultdict(
            float
        )
        self._clock: Dict[str, float] = collections.defaultdict(float)  # per-worker
        self._drop_at: Dict[str, float] = {}  # worker -> scheduled dropout time
        self._poisoned: Dict[str, float] = {}  # worker -> orphaned-at time
        self.stats: Dict[str, float] = collections.defaultdict(float)

    # ------------------------- configuration -------------------------- #
    def set_link(self, channel: str, worker: str, model: LinkModel) -> None:
        self._links[(channel, worker)] = model

    def set_wire_dtype(self, channel: str, dtype: str) -> None:
        self._wire_dtype[channel] = dtype

    def link(self, channel: str, worker: str) -> LinkModel:
        return self._links.get((channel, worker), LinkModel())

    # --------------------------- dropout ------------------------------ #
    def set_drop(self, worker: str, at: float) -> None:
        """Schedule ``worker`` to drop out once its virtual clock crosses
        ``at``. Enforced by every clock-advancing channel operation."""
        with self._lock:
            self._drop_at[worker] = float(at)

    def clear_drop(self, worker: str) -> None:
        with self._lock:
            self._drop_at.pop(worker, None)
            self._poisoned.pop(worker, None)

    def drop_time(self, worker: str) -> Optional[float]:
        with self._lock:
            return self._drop_at.get(worker)

    def poison(self, worker: str, at: float) -> None:
        """Mark ``worker`` as orphaned at virtual time ``at``: any blocked or
        future receive by the worker raises ``WorkerDropped`` immediately."""
        with self._cv:
            self._poisoned[worker] = float(at)
            self._cv.notify_all()

    def check_poison(self, worker: str) -> None:
        """Raise ``WorkerDropped`` if ``worker`` has been poisoned."""
        with self._lock:
            at = self._poisoned.get(worker)
        if at is not None:
            raise WorkerDropped(worker, at)

    def _check_poison_locked(self, worker: str) -> None:
        at = self._poisoned.get(worker)
        if at is not None:
            raise WorkerDropped(worker, at)

    def _check_alive(self, worker: str, new_time: float) -> None:
        """Raise WorkerDropped if moving ``worker``'s clock to ``new_time``
        crosses its dropout time. Caller must hold the lock."""
        at = self._drop_at.get(worker)
        if at is not None and new_time > at:
            self._clock[worker] = max(self._clock[worker], at)
            raise WorkerDropped(worker, at)

    # --------------------------- membership --------------------------- #
    def join(self, channel: str, group: str, worker: str) -> None:
        with self._lock:
            members = self._members[(channel, group)]
            if worker not in members:
                members.append(worker)

    def leave(self, channel: str, group: str, worker: str) -> None:
        with self._lock:
            members = self._members[(channel, group)]
            if worker in members:
                members.remove(worker)

    def peers(self, channel: str, group: str, me: str) -> List[str]:
        with self._lock:
            return [m for m in self._members[(channel, group)] if m != me]

    # ---------------------------- transport ---------------------------- #
    def _box(self, channel: str, group: str, dst: str, src: str) -> "queue.Queue[Message]":
        key = (channel, group, dst, src)
        with self._lock:
            if key not in self._boxes:
                self._boxes[key] = queue.Queue()
            return self._boxes[key]

    def _deliver_locked(
        self, channel: str, group: str, src: str, dst: str, payload: Any,
        nbytes: int, dur: float,
    ) -> None:
        """One transfer's clock/broker/dropout arithmetic and delivery.
        Caller holds the lock."""
        topic = (channel, group, dst)
        start = self._clock[src]
        if self.shared_broker:
            # broker serializes transfers on the destination's topic only
            start = max(start, self._broker_free_at[topic])
        arrival = start + dur
        drop_at = self._drop_at.get(src)
        if drop_at is not None and arrival > drop_at:
            # sender dies mid-transfer: nothing is delivered, and on a
            # shared broker the aborted transfer occupies the topic only
            # until the moment of death
            if self.shared_broker:
                self._broker_free_at[topic] = max(
                    self._broker_free_at[topic], min(drop_at, start + dur)
                )
            self._check_alive(src, arrival)  # raises WorkerDropped
        if self.shared_broker:
            self._broker_free_at[topic] = start + dur
        self._clock[src] = arrival
        self.stats[f"bytes:{channel}"] += nbytes
        self.stats[f"msgs:{channel}"] += 1
        self._box(channel, group, dst, src).put(Message(src, payload, nbytes, arrival))

    def send(self, channel: str, group: str, src: str, dst: str, payload: Any) -> None:
        self.send_many(channel, group, src, [dst], payload)

    def send_many(
        self, channel: str, group: str, src: str, dsts: Sequence[str], payload: Any
    ) -> None:
        """Deliver one payload to every dst: the payload is sized once, and
        the per-destination arithmetic runs under one lock hold, so arrivals,
        stats and dropout behavior equal the ``for dst: send(dst)`` loop.
        The same payload object is delivered by reference to each mailbox."""
        if not dsts:
            return
        nbytes = payload_bytes(payload, self._wire_dtype.get(channel, "f32"))
        dur = self.link(channel, src).transfer_time(nbytes)
        with self._lock:
            try:
                for dst in dsts:
                    self._deliver_locked(channel, group, src, dst, payload, nbytes, dur)
            finally:
                # wake receivers even when a mid-fan-out dropout aborts the
                # loop — earlier destinations' messages are already delivered
                self._cv.notify_all()

    def _get_msg(
        self, channel: str, group: str, me: str, end: str, timeout: Optional[float]
    ) -> Message:
        """Blocking single-box take on the delivery condition variable, so a
        ``poison`` call interrupts a blocked receiver immediately. Caller must
        NOT hold the lock. Raises ``queue.Empty`` on timeout."""
        box = self._box(channel, group, me, end)
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                self._check_poison_locked(me)
                try:
                    return box.get_nowait()
                except queue.Empty:
                    pass
                remaining = (
                    None if deadline is None else deadline - time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    raise queue.Empty
                self._cv.wait(timeout=remaining)

    def recv(
        self, channel: str, group: str, me: str, end: str, timeout: Optional[float]
    ) -> Any:
        msg = self._get_msg(channel, group, me, end, timeout)
        with self._lock:
            self._check_alive(me, msg.arrival)
            self._clock[me] = max(self._clock[me], msg.arrival)
        return msg.payload

    def recv_any(
        self,
        channel: str,
        group: str,
        me: str,
        ends: Sequence[str],
        timeout: Optional[float],
        advance: bool = True,
    ) -> Tuple[str, Any, float]:
        """Take the earliest-arriving available message from any of ``ends``:
        ``(end, payload, arrival)``. Blocks (wall-clock) until a message is
        available or ``timeout`` elapses (-> ``queue.Empty``).
        ``advance=False`` leaves the receiver's virtual clock untouched."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                self._check_poison_locked(me)
                best = self._earliest_locked(channel, group, me, ends)
                if best is not None:
                    _, end = best
                    msg = self._box(channel, group, me, end).get_nowait()
                    if advance:
                        self._check_alive(me, msg.arrival)
                        self._clock[me] = max(self._clock[me], msg.arrival)
                    return end, msg.payload, msg.arrival
                remaining = (
                    None if deadline is None else deadline - time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    raise queue.Empty
                if not self._cv.wait(timeout=remaining):
                    raise queue.Empty

    def _earliest_locked(
        self, channel: str, group: str, me: str, ends: Sequence[str]
    ) -> Optional[Tuple[float, str]]:
        best: Optional[Tuple[float, str]] = None
        for end in ends:
            box = self._box(channel, group, me, end)
            try:
                arrival = box.queue[0].arrival  # type: ignore[attr-defined]
            except IndexError:
                continue
            if best is None or arrival < best[0]:
                best = (arrival, end)
        return best

    def earliest(
        self, channel: str, group: str, me: str, ends: Sequence[str]
    ) -> Optional[Tuple[float, str]]:
        """Non-consuming query: ``(arrival, end)`` of the earliest available
        message from any of ``ends``, or ``None``."""
        with self._lock:
            return self._earliest_locked(channel, group, me, ends)

    def recv_fifo(
        self,
        channel: str,
        group: str,
        me: str,
        ends: Sequence[str],
        timeout: Optional[float],
    ) -> Iterable[Tuple[str, Any]]:
        """Drain one message from each end, yielding in emulated-arrival order."""
        msgs: List[Tuple[float, str, Any]] = []
        for end in ends:
            m = self._get_msg(channel, group, me, end, timeout)
            msgs.append((m.arrival, end, m.payload))
        msgs.sort(key=lambda t: t[0])
        with self._lock:
            if msgs:
                self._check_alive(me, msgs[-1][0])
                self._clock[me] = max(self._clock[me], msgs[-1][0])
        for _, end, payload in msgs:
            yield end, payload

    def peek(self, channel: str, group: str, me: str, end: str) -> Optional[Any]:
        box = self._box(channel, group, me, end)
        with self._lock:
            try:
                return box.queue[0].payload  # type: ignore[attr-defined]
            except IndexError:
                return None

    # ---------------------------- clocks ------------------------------ #
    def now(self, worker: str) -> float:
        with self._lock:
            return self._clock[worker]

    def advance(self, worker: str, seconds: float) -> None:
        """Advance a worker's emulated clock (models local compute time)."""
        with self._lock:
            self._check_alive(worker, self._clock[worker] + seconds)
            self._clock[worker] += seconds

    def set_clock(self, worker: str, at: float) -> None:
        """Force a worker's clock forward to ``at`` (arrival / re-join)."""
        with self._lock:
            self._clock[worker] = max(self._clock[worker], float(at))


_BACKEND_FACTORIES: Dict[str, Callable[[], TransportBackend]] = {}


def register_backend(name: str, factory: Callable[[], TransportBackend]) -> None:
    _BACKEND_FACTORIES[name] = factory


def registered_backends() -> List[str]:
    """Names of all registered transport backends."""
    return sorted(_BACKEND_FACTORIES)


register_backend("inproc", lambda: InprocBackend("inproc"))
register_backend("p2p-emu", lambda: InprocBackend("p2p-emu"))
register_backend("mqtt-emu", lambda: InprocBackend("mqtt-emu", shared_broker=True))
# "collective" channels are lowered onto a device mesh, not message-passed;
# the inproc instance only serves membership queries during emulation.
register_backend("collective", lambda: InprocBackend("collective"))


class ChannelManager:
    """Per-job channel fabric: instantiates one registered backend per
    channel spec and hands out ``ChannelEnd`` s to workers (the SDK's
    channel manager)."""

    def __init__(self, channel_specs: Sequence[ChannelSpec]):
        self._specs = {c.name: c for c in channel_specs}
        self._backends: Dict[str, TransportBackend] = {}
        for c in channel_specs:
            if c.backend not in _BACKEND_FACTORIES:
                raise KeyError(
                    f"unknown backend {c.backend!r} for channel {c.name!r}; "
                    f"registered: {sorted(_BACKEND_FACTORIES)}"
                )
            backend = _BACKEND_FACTORIES[c.backend]()
            backend.set_wire_dtype(c.name, c.wire_dtype)
            if getattr(c, "codec", ""):
                raise NotImplementedError(f"wire codec {c.codec!r} {_NOT_PORTED_WIRE}")
            self._backends[c.name] = backend

    def spec(self, channel: str) -> ChannelSpec:
        return self._specs[channel]

    def backend(self, channel: str) -> TransportBackend:
        return self._backends[channel]

    def end(
        self, channel: str, group: str, worker: str, join: bool = True
    ) -> ChannelEnd:
        spec = self._specs[channel]
        my_role = worker.rsplit("-", 1)[0]
        peer_role: Optional[str] = None
        a, b = spec.pair
        if a != b and my_role in (a, b):
            peer_role = b if my_role == a else a
        e = ChannelEnd(
            self._backends[channel], channel, group, worker, peer_role=peer_role
        )
        if join:
            e.join()
        return e

    def total_bytes(self, channel: str) -> float:
        return self._backends[channel].stats.get(f"bytes:{channel}", 0.0)

    def total_msgs(self, channel: str) -> int:
        """Messages moved over ``channel``."""
        return int(self._backends[channel].stats.get(f"msgs:{channel}", 0))

    def channel_stats(self, channel: str) -> Dict[str, float]:
        """Per-channel wire accounting: moved bytes and messages."""
        stats = self._backends[channel].stats
        return {
            "bytes": float(stats.get(f"bytes:{channel}", 0.0)),
            "msgs": float(stats.get(f"msgs:{channel}", 0.0)),
        }
