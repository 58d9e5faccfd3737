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

A socket-loopback transport, ``multiproc``, registers on import of
``repro_torch.transport``: its channel's payloads cross a real socket in the
wire format, coded by the channel's codec, while the rest of the job stays
in-process.

Payloads are trees whose leaves are ``torch.Tensor``s; on the in-process
backends they move by reference, never through the host. Wire cost is
computed from leaf sizes under the channel's ``wire_dtype``
(``payload_bytes``), counting exactly the leaves and item sizes the JAX
package counts; on a coded channel the in-process backends count the
post-codec bytes without running the codec.

The reduce plane (``install_reduce``): a backend can fold a reduced incast
topic's update frames itself, in sorted-source order per shard block, and
deliver one unfinalized partial per shard from ``wire.reduce_src(i)``. The
fold runs on the backend's device (``set_device``; the job's device through
``ChannelManager``), through the streaming fold kernel for float32 leaves.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
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


# Every operation a transport must provide; the conformance suite
# (``repro_torch.transport.conformance``) checks their presence and semantics.
TRANSPORT_OPS: Tuple[str, ...] = (
    # membership
    "join", "leave", "peers",
    # messaging
    "send", "send_many", "recv", "recv_any", "recv_fifo", "peek", "earliest",
    # failure emulation / cancellation
    "set_drop", "clear_drop", "drop_time", "poison", "check_poison",
    # link / wire configuration
    "set_link", "set_wire_dtype", "link",
    # clocks
    "now", "advance", "set_clock",
    # reduce plane
    "install_reduce",
)

# The session layer's transport-wide recovery counters, as a hub's stats
# name them (``ChannelManager.channel_stats`` and the process launcher's
# ``transport_recovery`` metric report them without the colon).
RECOVERY_COUNTERS: Tuple[str, ...] = ("resumes:", "replays:", "dedup_hits:", "hub_restarts:")


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

    # --------------------------- reduce plane -------------------------- #
    def install_reduce(
        self,
        channel: str,
        group: str,
        dst: str,
        srcs: Sequence[str],
        shards: int = 1,
        fused: Optional[bool] = None,
    ) -> None: ...


# Broadcast fan-out: when enabled (the default), ``ChannelEnd`` lowers a
# multi-destination send onto the backend's ``send_many`` (one encode, one
# RPC per broadcast); when disabled, it sends once per destination. Spawned
# workers inherit the environment variable, so one setting governs every
# process of a job; ordering, clocks and byte accounting are the same
# either way.
_FANOUT_ENABLED = os.environ.get("REPRO_BROADCAST_FANOUT", "1") not in ("0", "false")


def set_broadcast_fanout(enabled: bool) -> None:
    """Enable or disable the ``send_many`` broadcast path process-wide."""
    global _FANOUT_ENABLED
    _FANOUT_ENABLED = bool(enabled)


def broadcast_fanout_enabled() -> bool:
    return _FANOUT_ENABLED


# Hub-reduce kill switch: the reduce plane is opt-in per job (the
# ``reduce_plan`` hyperparameter), and this process-wide toggle can veto it
# everywhere. Spawned workers inherit the environment variable, so one
# setting governs every process of a job.
_HUB_REDUCE_ENABLED = os.environ.get("REPRO_HUB_REDUCE", "1") not in ("0", "false")


def set_hub_reduce(enabled: bool) -> None:
    """Enable or disable hub-side partial aggregation process-wide."""
    global _HUB_REDUCE_ENABLED
    _HUB_REDUCE_ENABLED = bool(enabled)


def hub_reduce_enabled() -> bool:
    return _HUB_REDUCE_ENABLED


def reduce_blocks(srcs: Sequence[str], shards: int) -> List[List[str]]:
    """Partition an incast's sources into the reduce plan's shard blocks:
    sorted sources, contiguous blocks, sizes as even as possible (the
    remainder up front). The one partition shared by the installing server
    and the reducing backend. ``[]`` when ``srcs`` is empty or
    ``shards < 1`` (reduce off)."""
    order = sorted(srcs)
    if not order or int(shards) < 1:
        return []
    n = min(int(shards), len(order))
    q, r = divmod(len(order), n)
    blocks: List[List[str]] = []
    i = 0
    for b in range(n):
        size = q + (1 if b < r else 0)
        blocks.append(order[i:i + size])
        i += size
    return blocks


# Decode pool of the per-frame incast path: ``recv_ordered`` fetches (and,
# on socket transports, decodes) the frames of several sources at once on
# its receiver's pool, while its caller still folds them in sorted-source
# order, so the fold's bytes are the sequential loop's. 0 or 1 receives one
# source at a time. Spawned workers inherit the environment variable.
_DECODE_POOL_WORKERS = int(os.environ.get("REPRO_DECODE_POOL", "4") or 0)
_DECODE_POOLS: Dict[str, Tuple[ThreadPoolExecutor, int]] = {}
_DECODE_POOLS_LOCK = threading.Lock()


def set_decode_pool(workers: int) -> None:
    """Set the receive-side decode concurrency (0 or 1: sequential)."""
    global _DECODE_POOL_WORKERS
    _DECODE_POOL_WORKERS = max(0, int(workers))


def decode_pool_workers() -> int:
    return _DECODE_POOL_WORKERS


# receiver -> [payloads its pooled ``recv_ordered`` holds now, the high-water mark
# since the last reset]: a payload counts from the moment its fetch returns
# until the caller asks for the next one (or the receive ends)
_HELD: Dict[str, List[int]] = {}
_HELD_LOCK = threading.Lock()


def _held_add_locked(receiver: str, n: int) -> None:
    c = _HELD.setdefault(receiver, [0, 0])
    c[0] += n
    c[1] = max(c[1], c[0])


def decode_pool_held(receiver: str) -> Tuple[int, int]:
    """``(held now, high-water mark)`` of the received payloads that
    ``receiver``'s pooled ``recv_ordered`` holds: at most ``workers + 1``."""
    with _HELD_LOCK:
        held, mark = _HELD.get(receiver, (0, 0))
        return held, mark


def reset_decode_pool_held(receiver: Optional[str] = None) -> None:
    """Restart the high-water mark at what is held now (every receiver's
    when ``receiver`` is None)."""
    with _HELD_LOCK:
        for r, c in _HELD.items():
            if receiver is None or r == receiver:
                c[1] = c[0]


def _decode_pool(receiver: str, workers: int) -> ThreadPoolExecutor:
    """``receiver``'s executor, built at first use and rebuilt larger when
    more workers are asked for. One per receiving worker, not one per
    process: a root and the intermediate aggregators below it may share a
    process (threads, a pool host), and a root whose fetches held every
    thread of a shared pool would starve the fetches its own uploads wait
    on. Each thread opens its own hub connection (a socket backend's
    sessions are per thread), so fetches from a hub overlap."""
    with _DECODE_POOLS_LOCK:
        pool, size = _DECODE_POOLS.get(receiver, (None, 0))
        if pool is None or size < workers:
            if pool is not None:
                pool.shutdown(wait=False)
            pool = ThreadPoolExecutor(max_workers=workers,
                                      thread_name_prefix=f"decode-pool-{receiver}")
            _DECODE_POOLS[receiver] = (pool, workers)
        return pool


@contextlib.contextmanager
def switches(decode_pool: Optional[int] = None, fanout: Optional[bool] = None):
    """Set the decode pool's workers and the broadcast fan-out in this
    process and in the environment that worker processes spawned meanwhile
    inherit; both are restored on exit. ``None`` leaves a switch as it is."""
    saved = {k: os.environ.get(k) for k in ("REPRO_DECODE_POOL", "REPRO_BROADCAST_FANOUT")}
    was = (decode_pool_workers(), broadcast_fanout_enabled())
    if decode_pool is not None:
        os.environ["REPRO_DECODE_POOL"] = str(int(decode_pool))
        set_decode_pool(decode_pool)
    if fanout is not None:
        os.environ["REPRO_BROADCAST_FANOUT"] = "1" if fanout else "0"
        set_broadcast_fanout(fanout)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        set_decode_pool(was[0])
        set_broadcast_fanout(was[1])


def _on_callers_stream(fn: Callable[..., Any]) -> Callable[..., Any]:
    """``fn`` run, on a pool thread, on the CUDA stream current in the
    calling thread: the kernels a decode launches (copies, dequantize) are
    then ordered before whatever the caller launches on the result."""
    if not torch.cuda.is_initialized():
        return fn
    stream = torch.cuda.current_stream()

    def run(*args: Any) -> Any:
        with torch.cuda.stream(stream):
            return fn(*args)

    return run


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
        """Send one payload to several destinations: through the backend's
        ``send_many`` while the fan-out switch is on
        (``set_broadcast_fanout``), else one ``send`` per destination.
        Ordering, clocks and byte accounting are the same either way."""
        if not ends:
            return
        if _FANOUT_ENABLED and len(ends) > 1:
            self._backend.send_many(self.channel, self.group, self.me, list(ends), msg)
        else:
            for end in ends:
                self.send(end, msg)

    def broadcast(self, msg: Any) -> None:
        self.send_many(self.ends(), msg)

    def install_reduce(self, srcs: Sequence[str], shards: int = 1) -> None:
        """Install (or, with empty ``srcs`` or ``shards < 1``, remove) a
        backend-side reduce spec for this end's incast: while installed,
        this end receives one partial frame per shard (from
        ``wire.reduce_src(i)``) instead of one frame per source. The
        ``bytes:``/``msgs:`` accounting of the uploads is unchanged; the
        folded frames count in ``hub_reduced:`` and ``hub_partials:``."""
        self._backend.install_reduce(self.channel, self.group, self.me, list(srcs), int(shards))

    def recv_ordered(self, ends: Sequence[str], timeout: Optional[float] = 30.0):
        """Receive one message from each of ``ends``, yielding
        ``(end, payload)`` in sorted-``ends`` order — the fold order that
        keeps aggregation bit-identical whatever the arrival order.

        With the decode pool on (``set_decode_pool``, more than one worker)
        the fetches run on the pool, at most ``workers`` ahead of the one
        yielded: the caller holds at most ``workers + 1`` received payloads
        at once (``decode_pool_held`` reads the count and its high-water
        mark). What a fetch raises surfaces at its sorted position, after
        every earlier source was yielded, as in the sequential loop."""
        order = sorted(ends)
        workers = decode_pool_workers()
        if workers <= 1 or len(order) <= 1:
            for end in order:
                yield end, self.recv(end, timeout=timeout)
            return
        me = self.me
        pool = _decode_pool(me, workers)
        recv = _on_callers_stream(self._backend.recv)
        rest = iter(order)
        # (end, future, counted): ``counted`` gets an entry when the fetch's
        # payload starts to count as held, which stops once the receive ends
        pending: collections.deque = collections.deque()
        live = [True]

        def fetch(counted: list, end: str) -> Any:
            msg = recv(self.channel, self.group, me, end, timeout)
            with _HELD_LOCK:
                if live[0]:
                    counted.append(end)
                    _held_add_locked(me, 1)
            return msg

        def submit(end: str) -> None:
            counted: list = []
            pending.append((end, pool.submit(fetch, counted, end), counted))

        try:
            for end in itertools.islice(rest, workers):
                submit(end)
            while pending:
                end, fut, counted = pending[0]
                msg = fut.result()
                pending.popleft()
                nxt = next(rest, None)
                if nxt is not None:
                    submit(nxt)
                try:
                    yield end, msg
                finally:
                    del msg
                    with _HELD_LOCK:
                        _held_add_locked(me, -len(counted))
        finally:
            with _HELD_LOCK:
                live[0] = False
                _held_add_locked(me, -sum(len(c) for _, _, c in pending))
            for _, fut, _ in pending:
                fut.cancel()

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


class _ReduceState:
    """Backend-side partial-aggregation state of one reduced incast topic.

    ``blocks`` is the shard partition from :func:`reduce_blocks`. Arriving
    updates wait in ``pending`` until they can be folded in sorted-source
    order (a cursor per block), so a partial's bytes do not depend on the
    arrival order. When a block's cursor completes, one partial frame is
    delivered and the block resets for the next round."""

    def __init__(self, blocks: List[List[str]]) -> None:
        self.blocks = blocks
        self.block_of: Dict[str, int] = {s: i for i, b in enumerate(blocks) for s in b}
        self.pending: List[Dict[str, Tuple[Any, float]]] = [{} for _ in blocks]
        self.cursor: List[int] = [0] * len(blocks)
        self.acc: List[Any] = [None] * len(blocks)
        self.hwm: List[float] = [0.0] * len(blocks)  # latest folded arrival


class InprocBackend:
    """Thread-safe in-process message transport with an emulated clock.

    Every (channel, group) is a mailbox keyed by (dst, src). Virtual time
    advances by each message's modeled transfer duration; ``recv`` blocks
    the receiving thread until real delivery, while each message's
    ``arrival`` records the *emulated* completion time.

    ``wall_clock=True`` maps real elapsed time onto the same clock API: a
    worker's clock never falls behind the wall-clock seconds since the
    backend was made (the process launcher's hub runs a plain sync job so).

    ``set_device`` names the device the reduce plane folds on: a reduced
    topic's frames are decoded there (an ``int8_blocks`` frame through the
    dequantize kernel on the card) and folded by the streaming fold kernel.
    Without a device, it folds on the card, and raises where there is none.
    """

    def __init__(
        self, name: str = "inproc", shared_broker: bool = False, wall_clock: bool = False
    ):
        self.name = name
        self.shared_broker = shared_broker
        self.wall_clock = wall_clock
        self._t0 = time.monotonic()
        self._device: Optional[torch.device] = None
        # reduce plane: (channel, group, dst) -> backend-side fold state
        self._reduce: Dict[Tuple[str, str, str], _ReduceState] = {}
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)  # signaled on every delivery
        self._members: Dict[Tuple[str, str], List[str]] = collections.defaultdict(list)
        self._boxes: Dict[Tuple[str, str, str, str], "queue.Queue[Message]"] = {}
        self._links: Dict[Tuple[str, str], LinkModel] = {}
        self._wire_dtype: Dict[str, str] = {}
        # channel -> codec object used for *accounting only*: emulated
        # payloads never leave the process, but a coded channel's transfer
        # time and byte stats must reflect post-codec wire bytes
        self._codec_acct: Dict[str, Any] = {}
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

    def set_codec(self, channel: str, codec: str) -> None:
        """Account ``channel``'s emulated wire bytes post-codec.

        The codec is never run here (payloads stay in the process), but a
        coded channel's ``transfer_time`` and ``stats["bytes:..."]`` follow
        the codec's wire bytes; the raw size is kept in
        ``raw_bytes:<channel>``. Unknown codec names raise ``WireError``."""
        from repro_torch.transport.wire import make_codec

        if codec:
            self._codec_acct[channel] = make_codec(codec)
        else:
            self._codec_acct.pop(channel, None)

    def link(self, channel: str, worker: str) -> LinkModel:
        return self._links.get((channel, worker), LinkModel())

    def set_device(self, device: Any) -> None:
        """The device the reduce plane decodes and folds on."""
        self._device = torch.device(device)

    def _wall(self) -> float:
        return time.monotonic() - self._t0

    # --------------------------- reduce plane -------------------------- #
    def install_reduce(
        self,
        channel: str,
        group: str,
        dst: str,
        srcs: Sequence[str],
        shards: int = 1,
        fused: Optional[bool] = None,
    ) -> None:
        """Install or replace (or, with empty ``srcs`` or ``shards < 1``,
        remove) the reduce spec of one incast topic. An absolute-state write
        like ``set_link``: installing resets the topic's fold for a fresh
        round. The installing server issues it before the broadcast that
        triggers the round's uploads, so no update races the spec.
        ``fused`` is accepted for the JAX package's signature and ignored."""
        key = (channel, group, dst)
        blocks = reduce_blocks(srcs, shards)
        with self._lock:
            if not blocks:
                self._reduce.pop(key, None)
            else:
                self._reduce[key] = _ReduceState(blocks)

    def _reduce_ingest(
        self, channel: str, group: str, dst: str, state: _ReduceState,
        src: str, payload: Any, arrival: float,
    ) -> bool:
        """Fold one arriving update frame backend-side. Caller holds the lock
        (the JAX package's semantics: every other operation waits while a
        frame decodes and folds).

        Returns True when the frame was absorbed; False lets the caller
        deliver it normally: a frame that is not a weight-sync update (no
        ``weights`` after the codec's decode) is never swallowed."""
        from repro_torch.core.roles import StreamingMean
        from repro_torch.transport.wire import (
            decode_payload, pack_hub_partial, reduce_src, to_device)

        # no device set: the card (a CPU-only host raises, never falls back)
        device = self._device if self._device is not None else torch.device("cuda")
        decoded = decode_payload(payload, device)
        if not isinstance(decoded, dict) or "weights" not in decoded:
            return False
        decoded = to_device(decoded, device)
        i = state.block_of[src]
        state.pending[i][src] = (decoded, arrival)
        self.stats[f"hub_reduced:{channel}"] += 1
        block = state.blocks[i]
        cur = state.cursor[i]
        while cur < len(block) and block[cur] in state.pending[i]:
            upd, arr = state.pending[i].pop(block[cur])
            if state.acc[i] is None:
                state.acc[i] = StreamingMean(device=device)
            state.acc[i].fold(upd["weights"], float(upd.get("num_samples", 1)))
            state.hwm[i] = max(state.hwm[i], arr)
            cur += 1
        state.cursor[i] = cur
        if cur == len(block):
            acc_tree, total = state.acc[i].partial()
            part = pack_hub_partial(i, block, acc_tree, total, state.acc[i].count)
            wire = self._wire_dtype.get(channel, "f32")
            self._box(channel, group, dst, reduce_src(i)).put(
                Message(reduce_src(i), part, payload_bytes(acc_tree, wire), state.hwm[i])
            )
            self.stats[f"hub_partials:{channel}"] += 1
            # reset the block for the next round (the spec stays installed)
            state.acc[i] = None
            state.cursor[i] = 0
            state.hwm[i] = 0.0
        return True

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

    def memberships(self, worker: str) -> List[Tuple[str, str]]:
        """The (channel, group) pairs ``worker`` is a member of."""
        with self._lock:
            return [key for key, members in self._members.items() if worker in members]

    # ---------------------------- transport ---------------------------- #
    def _box(self, channel: str, group: str, dst: str, src: str) -> "queue.Queue[Message]":
        key = (channel, group, dst, src)
        with self._lock:
            if key not in self._boxes:
                self._boxes[key] = queue.Queue()
            return self._boxes[key]

    def _deliver_locked(
        self, channel: str, group: str, src: str, dst: str, payload: Any,
        nbytes: int, dur: float, raw_bytes: Optional[int],
    ) -> None:
        """One transfer's clock/broker/dropout arithmetic and delivery.
        Caller holds the lock."""
        topic = (channel, group, dst)
        start = self._clock[src]
        if self.wall_clock:
            start = max(start, self._wall())
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
        if raw_bytes is not None:
            self.stats[f"raw_bytes:{channel}"] += raw_bytes
        state = self._reduce.get(topic)
        if not (
            state is not None
            and src in state.block_of
            and self._reduce_ingest(channel, group, dst, state, src, payload, arrival)
        ):
            self._box(channel, group, dst, src).put(Message(src, payload, nbytes, arrival))

    def send(self, channel: str, group: str, src: str, dst: str, payload: Any) -> None:
        self.send_many(channel, group, src, [dst], payload)

    def send_many(
        self, channel: str, group: str, src: str, dsts: Sequence[str], payload: Any
    ) -> None:
        """Deliver one payload to every dst: the payload is sized once, and
        the per-destination arithmetic runs under one lock hold, so arrivals,
        stats and dropout behavior equal the ``for dst: send(dst)`` loop.
        The same payload object is delivered by reference to each mailbox.
        On a coded channel the bytes counted (and timed) are the codec's
        wire bytes, and the raw ones go to ``raw_bytes:<channel>``."""
        if not dsts:
            return
        wire = self._wire_dtype.get(channel, "f32")
        codec = self._codec_acct.get(channel)
        raw_bytes = payload_bytes(payload, wire)
        nbytes = raw_bytes if codec is None else codec.wire_bytes(payload, wire)
        dur = self.link(channel, src).transfer_time(nbytes)
        raw = None if codec is None else raw_bytes
        with self._lock:
            try:
                for dst in dsts:
                    self._deliver_locked(
                        channel, group, src, dst, payload, nbytes, dur, raw
                    )
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
            if self.wall_clock:
                t = self._wall()
                # a dropped worker's clock stays frozen at its dropout time:
                # wall time must not resurrect it
                drop_at = self._drop_at.get(worker)
                if drop_at is not None:
                    t = min(t, drop_at)
                self._clock[worker] = max(self._clock[worker], t)
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

    def fabric_time(self) -> float:
        """The largest worker clock: how far the job has progressed, which
        the hub's fault plane reads to fire a seeded hub crash at its
        time."""
        with self._lock:
            return max(self._clock.values(), default=0.0)


def recv_any_multi(
    sources: Sequence[Tuple[ChannelEnd, Sequence[str]]],
    timeout: Optional[float] = None,
    poll: float = 0.005,
) -> Tuple[ChannelEnd, str, Any, float]:
    """Earliest available message across several channels.

    ``sources`` is ``[(channel_end, candidate_peers), ...]``: typically an
    intermediate aggregator's down channel (trainer updates) and up channel
    (root broadcasts), which live on different backends and so cannot share
    one condition variable. Returns ``(end, src, payload, arrival)`` for the
    globally earliest message, advancing the receiver's clock on the winning
    backend only (callers bridge clocks across backends themselves).

    Raises ``queue.Empty`` on timeout and ``WorkerDropped`` if the receiver
    is poisoned or dropped on any involved backend.
    """

    def _scan() -> Optional[Tuple[float, ChannelEnd, str]]:
        best: Optional[Tuple[float, ChannelEnd, str]] = None
        for end, peers in sources:
            if not peers:
                continue
            cand = end.earliest(peers)
            if cand is not None and (best is None or cand[0] < best[0]):
                best = (cand[0], end, cand[1])
        return best

    deadline = None if timeout is None else time.monotonic() + timeout
    while True:
        best = _scan()
        if best is not None:
            # settle: near-simultaneous wall-clock senders may not all have
            # enqueued yet; one short extra poll keeps virtual-arrival order
            # from being decided by thread scheduling
            time.sleep(min(poll, 0.002))
            best = _scan() or best
            _, end, src = best
            # single-consumer mailboxes: the message seen by earliest() can
            # only be taken by us, so a short timeout is a safety net
            s, payload, arrival = end.recv_any([src], timeout=1.0)
            return end, s, payload, arrival
        for end, _ in sources:
            end.check_poison()
        if deadline is not None and time.monotonic() >= deadline:
            raise queue.Empty
        time.sleep(poll)


_BACKEND_FACTORIES: Dict[str, Callable[[], TransportBackend]] = {}


def register_backend(name: str, factory: Callable[[], TransportBackend]) -> None:
    _BACKEND_FACTORIES[name] = factory


def registered_backends() -> List[str]:
    """Names of all registered transport backends."""
    return sorted(_BACKEND_FACTORIES)


def backend_factory(name: str) -> Callable[[], TransportBackend]:
    if name not in _BACKEND_FACTORIES:
        raise KeyError(
            f"unknown backend {name!r}; registered: {sorted(_BACKEND_FACTORIES)}"
        )
    return _BACKEND_FACTORIES[name]


register_backend("inproc", lambda: InprocBackend("inproc"))
register_backend("p2p-emu", lambda: InprocBackend("p2p-emu"))
register_backend("mqtt-emu", lambda: InprocBackend("mqtt-emu", shared_broker=True))
# "collective" channels are lowered onto a device mesh, not message-passed;
# the inproc instance only serves membership queries during emulation.
register_backend("collective", lambda: InprocBackend("collective"))


class ChannelManager:
    """Per-job channel fabric: instantiates one registered backend per
    channel spec and hands out ``ChannelEnd`` s to workers (the SDK's
    channel manager).

    ``backend_factory`` overrides the registry lookup with a per-spec
    factory. ``device`` is the job's device: a backend that moves payloads
    onto a device (the ``multiproc`` loopback's client ends) receives it
    through its ``set_device`` op; without one such a backend places
    received tensors on the card, and raises where there is none.
    """

    def __init__(
        self,
        channel_specs: Sequence[ChannelSpec],
        backend_factory: Optional[Callable[[ChannelSpec], TransportBackend]] = None,
        device: Any = None,
    ):
        self._specs = {c.name: c for c in channel_specs}
        self._backends: Dict[str, TransportBackend] = {}
        try:
            for c in channel_specs:
                self._backends[c.name] = self._make_backend(c, backend_factory, device)
        except BaseException:
            self.close()  # a loopback hub made before the failure
            raise

    def _make_backend(
        self,
        c: ChannelSpec,
        backend_factory: Optional[Callable[[ChannelSpec], TransportBackend]],
        device: Any,
    ) -> TransportBackend:
        if backend_factory is not None:
            backend = backend_factory(c)
        else:
            if c.backend not in _BACKEND_FACTORIES:
                # the socket-backed flavor registers on import of the
                # transport package
                import repro_torch.transport  # noqa: F401
            if c.backend not in _BACKEND_FACTORIES:
                raise KeyError(
                    f"unknown backend {c.backend!r} for channel {c.name!r}; "
                    f"registered: {sorted(_BACKEND_FACTORIES)}"
                )
            backend = _BACKEND_FACTORIES[c.backend]()
        try:
            backend.set_wire_dtype(c.name, c.wire_dtype)
            # opt-in wire codec: the socket transport runs it on the send
            # path; the in-process backends account post-codec bytes only.
            # Like set_device, the op is outside the TransportBackend protocol.
            codec = getattr(c, "codec", "")
            set_codec = getattr(backend, "set_codec", None)
            if codec and set_codec is not None:
                set_codec(c.name, codec)
            set_device = getattr(backend, "set_device", None)
            if device is not None and set_device is not None:
                set_device(device)
        except BaseException:
            close = getattr(backend, "close", None)
            if close is not None:
                close()
            raise
        return backend

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
        """Per-channel wire accounting: moved bytes and messages plus, on
        coded channels, the raw (pre-codec) bytes and the achieved ratio.
        In-process backends report emulated post-codec bytes; the multiproc
        client reports the measured sizes of the real coded frames and its
        encode/decode counts."""
        stats = self._backends[channel].stats
        out: Dict[str, float] = {
            "bytes": float(stats.get(f"bytes:{channel}", 0.0)),
            "msgs": float(stats.get(f"msgs:{channel}", 0.0)),
        }
        raw = stats.get(f"raw_bytes:{channel}")
        if raw:
            coded = stats.get(f"coded_bytes:{channel}", out["bytes"])
            out["raw_bytes"] = float(raw)
            out["codec_ratio"] = float(coded) / float(raw)
        for key in ("payload_encodes", "payload_decodes"):
            val = stats.get(f"{key}:{channel}")
            if val is not None:
                out[key] = float(val)
        # session layer: recovery counters are transport-wide, surfaced here
        # so a test reads "recovery happened" off the same dict
        for key in RECOVERY_COUNTERS:
            val = stats.get(key)
            if val:
                out[key.rstrip(":")] = float(val)
        return out

    def codec_ratio(self, channel: str) -> Optional[float]:
        """Achieved wire-compression ratio on ``channel`` (coded / raw
        bytes), or ``None`` when no coded traffic has been observed."""
        return self.channel_stats(channel).get("codec_ratio")

    def close(self) -> None:
        """Release transports that hold OS resources (the multiproc loopback
        owns a listening hub and sockets); idempotent."""
        for backend in self._backends.values():
            close = getattr(backend, "close", None)
            if close is not None:
                close()
