"""Socket transport behind the ``TransportBackend`` protocol (the port of
``repro.transport.multiproc``, for what the per-channel loopback runs).

A ``TransportHub`` (broker) owns the authoritative channel state —
membership, mailboxes, per-worker clocks, dropout/poison schedules, byte
accounting — in one ``InprocBackend``; every ``MultiprocBackend`` client
turns each operation into an RPC to the hub over a local TCP socket, with
payloads in the deterministic ``repro_torch.transport.wire`` format (no
pickle on the wire). Centralizing the shared-state semantics in one backend
means the conformance guarantees of ``InprocBackend`` carry over, as in the
paper's MQTT-broker deployment (§6.2). The hub runs on virtual clocks
unless made with ``wall_clock=True`` (the process launcher's sync jobs).

Devices: the hub keeps the frames it receives on the host, as numpy trees,
and only client ends move them to a device: a receive decodes the payload
onto the client's device (``set_device``; the job's device through
``ChannelManager``), where the ``int8_blocks`` codec dequantizes with the
CUDA kernel. Without a device set, a client places received tensors on the
card and raises where there is none. The one exception is a reduced topic
(``install_reduce``): the hub decodes its update frames onto the hub's
``device`` and folds them there with the streaming fold kernel; the partial
it delivers goes back to the host only when it is sent.

A ``ShardedTransportHub`` is one hub per groupBy label plus a root, and a
``ShardRouter`` the client that routes each op to the hub owning its group.

Each client thread keeps one persistent connection (the hub serves each
connection on its own thread), so a receive blocked in the hub never stalls
other operations. Exactly-once sessions (sequence numbers, the hub's replay
window, reconnect-resume-retransmit) make every op safe to retry. The
deterministic chaos plane sits on top: a hub armed with a ``FaultPlan``
severs a worker's connection (``conn_resets``) or restarts itself
(``hub_crashes``, ``simulate_crash``) at a seeded time, and the clients'
``_chaos_*`` hooks drive the session checks of the conformance suite. A
frame cut mid-stream is never decoded (``recv_obj`` reads a whole frame
first), and an op still running on a severed connection's serve thread
finishes into the replay cache, so a retransmitted upload is folded once.
"""
from __future__ import annotations

import collections
import itertools
import os
import queue
import socket
import threading
import time
import zlib
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from repro_torch.convert import resolve_device
from repro_torch.core.channels import (
    TRANSPORT_OPS,
    InprocBackend,
    LinkModel,
    WorkerDropped,
    register_backend,
)
from repro_torch.transport.wire import (
    WireCodec,
    WireError,
    decode_payload,
    encode_payload,
    encoded_size,
    make_codec,
    recv_obj,
    send_obj,
    to_device,
)

__all__ = [
    "DeferredAckError",
    "LoopbackMultiprocBackend",
    "MultiprocBackend",
    "ShardRouter",
    "ShardedTransportHub",
    "TransportHub",
    "hub_backend_factory",
    "make_backend_factory",
    "sharded_backend_factory",
]

# Process-unique suffix for client session ids: a session is one (client
# process, thread) stream of RPCs, so the id only has to be unique within
# the job — the pid guards against forked counters colliding.
_SESSION_IDS = itertools.count()


class DeferredAckError(ConnectionError):
    """Reconnect attempts exhausted with un-acked frames outstanding.

    With exactly-once sessions every connection fault is first handled by
    reconnect-resume-retransmit; this error surfaces only when that gives
    up (hub permanently gone), at which point the outcome of the frames
    still awaiting acks is unknowable. The first outstanding frame is
    attributed on the exception — ``op``/``channel``/``group``/``seq`` —
    so a lost fire-and-forget send names itself in test failures.
    """

    def __init__(
        self,
        message: str,
        op: Optional[str] = None,
        channel: Optional[str] = None,
        group: Optional[str] = None,
        seq: Optional[int] = None,
    ) -> None:
        super().__init__(message)
        self.op = op
        self.channel = channel
        self.group = group
        self.seq = seq


# ------------------------------------------------------------------ #
# error marshalling: exceptions cross the wire as (kind, args) tuples
# ------------------------------------------------------------------ #
def _encode_error(exc: BaseException) -> Tuple[str, list]:
    if isinstance(exc, WorkerDropped):
        return "worker_dropped", [exc.worker, float(exc.at)]
    if isinstance(exc, queue.Empty):
        return "empty", []
    if isinstance(exc, KeyError):
        return "key_error", [str(exc)]
    return "error", [f"{type(exc).__name__}: {exc}"]


def _raise_error(kind: str, args: Sequence[Any]) -> None:
    if kind == "worker_dropped":
        raise WorkerDropped(str(args[0]), float(args[1]))
    if kind == "empty":
        raise queue.Empty
    if kind == "key_error":
        raise KeyError(args[0])
    raise RuntimeError(f"transport hub error: {args[0]}")


class _HubSession:
    """Per-session exactly-once state: cached replies keyed by sequence
    number (the dedup/replay window) plus in-flight markers so a reconnected
    client can re-attach to an op still executing on a zombie serve thread.
    """

    __slots__ = ("lock", "replies", "inflight", "evicted_below")

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.replies: Dict[int, Tuple[str, Any]] = {}
        self.inflight: Dict[int, threading.Event] = {}
        self.evicted_below = 0


class TransportHub:
    """Socket-facing broker wrapping one shared backend for a whole job.

    All channels it serves route through the single inner backend (mailbox
    keys carry the channel name), like a broker hosting one topic tree. The
    owner reaches the inner backend directly via ``.backend`` for
    configuration (link models, dropout schedules) and byte-accounting
    reads. Bind port 0 (the default) to take any free port. ``device`` is
    where the reduce plane decodes and folds (the job's device);
    ``wall_clock`` maps real elapsed time onto the inner backend's clocks.
    """

    # hard cap on cached replies per session: normally the client's floor
    # evicts acked replies promptly, so the window only fills if a client
    # stops consuming acks — comfortably above MAX_PENDING_ACKS so a full
    # pipeline can always be replayed after a reconnect
    REPLAY_WINDOW = 1024

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        backend: Optional[InprocBackend] = None,
        backlog: int = 1024,
        device: Any = None,
        wall_clock: bool = False,
    ) -> None:
        self.backend = backend or InprocBackend("multiproc-hub", wall_clock=wall_clock)
        if device is not None:
            self.backend.set_device(device)
        self._backlog = max(1, int(backlog))
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        # a pool of 1k workers connects in one burst; an undersized backlog
        # turns that into connection-refused storms (the kernel may clamp to
        # net.core.somaxconn, and MultiprocBackend reconnects with backoff)
        self._sock.listen(self._backlog)
        self._closed = threading.Event()
        # exactly-once session state survives any individual connection (and
        # a simulated hub crash): sessions are keyed by the client-minted id,
        # not by the socket that carried them
        self._sessions: Dict[str, _HubSession] = {}
        self._sessions_lock = threading.Lock()
        self._counters = {"resumes:": 0.0, "replays:": 0.0, "dedup_hits:": 0.0}
        self._counters_lock = threading.Lock()
        # live client connections, severed by close() and simulate_crash()
        self._conns: List[socket.socket] = []
        self._conns_lock = threading.Lock()
        # armed chaos faults (a FaultPlan's), each one-shot
        self._fault_lock = threading.Lock()
        self._conn_resets: Dict[str, float] = {}
        self._crash_at: Optional[float] = None
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="transport-hub-accept", daemon=True
        )
        self._accept_thread.start()

    # ------------------------------------------------------------------ #
    @property
    def address(self) -> Tuple[str, int]:
        host, port = self._sock.getsockname()[:2]
        return str(host), int(port)

    # The driver-side fabric surface, mirrored by ``ShardedTransportHub`` so
    # the launcher drives a single hub or a sharded fabric through one API:
    # ``worker_address`` is what worker processes connect with (an address
    # here, an address map for the fabric) and ``engine_transport`` what the
    # EventEngine drives drop/poison/clock directives through.
    @property
    def worker_address(self) -> Tuple[str, int]:
        return self.address

    @property
    def engine_transport(self) -> InprocBackend:
        return self.backend

    @property
    def stats(self) -> Dict[str, float]:
        return self._merged_stats()

    def _merged_stats(self) -> Dict[str, float]:
        """Backend accounting plus the session-layer recovery counters
        (``resumes:`` / ``replays:`` / ``dedup_hits:``). Zero counters are
        omitted so fault-free runs keep byte-identical stats dicts across
        deployments."""
        out = dict(self.backend.stats)
        with self._counters_lock:
            for key, val in self._counters.items():
                if val:
                    out[key] = out.get(key, 0.0) + val
        return out

    def _bump(self, key: str, n: float = 1.0) -> None:
        with self._counters_lock:
            self._counters[key] = self._counters.get(key, 0.0) + n

    def set_wire_dtype(self, channel: str, dtype: str) -> None:
        self.backend.set_wire_dtype(channel, dtype)

    def set_link(self, channel: str, worker: str, model: LinkModel) -> None:
        self.backend.set_link(channel, worker, model)

    def close(self) -> None:
        """Stop accepting and shut down every live connection (their serve
        threads wake and exit). Idempotent."""
        self._closed.set()
        # shutdown BEFORE close: a blocked accept() holds a kernel reference
        # to the listening socket, so close() alone leaves the port accepting
        # one more connection and frees the fd under the blocked thread
        # (fd-reuse races against unrelated sockets). shutdown() wakes the
        # accept thread deterministically first.
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        self._accept_thread.join(timeout=2.0)
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            # shutdown, not close: the owning serve thread wakes on the read
            # fault and closes its own fd
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def __enter__(self) -> "TransportHub":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    # ------------------------------------------------------------------ #
    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # listener closed
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(
                target=self._serve_conn, args=(conn,),
                name="transport-hub-conn", daemon=True,
            ).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        with self._conns_lock:
            self._conns.append(conn)
        try:
            while True:
                try:
                    frame = recv_obj(conn)
                except (ConnectionError, OSError):
                    return  # client gone, the hub closing, or chaos severed us
                if len(frame) == 2:
                    # sessionless frame: the resume handshake itself, plus
                    # legacy 2-tuple callers (raw ping probes)
                    op, args = frame
                    if not self._serve_sessionless(conn, str(op), list(args)):
                        return
                    continue
                op, args, sid, seq, floor = frame
                if not self._serve_sessionful(
                    conn, str(op), list(args), str(sid), int(seq), int(floor)
                ):
                    return
        finally:
            with self._conns_lock:
                try:
                    self._conns.remove(conn)
                except ValueError:
                    pass
            try:
                conn.close()
            except OSError:
                pass

    def _serve_sessionless(
        self, conn: socket.socket, op: str, args: List[Any]
    ) -> bool:
        if op == "session_resume":
            # re-attach: make sure the session exists (its replay cache and
            # in-flight markers survive connection churn by construction)
            self._session(str(args[0]))
            self._bump("resumes:")
            reply: Tuple[str, Any] = ("ok", None)
        else:
            try:
                reply = ("ok", self._dispatch(op, args))
            except BaseException as exc:  # noqa: BLE001 - marshalled over
                reply = ("err", _encode_error(exc))
        return self._send_reply(conn, reply)

    def _serve_sessionful(
        self,
        conn: socket.socket,
        op: str,
        args: List[Any],
        sid: str,
        seq: int,
        floor: int,
    ) -> bool:
        if self._inject_fault(conn, args):
            return False  # connection severed before dispatch: the frame is lost
        sess = self._session(sid)
        cached: Optional[Tuple[str, Any]] = None
        wait_ev: Optional[threading.Event] = None
        with sess.lock:
            # the client's floor is the lowest seq still awaiting its ack:
            # every cached reply below it has been consumed and can go
            if floor > sess.evicted_below:
                for s in [s for s in sess.replies if s < floor]:
                    del sess.replies[s]
                sess.evicted_below = floor
            if seq in sess.replies:
                # duplicate of a completed op: replay the cached reply, do
                # NOT re-dispatch (the exactly-once guarantee)
                cached = sess.replies[seq]
            elif seq in sess.inflight:
                # duplicate of an op still executing (a blocked recv whose
                # original connection died): re-attach to its completion
                wait_ev = sess.inflight[seq]
            elif seq < sess.evicted_below:
                cached = ("err", ("error", [
                    f"seq {seq} outside the replay window (evicted below "
                    f"{sess.evicted_below}): duplicate arrived after its "
                    f"ack was already consumed"
                ]))
            else:
                sess.inflight[seq] = threading.Event()
        if wait_ev is not None:
            self._bump("dedup_hits:")
            wait_ev.wait()
            with sess.lock:
                cached = sess.replies.get(seq)
            if cached is None:  # pragma: no cover - executor always caches
                cached = ("err", ("error", [f"in-flight seq {seq} lost"]))
        if cached is not None:
            self._bump("dedup_hits:")
            self._bump("replays:")
            return self._send_reply(conn, cached)
        try:
            reply = ("ok", self._dispatch(op, args))
        except BaseException as exc:  # noqa: BLE001 - marshalled over
            reply = ("err", _encode_error(exc))
        # cache BEFORE the socket write: if the connection dies mid-reply,
        # the retransmitted frame replays this reply instead of re-running
        # the (possibly state-mutating) op
        with sess.lock:
            sess.replies[seq] = reply
            ev = sess.inflight.pop(seq, None)
            if len(sess.replies) > self.REPLAY_WINDOW:
                for s in sorted(sess.replies)[: -self.REPLAY_WINDOW]:
                    del sess.replies[s]
                    sess.evicted_below = max(sess.evicted_below, s + 1)
        if ev is not None:
            ev.set()
        return self._send_reply(conn, reply)

    def _send_reply(self, conn: socket.socket, reply: Tuple[str, Any]) -> bool:
        try:
            send_obj(conn, reply)
            return True
        except WireError as exc:
            # an unencodable dispatch result: send_obj encodes fully before
            # writing, so the stream is still clean — report the marshalling
            # failure instead of killing the handler
            try:
                send_obj(conn, ("err", _encode_error(exc)))
                return True
            except (ConnectionError, OSError):
                return False
        except (ConnectionError, OSError):
            return False

    def _session(self, sid: str) -> _HubSession:
        with self._sessions_lock:
            sess = self._sessions.get(sid)
            if sess is None:
                sess = self._sessions[sid] = _HubSession()
            return sess

    # --------------------- deterministic chaos plane -------------------- #
    def arm_faults(self, plan: Any) -> None:
        """Arm this hub with a ``FaultPlan``'s transport faults, each
        one-shot: ``conn_resets`` sever the connection carrying the first
        frame that names the worker once its clock passes ``at``;
        ``hub_crashes`` (shard key ``""`` for a single hub) trigger
        ``simulate_crash`` once fabric time passes ``at``."""
        crashes = dict(getattr(plan, "hub_crashes", {}) or {})
        unknown = [k for k in crashes if k != ""]
        if unknown:
            raise ValueError(
                f"unknown hub_crash shard key(s) {unknown!r} for a single "
                'hub (use "" for the root)'
            )
        self._arm_conn_resets(getattr(plan, "conn_resets", {}) or {})
        if "" in crashes:
            self._arm_crash(crashes[""])

    def _arm_crash(self, at: float) -> None:
        with self._fault_lock:
            self._crash_at = float(at)

    def _arm_conn_resets(self, resets: Dict[str, float]) -> None:
        with self._fault_lock:
            for worker, at in resets.items():
                self._conn_resets[str(worker)] = float(at)

    def _frame_worker(self, args: List[Any]) -> Optional[str]:
        """First armed worker named anywhere in a frame's arguments."""
        for a in args:
            if isinstance(a, str) and a in self._conn_resets:
                return a
            if isinstance(a, (list, tuple)):
                for b in a:
                    if isinstance(b, str) and b in self._conn_resets:
                        return b
        return None

    def _inject_fault(self, conn: socket.socket, args: List[Any]) -> bool:
        """The deterministic pre-dispatch fault check. True when the frame's
        connection was severed: the op did not run, so from the client's
        view the request is lost, and its session retry runs it exactly
        once. With nothing armed it costs two attribute reads; armed, one
        read of the worker clocks (``fabric_time``) per frame."""
        if self._crash_at is None and not self._conn_resets:
            return False
        crash = False
        reset = False
        with self._fault_lock:
            if (
                self._crash_at is not None
                and self.backend.fabric_time() >= self._crash_at
            ):
                self._crash_at = None
                crash = True
            elif self._conn_resets:
                worker = self._frame_worker(args)
                if (
                    worker is not None
                    and self.backend.now(worker) >= self._conn_resets[worker]
                ):
                    del self._conn_resets[worker]
                    reset = True
        if crash:
            self.simulate_crash()
            return True
        if reset:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            return True
        return False

    def simulate_crash(self) -> None:
        """Chaos hook: shut the listener and sever every live client
        connection, which is what a hub process's death looks like from
        outside, then listen again on the same port. Broker state
        (mailboxes, clocks, reduce accumulators on the hub's device,
        sessions) survives in-process: the restarted hub re-admits clients
        through the session layer, and ops still running on the severed
        connections' serve threads finish into the replay cache for the
        re-attached clients to collect."""
        host, port = self.address
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        self._accept_thread.join(timeout=2.0)
        with self._conns_lock:
            conns, self._conns = list(self._conns), []
        for conn in conns:
            # shutdown, not close: the owning serve thread wakes on the read
            # fault and closes its own fd
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((host, port))
        sock.listen(self._backlog)
        self._sock = sock
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="transport-hub-accept", daemon=True
        )
        self._accept_thread.start()
        self._bump("hub_restarts:")

    def _dispatch(self, op: str, args: List[Any]) -> Any:
        """Special-case the ops whose arguments/results need wire coercion;
        every other protocol op is a plain passthrough gated on
        ``TRANSPORT_OPS`` (new ops added to the protocol work over multiproc
        without touching this method)."""
        be = self.backend
        if op == "ping":
            return "pong"
        if op == "stats":
            return self._merged_stats()
        if op == "recv_any":
            channel, group, me, ends, timeout, advance = args
            end, payload, arrival = be.recv_any(
                channel, group, me, list(ends), timeout, advance=bool(advance)
            )
            return (end, payload, float(arrival))
        if op == "recv_fifo":
            channel, group, me, ends, timeout = args
            # materialize: the generator's clock advance and dropout check
            # run here; the client re-raises per-iteration (same surface)
            return list(be.recv_fifo(channel, group, me, list(ends), timeout))
        if op == "earliest":
            channel, group, me, ends = args
            got = be.earliest(channel, group, me, list(ends))
            return None if got is None else (float(got[0]), got[1])
        if op == "set_link":
            channel, worker, bandwidth, latency = args
            return be.set_link(
                channel, worker, LinkModel(float(bandwidth), float(latency))
            )
        if op == "link":
            model = be.link(*args)
            return (float(model.bandwidth), float(model.latency))
        if op == "now":
            return float(be.now(*args))
        if op in TRANSPORT_OPS:
            return getattr(be, op)(*args)
        raise RuntimeError(f"unknown transport op {op!r}")


class MultiprocBackend:
    """``TransportBackend`` client: every operation is an RPC to the hub.

    Stateless apart from per-thread sockets and per-channel codecs. Received
    payloads are decoded onto ``device`` (``set_device``); a send codes its
    float leaves on the device they lie on and ships numpy bodies.
    """

    # base delay of the capped exponential connect backoff (doubles per
    # attempt up to MAX_BACKOFF, scaled by deterministic per-client jitter)
    RETRY_BACKOFF = 0.05
    MAX_BACKOFF = 1.0
    # connect attempts after the first failure; REPRO_CONNECT_RETRIES
    # overrides it at call time
    CONNECT_RETRIES = 5
    # full reconnect-resume-retransmit cycles per op before giving up
    MAX_RECOVERIES = 3
    # max in-flight fire-and-forget sends per connection before the client
    # drains acks inline: bounds the hub's reply backlog (an ack frame is
    # ~tens of bytes, so the cap keeps worst-case buffered replies far under
    # any socket buffer — client writes and hub replies can never deadlock
    # on mutually full buffers)
    MAX_PENDING_ACKS = 256

    def __init__(
        self,
        address: Tuple[str, int],
        name: str = "multiproc",
        client_key: str = "",
        device: Any = None,
    ) -> None:
        self.name = name
        self.address = (str(address[0]), int(address[1]))
        self._device_: Optional[torch.device] = None
        if device is not None:
            self.set_device(device)
        # stable identity prefix for session ids and backoff jitter: the
        # launcher passes the worker id, so reconnect storms de-correlate
        # per worker deterministically (seed-derived, no wall-clock entropy)
        self.client_key = str(client_key)
        self._local = threading.local()
        # channel -> opt-in payload codec object (client-local: the hub
        # stores the coded payload opaquely; peers decode via the envelope
        # marker). Stateful codecs keep per-link error-feedback state inside
        # the instance, keyed by (channel, group, src, dst).
        self._codecs: Dict[str, WireCodec] = {}
        # client-side achieved-compression accounting per coded channel
        # (the hub only ever sees coded payloads, so the raw size — and the
        # achieved ratio — can only be measured here)
        self._codec_stats: Dict[str, float] = {}
        self._codec_stats_lock = threading.Lock()
        # every socket ever opened, across threads — close() must reach the
        # connections of worker threads that already finished, not just the
        # closing thread's own
        self._all_socks: List[socket.socket] = []
        self._socks_lock = threading.Lock()

    # ------------------------------------------------------------------ #
    def _state(self) -> Any:
        """Per-thread session state. A session is one thread's monotonic
        RPC stream: its id is minted once and survives every reconnect —
        the hub's dedup/replay window is keyed by it."""
        local = self._local
        if getattr(local, "session", None) is None:
            local.session = (
                f"{self.client_key or 'client'}|{os.getpid()}.{next(_SESSION_IDS)}"
            )
            local.seq = 0
            # frames written whose replies have not been consumed yet, in
            # order: replies arrive in frame order on a connection, so the
            # oldest entry always matches the next reply — and after a
            # fault this deque IS the retransmission queue
            local.unacked = collections.deque()
            # last two completed frames (chaos probes replay them)
            local.last_frames = collections.deque(maxlen=2)
            if getattr(local, "sock", None) is None:
                local.sock = None
        return local

    def _connect(self) -> socket.socket:
        """Dial the hub with capped exponential backoff and deterministic
        (seed-derived) jitter: each worker's schedule is a pure function of
        its client key, so a reconnect storm spreads out instead of
        thundering in lockstep. Attempts are bounded by
        ``REPRO_CONNECT_RETRIES`` when it is set (read on each call), else by
        ``CONNECT_RETRIES``."""
        st = self._state()
        retries = self.CONNECT_RETRIES
        env = os.environ.get("REPRO_CONNECT_RETRIES")
        if env:
            retries = max(0, int(env))
        for attempt in range(retries + 1):
            try:
                sock = socket.create_connection(self.address, timeout=30.0)
            except OSError:
                if attempt >= retries:
                    raise
                base = min(self.RETRY_BACKOFF * (2.0 ** attempt), self.MAX_BACKOFF)
                seed = f"{self.client_key}:{st.session}:{attempt}".encode()
                frac = zlib.crc32(seed) / 2.0 ** 32
                time.sleep(base * (0.5 + 0.5 * frac))
                continue
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # blocking after connect: receive waits are governed by the
            # hub's op timeout, not the socket's
            sock.settimeout(None)
            st.sock = sock
            with self._socks_lock:
                self._all_socks.append(sock)
            return sock
        raise ConnectionError("unreachable")  # pragma: no cover

    def _drop_sock(self) -> None:
        st = self._state()
        sock, st.sock = st.sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def _recover(self) -> socket.socket:
        """Reconnect-resume-retransmit: dial a fresh connection, re-attach
        the session hub-side, then replay every frame whose reply was never
        consumed. The hub's replay window answers already-executed frames
        from cache and executes the rest exactly once — so recovery is
        legal for ANY op, not just idempotent ones."""
        st = self._state()
        self._drop_sock()
        sock = self._connect()
        send_obj(sock, ("session_resume", [st.session]))
        status, value = recv_obj(sock)
        if status != "ok":  # pragma: no cover - resume never errors today
            kind, eargs = value
            _raise_error(str(kind), list(eargs))
        for frame in st.unacked:
            send_obj(sock, frame)
        return sock

    def _ensure_sock(self) -> socket.socket:
        st = self._state()
        if st.sock is not None:
            return st.sock
        if st.seq > 0 or st.unacked:
            return self._recover_or_fault()
        return self._connect()

    def _recover_or_fault(self) -> socket.socket:
        """Bounded recovery loop: on repeated failure, surface
        ``DeferredAckError`` (attributed to the first outstanding frame)
        when un-acked frames are at stake, else the connect error."""
        last: Optional[BaseException] = None
        for _ in range(self.MAX_RECOVERIES):
            try:
                return self._recover()
            except (ConnectionError, OSError) as exc:
                last = exc
                self._drop_sock()
        self._ack_fault(last)
        raise last  # pragma: no cover - _ack_fault always raises

    def _ack_fault(self, exc: Optional[BaseException]) -> None:
        """Give up on this thread's outstanding frames: reconnects are
        exhausted, so their outcome is ambiguous. Attribution (op, channel,
        group, seq) rides on the exception and in the drained-ack stats."""
        st = self._state()
        self._drop_sock()
        if not st.unacked:
            if exc is not None:
                raise exc
            raise ConnectionError("transport hub unreachable")
        op, args, _sid, seq, _floor = st.unacked[0]
        channel = str(args[0]) if args else None
        group = str(args[1]) if len(args) > 1 else None
        n = len(st.unacked)
        st.unacked.clear()
        with self._codec_stats_lock:
            key = f"ack_faults:{channel}"
            self._codec_stats[key] = self._codec_stats.get(key, 0.0) + 1.0
        raise DeferredAckError(
            f"reconnect attempts exhausted with {n} un-acked frame(s) "
            f"outstanding (first: op={op} channel={channel} group={group} "
            f"seq={seq})",
            op=str(op), channel=channel, group=group, seq=int(seq),
        ) from exc

    def _send_frame(self, op: str, args: List[Any]) -> None:
        """Write one sessionful frame ``(op, args, session, seq, floor)``.
        The frame enters the un-acked queue BEFORE the write, so a fault at
        any point is recovered by retransmission; the floor (oldest
        un-acked seq) tells the hub which cached replies are safe to
        evict."""
        st = self._state()
        seq = st.seq
        st.seq += 1
        floor = int(st.unacked[0][3]) if st.unacked else seq
        frame = [str(op), list(args), st.session, seq, floor]
        st.unacked.append(frame)
        for _ in range(self.MAX_RECOVERIES + 1):
            sock = st.sock
            if sock is None:
                # _recover retransmits the whole un-acked queue — including
                # this frame — so there is nothing left to write
                self._recover_or_fault()
                return
            try:
                send_obj(sock, frame)
                return
            except (ConnectionError, OSError):
                self._drop_sock()
        self._ack_fault(None)  # pragma: no cover - recover path raises first

    def _consume_reply(self) -> Tuple[str, Any]:
        """Read the reply for the oldest un-acked frame, recovering the
        connection (and re-attaching to a blocked op) on any fault."""
        st = self._state()
        recoveries = 0
        while True:
            sock = st.sock
            if sock is None:
                sock = self._recover_or_fault()
            try:
                status, value = recv_obj(sock)
            except (ConnectionError, OSError) as exc:
                recoveries += 1
                if recoveries > self.MAX_RECOVERIES:
                    self._ack_fault(exc)
                self._drop_sock()
                continue
            frame = st.unacked.popleft()
            st.last_frames.append(frame)
            return str(status), value

    def _drain_acks(self) -> None:
        """Collect the hub's replies for every fire-and-forget send still
        in flight on this thread. The first deferred error (e.g. a
        ``WorkerDropped`` from a send) is re-raised only after the stream
        is realigned — every pending reply consumed — so the connection
        stays usable. Connection faults mid-drain recover transparently;
        only exhausted reconnects surface (as ``DeferredAckError``)."""
        st = self._state()
        first_err: Optional[Tuple[str, List[Any]]] = None
        while st.unacked:
            status, value = self._consume_reply()
            if status != "ok" and first_err is None:
                first_err = (str(value[0]), list(value[1]))
        if first_err is not None:
            _raise_error(first_err[0], first_err[1])

    def _send_nowait(self, op: str, *args: Any) -> None:
        """Issue a send-family op fire-and-forget (pipelined): write the
        frame, defer collecting the hub's ack to the next synchronous op on
        this connection. A deferred fault therefore surfaces before the
        next op returns — after the session layer has already recovered
        everything recoverable."""
        st = self._state()
        self._ensure_sock()
        if len(st.unacked) >= self.MAX_PENDING_ACKS:
            self._drain_acks()
        self._send_frame(op, list(args))

    def _call(self, op: str, *args: Any) -> Any:
        """One synchronous RPC. Synchronous ops are the pipeline's ack
        barrier: deferred send faults surface here, before this op is
        dispatched. Any connection fault — before, during or after the
        hub's dispatch — is recovered by reconnect-resume-retransmit; the
        hub's per-session dedup window makes the retry exactly-once for
        every op (send, advance, recv*, ...), which is what licenses
        retrying non-idempotent ops at all."""
        st = self._state()
        self._ensure_sock()
        self._drain_acks()
        self._send_frame(op, list(args))
        status, value = self._consume_reply()
        if status == "ok":
            return value
        kind, eargs = value
        _raise_error(str(kind), list(eargs))

    # --------------------- deterministic chaos hooks -------------------- #
    def _chaos_break_conn(self) -> None:
        """Sever every live connection of this client (all threads) without
        touching session state: blocked threads wake on the read fault,
        reconnect, resume and re-attach. shutdown() rather than close() so
        a thread blocked inside recv_obj wakes at once and the owning
        thread keeps sole custody of its fd."""
        with self._socks_lock:
            socks = list(self._all_socks)
        for sock in socks:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def _raw_exchange(self, frames: Sequence[Any]) -> Tuple[str, Any]:
        """Replay pre-built frames over a fresh connection, the exact wire
        pattern of a crashed-and-reconnected client, returning the last
        reply. A test and conformance hook."""
        sock = socket.create_connection(self.address, timeout=30.0)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            status: str = "err"
            value: Any = None
            for frame in frames:
                send_obj(sock, frame)
                status, value = recv_obj(sock)
            return str(status), value
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def _chaos_duplicate(self, op: str, *args: Any) -> Tuple[Any, str, Any]:
        """Run one RPC normally, then replay its exact frame over a fresh
        connection (as a crash-retry would): returns (result, dup_status,
        dup_value). The duplicate must be answered from the hub's replay
        cache, never run again."""
        result = self._call(op, *args)
        st = self._state()
        frame = st.last_frames[-1]
        status, value = self._raw_exchange([("session_resume", [st.session]), frame])
        return result, status, value

    def _chaos_probe_evicted(self) -> Tuple[str, Any]:
        """Replay the second-newest completed frame: the newest frame's
        floor has evicted its cached reply, so the hub must answer with the
        replay-window error instead of running it again."""
        st = self._state()
        frame = st.last_frames[0]
        return self._raw_exchange([("session_resume", [st.session]), frame])

    def close(self) -> None:
        """Close every connection this client ever opened (all threads).
        Teardown-only: an in-flight call on another thread surfaces as a
        ConnectionError there."""
        # Drain this thread's deferred acks before closing: closing a socket
        # with unread replies in the kernel receive buffer resets (RST) the
        # stream, which may discard frames written but not yet read by the
        # hub — a worker whose *last* op was a fire-and-forget send (e.g. an
        # aggregator's final done-broadcast) would silently lose it. Once the
        # acks are in, the hub has processed every frame. Other threads'
        # pipelines are unreachable from here (un-acked queues are
        # thread-local); their owners drain at their own sync ops.
        if getattr(self._local, "sock", None) is not None and getattr(
            self._local, "unacked", None
        ):
            try:
                self._drain_acks()
            except Exception:
                pass
        with self._socks_lock:
            socks, self._all_socks = self._all_socks, []
        for sock in socks:
            try:
                sock.close()
            except OSError:
                pass
        self._local.sock = None
        if getattr(self._local, "unacked", None) is not None:
            self._local.unacked.clear()

    # --------------------------- membership --------------------------- #
    def join(self, channel: str, group: str, worker: str) -> None:
        self._call("join", channel, group, worker)

    def leave(self, channel: str, group: str, worker: str) -> None:
        self._call("leave", channel, group, worker)

    def peers(self, channel: str, group: str, me: str) -> List[str]:
        return list(self._call("peers", channel, group, me))

    # ---------------------------- messaging --------------------------- #
    def _bump_codec_stats(
        self, channel: str, raw: float, coded: float, encodes: float
    ) -> None:
        """Update the client-side accounting counters. The O(structure)
        counting walks run in the caller, outside the lock — the lock guards
        only the dict updates, so concurrent sender threads no longer
        serialize on payload-sized work."""
        with self._codec_stats_lock:
            stats = self._codec_stats
            if raw or coded:
                stats[f"raw_bytes:{channel}"] = (
                    stats.get(f"raw_bytes:{channel}", 0.0) + raw
                )
                stats[f"coded_bytes:{channel}"] = (
                    stats.get(f"coded_bytes:{channel}", 0.0) + coded
                )
            stats[f"payload_encodes:{channel}"] = (
                stats.get(f"payload_encodes:{channel}", 0.0) + encodes
            )

    def send(self, channel: str, group: str, src: str, dst: str, payload: Any) -> None:
        codec = self._codecs.get(channel)
        if codec is not None:
            coded = encode_payload(
                payload, codec, link=(channel, group, src, dst)
            )
            # O(structure) counting walks — the achieved ratio lands in
            # stats without re-serializing either payload
            raw = float(encoded_size(payload))
            enc = float(encoded_size(coded))
            self._bump_codec_stats(channel, raw, enc, 1.0)
            payload = coded
        else:
            payload = encode_payload(payload, "")
            self._bump_codec_stats(channel, 0.0, 0.0, 1.0)
        self._send_nowait("send", channel, group, src, dst, payload)

    def send_many(
        self, channel: str, group: str, src: str, dsts: Sequence[str], payload: Any
    ) -> None:
        """O(1)-encode fan-out: encode the payload once and ship ONE framed
        RPC; the hub delivers to every dst broker-side. Falls back to the
        per-dst ``send`` loop when the channel's codec is link-stateful
        (per-dst error-feedback residuals make per-dst payloads legitimately
        differ). Byte accounting equals the per-dst loop exactly: stateless
        encodes are deterministic, so N× one walk == sum of N walks."""
        dsts = list(dsts)
        if not dsts:
            return
        codec = self._codecs.get(channel)
        if codec is not None and codec.link_stateful:
            for dst in dsts:
                self.send(channel, group, src, dst, payload)
            return
        if codec is not None:
            coded = encode_payload(payload, codec, link=(channel, group, src))
            raw = float(encoded_size(payload)) * len(dsts)
            enc = float(encoded_size(coded)) * len(dsts)
            self._bump_codec_stats(channel, raw, enc, 1.0)
            payload = coded
        else:
            payload = encode_payload(payload, "")
            self._bump_codec_stats(channel, 0.0, 0.0, 1.0)
        self._send_nowait("send_many", channel, group, src, dsts, payload)

    def set_device(self, device: Any) -> None:
        """The device received payloads land on (the job's device)."""
        self._device_ = torch.device(device)

    def _device(self) -> torch.device:
        if self._device_ is None:
            self._device_ = resolve_device(None)
        return self._device_

    def _decode_in(self, channel: str, payload: Any) -> Any:
        """Decode one received frame onto this client's device: coded float
        leaves through their codec (dequantized on the card for
        ``int8_blocks``), every other array copied there. Every frame bumps
        ``payload_decodes:<channel>``, the receive-side twin of the encode
        counter."""
        with self._codec_stats_lock:
            self._codec_stats[f"payload_decodes:{channel}"] = (
                self._codec_stats.get(f"payload_decodes:{channel}", 0.0) + 1.0
            )
        device = self._device()
        return to_device(decode_payload(payload, device), device)

    def recv(
        self, channel: str, group: str, me: str, end: str, timeout: Optional[float]
    ) -> Any:
        return self._decode_in(
            channel, self._call("recv", channel, group, me, end, timeout)
        )

    def recv_any(
        self,
        channel: str,
        group: str,
        me: str,
        ends: Sequence[str],
        timeout: Optional[float],
        advance: bool = True,
    ) -> Tuple[str, Any, float]:
        end, payload, arrival = self._call(
            "recv_any", channel, group, me, list(ends), timeout, bool(advance)
        )
        return str(end), self._decode_in(channel, payload), float(arrival)

    def recv_fifo(
        self,
        channel: str,
        group: str,
        me: str,
        ends: Sequence[str],
        timeout: Optional[float],
    ) -> Iterable[Tuple[str, Any]]:
        def _gen() -> Iterable[Tuple[str, Any]]:
            # the RPC raises (queue.Empty / WorkerDropped) on first next(),
            # matching the inproc generator's consume-time semantics
            for end, payload in self._call(
                "recv_fifo", channel, group, me, list(ends), timeout
            ):
                yield str(end), self._decode_in(channel, payload)

        return _gen()

    def peek(self, channel: str, group: str, me: str, end: str) -> Optional[Any]:
        payload = self._call("peek", channel, group, me, end)
        if payload is None:
            return None
        return self._decode_in(channel, payload)

    def earliest(
        self, channel: str, group: str, me: str, ends: Sequence[str]
    ) -> Optional[Tuple[float, str]]:
        got = self._call("earliest", channel, group, me, list(ends))
        return None if got is None else (float(got[0]), str(got[1]))

    # ------------------- failure emulation / cancel -------------------- #
    def set_drop(self, worker: str, at: float) -> None:
        self._call("set_drop", worker, float(at))

    def clear_drop(self, worker: str) -> None:
        self._call("clear_drop", worker)

    def drop_time(self, worker: str) -> Optional[float]:
        got = self._call("drop_time", worker)
        return None if got is None else float(got)

    def poison(self, worker: str, at: float) -> None:
        self._call("poison", worker, float(at))

    def check_poison(self, worker: str) -> None:
        self._call("check_poison", worker)

    # ------------------------- configuration -------------------------- #
    def set_link(self, channel: str, worker: str, model: LinkModel) -> None:
        self._call(
            "set_link", channel, worker, float(model.bandwidth), float(model.latency)
        )

    def set_wire_dtype(self, channel: str, dtype: str) -> None:
        self._call("set_wire_dtype", channel, dtype)

    def set_codec(self, channel: str, codec: str) -> None:
        """Opt this channel into a wire payload codec (``repro_torch.transport
        .wire.WIRE_CODECS`` or a parametric name like ``"topk0.05"``): this
        client codes float leaves before they cross the socket, and any
        receiver decodes through the self-describing envelope. The codec is
        instantiated here, so a stateful codec's per-link state lives with
        the sender. The hub stores coded payloads opaquely; its byte
        accounting sees the coded arrays' element sizes. Unknown names
        raise ``WireError``."""
        if codec:
            self._codecs[channel] = make_codec(codec)
        else:
            self._codecs.pop(channel, None)

    def link(self, channel: str, worker: str) -> LinkModel:
        bandwidth, latency = self._call("link", channel, worker)
        return LinkModel(float(bandwidth), float(latency))

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
        """Install or remove the hub-side reduce spec of ``dst``'s incast.
        A synchronous RPC (it drains pipelined acks first), so every upload
        sent after it returns is folded hub-side; exactly-once on retry like
        every other op."""
        self._call("install_reduce", channel, group, dst, list(srcs), int(shards), fused)

    # ----------------------------- clocks ------------------------------ #
    def now(self, worker: str) -> float:
        return float(self._call("now", worker))

    def advance(self, worker: str, seconds: float) -> None:
        self._call("advance", worker, float(seconds))

    def set_clock(self, worker: str, at: float) -> None:
        self._call("set_clock", worker, float(at))

    # ------------------------------ stats ------------------------------ #
    @property
    def stats(self) -> Dict[str, float]:
        out = {str(k): float(v) for k, v in self._call("stats").items()}
        with self._codec_stats_lock:
            out.update(self._codec_stats)
        return out


def hub_backend_factory(
    address: Tuple[str, int], client_key: str = "", device: Any = None
) -> Callable[[Any], MultiprocBackend]:
    """A ``ChannelManager`` backend factory routing every channel spec through
    one shared hub client."""
    client = MultiprocBackend(address, client_key=client_key, device=device)
    return lambda spec: client


class ShardedTransportHub:
    """Subtree-sharded broker fabric: one hub per groupBy label plus a root.

    The paper's deployer provisions one broker per channel group (§6.2).
    Each shard key (a groupBy label of the TAG) gets its own
    ``TransportHub``; the root hub carries everything no shard owns (the
    implicit ``default`` group, so all cross-shard traffic). The routing key
    is the ``group`` argument every channel-scoped op already carries, so
    roles are untouched, and each (channel, group) topic lives on exactly
    one hub.

    Driver-side it exposes a single hub's fabric surface
    (``worker_address``, ``engine_transport``, ``stats``, the config
    setters) plus the ``EventEngine`` transport ops, which fan
    worker-scoped directives out to every hub: a worker has one fabric-wide
    clock, drop and poison state. Every hub folds reduced topics on
    ``device``.
    """

    def __init__(
        self,
        shards: Sequence[str],
        host: str = "127.0.0.1",
        wall_clock: bool = False,
        backlog: int = 1024,
        device: Any = None,
    ) -> None:
        self.root = TransportHub(
            host=host, backlog=backlog, device=device,
            backend=InprocBackend("multiproc-hub-root", wall_clock=wall_clock),
        )
        self.shards: Dict[str, TransportHub] = {}
        try:
            for key in sorted(set(shards)):
                self.shards[key] = TransportHub(
                    host=host, backlog=backlog, device=device,
                    backend=InprocBackend(f"multiproc-hub:{key}", wall_clock=wall_clock),
                )
        except BaseException:
            self.close()
            raise

    def hubs(self) -> List[TransportHub]:
        return [self.root, *self.shards.values()]

    @property
    def addresses(self) -> Dict[str, Tuple[str, int]]:
        """Shard key -> hub address, the root under key ``""``: what worker
        processes receive instead of one address (``ShardRouter``)."""
        out: Dict[str, Tuple[str, int]] = {"": self.root.address}
        for key, hub in self.shards.items():
            out[key] = hub.address
        return out

    @property
    def worker_address(self) -> Dict[str, Tuple[str, int]]:
        return self.addresses

    @property
    def engine_transport(self) -> "ShardedTransportHub":
        return self

    def _backend_for(self, group: str) -> InprocBackend:
        return self.shards.get(group, self.root).backend

    # ------------- EventEngine transport ops (driver-side) -------------- #
    def set_drop(self, worker: str, at: float) -> None:
        for hub in self.hubs():
            hub.backend.set_drop(worker, at)

    def clear_drop(self, worker: str) -> None:
        for hub in self.hubs():
            hub.backend.clear_drop(worker)

    def poison(self, worker: str, at: float) -> None:
        for hub in self.hubs():
            hub.backend.poison(worker, at)

    def set_clock(self, worker: str, at: float) -> None:
        for hub in self.hubs():
            hub.backend.set_clock(worker, at)

    def now(self, worker: str) -> float:
        return max(hub.backend.now(worker) for hub in self.hubs())

    def peers(self, channel: str, group: str, me: str) -> List[str]:
        return self._backend_for(group).peers(channel, group, me)

    def join(self, channel: str, group: str, worker: str) -> None:
        self._backend_for(group).join(channel, group, worker)

    def memberships(self, worker: str) -> List[Tuple[str, str]]:
        return [key for hub in self.hubs() for key in hub.backend.memberships(worker)]

    # ------------------- driver configuration / stats ------------------- #
    def set_wire_dtype(self, channel: str, dtype: str) -> None:
        # a channel's groups may live on different shards
        for hub in self.hubs():
            hub.backend.set_wire_dtype(channel, dtype)

    def set_link(self, channel: str, worker: str, model: LinkModel) -> None:
        for hub in self.hubs():
            hub.backend.set_link(channel, worker, model)

    @property
    def stats(self) -> Dict[str, float]:
        """Fabric-wide accounting: each topic lives on one hub, so the sums
        per key equal a single hub's totals."""
        out: Dict[str, float] = {}
        for hub in self.hubs():
            for k, v in hub.stats.items():
                out[k] = out.get(k, 0.0) + float(v)
        return out

    # --------------------- deterministic chaos plane -------------------- #
    def arm_faults(self, plan: Any) -> None:
        """Fan a ``FaultPlan`` across the fabric: ``hub_crashes`` route by
        shard key (``""`` is the root hub); ``conn_resets`` arm every hub,
        since a worker's frames may land on any shard it touches."""
        crashes = dict(getattr(plan, "hub_crashes", {}) or {})
        unknown = [k for k in crashes if k != "" and k not in self.shards]
        if unknown:
            raise ValueError(
                f"unknown hub_crash shard key(s) {unknown!r}; have "
                f"{['', *sorted(self.shards)]!r}"
            )
        resets = {
            str(w): float(t) for w, t in (getattr(plan, "conn_resets", {}) or {}).items()
        }
        for key, hub in (("", self.root), *self.shards.items()):
            if resets:
                hub._arm_conn_resets(resets)
            if key in crashes:
                hub._arm_crash(float(crashes[key]))

    def simulate_crash(self, shard: str = "") -> None:
        """Restart the hub of ``shard`` (the root for ``""``)."""
        self.shards.get(shard, self.root).simulate_crash()

    def close(self) -> None:
        for hub in self.hubs():
            try:
                hub.close()
            except OSError:  # pragma: no cover - teardown best-effort
                pass

    def __enter__(self) -> "ShardedTransportHub":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


class ShardRouter:
    """``TransportBackend`` client over a sharded hub fabric: one
    ``MultiprocBackend`` per hub, each op routed by its scope.

    * channel-scoped ops (membership, the send/recv family, peek, earliest,
      install_reduce) go to the hub owning the op's group, else the root;
    * worker-scoped writes (set_drop, clear_drop, poison, set_clock) fan out
      to every hub; ``now`` reads the max across hubs; ``advance`` levels
      every hub at that max, then steps them all, so each hub's dropout
      check runs against the schedule a single hub would apply;
      ``drop_time`` and ``check_poison`` are answered by the root;
    * channel config (set_link, set_wire_dtype, set_codec, set_device) fans
      out to every hub client.
    """

    def __init__(
        self,
        addresses: Dict[str, Tuple[str, int]],
        name: str = "multiproc",
        client_key: str = "",
        device: Any = None,
    ) -> None:
        self.name = name
        addrs = {str(k): (str(v[0]), int(v[1])) for k, v in addresses.items()}
        if "" not in addrs:
            raise ValueError('sharded address map needs a root hub under key ""')
        self._root = MultiprocBackend(
            addrs.pop(""), name=name, client_key=client_key, device=device)
        self._shards = {
            key: MultiprocBackend(addr, name=name, client_key=client_key, device=device)
            for key, addr in sorted(addrs.items())
        }
        self._all: List[MultiprocBackend] = [self._root, *self._shards.values()]

    def _be(self, group: str) -> MultiprocBackend:
        return self._shards.get(group, self._root)

    # --------------------------- membership --------------------------- #
    def join(self, channel: str, group: str, worker: str) -> None:
        self._be(group).join(channel, group, worker)

    def leave(self, channel: str, group: str, worker: str) -> None:
        self._be(group).leave(channel, group, worker)

    def peers(self, channel: str, group: str, me: str) -> List[str]:
        return self._be(group).peers(channel, group, me)

    # ---------------------------- messaging --------------------------- #
    def send(self, channel: str, group: str, src: str, dst: str, payload: Any) -> None:
        self._be(group).send(channel, group, src, dst, payload)

    def send_many(
        self, channel: str, group: str, src: str, dsts: Sequence[str], payload: Any
    ) -> None:
        # a (channel, group) topic lives on one shard: one encode per call
        self._be(group).send_many(channel, group, src, dsts, payload)

    def recv(
        self, channel: str, group: str, me: str, end: str, timeout: Optional[float]
    ) -> Any:
        return self._be(group).recv(channel, group, me, end, timeout)

    def recv_any(
        self,
        channel: str,
        group: str,
        me: str,
        ends: Sequence[str],
        timeout: Optional[float],
        advance: bool = True,
    ) -> Tuple[str, Any, float]:
        return self._be(group).recv_any(channel, group, me, ends, timeout, advance)

    def recv_fifo(
        self,
        channel: str,
        group: str,
        me: str,
        ends: Sequence[str],
        timeout: Optional[float],
    ) -> Iterable[Tuple[str, Any]]:
        return self._be(group).recv_fifo(channel, group, me, ends, timeout)

    def peek(self, channel: str, group: str, me: str, end: str) -> Optional[Any]:
        return self._be(group).peek(channel, group, me, end)

    def earliest(
        self, channel: str, group: str, me: str, ends: Sequence[str]
    ) -> Optional[Tuple[float, str]]:
        return self._be(group).earliest(channel, group, me, ends)

    # ------------------- failure emulation / cancel -------------------- #
    def set_drop(self, worker: str, at: float) -> None:
        for be in self._all:
            be.set_drop(worker, at)

    def clear_drop(self, worker: str) -> None:
        for be in self._all:
            be.clear_drop(worker)

    def drop_time(self, worker: str) -> Optional[float]:
        return self._root.drop_time(worker)

    def poison(self, worker: str, at: float) -> None:
        for be in self._all:
            be.poison(worker, at)

    def check_poison(self, worker: str) -> None:
        self._root.check_poison(worker)

    # ------------------------- configuration -------------------------- #
    def set_link(self, channel: str, worker: str, model: LinkModel) -> None:
        for be in self._all:
            be.set_link(channel, worker, model)

    def set_wire_dtype(self, channel: str, dtype: str) -> None:
        for be in self._all:
            be.set_wire_dtype(channel, dtype)

    def set_codec(self, channel: str, codec: str) -> None:
        for be in self._all:
            be.set_codec(channel, codec)

    def set_device(self, device: Any) -> None:
        for be in self._all:
            be.set_device(device)

    def link(self, channel: str, worker: str) -> LinkModel:
        return self._root.link(channel, worker)

    def install_reduce(
        self,
        channel: str,
        group: str,
        dst: str,
        srcs: Sequence[str],
        shards: int = 1,
        fused: Optional[bool] = None,
    ) -> None:
        # channel-scoped: the topic, and so its reduce state, lives on one hub
        self._be(group).install_reduce(channel, group, dst, srcs, shards, fused)

    # ----------------------------- clocks ------------------------------ #
    def now(self, worker: str) -> float:
        return max(be.now(worker) for be in self._all)

    def advance(self, worker: str, seconds: float) -> None:
        t = self.now(worker)
        for be in self._all:
            be.set_clock(worker, t)
        for be in self._all:
            be.advance(worker, seconds)

    def set_clock(self, worker: str, at: float) -> None:
        for be in self._all:
            be.set_clock(worker, at)

    @property
    def stats(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for be in self._all:
            for k, v in be.stats.items():
                out[k] = out.get(k, 0.0) + float(v)
        return out

    # --------------------- deterministic chaos hooks -------------------- #
    def _chaos_break_conn(self) -> None:
        for be in self._all:
            be._chaos_break_conn()

    def _chaos_duplicate(self, op: str, *args: Any) -> Tuple[Any, str, Any]:
        # channel-scoped ops carry (channel, group, ...): replay on the shard
        # client that owns the group's session
        group = str(args[1]) if len(args) > 1 else ""
        return self._be(group)._chaos_duplicate(op, *args)

    def _chaos_probe_evicted(self) -> Tuple[str, Any]:
        return self._root._chaos_probe_evicted()

    def close(self) -> None:
        for be in self._all:
            be.close()


def sharded_backend_factory(
    addresses: Dict[str, Tuple[str, int]], client_key: str = "", device: Any = None
) -> Callable[[Any], ShardRouter]:
    """``hub_backend_factory``'s sharded twin: every channel spec shares one
    ``ShardRouter``."""
    client = ShardRouter(addresses, client_key=client_key, device=device)
    return lambda spec: client


def make_backend_factory(
    address: Any, client_key: str = "", device: Any = None
) -> Callable[[Any], Any]:
    """Worker-side dispatch: a ``(host, port)`` address gives a single-hub
    client factory, a shard address map (``ShardedTransportHub.addresses``)
    a routing one. ``client_key`` (the worker id) seeds the session ids and
    the reconnect jitter."""
    if isinstance(address, dict):
        return sharded_backend_factory(address, client_key=client_key, device=device)
    return hub_backend_factory(
        (str(address[0]), int(address[1])), client_key=client_key, device=device
    )


class LoopbackMultiprocBackend(MultiprocBackend):
    """Self-contained socket-loopback transport for per-channel selection.

    Spins up a private hub and connects to it, so a TAG can flip a single
    channel's ``backend`` to ``"multiproc"`` and have that channel's traffic
    cross a real socket and the wire format (and its codec) while the rest
    of the job stays in-process — the §6.2 per-channel backend experiment
    with an actual transport.
    """

    def __init__(self, device: Any = None) -> None:
        self._own_hub = TransportHub(device=device)
        super().__init__(self._own_hub.address, name="multiproc", device=device)

    def set_device(self, device: Any) -> None:
        """The job's device, for received payloads and for the private
        hub's reduce fold."""
        super().set_device(device)
        self._own_hub.backend.set_device(device)

    def close(self) -> None:
        try:
            super().close()
        finally:
            self._own_hub.close()


# flipping a ChannelSpec to backend="multiproc" picks the loopback flavor
register_backend("multiproc", LoopbackMultiprocBackend)
