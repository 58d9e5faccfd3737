"""Shared transport-conformance suite and reference workload (the port of
``repro.transport.conformance``).

Every ``TransportBackend`` of the port — inproc, mqtt-emu, p2p-emu,
collective, the multiproc loopback — must pass the same semantics checks;
``tests/test_torch_transport.py`` runs them over every registered backend
and a shared hub. Each check takes a zero-argument ``factory`` producing a
**fresh** backend and raises ``AssertionError`` on a violation. Payloads
are tensor trees, as the port's roles send them; received tensors are
compared on the host.

The three session checks drive a connection-oriented backend's chaos hooks
(``_chaos_break_conn``, ``_chaos_duplicate``, ``_chaos_probe_evicted``); a
backend without them has no connection to lose and passes them vacuously.

``check_codec_roundtrip`` holds one codec to the JAX package's fixture set.
``SeededSGDTrainer`` is the reference workload for cross-deployment
equivalence.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.channels import (
    TRANSPORT_OPS,
    ChannelEnd,
    LinkModel,
    TransportBackend,
    WorkerDropped,
    recv_any_multi,
)
from repro_torch.core.roles import StreamingMean, Trainer
from repro_torch.core.tree import tree_leaves
from repro_torch.data.datasets import synthetic_classification

Factory = Callable[[], TransportBackend]

CH, G = "conf-ch", "default"


def _t(x: np.ndarray) -> torch.Tensor:
    """A payload leaf as the port's roles send it."""
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x: Any) -> np.ndarray:
    """A received leaf on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _pair(backend: TransportBackend, a: str = "a-0", b: str = "b-0"):
    backend.join(CH, G, a)
    backend.join(CH, G, b)
    return (
        ChannelEnd(backend, CH, G, a),
        ChannelEnd(backend, CH, G, b),
    )


# ------------------------------------------------------------------ #
# checks
# ------------------------------------------------------------------ #
def check_protocol_surface(factory: Factory) -> None:
    """Every protocol op exists and is callable; name/stats attributes too."""
    be = factory()
    for op in TRANSPORT_OPS:
        assert callable(getattr(be, op, None)), f"missing transport op {op!r}"
    assert isinstance(be.name, str) and be.name
    assert hasattr(be, "stats")


def check_send_recv_roundtrip(factory: Factory) -> None:
    """A nested pytree with float32 arrays round-trips bit-exactly."""
    be = factory()
    ea, eb = _pair(be)
    payload = {
        "weights": {
            "w": _t(np.arange(12, dtype=np.float32).reshape(3, 4) * np.float32(0.1)),
            "b": torch.zeros((4,), dtype=torch.float32),
        },
        "num_samples": 7,
        "tags": ["x", "y"],
        "done": False,
        "version": None,
    }
    ea.send("b-0", payload)
    got = eb.recv("a-0")
    assert got["num_samples"] == 7 and got["done"] is False and got["version"] is None
    assert got["tags"] == ["x", "y"]
    assert _np(got["weights"]["w"]).tobytes() == _np(payload["weights"]["w"]).tobytes()
    assert _np(got["weights"]["b"]).dtype == np.float32


def check_membership(factory: Factory) -> None:
    be = factory()
    for w in ("a-0", "a-1", "b-0"):
        be.join(CH, G, w)
    be.join(CH, G, "a-0")  # double join is idempotent
    assert sorted(be.peers(CH, G, "b-0")) == ["a-0", "a-1"]
    assert sorted(be.peers(CH, G, "a-0")) == ["a-1", "b-0"]
    be.leave(CH, G, "a-1")
    assert sorted(be.peers(CH, G, "b-0")) == ["a-0"]
    # role filtering through ChannelEnd
    end = ChannelEnd(be, CH, G, "b-0", peer_role="a")
    assert end.ends() == ["a-0"]


def check_fifo_order(factory: Factory) -> None:
    """recv_fifo yields in emulated-arrival order and advances the clock."""
    be = factory()
    be.set_link(CH, "a-0", LinkModel(latency=5.0))
    be.set_link(CH, "a-1", LinkModel(latency=2.0))
    for w in ("a-0", "a-1", "b-0"):
        be.join(CH, G, w)
    # fast sender first so the expected order also holds under a contended
    # shared-broker model (serialization can only push a-0 later)
    be.send(CH, G, "a-1", "b-0", "fast")
    be.send(CH, G, "a-0", "b-0", "slow")
    got = list(be.recv_fifo(CH, G, "b-0", ["a-0", "a-1"], timeout=5.0))
    assert got == [("a-1", "fast"), ("a-0", "slow")]
    assert be.now("b-0") >= 5.0


def check_peek_nonblocking(factory: Factory) -> None:
    be = factory()
    ea, eb = _pair(be)
    assert eb.peek("a-0") is None
    ea.send("b-0", 42)
    assert eb.peek("a-0") == 42  # non-consuming
    assert eb.recv("a-0") == 42
    assert eb.peek("a-0") is None


def check_earliest_empty_ends(factory: Factory) -> None:
    """``earliest`` over no ends / empty mailboxes is None, never an error."""
    be = factory()
    ea, eb = _pair(be)
    assert eb.earliest([]) is None
    assert eb.earliest(["a-0"]) is None  # joined, nothing sent
    assert eb.earliest(["ghost-7"]) is None  # never joined at all
    be.set_link(CH, "a-0", LinkModel(latency=3.0))
    ea.send("b-0", "x")
    got = eb.earliest(["a-0", "ghost-7"])
    assert got is not None
    arrival, end = got
    assert end == "a-0" and arrival >= 3.0
    # non-consuming: the message is still there
    assert eb.recv("a-0") == "x"


def check_recv_timeout_empty(factory: Factory) -> None:
    be = factory()
    _, eb = _pair(be)
    t0 = time.monotonic()
    try:
        eb.recv("a-0", timeout=0.1)
    except queue.Empty:
        pass
    else:
        raise AssertionError("recv on an empty mailbox must raise queue.Empty")
    try:
        eb.recv_any(["a-0"], timeout=0.1)
    except queue.Empty:
        pass
    else:
        raise AssertionError("recv_any on empty mailboxes must raise queue.Empty")
    assert time.monotonic() - t0 < 5.0


def check_recv_any_picks_earliest(factory: Factory) -> None:
    be = factory()
    be.set_link(CH, "a-0", LinkModel(latency=9.0))
    be.set_link(CH, "a-1", LinkModel(latency=1.0))
    for w in ("a-0", "a-1", "b-0"):
        be.join(CH, G, w)
    be.send(CH, G, "a-1", "b-0", "early")
    be.send(CH, G, "a-0", "b-0", "late")
    end, payload, arrival = be.recv_any(CH, G, "b-0", ["a-0", "a-1"], timeout=5.0)
    assert (end, payload) == ("a-1", "early")
    assert arrival >= 1.0
    # advance=False leaves the receiver clock untouched
    before = be.now("b-0")
    end, payload, arrival = be.recv_any(
        CH, G, "b-0", ["a-0", "a-1"], timeout=5.0, advance=False
    )
    assert (end, payload) == ("a-0", "late")
    assert be.now("b-0") == before


def check_poison_wakes_blocked_recv(factory: Factory) -> None:
    """poison() interrupts a receive already blocked in the transport."""
    be = factory()
    _, eb = _pair(be)
    caught: List[BaseException] = []
    started = threading.Event()

    def _blocked() -> None:
        started.set()
        try:
            eb.recv("a-0", timeout=30.0)
        except BaseException as exc:  # noqa: BLE001
            caught.append(exc)

    t = threading.Thread(target=_blocked, daemon=True)
    t.start()
    started.wait(5.0)
    time.sleep(0.2)  # let the receive actually block inside the transport
    be.poison("b-0", at=1.25)
    t.join(timeout=5.0)
    assert not t.is_alive(), "poison did not wake the blocked recv"
    assert len(caught) == 1 and isinstance(caught[0], WorkerDropped)
    assert caught[0].worker == "b-0" and caught[0].at == 1.25


def check_poison_wakes_recv_any_multi(factory: Factory) -> None:
    """poison() unblocks a cross-channel recv_any_multi promptly."""
    be = factory()
    be.join(CH, G, "b-0")
    be.join("conf-ch2", G, "b-0")
    end1 = ChannelEnd(be, CH, G, "b-0")
    end2 = ChannelEnd(be, "conf-ch2", G, "b-0")
    caught: List[BaseException] = []
    started = threading.Event()

    def _blocked() -> None:
        started.set()
        try:
            recv_any_multi([(end1, ["a-0"]), (end2, ["c-0"])], timeout=30.0)
        except BaseException as exc:  # noqa: BLE001
            caught.append(exc)

    t = threading.Thread(target=_blocked, daemon=True)
    t.start()
    started.wait(5.0)
    time.sleep(0.2)
    t0 = time.monotonic()
    be.poison("b-0", at=2.5)
    t.join(timeout=5.0)
    assert not t.is_alive(), "poison did not wake recv_any_multi"
    assert time.monotonic() - t0 < 3.0, "recv_any_multi woke too slowly"
    assert len(caught) == 1 and isinstance(caught[0], WorkerDropped)
    assert caught[0].at == 2.5


def check_dropout_mid_recv_fifo(factory: Factory) -> None:
    """A receiver whose dropout time precedes a message's arrival dies while
    consuming recv_fifo — not silently after it."""
    be = factory()
    be.set_link(CH, "a-0", LinkModel(latency=10.0))  # arrival at t=10
    ea, eb = _pair(be)
    be.set_drop("b-0", at=5.0)  # b-0 dies before the delivery completes
    ea.send("b-0", "never-seen")
    gen = eb.recv_fifo(["a-0"], timeout=5.0)
    try:
        list(gen)
    except WorkerDropped as exc:
        assert exc.worker == "b-0" and exc.at == 5.0
    else:
        raise AssertionError("recv_fifo ignored the receiver's dropout schedule")
    # the receiver's clock froze at the dropout time
    assert be.now("b-0") == 5.0


def check_dropout_on_send(factory: Factory) -> None:
    """A sender dying mid-transfer delivers nothing. Pipelined transports
    may defer the fault past the fire-and-forget send itself, but it must
    surface no later than the sender's next synchronous op (the barrier
    ``now`` below) — never silently retried or dropped."""
    be = factory()
    be.set_link(CH, "a-0", LinkModel(bandwidth=10.0))  # 100B -> 10s transfer
    ea, eb = _pair(be)
    be.set_drop("a-0", at=4.0)
    try:
        ea.send("b-0", torch.zeros(25, dtype=torch.float32))
        be.now("a-0")  # ack barrier for pipelined sends
    except WorkerDropped as exc:
        assert exc.worker == "a-0" and exc.at == 4.0
    else:
        raise AssertionError("send ignored the sender's dropout schedule")
    assert eb.peek("a-0") is None
    be.clear_drop("a-0")
    ea.send("b-0", "ok")  # clear_drop revives the sender
    assert eb.recv("a-0") == "ok"


def check_clock_ops(factory: Factory) -> None:
    be = factory()
    be.join(CH, G, "a-0")
    assert be.now("a-0") == 0.0
    be.advance("a-0", 2.5)
    assert be.now("a-0") == 2.5
    be.set_clock("a-0", 1.0)  # never moves backwards
    assert be.now("a-0") == 2.5
    be.set_clock("a-0", 7.0)
    assert be.now("a-0") == 7.0
    assert be.drop_time("a-0") is None


def check_supervisor_rejoin_reset(factory: Factory) -> None:
    """The process-supervisor op sequence used by the event engine: a
    tripped ``set_drop`` freezes the worker; ``clear_drop`` + ``set_clock``
    re-admit it at the re-join time — drop schedule gone, poison cleared,
    clock moved forward, messaging live again."""
    be = factory()
    ea, eb = _pair(be)
    be.set_drop("b-0", at=1.0)
    assert be.drop_time("b-0") == 1.0
    try:
        be.advance("b-0", 2.0)
    except WorkerDropped as exc:
        assert exc.worker == "b-0" and exc.at == 1.0
    else:
        raise AssertionError("advance ignored the dropout schedule")
    # an orphan cascade may have poisoned the worker while it was down
    be.poison("b-0", at=1.0)
    # re-join: reset drop/poison state, move the clock to the re-join time
    be.clear_drop("b-0")
    assert be.drop_time("b-0") is None
    be.check_poison("b-0")  # clear_drop clears poison too: must not raise
    be.set_clock("b-0", 3.0)
    assert be.now("b-0") == 3.0
    ea.send("b-0", "welcome-back")
    assert eb.recv("a-0") == "welcome-back"


def check_stats_accounting(factory: Factory) -> None:
    """Byte/message accounting honors the channel wire dtype."""
    be = factory()
    be.set_wire_dtype(CH, "bf16")
    ea, _ = _pair(be)
    ea.send("b-0", {"w": torch.zeros((10, 10), dtype=torch.float32)})
    stats = dict(be.stats)
    assert stats.get(f"bytes:{CH}") == 200.0  # 100 elements x 2 bytes
    assert stats.get(f"msgs:{CH}") == 1.0


# ------------------------------------------------------------------ #
# send_many (broadcast fan-out) checks
# ------------------------------------------------------------------ #
_SM_DSTS = ("b-0", "b-1", "b-2")


def _fanout_setup(be: TransportBackend) -> None:
    for w in ("a-0", *_SM_DSTS, "c-0"):
        be.join(CH, G, w)


def _wire_stats(stats: Dict[str, float], channel: str) -> Dict[str, float]:
    """``channel``'s accounting keys, normalized to their prefix, that must
    match the per-dst send loop exactly. (``payload_encodes:`` deliberately
    excluded — fewer encodes is the whole point of the fast path.)"""
    prefixes = ("bytes:", "msgs:", "raw_bytes:", "coded_bytes:")
    return {
        p: float(stats[p + channel]) for p in prefixes if (p + channel) in stats
    }


def check_send_many_delivery(factory: Factory) -> None:
    """send_many delivers the payload to exactly the given dst set."""
    be = factory()
    _fanout_setup(be)
    payload = {"w": torch.arange(8, dtype=torch.float32), "done": False}
    be.send_many(CH, G, "a-0", [], payload)  # empty dst list is a no-op
    be.send_many(CH, G, "a-0", list(_SM_DSTS), payload)
    for dst in _SM_DSTS:
        got = be.recv(CH, G, dst, "a-0", timeout=5.0)
        assert got["done"] is False
        assert _np(got["w"]).tobytes() == _np(payload["w"]).tobytes(), dst
    # a joined member outside the dst list receives nothing
    assert be.peek(CH, G, "c-0", "a-0") is None
    for dst in _SM_DSTS:
        assert be.peek(CH, G, dst, "a-0") is None  # exactly one copy each


def check_send_many_fifo_interleave(factory: Factory) -> None:
    """send_many interleaves with plain sends in issue order per mailbox."""
    be = factory()
    _fanout_setup(be)
    be.send(CH, G, "a-0", "b-0", "first")
    be.send_many(CH, G, "a-0", ["b-0", "b-1"], "fanned")
    be.send(CH, G, "a-0", "b-0", "last")
    got = [be.recv(CH, G, "b-0", "a-0", timeout=5.0) for _ in range(3)]
    assert got == ["first", "fanned", "last"], got
    assert be.recv(CH, G, "b-1", "a-0", timeout=5.0) == "fanned"


def check_send_many_accounting(factory: Factory) -> None:
    """Clock arithmetic and byte accounting are bit-identical to the
    per-dst send loop: same sender clock, same per-dst arrivals, same
    bytes/msgs (and raw/coded bytes on coded transports). Each comparison
    run lives on its own channel with its own worker names, so the check
    stays exact when ``factory`` hands out clients of one shared hub."""
    payload = {"w": torch.arange(25, dtype=torch.float32)}  # 100B on the wire

    def _run(fanout: bool) -> tuple:
        tag = "many" if fanout else "loop"
        ch = f"conf-sm-{tag}"
        src = f"sma-{tag}"
        dsts = [f"smb{i}-{tag}" for i in range(3)]
        be = factory()
        be.set_link(ch, src, LinkModel(bandwidth=100.0, latency=1.0))
        for w in (src, *dsts):
            be.join(ch, G, w)
        if fanout:
            be.send_many(ch, G, src, dsts, payload)
        else:
            for dst in dsts:
                be.send(ch, G, src, dst, payload)
        arrivals = []
        for dst in dsts:
            got = be.earliest(ch, G, dst, [src])
            assert got is not None, dst
            arrivals.append(float(got[0]))
        return be.now(src), arrivals, _wire_stats(dict(be.stats), ch)

    clock_loop, arr_loop, stats_loop = _run(fanout=False)
    clock_many, arr_many, stats_many = _run(fanout=True)
    assert clock_many == clock_loop, (clock_many, clock_loop)
    assert arr_many == arr_loop, (arr_many, arr_loop)
    assert stats_many == stats_loop, (stats_many, stats_loop)


def check_send_many_stateful_fallback(factory: Factory) -> None:
    """A link-stateful codec (per-dst error-feedback residuals) must make
    send_many behave exactly like the per-dst send loop: per-dst payloads
    and accounting bit-identical across two consecutive fan-outs (the
    second send is where a shared-encode shortcut would corrupt per-link
    residual state)."""
    be_probe = factory()
    if getattr(be_probe, "set_codec", None) is None:
        return  # codec-free transport: nothing to fall back from

    payload = {"w": _t(np.linspace(-1.0, 1.0, 64).astype(np.float32))}
    extra = {"w": _t((np.linspace(1.0, -1.0, 64) * 0.5).astype(np.float32))}

    def _run(fanout: bool) -> tuple:
        tag = "many" if fanout else "loop"
        ch = f"conf-tk-{tag}"
        src = f"tka-{tag}"
        dsts = [f"tkb0-{tag}", f"tkb1-{tag}"]
        be = factory()
        be.set_codec(ch, "topk0.25")
        for w in (src, *dsts):
            be.join(ch, G, w)

        def _take(dst: str) -> bytes:
            return _np(be.recv(ch, G, dst, src, timeout=5.0)["w"]).tobytes()

        def _fan() -> None:
            if fanout:
                be.send_many(ch, G, src, dsts, payload)
            else:
                for dst in dsts:
                    be.send(ch, G, src, dst, payload)

        rounds = []
        # fan-out, then a dsts[0]-only send (residuals now DIVERGE per
        # dst), then a second fan-out whose per-dst payloads legitimately
        # differ — a shared-encode shortcut cannot reproduce the loop here
        _fan()
        rounds.append([_take(dst) for dst in dsts])
        be.send(ch, G, src, dsts[0], extra)
        rounds.append([_take(dsts[0])])
        _fan()
        rounds.append([_take(dst) for dst in dsts])
        return rounds, _wire_stats(dict(be.stats), ch)

    rounds_loop, stats_loop = _run(fanout=False)
    rounds_many, stats_many = _run(fanout=True)
    assert rounds_many == rounds_loop
    assert stats_many == stats_loop, (stats_many, stats_loop)


def check_install_reduce_fold(factory: Factory) -> None:
    """The reduce plane folds an incast backend-side with the loop's
    semantics: one partial per shard, its accumulator byte-equal to a
    sorted-source ``StreamingMean`` fold of the same frames, its arrival the
    latest folded arrival, while the uploads' ``bytes:``/``msgs:``
    accounting and sender clocks equal the unreduced incast's. Installing
    is an absolute-state write, a non-update frame is delivered as is, and
    an empty install uninstalls. Each run has its own channel and workers,
    so the check stays exact on shared-hub factories."""
    from repro_torch.transport.wire import is_hub_partial, reduce_src

    def _update(seed: int) -> dict:
        rng = np.random.default_rng(seed)
        return {"weights": {"w": _t(rng.normal(size=(33,)).astype(np.float32))},
                "num_samples": 1 + seed % 3}

    def _run(reduced: bool) -> tuple:
        tag = "on" if reduced else "off"
        ch = f"conf-rd-{tag}"
        dst = f"rdb-{tag}"
        srcs = sorted(f"rda{i}-{tag}" for i in range(3))
        be = factory()
        for s in srcs:
            be.set_link(ch, s, LinkModel(bandwidth=50.0, latency=2.0))
        for w in (dst, *srcs):
            be.join(ch, G, w)
        if reduced:
            be.install_reduce(ch, G, dst, srcs, 1, None)
        # reverse sorted order: the fold must hold out-of-order arrivals
        # and still consume them in sorted-source order
        for n, s in enumerate(reversed(srcs)):
            be.send(ch, G, s, dst, _update(seed=len(srcs) - 1 - n))
            if reduced and n < len(srcs) - 1:
                assert be.earliest(ch, G, dst, [reduce_src(0)]) is None
        clocks = [be.now(s) for s in srcs]
        if reduced:
            got = be.earliest(ch, G, dst, [reduce_src(0)])
            assert got is not None
            arrivals = [float(got[0])]
            frames = [(reduce_src(0), be.recv(ch, G, dst, reduce_src(0), timeout=5.0))]
        else:
            arrivals, frames = [], []
            for s in srcs:
                got = be.earliest(ch, G, dst, [s])
                assert got is not None, s
                arrivals.append(float(got[0]))
                frames.append((s, be.recv(ch, G, dst, s, timeout=5.0)))
        return be, ch, dst, srcs, clocks, arrivals, frames, _wire_stats(dict(be.stats), ch)

    be, ch, dst, srcs, clocks_on, arr_on, frames_on, stats_on = _run(reduced=True)
    _, _, _, _, clocks_off, arr_off, _, stats_off = _run(reduced=False)
    assert clocks_on == clocks_off, (clocks_on, clocks_off)
    assert stats_on == stats_off, (stats_on, stats_off)
    assert arr_on == [max(arr_off)], (arr_on, arr_off)

    (psrc, part), = frames_on
    assert is_hub_partial(part) and part["shard"] == 0 and psrc == reduce_src(0)
    assert part["srcs"] == srcs and part["count"] == len(srcs)
    ref = StreamingMean()
    for i, _ in enumerate(srcs):
        upd = _update(seed=i)
        ref.fold(upd["weights"], float(upd["num_samples"]))
    ref_acc, ref_total = ref.partial()
    assert float(part["num_samples"]) == ref_total
    assert _np(part["acc"]["w"]).tobytes() == _np(ref_acc["w"]).tobytes()

    stats = dict(be.stats)
    assert stats.get(f"hub_reduced:{ch}") == len(srcs), stats
    assert stats.get(f"hub_partials:{ch}") == 1, stats

    # reinstall is absolute-state: a half-folded round is discarded
    be.install_reduce(ch, G, dst, srcs, 1, None)
    be.send(ch, G, srcs[0], dst, _update(seed=0))
    be.install_reduce(ch, G, dst, srcs, 1, None)
    for i, s in enumerate(srcs):
        be.send(ch, G, s, dst, _update(seed=i))
    part2 = be.recv(ch, G, dst, reduce_src(0), timeout=5.0)
    assert part2["count"] == len(srcs)
    assert _np(part2["acc"]["w"]).tobytes() == _np(ref_acc["w"]).tobytes()

    # a non-update frame on the reduced topic is not swallowed
    be.install_reduce(ch, G, dst, srcs, 1, None)
    be.send(ch, G, srcs[0], dst, {"hello": 1})
    assert be.recv(ch, G, dst, srcs[0], timeout=5.0) == {"hello": 1}

    # an empty install uninstalls: the next update is delivered per frame
    be.install_reduce(ch, G, dst, [], 0, None)
    be.send(ch, G, srcs[1], dst, _update(seed=1))
    back = be.recv(ch, G, dst, srcs[1], timeout=5.0)
    assert not is_hub_partial(back) and "weights" in back


def check_install_reduce_sharded(factory: Factory) -> None:
    """A multi-shard plan partitions the incast by ``reduce_blocks`` (one
    partial per contiguous sorted block, each folded in sorted-source
    order), two identical runs give byte-equal partials, and their
    shard-ordered combination matches the unreduced mean within 1e-6."""
    from repro_torch.core.channels import reduce_blocks
    from repro_torch.transport.wire import reduce_src

    def _update(seed: int) -> dict:
        rng = np.random.default_rng(100 + seed)
        return {"weights": {"w": _t(rng.normal(size=(17,)).astype(np.float32))},
                "num_samples": 2}

    def _run(tag: str) -> list:
        ch = f"conf-rs-{tag}"
        dst = f"rsb-{tag}"
        srcs = sorted(f"rsa{i}-{tag}" for i in range(5))
        be = factory()
        for w in (dst, *srcs):
            be.join(ch, G, w)
        be.install_reduce(ch, G, dst, srcs, 2, None)
        for i, s in enumerate(srcs):
            be.send(ch, G, s, dst, _update(seed=i))
        blocks = reduce_blocks(srcs, 2)
        parts = [be.recv(ch, G, dst, reduce_src(i), timeout=5.0) for i in range(len(blocks))]
        for i, part in enumerate(parts):
            assert part["srcs"] == blocks[i], (part["srcs"], blocks[i])
            assert part["count"] == len(blocks[i])
        return parts

    parts_a = _run("r1")
    parts_b = _run("r2")
    for pa, pb in zip(parts_a, parts_b):
        assert _np(pa["acc"]["w"]).tobytes() == _np(pb["acc"]["w"]).tobytes()

    server = StreamingMean()
    for part in parts_a:
        server.fold_partial(part["acc"], part["num_samples"], count=part["count"])
    ref = StreamingMean()
    for i in range(5):
        upd = _update(seed=i)
        ref.fold(upd["weights"], float(upd["num_samples"]))
    mean_sharded, total_sharded = server.finalize()
    mean_flat, total_flat = ref.finalize()
    assert total_sharded == total_flat
    np.testing.assert_allclose(_np(mean_sharded["w"]), _np(mean_flat["w"]), rtol=1e-6)


# ------------------------------------------------------------------ #
# wire-codec conformance: every registered codec must round-trip these
# ------------------------------------------------------------------ #
def _codec_fixtures() -> List[object]:
    """The JAX package's fixtures, as numpy trees: nested pytrees a codec must survive: model-update shapes, metadata
    scalars, empty/odd-sized arrays, deep nesting, and dicts colliding with
    the codec-envelope marker."""
    rng = np.random.default_rng(0)
    return [
        {
            "weights": {
                "w": rng.normal(size=(64, 32)).astype(np.float32),
                "b": rng.normal(size=(7,)).astype(np.float32),
            },
            "num_samples": 5,
            "version": 2,
            "done": False,
            "tags": ["x", "y"],
        },
        {
            "nested": [
                {"a": rng.normal(size=(5,)).astype(np.float32)},
                ({"b": rng.normal(size=(3, 3)).astype(np.float32)}, 1),
            ],
            "ints": np.arange(6, dtype=np.int64),
            "none": None,
        },
        {"empty": np.zeros((0,), np.float32), "scalar": np.float32(0.5)},
        {"odd": rng.normal(size=(4097,)).astype(np.float32) * 1e-3},
        # envelope-marker collision: must never be misread as an envelope
        {"__wire_codec__": "int8", "payload": {"x": 1}},
    ]


# per-codec internal sentinel shapes: user dicts with exactly these key sets
# must round-trip byte-exactly through *that* codec (escape machinery).
# Keys match codecs by name prefix.
CODEC_SENTINEL_FIXTURES: Dict[str, List[object]] = {
    "int8_blocks": [
        {"__qb__": 3},
        {"__qb_block_escape__": {"y": 2}},
    ],
    "int8": [
        {"__q8__": np.arange(4, dtype=np.int8), "__s8__": 0.5},
        {"__q8_escape__": {"x": 1}},
    ],
    "topk": [
        {
            "__tkv__": np.ones(2, np.float32),
            "__tki__": np.zeros(2, np.int32),
            "__tks__": (2,),
            "__tkd__": "<f4",
        },
        {"__tk_escape__": {"z": 1}},
    ],
}


def _float_absmax(tree: object) -> float:
    """Largest float-leaf magnitude in a tree (0.0 when no floats)."""
    out = 0.0
    for leaf in tree_leaves(tree):
        x = _np(leaf) if hasattr(leaf, "shape") else None
        if x is not None and x.dtype.kind == "f" and x.size:
            out = max(out, float(np.abs(x).max()))
    return out


def _assert_codec_tree(
    orig: object, back: object, codec: str, global_absmax: float = 0.0
) -> None:
    """Structure/dtype/shape preserved; non-float content exact; float
    leaves within the codec's loss envelope."""
    if isinstance(orig, dict):
        assert isinstance(back, dict) and set(back) == set(orig), (codec, orig, back)
        for k in orig:
            _assert_codec_tree(orig[k], back[k], codec, global_absmax)
        return
    if isinstance(orig, (list, tuple)):
        assert type(back) is type(orig) and len(back) == len(orig)
        for a, b in zip(orig, back):
            _assert_codec_tree(a, b, codec, global_absmax)
        return
    if hasattr(orig, "shape") and _np(orig).dtype.kind == "f":
        got = _np(back)
        assert got.shape == _np(orig).shape, (codec, got.shape)
        assert got.dtype == _np(orig).dtype or codec == "int8", (
            codec, got.dtype,
        )
        x = _np(orig)
        absmax = float(np.abs(x).max()) if x.size else 0.0
        if codec == "int8":
            # per-tensor symmetric quantization: one step of the leaf's scale
            np.testing.assert_allclose(got, x, atol=absmax / 127.0 + 1e-7)
        elif codec.startswith("int8_blocks"):
            # blocks span leaf boundaries in the fused flat buffer, so the
            # bound is one step of the worst block scale — at most the
            # payload-global absmax
            np.testing.assert_allclose(
                got, x, atol=global_absmax / 127.0 + 1e-7
            )
        elif codec.startswith("topk"):
            # sparsified: a subset of the dense magnitudes, rest zero
            assert float(np.abs(got).max(initial=0.0)) <= absmax + 1e-6
        else:
            assert got.tobytes() == x.tobytes()
        return
    if hasattr(orig, "shape") or isinstance(orig, np.generic):
        assert _np(back).tobytes() == _np(orig).tobytes()
        assert _np(back).dtype == _np(orig).dtype
        return
    assert back == orig and type(back) is type(orig), (codec, orig, back)


def check_codec_roundtrip(codec_name: str, device: Any = "cpu") -> None:
    """One registered codec over every fixture, as a tensor tree on
    ``device``: encode_payload -> wire encode/decode -> decode_payload ->
    ``to_device`` (what a receiving client does) must preserve structure and
    bound the loss; the codec's own sentinel collisions must round-trip."""
    from repro_torch.transport.wire import (
        decode,
        decode_payload,
        encode,
        encode_payload,
        make_codec,
        to_device,
    )

    def across(payload: Any) -> Any:  # across a real buffer
        coded = encode_payload(to_device(payload, device), codec, link=link)
        return to_device(decode_payload(decode(encode(coded)), device), device)

    codec = make_codec(codec_name)
    link = ("conf-ch", "default", "a-0", "b-0")
    for fixture in _codec_fixtures():
        _assert_codec_tree(fixture, across(fixture), codec_name, _float_absmax(fixture))
    for prefix, fixtures in CODEC_SENTINEL_FIXTURES.items():
        if not codec_name.startswith(prefix):
            continue
        for sentinel in fixtures:
            # the escape guarantees *structure*: the colliding dict is never
            # misdecoded into a quantized/sparse leaf. Float-array members
            # are still subject to the codec's (lossy) leaf transform.
            back = across({"blob": sentinel, "n": 1})
            assert back["n"] == 1
            _assert_codec_tree(
                sentinel, back["blob"], codec_name, _float_absmax(sentinel)
            )


# ------------------------------------------------------------------ #
# exactly-once session semantics (connection-oriented backends)
# ------------------------------------------------------------------ #
def check_session_resume_mid_recv(factory: Factory) -> None:
    """Severing every connection under a *blocked* recv must not lose it:
    the client reconnects, resumes its session, re-attaches to the
    in-flight recv and receives the message sent after the break."""
    be = factory()
    if getattr(be, "_chaos_break_conn", None) is None:
        return
    _pair(be)
    box: Dict[str, object] = {}

    def _blocked() -> None:
        try:
            box["got"] = be.recv(CH, G, "b-0", "a-0", 30.0)
        except BaseException as exc:  # noqa: BLE001 - surfaced via assert
            box["err"] = exc

    t = threading.Thread(target=_blocked, daemon=True)
    t.start()
    time.sleep(0.2)  # let the recv frame reach the hub and block there
    be._chaos_break_conn()
    time.sleep(0.1)
    be.send(CH, G, "a-0", "b-0", {"y": 2})
    be.now("a-0")  # ack barrier: the pipelined send is confirmed delivered
    t.join(10.0)
    assert not t.is_alive(), "blocked recv did not re-attach after the break"
    assert "err" not in box, f"re-attached recv raised: {box['err']!r}"
    assert box["got"]["y"] == 2  # type: ignore[index]
    be.close()


def check_duplicate_send_dedup(factory: Factory) -> None:
    """A retransmitted (duplicate) send frame must be answered from the
    replay cache, not run again: exactly one copy of the message exists."""
    from repro_torch.transport.wire import encode_payload

    be = factory()
    if getattr(be, "_chaos_duplicate", None) is None:
        return
    _pair(be)
    _, dup_status, _ = be._chaos_duplicate(
        "send", CH, G, "a-0", "b-0", encode_payload({"x": 1}, "")
    )
    assert dup_status == "ok", f"duplicate send rejected: {dup_status!r}"
    got = be.recv(CH, G, "b-0", "a-0", 5.0)
    assert got["x"] == 1
    try:
        extra = be.recv(CH, G, "b-0", "a-0", 0.2)
    except queue.Empty:
        extra = None
    assert extra is None, f"duplicate send was run again: {extra!r}"
    be.close()


def check_replay_window_eviction(factory: Factory) -> None:
    """A duplicate whose ack was already consumed (below the client's
    floor) must be *rejected*: replaying it could otherwise run again an op
    whose reply left the cache."""
    be = factory()
    if getattr(be, "_chaos_probe_evicted", None) is None:
        return
    _pair(be)
    # two completed sync ops: the second frame's floor evicts the first's
    # cached reply hub-side
    be.now("a-0")
    be.now("a-0")
    status, value = be._chaos_probe_evicted()
    assert status == "err", "evicted duplicate was answered (possibly run again)"
    assert "replay window" in str(value), value
    be.close()


CONFORMANCE_CHECKS: Dict[str, Callable[[Factory], None]] = {
    "protocol_surface": check_protocol_surface,
    "send_recv_roundtrip": check_send_recv_roundtrip,
    "membership": check_membership,
    "fifo_order": check_fifo_order,
    "peek_nonblocking": check_peek_nonblocking,
    "earliest_empty_ends": check_earliest_empty_ends,
    "recv_timeout_empty": check_recv_timeout_empty,
    "recv_any_picks_earliest": check_recv_any_picks_earliest,
    "poison_wakes_blocked_recv": check_poison_wakes_blocked_recv,
    "poison_wakes_recv_any_multi": check_poison_wakes_recv_any_multi,
    "dropout_mid_recv_fifo": check_dropout_mid_recv_fifo,
    "dropout_on_send": check_dropout_on_send,
    "supervisor_rejoin_reset": check_supervisor_rejoin_reset,
    "clock_ops": check_clock_ops,
    "stats_accounting": check_stats_accounting,
    "send_many_delivery": check_send_many_delivery,
    "send_many_fifo_interleave": check_send_many_fifo_interleave,
    "send_many_accounting": check_send_many_accounting,
    "send_many_stateful_fallback": check_send_many_stateful_fallback,
    "install_reduce_fold": check_install_reduce_fold,
    "install_reduce_sharded": check_install_reduce_sharded,
    "session_resume_mid_recv": check_session_resume_mid_recv,
    "duplicate_send_dedup": check_duplicate_send_dedup,
    "replay_window_eviction": check_replay_window_eviction,
}


def run_conformance(
    factory: Factory, checks: Optional[Sequence[str]] = None
) -> List[str]:
    """Run (a subset of) the suite against ``factory``; returns check names
    run. Raises on first violation."""
    names = list(checks) if checks is not None else sorted(CONFORMANCE_CHECKS)
    for name in names:
        CONFORMANCE_CHECKS[name](factory)
    return names


# ------------------------------------------------------------------ #
# reference workload for cross-deployment equivalence
# ------------------------------------------------------------------ #
class SeededSGDTrainer(Trainer):
    """Deterministic softmax-regression trainer, seeded by the worker's
    dataset name: one gradient step per round, as the JAX package's numpy
    trainer takes. Against the JAX package it agrees within float32
    rounding, not bit for bit.

    Its two products are float32 elementwise products summed by torch's
    reductions over one dimension, whose order depends on the shapes alone,
    not BLAS calls: a BLAS picks its summation order at run time (MKL
    promises the same bits from run to run only in its reproducibility
    mode), and ``x.T @ g`` sums terms that cancel, so another order moves
    the weights by tens of ulps and a seeded job would not repeat its
    bytes."""

    def load_data(self) -> None:
        d = synthetic_classification(self.ctx.worker.dataset or "d0")
        self.x = torch.from_numpy(d.x).to(self.ctx.device)
        self.y = torch.from_numpy(d.y).to(self.ctx.device, torch.int64)
        self.num_samples = d.num_samples

    def train(self) -> None:
        if self.weights is None:
            return
        w = self.weights["w"].to(torch.float32).clone()
        b = self.weights["b"].to(torch.float32).clone()
        z = (self.x.unsqueeze(2) * w).sum(dim=1) + b  # x @ w
        z = z - z.amax(dim=1, keepdim=True)
        e = torch.exp(z)
        p = e / e.sum(dim=1, keepdim=True)
        onehot = torch.eye(w.shape[1], dtype=torch.float32, device=w.device)[self.y]
        rows = torch.tensor(float(self.x.shape[0]), dtype=torch.float32, device=w.device)
        g = (p - onehot) / rows
        w -= 0.2 * (self.x.unsqueeze(2) * g.unsqueeze(1)).sum(dim=0)  # x.T @ g
        b -= 0.2 * g.sum(dim=0)
        self.weights = {"w": w, "b": b}
