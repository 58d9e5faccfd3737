"""Deterministic wire format for channel payloads and RPC frames (the port
of ``repro.transport.wire``).

Channel payloads are trees (nested dicts/lists/tuples of tensors, numpy
arrays and Python scalars). The multiproc transport must move them between processes
**deterministically**: the same object always encodes to the same bytes, and
arrays round-trip bit-exactly (``float32`` weights survive a parent → worker →
parent trip unchanged, which is what makes a seeded sync job byte-identical
across backends).

The format is a small tagged binary encoding — no pickle on the wire, so a
worker process never executes code smuggled through a payload, and encoding
is independent of interpreter details:

=====  ==============================================================
tag    payload
=====  ==============================================================
``Z``  None
``T``  True
``F``  False
``I``  int (signed 64-bit big-endian)
``W``  big int (length-prefixed decimal string, ints beyond 64 bits)
``D``  float (IEEE-754 binary64, big-endian)
``S``  str (length-prefixed UTF-8)
``B``  bytes (length-prefixed)
``L``  list (count + items)
``U``  tuple (count + items)
``M``  dict (count + key/value pairs, insertion order preserved)
``A``  ndarray (dtype str + shape + C-order raw bytes)
``G``  numpy scalar (encoded as a 0-d array, decoded back to a scalar)
=====  ==============================================================

A ``torch.Tensor`` (on the CPU or on the card) frames to exactly the bytes
the JAX package writes for the numpy array of the same dtype, shape and
values: ``A``, the numpy dtype string, shape, C-order bytes. ``decode``
returns numpy arrays, as the JAX package does; moving them onto a device is
the receiving end's business (``to_device``, and the codecs' ``decode``
which takes the device). ``bfloat16`` has no numpy dtype: a bfloat16 tensor
frames as the JAX package frames an ``ml_dtypes`` bfloat16 array, dtype
string ``<V2`` and the 16-bit patterns, and decodes, as there, to a numpy
``V2`` array of raw bytes, which no codec codes and ``to_device`` refuses
(the frame carries no tag that would make it bfloat16 again).
"""
from __future__ import annotations

import socket
import struct
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

_U32 = struct.Struct(">I")
_U64 = struct.Struct(">Q")
_I64 = struct.Struct(">q")
_F64 = struct.Struct(">d")

_I64_MIN, _I64_MAX = -(2**63), 2**63 - 1

# array/bytes bodies at least this large are framed as zero-copy memoryview
# segments instead of being copied into the frame buffer (send path)
_VIEW_MIN_BYTES = 4096
# max buffers per sendmsg call (Linux UIO_MAXIOV is 1024)
_IOV_MAX = 512


class WireError(ValueError):
    """Raised when an object cannot be encoded or a buffer is malformed."""


# torch dtype -> numpy dtype, for every dtype that has one
_NP_DTYPES: Dict[torch.dtype, np.dtype] = {
    t: np.dtype(n)
    for t, n in (
        (torch.float16, np.float16), (torch.float32, np.float32),
        (torch.float64, np.float64), (torch.complex64, np.complex64),
        (torch.complex128, np.complex128), (torch.bool, np.bool_),
        (torch.uint8, np.uint8), (torch.int8, np.int8), (torch.int16, np.int16),
        (torch.int32, np.int32), (torch.int64, np.int64),
        (torch.uint16, np.uint16), (torch.uint32, np.uint32), (torch.uint64, np.uint64),
    )
}
# numpy dtype string -> torch dtype, for the receiving end
_TORCH_DTYPES: Dict[str, torch.dtype] = {n.str: t for t, n in _NP_DTYPES.items()}
_FLOAT_TENSOR_DTYPES = (torch.float16, torch.float32, torch.float64)


# bfloat16 frames as the JAX package frames ml_dtypes' bfloat16: its dtype
# string, then the raw 16-bit patterns
_BF16_WIRE_DTYPE = "<V2"


def numpy_dtype(t: torch.Tensor) -> np.dtype:
    """The numpy dtype a tensor frames as; ``WireError`` where none exists."""
    try:
        return _NP_DTYPES[t.dtype]
    except KeyError:
        raise WireError(f"cannot encode a {t.dtype} tensor on the wire: no numpy dtype") from None


def _wire_dtype_str(t: torch.Tensor) -> str:
    """The dtype string a tensor frames with."""
    return _BF16_WIRE_DTYPE if t.dtype == torch.bfloat16 else numpy_dtype(t).str


def torch_dtype(dt: Any) -> torch.dtype:
    """The torch dtype of a numpy dtype (or its string)."""
    name = np.dtype(str(dt)).str
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise WireError(f"no torch dtype for numpy dtype {name!r}") from None


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host (one device-to-host copy for a
    CUDA tensor; a view of a CPU tensor). A bfloat16 tensor comes back as
    its bit patterns, ``uint16``."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.uint16)
    numpy_dtype(t)
    return t.detach().cpu().resolve_conj().resolve_neg().numpy()


def to_device(tree: Any, device: Any) -> Any:
    """Every numpy array in ``tree`` (as ``decode`` returns them) as a tensor
    on ``device``; tensors are moved there; scalars, numpy scalars, strings
    and containers keep their type."""
    device = torch.device(device)

    def walk(node: Any) -> Any:
        if isinstance(node, torch.Tensor):
            return node.to(device)
        if isinstance(node, np.ndarray):
            if node.dtype.kind == "V":
                raise WireError(
                    f"a {node.dtype.str} array (a bfloat16 leaf's raw bytes) has no "
                    "torch dtype: the wire carries no bfloat16 tag")
            # not np.ascontiguousarray: it turns a 0-d array into shape (1,)
            if not node.flags.c_contiguous:
                node = node.copy()
            return torch.from_numpy(node).to(device)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, tuple):
            return tuple(walk(v) for v in node)
        return node

    return walk(tree)


class _SegWriter:
    """A ``bytearray``-compatible sink that collects *gathered* segments.

    Small tokens accumulate into a growing bytearray; large array/bytes
    bodies are appended as zero-copy ``memoryview`` segments via
    :meth:`add_view` (the view keeps the source buffer alive). Joining the
    segments yields byte-identical output to encoding into one bytearray —
    the send path just never materializes the join.
    """

    __slots__ = ("_segs", "_buf")

    def __init__(self) -> None:
        self._segs: List[Any] = []
        self._buf = bytearray()

    def __iadd__(self, other: Any) -> "_SegWriter":
        self._buf += other
        return self

    def add_view(self, view: memoryview) -> None:
        if self._buf:
            self._segs.append(self._buf)
            self._buf = bytearray()
        self._segs.append(view)

    def segments(self) -> List[Any]:
        if self._buf:
            self._segs.append(self._buf)
            self._buf = bytearray()
        return self._segs


def _encode_into(obj: Any, out: bytearray) -> None:
    if obj is None:
        out += b"Z"
    elif obj is True:
        out += b"T"
    elif obj is False:
        out += b"F"
    elif isinstance(obj, torch.Tensor):
        out += b"A"
        _encode_array(_host_array(obj), out, _wire_dtype_str(obj))
    elif isinstance(obj, np.generic):
        # before int/float: np.float64 subclasses float (and np.int_ may
        # subclass int) — they must round-trip as numpy scalars, not lose
        # their dtype only on the wire-crossing deployment
        out += b"G"
        _encode_array(np.asarray(obj), out)
    elif isinstance(obj, int) and not isinstance(obj, bool):
        if _I64_MIN <= obj <= _I64_MAX:
            out += b"I"
            out += _I64.pack(obj)
        else:
            digits = str(obj).encode("ascii")
            out += b"W"
            out += _U32.pack(len(digits))
            out += digits
    elif isinstance(obj, float):
        out += b"D"
        out += _F64.pack(obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out += b"S"
        out += _U32.pack(len(raw))
        out += raw
    elif isinstance(obj, (bytes, bytearray)):
        out += b"B"
        out += _U64.pack(len(obj))
        if isinstance(out, _SegWriter) and len(obj) >= _VIEW_MIN_BYTES:
            out.add_view(memoryview(obj))
        else:
            out += bytes(obj)
    elif isinstance(obj, list):
        out += b"L"
        out += _U32.pack(len(obj))
        for item in obj:
            _encode_into(item, out)
    elif isinstance(obj, tuple):
        out += b"U"
        out += _U32.pack(len(obj))
        for item in obj:
            _encode_into(item, out)
    elif isinstance(obj, dict):
        out += b"M"
        out += _U32.pack(len(obj))
        for k, v in obj.items():
            _encode_into(k, out)
            _encode_into(v, out)
    elif hasattr(obj, "__array__") or hasattr(obj, "shape"):
        # numpy ndarray (or another array type numpy can read)
        out += b"A"
        _encode_array(np.asarray(obj), out)
    else:
        raise WireError(
            f"cannot encode {type(obj).__name__!r} on the wire (supported: "
            "None/bool/int/float/str/bytes/list/tuple/dict/ndarray)"
        )


def _encode_array(arr: np.ndarray, out: bytearray, dtype_str: Optional[str] = None) -> None:
    if arr.dtype == object:
        raise WireError("cannot encode object-dtype arrays on the wire")
    # e.g. b"<f4": carries byte order
    dt = (dtype_str or arr.dtype.str).encode("ascii")
    out += _U32.pack(len(dt))
    out += dt
    out += _U32.pack(arr.ndim)
    for dim in arr.shape:
        out += _U64.pack(dim)
    arr = np.ascontiguousarray(arr)
    out += _U64.pack(arr.nbytes)
    if isinstance(out, _SegWriter) and arr.nbytes >= _VIEW_MIN_BYTES:
        # zero-copy: frame the array's own buffer instead of tobytes()'ing a
        # multi-MB weight tensor on every send (the view pins the array)
        out.add_view(memoryview(arr).cast("B"))
    else:
        out += arr.tobytes()


def encode(obj: Any) -> bytes:
    """Serialize a pytree to deterministic bytes."""
    out = bytearray()
    _encode_into(obj, out)
    return bytes(out)


def encode_segments(obj: Any) -> List[Any]:
    """Serialize to a list of gathered buffer segments (zero-copy for large
    array bodies); ``b"".join(...)`` of the segments equals ``encode(obj)``."""
    out = _SegWriter()
    _encode_into(obj, out)
    return out.segments()


def encoded_size(obj: Any) -> int:
    """Exact ``len(encode(obj))`` computed by a byte-counting walk — no
    materialized buffer, so measuring a multi-MB payload costs O(structure)."""
    if obj is None or obj is True or obj is False:
        return 1
    if isinstance(obj, torch.Tensor):
        # counted from numel and element size: no device-to-host copy
        dt = _wire_dtype_str(obj)
        return 1 + 4 + len(dt) + 4 + 8 * obj.dim() + 8 + obj.numel() * obj.element_size()
    if isinstance(obj, np.generic):
        return 1 + _array_encoded_size(np.asarray(obj))
    if isinstance(obj, int):
        return 9 if _I64_MIN <= obj <= _I64_MAX else 5 + len(str(obj))
    if isinstance(obj, float):
        return 9
    if isinstance(obj, str):
        return 5 + len(obj.encode("utf-8"))
    if isinstance(obj, (bytes, bytearray)):
        return 9 + len(obj)
    if isinstance(obj, (list, tuple)):
        return 5 + sum(encoded_size(v) for v in obj)
    if isinstance(obj, dict):
        return 5 + sum(encoded_size(k) + encoded_size(v) for k, v in obj.items())
    if hasattr(obj, "__array__") or hasattr(obj, "shape"):
        return 1 + _array_encoded_size(np.asarray(obj))
    raise WireError(
        f"cannot encode {type(obj).__name__!r} on the wire (supported: "
        "None/bool/int/float/str/bytes/list/tuple/dict/ndarray)"
    )


def _array_encoded_size(arr: np.ndarray) -> int:
    if arr.dtype == object:
        raise WireError("cannot encode object-dtype arrays on the wire")
    return 4 + len(arr.dtype.str) + 4 + 8 * arr.ndim + 8 + arr.nbytes


class _Reader:
    """Zero-copy cursor over a received frame: ``take`` returns memoryview
    slices of the underlying buffer, so array bodies are never re-copied
    while being located (the one detach copy happens in ``_decode_array``)."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf: memoryview) -> None:
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise WireError("truncated wire buffer")
        chunk = self.buf[self.pos:end]
        self.pos = end
        return chunk

    def u32(self) -> int:
        return _U32.unpack(self.take(4))[0]

    def u64(self) -> int:
        return _U64.unpack(self.take(8))[0]


def _decode_array(r: _Reader) -> np.ndarray:
    dt = np.dtype(str(r.take(r.u32()), "ascii"))
    ndim = r.u32()
    shape = tuple(r.u64() for _ in range(ndim))
    raw = r.take(r.u64())
    # decode as a view of the frame buffer; the single .copy() detaches from
    # it and makes the array writable
    return np.frombuffer(raw, dtype=dt).reshape(shape).copy()


def _decode_from(r: _Reader) -> Any:
    tag = r.take(1)
    if tag == b"Z":
        return None
    if tag == b"T":
        return True
    if tag == b"F":
        return False
    if tag == b"I":
        return _I64.unpack(r.take(8))[0]
    if tag == b"W":
        return int(str(r.take(r.u32()), "ascii"))
    if tag == b"D":
        return _F64.unpack(r.take(8))[0]
    if tag == b"S":
        return str(r.take(r.u32()), "utf-8")
    if tag == b"B":
        return bytes(r.take(r.u64()))
    if tag == b"L":
        return [_decode_from(r) for _ in range(r.u32())]
    if tag == b"U":
        return tuple(_decode_from(r) for _ in range(r.u32()))
    if tag == b"M":
        n = r.u32()
        out = {}
        for _ in range(n):
            k = _decode_from(r)
            out[k] = _decode_from(r)
        return out
    if tag == b"A":
        return _decode_array(r)
    if tag == b"G":
        return _decode_array(r)[()]
    raise WireError(f"unknown wire tag {tag!r}")


def decode(buf: Any) -> Any:
    """Inverse of :func:`encode`. Accepts any bytes-like buffer (bytes,
    bytearray, memoryview) and reads it without intermediate copies."""
    view = memoryview(buf)
    r = _Reader(view)
    obj = _decode_from(r)
    if r.pos != len(view):
        raise WireError(f"{len(view) - r.pos} trailing bytes after decode")
    return obj


# ---------------------------------------------------------------------- #
# socket framing: 8-byte big-endian length prefix per frame
# ---------------------------------------------------------------------- #
def _send_segments(sock: socket.socket, segments: List[Any]) -> None:
    """Gathered send of a list of buffer segments without joining them.

    Uses ``sendmsg`` (scatter/gather) where available so one syscall moves
    many segments; falls back to per-segment ``sendall``. Handles partial
    sends by advancing memoryviews — no buffer is ever concatenated."""
    if not hasattr(sock, "sendmsg"):  # pragma: no cover - non-POSIX fallback
        for seg in segments:
            sock.sendall(seg)
        return
    views = [
        m for m in (memoryview(s).cast("B") for s in segments) if len(m)
    ]
    while views:
        sent = sock.sendmsg(views[:_IOV_MAX])
        while sent:
            head = views[0]
            if sent >= len(head):
                sent -= len(head)
                views.pop(0)
            else:
                views[0] = head[sent:]
                sent = 0


def send_frame(sock: socket.socket, payload: bytes) -> None:
    header = _U64.pack(len(payload))
    if len(payload) < 65536:
        sock.sendall(header + payload)
    else:
        # large frames: two sendalls instead of concatenating (a full extra
        # copy of a multi-MB weight payload per message on the hot path)
        sock.sendall(header)
        sock.sendall(payload)


def _recv_exact_into(sock: socket.socket, view: memoryview) -> None:
    """Fill ``view`` from the socket — ``recv_into`` a preallocated buffer,
    so receiving an N-byte frame performs zero chunk-list joins."""
    while len(view):
        n = sock.recv_into(view, min(len(view), 1 << 20))
        if not n:
            raise ConnectionError("transport peer closed the connection")
        view = view[n:]


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    buf = bytearray(n)
    _recv_exact_into(sock, memoryview(buf))
    return buf


def recv_frame(sock: socket.socket) -> bytearray:
    (length,) = _U64.unpack(_recv_exact(sock, 8))
    return _recv_exact(sock, length)


def send_obj(sock: socket.socket, obj: Any) -> None:
    """Encode ``obj`` into gathered segments and send them framed — large
    array bodies cross as zero-copy memoryviews of their source buffers
    (encoding fully precedes the first write, so an unencodable object
    raises ``WireError`` with the stream still clean)."""
    segments = encode_segments(obj)
    total = 0
    for seg in segments:
        total += len(seg) if not isinstance(seg, memoryview) else seg.nbytes
    _send_segments(sock, [_U64.pack(total), *segments])


def recv_obj(sock: socket.socket) -> Any:
    return decode(recv_frame(sock))


def encode_message(src: str, payload: Any, nbytes: int, arrival: float) -> bytes:
    """A ``repro_torch.core.channels.Message`` envelope on the wire."""
    return encode((src, payload, int(nbytes), float(arrival)))


def decode_message(buf: bytes) -> Tuple[str, Any, int, float]:
    src, payload, nbytes, arrival = decode(buf)
    return src, payload, nbytes, arrival


# ---------------------------------------------------------------------- #
# per-channel payload codecs: repro_torch.fl.compression on the wire
# ---------------------------------------------------------------------- #
# A channel spec may opt into a codec (``Channel(..., codec="int8")``): the
# *sending* client transforms float leaves before the payload crosses the
# socket, and any receiving client reverses it (the transform is
# self-describing via the envelope marker below, so receivers need no local
# configuration). Lossy, so strictly opt-in.
#
# Codecs are objects (``WireCodec``): a codec may carry per-link state on the
# sending side (the top-k family keeps an error-feedback residual per link).
# Decode is stateless: any receiver decodes any sender's envelope with a
# fresh instance, onto the device it names. Encoding runs where the leaves
# are (on the card for CUDA leaves) and hands the wire numpy arrays; the
# coded payload is the JAX package's, value for value. Emulation backends
# never run ``encode``; they use ``wire_bytes`` for post-codec accounting.

_CODEC_ENVELOPE = "__wire_codec__"
_Q8, _S8 = "__q8__", "__s8__"
_Q8_ESC = "__q8_escape__"
# key sets _int8_decode treats specially — user dicts with exactly these
# shapes must be escaped on encode or they would be silently mis-decoded
_Q8_SENTINELS = ({_Q8, _S8}, {_Q8_ESC})
_FLOAT_KINDS = ("f",)


def _is_float_array(node: Any) -> bool:
    """A float leaf a codec transforms: a float16/32/64 tensor, or a numpy
    array or scalar of float kind. bfloat16 tensors are not, as their
    frames (kind ``V``) are not in the JAX package."""
    if isinstance(node, torch.Tensor):
        return node.dtype in _FLOAT_TENSOR_DTYPES
    return (
        hasattr(node, "shape")
        and getattr(getattr(node, "dtype", None), "kind", "") in _FLOAT_KINDS
    )


def _dtype_str(node: Any) -> str:
    if isinstance(node, torch.Tensor):
        return numpy_dtype(node).str
    return np.asarray(node).dtype.str


def _as_tensor(node: Any, device: Optional[torch.device] = None) -> torch.Tensor:
    """A leaf as a tensor: tensors stay where they are unless a device is
    named; numpy leaves are wrapped on the host (without a copy where numpy
    allows one to be shared), then moved. Callers never write into it."""
    if not isinstance(node, torch.Tensor):
        arr = np.asarray(node)
        if not (arr.flags.c_contiguous and arr.flags.writeable):
            arr = arr.copy()
        node = torch.from_numpy(arr)
    return node if device is None else node.to(device)


def _int8_encode(payload: Any) -> Any:
    """Symmetric per-tensor int8 quantization of every float leaf
    (``repro_torch.fl.compression.quantize_int8``, on the leaf's device);
    non-float leaves pass through."""
    from repro_torch.fl.compression import quantize_int8

    def walk(node: Any) -> Any:
        if isinstance(node, dict):
            coded = {k: walk(v) for k, v in node.items()}
            if set(node) in _Q8_SENTINELS:
                # a user dict mimicking the quantization sentinel (or this
                # escape) would be mis-decoded — wrap so decode restores it
                return {_Q8_ESC: coded}
            return coded
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, tuple):
            return tuple(walk(v) for v in node)
        if _is_float_array(node) and np.prod(node.shape, dtype=np.int64):
            # zero-size leaves pass: the absmax of nothing is undefined
            q, scale = quantize_int8(_as_tensor(node))
            return {_Q8: _host_array(q), _S8: float(scale)}
        return node

    return walk(payload)


def _int8_decode(payload: Any, device: torch.device) -> Any:
    def walk(node: Any) -> Any:
        if isinstance(node, dict):
            if set(node) == {_Q8_ESC}:
                # escaped user dict: restore its shape, walk only its values
                return {k: walk(v) for k, v in node[_Q8_ESC].items()}
            if set(node) == {_Q8, _S8}:
                q = _as_tensor(node[_Q8], device).to(torch.float32)
                return q * torch.tensor(float(node[_S8]), dtype=torch.float32, device=device)
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, tuple):
            return tuple(walk(v) for v in node)
        return node

    return walk(payload)


class WireCodec:
    """A per-channel payload transform applied at the socket boundary.

    ``encode(payload, link)`` runs on the *sending* client right before a
    payload crosses the wire; ``decode(payload, device)`` reverses it on any
    receiver, leaving float leaves as tensors on ``device``. ``link`` is an
    opaque hashable key identifying the concrete link — ``(channel, group,
    src, dst)`` on the multiproc client — so a stateful codec can keep
    independent state (e.g. an error-feedback residual) per link.

    ``sim(payload)`` returns a cheap shape-faithful stand-in for the coded
    payload (stub arrays, never touched), used by ``wire_bytes`` so the
    emulation backends can account post-codec bytes without running the
    transform.
    """

    name = "identity"
    lossy = False
    stateful = False
    # True when encode output depends on the concrete (channel, group, src,
    # dst) link — e.g. per-link error-feedback residuals. The broadcast
    # fan-out fast path (one encode shipped to many dsts) is only valid when
    # this is False; link-stateful codecs fall back to per-dst encodes.
    link_stateful = False

    def encode(self, payload: Any, link: Any = ()) -> Any:
        return payload

    def decode(self, payload: Any, device: Any) -> Any:
        return payload

    def sim(self, payload: Any) -> Any:
        return payload

    def wire_bytes(self, payload: Any, wire_dtype: str = "f32") -> int:
        """Emulated post-codec wire bytes of ``payload`` (element-size
        accounting, consistent with ``repro_torch.core.channels.payload_bytes``)."""
        from repro_torch.core.channels import payload_bytes

        return payload_bytes(self.sim(payload), wire_dtype)

    def reset(self, link: Any = None) -> None:
        """Drop per-link state (all links when ``link`` is None)."""


def _stub(shape: Tuple[int, ...], dtype: Any) -> np.ndarray:
    # an untouched allocation: right shape/dtype for byte accounting, no fill
    return np.empty(shape, dtype)


def _numel(node: Any) -> int:
    size = 1
    for d in node.shape:
        size *= int(d)
    return size


class Int8Codec(WireCodec):
    """Per-leaf symmetric int8 quantization (the original ``"int8"``)."""

    name = "int8"
    lossy = True

    def encode(self, payload: Any, link: Any = ()) -> Any:
        return _int8_encode(payload)

    def decode(self, payload: Any, device: Any) -> Any:
        return _int8_decode(payload, torch.device(device))

    def sim(self, payload: Any) -> Any:
        def walk(node: Any) -> Any:
            if isinstance(node, dict):
                return {k: walk(v) for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return [walk(v) for v in node]
            if _is_float_array(node):
                return {_Q8: _stub(tuple(node.shape), np.int8), _S8: 0.0}
            return node

        return walk(payload)


class Int8BlocksCodec(WireCodec):
    """Fused blockwise int8 quantization through the quant kernels.

    All float leaves are flattened and concatenated as float32 on their
    device, quantized by one ``repro_torch.kernels.quant`` call (the CUDA
    kernel for leaves on the card), and only the first ``n`` int8 values
    and the per-block scales are copied to the host: one byte per parameter
    crosses PCIe instead of four. Decode copies them onto the receiver's
    device into a zeroed block buffer, dequantizes there and splits the
    result into leaf views cast back to each spec's dtype. The coded
    payload carries the structure with index markers where float leaves
    lived, plus the leaf specs needed to rebuild them.
    """

    name = "int8_blocks"
    lossy = True

    _QB = "__qb__"
    _QB_ESC = "__qb_block_escape__"
    _SENTINELS = ({_QB}, {_QB_ESC})

    def encode(self, payload: Any, link: Any = ()) -> Any:
        from repro_torch.kernels.quant.ops import BLOCK, quantize_flat

        leaves: List[Any] = []

        def walk(node: Any) -> Any:
            if isinstance(node, dict):
                coded = {k: walk(v) for k, v in node.items()}
                if set(node) in self._SENTINELS:
                    return {self._QB_ESC: coded}
                return coded
            if isinstance(node, list):
                return [walk(v) for v in node]
            if isinstance(node, tuple):
                return tuple(walk(v) for v in node)
            if _is_float_array(node):
                leaves.append(node)
                return {self._QB: len(leaves) - 1}
            return node

        tree = walk(payload)
        specs = [(tuple(int(d) for d in leaf.shape), _dtype_str(leaf)) for leaf in leaves]
        n = sum(_numel(leaf) for leaf in leaves)
        if not n:  # no float leaves, or only zero-size ones: nothing to code
            return {"tree": tree, "q": None, "scale": None, "specs": specs}
        device = next((t.device for t in leaves if isinstance(t, torch.Tensor)), None)
        parts = [_as_tensor(leaf, device).reshape(-1).to(torch.float32) for leaf in leaves]
        # one concatenation, zero padding to whole blocks included
        parts.append(parts[0].new_zeros((-n) % BLOCK))
        q, scale = quantize_flat(torch.cat(parts))
        # ship only the first n quantized bytes: the block padding is all
        # zeros and would otherwise inflate sub-block payloads past their raw
        # size (decode re-pads before dequantizing)
        return {
            "tree": tree,
            "q": _host_array(q.view(-1)[:n]),
            "scale": _host_array(scale),
            "specs": specs,
            "n": n,
        }

    def decode(self, payload: Any, device: Any) -> Any:
        device = torch.device(device)
        specs = payload["specs"]
        if payload.get("q") is None:
            # no (or only zero-size) float leaves were coded
            leaves = [
                torch.zeros(tuple(int(d) for d in shape), dtype=torch_dtype(dt), device=device)
                for shape, dt in specs
            ]
            return self._rebuild(payload["tree"], leaves)
        from repro_torch.kernels.quant.ops import BLOCK, dequantize_flat

        n = int(payload["n"])
        scale = _as_tensor(payload["scale"], device)
        q = torch.zeros((scale.shape[0] * BLOCK,), dtype=torch.int8, device=device)
        q[:n].copy_(_as_tensor(payload["q"]).reshape(-1))
        flat = dequantize_flat(q.view(-1, BLOCK), scale, n)
        leaves, offset = [], 0
        for shape, dt in specs:
            shape = tuple(int(d) for d in shape)
            size = 1
            for d in shape:
                size *= d
            leaves.append(flat[offset:offset + size].view(shape).to(torch_dtype(dt)))
            offset += size
        return self._rebuild(payload["tree"], leaves)

    def _rebuild(self, node: Any, leaves: List[torch.Tensor]) -> Any:
        if isinstance(node, dict):
            if set(node) == {self._QB_ESC}:
                return {
                    k: self._rebuild(v, leaves)
                    for k, v in node[self._QB_ESC].items()
                }
            if set(node) == {self._QB} and isinstance(node[self._QB], int):
                return leaves[node[self._QB]]
            return {k: self._rebuild(v, leaves) for k, v in node.items()}
        if isinstance(node, list):
            return [self._rebuild(v, leaves) for v in node]
        if isinstance(node, tuple):
            return tuple(self._rebuild(v, leaves) for v in node)
        return node

    def sim(self, payload: Any) -> Any:
        from repro_torch.kernels.quant.ops import BLOCK

        total = [0]

        def walk(node: Any) -> Any:
            if isinstance(node, dict):
                return {k: walk(v) for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return [walk(v) for v in node]
            if _is_float_array(node):
                total[0] += _numel(node)
                return {self._QB: 0}
            return node

        tree = walk(payload)
        if not total[0]:
            return {"tree": tree, "q": None, "scale": None, "specs": []}
        nb = -(-total[0] // BLOCK)
        return {
            "tree": tree,
            "q": _stub((total[0],), np.int8),
            "scale": _stub((nb, 1), np.float32),
            "specs": [],
            "n": total[0],
        }


class TopKCodec(WireCodec):
    """Magnitude top-k sparsification with per-link error feedback.

    Each float leaf is reduced to its ``frac`` largest-magnitude entries
    (``repro_torch.fl.compression.topk_sparsify``, on the leaf's device);
    the unsent remainder is kept as a per-(link, leaf) residual and added to
    the *next* send on that link, so the compression error feeds back
    instead of being lost. State lives on the sending side only; decode
    densifies statelessly.
    """

    lossy = True
    stateful = True
    # residuals are keyed per (channel, group, src, dst): identical payloads
    # legitimately encode differently per destination, so the O(1)-encode
    # broadcast fast path must not ship one coded body to many dsts
    link_stateful = True

    _TKV, _TKI, _TKS, _TKD = "__tkv__", "__tki__", "__tks__", "__tkd__"
    _TK_ESC = "__tk_escape__"
    _SENTINELS = ({_TKV, _TKI, _TKS, _TKD}, {_TK_ESC})

    def __init__(self, frac: float, name: Optional[str] = None) -> None:
        frac = float(frac)
        if not 0.0 < frac <= 1.0:
            raise WireError(f"topk codec needs 0 < frac <= 1, got {frac}")
        self.frac = frac
        self.name = name if name is not None else f"topk{frac:g}"
        # (link, leaf path) -> error-feedback residual (float32, leaf shape)
        self._residual: Dict[Any, torch.Tensor] = {}

    def encode(self, payload: Any, link: Any = ()) -> Any:
        from repro_torch.fl.compression import topk_sparsify

        def walk(node: Any, path: Tuple[Any, ...]) -> Any:
            if isinstance(node, dict):
                coded = {k: walk(v, path + (k,)) for k, v in node.items()}
                if set(node) in self._SENTINELS:
                    return {self._TK_ESC: coded}
                return coded
            if isinstance(node, list):
                return [walk(v, path + (i,)) for i, v in enumerate(node)]
            if isinstance(node, tuple):
                return tuple(walk(v, path + (i,)) for i, v in enumerate(node))
            if _is_float_array(node):
                if not _numel(node):
                    return node  # zero-size: nothing to sparsify
                x = _as_tensor(node).to(torch.float32)
                key = (link, path)
                r = self._residual.get(key)
                acc = x + r if r is not None and r.shape == x.shape else x
                k = max(1, int(round(self.frac * acc.numel())))
                vals, idx = topk_sparsify(acc, k)
                res = acc.reshape(-1).clone()
                res[idx] = 0.0
                self._residual[key] = res.reshape(acc.shape)
                return {
                    self._TKV: _host_array(vals),
                    self._TKI: _host_array(idx.to(torch.int32)),
                    self._TKS: tuple(int(d) for d in node.shape),
                    self._TKD: _dtype_str(node),
                }
            return node

        return walk(payload, ())

    def decode(self, payload: Any, device: Any) -> Any:
        from repro_torch.fl.compression import topk_densify

        device = torch.device(device)

        def walk(node: Any) -> Any:
            if isinstance(node, dict):
                if set(node) == {self._TK_ESC}:
                    return {k: walk(v) for k, v in node[self._TK_ESC].items()}
                if set(node) == {self._TKV, self._TKI, self._TKS, self._TKD}:
                    shape = tuple(int(d) for d in node[self._TKS])
                    dense = topk_densify(
                        _as_tensor(node[self._TKV], device),
                        _as_tensor(node[self._TKI], device),
                        shape,
                    )
                    return dense.to(torch_dtype(node[self._TKD]))
                return {k: walk(v) for k, v in node.items()}
            if isinstance(node, list):
                return [walk(v) for v in node]
            if isinstance(node, tuple):
                return tuple(walk(v) for v in node)
            return node

        return walk(payload)

    def sim(self, payload: Any) -> Any:
        def walk(node: Any) -> Any:
            if isinstance(node, dict):
                return {k: walk(v) for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return [walk(v) for v in node]
            if _is_float_array(node):
                k = max(1, int(round(self.frac * _numel(node))))
                return {
                    self._TKV: _stub((k,), np.float32),
                    self._TKI: _stub((k,), np.int32),
                    self._TKS: tuple(int(d) for d in node.shape),
                    self._TKD: "<f4",
                }
            return node

        return walk(payload)

    def reset(self, link: Any = None) -> None:
        if link is None:
            self._residual.clear()
        else:
            for key in [k for k in self._residual if k[0] == link]:
                del self._residual[key]


# name -> zero-arg factory producing a fresh codec instance. Stateful codecs
# must be instantiated per backend/channel, never shared — hence factories.
WIRE_CODECS: Dict[str, Callable[[], WireCodec]] = {
    "int8": Int8Codec,
    "int8_blocks": Int8BlocksCodec,
}

# parametric codec families: prefix -> (parser(name) -> codec, sample name).
# The sample is a representative concrete member used by conformance tests
# and benches that iterate "every registered codec".
_CODEC_FAMILIES: Dict[str, Tuple[Callable[[str], WireCodec], str]] = {
    "topk": (lambda name: TopKCodec(float(name[4:]), name=name), "topk0.1"),
}


def register_codec(name: str, factory: Callable[[], WireCodec]) -> None:
    WIRE_CODECS[name] = factory


def registered_codecs() -> List[str]:
    """All concrete codec names, plus one sample per parametric family."""
    return sorted(WIRE_CODECS) + sorted(s for _, s in _CODEC_FAMILIES.values())


def make_codec(codec: Any) -> WireCodec:
    """Resolve a codec name (or pass through an instance) to a ``WireCodec``.

    Concrete names come from ``WIRE_CODECS``; parametric names are parsed by
    their family prefix (``"topk0.05"`` -> ``TopKCodec(frac=0.05)``)."""
    if isinstance(codec, WireCodec):
        return codec
    name = str(codec)
    if name in WIRE_CODECS:
        return WIRE_CODECS[name]()
    for prefix, (parser, _) in _CODEC_FAMILIES.items():
        if name.startswith(prefix) and len(name) > len(prefix):
            try:
                return parser(name)
            except (TypeError, ValueError) as exc:
                raise WireError(f"malformed wire codec name {name!r}: {exc}")
    raise WireError(
        f"unknown wire codec {name!r}; registered: {registered_codecs()}"
    )


_ENVELOPE_KEYS = frozenset({_CODEC_ENVELOPE, "payload"})

# decode-side instance cache: decode is stateless, so one shared instance
# per codec name is safe and avoids re-instantiation per message
_DECODER_CACHE: Dict[str, WireCodec] = {}


def encode_payload(payload: Any, codec: Any, link: Any = ()) -> Any:
    """Apply ``codec`` (a name or ``WireCodec`` instance) to a channel
    payload; empty codec is the identity.

    A plain payload dict that happens to contain the envelope marker key is
    escaped into an identity envelope (``codec=""``), so ``decode_payload``
    can never misread user data as a codec envelope — every payload
    round-trips losslessly whether or not a codec is configured. ``link``
    selects the per-link state of a stateful codec."""
    if not codec:
        if isinstance(payload, dict) and _CODEC_ENVELOPE in payload:
            return {_CODEC_ENVELOPE: "", "payload": payload}
        return payload
    c = make_codec(codec)
    return {_CODEC_ENVELOPE: c.name, "payload": c.encode(payload, link)}


def decode_payload(payload: Any, device: Any) -> Any:
    """Reverse :func:`encode_payload`; plain payloads pass through. Coded
    float leaves come back as tensors on ``device``.

    Only a dict with *exactly* the envelope shape (the two envelope keys and
    a string codec name) is treated as an envelope; anything else — including
    user dicts merely containing the marker key, which ``encode_payload``
    escapes on the way in — passes through untouched."""
    if (
        isinstance(payload, dict)
        and set(payload) == _ENVELOPE_KEYS
        and isinstance(payload[_CODEC_ENVELOPE], str)
    ):
        codec = payload[_CODEC_ENVELOPE]
        if not codec:  # identity envelope: an escaped colliding payload
            return payload["payload"]
        dec = _DECODER_CACHE.get(codec)
        if dec is None:
            dec = _DECODER_CACHE.setdefault(codec, make_codec(codec))
        return dec.decode(payload["payload"], device)
    return payload


# ------------------------------------------------------------------ #
# hub-reduce partial frames (the reduce plane's wire vocabulary)
# ------------------------------------------------------------------ #
# A broker that reduces an incast topic forwards ONE partial frame per
# reduce shard per round instead of every client's update frame. The frame
# carries the *unfinalized* weighted sum so the receiving server can fold
# partials from several shards and divide once by the grand total — the
# same finalize step the per-frame streaming fold performs. The marker key
# is deliberately shaped like the codec envelope marker: both are reserved
# wire vocabulary that application payloads must never collide with
# (``pack_hub_partial`` is only ever produced broker-side).
HUB_PARTIAL_KEY = "__hub_partial__"

# reserved mailbox src prefix for partial frames: shard i's partial is
# delivered from the pseudo-source ``reduce_src(i)``, which can never clash
# with a worker id (worker ids are "<role>-<idx>")
_REDUCE_SRC_PREFIX = "__reduce__"


def reduce_src(shard: int) -> str:
    """Mailbox pseudo-source that delivers reduce shard ``shard``'s partial."""
    return f"{_REDUCE_SRC_PREFIX}{int(shard)}"


def pack_hub_partial(
    shard: int, srcs: List[str], acc: Any, total: float, count: int
) -> Dict[str, Any]:
    """Broker -> server partial-aggregate frame for one reduce shard.

    ``acc`` is the running weighted-sum tree (NOT the mean), ``total`` the
    summed sample weights and ``count`` the number of update frames folded
    into it, in sorted-``srcs`` order."""
    return {
        HUB_PARTIAL_KEY: True,
        "shard": int(shard),
        "srcs": list(srcs),
        "acc": acc,
        "num_samples": float(total),
        "count": int(count),
    }


def is_hub_partial(payload: Any) -> bool:
    """True iff ``payload`` is a broker-produced partial-aggregate frame."""
    return isinstance(payload, dict) and bool(payload.get(HUB_PARTIAL_KEY))


def codec_ratio(payload: Any, codec: Any, link: Any = ()) -> float:
    """Achieved wire-bytes ratio (coded / raw) of ``codec`` on ``payload``.

    Raw size comes from the :func:`encoded_size` counting walk — the
    multi-MB raw payload is never re-serialized just to be measured, so a
    bench run no longer doubles its peak memory."""
    raw = encoded_size(payload)
    coded = encoded_size(encode_payload(payload, codec, link))
    return coded / raw if raw else 1.0
