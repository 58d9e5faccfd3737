"""The port's wire format and codecs (``repro_torch.transport.wire``) against
the JAX package's, on the CPU.

The same tree frames to identical bytes in both packages (the port's tensor
leaves as the JAX package's numpy arrays), each package decodes the other's
frames, ``encoded_size`` agrees, and the coded payloads of ``int8``,
``int8_blocks`` and ``topk0.25`` (with ties, over several sends of the
error-feedback loop) are identical bytes.
"""
import socket
import threading

import numpy as np
import pytest
import torch

import repro.transport.wire as jw
import repro_torch.transport.wire as tw
from repro.transport.conformance import _codec_fixtures as jax_codec_fixtures
from repro_torch.convert import tree_to_numpy
from repro_torch.transport.conformance import check_codec_roundtrip

CODECS = ("int8", "int8_blocks", "topk0.25")
LINK = ("ch", "default", "a-0", "b-0")


def _as_port(tree):
    return tw.to_device(tree, "cpu")


def _trees():
    rng = np.random.default_rng(7)
    return jax_codec_fixtures() + [
        {
            "weights": {"w": np.linspace(0, 1, 12, dtype=np.float32).reshape(3, 4)},
            "num_samples": 3,
            "version": None,
            "flags": (True, False),
            "big": 2**100,
            "scalar": np.float32(0.25),
            "f64": np.float64(1.5),
            "i64": np.int64(-7),
            "zero_d": np.array(2.5, np.float32),
            "text": "héllo",
            "raw": b"\x00\x01" * 3000,
        },
        [rng.normal(size=(70, 70)).astype(np.float32), rng.integers(0, 9, (5,)).astype(np.int32),
         rng.normal(size=(2, 3)).astype(np.float16), np.zeros((0, 3), np.float64)],
    ]


def _same(a, b):
    """Structure, types and array bytes equal (tensors compared as numpy)."""
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    if isinstance(b, torch.Tensor):
        b = b.numpy()
    if isinstance(a, dict):
        return isinstance(b, dict) and list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, (np.ndarray, np.generic)):
        return (type(a) is type(b) and a.dtype == b.dtype and np.shape(a) == np.shape(b)
                and np.asarray(a).tobytes() == np.asarray(b).tobytes())
    return type(a) is type(b) and a == b


# ------------------------------------------------------------------ #
# frames
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("i", range(len(_trees())))
def test_same_tree_frames_to_identical_bytes(i):
    tree = _trees()[i]
    ref = jw.encode(tree)
    assert tw.encode(tree) == ref  # numpy leaves
    assert tw.encode(_as_port(tree)) == ref  # tensor leaves
    assert b"".join(bytes(s) for s in tw.encode_segments(_as_port(tree))) == ref
    assert tw.encoded_size(_as_port(tree)) == jw.encoded_size(tree) == len(ref)


@pytest.mark.parametrize("i", range(len(_trees())))
def test_each_package_decodes_the_others_frames(i):
    tree = _trees()[i]
    assert _same(tw.decode(jw.encode(tree)), jw.decode(jw.encode(tree)))
    assert _same(jw.decode(tw.encode(_as_port(tree))), tree)


def test_decode_returns_numpy_and_to_device_makes_tensors():
    back = tw.decode(tw.encode({"w": torch.arange(4.0), "s": np.float32(1), "n": 3}))
    assert isinstance(back["w"], np.ndarray)
    dev = tw.to_device(back, "cpu")
    assert isinstance(dev["w"], torch.Tensor) and dev["w"].dtype == torch.float32
    assert isinstance(dev["s"], np.float32) and dev["n"] == 3


def test_unencodable_objects_and_bfloat16_are_refused():
    """What cannot cross is refused; a bfloat16 leaf crosses as raw bytes
    (``<V2``, as in the JAX package) but ``to_device`` refuses to make a
    tensor of them, since the frame has no bfloat16 tag."""
    with pytest.raises(tw.WireError):
        tw.encode(object())
    back = tw.decode(tw.encode({"w": torch.zeros(2, dtype=torch.bfloat16)}))
    assert back["w"].dtype.kind == "V"
    with pytest.raises(tw.WireError, match="bfloat16"):
        tw.to_device(back, "cpu")
    with pytest.raises(tw.WireError):
        tw.decode(tw.encode([1, 2])[:-3])
    with pytest.raises(tw.WireError):
        tw.decode(tw.encode(1) + b"Z")


def test_bfloat16_tensor_frames_to_the_jax_packages_bytes():
    """A bf16 tensor frames as the JAX package frames the ml_dtypes array of
    the same bits (``<V2`` and the 16-bit patterns), ``encoded_size``
    agrees, the frame decodes to what the JAX package decodes, and no codec
    codes the leaf."""
    import ml_dtypes

    rng = np.random.default_rng(11)
    bits = rng.integers(0, 2**16, size=(3, 5), dtype=np.uint16)
    bits[0, :4] = [0x0000, 0x8000, 0x7F80, 0x7FC1]  # +0, -0, +inf, a NaN
    jax_leaf = bits.view(ml_dtypes.bfloat16)
    port_leaf = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    tree = {"w": jax_leaf, "b": np.ones(2, np.float32), "n": 3}
    ref = jw.encode(tree)
    port = {"w": port_leaf, "b": torch.ones(2), "n": 3}
    assert tw.encode(port) == ref
    assert b"".join(bytes(s) for s in tw.encode_segments(port)) == ref
    assert tw.encoded_size(port) == jw.encoded_size(tree) == len(ref)
    assert b"<V2" in ref
    assert _same(tw.decode(ref), jw.decode(ref))
    assert tw.decode(ref)["w"].tobytes() == bits.tobytes()
    for name in CODECS:
        coded = tw.make_codec(name).encode(port, link=LINK)
        leaf = _find_leaf(coded, port_leaf)
        assert leaf is not None and torch.equal(leaf.view(torch.uint16), port_leaf.view(torch.uint16))


def _find_leaf(tree, like):
    """The leaf of ``tree`` that is a tensor of ``like``'s dtype and shape."""
    if isinstance(tree, torch.Tensor):
        return tree if tree.dtype == like.dtype and tree.shape == like.shape else None
    items = tree.values() if isinstance(tree, dict) else tree if isinstance(tree, (list, tuple)) else ()
    for v in items:
        found = _find_leaf(v, like)
        if found is not None:
            return found
    return None


def test_message_envelope_matches_jax():
    payload = {"w": np.ones(2, np.float32)}
    frame = tw.encode_message("trainer-1", _as_port(payload), 8, 1.5)
    assert frame == jw.encode_message("trainer-1", payload, 8, 1.5)
    src, got, nbytes, arrival = tw.decode_message(frame)
    assert (src, nbytes, arrival) == ("trainer-1", 8, 1.5)
    np.testing.assert_array_equal(got["w"], payload["w"])


def test_socket_framing_roundtrips_large_frames():
    a, b = socket.socketpair()
    a.settimeout(30)
    b.settimeout(30)
    try:
        tree = {"w": torch.randn(300_000), "meta": [1, "x"]}
        t = threading.Thread(target=tw.send_obj, args=(a, tree))
        t.start()
        back = tw.recv_obj(b)
        t.join(timeout=30)
        assert not t.is_alive()
        assert back["w"].tobytes() == tree["w"].numpy().tobytes() and back["meta"] == [1, "x"]
        tw.send_frame(a, b"abc")
        assert bytes(tw.recv_frame(b)) == b"abc"
    finally:
        a.close()
        b.close()


# ------------------------------------------------------------------ #
# codecs
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("codec_name", tw.registered_codecs())
def test_every_registered_codec_passes_the_roundtrip_fixtures(codec_name):
    check_codec_roundtrip(codec_name)


def test_registered_codecs_are_the_jax_packages():
    assert tw.registered_codecs() == jw.registered_codecs()
    with pytest.raises(tw.WireError):
        tw.make_codec("zip9")
    with pytest.raises(tw.WireError):
        tw.make_codec("topk1.5")
    assert tw.make_codec("topk0.05").frac == 0.05


def _tie_payload(rng):
    return {
        "weights": {
            "w": rng.integers(-3, 4, size=(64, 33)).astype(np.float32),  # many ties
            "b": rng.normal(size=(4097,)).astype(np.float32),
            "h": rng.normal(size=(9,)).astype(np.float64),
        },
        "num_samples": 5,
        "done": False,
    }


@pytest.mark.parametrize("codec_name", CODECS)
@pytest.mark.parametrize("i", range(len(jax_codec_fixtures()) + 1))
def test_coded_payloads_are_identical_bytes(codec_name, i):
    fixtures = jax_codec_fixtures() + [_tie_payload(np.random.default_rng(3))]
    payload = fixtures[i]
    jcodec, tcodec = jw.make_codec(codec_name), tw.make_codec(codec_name)
    # several sends on one link: the top-k residual carries between them
    for step in range(3):
        ref = jw.encode(jw.encode_payload(payload, jcodec, link=LINK))
        got = tw.encode(tw.encode_payload(_as_port(payload), tcodec, link=LINK))
        assert got == ref, (codec_name, step)
    assert tw.codec_ratio(_as_port(payload), codec_name, LINK) == jw.codec_ratio(payload, codec_name, LINK)


@pytest.mark.parametrize("codec_name", CODECS)
def test_each_package_decodes_the_others_coded_frames(codec_name):
    payload = _tie_payload(np.random.default_rng(8))
    jframe = jw.encode(jw.encode_payload(payload, codec_name, link=LINK))
    tframe = tw.encode(tw.encode_payload(_as_port(payload), codec_name, link=LINK))
    want = jw.decode_payload(jw.decode(jframe))
    from_jax = tree_to_numpy(tw.to_device(tw.decode_payload(tw.decode(jframe), "cpu"), "cpu"))
    from_port = jw.decode_payload(jw.decode(tframe))
    for got in (from_jax, from_port):
        for k in ("w", "b", "h"):
            assert np.asarray(got["weights"][k]).tobytes() == np.asarray(want["weights"][k]).tobytes()
        assert got["num_samples"] == 5 and got["done"] is False


@pytest.mark.parametrize("codec_name", CODECS)
def test_emulated_wire_bytes_match_jax(codec_name):
    payload = _tie_payload(np.random.default_rng(2))
    for wire_dtype in ("f32", "bf16", "int8"):
        assert (tw.make_codec(codec_name).wire_bytes(_as_port(payload), wire_dtype)
                == jw.make_codec(codec_name).wire_bytes(payload, wire_dtype))


def test_int8_blocks_decodes_onto_the_named_device_in_spec_dtypes():
    payload = {"a": torch.randn(5000, dtype=torch.float64), "b": torch.randn(3, 3), "k": 1}
    back = tw.decode_payload(tw.decode(tw.encode(tw.encode_payload(payload, "int8_blocks"))), "cpu")
    assert back["a"].dtype == torch.float64 and back["b"].dtype == torch.float32
    assert back["a"].device.type == "cpu" and back["k"] == 1
    assert float((back["a"] - payload["a"]).abs().max()) <= float(payload["a"].abs().max()) / 127 + 1e-6
    empty = tw.encode_payload({"z": torch.zeros(0)}, "int8_blocks")
    assert empty["payload"]["q"] is None
    assert tw.decode_payload(empty, "cpu")["z"].shape == (0,)


def test_marker_and_sentinel_collisions_roundtrip():
    tricky = {"__wire_codec__": "int8", "payload": {"x": 1}}
    assert tw.decode_payload(tw.encode_payload(tricky, ""), "cpu") == tricky
    partial = {"__wire_codec__": "int8", "extra": 2}
    assert tw.decode_payload(tw.encode_payload(partial, ""), "cpu") == partial
    esc = {"__q8_escape__": {"x": 1}}
    assert tw.decode_payload(tw.encode_payload(esc, "int8"), "cpu") == esc
    assert tw.decode_payload({"plain": 1}, "cpu") == {"plain": 1}


def test_topk_error_feedback_converges():
    codec = tw.make_codec("topk0.25")
    x = torch.from_numpy(np.random.default_rng(3).normal(size=512).astype(np.float32))
    cum = torch.zeros_like(x)
    errs = []
    for t in range(1, 17):
        out = codec.decode(codec.encode({"w": x}, link=LINK), "cpu")
        cum += out["w"]
        errs.append(float((cum / t - x).abs().max()))
    assert errs[-1] < errs[0] / 2 and errs[-1] < 0.25
    codec.reset()
    assert codec._residual == {}


def test_hub_partial_vocabulary_matches_jax():
    part = tw.pack_hub_partial(1, ["a-0", "a-1"], {"w": np.ones(2, np.float32)}, 7.0, 2)
    assert tw.encode(part) == jw.encode(jw.pack_hub_partial(1, ["a-0", "a-1"], {"w": np.ones(2, np.float32)}, 7.0, 2))
    assert tw.is_hub_partial(part) and not tw.is_hub_partial({"w": 1})
    assert tw.reduce_src(3) == jw.reduce_src(3)


def test_int8_blocks_encode_frees_the_leaves_without_the_garbage_collector():
    """With the collector off, an encoded update's leaves are freed once the
    caller drops them: the encode leaves no reference cycle behind (its
    nested walk held every float leaf, 2.48 GB on the card for a coded
    Qwen2.5-3B update, until a full collection)."""
    import gc
    import weakref

    codec = tw.make_codec("int8_blocks")
    gc.collect()
    gc.disable()
    try:
        leaf = torch.linspace(-1.0, 1.0, 5000)
        old = weakref.ref(leaf)
        coded = codec.encode({"weights": {"w": leaf, "b": [leaf[:3].clone()]}, "n": 1})
        del leaf
        assert old() is None
        assert coded["n"] == 5003 and coded["tree"]["n"] == 1
    finally:
        gc.enable()
