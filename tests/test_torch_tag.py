"""The port's TAG layer and channels against the JAX package's.

Twins of ``test_tag_expansion.py`` and ``test_channels_composer.py``: the
same TAGs must serialize to the same JSON and expand to the same workers,
and the in-process backends must keep the same virtual clocks and byte
counts for the same traffic.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core.channels as jch
import repro.core.expansion as jexp
import repro.core.tag as jtag
import repro.core.topologies as jtop
import repro_torch.core.channels as tch
import repro_torch.core.expansion as texp
import repro_torch.core.tag as ttag
import repro_torch.core.topologies as ttop
from repro_torch.convert import tree_from_numpy
from repro_torch.core.composer import CloneComposer, Composer, Loop, Tasklet

_GROUPS = {"west": ("d0", "d1"), "east": ("d2", "d3")}

# (template name, builder kwargs, dataset groups) for expansion
_JOBS = [
    ("classical", {}, None),
    ("hierarchical", {"groups": ("west", "east"), "dataset_groups": _GROUPS}, _GROUPS),
    ("hierarchical", {"groups": ("g",), "replica": 3, "dataset_groups": {"g": ("d0",)}},
     {"g": ("d0",)}),
    ("coordinated", {"dataset_groups": {"default": ("d0", "d1", "d2", "d3")}}, None),
    ("hybrid", {"groups": ("c0", "c1"),
                "dataset_groups": {"c0": ("d0", "d1"), "c1": ("d2", "d3")}},
     {"c0": ("d0", "d1"), "c1": ("d2", "d3")}),
    ("distributed", {}, None),
    ("vertical", {}, None),
    ("gossip", {}, None),
]


def _datasets(mod, dataset_groups):
    if dataset_groups is None:
        return tuple(mod.DatasetSpec(name=f"d{i}") for i in range(4))
    return tuple(
        mod.DatasetSpec(name=d, group=g)
        for g, names in dataset_groups.items() for d in names
    )


def test_same_templates_registered():
    assert ttop.registered_templates() == jtop.registered_templates()


@pytest.mark.parametrize("name", sorted(jtop.TEMPLATES))
def test_to_json_equal_for_every_template(name):
    assert ttop.get_template(name)().to_json() == jtop.get_template(name)().to_json()


@pytest.mark.parametrize("name,kwargs,_", _JOBS)
def test_to_json_equal_with_groups(name, kwargs, _):
    a = ttop.get_template(name)(**kwargs)
    b = jtop.get_template(name)(**kwargs)
    assert a.to_json() == b.to_json()
    # each package reads the other's JSON back to the same TAG
    assert ttag.TAG.from_json(b.to_json()) == a
    assert jtag.TAG.from_json(a.to_json()) == b


@pytest.mark.parametrize("name,kwargs,groups", _JOBS)
def test_expand_equal(name, kwargs, groups):
    ours = texp.expand(texp.JobSpec(
        tag=ttop.get_template(name)(**kwargs), datasets=_datasets(ttag, groups)))
    ref = jexp.expand(jexp.JobSpec(
        tag=jtop.get_template(name)(**kwargs), datasets=_datasets(jtag, groups)))
    assert [dataclasses.asdict(w) for w in ours] == [dataclasses.asdict(w) for w in ref]


def test_expansion_errors_match():
    with pytest.raises(texp.ExpansionError):
        texp.expand(texp.JobSpec(tag=ttop.classical_fl(), datasets=()))
    with pytest.raises(jexp.ExpansionError):
        jexp.expand(jexp.JobSpec(tag=jtop.classical_fl(), datasets=()))


def test_diff_tags_equal():
    assert ttag.diff_tags(ttop.classical_fl(), ttop.hierarchical_fl()) == jtag.diff_tags(
        jtop.classical_fl(), jtop.hierarchical_fl()
    )


# ------------------------------------------------------------------ #
# byte accounting
# ------------------------------------------------------------------ #
def _payloads():
    rng = np.random.default_rng(3)
    return [
        {"weights": {"w": rng.normal(size=(8, 3)).astype(np.float32),
                     "b": np.zeros(3, np.float32)}, "done": False},
        {"weights": [np.ones(5, np.float16), (np.arange(4, dtype=np.int8), None)],
         "num_samples": 7, "version": 3},
        {"z": np.arange(6, dtype=np.int32).reshape(2, 3), "a": np.float32(2.5),
         "m": np.zeros((2, 2), np.float64), "n": None, "s": 1.5},
        {},
        None,
    ]


@pytest.mark.parametrize("wire", ["f32", "bf16", "int8", "f16"])
@pytest.mark.parametrize("i", range(5))
def test_payload_bytes_equal(i, wire):
    payload = _payloads()[i]
    expected = jch.payload_bytes(payload, wire)
    assert tch.payload_bytes(tree_from_numpy(payload, "cpu"), wire) == expected
    assert tch.payload_bytes(payload, wire) == expected


def test_payload_bytes_counts_bf16_tensor_at_its_width():
    x = torch.zeros(10, dtype=torch.bfloat16)
    assert tch.payload_bytes({"x": x}, "f32") == 20
    assert tch.payload_bytes({"x": x}, "int8") == 10


# ------------------------------------------------------------------ #
# backends: virtual clocks and stats for the same traffic
# ------------------------------------------------------------------ #
def _drive(mod, shared_broker):
    be = mod.InprocBackend(shared_broker=shared_broker)
    for w in ("a-0", "a-1", "b-0", "b-1"):
        be.set_link("ch", w, mod.LinkModel(bandwidth=10.0, latency=0.5))
        be.join("ch", "g", w)
    payload = np.zeros(25, np.float32)
    if mod is tch:
        payload = torch.from_numpy(payload)
    be.send("ch", "g", "a-0", "b-0", payload)
    be.send("ch", "g", "a-1", "b-0", payload)
    be.send_many("ch", "g", "a-0", ["b-0", "b-1"], payload)
    be.send("ch", "g", "a-1", "b-1", payload)
    got = [be.recv("ch", "g", "b-0", "a-0", 1.0) is payload for _ in range(2)]
    got.append(be.recv("ch", "g", "b-0", "a-1", 1.0) is payload)
    clocks = {w: be.now(w) for w in ("a-0", "a-1", "b-0", "b-1")}
    return got, clocks, dict(be.stats)


@pytest.mark.parametrize("shared_broker", [False, True])
def test_backend_clocks_and_stats_equal(shared_broker):
    got, clocks, stats = _drive(tch, shared_broker)
    ref_got, ref_clocks, ref_stats = _drive(jch, shared_broker)
    assert got == ref_got == [True, True, True]
    assert clocks == ref_clocks
    assert stats == ref_stats


def test_dropout_mid_send_matches():
    def run(mod):
        be = mod.InprocBackend()
        be.set_link("ch", "a-0", mod.LinkModel(bandwidth=10.0))
        for w in ("a-0", "b-0"):
            be.join("ch", "g", w)
        be.set_drop("a-0", 5.0)
        with pytest.raises(mod.WorkerDropped):
            be.send("ch", "g", "a-0", "b-0", np.zeros(25, np.float32))
        return be.now("a-0"), dict(be.stats)

    assert run(tch) == run(jch)


def test_channel_end_surface():
    mgr = tch.ChannelManager([ttag.Channel(name="ch", pair=("a", "b"))])
    eb = mgr.end("ch", "default", "b-0")
    eas = [mgr.end("ch", "default", f"a-{i}") for i in (2, 0, 1)]
    assert sorted(eb.ends()) == ["a-0", "a-1", "a-2"]
    for e in eas:
        e.send("b-0", e.me)
    assert list(eb.recv_ordered(eb.ends())) == [(f"a-{i}", f"a-{i}") for i in range(3)]
    eb.broadcast("hi")
    assert all(e.recv("b-0") == "hi" for e in eas)
    assert mgr.channel_stats("ch") == {"bytes": 24.0, "msgs": 6.0}


def test_codec_channel_not_ported_raises():
    """Codecs are ported: a coded in-process channel builds and accounts the
    codec's wire bytes, and an unknown codec is refused when the manager is
    built. The hub reduce plane is ported too: an installed spec folds the
    update into one partial frame. So is the fault plane, which raised
    before: the loopback's connections severed by its fault hook are
    resumed, and the message sent across the break arrives once."""
    from repro_torch.transport.wire import WireError, reduce_src

    mgr = tch.ChannelManager([ttag.Channel(name="ch", pair=("a", "b"), codec="int8")],
                             device="cpu")
    ea = mgr.end("ch", "default", "a-0")
    eb = mgr.end("ch", "default", "b-0")
    ea.send("b-0", {"w": torch.zeros(1000)})
    assert mgr.channel_stats("ch")["raw_bytes"] == 4000.0
    assert eb.recv("a-0", timeout=5.0)["w"].shape == (1000,)
    eb.install_reduce(["a-0"], 1)
    ea.send("b-0", {"weights": {"w": torch.full((4,), 0.5)}, "num_samples": 2})
    part = eb.recv(reduce_src(0), timeout=5.0)
    assert part["count"] == 1 and part["num_samples"] == 2.0
    assert part["acc"]["w"].tolist() == [1.0] * 4
    loop = tch.ChannelManager([ttag.Channel(name="ch", pair=("a", "b"), backend="multiproc")],
                              device="cpu")
    try:
        la, lb = loop.end("ch", "default", "a-0"), loop.end("ch", "default", "b-0")
        la.send("b-0", {"x": 1})
        loop.backend("ch")._chaos_break_conn()
        assert lb.recv("a-0", timeout=5.0) == {"x": 1}
        la.send("b-0", {"x": 2})
        assert lb.recv("a-0", timeout=5.0) == {"x": 2}
        stats = loop.channel_stats("ch")
        assert stats["msgs"] == 2.0 and stats["resumes"] >= 1.0
    finally:
        loop.close()
    with pytest.raises(WireError):
        tch.ChannelManager([ttag.Channel(name="ch", pair=("a", "b"), codec="zip9")])
    with pytest.raises(KeyError):
        tch.ChannelManager([ttag.Channel(name="ch", pair=("a", "b"), backend="nope")])


# ------------------------------------------------------------------ #
# composer (a copy of the JAX package's, checked on the port's path)
# ------------------------------------------------------------------ #
def test_composer_surgery():
    log = []
    state = {"n": 0}

    def bump():
        state["n"] += 1
        log.append("body")

    with Composer() as comp:
        t1 = Tasklet("one", lambda: log.append("one"))
        body = Tasklet("body", bump)
        t1 >> Loop(loop_check_fn=lambda: state["n"] >= 2)(body)
    with CloneComposer(comp) as comp2:
        comp2.get_tasklet("one").replace_with(Tasklet("first", lambda: log.append("first")))
        comp2.get_tasklet("body").insert_after(Tasklet("after", lambda: log.append("after")))
    comp2.run()
    assert log == ["first", "body", "after", "body", "after"]
