"""The port's server strategies against the JAX package's.

Twins of the strategy half of ``test_strategies_fedstep.py``, of
``TestFedBuffReference`` in ``test_async_runtime.py``, of
``TestFedBuffFlushBitEquality`` in ``test_fused_agg.py`` and of
``TestStrategyStreamMatchesBatch`` in ``test_streaming_agg.py``. Inputs are
made with numpy from a seed and fed to both packages; the port runs on the
CPU. Every strategy's ``apply`` is elementwise, one IEEE operation at a
time, so float32 trees must come out byte-equal. ``client_loss_extra`` sums
a reduction (``jnp.sum`` against ``torch.sum``, another order), so it is held
to a float32 tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.fl.strategies as jst
import repro_torch.fl.strategies as tst
from repro_torch.convert import tree_from_numpy
from repro_torch.core.tree import tree_leaves

CPU = torch.device("cpu")
STRATEGIES = ["fedavg", "fedprox", "fedadam", "fedadagrad", "fedyogi", "feddyn",
              "fedbuff", "fedasync"]


def _tree(rng, scale=1.0):
    """A ragged float32 tree: mixed ranks, odd sizes, a nested list."""
    return {
        "w": (scale * rng.normal(size=(33, 7))).astype(np.float32),
        "b": (scale * rng.normal(size=(7,))).astype(np.float32),
        "blocks": [
            (scale * rng.normal(size=(5, 2, 2))).astype(np.float32),
            (scale * rng.normal(size=(11,))).astype(np.float32),
        ],
    }


def _jbytes(tree):
    return [np.asarray(x).tobytes() for x in jax.tree_util.tree_leaves(tree)]


def _tbytes(tree):
    return [x.numpy().tobytes() for x in tree_leaves(tree)]


def _t(tree):
    return tree_from_numpy(tree, CPU)


# ---------------------------------------------------------------------- #
# apply: bytes equal to the JAX package's, step after step
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("name", STRATEGIES)
def test_apply_matches_reference_bytes(name):
    rng = np.random.default_rng(11)
    params = _tree(rng)
    js, ts = jst.get_strategy(name), tst.get_strategy(name)
    jp, tp = params, _t(params)
    jstate, tstate = js.init(jp), ts.init(tp)
    for step in range(4):
        delta = _tree(rng, scale=0.1)
        if name in ("fedbuff", "fedasync"):
            stale = int(rng.integers(0, 4))
            jstate = js.accumulate(jstate, delta, np.int32(stale))
            tstate = ts.accumulate(tstate, _t(delta), stale)
            jd, td = None, None
        else:
            jd, td = delta, _t(delta)
        jp, jstate = js.apply(jp, jd, jstate)
        tp, tstate = ts.apply(tp, td, tstate)
        assert _tbytes(tp) == _jbytes(jp), f"{name}: step {step}"
        if name in ("fedadam", "fedadagrad", "fedyogi", "feddyn"):
            assert _tbytes(tstate) == _jbytes(jstate), f"{name}: state, step {step}"


@pytest.mark.parametrize("name", ["fedadam", "fedyogi"])
def test_adaptive_apply_matches_reference_with_other_knobs(name):
    rng = np.random.default_rng(12)
    kw = dict(lr=0.3, beta1=0.8, beta2=0.95, tau=0.05)
    js, ts = jst.get_strategy(name, **kw), tst.get_strategy(name, **kw)
    params, delta = _tree(rng), _tree(rng)
    jout, _ = js.apply(params, delta, js.init(params))
    tout, _ = ts.apply(_t(params), _t(delta), ts.init(_t(params)))
    assert _tbytes(tout) == _jbytes(jout)


def test_feddyn_divide_is_an_ieee_divide():
    """``h / alpha`` divides by a 0-d tensor, not by a Python float, with
    an alpha whose reciprocal is not exact."""
    rng = np.random.default_rng(13)
    js, ts = jst.get_strategy("feddyn", alpha=0.03), tst.get_strategy("feddyn", alpha=0.03)
    params, delta = _tree(rng), _tree(rng)
    jout, jstate = js.apply(params, delta, js.init(params))
    tout, tstate = ts.apply(_t(params), _t(delta), ts.init(_t(params)))
    assert _tbytes(tout) == _jbytes(jout) and _tbytes(tstate) == _jbytes(jstate)


@pytest.mark.parametrize("name", ["fedprox", "feddyn"])
def test_client_loss_extra_matches_reference(name):
    rng = np.random.default_rng(14)
    js, ts = jst.get_strategy(name), tst.get_strategy(name)
    w, g = _tree(rng), _tree(rng)
    want = float(js.client_loss_extra(w, g, ()))
    got = ts.client_loss_extra(_t(w), _t(g), ())
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_base_client_loss_extra_is_a_float32_zero():
    got = tst.get_strategy("fedavg").client_loss_extra(_t({"w": np.ones(3, np.float32)}), None, ())
    assert got.dtype == torch.float32 and got.shape == () and float(got) == 0.0


# ---------------------------------------------------------------------- #
# the staleness weight: float32 1 / powf(1 + s, exp) on the host
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("exp", [0.5, 1.0, 2.0])
@pytest.mark.parametrize("name", ["fedbuff", "fedasync"])
def test_staleness_weights_bit_equal(name, exp):
    js = jst.get_strategy(name, staleness_exp=exp)
    ts = tst.get_strategy(name, staleness_exp=exp)
    want = np.array([np.asarray(js._update_weight(np.int32(s))) for s in range(200)], np.float32)
    got = np.array([ts._update_weight(s).numpy() for s in range(200)], np.float32)
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("exp", [0.3, 0.5, 0.7, 1.0, 1.5, 2.0])
@pytest.mark.parametrize("name", ["fedbuff", "fedasync"])
def test_staleness_weights_bit_equal_at_every_exponent(name, exp):
    """The weight (FedAsync's ``alpha *`` product included) against the
    JAX package's eager scalar calls, one staleness at a time as its
    runtime makes them, for s = 0 to 999: bit-equal at every exponent.
    torch's ``pow`` missed by up to 2 ulp at 0.3 and 0.7, and a float64
    power rounded to float32 by one at s = 649 and 781 (0.3) and s = 284
    (1.5): the reference's is the C library's ``powf``."""
    js = jst.get_strategy(name, staleness_exp=exp)
    ts = tst.get_strategy(name, staleness_exp=exp)
    want = np.array([np.asarray(js._update_weight(np.int32(s))) for s in range(1000)], np.float32)
    got = np.array([ts._update_weight(s).numpy() for s in range(1000)], np.float32)
    assert got.tobytes() == want.tobytes(), np.nonzero(got != want)[0][:10]


def test_staleness_weight_is_a_host_float32_tensor():
    w = tst.get_strategy("fedbuff").staleness_weight(3)
    assert w.device.type == "cpu" and w.dtype == torch.float32 and w.shape == ()


# ---------------------------------------------------------------------- #
# streaming, stacked and incremental absorption
# ---------------------------------------------------------------------- #
FLUSH_CASES = [
    ("fedbuff", dict(buffer_size=4, server_lr=1.0, staleness_exp=0.5)),
    ("fedbuff", dict(buffer_size=3, server_lr=0.7, staleness_exp=1.0)),
    ("fedasync", dict(alpha=0.6, staleness_exp=0.5)),
]


@pytest.mark.parametrize("name,kwargs", FLUSH_CASES)
def test_batched_flush_reproduces_incremental(name, kwargs):
    """``TestFedBuffFlushBitEquality``: the stacked batch, the streaming
    fold and the incremental chain give the same bytes, which are the JAX
    package's, before and after ``apply``."""
    rng = np.random.default_rng(3)
    js, ts = jst.get_strategy(name, **kwargs), tst.get_strategy(name, **kwargs)
    params = {"w": rng.normal(size=(260, 64)).astype(np.float32)}
    n = kwargs.get("buffer_size", 1)
    deltas = [{"w": rng.normal(size=(260, 64)).astype(np.float32)} for _ in range(n)]
    stals = [int(rng.integers(0, 4)) for _ in range(n)]
    jinc = js.init(params)
    for d, s in zip(deltas, stals):
        jinc = js.accumulate(jinc, d, np.int32(s))
    tp = _t(params)
    inc = ts.init(tp)
    for d, s in zip(deltas, stals):
        inc = ts.accumulate(inc, _t(d), s)
    stream = ts.init(tp)
    for d, s in zip(deltas, stals):
        stream = ts.accumulate_stream(stream, _t(d), s)
    bat = ts.accumulate_batch(ts.init(tp), [_t(d) for d in deltas], stals, fused=True)
    for state in (inc, stream, bat):
        assert int(state["count"]) == int(np.asarray(jinc["count"])) == n
        assert _tbytes(state["acc"]) == _jbytes(jinc["acc"])
    w_ref, _ = js.apply(params, None, jinc)
    for state in (inc, stream, bat):
        w, reset = ts.apply(tp, None, state)
        assert _tbytes(w) == _jbytes(w_ref)
        assert int(reset["count"]) == 0


def test_signed_zero_first_fold_matches_incremental():
    """The accumulator starts from explicit zeros, so ``0 + w*d`` turns -0.0
    into +0.0 on every path; ``fold_into(None, ...)`` (which starts from the
    scaled row and keeps -0.0) would not."""
    params = {"w": np.zeros(2, np.float32)}
    deltas = [{"w": np.array([-0.0, 1.0], np.float32)},
              {"w": np.array([-0.0, 2.0], np.float32)}]
    js = jst.get_strategy("fedbuff", buffer_size=2, server_lr=1.0, staleness_exp=0.5)
    ts = tst.get_strategy("fedbuff", buffer_size=2, server_lr=1.0, staleness_exp=0.5)
    jinc = js.init(params)
    for d in deltas:
        jinc = js.accumulate(jinc, d, np.int32(0))
    tp = _t(params)
    stream = ts.init(tp)
    for d in deltas:
        stream = ts.accumulate_stream(stream, _t(d), 0)
    bat = ts.accumulate_batch(ts.init(tp), [_t(d) for d in deltas], [0, 0])
    want = _jbytes(jinc["acc"])
    assert np.signbit(np.asarray(jinc["acc"]["w"])[0]) == False  # noqa: E712
    assert _tbytes(stream["acc"]) == want and _tbytes(bat["acc"]) == want


def test_nonzero_count_state_folds_update_by_update():
    """On a part-filled state ``accumulate_batch`` folds update by update
    through ``accumulate_stream``, with the JAX package's sequential bits."""
    rng = np.random.default_rng(4)
    js = jst.get_strategy("fedbuff", buffer_size=3, server_lr=1.0, staleness_exp=0.5)
    ts = tst.get_strategy("fedbuff", buffer_size=3, server_lr=1.0, staleness_exp=0.5)
    params = {"w": rng.normal(size=(300, 60)).astype(np.float32)}
    deltas = [{"w": rng.normal(size=(300, 60)).astype(np.float32)} for _ in range(3)]
    jinc = js.accumulate(js.init(params), deltas[0], np.int32(1))
    for d in deltas[1:]:
        jinc = js.accumulate(jinc, d, np.int32(0))
    pre = ts.accumulate(ts.init(_t(params)), _t(deltas[0]), 1)
    bat = ts.accumulate_batch(pre, [_t(d) for d in deltas[1:]], [0, 0], fused=True)
    assert int(bat["count"]) == 3
    assert _tbytes(bat["acc"]) == _jbytes(jinc["acc"])


@pytest.mark.parametrize("name", ["fedbuff", "fedasync"])
def test_accumulate_stream_equals_accumulate_batch_on_ragged_trees(name):
    """``TestStrategyStreamMatchesBatch`` on the ragged tree, against the
    JAX package's batch."""
    kw = {"buffer_size": 8} if name == "fedbuff" else {}
    js, ts = jst.get_strategy(name, **kw), tst.get_strategy(name, **kw)
    rng = np.random.default_rng(23)
    deltas = [_tree(rng, scale=0.1) for _ in range(5)]
    staleness = [0, 2, 1, 4, 0]
    params = _tree(np.random.default_rng(0))
    jbatch = js.accumulate_batch(js.init(params), deltas, staleness)
    bat = ts.accumulate_batch(ts.init(_t(params)), [_t(d) for d in deltas], staleness)
    stream = ts.init(_t(params))
    for d, s in zip(deltas, staleness):
        stream = ts.accumulate_stream(stream, _t(d), s)
    assert int(bat["count"]) == int(stream["count"]) == int(jbatch["count"]) == 5
    assert _tbytes(bat["acc"]) == _tbytes(stream["acc"]) == _jbytes(jbatch["acc"])


def test_accumulate_stream_folds_in_place_through_fold_into(monkeypatch):
    """The streaming absorb goes through the fold's tree entry once per
    update, on the state's own accumulator."""
    calls = []
    real = tst.fold_into

    def counting(acc, tree, w):
        calls.append((acc, w))
        return real(acc, tree, w)

    monkeypatch.setattr(tst, "fold_into", counting)
    ts = tst.get_strategy("fedbuff", buffer_size=2)
    state = ts.init(_t({"w": np.ones(5, np.float32)}))
    acc0 = state["acc"]["w"]
    state = ts.accumulate_stream(state, _t({"w": np.full(5, 2.0, np.float32)}), 3)
    assert len(calls) == 1 and calls[0][1] == float(ts.staleness_weight(3))
    assert state["acc"]["w"] is acc0  # updated in place, nothing retained


# ---------------------------------------------------------------------- #
# twins of test_strategies_fedstep.py's TestStrategies
# ---------------------------------------------------------------------- #
PARAMS = {"w": np.array([1.0, 2.0], np.float32), "b": np.zeros((2, 2), np.float32)}
DELTA = {"w": np.array([0.5, -0.5], np.float32), "b": np.ones((2, 2), np.float32)}


def test_fedavg_applies_delta():
    s = tst.get_strategy("fedavg")
    new, _ = s.apply(_t(PARAMS), _t(DELTA), s.init(_t(PARAMS)))
    np.testing.assert_allclose(new["w"].numpy(), [1.5, 1.5])


@pytest.mark.parametrize("name", ["fedadam", "fedadagrad", "fedyogi"])
def test_adaptive_strategies_descend_quadratic(name):
    js, ts = jst.get_strategy(name, lr=0.1), tst.get_strategy(name, lr=0.1)
    jw, tw = {"w": jnp.array([4.0, -3.0])}, {"w": torch.tensor([4.0, -3.0])}
    jstate, tstate = js.init(jw), ts.init(tw)
    for _ in range(60):
        jw, jstate = js.apply(jw, jax.tree_util.tree_map(lambda x: -x, jw), jstate)
        tw, tstate = ts.apply(tw, {"w": -tw["w"]}, tstate)
    assert float(tw["w"].abs().max()) < 0.9 * 4.0
    assert tw["w"].numpy().tobytes() == np.asarray(jw["w"]).tobytes()


def test_fedprox_client_regularizer():
    s = tst.get_strategy("fedprox", mu=0.1)
    extra = s.client_loss_extra({"w": torch.tensor([2.0])}, {"w": torch.tensor([0.0])}, ())
    assert float(extra) == pytest.approx(0.5 * 0.1 * 4.0)


def test_feddyn_state_updates():
    s = tst.get_strategy("feddyn", alpha=0.1)
    _, new_state = s.apply(_t(PARAMS), _t(DELTA), s.init(_t(PARAMS)))
    assert float(new_state["h"]["w"].abs().sum()) > 0


def test_fedbuff_buffers_then_applies():
    s = tst.get_strategy("fedbuff", buffer_size=2, server_lr=1.0)
    state = s.init(_t(PARAMS))
    state = s.accumulate(state, _t(DELTA), 0)
    assert not bool(s.ready(state))
    state = s.accumulate(state, _t(DELTA), 1)
    assert bool(s.ready(state))
    new, state2 = s.apply(_t(PARAMS), None, state)
    assert int(state2["count"]) == 0
    assert float(new["w"][0]) > float(PARAMS["w"][0])


@settings(max_examples=20, deadline=None)
@given(st.lists(st.floats(-5, 5), min_size=2, max_size=6))
def test_fedavg_identity_property(vals):
    s = tst.get_strategy("fedavg")
    p = {"w": torch.zeros(len(vals))}
    d = {"w": torch.tensor(np.asarray(vals, np.float32))}
    new, _ = s.apply(p, d, s.init(p))
    np.testing.assert_allclose(new["w"].numpy(), np.asarray(vals, np.float32), rtol=1e-6, atol=1e-6)


def test_fedbuff_matches_sequential_reference():
    """``TestFedBuffReference``: the staleness-weighted buffered mean against
    plain arithmetic, and byte-equal to the JAX package."""
    kw = dict(buffer_size=3, server_lr=0.5, staleness_exp=0.5)
    js, ts = jst.get_strategy("fedbuff", **kw), tst.get_strategy("fedbuff", **kw)
    jparams = {"w": jnp.ones((4,), jnp.float32)}
    tparams = {"w": torch.ones(4)}
    jstate, tstate = js.init(jparams), ts.init(tparams)
    for d, tau in zip([1.0, 2.0, 3.0], [0, 1, 2]):
        jstate = js.accumulate(jstate, {"w": jnp.full((4,), d, jnp.float32)}, jnp.int32(tau))
        tstate = ts.accumulate(tstate, {"w": torch.full((4,), d)}, tau)
        assert bool(ts.ready(tstate)) == (tau == 2)
    jnew, _ = js.apply(jparams, None, jstate)
    tnew, reset = ts.apply(tparams, None, tstate)
    ref = 1.0 + 0.5 * sum(d / (1.0 + t) ** 0.5 for d, t in zip([1.0, 2.0, 3.0], [0, 1, 2])) / 3.0
    np.testing.assert_allclose(tnew["w"].numpy(), ref, rtol=1e-6)
    assert tnew["w"].numpy().tobytes() == np.asarray(jnew["w"]).tobytes()
    assert int(reset["count"]) == 0


def test_fedasync_strategy_applies_immediately():
    s = tst.get_strategy("fedasync", alpha=0.5, staleness_exp=1.0)
    params = {"w": torch.zeros(2)}
    state = s.accumulate(s.init(params), {"w": torch.ones(2)}, 1)
    assert bool(s.ready(state))
    new, _ = s.apply(params, None, state)
    np.testing.assert_allclose(new["w"].numpy(), 0.25, rtol=1e-6)


# ---------------------------------------------------------------------- #
# the registry
# ---------------------------------------------------------------------- #
def test_registry_matches_reference():
    assert tst.registered_strategies() == jst.registered_strategies()
    for name in tst.registered_strategies():
        assert tst.get_strategy(name).name == jst.get_strategy(name).name
    with pytest.raises(KeyError, match="unknown strategy"):
        tst.get_strategy("fedmedian")


def test_register_strategy(monkeypatch):
    monkeypatch.setattr(tst, "_STRATEGIES", dict(tst._STRATEGIES))
    with pytest.raises(ValueError, match="already registered"):
        tst.register_strategy("fedavg", tst.FedAvg)
    tst.register_strategy("fedavg2", lambda **kw: tst.FedAvg(server_lr=2.0, **kw))
    assert "fedavg2" in tst.registered_strategies()
    new, _ = tst.get_strategy("fedavg2").apply({"w": torch.ones(2)}, {"w": torch.ones(2)}, ())
    assert new["w"].tolist() == [3.0, 3.0]
    tst.register_strategy("fedavg", tst.FedProx, overwrite=True)
    assert isinstance(tst.get_strategy("fedavg"), tst.FedProx)


def test_package_exports_the_strategies():
    import repro_torch.fl as tfl

    for name in ("ServerStrategy", "FedAvg", "FedProx", "FedAdam", "FedAdagrad", "FedYogi",
                 "FedDyn", "FedBuff", "FedAsync", "get_strategy"):
        assert getattr(tfl, name) is getattr(tst, name)


def test_sqrt_is_correctly_rounded():
    """``_sqrt`` gives the float32 root rounded to nearest (numpy's float64
    root rounded once, which is exact for float32 inputs), where torch's CPU
    ``sqrt`` misrounds some, and XLA's bits."""
    rng = np.random.default_rng(21)
    x = np.concatenate([
        (np.abs(rng.normal(size=200_000)) * 0.01).astype(np.float32),
        (np.abs(rng.normal(size=200_000)) * 1e6).astype(np.float32),
        np.array([0.0, -0.0, np.inf, 1.0, 2.0, 3.4e38, 1.2e-38], np.float32),
    ])
    want = np.sqrt(x.astype(np.float64)).astype(np.float32)
    got = tst._sqrt(torch.from_numpy(x)).numpy()
    assert got.tobytes() == want.tobytes()
    assert got.tobytes() == np.asarray(jnp.sqrt(jnp.asarray(x))).tobytes()


def test_sqrt_in_chunks_gives_the_same_bits(monkeypatch):
    """A CPU tensor longer than ``_SQRT_CHUNK`` is rooted chunk by chunk
    (a non-contiguous one too), with the same bits as in one piece."""
    rng = np.random.default_rng(22)
    x = (np.abs(rng.normal(size=(300, 1001))) * 0.01).astype(np.float32)
    x[0, :4] = [0.0, np.inf, 1.2e-38, 3.4e38]
    t = torch.from_numpy(x).t()  # non-contiguous
    whole = tst._sqrt(t)
    monkeypatch.setattr(tst, "_SQRT_CHUNK", 4096)
    got = tst._sqrt(t)
    assert got.shape == t.shape
    assert got.contiguous().numpy().tobytes() == whole.contiguous().numpy().tobytes()
    want = np.sqrt(x.T.astype(np.float64)).astype(np.float32)
    assert got.contiguous().numpy().tobytes() == np.ascontiguousarray(want).tobytes()
