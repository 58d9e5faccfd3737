"""Client and sample selection and the Dirichlet split of the port
(``repro_torch.fl.selection``, ``fl.sampling``, ``data.datasets.
dirichlet_partition``) against the JAX package's.

Both packages draw with numpy generators seeded the same way, so picks,
indices, thresholds and shards are *equal*, not equal in distribution:
``TestSelection`` of ``test_mgmt_misc.py`` and ``TestDeadlineSelector`` of
``test_async_runtime.py`` on the port's side, the random and Oort picks
over 20 rounds, FedBalancer's indices and thresholds given numpy and torch
losses, and the shards byte for byte.
"""
import numpy as np
import pytest
import torch

import repro.data as jdata
import repro.fl.sampling as jsampling
import repro.fl.selection as jselection
import repro_torch.data as tdata
import repro_torch.fl as tfl
import repro_torch.fl.sampling as tsampling
import repro_torch.fl.selection as tselection

CLIENTS = [f"c{i}" for i in range(10)]


def test_oort_prefers_high_utility():
    sel = tfl.get_selector("oort", epsilon=0.0, seed=0)
    for i, c in enumerate(CLIENTS):
        sel.report(c, stat_util=float(i), duration=1.0)
    picked = sel.select(CLIENTS, k=3, round_idx=5)
    assert "c9" in picked and "c0" not in picked


def test_random_selector_is_seeded():
    a = tfl.get_selector("random", seed=1).select(CLIENTS, 3, 0)
    b = tfl.get_selector("random", seed=1).select(CLIENTS, 3, 0)
    assert a == b


def test_predicted_stragglers_skipped_then_probed():
    sel = tfl.get_selector("deadline", deadline=1.0, probe_every=3)
    clients = ["c0", "c1", "c2"]
    sel.report("c1", 0.0, duration=5.0)  # past deadline
    assert sel.select(clients, k=2, round_idx=0) == ["c0", "c2"]
    # after probe_every rounds the straggler is probed again
    assert "c1" in sel.select(clients, k=3, round_idx=3)


def _feedback(rnd, picked):
    """Deterministic per-round reports: utility and duration from the
    client's index and the round."""
    for c in picked:
        i = int(c[1:])
        yield c, float((7 * i + 3 * rnd) % 11), 0.4 + 0.3 * ((i + rnd) % 5)


@pytest.mark.parametrize("name,kw", [
    ("all", {}),
    ("random", {"seed": 3}),
    ("oort", {"seed": 5}),
    ("oort", {"seed": 0, "epsilon": 0.5, "alpha": 1.0, "target_duration": 0.8}),
    ("deadline", {"deadline": 1.0, "probe_every": 3}),
])
def test_picks_equal_to_reference_over_20_rounds(name, kw):
    port, ref = tselection.get_selector(name, **kw), jselection.get_selector(name, **kw)
    assert type(port).__name__ == type(ref).__name__ and port.name == ref.name
    for rnd in range(20):
        k = 2 + rnd % 5
        a, b = port.select(CLIENTS, k, rnd), ref.select(CLIENTS, k, rnd)
        assert a == b, (rnd, a, b)
        assert len(a) == (len(CLIENTS) if name == "all" else min(k, len(CLIENTS)))
        for c, util, dur in _feedback(rnd, a):
            port.report(c, util, dur)
            ref.report(c, util, dur)


def _losses(seed, n=200):
    rng = np.random.default_rng(seed)
    return rng.gamma(2.0, 1.0, size=n).astype(np.float32)


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "torch"])
@pytest.mark.parametrize("kw", [{}, {"lt_ratio": 0.2, "ut_ratio": 0.9, "step": 0.1},
                                {"min_keep": 150}])
def test_fedbalancer_indices_and_thresholds_equal_to_reference(kw, as_tensor):
    port, ref = tsampling.FedBalancerSampler(**kw), jsampling.FedBalancerSampler(**kw)
    for rnd in range(8):
        losses = _losses(rnd)
        given = torch.from_numpy(losses) if as_tensor else losses
        a, b = port.select(given, rnd), ref.select(losses, rnd)
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype and a.tolist() == b.tolist()
        assert (port._lt, port._ut, port.lt_ratio) == (ref._lt, ref._ut, ref.lt_ratio)
        port.update_thresholds(given)
        ref.update_thresholds(losses)
    all_port = tsampling.SelectAllSampler().select(torch.from_numpy(_losses(9)), 0)
    assert all_port.tolist() == jsampling.SelectAllSampler().select(_losses(9), 0).tolist()


@pytest.mark.parametrize("kw", [{"num_clients": 4}, {"num_clients": 6, "alpha": 0.1, "seed": 3},
                                {"num_clients": 3, "alpha": 5.0, "num_classes": 5,
                                 "samples_per_client": 64, "num_features": 8,
                                 "prefix": "site"}])
def test_dirichlet_partition_byte_equal_to_reference(kw):
    port, ref = tdata.dirichlet_partition(**kw), jdata.dirichlet_partition(**kw)
    assert len(port) == len(ref) == kw["num_clients"]
    for a, b in zip(port, ref):
        assert a.name == b.name and a.num_samples == b.num_samples
        assert a.x.dtype == b.x.dtype and a.x.tobytes() == b.x.tobytes()
        assert a.y.dtype == b.y.dtype and a.y.tobytes() == b.y.tobytes()
    # the split skews labels: shards of a small alpha differ in their mix
    if kw.get("alpha", 0.5) < 1.0:
        counts = [np.bincount(s.y, minlength=10) for s in port]
        assert len({tuple(c) for c in counts}) == len(counts)
