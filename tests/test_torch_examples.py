"""The port's example programs (``repro_torch.examples``) against the JAX
package's scripts (``examples/*.py``), on the CPU, in one process.

The scripts are loaded from their files (``spec_from_file_location``) and
run as written; their ``run_job`` (and ``run_job_multiproc``) are wrapped
to keep each job's result, which the scripts only print from. Both
packages' trainers seed their data with ``abs(hash(dataset))``, which one
process gives both the same.

What is held:

* ``quickstart`` and ``topology_extension``: the global weights byte-equal
  (the mean trainer's two elementwise ops on numpy's float32 mean; the
  default trainer leaves the weights alone), the snapshots equal, the
  channel bytes equal.
* ``multiproc_quickstart``: threads byte-equal to processes in the port
  (the twin asserts it). Against the JAX script within ``SGD_RTOL`` /
  ``SGD_ATOL``: the port's ``SeededSGDTrainer`` sums its products without
  BLAS and the JAX package's calls numpy's, so their bits differ.
* the softmax-regression twins (``async_fedbuff``, ``hier_async``,
  ``gossip_ring``): virtual times, channel bytes and participation logs
  equal, weights within ``SGD_RTOL`` / ``SGD_ATOL`` (torch's float32
  ``x @ w`` rounds as MKL does, numpy's as its BLAS does), accuracies
  within ``ACC_SAMPLES`` of the 1 024 test samples. Where the order of
  arrivals decides the result, thread timing decides it in both packages
  and runs of either differ from each other: an async tier absorbs updates
  in the order they land, and a deadline root above sync aggregators
  admits one of two relays that arrive at the same virtual time. Those
  cases are held to what does not depend on that order (the script's own
  assert, the count of absorbed updates, round times and counts).
* ``vertical_fl``: messages (165) and channel bytes equal, losses and
  weights within ``SGD_RTOL`` / ``SGD_ATOL``.
* ``per_channel_backends``: the JAX script's own ``build(wire)`` step,
  jitted, on the twin's batch: every round's loss and the final weights
  within ``SGD_RTOL`` / ``SGD_ATOL``.

Both packages run the policy jobs with a wall-clock ``grace`` of
``GRACE`` s instead of the scripts' 1.5 s: every update arrives, so it is
never waited out, and a loaded host cannot cut an on-time update. The
twins' ``main(device="cpu")`` runs end to end with its asserts too.
"""
import dataclasses
import importlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core.runtime as jrt
import repro.launch.spawn as jspawn
from repro_torch.core.tree import tree_leaves
from repro_torch.examples import NAMES
from repro_torch.examples import async_fedbuff as t_async
from repro_torch.examples import gossip_ring as t_gossip
from repro_torch.examples import hier_async as t_hier
from repro_torch.examples import multiproc_quickstart as t_multiproc
from repro_torch.examples import per_channel_backends as t_pcb
from repro_torch.examples import quickstart as t_quick
from repro_torch.examples import topology_extension as t_topo
from repro_torch.examples import vertical_fl as t_vertical

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
SGD_RTOL, SGD_ATOL = 1e-5, 1e-6
ACC_SAMPLES = 2  # of the 1 024 test samples
GRACE = 30.0


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this file's torch work, as the other files
    that run jobs on threads pin them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _script(name: str, monkeypatch):
    """The JAX script ``examples/<name>.py`` as a fresh module, and the list
    its wrapped ``run_job`` / ``run_job_multiproc`` append their results to."""
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    results = []
    for attr, fn in (("run_job", jrt.run_job), ("run_job_multiproc", jspawn.run_job_multiproc)):
        if hasattr(mod, attr):
            monkeypatch.setattr(mod, attr, lambda *a, _fn=fn, **k: results.append(_fn(*a, **k))
                                or results[-1])
    return mod, results


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _byte_equal(ours: dict, ref: dict) -> None:
    assert ours.keys() == ref.keys()
    for k in ours:
        assert ours[k].dtype == ref[k].dtype and ours[k].shape == ref[k].shape, k
        assert ours[k].tobytes() == ref[k].tobytes(), k


def _close(ours: dict, ref: dict) -> None:
    assert ours.keys() == ref.keys()
    for k in ours:
        assert ours[k].dtype == ref[k].dtype and ours[k].shape == ref[k].shape, k
        np.testing.assert_allclose(ours[k], ref[k], rtol=SGD_RTOL, atol=SGD_ATOL, err_msg=k)


def _root(res):
    glob = res.program("global-aggregator-0")
    return glob, glob.ctx.now(glob.down_channel)


def _rounds(log):
    return [(e["included"], e["excluded"], e["missing"], e["round_time"]) for e in log or []]


def _policy_fields(policy) -> dict:
    return {f.name: getattr(policy, f.name) for f in dataclasses.fields(policy)}


# ---------------------------------------------------------------------- #
# quickstart, topology_extension, multiproc_quickstart: bytes
# ---------------------------------------------------------------------- #
def test_quickstart_byte_equal_to_the_script(monkeypatch):
    jmod, jres = _script("quickstart", monkeypatch)
    jmod.main()
    ours = t_quick.main("cpu")
    _byte_equal(ours["weights"], _np(jres[0].global_weights()))
    assert ours["channel_bytes"] == jres[0].channel_bytes


def test_topology_extension_byte_equal_to_the_script(monkeypatch):
    jmod, jres = _script("topology_extension", monkeypatch)
    jmod.main()
    ours = t_topo.main("cpu")
    assert ours["snapshots"] == jmod.SNAPSHOTS and len(ours["snapshots"]) == 3
    _byte_equal(ours["weights"], _np(jres[0].global_weights()))
    assert ours["channel_bytes"] == jres[0].channel_bytes
    from repro.core.tag import diff_tags
    from repro.core.topologies import coordinated_fl, hierarchical_fl

    assert ours["tag_diff"] == diff_tags(hierarchical_fl(), coordinated_fl())


@pytest.mark.multiproc
def test_multiproc_quickstart_threads_and_processes_against_the_script(
        monkeypatch, assert_children_reaped):
    """The twin's threads and processes byte-equal (its own assert), both
    within the SGD tolerance of the JAX script's, whose threads and
    processes are byte-equal too (its assert); the bytes over the hub equal."""
    jmod, jres = _script("multiproc_quickstart", monkeypatch)
    jmod.main()
    ours = t_multiproc.main("cpu")
    _byte_equal(ours["threads"], ours["processes"])
    jthreads, jprocs = jres
    _close(ours["threads"], _np(jthreads.global_weights()))
    assert ours["threads_channel_bytes"] == jthreads.channel_bytes
    assert ours["channel_bytes"] == jprocs.channel_bytes
    assert ours["workers"] == len(jprocs.workers) == 4
    assert_children_reaped()


# ---------------------------------------------------------------------- #
# the softmax-regression twins
# ---------------------------------------------------------------------- #
def _held_exactly(ours: dict, jres, jacc: float) -> None:
    glob, jtime = _root(jres)
    assert ours["virtual_time"] == jtime
    assert ours["channel_bytes"] == jres.channel_bytes
    assert _rounds(ours["participation"]) == _rounds(getattr(glob, "participation_log", None))
    _close(ours["weights"], _np(jres.global_weights()))
    assert abs(ours["accuracy"] - jacc) * 1024 <= ACC_SAMPLES


def _held_by_structure(ours: dict, jres, jacc: float) -> None:
    """What the order of arrivals does not decide: both learn (the script's
    assert), the same count of updates absorbed at the root, finite weights."""
    glob, jtime = _root(jres)
    assert ours["accuracy"] > 0.5 and jacc > 0.5
    assert len(ours["staleness"] or []) == len(getattr(glob, "staleness_log", None) or [])
    assert len(ours["participation"] or []) == len(getattr(glob, "participation_log", None) or [])
    assert np.isfinite(ours["virtual_time"]) and ours["virtual_time"] > 0 and jtime > 0
    assert all(np.isfinite(x).all() for x in tree_leaves(ours["weights"]))


def test_async_fedbuff_policies_are_the_script_s(monkeypatch):
    """The twin's three policies at the script's grace are the ones the
    script builds (its ``run_policy`` replaced, so no job runs)."""
    jmod, _ = _script("async_fedbuff", monkeypatch)
    built = []
    monkeypatch.setattr(jmod, "run_policy", lambda p: built.append(p) or (1.0, 0.0))
    jmod.main()
    assert [_policy_fields(p) for p in built] == [
        _policy_fields(p) for p in t_async.policies().values()]


@pytest.mark.parametrize("name", ["sync", "deadline", "async"])
def test_async_fedbuff_policy_against_the_script(name, monkeypatch):
    jmod, jres = _script("async_fedbuff", monkeypatch)
    monkeypatch.setattr(t_async, "GRACE", GRACE)
    policy = t_async.policies()[name]
    jacc, jtime = jmod.run_policy(jrt.RuntimePolicy(**_policy_fields(policy)))
    ours = t_async.run_policy(policy, "cpu")
    assert jtime == _root(jres[0])[1]
    if name == "async":
        _held_by_structure(ours, jres[0], jacc)
        assert len(ours["staleness"]) == t_async.ROUNDS * policy.buffer_size
    else:
        _held_exactly(ours, jres[0], jacc)
    assert ours["virtual_time"] == {"sync": 40.0, "deadline": 10.0}.get(name, ours["virtual_time"])


@pytest.mark.parametrize("root", t_hier.MODES)
@pytest.mark.parametrize("middle", t_hier.MODES)
def test_hier_async_combo_against_the_script(root, middle, monkeypatch):
    jmod, jres = _script("hier_async", monkeypatch)
    built = []

    def policy(**kw):  # the script's policy, at the tests' grace
        built.append(kw)
        return jrt.RuntimePolicy(**{**kw, "grace": GRACE})

    monkeypatch.setattr(jmod, "RuntimePolicy", policy)
    jacc, _ = jmod.run_combo(root, middle)
    assert built == [{k: v for k, v in _policy_fields(t_hier.policy(root, middle)).items()
                      if k in built[0]}]
    monkeypatch.setattr(t_hier, "GRACE", GRACE)
    ours = t_hier.run_combo(root, middle, "cpu")
    if (root, middle) not in t_hier.ARRIVAL_ORDERED:
        _held_exactly(ours, jres[0], jacc)
        return
    _held_by_structure(ours, jres[0], jacc)
    if root != "async" and middle != "async":
        # a deadline root over sync aggregators: one relay admitted a round,
        # which one decided by arrival order; the times and bytes are not
        glob, jtime = _root(jres[0])
        assert ours["virtual_time"] == jtime
        assert ours["channel_bytes"] == jres[0].channel_bytes
        shape = [(len(i), len(e), m, t) for i, e, m, t in _rounds(ours["participation"])]
        assert shape == [(len(i), len(e), m, t) for i, e, m, t in
                         _rounds(glob.participation_log)]


@pytest.mark.parametrize("codec", t_gossip.CODECS, ids=["raw", "topk0.25"])
def test_gossip_ring_against_the_script(codec, monkeypatch):
    jmod, jres = _script("gossip_ring", monkeypatch)
    jaccs, jbytes = jmod.run_ring(codec)
    ours = t_gossip.run_ring(codec, "cpu")
    assert ours["link_bytes"] == jbytes == {"": 13760.0, "topk0.25": 7680.0}[codec]
    assert ours["channel_bytes"] == jres[0].channel_bytes
    assert list(ours["weights"]) == list(jres[0].programs)
    for wid, w in ours["weights"].items():
        _close(w, _np(jres[0].programs[wid].weights))
    for a, b in zip(ours["accuracies"], jaccs, strict=True):
        assert abs(a - b) * 1024 <= ACC_SAMPLES


def test_vertical_fl_against_the_script(monkeypatch):
    jmod, jres = _script("vertical_fl", monkeypatch)
    jmod.main()
    ours = t_vertical.main("cpu")
    head = jres[0].program("head-0")
    assert ours["messages"] == head.ctx.channels.total_msgs("activation-channel") == 165
    assert ours["channel_bytes"] == jres[0].channel_bytes
    jlosses = [m["vertical_loss"] for m in head.metrics if "vertical_loss" in m]
    np.testing.assert_allclose(ours["losses"], jlosses, rtol=SGD_RTOL, atol=SGD_ATOL)
    assert ours["weights"].keys() == jres[0].programs.keys()
    for wid, w in ours["weights"].items():
        _close(w, _np(jres[0].programs[wid].weights))


@pytest.mark.parametrize("wire", t_pcb.WIRES)
def test_per_channel_backends_against_the_script_s_step(wire, monkeypatch):
    """The script's ``build(wire)`` step, on the twin's numpy batch (the
    script's ``jax.random`` draw has no torch counterpart), jitted as the
    JAX package's tests run it (called eagerly it traces anew every round,
    about 2 s a round on the CPU)."""
    import jax
    import jax.numpy as jnp

    jmod, _ = _script("per_channel_backends", monkeypatch)
    step, strat, plan = jmod.build(wire)
    step = jax.jit(step)
    data = t_pcb.batch()
    params = {"w": jnp.zeros((3, 1))}
    state = jmod.init_server_state(strat, plan, params)
    rng, jlosses = jax.random.key(0), []
    for i in range(t_pcb.STEPS):
        params, state, m = step(params, state, {k: jnp.asarray(v) for k, v in data.items()},
                                jax.random.fold_in(rng, i))
        jlosses.append(float(m["loss"]))
    ours = t_pcb.train(wire, {k: torch.from_numpy(v) for k, v in data.items()})
    np.testing.assert_allclose(ours["losses"], jlosses, rtol=SGD_RTOL, atol=SGD_ATOL)
    _close({"w": ours["w"]}, {"w": np.asarray(params["w"])})
    assert ours["losses"][-1] < 0.05


# ---------------------------------------------------------------------- #
# the entry points, end to end
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("name", [n for n in NAMES if n != "multiproc_quickstart"])
def test_main_runs_end_to_end_on_the_cpu(name, capsys):
    """Each twin's ``main(device="cpu")`` with its asserts, printing its
    script's ``... OK`` line (``multiproc_quickstart``'s runs in its test
    above, which spawns processes)."""
    out = importlib.import_module(f"repro_torch.examples.{name}").main("cpu")
    assert isinstance(out, dict) and out
    assert f"{name} OK" in capsys.readouterr().out
