"""``chip_smoke.py``'s failure report and held-memory reading, on the CPU.

A phase that raises names itself on stdout (``phase <id> FAILED: ...``),
the phases' seconds so far follow, the traceback goes to stderr and the
script exits 1 without its ``{"ok": true`` line. The held-memory gates read
both their sides after a collection and a synchronize, with cuBLAS's
workspaces released, outside any profiler session (the torch calls are
stubbed here), and a gate that fails prints the live blocks first.
"""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this file's torch work: the suite runs six
    files at once on the CPU, and eight threads in each slowed the 4 s
    decode-check case to 200 s."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _boom():
    raise chip_smoke.PhaseFailed("9.2 MB of device memory held after the MoE phase")


def test_failing_phase_names_itself_and_exits_1(capsys):
    phase_s = {"1": 6.8}
    with pytest.raises(SystemExit) as exc:
        chip_smoke.run_phase(phase_s, "6d", _boom)
    assert exc.value.code == 1
    out, err = capsys.readouterr()
    lines = out.splitlines()
    assert lines[0] == ("phase 6d FAILED: PhaseFailed: 9.2 MB of device memory held after "
                        "the MoE phase")
    assert lines[1].startswith("phase_s ")
    assert set(json.loads(lines[1][len("phase_s "):])) == {"1", "6d"}
    assert '{"ok": true' not in out
    assert "Traceback" in err and "_boom" in err


def test_passing_phase_returns_its_value_and_records_its_seconds(capsys):
    phase_s = {}
    assert chip_smoke.run_phase(phase_s, "2", lambda x: x + 1, 41) == 42
    assert list(phase_s) == ["2"] and phase_s["2"] >= 0.0
    assert capsys.readouterr().out == ""


def test_main_reports_the_first_failing_phase(monkeypatch, capsys):
    """``main`` runs its phases through the wrapper: the environment phase
    failing stops the run at once, with its line and no result."""
    ran = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(chip_smoke, "phase_environment",
                        lambda: (_ for _ in ()).throw(RuntimeError("nvcc failed")))
    monkeypatch.setattr(chip_smoke, "phase_parity", lambda dev: ran.append("2"))
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main()
    assert exc.value.code == 1 and ran == []
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "phase 1 FAILED: RuntimeError: nvcc failed"
    assert '{"ok": true' not in out


@pytest.fixture
def stub_cuda(monkeypatch):
    """The torch calls a held reading makes, recorded in order."""
    calls = []
    state = {"allocated": 1000, "profiling": False}
    monkeypatch.setattr(chip_smoke.gc, "collect", lambda: calls.append("collect"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: calls.append("synchronize"))
    monkeypatch.setattr(torch._C, "_cuda_clearCublasWorkspaces",
                        lambda: calls.append("clear_workspaces"), raising=False)
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: state["profiling"])

    def allocated(*a):
        calls.append("read")
        return state["allocated"]

    monkeypatch.setattr(torch.cuda, "memory_allocated", allocated)
    monkeypatch.setattr(torch.cuda, "memory_snapshot", lambda: [{
        "device": 0, "stream": 7, "blocks": [
            {"size": 33_554_432, "state": "active_allocated",
             "frames": [{"filename": "moe.py", "line": 12, "name": "route"}]},
            {"size": 4096, "state": "inactive"}]}])
    return calls, state


def test_held_reading_clears_library_workspaces_on_both_sides(stub_cuda):
    calls, state = stub_cuda
    dev = torch.device("cuda", 0)
    before = chip_smoke.program_bytes(dev)
    state["allocated"] = 1000 + 500_000
    assert chip_smoke.check_held(dev, before, 1.0, "the phase", strict=True) == 0.5
    assert calls == ["collect", "synchronize", "clear_workspaces", "read"] * 2


def test_held_gate_prints_live_blocks_then_fails(stub_cuda, capsys):
    calls, state = stub_cuda
    dev = torch.device("cuda", 0)
    before = chip_smoke.program_bytes(dev)
    state["allocated"] = 1000 + 9_200_000
    with pytest.raises(chip_smoke.PhaseFailed, match="9.2 MB of device memory held after the "
                                                     "MoE phase"):
        chip_smoke.check_held(dev, before, 1.0, "the MoE phase", strict=True)
    out = capsys.readouterr().out
    assert "the MoE phase: 9.2 MB held; live blocks" in out
    blocks = json.loads(out.split("live blocks ", 1)[1])
    assert blocks == [{"size": 33_554_432, "stream": 7, "frames": ["moe.py:12 route"]}]
    # a limit is a limit: exactly at it passes unless the gate is strict
    state["allocated"] = 1000 + 1_000_000
    assert chip_smoke.check_held(dev, before, 1.0, "the jobs") == 1.0
    with pytest.raises(chip_smoke.PhaseFailed):
        chip_smoke.check_held(dev, before, 1.0, "the MoE phase", strict=True)


def test_held_reading_refuses_an_open_profiler_session(stub_cuda):
    calls, state = stub_cuda
    state["profiling"] = True
    with pytest.raises(chip_smoke.PhaseFailed, match="profiler"):
        chip_smoke.program_bytes(torch.device("cuda", 0))
    assert "read" not in calls


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "script_alone"])
def test_no_result_without_a_card_or_a_checkout(tmp_path, alone):
    """Without CUDA (here), and in a directory holding only the script,
    it exits non-zero and prints no result."""
    script = ROOT / "chip_smoke.py"
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = tmp_path / "chip_smoke.py"
    proc = subprocess.run([sys.executable, str(script)], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


SERVING_PHASES = [("6h", "phase_serve_hymba"), ("6x", "phase_serve_xlstm"),
                  ("6s", "phase_serve_seamless"), ("6g", "phase_serve_gemma"),
                  ("6f", "phase_serve_qwen_f32"), ("6v", "phase_serve_qwen2_vl"),
                  ("6k", "phase_serve_deepseek"), ("6j", "phase_serve_glm4"),
                  ("6l", "phase_serve_llama4")]


@pytest.mark.parametrize("phase,fn", SERVING_PHASES, ids=[p for p, _ in SERVING_PHASES])
def test_serving_phase_failure_names_its_id(monkeypatch, capsys, phase, fn):
    """``main`` runs the nine later serving phases after 6d, in order,
    each under its own id: every phase before the failing one ran, none
    after it, and the failure line names it."""
    ran = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(chip_smoke, "free_device", lambda: None)
    earlier = ["phase_environment", "phase_parity", "phase_small_jobs", "phase_small_topologies",
               "phase_small_policies", "phase_examples", "phase_full_width",
               "phase_full_width_topologies", "phase_full_width_policies", "phase_codec_parity",
               "phase_codec_job", "phase_process_plane", "phase_fault_plane", "phase_flash_parity",
               "phase_serve", "phase_serve_moe"]
    for name in earlier:
        monkeypatch.setattr(chip_smoke, name, lambda *a, _n=name: ran.append(_n) or {})
    for _, name in SERVING_PHASES:
        if name == fn:
            monkeypatch.setattr(chip_smoke, name, lambda dev: _boom())
        else:
            monkeypatch.setattr(chip_smoke, name, lambda dev, _n=name: ran.append(_n) or {})
    monkeypatch.setattr(chip_smoke, "phase_train", lambda *a: ran.append("phase_train"))
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main()
    assert exc.value.code == 1
    order = [name for _, name in SERVING_PHASES]
    assert ran == earlier + order[:order.index(fn)]
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"phase {phase} FAILED: PhaseFailed: ")
    assert list(json.loads(lines[1][len("phase_s "):]))[-1] == phase


@pytest.mark.parametrize("arch", ["hymba_1_5b", "xlstm_1_3b", "seamless_m4t_medium", "gemma_7b",
                                  "qwen2_5_3b", "qwen2_vl_2b", "deepseek_7b", "glm4_9b",
                                  "qwen3_moe_235b_a22b", "llama4_maverick_400b_a17b"])
@pytest.mark.parametrize("scan_layers", [False, True])
def test_tree_param_count_counts_the_jax_packages_tree(arch, scan_layers):
    """The serving phases hold the port's parameter count against
    ``_tree_param_count``, worked out from the shapes: it counts the JAX
    package's init tree (reduced configs, both stackings; the MoE configs'
    routers, experts, shared expert and interleaved dense layers)."""
    import dataclasses

    import jax

    from repro.configs import get_config as jax_get_config
    from repro.models.api import build_model as jax_build_model

    cfg = dataclasses.replace(jax_get_config(arch, reduced=True), scan_layers=scan_layers)
    shapes = jax.eval_shape(jax_build_model(cfg).init, jax.random.key(0))
    want = sum(int(x.size) for x in jax.tree_util.tree_leaves(shapes))
    assert chip_smoke._tree_param_count(cfg) == want


def _reduced(arch, **kw):
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch, reduced=True), scan_layers=True, **kw)


DECODE_CUTS = {"hymba_2_layers": ("hymba_1_5b", {"num_layers": 2}),
               "xlstm_period": ("xlstm_1_3b", {"num_layers": 8}),
               "slstm_alone": ("xlstm_1_3b", {"num_layers": 1, "slstm_every": 1})}


@pytest.mark.parametrize("cut", list(DECODE_CUTS))
def test_decode_check_holds_and_sees_its_planted_faults(cut):
    """The serving phases' bf16 decode check on the reduced models, on the
    CPU: the decode's logits and first-layer state hold their limits, and
    each planted decode fault (the state rounded to bf16, a fresh state
    each step) reads above its own; a failing gate raises."""
    arch, kw = DECODE_CUTS[cut]
    cfg = _reduced(arch, param_dtype="bfloat16", attn_impl="flash", **kw)
    text = chip_smoke._decode_check(torch.device("cpu"), cfg, 2 * cfg.ssd_chunk)
    assert f"{chip_smoke.DECODE_STEPS} steps after a prefill of {2 * cfg.ssd_chunk}" in text
    # the patched recurrences are put back
    from repro_torch.models import blocks, ssd

    assert blocks.ssd_decode_step is ssd.ssd_decode_step and blocks.slstm_scan is ssd.slstm_scan


@pytest.mark.parametrize("arch", ["qwen2_5_3b", "gemma_7b", "seamless_m4t_medium"])
def test_flash_gate_sees_the_planted_attention_faults(arch):
    """``_flash_gate`` on a reduced float32 model, on the CPU: the flash
    prefill within the plain gate and every planted attention fault above
    it; with as many kv heads as query heads the wrong-kv-head fault is no
    fault and is left out."""
    from repro_torch.models import blocks
    from repro_torch.models.api import build_model

    cfg = _reduced(arch, attn_impl="flash")
    bundle = build_model(cfg, "cpu")
    plain = build_model(cfg.__class__(**{**cfg.__dict__, "attn_impl": "xla"}), "cpu")
    gen = torch.Generator().manual_seed(0)
    params = bundle.init(gen)
    prompts = torch.randint(0, cfg.vocab_size, (2, 32), generator=gen)
    batch = {"tokens": prompts}
    if cfg.encoder_layers:
        batch["frames"] = chip_smoke.STUB_FRAMES * torch.randn(
            2, cfg.frontend_len, cfg.d_model, generator=gen)
    run = {"bundle": bundle, "params": params, "prompts": prompts, "batch": batch,
           "logits_f": bundle.prefill(params, dict(batch), bundle.init_cache(2, 33))[0],
           "logits_x": plain.prefill(params, dict(batch), plain.init_cache(2, 33))[0]}
    text = chip_smoke._flash_gate(arch, cfg, run, chip_smoke._plain_gate)
    controls = json.loads(text.split("planted attention faults) ", 1)[1])
    want = {"tile_dropped", "not_causal"}
    if cfg.num_kv_heads < cfg.num_heads:
        want.add("wrong_kv_head")
    assert set(controls) == want
    assert min(controls.values()) > chip_smoke.SERVE_REL_L2
    assert blocks.flash_attention is chip_smoke.flash_attention
    # a prefill far from the plain one fails the gate
    run["logits_f"] = run["logits_f"] + run["logits_f"].abs().mean()
    with pytest.raises(chip_smoke.PhaseFailed, match="flash prefill"):
        chip_smoke._flash_gate(arch, cfg, run, chip_smoke._plain_gate)


# ---------------------------------------------------------------------- #
# phase 9: tensor parallelism
# ---------------------------------------------------------------------- #
def _tp_results(layers, V=12, fault_rel=1.0, gathered=0, share=0.5, launches=None):
    """Synthetic rank results of one model for ``_tp_serving_checks``: two
    ranks' vocabulary blocks that put back the one-process logits, a fault
    drive off by ``fault_rel``, and the float32 run's."""
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn(2, 1 + chip_smoke.TP_STEPS, V, generator=gen)
    ref = {"logits": logits, "param_bytes": 1000, "prefill_s": 0.5, "decode_ms": 3.0}
    ref32 = {"logits": logits * 2}
    counters = {"all_reduces": 9, "all_reduce_bytes": 9 << 20}
    want = chip_smoke.on_entry("flash_attention_forward_sm90", layers)

    def drive(x, rank):
        return {"logits": x[..., rank * V // 2:(rank + 1) * V // 2], "gathered": gathered,
                "prefill_launches": launches or want, "prefill_bhsd": layers,
                "step_launches": 0, "prefill_counters": counters, "step_counters": counters,
                "prefill_s": 0.6, "decode_ms": 4.0}

    res = [{"param_bytes": int(share * 1000), "peak_gb": 1.0,
            "drives": [drive(logits, r), drive(logits[:, :1] * (1 + fault_rel), r)]}
           for r in range(2)]
    res32 = [{"drives": [drive(logits * 2, r)]} for r in range(2)]
    return ref, ref32, res, res32


def test_phase9_report_names_its_gates_and_limits(capsys):
    ref, ref32, res, res32 = _tp_results(4)
    info = chip_smoke._tp_serving_checks("Qwen2.5-3B", ref, ref32, res, res32, 4, "8/1",
                                         pinned=False)
    line = capsys.readouterr().out
    assert line.startswith("phase 9b Qwen2.5-3B: ")
    assert f"<= {chip_smoke.SERVE_REL_L2}" in line and f"<= {chip_smoke.TP_F32_REL}" in line
    assert "fault skip_wo_all_reduce rel L2" in line and "0 gathered" in line
    assert "4 flash_sm90 launches a prefill per rank at H 8/1" in line
    assert "all-reduces (count, bytes) per prefill" in line and "information only" in line
    assert info["rel_l2"]["gate"] == 0.0 and info["launches_per_rank"] == [4, 4]


@pytest.mark.parametrize("fault", ["weak_fault", "gathered", "param_share", "fallback"])
def test_phase9_gates_fail(fault):
    kw = {"weak_fault": dict(fault_rel=1e-3), "gathered": dict(gathered=2),
          "param_share": dict(share=0.6),
          "fallback": dict(launches=chip_smoke.on_entry("flash_attention_forward", 4))}[fault]
    ref, ref32, res, res32 = _tp_results(4, **kw)
    with pytest.raises(chip_smoke.PhaseFailed):
        chip_smoke._tp_serving_checks("Qwen2.5-3B", ref, ref32, res, res32, 4, "8/1",
                                      pinned=False)


def test_near_ties_hold_rounding_flips_and_name_a_wrong_token():
    """``_near_ties`` on bf16 greedy tokens: a flip between two logits
    closer than the rows' rounding noise is a near-tie within its limit;
    a grid that picks a token far below the top is not."""
    gen = torch.Generator().manual_seed(3)
    want = torch.randn((2, 3, 1000), generator=gen)
    want[0, 1, 7], want[0, 1, 9] = 10.0, 10.0005  # a near-tie: one process picks 9
    noise = 1e-2 * torch.randn(want.shape, generator=gen)
    got = want + noise
    got[0, 1, 7], got[0, 1, 9] = 10.001, 10.0  # the grid picks 7
    ties = chip_smoke._near_ties(got, want)
    assert [t["at"] for t in ties] == [[0, 1]]
    assert ties[0]["margin"] == pytest.approx(5e-4, rel=1e-3)
    assert ties[0]["margin"] <= ties[0]["limit"]
    got[1, 2, 3] = 100.0  # a token the one-process logits put far below their top
    far = [t for t in chip_smoke._near_ties(got, want) if t["at"] == [1, 2]]
    assert len(far) == 1 and far[0]["margin"] > far[0]["limit"]


_REHEARSAL = r'''
"""Phase 9 of chip_smoke.py on the CPU at tiny widths: spawned ranks re-run
this top level, so they take the same stand-ins."""
import dataclasses, sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
from repro_torch.configs import get_config as real_get
from repro_torch.kernels.flash_attention import kernel as fk, ref as fref

def tiny(arch):
    cfg = real_get(arch)
    if arch == "qwen2_5_3b":
        return dataclasses.replace(cfg, d_model=64, d_ff=256, vocab_size=1000)
    if arch == "hymba_1_5b":  # 25/5 heads of 64 and 25 SSD heads as published; the
        # window no longer than the prompt, as on the card (2048 of 2048)
        return dataclasses.replace(cfg, d_model=100, d_ff=128, vocab_size=1000,
                                   sliding_window=32)
    if arch == "xlstm_1_3b":  # the published state (N 256) on d 64, a period of 2
        return dataclasses.replace(cfg, d_model=64, vocab_size=1000, slstm_every=2)
    return dataclasses.replace(cfg, d_model=64, moe_d_ff=32, vocab_size=1000)

cs.get_config = tiny
real_check = cs.check
cs.check = lambda cond, what: None if "widths" in what else real_check(cond, what)
for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
    setattr(torch.cuda, name, lambda *a, **k: None)
torch.cuda.max_memory_allocated = lambda *a, **k: 0
cs.cuda_ms = lambda fn, reps=5: (fn(), 0.1)[1]
fk._check = lambda *a: True

def plain_sm90(q, k, v, *, causal=True, window=0):
    plain_sm90.launches += 1
    return fref.reference_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                    causal=causal, window=window).transpose(1, 2)

plain_sm90.launches = 0
plain_sm90.__name__ = "flash_forward_sm90"
fk.ROUTES["flash_forward_sm90"] = plain_sm90
fk.KERNELS = (fk.flash_attention_bhsd, fk.flash_forward, plain_sm90, fk.flash_forward_sm90_d256)
cs.SERVE_BATCH, cs.SERVE_PROMPT, cs.TP_F32_PROMPT, cs.TRAIN_SEQ = 2, 64, 32, 32
cs.TP_HYMBA_LAYERS, cs.TP_XLSTM_LAYERS, cs.TP_F32_HYMBA_LAYERS = 2, 2, 1

if __name__ == "__main__":
    import types
    from repro_torch.launch import mesh as hw

    out = cs.phase_tensor_parallel(torch.device("cpu"), "no card")
    print("LAUNCHES", out["qwen"]["launches_per_rank"], out["moe"]["launches_per_rank"],
          out["hymba"]["launches_per_rank"], out["xlstm"]["launches_per_rank"])
    grid = cs.phase_grid(torch.device("cpu"), "no card", out)
    print("GRID LAUNCHES", grid["qwen"]["launches_per_rank"], grid["moe"]["launches_per_rank"],
          grid["llama4"]["launches_per_rank"])
    torch.cuda.get_device_properties = lambda dev: types.SimpleNamespace(
        total_memory=hw.HBM_PER_CARD)
    ten = cs.phase_dry_run(torch.device("cpu"), {"prefill_ms": 1e6}, out, "no card", grid)
    print("DRYRUN", ten["roofline"]["dominant"], ten["param_bytes"])
    right = grid["train"]["by_axis"][1]
    grid["train"]["by_axis"][1] = {"model": right["model"], "data": (1, 1)}
    try:
        cs.phase_dry_run(torch.device("cpu"), {"prefill_ms": 1e6}, out, "no card", grid)
    except cs.PhaseFailed as e:
        print("GRID MISCOUNT REFUSED", e)
    grid["train"]["by_axis"][1] = right
    right = grid["llama4_train"]["by_axis"][2]
    grid["llama4_train"]["by_axis"][2] = {"model": right["model"], "data": (1, 1)}
    try:
        cs.phase_dry_run(torch.device("cpu"), {"prefill_ms": 1e6}, out, "no card", grid)
    except cs.PhaseFailed as e:
        print("LLAMA4 STEP MISCOUNT REFUSED", e)
    grid["llama4_train"]["by_axis"][2] = right
    out["qwen"]["prefill_all_reduce"][1] = (8, 0)
    try:
        cs.phase_dry_run(torch.device("cpu"), {"prefill_ms": 1e6}, out, "no card")
    except cs.PhaseFailed as e:
        print("MISCOUNT REFUSED", e)
    out["qwen"]["prefill_all_reduce"][1] = out["qwen"]["prefill_all_reduce"][0]
    try:
        cs.phase_dry_run(torch.device("cpu"), {"prefill_ms": 1e-3}, out, "no card")
    except cs.PhaseFailed as e:
        print("TOO FAST REFUSED", e)
'''


def test_phase9_runs_on_cpu_ranks_at_tiny_widths(tmp_path):
    """The whole phase, every gate, over two gloo ranks on the CPU (the
    flash route a counting plain version, the CUDA calls no-ops; its part
    (g): Hymba at 2 layers and an xLSTM period of 2, tiny, on their
    slices, their gathers as reckoned), then
    phase 9f over a (data 2, model 2) grid of four (its part (e): Llama4's
    period, the ranks drawing in turn, the routing pinned, the zeroed data
    block caught; its part (f): one donated step of that period on (e)'s
    draws, the one-process step's picks replayed, every leaf's gradient
    blocks held to one process's but the planted skipped sum's, which is
    caught), then phase 10 on their results: it passes, and refuses a
    miscounted all-reduce (phase 9's and 9f's by axis, (d)'s and (f)'s
    steps) and a prefill faster than its compute term."""
    driver = tmp_path / "rehearse_phase9.py"
    driver.write_text(_REHEARSAL)
    env = dict(__import__("os").environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, str(driver), str(ROOT)], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    for part in ("phase 9a:", "phase 9b Qwen2.5-3B:", "phase 9b sampling:",
                 "phase 9c Qwen3-MoE-235B-A22B:", "phase 9d:", "phase 9e:",
                 "phase 9 flash_sm90 at", "phase 9f a:", "phase 9fb Qwen2.5-3B:",
                 "phase 9fc Qwen3-MoE-235B-A22B:", "phase 9f d:",
                 "phase 9fe Llama4-Maverick-400B-A17B:", "phase 9f e:", "phase 9f flash_sm90 at",
                 "phase 10 grid:", "phase 10: card memory", "MISCOUNT REFUSED",
                 "GRID MISCOUNT REFUSED", "LLAMA4 STEP MISCOUNT REFUSED", "TOO FAST REFUSED",
                 "phase 9f f:", "phase 9g Hymba-1.5B:", "phase 9g xLSTM-1.3B:"):
        assert part in out
    step = out.split("phase 9f f:", 1)[1].splitlines()[0]
    assert "(2 picks replayed a rank)" in step and "fault skip_data_sum on ln_f/scale" in step
    parts = json.loads(out.split("phase 9f parts s ", 1)[1].splitlines()[0])
    assert list(parts)[-3:] == ["e", "f", "flash timings"]
    assert "Llama4's donated step" in out.split("phase 10 grid:", 1)[1]
    assert "LAUNCHES [4, 4] [2, 2] [2, 2] [0, 0]" in out and "DRYRUN memory" in out
    assert list(json.loads(out.split("phase 9 parts s ", 1)[1].splitlines()[0]))[-2:] == [
        "9g", "flash timings"]
    assert "GRID LAUNCHES [4, 4, 4, 4] [2, 2, 2, 2] [2, 2, 2, 2]" in out
    assert "fault zero_data_block rel L2" in out.split("phase 9fe", 1)[1]


def test_float32_flash_gate_sees_the_planted_attention_faults():
    """Phase 6f's gate on the CPU, on a reduced float32 Qwen2.5 at its head
    dim (128) and GQA 2:1: the flash prefill within F32_SERVE_REL of the
    plain prefill, each planted attention fault above it, and a prefill
    moved by 1e-3 of its magnitude refused."""
    import dataclasses
    import functools

    from repro_torch.models.api import build_model

    cfg = _reduced("qwen2_5_3b", attn_impl="flash", head_dim=128, num_heads=4, num_kv_heads=2)
    bundle = build_model(cfg, "cpu")
    plain = build_model(dataclasses.replace(cfg, attn_impl="xla"), "cpu")
    gen = torch.Generator().manual_seed(1)
    params = bundle.init(gen)
    prompts = torch.randint(0, cfg.vocab_size, (2, 48), generator=gen)
    batch = {"tokens": prompts}
    run = {"bundle": bundle, "params": params, "prompts": prompts, "batch": batch,
           "logits_f": bundle.prefill(params, dict(batch), bundle.init_cache(2, 49))[0],
           "logits_x": plain.prefill(params, dict(batch), plain.init_cache(2, 49))[0]}
    gate = functools.partial(chip_smoke._plain_gate, limit=chip_smoke.F32_SERVE_REL)
    text = chip_smoke._flash_gate("Qwen2.5 float32", cfg, run, gate)
    assert f"<= {chip_smoke.F32_SERVE_REL}" in text
    controls = json.loads(text.split("planted attention faults) ", 1)[1])
    assert set(controls) == {"tile_dropped", "wrong_kv_head", "not_causal"}
    assert min(controls.values()) > chip_smoke.F32_SERVE_REL
    run["logits_f"] = run["logits_f"] * (1 + 1e-3)
    with pytest.raises(chip_smoke.PhaseFailed, match="flash prefill"):
        chip_smoke._flash_gate("Qwen2.5 float32", cfg, run, gate)


# ---------------------------------------------------------------------- #
# phases 6v, 6k, 6j, 6l: the VLM batch, the MoE phase on Llama4, the line
# ---------------------------------------------------------------------- #
def _vlm_run(prompt=96):
    """A reduced float32 Qwen2-VL at the published head dim (128) and M-RoPE
    sections (16, 24, 24), 64 patch slots, on the VLM batch
    ``_serve_family`` builds: its flash and plain prefills. (At the reduced
    head dim of 32 the h and w sections are the slowest bands, and a 4 x 4
    grid's streams move the logits by 1.2e-3 only.)"""
    from repro_torch.models.api import build_model

    cfg = _reduced("qwen2_vl_2b", attn_impl="flash", head_dim=128,
                   mrope_sections=(16, 24, 24), vision_patches=64)
    bundle = build_model(cfg, "cpu")
    plain = build_model(cfg.__class__(**{**cfg.__dict__, "attn_impl": "xla"}), "cpu")
    gen = torch.Generator().manual_seed(0)
    params = bundle.init(gen)
    prompts = torch.randint(0, cfg.vocab_size, (2, prompt), generator=gen)
    batch = {"tokens": prompts, **chip_smoke._vlm_inputs(cfg, 2, prompt, gen, "cpu")}
    nxt = torch.randint(0, cfg.vocab_size, (2, 1), generator=gen).to(torch.int32)
    return cfg, {"bundle": bundle, "params": params, "prompts": prompts, "batch": batch,
                 "nxt": nxt,
                 "logits_f": bundle.prefill(params, dict(batch),
                                           bundle.init_cache(2, prompt + 1))[0],
                 "logits_x": plain.prefill(params, dict(batch),
                                           plain.init_cache(2, prompt + 1))[0]}


def test_vlm_batch_gates_and_sees_its_collapsed_mrope_streams():
    """6v's VLM batch on the reduced Qwen2-VL: patch embeddings over the
    first 64 slots, h and w the 8 x 8 grid's rows and columns there and t
    after; the flash prefill within the plain gate, every planted fault
    (the M-RoPE streams collapsed to t too) above it; teacher forcing on
    the batch (the longer prefill's positions extended) within its limit."""
    from repro_torch.models import blocks, layers

    cfg, run = _vlm_run()
    pos, patches = run["batch"]["positions"], run["batch"]["patch_embeds"]
    assert tuple(patches.shape) == (2, 64, cfg.d_model) and tuple(pos.shape) == (3, 2, 96)
    t = torch.arange(96, dtype=torch.int32)
    assert torch.equal(pos[0, 1], t)
    assert torch.equal(pos[1, 0, :64], t[:64] // 8) and torch.equal(pos[2, 0, :64], t[:64] % 8)
    assert torch.equal(pos[1:, :, 64:], t[64:].expand(2, 2, 32))
    text = chip_smoke._flash_gate("Qwen2-VL", cfg, run, chip_smoke._plain_gate)
    controls = json.loads(text.split("planted attention faults) ", 1)[1])
    assert set(controls) == {"tile_dropped", "wrong_kv_head", "not_causal",
                             "mrope_streams_collapsed"}
    assert min(controls.values()) > chip_smoke.SERVE_REL_L2
    assert blocks.apply_mrope is layers.apply_mrope
    assert blocks.flash_attention is chip_smoke.flash_attention
    rel, _, _ = chip_smoke._tf_one(torch.device("cpu"), run, limit=chip_smoke.TF_F32_REL)
    assert rel <= chip_smoke.TF_F32_REL


class _Event:
    def __init__(self, **kw):
        pass

    def record(self):
        pass

    def elapsed_time(self, other):
        return 0.25


@pytest.fixture
def cpu_card(monkeypatch):
    """The card's calls a serving phase makes, as no-ops or fixed readings
    on the CPU; the tensor-core flash route a plain version that counts its
    launches, the tensor-core route being what a bf16 config takes."""
    from repro_torch.kernels.flash_attention import kernel as fk, ref as fref

    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(chip_smoke, "program_bytes", lambda dev: 0)
    monkeypatch.setattr(chip_smoke, "check_held", lambda *a, **k: 0.0)
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, reps=5: (fn(), 0.1)[1])
    monkeypatch.setattr(chip_smoke, "_median_ms", lambda fn, runs=3, warm=True: (fn(), 1.0)[1])
    monkeypatch.setattr(chip_smoke, "_kernel_classes", lambda fn: (fn(), {"busy_share": 1.0})[1])
    monkeypatch.setattr(fk, "_check", lambda *a: True)

    def plain_sm90(q, k, v, *, causal=True, window=0):
        plain_sm90.launches += 1
        return fref.reference_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                        causal=causal, window=window).transpose(1, 2)

    plain_sm90.launches = 0
    monkeypatch.setitem(fk.ROUTES, "flash_forward_sm90", plain_sm90)
    monkeypatch.setattr(fk, "KERNELS", (fk.flash_attention_bhsd, fk.flash_forward, plain_sm90,
                                        fk.flash_forward_sm90_d256))
    for name, value in (("SERVE_BATCH", 2), ("SERVE_PROMPT", 64), ("SERVE_GEN", 3),
                        ("MOE_TF_LEN", 16)):
        monkeypatch.setattr(chip_smoke, name, value)


def test_moe_phase_serves_the_reduced_llama4_period(cpu_card, capsys):
    """6l's code (6d's, over the config) on the reduced Llama4 cut to one
    period, bf16, on the CPU: the parameter count holds with the dense
    layer and the shared expert in it, 2 flash launches a prefill and none
    a decode step, the routing-pinned gates hold (one MoE layer pinned),
    and the shared expert is timed as a piece of its own."""
    cfg = _reduced("llama4_maverick_400b_a17b", param_dtype="bfloat16", attn_impl="flash",
                   num_layers=2)
    assert cfg.shared_expert and cfg.moe_every == 2 and cfg.experts_per_token == 1
    out = chip_smoke._serve_moe(torch.device("cpu"), "Llama4 reduced", cfg, 48)
    assert out["launches"] == chip_smoke.on_entry("flash_attention_forward_sm90", 2)
    assert out["flash"][0]["rel_l2"] <= chip_smoke.FLASH_REL_L2[torch.bfloat16]
    line = capsys.readouterr().out
    assert "Llama4 reduced (published widths, 2 of 48 layers" in line
    assert "4 experts top-1 and a shared expert, MoE every 2 layers" in line
    pieces = json.loads(line.split("prefill pieces device ms ", 1)[1].split(" decode", 1)[0])
    assert set(pieces) == {"route", "experts", "combine", "flash", "shared_expert"}
    assert "phase serve moe Llama4 reduced: ok" in line
    from repro_torch.models import moe
    from repro_torch.models.layers import mlp_apply

    assert moe.mlp_apply is mlp_apply and moe._top_k.__name__ == "_top_k"


def _flash_entry(ms):
    return {"shape": f"shape at {ms}", "ms": ms, "max_abs_err": 1e-3, "rel_l2": 2e-3,
            "plain_ms": 10.0, "bound": (0.278, "operations"), "library_ms": 0.3,
            "bound_terms": {"bytes_ms": 0.01, "products_ms": 0.278, "exp_ms": 0.05},
            "sdpa_backend": "FLASH_ATTENTION", "route": {}, "direct": {
                "ms": 9.0, "max_abs_err": 0.0, "rel_l2": 0.0}}


def _kernels_line(examples_launches: dict) -> dict:
    """``kernels_line`` on synthetic phase results: every agg and quant
    entry timed alike, flash's prefill launches by serving phase, and the
    example programs' launches ``examples_launches``."""
    agg = ["exact_fold_into_tree", "exact_fold_into", "exact_divide", "exact_fold",
           "weighted_aggregate", "quantize_blocks", "dequantize_blocks"]
    sm90 = "flash_attention_forward_sm90"
    flash = [sm90, "flash_attention_forward_sm90_d256", "flash_attention_forward"]
    zero = {name: 0 for name in agg + flash}
    plain = {"ms": 1.0, "plain_ms": 2.0, "bound": (0.5, "bytes"), "library_ms": 1.5,
             "max_abs_err": 0.0}
    run = {"launches": zero, "timings": {name: plain for name in agg}}
    fam = {phase: {"launches": dict(zero, **{sm90: n}), "flash": [_flash_entry(0.1 * i)]}
           for i, (phase, n) in enumerate((("6h", 32), ("6x", 0), ("6s", 12), ("6g", 0),
                                            ("6f", 0), ("6v", 28), ("6k", 30), ("6j", 40),
                                            ("6l", 2)))}
    serve = {"launches": dict(zero, **{sm90: 36}), "flash": [_flash_entry(0.347)] * 3}
    moe = {"launches": dict(zero, **{sm90: 8}), "flash": [_flash_entry(1.295)]}
    ranks = {"qwen": {"launches_per_rank": [4, 4]}, "moe": {"launches_per_rank": [2, 2]},
             "hymba": {"launches_per_rank": [8, 8]}, "xlstm": {"launches_per_rank": [0, 0]},
             "flash": {"qwen": _flash_entry(0.18), "moe": _flash_entry(0.66),
                       "hymba": _flash_entry(0.41)}}
    grid = dict(ranks, llama4={"launches_per_rank": [2, 2]},
                flash=dict(ranks["flash"], llama4=_flash_entry(0.23)))
    return json.loads(chip_smoke.kernels_line(run, run, run, run, serve, moe, run, run, run,
                                              fam, ranks, grid,
                                              {"launches": examples_launches}))


def test_kernels_line_has_the_four_shapes_and_their_launches():
    """The ``kernels`` line's ``flash_sm90.cu`` row carries an
    ``at_<shape>`` entry for each of 6v, 6k, 6j and 6l (ms, bound, plain,
    SDPA, rel L2) and their prefill launches by path, and 9f (e)'s Llama4
    rank shape with its launches in 9f's."""
    line = _kernels_line({})
    row = next(r for r in line["kernels"] if r["name"] == "flash_attention_forward_sm90")
    for phase, n in (("6v", 28), ("6k", 30), ("6j", 40), ("6l", 2)):
        assert row["launches_by_path"][phase] == n
    for i, key in ((5, "qwen2_vl"), (6, "deepseek"), (7, "glm4"), (8, "llama4")):
        entry = row[f"at_{key}_shape"]
        assert entry["ms"] == 0.1 * i and entry["rel_l2"] == 2e-3
        assert {"bound_ms", "bound_by", "plain_ms", "library_ms"} <= set(entry)
    assert row["at_moe_shape"]["ms"] == 1.295
    assert row["at_grid_llama4_rank_shape"]["ms"] == 0.23
    assert row["launches_by_path"]["9f"] == 2 * (4 + 2 + 2)  # (b), (c) and (e) a rank
    assert row["launches_by_path"]["9"] == 2 * (4 + 2 + 8)  # (b), (c) and 9g's Hymba a rank
    assert row["at_tp_hymba_rank_shape"]["ms"] == 0.41


def test_kernels_line_counts_the_examples_launches():
    """Phase 3e's launches land under ``3e`` in every row's launches by
    path and in its total; a kernel the examples never launch reads 0."""
    rows = {r["name"]: r for r in _kernels_line(
        {"exact_fold_into_tree": 41, "exact_divide": 43})["kernels"]}
    for name, n in (("exact_fold_into_tree", 41), ("exact_divide", 43), ("exact_fold_into", 0),
                    ("quantize_blocks", 0), ("flash_attention_forward_sm90", 0)):
        assert rows[name]["launches_by_path"]["3e"] == n
    assert rows["exact_fold_into_tree"]["launches"] == 41
    assert rows["flash_attention_forward_sm90"]["launches"] == 36 + 8 + 144 + 12 + 16 + 16


def test_main_ends_with_the_card_and_result_lines(monkeypatch, capsys):
    """``main`` with every phase stubbed (the ``kernels`` line's synthetic
    results): its last line is the result ``{"ok": true, "device":
    {"platform": "gpu", "kind": ..., "count": 1}}``, the line before it the
    card's name and power limit, and before that the ``kernels`` line."""
    agg = ["exact_fold_into_tree", "exact_fold_into", "exact_divide", "exact_fold",
           "weighted_aggregate", "quantize_blocks", "dequantize_blocks"]
    sm90 = "flash_attention_forward_sm90"
    zero = {name: 0 for name in agg + [sm90, "flash_attention_forward_sm90_d256",
                                       "flash_attention_forward"]}
    plain = {"ms": 1.0, "plain_ms": 2.0, "bound": (0.5, "bytes"), "library_ms": 1.5,
             "max_abs_err": 0.0}
    run = {"launches": zero, "timings": {name: plain for name in agg}}
    fam = {phase: {"launches": zero, "flash": [_flash_entry(0.2)]} for phase in
           ("6h", "6x", "6s", "6g", "6f", "6v", "6k", "6j", "6l")}
    serve = {"launches": zero, "flash": [_flash_entry(0.347)] * 3}
    ranks = {"qwen": {"launches_per_rank": [4, 4]}, "moe": {"launches_per_rank": [2, 2]},
             "hymba": {"launches_per_rank": [8, 8]}, "xlstm": {"launches_per_rank": [0, 0]},
             "flash": {"qwen": _flash_entry(0.18), "moe": _flash_entry(0.66),
                       "hymba": _flash_entry(0.41)}}
    grid = dict(ranks, llama4={"launches_per_rank": [2, 2]},
                flash=dict(ranks["flash"], llama4=_flash_entry(0.23)))
    smi = "NVIDIA H100 80GB HBM3, 700.00 W"
    stubs = {"phase_environment": lambda: smi, "phase_examples": lambda dev: {"launches": {}},
             "phase_serve": lambda dev: serve, "phase_serve_moe": lambda dev: serve,
             "phase_train": lambda dev, smi: run, "phase_tensor_parallel": lambda dev, smi: ranks,
             "phase_grid": lambda dev, smi, tpar: grid,
             "phase_dry_run": lambda *a: {}, "free_device": lambda: None}
    for name in ("phase_parity", "phase_small_jobs", "phase_small_topologies",
                 "phase_small_policies", "phase_flash_parity"):
        stubs[name] = lambda *a: None
    for name in ("phase_full_width", "phase_full_width_topologies", "phase_full_width_policies",
                 "phase_process_plane", "phase_fault_plane", "phase_codec_parity",
                 "phase_codec_job"):
        stubs[name] = lambda *a: run
    for phase, name in SERVING_PHASES + [("6l", "phase_serve_llama4")]:
        stubs[name] = lambda dev, phase=phase: fam[phase]
    for name, fn in stubs.items():
        monkeypatch.setattr(chip_smoke, name, fn)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert chip_smoke.main() == 0
    lines = capsys.readouterr().out.splitlines()
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert lines[-2] == f"card: {smi}"
    assert {r["name"] for r in json.loads(lines[-3])["kernels"]} == set(zero)
