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
