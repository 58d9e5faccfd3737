"""The port stands alone: no jax, no JAX package, and no silent CPU runs.

* No module under ``src/repro_torch/``, nor ``chip_smoke.py``, imports
  ``jax`` or ``repro`` (an AST walk, and a subprocess import with both
  blocked in ``sys.modules``).
* ``run_job`` without ``device`` raises where there is no CUDA device.
* ``chip_smoke.py`` exits non-zero, printing no result, without a card and
  outside a checkout.
"""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import runtime
from repro_torch.core.expansion import JobSpec
from repro_torch.core.tag import DatasetSpec
from repro_torch.core.topologies import classical_fl

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
_BANNED = ("jax", "jaxlib", "repro")


def _banned(module: str) -> bool:
    return module.split(".")[0] in _BANNED


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imported_modules(path) if _banned(m)]
    assert not bad, f"{path} imports {bad}"


def test_port_imports_with_jax_and_reference_blocked():
    code = (
        "import importlib, importlib.util, pkgutil, sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', sys.argv[1])\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print(len(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 15


def test_run_job_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    job = JobSpec(tag=classical_fl(), datasets=(DatasetSpec(name="d0"),),
                  hyperparams={"rounds": 1, "init_weights": {"w": np.ones(2, np.float32)}})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runtime.run_job(job)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runtime.run_job(job, device="cuda")
    res = runtime.run_job(job, device="cpu", timeout=30)
    assert not res.errors and res.global_weights()["w"].device.type == "cpu"


def _smoke(cwd: Path, env: dict) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card_or_a_checkout(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    alone = _smoke(tmp_path, env)
    assert alone.returncode != 0 and '"ok"' not in alone.stdout
    if not torch.cuda.is_available():
        here = _smoke(ROOT, env)
        assert here.returncode != 0 and '"ok"' not in here.stdout
        assert "no CUDA device" in here.stderr
