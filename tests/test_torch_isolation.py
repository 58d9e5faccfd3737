"""The port stands alone: no jax, no JAX package, and no silent CPU runs.

* No module under ``src/repro_torch/``, nor ``chip_smoke.py``,
  ``tools/flash_sm90_variants.py`` or ``tools/agg_fold_variants.py``, imports
  ``jax``, ``repro`` or ``ml_dtypes`` (an AST walk, and a subprocess import
  with them blocked in ``sys.modules``); the card's machine has none.
* ``run_job``, ``build_train_step``, the train launcher and the example
  programs (``repro_torch.examples``) without a device raise where there
  is no CUDA device.
* The training slice's modules (mesh lowering, DP, the fed step, the data
  pipeline, the train launchers), the fault plane's (channels, runtime,
  launcher, hub and conformance), client and sample selection, the MoE
  block's (``shard_ctx``, ``moe``, ``blocks``), tensor parallelism's
  (the sharding rules, the meshes, the model group, the rank programs of
  the tests), the dry run's and its analysis's, and the local optimizers'
  (``optim/``) are among the files walked; ``python -m
  repro_torch.launch.dryrun`` runs with them blocked.
* ``chip_smoke.py`` exits non-zero, printing no result, without a card and
  outside a checkout.
"""
import ast
import importlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import examples
from repro_torch.core import runtime
from repro_torch.core.expansion import JobSpec
from repro_torch.core.tag import DatasetSpec
from repro_torch.core.topologies import classical_fl

ROOT = Path(__file__).resolve().parents[1]
# what runs on the card's machine: the package, chip_smoke.py and the variant tools
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tools" / "flash_sm90_variants.py",
    ROOT / "tools" / "agg_fold_variants.py"]
_BANNED = ("jax", "jaxlib", "repro", "ml_dtypes")


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
        "for name in ('jax', 'jaxlib', 'repro', 'ml_dtypes'):\n"
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



@pytest.mark.parametrize("name", examples.NAMES)
def test_examples_default_to_cuda_and_raise_without_it(name, monkeypatch):
    """Each example's ``main`` and its command line (``python -m
    repro_torch.examples.<name>``) run on the card unless given ``cpu``:
    without a card they raise before any job starts."""
    module = importlib.import_module(f"repro_torch.examples.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        examples.cli(module.main, [])

TRAINING_MODULES = ["core/mesh_lowering.py", "fl/privacy.py", "fl/fedstep.py",
                    "data/datasets.py", "data/pipeline.py", "launch/mesh.py",
                    "launch/steps.py", "launch/train.py", "models/transformer.py",
                    "models/api.py", "convert.py"]


# the fault plane's and the selection slice's modules
FAULT_PLANE_MODULES = ["core/channels.py", "core/runtime.py", "launch/spawn.py",
                       "transport/multiproc.py", "transport/conformance.py",
                       "fl/selection.py", "fl/sampling.py", "data/__init__.py",
                       "fl/__init__.py"]

# the MoE block's modules
MOE_MODULES = ["models/shard_ctx.py", "models/moe.py", "models/blocks.py"]

# the recurrent and encoder-decoder families' modules
FAMILY_MODULES = ["models/ssd.py", "models/encdec.py", "launch/serve.py"]

# tensor parallelism's modules
TP_MODULES = ["launch/sharding.py", "launch/tensor_parallel.py", "launch/mesh.py",
              "models/attention.py", "models/layers.py"]

# the dry run, its analysis and the local optimizers
DRYRUN_MODULES = ["launch/dryrun.py", "launch/analysis.py", "optim/__init__.py",
                  "optim/optimizers.py", "optim/schedules.py", "fl/compression.py"]


@pytest.mark.parametrize("module", TRAINING_MODULES + FAULT_PLANE_MODULES + MOE_MODULES
                         + FAMILY_MODULES + TP_MODULES + DRYRUN_MODULES)
def test_training_modules_are_held_to_the_import_rule(module):
    path = ROOT / "src" / "repro_torch" / module
    assert path in PORT_FILES
    assert not [m for m in _imported_modules(path) if _banned(m)]


def test_dryrun_runs_with_jax_and_the_reference_blocked(tmp_path):
    """The dry run's command line, in a process where importing jax, the
    JAX package or ml_dtypes fails: one record, counted on the CPU."""
    out = tmp_path / "rec.json"
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'repro', 'ml_dtypes'):\n"
            "    sys.modules[name] = None\n"
            "from repro_torch.launch import dryrun\n"
            "sys.exit(dryrun.main(['--arch', 'gemma_7b', '--shape', 'long_500k', '--out', "
            "sys.argv[1]]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code, str(out)], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "roofline: dominant=" in proc.stdout and out.exists()


def test_tp_rank_programs_import_the_port_alone():
    """The tests' rank functions run in spawned ranks: their module imports
    neither jax nor the JAX package (a rank would import JAX for nothing)."""
    bad = [m for m in _imported_modules(ROOT / "tests" / "_torch_tp_programs.py") if _banned(m)]
    assert not bad


def test_tp_launchers_default_to_cuda_and_raise_without_it(monkeypatch):
    """``--ranks`` runs its ranks on the cards unless ``--device cpu`` is
    asked for; without a card it raises before it spawns anything."""
    from repro_torch.launch import serve, train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced", "--ranks", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--reduced", "--ranks", "2", "--steps", "1"])
    assert serve._rank_devices("cpu", 2) == ["cpu", "cpu"]


def test_train_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.steps import build_train_step

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen2_5_3b", reduced=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_train_step(cfg, make_smoke_mesh())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--reduced", "--steps", "1"])
    bundle, setup = build_train_step(cfg, make_smoke_mesh(), device="cpu")
    assert bundle.device.type == "cpu" and setup.client_axes == ("data",)


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
