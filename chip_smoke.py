#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on a CUDA card and check it.

Run from the root of a checkout, with one CUDA card (Hopper, sm_90a) and
the CUDA toolkit:

    python3 chip_smoke.py

It builds the aggregation kernels from ``src/repro_torch/kernels/agg/csrc``
(nvcc, at first use), then runs five phases, each printing one line:

1. environment: torch/CUDA versions, the card, the kernel build;
2. kernel parity: every kernel entry against its plain PyTorch version on
   the same CUDA tensors (bytes equal for the exact entries; the fused
   weighted sum within 1e-6 of the summed magnitudes of its terms), and
   whether ``tensor / python_float`` on CUDA is an IEEE divide;
3. the slice, small: ``classical_fl`` with the seeded SGD trainer and
   ``hierarchical_fl`` with an "add one" trainer, on the card and on the
   CPU;
4. the slice at full width: a ``classical_fl`` job whose weight tree is the
   parameter tree of Qwen2.5-3B (published widths, depth cut from 36
   layers to 4), 8 trainers, 3 rounds, with the job's global weights held
   byte-equal to the plain fold of the same updates after every round;
5. a ``kernels`` JSON line: launches on the main path (phase 4), time,
   plain version's time, bound and a library call's time per kernel, at
   the main path's shapes.

Then the card's name and power limit (``nvidia-smi``), and as the last line
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero without
that line; so does a run without a CUDA device or outside a checkout.
"""
from __future__ import annotations

import gc
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.convert import tree_to_numpy  # noqa: E402
from repro_torch.core.expansion import JobSpec  # noqa: E402
from repro_torch.core.roles import GlobalAggregator, Trainer  # noqa: E402
from repro_torch.core.runtime import run_job  # noqa: E402
from repro_torch.core.tag import DatasetSpec  # noqa: E402
from repro_torch.core.topologies import classical_fl, hierarchical_fl  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.kernels.agg import kernel, ops, ref  # noqa: E402
from repro_torch.transport.conformance import SeededSGDTrainer  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet), at the full 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# the CPU tests' tolerance for the seeded SGD job (tests/test_torch_jobs.py):
# float32 products rounded by another BLAS
SGD_RTOL, SGD_ATOL = 1e-5, 1e-6
WEIGHTED_RTOL = 1e-6

# Qwen2.5-3B (src/repro/configs/qwen2_5_3b.py), depth cut 36 -> 4 layers
QWEN = dict(d_model=2048, heads=16, kv_heads=2, head_dim=128, d_ff=11008,
            vocab=151936, layers=4)
QWEN_PARAMS = 619_474_944
N_TRAINERS, ROUNDS = 8, 3


class PhaseFailed(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)
    )


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean device time of ``fn`` over ``reps`` runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------- #
# phase 1
# ---------------------------------------------------------------------- #
def phase_environment() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    kernel.build()
    build_s = time.perf_counter() - t0
    log = kernel.library_path().with_name(kernel.library_path().name + ".log")
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln or "spill" in ln] if log.exists() else []
    print(f"phase environment: ok python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} card {torch.cuda.get_device_name(0)!r} "
          f"build_s {build_s:.3f} ptxas {ptxas}", flush=True)
    return smi


# ---------------------------------------------------------------------- #
# phase 2
# ---------------------------------------------------------------------- #
def phase_parity(dev: torch.device) -> None:
    gen = torch.Generator(device=dev).manual_seed(2024)
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for C in (1, 2, 3, 7, 12):
            for N in (1, 7, 130, 16_640, (1 << 20) + 3):
                d = torch.randn(C, N, generator=gen, device=dev).to(dtype)
                d[:, 0] = -0.0  # an all -0.0 column keeps its sign
                w = torch.rand(C, generator=gen, device=dev) * 30 + 1
                den = torch.tensor([float(w.double().sum())], device=dev)
                out = kernel.exact_fold(d, w, den)
                check(same_bits(out, ref.exact_fold(d, w, den)),
                      f"exact_fold C={C} N={N} {dtype}")
                check(bool(torch.signbit(out[0])), f"exact_fold lost -0.0 C={C} N={N}")
                fast = kernel.weighted_aggregate(d, w, den)
                tol = WEIGHTED_RTOL * (w[:, None] * d.float()).abs().sum(0) / den
                check(bool(((fast - ref.weighted_aggregate(d, w, den)).abs() <= tol).all()),
                      f"weighted_aggregate C={C} N={N} {dtype}")
                cases += 2
    # the card's exact fold gives the CPU's (and so the JAX package's) bits
    d = torch.randn(7, 16_640, generator=gen, device=dev)
    w = torch.rand(7, generator=gen, device=dev) * 30 + 1
    den = torch.tensor([float(w.double().sum())], device=dev)
    check(same_bits(kernel.exact_fold(d, w, den).cpu(),
                    ref.exact_fold(d.cpu(), w.cpu(), den.cpu())), "exact_fold card vs CPU")
    # streaming and divide entries, aligned and misaligned (scalar loop)
    for N in (1, 7, 130, 16_640, (1 << 20) + 3):
        for offset in (0, 1):
            buf = torch.randn(3 * N + offset, generator=gen, device=dev)
            a, b = buf[offset:offset + N], buf[offset + N:offset + 2 * N]
            a[0] = -0.0
            acc = kernel.exact_fold_into(None, a, 3.0)
            acc = kernel.exact_fold_into(acc, b, 0.3)
            plain = ref.exact_fold_into(ref.exact_fold_into(None, a, 3.0), b, 0.3)
            check(same_bits(acc, plain), f"exact_fold_into N={N} offset={offset}")
            q = kernel.exact_divide(acc, 7.7)
            check(same_bits(q, ref.exact_divide(acc, 7.7)), f"exact_divide N={N}")
            inplace = acc.clone()
            kernel.exact_divide(inplace, 7.7, out=inplace)
            check(same_bits(inplace, q), f"exact_divide in place N={N}")
            cases += 3
        stacked = torch.randn(4 * N + 1, generator=gen, device=dev)[1:].view(4, N)
        w4 = torch.rand(4, generator=gen, device=dev) + 1
        den4 = torch.tensor([float(w4.double().sum())], device=dev)
        check(same_bits(kernel.exact_fold(stacked, w4, den4), ref.exact_fold(stacked, w4, den4)),
              f"exact_fold misaligned N={N}")
        cases += 1
    torch.cuda.synchronize()
    # the division trap: tensor / python_float against an IEEE divide
    x = torch.randn(1 << 20, generator=gen, device=dev) * 1e3
    total = 7.7
    ieee = torch.from_numpy(x.cpu().numpy() / np.float32(total))
    check(same_bits(ref.exact_divide(x, total).cpu(), ieee), "0-d tensor divide is not IEEE")
    scalar = (x / total).cpu()
    differ = int((scalar.view(torch.int32) != ieee.view(torch.int32)).sum())
    print(f"phase parity: ok {cases} comparisons; cuda tensor/python_float is IEEE divide: "
          f"{differ == 0} ({differ} of {x.numel()} values differ at total={total})", flush=True)


# ---------------------------------------------------------------------- #
# phase 3
# ---------------------------------------------------------------------- #
class AddOneTrainer(Trainer):
    def train(self):
        if self.weights is not None:
            self.weights = {k: v + 1.0 for k, v in self.weights.items()}


def _small_job(tag, init, n=4, rounds=3):
    return JobSpec(
        tag=tag,
        datasets=tuple(DatasetSpec(name=f"d{i}") for i in range(n)),
        hyperparams={"rounds": rounds, "init_weights": init},
    )


def _run(job, device, trainer):
    res = run_job(job, device=device, timeout=120, program_overrides={"trainer": trainer})
    check(not res.errors, f"job errors on {device}: {res.errors}")
    return res


def phase_small_jobs(dev: torch.device) -> None:
    rng = np.random.default_rng(17)
    sgd_w0 = {"w": (0.01 * rng.normal(size=(32, 10))).astype(np.float32),
              "b": np.zeros((10,), np.float32)}
    kernel.reset_launches()
    card = _run(_small_job(classical_fl(), sgd_w0), dev, SeededSGDTrainer)
    folds = kernel.exact_fold_into.launches
    check(folds > 0 and kernel.exact_divide.launches > 0, "classical job never ran the fold kernel")
    host = _run(_small_job(classical_fl(), sgd_w0), "cpu", SeededSGDTrainer)
    a, b = tree_to_numpy(card.global_weights()), tree_to_numpy(host.global_weights())
    err = max(float(np.abs(a[k] - b[k]).max()) for k in a)
    check(all(np.allclose(a[k], b[k], rtol=SGD_RTOL, atol=SGD_ATOL) for k in a),
          f"SGD job card vs CPU differs by {err}")
    check(card.channel_bytes == host.channel_bytes, "SGD job channel_bytes differ")

    groups = {"west": ("d0", "d1"), "east": ("d2", "d3")}
    w0 = {"w": np.full((8,), 2.0, np.float32), "b": np.zeros((2, 2), np.float32)}
    tag = hierarchical_fl(groups=("west", "east"), dataset_groups=groups)
    hcard = _run(_small_job(tag, w0), dev, AddOneTrainer)
    hhost = _run(_small_job(tag, w0), "cpu", AddOneTrainer)
    ha, hb = tree_to_numpy(hcard.global_weights()), tree_to_numpy(hhost.global_weights())
    check(all(ha[k].tobytes() == hb[k].tobytes() for k in ha), "hierarchical weights differ")
    check(hcard.channel_bytes == hhost.channel_bytes, "hierarchical channel_bytes differ")
    print(f"phase small jobs: ok classical SGD card-vs-cpu max_abs_err {err:.3g} "
          f"(fold launches {folds}); hierarchical add-one byte-equal; "
          f"channel_bytes {hcard.channel_bytes}", flush=True)


# ---------------------------------------------------------------------- #
# phase 4
# ---------------------------------------------------------------------- #
def qwen_shapes():
    q = QWEN
    dq, dkv = q["heads"] * q["head_dim"], q["kv_heads"] * q["head_dim"]
    D, F = q["d_model"], q["d_ff"]
    layer = {
        "attn": {"q_w": (D, dq), "q_b": (dq,), "k_w": (D, dkv), "k_b": (dkv,),
                 "v_w": (D, dkv), "v_b": (dkv,), "o_w": (dq, D)},
        "mlp": {"gate": (D, F), "up": (D, F), "down": (F, D)},
        "norm_attn": (D,), "norm_mlp": (D,),
    }
    return {"embed": (q["vocab"], D), "layers": [layer] * q["layers"], "final_norm": (D,)}


def _is_shape(x):
    return isinstance(x, tuple) and all(isinstance(i, int) for i in x)


def _map_shapes(fn, tree):
    if _is_shape(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_shapes(fn, v) for k, v in tree.items()}
    return [_map_shapes(fn, v) for v in tree]


def _seed(name: str, rnd: int) -> int:
    return int(hashlib.sha256(f"{name}:{rnd}".encode()).hexdigest()[:15], 16)


def noisy(weights, dataset: str, rnd: int):
    """The trainer's update: weights + 0.01 * randn, from a generator on the
    card seeded by (dataset, round); drawn leaf by leaf in tree order."""
    gen = torch.Generator(device=tree_leaves(weights)[0].device).manual_seed(_seed(dataset, rnd))
    return tree_map(
        lambda x: x + 0.01 * torch.randn(x.shape, generator=gen, device=x.device), weights)


def samples_of(dataset: str) -> int:
    return 100 + 37 * int(dataset[1:])


class NoiseTrainer(Trainer):
    def __init__(self, ctx):
        super().__init__(ctx)
        self._step = 0

    def train(self):
        if self.weights is None:
            return
        self._step += 1
        self.weights = noisy(self.weights, self.ctx.worker.dataset, self._step)
        self.num_samples = samples_of(self.ctx.worker.dataset)


class RecordingAggregator(GlobalAggregator):
    """Keeps every round's global weights and wall time."""

    def __init__(self, ctx):
        super().__init__(ctx)
        self.history = [self.weights]
        self.round_s = []
        self._t0 = 0.0

    def distribute(self):
        torch.cuda.synchronize()
        self._t0 = time.perf_counter()
        super().distribute()

    def aggregate(self):
        super().aggregate()
        if not self._work_done:
            torch.cuda.synchronize()
            self.round_s.append(time.perf_counter() - self._t0)
            self.history.append(self.weights)


def phase_full_width(dev: torch.device) -> dict:
    shapes = qwen_shapes()
    n_params = sum(int(np.prod(s)) for s in _flat_shapes(shapes))
    check(n_params == QWEN_PARAMS, f"tree has {n_params} parameters, not {QWEN_PARAMS}")
    gen = torch.Generator(device=dev).manual_seed(0)
    init = _map_shapes(lambda s: 0.02 * torch.randn(s, generator=gen, device=dev), shapes)
    job = JobSpec(
        tag=classical_fl(),
        datasets=tuple(DatasetSpec(name=f"d{i}") for i in range(N_TRAINERS)),
        hyperparams={"rounds": ROUNDS, "init_weights": init},
    )
    del init
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernel.reset_launches()
    t0 = time.perf_counter()
    res = run_job(job, device=dev, timeout=900, program_overrides={
        "trainer": NoiseTrainer, "global-aggregator": RecordingAggregator})
    torch.cuda.synchronize()
    job_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernel.KERNELS}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    check(not res.errors, f"full-width job errors: {res.errors}")
    for name in ("exact_fold_into", "exact_divide"):
        check(launches[name] > 0, f"main path never launched {name}")
    root = next(p for p in res.programs.values() if isinstance(p, RecordingAggregator))
    history, round_s = root.history, root.round_s
    check(len(history) == ROUNDS + 1, f"{len(history) - 1} rounds recorded, not {ROUNDS}")
    datasets = sorted((w.worker_id, w.dataset) for w in res.workers if w.role == "trainer")
    check(len(datasets) == N_TRAINERS, "trainer count")
    channel_bytes = dict(res.channel_bytes)
    # role programs hold reference cycles (tasklets bind their methods):
    # collect them now, or the trainers' 20 GB of weights outlive the job
    del res, root, job
    gc.collect()
    torch.cuda.empty_cache()

    # every round: regenerate the updates, fold them with the plain version
    # in sorted-source order, and hold the job's weights to it byte for byte
    max_err = 0.0
    for rnd in range(1, ROUNDS + 1):
        acc, total = None, 0.0
        for _, dataset in datasets:
            update = noisy(history[rnd - 1], dataset, rnd)
            n = float(samples_of(dataset))
            total += n
            acc = tree_map(lambda x: ref.exact_fold_into(None, x, n), update) if acc is None \
                else tree_map(lambda a, x: ref.exact_fold_into(a, x, n), acc, update)
            del update
        mean = tree_map(lambda x: ref.exact_divide(x, total), acc)
        got = tree_leaves(history[rnd])
        want = tree_leaves(mean)
        check(all(torch.isfinite(g).all() for g in got), f"round {rnd}: non-finite weights")
        for g, w in zip(got, want):
            check(same_bits(g, w), f"round {rnd}: global weights differ from the plain fold")
            max_err = max(max_err, float((g - w).abs().max()))
        del acc, mean, got, want

    # the device work of one round, replayed alone with CUDA events: the
    # trainers' updates, then the fold of the 8 updates and its divide
    base = history[ROUNDS - 1]

    def train_round():
        for _, ds in datasets:
            noisy(base, ds, ROUNDS)

    train_ms = cuda_ms(train_round, reps=2)
    # kernel timing at the main path's shapes: the last round's updates
    updates = [(noisy(base, ds, ROUNDS), float(samples_of(ds))) for _, ds in datasets]
    del history
    torch.cuda.empty_cache()
    total = sum(n for _, n in updates)

    def fold_round():
        acc = None
        for u, n in updates:
            acc = ops.fold_into(acc, u, n)
        return ops.divide(acc, total)

    round_fold_ms = cuda_ms(fold_round, reps=2)
    w = updates[0][1]
    acc = ops.fold_into(None, updates[1][0], updates[1][1])
    u_leaves, acc_leaves = tree_leaves(updates[0][0]), tree_leaves(acc)
    n = sum(x.numel() for x in u_leaves)
    den0 = torch.tensor(total, dtype=torch.float32, device=dev)
    timings = {
        "exact_fold_into": dict(
            ms=cuda_ms(lambda: [kernel.exact_fold_into(a, x, w) for a, x in zip(acc_leaves, u_leaves)]),
            plain_ms=cuda_ms(lambda: [ref.exact_fold_into(a, x, w) for a, x in zip(acc_leaves, u_leaves)]),
            library_ms=cuda_ms(lambda: [torch.add(a, x, alpha=w, out=a) for a, x in zip(acc_leaves, u_leaves)]),
            bound=bound(12 * n, 2 * n), max_abs_err=max_err,
        ),
        "exact_divide": dict(
            ms=cuda_ms(lambda: [kernel.exact_divide(a, total) for a in acc_leaves]),
            plain_ms=cuda_ms(lambda: [ref.exact_divide(a, total) for a in acc_leaves]),
            library_ms=cuda_ms(lambda: [torch.div(a, den0) for a in acc_leaves]),
            bound=bound(8 * n, n), max_abs_err=max_err,
        ),
    }
    del acc, acc_leaves, u_leaves
    # the stacked entries (not on the classical path) at the same leaves, C = 8;
    # each leaf's rows are dropped as soon as they are stacked
    wts = torch.tensor([nn for _, nn in updates], dtype=torch.float32, device=dev)
    C = len(updates)
    rows_of = [tree_leaves(u) for u, _ in updates]
    del updates, base, train_round
    stacked = []
    for j in range(len(rows_of[0])):
        stacked.append(torch.stack([rows[j] for rows in rows_of]).reshape(C, -1))
        for rows in rows_of:
            rows[j] = None
    del rows_of
    torch.cuda.empty_cache()
    den = torch.tensor([total], dtype=torch.float32, device=dev)
    w_over_den = wts / den
    errs = {"exact_fold": 0.0, "weighted_aggregate": 0.0}
    for d in stacked:
        exact = kernel.exact_fold(d, wts, den)
        plain = ref.exact_fold(d, wts, den)
        check(same_bits(exact, plain), "exact_fold at full width")
        fast = kernel.weighted_aggregate(d, wts, den)
        tol = WEIGHTED_RTOL * (wts[:, None] * d).abs().sum(0) / den
        diff = (fast - ref.weighted_aggregate(d, wts, den)).abs()
        check(bool((diff <= tol).all()), "weighted_aggregate at full width")
        errs["weighted_aggregate"] = max(errs["weighted_aggregate"], float(diff.max()))
        del exact, plain, fast, tol, diff
    for name, fn in (("exact_fold", kernel.exact_fold), ("weighted_aggregate", kernel.weighted_aggregate)):
        plain_fn = getattr(ref, name)
        timings[name] = dict(
            ms=cuda_ms(lambda: [fn(d, wts, den) for d in stacked]),
            plain_ms=cuda_ms(lambda: [plain_fn(d, wts, den) for d in stacked], reps=2),
            library_ms=cuda_ms(lambda: [torch.mv(d.t(), w_over_den) for d in stacked]),
            bound=bound((4 * C + 4) * n, 2 * C * n), max_abs_err=errs[name],
        )
    del stacked
    torch.cuda.empty_cache()
    fi = timings["exact_fold_into"]
    print(f"phase full width: ok Qwen2.5-3B tree ({n_params} f32 params, layers 36->4), "
          f"{N_TRAINERS} trainers, {ROUNDS} rounds byte-equal to the plain fold; "
          f"job_s {job_s:.3f} round_wall_s {[round(s, 4) for s in round_s]} "
          f"train_device_ms_per_round {train_ms:.3f} "
          f"fold_device_ms_per_round {round_fold_ms:.3f} "
          f"device_busy_share_est {(train_ms + round_fold_ms) / 1e3 / np.median(round_s):.3f} "
          f"peak_device_gb {peak_gb:.2f} "
          f"stream ms {fi['ms']:.3f} bound_ms {fi['bound'][0]:.3f} "
          f"library_ms {fi['library_ms']:.3f} channel_bytes {channel_bytes}", flush=True)
    return {"launches": launches, "timings": timings}


def _flat_shapes(tree):
    if _is_shape(tree):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [s for v in items for s in _flat_shapes(v)]


# ---------------------------------------------------------------------- #
def kernels_line(full: dict) -> str:
    src = "src/repro_torch/kernels/agg/csrc/agg.cu"
    fold = "src/repro/kernels/agg/kernel.py:96"
    rows = [
        ("exact_fold_into", fold, True, "torch.add(acc, d, alpha=w, out=acc)"),
        ("exact_divide", fold, True, "torch.div(x, den)"),
        ("exact_fold", fold, False, "torch.mv(d.t(), w / den)"),
        ("weighted_aggregate", "src/repro/kernels/agg/kernel.py:74", False,
         "torch.mv(d.t(), w / den)"),
    ]
    out = []
    for name, replaces, on_path, library in rows:
        t = full["timings"][name]
        out.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": full["launches"][name], "on_main_path": on_path,
            "max_abs_err": t["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": t["library_ms"], "library_call": library,
        })
    return json.dumps({"kernels": out})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = phase_environment()
    phase_parity(dev)
    phase_small_jobs(dev)
    full = phase_full_width(dev)
    print(kernels_line(full), flush=True)
    print(f"card: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
