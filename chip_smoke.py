#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on a CUDA card and check it.

Run from the root of a checkout, with one CUDA card (Hopper, sm_90a) and
the CUDA toolkit:

    python3 chip_smoke.py

It builds the kernels from ``src/repro_torch/kernels/*/csrc`` (one nvcc per
source, started together), then runs six phases, each printing one line:

1. environment: torch/CUDA versions, the card, the kernel builds;
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
5. codec: (a) the quant kernels against their plain versions on the card
   (q and scales as bytes) over edge-case blocks; (b) the same job with the
   param channel on the socket loopback (``backend="multiproc"``, codec
   ``int8_blocks``): 4 trainers, 2 rounds, the job's weights byte-equal
   every round to the plain fold of the plain-dequantized, plain-quantized
   updates, byte counts and codec ratio equal to those worked out from the
   shapes, kernel launches equal to the codec's encode/decode counts, and a
   split of one round; (c) the quant kernels' times at full width;
6. a ``kernels`` JSON line: launches on each path (phase 4 for the fold
   kernels, phase 5's job for the quant kernels), time, plain version's
   time, bound and a library call's time per kernel, at the path's shapes.

Then the card's name and power limit (``nvidia-smi``), and as the last line
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero without
that line; so does a run without a CUDA device or outside a checkout.
"""
from __future__ import annotations

import dataclasses
import gc
import hashlib
import json
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
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
from repro_torch.core.channels import payload_bytes  # noqa: E402
from repro_torch.kernels.agg import kernel, ops, ref  # noqa: E402
from repro_torch.kernels.quant import kernel as qkernel  # noqa: E402
from repro_torch.kernels.quant import ops as qops  # noqa: E402
from repro_torch.kernels.quant import ref as qref  # noqa: E402
from repro_torch.transport import wire  # noqa: E402
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
# phase 5: the same tree over the socket loopback with the int8_blocks codec
CODEC_TRAINERS, CODEC_ROUNDS = 4, 2
QUANT_BLOCK = qkernel.BLOCK
QWEN_BLOCKS = 151_239  # QWEN_PARAMS / 4096, exactly


class PhaseFailed(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


def same_bytes(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


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
LIBRARIES = (kernel.LIBRARY, qkernel.LIBRARY)


def phase_environment() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:  # one nvcc per source
        for fut in [pool.submit(lib.compile) for lib in LIBRARIES]:
            fut.result()
    for lib in LIBRARIES:
        lib.load()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for lib in LIBRARIES if lib.log_path().exists()
             for ln in lib.log_path().read_text().splitlines()
             if "registers" in ln or "spill" in ln]
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
                check(same_bytes(out, ref.exact_fold(d, w, den)),
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
    check(same_bytes(kernel.exact_fold(d, w, den).cpu(),
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
            check(same_bytes(acc, plain), f"exact_fold_into N={N} offset={offset}")
            q = kernel.exact_divide(acc, 7.7)
            check(same_bytes(q, ref.exact_divide(acc, 7.7)), f"exact_divide N={N}")
            inplace = acc.clone()
            kernel.exact_divide(inplace, 7.7, out=inplace)
            check(same_bytes(inplace, q), f"exact_divide in place N={N}")
            cases += 3
        stacked = torch.randn(4 * N + 1, generator=gen, device=dev)[1:].view(4, N)
        w4 = torch.rand(4, generator=gen, device=dev) + 1
        den4 = torch.tensor([float(w4.double().sum())], device=dev)
        check(same_bytes(kernel.exact_fold(stacked, w4, den4), ref.exact_fold(stacked, w4, den4)),
              f"exact_fold misaligned N={N}")
        cases += 1
    torch.cuda.synchronize()
    # the division trap: tensor / python_float against an IEEE divide
    x = torch.randn(1 << 20, generator=gen, device=dev) * 1e3
    total = 7.7
    ieee = torch.from_numpy(x.cpu().numpy() / np.float32(total))
    check(same_bytes(ref.exact_divide(x, total).cpu(), ieee), "0-d tensor divide is not IEEE")
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
            check(same_bytes(g, w), f"round {rnd}: global weights differ from the plain fold")
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
        check(same_bytes(exact, plain), "exact_fold at full width")
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
# phase 5
# ---------------------------------------------------------------------- #
def edge_blocks(dev: torch.device, gen: torch.Generator) -> torch.Tensor:
    """(9, 4096) f32 blocks: all zero, all -0.0, subnormals, +-3e38 among
    small values, exact half-way ties at scale 1 and at scale 2, a NaN, +inf,
    -inf. Rows 6-8 (NaN and infinities) are compared by scale only."""
    x = torch.randn(9, QUANT_BLOCK, generator=gen, device=dev)
    x[0] = 0.0
    x[1] = -0.0
    sign = torch.where(x[2] < 0, -1.0, 1.0)
    x[2] = sign * torch.rand(QUANT_BLOCK, generator=gen, device=dev) * 1.1e-38
    x[3] = x[3] * 1e-3
    x[3, 0], x[3, 1] = 3e38, -3e38
    k = torch.randint(-127, 127, (QUANT_BLOCK,), generator=gen, device=dev).float()
    x[4] = k + 0.5            # absmax 126.5 or 127 -> ties of (k + 0.5) * scale
    x[4, 0] = 127.0           # scale = 127 * f32(1/127) = 1.0 exactly
    x[5] = 2.0 * k + 1.0      # (k + 0.5) * 2
    x[5, 0] = 254.0           # scale 2.0
    x[6, 17] = float("nan")
    x[7, 5] = float("inf")
    x[8, 9] = float("-inf")
    return x


def phase_codec_parity(dev: torch.device) -> dict:
    """(a) each quant kernel against its plain version on the card, q and
    scales compared as bytes."""
    gen = torch.Generator(device=dev).manual_seed(5)
    cases = 0
    errs = {"quantize_blocks": 0.0, "dequantize_blocks": 0.0}

    def compare(x: torch.Tensor, finite_rows: slice = slice(None)) -> None:
        nonlocal cases
        q, s = qkernel.quantize_blocks(x)
        pq, ps = qref.quantize_blocks(x)
        check(torch.equal(torch.isnan(s), torch.isnan(ps)), "quantize: NaN scales differ")
        keep = ~torch.isnan(ps)
        check(same_bytes(s[keep], ps[keep]), f"quantize: scales differ (NB={x.shape[0]})")
        check(same_bytes(q[finite_rows], pq[finite_rows]), f"quantize: q differs (NB={x.shape[0]})")
        d = qkernel.dequantize_blocks(pq, ps)
        pd = qref.dequantize_blocks(pq, ps)
        check(torch.equal(torch.isnan(d), torch.isnan(pd)), "dequantize: NaNs differ")
        fin = torch.isfinite(pd)
        check(same_bytes(d[fin], pd[fin]) and torch.equal(d[~fin].isnan(), pd[~fin].isnan()),
              f"dequantize differs (NB={x.shape[0]})")
        qd = (q[finite_rows].float() - pq[finite_rows].float()).abs().max()
        fin_s = torch.isfinite(ps)
        errs["quantize_blocks"] = max(errs["quantize_blocks"], float(qd),
                                      float((s[fin_s] - ps[fin_s]).abs().max()))
        errs["dequantize_blocks"] = max(errs["dequantize_blocks"],
                                        float((d[fin] - pd[fin]).abs().max()))
        cases += 2

    for nb in (1, 3, QWEN_BLOCKS):
        scale = torch.exp(torch.randn(nb, 1, generator=gen, device=dev) * 4)
        compare(torch.randn(nb, QUANT_BLOCK, generator=gen, device=dev) * scale)
    edge = edge_blocks(dev, gen)
    compare(edge, slice(0, 6))
    q, s = qkernel.quantize_blocks(edge)
    check(float(s[4]) == 1.0 and float(s[5]) == 2.0, "tie blocks: scale is not 1 and 2")
    want = torch.round(edge[4:6] / s[4:6])  # half to even
    check(torch.equal(q[4:6].float(), want), "ties did not round half to even")
    check(bool((q[0:2] == 0).all()), "zero blocks: q is not 0")
    check(same_bytes(s[0], torch.tensor([1e-30], device=dev) * torch.tensor(qref.INV_127, device=dev)),
          "zero block: scale is not 1e-30 * f32(1/127)")
    check(bool(torch.isnan(s[6])) and float(s[7]) == float("inf") and float(s[8]) == float("inf"),
          "NaN/inf blocks: scale is not NaN / inf")
    # n not a multiple of 4096, through the flat layer (zero padding)
    n = 3 * QUANT_BLOCK + 1234
    flat = torch.randn(n, generator=gen, device=dev)
    q, s = qkernel.quantize_blocks(torch.cat([flat, flat.new_zeros(QUANT_BLOCK - 1234)]).view(-1, QUANT_BLOCK))
    fq, fs = qops.quantize_flat(flat)
    check(same_bytes(fq, q) and same_bytes(fs, s), "quantize_flat: padding differs")
    back = qops.dequantize_flat(fq, fs, n)
    check(back.shape == (n,) and same_bytes(back, qref.dequantize_blocks(q, s).view(-1)[:n]),
          "dequantize_flat differs")
    # the card's bits are the CPU's (the JAX package's CPU path gives those)
    x = torch.randn(64, QUANT_BLOCK, generator=gen, device=dev) * 7
    q, s = qkernel.quantize_blocks(x)
    cq, cs = qref.quantize_blocks(x.cpu())
    check(same_bytes(q.cpu(), cq) and same_bytes(s.cpu(), cs), "quantize: card differs from CPU")
    torch.cuda.synchronize()
    print(f"phase codec parity: ok {cases + 3} comparisons bit-equal (NB 1, 3, {QWEN_BLOCKS}; "
          "zero, -0.0, subnormal, +-3e38, half-way ties at scales 1 and 2; NaN/inf by scale; "
          f"n % 4096 = 1234; card vs CPU)", flush=True)
    return errs


def codec_tag():
    """classical_fl with the param channel on the socket loopback, coded."""
    tag = classical_fl()
    return dataclasses.replace(tag, channels=tuple(
        dataclasses.replace(c, backend="multiproc", codec="int8_blocks")
        if c.name == "param-channel" else c for c in tag.channels))


def _walk(tree, out):
    """Leaves in the order the codec walks them: dicts in insertion order."""
    if isinstance(tree, dict):
        for v in tree.values():
            _walk(v, out)
    elif isinstance(tree, list):
        for v in tree:
            _walk(v, out)
    else:
        out.append(tree)
    return out


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, it) for v in tree]
    return next(it)


def _plain_roundtrip(tree):
    """The plain chain of one coded message: concatenate the leaves in the
    codec's order, plain quantize, plain dequantize, split into leaves of
    the same shapes and structure."""
    leaves = _walk(tree, [])
    n = sum(x.numel() for x in leaves)
    flat = torch.cat([x.reshape(-1) for x in leaves] + [leaves[0].new_zeros((-n) % QUANT_BLOCK)])
    q, s = qref.quantize_blocks(flat.view(-1, QUANT_BLOCK))
    del flat
    out = qref.dequantize_blocks(q, s).view(-1)
    del q
    parts, off = [], 0
    for x in leaves:
        parts.append(out[off:off + x.numel()].view(x.shape))
        off += x.numel()
    return _rebuild(tree, iter(parts))


def _expected_wire(shapes, n_leaves: int, n: int) -> dict:
    """Bytes of one coded message and of its raw payload, worked out from
    the shapes: the payloads are rebuilt with meta tensors (no data) and
    counted by the wire format's rules."""
    meta = _map_shapes(lambda s: torch.empty(s, device="meta"), shapes)
    specs = [(tuple(s), "<f4") for s in _flat_shapes(shapes)]
    it = iter(range(n_leaves))
    marks = _map_shapes(lambda s: {"__qb__": next(it)}, shapes)
    nb = -(-n // QUANT_BLOCK)

    def coded(extra):
        return {"__wire_codec__": "int8_blocks", "payload": {
            "tree": {"weights": marks, **extra}, "q": torch.empty(n, dtype=torch.int8, device="meta"),
            "scale": torch.empty(nb, 1, device="meta"), "specs": specs, "n": n}}

    bcast, up = {"done": False}, {"num_samples": 1}
    return {
        "hub_bytes": payload_bytes(coded(bcast)),  # the same for an update
        "raw_bcast": wire.encoded_size({"weights": meta, **bcast}),
        "raw_up": wire.encoded_size({"weights": meta, **up}),
        "coded_bcast": wire.encoded_size(coded(bcast)),
        "coded_up": wire.encoded_size(coded(up)),
    }


class _Clock:
    """Host-clock spans of one replayed piece, synchronized on the card."""

    def __init__(self):
        self.ms = {}

    def span(self, name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        self.ms[name] = (time.perf_counter() - t0) * 1e3
        return out


def _socket_crossing_ms(frame) -> float:
    """One wire crossing of ``frame`` over a local socket pair: encode and
    send on one thread, receive and decode on this one."""
    import socket
    a, b = socket.socketpair()
    try:
        t = threading.Thread(target=wire.send_obj, args=(a, frame))
        t0 = time.perf_counter()
        t.start()
        wire.recv_obj(b)
        t.join(timeout=600)
        check(not t.is_alive(), "socket replay: sender did not finish")
        return (time.perf_counter() - t0) * 1e3
    finally:
        a.close()
        b.close()


def phase_codec_job(dev: torch.device, errs: dict) -> dict:
    """(b) the full-width job over the socket loopback with int8_blocks, and
    (c) the quant kernels' times at its shapes."""
    shapes = qwen_shapes()
    n_params = sum(int(np.prod(s)) for s in _flat_shapes(shapes))
    n_leaves = len(_flat_shapes(shapes))
    check(n_params == QWEN_BLOCKS * QUANT_BLOCK, "tree is not a whole number of blocks")
    gen = torch.Generator(device=dev).manual_seed(0)
    init = _map_shapes(lambda s: 0.02 * torch.randn(s, generator=gen, device=dev), shapes)
    job = JobSpec(
        tag=codec_tag(),
        datasets=tuple(DatasetSpec(name=f"d{i}") for i in range(CODEC_TRAINERS)),
        hyperparams={"rounds": CODEC_ROUNDS, "init_weights": init},
    )
    del init
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernel.reset_launches()
    qkernel.reset_launches()
    t0 = time.perf_counter()
    res = run_job(job, device=dev, timeout=900, program_overrides={
        "trainer": NoiseTrainer, "global-aggregator": RecordingAggregator})
    torch.cuda.synchronize()
    job_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in qkernel.KERNELS + kernel.KERNELS}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    check(not res.errors, f"codec job errors: {res.errors}")
    stats = dict(res.channel_stats["param-channel"])
    channel_bytes = res.channel_bytes["param-channel"]
    root = next(p for p in res.programs.values() if isinstance(p, RecordingAggregator))
    history, round_s = root.history, root.round_s
    check(len(history) == CODEC_ROUNDS + 1, f"{len(history) - 1} rounds recorded")
    datasets = sorted((w.worker_id, w.dataset) for w in res.workers if w.role == "trainer")
    del res, root, job
    gc.collect()
    torch.cuda.empty_cache()

    # launches and codec counts: a broadcast per round plus the closing one
    # (one send_many encode each, a decode per trainer), an upload per
    # trainer per round (an encode and a server decode each)
    T, R = CODEC_TRAINERS, CODEC_ROUNDS
    encodes, decodes = (R + 1) + R * T, (R + 1) * T + R * T
    check(stats.get("payload_encodes") == encodes, f"encodes {stats.get('payload_encodes')} != {encodes}")
    check(stats.get("payload_decodes") == decodes, f"decodes {stats.get('payload_decodes')} != {decodes}")
    check(launches["quantize_blocks"] == encodes,
          f"quantize launches {launches['quantize_blocks']} != encodes {encodes}")
    check(launches["dequantize_blocks"] == decodes,
          f"dequantize launches {launches['dequantize_blocks']} != decodes {decodes}")
    check(launches["exact_fold_into"] > 0, "the codec job never ran the fold kernel")
    # bytes: every delivered message counted by the hub; raw and coded sizes
    # of every send (a broadcast counts once per trainer) by the client
    exp = _expected_wire(shapes, n_leaves, n_params)
    msgs = (R + 1) * T + R * T
    check(channel_bytes == msgs * exp["hub_bytes"], f"channel_bytes {channel_bytes} != {msgs} x {exp['hub_bytes']}")
    raw = (R + 1) * T * exp["raw_bcast"] + R * T * exp["raw_up"]
    coded = (R + 1) * T * exp["coded_bcast"] + R * T * exp["coded_up"]
    check(stats.get("raw_bytes") == raw, f"raw_bytes {stats.get('raw_bytes')} != {raw}")
    check(stats.get("codec_ratio") == coded / raw, f"codec_ratio {stats.get('codec_ratio')} != {coded / raw}")

    # every round: the plain chain from the previous global weights
    for rnd in range(1, R + 1):
        received = _plain_roundtrip(history[rnd - 1])
        acc, total = None, 0.0
        for _, dataset in datasets:
            update = _plain_roundtrip(noisy(received, dataset, rnd))
            m = float(samples_of(dataset))
            total += m
            acc = tree_map(lambda x: ref.exact_fold_into(None, x, m), update) if acc is None \
                else tree_map(lambda a, x: ref.exact_fold_into(a, x, m), acc, update)
            del update
        mean = tree_map(lambda x: ref.exact_divide(x, total), acc)
        got, want = tree_leaves(history[rnd]), tree_leaves(mean)
        check(all(torch.isfinite(g).all() for g in got), f"codec round {rnd}: non-finite weights")
        check(len(got) == len(want) and all(same_bytes(g, w) for g, w in zip(got, want)),
              f"codec round {rnd}: global weights differ from the plain chain")
        del received, acc, mean, got, want

    # a split of one round, each piece replayed alone on the last round's data
    clock = _Clock()
    base = history[R - 1]
    del history
    leaves = tree_leaves(base)
    codec = wire.Int8BlocksCodec()
    payload = {"weights": base, "num_samples": samples_of(datasets[0][1])}
    flat = clock.span("cat", lambda: torch.cat([x.reshape(-1) for x in leaves]))
    q, s = clock.span("quantize", lambda: qkernel.quantize_blocks(flat.view(-1, QUANT_BLOCK)))
    clock.span("d2h", lambda: (q.view(-1).cpu(), s.cpu()))
    del flat
    frame = clock.span("encode", lambda: wire.encode_payload(payload, codec))
    socket_ms = _socket_crossing_ms(frame)
    on_wire = wire.decode(wire.encode(frame))
    clock.span("h2d", lambda: (torch.from_numpy(on_wire["payload"]["q"]).to(dev),
                               torch.from_numpy(on_wire["payload"]["scale"]).to(dev)))
    clock.span("dequantize", lambda: qkernel.dequantize_blocks(q, s))
    decoded = clock.span("decode", lambda: wire.decode_payload(on_wire, dev))
    updates = [decoded["weights"]] * T

    def fold_round():
        acc = None
        for u in updates:
            acc = ops.fold_into(acc, u, 100.0)
        return ops.divide(acc, 100.0 * T)

    clock.span("fold", fold_round)
    del decoded, updates, on_wire, frame, payload
    ms = clock.ms

    # (c) kernel times at full width, CUDA events
    x = torch.cat([x_.reshape(-1) for x_ in leaves]).view(-1, QUANT_BLOCK)
    nb = x.shape[0]
    q, s = qkernel.quantize_blocks(x)
    nbytes = (5 * QUANT_BLOCK + 4) * nb
    timings = {
        "quantize_blocks": dict(
            ms=cuda_ms(lambda: qkernel.quantize_blocks(x)),
            plain_ms=cuda_ms(lambda: qref.quantize_blocks(x), reps=2),
            library_ms=None,
            bound=bound(nbytes, 6 * QUANT_BLOCK * nb), max_abs_err=errs["quantize_blocks"],
        ),
        "dequantize_blocks": dict(
            ms=cuda_ms(lambda: qkernel.dequantize_blocks(q, s)),
            plain_ms=cuda_ms(lambda: qref.dequantize_blocks(q, s), reps=2),
            library_ms=cuda_ms(lambda: torch.mul(q, s)),
            bound=bound(nbytes, 2 * QUANT_BLOCK * nb), max_abs_err=errs["dequantize_blocks"],
        ),
    }
    check(same_bytes(torch.mul(q, s), qkernel.dequantize_blocks(q, s)), "torch.mul(q, s) differs")
    del x, q, s, base, leaves
    torch.cuda.empty_cache()
    per_round = {
        "encode_ms": ms["encode"] * (1 + T), "socket_ms": socket_ms * (1 + T + 2 * T),
        "decode_ms": ms["decode"] * 2 * T, "fold_ms": ms["fold"],
    }
    tq, td = timings["quantize_blocks"], timings["dequantize_blocks"]
    print(f"phase codec job: ok Qwen2.5-3B tree ({n_params} f32 params, {nb} blocks, layers 36->4) "
          f"over the socket loopback with int8_blocks, {T} trainers, {R} rounds byte-equal to the "
          f"plain chain; job_s {job_s:.3f} round_wall_s {[round(t, 4) for t in round_s]} "
          f"peak_device_gb {peak_gb:.2f} channel_bytes {channel_bytes} raw_bytes {raw} "
          f"codec_ratio {coded / raw:.6f} encodes {encodes} decodes {decodes}; "
          f"one message: encode_ms {ms['encode']:.3f} (cat {ms['cat']:.3f} quantize {ms['quantize']:.3f} "
          f"d2h {ms['d2h']:.3f}) socket_crossing_ms {socket_ms:.3f} decode_ms {ms['decode']:.3f} "
          f"(h2d {ms['h2d']:.3f} dequantize {ms['dequantize']:.3f}) fold_{T}_updates_ms {ms['fold']:.3f}; "
          f"serial sum per round {json.dumps({k: round(v, 3) for k, v in per_round.items()})}; "
          f"quantize ms {tq['ms']:.3f} dequantize ms {td['ms']:.3f} bound_ms {tq['bound'][0]:.3f}",
          flush=True)
    return {"launches": launches, "timings": timings}


# ---------------------------------------------------------------------- #
def kernels_line(full: dict, codec: dict) -> str:
    agg_src = "src/repro_torch/kernels/agg/csrc/agg.cu"
    quant_src = "src/repro_torch/kernels/quant/csrc/quant.cu"
    fold = "src/repro/kernels/agg/kernel.py:96"
    rows = [
        ("exact_fold_into", agg_src, fold, True, "torch.add(acc, d, alpha=w, out=acc)", full),
        ("exact_divide", agg_src, fold, True, "torch.div(x, den)", full),
        ("exact_fold", agg_src, fold, False, "torch.mv(d.t(), w / den)", full),
        ("weighted_aggregate", agg_src, "src/repro/kernels/agg/kernel.py:74", False,
         "torch.mv(d.t(), w / den)", full),
        ("quantize_blocks", quant_src, "src/repro/kernels/quant/kernel.py:31", True,
         "none: no one PyTorch call computes blockwise scales and codes", codec),
        ("dequantize_blocks", quant_src, "src/repro/kernels/quant/kernel.py:50", True,
         "torch.mul(q, scale)", codec),
    ]
    out = []
    for name, src, replaces, on_path, library, run in rows:
        t = run["timings"][name]
        out.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": run["launches"][name], "on_main_path": on_path,
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
    gc.collect()
    torch.cuda.empty_cache()
    errs = phase_codec_parity(dev)
    codec = phase_codec_job(dev, errs)
    print(kernels_line(full, codec), flush=True)
    print(f"card: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
