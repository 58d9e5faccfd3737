#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on a CUDA card and check it.

Run from the root of a checkout, with one CUDA card (Hopper, sm_90a) and
the CUDA toolkit:

    python3 chip_smoke.py

It builds the kernels from ``src/repro_torch/kernels/*/csrc`` (one nvcc per
source, started together), then runs nine phases, each printing one line:

1. environment: torch/CUDA versions, the card, the kernel builds;
2. kernel parity: every kernel entry against its plain PyTorch version on
   the same CUDA tensors (bytes equal for the exact entries; the fused
   weighted sum within 1e-6 of the summed magnitudes of its terms; the
   streaming fold's tree entry on trees of odd sizes, of leaves at 16-byte
   and at 4-byte offsets and of more than one table of leaves, first update
   and later, with one launch per table), and whether
   ``tensor / python_float`` on CUDA is an IEEE divide;
3. the slice, small: ``classical_fl`` with the seeded SGD trainer and
   ``hierarchical_fl`` with an "add one" trainer, on the card and on the
   CPU, folding through the tree entry only; then ``distributed_fl``,
   ``hybrid_fl``, ``coordinated_fl`` and ``gossip_fl`` with trainers that
   add noise drawn on the host (every weight byte-equal card vs CPU, the
   coordinated job on the stacked exact fold) and ``vertical_fl`` (losses
   and weights within the SGD tolerance); and the runtime policies: a
   deadline job with a straggler, and a one-trainer FedBuff job restarted
   from its checkpoint by a second ``run_job`` (weights, logs and the
   restored step byte-equal card vs CPU);
4. the slice at full width: a ``classical_fl`` job whose weight tree is the
   parameter tree of Qwen2.5-3B (published widths, depth cut from 36
   layers to 4), 8 trainers, 3 rounds, with the job's global weights held
   byte-equal to the plain fold of the same updates after every round and
   exactly one launch of the fold's tree entry per update (none per leaf);
   then the fold's times, in turns: the tree entry, the per-leaf entry, 50
   per-leaf ``torch.add`` calls, one ``torch._foreach_add_`` and the plain
   version, beside the bound, and the host ms of a ``StreamingMean.fold``
   call through the tree entry and through 50 per-leaf calls;
   4b. the other topologies on the same tree: ``coordinated_fl`` with 8
   trainers and 2 aggregator replicas, 3 rounds, every round's global
   weights byte-equal to a replay of the same updates, in the order each
   aggregator folded them, through the plain stacked fold, with exactly
   (aggregators + global) x leaves x rounds launches of ``agg_exact_fold``
   and none of the streaming fold, the stacked folds of a round timed
   beside ``torch.mv``; and ``distributed_fl`` with 4 trainers, 2 rounds,
   on the tree cut to 1 layer (to make room for phases 7 and 8),
   the consensus byte-equal across trainers and to a float64 numpy fold of
   the same updates on the host, leaf by leaf; each job's peak memory;
   4c. the runtime policies on the same tree: (a) a deadline job, 8
   trainers, 3 rounds, one straggler past the deadline excluded every
   round, every round byte-equal to the plain streaming fold of the
   included updates in sorted-source order (7 tree folds and 50 divides a
   round); (b) a FedBuff job, 8 trainers at staggered compute times,
   buffer 4, 3 versions, byte-equal to a replay of its staleness log
   through the plain versions (base snapshot, delta, host weight, zeros-
   start accumulator, ``p + lr * acc / count``), one tree fold per absorbed
   update; (c) ``accumulate_batch`` (stacked fold, C = 8, one launch a
   leaf) against ``accumulate_stream`` and the plain chain; (d) a
   checkpoint round trip of the global weights onto the card;
5. codec: (a) the quant kernels against their plain versions on the card
   (q and scales as bytes) over edge-case blocks; (b) the same job with the
   param channel on the socket loopback (``backend="multiproc"``, codec
   ``int8_blocks``): 4 trainers, 2 rounds, the job's weights byte-equal
   every round to the plain fold of the plain-dequantized, plain-quantized
   updates, byte counts and codec ratio equal to those worked out from the
   shapes, kernel launches equal to the codec's encode/decode counts and
   one fold launch per update, and a split of one round; (c) the quant
   kernels' times at full width;
6. serve: (a) both flash kernels against their plain version on the same
   CUDA tensors: every case through the wrapper, which picks the route by
   dtype and head dim (bf16 at D 64 and 128: the tensor-core kernel of
   ``flash_sm90.cu``; the rest: ``flash.cu``), with one launch on the
   expected route, and each bf16 D 64 / 128 case also on ``flash.cu``
   directly, which takes it too (the five shapes of the JAX package's
   kernel test and its bf16 case, head dims 32 to 256, causal, not, sliding
   windows, GQA 8:1, ragged S, the serving shape); (b) ``serve.generate``
   on Qwen2.5-3B at full width and depth (36 layers, bf16, random weights
   from a seeded generator), 8 prompts of 2048 tokens and 64 greedy tokens,
   with the flash kernel: logits finite, 36 launches of the tensor-core
   kernel per prefill, none of ``flash.cu`` and none per decode step, the
   prefill's logits against the plain attention's, and teacher forcing (a
   decode step after a prefill of S tokens against a prefill of S + 1);
   (c) prefill and decode times, a kernel-time breakdown of each from
   ``torch.profiler``, and both flash kernels' times at the serving shape:
   the tensor-core kernel at bf16, ``flash.cu`` on its own route, float32
   (checked against the plain version there too);
7. the process plane (run after phase 5, before phase 6): (a) phase 5's job
   (the same tree, seeds, 4 trainers, 2 rounds, ``int8_blocks``) through
   ``run_job_multiproc`` with ``reduce_plan`` 1: 5 worker processes and the
   hub in this process, which decodes each upload with the dequantize
   kernel and folds it with the tree fold kernel on the card; every round's
   weights byte-equal (sha256 of the bytes) to the same job through
   ``run_job`` on the socket loopback at the same plan and to phase 5's
   unreduced rounds; the hub's launches and every child's (from their
   summaries) equal to the counts derived from the shapes; start-up, round
   wall time, the hub fold's device ms, the hub's time under its lock, the
   children's and the driver's peak memory; (b) a ``hierarchical_fl`` job
   on 2 pool hosts with sharded hubs at ``reduce_plan`` 2 under the deadline
   policy, an intermediate aggregator dropped and re-joined, and a
   ``coordinated_fl`` sync job over 7 processes, each byte-equal (every
   program's weights, events, drops, channel bytes) to ``run_job`` on the
   card;
8. the federated train step (run last): (a) ``build_train_step`` on
   Qwen2.5-3B at full width and depth (36 layers, bf16, seeded random
   weights), ``classical_fl`` lowered to a plan over 2 virtual clients,
   FedAdam, ``launch/train.py``'s traffic (batch 8 x 128 tokens of
   ``synthetic_lm_batches(seed=0)``, 2 local steps at lr 0.05): a warm-up
   round and 5 timed rounds (host clock after a synchronize; the split
   into the clients' SGD, the stage sums and the apply by CUDA events),
   every kernel's launches over them (none: the stages are float32 sums and
   training runs the plain attention), a profiled round (launches, busy
   share), the peak memory and the memory held between rounds, every loss
   and ``delta_norm``; gates: the held memory flat (within 1 GB), finite
   losses, weights and server state, the last loss below the first (as
   ``launch/train.py`` asserts), and, from a new init with the first batch
   repeated 3 rounds, a loss at least 1 nat lower (the fresh batches alone
   carry little to learn: 1 024 new tokens of 152 064 a round); (b)
   ``hierarchical_fl`` over pod 2 x data 2 with a bf16 cross-pod wire at 4
   layers, 3 rounds; (c) the first round at 2 layers, full width, float32,
   on the card against the same round on the CPU from the same parameters
   and batch: loss, ``delta_norm`` and every new parameter within the
   stated tolerances;
9. a ``kernels`` JSON line: launches on each path (phase 4 for the
   streaming fold kernels, phase 4b's coordinated job for the stacked exact
   fold, phase 4c's jobs and batch for every agg entry, phase 5's job for
   the quant kernels, phase 6's serving run for the flash kernels, phase
   7's process job for the agg and quant entries, phase 8's rounds for
   every kernel), time, plain version's time, bound and a library call's
   time per kernel, at the path's shapes.

Then the card's name and power limit (``nvidia-smi``), and as the last line
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero without
that line; so does a run without a CUDA device or outside a checkout.
"""
from __future__ import annotations

import dataclasses
import gc
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import checkpoint  # noqa: E402
from repro_torch.convert import tree_to_numpy  # noqa: E402
from repro_torch.core.expansion import JobSpec  # noqa: E402
from repro_torch.core import roles as troles  # noqa: E402
from repro_torch.core import roles_async  # noqa: E402
from repro_torch.core.roles import GlobalAggregator, Trainer  # noqa: E402
from repro_torch.core.runtime import RuntimePolicy, run_job  # noqa: E402
from repro_torch.core.tag import DatasetSpec  # noqa: E402
from repro_torch.core.roles_coord import (  # noqa: E402
    CoordAggregator, CoordGlobalAggregator, CoordTrainer)
from repro_torch.core.topologies import (  # noqa: E402
    classical_fl, coordinated_fl, distributed_fl, gossip_fl, hierarchical_fl, hybrid_fl,
    vertical_fl)
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.core.channels import InprocBackend, payload_bytes  # noqa: E402
from repro_torch.fl.strategies import get_strategy  # noqa: E402
from repro_torch.kernels.agg import kernel, ops, ref  # noqa: E402
from repro_torch.kernels.quant import kernel as qkernel  # noqa: E402
from repro_torch.kernels.quant import ops as qops  # noqa: E402
from repro_torch.kernels.quant import ref as qref  # noqa: E402
from repro_torch.transport import wire  # noqa: E402
from repro_torch.transport.conformance import SeededSGDTrainer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fkernel  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fref  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.launch.spawn import run_job_multiproc  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.core.mesh_lowering import lower_tag_to_mesh  # noqa: E402
from repro_torch.data.datasets import synthetic_lm_batches  # noqa: E402
from repro_torch.fl.fedstep import FedStepConfig  # noqa: E402
from repro_torch.launch.mesh import make_virtual_mesh  # noqa: E402
from repro_torch.launch.steps import build_train_step  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet), at the full 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_TENSOR_FLOPS = 989e12
# the CPU tests' tolerance for the seeded SGD job (tests/test_torch_jobs.py):
# float32 products rounded by another BLAS
SGD_RTOL, SGD_ATOL = 1e-5, 1e-6
WEIGHTED_RTOL = 1e-6

# Qwen2.5-3B (src/repro/configs/qwen2_5_3b.py), depth cut 36 -> 4 layers
QWEN = dict(d_model=2048, heads=16, kv_heads=2, head_dim=128, d_ff=11008,
            vocab=151936, layers=4)
QWEN_PARAMS = 619_474_944
N_TRAINERS, ROUNDS = 8, 3
# phase 4b: coordinated FL (8 trainers, 2 aggregator replicas) and the
# distributed ring (4 trainers) on the same tree
COORD_TRAINERS, COORD_AGGS, COORD_ROUNDS = 8, 2, 3
DIST_TRAINERS, DIST_ROUNDS = 4, 2
# the ring's tree at 1 of phase 4's 4 layers (388 M parameters): its host
# float64 check was the script's largest piece, cut from 4 layers to 2 to
# make room for phase 7 and to 1 for phase 8
DIST_LAYERS = 1
# phase 4c: the deadline and async policies on the same tree: 8 trainers,
# 3 rounds (versions); one straggler past the deadline; FedBuff's buffer; a
# wall-clock grace no on-time update of 2.48 GB comes near (the rounds print
# what they waited)
POLICY_TRAINERS, POLICY_ROUNDS = 8, 3
DEADLINE_S, STRAGGLER, STRAGGLER_S = 2.0, "trainer-1", 5.0
ASYNC_BUFFER, POLICY_GRACE_S = 4, 60.0
BATCH_STALENESS = (0, 1, 2, 3, 0, 1, 2, 3)
# phase 5: the same tree over the socket loopback with the int8_blocks codec
CODEC_TRAINERS, CODEC_ROUNDS = 4, 2
QUANT_BLOCK = qkernel.BLOCK
QWEN_BLOCKS = 151_239  # QWEN_PARAMS / 4096, exactly
# phase 6: serving the full Qwen2.5-3B (36 layers, bf16, vocab padded to 152 064)
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 8, 2048, 64
QWEN_FULL_PARAMS = 3_086_200_832
# the flash kernel against its plain version: the JAX package's tolerances
# (tests/test_kernels.py); the kernel sums in another order
FLASH_ATOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
# ... and a limit scaled to the output, for the long rows whose values are
# far below FLASH_ATOL (|out| ~ 0.04 at S 2048): relative L2 within a few
# times the rounding of the output (bf16: 2^-9 at most per value), which a
# plain version with one 64-key tile dropped must exceed
FLASH_REL_L2 = {torch.float32: 1e-5, torch.bfloat16: 5e-3}
# keys a planted fault drops: one KV tile of flash.cu at D 64, half of the
# tensor-core kernel's 128-key tile, so the stricter control for it
FAULT_KEYS = 64
# prefill logits, flash against plain attention and decode against a longer
# prefill: bf16 rounds at every product through 36 layers, in other orders;
# prefills with a fault planted in the attention must read above it
SERVE_REL_L2 = 5e-2
# phase 8: the federated train step (TAG -> aggregation plan -> fed step) on
# Qwen2.5-3B at full width and depth, classical_fl over 2 virtual clients,
# the config's FedAdam; the traffic is launch/train.py's defaults
TRAIN_CLIENTS, TRAIN_WARMUP, TRAIN_ROUNDS = 2, 1, 5
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LOCAL_STEPS, TRAIN_LR = 8, 128, 2, 0.05
# the second run: hierarchical_fl over pod 2 x data 2, bf16 cross-pod wire,
# full width at 4 layers
HIER_PODS, HIER_CLIENTS, HIER_LAYERS, HIER_ROUNDS = 2, 2, 4, 3
# the gate: the first round at 2 layers, full width, float32, on the card and
# on the CPU from the same parameters and batch
GATE_LAYERS = 2
# float32 products summed in other orders (cuBLAS against the CPU's BLAS, TF32
# off): about sqrt(K) * 2**-24 = 6e-6 relative at K = 11 008, so the loss and
# delta_norm within 1e-5 relative; FedAdam moves a parameter by at most half
# its delta's difference where the delta is small, and by a sign-like 0.01
# the float32 differences cannot flip where it is not: 1e-5 absolute
GATE_LOSS_RTOL, GATE_NORM_RTOL, GATE_PARAM_ATOL = 1e-5, 1e-5, 1e-5
# the step learns: one batch repeated, full width and depth; the loss must
# fall by at least LEARN_DROP nats in LEARN_ROUNDS rounds (fresh batches move
# it by about 0.1 either way: 1 024 new tokens of 152 064 a round)
LEARN_ROUNDS, LEARN_DROP = 3, 1.0
# memory held between rounds may not grow by a tree's worth (the parameters
# are 6.2 GB) over the timed rounds
HELD_GROWTH_GB = 1.0


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


def bound(nbytes: float, flops: float, peak_flops: float = F32_FLOPS):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------- #
# phase 1
# ---------------------------------------------------------------------- #
LIBRARIES = (kernel.LIBRARY, qkernel.LIBRARY, fkernel.LIBRARY, fkernel.SM90_LIBRARY)


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
    cases += phase_tree_parity(dev, gen)
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


def _leaves_at(sizes, gen, dev, offset_every):
    """Leaves of ``sizes`` in one buffer; every ``offset_every``-th starts
    one float past a 16-byte boundary."""
    pos, spans = 0, []
    for i, n in enumerate(sizes):
        pos += -pos % 4 + (i % offset_every == 1)
        spans.append((pos, n))
        pos += n
    buf = torch.randn(pos + 4, generator=gen, device=dev)
    return [buf[o:o + n] for o, n in spans]


# leaf sizes of the tree entry's parity trees: odd, empty, multiples of 4,
# a chunk and more, a leaf of 2^20 + 3
TREE_SIZES = (1, 3, 4, 5, 7, 0, 130, 4099, kernel.CHUNK, kernel.CHUNK + 3, 16_640, (1 << 20) + 3)


def phase_tree_parity(dev: torch.device, gen: torch.Generator) -> int:
    """The fold's tree entry against its plain version, bytes equal: a first
    update, then later ones into accumulators at both alignments, on the
    odd-size tree and on one of 2 * TREE_LEAVES + 7 leaves (three launches
    a fold); launches counted per call."""
    sizes_rng = np.random.default_rng(9)
    many = [int(n) for n in sizes_rng.integers(1, 5000, size=2 * kernel.TREE_LEAVES + 7)]
    cases = 0
    for name, sizes in (("odd sizes", TREE_SIZES), ("more than a table", many)):
        per_fold = -(-sum(1 for n in sizes if n) // kernel.TREE_LEAVES)
        ds, ds2 = _leaves_at(sizes, gen, dev, 2), _leaves_at(sizes, gen, dev, 3)
        ds[0][0] = -0.0
        kernel.reset_launches()
        acc = kernel.exact_fold_into_tree(None, ds, 3.0)
        plain = ref.exact_fold_into_tree(None, ds, 3.0)
        check(all(same_bytes(a, b) for a, b in zip(acc, plain)), f"exact_fold_into_tree first, {name}")
        check(bool(torch.signbit(acc[0][0])), "exact_fold_into_tree lost -0.0")
        for accs in (acc, _leaves_at(sizes, gen, dev, 2)):  # fresh, then offset accumulators
            for a, b in zip(accs, plain):
                a.copy_(b)
            want = ref.exact_fold_into_tree([a.clone() for a in accs], ds2, 0.3)
            out = kernel.exact_fold_into_tree(accs, ds2, 0.3)
            check(all(o is a for o, a in zip(out, accs)), "exact_fold_into_tree is not in place")
            check(all(same_bytes(a, b) for a, b in zip(out, want)),
                  f"exact_fold_into_tree later, {name}")
        check(kernel.exact_fold_into_tree.launches == 3 * per_fold,
              f"exact_fold_into_tree {name}: {kernel.exact_fold_into_tree.launches} launches, "
              f"not {3 * per_fold}")
        cases += 3
    return cases


# ---------------------------------------------------------------------- #
# phase 3
# ---------------------------------------------------------------------- #
class AddOneTrainer(Trainer):
    def train(self):
        if self.weights is not None:
            self.weights = {k: v + 1.0 for k, v in self.weights.items()}


def _small_job(tag, init, n=4, rounds=3):
    hp = {"rounds": rounds} if init is None else {"rounds": rounds, "init_weights": init}
    return JobSpec(
        tag=tag,
        datasets=tuple(DatasetSpec(name=f"d{i}") for i in range(n)),
        hyperparams=hp,
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
    folds = kernel.exact_fold_into_tree.launches
    check(folds > 0 and kernel.exact_divide.launches > 0, "classical job never ran the fold kernel")
    check(kernel.exact_fold_into.launches == 0, "classical job folded leaf by leaf")
    host = _run(_small_job(classical_fl(), sgd_w0), "cpu", SeededSGDTrainer)
    a, b = tree_to_numpy(card.global_weights()), tree_to_numpy(host.global_weights())
    err = max(float(np.abs(a[k] - b[k]).max()) for k in a)
    check(all(np.allclose(a[k], b[k], rtol=SGD_RTOL, atol=SGD_ATOL) for k in a),
          f"SGD job card vs CPU differs by {err}")
    check(card.channel_bytes == host.channel_bytes, "SGD job channel_bytes differ")

    groups = {"west": ("d0", "d1"), "east": ("d2", "d3")}
    w0 = {"w": np.full((8,), 2.0, np.float32), "b": np.zeros((2, 2), np.float32)}
    tag = hierarchical_fl(groups=("west", "east"), dataset_groups=groups)
    kernel.reset_launches()
    hcard = _run(_small_job(tag, w0), dev, AddOneTrainer)
    hfolds = kernel.exact_fold_into_tree.launches
    check(hfolds > 0 and kernel.exact_fold_into.launches == 0,
          f"hierarchical job: {hfolds} tree launches, {kernel.exact_fold_into.launches} per leaf")
    hhost = _run(_small_job(tag, w0), "cpu", AddOneTrainer)
    ha, hb = tree_to_numpy(hcard.global_weights()), tree_to_numpy(hhost.global_weights())
    check(all(ha[k].tobytes() == hb[k].tobytes() for k in ha), "hierarchical weights differ")
    check(hcard.channel_bytes == hhost.channel_bytes, "hierarchical channel_bytes differ")
    print(f"phase small jobs: ok classical SGD card-vs-cpu max_abs_err {err:.3g} "
          f"(tree fold launches {folds}); hierarchical add-one byte-equal (tree fold launches "
          f"{hfolds}); "
          f"channel_bytes {hcard.channel_bytes}", flush=True)


class HostNoise:
    """Trainer mixin: adds noise drawn on the host from (dataset, step), the
    same on every device, and reports ``3 + dataset index`` samples; an add
    is exact, so a job of such trainers folds to the same bytes anywhere."""

    def train(self):
        if self.weights is None or self._work_done:
            return
        self._noise_step = getattr(self, "_noise_step", 0) + 1
        ds = self.ctx.worker.dataset
        self.num_samples = 3 + int(ds[1:])
        rng = np.random.default_rng(_seed(ds, self._noise_step) % (1 << 63))
        self.weights = {
            k: v + torch.from_numpy(
                (0.01 * rng.standard_normal(tuple(v.shape))).astype(np.float32)).to(v.device)
            for k, v in self.weights.items()}


def _host_weights(res) -> dict:
    return {wid: tree_to_numpy(p.weights) for wid, p in res.programs.items()
            if getattr(p, "weights", None) is not None}


def _small_topology(dev: torch.device, tag, n: int, rounds: int, trainer=None):
    """One job on the card and on the CPU: (card result, CPU result, the
    card run's launches per kernel)."""
    overrides = {} if trainer is None else {"trainer": trainer}
    out = []
    for device in (dev, "cpu"):
        kernel.reset_launches()
        res = run_job(_small_job(tag, HOST_W0 if trainer else None, n, rounds), device=device,
                      timeout=120, program_overrides=overrides)
        check(not res.errors, f"{tag.name} job errors on {device}: {res.errors}")
        out.append(res)
        if device == dev:
            launches = {fn.__name__: fn.launches for fn in kernel.KERNELS}
    return out[0], out[1], launches


HOST_W0 = {"w": np.full((64, 33), 0.5, np.float32), "b": np.zeros((33,), np.float32)}


def phase_small_topologies(dev: torch.device) -> None:
    """The five templates beyond classical and hierarchical at the sizes of
    tests/test_jobs_e2e.py, on the card and on the CPU: every weight byte-
    equal where the job only folds (host-noise trainers), the vertical job's
    losses and weights within the SGD tolerance (its products round as
    cuBLAS and the CPU's BLAS do)."""
    c4 = {"c0": ("d0", "d1"), "c1": ("d2", "d3")}
    jobs = {
        "distributed": (distributed_fl(), 3, 2, troles.DistributedTrainer),
        "hybrid": (hybrid_fl(groups=("c0", "c1"), dataset_groups=c4), 4, 2, troles.HybridTrainer),
        "coordinated": (coordinated_fl(dataset_groups={"default": ("d0", "d1", "d2", "d3")}), 4, 3,
                        CoordTrainer),
        "gossip": (gossip_fl(backend="inproc"), 4, 3, Trainer),
    }
    report = {}
    for name, (tag, n, rounds, base) in jobs.items():
        trainer = type(f"HostNoise{base.__name__}", (HostNoise, base), {})
        card, host, launches = _small_topology(dev, tag, n, rounds, trainer)
        a, b = _host_weights(card), _host_weights(host)
        check(a.keys() == b.keys() and all(
            a[w][k].tobytes() == b[w][k].tobytes() for w in a for k in a[w]),
            f"{name}: weights on the card differ from the CPU's")
        check(any(not np.array_equal(a[w]["w"], HOST_W0["w"]) for w in a),
              f"{name}: the trainers never moved the weights")
        check(card.channel_bytes == host.channel_bytes, f"{name}: channel_bytes differ")
        report[name] = {k: v for k, v in launches.items() if v}
    check(report["coordinated"].get("exact_fold", 0) > 0,
          "the coordinated job never launched the stacked exact fold")
    check(report["hybrid"].get("exact_fold_into_tree", 0) > 0,
          "the hybrid job's aggregator never launched the tree fold")
    card, host, launches = _small_topology(dev, vertical_fl(), 3, 3)
    losses = [[m["vertical_loss"] for m in r.program("head-0").metrics if "vertical_loss" in m]
              for r in (card, host)]
    check(len(losses[0]) == 3 and losses[0][-1] < losses[0][0], f"vertical losses {losses[0]}")
    check(np.allclose(losses[0], losses[1], rtol=SGD_RTOL, atol=SGD_ATOL),
          f"vertical losses card {losses[0]} vs CPU {losses[1]}")
    a, b = _host_weights(card), _host_weights(host)
    verr = max(float(np.abs(a[w][k] - b[w][k]).max()) for w in a for k in a[w])
    check(all(np.allclose(a[w][k], b[w][k], rtol=SGD_RTOL, atol=SGD_ATOL) for w in a for k in a[w]),
          f"vertical weights card vs CPU differ by {verr}")
    check(card.channel_bytes == host.channel_bytes, "vertical: channel_bytes differ")
    print(f"phase small topologies: ok distributed, hybrid, coordinated, gossip byte-equal card "
          f"vs cpu (kernel launches {json.dumps(report)}); vertical losses "
          f"{[round(x, 6) for x in losses[0]]} max_abs_err {verr:.3g} within rtol {SGD_RTOL} "
          f"atol {SGD_ATOL}", flush=True)


class ScaleAddTrainer(Trainer):
    """``0.75 w + 1``, a multiply and an add: rounds at every step, the
    same on every device."""

    def train(self):
        if self.weights is not None and not self._work_done:
            self.weights = {k: v * 0.75 + 1.0 for k, v in self.weights.items()}


def _policy_small(device, mode: str, d: str = "", rounds: int = 3):
    """The small policy jobs of phase 3 on ``device``: a deadline round with
    a straggler (4 trainers), or a one-trainer FedBuff server with
    ``buffer_size`` 1 checkpointing every version into ``d``."""
    if mode == "deadline":
        job = _small_job(classical_fl(), HOST_W0, 4, rounds)
        policy = RuntimePolicy(mode="deadline", deadline=DEADLINE_S, grace=POLICY_GRACE_S)
        extra = {"per_worker_hyperparams": {STRAGGLER: {"compute_time": STRAGGLER_S}}}
    else:
        job = JobSpec(tag=classical_fl(), datasets=(DatasetSpec(name="d0"),), hyperparams={
            "rounds": rounds, "init_weights": HOST_W0, "checkpoint_every": 1,
            "checkpoint_dir": d})
        policy, extra = RuntimePolicy(mode="async", buffer_size=1, grace=POLICY_GRACE_S), {}
    res = run_job(job, device=device, timeout=300, policy=policy,
                  program_overrides={"trainer": ScaleAddTrainer}, **extra)
    check(not res.errors, f"{mode} job errors on {device}: {res.errors}")
    glob = res.program("global-aggregator-0")
    log = glob.participation_log if mode == "deadline" else glob.staleness_log
    restored = [m for m in glob.metrics if "restored_step" in m]
    return tree_to_numpy(res.global_weights()), log, restored, res.channel_bytes


def phase_small_policies(dev: torch.device) -> None:
    """The deadline and async lowerings at small size, card against CPU: a
    deadline job with a straggler, and a one-trainer async job restarted
    from its checkpoint by a second ``run_job`` (deterministic with one
    trainer and ``buffer_size`` 1): weights, logs and the restored step
    equal, the card's weights byte for byte."""
    out, launches = {}, {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        for name, device in (("card", dev), ("host", "cpu")):
            kernel.reset_launches()
            d = os.path.join(tmp, name)
            out[name] = [_policy_small(device, "deadline"),
                         _policy_small(device, "async", d, 2), _policy_small(device, "async", d, 4)]
            if name == "card":
                launches = {fn.__name__: fn.launches for fn in kernel.KERNELS if fn.launches}
            files = sorted(os.listdir(os.path.join(d, "global-aggregator-0")))
            check(files == [f"ckpt_{v:08d}.npz" for v in range(5)], f"{name} checkpoints {files}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for card, host in zip(out["card"], out["host"]):
        check(card[0].keys() == host[0].keys() and all(
            card[0][k].tobytes() == host[0][k].tobytes() for k in card[0]),
            "policy job: the card's weights differ from the CPU's")
        check(card[1:] == host[1:], "policy job: logs, restored step or bytes differ")
    deadline_log = out["card"][0][1]
    check(all(e["excluded"] == [STRAGGLER] for e in deadline_log), f"deadline log {deadline_log}")
    check(out["card"][2][2] == [{"restored_step": 2}], f"restart {out['card'][2][2]}")
    check(launches.get("exact_fold_into_tree", 0) > 0 and launches.get("exact_divide", 0) > 0,
          f"small policy jobs launched {launches}")
    print(f"phase small policies: ok deadline (straggler excluded every round) and async "
          f"restart (restored_step 2, {len(out['card'][2][1])} absorbed updates) byte-equal card "
          f"vs cpu (kernel launches {json.dumps(launches)})", flush=True)


# ---------------------------------------------------------------------- #
# phase 4
# ---------------------------------------------------------------------- #
def qwen_shapes(layers=None):
    q = dict(QWEN, layers=QWEN["layers"] if layers is None else layers)
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
    check(launches["exact_fold_into_tree"] == N_TRAINERS * ROUNDS and launches["exact_fold_into"] == 0,
          f"fold launches {launches}: not one tree launch per update ({N_TRAINERS * ROUNDS}) "
          "and none per leaf")
    check(launches["exact_divide"] > 0, "main path never launched exact_divide")
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

    # the caching allocator's cudaMalloc calls and retries (frees of cached
    # blocks under pressure) over the replay: each can stall the stream
    before = torch.cuda.memory_stats(dev)
    round_fold_ms = cuda_ms(fold_round, reps=2)
    after = torch.cuda.memory_stats(dev)
    allocator = {k: after.get(k, 0) - before.get(k, 0)
                 for k in ("num_device_alloc", "num_device_free", "num_alloc_retries")}

    def folds_of_round():
        acc = None
        for u, n in updates:
            acc = ops.fold_into(acc, u, n)
        return acc

    folds_ms = cuda_ms(folds_of_round, reps=2)
    host_ms = fold_host_ms(dev, updates)
    w = updates[0][1]
    acc = ops.fold_into(None, updates[1][0], updates[1][1])
    u_leaves, acc_leaves = tree_leaves(updates[0][0]), tree_leaves(acc)
    n = sum(x.numel() for x in u_leaves)
    # the per-leaf entry (off the main path) at full width, against the plain fold
    per_leaf = [kernel.exact_fold_into(a.clone(), x, w) for a, x in zip(acc_leaves, u_leaves)]
    plain = ref.exact_fold_into_tree([a.clone() for a in acc_leaves], u_leaves, w)
    check(all(same_bytes(a, b) for a, b in zip(per_leaf, plain)), "exact_fold_into at full width")
    per_leaf_err = max(float((a - b).abs().max()) for a, b in zip(per_leaf, plain))
    del per_leaf, plain
    den0 = torch.tensor(total, dtype=torch.float32, device=dev)
    fold_ms = in_turns({
        "exact_fold_into_tree": lambda: kernel.exact_fold_into_tree(acc_leaves, u_leaves, w),
        "exact_fold_into": lambda: [kernel.exact_fold_into(a, x, w) for a, x in zip(acc_leaves, u_leaves)],
        "torch.add": lambda: [torch.add(a, x, alpha=w, out=a) for a, x in zip(acc_leaves, u_leaves)],
        "torch._foreach_add_": lambda: torch._foreach_add_(acc_leaves, u_leaves, alpha=w),
        "plain": lambda: ref.exact_fold_into_tree(acc_leaves, u_leaves, w),
    })
    fold_bound = bound(12 * n, 2 * n)
    timings = {
        "exact_fold_into_tree": dict(
            ms=fold_ms["exact_fold_into_tree"], plain_ms=fold_ms["plain"],
            library_ms=fold_ms["torch._foreach_add_"], library_per_leaf_ms=fold_ms["torch.add"],
            bound=fold_bound, max_abs_err=max_err,
        ),
        "exact_fold_into": dict(
            ms=fold_ms["exact_fold_into"], plain_ms=fold_ms["plain"],
            library_ms=fold_ms["torch.add"], bound=fold_bound, max_abs_err=per_leaf_err,
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
    tree_host, leaf_host = host_ms["tree"], host_ms["per_leaf"]
    print(f"phase full width: ok Qwen2.5-3B tree ({n_params} f32 params in {len(_flat_shapes(shapes))} "
          f"leaves, layers 36->4), {N_TRAINERS} trainers, {ROUNDS} rounds byte-equal to the plain "
          f"fold; fold launches {json.dumps(launches)} (one tree launch per update); "
          f"job_s {job_s:.3f} round_wall_s {[round(s, 4) for s in round_s]} "
          f"train_device_ms_per_round {train_ms:.3f} "
          f"fold_device_ms_per_round {round_fold_ms:.3f} ({N_TRAINERS} folds {folds_ms:.3f}, divide "
          f"{round_fold_ms - folds_ms:.3f}; allocator over it {json.dumps(allocator)}) "
          f"device_busy_share_est {(train_ms + round_fold_ms) / 1e3 / np.median(round_s):.3f} "
          f"peak_device_gb {peak_gb:.2f}; one later fold, in turns, ms "
          f"{json.dumps({k: round(v, 4) for k, v in fold_ms.items()})} bound_ms "
          f"{fold_bound[0]:.4f} (12 bytes an element); StreamingMean.fold host ms per call "
          f"through the tree entry {json.dumps(tree_host)}, through {len(_flat_shapes(shapes))} "
          f"per-leaf calls "
          f"{json.dumps(leaf_host)}; channel_bytes {channel_bytes}", flush=True)
    return {"launches": launches, "timings": timings}


# ---------------------------------------------------------------------- #
# phase 4b: coordinated and distributed FL on the same tree
# ---------------------------------------------------------------------- #
class _FullNoise:
    """Trainer mixin: ``noisy`` on the card (phase 4's update) once per
    round; nothing after the last round."""

    def train(self):
        if self.weights is None or self._work_done:
            return
        self._step = getattr(self, "_step", 0) + 1
        self.weights = noisy(self.weights, self.ctx.worker.dataset, self._step)
        self.num_samples = samples_of(self.ctx.worker.dataset)


class CoordNoiseTrainer(_FullNoise, CoordTrainer):
    pass


def _recording_fifo(role, order: list):
    """Wrap ``role``'s down-channel ``recv_fifo`` so each drain records its
    (source, samples) list in fold order; the role's own ``aggregate`` runs."""
    end = role.ctx.end(role.down_channel)
    real = end.recv_fifo

    def recv_fifo(ends, *args, **kwargs):
        msgs = list(real(ends, *args, **kwargs))
        order.append([(src, float(m.get("num_samples", 1))) for src, m in msgs])
        return msgs

    end.recv_fifo = recv_fifo


class _RecordsFolds:
    """Aggregator mixin: ``order`` lists, per fold, its (source, samples)."""

    def aggregate(self):
        if not hasattr(self, "order"):
            self.order = []
            _recording_fifo(self, self.order)
        super().aggregate()


class RecordingCoordAggregator(_RecordsFolds, CoordAggregator):
    pass


class RecordingCoordGlobal(_RecordsFolds, CoordGlobalAggregator):
    """Also keeps every round's global weights."""

    def __init__(self, ctx):
        super().__init__(ctx)
        self.history = [self.weights]

    def aggregate(self):
        super().aggregate()
        if not self._work_done:
            self.history.append(self.weights)


class DistNoiseTrainer(_FullNoise, troles.DistributedTrainer):
    """Keeps trainer-0's consensus weights of every round, and for every
    trainer a digest of its leaves' bits per round."""

    def allreduce(self):
        super().allreduce()
        self.digests = getattr(self, "digests", [])
        self.digests.append([int(x.view(torch.int32).sum(dtype=torch.int64))
                             for x in tree_leaves(self.weights)])
        if self.ctx.worker.worker_id == "trainer-0":
            self.history = getattr(self, "history", []) + [self.weights]


def _stack_rows(trees):
    """One (C, N) stack per leaf of ``trees``; each tree's leaf is dropped as
    soon as it is stacked."""
    rows = [tree_leaves(t) for t in trees]
    stacked = []
    for j in range(len(rows[0])):
        stacked.append(torch.stack([r[j] for r in rows]).reshape(len(rows), -1))
        for r in rows:
            r[j] = None
    return stacked


def _stacked_fold(stacked, samples, dev, fn):
    """``weighted_mean``'s fold of the stacks with ``fn`` (``ref.exact_fold``
    or the kernel): weights float32, denominator the float sum."""
    total = 0.0
    for n in samples:
        total += n
    w = torch.tensor(samples, dtype=torch.float32, device=dev)
    den = torch.tensor([total], dtype=torch.float32, device=dev)
    return [fn(d, w, den) for d in stacked], w, den


HOST_THREADS = 8
HOST_CHUNK = 1 << 22


def host_fold_equal(pool, rows, samples, got) -> bool:
    """Whether ``got`` (float32) is the JAX package's ``_fold_allreduce`` of
    ``rows`` in numpy: ``np.asarray(x, float64) * n`` per row in order, each
    added, then ``(acc / total).astype(float32)``. Elementwise, so it runs in
    chunks on ``pool``'s threads (numpy releases the GIL) with the same
    operations on every element."""
    total = 0.0
    for nn in samples:
        total += nn

    def chunk(lo):
        hi = min(lo + HOST_CHUNK, got.size)
        acc = rows[0][lo:hi].astype(np.float64)
        acc *= samples[0]
        for x, nn in zip(rows[1:], samples[1:]):
            scaled = x[lo:hi].astype(np.float64)
            scaled *= nn
            acc += scaled
        acc /= total
        return np.array_equal(acc.astype(np.float32).view(np.uint32), got[lo:hi].view(np.uint32))

    return all(pool.map(chunk, range(0, got.size, HOST_CHUNK)))


def phase_full_width_topologies(dev: torch.device) -> dict:
    shapes = qwen_shapes()
    n_leaves = len(_flat_shapes(shapes))
    gen = torch.Generator(device=dev).manual_seed(0)
    init = _map_shapes(lambda s: 0.02 * torch.randn(s, generator=gen, device=dev), shapes)
    n = sum(x.numel() for x in tree_leaves(init))
    check(n == QWEN_PARAMS, f"tree has {n} parameters, not {QWEN_PARAMS}")

    # ---- coordinated: 2 aggregator replicas, stacked exact folds ---- #
    datasets = tuple(f"d{i}" for i in range(COORD_TRAINERS))
    job = JobSpec(
        tag=coordinated_fl(aggregator_replicas=COORD_AGGS, dataset_groups={"default": datasets}),
        datasets=tuple(DatasetSpec(name=d) for d in datasets),
        hyperparams={"rounds": COORD_ROUNDS, "init_weights": init},
    )
    del init
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernel.reset_launches()
    t0 = time.perf_counter()
    res = run_job(job, device=dev, timeout=900, program_overrides={
        "trainer": CoordNoiseTrainer, "aggregator": RecordingCoordAggregator,
        "global-aggregator": RecordingCoordGlobal})
    torch.cuda.synchronize()
    coord_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernel.KERNELS}
    coord_peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    check(not res.errors, f"coordinated job errors: {res.errors}")
    root = res.program("global-aggregator-0")
    aggs = {wid: p for wid, p in res.programs.items() if isinstance(p, RecordingCoordAggregator)}
    ds_of = {w.worker_id: w.dataset for w in res.workers}
    decisions = res.program("coordinator-0").decisions
    history, g_order = root.history, root.order
    a_order = {wid: list(getattr(p, "order", [])) for wid, p in aggs.items()}
    check(len(history) == COORD_ROUNDS + 1 and len(g_order) == COORD_ROUNDS,
          f"{len(history) - 1} coordinated rounds recorded, not {COORD_ROUNDS}")
    # one stacked fold per leaf for each aggregator that folded in a round,
    # and for the global aggregator every round
    folds_per_round = [len(d["active"]) + 1 for d in decisions]
    want = sum(folds_per_round) * n_leaves
    check(sum(len(o) for o in a_order.values()) + len(g_order) == sum(folds_per_round),
          f"recorded folds {a_order} {g_order} vs active aggregators {folds_per_round}")
    check(launches["exact_fold"] == want,
          f"exact_fold launches {launches['exact_fold']}, not (aggregators + global) x leaves x "
          f"rounds = {folds_per_round} x {n_leaves} = {want}")
    check(launches["exact_fold_into_tree"] == 0, "the coordinated job ran the streaming fold")
    del res, root, aggs, job
    gc.collect()
    torch.cuda.empty_cache()

    # every round: regenerate each aggregator's updates in the order it
    # folded them, fold with the plain stacked fold, then the aggregators'
    # means in the global's order; the job's weights must be those bytes
    replay_s = time.perf_counter()
    max_err, fold_ms, mv_ms, plain_ms, stack_c = 0.0, [], [], [], []
    for rnd in range(1, COORD_ROUNDS + 1):
        base, means = history[rnd - 1], {}
        for wid, order in a_order.items():
            if len(order) < rnd:
                continue
            srcs = order[rnd - 1]
            stacked = _stack_rows([noisy(base, ds_of[src], rnd) for src, _ in srcs])
            samples = [nn for _, nn in srcs]
            plain, w, den = _stacked_fold(stacked, samples, dev, ref.exact_fold)
            means[wid] = (plain, float(sum(samples)))
            if rnd == COORD_ROUNDS:  # the kernel against its plain version, and timed
                got, _, _ = _stacked_fold(stacked, samples, dev, kernel.exact_fold)
                check(all(same_bytes(g, p) for g, p in zip(got, plain)), "exact_fold at C = 4")
                del got
                w_over_den = w / den
                fold_ms.append(cuda_ms(lambda: [kernel.exact_fold(d, w, den) for d in stacked]))
                mv_ms.append(cuda_ms(lambda: [torch.mv(d.t(), w_over_den) for d in stacked]))
                plain_ms.append(cuda_ms(lambda: [ref.exact_fold(d, w, den) for d in stacked], reps=2))
                stack_c.append(len(srcs))
            del stacked
        srcs = g_order[rnd - 1]
        check(sorted(s for s, _ in srcs) == sorted(means),
              f"round {rnd}: global folded {srcs}, aggregators {sorted(means)}")
        check(all(nn == float(int(means[s][1])) for s, nn in srcs), f"round {rnd}: samples")
        stacked = _stack_rows([means.pop(s)[0] for s, _ in srcs])
        glob, w, den = _stacked_fold(stacked, [nn for _, nn in srcs], dev, ref.exact_fold)
        if rnd == COORD_ROUNDS:
            fold_ms.append(cuda_ms(lambda: [kernel.exact_fold(d, w, den) for d in stacked]))
            w_over_den = w / den
            mv_ms.append(cuda_ms(lambda: [torch.mv(d.t(), w_over_den) for d in stacked]))
            plain_ms.append(cuda_ms(lambda: [ref.exact_fold(d, w, den) for d in stacked], reps=2))
            stack_c.append(len(srcs))
        del stacked
        for g, want_leaf in zip(tree_leaves(history[rnd]), glob):
            check(bool(torch.isfinite(g).all()), f"coordinated round {rnd}: non-finite weights")
            check(same_bytes(g.reshape(-1), want_leaf),
                  f"coordinated round {rnd}: global weights differ from the plain stacked fold")
            max_err = max(max_err, float((g.reshape(-1) - want_leaf).abs().max()))
        del glob
    del history
    gc.collect()
    torch.cuda.empty_cache()
    replay_s = time.perf_counter() - replay_s
    # each stack read once and the mean written: (4 C + 4) bytes an element
    bounds = [bound((4 * c + 4) * n, 2 * c * n) for c in stack_c]
    agg_bound = bounds[0]
    timings = {"exact_fold": dict(
        ms=fold_ms[0], plain_ms=plain_ms[0], library_ms=mv_ms[0], bound=agg_bound,
        max_abs_err=max_err)}

    # ---- distributed: the float64 ring fold ---- #
    gen = torch.Generator(device=dev).manual_seed(0)
    init = _map_shapes(lambda s: 0.02 * torch.randn(s, generator=gen, device=dev),
                       qwen_shapes(DIST_LAYERS))
    ring_n = sum(x.numel() for x in tree_leaves(init))
    job = JobSpec(
        tag=distributed_fl(),
        datasets=tuple(DatasetSpec(name=f"d{i}") for i in range(DIST_TRAINERS)),
        hyperparams={"rounds": DIST_ROUNDS, "init_weights": init},
    )
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernel.reset_launches()
    t0 = time.perf_counter()
    res = run_job(job, device=dev, timeout=900, program_overrides={"trainer": DistNoiseTrainer})
    torch.cuda.synchronize()
    dist_s = time.perf_counter() - t0
    dist_peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    check(not res.errors, f"distributed job errors: {res.errors}")
    dist_launches = {k: v for k, v in ((fn.__name__, fn.launches) for fn in kernel.KERNELS) if v}
    check(not dist_launches, f"the float64 ring fold launched {dist_launches}")
    progs = sorted(res.programs.items())
    ds_of = {w.worker_id: w.dataset for w in res.workers}
    first = tree_leaves(progs[0][1].weights)
    for wid, p in progs[1:]:
        check(p.digests == progs[0][1].digests, f"{wid}: per-round digests differ from trainer-0's")
        check(all(same_bytes(a, b) for a, b in zip(tree_leaves(p.weights), first)),
              f"{wid}: consensus weights differ from trainer-0's")
    d_history = [init] + progs[0][1].history
    ids = [wid for wid, _ in progs]
    del res, progs, first, job, init
    gc.collect()
    torch.cuda.empty_cache()
    # the host's float64 fold of the same updates, leaf by leaf
    host_s = time.perf_counter()
    with ThreadPoolExecutor(HOST_THREADS) as pool:
        for rnd in range(1, DIST_ROUNDS + 1):
            updates = [tree_leaves(noisy(d_history[rnd - 1], ds_of[wid], rnd)) for wid in ids]
            samples = [float(samples_of(ds_of[wid])) for wid in ids]
            for j, got in enumerate(tree_leaves(d_history[rnd])):
                rows = [leaves[j].cpu().numpy().reshape(-1) for leaves in updates]
                check(host_fold_equal(pool, rows, samples, got.cpu().numpy().reshape(-1)),
                      f"distributed round {rnd}, leaf {j}: differs from the host's float64 fold")
                del rows
            del updates
    host_s = time.perf_counter() - host_s
    del d_history
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase full-width topologies: ok Qwen2.5-3B tree ({n} f32 params in {n_leaves} "
          f"leaves); coordinated_fl {COORD_TRAINERS} trainers, {COORD_AGGS} aggregators, "
          f"{COORD_ROUNDS} rounds byte-equal to the plain stacked fold every round; exact_fold "
          f"launches {launches['exact_fold']} = (active aggregators + global) {folds_per_round} x "
          f"{n_leaves} leaves, exact_fold_into_tree {launches['exact_fold_into_tree']}; job_s "
          f"{coord_s:.3f} peak_device_gb {coord_peak_gb:.2f} (replay and timing {replay_s:.1f} s); "
          f"stacked folds of one round, ms "
          f"(C = {stack_c}) {[round(t, 4) for t in fold_ms]} sum {sum(fold_ms):.4f}, bound_ms "
          f"{[round(b[0], 4) for b in bounds]} ({bounds[0][1]} at 3.35 TB/s), torch.mv ms "
          f"{[round(t, 4) for t in mv_ms]}, plain ms "
          f"{[round(t, 4) for t in plain_ms]}; distributed_fl {DIST_TRAINERS} trainers, "
          f"{DIST_ROUNDS} rounds on the tree at {DIST_LAYERS} layers ({ring_n} params): consensus byte-equal across trainers and to the host's float64 "
          f"fold (host check {host_s:.1f} s); job_s {dist_s:.3f} peak_device_gb "
          f"{dist_peak_gb:.2f}", flush=True)
    return {"launches": {"exact_fold": launches["exact_fold"]}, "timings": timings}


# ---------------------------------------------------------------------- #
# phase 4c: the deadline and async policies on the same tree
# ---------------------------------------------------------------------- #
class PolicyNoiseTrainer(_FullNoise, Trainer):
    """``noisy`` of its step (1, 2, ...) on the card; records the server
    version each step trained from, so a replay regenerates each update."""

    def train(self):
        if self.weights is not None and not self._work_done:
            self.trained_from = getattr(self, "trained_from", []) + [self._server_version]
        super().train()


class RecordingPolicyRoot(GlobalAggregator):
    """Lowered to the deadline or async root by the runtime; ``evaluate``
    runs after every round (deadline) or new version (async) and keeps the
    weights."""

    def __init__(self, ctx):
        super().__init__(ctx)
        self.history = [self.weights]

    def evaluate(self):
        self.history.append(self.weights)


def _policy_job(dev, init, policy, per_worker):
    datasets = tuple(DatasetSpec(name=f"d{i}") for i in range(POLICY_TRAINERS))
    job = JobSpec(tag=classical_fl(), datasets=datasets,
                  hyperparams={"rounds": POLICY_ROUNDS, "init_weights": init})
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernel.reset_launches()
    t0 = time.perf_counter()
    res = run_job(job, device=dev, timeout=900, policy=policy, per_worker_hyperparams=per_worker,
                  program_overrides={"trainer": PolicyNoiseTrainer,
                                     "global-aggregator": RecordingPolicyRoot})
    torch.cuda.synchronize()
    job_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernel.KERNELS}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    check(not res.errors, f"{policy.mode} job errors: {res.errors}")
    return res, launches, job_s, peak_gb


def _host_weight(staleness: int) -> float:
    """FedBuff's staleness weight, float32 ``1 / pow(1 + s, 0.5)`` on the
    host with torch's CPU ops (as the JAX package's XLA gives it)."""
    s = torch.tensor(float(staleness), dtype=torch.float32)
    return float(torch.ones((), dtype=torch.float32) / torch.pow(1.0 + s, 0.5))


def phase_full_width_policies(dev: torch.device) -> dict:
    """(a) a deadline job, (b) a FedBuff job, (c) ``accumulate_batch``
    against ``accumulate_stream`` and (d) a checkpoint round trip, all on
    phase 4's tree; each held byte for byte to its plain version."""
    shapes = qwen_shapes()
    n_leaves = len(_flat_shapes(shapes))
    gen = torch.Generator(device=dev).manual_seed(0)
    init = _map_shapes(lambda s: 0.02 * torch.randn(s, generator=gen, device=dev), shapes)
    n = sum(x.numel() for x in tree_leaves(init))
    check(n == QWEN_PARAMS, f"tree has {n} parameters, not {QWEN_PARAMS}")
    report, launches = {}, {}

    # ---- (a) deadline: the straggler cut every round ---- #
    waits = []
    real_collect = roles_async._PolicyBase._collect_deadline

    def timed_collect(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = real_collect(self, *args, **kwargs)
        waits.append(time.perf_counter() - t0)
        return out

    roles_async._PolicyBase._collect_deadline = timed_collect
    try:
        res, got, job_s, peak_gb = _policy_job(
            dev, init, RuntimePolicy(mode="deadline", deadline=DEADLINE_S, grace=POLICY_GRACE_S),
            {STRAGGLER: {"compute_time": STRAGGLER_S}})
    finally:
        roles_async._PolicyBase._collect_deadline = real_collect
    root = res.program("global-aggregator-0")
    log, history = root.participation_log, root.history
    ds_of = {w.worker_id: w.dataset for w in res.workers}
    on_time = POLICY_TRAINERS - 1
    check(len(log) == POLICY_ROUNDS and len(history) == POLICY_ROUNDS + 1,
          f"{len(log)} deadline rounds logged, {len(history) - 1} recorded")
    for e in log:
        check(e["excluded"] == [STRAGGLER] and not e["missing"] and len(e["included"]) == on_time
              and STRAGGLER not in e["included"], f"deadline round {e}")
    check(max(waits) < POLICY_GRACE_S / 2, f"a round's collection waited {max(waits):.1f} s")
    want = {"exact_fold_into_tree": on_time * POLICY_ROUNDS,
            "exact_divide": n_leaves * POLICY_ROUNDS}
    check(all(got[k] == v for k, v in want.items()) and got["exact_fold_into"] == 0
          and got["exact_fold"] == 0,
          f"deadline launches {got}, not {on_time} tree folds and {n_leaves} divides a round")
    launches["deadline"] = {k: v for k, v in got.items() if v}
    del res, root
    gc.collect()
    max_err = 0.0
    for rnd in range(1, POLICY_ROUNDS + 1):
        acc, total = None, 0.0
        for wid in log[rnd - 1]["included"]:  # sorted: the fold's order
            update = noisy(history[rnd - 1], ds_of[wid], rnd)
            nn = float(samples_of(ds_of[wid]))
            total += nn
            acc = tree_map(lambda x: ref.exact_fold_into(None, x, nn), update) if acc is None \
                else tree_map(lambda a, x: ref.exact_fold_into(a, x, nn), acc, update)
            del update
        mean = tree_leaves(tree_map(lambda x: ref.exact_divide(x, total), acc))
        for g, w in zip(tree_leaves(history[rnd]), mean):
            check(bool(torch.isfinite(g).all()), f"deadline round {rnd}: non-finite weights")
            check(same_bytes(g, w), f"deadline round {rnd}: weights differ from the plain fold")
            max_err = max(max_err, float((g - w).abs().max()))
        del acc, mean
    # a round's fold on the card alone: StreamingMean over the 7 on-time
    # updates (one regenerated update stands for each), then its divide;
    # and an async absorb: the delta against its base, then one tree fold
    update = noisy(history[-2], ds_of[log[-1]["included"][0]], POLICY_ROUNDS)
    nn = float(samples_of(ds_of[log[-1]["included"][0]]))

    def deadline_fold():
        mean = troles.StreamingMean(device=dev)
        for _ in range(on_time):
            mean.fold(update, nn)
        return mean.finalize()

    fedbuff = get_strategy("fedbuff", buffer_size=ASYNC_BUFFER)
    state = fedbuff.init(update)

    def absorb():
        fedbuff.accumulate_stream(state, tree_map(torch.sub, update, history[-2]), 1)

    fold_ms, absorb_ms = cuda_ms(deadline_fold, reps=2), cuda_ms(absorb, reps=3)
    report["deadline"] = dict(job_s=job_s, peak_gb=peak_gb, waits=waits, fold_ms=fold_ms,
                              absorb_ms=absorb_ms, round_times=[e["round_time"] for e in log])
    del history, update, state
    gc.collect()

    # ---- (b) async FedBuff: the replay of the staleness log ---- #
    stagger = {f"trainer-{i}": {"compute_time": 0.5 + 0.25 * i} for i in range(POLICY_TRAINERS)}
    res, got, job_s, peak_gb = _policy_job(
        dev, init, RuntimePolicy(mode="async", buffer_size=ASYNC_BUFFER, grace=POLICY_GRACE_S),
        stagger)
    root = res.program("global-aggregator-0")
    slog, history = list(root.staleness_log), root.history
    snaps = len(root._snapshots)
    snap_gb = snaps * 4 * n / 1e9
    trained = {wid: list(getattr(p, "trained_from", [])) for wid, p in res.programs.items()
               if wid.startswith("trainer")}
    ds_of = {w.worker_id: w.dataset for w in res.workers}
    check(root._version == POLICY_ROUNDS and len(history) == POLICY_ROUNDS + 1,
          f"async server at version {root._version}, {len(history) - 1} versions recorded")
    check(len(slog) == ASYNC_BUFFER * POLICY_ROUNDS, f"{len(slog)} updates absorbed")
    check(got["exact_fold_into_tree"] == len(slog) and got["exact_fold"] == 0
          and got["exact_fold_into"] == 0,
          f"async launches {got}: not one tree fold per absorbed update ({len(slog)})")
    launches["async"] = {k: v for k, v in got.items() if v}
    del res, root
    gc.collect()
    steps = {wid: 0 for wid in trained}
    acc, count, version, stale = None, 0, 0, []
    for e in slog:
        src = e["src"]
        step = steps[src]
        steps[src] += 1
        trained_from = trained[src][step]
        check(e["version"] == version and not e.get("clamped")
              and e["version"] - e["staleness"] == trained_from, f"staleness entry {e}")
        stale.append(e["staleness"])
        update = noisy(history[trained_from], ds_of[src], step + 1)
        delta = tree_map(torch.sub, update, history[trained_from])
        del update
        w = _host_weight(e["staleness"])
        if acc is None:
            acc = tree_map(torch.zeros_like, delta)
        acc = tree_map(lambda a, x: ref.exact_fold_into(a, x, w), acc, delta)
        del delta
        count += 1
        if count == ASYNC_BUFFER:
            den = torch.tensor(float(count), dtype=torch.float32, device=dev)
            new = tree_map(lambda p, a: p + 1.0 * a / den, history[version], acc)
            version += 1
            for g, w_ in zip(tree_leaves(history[version]), tree_leaves(new)):
                check(bool(torch.isfinite(g).all()), f"async version {version}: non-finite")
                check(same_bytes(g, w_), f"async version {version}: weights differ from the replay")
                max_err = max(max_err, float((g - w_).abs().max()))
            acc, count = None, 0
            del new
    check(version == POLICY_ROUNDS, f"replay reached version {version}")
    report["async"] = dict(job_s=job_s, peak_gb=peak_gb, snapshots=snaps, snapshot_gb=snap_gb,
                           staleness=stale)
    final = history[-1]
    del history, init
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (c) accumulate_batch against accumulate_stream, C = 8 ---- #
    strategy = get_strategy("fedbuff", buffer_size=len(BATCH_STALENESS))
    deltas = [_map_shapes(lambda s: 0.01 * torch.randn(s, generator=gen, device=dev), shapes)
              for _ in BATCH_STALENESS]
    for d in deltas:  # a -0.0 column: the zeros-start accumulator makes it +0.0
        tree_leaves(d)[0].view(-1)[:8] = -0.0
    kernel.reset_launches()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    stream = strategy.init(final)
    for d, st in zip(deltas, BATCH_STALENESS):
        stream = strategy.accumulate_stream(stream, d, st)
    end.record()
    torch.cuda.synchronize()
    stream_ms = start.elapsed_time(end)
    stream_launches = kernel.exact_fold_into_tree.launches
    start.record()
    batch = strategy.accumulate_batch(strategy.init(final), deltas, list(BATCH_STALENESS))
    end.record()
    torch.cuda.synchronize()
    batch_ms = start.elapsed_time(end)
    got = {fn.__name__: fn.launches for fn in kernel.KERNELS}
    check(stream_launches == len(BATCH_STALENESS) and got["exact_fold"] == n_leaves
          and got["exact_fold_into_tree"] == len(BATCH_STALENESS),
          f"batch/stream launches {got}: not {len(BATCH_STALENESS)} tree folds and "
          f"{n_leaves} stacked folds")
    launches["batch"] = {k: v for k, v in got.items() if v}
    check(int(stream["count"]) == int(batch["count"]) == len(BATCH_STALENESS), "counts")
    for a, b in zip(tree_leaves(stream["acc"]), tree_leaves(batch["acc"])):
        check(same_bytes(a, b), "accumulate_batch differs from accumulate_stream")
    check(not bool(torch.signbit(tree_leaves(batch["acc"])[0].view(-1)[:8]).any()),
          "accumulate_batch kept -0.0")
    del batch
    plain = tree_map(torch.zeros_like, final)
    for d, st in zip(deltas, BATCH_STALENESS):
        w = _host_weight(st)
        plain = tree_map(lambda a, x: ref.exact_fold_into(a, x, w), plain, d)
    for a, b in zip(tree_leaves(stream["acc"]), tree_leaves(plain)):
        check(same_bytes(a, b), "accumulate_stream differs from the plain chain")
    report["batch"] = dict(stream_ms=stream_ms, batch_ms=batch_ms)
    del deltas, stream, plain
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (d) checkpoint round trip of the global weights ---- #
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = checkpoint.save(tmp, POLICY_ROUNDS, final)
        save_ms = (time.perf_counter() - t0) * 1e3
        file_bytes = os.path.getsize(path)
        t0 = time.perf_counter()
        back = checkpoint.restore(tmp, POLICY_ROUNDS, final, strict=True, device=dev)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for a, b in zip(tree_leaves(back), tree_leaves(final)):
        check(a.device == dev and same_bytes(a, b), "checkpoint round trip differs")
    report["checkpoint"] = dict(save_ms=save_ms, restore_ms=restore_ms, file_bytes=file_bytes)
    del back, final
    gc.collect()
    torch.cuda.empty_cache()

    dl, asy, bt, ck = report["deadline"], report["async"], report["batch"], report["checkpoint"]
    print(f"phase full-width policies: ok Qwen2.5-3B tree ({n} f32 params in {n_leaves} leaves); "
          f"(a) deadline {POLICY_TRAINERS} trainers, {POLICY_ROUNDS} rounds, {STRAGGLER} past the "
          f"{DEADLINE_S} s deadline and excluded every round, byte-equal to the plain fold; "
          f"launches {json.dumps(launches['deadline'])}; job_s {dl['job_s']:.3f} collection wait s "
          f"{[round(t, 3) for t in dl['waits']]} (grace {POLICY_GRACE_S} s) virtual round_time "
          f"{dl['round_times']} peak_device_gb {dl['peak_gb']:.2f} round fold device ms "
          f"{dl['fold_ms']:.3f} ({on_time} tree folds and the divide); (b) FedBuff buffer "
          f"{ASYNC_BUFFER}, {POLICY_ROUNDS} versions, {len(slog)} updates at staleness "
          f"{asy['staleness']} byte-equal to the replay; launches {json.dumps(launches['async'])}; "
          f"job_s {asy['job_s']:.3f} absorb device ms {dl['absorb_ms']:.3f} (delta and tree "
          f"fold) snapshots {asy['snapshots']} ({asy['snapshot_gb']:.2f} GB) "
          f"peak_device_gb {asy['peak_gb']:.2f}; (c) accumulate_batch == accumulate_stream == "
          f"plain, C = {len(BATCH_STALENESS)} at staleness {list(BATCH_STALENESS)}; launches "
          f"{json.dumps(launches['batch'])}; stream ms {bt['stream_ms']:.3f} batch ms (stack "
          f"included) {bt['batch_ms']:.3f}; (d) checkpoint save ms {ck['save_ms']:.1f} restore "
          f"ms {ck['restore_ms']:.1f} file bytes {ck['file_bytes']}, byte-equal on the card",
          flush=True)
    total = {}
    for path_launches in launches.values():
        for k, v in path_launches.items():
            total[k] = total.get(k, 0) + v
    return {"launches": total, "by_job": launches, "max_abs_err": max_err}


def in_turns(fns: dict, rounds: int = 5) -> dict:
    """Median device ms of each of ``fns`` over ``rounds`` rounds that take
    them in turns (in order, then in reverse order), 10 runs a turn."""
    names = list(fns)
    times = {name: [] for name in names}
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            times[name].append(cuda_ms(fns[name], reps=10))
    return {name: float(np.median(t)) for name, t in times.items()}


def fold_host_ms(dev: torch.device, updates) -> dict:
    """Host ms of ``StreamingMean.fold`` over a round's updates, the card
    synchronized before each call and not inside it: through the tree entry
    (``ops.fold_into``, as the job folds) and through one per-leaf wrapper
    call per leaf (the fold before the tree entry), in turns, twice. Gives
    the first call (it allocates the accumulator) and the median of the
    later ones."""
    def per_leaf(acc, tree, w):
        if acc is None:
            return tree_map(lambda x: kernel.exact_fold_into(None, x, w), tree)
        return tree_map(lambda a, x: kernel.exact_fold_into(a, x, w), acc, tree)

    calls = {"tree": [], "per_leaf": []}
    firsts = {"tree": [], "per_leaf": []}
    try:
        for _ in range(2):
            for name, fold in (("tree", ops.fold_into), ("per_leaf", per_leaf)):
                troles.fold_into = fold
                mean = troles.StreamingMean(device=dev)
                for i, (u, n) in enumerate(updates):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    mean.fold(u, n)
                    (firsts if i == 0 else calls)[name].append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize()
                del mean
    finally:
        troles.fold_into = ops.fold_into
    return {name: {"first": [round(t, 4) for t in firsts[name]],
                   "later_median": round(float(np.median(calls[name])), 4)} for name in calls}


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
    round_digests = [tree_digest(h) for h in history[1:]]  # phase 7's reference
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
    check(launches["exact_fold_into_tree"] == R * T and launches["exact_fold_into"] == 0,
          f"codec job fold launches {launches['exact_fold_into_tree']} tree, "
          f"{launches['exact_fold_into']} per leaf: not one tree launch per update ({R * T})")
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
    return {"launches": launches, "timings": timings, "round_digests": round_digests}


# ---------------------------------------------------------------------- #
# phase 7: the process plane
# ---------------------------------------------------------------------- #
def tree_digest(tree) -> str:
    """sha256 over a tree's leaves (shape, dtype and bytes, in tree order),
    hashed leaf by leaf on the host in threads: a byte-equality check that
    crosses process boundaries without carrying the tree."""
    leaves = tree_leaves(tree)
    hosts = [x.detach().contiguous().cpu().numpy() for x in leaves]
    with ThreadPoolExecutor(HOST_THREADS) as pool:
        parts = list(pool.map(lambda a: hashlib.sha256(memoryview(a).cast("B")).digest(), hosts))
    h = hashlib.sha256()
    for x, part in zip(leaves, parts):
        h.update(f"{tuple(x.shape)}{x.dtype}".encode())
        h.update(part)
    return h.hexdigest()


def codec_init(dev):
    """Phase 5's initial weights, drawn from the seed-0 generator on ``dev``:
    the same bytes in any process on the card."""
    gen = torch.Generator(device=dev).manual_seed(0)
    return _map_shapes(lambda s: 0.02 * torch.randn(s, generator=gen, device=dev), qwen_shapes())


class ProcNoiseTrainer(NoiseTrainer):
    """Phase 5's trainer; its final weights stay in its own process (each
    would carry 2.48 GB back to the driver for nothing)."""

    def run(self):
        super().run()
        self.weights = None


class ProcRecordingAggregator(GlobalAggregator):
    """Phase 5's root, which draws phase 5's initial weights itself (the job
    carries none to its processes) and records each round's wall time and
    weight digest in its metrics, which cross back to the driver."""

    def __init__(self, ctx):
        super().__init__(ctx)
        self.weights = codec_init(ctx.device)
        self._t0 = 0.0

    def distribute(self):
        torch.cuda.synchronize(self.ctx.device)
        self._t0 = time.perf_counter()
        if not any("first_distribute_unix" in m for m in self.metrics):
            self.metrics.append({"first_distribute_unix": time.time()})
        super().distribute()

    def aggregate(self):
        super().aggregate()
        if not self._work_done:
            torch.cuda.synchronize(self.ctx.device)
            round_s = time.perf_counter() - self._t0
            self.metrics.append({"round_s": round_s, "digest": tree_digest(self.weights)})


class HostNoiseTrainer(HostNoise, Trainer):
    pass


class HostNoiseCoord(HostNoise, CoordTrainer):
    pass


class _HubProbe:
    """Times the hub's reduce plane in this process while a job runs: host
    seconds inside ``InprocBackend._reduce_ingest`` (which runs under the
    backend's lock) and, with CUDA events around each ``fold_into`` of a
    hub ``StreamingMean``, the fold's device ms."""

    def __enter__(self):
        self.lock_s, self.events = [], []
        self._ingest, self._fold = InprocBackend._reduce_ingest, troles.fold_into
        ingest, fold = self._ingest, self._fold

        def timed_ingest(backend, *args):
            t0 = time.perf_counter()
            try:
                return ingest(backend, *args)
            finally:
                self.lock_s.append(time.perf_counter() - t0)

        def timed_fold(acc, tree, w):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fold(acc, tree, w)
            end.record()
            self.events.append((start, end))
            return out

        InprocBackend._reduce_ingest, troles.fold_into = timed_ingest, timed_fold
        return self

    def __exit__(self, *exc):
        InprocBackend._reduce_ingest, troles.fold_into = self._ingest, self._fold
        torch.cuda.synchronize()
        self.fold_ms = [s.elapsed_time(e) for s, e in self.events]


def _proc_launches(launches: dict, programs) -> dict:
    """The driver's (hub's) launch counts plus every child's."""
    out = dict(launches)
    for p in programs:
        for name, n in p.launches.items():
            out[name] = out.get(name, 0) + n
    return out


def _small_obs(res) -> dict:
    glob = res.program("global-aggregator-0")
    return {
        "weights": {w: {k: v.tobytes() for k, v in ws.items()} for w, ws in _host_weights(res).items()},
        "participation": getattr(glob, "participation_log", None) or None,
        "events": res.events, "dropped": res.dropped, "channel_bytes": res.channel_bytes,
    }


def phase_process_plane(dev: torch.device, codec: dict) -> dict:
    """(a) phase 5's job as a process tree with the hub folding on the card;
    (b) a pooled, sharded deadline job with a dropout and a re-join, and a
    coordinated sync job, over processes."""
    T, R = CODEC_TRAINERS, CODEC_ROUNDS
    n_leaves = len(_flat_shapes(qwen_shapes()))
    job = JobSpec(tag=codec_tag(),
                  datasets=tuple(DatasetSpec(name=f"d{i}") for i in range(T)),
                  hyperparams={"rounds": R, "reduce_plan": 1})
    overrides = {"trainer": ProcNoiseTrainer, "global-aggregator": ProcRecordingAggregator}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernel.reset_launches()
    qkernel.reset_launches()
    t_launch, t0 = time.time(), time.perf_counter()
    with _HubProbe() as probe:
        res = run_job_multiproc(job, device=dev, timeout=600, program_overrides=overrides)
    job_s = time.perf_counter() - t0
    hub = {fn.__name__: fn.launches for fn in qkernel.KERNELS + kernel.KERNELS}
    driver_peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    check(not res.errors, f"process job errors: {res.errors}")
    root = res.program("global-aggregator-0")
    trainers = [res.program(f"trainer-{i}") for i in range(T)]
    rounds = [m for m in root.metrics if "digest" in m]
    check(len(rounds) == R, f"{len(rounds)} rounds recorded")
    startup_s = next(m["first_distribute_unix"] for m in root.metrics
                     if "first_distribute_unix" in m) - t_launch
    # the hub folds every upload (R x T, one tree launch each: 50 leaves fit
    # one table) after decoding it (one dequantize each), and encodes nothing
    check(hub["exact_fold_into_tree"] == R * T and hub["dequantize_blocks"] == R * T
          and hub["exact_fold_into"] == 0 and hub["quantize_blocks"] == 0,
          f"hub launches {hub} != {R * T} tree folds and dequantizes")
    check(len(probe.fold_ms) == R * T, f"{len(probe.fold_ms)} hub folds timed")
    # the root encodes R + 1 broadcasts, folds one partial a round and
    # divides every leaf; each trainer decodes R + 1 broadcasts, encodes R
    want_root = {"quantize_blocks": R + 1, "dequantize_blocks": 0, "exact_fold_into_tree": R,
                 "exact_divide": R * n_leaves}
    check(all(root.launches[k] == v for k, v in want_root.items()),
          f"root launches {root.launches} != {want_root}")
    for t in trainers:
        check(t.launches["dequantize_blocks"] == R + 1 and t.launches["quantize_blocks"] == R
              and t.launches["exact_fold_into_tree"] == 0, f"{t.worker_id} launches {t.launches}")
    stats = res.channel_stats["param-channel"]
    check(stats.get("hub_reduced") == R * T and stats.get("hub_partials") == R,
          f"hub reduce stats {stats}")
    digests = [m["digest"] for m in rounds]
    check(digests == codec["round_digests"],
          "process job's rounds differ from phase 5's unreduced rounds")
    final = res.global_weights()
    check(all(x.device == dev for x in tree_leaves(final)), "global weights not on the card")
    proc_bytes = res.channel_bytes["param-channel"]
    children = {p.worker_id: {"launches": {k: v for k, v in p.launches.items() if v},
                              "peak_gb": round(p.peak_device_bytes / 1e9, 3)}
                for p in [root, *trainers]}
    launches = _proc_launches(hub, [root, *trainers])
    del res, root, trainers
    gc.collect()

    # the comparator: the same job through run_job, its param channel on the
    # socket loopback at the same plan (the loopback's hub folds here too)
    kernel.reset_launches()
    qkernel.reset_launches()
    t0 = time.perf_counter()
    cmp = run_job(job, device=dev, timeout=600, program_overrides=overrides)
    cmp_s = time.perf_counter() - t0
    check(not cmp.errors, f"loopback comparator errors: {cmp.errors}")
    croot = cmp.program("global-aggregator-0")
    check([m["digest"] for m in croot.metrics if "digest" in m] == digests,
          "process job's rounds differ from the loopback comparator's")
    check(all(same_bytes(a, b) for a, b in zip(tree_leaves(final), tree_leaves(croot.weights))),
          "process job's global weights differ from the loopback comparator's")
    check(cmp.channel_bytes["param-channel"] == proc_bytes,
          f"channel_bytes {proc_bytes} != loopback {cmp.channel_bytes['param-channel']}")
    cmp_round_s = [m["round_s"] for m in croot.metrics if "round_s" in m]
    del cmp, croot, final
    gc.collect()
    torch.cuda.empty_cache()

    # (b) small jobs over processes against run_job on the card
    # (b) two small jobs over processes at once (their start-ups overlap),
    # then each through run_job on the card; only the H-FL job's shard hubs
    # fold in this process while they run
    hier = JobSpec(
        tag=hierarchical_fl(groups=("west", "east"),
                            dataset_groups={"west": ("d0", "d1"), "east": ("d2", "d3")}),
        datasets=tuple(DatasetSpec(name=f"d{i}") for i in range(4)),
        hyperparams={"rounds": 3, "init_weights": HOST_W0, "reduce_plan": 2})
    hier_kw = dict(policy=RuntimePolicy(mode="deadline", deadline=10.0, grace=2.0,
                                        dropouts={"aggregator-1": 1.5},
                                        rejoins={"aggregator-1": 2.5}),
                   per_worker_hyperparams={f"trainer-{i}": {"compute_time": 1.0}
                                           for i in range(4)},
                   program_overrides={"trainer": HostNoiseTrainer})
    coord = JobSpec(tag=coordinated_fl(dataset_groups={"default": ("d0", "d1", "d2", "d3")}),
                    datasets=tuple(DatasetSpec(name=f"d{i}") for i in range(4)),
                    hyperparams={"rounds": 3, "init_weights": HOST_W0})
    coord_kw = dict(program_overrides={"trainer": HostNoiseCoord})
    kernel.reset_launches()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        futs = [pool.submit(run_job_multiproc, hier, device=dev, timeout=300, pool_size=2,
                            sharded=True, **hier_kw),
                pool.submit(run_job_multiproc, coord, device=dev, timeout=300, **coord_kw)]
        mp_hier, mp_coord = (f.result() for f in futs)
    small_s = time.perf_counter() - t0
    hier_hub_folds = kernel.exact_fold_into_tree.launches
    check(not mp_hier.errors, f"pooled sharded job errors: {mp_hier.errors}")
    check(not mp_coord.errors, f"coordinated process job errors: {mp_coord.errors}")
    thr = run_job(hier, device=dev, timeout=120, **hier_kw)
    check(not thr.errors, f"threaded hierarchical job errors: {thr.errors}")
    check(_small_obs(mp_hier) == _small_obs(thr),
          "pooled sharded deadline job differs from run_job on the card")
    check(mp_hier.dropped == {"aggregator-1": 1.5}
          and (2.5, "rejoin", "aggregator-1") in mp_hier.events,
          f"dropout and re-join did not happen: {mp_hier.dropped} {mp_hier.events}")
    reduced = mp_hier.channel_stats["param-channel"]
    check(reduced.get("hub_partials", 0) > 0 and hier_hub_folds == reduced["hub_reduced"],
          f"shard hubs folded {hier_hub_folds} frames, reduced {reduced}")
    coord_folds = _proc_launches({}, mp_coord.programs.values())["exact_fold"]
    thr = run_job(coord, device=dev, timeout=120, **coord_kw)
    check(not thr.errors and _small_obs(mp_coord) == _small_obs(thr),
          "coordinated process job differs from run_job on the card")
    check(coord_folds > 0, "the coordinated aggregators' processes never launched the stacked fold")

    lock = probe.lock_s
    fold = probe.fold_ms
    print(f"phase process plane: ok Qwen2.5-3B tree ({QWEN_PARAMS} f32 params, layers 36->4) as "
          f"{T + 1} processes, hub in the driver folding on the card at reduce_plan 1 over "
          f"int8_blocks, {R} rounds byte-equal to the loopback comparator and to phase 5's "
          f"unreduced rounds; startup_s {startup_s:.3f} job_s {job_s:.3f} round_wall_s "
          f"{[round(m['round_s'], 4) for m in rounds]} (loopback comparator "
          f"{[round(x, 4) for x in cmp_round_s]}, job_s {cmp_s:.3f}); hub launches "
          f"exact_fold_into_tree {hub['exact_fold_into_tree']} dequantize_blocks "
          f"{hub['dequantize_blocks']} (= {R} x {T}); hub fold device ms mean "
          f"{sum(fold) / len(fold):.3f} max {max(fold):.3f}; hub under the lock s total "
          f"{sum(lock):.3f} per frame mean {sum(lock) / len(lock):.3f} max {max(lock):.3f}; "
          f"children {json.dumps(children)}; driver peak_device_gb {driver_peak_gb:.2f}; "
          f"(b) hierarchical_fl pool_size 2 sharded reduce_plan 2 deadline with aggregator-1 "
          f"dropped at 1.5 and re-joined at 2.5 (hub_reduced {reduced['hub_reduced']}) and "
          f"coordinated_fl sync over 7 processes (exact_fold launches {coord_folds}), run at "
          f"once in {small_s:.3f} s, byte-equal to run_job on the card", flush=True)
    return {"launches": launches}


# ---------------------------------------------------------------------- #
# phase 6
# ---------------------------------------------------------------------- #
# (B, S, H, Hkv, D, causal, window, dtype): the five shapes and the bf16
# case of tests/test_kernels.py, the bf16 shapes the tensor-core kernel
# takes (D 64 and 128: causal, not, a window whose rows' first visited
# tiles are all masked, a non-causal window, GQA 8:1, ragged S), float32
# at D 128 and bf16 at D 32 and 256 (flash.cu only), and the serving
# prefill's shape last
FLASH_CASES = (
    (2, 128, 4, 2, 64, True, 0, torch.float32),
    (1, 256, 4, 4, 32, True, 0, torch.float32),
    (2, 192, 8, 1, 64, True, 64, torch.float32),
    (1, 128, 4, 2, 64, False, 0, torch.float32),
    (1, 200, 2, 2, 32, True, 0, torch.float32),
    (1, 128, 4, 2, 64, True, 0, torch.bfloat16),
    (2, 192, 8, 1, 64, True, 64, torch.bfloat16),
    (1, 97, 2, 1, 64, False, 40, torch.bfloat16),
    (1, 256, 4, 4, 128, False, 0, torch.bfloat16),
    (1, 400, 4, 1, 128, True, 100, torch.bfloat16),
    (1, 512, 8, 1, 128, True, 0, torch.bfloat16),
    (2, 512, 8, 2, 128, True, 0, torch.float32),
    (1, 200, 2, 2, 32, True, 0, torch.bfloat16),
    (2, 384, 4, 2, 256, True, 0, torch.bfloat16),
    (1, 2049, 16, 2, 128, True, 0, torch.bfloat16),
    (SERVE_BATCH, SERVE_PROMPT, 16, 2, 128, True, 0, torch.bfloat16),
)
# the routes' counters and the C entries they launch
ROUTE_ENTRIES = {"flash_forward": "flash_attention_forward",
                 "flash_forward_sm90": "flash_attention_forward_sm90"}


def _qkv(dev, gen, B, S, H, Hkv, D, dtype):
    return (torch.randn(B, S, H, D, generator=gen, device=dev).to(dtype),
            torch.randn(B, S, Hkv, D, generator=gen, device=dev).to(dtype),
            torch.randn(B, S, Hkv, D, generator=gen, device=dev).to(dtype))


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def _attention_without_tile(q, k, v, *, causal=True, window=0):
    """Causal plain attention with a planted fault: the FAULT_KEYS keys from
    S/2 on are masked for every row, as a kernel that skips one KV tile
    would compute. (B, S, H, D) layout, the flash op's signature."""
    check(causal and not window, "the planted tile fault is causal without a window")
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    lo = S // 2 - S // 2 % FAULT_KEYS
    pos = torch.arange(S, device=q.device)
    keep = (pos[None, :] <= pos[:, None]) & ~((pos >= lo) & (pos < lo + FAULT_KEYS))[None, :]
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float().reshape(B, S, Hkv, H // Hkv, D), k.float())
    s = (s * D**-0.5).masked_fill(~keep, fref.NEG_INF)
    out = torch.einsum("bhgqk,bkhd->bqhgd", torch.softmax(s, dim=-1), v.float())
    return out.reshape(B, S, H, D).to(q.dtype)


def _attention_wrong_heads(q, k, v, *, causal=True, window=0):
    """Plain attention with a planted fault: q head h reads kv head
    h % Hkv instead of h // (H / Hkv)."""
    heads = torch.arange(q.shape[2], device=q.device) % k.shape[2]
    return fref.reference_attention(q, k[:, :, heads], v[:, :, heads], causal=causal, window=window)


def _attention_not_causal(q, k, v, *, causal=True, window=0):
    """Plain attention with a planted fault: no causal mask."""
    return fref.reference_attention(q, k, v, causal=False, window=window)


PLANTED_FAULTS = {"tile_dropped": _attention_without_tile, "wrong_kv_head": _attention_wrong_heads,
                  "not_causal": _attention_not_causal}


def phase_flash_parity(dev: torch.device) -> dict:
    """(a) both flash kernels against their plain version on the same
    tensors, by max abs error and by relative L2: each case through the
    wrapper (one launch, on the route its dtype and head dim pick), and the
    cases of the tensor-core route also on flash.cu directly; then the
    plain version with one KV tile dropped against it at the serving shape
    (a control that the relative limit must see). Returns each route's max
    abs error at the serving shape."""
    gen = torch.Generator(device=dev).manual_seed(13)
    errs, rels, routes = [], [], []
    serving_err = {}
    for B, S, H, Hkv, D, causal, window, dtype in FLASH_CASES:
        q, k, v = _qkv(dev, gen, B, S, H, Hkv, D, dtype)
        plain = fref.reference_attention(q, k, v, causal=causal, window=window)
        case = f"flash (B {B}, S {S}, H {H}/{Hkv}, D {D}, causal {causal}, window {window}, {dtype})"
        route = fkernel.route_of(dtype, D)
        fkernel.reset_launches()
        runs = [(route, flash_attention(q, k, v, causal=causal, window=window))]
        counts = {name: fkernel.ROUTES[name].launches for name in ROUTE_ENTRIES}
        check(counts == {name: int(name == route) for name in ROUTE_ENTRIES}
              and fkernel.flash_attention_bhsd.launches == 1,
              f"{case}: launches {counts}, expected one on {route}")
        if route == "flash_forward_sm90":  # flash.cu takes these too
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            runs.append(("flash_forward", fkernel.flash_forward(
                qt, kt, vt, causal=causal, window=window).transpose(1, 2)))
        for name, out in runs:
            check(out.dtype == dtype and out.shape == q.shape,
                  f"{case} {name}: output {out.dtype} {tuple(out.shape)}")
            err = float((out.float() - plain.float()).abs().max())
            rel = _rel_l2(out, plain)
            check(err <= FLASH_ATOL[dtype], f"{case} {name}: max abs err {err} > {FLASH_ATOL[dtype]}")
            check(rel <= FLASH_REL_L2[dtype], f"{case} {name}: rel L2 {rel} > {FLASH_REL_L2[dtype]}")
            errs.append(err)
            rels.append(rel)
            routes.append("sm90" if name == "flash_forward_sm90" else "simt")
            serving_err[ROUTE_ENTRIES[name]] = err
        del runs
    # the last case is the serving shape: a dropped tile must show
    control = _attention_without_tile(q, k, v)
    control_rel = _rel_l2(control, plain)
    control_err = float((control.float() - plain.float()).abs().max())
    check(control_rel > FLASH_REL_L2[dtype],
          f"one dropped KV tile reads rel L2 {control_rel}, within the limit {FLASH_REL_L2[dtype]}")
    del q, k, v, plain, control
    torch.cuda.synchronize()
    print(f"phase serve parity: ok both flash kernels within atol 2e-5 / 3e-2 and rel L2 1e-5 / "
          f"5e-3 (f32 / bf16) of their plain version in {len(errs)} runs of {len(FLASH_CASES)} "
          f"cases, one launch on the route of each; route {routes} max_abs_err "
          f"{[f'{e:.3g}' for e in errs]} rel_l2 {[f'{r:.3g}' for r in rels]}; control (plain with "
          f"{FAULT_KEYS} keys dropped, serving shape) rel_l2 {control_rel:.3g} max_abs_err "
          f"{control_err:.3g}", flush=True)
    return serving_err


def _rounded(d: dict) -> dict:
    return {k: round(v, 3) if isinstance(v, float) else v for k, v in d.items()}


def _kernel_classes(fn) -> dict:
    """Wall ms of ``fn`` (synchronized) and its device kernel ms by class,
    from a ``torch.profiler`` trace of the card alone."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ms = {"flash": 0.0, "gemm": 0.0, "other": 0.0}
    other = {}
    n = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name.lower()
        cls = ("flash" if "flash_kernel" in name else
               "gemm" if any(w in name for w in ("gemm", "xmma", "cutlass", "nvjet", "cublas")) else
               "other")
        t = e.time_range.elapsed_us() / 1e3
        ms[cls] += t
        if cls == "other":
            other[e.name[:60]] = other.get(e.name[:60], 0.0) + t
        n += 1
    check(n > 0, "the profiler recorded no device kernels")
    busy = sum(ms.values())
    top = sorted(other.items(), key=lambda kv: -kv[1])[:3]
    return {"wall_ms": wall_ms, "kernels": n, "busy_share": busy / wall_ms,
            **{f"{k}_ms": v for k, v in ms.items()},
            "top_other_ms": [[k, round(v, 3)] for k, v in top]}


def _route_launches() -> dict:
    return {entry: fkernel.ROUTES[name].launches for name, entry in ROUTE_ENTRIES.items()}


def phase_serve(dev: torch.device, flash_errs: dict) -> dict:
    """(b) serving the full Qwen2.5-3B through ``serve.generate`` with the
    flash kernel, checked; (c) its times and both flash kernels'."""
    B, S, T = SERVE_BATCH, SERVE_PROMPT, SERVE_GEN
    cfg = dataclasses.replace(get_config("qwen2_5_3b"), attn_impl="flash")
    check(cfg.num_layers == 36 and cfg.scan_layers and cfg.param_dtype == "bfloat16",
          "qwen2_5_3b is not the full bf16 36-layer config")
    bundle = build_model(cfg, dev)
    plain_bundle = build_model(dataclasses.replace(cfg, attn_impl="xla"), dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = bundle.init(gen)
    n_params = sum(x.numel() for x in tree_leaves(params))
    check(n_params == QWEN_FULL_PARAMS, f"{n_params} parameters, not {QWEN_FULL_PARAMS}")
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=dev)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)

    # the main path: one generate call, launches counted from 0
    fkernel.reset_launches()
    out = generate(bundle, params, prompts, T)
    launches = fkernel.flash_attention_bhsd.launches
    routes = _route_launches()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    check(out.all_finite, "non-finite logits while serving")
    check(out.tokens.shape == (B, T), f"tokens {tuple(out.tokens.shape)}")
    on_path = {"flash_attention_forward_sm90": cfg.num_layers, "flash_attention_forward": 0}
    check(launches == cfg.num_layers and routes == on_path,
          f"{launches} flash launches ({routes}) in a prefill and {T - 1} decode steps, "
          f"not {on_path}")

    # per call: 36 launches per prefill, all on the tensor-core kernel, none per decode step
    fkernel.reset_launches()
    logits_f, cache = bundle.prefill(params, {"tokens": prompts}, bundle.init_cache(B, S + 1))
    per_prefill = fkernel.flash_attention_bhsd.launches
    per_prefill_routes = _route_launches()
    nxt = torch.argmax(logits_f[:, -1], dim=-1, keepdim=True).to(torch.int32)
    fkernel.reset_launches()
    logits_d, _ = bundle.serve_step(params, cache, {"token": nxt})
    per_step = fkernel.flash_attention_bhsd.launches
    check(per_prefill == cfg.num_layers and per_prefill_routes == on_path and per_step == 0,
          f"flash launches per prefill {per_prefill} ({per_prefill_routes}), per decode step "
          f"{per_step}")
    del cache
    # teacher forcing: the decode step against a prefill of S + 1 tokens
    logits_s1, _ = bundle.prefill(params, {"tokens": torch.cat([prompts, nxt], dim=1)},
                                  bundle.init_cache(B, S + 1))
    tf_rel = _rel_l2(logits_d, logits_s1)
    tf_err = float((logits_d - logits_s1).abs().max())
    # the flash prefill against the plain attention's
    logits_x, _ = plain_bundle.prefill(params, {"tokens": prompts}, plain_bundle.init_cache(B, S + 1))
    fx_rel = _rel_l2(logits_f, logits_x)
    fx_err = float((logits_f - logits_x).abs().max())
    check(all(bool(torch.isfinite(x).all()) for x in (logits_f, logits_d, logits_s1, logits_x)),
          "non-finite logits")
    check(fx_rel <= SERVE_REL_L2, f"flash vs plain prefill logits: rel L2 {fx_rel} > {SERVE_REL_L2}")
    check(tf_rel <= SERVE_REL_L2, f"teacher forcing: rel L2 {tf_rel} > {SERVE_REL_L2}")
    # controls: prefills with a fault planted in the attention, against the
    # plain prefill; each must read above the bound
    controls = {}
    try:
        for name, fault in PLANTED_FAULTS.items():
            blocks.flash_attention = fault
            logits_c, _ = bundle.prefill(params, {"tokens": prompts}, bundle.init_cache(B, S + 1))
            controls[name] = _rel_l2(logits_c, logits_x)
            del logits_c
    finally:
        blocks.flash_attention = flash_attention
    check(min(controls.values()) > SERVE_REL_L2,
          f"a planted attention fault reads within the bound {SERVE_REL_L2}: rel L2 {controls}")
    del logits_s1, logits_x, logits_d
    gc.collect()
    torch.cuda.empty_cache()

    # (c) prefill time: median of 3 after a warm-up, CUDA events
    def prefill(which=bundle):
        return which.prefill(params, {"tokens": prompts}, which.init_cache(B, S + T))

    def median_ms(fn, runs=3):
        fn()
        times = []
        for _ in range(runs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    prefill_ms = median_ms(prefill)
    plain_prefill_ms = median_ms(lambda: prefill(plain_bundle), runs=1)
    # bf16 products that may reduce split-K sums in bf16 (PyTorch's default)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    reduced_ms = median_ms(prefill)
    logits_r, _ = prefill()
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    reduced_rel = _rel_l2(logits_r, logits_f)
    del logits_r
    # where a prefill's and a decode step's device time goes
    prof_prefill = _kernel_classes(prefill)
    _, cache = prefill()
    prof_step = _kernel_classes(lambda: bundle.serve_step(params, cache, {"token": nxt}))
    del cache
    gc.collect()
    torch.cuda.empty_cache()

    # the tensor-core kernel alone at the serving shape
    gen = torch.Generator(device=dev).manual_seed(1)
    q, k, v = _qkv(dev, gen, B, S, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, torch.bfloat16)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    nbytes = 2 * (2 * B * S * H * D + 2 * B * S * Hkv * D)  # q, k, v read, out written
    flops = 4 * D * B * H * (S * (S + 1) // 2)  # two products over the causal pairs
    timing = dict(
        plain_ms=cuda_ms(lambda: fref.reference_attention(q, k, v), reps=2),
        library_ms=cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), reps=20),
        bound=bound(nbytes, flops, BF16_TENSOR_FLOPS),
        ms=cuda_ms(lambda: flash_attention(q, k, v), reps=20),
        max_abs_err=flash_errs["flash_attention_forward_sm90"],
    )
    del q, k, v, qt, kt, vt
    # flash.cu on its own route: float32 at the serving shape, against the
    # plain version, SDPA at float32 and the float32 bound (CUDA cores: TF32
    # would miss the 2e-5 limit)
    q, k, v = _qkv(dev, gen, B, S, H, Hkv, D, torch.float32)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    plain32 = fref.reference_attention(q, k, v)
    out32 = fkernel.flash_forward(qt, kt, vt).transpose(1, 2)
    err32, rel32 = float((out32 - plain32).abs().max()), _rel_l2(out32, plain32)
    check(err32 <= FLASH_ATOL[torch.float32] and rel32 <= FLASH_REL_L2[torch.float32],
          f"flash.cu at float32, serving shape: max abs err {err32}, rel L2 {rel32}")
    del plain32, out32
    simt = dict(
        ms=cuda_ms(lambda: fkernel.flash_forward(qt, kt, vt), reps=3),
        plain_ms=cuda_ms(lambda: fref.reference_attention(q, k, v), reps=2),
        library_ms=cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), reps=5),
        bound=bound(2 * nbytes, flops), max_abs_err=err32)
    timings = {"flash_attention_forward_sm90": timing, "flash_attention_forward": simt}
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    decode_ms = out.decode_s / (T - 1) * 1e3
    print(f"phase serve: ok Qwen2.5-3B ({n_params} bf16 params, 36 layers) B {B} prompt {S} "
          f"gen {T} with the flash kernel; flash launches {launches} {json.dumps(routes)} (per "
          f"prefill {per_prefill}, per decode step {per_step}); flash vs plain prefill rel_l2 {fx_rel:.3g} max_abs_err "
          f"{fx_err:.3g}; teacher forcing rel_l2 {tf_rel:.3g} max_abs_err {tf_err:.3g}; "
          f"controls (planted attention faults) rel_l2 "
          f"{json.dumps({k: float(f'{v:.4g}') for k, v in controls.items()})}; "
          f"prefill_ms {prefill_ms:.3f} (in generate {out.prefill_s * 1e3:.3f}) plain_prefill_ms "
          f"{plain_prefill_ms:.3f} bf16_reduced_reduction prefill_ms {reduced_ms:.3f} rel_l2 "
          f"{reduced_rel:.3g}; decode_ms_per_step {decode_ms:.3f} decode_tokens_per_s "
          f"{B * (T - 1) / out.decode_s:.1f} generated_tokens_per_s "
          f"{B * T / (out.prefill_s + out.decode_s):.1f} peak_device_gb {peak_gb:.2f}; "
          f"prefill profile {json.dumps(_rounded(prof_prefill))} "
          f"decode step profile {json.dumps(_rounded(prof_step))}; "
          f"flash ms {timing['ms']:.3f} plain_ms {timing['plain_ms']:.3f} sdpa_ms "
          f"{timing['library_ms']:.3f} bound_ms {timing['bound'][0]:.4f} ({timing['bound'][1]}); "
          f"flash.cu float32 ms {simt['ms']:.3f} max_abs_err {err32:.3g} rel_l2 {rel32:.3g} "
          f"plain_ms {simt['plain_ms']:.3f} sdpa_f32_ms {simt['library_ms']:.3f} bound_ms "
          f"{simt['bound'][0]:.4f} ({simt['bound'][1]})", flush=True)
    return {"launches": routes, "timings": timings}


# ---------------------------------------------------------------------- #
# phase 8: the federated train step
# ---------------------------------------------------------------------- #
def _all_launches() -> dict:
    out = {fn.__name__: fn.launches for fn in kernel.KERNELS + qkernel.KERNELS}
    out.update(_route_launches())
    return out


def _reset_all_launches() -> None:
    kernel.reset_launches()
    qkernel.reset_launches()
    fkernel.reset_launches()


def _train_round(setup, params, state, tokens, seed):
    """One step, host-timed after a synchronize, split by CUDA events at the
    step's segment marks (clients' SGD, stage sums, the strategy's apply)."""
    events = []

    def mark(label):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        events.append((label, e))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, state, m = setup.step(params, state, {"tokens": tokens}, seed, on_segment=mark)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    split = {}
    for (label, a), (_, b) in zip(events, events[1:]):
        split[label] = split.get(label, 0.0) + a.elapsed_time(b)
    return params, state, {k: float(v) for k, v in m.items()}, wall_s, split


def _finite(tree) -> bool:
    return all(bool(torch.isfinite(x).all()) for x in tree_leaves(tree))


def phase_train(dev: torch.device, smi: str) -> dict:
    """(a) the fed step on Qwen2.5-3B at full width and depth over 2 virtual
    clients: a warm-up round, timed rounds, a profiled round, then one batch
    repeated from a new init; (b)
    ``hierarchical_fl`` over pod 2 x data 2 with a bf16 cross-pod wire at 4
    layers; (c) the gate: the first round at 2 layers in float32 on the card
    against the same round on the CPU."""
    cfg = get_config("qwen2_5_3b")
    check(cfg.num_layers == 36 and cfg.param_dtype == "bfloat16" and cfg.attn_impl == "xla"
          and cfg.server_strategy == "fedadam", "qwen2_5_3b is not the full bf16 36-layer config")
    fed = FedStepConfig(local_steps=TRAIN_LOCAL_STEPS, local_lr=TRAIN_LR)
    bundle, setup = build_train_step(cfg, make_virtual_mesh(TRAIN_CLIENTS), fed, device=dev)
    check(setup.client_axes == ("data",) and setup.tag.name == "classical-fl",
          f"the train step lowered {setup.tag} over {setup.client_axes}")
    params = bundle.init(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(x.numel() for x in tree_leaves(params))
    check(n_params == QWEN_FULL_PARAMS, f"{n_params} parameters, not {QWEN_FULL_PARAMS}")
    state = setup.init_state(params)
    data = synthetic_lm_batches(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    batches = [next(data) for _ in range(TRAIN_WARMUP + TRAIN_ROUNDS + 1)]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)

    # the main path: the warm-up and timed rounds, launches counted from 0
    _reset_all_launches()
    losses, norms, walls, splits, held_gb = [], [], [], [], []
    for i in range(TRAIN_WARMUP + TRAIN_ROUNDS):
        params, state, m, wall_s, split = _train_round(setup, params, state, batches[i], i)
        check(m["participants"] == TRAIN_CLIENTS, f"round {i}: {m['participants']} participants")
        losses.append(m["loss"])
        norms.append(m["delta_norm"])
        held_gb.append(torch.cuda.memory_allocated(dev) / 1e9)
        if i >= TRAIN_WARMUP:
            walls.append(wall_s)
            splits.append(split)
    launches = _all_launches()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)), f"losses {losses}, norms {norms}")
    check(_finite(params) and _finite(state), "a non-finite weight or server state")
    # the launcher's own assertion; on these fresh batches it is no evidence
    # of learning (1 024 new tokens of 152 064 a round move the loss about
    # 0.1 either way, and whether the last is lower depends on which batch
    # comes last): the repeated batch below, a nat lower, is that evidence
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    # between rounds the card holds the parameters, the server state and
    # nothing of a finished round (a reference cycle once kept each round's
    # old parameters until a full garbage collection)
    check(held_gb[-1] - held_gb[0] < HELD_GROWTH_GB,
          f"memory held between rounds grew: {held_gb} GB")
    # where a round's device time goes, and its launches
    i = TRAIN_WARMUP + TRAIN_ROUNDS
    prof = _kernel_classes(lambda: setup.step(params, state, {"tokens": batches[i]}, i))
    round_ms = float(np.median(walls)) * 1e3
    split_ms = {k: float(np.median([sp.get(k, 0.0) for sp in splits]))
                for k in ("local", "reduce", "apply")}
    del params, state
    gc.collect()
    torch.cuda.empty_cache()
    # (d) the step learns: the first batch again and again from a new init
    params = bundle.init(torch.Generator(device=dev).manual_seed(0))
    state = setup.init_state(params)
    learn = []
    for i in range(LEARN_ROUNDS):
        params, state, m = setup.step(params, state, {"tokens": batches[0]}, i)
        learn.append(float(m["loss"]))
    check(all(np.isfinite(learn)) and learn[-1] < learn[0] - LEARN_DROP,
          f"one batch repeated {LEARN_ROUNDS} rounds: losses {learn}, not {LEARN_DROP} lower")
    del params, state, bundle, setup
    gc.collect()
    torch.cuda.empty_cache()

    # (b) two stages: the mean over data within each pod, then over pod in bf16
    hcfg = dataclasses.replace(cfg, num_layers=HIER_LAYERS)
    hmesh = make_virtual_mesh(HIER_CLIENTS, pods=HIER_PODS)
    hbundle, hsetup = build_train_step(hcfg, hmesh, fed, cross_pod_wire="bf16", device=dev)
    plan = lower_tag_to_mesh(hsetup.tag, ("data", "pod"))
    check([(st.axes, st.wire_dtype) for st in plan.stages] == [(("data",), "f32"),
                                                             (("pod",), "bf16")],
          f"hierarchical plan {plan}")
    hparams = hbundle.init(torch.Generator(device=dev).manual_seed(1))
    hstate = hsetup.init_state(hparams)
    hdata = synthetic_lm_batches(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    hlosses, hwalls = [], []
    for i in range(HIER_ROUNDS):
        hparams, hstate, m, wall_s, _ = _train_round(hsetup, hparams, hstate, next(hdata), i)
        check(m["participants"] == HIER_PODS * HIER_CLIENTS, f"{m['participants']} participants")
        hlosses.append(m["loss"])
        hwalls.append(wall_s)
    check(all(np.isfinite(hlosses)) and _finite(hparams), f"hierarchical losses {hlosses}")
    del hparams, hstate, hbundle, hsetup
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the gate: 2 layers, full width, float32, card against CPU
    gcfg = dataclasses.replace(cfg, num_layers=GATE_LAYERS, param_dtype="float32")
    gmesh = make_virtual_mesh(TRAIN_CLIENTS)
    cbundle, csetup = build_train_step(gcfg, gmesh, fed, device=dev)
    pbundle, psetup = build_train_step(gcfg, gmesh, fed, device="cpu")
    cparams = cbundle.init(torch.Generator(device=dev).manual_seed(2))
    pparams = tree_map(lambda x: x.cpu(), cparams)
    t0 = time.perf_counter()
    cnew, _, cm = csetup.step(cparams, csetup.init_state(cparams), {"tokens": batches[0]}, 0)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pnew, _, pm = psetup.step(pparams, psetup.init_state(pparams), {"tokens": batches[0]}, 0)
    cpu_s = time.perf_counter() - t0
    loss_rel = abs(float(cm["loss"]) - float(pm["loss"])) / abs(float(pm["loss"]))
    norm_rel = abs(float(cm["delta_norm"]) - float(pm["delta_norm"])) / float(pm["delta_norm"])
    param_err = max(float((a.cpu() - b).abs().max())
                    for a, b in zip(tree_leaves(cnew), tree_leaves(pnew)))
    moved = max(float((a - b).abs().max()) for a, b in zip(tree_leaves(pnew), tree_leaves(pparams)))
    check(loss_rel <= GATE_LOSS_RTOL and norm_rel <= GATE_NORM_RTOL and param_err <= GATE_PARAM_ATOL,
          f"card vs CPU at {GATE_LAYERS} layers, float32: loss rel {loss_rel:.3g} (limit "
          f"{GATE_LOSS_RTOL}), delta_norm rel {norm_rel:.3g} ({GATE_NORM_RTOL}), params max abs "
          f"{param_err:.3g} ({GATE_PARAM_ATOL})")
    del cparams, pparams, cnew, pnew, cbundle, pbundle
    gc.collect()
    torch.cuda.empty_cache()

    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"phase train: ok card {smi}; Qwen2.5-3B ({n_params} bf16 params, 36 layers) "
          f"classical_fl over {TRAIN_CLIENTS} virtual clients, fedadam, batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}, local_steps {TRAIN_LOCAL_STEPS}, local_lr {TRAIN_LR}; rounds_ms "
          f"{json.dumps([round(w * 1e3, 3) for w in walls])} median round_ms {round_ms:.3f} "
          f"train_tokens_per_s {tokens / (round_ms / 1e3):.1f}; split_ms (CUDA events, median) "
          f"{json.dumps(_rounded(split_ms))}; launches on the path "
          f"{json.dumps(launches)}; profiled round {json.dumps(_rounded(prof))}; "
          f"peak_device_gb {peak_gb:.2f} held between rounds gb "
          f"{json.dumps([round(x, 3) for x in held_gb])}; losses "
          f"{json.dumps([round(x, 5) for x in losses])} "
          f"delta_norms {json.dumps([round(x, 6) for x in norms])}; one batch repeated: losses "
          f"{json.dumps([round(x, 5) for x in learn])}; hierarchical_fl pod "
          f"{HIER_PODS} x data {HIER_CLIENTS}, bf16 cross-pod wire, {HIER_LAYERS} layers: losses "
          f"{json.dumps([round(x, 5) for x in hlosses])} rounds_ms "
          f"{json.dumps([round(w * 1e3, 3) for w in hwalls])}; gate {GATE_LAYERS} layers float32 "
          f"card vs CPU: loss rel {loss_rel:.3g} delta_norm rel {norm_rel:.3g} params max abs "
          f"{param_err:.3g} (largest move {moved:.3g}); card round_s {card_s:.2f} cpu round_s "
          f"{cpu_s:.2f}", flush=True)
    return {"launches": launches, "round_ms": round_ms, "peak_gb": peak_gb}


# ---------------------------------------------------------------------- #
def kernels_line(full: dict, topo: dict, policies: dict, codec: dict, serve: dict,
                 proc: dict, train: dict) -> str:
    """One row per kernel. ``launches`` sums the paths that run it, each
    counted from 0 over its own run (``launches_by_path``): phase 4's job
    for the streaming fold entries, phase 4b's coordinated job for the
    stacked fold, phase 4c's policy jobs and its batch for all agg entries,
    phase 5's job for the quant kernels, phase 6's serving for flash,
    phase 7's process job (the hub's launches plus every child's) for the
    agg and quant entries, and phase 8's training rounds for every kernel
    (none launches there: the stages are float32 sums and training runs the
    plain attention)."""
    agg_src = "src/repro_torch/kernels/agg/csrc/agg.cu"
    quant_src = "src/repro_torch/kernels/quant/csrc/quant.cu"
    fold = "src/repro/kernels/agg/kernel.py:96"
    sdpa = "torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)"
    rows = [
        ("exact_fold_into_tree", agg_src, fold, True, "torch._foreach_add_(accs, ds, alpha=w)",
         full, "4"),
        ("exact_fold_into", agg_src, fold, False, "torch.add(acc, d, alpha=w, out=acc)", full, "4"),
        ("exact_divide", agg_src, fold, True, "torch.div(x, den)", full, "4"),
        ("exact_fold", agg_src, fold, True, "torch.mv(d.t(), w / den)", topo, "4b"),
        ("weighted_aggregate", agg_src, "src/repro/kernels/agg/kernel.py:74", False,
         "torch.mv(d.t(), w / den)", full, "4"),
        ("quantize_blocks", quant_src, "src/repro/kernels/quant/kernel.py:31", True,
         "none: no one PyTorch call computes blockwise scales and codes", codec, "5"),
        ("dequantize_blocks", quant_src, "src/repro/kernels/quant/kernel.py:50", True,
         "torch.mul(q, scale)", codec, "5"),
        ("flash_attention_forward_sm90", "src/repro_torch/kernels/flash_attention/csrc/flash_sm90.cu",
         "src/repro/kernels/flash_attention/kernel.py:76", True, sdpa, serve, "6"),
        ("flash_attention_forward", "src/repro_torch/kernels/flash_attention/csrc/flash.cu",
         "src/repro/kernels/flash_attention/kernel.py:76", False, sdpa, serve, "6"),
    ]
    out = []
    for name, src, replaces, on_path, library, run, phase in rows:
        t = run["timings"][name]
        by_path = {phase: run["launches"][name]}
        if src == agg_src:
            by_path["4c"] = policies["launches"].get(name, 0)
        if src in (agg_src, quant_src):
            by_path["7"] = proc["launches"].get(name, 0)
        by_path["8"] = train["launches"][name]
        launches = sum(by_path.values())
        out.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches, "launches_by_path": by_path,
            "on_main_path": on_path or launches > 0,
            "max_abs_err": t["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": t["library_ms"], "library_call": library,
            **({"library_per_leaf_ms": t["library_per_leaf_ms"],
                "library_per_leaf_call": "torch.add(acc, d, alpha=w, out=acc) per leaf"}
               if "library_per_leaf_ms" in t else {}),
        })
    return json.dumps({"kernels": out})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products reduce split-K partial sums in float32, as the JAX
    # package accumulates (phase 6 also times a prefill with it allowed)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    phase_s = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phase_s[name] = round(time.perf_counter() - t, 1)
        return out

    smi = timed("1", phase_environment)
    timed("2", phase_parity, dev)
    timed("3", lambda: (phase_small_jobs(dev), phase_small_topologies(dev),
                        phase_small_policies(dev)))
    full = timed("4", phase_full_width, dev)
    gc.collect()
    torch.cuda.empty_cache()
    topo = timed("4b", phase_full_width_topologies, dev)
    gc.collect()
    torch.cuda.empty_cache()
    policies = timed("4c", phase_full_width_policies, dev)
    errs = timed("5a", phase_codec_parity, dev)
    codec = timed("5", phase_codec_job, dev, errs)
    proc = timed("7", phase_process_plane, dev, codec)
    # the earlier phases peak at about 46 GB: free them before serving
    gc.collect()
    torch.cuda.empty_cache()
    serve = timed("6", lambda: phase_serve(dev, phase_flash_parity(dev)))
    gc.collect()
    torch.cuda.empty_cache()
    train = timed("8", phase_train, dev, smi)
    print(f"phase_s {json.dumps(phase_s)}", flush=True)
    print(f"elapsed_s {time.perf_counter() - t0:.1f}", flush=True)
    print(kernels_line(full, topo, policies, codec, serve, proc, train), flush=True)
    print(f"card: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
