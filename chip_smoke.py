#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on a CUDA card and check it.

Run from the root of a checkout, with one CUDA card (Hopper, sm_90a) and
the CUDA toolkit:

    python3 chip_smoke.py

It builds the kernels from ``src/repro_torch/kernels/*/csrc`` (one nvcc per
source, started together), then runs nine phases (phase 6 in seven
parts), each printing its lines:

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
   (q and scales as bytes) over edge-case blocks; (b) the same job, its
   tree cut to 1 layer (388 M parameters, the last block padded), with the
   param channel on the socket loopback (``backend="multiproc"``, codec
   ``int8_blocks``): 4 trainers, 2 rounds, the job's weights byte-equal
   every round to the plain fold of the plain-dequantized, plain-quantized
   updates, byte counts and codec ratio equal to those worked out from the
   shapes, kernel launches equal to the codec's encode/decode counts and
   one fold launch per update, and a split of one round; the same job
   again with the decode pool off (``REPRO_DECODE_POOL`` 0: the root
   receives the uploads one at a time; the default pool of 4 fetches and
   decodes them at once), every round's weights byte-equal (sha256) to the
   pooled run's, both runs' round times; (c) the quant kernels' times at
   full width;
6. serve: (a) the three flash kernels against their plain version on the
   same CUDA tensors: every case through the wrapper, which picks the route
   by dtype and head dim (bf16 at D 64 and 128: the tensor-core kernel of
   ``flash_sm90.cu``; bf16 at D 256: the tensor-core kernel of
   ``flash_sm90_d256.cu``; the rest: ``flash.cu``), with one launch on the
   expected route, and each bf16 D 64 / 128 / 256 case also on ``flash.cu``
   directly, which takes it too (the five shapes of the JAX package's
   kernel test and its bf16 case, head dims 32 to 256, causal, not, sliding
   windows, GQA 8:1 and 16:1, ragged S, Gemma's prefill, the serving
   shape); (b)
   ``serve.generate`` on Qwen2.5-3B at full width and depth (36 layers,
   bf16, random weights from a seeded generator), 8 prompts of 2048 tokens
   and 64 greedy tokens, with the flash kernel, through the serving checks
   every serving phase but 6d shares (``_serve_phase``): logits finite, 36
   launches of the tensor-core kernel per prefill, none of ``flash.cu`` and
   none per decode step, the prefill's logits against the plain
   attention's and the planted attention faults (a KV tile dropped, the
   wrong kv heads, no causal mask) against the same limit, and teacher
   forcing (a decode step after a prefill of S tokens against a prefill of
   S + 1); (c) prefill, plain prefill and decode times, a kernel-time
   breakdown of each from ``torch.profiler``, and both flash kernels'
   times at the serving shape: the tensor-core kernel at bf16, ``flash.cu``
   on its own route, float32 (checked against the plain version there too);
   6d. serving Qwen3-MoE-235B-A22B at its published widths (128 experts
   top-8, 64/4 heads of 128), depth cut from 94 layers to 8, bf16, random
   weights from a seeded generator, through ``serve.generate`` with the
   flash kernel: phase 6's traffic, logits finite, one launch of the
   tensor-core kernel a layer per prefill and none per decode step, the
   prefill's logits against the plain attention's with every token routed
   to the experts the flash prefill picked (and, reported, without), and
   teacher forcing at capacity factor 8 on 2 prompts of 256 tokens (the
   routing pinned to the longer prefill's, and reported unpinned); the
   prefill and decode times, each split by CUDA events into routing and
   dispatch, the expert products, the combine and flash, and a
   ``torch.profiler`` breakdown; the peak memory and 0 MB held after; the
   tensor-core kernel at the model's attention shape (B 8, S 2048, H 64/4,
   D 128, causal) against the plain version, SDPA and its bound;
   6h, 6x, 6s, 6g. serving the families the earlier phases do not reach,
   each at its published widths and full depth, bf16, seeded weights
   (parameters counted against the JAX package's tree, worked out from the
   shapes), through phase 6's checks, no memory held after:
   6h Hymba-1.5B (prompts of 4096, twice its window of 2048; 32 tensor-core
   flash launches a prefill, gated against the same weights in float32;
   teacher forcing: 32 decode steps after a prefill of 2048, in float32, and
   256 bf16 decode steps at 2 layers whose first-layer SSD state must match
   a prefill's, with planted decode faults), then 2 layers in float32 on the
   card against the CPU and the tensor-core kernel at Hymba's attention
   shape (GQA 25/5, D 64, window 2048) against the plain version, SDPA
   (explicit mask, K/V repeated) and its bound; 6x xLSTM-1.3B (48 layers, 6
   sLSTM; prompts of 2048; no flash launch: the path runs no TPU kernel; 32
   decode steps after a prefill of 1792, in float32, and the bf16 decode at
   one period of 8 layers and on the sLSTM block alone; the sLSTM loop and
   the chunked mLSTM timed apart), then one period of 8 layers in float32
   card against CPU; 6s SeamlessM4T-medium (12 + 12 layers, 1024 float32
   stub frames of 0.1 randn, prompts of 256; 12 tensor-core launches a
   prefill, the decoder's self-attention only), then 2 + 2 layers in
   float32 card against CPU and the tensor-core kernel at the decoder's
   attention shape (B 8, S 256, H 16/16, D 64); 6g Gemma-7B (28 layers,
   head dim 256: 28 launches of ``flash_sm90_d256.cu`` a prefill, none of
   ``flash.cu``), then the D 256 tensor-core kernel at Gemma's attention
   shape (B 8, S 2048, H 16/16, D 256, causal) against the plain version,
   SDPA and its bound, and ``flash.cu`` called directly at the same shape;
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
   children's and this process's peak memory; then, each job alone, (a)'s
   job with the decode pool off, with the broadcast fan-out off
   (``REPRO_BROADCAST_FANOUT`` 0: one send per destination) and on the
   per-frame path (no reduce plan, the root's pool of 2 fetching and
   decoding the 4 uploads on the card, the root holding each round's first
   update until the fetches ahead of it land), every round byte-equal to
   (a)'s, their round times, the pooled receive's high-water count of
   payloads held (exactly the pool's 2 workers + 1, every round) and the
   device memory the per-frame root's aggregate allocates, held to the
   accumulator, 3 decoded updates and 2 updates' codes; (b) a ``hierarchical_fl`` job
   on 2 pool hosts with sharded hubs at ``reduce_plan`` 2 under the deadline
   policy, an intermediate aggregator dropped and re-joined, and a
   ``coordinated_fl`` sync job over 7 processes, each byte-equal (every
   program's weights, events, drops, channel bytes) to ``run_job`` on the
   card; (c) the fault plane, each job alone, each fault fired at a point
   of the job's own progress (``_FaultProbe``): (a) job (a) again with
   ``trainer-1``'s connection reset on the first frame naming it after the
   root's round-1 broadcast and the hub crashed on the first frame after
   round 1's last fold (both points gated): every round's digest, the
   channel bytes and every launch count (the hub's folds and dequantizes,
   each child's) equal to (a)'s, the faults fired and recovered
   (``transport_recovery``), no device memory held after the job; (b) job
   (b)'s H-FL job with its ``west`` shard hub crashed after its round-1
   folds, byte-equal to (b); (c) a FedBuff server (buffer 1) over processes
   on phase 5's tree less its embedding, with its codec, restarted from its
   checkpoint (``server_restarts``, 4 versions, ``checkpoint_every`` 2), then
   its fault-free run: the absorbed sequence, version vector and final
   weights equal, the
   restored step recorded; recovery counters, round times, the hub's time
   under its lock, its peak memory before and after the restart, the time
   from the crash to the next frame served, checkpoint bytes and save and
   restore times;
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
   layers, 3 rounds; (c) the first round at 1 layer, full width, float32,
   on the card against the same round on the CPU from the same parameters
   and batch: loss, ``delta_norm`` and every new parameter within the
   stated tolerances;
9. a ``kernels`` JSON line: launches on each path (phase 4 for the
   streaming fold kernels, phase 4b's coordinated job for the stacked exact
   fold, phase 4c's jobs and batch for every agg entry, phase 5's job for
   the quant kernels, phase 6's, 6d's, 6h's, 6x's, 6s's and 6g's serving
   runs for the flash kernels, phase
   7's process job and phase 7c's faulted jobs for the agg and quant
   entries, phase 8's rounds for
   every kernel), time, plain version's time, bound and a library call's
   time per kernel, at the path's shapes.

Then the card's name and power limit (``nvidia-smi``), and as the last line
``{"ok": true, "device": {...}}``. A phase that raises prints ``phase <id>
FAILED: <type>: <message>`` and the phases' seconds so far on stdout, its
traceback on stderr, and the script exits 1 without that line; a run
without a CUDA device or outside a checkout exits non-zero without it too.
The held-memory gates read the device after a collection and a
synchronize with cuBLAS's workspaces released, on both sides
(``program_bytes``), and print the live blocks when they fail.
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
import traceback
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
from repro_torch.core import channels as tch  # noqa: E402
from repro_torch.core.channels import InprocBackend, payload_bytes  # noqa: E402
from repro_torch.fl.strategies import get_strategy  # noqa: E402
from repro_torch.kernels.agg import kernel, ops, ref  # noqa: E402
from repro_torch.kernels.quant import kernel as qkernel  # noqa: E402
from repro_torch.kernels.quant import ops as qops  # noqa: E402
from repro_torch.kernels.quant import ref as qref  # noqa: E402
from repro_torch.transport import wire  # noqa: E402
from repro_torch.transport.conformance import SeededSGDTrainer  # noqa: E402
from repro_torch.transport.multiproc import TransportHub  # noqa: E402
from repro_torch.core.events import FaultPlan  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fkernel  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fref  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.launch.spawn import run_job_multiproc  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.models import encdec as tencdec  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
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
# phase 5: the tree over the socket loopback with the int8_blocks codec, cut
# to 1 of phase 4's 4 layers together with phase 7's process jobs (which
# check their rounds against phase 5's) to make room for phase 7c: full
# width, 388 M parameters, the last of 94 787 blocks a padded one
CODEC_TRAINERS, CODEC_ROUNDS, CODEC_LAYERS = 4, 2, 1
# the process plane's default decode pool (REPRO_DECODE_POOL)
DECODE_POOL = 4
# phase 7a's pool gates: the per-frame root receives through a pool of 2,
# fewer workers than its 4 trainers, and holds each round's first update
# until the fetches ahead of it land, so a pool that fetched past its bound
# would hold all 3 other updates
GATE_POOL = 2
CODEC_PARAMS = 388_243_968
QUANT_BLOCK = qkernel.BLOCK
QWEN_BLOCKS = 151_239  # QWEN_PARAMS / 4096, exactly: the quant kernels' parity case
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
# phase 6d: serving Qwen3-MoE-235B-A22B (src/repro/configs/qwen3_moe_235b_a22b.py)
# at its published widths, depth cut 94 -> 8 layers (42 GB of bf16 weights),
# the phase 6 traffic; teacher forcing at the JAX package's test capacity
# (tests/test_models.py) on 2 prompts of 256 tokens
MOE_LAYERS = 8
MOE_TF_CAPACITY, MOE_TF_PROMPTS, MOE_TF_LEN = 8.0, 2, 256
# phases 6h, 6x, 6s, 6g: Hymba-1.5B, xLSTM-1.3B, SeamlessM4T-medium and
# Gemma-7B (src/repro/configs/) at their published widths, full depth, bf16,
# seeded weights; 8 prompts each, 64 greedy tokens: Hymba's of 4096 tokens
# (twice its window), Seamless's of 256 tokens on 1024 frames, the others
# phase 6's 2048. Teacher forcing of the recurrent models on 2 prompts: 32
# decode steps after a prefill that ends on a chunk boundary (the chunked
# recurrence takes whole chunks): Hymba's of 2048 (its window, so the steps
# wrap the ring), xLSTM's of 1792
HYMBA_PROMPT, SEAMLESS_PROMPT, TF_PROMPTS, TF_STEPS = 4096, 256, 2, 32
# the encoder-decoder's stub frames, float32 as the serve loop's: this
# times randn, so that the encoder does real work
STUB_FRAMES = 0.1
# The recurrent models' teacher forcing at full depth runs on their weights
# in float32: in bf16 the random-weight stacks' own rounding swamps the check
# (a bf16 prefill is 5.7e-2 from the float32 model for Hymba; xLSTM's bf16
# teacher forcing reads 0.39, its float32 one 3.5e-4), while in float32 a
# 1e-7 relative change of the embeddings moves the logits by 2.5e-4 (xLSTM)
# and 1.4e-5 (Hymba) (H100 80GB HBM3, 700 W): the limit is about 6x xLSTM's
# reading, and Hymba's control, a prefill of 2304 (past the window, not a
# multiple of it: the ring fault of ROADMAP Queue 3), reads 0.354
TF_F32_REL, HYMBA_TF_CONTROL = 2e-3, 2304
# The bf16 decode path, at cut depth (Hymba 2 layers; xLSTM one period of 8
# and its sLSTM block alone), seeded weights: DECODE_STEPS teacher-forced
# steps (one SSD chunk, so that the prompt and the steps are whole chunks)
# after the float32 check's prefill, their logits within SERVE_REL_L2 of the
# bf16 full forward; and the first layer's float32 state after them within
# DECODE_STATE_REL of a prefill's over the same tokens. That layer's inputs
# are the same in both, so only the float32 order and the products' row
# rounding differ: 2.4e-6 (Hymba), 6.4e-5 (xLSTM), 0 (sLSTM); a decode that
# rounds the state to bf16 reads 7.3e-4 to 1.5e-3 (H100 80GB HBM3, 700 W)
DECODE_STEPS, DECODE_STATE_REL = 256, 2e-4
# Hymba's bf16 flash prefill against the plain one: both sit 5.7e-2 from the
# same weights in float32 (32 layers of bf16 rounding), above SERVE_REL_L2,
# so the gate is the float32 model: the flash prefill may be at most this
# many times as far from it as the plain prefill is (1.04 measured), and
# each planted attention fault must read above it
FLASH_F32_RATIO = 1.25
# each family's float32 model cut in depth (Hymba and Seamless: 2 layers,
# and 2 encoder layers; xLSTM: one period of 8) on the card against the CPU
# on 1 x 512 tokens (two SSD chunks): float32 products in other orders
CARD_CPU_LAYERS, CARD_CPU_LEN, CARD_CPU_REL = 2, 512, 1e-4
# phase 8: the federated train step (TAG -> aggregation plan -> fed step) on
# Qwen2.5-3B at full width and depth, classical_fl over 2 virtual clients,
# the config's FedAdam; the traffic is launch/train.py's defaults
TRAIN_CLIENTS, TRAIN_WARMUP, TRAIN_ROUNDS = 2, 1, 5
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LOCAL_STEPS, TRAIN_LR = 8, 128, 2, 0.05
# the second run: hierarchical_fl over pod 2 x data 2, bf16 cross-pod wire,
# full width at 4 layers
HIER_PODS, HIER_CLIENTS, HIER_LAYERS, HIER_ROUNDS = 2, 2, 4, 3
# the gate: the first round at 1 layer, full width, float32, on the card and
# on the CPU from the same parameters and batch (2 layers until phases 6h to
# 6g came: its CPU round was 23-39 s of the script)
GATE_LAYERS = 1
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
# phase 7c: the faulted jobs leave no device memory held after them beyond
# this (a decoded update the hub kept alive would be 1.55 GB)
FAULT_HELD_MB = 64.0
# (b): the H-FL job's west shard hub crashes on its first frame after it
# folded this many frames (its 2 trainers' round-1 uploads)
SHARD_CRASH = ("west", 2)
# (c): the reference test's FedBuff restart (tests/test_chaos.py): trainer-1
# a 50 s straggler dropped at 0.5, the server dropped at 2.5 and re-joined
# at 3.0, buffer 1; 4 versions with a checkpoint every 2 (the reference's 3
# versions with one every version wrote three checkpoints through host
# numpy): version 2's is restored, version 4's is the restarted
# incarnation's; on phase 5's tree less its embedding (``restart_init``)
RESTART_AT = (2.5, 3.0)
RESTART_VERSIONS, RESTART_CKPT_EVERY = 4, 2


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


def _median_ms(fn, runs: int = 3, warm: bool = True) -> float:
    """The median device ms of ``fn`` over ``runs`` runs (CUDA events
    around each), after a warm-up run unless the caller ran one."""
    if warm:
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


def bound(nbytes: float, flops: float, peak_flops: float = F32_FLOPS):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------- #
# phase 1
# ---------------------------------------------------------------------- #
LIBRARIES = (kernel.LIBRARY, qkernel.LIBRARY, fkernel.LIBRARY, fkernel.SM90_LIBRARY,
             fkernel.SM90_D256_LIBRARY)


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
          f"build_s {build_s:.3f} ptxas {ptxas}; host cpu_count {os.cpu_count()} "
          f"sched_affinity {len(os.sched_getaffinity(0))} mem_available_gb "
          f"{_mem_available_gb():.1f} checkpoint dir {tempfile.gettempdir()} disk_free_gb "
          f"{shutil.disk_usage(tempfile.gettempdir()).free / 1e9:.1f}", flush=True)
    return smi


def _mem_available_gb() -> float:
    """The host's available memory (``MemAvailable`` of /proc/meminfo)."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024 / 1e9
    return float("nan")


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
    shapes = qwen_shapes(CODEC_LAYERS)
    n_params = sum(int(np.prod(s)) for s in _flat_shapes(shapes))
    n_leaves = len(_flat_shapes(shapes))
    check(n_params == CODEC_PARAMS, f"tree has {n_params} parameters, not {CODEC_PARAMS}")
    check(tch.decode_pool_workers() == DECODE_POOL and tch.broadcast_fanout_enabled(),
          f"the process plane's defaults: decode pool {tch.decode_pool_workers()}, fan-out "
          f"{tch.broadcast_fanout_enabled()}")
    init = codec_init(dev)
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

    # the decode pool off: the root receives the uploads one at a time;
    # every round's weights byte-equal (sha256) to the pooled run's
    with tch.switches(decode_pool=0):
        res = run_job(JobSpec(
            tag=codec_tag(), datasets=tuple(DatasetSpec(name=f"d{i}") for i in range(CODEC_TRAINERS)),
            hyperparams={"rounds": CODEC_ROUNDS, "init_weights": codec_init(dev)}),
            device=dev, timeout=900,
            program_overrides={"trainer": NoiseTrainer, "global-aggregator": RecordingAggregator})
    check(not res.errors, f"codec job without the decode pool: errors {res.errors}")
    root = next(p for p in res.programs.values() if isinstance(p, RecordingAggregator))
    unpooled_s = root.round_s
    check([tree_digest(h) for h in root.history[1:]] == round_digests,
          "codec job without the decode pool differs from the pooled run")
    del res, root
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
    pad = leaves[0].new_zeros((-n_params) % QUANT_BLOCK)  # the codec pads to whole blocks
    flat = clock.span("cat", lambda: torch.cat([x.reshape(-1) for x in leaves] + [pad]))
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

    # (c) kernel times at full width, CUDA events, on the blocks the codec
    # quantizes (the last one zero-padded)
    x = torch.cat([x_.reshape(-1) for x_ in leaves] + [pad]).view(-1, QUANT_BLOCK)
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
    print(f"phase codec job: ok Qwen2.5-3B tree ({n_params} f32 params, {nb} blocks, layers 36->{CODEC_LAYERS}) "
          f"over the socket loopback with int8_blocks, {T} trainers, {R} rounds byte-equal to the "
          f"plain chain; job_s {job_s:.3f} round_wall_s (decode pool {tch.decode_pool_workers()}) "
          f"{[round(t, 4) for t in round_s]} (decode pool 0, byte-equal: "
          f"{[round(t, 4) for t in unpooled_s]}) "
          f"peak_device_gb {peak_gb:.2f} channel_bytes {channel_bytes} raw_bytes {raw} "
          f"codec_ratio {coded / raw:.6f} encodes {encodes} decodes {decodes}; "
          f"one message: encode_ms {ms['encode']:.3f} (cat {ms['cat']:.3f} quantize {ms['quantize']:.3f} "
          f"d2h {ms['d2h']:.3f}) socket_crossing_ms {socket_ms:.3f} decode_ms {ms['decode']:.3f} "
          f"(h2d {ms['h2d']:.3f} dequantize {ms['dequantize']:.3f}) fold_{T}_updates_ms {ms['fold']:.3f}; "
          f"serial sum per round {json.dumps({k: round(v, 3) for k, v in per_round.items()})}; "
          f"quantize ms {tq['ms']:.3f} dequantize ms {td['ms']:.3f} bound_ms {tq['bound'][0]:.3f}",
          flush=True)
    return {"launches": launches, "timings": timings, "round_digests": round_digests,
            "round_s": {"pool": list(round_s), "unpooled": list(unpooled_s)}}


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
    return _map_shapes(lambda s: 0.02 * torch.randn(s, generator=gen, device=dev),
                       qwen_shapes(CODEC_LAYERS))


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


class ProcPoolRoot(ProcRecordingAggregator):
    """Phase 5's root on the per-frame path (no reduce plan): its pooled
    receive fetches and decodes the uploads on the card. Each round it
    holds the first update the receive hands it until the fetches ahead of
    that update have landed, so the receive reaches its bound (``workers +
    1`` payloads held) on every run, and a pool that fetched past the bound
    would show in the count and in the bytes. Records the receive's
    high-water count and the device bytes each aggregate allocated above
    what the root held before it."""

    def aggregate(self):
        dev, me = self.ctx.device, self.ctx.worker.worker_id
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        base_req = torch.cuda.memory_stats(dev).get("requested_bytes.all.current")
        torch.cuda.reset_peak_memory_stats(dev)
        tch.reset_decode_pool_held(me)
        recv_ordered = tch.ChannelEnd.recv_ordered

        def first_held_until_full(end, ends, timeout=30.0):
            it = recv_ordered(end, ends, timeout)
            first = next(it, None)
            if first is None:
                return
            want = min(tch.decode_pool_workers() + 1, len(ends))
            deadline = time.monotonic() + 120.0  # a hang guard; the count gate fails
            while tch.decode_pool_held(me)[0] < want and time.monotonic() < deadline:
                time.sleep(0.002)
            yield first
            del first
            yield from it

        tch.ChannelEnd.recv_ordered = first_held_until_full
        try:
            super().aggregate()
        finally:
            tch.ChannelEnd.recv_ordered = recv_ordered
        if not self._work_done:
            torch.cuda.synchronize(dev)
            peak_req = torch.cuda.memory_stats(dev).get("requested_bytes.all.peak")
            self.metrics.append({
                "aggregate_bytes": torch.cuda.max_memory_allocated(dev) - base,
                "aggregate_requested": None if base_req is None else peak_req - base_req,
                "held_high_water": tch.decode_pool_held(me)[1]})


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
    n_leaves = len(_flat_shapes(qwen_shapes(CODEC_LAYERS)))
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
    job_a = {"job": job, "overrides": overrides, "digests": [m["digest"] for m in rounds],
             "round_s": [m["round_s"] for m in rounds], "channel_bytes": proc_bytes,
             "hub": hub, "launches": launches, "startup_s": startup_s,
             "lock_s": list(probe.lock_s),
             "driver_peak_gb": driver_peak_gb}
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

    # the switches over processes, each run's rounds byte-equal (sha256) to
    # (a)'s, each job alone (their times and the pool's count are gated or
    # reported): the decode pool off; the broadcast fan-out off; the
    # per-frame path (no reduce plan), whose root receives the uploads
    # through a pool of GATE_POOL, decodes them on the card and is held to
    # the pool's bound in payloads and in bytes
    def run(job_, **kw):
        res_ = run_job_multiproc(job_, device=dev, timeout=600, **kw)
        check(not res_.errors, f"process job errors: {res_.errors}")
        root_ = res_.program("global-aggregator-0")
        rounds_ = [m for m in root_.metrics if "digest" in m]
        check([m["digest"] for m in rounds_] == digests,
              f"process job ({sorted(kw)}) differs from phase 7a's rounds")
        return [m["round_s"] for m in rounds_], root_.metrics

    with tch.switches(decode_pool=0):
        unpooled_round_s, _ = run(job, program_overrides=overrides)
    with tch.switches(fanout=False):
        no_fanout_round_s, _ = run(job, program_overrides=overrides)
    per_frame = JobSpec(tag=job.tag, datasets=job.datasets, hyperparams={"rounds": R})
    with tch.switches(decode_pool=GATE_POOL):
        per_frame_round_s, metrics = run(per_frame, program_overrides={
            "trainer": ProcNoiseTrainer, "global-aggregator": ProcPoolRoot})
    agg_bytes = [m["aggregate_bytes"] for m in metrics if "aggregate_bytes" in m]
    agg_requested = [m["aggregate_requested"] for m in metrics if "aggregate_bytes" in m]
    high_water = [m["held_high_water"] for m in metrics if "held_high_water" in m]
    # the pool's bound in payloads: reached every round (the root holds its
    # first update until the fetches ahead of it land) and never passed
    check(high_water == [GATE_POOL + 1] * R,
          f"the root's pooled receive held at most {high_water} payloads a round, not "
          f"{GATE_POOL + 1} (the pool's {GATE_POOL} workers + 1)")
    # ... and in bytes: the accumulator; per update yielded or fetched
    # ahead, its float32 tree (whole blocks); per fetch still decoding, its
    # int8 codes and scales. The caching allocator counts a block, not the
    # request: it hands out a cached block whole when splitting would leave
    # 1 MiB or less, so each of those buffers (a leaf of the accumulator; a
    # tree, codes, scales) may count up to 1 MiB over its bytes. One more
    # update held is 1.55 GB.
    blocks_ = -(-CODEC_PARAMS // QUANT_BLOCK)
    tree_bytes, code_bytes = blocks_ * QUANT_BLOCK * 4, blocks_ * (QUANT_BLOCK + 4)
    held = CODEC_PARAMS * 4 + (GATE_POOL + 1) * tree_bytes + GATE_POOL * code_bytes
    block_slack = (n_leaves + GATE_POOL + 1 + 2 * GATE_POOL) * 2**20
    agg_limit = held + block_slack
    check(len(agg_bytes) == R and max(agg_bytes) <= agg_limit,
          f"the root's aggregate allocated {agg_bytes} bytes, over the accumulator plus "
          f"{GATE_POOL + 1} decoded updates and {GATE_POOL} updates' codes ({held}) plus "
          f"the allocator's blocks ({block_slack})")
    free_device()

    # (b) two small jobs over processes, one after the other (the deadline
    # job's grace is wall time), then each through run_job on the card
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
    mp_hier = run_job_multiproc(hier, device=dev, timeout=300, pool_size=2, sharded=True,
                                **hier_kw)
    hier_hub_folds = kernel.exact_fold_into_tree.launches
    mp_coord = run_job_multiproc(coord, device=dev, timeout=300, **coord_kw)
    small_s = time.perf_counter() - t0
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
    job_b = {"job": hier, "kw": hier_kw, "obs": _small_obs(mp_hier),
             "stats": dict(reduced)}

    lock = probe.lock_s
    fold = probe.fold_ms
    print(f"phase process plane: ok Qwen2.5-3B tree ({CODEC_PARAMS} f32 params, layers 36->{CODEC_LAYERS}) as "
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
          f"the switches, each job alone, each byte-equal to (a): round_wall_s decode pool 0 "
          f"{[round(x, 4) for x in unpooled_round_s]} (a: pool {DECODE_POOL}); fan-out off "
          f"{[round(x, 4) for x in no_fanout_round_s]}; the per-frame path (no reduce plan, "
          f"the root's pool of {GATE_POOL} decoding) {[round(x, 4) for x in per_frame_round_s]} "
          f"with the pooled receive's high-water count {high_water} payloads (bound "
          f"{GATE_POOL + 1}) and the root's aggregate allocating bytes {agg_bytes} (requested "
          f"{agg_requested}; limit {agg_limit}: the accumulator, {GATE_POOL + 1} decoded "
          f"updates of {tree_bytes} and {GATE_POOL} updates' codes of {code_bytes}, {held} in "
          f"all, plus 1 MiB for each of their {block_slack >> 20} buffers; margin "
          f"{agg_limit - max(agg_bytes)} bytes); "
          f"(b) hierarchical_fl pool_size 2 sharded reduce_plan 2 deadline with aggregator-1 "
          f"dropped at 1.5 and re-joined at 2.5 (hub_reduced {reduced['hub_reduced']}) and "
          f"coordinated_fl sync over 7 processes (exact_fold launches {coord_folds}), one "
          f"after the other in {small_s:.3f} s, byte-equal to run_job on the card", flush=True)
    return {"launches": launches, "a": job_a, "b": job_b,
            "round_s": {"pool": job_a["round_s"], "unpooled": unpooled_round_s,
                        "no_fanout": no_fanout_round_s, "per_frame": per_frame_round_s},
            "aggregate_bytes": agg_bytes, "aggregate_requested": agg_requested,
            "high_water": high_water}


# ---------------------------------------------------------------------- #
# phase 7c: the fault plane
# ---------------------------------------------------------------------- #
NEVER = float("inf")


class _FaultProbe:
    """Watches the hubs of this process through a faulted job, and fires
    its faults at points of the job's own progress. The job's ``FaultPlan``
    names each fault at time ``NEVER``, so no clock fires it; the probe
    re-arms it at time 0 (the hub then fires it on the next frame that
    qualifies) once its event has passed:

    * ``reset=(worker, broadcaster, channel, n)``: the connection reset of
      ``worker``, once ``broadcaster``'s first broadcast on ``channel`` (its
      ``n`` destinations) was dispatched, so it severs the first frame
      naming ``worker`` after it;
    * ``crash=(hub_name, channel, n)``: the crash of the hub whose backend
      is ``hub_name`` (any hub for ``""``), once it has folded ``n`` frames
      of ``channel``, so it fires on that hub's next frame.

    It records every hub armed (so the phase can check that each fault
    fired), the fold count and frame of each reset and crash, the host time
    of each restart, the device memory peak before the first restart and
    after it, and the host time of the first frame a hub served after each
    restart."""

    def __init__(self, dev, reset=None, crash=None):
        self.dev, self.reset, self.crash = dev, reset, crash
        self._sent = 0
        self.reset_armed_at = self.crash_armed_at = None

    def _folds(self, hub, channel):
        return int(hub.backend.stats.get(f"hub_reduced:{channel}", 0))

    def _after(self, hub, op, args):
        """Arm a fault whose event the frame just dispatched completed."""
        if self.reset is not None and self.reset_armed_at is None and op in ("send", "send_many"):
            worker, src, channel, n = self.reset
            if args[0] == channel and args[2] == src:
                self._sent += len(args[3]) if op == "send_many" else 1
                if self._sent >= n:
                    self.reset_armed_at = self._folds(hub, channel)
                    hub._arm_conn_resets({worker: 0.0})
        if self.crash is not None and self.crash_armed_at is None:
            name, channel, n = self.crash
            if name in ("", hub.backend.name) and self._folds(hub, channel) >= n:
                self.crash_armed_at = self._folds(hub, channel)
                hub._arm_crash(0.0)

    def __enter__(self):
        self.armed, self.crashes, self.first_after, self.resets = [], [], [], []
        self.peak_before_gb = None
        self._saved = (TransportHub._arm_crash, TransportHub._arm_conn_resets,
                       TransportHub.simulate_crash, TransportHub._dispatch,
                       TransportHub._inject_fault)
        arm_crash, arm_resets, crash, dispatch, inject = self._saved
        probe = self

        def armed_crash(hub, at):
            probe.armed.append(hub)
            return arm_crash(hub, at)

        def armed_resets(hub, resets):
            probe.armed.append(hub)
            return arm_resets(hub, resets)

        def timed_crash(hub):
            if probe.peak_before_gb is None:
                probe.peak_before_gb = torch.cuda.max_memory_allocated(probe.dev) / 1e9
                torch.cuda.reset_peak_memory_stats(probe.dev)
            channel = probe.crash[1] if probe.crash else ""
            probe.crashes.append((hub.backend.name, probe._folds(hub, channel),
                                  time.perf_counter()))
            return crash(hub)

        def watched_dispatch(hub, op, args):
            if len(probe.first_after) < len(probe.crashes):
                probe.first_after.append(time.perf_counter())
            out = dispatch(hub, op, args)
            probe._after(hub, op, args)
            return out

        def noted_inject(hub, conn, args):
            crashes = len(probe.crashes)
            fired = inject(hub, conn, args)
            if fired and len(probe.crashes) == crashes:
                channel = probe.reset[2] if probe.reset else ""
                probe.resets.append((probe._folds(hub, channel),
                                     [a for a in args if isinstance(a, str)]))
            return fired

        (TransportHub._arm_crash, TransportHub._arm_conn_resets, TransportHub.simulate_crash,
         TransportHub._dispatch, TransportHub._inject_fault) = (
            armed_crash, armed_resets, timed_crash, watched_dispatch, noted_inject)
        return self

    def __exit__(self, *exc):
        (TransportHub._arm_crash, TransportHub._arm_conn_resets, TransportHub.simulate_crash,
         TransportHub._dispatch, TransportHub._inject_fault) = self._saved

    def unfired(self) -> list:
        """The faults still armed on any hub: each fires once, so a fault
        left here never fired."""
        return [(hub.backend.name, dict(hub._conn_resets), hub._crash_at) for hub in self.armed
                if hub._conn_resets or hub._crash_at is not None]

    def recovery_ms(self) -> list:
        return [round((b - a[2]) * 1e3, 3) for a, b in zip(self.crashes, self.first_after)]


def _recovery(res) -> dict:
    root = res.program("global-aggregator-0")
    return next((m["transport_recovery"] for m in root.metrics if "transport_recovery" in m), {})


def program_bytes(dev) -> int:
    """The device bytes the program's own tensors hold: read after a
    collection and a synchronize, with cuBLAS's workspaces released (PyTorch
    keeps one per (handle, stream), so which threads and streams ran a
    product since the last reading would otherwise count), and never inside
    a profiler session. Every held-memory gate reads both its sides so."""
    check(not torch.autograd._profiler_enabled(), "device memory read inside a profiler session")
    gc.collect()
    torch.cuda.synchronize(dev)
    torch._C._cuda_clearCublasWorkspaces()
    return torch.cuda.memory_allocated(dev)


def _live_blocks(dev, limit: int = 20) -> list:
    """The largest live allocator blocks: size, stream and the frames of
    the allocation where the allocator recorded them."""
    out = []
    for seg in torch.cuda.memory_snapshot():
        if seg.get("device", dev.index) != dev.index:
            continue
        for blk in seg.get("blocks", ()):
            if blk.get("state") == "active_allocated":
                frames = [f"{f.get('filename')}:{f.get('line')} {f.get('name')}"
                          for f in blk.get("frames", ())[:6]]
                out.append({"size": blk.get("size"), "stream": seg.get("stream"),
                            "frames": frames})
    return sorted(out, key=lambda b: -(b["size"] or 0))[:limit]


def check_held(dev, before: int, limit_mb: float, what: str, strict: bool = False) -> float:
    """Gate the megabytes of device memory held beyond ``before`` (a
    ``program_bytes`` reading): at most ``limit_mb`` (under it when
    ``strict``). On failure print the live blocks first."""
    held = (program_bytes(dev) - before) / 1e6
    if held > limit_mb or (strict and held >= limit_mb):
        print(f"{what}: {held:.1f} MB held; live blocks "
              f"{json.dumps(_live_blocks(dev))}", flush=True)
        raise PhaseFailed(f"{held:.1f} MB of device memory held after {what}")
    return held


class ProcVersionNoiseTrainer(Trainer):
    """``noisy`` of (dataset, 1 + the server version it trained from) on the
    card: an upload lost to a server restart and trained again from the
    restored version is the same bytes. Its weights stay in its process."""

    def train(self):
        if self.weights is None or self._work_done:
            return
        self.weights = noisy(self.weights, self.ctx.worker.dataset, 1 + self._server_version)
        self.num_samples = samples_of(self.ctx.worker.dataset)

    def run(self):
        super().run()
        self.weights = None


def _timed_checkpoints(times: dict) -> None:
    """Time this process's checkpoint saves and loads into ``times``. After
    each save the older steps' files go: a restart reads the newest only,
    and each file holds several copies of the tree (weights, snapshots, the
    strategy's accumulator), 8 GB at phase 5's depth."""
    ck = roles_async.checkpoint
    if getattr(ck.save, "_timed", False):
        return
    save, load = ck.save, ck.load_tree

    def timed_save(directory, step, tree):
        t0 = time.perf_counter()
        path = save(directory, step, tree)
        times.setdefault("save_s", []).append(round(time.perf_counter() - t0, 4))
        times.setdefault("bytes", []).append(os.path.getsize(path))
        for name in os.listdir(directory):
            if name.endswith(".npz") and os.path.join(directory, name) != path:
                os.unlink(os.path.join(directory, name))
        return path

    def timed_load(directory, step, device):
        t0 = time.perf_counter()
        tree = load(directory, step, device=device)
        torch.cuda.synchronize(device)
        times.setdefault("restore_s", []).append(round(time.perf_counter() - t0, 4))
        return tree

    timed_save._timed = True
    ck.save, ck.load_tree = timed_save, timed_load


def restart_init(dev):
    """7c (c)'s initial weights: phase 5's, less the embedding (the layer at
    full width and the final norm, 77 M parameters). A checkpoint holds
    five copies of the tree (weights, base snapshots, the accumulator) and
    moves through host numpy at about 0.7 GB/s: 1.55 GB a save instead of
    the whole tree's 7.76 GB (10 s a save)."""
    init = codec_init(dev)
    del init["embed"]
    return init


class ProcAsyncRoot(GlobalAggregator):
    """Lowered to the FedBuff root: draws 7c (c)'s initial weights itself
    (the job carries none to its processes) and reports the checkpoint
    saves and loads of its incarnation in its metrics."""

    def __init__(self, ctx):
        super().__init__(ctx)
        self.weights = restart_init(ctx.device)
        self._ckpt_times: dict = {}
        _timed_checkpoints(self._ckpt_times)

    def run(self):
        try:
            super().run()
        finally:
            self.metrics.append({"checkpoint_times": dict(self._ckpt_times)})


def phase_fault_plane(dev: torch.device, proc: dict) -> dict:
    """(a) phase 7a's job under a connection reset and a hub crash; (b)
    phase 7b's H-FL job with a shard hub crashed; (c) a FedBuff server
    restarted from its checkpoint over processes; each against its
    fault-free run."""
    a, b = proc["a"], proc["b"]
    T, R = CODEC_TRAINERS, CODEC_ROUNDS
    # the faults fire at points of this job's own progress (no clock fires
    # them): trainer-1's connection reset on the first frame naming it after
    # the root's round-1 broadcast went out (its round-1 upload, or an op on
    # its way there), so before round 1's last fold; the hub's crash on the
    # first frame after round 1's last fold (round 1's partial to the root
    # or round 2's broadcast), so after exactly T folds
    plan = FaultPlan(conn_resets={"trainer-1": NEVER}, hub_crashes={"": NEVER})
    events = dict(reset=("trainer-1", "global-aggregator-0", "param-channel", T),
                  crash=("", "param-channel", T))
    free_device()
    before = program_bytes(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    kernel.reset_launches()
    qkernel.reset_launches()
    t0 = time.perf_counter()
    with _HubProbe() as hub_probe, _FaultProbe(dev, **events) as faults:
        res = run_job_multiproc(a["job"], device=dev, timeout=600, policy=RuntimePolicy(faults=plan),
                                program_overrides=a["overrides"])
        job_s = time.perf_counter() - t0
        peak_after_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        unfired = faults.unfired()
    hub = {fn.__name__: fn.launches for fn in qkernel.KERNELS + kernel.KERNELS}
    check(not res.errors, f"faulted process job errors: {res.errors}")
    rec = _recovery(res)
    check(not unfired and rec.get("hub_restarts", 0) >= 1 and rec.get("resumes", 0) >= 1,
          f"a fault did not fire or was not recovered: unfired {unfired}, recovery {rec}")
    check(faults.reset_armed_at == 0 and len(faults.resets) == 1 and faults.resets[0][0] < T,
          f"the reset was armed after {faults.reset_armed_at} folds and fired at (folds, the "
          f"frame's names) {faults.resets}, not after round 1's broadcast and before its last fold")
    check([c[1] for c in faults.crashes] == [T],
          f"the hub crashed after {[c[1] for c in faults.crashes]} folds, not after round 1's "
          f"last ({T})")
    root = res.program("global-aggregator-0")
    programs = [root, *(res.program(f"trainer-{i}") for i in range(T))]
    rounds = [m for m in root.metrics if "digest" in m]
    check([m["digest"] for m in rounds] == a["digests"],
          "faulted job's rounds differ from phase 7a's fault-free rounds")
    check(res.channel_bytes["param-channel"] == a["channel_bytes"],
          f"channel_bytes {res.channel_bytes['param-channel']} != 7a's {a['channel_bytes']}")
    check(hub == a["hub"], f"hub launches {hub} != 7a's {a['hub']}: a frame folded twice or lost")
    launches_a = _proc_launches(hub, programs)
    check(launches_a == a["launches"], f"launches {launches_a} != 7a's {a['launches']}")
    stats = res.channel_stats["param-channel"]
    check(stats.get("hub_reduced") == R * T and stats.get("hub_partials") == R,
          f"hub reduce stats {stats}")
    del res, root, programs
    held_a = check_held(dev, before, FAULT_HELD_MB, "the faulted job")
    lock = hub_probe.lock_s
    a_line = (f"(a) trainer-1's connection reset armed after the root's round-1 broadcast "
              f"({faults.reset_armed_at} folds), fired at (folds, the frame's names) "
              f"{faults.resets}; the hub crash armed after round 1's last fold, fired after "
              f"{[c[1] for c in faults.crashes]} of {R * T} folds; transport_recovery "
              f"{json.dumps(rec)}; {R} rounds byte-equal to "
              f"7a, channel_bytes and every launch count equal (hub exact_fold_into_tree "
              f"{hub['exact_fold_into_tree']} dequantize_blocks {hub['dequantize_blocks']}); job_s "
              f"{job_s:.3f} round_wall_s {[round(m['round_s'], 4) for m in rounds]} (7a "
              f"{[round(x, 4) for x in a['round_s']]}); hub under the lock per frame s "
              f"{[round(x, 3) for x in lock]} (7a {[round(x, 3) for x in a['lock_s']]}); driver peak "
              f"device GB before the crash {faults.peak_before_gb:.3f}, after it "
              f"{peak_after_gb:.3f} (7a's job {a['driver_peak_gb']:.3f}); crash to the next "
              f"frame served ms {faults.recovery_ms()}; held after the job {held_a:.1f} MB")
    print(f"phase fault plane {a_line}", flush=True)

    # (b) the H-FL job with its west shard hub crashed on the first frame
    # after the shard's round-1 folds (its trainers' uploads), alone
    kw = dict(b["kw"])
    shard, shard_folds = SHARD_CRASH
    kw["policy"] = dataclasses.replace(kw["policy"], faults=FaultPlan(hub_crashes={shard: NEVER}))
    before = program_bytes(dev)
    kernel.reset_launches()
    qkernel.reset_launches()
    t0 = time.perf_counter()
    with _FaultProbe(dev, crash=(f"multiproc-hub:{shard}", "param-channel", shard_folds)) as faults:
        res = run_job_multiproc(b["job"], device=dev, timeout=300, pool_size=2, sharded=True, **kw)
        unfired = faults.unfired()
    job_b_s = time.perf_counter() - t0
    hub_b = {fn.__name__: fn.launches for fn in qkernel.KERNELS + kernel.KERNELS}
    check(not res.errors, f"faulted sharded job errors: {res.errors}")
    rec_b = _recovery(res)
    check(not unfired and rec_b.get("hub_restarts", 0) >= 1,
          f"the shard crash did not fire: unfired {unfired}, recovery {rec_b}")
    check([c[:2] for c in faults.crashes] == [(f"multiproc-hub:{shard}", shard_folds)],
          f"the crashes {[c[:2] for c in faults.crashes]} are not the {shard} shard's after its "
          f"{shard_folds} round-1 folds")
    check(_small_obs(res) == b["obs"], "faulted sharded H-FL job differs from phase 7b's")
    reduced = res.channel_stats["param-channel"]
    check(reduced.get("hub_reduced") == b["stats"].get("hub_reduced")
          and hub_b["exact_fold_into_tree"] == reduced["hub_reduced"],
          f"shard hubs folded {hub_b['exact_fold_into_tree']} frames, reduced {reduced}, "
          f"7b {b['stats']}")
    # (b)'s frames are float32: no codec kernel ran in this process
    check(hub_b["dequantize_blocks"] == 0 and hub_b["quantize_blocks"] == 0,
          f"codec launches in this process during (b): {hub_b}")
    launches_b = _proc_launches(hub_b, res.programs.values())
    del res
    held_b = check_held(dev, before, FAULT_HELD_MB, "the sharded job")

    # (c) a FedBuff server restarted from its checkpoint, then its
    # fault-free run, each alone (their results are gated on virtual times)
    per_worker = {"trainer-0": {"compute_time": 1.0},
                  "trainer-1": {"compute_time": 50.0}}  # never finishes an upload
    # the grace outlasts a coded full-width round trip on a loaded host (the
    # reference test's 3 s is for a toy model)
    pol = dict(mode="async", buffer_size=1, grace=POLICY_GRACE_S, dropouts={"trainer-1": 0.5})
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    overrides = {"trainer": ProcVersionNoiseTrainer, "global-aggregator": ProcAsyncRoot}

    def fedbuff_job(**hp):
        return JobSpec(tag=codec_tag(), datasets=(DatasetSpec(name="d0"), DatasetSpec(name="d1")),
                       hyperparams={"rounds": RESTART_VERSIONS, **hp})

    before_c = program_bytes(dev)
    t_c = time.perf_counter()
    try:
        restarted = run_job_multiproc(
            fedbuff_job(checkpoint_every=RESTART_CKPT_EVERY, checkpoint_dir=ckpt_dir),
            device=dev, timeout=600, per_worker_hyperparams=per_worker,
            program_overrides=overrides,
            policy=RuntimePolicy(**pol, faults=FaultPlan(
                server_restarts={"global-aggregator-0": RESTART_AT})))
        restarted_s = time.perf_counter() - t_c
        ckpt_files = sorted(os.listdir(os.path.join(ckpt_dir, "global-aggregator-0")))
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    t_clean = time.perf_counter()
    clean = run_job_multiproc(fedbuff_job(), device=dev, timeout=600,
                              policy=RuntimePolicy(**pol), per_worker_hyperparams=per_worker,
                              program_overrides=overrides)
    clean_s = time.perf_counter() - t_clean
    check(not clean.errors, f"fault-free FedBuff job errors: {clean.errors}")
    check(not restarted.errors, f"restarted FedBuff job errors: {restarted.errors}")
    glob, cglob = restarted.program("global-aggregator-0"), clean.program("global-aggregator-0")

    def absorbed(p):
        return [(e["src"], e["version"], e["staleness"]) for e in p.staleness_log]

    check(absorbed(glob) == absorbed(cglob)
          == [("trainer-0", v, 0) for v in range(RESTART_VERSIONS)],
          f"absorbed {absorbed(glob)} != fault-free {absorbed(cglob)}")
    check(glob.version == cglob.version == RESTART_VERSIONS
          and glob.version_vector == cglob.version_vector,
          f"versions {glob.version} {glob.version_vector} != {cglob.version} {cglob.version_vector}")
    check({"restored_step": 2} in glob.metrics, f"no restored_step 2 in {glob.metrics}")
    check(restarted.dropped.get("global-aggregator-0") == RESTART_AT[0]
          and (RESTART_AT[0], "dropout", "global-aggregator-0") in restarted.events
          and (RESTART_AT[1], "rejoin", "global-aggregator-0") in restarted.events,
          f"the restart is not in the events: {restarted.dropped} {restarted.events}")
    final = tree_digest(restarted.global_weights())
    restart_params = sum(x.numel() for x in tree_leaves(restarted.global_weights()))
    check(final == tree_digest(clean.global_weights()),
          "restarted FedBuff job's final weights differ from the fault-free run's")
    check(final != tree_digest(restart_init(dev)), "the FedBuff job did not train")
    times = next(m["checkpoint_times"] for m in glob.metrics if "checkpoint_times" in m)
    check(times.get("restore_s") and times.get("save_s"),
          f"the restarted server neither restored nor saved: {times}")
    launches_c = _proc_launches({}, restarted.programs.values())
    glob_vv = dict(glob.version_vector)
    del clean, restarted, glob, cglob
    check_held(dev, before_c, FAULT_HELD_MB, "the FedBuff jobs")

    launches = dict(launches_a)
    for extra in (launches_b, launches_c):
        for name, n in extra.items():
            launches[name] = launches.get(name, 0) + n
    print(f"phase fault plane: ok Qwen2.5-3B tree ({CODEC_PARAMS} f32 params, layers "
          f"36->{CODEC_LAYERS}) (a) as above; (b) hierarchical_fl sharded pooled deadline job with "
          f"the {shard} shard hub crashed after its {shard_folds} round-1 folds, alone, byte-equal "
          f"to 7b, transport_recovery {json.dumps(rec_b)}, hub_reduced {reduced['hub_reduced']}, "
          f"job_s {job_b_s:.3f}, held after {held_b:.1f} MB; (c) FedBuff buffer 1 over processes "
          f"on the int8_blocks channel, server dropped at {RESTART_AT[0]} and re-joined at "
          f"{RESTART_AT[1]}, restored_step 2, {RESTART_VERSIONS} versions of trainer-0 absorbed "
          f"(a checkpoint every {RESTART_CKPT_EVERY}) on phase 5's tree less its embedding "
          f"({restart_params} f32 params), version vector {glob_vv}, final weights "
          f"byte-equal to the fault-free run (each alone: restarted job_s {restarted_s:.3f}, "
          f"fault-free {clean_s:.3f}); checkpoint files left {ckpt_files}, the restarted "
          f"incarnation's saves and restore {json.dumps(times)}", flush=True)
    return {"launches": launches}


# ---------------------------------------------------------------------- #
# phase 6
# ---------------------------------------------------------------------- #
# (B, S, H, Hkv, D, causal, window, dtype): the five shapes and the bf16
# case of tests/test_kernels.py, the bf16 shapes the tensor-core kernels
# take (D 64 and 128: causal, not, a window whose rows' first visited
# tiles are all masked, a non-causal window, GQA 8:1, ragged S; D 256:
# causal GQA, not, such a window, ragged S with GQA 8:1), float32 at D 128
# and bf16 at D 32 (flash.cu only), Hymba-1.5B's heads and window and
# Gemma-7B's prefill, and the serving prefill's shape last
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
    (1, 192, 4, 4, 256, False, 0, torch.bfloat16),
    (1, 400, 4, 1, 256, True, 100, torch.bfloat16),
    (1, 300, 8, 1, 256, True, 0, torch.bfloat16),
    (1, 2049, 16, 2, 128, True, 0, torch.bfloat16),
    (1, 512, 64, 4, 128, True, 0, torch.bfloat16),  # Qwen3-MoE's heads: GQA 16:1
    (1, 4096, 25, 5, 64, True, 2048, torch.bfloat16),  # Hymba's: GQA 5:1, odd heads, window
    (SERVE_BATCH, SERVE_PROMPT, 16, 16, 256, True, 0, torch.bfloat16),  # Gemma-7B's prefill
    (SERVE_BATCH, SERVE_PROMPT, 16, 2, 128, True, 0, torch.bfloat16),
)
# the routes' counters and the C entries they launch
ROUTE_ENTRIES = {"flash_forward": "flash_attention_forward",
                 "flash_forward_sm90": "flash_attention_forward_sm90",
                 "flash_forward_sm90_d256": "flash_attention_forward_sm90_d256"}
ROUTE_TAGS = {"flash_forward": "simt", "flash_forward_sm90": "sm90",
              "flash_forward_sm90_d256": "sm90_d256"}


def on_entry(entry: str = "", n: int = 0) -> dict:
    """The launches a path expects on each C entry: ``n`` on ``entry``, 0
    on the others."""
    return {e: n * (e == entry) for e in ROUTE_ENTRIES.values()}


def _qkv(dev, gen, B, S, H, Hkv, D, dtype):
    return (torch.randn(B, S, H, D, generator=gen, device=dev).to(dtype),
            torch.randn(B, S, Hkv, D, generator=gen, device=dev).to(dtype),
            torch.randn(B, S, Hkv, D, generator=gen, device=dev).to(dtype))


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def _attention_without_tile(q, k, v, *, causal=True, window=0):
    """Causal plain attention (under ``window``, if any) with a planted
    fault: the FAULT_KEYS keys from S/2 on are masked for every row, as a
    kernel that skips one KV tile would compute. (B, S, H, D) layout, the
    flash op's signature."""
    check(causal, "the planted tile fault is causal")
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    lo = S // 2 - S // 2 % FAULT_KEYS
    pos = torch.arange(S, device=q.device)
    keep = (pos[None, :] <= pos[:, None]) & ~((pos >= lo) & (pos < lo + FAULT_KEYS))[None, :]
    if window:
        keep &= pos[None, :] > pos[:, None] - window
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


def phase_flash_parity(dev: torch.device) -> None:
    """(a) the flash kernels against their plain version on the same
    tensors, by max abs error and by relative L2: each case through the
    wrapper (one launch, on the route its dtype and head dim pick), and the
    cases of the tensor-core routes also on flash.cu directly; then the
    plain version with one KV tile dropped against it at the serving shape
    (a control that the relative limit must see)."""
    gen = torch.Generator(device=dev).manual_seed(13)
    errs, rels, routes = [], [], []
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
        if route != "flash_forward":  # flash.cu takes these too
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
            routes.append(ROUTE_TAGS[name])
        del runs
    # the last case is the serving shape: a dropped tile must show
    control = _attention_without_tile(q, k, v)
    control_rel = _rel_l2(control, plain)
    control_err = float((control.float() - plain.float()).abs().max())
    check(control_rel > FLASH_REL_L2[dtype],
          f"one dropped KV tile reads rel L2 {control_rel}, within the limit {FLASH_REL_L2[dtype]}")
    del q, k, v, plain, control
    torch.cuda.synchronize()
    print(f"phase serve parity: ok the three flash kernels within atol 2e-5 / 3e-2 and rel L2 1e-5 / "
          f"5e-3 (f32 / bf16) of their plain version in {len(errs)} runs of {len(FLASH_CASES)} "
          f"cases, one launch on the route of each; route {routes} max_abs_err "
          f"{[f'{e:.3g}' for e in errs]} rel_l2 {[f'{r:.3g}' for r in rels]}; control (plain with "
          f"{FAULT_KEYS} keys dropped, serving shape) rel_l2 {control_rel:.3g} max_abs_err "
          f"{control_err:.3g}", flush=True)


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
    # the raw trace: ``prof.events()`` would build the profiler's event tree
    # first, tens of seconds for the 176 000 kernels of an xLSTM prefill
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        full = e.name()
        name = full.lower()
        cls = ("flash" if "flash_kernel" in name else
               "gemm" if any(w in name for w in ("gemm", "xmma", "cutlass", "nvjet", "cublas")) else
               "other")
        t = e.duration_ns() / 1e6
        ms[cls] += t
        if cls == "other":
            other[full[:60]] = other.get(full[:60], 0.0) + t
        n += 1
    check(n > 0, "the profiler recorded no device kernels")
    busy = sum(ms.values())
    top = sorted(other.items(), key=lambda kv: -kv[1])[:3]
    return {"wall_ms": wall_ms, "kernels": n, "busy_share": busy / wall_ms,
            **{f"{k}_ms": v for k, v in ms.items()},
            "top_other_ms": [[k, round(v, 3)] for k, v in top]}


def _route_launches() -> dict:
    return {entry: fkernel.ROUTES[name].launches for name, entry in ROUTE_ENTRIES.items()}


def phase_serve(dev: torch.device) -> dict:
    """(b) serving the full Qwen2.5-3B through ``serve.generate`` with the
    flash kernel, with the checks of every serving phase
    (``_serve_phase``); (c) its times, the tensor-core kernel at the
    serving shape and flash.cu at the same shape in float32 (CUDA cores:
    TF32 would miss the 2e-5 limit)."""
    cfg = dataclasses.replace(get_config("qwen2_5_3b"), attn_impl="flash")
    _published(cfg, num_layers=36, d_model=2048, num_heads=16, num_kv_heads=2, head_dim=128,
               scan_layers=True, param_dtype="bfloat16")
    check(_tree_param_count(cfg) == QWEN_FULL_PARAMS,
          f"the JAX-shaped tree counts {_tree_param_count(cfg)} parameters, not {QWEN_FULL_PARAMS}")
    shape = (SERVE_BATCH, SERVE_PROMPT, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, 0)
    return _serve_phase(
        dev, "Qwen2.5-3B", cfg, SERVE_PROMPT,
        on_entry("flash_attention_forward_sm90", cfg.num_layers),
        pieces={"flash": (blocks, "flash_attention")},
        step_pieces={"attention": (blocks, "_attn_core_decode")},
        flash_shapes=[shape + (torch.bfloat16,), shape + (torch.float32,)])


# ---------------------------------------------------------------------- #
# phase 6d: serving the mixture-of-experts model
# ---------------------------------------------------------------------- #
class _RegionTimer:
    """CUDA events around the MoE layer's pieces (routing and dispatch,
    the expert products, the combine) and the flash attention while a
    prefill or a decode step runs: device ms per piece (one stream, so the
    events bracket each piece's kernels)."""

    PIECES = {"route": (tmoe, "_route"), "experts": (tmoe, "expert_ffn"),
              "combine": (tmoe, "_combine"), "flash": (blocks, "flash_attention")}

    def __init__(self, pieces=None):
        """``pieces``: name -> (module, function name); the MoE pieces when
        None."""
        if pieces is not None:
            self.PIECES = pieces

    def __enter__(self):
        self.events = {name: [] for name in self.PIECES}
        self._saved = {name: getattr(mod, attr) for name, (mod, attr) in self.PIECES.items()}
        for name, (mod, attr) in self.PIECES.items():
            setattr(mod, attr, self._timed(name, self._saved[name]))
        return self

    def _timed(self, name, fn):
        def run(*args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.events[name].append((start, end))
            return out
        return run

    def __exit__(self, *exc):
        for name, (mod, attr) in self.PIECES.items():
            setattr(mod, attr, self._saved[name])
        torch.cuda.synchronize()
        self.ms = {name: sum(a.elapsed_time(b) for a, b in ev) for name, ev in self.events.items()}


class _PinnedRouting:
    """Records the experts each MoE routing call picks (``moe._top_k``, one
    call a layer), and after ``replay(transform)`` hands the recorded picks
    back, through ``transform``, in the same order: a later run then routes
    each token to the experts the recorded run picked for it, weighted by
    its own router probabilities."""

    def __enter__(self):
        self._top_k, self.picks, self._replay, self.calls = tmoe._top_k, [], None, 0

        def top_k(x, k):
            self.calls += 1
            if self._replay is None:
                vals, idx = self._top_k(x, k)
                self.picks.append(idx)
                return vals, idx
            idx = self._replay.pop(0)
            return torch.gather(x, -1, idx), idx

        tmoe._top_k = top_k
        return self

    def replay(self, transform=lambda idx: idx):
        self._replay = [transform(idx) for idx in self.picks]

    def __exit__(self, *exc):
        tmoe._top_k = self._top_k


def _moe_param_count(cfg) -> int:
    """The parameters of the model's tree: untied embedding and unembedding
    at the padded vocabulary, per layer two norms, attention (no biases)
    and the MoE block (float32 router, stacked experts), the final norm."""
    d, E, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    attn = d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d
    layer = 2 * d + attn + d * E + 3 * E * d * ff
    return 2 * cfg.padded_vocab * d + cfg.num_layers * layer + d


def phase_serve_moe(dev: torch.device) -> dict:
    """Serving Qwen3-MoE-235B-A22B at its published widths, depth cut to
    MOE_LAYERS, through ``serve.generate`` with the flash kernel; checks
    and times, and the tensor-core flash kernel at its attention shape."""
    B, S, T = SERVE_BATCH, SERVE_PROMPT, SERVE_GEN
    full = get_config("qwen3_moe_235b_a22b")
    check((full.num_layers, full.d_model, full.num_heads, full.num_kv_heads, full.head_dim,
           full.num_experts, full.experts_per_token, full.moe_d_ff, full.vocab_size,
           full.tie_embeddings, full.param_dtype, full.moe_every)
          == (94, 4096, 64, 4, 128, 128, 8, 1536, 151936, False, "bfloat16", 1),
          "qwen3_moe_235b_a22b is not the published config")
    cfg = dataclasses.replace(full, num_layers=MOE_LAYERS, attn_impl="flash")
    free_device()
    before = program_bytes(dev)
    bundle = build_model(cfg, dev)
    plain_bundle = build_model(dataclasses.replace(cfg, attn_impl="xla"), dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = bundle.init(gen)
    n_params = sum(x.numel() for x in tree_leaves(params))
    check(n_params == _moe_param_count(cfg), f"{n_params} parameters, not {_moe_param_count(cfg)}")
    params_gb = sum(x.numel() * x.element_size() for x in tree_leaves(params)) / 1e9
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)

    # the main path: one generate call, launches counted from 0
    fkernel.reset_launches()
    out = generate(bundle, params, prompts, T)
    launches = fkernel.flash_attention_bhsd.launches
    routes = _route_launches()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    check(out.all_finite, "non-finite logits while serving the MoE model")
    check(out.tokens.shape == (B, T), f"tokens {tuple(out.tokens.shape)}")
    on_path = on_entry("flash_attention_forward_sm90", MOE_LAYERS)
    check(launches == MOE_LAYERS and routes == on_path,
          f"{launches} flash launches ({routes}) in a prefill and {T - 1} decode steps, "
          f"not {on_path}")

    # per call: one launch a layer per prefill, none per decode step
    fkernel.reset_launches()
    logits_f, cache = bundle.prefill(params, {"tokens": prompts}, bundle.init_cache(B, S + 1))
    per_prefill, per_prefill_routes = fkernel.flash_attention_bhsd.launches, _route_launches()
    nxt = torch.argmax(logits_f[:, -1], dim=-1, keepdim=True).to(torch.int32)
    fkernel.reset_launches()
    cache = bundle.serve_step(params, cache, {"token": nxt})[1]
    per_step = fkernel.flash_attention_bhsd.launches
    check(per_prefill == MOE_LAYERS and per_prefill_routes == on_path and per_step == 0,
          f"flash launches per prefill {per_prefill} ({per_prefill_routes}), per decode step "
          f"{per_step}")
    del cache
    # the flash prefill against the plain attention's, both routing every
    # token to the experts the flash prefill picked (a top-k choice turns a
    # bf16 rounding difference in the router's input into another expert);
    # and, unpinned, the plain prefill as it routes itself
    with _PinnedRouting() as pin:
        logits_f = bundle.prefill(params, {"tokens": prompts}, bundle.init_cache(B, S + 1))[0]
        pin.replay()
        logits_x = plain_bundle.prefill(params, {"tokens": prompts},
                                        plain_bundle.init_cache(B, S + 1))[0]
    logits_u = plain_bundle.prefill(params, {"tokens": prompts},
                                    plain_bundle.init_cache(B, S + 1))[0]
    fx_rel = _rel_l2(logits_f, logits_x)
    fx_err = float((logits_f - logits_x).abs().max())
    unpinned_rel = _rel_l2(logits_f, logits_u)
    check(all(bool(torch.isfinite(x).all()) for x in (logits_f, logits_x, logits_u)),
          "non-finite prefill logits")
    check(pin.calls == 2 * MOE_LAYERS, f"{pin.calls} routing calls pinned, not {2 * MOE_LAYERS}")
    check(fx_rel <= SERVE_REL_L2,
          f"MoE flash vs plain prefill logits (routing pinned): rel L2 {fx_rel} > {SERVE_REL_L2}")
    del logits_x, logits_u
    # teacher forcing at capacity factor 8 (no slot dropped, so the decode
    # step routes as the longer prefill does): a decode step after a
    # prefill of S tokens against a prefill of S + 1
    tf = build_model(dataclasses.replace(cfg, capacity_factor=MOE_TF_CAPACITY), dev)
    P, L = MOE_TF_PROMPTS, MOE_TF_LEN
    tf_prompts = prompts[:P, :L + 1]

    def teacher_forcing():
        """(the decode step's logits after a prefill of L, a prefill of L + 1's)"""
        _, cache_ = tf.prefill(params, {"tokens": tf_prompts[:, :-1]}, tf.init_cache(P, L + 1))
        step, _ = tf.serve_step(params, cache_, {"token": tf_prompts[:, -1:]})
        return step

    # pinned: the prefill of L + 1 routes itself; the prefill of L and the
    # decode step route each token as it did (one routing block each)
    # [0], [1]: a name for a returned cache would keep it to the phase's end
    with _PinnedRouting() as pin:
        logits_s1 = tf.prefill(params, {"tokens": tf_prompts}, tf.init_cache(P, L + 1))[0]
        k = cfg.experts_per_token
        pin.replay(lambda idx: idx.view(P, L + 1, k)[:, :L].reshape(1, P * L, k))
        cache = tf.prefill(params, {"tokens": tf_prompts[:, :-1]}, tf.init_cache(P, L + 1))[1]
        pin.replay(lambda idx: idx.view(P, L + 1, k)[:, L:].reshape(1, P, k))
        logits_d = tf.serve_step(params, cache, {"token": tf_prompts[:, -1:]})[0]
    check(pin.calls == 3 * MOE_LAYERS, f"{pin.calls} routing calls, not {3 * MOE_LAYERS}")
    tf_rel = _rel_l2(logits_d, logits_s1)
    tf_err = float((logits_d - logits_s1).abs().max())
    tf_unpinned_rel = _rel_l2(teacher_forcing(), logits_s1)
    check(bool(torch.isfinite(logits_d).all()) and tf_rel <= SERVE_REL_L2,
          f"MoE teacher forcing (routing pinned): rel L2 {tf_rel} > {SERVE_REL_L2}")
    # the picks are views of whole sort indices; the prompts' view holds them
    del cache, logits_d, logits_s1, logits_f, pin, tf_prompts
    gc.collect()
    torch.cuda.empty_cache()

    # times: the prefill (median of 3 after a warm-up, CUDA events), a
    # decode step (from generate), and where the device time of each goes
    def prefill():
        return bundle.prefill(params, {"tokens": prompts}, bundle.init_cache(B, S + T))

    prefill_ms = _median_ms(prefill)
    prof_prefill = _kernel_classes(prefill)
    with _RegionTimer() as regions_prefill:
        cache = prefill()[1]
    with _RegionTimer() as regions_step:
        bundle.serve_step(params, cache, {"token": nxt})
    del cache
    decode_ms = out.decode_s / (T - 1) * 1e3
    out_prefill_ms = out.prefill_s * 1e3
    cache = prefill()[1]
    prof_step = _kernel_classes(lambda: bundle.serve_step(params, cache, {"token": nxt}))
    del cache, params, bundle, plain_bundle, tf, out, prompts, nxt
    free_device()
    held_mb = check_held(dev, before, 1.0, "the MoE phase", strict=True)

    # the tensor-core flash kernel at the model's attention shape, against
    # the plain version and SDPA; the bound is the causal products' work
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(2)
    q, k, v = _qkv(dev, gen, B, S, H, Hkv, D, torch.bfloat16)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    plain = fref.reference_attention(q, k, v)
    got = flash_attention(q, k, v)
    err, rel = float((got.float() - plain.float()).abs().max()), _rel_l2(got, plain)
    check(err <= FLASH_ATOL[torch.bfloat16] and rel <= FLASH_REL_L2[torch.bfloat16],
          f"flash at the MoE shape: max abs err {err}, rel L2 {rel}")
    del plain, got
    nbytes = 2 * (2 * B * S * H * D + 2 * B * S * Hkv * D)
    flops = 4 * D * B * H * (S * (S + 1) // 2)
    flash = dict(
        ms=cuda_ms(lambda: flash_attention(q, k, v), reps=20),
        plain_ms=cuda_ms(lambda: fref.reference_attention(q, k, v), reps=2),
        library_ms=cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), reps=20),
        bound=bound(nbytes, flops, BF16_TENSOR_FLOPS), max_abs_err=err)
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    # the expert products' work and their least time: 3 products of
    # (E, C_total, d) x (d, ff) per layer, and a decode step's expert
    # weights read once per layer
    nb = tmoe.route_blocks(S * B)
    C = tmoe._capacity(S * B // nb, cfg)
    expert_flops = MOE_LAYERS * 3 * 2 * cfg.num_experts * nb * C * cfg.d_model * cfg.moe_d_ff
    expert_bytes = MOE_LAYERS * 3 * cfg.num_experts * cfg.d_model * cfg.moe_d_ff * 2
    print(f"phase serve moe: Qwen3-MoE-235B-A22B (published widths, {MOE_LAYERS} of "
          f"{full.num_layers} layers, {n_params} bf16 params ({params_gb:.2f} GB), 128 experts "
          f"top-8, random weights) B {B} prompt {S} gen {T} with the flash kernel; flash "
          f"launches {launches} {json.dumps(routes)} (per prefill {per_prefill}, per decode step "
          f"{per_step}); flash vs plain prefill (routing pinned to the flash run's) rel_l2 "
          f"{fx_rel:.3g} max_abs_err {fx_err:.3g} (unpinned: rel_l2 {unpinned_rel:.3g}); "
          f"teacher forcing (capacity {MOE_TF_CAPACITY}, {MOE_TF_PROMPTS} prompts of "
          f"{MOE_TF_LEN}, routing pinned to the longer prefill's) rel_l2 {tf_rel:.3g} max_abs_err "
          f"{tf_err:.3g} (unpinned: rel_l2 {tf_unpinned_rel:.3g}); prefill_ms "
          f"{prefill_ms:.3f} (in generate {out_prefill_ms:.3f}) decode_ms_per_step "
          f"{decode_ms:.3f}; peak_device_gb {peak_gb:.2f}; held after {held_mb:.1f} MB; "
          f"prefill pieces device ms {json.dumps({k: round(v, 3) for k, v in regions_prefill.ms.items()})} "
          f"decode step pieces device ms {json.dumps({k: round(v, 3) for k, v in regions_step.ms.items()})}; "
          f"prefill profile {json.dumps(_rounded(prof_prefill))} decode step profile "
          f"{json.dumps(_rounded(prof_step))}; expert products per prefill {expert_flops:.4g} "
          f"FLOP (least {expert_flops / BF16_TENSOR_FLOPS * 1e3:.3f} ms), a decode step's "
          f"expert weights {expert_bytes / 1e9:.2f} GB (least "
          f"{expert_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms); flash at (B {B}, S {S}, H {H}/{Hkv}, "
          f"D {D}, causal) ms {flash['ms']:.3f} max_abs_err {err:.3g} rel_l2 {rel:.3g} plain_ms "
          f"{flash['plain_ms']:.3f} sdpa_ms {flash['library_ms']:.3f} bound_ms "
          f"{flash['bound'][0]:.4f} ({flash['bound'][1]})", flush=True)
    print("phase serve moe: ok", flush=True)
    return {"launches": routes, "flash": flash}


# ---------------------------------------------------------------------- #
# phases 6h, 6x, 6s, 6g: the recurrent families, the encoder-decoder and
# Gemma-7B, each served at its published widths
# ---------------------------------------------------------------------- #
def _attn_params(cfg) -> int:
    bias = cfg.q_dim + 2 * cfg.kv_dim if cfg.qkv_bias else 0
    return cfg.d_model * cfg.q_dim + 2 * cfg.d_model * cfg.kv_dim + cfg.q_dim * cfg.d_model + bias


def _ssd_params(cfg) -> int:
    """in_xz, in_bc (per head k and q), in_dt, float32 a_log and d_skip, out."""
    d = cfg.d_model
    d_i = d * cfg.ssm_expand
    H, N = cfg.ssm_heads, cfg.ssm_state
    return d * 2 * d_i + d * 2 * H * N + d * H + 2 * H + d_i * d


def _tree_param_count(cfg) -> int:
    """The parameters of the JAX package's tree for ``cfg`` (its init's
    leaves, worked out from the shapes, not ``param_count()``): embedding
    (and unembedding, untied) at the padded vocabulary, the layers, the
    final norm (and the encoder's)."""
    d = cfg.d_model
    emb = cfg.padded_vocab * d * (1 if cfg.tie_embeddings else 2)
    mlp = 3 * d * cfg.d_ff
    if cfg.encoder_layers:
        enc = 2 * d + _attn_params(cfg) + mlp
        dec = 3 * d + 2 * _attn_params(cfg) + mlp
        return emb + cfg.encoder_layers * enc + cfg.num_layers * dec + 2 * d
    if cfg.family == "hybrid":
        layer = 4 * d + _attn_params(cfg) + _ssd_params(cfg) + mlp
        return emb + cfg.num_layers * layer + d
    if cfg.family == "ssm":
        n_s = cfg.num_layers // cfg.slstm_every
        mlstm = d + _ssd_params(cfg)
        slstm = d + 4 * d * d + d * d
        return emb + (cfg.num_layers - n_s) * mlstm + n_s * slstm + d
    return emb + cfg.num_layers * (2 * d + _attn_params(cfg) + mlp) + d


def _has_attention(cfg) -> bool:
    return bool(cfg.encoder_layers or set(blocks.layer_kinds(cfg)) & {"dense", "moe", "hymba"})


def _serve_family(dev, label: str, cfg, seed: int, B: int, S: int, T: int,
                  on_path: dict) -> dict:
    """``serve.generate`` on ``cfg`` with the flash kernel: params from a
    seeded generator (counted against the JAX-shaped tree), B prompts of S
    tokens and T greedy tokens with the launches counted from 0
    (``on_path`` per prefill, none per decode step), the per-call
    launches, and the flash prefill's logits and, with attention, the
    plain attention's (gated by the caller). An encoder-decoder gets
    ``STUB_FRAMES * randn`` stub frames. Returns what the phase goes on
    with (the bundles, params, prompts, batch, numbers)."""
    bundle = build_model(cfg, dev)
    attention = _has_attention(cfg)
    plain = build_model(dataclasses.replace(cfg, attn_impl="xla"), dev) if attention else None
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = bundle.init(gen)
    n_params = sum(x.numel() for x in tree_leaves(params))
    check(n_params == _tree_param_count(cfg), f"{label}: {n_params} parameters, not "
                                               f"{_tree_param_count(cfg)} (the JAX-shaped tree)")
    params_gb = sum(x.numel() * x.element_size() for x in tree_leaves(params)) / 1e9
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=dev)
    batch = {"tokens": prompts}
    frames = None
    if cfg.encoder_layers:
        frames = STUB_FRAMES * torch.randn(B, cfg.frontend_len, cfg.d_model, generator=gen,
                                           device=dev)
        batch["frames"] = frames
    torch.cuda.reset_peak_memory_stats(dev)

    # the main path: one generate call, launches counted from 0
    fkernel.reset_launches()
    out = generate(bundle, params, prompts, T, frames=frames)
    routes = _route_launches()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    check(out.all_finite, f"{label}: non-finite logits while serving")
    check(out.tokens.shape == (B, T), f"{label}: tokens {tuple(out.tokens.shape)}")
    check(routes == on_path, f"{label}: flash launches {routes} in a prefill and {T - 1} decode "
                             f"steps, not {on_path}")

    # per call: on_path per prefill, none per decode step
    fkernel.reset_launches()
    logits_f, cache = bundle.prefill(params, dict(batch), bundle.init_cache(B, S + 1))
    per_prefill = _route_launches()
    nxt = torch.argmax(logits_f[:, -1], dim=-1, keepdim=True).to(torch.int32)
    fkernel.reset_launches()
    logits_d, cache = bundle.serve_step(params, cache, {"token": nxt})
    per_step = _route_launches()
    check(per_prefill == on_path and not any(per_step.values()),
          f"{label}: flash launches per prefill {per_prefill}, per decode step {per_step}")
    logits_x = plain.prefill(params, dict(batch), plain.init_cache(B, S + 1))[0] if attention else None
    check(all(bool(torch.isfinite(x).all()) for x in (logits_f, logits_d, logits_x)
              if x is not None), f"{label}: non-finite prefill or decode logits")
    del cache, logits_d
    return dict(bundle=bundle, plain=plain, params=params, prompts=prompts, batch=batch, nxt=nxt,
                logits_f=logits_f, logits_x=logits_x, out=out, routes=routes,
                per_prefill=per_prefill, per_step=per_step, peak_gb=peak_gb,
                n_params=n_params, params_gb=params_gb)


def _plain_gate(run: dict):
    """The flash prefill's gate: the relative L2 of a prefill's logits from
    the plain attention's prefill, within SERVE_REL_L2."""
    ref = run["logits_x"]
    return (lambda logits: _rel_l2(logits, ref)), SERVE_REL_L2, "rel L2 from the plain prefill"


def _float32_gate(run: dict):
    """Hymba's gate: a bf16 prefill's relative L2 from the same weights in
    float32, as a multiple of the plain bf16 prefill's, within
    FLASH_F32_RATIO (32 layers of bf16 rounding put both prefills about
    5.7e-2 from the float32 model, above SERVE_REL_L2)."""
    cfg32 = dataclasses.replace(run["bundle"].cfg, param_dtype="float32", attn_impl="xla")
    b32 = build_model(cfg32, run["prompts"].device)
    p32 = tree_map(lambda x: x.float(), run["params"])
    B, S = run["prompts"].shape
    # [0]: a name for the returned cache would keep it to the phase's end
    l32 = b32.prefill(p32, dict(run["batch"]), b32.init_cache(B, S + 1))[0]
    del b32, p32
    plain = _rel_l2(run["logits_x"], l32)
    check(plain > 0, "the plain prefill equals the float32 model's: no bf16 model to gate")
    return ((lambda logits: _rel_l2(logits, l32) / plain), FLASH_F32_RATIO,
            f"rel L2 from the float32 model over the plain bf16 prefill's ({plain:.4g})")


def _flash_gate(label: str, cfg, run: dict, gate) -> str:
    """The flash prefill within ``gate``'s limit, and each planted
    attention fault (phase 6's: the plain attention with one KV tile
    dropped, with q heads on the wrong kv heads, without the causal mask)
    in the same prefill above it. With as many kv heads as query heads
    there is no wrong kv head (h % Hkv is h // 1): that fault is left out."""
    distance, limit, what = gate(run)
    got = distance(run["logits_f"])
    check(got <= limit, f"{label}: the flash prefill's {what} is {got} > {limit}")
    faults = {name: f for name, f in PLANTED_FAULTS.items()
              if name != "wrong_kv_head" or cfg.num_kv_heads < cfg.num_heads}
    bundle, params, batch = run["bundle"], run["params"], run["batch"]
    B, S = run["prompts"].shape
    controls = {}
    try:
        for name, fault in faults.items():
            blocks.flash_attention = fault
            controls[name] = distance(bundle.prefill(params, dict(batch),
                                                     bundle.init_cache(B, S + 1))[0])
    finally:
        blocks.flash_attention = flash_attention
    check(min(controls.values()) > limit,
          f"{label}: a planted attention fault reads within {limit}: {controls}")
    return (f"flash prefill {what} {got:.4g} <= {limit}; controls (planted attention faults) "
            f"{json.dumps({k: float(f'{v:.4g}') for k, v in controls.items()})}")


def _tf_one(dev, run: dict) -> tuple:
    """Teacher forcing: a decode step after a prefill of S tokens against a
    prefill of S + 1 (the step's token appended), within SERVE_REL_L2.
    Returns (rel L2, max abs, what was compared)."""
    bundle, params, batch, nxt = run["bundle"], run["params"], run["batch"], run["nxt"]
    B, S = run["prompts"].shape
    _, cache = bundle.prefill(params, dict(batch), bundle.init_cache(B, S + 1))
    logits_d, _ = bundle.serve_step(params, cache, {"token": nxt})
    longer = dict(batch, tokens=torch.cat([batch["tokens"], nxt], dim=1))
    logits_s1, _ = bundle.prefill(params, longer, bundle.init_cache(B, S + 1))
    rel, err = _rel_l2(logits_d, logits_s1), float((logits_d - logits_s1).abs().max())
    check(rel <= SERVE_REL_L2, f"teacher forcing: rel L2 {rel} > {SERVE_REL_L2}")
    return rel, err, f"a decode step after a prefill of {S} against one of {S + 1}"


def _teacher_forcing_steps(bundle, params, cfg, tokens: torch.Tensor, prefill_len: int,
                           steps: int) -> tuple:
    """A prefill of ``prefill_len`` tokens, then ``steps`` decode steps fed
    the next ones, against the full forward at those positions: (rel L2
    over every step's logits, max abs, the last step's rel L2, the cache
    after the steps). The chunked recurrence takes whole chunks, so the
    prefill ends on a chunk boundary and the full forward runs to the next
    boundary past the steps; under a window the prefill is a multiple of
    the window too (see ``phase_serve_hymba``)."""
    chunk = cfg.ssd_chunk
    L = prefill_len + -(-steps // chunk) * chunk
    check(tokens.shape[1] >= L, f"teacher forcing over {L} tokens of prompts of {tokens.shape[1]}")
    tokens = tokens[:, :L]
    P = tokens.shape[0]
    h, _, _ = transformer.forward_hidden(params, cfg, tokens=tokens)
    full = transformer.logits_of(params, cfg, h[:, prefill_len:prefill_len + steps])
    del h
    _, cache = bundle.prefill(params, {"tokens": tokens[:, :prefill_len]},
                              bundle.init_cache(P, prefill_len + steps))
    got = []
    for i in range(prefill_len, prefill_len + steps):
        logits, cache = bundle.serve_step(params, cache, {"token": tokens[:, i:i + 1]})
        got.append(logits)
    got = torch.cat(got, dim=1)
    check(bool(torch.isfinite(got).all()) and bool(torch.isfinite(full).all()),
          "non-finite teacher-forcing logits")
    return (_rel_l2(got, full), float((got - full).abs().max()),
            _rel_l2(got[:, -1], full[:, -1]), cache)


def _first_state(cache: dict) -> dict:
    """The first layer's recurrent state in a stacked cache: the SSD state
    (hymba, mlstm) or the sLSTM carry."""
    group = cache["groups"][0]
    if "ssd" in group:
        return {"state": group["ssd"]["state"][0].clone()}
    return {name: group[name][0].clone() for name in ("c", "n", "m")}


_SSD_DECODE, _SLSTM_SCAN = blocks.ssd_decode_step, blocks.slstm_scan


def _decode_state_bf16(kind: str):
    """A planted decode fault: the recurrent state rounded to bf16 before
    each decode step (the SSD state, the sLSTM's c and n), as a decode that
    kept it in the model's dtype would."""
    def ssd(state, *a):
        return _SSD_DECODE(state.to(torch.bfloat16).float(), *a)

    def slstm(i, f, z, o, initial=None):
        if initial is not None and z.shape[1] == 1:
            c, n, m = initial
            initial = (c.bfloat16().float(), n.bfloat16().float(), m)
        return _SLSTM_SCAN(i, f, z, o, initial=initial)
    return {"ssd_decode_step": ssd, "slstm_scan": slstm}[kind]


def _decode_state_dropped(kind: str):
    """A planted decode fault: each decode step starts from a fresh state."""
    def ssd(state, *a):
        return _SSD_DECODE(torch.zeros_like(state), *a)

    def slstm(i, f, z, o, initial=None):
        return _SLSTM_SCAN(i, f, z, o, initial=None if z.shape[1] == 1 else initial)
    return {"ssd_decode_step": ssd, "slstm_scan": slstm}[kind]


DECODE_FAULTS = {"state_bf16": _decode_state_bf16, "state_dropped": _decode_state_dropped}


def _decode_check(dev, cfg, prefill_len: int) -> str:
    """The bf16 decode path of a recurrent model cut in depth (seeded
    weights): DECODE_STEPS teacher-forced decode steps after a prefill of
    ``prefill_len`` on TF_PROMPTS prompts. Their logits within SERVE_REL_L2
    of the bf16 full forward's, and the first layer's float32 state after
    them within DECODE_STATE_REL of a prefill's over the same tokens; with
    each planted decode fault, the state (``state_bf16``) or the logits
    (``state_dropped``) above their limit."""
    bundle = build_model(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    params = bundle.init(gen)
    L = prefill_len + DECODE_STEPS
    toks = torch.randint(0, cfg.vocab_size, (TF_PROMPTS, L), generator=gen, device=dev)
    ref = _first_state(bundle.prefill(params, {"tokens": toks},
                                      bundle.init_cache(TF_PROMPTS, L))[1])

    def run():
        rel, err, _, cache = _teacher_forcing_steps(bundle, params, cfg, toks, prefill_len,
                                                    DECODE_STEPS)
        got = _first_state(cache)
        return rel, max(_rel_l2(got[k], ref[k]) for k in ref)

    rel, state = run()
    controls = {}
    for name, fault in DECODE_FAULTS.items():
        try:
            for kind in ("ssd_decode_step", "slstm_scan"):
                setattr(blocks, kind, fault(kind))
            controls[name] = run()
        finally:
            blocks.ssd_decode_step, blocks.slstm_scan = _SSD_DECODE, _SLSTM_SCAN
    kinds = "+".join(blocks.layer_kinds(cfg))
    what = f"{cfg.num_layers} x [{kinds}] layers bf16"
    check(rel <= SERVE_REL_L2 and state <= DECODE_STATE_REL,
          f"bf16 decode ({what}): logits rel L2 {rel} (limit {SERVE_REL_L2}), first layer's "
          f"state {state} (limit {DECODE_STATE_REL})")
    check(controls["state_bf16"][1] > DECODE_STATE_REL
          and controls["state_dropped"][0] > SERVE_REL_L2,
          f"bf16 decode ({what}): a planted decode fault reads within its limit: {controls}")
    del bundle, params
    free_device()
    return (f"bf16 decode ({what}, {DECODE_STEPS} steps after a prefill of {prefill_len}) "
            f"logits rel_l2 {rel:.3g}, first layer's state rel_l2 {state:.3g}; controls "
            f"state_bf16 state {controls['state_bf16'][1]:.3g}, state_dropped logits "
            f"{controls['state_dropped'][0]:.3g}")


def _recurrent_teacher(prefill_len: int, cuts: tuple, control: int = 0):
    """Teacher forcing for the recurrent models: at full depth on the
    weights in float32, TF_STEPS decode steps after a prefill of
    ``prefill_len`` within TF_F32_REL (and after a prefill of ``control``,
    if given, a control that must read above it); then the bf16 decode
    path at each of ``cuts`` (the config cut in depth) through
    ``_decode_check``."""
    def teacher(dev, run: dict) -> tuple:
        cfg32 = dataclasses.replace(run["bundle"].cfg, param_dtype="float32", attn_impl="xla")
        b32 = build_model(cfg32, dev)
        p32 = tree_map(lambda x: x.float(), run["params"])
        prompts = run["prompts"][:TF_PROMPTS]
        rel, err, last, _ = _teacher_forcing_steps(b32, p32, cfg32, prompts, prefill_len, TF_STEPS)
        check(rel <= TF_F32_REL, f"teacher forcing (float32): rel L2 {rel} > {TF_F32_REL}")
        text = (f"float32 weights, {TF_STEPS} decode steps after a prefill of {prefill_len}, "
                f"{TF_PROMPTS} prompts; last step rel_l2 {last:.3g}")
        if control:
            ctl = _teacher_forcing_steps(b32, p32, cfg32, prompts, control, TF_STEPS)[0]
            check(ctl > TF_F32_REL, f"the control (a prefill of {control}) reads rel L2 {ctl}, "
                                    f"within {TF_F32_REL}")
            text += f"; control, a prefill of {control}: rel_l2 {ctl:.3g}"
        del b32, p32
        free_device()
        for cut in cuts:
            text += "; " + _decode_check(dev, cut, prefill_len)
        return rel, err, text
    return teacher


def _card_vs_cpu(dev, cfg, seed: int, L: int) -> dict:
    """The same float32 model (``cfg``, drawn on the card and copied to the
    host) on the card and on the CPU: a prefill of 1 x L tokens (and, for
    an encoder-decoder, ``STUB_FRAMES * randn`` frames) and one decode
    step. The relative L2 of the prefill's and the step's logits, and the
    largest of the cache's float leaves'; and each side's seconds."""
    card = build_model(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = card.init(gen)
    toks = torch.randint(0, cfg.vocab_size, (1, L + 1), generator=gen, device=dev).to(torch.int32)
    batch = {"tokens": toks[:, :L]}
    if cfg.encoder_layers:
        batch["frames"] = STUB_FRAMES * torch.randn(1, cfg.frontend_len, cfg.d_model,
                                                    generator=gen, device=dev)
    sides = {"card": (card, params, batch, toks[:, L:])}
    cpu = build_model(cfg, "cpu")
    sides["cpu"] = (cpu, tree_map(lambda x: x.cpu(), params),
                    {k: v.cpu() for k, v in batch.items()}, toks[:, L:].cpu())
    res = {}
    for name, (bundle, p, b, nxt) in sides.items():
        t0 = time.perf_counter()
        lp, cache = bundle.prefill(p, dict(b), bundle.init_cache(1, L + 1))
        ls, cache = bundle.serve_step(p, cache, {"token": nxt})
        res[name] = (lp.cpu(), ls.cpu(),
                     [x.cpu() for x in tree_leaves(cache) if x.is_floating_point()])
        res[name + "_s"] = time.perf_counter() - t0
    (cp, cs, cc), (hp, hs, hc) = res["card"], res["cpu"]
    cache_rel = max(_rel_l2(a, b) for a, b in zip(cc, hc) if float(b.abs().max()) > 0)
    return {"prefill_rel": _rel_l2(cp, hp), "step_rel": _rel_l2(cs, hs), "cache_rel": cache_rel,
            "card_s": res["card_s"], "cpu_s": res["cpu_s"]}


def _flash_at(dev, B, S, H, Hkv, D, window: int, dtype: torch.dtype, seed: int,
              direct: bool = False) -> dict:
    """The flash kernel its route picks at one attention shape and dtype:
    max abs error and relative L2 against the plain version, times of the
    kernel, the plain version and SDPA (for a window: an explicit boolean
    mask, K/V repeated to H heads before the timed call, and the backend
    SDPA's dispatcher picks for it), and the bound (the causal, windowed
    pairs' two products, bf16 on the tensor cores, float32 on the CUDA
    cores; q, k, v read and out written once). With ``direct``, flash.cu
    called directly on the same tensors too (``timing["direct"]``: its
    error against the same plain output and its time)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = _qkv(dev, gen, B, S, H, Hkv, D, dtype)
    plain = fref.reference_attention(q, k, v, causal=True, window=window)
    fkernel.reset_launches()
    got = flash_attention(q, k, v, causal=True, window=window)
    route = {name: n for name, n in _route_launches().items() if n}
    err, rel = float((got.float() - plain.float()).abs().max()), _rel_l2(got, plain)
    check(err <= FLASH_ATOL[dtype] and rel <= FLASH_REL_L2[dtype],
          f"flash at (B {B}, S {S}, H {H}/{Hkv}, D {D}, window {window}, {dtype}): max abs err "
          f"{err}, rel L2 {rel}")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    simt = None
    if direct:
        def run_simt():
            return fkernel.flash_forward(qt, kt, vt, causal=True, window=window)

        out = run_simt().transpose(1, 2)
        d_err, d_rel = float((out.float() - plain.float()).abs().max()), _rel_l2(out, plain)
        check(d_err <= FLASH_ATOL[dtype] and d_rel <= FLASH_REL_L2[dtype],
              f"flash.cu at (B {B}, S {S}, H {H}/{Hkv}, D {D}, {dtype}): max abs err {d_err}, "
              f"rel L2 {d_rel}")
        simt = {"ms": cuda_ms(run_simt, reps=3), "max_abs_err": d_err, "rel_l2": d_rel}
        del out
    del plain, got
    if window:
        pos = torch.arange(S, device=dev)
        mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
        kt, vt = (x.repeat_interleave(H // Hkv, dim=1) for x in (kt, vt))
        sdpa_kw = {"attn_mask": mask}
        pairs = window * (window + 1) // 2 + (S - window) * window
    else:
        sdpa_kw = {"is_causal": True, "enable_gqa": Hkv != H}
        pairs = S * (S + 1) // 2
    try:
        from torch.nn.attention import SDPBackend
        backend = SDPBackend(torch._fused_sdp_choice(qt, kt, vt, **sdpa_kw)).name
    except Exception as e:  # noqa: BLE001 - a private dispatcher call, reported
        backend = f"unknown ({type(e).__name__})"
    nbytes = q.element_size() * (2 * B * S * H * D + 2 * B * S * Hkv * D)
    peak = BF16_TENSOR_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    timing = dict(
        ms=cuda_ms(lambda: flash_attention(q, k, v, causal=True, window=window), reps=10),
        plain_ms=cuda_ms(lambda: fref.reference_attention(q, k, v, causal=True, window=window),
                         reps=2),
        library_ms=cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, **sdpa_kw), reps=10),
        bound=bound(nbytes, 4 * D * B * H * pairs, peak), max_abs_err=err,
        rel_l2=rel, route=route, sdpa_backend=backend, direct=simt,
        shape=(f"B {B}, S {S}, H {H}/{Hkv}, D {D}, causal"
               + (f", window {window}" if window else "")
               + (", float32" if dtype == torch.float32 else "")))
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return timing


def _flash_text(f: dict) -> str:
    d = f["direct"]
    return (f"flash at ({f['shape']}) on {list(f['route'])} ms {f['ms']:.3f} max_abs_err "
            f"{f['max_abs_err']:.3g} rel_l2 {f['rel_l2']:.3g} plain_ms {f['plain_ms']:.3f} sdpa_ms "
            f"{f['library_ms']:.3f} (backend {f['sdpa_backend']}) bound_ms {f['bound'][0]:.4f} "
            f"({f['bound'][1]})"
            + (f"; flash.cu directly ms {d['ms']:.3f} max_abs_err {d['max_abs_err']:.3g} rel_l2 "
               f"{d['rel_l2']:.3g}" if d else ""))


def _serve_text(label: str, run: dict, B: int, S: int, T: int) -> str:
    out = run["out"]
    return (f"{label} B {B} prompt {S} gen {T}; {run['n_params']} params "
            f"({run['params_gb']:.2f} GB); flash launches {json.dumps(run['routes'])} (per "
            f"prefill {json.dumps(run['per_prefill'])}, per decode step "
            f"{sum(run['per_step'].values())}); decode_ms_per_step "
            f"{out.decode_s / (T - 1) * 1e3:.3f} decode_tokens_per_s "
            f"{B * (T - 1) / out.decode_s:.1f} generated_tokens_per_s "
            f"{B * T / (out.prefill_s + out.decode_s):.1f} (in generate: prefill "
            f"{out.prefill_s * 1e3:.3f} ms) peak_device_gb {run['peak_gb']:.2f}")


def _published(cfg, **want) -> None:
    got = {k: getattr(cfg, k) for k in want}
    check(got == want, f"{cfg.arch_id} is not the published config: {got}")


def _serve_phase(dev, label: str, cfg, S: int, on_path: dict, *, gate=_plain_gate,
                 teacher=_tf_one, gate_cfg=None, pieces: dict, step_pieces: dict,
                 flash_shapes: list = (), direct: bool = False) -> dict:
    """One serving phase: ``_serve_family``'s checks; with attention, the
    flash prefill within ``gate``'s limit and the planted attention faults
    above it (``_flash_gate``); ``teacher`` forcing (``_tf_one`` or
    ``_recurrent_teacher``'s); the prefill's median ms, the plain
    attention's prefill ms, a profile of a prefill and of a decode step
    (busy share), the device ms of ``pieces`` inside a prefill and of
    ``step_pieces`` inside a decode step, the memory held after (under 1
    MB), then ``gate_cfg`` (float32, cut in depth) on the card against the
    CPU, and the flash kernel at each of ``flash_shapes`` (B, S, H, Hkv, D,
    window, dtype), with ``direct``: and flash.cu there too. Prints the phase's line and its seconds by stage;
    returns its numbers and the main path's launches."""
    B, T = SERVE_BATCH, SERVE_GEN
    free_device()
    before = program_bytes(dev)
    stage_s, t0 = {}, time.perf_counter()

    def stage(name):
        nonlocal t0
        stage_s[name] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()

    run = _serve_family(dev, label, cfg, 0, B, S, T, on_path)
    stage("serve")
    if run["logits_x"] is not None:
        flash_text = _flash_gate(label, cfg, run, gate)
    else:
        flash_text = "flash vs plain n/a (no attention: one model under both)"
    tf_rel, tf_err, tf_what = teacher(dev, run)
    run.pop("logits_f"), run.pop("logits_x")
    free_device()
    stage("gates")
    bundle, plain, params = run["bundle"], run["plain"], run["params"]

    def prefill(which=bundle):
        return which.prefill(params, dict(run["batch"]), which.init_cache(B, S + T))

    with _RegionTimer(pieces) as in_prefill:  # also the timing's warm-up
        cache = prefill()[1]
    with _RegionTimer(step_pieces) as in_step:
        bundle.serve_step(params, cache, {"token": run["nxt"]})
    prefill_ms = _median_ms(prefill, warm=False)
    # the plain bundle ran a prefill of this shape for the gate: warm
    plain_text = (f" plain_prefill_ms {_median_ms(lambda: prefill(plain), runs=1, warm=False):.3f}"
                  if plain is not None else "")
    stage("times")
    prof_prefill = _kernel_classes(prefill)
    prof_step = _kernel_classes(lambda: bundle.serve_step(params, cache, {"token": run["nxt"]}))
    text = _serve_text(label, run, B, S, T)
    launches = run["routes"]
    del cache, run, bundle, plain, params
    free_device()
    held_mb = check_held(dev, before, 1.0, f"the {label} phase", strict=True)
    stage("profiles")
    gate_text = ""
    if gate_cfg is not None:
        cvc = _card_vs_cpu(dev, gate_cfg, 3, CARD_CPU_LEN)
        check(max(cvc["prefill_rel"], cvc["step_rel"], cvc["cache_rel"]) <= CARD_CPU_REL,
              f"{label} card vs CPU ({gate_cfg.num_layers} layers, float32): {cvc}")
        free_device()
        stage("card_vs_cpu")
        enc = f"{gate_cfg.encoder_layers} + " if gate_cfg.encoder_layers else ""
        gate_text = (f"; card vs CPU ({enc}{gate_cfg.num_layers} layers, float32, 1 x "
                     f"{CARD_CPU_LEN} tokens) rel_l2 prefill {cvc['prefill_rel']:.3g} step "
                     f"{cvc['step_rel']:.3g} cache {cvc['cache_rel']:.3g} (card "
                     f"{cvc['card_s']:.2f} s, cpu {cvc['cpu_s']:.2f} s)")
    flashes = [_flash_at(dev, *shape, seed=4, direct=direct) for shape in flash_shapes]
    stage("flash")
    print(f"phase serve {label}: {text}; {flash_text}; teacher forcing ({tf_what}) rel_l2 "
          f"{tf_rel:.3g} max_abs_err {tf_err:.3g}; prefill_ms {prefill_ms:.3f}{plain_text}; held "
          f"after {held_mb:.1f} MB; prefill pieces device ms {json.dumps(_rounded(in_prefill.ms))} "
          f"decode step pieces device ms {json.dumps(_rounded(in_step.ms))}; prefill profile "
          f"{json.dumps(_rounded(prof_prefill))} decode step profile "
          f"{json.dumps(_rounded(prof_step))}{gate_text}"
          + "".join(f"; {_flash_text(f)}" for f in flashes) + f"; stage_s {json.dumps(stage_s)}",
          flush=True)
    print(f"phase serve {label}: ok", flush=True)
    return {"launches": launches, "flash": flashes, "prefill_ms": prefill_ms}


def phase_serve_hymba(dev: torch.device) -> dict:
    """6h: Hymba-1.5B at its published widths and full depth, 8 prompts of
    4096 tokens (past the window of 2048: the window masks and the decode
    ring wraps), 64 greedy tokens; 32 tensor-core flash launches a
    prefill. The flash prefill is gated against the float32 model
    (``_float32_gate``). Teacher forcing decodes 32 steps after a prefill
    of 2048 (one window), so the ring wraps there too, with a prefill of
    2304 as its control; the bf16 decode runs at 2 layers. A prefill
    longer than the window keeps its last W keys at slots 0..W-1 (the JAX
    package's ``_attn_core_full``), where a decode step writes position p
    at slot p mod W: the two agree when the prefill is a multiple of W, as
    4096 and 2048 are; otherwise the first decode steps overwrite live
    keys, in both packages alike (ROADMAP Queue 3)."""
    cfg = dataclasses.replace(get_config("hymba_1_5b"), attn_impl="flash")
    _published(cfg, num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5, head_dim=64,
               ssm_heads=25, ssm_state=16, ssm_expand=2, d_ff=5504, sliding_window=2048,
               vocab_size=32001, param_dtype="bfloat16", ssd_chunk=256)
    gate = dataclasses.replace(cfg, num_layers=CARD_CPU_LAYERS, param_dtype="float32",
                               attn_impl="xla")
    return _serve_phase(
        dev, "Hymba-1.5B", cfg, HYMBA_PROMPT,
        on_entry("flash_attention_forward_sm90", cfg.num_layers),
        gate=_float32_gate,
        teacher=_recurrent_teacher(cfg.sliding_window, (dataclasses.replace(cfg, num_layers=2),),
                                   control=HYMBA_TF_CONTROL),
        gate_cfg=gate,
        pieces={"ssd_chunked": (blocks, "ssd_chunked"), "flash": (blocks, "flash_attention")},
        step_pieces={"ssd_decode_step": (blocks, "ssd_decode_step")},
        flash_shapes=[(SERVE_BATCH, HYMBA_PROMPT, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                       cfg.sliding_window, torch.bfloat16)])


def phase_serve_xlstm(dev: torch.device) -> dict:
    """6x: xLSTM-1.3B at its published widths and full depth (48 layers, 6
    of them sLSTM), phase 6's traffic; no flash launch (no attention). The
    bf16 decode runs at one period (8 layers) and on the sLSTM block alone
    (one layer, so that its inputs are the same in the decode and the
    prefill)."""
    cfg = dataclasses.replace(get_config("xlstm_1_3b"), attn_impl="flash")
    _published(cfg, num_layers=48, d_model=2048, ssm_heads=4, ssm_state=256, ssm_expand=2,
               slstm_every=8, vocab_size=50304, param_dtype="bfloat16", ssd_chunk=256)
    gate = dataclasses.replace(cfg, num_layers=cfg.slstm_every, param_dtype="float32",
                               attn_impl="xla")
    cuts = (dataclasses.replace(cfg, num_layers=cfg.slstm_every),
            dataclasses.replace(cfg, num_layers=1, slstm_every=1))
    return _serve_phase(
        dev, "xLSTM-1.3B", cfg, SERVE_PROMPT,
        on_entry(),
        teacher=_recurrent_teacher(SERVE_PROMPT - cfg.ssd_chunk, cuts), gate_cfg=gate,
        pieces={"slstm_scan": (blocks, "slstm_scan"), "ssd_chunked": (blocks, "ssd_chunked")},
        step_pieces={"slstm_scan": (blocks, "slstm_scan"),
                     "ssd_decode_step": (blocks, "ssd_decode_step")})


def phase_serve_seamless(dev: torch.device) -> dict:
    """6s: SeamlessM4T-medium at its published widths (12 encoder and 12
    decoder layers), 8 utterances of 1024 stub frames (float32, so the
    encoder and the cross K/V run in float32, as in the JAX package),
    256-token decoder prompts, 64 greedy tokens; one tensor-core flash
    launch a decoder layer a prefill (the encoder and the cross-attention
    are plain), held against the plain version at that shape."""
    cfg = dataclasses.replace(get_config("seamless_m4t_medium"), attn_impl="flash")
    _published(cfg, num_layers=12, encoder_layers=12, d_model=1024, num_heads=16,
               num_kv_heads=16, head_dim=64, d_ff=4096, vocab_size=256206, frontend_len=1024,
               param_dtype="bfloat16")
    gate = dataclasses.replace(cfg, num_layers=CARD_CPU_LAYERS, encoder_layers=CARD_CPU_LAYERS,
                               param_dtype="float32", attn_impl="xla")
    return _serve_phase(
        dev, "SeamlessM4T-medium", cfg, SEAMLESS_PROMPT,
        on_entry("flash_attention_forward_sm90", cfg.num_layers),
        gate_cfg=gate,
        pieces={"encode": (tencdec, "encode"), "flash": (blocks, "flash_attention")},
        step_pieces={"cross_attend": (tencdec, "_cross_attend")},
        flash_shapes=[(SERVE_BATCH, SEAMLESS_PROMPT, cfg.num_heads, cfg.num_kv_heads,
                       cfg.head_dim, 0, torch.bfloat16)])


def phase_serve_gemma(dev: torch.device) -> dict:
    """6g: Gemma-7B at its published widths and full depth (head dim 256:
    the route of flash_sm90_d256.cu), phase 6's traffic; 28 launches of it
    a prefill and none of flash.cu; then the D 256 kernel at Gemma's
    attention shape, with flash.cu timed directly beside it."""
    cfg = dataclasses.replace(get_config("gemma_7b"), attn_impl="flash")
    _published(cfg, num_layers=28, d_model=3072, num_heads=16, num_kv_heads=16, head_dim=256,
               d_ff=24576, vocab_size=256000, activation="geglu", tie_embeddings=True,
               param_dtype="bfloat16")
    return _serve_phase(
        dev, "Gemma-7B", cfg, SERVE_PROMPT,
        on_entry("flash_attention_forward_sm90_d256", cfg.num_layers),
        pieces={"flash": (blocks, "flash_attention")},
        step_pieces={"attention": (blocks, "_attn_core_decode")},
        flash_shapes=[(SERVE_BATCH, SERVE_PROMPT, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                       0, torch.bfloat16)], direct=True)


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
    layers; (c) the gate: the first round at 1 layer in float32 on the card
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

    # (c) the gate: 1 layer, full width, float32, card against CPU
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
                 moe: dict, proc: dict, fault: dict, train: dict, families: dict) -> str:
    """One row per kernel. ``launches`` sums the paths that run it, each
    counted from 0 over its own run (``launches_by_path``): phase 4's job
    for the streaming fold entries, phase 4b's coordinated job for the
    stacked fold, phase 4c's policy jobs and its batch for all agg entries,
    phase 5's job for the quant kernels, phase 6's serving, phase 6d's
    MoE serving and phases 6h, 6x, 6s and 6g's serving (``families``: 6x
    runs no TPU kernel, 0 launches) for flash,
    phase 7's process job (the hub's launches plus every child's) and
    phase 7c's three faulted jobs (the same) for the agg and quant entries,
    and phase 8's training rounds for every kernel
    (none launches there: the stages are float32 sums and training runs the
    plain attention)."""
    # the flash rows' numbers: the D 64/128 tensor-core kernel at phase 6's
    # serving shape; the D 256 one on its path, 6g's (Gemma-7B, bf16);
    # flash.cu, on no path, at phase 6's serving shape in float32 (and at
    # Gemma's, called directly, below)
    gemma = families["6g"]["flash"][0]
    serve = dict(serve, timings={"flash_attention_forward_sm90": serve["flash"][0],
                                 "flash_attention_forward_sm90_d256": gemma,
                                 "flash_attention_forward": serve["flash"][1]})
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
        ("flash_attention_forward_sm90_d256",
         "src/repro_torch/kernels/flash_attention/csrc/flash_sm90_d256.cu",
         "src/repro/kernels/flash_attention/kernel.py:76", True,
         "torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True)", serve, "6"),
        ("flash_attention_forward", "src/repro_torch/kernels/flash_attention/csrc/flash.cu",
         "src/repro/kernels/flash_attention/kernel.py:76", False,
         "torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True)", serve, "6"),
    ]
    out = []
    for name, src, replaces, on_path, library, run, phase in rows:
        t = run["timings"][name]
        by_path = {phase: run["launches"][name]}
        if src == agg_src:
            by_path["4c"] = policies["launches"].get(name, 0)
        if src in (agg_src, quant_src):
            by_path["7"] = proc["launches"].get(name, 0)
            by_path["7c"] = fault["launches"].get(name, 0)
        else:
            by_path["6d"] = moe["launches"][name]
            for phase, res in families.items():
                by_path[phase] = res["launches"][name]
        by_path["8"] = train["launches"][name]
        launches = sum(by_path.values())
        extra = {}
        if name == "flash_attention_forward_sm90":
            f = moe["flash"]
            extra = {"shape": t["shape"], "sdpa_backend": t["sdpa_backend"], "at_moe_shape": {
                "shape": "B 8, S 2048, H 64/4, D 128, causal", "ms": f["ms"],
                "max_abs_err": f["max_abs_err"], "plain_ms": f["plain_ms"],
                "bound_ms": f["bound"][0], "bound_by": f["bound"][1],
                "library_ms": f["library_ms"]},
                "at_hymba_shape": _shape_entry(families["6h"]["flash"][0]),
                "at_seamless_shape": _shape_entry(families["6s"]["flash"][0])}
        elif name == "flash_attention_forward_sm90_d256":
            extra = {"shape": t["shape"], "sdpa_backend": t["sdpa_backend"]}
        elif name == "flash_attention_forward":
            # on no path since the D 256 route; timed at phase 6's float32
            # serving shape, and called directly at Gemma's beside the
            # D 256 kernel (the same tensors, plain, SDPA and bound)
            d = gemma["direct"]
            extra = {"shape": t["shape"], "sdpa_backend": t["sdpa_backend"], "at_gemma_shape": {
                **_shape_entry(gemma), "ms": d["ms"], "max_abs_err": d["max_abs_err"],
                "rel_l2": d["rel_l2"]}}
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
            **extra,
        })
    return json.dumps({"kernels": out})


def _shape_entry(f: dict) -> dict:
    return {"shape": f["shape"], "ms": f["ms"], "max_abs_err": f["max_abs_err"],
            "plain_ms": f["plain_ms"], "bound_ms": f["bound"][0], "bound_by": f["bound"][1],
            "library_ms": f["library_ms"], "sdpa_backend": f["sdpa_backend"]}


def run_phase(phase_s: dict, name: str, fn, *args):
    """Run one phase, recording its seconds in ``phase_s``. A phase that
    raises names itself: ``phase <name> FAILED: <type>: <message>`` on
    stdout, then the phases' seconds so far, then the traceback on stderr,
    and the script exits 1. Nothing is retried or skipped."""
    t = time.perf_counter()
    try:
        out = fn(*args)
    except Exception as e:  # noqa: BLE001 - reported, then the script exits 1
        phase_s[name] = round(time.perf_counter() - t, 1)
        print(f"phase {name} FAILED: {type(e).__name__}: {e}", flush=True)
        print(f"phase_s {json.dumps(phase_s)}", flush=True)
        traceback.print_exc(file=sys.stderr)
        sys.stderr.flush()
        raise SystemExit(1) from e
    phase_s[name] = round(time.perf_counter() - t, 1)
    return out


def free_device() -> None:
    gc.collect()
    torch.cuda.empty_cache()


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
        return run_phase(phase_s, name, fn, *args)

    smi = timed("1", phase_environment)
    timed("2", phase_parity, dev)
    timed("3", lambda: (phase_small_jobs(dev), phase_small_topologies(dev),
                        phase_small_policies(dev)))
    full = timed("4", phase_full_width, dev)
    free_device()
    topo = timed("4b", phase_full_width_topologies, dev)
    free_device()
    policies = timed("4c", phase_full_width_policies, dev)
    errs = timed("5a", phase_codec_parity, dev)
    codec = timed("5", phase_codec_job, dev, errs)
    proc = timed("7", phase_process_plane, dev, codec)
    fault = timed("7c", phase_fault_plane, dev, proc)
    # the earlier phases peak at about 46 GB: free them before serving
    free_device()
    timed("6a", phase_flash_parity, dev)
    serve = timed("6", phase_serve, dev)
    free_device()
    moe = timed("6d", phase_serve_moe, dev)
    free_device()
    families = {}
    for name, fn in (("6h", phase_serve_hymba), ("6x", phase_serve_xlstm),
                     ("6s", phase_serve_seamless), ("6g", phase_serve_gemma)):
        families[name] = timed(name, fn, dev)
        free_device()
    train = timed("8", phase_train, dev, smi)
    lines = timed("9", lambda: kernels_line(full, topo, policies, codec, serve, moe, proc,
                                            fault, train, families))
    print(f"phase_s {json.dumps(phase_s)}", flush=True)
    print(f"elapsed_s {time.perf_counter() - t0:.1f}", flush=True)
    print(lines, flush=True)
    print(f"card: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
