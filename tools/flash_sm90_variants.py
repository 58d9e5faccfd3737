"""Build and time variants of a flash kernel on one CUDA card.

Each variant is a kernel source with a few lines replaced. ``--source``
picks the source (default ``flash_sm90.cu``):

- ``flash_sm90.cu`` (D 64 and 128): the KV tile width, the ring's depth, a
  producer warpgroup with ``setmaxnreg``, turns between the consumer
  warpgroups, the exp2 instruction, D 32's KV tile; timed by default at
  phase 6's serving shape (B 8, S 2048, H 16/2, D 128);
- ``flash_sm90_d256.cu`` (D 256): the wait's watchdog as a trap, setmaxnreg
  24/240 (as built) or 40/232, a producer warp instead of a producer
  warpgroup (with the launch bound's registers or ``__maxnreg__``), the
  fallback of one 64-row consumer warpgroup, KV tiles of 32, 64 (as built)
  or 80 keys, flash_sm90.cu's grid order, warpgroup 0 on the causal
  diagonal's last tile, ``exp2f`` for ``ex2.approx.ftz``, FA3's ping-pong; timed
  by default at Gemma-7B's prefill (B 8, S 2048, H 16/16, D 256);
- ``flash.cu`` (float32 on the CUDA cores): the S product as an 8 x 8 tile
  a thread over half of D (D split across lane pairs), ``expf`` for
  ``exp2f``, no warp-level tile skipping, unroll depths; and two
  diagnostics whose outputs are wrong by design (their relative L2 says
  so), timing the kernel without its P V product or without its S
  product; timed in float32 at Qwen2.5-3B's prefill (B 8, S 2048, H 16/2,
  D 128).

``--shape B,S,H,Hkv,D`` sets the timed shape. All variants are compiled at
once with the port's nvcc flags into ``build/flash_sm90_variants/<source>/``;
for each the script prints ptxas's registers, spills and wgmma warnings and,
from ``cuobjdump -sass``, the highest register each kernel names and its
local-memory loads and stores (``LDL``/``STL``); then, in a child process
with a time limit, its relative L2 error against the plain version on four
small shapes and its time at the timed shape (the source's dtype, causal
and not), beside ``scaled_dot_product_attention``'s in the same process.
Run from the root of a checkout:

    python3 tools/flash_sm90_variants.py
    python3 tools/flash_sm90_variants.py --source flash_sm90_d256.cu
    python3 tools/flash_sm90_variants.py --source flash.cu
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fkernel  # noqa: E402
from repro_torch.kernels.flash_attention import ref  # noqa: E402

OUT = ROOT / "build" / "flash_sm90_variants"
VARIANTS = {
    "as_built": [],
    "bk64": [("constexpr int kBK = 128;", "constexpr int kBK = 64;")],
    "three_stages": [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
    "producer_warpgroup_setmaxnreg": [
        ("constexpr int kThreads = 288;", "constexpr int kThreads = 384;"),
        ("    if (threadIdx.x == 256) {",
         '    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");\n'
         "    if (threadIdx.x == 256) {"),
        ("    const int cw = wg;",
         '    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");\n'
         "    const int cw = wg;"),
    ],
    # FA3's ping-pong: the consumer warpgroups take turns to issue S = Q K^T
    # (named barriers 1 and 2), so one's softmax overlaps the other's product
    "pingpong": [
        ("    mbar_wait(q_full, 0);\n",
         "    mbar_wait(q_full, 0);\n"
         '    if (cw == 1 && n_kv > 0) asm volatile("bar.arrive 1, 256;" ::: "memory");\n'),
        ("      mbar_wait(k_full(s), phase);\n      wgmma_fence();",
         "      mbar_wait(k_full(s), phase);\n"
         '      asm volatile("bar.sync %0, 256;" ::"r"(1 + cw) : "memory");\n'
         "      wgmma_fence();"),
        ("      wgmma_commit();\n      wgmma_wait_all();\n      fence_regs(sc);",
         "      wgmma_commit();\n"
         "      if (cw == 0 || it + 1 < n_kv)\n"
         '        asm volatile("bar.arrive %0, 256;" ::"r"(2 - cw) : "memory");\n'
         "      wgmma_wait_all();\n      fence_regs(sc);"),
    ],
    "ex2_ftz": [
        ("__device__ __forceinline__ uint32_t pack_bf16(",
         "__device__ __forceinline__ float ex2_ftz(float x) {\n  float y;\n"
         '  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));\n  return y;\n}\n\n'
         "__device__ __forceinline__ uint32_t pack_bf16("),
        ("alpha[r] = exp2f(", "alpha[r] = ex2_ftz("),
        ("sc[i] = exp2f(", "sc[i] = ex2_ftz("),
    ],
}
VARIANTS["pingpong_three_stages"] = VARIANTS["pingpong"] + VARIANTS["three_stages"]
# D 32 on the 128-key tiles of D 64 and 128
VARIANTS["d32_bk128"] = [("static constexpr int kKeys = D == 32 ? kBK32 : kBK;",
                          "static constexpr int kKeys = kBK;")]
# two blocks an SM (ptxas then keeps a thread within 112 registers): four
# consumer warpgroups to overlap one another's softmax and products
VARIANTS["two_blocks"] = [("__launch_bounds__(kThreads, 1)\n    flash_kernel_sm90(",
                           "__launch_bounds__(kThreads, 2)\n    flash_kernel_sm90(")]
VARIANTS["two_blocks_bk64"] = VARIANTS["two_blocks"] + VARIANTS["bk64"]
VARIANTS["two_blocks_ex2_ftz"] = VARIANTS["two_blocks"] + VARIANTS["ex2_ftz"]
D256_VARIANTS = {
    "as_built": [],
    # the wait's watchdog as a trap block, as flash_sm90.cu has it: ptxas
    # then allocates the consumers within the entry's 168 registers
    "trap_watchdog": [("    if (spins == (1u << 26))\n"
                       '      asm volatile("st.global.u32 [%0], %1;" ::"l"(0ull), "r"(0u) : "memory");\n',
                       "    if (spins == (1u << 26)) __trap();\n")],
    "setmaxnreg_40_232": [
        ("constexpr int kProducerRegs = 24;", "constexpr int kProducerRegs = 40;"),
        ("constexpr int kConsumerRegs = 240;", "constexpr int kConsumerRegs = 232;"),
    ],
    # two consumer warpgroups beside a producer warp (288 threads), no
    # setmaxnreg: ptxas caps them at 168 registers; with __maxnreg__(224)
    # it compiles them without spills, and the launch fails (error 701:
    # 3 of the 9 warps share a sub-partition's 16 384 registers)
    "producer_warp_288": [("constexpr int kProducerRegs = 24;", "constexpr int kProducerRegs = 0;")],
    "producer_warp_288_maxnreg_224": [
        ("constexpr int kProducerRegs = 24;", "constexpr int kProducerRegs = 0;"),
        ("__launch_bounds__(kThreads, 1)", "__maxnreg__(224)"),
    ],
    # the fallback: one 64-row consumer warpgroup beside a producer warp
    "one_consumer_160": [
        ("constexpr int kConsumerWGs = 2;", "constexpr int kConsumerWGs = 1;"),
        ("constexpr int kProducerRegs = 24;", "constexpr int kProducerRegs = 0;"),
    ],
    "bk32": [("constexpr int kBK = 64;", "constexpr int kBK = 32;")],
    "bk80": [("constexpr int kBK = 64;", "constexpr int kBK = 80;")],
    # the grid in flash_sm90.cu's order, q tile slowest and heads fastest:
    # the blocks in flight then read as many (head, batch) pairs' K and V,
    # which do not fit in L2
    "heads_fastest": [
        ("  const int g = blockIdx.x % p.group;\n"
         "  const int rest = blockIdx.x / p.group;\n"
         "  int tile = rest % p.n_tiles;\n"
         "  const int hkb = rest / p.n_tiles;\n"
         "  const int hk = hkb % p.kv_heads;\n"
         "  const int b = hkb / p.kv_heads;\n"
         "  const int h = hk * p.group + g;\n",
         "  const int heads_batch = p.heads * p.batch;\n"
         "  int tile = blockIdx.x / heads_batch;\n"
         "  const int hb = blockIdx.x - tile * heads_batch;\n"
         "  const int h = hb % p.heads;\n"
         "  const int b = hb / p.heads;\n"
         "  const int hk = h / p.group;\n"),
    ],
    # warpgroup 0 visits the causal diagonal's last tile too, as warpgroup 1 does
    "no_causal_stop": [("    if (p.causal) n_mine = ", "    if (false) n_mine = ")],
    # exp2f (with its denormal range) instead of ex2.approx.ftz
    "exp2f": [("alpha[r] = ex2_ftz(", "alpha[r] = exp2f("), ("sc[i] = ex2_ftz(", "sc[i] = exp2f(")],
}
# FA3's ping-pong: the consumer warpgroups take turns to issue S (named
# barriers 1 and 2); both visit every tile, so the turns pair up
D256_VARIANTS["pingpong"] = D256_VARIANTS["no_causal_stop"] + [
    ("    mbar_wait(q_full, 0);\n    for (int it = 0; it < n_mine; ++it) {",
     "    mbar_wait(q_full, 0);\n"
     '    if (cw == 1 && n_mine > 0) asm volatile("bar.arrive 1, 256;" ::: "memory");\n'
     "    for (int it = 0; it < n_mine; ++it) {"),
    ("      mbar_wait(k_full(s), phase);\n      wgmma_fence();\n      qk(s, sc);\n      wgmma_commit();\n",
     "      mbar_wait(k_full(s), phase);\n"
     '      asm volatile("bar.sync %0, 256;" ::"r"(1 + cw) : "memory");\n'
     "      wgmma_fence();\n      qk(s, sc);\n      wgmma_commit();\n"
     "      if (cw == 0 || it + 1 < n_mine)\n"
     '        asm volatile("bar.arrive %0, 256;" ::"r"(2 - cw) : "memory");\n'),
]
# flash.cu's S product as built: an 8 x 4 tile a thread over all of D
_S_8X4 = """      // S = Q K^T: 8 (4) rows x 4 keys a thread, float4 steps along D
      float s[RT][KPT];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) s[i][j] = 0.0f;
#pragma unroll 8
      for (int d = 0; d < D; d += 4) {
        float4 qv[RT], kv[KPT];
#pragma unroll
        for (int i = 0; i < RT; ++i) qv[i] = *reinterpret_cast<const float4*>(qrow + 2 * i * LDQ + d);
#pragma unroll
        for (int j = 0; j < KPT; ++j)
          kv[j] = *reinterpret_cast<const float4*>(krow + kColGroups * j * LDK + d);
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < KPT; ++j) {
            s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
            s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
            s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
            s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
          }
      }

"""
# ... and with D split across lane pairs: an 8 x 8 tile a thread over half
# of D (the float4 steps dh, dh + 2, ...), the halves added across the pair,
# each lane keeping 4 of its 8 keys (key0 + 8 j)
_S_SPLIT = """      // S = Q K^T: 8 (4) rows x 8 keys a thread over half of D (the float4
      // steps dh, dh + 2, ...), then the two halves added across the lane
      // pair: each lane keeps 4 of the 8 keys and sends the other 4
      float s2[RT][2 * KPT];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < 2 * KPT; ++j) s2[i][j] = 0.0f;
#pragma unroll 2
      for (int d = 4 * dh; d < D; d += 8) {
        float4 qv[RT], kv[2 * KPT];
#pragma unroll
        for (int i = 0; i < RT; ++i) qv[i] = *reinterpret_cast<const float4*>(qrow + 2 * i * LDQ + d);
#pragma unroll
        for (int j = 0; j < 2 * KPT; ++j)
          kv[j] = *reinterpret_cast<const float4*>(krow + kKeyGroups * j * LDK + d);
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < 2 * KPT; ++j) {
            s2[i][j] = fmaf(qv[i].x, kv[j].x, s2[i][j]);
            s2[i][j] = fmaf(qv[i].y, kv[j].y, s2[i][j]);
            s2[i][j] = fmaf(qv[i].z, kv[j].z, s2[i][j]);
            s2[i][j] = fmaf(qv[i].w, kv[j].w, s2[i][j]);
          }
      }
      float s[RT][KPT];  // keys key0 + 8 j
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          const float mine = dh ? s2[i][KPT + j] : s2[i][j];
          const float theirs = dh ? s2[i][j] : s2[i][KPT + j];
          s[i][j] = mine + __shfl_xor_sync(0xffffffffu, theirs, kKeyGroups);
        }

"""
SIMT_VARIANTS = {
    "as_built": [],
    "s_8x8_split_d": [
        (_S_8X4, _S_SPLIT),
        ("constexpr int kColGroups = 16;  // lanes of a half-warp: keys of S, columns of O\n",
         "constexpr int kColGroups = 16;\nconstexpr int kKeyGroups = 8;\n"),
        ("  const int cg = lane % kColGroups;  // keys cg + 16 j of S, columns VW (cg + 16 g) + e of O\n",
         "  const int cg = lane % kColGroups;\n  const int kq = cg % kKeyGroups;\n"
         "  const int dh = cg / kKeyGroups;\n  const int key0 = kq + 8 * KPT * dh;\n"),
        ("  const float* const krow = ks + cg * LDK; ", "  const float* const krow = ks + kq * LDK; "),
        ("            const int kpos = k0 + cg + kColGroups * j;",
         "            const int kpos = k0 + key0 + kKeyGroups * j;"),
        ("          *reinterpret_cast<float4*>(prow + (cg + kColGroups * j) * LP + i) =",
         "          *reinterpret_cast<float4*>(prow + (key0 + kKeyGroups * j) * LP + i) ="),
    ],
    "expf": [("p.scale_log2 = static_cast<float>(static_cast<double>(scale) * 1.4426950408889634);",
              "p.scale_log2 = scale;"),
             ("const float alpha = exp2f(", "const float alpha = expf("),
             ("s[i][j] = exp2f(", "s[i][j] = expf(")],
    # two blocks of 4 warps an SM (64 q rows; 8 warps of 8 rows at D 256),
    # whose softmaxes and barriers fall out of step, in the SM's 228 KB:
    # Q, V and P^T unpadded
    "two_blocks": [("static constexpr int kWarps = 8;   // warps a block",
                    "static constexpr int kWarps = D == 256 ? 8 : 4;"),
                   ("static constexpr int kBlocks = 1;  // blocks an SM",
                    "static constexpr int kBlocks = D == 256 ? 1 : 2;"),
                   ("static constexpr int LDQ = D + 4;", "static constexpr int LDQ = D;"),
                   ("static constexpr int LDV = D + 4;", "static constexpr int LDV = D;"),
                   ("static constexpr int LP = RW + 4;", "static constexpr int LP = RW;"),
                   ("  if (err != cudaSuccess) return static_cast<int>(err);\n  const long long grid",
                    "  if (err == cudaSuccess)\n    err = cudaFuncSetAttribute(flash_kernel<T, D>, "
                    "cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);\n"
                    "  if (err != cudaSuccess) return static_cast<int>(err);\n  const long long grid")],
    "no_warp_skip": [("    const bool live = wr0 < p.sq && !(p.causal && k0 > wr1) &&\n"
                      "                      !(p.window > 0 && k0 + kBK - 1 <= wr0 - p.window);",
                      "    const bool live = true;")],
    "s_unroll4": [("#pragma unroll 8\n      for (int d = 0; d < D; d += 4) {",
                   "#pragma unroll 4\n      for (int d = 0; d < D; d += 4) {")],
    "pv_unroll4": [("#pragma unroll 8\n      for (int j = 0; j < kBK; ++j) {",
                    "#pragma unroll 4\n      for (int j = 0; j < kBK; ++j) {")],
    # the mask applied per score, each under its own branch on the edge test
    "mask_per_score": [
        ("      if (k0 + kBK > p.kv_len || (p.causal && k0 + kBK - 1 > wr0) ||\n"
         "          (p.window > 0 && k0 <= wr1 - p.window)) {\n",
         "      const bool edge = k0 + kBK > p.kv_len || (p.causal && k0 + kBK - 1 > wr0) ||\n"
         "                        (p.window > 0 && k0 <= wr1 - p.window);\n      {\n"),
        ("            if (!ok) s[i][j] = kNegInf;", "            if (edge && !ok) s[i][j] = kNegInf;")],
    # diagnostics: wrong outputs by design, for the time of the rest
    "diag_no_pv": [("    if (live) {\n      // O += P V", "    if (false) {\n      // O += P V")],
    "diag_no_s": [("      for (int d = 0; d < D; d += 4) {", "      for (int d = D; d < D; d += 4) {")],
    "diag_no_exp": [("        const float alpha = exp2f(m[i] - m_new);", "        const float alpha = 1.0f;"),
                    ("          s[i][j] = exp2f(s[i][j] - m_new);", "          s[i][j] = s[i][j] - m_new;")],
    "diag_s_no_lds": [("qrow + 2 * i * LDQ + d)", "qrow + 2 * i * LDQ)"),
                      ("krow + kColGroups * j * LDK + d)", "krow + kColGroups * j * LDK)")],
    "diag_k_broadcast": [("  const float* const krow = ks + cg * LDK; ", "  const float* const krow = ks; ")],
    "diag_pv_no_lds": [("load_vec<4>(pr + i, prow + j * LP + i)", "load_vec<4>(pr + i, prow + i)"),
                       ("vcol + j * LDV + g * VW * kColGroups)", "vcol + g * VW * kColGroups)")],
    "diag_no_sync": [("    cp_async_wait_all();\n    __syncthreads();  // K(it)", "    // K(it)"),
                     ("    cp_async_wait_all();\n    __syncthreads();  // V(it)", "    // V(it)")],
}
# per source: its variants, C entry, library, binder, wrapper, dtype, parity
# shapes (B, S, H, Hkv, D, causal, window) and default timed shape (B, S, H, Hkv, D)
SOURCES = {
    "flash.cu": dict(
        variants=SIMT_VARIANTS, entry="flash_attention_forward", library=fkernel.LIBRARY,
        bind=fkernel._bind, fn=fkernel.flash_forward, dtype=torch.float32,
        parity=[(2, 300, 4, 2, 128, True, 0), (1, 400, 4, 1, 128, True, 100),
                (1, 256, 4, 4, 64, False, 0), (1, 97, 2, 1, 32, False, 40)],
        shape=(8, 2048, 16, 2, 128)),
    "flash_sm90.cu": dict(
        variants=VARIANTS, entry="flash_attention_forward_sm90", library=fkernel.SM90_LIBRARY,
        bind=fkernel._bind_tma("flash_attention_forward_sm90"), dtype=torch.bfloat16,
        fn=fkernel.flash_forward_sm90,
        parity=[(2, 300, 4, 2, 128, True, 0), (1, 400, 4, 1, 128, True, 100),
                (1, 256, 4, 4, 64, False, 0), (1, 97, 2, 1, 64, False, 40)],
        shape=(8, 2048, 16, 2, 128)),
    "flash_sm90_d256.cu": dict(
        variants=D256_VARIANTS, entry="flash_attention_forward_sm90_d256",
        library=fkernel.SM90_D256_LIBRARY, fn=fkernel.flash_forward_sm90_d256,
        bind=fkernel._bind_tma("flash_attention_forward_sm90_d256"), dtype=torch.bfloat16,
        parity=[(2, 300, 4, 2, 256, True, 0), (1, 400, 4, 1, 256, True, 100),
                (1, 256, 4, 4, 256, False, 0), (1, 97, 2, 1, 256, False, 40)],
        shape=(8, 2048, 16, 16, 256)),
}


def compile_variant(source: str, name: str):
    spec = SOURCES[source]
    text = (fkernel.CSRC / source).read_text()
    for old, new in spec["variants"][name]:
        if old not in text:
            return name, 1, [f"the source no longer holds {old!r}"]
        text = text.replace(old, new)
    out = OUT / Path(source).stem
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"{name}.cu", out / f"lib{name}.so"
    cu.write_text(text)
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    lines = [ln.strip()[-300:] for ln in (proc.stdout + proc.stderr).splitlines()
             if any(w in ln for w in ("C75", "spill", "Used", "error"))]
    if proc.returncode == 0:
        lines.append(sass_registers(so))
    return name, proc.returncode, lines


def sass_registers(so: Path) -> str:
    """The highest register each kernel's SASS names, whether it holds
    setmaxnreg (``USETMAXREG``) and its local-memory loads and stores
    (``LDL``, ``STL``: spills), from ``cuobjdump -sass``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        sass = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True,
                              timeout=120).stdout
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"sass: {exc}"
    out = []
    for part in sass.split("Function : ")[1:]:
        head = part.split(maxsplit=1)[0]
        regs = [int(r) for r in re.findall(r"\bR(\d+)\b", part)]
        tag = re.search(r'ILi(\d+)E', head)
        out.append(f"{'D ' + tag.group(1) if tag else head}: highest R{max(regs, default=0)}, "
                   f"USETMAXREG {'USETMAXREG' in part}, LDL {len(re.findall(r'\bLDL\b', part))}, "
                   f"STL {len(re.findall(r'\bSTL\b', part))}, CALL {len(re.findall(r'\bCALL\b', part))}")
    return "sass: " + "; ".join(out)


def cuda_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def measure(source: str, name: str, shape: tuple) -> dict:
    spec = SOURCES[source]
    lib = ctypes.CDLL(str(OUT / Path(source).stem / f"lib{name}.so"))
    spec["bind"](lib)
    spec["library"]._lib = lib  # the wrapper launches this variant
    fn = spec["fn"]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def qkv(B, S, H, Hkv, D):  # the model's (B, S, H, D) tensors as (B, H, S, D) views
        return [torch.randn(B, S, h, D, generator=gen, device=dev).to(spec["dtype"]).transpose(1, 2)
                for h in (H, Hkv, Hkv)]

    rel = []
    for B, S, H, Hkv, D, causal, window in spec["parity"]:
        q, k, v = qkv(B, S, H, Hkv, D)
        out = fn(q, k, v, causal=causal, window=window)
        plain = ref.reference_attention(*(x.transpose(1, 2) for x in (q, k, v)),
                                        causal=causal, window=window).transpose(1, 2)
        rel.append(float((out.double() - plain.double()).norm() / plain.double().norm()))
    B, S, H, Hkv, D = shape
    q, k, v = qkv(B, S, H, Hkv, D)
    return {
        "variant": name, "rel_l2": rel, "shape": list(shape),
        "ms": cuda_ms(lambda: fn(q, k, v)),
        "ms_noncausal": cuda_ms(lambda: fn(q, k, v, causal=False)),
        "sdpa_ms": cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=Hkv != H)),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", default="flash_sm90.cu", choices=sorted(SOURCES))
    ap.add_argument("--shape", help="the timed shape B,S,H,Hkv,D (default: the source's)")
    ap.add_argument("--variants", help="comma-separated variant names (default: all)")
    ap.add_argument("--measure", metavar="VARIANT", help=argparse.SUPPRESS)
    args = ap.parse_args()
    shape = (tuple(int(x) for x in args.shape.split(",")) if args.shape
             else SOURCES[args.source]["shape"])
    if args.measure:
        print(json.dumps(measure(args.source, args.measure, shape)), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("flash_sm90_variants: no CUDA device", file=sys.stderr)
        return 2
    variants = SOURCES[args.source]["variants"]
    if args.variants:
        variants = {name: variants[name] for name in args.variants.split(",")}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(variants)) as pool:
        built = list(pool.map(lambda name: compile_variant(args.source, name), variants))
    print(f"build_s {time.perf_counter() - t0:.1f}")
    for name, rc, lines in built:
        print(f"{name}: nvcc rc {rc}")
        for ln in lines:
            print(f"    {ln}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    failed = 0
    for name, rc, _ in built:
        if rc:
            failed += 1
            continue
        try:
            proc = subprocess.run([sys.executable, __file__, "--source", args.source, "--shape",
                                   ",".join(map(str, shape)), "--measure", name],
                                  timeout=180, capture_output=True, text=True)
            print(proc.stdout.strip() or f"{name}: failed\n{proc.stderr[-2000:]}", flush=True)
            failed += proc.returncode != 0
        except subprocess.TimeoutExpired:
            print(f"{name}: timed out", flush=True)
            failed += 1
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
