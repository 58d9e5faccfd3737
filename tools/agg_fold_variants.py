"""Build and time variants of the streaming fold kernel on one CUDA card.

Each variant is ``csrc/agg.cu`` with a few lines replaced in
``fold_tree_kernel`` and its launch: packs of each stream in flight per
thread (1, 2, 4, 8), the cache hints (evict-first ``__ldcs``/``__stcs``,
plain loads and stores, or evict-first loads that ask L2 for 256 bytes),
blocks per SM (1, 2, 4, 8), threads per block, the chunk size (1024 to 4096
packs), chunks walked in contiguous runs per block instead of a grid stride,
and a ring of shared-memory stages filled by ``cp.async.bulk`` (1-D TMA)
under ``mbarrier``s. All are compiled at once with the port's nvcc flags
into ``build/agg_fold_variants/``; for each the script prints ptxas's
registers and spills of the fold kernels, then, in one child process with a
time limit that runs them all, whether each folds phase 4's tree
(Qwen2.5-3B's parameter tree at 4 layers, 619 474 944 floats in 50 leaves,
built as ``chip_smoke.py`` builds it) to the plain fold's bytes, first
update and later, and then, in five rounds that take the variants in turns,
each one's time for one later update and for a first, beside 50 per-leaf
``torch.add`` calls and one ``torch._foreach_add_`` per round.
``as_built`` is in the list twice, for the spread between two copies of one
kernel. Run from the root of a checkout (names of variants, if given, pick
a subset):

    python3 tools/agg_fold_variants.py [variant ...]
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.agg import kernel, ref  # noqa: E402

SOURCE = kernel.SOURCE
OUT = ROOT / "build" / "agg_fold_variants"
HBM_BYTES_PER_S = 3.35e12

PLAIN_ACCESS = '''template <typename T>
__device__ __forceinline__ T ld_plain(const T* p) { return *p; }
template <typename T>
__device__ __forceinline__ void st_plain(T* p, T v) { *p = v; }

template <bool kFirst>
__device__ __forceinline__ float4 fold4('''

LD_256B = '''__device__ __forceinline__ float4 ld_cs_256(const float4* p) {
  float4 v;
  asm("ld.global.cs.L2::256B.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
  return v;
}

template <bool kFirst>
__device__ __forceinline__ float4 fold4('''

# the cp.async.bulk ring: one chunk per stage (d and acc of its whole packs),
# thread 0 keeps kRingStages chunks in flight, all threads fold a stage from
# shared memory, store with __stcs and do the chunk's scalar part from device
# memory; a __syncthreads frees the stage for the chunk kRingStages ahead
RING = r'''
constexpr int kRingStages = 4;
constexpr int kRingBytes = kRingStages * 2 * kChunkPacks * 16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ring_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  }
}

// chunk c's leaf (cursor i only moves forward) and element range
__device__ __forceinline__ void chunk_span(const FoldTable& t, int c, int& i, long long& e0,
                                           long long& e1) {
  while (i + 1 < t.leaves && c >= t.leaf[i + 1].chunk0) ++i;
  e0 = (c - t.leaf[i].chunk0) * (4LL * kChunkPacks);
  e1 = min(e0 + 4LL * kChunkPacks, t.leaf[i].n);
}

template <bool kFirst>
__global__ void __launch_bounds__(kFoldThreads)
fold_tree_ring_kernel(const __grid_constant__ FoldTable t) {
  extern __shared__ __align__(128) float4 ring[];  // [stage][d, acc][kChunkPacks]
  __shared__ __align__(8) uint64_t full[kRingStages];
  const int items = (t.chunks - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRingStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(&full[s])));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  int pi = 0;
  auto issue = [&](int k) {  // thread 0: chunk k of this block into stage k % kRingStages
    long long e0, e1;
    chunk_span(t, blockIdx.x + k * gridDim.x, pi, e0, e1);
    const long long p0 = e0 / 4, p1 = t.leaf[pi].aligned ? e1 / 4 : p0;
    const uint32_t bytes = static_cast<uint32_t>(p1 - p0) * 16;
    const int s = k % kRingStages;
    const uint32_t bar = smem_u32(&full[s]);
    float4* st = ring + s * 2 * kChunkPacks;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(bar), "r"(kFirst ? bytes : 2 * bytes) : "memory");
    if (bytes) {
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
          ::"r"(smem_u32(st)), "l"(t.leaf[pi].d + e0), "r"(bytes), "r"(bar) : "memory");
      if (!kFirst)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
            ::"r"(smem_u32(st + kChunkPacks)), "l"(t.leaf[pi].acc + e0), "r"(bytes), "r"(bar)
            : "memory");
    }
  };
  if (threadIdx.x == 0)
    for (int k = 0; k < kRingStages && k < items; ++k) issue(k);
  const float w = t.w;
  int i = 0;
  for (int k = 0; k < items; ++k) {
    long long e0, e1;
    chunk_span(t, blockIdx.x + k * gridDim.x, i, e0, e1);
    const int s = k % kRingStages;
    ring_wait(&full[s], (k / kRingStages) & 1);
    float* acc = t.leaf[i].acc;
    const float* d = t.leaf[i].d;
    long long scalar0 = e0;
    if (t.leaf[i].aligned) {
      const float4* st = ring + s * 2 * kChunkPacks;
      const long long p0 = e0 / 4, p1 = e1 / 4;
      float4* acc4 = reinterpret_cast<float4*>(acc);
      for (long long p = p0 + threadIdx.x; p < p1; p += kFoldThreads) {
        const float4 x = st[p - p0];
        __stcs(acc4 + p, fold4<kFirst>(kFirst ? x : st[kChunkPacks + p - p0], x, w));
      }
      scalar0 = p1 * 4;
    }
    for (long long e = scalar0 + threadIdx.x; e < e1; e += kFoldThreads) {
      const float s1 = __fmul_rn(__ldcs(d + e), w);
      __stcs(acc + e, kFirst ? s1 : __fadd_rn(__ldcs(acc + e), s1));
    }
    __syncthreads();
    if (threadIdx.x == 0 && k + kRingStages < items) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // reads before the refill
      issue(k + kRingStages);
    }
  }
}

int fold_tree('''

RING_LAUNCH_OLD = '''  if (first) {
    fold_tree_kernel<true><<<blocks, kFoldThreads, 0, s>>>(*table);
  } else {
    fold_tree_kernel<false><<<blocks, kFoldThreads, 0, s>>>(*table);
  }'''
RING_LAUNCH_NEW = '''  cudaFuncSetAttribute(fold_tree_ring_kernel<true>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, kRingBytes);
  cudaFuncSetAttribute(fold_tree_ring_kernel<false>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, kRingBytes);
  if (first) {
    fold_tree_ring_kernel<true><<<blocks, kFoldThreads, kRingBytes, s>>>(*table);
  } else {
    fold_tree_ring_kernel<false><<<blocks, kFoldThreads, kRingBytes, s>>>(*table);
  }'''


def _const(name: str, value: int) -> tuple:
    old = {"kFoldUnroll": 4, "kFoldBlocksPerSm": 4, "kChunkPacks": 2048, "kFoldThreads": 256}[name]
    return (f"constexpr int {name} = {old};", f"constexpr int {name} = {value};")


VARIANTS = {
    "as_built": [],
    "as_built_again": [],
    "unroll1": [_const("kFoldUnroll", 1)],
    "unroll2": [_const("kFoldUnroll", 2)],
    "unroll8": [_const("kFoldUnroll", 8)],
    "no_hints": [("template <bool kFirst>\n__device__ __forceinline__ float4 fold4(", PLAIN_ACCESS),
                 ("__ldcs(", "ld_plain("), ("__stcs(", "st_plain(")],
    "ld_cs_l2_256b": [("template <bool kFirst>\n__device__ __forceinline__ float4 fold4(", LD_256B),
                      ("x[k] = __ldcs(d4 + q);", "x[k] = ld_cs_256(d4 + q);"),
                      ("a[k] = __ldcs(acc4 + q);", "a[k] = ld_cs_256(acc4 + q);")],
    "blocks1": [_const("kFoldBlocksPerSm", 1)],
    "blocks2": [_const("kFoldBlocksPerSm", 2)],
    "blocks8": [_const("kFoldBlocksPerSm", 8)],
    "blocks1_unroll2": [_const("kFoldBlocksPerSm", 1), _const("kFoldUnroll", 2)],
    "blocks1_threads512": [_const("kFoldBlocksPerSm", 1), _const("kFoldThreads", 512)],
    "blocks1_threads1024": [_const("kFoldBlocksPerSm", 1), _const("kFoldThreads", 1024),
                            _const("kChunkPacks", 4096)],
    "chunk1024": [_const("kChunkPacks", 1024)],
    "chunk4096": [_const("kChunkPacks", 4096)],
    "contiguous_runs": [(
        "  for (int c = blockIdx.x; c < t.chunks; c += gridDim.x) {",
        "  const int per = (t.chunks + gridDim.x - 1) / gridDim.x;\n"
        "  const int c_end = min(t.chunks, static_cast<int>(blockIdx.x + 1) * per);\n"
        "  for (int c = blockIdx.x * per; c < c_end; ++c) {")],
    "bulk_ring": [_const("kChunkPacks", 1024), _const("kFoldBlocksPerSm", 1),
                  ("\nint fold_tree(", RING), (RING_LAUNCH_OLD, RING_LAUNCH_NEW)],
    "bulk_ring_blocks2": [_const("kChunkPacks", 512), _const("kFoldBlocksPerSm", 2),
                          ("\nint fold_tree(", RING), (RING_LAUNCH_OLD, RING_LAUNCH_NEW)],
}


def compile_variant(name: str):
    text = SOURCE.read_text()
    for old, new in VARIANTS[name]:
        if old not in text:
            return name, 1, [f"the source no longer holds {old!r}"]
        text = text.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    cu.write_text(text)
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    lines, entry = [], None
    for ln in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry function" in ln:
            entry = ln
        elif "error" in ln or ("fold_tree" in (entry or "") and ("Used" in ln or "spill" in ln)):
            kind = "first" if "ILb1E" in (entry or "") else "later"
            ring = "ring " if "ring" in (entry or "") else ""
            lines.append(f"{ring}{kind}: {ln.strip()[-200:]}")
    return name, proc.returncode, lines


def cuda_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def same_bytes(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _load(name: str):
    """The variant's library, bound as the wrapper binds agg.cu, and its
    chunk size."""
    lib = ctypes.CDLL(str(OUT / f"lib{name}.so"))
    layout = (ctypes.c_int * 3)()
    lib.agg_fold_tree_layout(layout)
    return lib, layout[1]


def _use(lib, chunk_packs: int) -> None:
    kernel.CHUNK_PACKS, kernel.CHUNK = chunk_packs, 4 * chunk_packs
    kernel._bind(lib)
    kernel.LIBRARY._lib = lib  # the wrappers launch this variant


def measure(names, rounds: int = 5) -> list:
    """Every variant in one process, in turns: checked against the plain
    fold, then ``rounds`` rounds that time each variant (in order, then in
    reverse order) beside per-leaf ``torch.add`` and ``_foreach_add_``."""
    import chip_smoke

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = chip_smoke._flat_shapes(chip_smoke.qwen_shapes())
    ds = [0.02 * torch.randn(s, generator=gen, device=dev) for s in shapes]
    ds2 = [0.02 * torch.randn(s, generator=gen, device=dev) for s in shapes]
    n = sum(x.numel() for x in ds)
    want_first = ref.exact_fold_into_tree(None, ds, 137.0)
    want_later = ref.exact_fold_into_tree([a.clone() for a in want_first], ds2, 174.0)
    libs = {name: _load(name) for name in names}
    rows = {}
    for name in names:
        _use(*libs[name])
        acc = kernel.exact_fold_into_tree(None, ds, 137.0)
        first_ok = all(same_bytes(a, b) for a, b in zip(acc, want_first))
        kernel.exact_fold_into_tree(acc, ds2, 174.0)
        rows[name] = {"variant": name, "chunk_packs": libs[name][1], "bit_equal_first": first_ok,
                      "bit_equal_later": all(same_bytes(a, b) for a, b in zip(acc, want_later)),
                      "ms": [], "first_ms": []}
        del acc
    del want_first, want_later
    torch.cuda.empty_cache()
    acc = [torch.zeros_like(x) for x in ds]
    w = 111.0
    library = {"torch.add per leaf": [], "torch._foreach_add_": []}
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            _use(*libs[name])
            rows[name]["ms"].append(cuda_ms(lambda: kernel.exact_fold_into_tree(acc, ds, w)))
            rows[name]["first_ms"].append(cuda_ms(lambda: kernel.exact_fold_into_tree(None, ds, w)))
        library["torch.add per leaf"].append(cuda_ms(
            lambda: [torch.add(a, x, alpha=w, out=a) for a, x in zip(acc, ds)]))
        library["torch._foreach_add_"].append(cuda_ms(lambda: torch._foreach_add_(acc, ds, alpha=w)))
    bound_ms = 12 * n / HBM_BYTES_PER_S * 1e3
    out = []
    for row in rows.values():
        ms = sorted(row["ms"])
        out.append({**row, "ms": [round(t, 4) for t in row["ms"]],
                    "first_ms": [round(t, 4) for t in row["first_ms"]],
                    "median_ms": round(ms[len(ms) // 2], 4),
                    "median_share_of_bound": round(bound_ms / ms[len(ms) // 2], 4)})
    out.append({"library": {k: [round(t, 4) for t in v] for k, v in library.items()},
                "bound_ms": round(bound_ms, 4)})
    return out


def main() -> int:
    if sys.argv[1:2] == ["--measure"]:
        for row in measure(sys.argv[2:]):
            print(json.dumps(row), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("agg_fold_variants: no CUDA device", file=sys.stderr)
        return 2
    names = sys.argv[1:] or list(VARIANTS)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(compile_variant, names))
    print(f"build_s {time.perf_counter() - t0:.1f}")
    for name, rc, lines in built:
        print(f"{name}: nvcc rc {rc}")
        for ln in lines:
            print(f"    {ln}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    ok = [name for name, rc, _ in built if rc == 0]
    try:
        proc = subprocess.run([sys.executable, __file__, "--measure", *ok], timeout=600,
                              capture_output=True, text=True)
    except subprocess.TimeoutExpired:
        print("measure: timed out", flush=True)
        return 1
    print(proc.stdout.strip() or f"measure failed\n{proc.stderr[-3000:]}", flush=True)
    wrong = '"bit_equal_first": false' in proc.stdout or '"bit_equal_later": false' in proc.stdout
    return 1 if proc.returncode or wrong or len(ok) < len(built) else 0


if __name__ == "__main__":
    sys.exit(main())
