// Forward flash attention for Hopper on the tensor cores (sm_90a) at head
// dim 256: bfloat16 q, k and v, TMA loads and wgmma products. Bound to
// Python with ctypes; the wrapper (kernel.py) sends it bf16 inputs at D 256,
// flash_sm90.cu those at D 64 and 128, and everything else to flash.cu.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention/kernel.py:
//
//   flash_attention_forward_sm90_d256   flash_attention_bhsd (kernel.py:76, body
//                                       _flash_kernel at :25-73): tiled
//                                       online-softmax attention, forward only
//
// What it computes is flash_sm90.cu's function, per batch b, query head h
// and query row qpos:
//   GQA: q head h reads kv head h / (H / Hkv);
//   s = q . k in float32 (bf16 products, float32 sums on the tensor cores),
//   kept in log2 units: s = (q . k) * c with c = fl(D^-0.5 * log2 e);
//   masked to -1e30 (not -inf) unless kpos < kv_len, and (causal)
//   kpos <= qpos, and (window) kpos > qpos - window;
//   m, l and acc in float32, updated tile by tile:
//     m_new = max(m, max_j s_j); p_j = exp2(s_j - m_new); alpha = exp2(m - m_new)
//     l = alpha * l + sum_j p_j;  acc = alpha * acc + sum_j bf16(p_j) v_j
//   out = acc / max(l, 1e-30), rounded to nearest bf16.
// P is rounded to bf16 before P V (wgmma multiplies bf16 operands) and l
// sums the float32 p, as in flash_sm90.cu, whose header gives what either
// rounding costs against float32 attention. exp2 is ex2.approx.ftz.f32,
// exp2f's 2-ulp MUFU approximation without its denormal range: a p or an
// alpha below 2^-126 is 0 (3% faster at Gemma's shape, PERF.md).
//
// Skipped tiles: flash_sm90.cu's rule with 128-row q tiles and kBK-key KV
// tiles. A block visits the KV tiles from k_begin (the tile holding
// q0 - window + 1, rounded down to a tile) to k_end (kv_len, or under causal
// the end of the q tile's diagonal); every skipped tile is wholly masked for
// all 128 rows. Both warpgroups visit the same tiles (they share the ring),
// except that under causal warpgroup 0 stops at its own last row: the tiles
// after it are wholly masked for its 64 rows. A visited tile wholly masked
// for a warpgroup's rows adds p = 0 once its rows have a valid key, and
// before that gathers uniform sums under the -1e30 sentinel that
// alpha = exp2(-1e30 - m) = 0 wipes at the row's first valid key. The mask
// is applied only on tiles that cross the diagonal, the window's edge or
// kv_len for some row of the warpgroup.
//
// Bound. For Gemma-7B's prefill (B 8, H 16, Hkv 16, S 2048, D 256, causal)
// the two products are 2.75e11 operations over the causal pairs against
// 537 MB of q, k, v and output: 0.278 ms at 989 TFLOP/s of dense bf16 on
// the tensor cores, 0.160 ms at 3.35 TB/s, so operations bound it.
//
// Why a kernel of its own, not one more head dim of flash_sm90.cu: at D 256
// a consumer's accumulator is 64 x 256 float32 over 128 threads, 128
// registers a thread, so the thread layout, the KV tile and the register
// budget all change (flash_sm90.cu's notes: it compiles within 168
// registers and already spills 16 bytes at D 128).
//
// Design (FA3's forward at D 256; one thread block of kThreads threads per
// 128-row q tile, q head and batch):
// - Warpgroups 0 and 1 consume, each owning 64 q rows (wgmma's M);
//   warpgroup 2 produces: one of its threads issues every TMA load.
//   setmaxnreg gives the producer kProducerRegs registers a thread and each
//   consumer kConsumerRegs: 128 x 24 + 256 x 240 = 64 512 of the SM's
//   65 536. The entry is compiled for 384 threads (168 registers); the
//   warp-specialised branches never reconverge, so ptxas allocates the
//   consumer branch within 240 (its SASS names up to R188, no spill).
// - KV tiles of kBK = 64 keys in a ring of two stages. Shared memory: Q
//   128 x 256 x 2 B = 64 KB, plus 2 x (K 32 KB + V 32 KB) = 192 KB, plus the
//   barriers: one block per SM.
// - Loads: TMA over 4-D tensor maps (D, S, heads, batch) built on the host
//   per call from the tensors' strides, so the model's (B, S, H, D) tensors
//   go in without a copy. The 128-byte swizzle caps a box at 64 bf16
//   columns, so every tile arrives as D / 64 = 4 boxes of [rows][64], each
//   in its own 1024-byte-aligned region. Keys past Skv and rows past Sq
//   arrive as zeros (TMA's out-of-bounds fill); kv_len masks those keys
//   and rows >= Sq are not written.
// - S = Q K^T: 16 k-steps of wgmma m64n64k16, both operands from shared
//   memory (K-major: 32 bytes per k16 step inside a box, the next box
//   after 4 steps), float32 accumulators: 32 registers.
// - Softmax in registers: each thread holds two rows of S; row max by a
//   quad shuffle, l as a per-thread partial summed over the quad at the
//   end. O is rescaled by alpha in the consumer, 128 multiplies a tile.
// - O += P V: 4 k-steps of 16 keys; each is two wgmma m64n128k16 with A = P
//   from registers (the accumulator's layout, rounded to bf16, is the A
//   fragment's) and B = V from shared memory, N-major with the transpose
//   bit: the leading byte offset steps between the 64-column boxes of the
//   tile (kBK x 128 B), and the second 128-column half starts two boxes in.
// - Output: bf16 pairs stored from the registers, rows >= Sq not written.
// - The grid is kv-head major: the q heads of a group, then the q tiles,
//   are the fastest indices, so the blocks in flight read the K and V of
//   a few (kv head, batch) pairs, which stay in L2 (Gemma's: 2 MB a pair).
//   flash_sm90.cu's order (q tile slowest, heads fastest) has the 132
//   blocks in flight read 132 pairs' K and V, so every block reads its
//   own from device memory. Causal grids run each kv head's heaviest q
//   tile first.
// No pipelining inside a warpgroup and no turns between the two: each
// waits for its S product before the softmax and for P V before the next
// tile, and the two overlap one another as they fall. FA3's turns (the
// warpgroups take turns to issue S, named barriers 1 and 2) are a variant
// of tools/flash_sm90_variants.py: within 1% (PERF.md). S of the next tile
// issued before P V of this one (FA3's intra-warpgroup overlap) ran 29%
// slower.
//
// Where trouble is likely:
// - Registers: O 128 + S 32 + P 16 + m, l, alpha and addresses, about 200.
//   ptxas's -v count is the entry's (168 at 384 threads); the consumer
//   loop's SASS is the test: no STL/LDL there, the highest register it
//   names, and no C7512 warning (a serialized wgmma). A __trap() anywhere
//   in the consumer branch (flash_sm90.cu's watchdog) makes ptxas allocate
//   the branch within the entry's 168 instead: it spilled 240 bytes,
//   serialized every wgmma and ran 1.5x slower. So the watchdog here
//   faults instead of trapping (mbar_wait). Without setmaxnreg the budget
//   is 168 however many threads the block has: the register file is split
//   among the SM's four sub-partitions, and a block of 9 to 12 warps puts
//   3 on one of them (65 536 / 4 / 3 / 32 = 170).
// - cuTensorMapEncodeTiled is a driver-API call and the library links only
//   the CUDA runtime: the entry is fetched once through
//   cudaGetDriverEntryPoint.
// - TMA needs a 16-byte-aligned base and strides that are multiples of 16
//   bytes. The wrapper checks both and raises; it never sends such a
//   tensor to flash.cu.
// - wgmma writes its accumulators asynchronously: fence_regs after each
//   wait keeps the compiler from reading them before it.
//
// The entry launches on the stream it is given, allocates nothing and
// returns 0 or an error: a cudaError_t from cudaFuncSetAttribute or
// cudaGetLastError() after the launch, or kNoEncoder / kEncodeFailed - r
// when a tensor map cannot be built.

#include <cuda.h>  // CUtensorMap and its enums; the driver call goes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 256;
constexpr int kConsumerWGs = 2;     // consumer warpgroups of 64 q rows each
constexpr int kBK = 64;             // keys per KV tile
constexpr int kStages = 2;
constexpr int kProducerRegs = 24;   // setmaxnreg of the producer warpgroup (0: a producer warp)
constexpr int kConsumerRegs = 240;  // setmaxnreg of each consumer warpgroup
constexpr int kBQ = 64 * kConsumerWGs;  // q rows per block
constexpr int kThreads = 128 * kConsumerWGs + (kProducerRegs > 0 ? 128 : 32);
constexpr int kConsumerWarps = 4 * kConsumerWGs;
constexpr int kBoxCols = 64;  // 128 bytes of bf16: the 128-byte swizzle's width
constexpr int kBoxRowBytes = 128;
constexpr int kBoxes = kD / kBoxCols;
constexpr float kNegInf = -1e30f;  // the JAX package's NEG_INF
constexpr int kNoEncoder = -1;
constexpr int kEncodeFailed = -1000;

// byte offsets into the 1024-aligned dynamic shared memory
constexpr int kQBytes = kBQ * kD * 2;
constexpr int kTileBytes = kBK * kD * 2;  // one K or one V tile
constexpr int kKOff = kQBytes;
constexpr int kVOff = kKOff + kStages * kTileBytes;
constexpr int kBarOff = kVOff + kStages * kTileBytes;
// q_full, then k_full, v_full and empty for each stage
constexpr int kSmemBytes = kBarOff + (1 + 3 * kStages) * 8;
constexpr int kLaunchBytes = kSmemBytes + 1024;  // room to align the base
static_assert(kLaunchBytes <= 232448, "more shared memory than a block may take");
static_assert(kBK % 16 == 0 && kBK * kBoxRowBytes % 1024 == 0, "KV boxes must stay 1024-aligned");

struct Params {
  void* o;
  long long o_sb, o_sh, o_ss;  // output strides in elements: batch, head, sequence
  int heads, kv_heads, batch, n_tiles;
  int sq, kv_len, group, causal, window;
  float scale_log2;  // D^-0.5 * log2(e)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// returns once the phase of parity `parity` has completed. A wait that
// polls 2^26 times (over a second; a tile takes microseconds) stores to
// address 0: the illegal-address fault fails the launch instead of hanging
// the card. (flash_sm90.cu traps there; a trap block in the consumer
// branch makes ptxas allocate it within the entry's 168 registers, not
// setmaxnreg's 240: see "Registers" above.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (spins == (1u << 26))
      asm volatile("st.global.u32 [%0], %1;" ::"l"(0ull), "r"(0u) : "memory");
  }
}

// ---------------------------------------------------------------- TMA
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets in 16-byte units, layout type 1 (B128) in bits 62-63.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps the compiler from moving reads or writes of these registers across
// the asynchronous wgmma region
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define F8(i)                                                                              \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 32, f32) (+)= A (64 x 16, smem, K-major) * B (16 x 32, smem, K-major)
__device__ __forceinline__ void wgmma_qk(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : F8(0), F8(8)
      : "l"(a), "l"(b), "r"(acc));
}

// d (64 x 64, f32) (+)= A (64 x 16, smem, K-major) * B (16 x 64, smem, K-major)
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : F8(0), F8(8), F8(16), F8(24)
      : "l"(a), "l"(b), "r"(acc));
}

// d (64 x 80, f32) (+)= A (64 x 16, smem, K-major) * B (16 x 80, smem, K-major)
__device__ __forceinline__ void wgmma_qk(float (&d)[40], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "%40, %41, p, 1, 1, 0, 0;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32)
      : "l"(a), "l"(b), "r"(acc));
}

// d (64 x 128, f32) += A (64 x 16, bf16 registers) * B (16 x 128, smem, N-major: transposed)
__device__ __forceinline__ void wgmma_pv(float (&d)[64], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef F8

// 2^x with the MUFU's 2-ulp approximation, flushing results below 2^-126
// to zero: exp2f less its denormal range (a p that small rounds to a bf16
// denormal or to zero anyway)
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---------------------------------------------------------------- kernel
// Accumulator layout of wgmma m64nN (f32), thread t of the warpgroup, warp
// w = t / 32, lane l: element i sits at row 16 w + l / 4 + 8 ((i / 2) % 2),
// column 8 (i / 4) + 2 (l % 4) + i % 2. So each thread holds two rows
// (r = (i / 2) % 2) and the four lanes of a quad share them.
__global__ void __launch_bounds__(kThreads, 1)
    flash_kernel_sm90_d256(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq_addr = base;
  const uint32_t bar = base + kBarOff;
  const uint32_t q_full = bar;
  auto k_full = [&](int s) { return bar + 8u * (1 + s); };
  auto v_full = [&](int s) { return bar + 8u * (1 + kStages + s); };
  auto empty = [&](int s) { return bar + 8u * (1 + 2 * kStages + s); };
  auto k_tile = [&](int s) { return base + kKOff + static_cast<uint32_t>(s * kTileBytes); };
  auto v_tile = [&](int s) { return base + kVOff + static_cast<uint32_t>(s * kTileBytes); };

  // block -> (q head in its group, q tile, kv head, batch), fastest first:
  // the blocks that read one kv head's K and V run side by side and share
  // them in L2; causal grids run each kv head's last (heaviest) tile first
  const int g = blockIdx.x % p.group;
  const int rest = blockIdx.x / p.group;
  int tile = rest % p.n_tiles;
  const int hkb = rest / p.n_tiles;
  const int hk = hkb % p.kv_heads;
  const int b = hkb / p.kv_heads;
  const int h = hk * p.group + g;
  if (p.causal) tile = p.n_tiles - 1 - tile;
  const int q0 = tile * kBQ;

  // the KV tiles with a valid key for some row of this q tile (see above)
  int k_end = p.kv_len;
  if (p.causal) k_end = min(k_end, q0 + kBQ);
  int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  k_begin -= k_begin % kBK;
  const int n_kv = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the consumer warpgroups first, then the producer (wgmma needs
  // warpgroup-aligned warps); the two branches never reconverge
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == kConsumerWGs) {
    // ------------------------------------------------ producer
    if constexpr (kProducerRegs > 0)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs) : "memory");
    if (threadIdx.x == 128 * kConsumerWGs) {
      mbar_expect_tx(q_full, kQBytes);
      for (int c = 0; c < kBoxes; ++c)
        tma_load(sq_addr + c * kBQ * kBoxRowBytes, &tq, q_full, c * kBoxCols, q0, h, b);
      for (int it = 0; it < n_kv; ++it) {
        const int s = it % kStages;
        const uint32_t phase = static_cast<uint32_t>(it / kStages) & 1u;
        const int k0 = k_begin + it * kBK;
        mbar_wait(empty(s), phase ^ 1u);  // the first round finds every stage free
        mbar_expect_tx(k_full(s), kTileBytes);
        for (int c = 0; c < kBoxes; ++c)
          tma_load(k_tile(s) + c * kBK * kBoxRowBytes, &tk, k_full(s), c * kBoxCols, k0, hk, b);
        mbar_expect_tx(v_full(s), kTileBytes);
        for (int c = 0; c < kBoxes; ++c)
          tma_load(v_tile(s) + c * kBK * kBoxRowBytes, &tv, v_full(s), c * kBoxCols, k0, hk, b);
      }
    }
  } else {
    // ------------------------------------------------ consumer warpgroups
    if constexpr (kProducerRegs > 0)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs) : "memory");
    const int cw = wg;  // rows q0 + 64 cw ... q0 + 64 cw + 63
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int row_lo = q0 + 64 * cw;
    const int row_hi = row_lo + 63;
    const int row0 = row_lo + 16 * (t / 32) + lane / 4;  // and row0 + 8
    const int col0 = 2 * (lane % 4);

    float o[2][64];  // columns 0-127 and 128-255
#pragma unroll
    for (int i = 0; i < 64; ++i) o[0][i] = o[1][i] = 0.0f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.0f, 0.0f};  // this thread's partial sums; the quad's sum at the end

    // Q rows of this warpgroup inside each 64-column box
    const uint64_t q_desc = sw128_desc(sq_addr + cw * 64 * kBoxRowBytes, 16, 1024);

    // S = Q K^T of stage s: D / 16 steps of k16; box kk / 4, 32 bytes per
    // step inside it (offsets in the descriptors' 16-byte units)
    auto qk = [&](int s, float (&sc)[kBK / 2]) {
      uint64_t q_tile = q_desc;  // rebuilt each tile: hoisted descriptors would hold registers
      asm volatile("" : "+l"(q_tile));
      const uint64_t k_desc = sw128_desc(k_tile(s), 16, 1024);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const uint32_t off = ((kk / 4) * (kBQ * kBoxRowBytes) + (kk % 4) * 32) >> 4;
        const uint32_t koff = ((kk / 4) * (kBK * kBoxRowBytes) + (kk % 4) * 32) >> 4;
        wgmma_qk(sc, q_tile + off, k_desc + koff, kk > 0);
      }
    };
    // O += P V of stage s: kBK / 16 steps of 16 keys (2048 bytes of V rows
    // each), two 128-column halves per step; the leading byte offset steps
    // between the 64-column boxes, the second half starts two boxes in
    auto pv = [&](int s, const uint32_t (&pa)[kBK / 4]) {
      const uint64_t v_desc = sw128_desc(v_tile(s), kBK * kBoxRowBytes, 1024);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint32_t voff = (kk * 16 * kBoxRowBytes) >> 4;
        wgmma_pv(o[0], &pa[4 * kk], v_desc + voff);
        wgmma_pv(o[1], &pa[4 * kk], v_desc + voff + ((2 * kBK * kBoxRowBytes) >> 4));
      }
    };
    // scale (log2 units), mask where some row of this warpgroup needs it,
    // and the online softmax over the two rows this thread holds: sc
    // becomes p, m and l move on, alpha rescales O
    auto softmax = [&](float (&sc)[kBK / 2], int k0, float (&alpha)[2]) {
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) sc[i] *= p.scale_log2;
      const bool masked = k0 + kBK > p.kv_len || (p.causal && k0 + kBK - 1 > row_lo) ||
                          (p.window > 0 && k0 <= row_hi - p.window);
      if (masked) {
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i) {
          const int kpos = k0 + 8 * (i / 4) + col0 + i % 2;
          const int qpos = row0 + 8 * ((i / 2) % 2);
          const bool ok = kpos < p.kv_len && (!p.causal || kpos <= qpos) &&
                          (p.window <= 0 || kpos > qpos - p.window);
          if (!ok) sc[i] = kNegInf;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < kBK / 4; ++j) mx = fmaxf(mx, sc[4 * (j / 2) + 2 * r + j % 2]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        alpha[r] = ex2_ftz(m[r] - m_new);
        m[r] = m_new;
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < kBK / 4; ++j) {
          const int i = 4 * (j / 2) + 2 * r + j % 2;
          sc[i] = ex2_ftz(sc[i] - m_new);
          sum += sc[i];
        }
        l[r] = alpha[r] * l[r] + sum;
      }
    };
    auto rescale = [&](const float (&alpha)[2]) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        o[0][i] *= alpha[(i / 2) % 2];
        o[1][i] *= alpha[(i / 2) % 2];
      }
    };
    // P as bf16 A fragments: k16 step kk holds accumulator elements 8 kk ... 8 kk + 7
    auto pack = [&](const float (&sc)[kBK / 2], uint32_t (&pa)[kBK / 4]) {
#pragma unroll
      for (int j = 0; j < kBK / 4; ++j) pa[j] = pack_bf16(sc[2 * j], sc[2 * j + 1]);
    };

    // under causal, the KV tiles past this warpgroup's last row are wholly
    // masked for it (the other warpgroup's diagonal): it stops before them.
    // They are the block's last tiles, so no load waits on the stages it
    // leaves unreleased; a visit would add p = 0 at alpha = 1, so skipping
    // them changes no bit.
    int n_mine = n_kv;
    if (p.causal) n_mine = min(n_kv, max(0, (row_hi + 1 - k_begin + kBK - 1) / kBK));
    mbar_wait(q_full, 0);
    for (int it = 0; it < n_mine; ++it) {
      const int s = it % kStages;
      const uint32_t phase = static_cast<uint32_t>(it / kStages) & 1u;
      float sc[kBK / 2];
      mbar_wait(k_full(s), phase);
      wgmma_fence();
      qk(s, sc);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      float alpha[2];
      softmax(sc, k_begin + it * kBK, alpha);
      rescale(alpha);
      uint32_t pa[kBK / 4];
      pack(sc, pa);
      mbar_wait(v_full(s), phase);
      fence_regs(o[0]);
      fence_regs(o[1]);
      fence_regs(pa);
      wgmma_fence();
      pv(s, pa);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o[0]);
      fence_regs(o[1]);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));  // this warp is done with the stage
    }

    // out = acc / max(l, 1e-30) in bf16, rows < Sq
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float den = fmaxf(sum, 1e-30f);
      const int row = row0 + 8 * r;
      if (row < p.sq) {
        __nv_bfloat16* dst = out + row * p.o_ss + col0;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const __nv_bfloat162 v = __floats2bfloat162_rn(o[hf][4 * j + 2 * r] / den,
                                                           o[hf][4 * j + 2 * r + 1] / den);
            *reinterpret_cast<__nv_bfloat162*>(dst + 128 * hf + 8 * j) = v;
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------- host
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* entry = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &entry,
                                                             12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &entry, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(entry);
  }
  return fn;
}

// a 4-D map (D, S, heads, batch) over a bf16 tensor with the given strides in
// elements; boxes of 64 columns x rows, 128-byte swizzle, zeros out of bounds
int make_map(CUtensorMap* map, const void* ptr, int S, int heads, int batch,
             const long long* strides, int rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return kNoEncoder;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(kD), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  // strides[0 .. 2] = (batch, head, sequence); TMA takes dims 1 .. 3 in bytes
  const cuuint64_t bytes[3] = {static_cast<cuuint64_t>(strides[2]) * 2,
                               static_cast<cuuint64_t>(strides[1]) * 2,
                               static_cast<cuuint64_t>(strides[0]) * 2};
  const cuuint32_t box[4] = {kBoxCols, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                            bytes, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed - static_cast<int>(r);
}

}  // namespace

extern "C" {

// bf16 q (B, H, Sq, D), k and v (B, Hkv, Skv, D), o (B, H, Sq, D), D 256,
// each given by its data pointer and strides[3 * i .. 3 * i + 2] = (batch,
// head, sequence) in elements, i = 0 (q), 1 (k), 2 (v), 3 (o); the last
// dimension has stride 1. The wrapper (kernel.py) checks shapes, dtype, D,
// 16-byte alignment of q, k and v and the grid's size. The argument list is
// flash_attention_forward_sm90's.
int flash_attention_forward_sm90_d256(const void* q, const void* k, const void* v, void* o,
                                      const long long* strides, int B, int H, int Hkv, int Sq,
                                      int Skv, int D, int kv_len, int causal, int window,
                                      float scale, void* stream) {
  if (Sq == 0) return 0;
  if (D != kD) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, Sq, H, B, strides, kBQ);
  if (err == 0) err = make_map(&tk, k, Skv, Hkv, B, strides + 3, kBK);
  if (err == 0) err = make_map(&tv, v, Skv, Hkv, B, strides + 6, kBK);
  if (err != 0) return err;
  Params p;
  p.o = o;
  p.o_sb = strides[9];
  p.o_sh = strides[10];
  p.o_ss = strides[11];
  p.heads = H;
  p.kv_heads = Hkv;
  p.batch = B;
  p.n_tiles = (Sq + kBQ - 1) / kBQ;
  p.sq = Sq;
  p.kv_len = kv_len;
  p.group = H / Hkv;
  p.causal = causal;
  p.window = window;
  p.scale_log2 = static_cast<float>(static_cast<double>(scale) * 1.4426950408889634);
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_kernel_sm90_d256, cudaFuncAttributeMaxDynamicSharedMemorySize, kLaunchBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int grid = p.n_tiles * p.heads * p.batch;
  flash_kernel_sm90_d256<<<grid, kThreads, kLaunchBytes, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
