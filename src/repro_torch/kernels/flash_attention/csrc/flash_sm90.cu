// Forward flash attention for Hopper on the tensor cores (sm_90a): bfloat16
// q, k and v at head dims 32, 64 and 128, TMA loads and wgmma products. Bound
// to Python with ctypes; the wrapper (kernel.py) sends it bf16 inputs at those
// head dims, bf16 at D 256 to csrc/flash_sm90_d256.cu and float32 to
// csrc/flash.cu.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention/kernel.py:
//
//   flash_attention_forward_sm90   flash_attention_bhsd (kernel.py:76, body
//                                  _flash_kernel at :25-73): tiled
//                                  online-softmax attention, forward only
//
// What it computes, per batch b, query head h and query row qpos (the same
// function as flash.cu and the Pallas kernel):
//   GQA: q head h reads kv head h / (H / Hkv);
//   s = q . k in float32 (bf16 products, float32 sums on the tensor cores),
//   times the scale; masked to -1e30 (not -inf) unless kpos < kv_len, and
//   (causal) kpos <= qpos, and (window) kpos > qpos - window;
//   m, l and acc in float32, updated tile by tile:
//     m_new = max(m, max_j s_j); p_j = exp(s_j - m_new); alpha = exp(m - m_new)
//     l = alpha * l + sum_j p_j;  acc = alpha * acc + sum_j p_j v_j
//   out = acc / max(l, 1e-30), rounded to nearest bf16.
// Two differences in rounding, none in the function:
// - P is rounded to bf16 before P V (wgmma multiplies bf16 operands); l sums
//   the float32 p. On bf16 randn inputs at S 2048, D 128 (causal), that
//   rounding alone reads relative L2 1.3e-3 against float32 attention, and
//   2.0e-3 with the output's own bf16 rounding (1.6e-3 without it).
// - exp is exp2f with log2(e) folded into the scale: s is kept as
//   (q . k) * c with c = fl(D^-0.5 * log2 e), m in the same units, and
//   p = exp2f(s - m). Against expf((q . k) * D^-0.5 - m) that moves p by a
//   relative ~1e-6 at |s - m| ~ 20 (the roundings of c and of the product)
//   plus exp2f's 2 ulp: three orders under the bf16 rounding of P. The
//   -1e30 sentinel keeps its meaning in these units: a masked key gives
//   exp2f(-1e30 - m) = 0 once m is finite, and exp2f(0) = 1 while it is not.
//
// Skipped tiles: the rule of flash.cu with 128-row q tiles and 128-key KV
// tiles (64-key at D 32). A block visits the KV tiles from k_begin (the tile holding
// q0 - window + 1, rounded down to a tile) to k_end (kv_len, or under causal
// the end of the q tile's diagonal); every skipped tile is wholly masked for
// all 128 rows. Both warpgroups visit the same tiles (they share the ring),
// so a warpgroup may visit a tile that is wholly masked for its own 64 rows,
// and a window row's first visited tiles may be wholly masked for it. Those
// gather uniform sums under the -1e30 sentinel (m stays -1e30, p = 1) that
// alpha = exp2f(-1e30 - m) = 0 wipes at the row's first tile with a valid
// key, so visiting them or not gives the same result, as flash.cu argues.
// The mask is applied only on tiles that cross the diagonal, the window's
// edge or kv_len for some row of the warpgroup; every other tile is all
// valid and goes unmasked.
//
// Bound. For the serving prefill (B 8, H 16, Hkv 2, S 2048, D 128, causal)
// the two products are 137.5 GFLOP over the causal pairs against 151 MB of
// q, k, v and output: 0.139 ms at 989 TFLOP/s of dense bf16 on the tensor
// cores, 0.045 ms at 3.35 TB/s, so operations bound it. At D 32 (the same
// B, H and S) the products shrink to 34.4 GFLOP (0.035 ms) and the bytes to
// 38 MB (0.011 ms), while the exponentials stay one per causal pair, 2.7e8:
// at the SFU's 16 a clock per SM, 132 SMs and 1.98 GHz (clocks.max.sm),
// 0.065 ms. There the exponentials bound it.
//
// Design (one thread block of 288 threads per 128-row q tile, q head, batch):
// - Warpgroups 0 and 1 consume, each owning 64 q rows (wgmma's M); warp 8
//   produces: one of its threads issues every TMA load. (wgmma needs its
//   warpgroups on warps 4k .. 4k + 3, so the producer comes last.)
// - Loads: TMA over 4-D tensor maps (D, S, heads, batch) built on the host
//   per call from the tensors' strides, so the model's (B, S, H, D) tensors
//   go in without a copy. Q once per block; K and V through a ring of
//   kStages stages, each with a full barrier for K, one for V and an empty
//   barrier that the 8 consumer warps release. Keys past Skv and rows past
//   Sq arrive as zeros (TMA's out-of-bounds fill); kv_len masks those keys
//   and rows >= Sq are not written.
// - 128-byte swizzle caps a box's inner extent at 128 bytes: a D-128 bf16 row
//   is 256 bytes, so every tile is loaded as D/64 boxes of 64 columns, each
//   [rows][64] in its own 1024-byte-aligned region, and the wgmma descriptors
//   step between them (Q and K: K-major, 32 bytes per k16 step inside a box,
//   the next box after 4 steps; V: MN-major, the second box as the leading
//   byte offset). A D-32 row is 64 bytes: one box of 32 columns under the
//   64-byte swizzle (TMA's CU_TENSOR_MAP_SWIZZLE_64B, the descriptors' layout
//   type 2), whose atom is 8 rows of 64 bytes (512 bytes, the stride byte
//   offset): S is two k16 steps of 32 bytes inside the row, and O += P V is
//   wgmma m64n32k16, V's 32 columns one atom wide. Its KV tiles hold 64
//   keys (S is wgmma m64n64k16), so that each warpgroup's short products
//   come between shorter softmaxes: the other warpgroup's softmax then
//   covers more of them.
// - S = Q K^T: wgmma m64n128k16, both operands from shared memory, float32
//   accumulators. K's rows are D-contiguous, K-major for the B operand, so
//   no transpose.
// - Softmax in registers: each thread holds two rows of the accumulator;
//   row max by a quad shuffle, l as a per-thread partial summed over the
//   quad at the end.
// - O += P V: wgmma m64nDk16 with A = P from registers (the accumulator's
//   layout, rounded to bf16, is the A fragment's) and B = V from shared
//   memory, which is N-major: the instruction's transpose bit for B, which
//   exists for 16-bit types only.
// - Output: bf16 pairs stored from the registers, rows >= Sq not written.
// - Causal grids run the heaviest q tiles first: the q tile is the slowest
//   index of a 1-D grid, counted from the last tile down, so the long
//   diagonal rows do not trail the grid; heads are the fastest index, so
//   the q heads that share a kv head run side by side and share K and V in
//   L2.
// Shared memory at D 128: Q 32 KB and kStages x (K + V) = 2 x 64 KB; one
// block per SM (at D 32: 8 KB and 2 x 16 KB). No pipelining inside a warpgroup: each waits for its S
// product before the softmax and for P V before the next tile, and the two
// warpgroups overlap one another.
//
// Where trouble is likely:
// - Registers. ptxas compiles this kernel within 168 registers a thread, as
//   it does for 384 threads, and a consumer holds S (64 at BK 128), O (64 at
//   D 128) and P (32): ptxas spills 16 bytes. A producer warpgroup with
//   setmaxnreg (24 for it, 240 for the consumers) did not raise that
//   budget: ptxas still allocated 168 and spilled the same. A live set any
//   larger (a second S tile, or descriptors kept across tiles) makes ptxas
//   spill P and serialize every wgmma (its warning C7512).
//   tools/flash_sm90_variants.py builds and times such variants.
// - cuTensorMapEncodeTiled is a driver-API call and the library links only
//   the CUDA runtime (build.py's flags are shared by every library): the
//   entry is fetched once through cudaGetDriverEntryPoint.
// - TMA needs a 16-byte-aligned base and strides that are multiples of 16
//   bytes. The wrapper checks both and raises; it never sends such a tensor
//   to flash.cu.
// - wgmma writes its accumulators asynchronously: fence_regs after each
//   wait keeps the compiler from reading them before it.
//
// Each entry launches on the stream it is given, allocates nothing and
// returns 0 or an error: a cudaError_t from cudaFuncSetAttribute or
// cudaGetLastError() after the launch, or kNoEncoder / kEncodeFailed - r
// when a tensor map cannot be built.

#include <cuda.h>  // CUtensorMap and its enums; the driver call goes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;  // q rows per block: two consumer warpgroups of 64
constexpr int kBK = 128;  // keys per KV tile at D 64 and 128
constexpr int kBK32 = 64;  // ... and at D 32 (Layout<32>::kKeys)
constexpr int kStages = 2;
constexpr int kThreads = 288;  // two consumer warpgroups + one producer warp
constexpr int kConsumerWarps = 8;
constexpr float kNegInf = -1e30f;  // the JAX package's NEG_INF
constexpr int kNoEncoder = -1;
constexpr int kEncodeFailed = -1000;

struct Params {
  void* o;
  long long o_sb, o_sh, o_ss;  // output strides in elements: batch, head, sequence
  int heads, batch, n_tiles;
  int sq, kv_len, group, causal, window;
  float scale_log2;  // D^-0.5 * log2(e)
};

template <int D>
struct Layout {  // byte offsets into the 1024-aligned dynamic shared memory
  // a TMA box's columns: 64 (128 bytes of bf16, the 128-byte swizzle's width)
  // or, at D 32, 32 (64 bytes, the 64-byte swizzle's)
  static constexpr int kBoxCols = D < 64 ? D : 64;
  static constexpr int kBoxRowBytes = 2 * kBoxCols;
  static constexpr int kAtomBytes = 8 * kBoxRowBytes;  // 8 rows: the swizzle's repeat
  static constexpr int kSteps = kBoxRowBytes / 32;     // k16 steps inside a box
  // keys per KV tile: at D 32 a tile of 64 keys keeps the products short
  // beside the softmax, which there bounds the kernel (0.177 against 0.234
  // ms at B 8, S 2048, H 16/2: tools/flash_sm90_variants.py)
  static constexpr int kKeys = D == 32 ? kBK32 : kBK;
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kTileBytes = kKeys * D * 2;  // one K or one V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;
  // q_full, then k_full, v_full and empty for each stage
  static constexpr int kBytes = kBar + (1 + 3 * kStages) * 8;
  static constexpr int kLaunchBytes = kBytes + 1024;  // room to align the base
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
// polls 2^26 times (over a second; a tile takes microseconds) traps: a
// broken ring fails the launch instead of hanging the card.
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
    if (spins == (1u << 26)) __trap();
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
// Shared-memory matrix descriptor of a swizzled layout: start address,
// leading and stride byte offsets in 16-byte units, the layout type in bits
// 62-63: 1 for the 128-byte swizzle (rows of 128 bytes), 2 for the 64-byte one.
template <int RowBytes>
__device__ __forceinline__ uint64_t sw_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  static_assert(RowBytes == 128 || RowBytes == 64, "swizzle width");
  constexpr uint64_t kType = RowBytes == 128 ? 1 : 2;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (kType << 62);
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

// d (64 x 128, f32) (+)= A (64 x 16, smem, K-major) * B (16 x 128, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56)
      : "l"(a), "l"(b), "r"(acc));
}

// d (64 x 64, f32) (+)= A (64 x 16, smem, K-major) * B (16 x 64, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : F8(0), F8(8), F8(16), F8(24)
      : "l"(a), "l"(b), "r"(acc));
}

// d (64 x 128, f32) += A (64 x 16, bf16 registers) * B (16 x 128, smem, N-major: transposed)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a, uint64_t b) {
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

// d (64 x 64, f32) += A (64 x 16, bf16 registers) * B (16 x 64, smem, N-major: transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 32, f32) += A (64 x 16, bf16 registers) * B (16 x 32, smem, N-major: transposed)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : F8(0), F8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef F8

// the two products at the kernel's shapes: S over kBK keys, O over D columns
__device__ __forceinline__ void wgmma_qk(float (&s)[32], uint64_t a, uint64_t b, int acc) {
  wgmma_ss_n64(s, a, b, acc);
}
__device__ __forceinline__ void wgmma_qk(float (&s)[64], uint64_t a, uint64_t b, int acc) {
  wgmma_ss_n128(s, a, b, acc);
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t* a, uint64_t b);
template <>
__device__ __forceinline__ void wgmma_pv<32>(float (&o)[16], const uint32_t* a, uint64_t b) {
  wgmma_rs_n32(o, a, b);
}
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32], const uint32_t* a, uint64_t b) {
  wgmma_rs_n64(o, a, b);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64], const uint32_t* a, uint64_t b) {
  wgmma_rs_n128(o, a, b);
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
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_kernel_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = Layout<D>;
  constexpr int kBoxCols = L::kBoxCols, kBoxRowBytes = L::kBoxRowBytes, kSteps = L::kSteps;
  constexpr int kBK = L::kKeys;
  constexpr int kBoxes = D / kBoxCols;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq_addr = base + L::kQ;
  const uint32_t bar = base + L::kBar;
  const uint32_t q_full = bar;
  auto k_full = [&](int s) { return bar + 8u * (1 + s); };
  auto v_full = [&](int s) { return bar + 8u * (1 + kStages + s); };
  auto empty = [&](int s) { return bar + 8u * (1 + 2 * kStages + s); };
  auto k_tile = [&](int s) { return base + L::kK + static_cast<uint32_t>(s * L::kTileBytes); };
  auto v_tile = [&](int s) { return base + L::kV + static_cast<uint32_t>(s * L::kTileBytes); };

  // block -> (q tile, head, batch); causal grids run the last (heaviest) tile first
  const int heads_batch = p.heads * p.batch;
  int tile = blockIdx.x / heads_batch;
  const int hb = blockIdx.x - tile * heads_batch;
  const int h = hb % p.heads;
  const int b = hb / p.heads;
  if (p.causal) tile = p.n_tiles - 1 - tile;
  const int q0 = tile * kBQ;
  const int hk = h / p.group;

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

  // warpgroups 0 and 1 consume, warp 8 produces (wgmma needs warpgroup-aligned warps)
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 2) {
    // ------------------------------------------------ producer warp
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, L::kQBytes);
      for (int c = 0; c < kBoxes; ++c)
        tma_load(sq_addr + c * kBQ * kBoxRowBytes, &tq, q_full, c * kBoxCols, q0, h, b);
      for (int it = 0; it < n_kv; ++it) {
        const int s = it % kStages;
        const uint32_t phase = static_cast<uint32_t>(it / kStages) & 1u;
        const int k0 = k_begin + it * kBK;
        mbar_wait(empty(s), phase ^ 1u);  // the first round finds every stage free
        mbar_expect_tx(k_full(s), L::kTileBytes);
        for (int c = 0; c < kBoxes; ++c)
          tma_load(k_tile(s) + c * kBK * kBoxRowBytes, &tk, k_full(s), c * kBoxCols, k0, hk, b);
        mbar_expect_tx(v_full(s), L::kTileBytes);
        for (int c = 0; c < kBoxes; ++c)
          tma_load(v_tile(s) + c * kBK * kBoxRowBytes, &tv, v_full(s), c * kBoxCols, k0, hk, b);
      }
    }
  } else {
    // ------------------------------------------------ consumer warpgroups
    const int cw = wg;  // rows q0 + 64 cw ... q0 + 64 cw + 63
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int row_lo = q0 + 64 * cw;
    const int row_hi = row_lo + 63;
    const int row0 = row_lo + 16 * (t / 32) + lane / 4;  // and row0 + 8
    const int col0 = 2 * (lane % 4);

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.0f, 0.0f};  // this thread's partial sums; the quad's sum at the end

    // Q rows of this warpgroup inside each 64-column box
    const uint64_t q_desc = sw_desc<kBoxRowBytes>(sq_addr + cw * 64 * kBoxRowBytes, 16,
                                                  L::kAtomBytes);
    mbar_wait(q_full, 0);

    for (int it = 0; it < n_kv; ++it) {
      const int s = it % kStages;
      const uint32_t phase = static_cast<uint32_t>(it / kStages) & 1u;
      const int k0 = k_begin + it * kBK;

      // S = Q K^T: D / 16 steps of k16; box kk / kSteps, 32 bytes per step inside it
      float sc[kBK / 2];
      mbar_wait(k_full(s), phase);
      wgmma_fence();
      uint64_t q_tile = q_desc;  // rebuilt each tile: 8 hoisted descriptors would hold 16 registers
      asm volatile("" : "+l"(q_tile));
      const uint64_t k_desc = sw_desc<kBoxRowBytes>(k_tile(s), 16, L::kAtomBytes);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {  // offsets in the descriptors' 16-byte units
        const uint32_t off = ((kk / kSteps) * (kBQ * kBoxRowBytes) + (kk % kSteps) * 32) >> 4;
        const uint32_t koff = ((kk / kSteps) * (kBK * kBoxRowBytes) + (kk % kSteps) * 32) >> 4;
        wgmma_qk(sc, q_tile + off, k_desc + koff, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // scale (log2 units), mask where some row of this warpgroup needs it
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

      // online softmax over the two rows this thread holds
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < kBK / 4; ++j) mx = fmaxf(mx, sc[4 * (j / 2) + 2 * r + j % 2]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        alpha[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < kBK / 4; ++j) {
          const int i = 4 * (j / 2) + 2 * r + j % 2;
          sc[i] = exp2f(sc[i] - m_new);
          sum += sc[i];
        }
        l[r] = alpha[r] * l[r] + sum;
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i / 2) % 2];

      // P as bf16 A fragments: k16 step kk holds accumulator elements 8 kk ... 8 kk + 7
      uint32_t pa[kBK / 4];
#pragma unroll
      for (int j = 0; j < kBK / 4; ++j) pa[j] = pack_bf16(sc[2 * j], sc[2 * j + 1]);

      // O += P V: BK / 16 steps of 16 keys, 16 rows of V's boxes each
      mbar_wait(v_full(s), phase);
      fence_regs(o);
      fence_regs(pa);
      wgmma_fence();
      const uint64_t v_desc = sw_desc<kBoxRowBytes>(v_tile(s), kBK * kBoxRowBytes, L::kAtomBytes);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_pv<D>(o, &pa[4 * kk], v_desc + ((kk * 16 * kBoxRowBytes) >> 4));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);

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
        for (int j = 0; j < D / 8; ++j) {
          const __nv_bfloat162 v =
              __floats2bfloat162_rn(o[4 * j + 2 * r] / den, o[4 * j + 2 * r + 1] / den);
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = v;
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
// elements; boxes of 64 columns x rows under the 128-byte swizzle (32 columns
// under the 64-byte one at D 32), zeros out of bounds
int make_map(CUtensorMap* map, const void* ptr, int D, int S, int heads, int batch,
             const long long* strides, int rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return kNoEncoder;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  // strides[0 .. 2] = (batch, head, sequence); TMA takes dims 1 .. 3 in bytes
  const cuuint64_t bytes[3] = {static_cast<cuuint64_t>(strides[2]) * 2,
                               static_cast<cuuint64_t>(strides[1]) * 2,
                               static_cast<cuuint64_t>(strides[0]) * 2};
  const cuuint32_t cols = D < 64 ? D : 64;
  const cuuint32_t box[4] = {cols, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                            bytes, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed - static_cast<int>(r);
}

template <int D>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, const Params& p,
           cudaStream_t stream) {
  constexpr int bytes = Layout<D>::kLaunchBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_kernel_sm90<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = p.n_tiles * p.heads * p.batch;
  flash_kernel_sm90<D><<<grid, kThreads, bytes, stream>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// bf16 q (B, H, Sq, D), k and v (B, Hkv, Skv, D), o (B, H, Sq, D), D 32, 64
// or 128, each given by its data pointer and strides[3 * i .. 3 * i + 2] =
// (batch, head, sequence) in elements, i = 0 (q), 1 (k), 2 (v), 3 (o); the
// last dimension has stride 1. The wrapper (kernel.py) checks shapes, dtype,
// D, 16-byte alignment of q, k and v and the grid's size.
int flash_attention_forward_sm90(const void* q, const void* k, const void* v, void* o,
                                 const long long* strides, int B, int H, int Hkv, int Sq, int Skv,
                                 int D, int kv_len, int causal, int window, float scale,
                                 void* stream) {
  if (Sq == 0) return 0;
  if (D != 32 && D != 64 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, D, Sq, H, B, strides, kBQ);
  const int keys = D == 32 ? Layout<32>::kKeys : kBK;
  if (err == 0) err = make_map(&tk, k, D, Skv, Hkv, B, strides + 3, keys);
  if (err == 0) err = make_map(&tv, v, D, Skv, Hkv, B, strides + 6, keys);
  if (err != 0) return err;
  Params p;
  p.o = o;
  p.o_sb = strides[9];
  p.o_sh = strides[10];
  p.o_ss = strides[11];
  p.heads = H;
  p.batch = B;
  p.n_tiles = (Sq + kBQ - 1) / kBQ;
  p.sq = Sq;
  p.kv_len = kv_len;
  p.group = H / Hkv;
  p.causal = causal;
  p.window = window;
  p.scale_log2 = static_cast<float>(static_cast<double>(scale) * 1.4426950408889634);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 32) return launch<32>(tq, tk, tv, p, s);
  return D == 64 ? launch<64>(tq, tk, tv, p, s) : launch<128>(tq, tk, tv, p, s);
}

}  // extern "C"
