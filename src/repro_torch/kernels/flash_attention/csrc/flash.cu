// Forward flash attention in float32 on Hopper's CUDA cores (sm_90a), bound
// to Python with ctypes. The wrapper (kernel.py) sends it float32 at every
// head dim; bf16 goes to the tensor-core kernels, and this entry takes bf16
// only when called directly (chip_smoke.py holds those kernels against it).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention/kernel.py:
//
//   flash_attention_forward   flash_attention_bhsd (kernel.py:76, body
//                             _flash_kernel at :25-73): tiled online-softmax
//                             attention, forward only
//
// What it computes, per batch b, query head h and query row qpos:
//   GQA: q head h reads kv head h / (H / Hkv);
//   s = (q . k) * D^-0.5 in float32; masked to -1e30 (not -inf) unless
//   kpos < kv_len, and (causal) kpos <= qpos, and (window) kpos > qpos - window;
//   m, l and acc in float32, updated tile by tile as the Pallas kernel does:
//     m_new = max(m, max_j s_j); p_j = exp(s_j - m_new); alpha = exp(m - m_new)
//     l = alpha * l + sum_j p_j;  acc = alpha * acc + sum_j p_j v_j
//   out = acc / max(l, 1e-30) (an IEEE divide), written in q's dtype (round
//   to nearest). Products in float32 on the CUDA cores: no TF32, no fast math.
// The exponential is exp2f with log2(e) folded into the scale, as in
// flash_sm90.cu: s is kept as (q . k) * c with c = fl(D^-0.5 * log2 e), m in
// the same units, p = exp2f(s - m). Against expf((q . k) * D^-0.5 - m) that
// moves p by a relative ~1e-6 at |s - m| ~ 20 (the roundings of c and of the
// product) plus exp2f's 2 ulp, under the float32 gate (relative L2 1e-5); it
// takes half the instructions of expf's range reduction. The -1e30 sentinel
// keeps its meaning in these units (exp2f(-1e30 - m) = 0 once m is finite,
// exp2f(0) = 1 while it is not).
//
// Layout. q, k and v are read through their strides (batch, head, sequence;
// the last dimension contiguous), so the model's (B, S, H, D) tensors go in
// without the host-side transpose and padding copies of the JAX wrapper; the
// ragged edges are masked here (rows >= Sq are not written, keys >= Skv are
// loaded as zeros and masked by kv_len <= Skv). The wrapper passes kv_len =
// Skv; it stays a parameter of its own.
//
// Skipped tiles. A KV tile whose keys are all masked for every row of the q
// tile is not loaded: those wholly above the causal diagonal, those at or
// past kv_len, and those wholly before the window of the tile's first row.
// Inside a block each warp owns 16 rows (8 at D 256) and skips, by the same
// rule on its own rows, a loaded tile wholly masked for them. For a row that
// already has a finite m, such a tile adds exp(-1e30 - m) = 0 and scales by
// alpha = 1, so skipping it changes nothing. A window row's first visited
// tiles can still be wholly masked for that row (its window starts later than
// its warp's first row's): there m stays -1e30, and the -1e30 sentinel makes
// p = exp(0) = 1, so l and acc gather a uniform sum, as in the Pallas kernel,
// which visits every tile from the first. The row's first tile with a valid
// key sets m to a real score and alpha = exp(-1e30 - m) = 0 wipes that sum,
// so whether the wholly masked tiles before it were visited or skipped, the
// result is the same. (A row with no valid key at all, possible only when a
// window ends before Skv begins, keeps the uniform sum of the tiles visited,
// which depends on the tiling here as it does on block_k and the padding in
// the JAX package.)
//
// Bound. Float32 products run on the CUDA cores at 67 TFLOP/s (TF32 would
// miss the float32 gate). For Qwen2.5-3B's float32 prefill (B 8, H 16,
// Hkv 2, S 2048, D 128, causal) the two products are 4 * D * B * H * pairs =
// 137.5 GFLOP over the causal pairs: 2.052 ms, against 302 MB of q, k, v and
// output (0.090 ms at 3.35 TB/s), so FFMA issue bounds it. The exponentials
// (one per causal pair, 2.7e8, at 16 a clock per SM) are 3% of that term.
//
// Design, for an FFMA-bound product: every issue slot not an FFMA is lost.
// - One block of 256 threads (8 warps) per 128-row q tile (64 at D 256),
//   q head and batch; one block per SM. Q stays in shared memory for the
//   block's life; K and V come in 64-key tiles.
// - Each warp owns 16 rows of the q tile (8 at D 256) and works on them
//   alone between the block barriers: S = Q K^T for its rows, the softmax,
//   P through a slice of shared memory that only it reads and writes (under
//   __syncwarp), and O += P V. Lane l holds rows rg + 2 i (rg = l / 16, i <
//   8; 4 at D 256) and, with the 16 lanes of its half-warp, splits the keys
//   (cg + 16 j, cg = l % 16) and the columns of O (float4 groups cg + 16 g).
// - S: each thread holds an 8 x 4 block of scores; per 4 columns of D it
//   loads 8 rows of Q and 4 keys of K as float4 (12 loads, 128 FFMAs). The
//   rows are padded by 4 floats, so the two rows a warp's Q load names fall
//   in different banks and its 16 keys spread over all 32 banks.
// - O: each thread holds an 8 x D/16 block (8 x 8 at D 128: 64 registers);
//   per key it loads its 8 rows of P^T (two float4, the same for 16 lanes)
//   and its columns of V (two float4) for 64 FFMAs.
// - m and the running sums: the row max by four shuffles over the half-warp;
//   l as each thread's partial sum over its own keys (every lane of a row
//   scales by the same alpha), summed over the half-warp at the end.
// - K and V through two buffers filled by cp.async (16-byte copies, zeros
//   past Skv; 4-byte copies where an address or a stride is not a multiple
//   of 16 bytes): K(t + 1) lands while P V(t) runs, V(t) while S(t) and the
//   softmax run. Two block barriers a tile: one before S (K(t) in, V free),
//   one before P V (V(t) in, K free). The bf16 entry loads through
//   registers (convert, store) at the same points, without the overlap.
// - The mask is applied only on tiles that cross the diagonal, the window's
//   edge or kv_len for some row of the warp, under one branch a tile.
// - Copies: each thread copies the same 16 bytes of every 8th row (64th at
//   D 256; 4 bytes at unaligned strides), a loop the compiler unrolls.
// - Causal grids run the heaviest q tiles first (the q tile is the slowest
//   index of a 1-D grid, counted from the last tile down); heads are the
//   fastest index, so the q heads that share a kv head share K and V in L2.
// Shared memory at D 128: Q 66 KB, K and V 33 KB each, P 40 KB (176 KB).
// What the first design lost: 4 warps a block and two blocks an SM left
// FFMA and load latency unhidden; K and V loaded element by element between
// two barriers, nothing of the next tile in flight; 8 shared loads per 64
// FFMAs in S and a scalar load of P per 4 FFMAs in P V; P written by every
// warp and read by every warp after a third barrier; expf's range reduction.
// Measured (tools/flash_sm90_variants.py --source flash.cu, H100 80GB HBM3,
// 700 W, one call): 3.52 ms at the shape above (58% of the bound; the first
// design 5.32); without P V 2.30, without S 1.99. Slower in the same call:
// the mask under a branch per score (3.68), two blocks of 4 warps an SM
// (3.70), an 8 x 8 S tile over half of D with the halves added across lane
// pairs (3.59), expf (3.56), unroll 4 (3.54, 3.56), no warp-level skipping
// (3.54). Neither hoisting S's shared loads out of its loop nor loading one
// K row for all lanes made S faster: shared memory does not bound it. ncu
// does not run on that machine, so its stalls are not broken down.
//
// Each entry launches on the stream it is given, allocates nothing and
// returns a cudaError_t as an int: cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 64;         // keys per KV tile
constexpr int kColGroups = 16;  // lanes of a half-warp: keys of S, columns of O
constexpr float kNegInf = -1e30f;  // the JAX package's NEG_INF

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  // strides in elements: batch, head, sequence (the last dimension is 1)
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int heads, batch, n_tiles;
  int sq, skv, kv_len, group, causal, window;
  int vec;           // 16-byte copies: every address and stride a multiple of 16 bytes
  float scale_log2;  // D^-0.5 * log2(e)
};

// the tile shapes and the shared-memory layout (in floats) of head dim D
template <int D>
struct Tile {
  static constexpr int kWarps = 8;   // warps a block
  static constexpr int kBlocks = 1;  // blocks an SM
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int RW = D == 256 ? 8 : 16;  // q rows per warp
  static constexpr int BQ = kWarps * RW;        // q rows per block
  static constexpr int RT = RW / 2;             // rows per thread
  static constexpr int KPT = kBK / kColGroups;  // keys per thread in S
  static constexpr int CPT = D / kColGroups;    // columns per thread in O
  static constexpr int VW = CPT < 4 ? CPT : 4;  // floats per vector of O's columns
  static constexpr int NG = CPT / VW;           // vectors per row
  // rows in shared memory, padded by 4 floats: a warp's Q load names two
  // rows, which then fall in different banks, and its K load 16 keys, which
  // spread over all 32
  static constexpr int LDQ = D + 4;
  static constexpr int LDK = D + 4;
  static constexpr int LDV = D + 4;
  static constexpr int LP = RW + 4;  // a key's row of a warp's P^T
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + BQ * LDQ;
  static constexpr int kV = kK + kBK * LDK;
  static constexpr int kP = kV + kBK * LDV;
  static constexpr int kFloats = kP + kWarps * kBK * LP;
  static constexpr int kBytes = kFloats * static_cast<int>(sizeof(float));
  static_assert(RT % 4 == 0 && CPT % VW == 0 && LDK % 4 == 0 && LP % 4 == 0, "tile shape");
  // kBlocks blocks, each with its 1 KB of reserved shared memory, in the SM's 228 KB
  static_assert(kBlocks * (kBytes + 1024) <= 233472, "shared memory");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 or 4 bytes; src_bytes 0 fills the destination with zeros
__device__ __forceinline__ void cp_async16(float* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// rows [row0, row0 + ROWS) of a (sequence, D) slice with row stride ss into
// dst[r * LD + d], rows >= limit as zeros: float through cp.async. A thread
// copies the same E-element column of every kThreads / (D / E)-th row, so
// the trip count and the column are known to the compiler.
template <int D, int LD, int ROWS, int E>
__device__ __forceinline__ void copy_rows(float* dst, const float* g, long long ss, int row0,
                                          int limit) {
  constexpr int kThreads = Tile<D>::kThreads, C = D / E, kStep = kThreads / C;
  static_assert(kThreads % C == 0 && ROWS % kStep == 0, "copy shape");
  const int r0 = threadIdx.x / C, col = threadIdx.x % C * E;
#pragma unroll
  for (int r = r0; r < ROWS; r += kStep) {
    const int row = row0 + r;
    const bool in = row < limit;
    const float* src = in ? g + row * ss + col : g;
    if constexpr (E == 4)
      cp_async16(dst + r * LD + col, src, in ? 16 : 0);
    else
      cp_async4(dst + r * LD + col, src, in ? 4 : 0);
  }
}

template <int D, int LD, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const float* g, long long ss, int row0,
                                          int limit, bool vec) {
  if (vec)
    copy_rows<D, LD, ROWS, 4>(dst, g, ss, row0, limit);
  else
    copy_rows<D, LD, ROWS, 1>(dst, g, ss, row0, limit);
}

// ... bf16 through registers, converted to float, at the same points
template <int D, int LD, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const __nv_bfloat16* g, long long ss,
                                          int row0, int limit, bool vec) {
  constexpr int kThreads = Tile<D>::kThreads;
  if (vec) {
    constexpr int C = D / 8;
    for (int c = threadIdx.x; c < ROWS * C; c += kThreads) {
      const int r = c / C, cc = c % C, row = row0 + r;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (row < limit) raw = *reinterpret_cast<const uint4*>(g + row * ss + cc * 8);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
      float* out = dst + r * LD + cc * 8;
      const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
      const float2 c2 = __bfloat1622float2(h[2]), d2 = __bfloat1622float2(h[3]);
      *reinterpret_cast<float4*>(out) = make_float4(a.x, a.y, b.x, b.y);
      *reinterpret_cast<float4*>(out + 4) = make_float4(c2.x, c2.y, d2.x, d2.y);
    }
  } else {
    for (int c = threadIdx.x; c < ROWS * D; c += kThreads) {
      const int r = c / D, d = c % D, row = row0 + r;
      dst[r * LD + d] = row < limit ? __bfloat162float(g[row * ss + d]) : 0.0f;
    }
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <int VW>
__device__ __forceinline__ void load_vec(float* r, const float* s) {
  if constexpr (VW == 4) {
    const float4 x = *reinterpret_cast<const float4*>(s);
    r[0] = x.x, r[1] = x.y, r[2] = x.z, r[3] = x.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(s);
    r[0] = x.x, r[1] = x.y;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(Tile<D>::kThreads, Tile<D>::kBlocks) flash_kernel(const Params p) {
  using L = Tile<D>;
  constexpr int RT = L::RT, KPT = L::KPT, CPT = L::CPT, VW = L::VW, NG = L::NG;
  constexpr int LDQ = L::LDQ, LDK = L::LDK, LDV = L::LDV, LP = L::LP;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  float* const qs = smem + L::kQ;  // [BQ][LDQ]
  float* const ks = smem + L::kK;  // [kBK][LDK]
  float* const vs = smem + L::kV;  // [kBK][LDV]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = lane / kColGroups;  // rows rg + 2 i of the warp's
  const int cg = lane % kColGroups;  // keys cg + 16 j of S, columns VW (cg + 16 g) + e of O
  float* const pt = smem + L::kP + warp * kBK * LP;  // P^T: [key][rg * RT + i]

  // block -> (q tile, head, batch); causal grids run the last (heaviest) tile first
  const int heads_batch = p.heads * p.batch;
  int tile = blockIdx.x / heads_batch;
  const int hb = blockIdx.x - tile * heads_batch;
  const int h = hb % p.heads;
  const int b = hb / p.heads;
  if (p.causal) tile = p.n_tiles - 1 - tile;
  const int q0 = tile * L::BQ;
  const int hk = h / p.group;
  const int wr0 = q0 + warp * L::RW;  // this warp's rows wr0 ... wr1
  const int wr1 = wr0 + L::RW - 1;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  // the KV tiles with a valid key for some row of this q tile (see above)
  int k_end = p.kv_len;
  if (p.causal) k_end = min(k_end, q0 + L::BQ);
  int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  k_begin -= k_begin % kBK;
  const int n_kv = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  const bool vec = p.vec != 0;
  load_tile<D, LDQ, L::BQ>(qs, qg, p.q_ss, q0, p.sq, vec);
  if (n_kv > 0) load_tile<D, LDK, kBK>(ks, kg, p.k_ss, k_begin, p.skv, vec);
  cp_async_commit();

  float o[RT][CPT], m[RT], l[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) o[i][c] = 0.0f;
  }
  const float* const qrow = qs + (warp * L::RW + rg) * LDQ;  // row rg + 2 i at + 2 i LDQ
  const float* const krow = ks + cg * LDK;                    // key cg + 16 j at + 16 j LDK
  const float* const vcol = vs + VW * cg;                   // columns VW cg + 16 VW g
  float* const prow = pt + rg * RT;

  for (int it = 0; it < n_kv; ++it) {
    const int k0 = k_begin + it * kBK;
    cp_async_wait_all();
    __syncthreads();  // K(it) (and Q) have landed; every warp is done with V(it - 1)
    load_tile<D, LDV, kBK>(vs, vg, p.v_ss, k0, p.skv, vec);
    cp_async_commit();

    // this warp's rows see a valid key in this tile (the rule above, per warp)
    const bool live = wr0 < p.sq && !(p.causal && k0 > wr1) &&
                      !(p.window > 0 && k0 + kBK - 1 <= wr0 - p.window);
    if (live) {
      // S = Q K^T: 8 (4) rows x 4 keys a thread, float4 steps along D
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

      // scale (log2 units), mask where some row of this warp needs it
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) s[i][j] *= p.scale_log2;
      if (k0 + kBK > p.kv_len || (p.causal && k0 + kBK - 1 > wr0) ||
          (p.window > 0 && k0 <= wr1 - p.window)) {
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const int qpos = wr0 + rg + 2 * i;
#pragma unroll
          for (int j = 0; j < KPT; ++j) {
            const int kpos = k0 + cg + kColGroups * j;
            const bool ok = kpos < p.kv_len && (!p.causal || kpos <= qpos) &&
                            (p.window <= 0 || kpos > qpos - p.window);
            if (!ok) s[i][j] = kNegInf;
          }
        }
      }

      // online softmax; P^T into this warp's slice
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        float mx = s[i][0];
#pragma unroll
        for (int j = 1; j < KPT; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
        for (int x = 1; x < kColGroups; x *= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
        const float m_new = fmaxf(m[i], mx);
        const float alpha = exp2f(m[i] - m_new);
        m[i] = m_new;
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          s[i][j] = exp2f(s[i][j] - m_new);
          sum += s[i][j];
        }
        l[i] = alpha * l[i] + sum;
#pragma unroll
        for (int c = 0; c < CPT; ++c) o[i][c] *= alpha;
      }
#pragma unroll
      for (int j = 0; j < KPT; ++j)
#pragma unroll
        for (int i = 0; i < RT; i += 4)
          *reinterpret_cast<float4*>(prow + (cg + kColGroups * j) * LP + i) =
              make_float4(s[i][j], s[i + 1][j], s[i + 2][j], s[i + 3][j]);
      __syncwarp();
    }

    cp_async_wait_all();
    __syncthreads();  // V(it) has landed; every warp is done with K(it)
    if (it + 1 < n_kv) {
      load_tile<D, LDK, kBK>(ks, kg, p.k_ss, k0 + kBK, p.skv, vec);
      cp_async_commit();
    }

    if (live) {
      // O += P V: per key, 8 (4) rows of P^T and CPT columns of V
#pragma unroll 8
      for (int j = 0; j < kBK; ++j) {
        float pr[RT], vv[CPT];
#pragma unroll
        for (int i = 0; i < RT; i += 4) load_vec<4>(pr + i, prow + j * LP + i);
#pragma unroll
        for (int g = 0; g < NG; ++g) load_vec<VW>(vv + g * VW, vcol + j * LDV + g * VW * kColGroups);
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int c = 0; c < CPT; ++c) o[i][c] = fmaf(pr[i], vv[c], o[i][c]);
      }
    }
  }

  cp_async_wait_all();  // a block with no KV tile still has Q in flight

  // out = acc / max(l, 1e-30), rows < Sq
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    float sum = l[i];
#pragma unroll
    for (int x = 1; x < kColGroups; x *= 2) sum += __shfl_xor_sync(0xffffffffu, sum, x);
    const int row = wr0 + rg + 2 * i;
    if (row >= p.sq) continue;
    const float den = fmaxf(sum, 1e-30f);
    T* out = og + row * p.o_ss + VW * cg;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < VW; ++e) store(out + g * VW * kColGroups + e, o[i][g * VW + e] / den);
  }
}

template <typename T, int D>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int bytes = Tile<D>::kBytes;
  cudaError_t err =
      cudaFuncSetAttribute(flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long grid = static_cast<long long>(p.n_tiles) * p.heads * p.batch;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_kernel<T, D><<<static_cast<unsigned>(grid), Tile<D>::kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(Params& p, int D, cudaStream_t stream) {
  switch (D) {
    case 32: p.n_tiles = (p.sq + Tile<32>::BQ - 1) / Tile<32>::BQ; return launch<T, 32>(p, stream);
    case 64: p.n_tiles = (p.sq + Tile<64>::BQ - 1) / Tile<64>::BQ; return launch<T, 64>(p, stream);
    case 128:
      p.n_tiles = (p.sq + Tile<128>::BQ - 1) / Tile<128>::BQ;
      return launch<T, 128>(p, stream);
    case 256:
      p.n_tiles = (p.sq + Tile<256>::BQ - 1) / Tile<256>::BQ;
      return launch<T, 256>(p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

extern "C" {

// q (B, H, Sq, D), k and v (B, Hkv, Skv, D), o (B, H, Sq, D), each given by
// its data pointer and strides[3 * i .. 3 * i + 2] = (batch, head, sequence)
// in elements, i = 0 (q), 1 (k), 2 (v), 3 (o); the last dimension has
// stride 1. dtype 0 is float32, 1 bfloat16 (all four tensors the same).
// The wrapper (kernel.py) checks shapes, types, D and the grid's size.
int flash_attention_forward(const void* q, const void* k, const void* v, void* o,
                            const long long* strides, int dtype, int B, int H, int Hkv,
                            int Sq, int Skv, int D, int kv_len, int causal, int window,
                            float scale, void* stream) {
  if (Sq == 0) return 0;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.q_sb = strides[0];
  p.q_sh = strides[1];
  p.q_ss = strides[2];
  p.k_sb = strides[3];
  p.k_sh = strides[4];
  p.k_ss = strides[5];
  p.v_sb = strides[6];
  p.v_sh = strides[7];
  p.v_ss = strides[8];
  p.o_sb = strides[9];
  p.o_sh = strides[10];
  p.o_ss = strides[11];
  p.heads = H;
  p.batch = B;
  p.sq = Sq;
  p.skv = Skv;
  p.kv_len = kv_len;
  p.group = H / Hkv;
  p.causal = causal;
  p.window = window;
  p.scale_log2 = static_cast<float>(static_cast<double>(scale) * 1.4426950408889634);
  const long long unit = dtype == 0 ? 4 : 8;  // elements in 16 bytes
  bool vec = aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o);
  for (int i = 0; i < 12; ++i) vec = vec && strides[i] % unit == 0;
  p.vec = vec ? 1 : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(p, D, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
