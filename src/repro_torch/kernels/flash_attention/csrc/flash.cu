// Forward flash attention for Hopper (sm_90a), bound to Python with ctypes.
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
//   out = acc / max(l, 1e-30), written in q's dtype (round to nearest).
// Every serving prefill runs it once per layer; decode steps do not.
//
// Layout. q, k and v are read through their strides (batch, head, sequence;
// the last dimension contiguous), so the model's (B, S, H, D) tensors go in
// without the host-side transpose and padding copies of the JAX wrapper; the
// ragged edges are masked here (rows >= Sq are not written, keys >= Skv are
// loaded as zeros and masked by kv_len <= Skv). The wrapper passes kv_len =
// Skv. Masking with Skv itself computes the same, but ptxas then schedules
// the loop otherwise and the serving shape's launch was much slower (same
// outputs, no spills; PERF.md has the times), so kv_len stays a parameter
// of its own.
//
// Skipped tiles. A KV tile whose keys are all masked for every row of the q
// tile is not visited: those wholly above the causal diagonal, those at or
// past kv_len, and those wholly before the window of the tile's first row.
// For a row that already has a finite m, such a tile adds exp(-1e30 - m) = 0
// and scales by alpha = 1, so skipping it changes nothing. A window row's
// first visited tiles can still be wholly masked for that row (its window
// starts later than the tile's first row's): there m stays -1e30, and the
// -1e30 sentinel makes p = exp(0) = 1, so l and acc gather a uniform sum, as
// in the Pallas kernel, which visits every tile from the first. The row's
// first tile with a valid key sets m to a real score and alpha =
// exp(-1e30 - m) = 0 wipes that sum, so whether the wholly masked tiles
// before it were visited or skipped, the result is the same. (A row with no
// valid key at all, possible only when a window ends before Skv begins,
// keeps the uniform sum of the tiles visited, which depends on the tiling
// here as it does on block_k and the padding in the JAX package.)
//
// Bound. For the serving prefill (B 8, H 16, Hkv 2, S 2048, D 128, bf16,
// causal) the two products are 2 * B * H * S^2 * D = 137.4 GFLOP of causal
// work against 151 MB of q, k, v and output (0.045 ms at 3.35 TB/s), so
// operations bound it: 0.139 ms at 989 TFLOP/s of dense bf16 on the tensor
// cores. This first kernel does not reach for that bound: it runs on the
// float32 CUDA cores (67 TFLOP/s peak) with K, V, Q and P staged in shared
// memory as float32.
// Design. One thread block of 128 threads per (q tile, head, batch). The
// score tile S = Q K^T is split 16 x 8 over the threads: each thread holds
// RQ query rows x KPT keys (keys cg, cg + 8, ...), reading Q and K from
// shared memory as float4 with a row padding of 4 floats, so the 8 lanes of
// a quarter warp touch 8 distinct 16-byte slots. The 8 threads that share
// rows reduce the row max and the row sum with warp shuffles and each keeps
// the rows' m and l in registers; P goes through shared memory to the
// product P V, where each thread owns the same RQ rows x D/8 columns of acc
// (float4 column groups cg, cg + 8, ...) in registers. Tiles per D keep two
// blocks resident per SM (77 KB at D 128, 104 KB at D 256, above the 48 KB
// default, so the entry opts in to dynamic shared memory).
//
// Each entry launches on the stream it is given, allocates nothing and
// returns a cudaError_t as an int: cudaGetLastError() after the launch.
// expf (not __expf) and IEEE division: the build allows no fast math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
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
  int sq, skv, kv_len, group, causal, window;
  float scale;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <int BQ, int BK, int D>
constexpr int smem_floats() {
  return BQ * (D + 4) + 2 * BK * (D + 4) + BQ * (BK + 4);
}

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) flash_kernel(Params p) {
  constexpr int RQ = BQ / 16;  // query rows per thread
  constexpr int KPT = BK / 8;  // keys per thread in the score tile
  constexpr int C4 = D / 32;   // float4 column groups per thread in acc
  constexpr int LD = D + 4;    // padded row of the q, k and v tiles
  constexpr int LP = BK + 4;   // padded row of the p tile
  static_assert(BQ % 16 == 0 && BK % 8 == 0 && D % 32 == 0, "tile shape");

  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [BQ][LD]
  float* ks = qs + BQ * LD;                      // [BK][LD]
  float* vs = ks + BK * LD;                      // [BK][LD]
  float* ps = vs + BK * LD;                      // [BQ][LP]

  const int tid = threadIdx.x;
  const int rg = tid >> 3;  // rows rg * RQ ... rg * RQ + RQ - 1
  const int cg = tid & 7;   // key group (scores), column group (acc)
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.group;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, d = i % D, s = q0 + r;
    qs[r * LD + d] = s < p.sq ? to_float(qg[s * p.q_ss + d]) : 0.0f;
  }

  float m[RQ], l[RQ], acc[RQ][C4 * 4];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < C4 * 4; ++c) acc[i][c] = 0.0f;
  }

  // the KV tiles with a valid key for some row of this q tile (see above)
  int k_end = p.kv_len;
  if (p.causal) k_end = min(k_end, q0 + BQ);
  int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  k_begin -= k_begin % BK;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's reads of ks, vs, ps are done
    for (int i = tid; i < BK * D; i += kThreads) {
      const int r = i / D, d = i % D, key = k0 + r;
      const bool in = key < p.skv;
      ks[r * LD + d] = in ? to_float(kg[key * p.k_ss + d]) : 0.0f;
      vs[r * LD + d] = in ? to_float(vg[key * p.v_ss + d]) : 0.0f;
    }
    __syncthreads();

    float s[RQ][KPT];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&qs[(rg * RQ + i) * LD + d]);
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(&ks[(cg + 8 * j) * LD + d]);
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qpos = q0 + rg * RQ + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int kpos = k0 + cg + 8 * j;
        const bool ok = kpos < p.kv_len && (!p.causal || kpos <= qpos) &&
                        (p.window <= 0 || kpos > qpos - p.window);
        s[i][j] = ok ? s[i][j] * p.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 8 threads of a row group are 8 neighbouring lanes
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float pj = expf(s[i][j] - m_new);
        sum += pj;
        ps[(rg * RQ + i) * LP + cg + 8 * j] = pj;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < C4 * 4; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pr[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pr[i] = ps[(rg * RQ + i) * LP + kk];
#pragma unroll
      for (int c = 0; c < C4; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(&vs[kk * LD + (cg + 8 * c) * 4]);
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          acc[i][c * 4 + 0] = fmaf(pr[i], vv.x, acc[i][c * 4 + 0]);
          acc[i][c * 4 + 1] = fmaf(pr[i], vv.y, acc[i][c * 4 + 1]);
          acc[i][c * 4 + 2] = fmaf(pr[i], vv.z, acc[i][c * 4 + 2]);
          acc[i][c * 4 + 3] = fmaf(pr[i], vv.w, acc[i][c * 4 + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + rg * RQ + i;
    if (row >= p.sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* out = og + row * p.o_ss;
#pragma unroll
    for (int c = 0; c < C4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) store(&out[(cg + 8 * c) * 4 + e], acc[i][c * 4 + e] / den);
  }
}

template <typename T, int D, int BQ, int BK>
int launch(const Params& p, int B, int H, cudaStream_t stream) {
  constexpr int bytes = smem_floats<BQ, BK, D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, D, BQ, BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.sq + BQ - 1) / BQ, H, B);
  flash_kernel<T, D, BQ, BK><<<grid, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Params& p, int B, int H, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32, 64, 64>(p, B, H, stream);
    case 64: return launch<T, 64, 64, 64>(p, B, H, stream);
    case 128: return launch<T, 128, 64, 32>(p, B, H, stream);
    case 256: return launch<T, 256, 32, 32>(p, B, H, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q (B, H, Sq, D), k and v (B, Hkv, Skv, D), o (B, H, Sq, D), each given by
// its data pointer and strides[3 * i .. 3 * i + 2] = (batch, head, sequence)
// in elements, i = 0 (q), 1 (k), 2 (v), 3 (o); the last dimension has
// stride 1. dtype 0 is float32, 1 bfloat16 (all four tensors the same).
// The wrapper (kernel.py) checks shapes, types, D and the grid limits.
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
  p.sq = Sq;
  p.skv = Skv;
  p.kv_len = kv_len;
  p.group = H / Hkv;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(p, B, H, D, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, B, H, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
