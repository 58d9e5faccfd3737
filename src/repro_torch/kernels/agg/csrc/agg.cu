// Aggregation fold kernels for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces two Pallas TPU kernels of src/repro/kernels/agg/kernel.py:
//
//   * fold_scaled (kernel.py:96, body _fold_kernel at :41-52), together with
//     the separate scale pass before it (ops.py::_scale_rows, :107-112) and the
//     per-update scale/add pair StreamingMean.fold runs
//     (fl/strategies.py::_scale_delta/_add_scaled, :205-215). Three exact
//     entries:
//       agg_exact_fold       stacked:  out[n] = fdiv(fold_c fmul(d[c,n], w[c]), den)
//       agg_exact_fold_tree  streaming, in place, over every leaf of an update
//                            tree: acc_i = fmul(d_i, w) on the first update,
//                            then acc_i = fadd(acc_i, fmul(d_i, w))
//       agg_exact_divide     x = fdiv(x, den), in place or out of place
//   * weighted_aggregate (kernel.py:74, body _agg_kernel at :34-38):
//       agg_weighted_sum     out[n] = (sum_c w[c] * d[c,n]) / den, FMAs allowed
//
// Exactness. Every operation of the exact entries is an intrinsic
// (__fmul_rn, __fadd_rn, __fdiv_rn) that nvcc never contracts into an FMA, so
// they reproduce the JAX package's sequential IEEE fold bit for bit: a multiply
// per client, adds in client order with the accumulator seeded from client 0
// (so an all -0.0 column stays -0.0), one divide. Build without
// --use_fast_math.
//
// Bound. Each entry reads every input element once and writes every output
// element once, doing one or two flops per element read, so on an H100
// (3.35 TB/s, 67 TFLOP/s f32 outside the tensor cores) the bytes bound it:
//   stacked, f32 rows:   (4*C + 4) * N bytes   (bf16 rows: (2*C + 4) * N)
//   streaming fold:      12 * N bytes          (read acc, read d, write acc)
//   divide:              8 * N bytes
// Design of the stacked entries and the divide against that bound: one pass
// over memory, 16-byte vector loads and stores on neighbouring addresses, a
// grid-stride loop over a grid sized to the SMs, no shared memory and nothing
// carried between blocks. Rows whose stride or base is not 16-byte aligned
// take the scalar loop.
//
// The streaming fold runs once per client update, over a tree whose leaves
// range from 256 floats to a 311M-float embedding. Its design:
//   * one launch per tree (per kTreeLeaves leaves): the leaf table (pointers,
//     lengths, alignment, chunk prefix) is a __grid_constant__ kernel
//     parameter, built on the host per call and copied by the launch itself,
//     so no buffer outlives the call or is shared between threads folding
//     onto one stream;
//   * every leaf is cut into chunks of kChunkPacks 16-byte packs; a grid of
//     kFoldBlocksPerSm blocks per SM walks all chunks of all leaves with a
//     grid stride, finding each chunk's leaf by walking the prefix forward,
//     so small leaves and the embedding's tail share one launch;
//   * each thread loads kFoldUnroll float4 of d and of acc before using any,
//     with evict-first hints (__ldcs/__stcs): every byte is touched once,
//     gigabytes against a 50 MB L2;
//   * the first update is a template parameter (no acc read, no branch);
//   * a leaf whose acc or d is not 16-byte aligned, and the last n % 4
//     elements of one that is, take a scalar loop in the same launch.
//
// Every entry launches on the stream it is given, allocates nothing and
// returns cudaGetLastError() as an int.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // 132 SMs on an H100 SXM

__device__ __forceinline__ float widen(float x) { return x; }

// bf16 is the top half of an f32: widening is a shift, exact
__device__ __forceinline__ float widen(uint16_t bits) {
  return __uint_as_float(static_cast<uint32_t>(bits) << 16);
}

// 16 bytes of T, moved as one vector access
template <typename T>
union Pack16 {
  uint4 raw;
  T v[16 / sizeof(T)];
};

int blocks_for(long long work) {
  long long b = (work + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return static_cast<int>(b);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Stacked fold over C rows of N elements. ``packs`` is the number of 16-byte
// packs per row taken by the vector loop (0 when rows are not aligned); the
// scalar loop takes the elements after them.
template <typename T, bool kExact>
__global__ void stacked_kernel(const T* __restrict__ d, const float* __restrict__ w,
                               const float* __restrict__ den_ptr, float* __restrict__ out,
                               int C, long long N, long long packs) {
  constexpr int P = 16 / sizeof(T);
  const float den = *den_ptr;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long i = tid; i < packs; i += stride) {
    float acc[P];
    Pack16<T> x;
    x.raw = reinterpret_cast<const uint4*>(d)[i];
    const float w0 = w[0];
#pragma unroll
    for (int k = 0; k < P; ++k) acc[k] = __fmul_rn(widen(x.v[k]), w0);
    for (int c = 1; c < C; ++c) {
      x.raw = reinterpret_cast<const uint4*>(d + c * N)[i];
      const float wc = w[c];
#pragma unroll
      for (int k = 0; k < P; ++k) {
        acc[k] = kExact ? __fadd_rn(acc[k], __fmul_rn(widen(x.v[k]), wc))
                        : fmaf(widen(x.v[k]), wc, acc[k]);
      }
    }
    float4* o = reinterpret_cast<float4*>(out + i * P);
#pragma unroll
    for (int k = 0; k < P; k += 4) {
      o[k / 4] = make_float4(__fdiv_rn(acc[k], den), __fdiv_rn(acc[k + 1], den),
                             __fdiv_rn(acc[k + 2], den), __fdiv_rn(acc[k + 3], den));
    }
  }
  for (long long n = packs * P + tid; n < N; n += stride) {
    float acc = __fmul_rn(widen(d[n]), w[0]);
    for (int c = 1; c < C; ++c) {
      const float x = widen(d[c * N + n]);
      acc = kExact ? __fadd_rn(acc, __fmul_rn(x, w[c])) : fmaf(x, w[c], acc);
    }
    out[n] = __fdiv_rn(acc, den);
  }
}

// x and out may be the same buffer (in place), so no __restrict__ here
__global__ void divide_kernel(const float* x, float* out, float den, long long N,
                              long long packs) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* o4 = reinterpret_cast<float4*>(out);
  for (long long i = tid; i < packs; i += stride) {
    const float4 v = x4[i];
    o4[i] = make_float4(__fdiv_rn(v.x, den), __fdiv_rn(v.y, den), __fdiv_rn(v.z, den),
                        __fdiv_rn(v.w, den));
  }
  for (long long n = packs * 4 + tid; n < N; n += stride) out[n] = __fdiv_rn(x[n], den);
}

template <typename T, bool kExact>
void launch_stacked(const void* d, const float* w, const float* den, float* out, int C,
                    long long N, cudaStream_t s) {
  constexpr int P = 16 / sizeof(T);
  const T* dp = static_cast<const T*>(d);
  // every row starts 16-byte aligned only when N is a whole number of packs
  const long long packs = (N % P == 0 && aligned16(dp) && aligned16(out)) ? N / P : 0;
  stacked_kernel<T, kExact><<<blocks_for(packs ? packs : N), kThreads, 0, s>>>(
      dp, w, den, out, C, N, packs);
}

template <bool kExact>
int stacked(const void* d, int bf16, const float* w, const float* den, float* out, int C,
            long long N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    launch_stacked<uint16_t, kExact>(d, w, den, out, C, N, s);
  } else {
    launch_stacked<float, kExact>(d, w, den, out, C, N, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------- //
// the streaming fold over an update tree
// ---------------------------------------------------------------------- //
constexpr int kTreeLeaves = 120;      // leaves per launch: the table stays under 4 KB
constexpr int kChunkPacks = 2048;     // 16-byte packs per chunk (32 KB of each stream)
constexpr int kFoldThreads = 256;
constexpr int kFoldUnroll = 4;        // packs of each stream in flight per thread
constexpr int kFoldBlocksPerSm = 4;

struct FoldLeaf {
  float* acc;
  const float* d;
  long long n;  // elements, > 0
  int chunk0;   // the leaf's first chunk; its last is the next leaf's chunk0 - 1
  int aligned;  // acc and d both 16-byte aligned: the leaf's whole packs go as float4
};

struct FoldTable {
  int leaves;
  int chunks;  // of all leaves
  float w;
  int pad;
  FoldLeaf leaf[kTreeLeaves];
};
static_assert(sizeof(FoldLeaf) == 32, "the Python table mirrors this layout");
static_assert(sizeof(FoldTable) <= 4096, "the table is a kernel parameter of at most 4 KB");

template <bool kFirst>
__device__ __forceinline__ float4 fold4(const float4& a, const float4& x, float w) {
  const float4 s = make_float4(__fmul_rn(x.x, w), __fmul_rn(x.y, w), __fmul_rn(x.z, w),
                               __fmul_rn(x.w, w));
  if (kFirst) return s;
  return make_float4(__fadd_rn(a.x, s.x), __fadd_rn(a.y, s.y), __fadd_rn(a.z, s.z),
                     __fadd_rn(a.w, s.w));
}

template <bool kFirst>
__global__ void __launch_bounds__(kFoldThreads)
fold_tree_kernel(const __grid_constant__ FoldTable t) {
  constexpr long long kChunk = 4LL * kChunkPacks;  // elements
  constexpr int kStep = kFoldThreads * kFoldUnroll;
  const float w = t.w;
  int i = 0;  // this block's leaf; its chunks only grow
  for (int c = blockIdx.x; c < t.chunks; c += gridDim.x) {
    while (i + 1 < t.leaves && c >= t.leaf[i + 1].chunk0) ++i;
    float* acc = t.leaf[i].acc;
    const float* d = t.leaf[i].d;
    const long long e0 = (c - t.leaf[i].chunk0) * kChunk;
    const long long e1 = min(e0 + kChunk, t.leaf[i].n);
    long long scalar0 = e0;
    if (t.leaf[i].aligned) {
      const long long p1 = e1 / 4;  // packs wholly inside [e0, e1)
      float4* acc4 = reinterpret_cast<float4*>(acc);
      const float4* d4 = reinterpret_cast<const float4*>(d);
      for (long long p = e0 / 4 + threadIdx.x; p < p1; p += kStep) {
        float4 x[kFoldUnroll], a[kFoldUnroll];
#pragma unroll
        for (int k = 0; k < kFoldUnroll; ++k) {
          const long long q = p + k * kFoldThreads;
          if (q < p1) {
            x[k] = __ldcs(d4 + q);
            if (!kFirst) a[k] = __ldcs(acc4 + q);
          }
        }
#pragma unroll
        for (int k = 0; k < kFoldUnroll; ++k) {
          const long long q = p + k * kFoldThreads;
          if (q < p1) __stcs(acc4 + q, fold4<kFirst>(a[k], x[k], w));
        }
      }
      scalar0 = p1 * 4;
    }
    for (long long e = scalar0 + threadIdx.x; e < e1; e += kFoldThreads) {
      const float s = __fmul_rn(__ldcs(d + e), w);
      __stcs(acc + e, kFirst ? s : __fadd_rn(__ldcs(acc + e), s));
    }
  }
}

int fold_tree(const FoldTable* table, int first, cudaStream_t s) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int blocks = table->chunks < kFoldBlocksPerSm * sms ? table->chunks
                                                            : kFoldBlocksPerSm * sms;
  if (first) {
    fold_tree_kernel<true><<<blocks, kFoldThreads, 0, s>>>(*table);
  } else {
    fold_tree_kernel<false><<<blocks, kFoldThreads, 0, s>>>(*table);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int agg_exact_fold(const void* d, int bf16, const float* w, const float* den, float* out,
                   int C, long long N, void* stream) {
  return stacked<true>(d, bf16, w, den, out, C, N, stream);
}

int agg_weighted_sum(const void* d, int bf16, const float* w, const float* den, float* out,
                     int C, long long N, void* stream) {
  return stacked<false>(d, bf16, w, den, out, C, N, stream);
}

// one launch folds the table's leaves (chunks > 0): the launch copies the
// table, so the caller may free or reuse it as soon as this returns
int agg_exact_fold_tree(const void* table, int first, void* stream) {
  return fold_tree(static_cast<const FoldTable*>(table), first,
                   static_cast<cudaStream_t>(stream));
}

// leaves per table, packs per chunk and the table's bytes, for the wrapper's
// mirror of FoldTable
int agg_fold_tree_layout(int* out) {
  out[0] = kTreeLeaves;
  out[1] = kChunkPacks;
  out[2] = static_cast<int>(sizeof(FoldTable));
  return 0;
}

int agg_exact_divide(const float* x, float* out, float den, long long N, void* stream) {
  const long long packs = (aligned16(x) && aligned16(out)) ? N / 4 : 0;
  const long long work = packs ? packs + N % 4 : N;
  divide_kernel<<<blocks_for(work), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, den, N, packs);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
