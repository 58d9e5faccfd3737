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
//       agg_exact_fold_into  streaming, in place: acc = fmul(d, w) on the first
//                            update, then acc = fadd(acc, fmul(d, w))
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
// Design against that bound: one pass over memory, 16-byte vector loads and
// stores on neighbouring addresses, a grid-stride loop over a grid sized to the
// SMs, no shared memory and nothing carried between blocks. Rows whose stride
// or base is not 16-byte aligned take the scalar loop. One launch per leaf;
// batching leaves into one launch and cp.async/TMA pipelines are later work.
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

__global__ void fold_into_kernel(float* __restrict__ acc, const float* __restrict__ d,
                                 float w, int first, long long N, long long packs) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float4* acc4 = reinterpret_cast<float4*>(acc);
  const float4* d4 = reinterpret_cast<const float4*>(d);
  for (long long i = tid; i < packs; i += stride) {
    const float4 x = d4[i];
    float4 r = make_float4(__fmul_rn(x.x, w), __fmul_rn(x.y, w), __fmul_rn(x.z, w),
                           __fmul_rn(x.w, w));
    if (!first) {
      const float4 a = acc4[i];
      r = make_float4(__fadd_rn(a.x, r.x), __fadd_rn(a.y, r.y), __fadd_rn(a.z, r.z),
                      __fadd_rn(a.w, r.w));
    }
    acc4[i] = r;
  }
  for (long long n = packs * 4 + tid; n < N; n += stride) {
    const float s = __fmul_rn(d[n], w);
    acc[n] = first ? s : __fadd_rn(acc[n], s);
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

int agg_exact_fold_into(float* acc, const float* d, float w, int first, long long N,
                        void* stream) {
  const long long packs = (aligned16(acc) && aligned16(d)) ? N / 4 : 0;
  const long long work = packs ? packs + N % 4 : N;
  fold_into_kernel<<<blocks_for(work), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      acc, d, w, first, N, packs);
  return static_cast<int>(cudaGetLastError());
}

int agg_exact_divide(const float* x, float* out, float den, long long N, void* stream) {
  const long long packs = (aligned16(x) && aligned16(out)) ? N / 4 : 0;
  const long long work = packs ? packs + N % 4 : N;
  divide_kernel<<<blocks_for(work), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, den, N, packs);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
