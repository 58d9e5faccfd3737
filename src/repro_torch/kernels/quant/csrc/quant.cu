// Blockwise int8 quantize / dequantize kernels for Hopper (sm_90a), bound to
// Python with ctypes.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/quant/kernel.py:
//
//   quant_quantize_blocks    quantize_blocks (kernel.py:31, body _quant_kernel
//                            at :18-24): per 4096-element block, absmax,
//                            scale = max(absmax, 1e-30) * float32(1/127),
//                            q = clip(round_half_even(x / scale), -127, 127)
//   quant_dequantize_blocks  dequantize_blocks (kernel.py:50, body
//                            _dequant_kernel at :27-28): x = float(q) * scale
//
// They carry the int8_blocks wire codec: every coded send quantizes the
// flattened float leaves on the sender's card, and every receive dequantizes
// on the receiver's, so one byte per parameter crosses PCIe and the socket
// instead of four.
//
// Exactness. Both must give the bits of the plain versions (ref.py) and of the
// JAX package's CPU path (its jitted reference_quantize). XLA compiles that
// path's constant divide "/ 127.0" into a multiply by float32(1/127)
// (0x3c010204), and the Pallas kernel does the same, so the scale here is
// that __fmul_rn; x / scale is an IEEE divide there and __fdiv_rn here (never
// a reciprocal multiply); dequantize is one __fmul_rn; rounding is rintf
// (half to even, as jnp.round; roundf rounds half away from zero). Build
// without --use_fast_math. The absmax propagates NaN like jnp.max, so a
// block holding a NaN gets a NaN scale; fmaxf would drop it.
//
// Bound. Per element the quantizer reads 4 bytes and writes 1, plus 4 bytes of
// scale per block; the dequantizer reads 1 and writes 4. A few operations per
// element against 5 bytes, so on an H100 (3.35 TB/s) the bytes bound both:
// (5 * 4096 + 4) * NB bytes per call.
// Design against that bound: one thread block of 256 threads per 4096-element
// block, 16 elements per thread. The quantizer keeps its 16 values in
// registers across the block reduction (warp shuffles, then 8 partials in
// shared memory), so device memory sees each element once; loads are float4
// and stores char4 on neighbouring addresses. The dequantizer reads char4 and
// writes float4. Nothing is carried between blocks.
//
// Each entry launches on the stream it is given, allocates nothing and
// returns cudaGetLastError() as an int. x and the outputs must be 16-byte
// aligned (the wrapper checks).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 4096;         // elements per quantization block
constexpr int kThreads = 256;
constexpr int kVecs = kBlock / 4 / kThreads;  // float4 per thread: 4
constexpr int kWarps = kThreads / 32;
constexpr float kInv127 = 0x1.020408p-7f;    // float32(1/127), 0x3c010204

// max(|a|, m) that keeps a NaN from either side, as jnp.max does
__device__ __forceinline__ float nan_max(float a, float m) {
  return (a != a || a > m) ? a : m;
}

__device__ __forceinline__ signed char quantize_one(float x, float scale) {
  float r = rintf(__fdiv_rn(x, scale));
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return static_cast<signed char>(static_cast<int>(r));
}

__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float4* __restrict__ x, char4* __restrict__ q,
                float* __restrict__ scale) {
  __shared__ float partial[kWarps];
  const long long base = static_cast<long long>(blockIdx.x) * (kBlock / 4);
  float4 v[kVecs];
  float m = 0.0f;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    v[i] = x[base + threadIdx.x + i * kThreads];
    m = nan_max(fabsf(v[i].x), m);
    m = nan_max(fabsf(v[i].y), m);
    m = nan_max(fabsf(v[i].z), m);
    m = nan_max(fabsf(v[i].w), m);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = nan_max(__shfl_xor_sync(0xffffffffu, m, off), m);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = m;
  __syncthreads();
  float absmax = partial[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) absmax = nan_max(partial[w], absmax);
  // max(absmax, 1e-30) that keeps a NaN, times float32(1/127)
  const float s = __fmul_rn(absmax != absmax ? absmax : fmaxf(absmax, 1e-30f), kInv127);
  if (threadIdx.x == 0) scale[blockIdx.x] = s;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    q[base + threadIdx.x + i * kThreads] =
        make_char4(quantize_one(v[i].x, s), quantize_one(v[i].y, s),
                   quantize_one(v[i].z, s), quantize_one(v[i].w, s));
  }
}

__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const char4* __restrict__ q, const float* __restrict__ scale,
                  float4* __restrict__ x) {
  const long long base = static_cast<long long>(blockIdx.x) * (kBlock / 4);
  const float s = scale[blockIdx.x];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const char4 c = q[base + threadIdx.x + i * kThreads];
    x[base + threadIdx.x + i * kThreads] =
        make_float4(__fmul_rn(static_cast<float>(c.x), s), __fmul_rn(static_cast<float>(c.y), s),
                    __fmul_rn(static_cast<float>(c.z), s), __fmul_rn(static_cast<float>(c.w), s));
  }
}

}  // namespace

extern "C" {

int quant_quantize_blocks(const float* x, signed char* q, float* scale, long long nb,
                          void* stream) {
  quantize_kernel<<<static_cast<unsigned int>(nb), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<char4*>(q), scale);
  return static_cast<int>(cudaGetLastError());
}

int quant_dequantize_blocks(const signed char* q, const float* scale, float* x, long long nb,
                            void* stream) {
  dequantize_kernel<<<static_cast<unsigned int>(nb), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const char4*>(q), scale, reinterpret_cast<float4*>(x));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
