// Per-row int8 activation quantization (K1) for sm_90a.
//
// Replaces: src/repro/kernels/quant_act/kernel.py, _quant_act_kernel
//           (launched by quant_act_kernel).
// Computes: for each row of x (M, K), absmax in f32, scale = absmax / qmax
//           (1.0 when absmax <= 1e-12), q = clip(rint(x / scale), ±qmax)
//           as int8, plus the (M, 1) f32 scale.
// Bound:    memory.  Each element is read once (2 or 4 bytes) and written
//           once (1 byte); the arithmetic is a max, a divide and a round.
//           At the slice's shapes (256 x 768 / 3072) the whole call moves
//           0.6-2.4 MB, below one launch's latency on an H100.
// Design:   one block per row.  Pass 1 reduces |x| to the row max (max is
//           exact in any order: warp shuffles, then one value per warp in
//           shared memory); pass 2 re-reads the row, which is hot in L1/L2,
//           and writes int8.  The division is IEEE (__fdiv_rn) and the
//           rounding is half to even (rintf), the JAX reference's numerics;
//           this file must never be built with --use_fast_math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
quant_act_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                 float* __restrict__ scale, int k, float qmax) {
  const int64_t row = blockIdx.x;
  const T* xr = x + row * k;
  int8_t* qr = q + row * k;

  float m = 0.0f;
  for (int i = threadIdx.x; i < k; i += kThreads) m = fmaxf(m, fabsf(to_f32(xr[i])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));

  __shared__ float warp_max[kThreads / 32];
  __shared__ float row_scale;
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float absmax = warp_max[0];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) absmax = fmaxf(absmax, warp_max[w]);
    const float s = absmax <= 1e-12f ? 1.0f : __fdiv_rn(absmax, qmax);
    row_scale = s;
    scale[row] = s;
  }
  __syncthreads();

  const float s = row_scale;
  for (int i = threadIdx.x; i < k; i += kThreads) {
    float v = rintf(__fdiv_rn(to_f32(xr[i]), s));
    v = fminf(fmaxf(v, -qmax), qmax);
    qr[i] = static_cast<int8_t>(__float2int_rn(v));
  }
}

template <typename T>
int launch(const void* x, void* q, void* scale, int m, int k, int qmax,
           int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m > 0) {
    quant_act_kernel<T><<<m, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(scale), k, static_cast<float>(qmax));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int launch_quant_act_f32(const void* x, void* q, void* scale, int m,
                                    int k, int qmax, int device,
                                    cudaStream_t stream) {
  return launch<float>(x, q, scale, m, k, qmax, device, stream);
}

extern "C" int launch_quant_act_bf16(const void* x, void* q, void* scale, int m,
                                     int k, int qmax, int device,
                                     cudaStream_t stream) {
  return launch<__nv_bfloat16>(x, q, scale, m, k, qmax, device, stream);
}
