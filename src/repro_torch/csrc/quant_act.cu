// Per-row int8 activation quantization (K1) for sm_90a, and its SwiGLU mode.
//
// Replaces: src/repro/kernels/quant_act/kernel.py, _quant_act_kernel
//           (launched by quant_act_kernel).
// Computes: for each row of x (M, K), absmax in f32, scale = absmax / qmax
//           (1.0 when absmax <= 1e-12), q = clip(rint(x / scale), ±qmax)
//           as int8, plus the (M, 1) f32 scale.  The SwiGLU mode reads gate
//           and up (M, K) instead of x and quantizes h = silu(gate) * up,
//           each element computed as PyTorch computes it on the card (bf16:
//           silu's f32 quotient rounded to bf16, times up in f32, rounded
//           to bf16), so one launch replaces F.silu, the product and K1; h
//           is written out only when the caller passes a pointer for it.
//           Two more modes serve the row-parallel projections of a serving
//           mesh (src/repro_torch/core/quantized_linear.py), whose rows are
//           split over ranks by columns: the absmax mode writes each row's
//           f32 absmax (of x, or of h) in place of the scale and quantizes
//           nothing; the given-absmax mode skips the reduction and
//           quantizes with the (M, 1) absmax it is given (the maximum of
//           the ranks' absmaxes), so each rank's values are bitwise those
//           of the whole row's K1.
// Bound:    memory for K1: each element is read once (2 or 4 bytes) and
//           written once (1 byte); ~15 instructions an element (max,
//           product by the row's reciprocal, rounding by a magic sum, clip,
//           packing) stay below the bytes' time on an H100.  The SwiGLU mode
//           reads twice the bytes and adds expf and an IEEE division an
//           element (~38 instructions); the card's readings do not show
//           the ALUs binding it either (PERF.md §6).
// Design:   one read of each element: a thread loads its share of a row
//           into registers (16-byte loads of 8 values; 8-byte stores of 8
//           int8), reduces |x|, and quantizes from the same registers, so
//           the row never comes back from memory.  Rows map by shape
//           (`quant_plan` in src/repro_torch/kernels/quant_act/ops.py):
//             block rows:   one block a row (a block reduction);
//             cluster rows: a row split over a thread-block cluster of 2-8
//                           blocks (few rows, or a row longer than a block
//                           holds): each block reduces its slice, then reads
//                           its peers' maxima through distributed shared
//                           memory after a cluster barrier.
//           The register arrays are sized per launch (NV units a thread).
//           Max is exact in any order, so every mapping gives the same
//           bits.  A K that is not a multiple of 8, or a base off 16 bytes,
//           takes the unvectorized instantiation (one element an access).
//           The values are rint(x / s) of the IEEE quotient, half to even
//           (`quantize` below: the same bits as __fdiv_rn and rintf), the
//           JAX reference's numerics.  This file must never be built with
//           --use_fast_math.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxSplit = 8;           // a portable cluster
constexpr int kVec = 8;                // elements a vector access moves

enum Rows { kBlockRows = 0, kClusterRows = 1 };
// kQuantize: the absmax, then the values; kAbsmax: the absmax alone, into
// `scale`; kGiven: the values, with the absmax read from `absmax`
enum Mode { kQuantize = 0, kAbsmax = 1, kGiven = 2 };

// the most vectors (unvectorized: elements) a thread holds; `max_per` in
// src/repro_torch/kernels/quant_act/ops.py mirrors it
template <typename T, int VEC> struct Cap { static constexpr int value = 16; };
template <> struct Cap<__nv_bfloat16, kVec> { static constexpr int value = 8; };
template <> struct Cap<float, kVec> { static constexpr int value = 4; };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// h = silu(g) * u as PyTorch computes it on the card: silu is
// g / (1 + exp(-g)) in f32 (expf and an IEEE division), its result has the
// tensor's type, and the product is an f32 product rounded to that type.
// The _rn intrinsics keep nvcc from contracting the add or the product.
__device__ __forceinline__ float silu(float g) {
  return __fdiv_rn(g, __fadd_rn(1.0f, expf(-g)));
}

template <typename T>
__device__ __forceinline__ float swiglu(float g, float u) {
  if constexpr (sizeof(T) == 2) return bf16_round(__fmul_rn(bf16_round(silu(g)), u));
  return __fmul_rn(silu(g), u);
}

// VEC consecutive elements of a row, in registers: bf16 packed two to a
// word as loaded, f32 (and the unvectorized case) as floats
template <typename T, int VEC> struct Frag {
  float v[VEC];
  __device__ __forceinline__ void load(const T* p) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = to_f32(p[i]);
  }
  // this fragment (holding up) becomes silu(g) * up
  __device__ __forceinline__ void swiglu_of(const Frag& g) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = swiglu<T>(g.v[i], v[i]);
  }
  __device__ __forceinline__ float get(int i) const { return v[i]; }
  __device__ __forceinline__ void store(T* p) const {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = static_cast<T>(v[i]);
  }
};

template <> struct Frag<float, kVec> {
  float v[kVec];
  __device__ __forceinline__ void load(const float* p) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
  __device__ __forceinline__ void swiglu_of(const Frag& g) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) v[i] = swiglu<float>(g.v[i], v[i]);
  }
  __device__ __forceinline__ float get(int i) const { return v[i]; }
  __device__ __forceinline__ void store(float* p) const {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
};

template <> struct Frag<__nv_bfloat16, kVec> {
  uint32_t w[kVec / 2];                  // element 2i in the low half of w[i]
  // this fragment (holding up) becomes silu(g) * up, two elements at a
  // time: each pair's roundings to bf16 are one packed conversion
  __device__ __forceinline__ void swiglu_of(const Frag& g) {
#pragma unroll
    for (int i = 0; i < kVec / 2; ++i) {
      const float2 s = __bfloat1622float2(
          __floats2bfloat162_rn(silu(g.get(2 * i)), silu(g.get(2 * i + 1))));
      const __nv_bfloat162 h = __floats2bfloat162_rn(__fmul_rn(s.x, get(2 * i)),
                                                      __fmul_rn(s.y, get(2 * i + 1)));
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
  }
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  }
  __device__ __forceinline__ float get(int i) const {
    return __uint_as_float(i & 1 ? w[i >> 1] & 0xffff0000u : w[i >> 1] << 16);
  }
  __device__ __forceinline__ void store(__nv_bfloat16* p) const {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

constexpr float kMagic = 12582912.0f;         // 1.5 * 2^23
constexpr int kMagicBits = 0x4B400000;          // its bits
constexpr float kNearHalf = 0.5f - 3.0517578125e-05f;   // 1/2 - 2^-15

// rint(v) as an int for |v| < 2^22, half to even: v + 1.5 * 2^23 lies in
// [2^23, 2^24), where the floats are the integers, so the sum rounds v to
// an integer (1.5 * 2^23 is even, so ties go to even), and that integer is
// the sum's bits minus kMagicBits.  Full-rate additions in place of FRND
// and F2I, which share the quarter-rate pipe with MUFU.
__device__ __forceinline__ int rint_bits(float sum) { return __float_as_int(sum) - kMagicBits; }

// clip(rint(x / s), ±qmax), x / s the IEEE quotient, given y = RN(1 / s).
// |x / s| <= 127.00001 (|x| <= absmax and s = RN(absmax / 127), or s = 1
// with |x| <= 1e-12), so q = RN(x * y) = (x / s)(1 + d1)(1 + d2) with
// |d1|, |d2| <= 2^-24 lies within 127.00001 * (2^-23 + 2^-48) < 2^-16 of
// x / s (a product that underflows errs by at most 2^-149), and RN(x / s)
// within half an ulp, 2^-18, of it: q and RN(x / s) are less than 2^-15
// apart.  (s = inf, from an infinite absmax, gives y = 0: q = 0 = x / s
// for finite x, NaN otherwise.)  Where q is at least 2^-15 from every
// half-integer, no rounding boundary of rint lies between them, so
// rint(q) = rint(RN(x / s)); t = q - rint(q) is exact.  Elsewhere (one
// element in ~16,000, and NaN) the IEEE quotient decides.  rint and the
// clip to the integers ±qmax commute.  The result is bitwise that of
// __fdiv_rn without its reciprocal and FMAs on each element.
__device__ __forceinline__ int quantize(float x, float s, float y, float qmax) {
  const float q = __fmul_rn(x, y);
  const float sum = __fadd_rn(q, kMagic);
  const float t = __fsub_rn(q, __fsub_rn(sum, kMagic));
  int n;
  if (fabsf(t) < kNearHalf) {
    n = rint_bits(sum);
  } else {
    const float v = fminf(fmaxf(__fdiv_rn(x, s), -qmax), qmax);   // NaN: -qmax
    n = rint_bits(__fadd_rn(v, kMagic));
  }
  const int qi = static_cast<int>(qmax);
  return min(max(n, -qi), qi);
}

template <int VEC>
__device__ __forceinline__ void store_q(int8_t* p, const int (&q)[VEC]) {
  if constexpr (VEC == kVec) {
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      lo |= static_cast<uint32_t>(q[i] & 0xff) << (8 * i);
      hi |= static_cast<uint32_t>(q[i + 4] & 0xff) << (8 * i);
    }
    *reinterpret_cast<uint2*>(p) = make_uint2(lo, hi);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = static_cast<int8_t>(q[i]);
  }
}

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  return m;
}

struct Args {
  const void* x;    // (M, K): the activation, or gate in the SwiGLU mode
  const void* u;    // (M, K): up in the SwiGLU mode, else null
  int8_t* q;        // (M, K), null in the absmax mode
  float* scale;     // (M, 1): the scale, or the absmax in the absmax mode
  void* h;          // (M, K): silu(gate) * up, or null
  const float* absmax;  // (M, 1) in the given-absmax mode, else null
  int m, k;
  int per;          // vectors (unvectorized: elements) a thread holds
  int split;        // blocks a row (cluster rows), else 1
  float qmax;
  int mode;         // Mode
};

// A row's units (vectors of VEC elements) split into `split` slices of
// ceil(units / split); thread t of a slice's group holds units
// lo + t + j * group for j < per <= NV (registers for NV units: the
// launcher picks the smallest instantiation that holds `per`).
template <typename T, bool GLU, int VEC, int ROWS, int NV>
__global__ void __launch_bounds__(kMaxThreads) quant_rows(const Args a) {
  __shared__ float part_max[kMaxThreads / 32];
  __shared__ float slice_max;

  int rank = 0;
  if constexpr (ROWS == kClusterRows) rank = static_cast<int>(cg::this_cluster().block_rank());
  const int64_t row = blockIdx.x / a.split;
  const int t = threadIdx.x;
  const int group = blockDim.x;
  const int units = a.k / VEC;
  const int slice = (units + a.split - 1) / a.split;
  const int lo = rank * slice;
  const int hi = min(lo + slice, units);
  const int64_t base = row * a.k;

  // every load first, so a thread's loads are in flight together
  Frag<T, VEC> f[NV];
  Frag<T, VEC> g[GLU ? NV : 1];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = lo + t + j * group;
    if (j < a.per && i < hi) {
      if constexpr (GLU) {
        g[j].load(static_cast<const T*>(a.x) + base + static_cast<int64_t>(i) * VEC);
        f[j].load(static_cast<const T*>(a.u) + base + static_cast<int64_t>(i) * VEC);
      } else {
        f[j].load(static_cast<const T*>(a.x) + base + static_cast<int64_t>(i) * VEC);
      }
    }
  }
  float m = 0.0f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = lo + t + j * group;
    if (j < a.per && i < hi) {
      if constexpr (GLU) {
        f[j].swiglu_of(g[j]);
        if (a.h != nullptr)
          f[j].store(static_cast<T*>(a.h) + base + static_cast<int64_t>(i) * VEC);
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) m = fmaxf(m, fabsf(f[j].get(e)));
    }
  }

  // the mode is the same for every block, so the barriers below are taken
  // by all of a cluster's blocks or by none
  const bool reduce = a.mode != kGiven;
  if (reduce) {
    m = warp_max(m);
    const int warps = blockDim.x >> 5;
    if ((threadIdx.x & 31) == 0) part_max[threadIdx.x >> 5] = m;
    __syncthreads();
    m = part_max[0];
    for (int w = 1; w < warps; ++w) m = fmaxf(m, part_max[w]);
    if constexpr (ROWS == kClusterRows) {
      cg::cluster_group cluster = cg::this_cluster();
      if (threadIdx.x == 0) slice_max = m;
      cluster.sync();                        // every slice's max is written
      for (int r = 0; r < a.split; ++r) m = fmaxf(m, *cluster.map_shared_rank(&slice_max, r));
    }
  } else {
    m = a.absmax[row];
  }
  if (a.mode == kAbsmax) {
    if (rank == 0 && t == 0) a.scale[row] = m;
  } else {
    const float s = m <= 1e-12f ? 1.0f : __fdiv_rn(m, a.qmax);
    const float y = __frcp_rn(s);
    if (rank == 0 && t == 0) a.scale[row] = s;

#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = lo + t + j * group;
      if (j < a.per && i < hi) {
        int q[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) q[e] = quantize(f[j].get(e), s, y, a.qmax);
        store_q<VEC>(a.q + base + static_cast<int64_t>(i) * VEC, q);
      }
    }
  }
  // a block's shared memory must outlive its peers' reads of slice_max
  if constexpr (ROWS == kClusterRows) {
    if (reduce) cg::this_cluster().sync();
  }
}

int cap_of(int bf16, int vec) {
  if (vec == 1) return Cap<float, 1>::value;
  return bf16 ? Cap<__nv_bfloat16, kVec>::value : Cap<float, kVec>::value;
}

bool aligned(const void* p, uintptr_t bytes) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The plan against the launcher's own geometry: the slices cover each row's
// units exactly once (the last slice not empty), a thread's share fits its
// registers, vector accesses only on aligned rows.
bool plan_fits(const Args& a, int bf16, int vec, int rows, int threads) {
  if (a.m < 0 || a.k < 1 || a.split < 1 || a.split > kMaxSplit) return false;
  if (threads < 32 || threads > kMaxThreads || threads % 32) return false;
  if (vec != 1 && vec != kVec) return false;
  if (a.per < 1 || a.per > cap_of(bf16, vec)) return false;
  if ((rows == kClusterRows) != (a.split > 1) || rows < kBlockRows || rows > kClusterRows)
    return false;
  if (a.k % vec) return false;
  if (vec == kVec && !(aligned(a.x, 16) && aligned(a.u, 16) && aligned(a.h, 16) &&
                       aligned(a.q, 8)))
    return false;
  const int units = a.k / vec;
  const int slice = (units + a.split - 1) / a.split;
  if ((a.split - 1) * slice >= units) return false;     // the last slice empty
  if (static_cast<int64_t>(a.per) * threads < slice) return false;
  return static_cast<int64_t>(a.m) * a.split <= INT_MAX;
}

template <typename T, bool GLU, int VEC, int NV>
cudaError_t launch_rows(const Args& a, int rows, int threads, cudaStream_t stream) {
  if (rows == kBlockRows) {
    quant_rows<T, GLU, VEC, kBlockRows, NV><<<a.m, threads, 0, stream>>>(a);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(a.m) * a.split);
  config.blockDim = dim3(threads);
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&config, quant_rows<T, GLU, VEC, kClusterRows, NV>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// the register arrays' sizes: 1, 2, 4 and the cap for vectors, 4 and the
// cap for single values
template <typename T, bool GLU, int VEC>
cudaError_t launch_sized(const Args& a, int rows, int threads, cudaStream_t stream) {
  constexpr int CAP = Cap<T, VEC>::value;
  if constexpr (VEC == kVec) {
    if (a.per <= 1) return launch_rows<T, GLU, VEC, 1>(a, rows, threads, stream);
    if (a.per <= 2) return launch_rows<T, GLU, VEC, 2>(a, rows, threads, stream);
  }
  if (a.per <= 4) return launch_rows<T, GLU, VEC, 4>(a, rows, threads, stream);
  if constexpr (CAP > 4) return launch_rows<T, GLU, VEC, CAP>(a, rows, threads, stream);
  return cudaErrorInvalidValue;
}

template <typename T, bool GLU>
cudaError_t launch_typed(const Args& a, int vec, int rows, int threads, cudaStream_t stream) {
  return vec == kVec ? launch_sized<T, GLU, kVec>(a, rows, threads, stream)
                     : launch_sized<T, GLU, 1>(a, rows, threads, stream);
}

}  // namespace

// x: the activation (or gate); u: up, null outside the SwiGLU mode; h: where
// the SwiGLU mode writes silu(gate) * up, or null.  mode: 0 quantize, 1 the
// rows' absmax alone (into `scale`; q null), 2 quantize with the (M, 1)
// `absmax` given.  rows: 0 block rows, 1 cluster rows of `split` blocks.
// Returns a CUDA error code; cudaErrorInvalidValue for a plan that does not
// fit.
extern "C" int launch_quant_act(const void* x, const void* u, void* q, void* scale, void* h,
                                const void* absmax, int m, int k, int qmax, int bf16, int glu,
                                int vec, int rows, int threads, int split, int per, int mode,
                                int device, cudaStream_t stream) {
  Args a{x, u, static_cast<int8_t*>(q), static_cast<float*>(scale), h,
         static_cast<const float*>(absmax), m, k, per, split, static_cast<float>(qmax), mode};
  if (!plan_fits(a, bf16, vec, rows, threads) || qmax < 1 || qmax > 127 ||
      (glu != 0) != (u != nullptr) ||
      (!glu && h != nullptr) || mode < kQuantize || mode > kGiven ||
      (mode == kAbsmax) != (q == nullptr) || (mode == kGiven) != (absmax != nullptr) ||
      scale == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m == 0) return 0;
  if (bf16) {
    err = glu ? launch_typed<__nv_bfloat16, true>(a, vec, rows, threads, stream)
              : launch_typed<__nv_bfloat16, false>(a, vec, rows, threads, stream);
  } else {
    err = glu ? launch_typed<float, true>(a, vec, rows, threads, stream)
              : launch_typed<float, false>(a, vec, rows, threads, stream);
  }
  return static_cast<int>(err);
}
