// The general variant of the int8 GEMM (K2) and the fused QKV GEMM (K3):
// the shapes the tensor-core variants (int8_wgmma.cuh) cannot take, because
// TMA cannot describe them (a row stride not a multiple of 16 bytes, or a
// base address not 16-byte aligned).
//
// One block owns a BM x BN output tile of up to NMAT products that share the
// A operand: C_j = dequant(A @ B_j) (+ bias_j).  The K loop runs inside the
// block: each step stages one BK-deep slab of A, and of every live B_j, in
// shared memory, then accumulates in int32 with __dp4a on K-packed quads.
// That loop replaces both TPU schedules (panel-resident and K-split): Hopper
// has no sequential grid, so nothing is carried between blocks.
//
// Layout: A is (M, K) row-major and every B_j is stored K-major, (N_j, K)
// row-major, so a row's K run is contiguous in both and one 32-bit read of
// a staged row yields the four K values __dp4a needs.  Rows are padded to
// BK + 4 bytes (17 words) so the 16 distinct rows a warp reads fall in
// distinct banks.
//
// Edges: M, N_j and K need not be tile multiples.  Out-of-range A and B
// elements are zero-filled on load (they add 0 to the int32 sum) and stores
// are guarded.  GQA: B_j with N_j <= the tile's first column is skipped for
// that tile, the Hopper form of the TPU kernel's `j < nkv_blocks` gate.
//
// Epilogue: __fmul_rn(float(acc), __fmul_rn(sa, sb)), then __fadd_rn(bias):
// the explicit round-to-nearest intrinsics keep nvcc from contracting the
// multiply and add into an FMA, which would change the last bit against the
// reference's separate multiply and add.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace int8_tile {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 64;
constexpr int kThreads = 256;        // 16 x 16 threads, 4 x 4 outputs each
constexpr int LDB = BK + 4;          // padded shared row, bytes
constexpr int LDW = LDB / 4;         // padded shared row, 32-bit words
static_assert(BM == BN, "load_slab stages A and B tiles alike");

struct Mat {
  const int8_t* b;        // (n, K) int8, K-major
  const float* sb;        // (n,) f32 per-column scale
  const float* bias;      // (n,) f32 or nullptr
  void* out;              // (M, n) f32 or bf16
  int n;
  int vec;                // K % 4 == 0 and b 4-byte aligned: word loads
};

template <int NMAT>
struct Args {
  const int8_t* a;        // (M, K) int8
  const float* sa;        // (M,) f32 per-row scale
  int m;
  int k;
  int vec_a;              // K % 4 == 0 and a 4-byte aligned: word loads
  Mat mat[NMAT];
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// stage rows [r0, r0 + BM) x K values [k0, k0 + BK) of a (rows, K)
// row-major int8 matrix, zero past its edges
__device__ __forceinline__ void load_slab(int8_t* s, const int8_t* g, int rows, int k, int r0,
                                          int k0, int vec) {
  const int tid = threadIdx.x;
  if (vec) {
    for (int w = tid; w < BM * BK / 4; w += kThreads) {
      const int r = w / (BK / 4), c = (w % (BK / 4)) * 4;
      const int gr = r0 + r, gk = k0 + c;
      int v = 0;
      if (gr < rows && gk < k) v = *reinterpret_cast<const int*>(g + static_cast<int64_t>(gr) * k + gk);
      *reinterpret_cast<int*>(s + r * LDB + c) = v;
    }
  } else {
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int r = e / BK, c = e % BK;
      const int gr = r0 + r, gk = k0 + c;
      s[r * LDB + c] = (gr < rows && gk < k) ? g[static_cast<int64_t>(gr) * k + gk] : int8_t(0);
    }
  }
}

template <typename OutT, int NMAT>
__global__ void __launch_bounds__(kThreads) gemm_kernel(const Args<NMAT> args) {
  __shared__ __align__(16) int8_t sA[BM * LDB];
  __shared__ __align__(16) int8_t sB[NMAT][BN * LDB];

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  bool live[NMAT];
#pragma unroll
  for (int j = 0; j < NMAT; ++j) live[j] = n0 < args.mat[j].n;

  int acc[NMAT][4][4];
#pragma unroll
  for (int j = 0; j < NMAT; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][r][c] = 0;

  for (int k0 = 0; k0 < args.k; k0 += BK) {
    load_slab(sA, args.a, args.m, args.k, m0, k0, args.vec_a);
#pragma unroll
    for (int j = 0; j < NMAT; ++j)
      if (live[j]) load_slab(sB[j], args.mat[j].b, args.mat[j].n, args.k, n0, k0, args.mat[j].vec);
    __syncthreads();

    const int* wA = reinterpret_cast<const int*>(sA);
#pragma unroll 4
    for (int k4 = 0; k4 < BK / 4; ++k4) {
      int av[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) av[r] = wA[(ty + 16 * r) * LDW + k4];
#pragma unroll
      for (int j = 0; j < NMAT; ++j) {
        if (!live[j]) continue;
        const int* wB = reinterpret_cast<const int*>(sB[j]);
        int bv[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = wB[(tx + 16 * c) * LDW + k4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[j][r][c] = __dp4a(av[r], bv[c], acc[j][r][c]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < NMAT; ++j) {
    if (!live[j]) continue;
    const Mat& mat = args.mat[j];
    OutT* out = static_cast<OutT*>(mat.out);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int gm = m0 + ty + 16 * r;
      if (gm >= args.m) continue;
      const float sa = args.sa[gm];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int gn = n0 + tx + 16 * c;
        if (gn >= mat.n) continue;
        float v = __fmul_rn(__int2float_rn(acc[j][r][c]), __fmul_rn(sa, mat.sb[gn]));
        if (mat.bias != nullptr) v = __fadd_rn(v, mat.bias[gn]);
        store(out + static_cast<int64_t>(gm) * mat.n + gn, v);
      }
    }
  }
}

inline int aligned4(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 3) == 0; }

template <int NMAT>
int launch(Args<NMAT> args, int out_bf16, cudaStream_t stream) {
  args.vec_a = (args.k % 4 == 0) && aligned4(args.a);
  for (int j = 0; j < NMAT; ++j)
    args.mat[j].vec = (args.k % 4 == 0) && aligned4(args.mat[j].b);
  // mat[0] is the widest product (Nq >= Nkv): the grid covers its columns
  const dim3 grid((args.mat[0].n + BN - 1) / BN, (args.m + BM - 1) / BM);
  if (grid.x > 0 && grid.y > 0) {
    if (out_bf16)
      gemm_kernel<__nv_bfloat16, NMAT><<<grid, kThreads, 0, stream>>>(args);
    else
      gemm_kernel<float, NMAT><<<grid, kThreads, 0, stream>>>(args);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace int8_tile
