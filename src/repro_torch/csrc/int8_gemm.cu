// int8 GEMMs with a fused dequant epilogue (K2, K3) for sm_90a.
//
// K2 tiled_matmul
//   Replaces: src/repro/kernels/tiled_matmul/kernel.py, _matmul_kernel_panel
//             and _matmul_kernel_ksplit (launched by tiled_matmul_kernel).
//   Computes: C = (int32(A @ B).f32 * (sa * sb) [+ bias]) as f32 or bf16, for
//             A (M, K) int8, sa (M,) f32, B (K, N) int8 stored K-major as
//             (N, K), sb (N,) f32.
// K3 fused_qkv
//   Replaces: src/repro/kernels/fused_qkv/kernel.py, _fused_qkv_kernel and
//             _fused_qkv_kernel_ksplit (launched by fused_qkv_kernel).
//   Computes: Q, K, V = the K2 epilogue (no bias) over A @ Wq, A @ Wk, A @ Wv
//             in one launch; Wk / Wv cost only the column tiles they have
//             (GQA: Nkv <= Nq).
// Bound:    on an H100 (3.35 TB/s, 1,979 int8 TOP/s) the ridge is ~590 int8
//           ops per byte.  Decode and verify (M <= 64: 2 M N K / bytes
//           below 2 M) are bound by the weight bytes; an 8192-token
//           prefill (in the thousands) by the tensor cores.
// Design:   three variants, chosen before launch by the wrapper's
//           `gemm_plan` from (M, N, K, alignment) alone:
//   wide    (int8_wgmma.cuh, COLS 256) M > 512, or M > 64 where its
//           tiles fill half the SMs: 128 x 256 output tiles, TMA into a
//           4-stage ring, wgmma m64n256k32 s8 on two consumer warpgroups,
//           one producer warp; one persistent block an SM.
//   swap    (int8_wgmma.cuh, COLS 8-64) the other M: swap-AB, the K-major
//           weights are wgmma's 64-row A operand and the activation rows,
//           zero-padded to COLS by TMA (tiles of 64 rows past 64), its N
//           side; 128 weight rows a tile, two blocks an SM; K split over
//           blocks where the tiles leave most SMs idle, the int32 partials
//           summed by a second kernel.  Where the wide tiles would leave
//           SMs idle it is the faster of the two (tools/gemm_plan_sweep.py
//           times both).
//   general (int8_tile.cuh) what TMA cannot describe: __dp4a on 64 x 64
//           tiles.
//   The launcher checks the plan it is given against its own geometry
//   (`plan_fits`): a plan whose splits do not cover K's k-steps exactly
//   once, or a width no variant is built for, returns an error rather than
//   a partial product, whatever the wrapper's constants say.
//   Two more K2 modes serve the row-parallel projections of a serving mesh
//   (src/repro_torch/core/quantized_linear.py), whose ranks each hold a
//   slice of K: the int32-out mode (`launch_tiled_matmul_int32`) runs the
//   swap form with its scratch as the output, K2 without its epilogue (a
//   split K sums its partials into it in `splitk_epilogue`), and the
//   epilogue mode (`launch_int8_epilogue`) runs `splitk_epilogue` alone on
//   an int32 product (the ranks' sum), with the same dequant as every
//   variant: bitwise the unsplit K2.
//   K3 walks its column space [Nq | Nkv | Nkv] as one grid of tiles mapped
//   to (product, column) rather than staging one A stage for all three
//   products: A's tile is a third of a wide stage's bytes, and one grid of
//   2048 / 256 + 2 tiles (qwen2.5-3b) keeps every block's work equal, where
//   a shared stage would leave the K/V accumulators idle on 8 of 10 column
//   tiles.
#include <cuda.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "int8_tile.cuh"
#include "int8_wgmma.cuh"

namespace {

enum Variant { kGeneral = 0, kWide = 1, kSwap = 2 };

// cuTensorMapEncodeTiled, a driver-API call, fetched through the runtime
// (no -lcuda at link time)
using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeFn encode_fn() {
  static EncodeFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeFn>(p);
  }
  return fn;
}

// a (rows, K) row-major int8 matrix, read in boxes of BK x box_rows with
// the 128-byte swizzle; rows and K past the edges read as 0
bool encode(CUtensorMap* map, const void* base, int rows, int k, int box_rows) {
  EncodeFn fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(int8_wgmma::BK),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Product {
  const void* b;          // (n, K) int8, K-major
  const float* sb;
  const float* bias;
  void* out;
  int n;
};

// sum_out: the int32-out mode's (M, n_total) output (the swap form only),
// else nullptr
template <int COLS, int NMAT>
int launch_tma(const void* a, const float* sa, const Product (&prod)[NMAT], int32_t* ws, int m,
               int k, int split, int chunk, int out_bf16, int sms, cudaStream_t stream,
               int32_t* sum_out = nullptr) {
  using S = int8_wgmma::Shape<COLS>;
  using int8_wgmma::ROWS;
  constexpr int kWeightTile = S::kSwap ? ROWS : COLS;
  int8_wgmma::Params<NMAT> p{};
  if (!encode(&p.act, a, m, k, S::kSwap ? COLS : ROWS)) return cudaErrorInvalidValue;
  int tiles = 0, n_total = 0;
  for (int j = 0; j < NMAT; ++j) {
    if (!encode(&p.w[j], prod[j].b, prod[j].n, k, kWeightTile)) return cudaErrorInvalidValue;
    p.mat[j] = {prod[j].sb, prod[j].bias, prod[j].out, prod[j].n,
                (prod[j].n + kWeightTile - 1) / kWeightTile, n_total};
    tiles += p.mat[j].tiles;
    n_total += prod[j].n;
  }
  p.sa = sa;
  p.ws = split > 1 ? ws : sum_out;
  p.m = m;
  p.n_total = n_total;
  p.nk = (k + int8_wgmma::BK - 1) / int8_wgmma::BK;
  p.chunk = chunk;
  p.tiles = tiles;
  const int m_tile = S::kSwap ? COLS : ROWS;
  p.row_tiles = (m + m_tile - 1) / m_tile;
  p.split = split;
  p.out_bf16 = out_bf16;
  // persistent blocks: as many as fit on the card at once, at most one
  // per work item
  const int grid = std::min(tiles * p.row_tiles * split, sms * S::kMinBlocks);
  auto kernel = int8_wgmma::gemm_tma<COLS, NMAT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         S::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, int8_wgmma::kThreads, S::kSmem, stream>>>(p);
  if (split > 1) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    int8_wgmma::EpiParams<NMAT> e{};
    e.ws = ws;
    e.sa = sa;
    for (int j = 0; j < NMAT; ++j) e.mat[j] = p.mat[j];
    e.m = m;
    e.n_total = n_total;
    e.split = split;
    e.out_bf16 = out_bf16;
    e.sum_out = sum_out;
    int8_wgmma::splitk_epilogue<NMAT><<<dim3((n_total + 255) / 256, m), 256, 0, stream>>>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int NMAT>
int launch_general(const void* a, const float* sa, const Product (&prod)[NMAT], int m, int k,
                   int out_bf16, cudaStream_t stream) {
  int8_tile::Args<NMAT> args{};
  args.a = static_cast<const int8_t*>(a);
  args.sa = sa;
  args.m = m;
  args.k = k;
  for (int j = 0; j < NMAT; ++j)
    args.mat[j] = {static_cast<const int8_t*>(prod[j].b), prod[j].sb, prod[j].bias, prod[j].out,
                   prod[j].n, 0};
  return int8_tile::launch<NMAT>(args, out_bf16, stream);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// whether the variant takes the plan: the general tile unsplit; a
// tensor-core variant only where TMA reads the operands (K a multiple of 16,
// 16-byte bases), at a width it is built for, with `split` runs of `chunk`
// k-steps that cover K's k-steps exactly once (the last run not empty) and
// scratch for the partials; the wide tile does not split K
template <int NMAT>
bool plan_fits(const void* a, const Product (&prod)[NMAT], const void* ws, int k, int variant,
               int cols, int split, int chunk) {
  if (variant == kGeneral) return split == 1;
  if (variant != kWide && variant != kSwap) return false;
  if (k % 16 != 0 || !aligned16(a)) return false;
  for (int j = 0; j < NMAT; ++j)
    if (!aligned16(prod[j].b)) return false;
  const long long nk = (k + int8_wgmma::BK - 1) / int8_wgmma::BK;
  if (split < 1 || chunk < 1) return false;
  if (static_cast<long long>(split - 1) * chunk >= nk ||
      static_cast<long long>(split) * chunk < nk)
    return false;
  if (split > 1 && ws == nullptr) return false;
  if (variant == kWide) return cols == 256 && split == 1;
  return cols == 8 || cols == 16 || cols == 32 || cols == 64;
}

template <int NMAT>
int launch(const void* a, const void* sa, const Product (&prod)[NMAT], void* ws, int m, int k,
           int out_bf16, int variant, int cols, int split, int chunk, int device,
           cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m == 0) return 0;
  if (!plan_fits<NMAT>(a, prod, ws, k, variant, cols, split, chunk))
    return cudaErrorInvalidValue;
  const float* s = static_cast<const float*>(sa);
  int32_t* w = static_cast<int32_t*>(ws);
  if (variant == kGeneral) return launch_general<NMAT>(a, s, prod, m, k, out_bf16, stream);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
#define INT8_GEMM_TMA(C) \
  launch_tma<C, NMAT>(a, s, prod, w, m, k, split, chunk, out_bf16, sms, stream)
  if (variant == kWide) return INT8_GEMM_TMA(256);
  if (variant == kSwap) {
    switch (cols) {
      case 8: return INT8_GEMM_TMA(8);
      case 16: return INT8_GEMM_TMA(16);
      case 32: return INT8_GEMM_TMA(32);
      case 64: return INT8_GEMM_TMA(64);
    }
  }
#undef INT8_GEMM_TMA
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int launch_tiled_matmul(const void* a, const void* sa, const void* b,
                                   const void* sb, const void* bias, void* out, void* ws,
                                   int m, int k, int n, int out_bf16, int variant, int cols,
                                   int split, int chunk, int device, cudaStream_t stream) {
  const Product prod[1] = {{b, static_cast<const float*>(sb), static_cast<const float*>(bias),
                            out, n}};
  return launch<1>(a, sa, prod, ws, m, k, out_bf16, variant, cols, split, chunk, device, stream);
}

// K2's int32-out mode: acc (M, N) int32 = A @ B exactly, by the swap form
// (cols 8-64; with split > 1, `ws` holds the (split, M, N) partials).  sa and
// sb are read (staged) but do not enter the result.
extern "C" int launch_tiled_matmul_int32(const void* a, const void* sa, const void* b,
                                         const void* sb, void* acc, void* ws, int m, int k,
                                         int n, int cols, int split, int chunk, int device,
                                         cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m == 0) return 0;
  const Product prod[1] = {{b, static_cast<const float*>(sb), nullptr, nullptr, n}};
  if (acc == nullptr || !plan_fits<1>(a, prod, ws, k, kSwap, cols, split, chunk))
    return cudaErrorInvalidValue;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* s = static_cast<const float*>(sa);
  int32_t* w = static_cast<int32_t*>(ws);
  int32_t* out = static_cast<int32_t*>(acc);
  switch (cols) {
    case 8: return launch_tma<8, 1>(a, s, prod, w, m, k, split, chunk, 0, sms, stream, out);
    case 16: return launch_tma<16, 1>(a, s, prod, w, m, k, split, chunk, 0, sms, stream, out);
    case 32: return launch_tma<32, 1>(a, s, prod, w, m, k, split, chunk, 0, sms, stream, out);
    case 64: return launch_tma<64, 1>(a, s, prod, w, m, k, split, chunk, 0, sms, stream, out);
  }
  return cudaErrorInvalidValue;
}

// K2's epilogue alone: out (M, N) = acc.f32 * (sa * sb) (+ bias), f32 or
// bf16, for an int32 product acc (M, N), as every K2 variant computes it.
extern "C" int launch_int8_epilogue(const void* acc, const void* sa, const void* sb,
                                    const void* bias, void* out, int m, int n, int out_bf16,
                                    int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m == 0 || n == 0) return 0;
  if (acc == nullptr || sa == nullptr || sb == nullptr || out == nullptr || m > 65535)
    return cudaErrorInvalidValue;
  int8_wgmma::EpiParams<1> e{};
  e.ws = static_cast<const int32_t*>(acc);
  e.sa = static_cast<const float*>(sa);
  e.mat[0] = {static_cast<const float*>(sb), static_cast<const float*>(bias), out, n, 0, 0};
  e.m = m;
  e.n_total = n;
  e.split = 1;
  e.out_bf16 = out_bf16;
  e.sum_out = nullptr;
  int8_wgmma::splitk_epilogue<1><<<dim3((n + 255) / 256, m), 256, 0, stream>>>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int launch_fused_qkv(const void* a, const void* sa, const void* wq,
                                const void* sq, const void* wk, const void* sk,
                                const void* wv, const void* sv, void* q_out,
                                void* k_out, void* v_out, void* ws, int m, int k, int nq,
                                int nkv, int out_bf16, int variant, int cols, int split,
                                int chunk, int device, cudaStream_t stream) {
  const Product prod[3] = {
      {wq, static_cast<const float*>(sq), nullptr, q_out, nq},
      {wk, static_cast<const float*>(sk), nullptr, k_out, nkv},
      {wv, static_cast<const float*>(sv), nullptr, v_out, nkv}};
  return launch<3>(a, sa, prod, ws, m, k, out_bf16, variant, cols, split, chunk, device, stream);
}
