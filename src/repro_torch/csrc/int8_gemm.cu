// int8 GEMMs with a fused dequant epilogue (K2, K3) for sm_90a.
//
// K2 tiled_matmul
//   Replaces: src/repro/kernels/tiled_matmul/kernel.py, _matmul_kernel_panel
//             and _matmul_kernel_ksplit (launched by tiled_matmul_kernel).
//   Computes: C = (int32(A @ B).f32 * (sa * sb) [+ bias]) as f32 or bf16, for
//             A (M, K) int8, sa (M,) f32, B (K, N) int8, sb (N,) f32.
// K3 fused_qkv
//   Replaces: src/repro/kernels/fused_qkv/kernel.py, _fused_qkv_kernel and
//             _fused_qkv_kernel_ksplit (launched by fused_qkv_kernel).
//   Computes: Q, K, V = the K2 epilogue (no bias) over A @ Wq, A @ Wk, A @ Wv
//             in one launch, each A slab staged once for all three (the
//             paper's update_A); Wk / Wv are only multiplied by the column
//             tiles they have (GQA: Nkv <= Nq).
// Bound:    memory at the slice's shapes.  On an H100 (3.35 TB/s, 1,979 int8
//           TOP/s) the ridge is ~590 int8 ops per byte; a (256, 768) x
//           (768, 3072) product does 2*M*N*K / bytes ~ 290 and decode (M = 4)
//           ~ 8, so weight bytes set the bound.
// Design:   int8_tile.cuh: 64 x 64 output tiles, a K loop over 64-deep slabs
//           staged in shared memory, int32 __dp4a accumulation and an epilogue
//           with explicit _rn intrinsics.  It is the simple, exact first
//           version: no wgmma, no TMA, no multi-stage pipeline, so it reads far
//           from its bound (see PERF.md).
#include "int8_tile.cuh"

extern "C" int launch_tiled_matmul(const void* a, const void* sa, const void* b,
                                   const void* sb, const void* bias, void* out,
                                   int m, int k, int n, int out_bf16, int device,
                                   cudaStream_t stream) {
  int8_tile::Args<1> args{};
  args.a = static_cast<const int8_t*>(a);
  args.sa = static_cast<const float*>(sa);
  args.m = m;
  args.k = k;
  args.mat[0] = {static_cast<const int8_t*>(b), static_cast<const float*>(sb),
                 static_cast<const float*>(bias), out, n, 0};
  return int8_tile::launch<1>(args, out_bf16, device, stream);
}

extern "C" int launch_fused_qkv(const void* a, const void* sa, const void* wq,
                                const void* sq, const void* wk, const void* sk,
                                const void* wv, const void* sv, void* q_out,
                                void* k_out, void* v_out, int m, int k, int nq,
                                int nkv, int out_bf16, int device,
                                cudaStream_t stream) {
  int8_tile::Args<3> args{};
  args.a = static_cast<const int8_t*>(a);
  args.sa = static_cast<const float*>(sa);
  args.m = m;
  args.k = k;
  args.mat[0] = {static_cast<const int8_t*>(wq), static_cast<const float*>(sq),
                 nullptr, q_out, nq, 0};
  args.mat[1] = {static_cast<const int8_t*>(wk), static_cast<const float*>(sk),
                 nullptr, k_out, nkv, 0};
  args.mat[2] = {static_cast<const int8_t*>(wv), static_cast<const float*>(sv),
                 nullptr, v_out, nkv, 0};
  return int8_tile::launch<3>(args, out_bf16, device, stream);
}
