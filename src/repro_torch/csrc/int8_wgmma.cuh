// Tensor-core core of the int8 GEMM (K2) and the fused QKV GEMM (K3) on
// sm_90a: TMA loads into a ring of shared-memory stages, wgmma s8 x s8 ->
// s32 products, and the dequant epilogue straight from the accumulators.
//
// Each work item is an output tile of one product C_j = dequant(A @ B_j)
// (+ bias_j) of up to NMAT products that share the activations A (M, K).
// Every weight B_j is stored K-major, (N_j, K) row-major: wgmma reads 8-bit
// operands only K-major, and TMA cannot transpose bytes.
//
// The wgmma's A side is always a 128-row tile (two consumer warpgroups of 64
// rows); its B side is COLS rows.  Two forms:
//   wide (SWAP false, COLS 256): the A side is 128 activation rows, the B
//     side 256 weight rows (output columns).  Large M: prefill and chunked
//     prefill.  Bound by the tensor cores.
//   swap (SWAP true, COLS 8-64): the A side is 128 weight rows, the B side
//     the activation rows zero-padded to COLS (TMA fills rows past M with
//     0), in tiles of COLS rows.  Small M: decode, the verify pass, the
//     draft, short prefills.  Bound by the weight bytes, so the ring keeps
//     4 stages of 16 KB of weights in flight per block, two blocks per SM,
//     and the K loop may be split over blocks.
// The column space [N_0 | N_1 | ...] of the products is walked as one grid
// (blockIdx.x -> (product, tile)), so K3's GQA widths (2048 | 256 | 256 for
// qwen2.5-3b) cost one tile each and nothing past N_kv is computed.
//
// A stage holds BK = 128 values of K: one 128-byte row of TMA's 128-byte
// swizzle per operand row, which is also the canonical K-major SW128 layout
// wgmma's descriptors name (8-row groups 1024 bytes apart; a k32 step moves
// the start address by 32 bytes).
//
// Warp roles: warpgroup 0 is the producer (one thread issues the TMA loads
// of each stage, waits on the stage's `empty` barrier before reuse);
// warpgroups 1-2 are consumers (wait on `full`, issue the stage's four
// wgmmas as one batch, release the previous stage once its batch is done).
// Blocks are persistent: block b takes work items b, b + gridDim.x, ...
// (column tile fastest, then row tile, then split), and the producer runs
// on into the next item's stages while the consumers run an epilogue.
//
// Split K (`split` > 1, the swap form only): work item z of a tile takes
// k-steps [z * chunk, (z + 1) * chunk) and writes its int32 partial sums
// to scratch (split, M, N_total); the second kernel `splitk_epilogue` adds
// them (int32 sums are exact in any order) and runs the epilogue once.
//
// Epilogue: __fmul_rn(float(acc), __fmul_rn(sa, sb)), then __fadd_rn(bias),
// then the cast: the _rn intrinsics keep nvcc from contracting an FMA.  A
// tile's scales and biases are staged in shared memory by cp.async while
// its mainloop runs; the wide form passes each warp's outputs through a
// small shared-memory slab so every lane stores 16 adjacent bytes (the
// accumulator fragment holds only 2 adjacent columns a lane).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace int8_wgmma {

constexpr int BK = 128;                  // K values (bytes) per stage
constexpr int ROWS = 128;                // wgmma A-side rows per block
constexpr int kConsumers = ROWS / 64;    // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kRowBytes = ROWS * BK;     // 16 KB
constexpr int SWAP_MAX_COLS = 64;        // the swap form's largest COLS
constexpr int kScaleFloats = 3 * 256;    // a tile's staged sb, bias, sa
// a warp's 8 x 32 outputs, rows padded to 160 bytes (f32) or 80 (bf16)
// so neither the writes nor the 16-byte reads conflict in a bank
constexpr int kSlabBytes = 8 * 160;

struct Mat {
  const float* sb;        // (n,) f32 per-column scale
  const float* bias;      // (n,) f32 or nullptr
  void* out;              // (M, n) f32 or bf16
  int n;
  int tiles;              // tiles of this product in the column space
  int col0;               // first column in the split-K scratch
};

template <int NMAT>
struct Params {
  CUtensorMap act;        // A (M, K) int8, box {BK, ROWS or COLS}
  CUtensorMap w[NMAT];    // B_j (N_j, K) int8, box {BK, COLS or ROWS}
  const float* sa;        // (M,) f32 per-row scale
  int32_t* ws;            // split-K partials (split, M, n_total), or nullptr
  Mat mat[NMAT];
  int m;
  int n_total;
  int nk;                 // k-steps in K
  int chunk;              // k-steps per split
  int tiles;              // column tiles, all products
  int row_tiles;          // activation-row tiles
  int split;
  int out_bf16;
};

template <int NMAT>
struct EpiParams {
  const int32_t* ws;
  const float* sa;
  Mat mat[NMAT];
  int m;
  int n_total;
  int split;
  int out_bf16;
  int32_t* sum_out;       // (M, n_total): the int32 sums alone, or nullptr
};

template <int COLS>
struct Shape {
  static constexpr bool kSwap = COLS <= SWAP_MAX_COLS;
  static constexpr int kStages = 4;
  static constexpr int kColBytes = COLS * BK;
  static constexpr int kStageBytes = kRowBytes + kColBytes;
  // stages, their barriers, two tiles' scales (sb, bias, sa: 3 x 256
  // floats each), and room to align the base to 1024 bytes
  static constexpr int kScalesAt = kStages * kStageBytes + 2 * kStages * 8;
  // the wide form's epilogue: a staging slab per consumer warp
  static constexpr int kSlabsAt = kScalesAt + 2 * kScaleFloats * 4;
  static constexpr int kSmem = kSlabsAt + (kSwap ? 0 : 4 * kConsumers * kSlabBytes) + 1024;
  static constexpr int kMinBlocks = kSwap ? 2 : 1;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// a 2-D TMA load of the box at (c0 along K, c1 along rows) into `dst`,
// completing on `bar`'s transaction count
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1) : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// a wgmma descriptor of a K-major tile in TMA's 128-byte swizzle: 8-row
// groups 1024 bytes apart (SBO), layout type 1 (SWIZZLE_128B)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int pending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(pending) : "memory");
}

// keep the accumulators in their registers across a wgmma's fence or wait
template <int R>
__device__ __forceinline__ void pin(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Each stage's wgmmas (4 k32 steps over the stage's 128 values of K) are
// issued with every descriptor computed beforehand, and for COLS <= 64 as
// one asm statement; `one` is a register holding 1 (scale-d: accumulate
// into the zeroed accumulators).

// m64n8k32: four k-steps (one 128-byte stage) in one statement
__device__ __forceinline__ void mma_stage(int (&d)[4], const uint64_t (&a)[4],
                                          const uint64_t (&b)[4], int one) {
  asm volatile(
    "{\n.reg .pred p;\nsetp.ne.b32 p, %12, 0;\n"
    "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
    "%0, %1, %2, %3"
    "}, %4, %8, p;\n"
    "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
    "%0, %1, %2, %3"
    "}, %5, %9, p;\n"
    "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
    "%0, %1, %2, %3"
    "}, %6, %10, p;\n"
    "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
    "%0, %1, %2, %3"
    "}, %7, %11, p;\n"
    "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(a[0]), "l"(a[1]), "l"(a[2]), "l"(a[3]), "l"(b[0]), "l"(b[1]), "l"(b[2]),
        "l"(b[3]), "r"(one));
}

// m64n16k32: four k-steps (one 128-byte stage) in one statement
__device__ __forceinline__ void mma_stage(int (&d)[8], const uint64_t (&a)[4],
                                          const uint64_t (&b)[4], int one) {
  asm volatile(
    "{\n.reg .pred p;\nsetp.ne.b32 p, %16, 0;\n"
    "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
    "%0, %1, %2, %3, %4, %5, %6, %7"
    "}, %8, %12, p;\n"
    "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
    "%0, %1, %2, %3, %4, %5, %6, %7"
    "}, %9, %13, p;\n"
    "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
    "%0, %1, %2, %3, %4, %5, %6, %7"
    "}, %10, %14, p;\n"
    "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
    "%0, %1, %2, %3, %4, %5, %6, %7"
    "}, %11, %15, p;\n"
    "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "l"(a[0]), "l"(a[1]), "l"(a[2]), "l"(a[3]), "l"(b[0]), "l"(b[1]), "l"(b[2]),
        "l"(b[3]), "r"(one));
}

// m64n32k32: four k-steps (one 128-byte stage) in one statement
__device__ __forceinline__ void mma_stage(int (&d)[16], const uint64_t (&a)[4],
                                          const uint64_t (&b)[4], int one) {
  asm volatile(
    "{\n.reg .pred p;\nsetp.ne.b32 p, %24, 0;\n"
    "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
    "%14, %15"
    "}, %16, %20, p;\n"
    "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
    "%14, %15"
    "}, %17, %21, p;\n"
    "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
    "%14, %15"
    "}, %18, %22, p;\n"
    "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
    "%14, %15"
    "}, %19, %23, p;\n"
    "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "l"(a[0]), "l"(a[1]), "l"(a[2]), "l"(a[3]), "l"(b[0]), "l"(b[1]), "l"(b[2]),
        "l"(b[3]), "r"(one));
}

// m64n64k32: four k-steps (one 128-byte stage) in one statement
__device__ __forceinline__ void mma_stage(int (&d)[32], const uint64_t (&a)[4],
                                          const uint64_t (&b)[4], int one) {
  asm volatile(
    "{\n.reg .pred p;\nsetp.ne.b32 p, %40, 0;\n"
    "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
    "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
    "%26, %27, %28, %29, %30, %31"
    "}, %32, %36, p;\n"
    "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
    "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
    "%26, %27, %28, %29, %30, %31"
    "}, %33, %37, p;\n"
    "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
    "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
    "%26, %27, %28, %29, %30, %31"
    "}, %34, %38, p;\n"
    "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
    "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
    "%26, %27, %28, %29, %30, %31"
    "}, %35, %39, p;\n"
    "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a[0]), "l"(a[1]), "l"(a[2]), "l"(a[3]), "l"(b[0]), "l"(b[1]), "l"(b[2]),
        "l"(b[3]), "r"(one));
}

// m64n256k32: one k-step per statement
__device__ __forceinline__ void mma_k32(int (&d)[128], uint64_t a, uint64_t b, int one) {
  asm volatile(
    "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
    "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
    "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
    "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
    "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
    "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
    "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
    "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
    "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
    "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, "
    "%109, %110, %111, %112, %113, %114, %115, %116, %117, %118, "
    "%119, %120, %121, %122, %123, %124, %125, %126, %127"
    "}, %128, %129, p;\n"
    "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
        "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),
        "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(one));
}

__device__ __forceinline__ void mma_stage(int (&d)[128], const uint64_t (&a)[4],
                                          const uint64_t (&b)[4], int one) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) mma_k32(d, a[kk], b[kk], one);
}


__device__ __forceinline__ float dequant(int acc, float sa, float sb, bool has_bias, float b) {
  const float v = __fmul_rn(__int2float_rn(acc), __fmul_rn(sa, sb));
  return has_bias ? __fadd_rn(v, b) : v;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16;
}

// `n` (up to `w`) adjacent outputs of `elt` bytes from v at element idx
// of `out`: one 16-byte store where all w fit and idx is 16-byte aligned
// (every base is 256-byte aligned), else one store each
__device__ __forceinline__ void put_vec(void* out, int64_t idx, int elt, uint4 v, int n) {
  const int w = 16 / elt;
  if (n >= w && !(idx & (w - 1))) {
    *reinterpret_cast<uint4*>(static_cast<uint8_t*>(out) + idx * elt) = v;
    return;
  }
  const uint32_t word[4] = {v.x, v.y, v.z, v.w};
  if (elt == 2) {
    uint16_t* o = static_cast<uint16_t*>(out) + idx;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (e < n) o[e] = static_cast<uint16_t>(e & 1 ? word[e / 2] >> 16 : word[e / 2] & 0xffffu);
  } else {
    uint32_t* o = static_cast<uint32_t*>(out) + idx;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < n) o[e] = word[e];
  }
}

__device__ __forceinline__ void put1(void* out, int out_bf16, int64_t idx, float v) {
  if (out_bf16)
    static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(out)[idx] = v;
}

// one work item: product j's tile at weight row n0, activation row m0,
// k-steps [k0, k0 + steps)
struct Work {
  int j, n0, m0, z, k0, steps;
};

template <int COLS, int NMAT>
__device__ __forceinline__ Work work_item(const Params<NMAT>& p, int w) {
  constexpr bool kSwap = Shape<COLS>::kSwap;
  Work t;
  int x = w % p.tiles;
  const int r = w / p.tiles;
  t.z = r / p.row_tiles;
  t.j = 0;
#pragma unroll
  for (int i = 0; i + 1 < NMAT; ++i)
    if (t.j == i && x >= p.mat[i].tiles) { x -= p.mat[i].tiles; t.j = i + 1; }
  t.n0 = x * (kSwap ? ROWS : COLS);
  t.m0 = (r % p.row_tiles) * (kSwap ? COLS : ROWS);
  t.k0 = t.z * p.chunk;
  t.steps = max(0, min(p.nk, t.k0 + p.chunk) - t.k0);
  return t;
}

// stage a tile's epilogue operands in shared memory, asynchronously (the
// mainloop hides the loads): sc[0, 256) sb and sc[256, 512) bias of
// columns n0 + i, sc[512, 768) sa of rows m0 + i; 0 past the edges (and
// for a missing bias)
template <int NMAT>
__device__ __forceinline__ void stage_scales(const Params<NMAT>& p, const Work& t, float* sc) {
  const Mat& mat = p.mat[t.j];
  const int i = threadIdx.x - 128;                 // consumer thread 0..255
  const int n = t.n0 + i, m = t.m0 + i;
  const bool n_ok = n < mat.n, m_ok = m < p.m;
  async_copy::copy4(sc + i, n_ok ? mat.sb + n : mat.sb, n_ok);
  const bool b_ok = n_ok && mat.bias != nullptr;
  async_copy::copy4(sc + 256 + i, b_ok ? mat.bias + n : mat.sb, b_ok);
  async_copy::copy4(sc + 512 + i, m_ok ? p.sa + m : p.sa, m_ok);
  async_copy::commit();
}

// the accumulator fragment of consumer warpgroup c: register 4 q + 2 h + e
// holds A-side row 64 c + 16 warp + lane / 4 + 8 h and B-side row
// 8 q + 2 (lane % 4) + e
template <int COLS, int NMAT>
__device__ __forceinline__ void epilogue(const Params<NMAT>& p, const Work& t, int c,
                                         const int (&acc)[COLS / 2], const float* sc,
                                         uint8_t* slab) {
  const Mat& mat = p.mat[t.j];
  const bool has_bias = mat.bias != nullptr;
  const float* s_sb = sc;
  const float* s_bias = sc + 256;
  const float* s_sa = sc + 512;
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32, quad = lane % 4;
  const int a_row = c * 64 + warp * 16 + lane / 4;
  if constexpr (!Shape<COLS>::kSwap) {
    // A side: activation rows; B side: output columns.  A warp's 8 rows x
    // 32 columns go through its slab, so each lane stores 16 adjacent
    // bytes of one row.
    const bool bf16 = p.out_bf16;
    const int elt = bf16 ? 2 : 4, pitch = bf16 ? 80 : 160;
    const int g8 = lane / 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = a_row + 8 * h;
      const float sa = s_sa[r];
      const int row0 = t.m0 + c * 64 + warp * 16 + 8 * h;   // the slab's first row
#pragma unroll
      for (int g = 0; g < COLS / 32; ++g) {
        __syncwarp();
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int q = 4 * g + cc, col = 8 * q + 2 * quad;
          const float f0 = dequant(acc[4 * q + 2 * h], sa, s_sb[col], has_bias, s_bias[col]);
          const float f1 =
              dequant(acc[4 * q + 2 * h + 1], sa, s_sb[col + 1], has_bias, s_bias[col + 1]);
          uint8_t* at = slab + g8 * pitch + (8 * cc + 2 * quad) * elt;
          if (bf16)
            *reinterpret_cast<uint32_t*>(at) = pack_bf16(f0, f1);
          else
            *reinterpret_cast<uint2*>(at) = make_uint2(__float_as_uint(f0), __float_as_uint(f1));
        }
        __syncwarp();
        // the slab's 16-byte pieces, 4 a row in bf16 and 8 in f32: one a
        // lane, or two
        const int pieces = 2 * elt;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (i * 32 >= 8 * pieces) break;
          const int id = lane + 32 * i, rr = id / pieces, piece = id % pieces;
          const int m = row0 + rr, n = t.n0 + 32 * g + piece * (16 / elt);
          const uint4 v = *reinterpret_cast<const uint4*>(slab + rr * pitch + piece * 16);
          if (m < p.m && n < mat.n)
            put_vec(mat.out, static_cast<int64_t>(m) * mat.n + n, elt, v, mat.n - n);
        }
      }
    }
  } else {
    // A side: output columns; B side: activation rows
#pragma unroll
    for (int q = 0; q < COLS / 8; ++q) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int mr = 8 * q + 2 * quad + e;
        const int m = t.m0 + mr;
        if (m >= p.m) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = a_row + 8 * h;
          const int n = t.n0 + r;
          if (n >= mat.n) continue;
          const int v = acc[4 * q + 2 * h + e];
          if (p.ws != nullptr)      // split K: rows z M + m of the scratch
            p.ws[(static_cast<int64_t>(t.z) * p.m + m) * p.n_total + mat.col0 + n] = v;
          else
            put1(mat.out, p.out_bf16, static_cast<int64_t>(m) * mat.n + n,
                 dequant(v, s_sa[mr], s_sb[r], has_bias, s_bias[r]));
        }
      }
    }
  }
}

template <int COLS, int NMAT>
__global__ void __launch_bounds__(kThreads, Shape<COLS>::kMinBlocks)
    gemm_tma(__grid_constant__ const Params<NMAT> p) {
  using S = Shape<COLS>;
  constexpr bool kSwap = S::kSwap;
  constexpr int kStages = S::kStages;
  constexpr int kAcc = COLS / 2;         // accumulators per thread (m64nCOLS)
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t rows_s = base;                                  // kStages x 16 KB
  const uint32_t cols_s = base + kStages * kRowBytes;            // kStages x COLS x BK
  const uint32_t full = cols_s + kStages * S::kColBytes;         // kStages mbarriers
  const uint32_t empty = full + 8 * kStages;
  uint8_t* const gbase = smem_raw + (base - smem_u32(smem_raw));   // `base` as a pointer
  float* scales = reinterpret_cast<float*>(gbase + S::kScalesAt);
  const int n_work = p.tiles * p.row_tiles * p.split;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: the loads of every work item of this block, in order
    if constexpr (!kSwap) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      prefetch_map(&p.act);
#pragma unroll
      for (int j = 0; j < NMAT; ++j) prefetch_map(&p.w[j]);
      int s = 0;
      uint32_t phase = 0;
      for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
        const Work t = work_item<COLS>(p, w);
        const CUtensorMap* rows_map = kSwap ? &p.w[t.j] : &p.act;
        const CUtensorMap* cols_map = kSwap ? &p.act : &p.w[t.j];
        const int rows_c = kSwap ? t.n0 : t.m0;
        const int cols_c = kSwap ? t.m0 : t.n0;
        for (int i = 0; i < t.steps; ++i) {
          mbar_wait(empty + 8 * s, phase ^ 1);
          mbar_expect_tx(full + 8 * s, S::kStageBytes);
          const int kc = (t.k0 + i) * BK;
          tma_load(rows_s + s * kRowBytes, rows_map, full + 8 * s, kc, rows_c);
          tma_load(cols_s + s * S::kColBytes, cols_map, full + 8 * s, kc, cols_c);
          if (++s == kStages) { s = 0; phase ^= 1; }
        }
      }
    }
    return;
  }

  // consumers: warpgroup c takes the A side's rows [64 c, 64 c + 64)
  if constexpr (!kSwap) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg - 1;
  const int one = 1;
  int s = 0, parity = 0;
  uint32_t phase = 0;
  for (int w = blockIdx.x; w < n_work; w += gridDim.x, parity ^= 1) {
    const Work t = work_item<COLS>(p, w);
    // two tiles' scale buffers: a thread stages tile i's while others may
    // still read tile i - 1's; tile i - 2's readers all passed tile i - 1's
    // barrier
    float* sc = scales + parity * kScaleFloats;
    stage_scales(p, t, sc);
    int acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0;
    int prev = 0;
    for (int i = 0; i < t.steps; ++i) {
      mbar_wait(full + 8 * s, phase);
      uint64_t da[4], db[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        da[kk] = sw128_desc(rows_s + s * kRowBytes + c * 64 * BK + 32 * kk);
        db[kk] = sw128_desc(cols_s + s * S::kColBytes + 32 * kk);
      }
      pin(acc);
      wgmma_fence();
      mma_stage(acc, da, db, one);
      wgmma_commit();
      wgmma_wait<1>();                 // the previous stage's batch is done
      pin(acc);
      if (i > 0 && threadIdx.x % 128 == 0) mbar_arrive(empty + 8 * prev);
      prev = s;
      if (++s == kStages) { s = 0; phase ^= 1; }
    }
    wgmma_wait<0>();
    pin(acc);
    if (t.steps > 0 && threadIdx.x % 128 == 0) mbar_arrive(empty + 8 * prev);
    async_copy::wait<0>();
    asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kConsumers) : "memory");   // the scales
    epilogue<COLS>(p, t, c, acc, sc, gbase + S::kSlabsAt + (threadIdx.x / 32 - 4) * kSlabBytes);
  }
}

// the sum of the split-K partials, then the epilogue: one thread per output.
// With `sum_out` the sums are written there as they are (K2's int32-out
// mode); with split 1 and `ws` an int32 product this is K2's epilogue alone
template <int NMAT>
__global__ void __launch_bounds__(256)
    splitk_epilogue(__grid_constant__ const EpiParams<NMAT> p) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int m = blockIdx.y;
  if (col >= p.n_total) return;
  int j = 0;
#pragma unroll
  for (int i = 1; i < NMAT; ++i)
    if (col >= p.mat[i].col0) j = i;
  const Mat& mat = p.mat[j];
  const int n = col - mat.col0;
  int acc = 0;
  for (int z = 0; z < p.split; ++z)
    acc += p.ws[(static_cast<int64_t>(z) * p.m + m) * p.n_total + col];
  if (p.sum_out != nullptr) {
    p.sum_out[static_cast<int64_t>(m) * p.n_total + col] = acc;
    return;
  }
  const bool has_bias = mat.bias != nullptr;
  put1(mat.out, p.out_bf16, static_cast<int64_t>(m) * mat.n + n,
       dequant(acc, p.sa[m], mat.sb[n], has_bias, has_bias ? mat.bias[n] : 0.0f));
}

}  // namespace int8_wgmma
