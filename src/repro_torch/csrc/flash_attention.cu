// Block-sparse flash attention (K5) for sm_90a.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:133, _flash_kernel
//           (launched by flash_attention_kernel, planned by flash_schedule
//           and _kv_block_bounds).
// Computes: out[b, s, h] = softmax(q[b, s, h] . K^T * scale [softcap]) . V
//           over the keys t of KV head h / g (g = H / KH, GQA) that
//           query s sees: t <= s when causal, t > s - window with a
//           window; a row that sees nothing gives 0.  q and out are
//           (B, S, H, D), k and v (B, T, KH, D), all f32 or all bf16, with
//           D <= 128.  The softmax is online, in f32: scores scaled by
//           __fmul_rn, capped as softcap * tanhf(s / softcap), masked to
//           NEG_INF, p re-masked after the exp, l summed from the f32 p, V
//           rows past T zeroed, and the epilogue acc / max(l, 1e-37) by
//           __fdiv_rn.  The P.V product takes the unnormalised p in f32
//           (f32) or as two bf16 terms, p's bf16 rounding and its rest
//           (bf16: ~16 bits of p, where the TPU kernel rounds p to bf16).
//           For the backward (flash_attention_bwd.cu) it may also write each
//           row's log-sum-exp m + log(l) (+inf for a row that sees no key)
//           and, in bf16, out before its rounding; out is the same bits
//           either way.
// Bound:    operations.  At the served shapes (S = T = 8192, D = 128) each
//           K/V row is used by g * (its visible q rows) query rows: 2,000
//           to 3,600 flops per byte of q, k, v and out, far above the
//           card's ~295 bf16 tensor-core flops per byte, so the least time
//           is the flops of the visible (q, k) pairs (4 * D per pair and
//           head: QK and PV) over the 989 TFLOP/s bf16 peak.
// Design:   a q tile of 64 rows of one head walks its own KV tiles of 64
//           rows, [j_lo, j_hi] by _kv_block_bounds' formula at these tile
//           sizes, in a loop inside its block (so a fully masked KV tile
//           is never loaded; the loop replaces the TPU's sequential
//           max_kv_steps grid axis).  q tiles run in reverse order, so the
//           longest causal walks start first.
//   bf16:   the products run on the tensor cores by wgmma (bf16 in, f32
//           accumulate), FlashAttention-3 style.  A block is one
//           warpgroup (128 threads, 16 q rows a warp) per query head, two
//           heads of one KV group per block where the group allows it, so
//           each K/V tile is loaded once for both: the walk is bound by
//           the K/V bytes each tile moves from L2.  Tiles sit in shared
//           memory as bf16 in wgmma's 8 x 8-block layout, head dim
//           zero-padded to 128 (every D <= 128 takes this path).  S = Q K^T
//           reads Q and K from shared memory (m64n64k16); the online
//           softmax runs on S's accumulator registers in f32 (each thread
//           holds 2 rows x 16 keys; row max and sum by quad shuffles; the
//           masks only on tiles that cross the diagonal, the window's edge
//           or T; exp by the MUFU's ex2); P's accumulator fragments are
//           repacked in registers as two bf16 A-fragments (p rounded, and
//           the rest rounded) of O += P V (m64n128k16, V from shared
//           memory, MN-major).  Tile j's QK is issued together with tile
//           j - 1's P V, so P V runs while tile j's softmax does.  K and V
//           stream through a ring of three stages filled by cp.async (rows
//           past T zero-filled): the next tile loads while one tile's K and
//           the last one's V are read; one barrier per tile.  128 KB of
//           shared memory and ~200 registers a thread: one block of two
//           heads per SM.
//   f32:    the products stay on the f32 ALUs (full f32, no TF32: phase
//           5's limit forbids it).  Tiles are staged in shared memory as
//           f32 with 16-byte loads (98 KB at D = 128, two blocks per SM);
//           each thread owns a 4 x 8 register tile of the 64 x 64 score
//           block (rows strided by 4, columns by 8, so the 16-byte
//           shared-memory reads are free of bank conflicts) and a 4 x 16
//           tile of the 64 x D accumulator; the probabilities reuse the K
//           tile's space.
//           Measured times: PERF.md section 6 (chip_smoke.py phase 6).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "async_copy.cuh"
#include "flash_common.cuh"

namespace {

using flash::kBK;                             // KV rows per step of the walk
using flash::kBQ;                             // q rows per block
using flash::kNegInf;

constexpr int kThreads = 128;                 // 4 warps, 16 q rows each
constexpr int kMaxD = 128;
constexpr int kStages = 3;                    // bf16: K/V tile stages
constexpr int kPS = kBK + 8;                  // row stride of the f32 P tile
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;                                 // (B, H, S) f32, or null: none
  float* out32;                               // bf16: out before rounding, or null
  int s_len, t_len, n_heads, n_kv, d;
  int dp;                                     // f32: d padded to 4
  int group;                                  // H / KH
  int causal, window;                         // window <= 0: none
  float scale, softcap;                       // softcap <= 0: none
  int vec;                                    // 16-byte global loads
};

// the q tile's KV tiles [j_lo, j_hi], as _kv_block_bounds computes them
__device__ __forceinline__ void kv_bounds(const Params& p, int i, int& j_lo, int& j_hi) {
  flash::kv_tile_bounds(i, p.t_len, p.causal, p.window, j_lo, j_hi);
}

__device__ __forceinline__ bool visible(const Params& p, int k_pos, int q_pos) {
  return flash::key_visible(k_pos, q_pos, p.t_len, p.causal, p.window);
}

__device__ __forceinline__ float capped(const Params& p, float acc) {
  return flash::cap_score(acc, p.scale, p.softcap);
}

// the row's log-sum-exp m + log(l) for the backward; +inf for a row that
// sees no key (l = 0), so that exp(s - lse) is 0 for it
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.0f ? m + logf(l) : __int_as_float(0x7f800000);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma)
// ---------------------------------------------------------------------------
// Tiles of kMaxD columns (the head dim zero-padded) sit in shared memory as
// 8 x 8 blocks of 128 contiguous bytes (wgmma's interleave layout, no
// swizzle: eight 16-byte rows of a block are one 128-byte line, free of
// bank conflicts): element (r, c) at ((r / 8) * 16 + c / 8) * 64 +
// (r % 8) * 8 + c % 8.
__device__ __forceinline__ int tiled(int r, int c) {
  return ((r >> 3) * (kMaxD / 8) + (c >> 3)) * 64 + (r & 7) * 8 + (c & 7);
}

// a wgmma shared-memory matrix descriptor, interleave layout: the byte
// offsets between neighbouring 8 x 8 blocks along K (lbo) and along M or N
// (sbo)
__device__ __forceinline__ uint64_t smem_desc(const bf16* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((async_copy::smem_addr(p) & 0x3ffff) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3fff) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3fff) << 32;
}

// Each batch of wgmmas is one asm statement: an instruction between two
// wgmmas of a batch that defines one of their input registers makes ptxas
// serialize them.  `zero` is a register holding 0 (the scale-d flags).
// S (64 x 64) = Q (64 x 128) . K^T (128 x 64): 8 k-steps, both operands in
// shared memory (K-major, descriptors a and b per k-step)
__device__ __forceinline__ void wgmma_qk(float (&s)[8][4], const uint64_t (&a)[8],
                                          const uint64_t (&b)[8], int zero) {
  asm volatile(
    "{\n.reg .pred p0, p1;\nsetp.ne.b32 p0, %48, 0;\nsetp.eq.b32 p1, %48, 0;\n"
    "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, "
    "%4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
    "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, "
    "%40, p0, 1, 1, 0, 0;\n"
    "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, "
    "%4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
    "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %33, "
    "%41, p1, 1, 1, 0, 0;\n"
    "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, "
    "%4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
    "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %34, "
    "%42, p1, 1, 1, 0, 0;\n"
    "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, "
    "%4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
    "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %35, "
    "%43, p1, 1, 1, 0, 0;\n"
    "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, "
    "%4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
    "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %36, "
    "%44, p1, 1, 1, 0, 0;\n"
    "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, "
    "%4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
    "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %37, "
    "%45, p1, 1, 1, 0, 0;\n"
    "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, "
    "%4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
    "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %38, "
    "%46, p1, 1, 1, 0, 0;\n"
    "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, "
    "%4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
    "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %39, "
    "%47, p1, 1, 1, 0, 0;\n"
    "}\n"
      : "+f"(s[0][0]), "+f"(s[0][1]), "+f"(s[0][2]), "+f"(s[0][3]),
      "+f"(s[1][0]), "+f"(s[1][1]), "+f"(s[1][2]), "+f"(s[1][3]),
      "+f"(s[2][0]), "+f"(s[2][1]), "+f"(s[2][2]), "+f"(s[2][3]),
      "+f"(s[3][0]), "+f"(s[3][1]), "+f"(s[3][2]), "+f"(s[3][3]),
      "+f"(s[4][0]), "+f"(s[4][1]), "+f"(s[4][2]), "+f"(s[4][3]),
      "+f"(s[5][0]), "+f"(s[5][1]), "+f"(s[5][2]), "+f"(s[5][3]),
      "+f"(s[6][0]), "+f"(s[6][1]), "+f"(s[6][2]), "+f"(s[6][3]),
      "+f"(s[7][0]), "+f"(s[7][1]), "+f"(s[7][2]), "+f"(s[7][3])
      : "l"(a[0]), "l"(a[1]), "l"(a[2]), "l"(a[3]),
      "l"(a[4]), "l"(a[5]), "l"(a[6]), "l"(a[7]),
      "l"(b[0]), "l"(b[1]), "l"(b[2]), "l"(b[3]),
      "l"(b[4]), "l"(b[5]), "l"(b[6]), "l"(b[7]),
      "r"(zero));
}
// O (64 x 128) += P (64 x 64, registers: 4 k-steps, as hi then lo) .
// V (64 x 128, shared memory, MN-major, descriptor b per k-step)
__device__ __forceinline__ void wgmma_pv(float (&o)[16][4], const uint32_t (&hi)[4][4],
                                          const uint32_t (&lo)[4][4], const uint64_t (&b)[4],
                                          int zero) {
  asm volatile(
    "{\n.reg .pred p1;\nsetp.eq.b32 p1, %100, 0;\n"
    "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, "
    "%4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
    "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
    "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
    "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
    "%61, %62, %63}, {%64, %65, %66, %67}, %96, p1, 1, 1, 1;\n"
    "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, "
    "%4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
    "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
    "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
    "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
    "%61, %62, %63}, {%68, %69, %70, %71}, %97, p1, 1, 1, 1;\n"
    "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, "
    "%4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
    "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
    "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
    "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
    "%61, %62, %63}, {%72, %73, %74, %75}, %98, p1, 1, 1, 1;\n"
    "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, "
    "%4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
    "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
    "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
    "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
    "%61, %62, %63}, {%76, %77, %78, %79}, %99, p1, 1, 1, 1;\n"
    "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, "
    "%4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
    "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
    "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
    "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
    "%61, %62, %63}, {%80, %81, %82, %83}, %96, p1, 1, 1, 1;\n"
    "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, "
    "%4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
    "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
    "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
    "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
    "%61, %62, %63}, {%84, %85, %86, %87}, %97, p1, 1, 1, 1;\n"
    "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, "
    "%4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
    "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
    "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
    "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
    "%61, %62, %63}, {%88, %89, %90, %91}, %98, p1, 1, 1, 1;\n"
    "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, "
    "%4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
    "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
    "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
    "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
    "%61, %62, %63}, {%92, %93, %94, %95}, %99, p1, 1, 1, 1;\n"
    "}\n"
      : "+f"(o[0][0]), "+f"(o[0][1]), "+f"(o[0][2]), "+f"(o[0][3]),
      "+f"(o[1][0]), "+f"(o[1][1]), "+f"(o[1][2]), "+f"(o[1][3]),
      "+f"(o[2][0]), "+f"(o[2][1]), "+f"(o[2][2]), "+f"(o[2][3]),
      "+f"(o[3][0]), "+f"(o[3][1]), "+f"(o[3][2]), "+f"(o[3][3]),
      "+f"(o[4][0]), "+f"(o[4][1]), "+f"(o[4][2]), "+f"(o[4][3]),
      "+f"(o[5][0]), "+f"(o[5][1]), "+f"(o[5][2]), "+f"(o[5][3]),
      "+f"(o[6][0]), "+f"(o[6][1]), "+f"(o[6][2]), "+f"(o[6][3]),
      "+f"(o[7][0]), "+f"(o[7][1]), "+f"(o[7][2]), "+f"(o[7][3]),
      "+f"(o[8][0]), "+f"(o[8][1]), "+f"(o[8][2]), "+f"(o[8][3]),
      "+f"(o[9][0]), "+f"(o[9][1]), "+f"(o[9][2]), "+f"(o[9][3]),
      "+f"(o[10][0]), "+f"(o[10][1]), "+f"(o[10][2]), "+f"(o[10][3]),
      "+f"(o[11][0]), "+f"(o[11][1]), "+f"(o[11][2]), "+f"(o[11][3]),
      "+f"(o[12][0]), "+f"(o[12][1]), "+f"(o[12][2]), "+f"(o[12][3]),
      "+f"(o[13][0]), "+f"(o[13][1]), "+f"(o[13][2]), "+f"(o[13][3]),
      "+f"(o[14][0]), "+f"(o[14][1]), "+f"(o[14][2]), "+f"(o[14][3]),
      "+f"(o[15][0]), "+f"(o[15][1]), "+f"(o[15][2]), "+f"(o[15][3])
      : "r"(hi[0][0]), "r"(hi[0][1]), "r"(hi[0][2]), "r"(hi[0][3]),
      "r"(hi[1][0]), "r"(hi[1][1]), "r"(hi[1][2]), "r"(hi[1][3]),
      "r"(hi[2][0]), "r"(hi[2][1]), "r"(hi[2][2]), "r"(hi[2][3]),
      "r"(hi[3][0]), "r"(hi[3][1]), "r"(hi[3][2]), "r"(hi[3][3]),
      "r"(lo[0][0]), "r"(lo[0][1]), "r"(lo[0][2]), "r"(lo[0][3]),
      "r"(lo[1][0]), "r"(lo[1][1]), "r"(lo[1][2]), "r"(lo[1][3]),
      "r"(lo[2][0]), "r"(lo[2][1]), "r"(lo[2][2]), "r"(lo[2][3]),
      "r"(lo[3][0]), "r"(lo[3][1]), "r"(lo[3][2]), "r"(lo[3][3]),
      "l"(b[0]), "l"(b[1]), "l"(b[2]), "l"(b[3]),
      "r"(zero));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most `pending` committed wgmma groups are in flight
template <int pending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(pending) : "memory");
}

// the registers a wgmma reads or writes, held in place across its wait
template <int N>
__device__ __forceinline__ void pin(float (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(x[i][e])::"memory");
}

// 2^x by the MUFU's ex2.approx (relative error about 2^-22, as exp2f's 2
// ulp) for results above 2^-126; smaller ones flush to 0, which no softmax
// sum of terms up to 1 can tell from them
__device__ __forceinline__ float exp2_mufu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// p (f32, in [0, 1]) as the sum of two bf16 A-fragment values, hi = p
// rounded to bf16 and lo = the rest (exact in f32) rounded to bf16: P V
// then carries ~16 of p's bits, not 8.  Rounding p itself to bf16 (the TPU
// kernel's p.astype(v.dtype)) put the kernel's P V error on top of the
// plain version's p / l rounding, past the 1e-2 per-row limit at small
// head dims (PERF.md section 6).
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - __low2float(h), b - __high2float(h));
}

// Stage kBQ (= kBK) rows of one head into the tiled `dst` with the kN
// threads t = 0 .. kN - 1: rows at or past `rows` as 0.  `src` points at
// the first row's head; rows are `row_stride` elements apart.  16-byte
// cp.async when p.vec (columns past d were zeroed once); else plain loads,
// columns past d written as 0.
template <int kN>
__device__ __forceinline__ void stage_bf16(const Params& p, const bf16* src, int64_t row_stride,
                                           int rows, bf16* dst, int t) {
  if (p.vec && p.d == kMaxD) {
    // chunk n·kN + t is row 8 g + t % 8, columns 8 c.. with g·16 + c =
    // chunk / 8: the tiled layout stores chunks in this order, and a thread
    // keeps its column c, stepping kN / 16 rows per chunk
    constexpr int kPer = kMaxD / 8, kStep = kN / kPer;
    const int c = (t / 8) % kPer, r0 = (t / 8) / kPer * 8 + t % 8;
    const bf16* from = src + r0 * row_stride + 8 * c;
#pragma unroll
    for (int n = 0; n < kBQ * kPer / kN; ++n) {
      const bool ok = r0 + n * kStep < rows;
      async_copy::copy16(dst + 8 * (n * kN + t), ok ? from : src, ok);
      from += kStep * row_stride;
    }
  } else if (p.vec) {
    // chunk (8 g + t % 8, c): row group g, columns 8 c .. 8 c + 7
    const int per_row = p.d / 8, dg = (kN / 8) / per_row, dc = (kN / 8) % per_row;
    const int rl = t % 8;
    int g = (t / 8) / per_row, c = (t / 8) % per_row;
    while (g < kBQ / 8) {
      const int r = 8 * g + rl;
      const bool ok = r < rows;
      async_copy::copy16(dst + tiled(r, 8 * c), ok ? src + r * row_stride + 8 * c : src, ok);
      g += dg;
      c += dc;
      if (c >= per_row) {
        c -= per_row;
        ++g;
      }
    }
  } else {
    for (int idx = t; idx < kBQ * kMaxD; idx += kN) {
      const int r = idx / kMaxD, c = idx % kMaxD;
      dst[tiled(r, c)] = (r < rows && c < p.d) ? src[r * row_stride + c] : __float2bfloat16_rn(0.0f);
    }
  }
}

// kHeads warpgroups, one per query head of a group of kHeads heads that
// share a KV head: each K/V tile is loaded once for all of them.
template <int kHeads>
__global__ void __launch_bounds__(kThreads * kHeads, 2 / kHeads) flash_attention_bf16(Params p) {
  extern __shared__ float4 smem4[];
  constexpr int kN = kThreads * kHeads;        // threads of the block
  constexpr int kTile = kBK * kMaxD;           // elements of a tile
  constexpr uint32_t kGroup = kMaxD / 8 * 128; // bytes between 8-row groups
  const int wg = threadIdx.x / kThreads, t = threadIdx.x % kThreads;
  bf16* q_s = reinterpret_cast<bf16*>(smem4) + wg * kTile;  // kBQ x kMaxD each
  bf16* k_s = reinterpret_cast<bf16*>(smem4) + kHeads * kTile;  // kStages x kBK x kMaxD
  bf16* v_s = k_s + kStages * kTile;           // kStages stages of kBK x kMaxD

  const int hg = p.n_heads / kHeads;           // head groups per sequence
  const int b = blockIdx.x / hg, h = blockIdx.x % hg * kHeads + wg;
  const int kh = h / p.group;
  const int num_q = (p.s_len + kBQ - 1) / kBQ;
  const int i = num_q - 1 - static_cast<int>(blockIdx.y);  // longest first
  const int warp = t / 32, lane = t % 32;
  const int g = lane / 4, c2 = 2 * (lane % 4);  // accumulator row, columns
  const int q0 = i * kBQ + warp * 16 + g;      // this thread's rows: q0, q0 + 8

  if (p.vec && p.d != kMaxD) {                 // the padded columns: 0
    for (int idx = threadIdx.x; idx < (kHeads + 2 * kStages) * kTile / 8; idx += kN)
      smem4[idx] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
  }

  const bf16* q = static_cast<const bf16*>(p.q);
  const bf16* k = static_cast<const bf16*>(p.k);
  const bf16* v = static_cast<const bf16*>(p.v);
  const int64_t q_row = static_cast<int64_t>(p.n_heads) * p.d;
  const int64_t kv_row = static_cast<int64_t>(p.n_kv) * p.d;
  int j_lo, j_hi;
  kv_bounds(p, i, j_lo, j_hi);
  float o[kMaxD / 8][4];                       // O, 16 rows x kMaxD per warp
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};  // rows g, g + 8
#pragma unroll
  for (int dt = 0; dt < kMaxD / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.0f;

  // tile j into its stage, one commit group per tile (an empty group past
  // j_hi keeps the count uniform)
  auto stage_kv = [&](int j) {
    if (j <= j_hi) {
      const int64_t off = (static_cast<int64_t>(b) * p.t_len + j * kBK) * kv_row +
                          static_cast<int64_t>(kh) * p.d;
      const int slot = (j - j_lo) % kStages;
      stage_bf16<kN>(p, k + off, kv_row, p.t_len - j * kBK, k_s + slot * kTile, threadIdx.x);
      stage_bf16<kN>(p, v + off, kv_row, p.t_len - j * kBK, v_s + slot * kTile,  // V past T: 0
                     threadIdx.x);
    }
    async_copy::commit();
  };
  auto published = [&]() {                     // this thread's copies landed, seen by all
    async_copy::fence_async_proxy();           // ... and by wgmma
    __syncthreads();
  };

  // The wgmma operands' descriptors: Q's per k-step (K-major, 8 x 8 blocks
  // 128 bytes apart along K, kGroup apart along M); a stage's K per k-step
  // (the same layout), and its V per 16 keys (MN-major: kGroup apart along
  // K, 128 bytes apart along N).  All are computed before a batch.
  uint64_t dq[kMaxD / 16], dk[kMaxD / 16], dv[kBK / 16];
#pragma unroll
  for (int kk = 0; kk < kMaxD / 16; ++kk) dq[kk] = smem_desc(q_s + 128 * kk, 128, kGroup);
  auto descriptors = [&](int j_k, int j_v) {
    const bf16* ks = k_s + (j_k - j_lo) % kStages * kTile;
    const bf16* vs = v_s + (j_v - j_lo) % kStages * kTile;
#pragma unroll
    for (int kk = 0; kk < kMaxD / 16; ++kk) dk[kk] = smem_desc(ks + 128 * kk, 128, kGroup);
#pragma unroll
    for (int kt = 0; kt < kBK / 16; ++kt)
      dv[kt] = smem_desc(vs + 2 * kt * (kMaxD / 8) * 64, kGroup, 128);
  };
  const int zero = 0;

  // the online softmax of tile j's scores, in place: scale, softcap and
  // masks (only where the tile crosses one), the running max and sum per row
  // over the 4 lanes of its quad; S becomes P, and alpha the factor O is to
  // be scaled by
  auto softmax = [&](int j, float (&s)[kBK / 8][4], float (&alpha)[2]) {
    const int k0 = j * kBK;
    const bool full = k0 + kBK <= p.t_len && (!p.causal || k0 + kBK - 1 <= i * kBQ) &&
                      (p.window <= 0 || k0 > i * kBQ + kBQ - 1 - p.window);
    uint32_t allowed = 0xffffffffu;            // bit 4 nt + e
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = capped(p, s[nt][e]);
        if (!full && !visible(p, k0 + 8 * nt + c2 + (e & 1), q0 + 8 * (e >> 1))) {
          allowed &= ~(1u << (4 * nt + e));
          s[nt][e] = kNegInf;
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    // exp(x - m) as 2^(x log2(e) - m log2(e)): one FFMA and the MUFU's
    // ex2, where expf spends a range reduction of several instructions
    float sum[2] = {0.0f, 0.0f}, m2[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2_mufu((m[r] - m_new) * kLog2e);  // 1 while both are NEG_INF
      m2[r] = m_new * kLog2e;                      // used only where m_new is finite
      m[r] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a row with nothing visible yet has m == NEG_INF: re-mask
        s[nt][e] = (allowed >> (4 * nt + e)) & 1u
                       ? exp2_mufu(fmaf(s[nt][e], kLog2e, -m2[e >> 1]))
                       : 0.0f;
        sum[e >> 1] += s[nt][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = fmaf(l[r], alpha[r], sum[r]);
    }
  };
  // P's accumulator fragments of keys 16 kt.. as the A-fragments (hi, lo)
  // of P V
  uint32_t hi[kBK / 16][4], lo[kBK / 16][4];
  auto to_a = [&](const float (&s)[kBK / 8][4]) {
#pragma unroll
    for (int kt = 0; kt < kBK / 16; ++kt) {
      split_bf16(s[2 * kt][0], s[2 * kt][1], hi[kt][0], lo[kt][0]);
      split_bf16(s[2 * kt][2], s[2 * kt][3], hi[kt][1], lo[kt][1]);
      split_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1], hi[kt][2], lo[kt][2]);
      split_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3], hi[kt][3], lo[kt][3]);
    }
  };
  auto rescale = [&](const float (&alpha)[2]) {
#pragma unroll
    for (int dt = 0; dt < kMaxD / 8; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }
  };

  // The walk: tile j's QK is issued with tile j - 1's P V, and tile j's
  // softmax runs while the tensor cores do that P V; P V's A-fragments are
  // rewritten only once it is done (a register a pending wgmma reads,
  // written meanwhile, makes ptxas serialize the wgmmas).  While tile j's K
  // and tile j - 1's V are read, tiles j + 1 .. j + kStages - 2 load.
  stage_bf16<kThreads>(p, q + (static_cast<int64_t>(b) * p.s_len + i * kBQ) * q_row +
                              static_cast<int64_t>(h) * p.d,
                       q_row, p.s_len - i * kBQ, q_s, t);
#pragma unroll
  for (int u = 0; u < kStages - 1; ++u) stage_kv(j_lo + u);
  async_copy::wait<kStages - 2>();
  published();
  float s[kBK / 8][4], alpha[2];
  descriptors(j_lo, j_lo);
  wgmma_fence();
  wgmma_qk(s, dq, dk, zero);
  wgmma_commit();
  wgmma_wait<0>();
  pin(s);
  softmax(j_lo, s, alpha);                     // O is 0: nothing to rescale
  to_a(s);
  for (int j = j_lo + 1; j <= j_hi; ++j) {
    async_copy::wait<kStages - 3>();
    published();                               // tile j landed; tile j - 2 consumed
    stage_kv(j + kStages - 2);                 // into tile j - 2's stage
    descriptors(j, j - 1);
    wgmma_fence();
    wgmma_qk(s, dq, dk, zero);
    wgmma_commit();
    wgmma_pv(o, hi, lo, dv, zero);
    wgmma_commit();
    wgmma_wait<1>();                           // S of tile j
    pin(s);
    softmax(j, s, alpha);
    wgmma_wait<0>();                           // O of tiles .. j - 1
    pin(o);
    rescale(alpha);
    to_a(s);
  }
  descriptors(j_hi, j_hi);
  wgmma_fence();
  wgmma_pv(o, hi, lo, dv, zero);
  wgmma_commit();
  wgmma_wait<0>();
  pin(o);

  bf16* out = static_cast<bf16*>(p.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s_row = q0 + 8 * r;
    if (s_row >= p.s_len) continue;
    const int64_t at = (static_cast<int64_t>(b) * p.s_len + s_row) * q_row +
                       static_cast<int64_t>(h) * p.d;
    bf16* orow = out + at;
    float* o32row = p.out32 + at;              // used only where out32 is set
    const float denom = fmaxf(l[r], 1e-37f);
#pragma unroll
    for (int dt = 0; dt < kMaxD / 8; ++dt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * dt + c2 + e;
        if (c < p.d) {
          const float val = __fdiv_rn(o[dt][2 * r + e], denom);
          orow[c] = __float2bfloat16_rn(val);
          if (p.out32 != nullptr) o32row[c] = val;
        }
      }
    if (p.lse != nullptr && lane % 4 == 0)   // the quad's lanes hold the same m, l
      p.lse[(static_cast<int64_t>(b) * p.n_heads + h) * p.s_len + s_row] = row_lse(m[r], l[r]);
  }
}

// ---------------------------------------------------------------------------
// f32: ALUs
// ---------------------------------------------------------------------------
// Stage kBQ (= kBK) rows of one head into `dst` (row stride `stride`
// floats, columns [0, dp)): rows at or past `rows` and columns at or past
// d are written as 0.  `src` points at the first row's head; rows are
// `row_stride` elements apart.
__device__ __forceinline__ void load_tile_f32(const Params& p, const float* src,
                                              int64_t row_stride, int rows, float* dst,
                                              int stride) {
  if (p.vec) {                                // d % 4 == 0, so dp == d
    const int per_row = p.d / 4;
    for (int idx = threadIdx.x; idx < kBQ * per_row; idx += kThreads) {
      const int r = idx / per_row, c = (idx % per_row) * 4;
      float* o = dst + r * stride + c;
      if (r >= rows) {
        *reinterpret_cast<float4*>(o) = make_float4(0.f, 0.f, 0.f, 0.f);
        continue;
      }
      union { uint4 u; float e[4]; } chunk;
      chunk.u = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
      *reinterpret_cast<float4*>(o) = make_float4(chunk.e[0], chunk.e[1], chunk.e[2], chunk.e[3]);
    }
  } else {
    for (int idx = threadIdx.x; idx < kBQ * p.dp; idx += kThreads) {
      const int r = idx / p.dp, c = idx % p.dp;
      dst[r * stride + c] = (r < rows && c < p.d) ? src[r * row_stride + c] : 0.0f;
    }
  }
}

__global__ void __launch_bounds__(kThreads) flash_attention_f32(Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int dp = p.dp, qs = dp + 4;           // q / K tile row stride
  float* q_s = smem;                          // kBQ x qs
  float* k_s = q_s + kBQ * qs;                // kBK x qs; then P, kBQ x kPS
  float* v_s = k_s + max(kBK * qs, kBQ * kPS);  // kBK x dp

  const int bh = blockIdx.x;                  // b * H + h
  const int b = bh / p.n_heads, h = bh % p.n_heads;
  const int kh = h / p.group;
  const int num_q = (p.s_len + kBQ - 1) / kBQ;
  const int num_kv = (p.t_len + kBK - 1) / kBK;
  const int i = num_q - 1 - static_cast<int>(blockIdx.y);  // longest first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = lane / 8, cg = lane % 8;
  const int row0 = warp * 16 + rg;            // rows row0 + 4 * rr

  const float* q = static_cast<const float*>(p.q);
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);
  const int64_t q_row = static_cast<int64_t>(p.n_heads) * p.d;
  const int64_t kv_row = static_cast<int64_t>(p.n_kv) * p.d;
  load_tile_f32(p, q + (static_cast<int64_t>(b) * p.s_len + i * kBQ) * q_row +
                       static_cast<int64_t>(h) * p.d,
                q_row, p.s_len - i * kBQ, q_s, qs);

  // the q tile's KV tiles, as _kv_block_bounds computes them
  int j_lo = 0, j_hi = num_kv - 1;
  if (p.window > 0) j_lo = min(max(i * kBQ - (p.window - 1), 0) / kBK, num_kv - 1);
  if (p.causal) j_hi = min(((i + 1) * kBQ - 1) / kBK, num_kv - 1);

  float acc[4][16], m[4], l[4];
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.0f;
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[rr][e] = 0.0f;
  }

  for (int j = j_lo; j <= j_hi; ++j) {
    __syncthreads();                          // the last tile is consumed
    const int64_t kv_off = (static_cast<int64_t>(b) * p.t_len + j * kBK) * kv_row +
                           static_cast<int64_t>(kh) * p.d;
    const int kv_rows = p.t_len - j * kBK;    // V rows past T: 0
    load_tile_f32(p, k + kv_off, kv_row, kv_rows, k_s, qs);
    load_tile_f32(p, v + kv_off, kv_row, kv_rows, v_s, dp);
    __syncthreads();

    // S = Q K^T: rows row0 + 4 rr, columns cg + 8 cc
    float sc[4][8];
#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) sc[rr][cc] = 0.0f;
    for (int e = 0; e < dp; e += 4) {
      float4 qv[4];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
        qv[rr] = *reinterpret_cast<const float4*>(q_s + (row0 + 4 * rr) * qs + e);
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        const float4 kv = *reinterpret_cast<const float4*>(k_s + (cg + 8 * cc) * qs + e);
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          float s = sc[rr][cc];
          s = fmaf(qv[rr].x, kv.x, s);
          s = fmaf(qv[rr].y, kv.y, s);
          s = fmaf(qv[rr].z, kv.z, s);
          s = fmaf(qv[rr].w, kv.w, s);
          sc[rr][cc] = s;
        }
      }
    }

    // scale, softcap and masks; then the online softmax, one row at a time
    // over the 8 lanes of its row group
    uint32_t allowed = 0;
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const int q_pos = i * kBQ + row0 + 4 * rr;
      float mx = kNegInf;
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        const int k_pos = j * kBK + cg + 8 * cc;
        float s = __fmul_rn(sc[rr][cc], p.scale);
        if (p.softcap > 0.0f) s = __fmul_rn(p.softcap, tanhf(__fdiv_rn(s, p.softcap)));
        const bool ok = k_pos < p.t_len && (!p.causal || k_pos <= q_pos) &&
                        (p.window <= 0 || k_pos > q_pos - p.window);
        allowed |= static_cast<uint32_t>(ok) << (rr * 8 + cc);
        sc[rr][cc] = ok ? s : kNegInf;
        mx = fmaxf(mx, sc[rr][cc]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[rr], mx);
      const float alpha = expf(m[rr] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        // a row with nothing visible yet has m_new == NEG_INF: re-mask
        const float e = (allowed >> (rr * 8 + cc)) & 1u ? expf(sc[rr][cc] - m_new) : 0.0f;
        sum += e;
        sc[rr][cc] = e;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[rr] = fmaf(l[rr], alpha, sum);
      m[rr] = m_new;
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[rr][e] *= alpha;
    }

    __syncthreads();                          // every warp is done with K
    float* p_s = k_s;
#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) p_s[(row0 + 4 * rr) * kPS + cg + 8 * cc] = sc[rr][cc];
    __syncwarp();                             // a warp reads its own rows only

    // acc += P V: rows row0 + 4 rr, columns 4 cg + 32 jj + (0..3)
    for (int t = 0; t < kBK; t += 4) {
      float4 pv[4];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
        pv[rr] = *reinterpret_cast<const float4*>(p_s + (row0 + 4 * rr) * kPS + t);
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int c = 4 * cg + 32 * jj;
          if (c >= dp) continue;
          const float4 vv = *reinterpret_cast<const float4*>(v_s + (t + tt) * dp + c);
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) {
            const float pr = tt == 0 ? pv[rr].x : tt == 1 ? pv[rr].y
                           : tt == 2 ? pv[rr].z : pv[rr].w;
            acc[rr][4 * jj + 0] = fmaf(pr, vv.x, acc[rr][4 * jj + 0]);
            acc[rr][4 * jj + 1] = fmaf(pr, vv.y, acc[rr][4 * jj + 1]);
            acc[rr][4 * jj + 2] = fmaf(pr, vv.z, acc[rr][4 * jj + 2]);
            acc[rr][4 * jj + 3] = fmaf(pr, vv.w, acc[rr][4 * jj + 3]);
          }
        }
      }
    }
  }

  float* out = static_cast<float*>(p.out);
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const int s = i * kBQ + row0 + 4 * rr;
    if (s >= p.s_len) continue;
    float* o = out + (static_cast<int64_t>(b) * p.s_len + s) * q_row +
               static_cast<int64_t>(h) * p.d;
    const float denom = fmaxf(l[rr], 1e-37f);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * cg + 32 * jj + e;
        if (c < p.d) o[c] = __fdiv_rn(acc[rr][4 * jj + e], denom);
      }
    if (p.lse != nullptr && cg == 0)          // the row group's lanes hold the same m, l
      p.lse[(static_cast<int64_t>(b) * p.n_heads + h) * p.s_len + s] = row_lse(m[rr], l[rr]);
  }
}

template <typename Kernel>
int launch(Kernel kernel, const Params& p, size_t smem, size_t& opted_in, int batch,
           cudaStream_t stream, int heads_per_block = 1) {
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = smem;
  }
  const int num_q = (p.s_len + kBQ - 1) / kBQ;
  if (num_q > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(batch * p.n_heads / heads_per_block, num_q);
  kernel<<<grid, kThreads * heads_per_block, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

// bf16: q, k, v and out are bf16 (else f32).  window <= 0 and softcap <= 0:
// none.  causal != 0: key t is visible to query s only if t <= s.  lse: null,
// or (B, H, S) f32 to receive each row's log-sum-exp (+inf where the row sees
// no key), which the backward reads; out is the same with or without it.
// out32: null, or with bf16 (B, S, H, D) f32 to receive out before its
// rounding to bf16 (the backward's rowsum(dO * O) takes it).
extern "C" int launch_flash_attention(const void* q, const void* k, const void* v,
                                      void* out, float* lse, float* out32, int batch,
                                      int s_len, int t_len,
                                      int n_heads, int n_kv, int d, int causal,
                                      int window, float scale, float softcap,
                                      int bf16_io, int device, cudaStream_t stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (d < 1 || d > kMaxD || s_len < 0 || t_len < 1 || n_kv < 1 || n_heads % n_kv != 0 ||
      batch < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || s_len == 0) return 0;
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.lse = lse;
  p.out32 = bf16_io ? out32 : nullptr;
  p.s_len = s_len;
  p.t_len = t_len;
  p.n_heads = n_heads;
  p.n_kv = n_kv;
  p.d = d;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.softcap = softcap;
  p.group = n_heads / n_kv;
  const bool ptrs16 = aligned16(q) && aligned16(k) && aligned16(v);
  if (bf16_io) {                              // head dim zero-padded to 128
    p.vec = d % 8 == 0 && ptrs16;
    if (p.group % 2 == 0) {                   // two query heads share each tile
      static size_t opted_in = 48 * 1024;
      const size_t smem = sizeof(bf16) * (2 + 2 * kStages) * kBQ * kMaxD;
      return launch(flash_attention_bf16<2>, p, smem, opted_in, batch, stream, 2);
    }
    static size_t opted_in = 48 * 1024;
    const size_t smem = sizeof(bf16) * (1 + 2 * kStages) * kBQ * kMaxD;
    return launch(flash_attention_bf16<1>, p, smem, opted_in, batch, stream);
  }
  static size_t opted_in = 48 * 1024;
  p.dp = (d + 3) / 4 * 4;
  p.vec = d % 4 == 0 && ptrs16;
  const int qs = p.dp + 4;
  const size_t smem = sizeof(float) * (static_cast<size_t>(kBQ) * qs +
                                       std::max(kBK * qs, kBQ * kPS) + kBK * p.dp);
  return launch(flash_attention_f32, p, smem, opted_in, batch, stream);
}
