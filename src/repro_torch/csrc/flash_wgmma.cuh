// The wgmma building blocks K5's bf16 kernels share: the forward
// (flash_attention.cu) and its backward (flash_attention_bwd.cu).  Tiles of
// kMaxD columns sit in shared memory in wgmma's 8 x 8-block interleave
// layout; products of 64 rows are issued by one warpgroup.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "flash_common.cuh"

namespace flash {

using bf16 = __nv_bfloat16;

constexpr int kMaxD = 128;                    // the head dim, zero-padded
constexpr float kLog2e = 1.4426950408889634f;

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

// O (64 x 128) += A (64 x 64, registers: 4 k-steps, one bf16 term) .
// B (64 x 128, shared memory, MN-major, descriptor b per k-step): wgmma_pv
// with the operand rounded once.  fresh != 0: O = A B, O's old values
// unread, so a walk's first product needs no zeroed accumulator
__device__ __forceinline__ void wgmma_av(float (&o)[16][4], const uint32_t (&a)[4][4],
                                          const uint64_t (&b)[4], int fresh) {
  asm volatile(
    "{\n.reg .pred p0, p1;\nsetp.eq.b32 p0, %84, 0;\nsetp.eq.b32 p1, %84, %84;\n"
    "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, "
    "%4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
    "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
    "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
    "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
    "%61, %62, %63}, {%64, %65, %66, %67}, %80, p0, 1, 1, 1;\n"
    "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, "
    "%4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
    "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
    "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
    "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
    "%61, %62, %63}, {%68, %69, %70, %71}, %81, p1, 1, 1, 1;\n"
    "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, "
    "%4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
    "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
    "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
    "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
    "%61, %62, %63}, {%72, %73, %74, %75}, %82, p1, 1, 1, 1;\n"
    "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, "
    "%4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
    "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
    "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
    "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
    "%61, %62, %63}, {%76, %77, %78, %79}, %83, p1, 1, 1, 1;\n"
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
      : "r"(a[0][0]), "r"(a[0][1]), "r"(a[0][2]), "r"(a[0][3]),
      "r"(a[1][0]), "r"(a[1][1]), "r"(a[1][2]), "r"(a[1][3]),
      "r"(a[2][0]), "r"(a[2][1]), "r"(a[2][2]), "r"(a[2][3]),
      "r"(a[3][0]), "r"(a[3][1]), "r"(a[3][2]), "r"(a[3][3]),
      "l"(b[0]), "l"(b[1]), "l"(b[2]), "l"(b[3]),
      "r"(fresh));
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
template <int kN, typename Params>
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

}  // namespace flash
