// The backward of block-sparse flash attention (K5) for sm_90a.
//
// Replaces: no TPU kernel.  The JAX package differentiates its attention by
//           autodiff of the blockwise jnp path; the port's K5 forward
//           (flash_attention.cu) writes its output through a raw pointer, so
//           autograd needs this kernel to take gradients through it.
// Computes: dQ, dK and dV of out = softmax(cap(q . K^T * scale)) . V as K5
//           computes it (flash_common.cuh: the same tiles, masks and scores),
//           given dO, q (B, S, H, D), k and v (B, T, KH, D), K5's output O
//           in f32 (in bf16 the forward's values before their rounding:
//           rowsum(dO * O) of the rounded O cancels to a few percent of
//           dQ) and the row log-sum-exps lse (B, H, S) its forward wrote:
//             P = exp(s - lse) on the visible keys (0 elsewhere, and for a
//                 row that sees no key, whose lse is +inf),
//             D_i = rowsum(dO_i * O_i),  dS = P * (dO . V^T - D),
//             dA = dS * (1 - tanh^2(s0 / cap)) * scale (the softcap's
//                 derivative; dS * scale without one),
//             dQ = dA K, dK = dA^T Q and dV = P^T dO, the last two summed in
//             f32 over the g = H / KH query heads of each KV head.
//           q, k, v, dO and the gradients are all f32 or all bf16, with
//           D <= 128; every sum is in f32.
// Bound:    operations.  Each visible (q, k) pair and head needs 10 D flops
//           (QK, dO V^T, P^T dO, dA^T Q, dA K); at qwen2.5-3b's training
//           shape (S = T = 4096, D = 128) that is ~1,300 flops per byte of
//           q, k, v, O, dO and the gradients, far above the card's ~295 bf16
//           tensor-core flops per byte.  Both designs recompute S and
//           dO V^T in each of their two walks: 14 D flops a pair.
// Design:   three passes, no atomics, so two runs give the same bits:
//   delta:  D_i, one warp a row (both dtypes).
//   bf16:   the products on the tensor cores by wgmma (flash_wgmma.cuh,
//           the forward's helpers: tiles as bf16 in the 8 x 8-block layout,
//           head dim zero-padded to 128, cp.async).  A block is one
//           warpgroup (128 threads, 16 accumulator rows a warp).
//     dK dV: KV-stationary.  A block owns 64 keys of one KV head and ONE
//           query head h of its group (the g heads of a group are split
//           over blocks: the causal walks run 1 to S / 64 q tiles, and a
//           block holding all g heads would leave B KH T / 64 blocks with
//           walks up to g S / 64).  Its K and V tiles stay in shared memory;
//           it walks the q tiles whose forward walk visits its KV tile,
//           [i_lo, i_hi] by q_tile_bounds (the inverse of kv_tile_bounds),
//           Q, dO and their rows' lse and D streaming through two cp.async
//           stages.  Per q tile: S^T = K Q^T and dP^T = V dO^T (m64n64k16,
//           both operands K-major in shared memory, two commit groups, so
//           P^T's exp runs while dP^T is on the tensor cores), P^T and dA^T
//           in f32 on the accumulator registers, repacked as bf16
//           A-fragments (rounded once), then dV += P^T dO and dK += dA^T Q
//           (m64n128k16, dO and Q read MN-major from the same tiles; the
//           first tile's products write the accumulators, a walk that
//           visits no q tile writes zeros and leaves).
//           With g = 1 the block writes dK and dV in bf16; else it writes
//           its head's share in f32 to scratch (B, T, H, D) each, and
//           attention_bwd_dkdv_sum adds the g shares in head order and
//           rounds them to bf16.  Blocks run the longest walks first (low
//           KV tiles when causal, high ones when not).
//     dQ:   Q-stationary, the forward's own structure: a block owns a 64-row
//           q tile of one head, its Q, dO, lse and D resident, and walks
//           the forward's KV tiles (kv_tile_bounds) with K and V in two
//           cp.async stages: S = Q K^T and dP = dO V^T (m64n64k16), dA in
//           f32 on the registers, repacked as bf16 A-fragments, dQ += dA K
//           (m64n128k16, K read MN-major).  Longest walks first.
//           Shared memory: 97 KB (dK dV: K, V, two stages of Q and dO) and
//           96 KB (dQ: Q, dO, two stages of K and V) a block, so two blocks
//           share an SM; registers: dK dV holds two 64 x 128 f32
//           accumulators (128 a thread) beside S^T and dP^T (64), ~246 of
//           255.  With those accumulators zeroed before the walk and an
//           empty walk falling through to the stores, ptxas serialized
//           every wgmma of the kernel (C7515); routing P^T and dA^T through
//           shared memory instead of registers was slower (PERF.md section
//           6).
//   f32:    the products stay on the f32 ALUs (full f32, no TF32: phase 5's
//           limit forbids it), tiles staged as f32 in shared memory.
//     dK dV: a block of 256 threads owns 32 keys of one KV head and walks
//           the g query heads and, for each, the q tiles whose forward walk
//           visits these keys; for each it stages Q and dO, recomputes S
//           and dO V^T (each thread 2 q rows x 4 keys), writes P^T and dA^T
//           to shared memory and accumulates dV += P^T dO and dK += dA^T Q
//           in registers (1 key x 16 columns each).
//     dQ:   a block of 256 threads owns one 64-row q tile of one head, its
//           Q and dO resident, walks the forward's KV tiles, recomputes S,
//           P and dA as above, writes dA to shared memory and accumulates
//           dQ += dA K in registers.  ~120 KB (dK dV) and ~155 KB (dQ) of
//           shared memory at D = 128: one block per SM.
//           Measured times: PERF.md section 6 (chip_smoke.py phase 6).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "flash_common.cuh"
#include "flash_wgmma.cuh"

namespace {

using flash::bf16;
using flash::kBK;
using flash::kBQ;
using flash::kMaxD;

constexpr int kThreads = 256;                 // f32: 8 warps, 8 q rows of a tile each
constexpr int kKV = 32;                       // f32 dK dV: keys a block
constexpr int kTS = kBQ + 4;                  // f32: row stride of the P / dA tiles
constexpr int kWG = 128;                      // bf16: one warpgroup a block
constexpr int kStages = 2;                    // bf16: stages of the streamed tiles
constexpr int kTile = kBQ * kMaxD;            // bf16: elements of a tile (kBQ == kBK)
constexpr uint32_t kGroup = kMaxD / 8 * 128;  // bytes between 8-row groups of a tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* o;                             // f32: K5's output before any rounding
  const void* dout;
  const float* lse;                           // (B, H, S)
  float* delta;                               // (B, H, S), the delta pass's output
  float* dk_part;                             // bf16 with g > 1: (B, T, H, D) f32 shares
  float* dv_part;
  void* dq;
  void* dk;
  void* dv;
  int s_len, t_len, n_heads, n_kv, d;
  int dp;                                     // f32: d padded to 4
  int group;                                  // H / KH
  int causal, window;                         // window <= 0: none
  float scale, softcap;                       // softcap <= 0: none
  int vec;                                    // bf16: 16-byte cp.async loads
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// D[b, h, s] = sum_c dO[b, s, h, c] O[b, s, h, c] in f32: warp r takes row r
// of the (B, S, H) rows, in memory order
template <typename T>
__global__ void __launch_bounds__(kThreads) attention_bwd_delta(Params p, int rows) {
  const int row = (blockIdx.x * kThreads + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* o = p.o + static_cast<int64_t>(row) * p.d;
  const T* g = static_cast<const T*>(p.dout) + static_cast<int64_t>(row) * p.d;
  float acc = 0.0f;
  for (int c = lane; c < p.d; c += 32) acc = fmaf(to_f32(g[c]), o[c], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = row % p.n_heads, bs = row / p.n_heads;
    const int b = bs / p.s_len, s = bs % p.s_len;
    p.delta[(static_cast<int64_t>(b) * p.n_heads + h) * p.s_len + s] = acc;
  }
}

// ---------------------------------------------------------------------------
// f32: ALUs
// ---------------------------------------------------------------------------
// Stage `tile` rows of one head into `dst` (row stride `stride`, columns
// [0, dp)): rows at or past `rows` and columns at or past d as 0.  `src`
// points at the first row's head; rows are `row_stride` elements apart.
__device__ __forceinline__ void load_tile(const Params& p, const float* src, int64_t row_stride,
                                          int rows, int tile, float* dst, int stride) {
  for (int idx = threadIdx.x; idx < tile * p.dp; idx += kThreads) {
    const int r = idx / p.dp, c = idx % p.dp;
    dst[r * stride + c] = (r < rows && c < p.d) ? src[r * row_stride + c] : 0.0f;
  }
}

// out[rr][cc] = row (r0 + 4 rr) of a_s . row (cg + 8 cc) of b_s over dp
// columns: the thread's RR x CC block of a product A B^T
template <int RR, int CC>
__device__ __forceinline__ void dots(const float* a_s, const float* b_s, int stride, int dp,
                                     int r0, int cg, float (&out)[RR][CC]) {
#pragma unroll
  for (int rr = 0; rr < RR; ++rr)
#pragma unroll
    for (int cc = 0; cc < CC; ++cc) out[rr][cc] = 0.0f;
  for (int e = 0; e < dp; e += 4) {
    float4 av[RR];
#pragma unroll
    for (int rr = 0; rr < RR; ++rr)
      av[rr] = *reinterpret_cast<const float4*>(a_s + (r0 + 4 * rr) * stride + e);
#pragma unroll
    for (int cc = 0; cc < CC; ++cc) {
      const float4 bv = *reinterpret_cast<const float4*>(b_s + (cg + 8 * cc) * stride + e);
#pragma unroll
      for (int rr = 0; rr < RR; ++rr) {
        float s = out[rr][cc];
        s = fmaf(av[rr].x, bv.x, s);
        s = fmaf(av[rr].y, bv.y, s);
        s = fmaf(av[rr].z, bv.z, s);
        s = fmaf(av[rr].w, bv.w, s);
        out[rr][cc] = s;
      }
    }
  }
}

// acc[rr][4 jj + e] += sum_t w_s[r0 + 4 rr][t] x_s[t][4 cg + 32 jj + e] over
// t < kLen (w_s's row stride kTS): the thread's RR x 16 block of W X
template <int RR, int kLen>
__device__ __forceinline__ void accumulate(const float* w_s, const float* x_s, int stride,
                                           int dp, int r0, int cg, float (&acc)[RR][16]) {
  for (int t = 0; t < kLen; t += 4) {
    float4 wv[RR];
#pragma unroll
    for (int rr = 0; rr < RR; ++rr)
      wv[rr] = *reinterpret_cast<const float4*>(w_s + (r0 + 4 * rr) * kTS + t);
#pragma unroll
    for (int tt = 0; tt < 4; ++tt) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = 4 * cg + 32 * jj;
        if (c >= dp) continue;
        const float4 xv = *reinterpret_cast<const float4*>(x_s + (t + tt) * stride + c);
#pragma unroll
        for (int rr = 0; rr < RR; ++rr) {
          const float w = tt == 0 ? wv[rr].x : tt == 1 ? wv[rr].y : tt == 2 ? wv[rr].z : wv[rr].w;
          acc[rr][4 * jj + 0] = fmaf(w, xv.x, acc[rr][4 * jj + 0]);
          acc[rr][4 * jj + 1] = fmaf(w, xv.y, acc[rr][4 * jj + 1]);
          acc[rr][4 * jj + 2] = fmaf(w, xv.z, acc[rr][4 * jj + 2]);
          acc[rr][4 * jj + 3] = fmaf(w, xv.w, acc[rr][4 * jj + 3]);
        }
      }
    }
  }
}

// P and dA of the thread's 2 x CC (q row, key) pairs, q rows i * kBQ + r0 +
// 4 rr and keys k0 + cg + 8 cc, from the raw products S = Q K^T and dP = dO
// V^T: the forward's score and masks (rows past S are masked too), P =
// exp(s - lse), dA = P (dP - D) times the softcap's derivative and the scale
template <int CC>
__device__ __forceinline__ void probabilities(const Params& p, int i, int k0, int r0, int cg,
                                              const float* lse_s, const float* delta_s,
                                              float (&s)[2][CC], float (&dp)[2][CC]) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = r0 + 4 * rr, q_pos = i * kBQ + r;
    const float lse = lse_s[r], delta = delta_s[r];
#pragma unroll
    for (int cc = 0; cc < CC; ++cc) {
      const int k_pos = k0 + cg + 8 * cc;
      float prob = 0.0f, da = 0.0f;
      if (q_pos < p.s_len && flash::key_visible(k_pos, q_pos, p.t_len, p.causal, p.window)) {
        const float s0 = __fmul_rn(s[rr][cc], p.scale);
        float sc = s0, dcap = 1.0f;
        if (p.softcap > 0.0f) {
          const float th = tanhf(__fdiv_rn(s0, p.softcap));
          sc = __fmul_rn(p.softcap, th);
          dcap = 1.0f - th * th;
        }
        prob = expf(sc - lse);
        da = prob * (dp[rr][cc] - delta) * dcap * p.scale;
      }
      s[rr][cc] = prob;
      dp[rr][cc] = da;
    }
  }
}

// lse and D of q tile i's rows into shared memory; rows past S as +inf and
// 0, so that they add nothing
__device__ __forceinline__ void load_rows(const Params& p, int b, int h, int i, float* lse_s,
                                          float* delta_s) {
  if (threadIdx.x < kBQ) {
    const int s = i * kBQ + threadIdx.x;
    const int64_t at = (static_cast<int64_t>(b) * p.n_heads + h) * p.s_len + s;
    lse_s[threadIdx.x] = s < p.s_len ? p.lse[at] : __int_as_float(0x7f800000);
    delta_s[threadIdx.x] = s < p.s_len ? p.delta[at] : 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads) attention_bwd_dkdv_f32(Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int stride = p.dp + 4;
  float* k_s = smem;                          // kKV x stride each
  float* v_s = k_s + kKV * stride;
  float* q_s = v_s + kKV * stride;            // kBQ x stride each
  float* do_s = q_s + kBQ * stride;
  float* pt_s = do_s + kBQ * stride;          // P^T: kKV keys x kTS
  float* dat_s = pt_s + kKV * kTS;            // dA^T
  float* lse_s = dat_s + kKV * kTS;           // kBQ
  float* delta_s = lse_s + kBQ;               // kBQ

  const int b = blockIdx.x / p.n_kv, kh = blockIdx.x % p.n_kv;
  const int k0 = blockIdx.y * kKV;            // the first key of the tile
  const int jf = k0 / kBK;                    // the forward's KV tile holding it
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = lane / 8, cg = lane % 8;
  const int r0 = warp * 8 + rg;               // q rows r0, r0 + 4 of a q tile
  const int rk = warp * 4 + rg;               // this thread's key of the tile
  const int num_q = (p.s_len + kBQ - 1) / kBQ;

  const float* q = static_cast<const float*>(p.q);
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);
  const float* dout = static_cast<const float*>(p.dout);
  const int64_t q_row = static_cast<int64_t>(p.n_heads) * p.d;
  const int64_t kv_row = static_cast<int64_t>(p.n_kv) * p.d;
  const int64_t kv_off = (static_cast<int64_t>(b) * p.t_len + k0) * kv_row +
                         static_cast<int64_t>(kh) * p.d;
  load_tile(p, k + kv_off, kv_row, p.t_len - k0, kKV, k_s, stride);
  load_tile(p, v + kv_off, kv_row, p.t_len - k0, kKV, v_s, stride);

  float dk[1][16], dv[1][16];
#pragma unroll
  for (int e = 0; e < 16; ++e) dk[0][e] = dv[0][e] = 0.0f;

  for (int hh = 0; hh < p.group; ++hh) {
    const int h = kh * p.group + hh;
    for (int i = 0; i < num_q; ++i) {
      int j_lo, j_hi;                         // the forward's walk of q tile i
      flash::kv_tile_bounds(i, p.t_len, p.causal, p.window, j_lo, j_hi);
      if (jf < j_lo || jf > j_hi) continue;
      __syncthreads();                        // the last tiles are consumed
      const int64_t q_off = (static_cast<int64_t>(b) * p.s_len + i * kBQ) * q_row +
                            static_cast<int64_t>(h) * p.d;
      load_tile(p, q + q_off, q_row, p.s_len - i * kBQ, kBQ, q_s, stride);
      load_tile(p, dout + q_off, q_row, p.s_len - i * kBQ, kBQ, do_s, stride);
      load_rows(p, b, h, i, lse_s, delta_s);
      __syncthreads();
      float s[2][kKV / 8], dp[2][kKV / 8];
      dots(q_s, k_s, stride, p.dp, r0, cg, s);
      dots(do_s, v_s, stride, p.dp, r0, cg, dp);
      probabilities(p, i, k0, r0, cg, lse_s, delta_s, s, dp);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int cc = 0; cc < kKV / 8; ++cc) {
          pt_s[(cg + 8 * cc) * kTS + r0 + 4 * rr] = s[rr][cc];
          dat_s[(cg + 8 * cc) * kTS + r0 + 4 * rr] = dp[rr][cc];
        }
      __syncthreads();
      accumulate<1, kBQ>(pt_s, do_s, stride, p.dp, rk, cg, dv);
      accumulate<1, kBQ>(dat_s, q_s, stride, p.dp, rk, cg, dk);
    }
  }

  const int t = k0 + rk;
  if (t >= p.t_len) return;
  float* dk_out = static_cast<float*>(p.dk);
  float* dv_out = static_cast<float*>(p.dv);
  const int64_t at = (static_cast<int64_t>(b) * p.t_len + t) * kv_row +
                     static_cast<int64_t>(kh) * p.d;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 4 * cg + 32 * jj + e;
      if (c < p.d) {
        dk_out[at + c] = dk[0][4 * jj + e];
        dv_out[at + c] = dv[0][4 * jj + e];
      }
    }
}

__global__ void __launch_bounds__(kThreads) attention_bwd_dq_f32(Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int stride = p.dp + 4;
  float* q_s = smem;                          // 64 x stride each
  float* do_s = q_s + kBQ * stride;
  float* k_s = do_s + kBQ * stride;
  float* v_s = k_s + kBK * stride;
  float* da_s = v_s + kBK * stride;           // dA: 64 q rows x kTS
  float* lse_s = da_s + kBQ * kTS;            // 64
  float* delta_s = lse_s + kBQ;               // 64

  const int b = blockIdx.x / p.n_heads, h = blockIdx.x % p.n_heads;
  const int kh = h / p.group;
  const int num_q = (p.s_len + kBQ - 1) / kBQ;
  const int i = num_q - 1 - static_cast<int>(blockIdx.y);  // longest walks first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = lane / 8, cg = lane % 8;
  const int r0 = warp * 8 + rg;

  const float* q = static_cast<const float*>(p.q);
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);
  const float* dout = static_cast<const float*>(p.dout);
  const int64_t q_row = static_cast<int64_t>(p.n_heads) * p.d;
  const int64_t kv_row = static_cast<int64_t>(p.n_kv) * p.d;
  const int64_t q_off = (static_cast<int64_t>(b) * p.s_len + i * kBQ) * q_row +
                        static_cast<int64_t>(h) * p.d;
  load_tile(p, q + q_off, q_row, p.s_len - i * kBQ, kBQ, q_s, stride);
  load_tile(p, dout + q_off, q_row, p.s_len - i * kBQ, kBQ, do_s, stride);
  load_rows(p, b, h, i, lse_s, delta_s);

  float dq[2][16];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
#pragma unroll
    for (int e = 0; e < 16; ++e) dq[rr][e] = 0.0f;

  int j_lo, j_hi;
  flash::kv_tile_bounds(i, p.t_len, p.causal, p.window, j_lo, j_hi);
  for (int j = j_lo; j <= j_hi; ++j) {
    __syncthreads();                          // the last tiles are consumed
    const int64_t kv_off = (static_cast<int64_t>(b) * p.t_len + j * kBK) * kv_row +
                           static_cast<int64_t>(kh) * p.d;
    load_tile(p, k + kv_off, kv_row, p.t_len - j * kBK, kBK, k_s, stride);
    load_tile(p, v + kv_off, kv_row, p.t_len - j * kBK, kBK, v_s, stride);
    __syncthreads();
    float s[2][kBK / 8], dp[2][kBK / 8];
    dots(q_s, k_s, stride, p.dp, r0, cg, s);
    dots(do_s, v_s, stride, p.dp, r0, cg, dp);
    probabilities(p, i, j * kBK, r0, cg, lse_s, delta_s, s, dp);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) da_s[(r0 + 4 * rr) * kTS + cg + 8 * cc] = dp[rr][cc];
    __syncthreads();
    accumulate<2, kBK>(da_s, k_s, stride, p.dp, r0, cg, dq);
  }

  float* dq_out = static_cast<float*>(p.dq);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int s = i * kBQ + r0 + 4 * rr;
    if (s >= p.s_len) continue;
    float* row = dq_out + (static_cast<int64_t>(b) * p.s_len + s) * q_row + static_cast<int64_t>(h) * p.d;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * cg + 32 * jj + e;
        if (c < p.d) row[c] = dq[rr][4 * jj + e];
      }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma)
// ---------------------------------------------------------------------------
// One (q, key) pair from its raw products s = q . k and dp = dO . v, in
// place: s becomes P = exp(cap(s) - lse) (by the MUFU's ex2; 0 where the
// key is not visible or lse = +inf) and w = P times the softcap's
// derivative and the scale, so that dA = w (dp - D).
__device__ __forceinline__ float probability(const Params& p, bool visible, float& s,
                                             float lse) {
  float prob = 0.0f, w = 0.0f;
  if (visible) {
    const float s0 = __fmul_rn(s, p.scale);
    float sc = s0, dcap = 1.0f;
    if (p.softcap > 0.0f) {
      const float th = tanhf(__fdiv_rn(s0, p.softcap));
      sc = __fmul_rn(p.softcap, th);
      dcap = 1.0f - th * th;
    }
    prob = flash::exp2_mufu((sc - lse) * flash::kLog2e);
    w = prob * dcap * p.scale;
  }
  s = w;
  return prob;
}

// a 64 x 64 accumulator's fragments as the A-fragments of its product over
// those 64 columns (4 k-steps), each value rounded once to bf16
__device__ __forceinline__ void to_a(const float (&x)[8][4], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kt = 0; kt < 4; ++kt) {
    a[kt][0] = flash::pack_bf16(x[2 * kt][0], x[2 * kt][1]);
    a[kt][1] = flash::pack_bf16(x[2 * kt][2], x[2 * kt][3]);
    a[kt][2] = flash::pack_bf16(x[2 * kt + 1][0], x[2 * kt + 1][1]);
    a[kt][3] = flash::pack_bf16(x[2 * kt + 1][2], x[2 * kt + 1][3]);
  }
}

// descriptors of a tile in the 8 x 8-block layout: K-major per 16 columns
// (the operands of S = Q K^T and of its kind), and MN-major per 16 rows
// (the B operand of a product over the tile's rows)
__device__ __forceinline__ void k_major(const bf16* tile, uint64_t (&d)[kMaxD / 16]) {
#pragma unroll
  for (int kk = 0; kk < kMaxD / 16; ++kk) d[kk] = flash::smem_desc(tile + 128 * kk, 128, kGroup);
}
__device__ __forceinline__ void mn_major(const bf16* tile, uint64_t (&d)[kBQ / 16]) {
#pragma unroll
  for (int kt = 0; kt < kBQ / 16; ++kt)
    d[kt] = flash::smem_desc(tile + 2 * kt * (kMaxD / 8) * 64, kGroup, 128);
}

// this thread's copies landed, seen by all threads and by wgmma
__device__ __forceinline__ void published() {
  async_copy::fence_async_proxy();
  __syncthreads();
}

// the padded columns of `tiles` tiles at the start of shared memory: 0 once
// (cp.async writes only the first d)
__device__ __forceinline__ void zero_padding(const Params& p, float4* smem4, int tiles) {
  if (p.vec && p.d != kMaxD) {
    for (int idx = threadIdx.x; idx < tiles * kTile / 8; idx += kWG)
      smem4[idx] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
  }
}

// a dK dV block's output: its keys key0, key0 + 8 of head h's dK and dV
// (accumulator fragments, 64 keys x kMaxD a warpgroup); with g = 1 in bf16,
// else in f32 as head h's share
__device__ __forceinline__ void store_dkdv(const Params& p, int b, int h, int key0, int c2,
                                           const float (&dk)[kMaxD / 8][4],
                                           const float (&dv)[kMaxD / 8][4]) {
  const int64_t kv_row = static_cast<int64_t>(p.n_kv) * p.d;
  const int kh = h / p.group;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= p.t_len) continue;
    const int64_t bt = static_cast<int64_t>(b) * p.t_len + key;
    if (p.group == 1) {
      bf16* dk_row = static_cast<bf16*>(p.dk) + bt * kv_row + static_cast<int64_t>(kh) * p.d;
      bf16* dv_row = static_cast<bf16*>(p.dv) + bt * kv_row + static_cast<int64_t>(kh) * p.d;
#pragma unroll
      for (int dt = 0; dt < kMaxD / 8; ++dt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * dt + c2 + e;
          if (c < p.d) {
            dk_row[c] = __float2bfloat16_rn(dk[dt][2 * r + e]);
            dv_row[c] = __float2bfloat16_rn(dv[dt][2 * r + e]);
          }
        }
    } else {
      const int64_t at = (bt * p.n_heads + h) * p.d;
#pragma unroll
      for (int dt = 0; dt < kMaxD / 8; ++dt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * dt + c2 + e;
          if (c < p.d) {
            p.dk_part[at + c] = dk[dt][2 * r + e];
            p.dv_part[at + c] = dv[dt][2 * r + e];
          }
        }
    }
  }
}

__global__ void __launch_bounds__(kWG, 2) attention_bwd_dkdv_bf16(Params p) {
  extern __shared__ float4 smem4[];
  bf16* k_s = reinterpret_cast<bf16*>(smem4);  // resident: kBK x kMaxD each
  bf16* v_s = k_s + kTile;
  bf16* q_s = v_s + kTile;                     // kStages stages of kBQ x kMaxD each
  bf16* do_s = q_s + kStages * kTile;
  float* rows_s = reinterpret_cast<float*>(do_s + kStages * kTile);  // a stage: lse, D

  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int g = lane / 4, c2 = 2 * (lane % 4);  // accumulator row, columns
  const int b = blockIdx.x / p.n_heads, h = blockIdx.x % p.n_heads, kh = h / p.group;
  const int num_kv = (p.t_len + kBK - 1) / kBK;
  const int y = static_cast<int>(blockIdx.y);
  const int j = p.causal ? y : num_kv - 1 - y;  // longest walks first
  const int k0 = j * kBK, key0 = k0 + warp * 16 + g;  // this thread's keys: key0, key0 + 8
  int i_lo, i_hi;
  flash::q_tile_bounds(j, p.s_len, p.t_len, p.causal, p.window, i_lo, i_hi);
  if (i_lo > i_hi) {                           // no q tile sees these keys
    const float none[kMaxD / 8][4] = {};
    store_dkdv(p, b, h, key0, c2, none, none);
    return;
  }
  zero_padding(p, smem4, 2 + 2 * kStages);

  const bf16* q = static_cast<const bf16*>(p.q);
  const bf16* dout = static_cast<const bf16*>(p.dout);
  const int64_t q_row = static_cast<int64_t>(p.n_heads) * p.d;
  const int64_t kv_row = static_cast<int64_t>(p.n_kv) * p.d;
  const int64_t kv_off = (static_cast<int64_t>(b) * p.t_len + k0) * kv_row +
                         static_cast<int64_t>(kh) * p.d;
  const int64_t rows_at = (static_cast<int64_t>(b) * p.n_heads + h) * p.s_len;
  flash::stage_bf16<kWG>(p, static_cast<const bf16*>(p.k) + kv_off, kv_row, p.t_len - k0, k_s, t);
  flash::stage_bf16<kWG>(p, static_cast<const bf16*>(p.v) + kv_off, kv_row, p.t_len - k0, v_s, t);
  // q tile i into its stage with its rows' lse (threads 0..63) and D
  // (64..127), one commit group per tile (the first with K and V; an empty
  // group past i_hi keeps the count uniform)
  auto stage_q = [&](int i) {
    if (i <= i_hi) {
      const int slot = (i - i_lo) % kStages;
      const int64_t off = (static_cast<int64_t>(b) * p.s_len + i * kBQ) * q_row +
                          static_cast<int64_t>(h) * p.d;
      flash::stage_bf16<kWG>(p, q + off, q_row, p.s_len - i * kBQ, q_s + slot * kTile, t);
      flash::stage_bf16<kWG>(p, dout + off, q_row, p.s_len - i * kBQ, do_s + slot * kTile, t);
      const int s = i * kBQ + t % kBQ;         // rows past S: 0, masked below
      const float* src = (t < kBQ ? p.lse : p.delta) + rows_at;
      async_copy::copy4(rows_s + slot * 2 * kBQ + t, s < p.s_len ? src + s : src, s < p.s_len);
    }
    async_copy::commit();
  };

  uint64_t k_desc[kMaxD / 16], v_desc[kMaxD / 16];  // K and V, K-major
  k_major(k_s, k_desc);
  k_major(v_s, v_desc);
  float dk[kMaxD / 8][4], dv[kMaxD / 8][4];   // 64 keys x kMaxD a warpgroup, written
                                               // by the first tile's products (C7515:
                                               // the header)
  const int zero = 0;
  stage_q(i_lo);
  for (int i = i_lo; i <= i_hi; ++i) {
    async_copy::wait<0>();
    flash::wgmma_wait<0>();                    // tile i - 1's products, whose stage
    flash::pin(dk);                            // tile i + 1 is about to take
    flash::pin(dv);
    published();
    stage_q(i + 1);
    const int slot = (i - i_lo) % kStages;
    const bf16* qs = q_s + slot * kTile;
    const bf16* dos = do_s + slot * kTile;
    const float* lse_s = rows_s + slot * 2 * kBQ;
    const float* delta_s = lse_s + kBQ;

    // S^T = K Q^T, then dP^T = V dO^T: P^T's exp runs while dP^T does
    float st[kBQ / 8][4], dpt[kBQ / 8][4];     // 64 keys x 64 q rows
    uint64_t q_desc[kMaxD / 16], do_desc[kMaxD / 16];
    k_major(qs, q_desc);
    k_major(dos, do_desc);
    flash::wgmma_fence();
    flash::wgmma_qk(st, k_desc, q_desc, zero);
    flash::wgmma_commit();
    flash::wgmma_qk(dpt, v_desc, do_desc, zero);
    flash::wgmma_commit();
    flash::wgmma_wait<1>();
    flash::pin(st);

    const int q_base = i * kBQ;
    const bool full = q_base + kBQ <= p.s_len && k0 + kBK <= p.t_len &&
                      (!p.causal || k0 + kBK - 1 <= q_base) &&
                      (p.window <= 0 || k0 > q_base + kBQ - 1 - p.window);
    uint32_t pa[4][4], da[4][4];               // P^T and dA^T as A-fragments
#pragma unroll
    for (int nt = 0; nt < kBQ / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {            // keys key0 + 8 r, q rows qc, qc + 1
        const int qc = 8 * nt + c2;
        float pr[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = full || (q_base + qc + e < p.s_len &&
                                   flash::key_visible(key0 + 8 * r, q_base + qc + e, p.t_len,
                                                      p.causal, p.window));
          pr[e] = probability(p, ok, st[nt][2 * r + e], lse_s[qc + e]);
        }
        pa[nt / 2][nt % 2 * 2 + r] = flash::pack_bf16(pr[0], pr[1]);
      }
    flash::wgmma_wait<0>();
    flash::pin(dpt);
#pragma unroll
    for (int nt = 0; nt < kBQ / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qc = 8 * nt + c2;
        da[nt / 2][nt % 2 * 2 + r] = flash::pack_bf16(
            st[nt][2 * r] * (dpt[nt][2 * r] - delta_s[qc]),
            st[nt][2 * r + 1] * (dpt[nt][2 * r + 1] - delta_s[qc + 1]));
      }

    // dV += P^T dO, dK += dA^T Q: left running into the next tile's wait
    uint64_t do_mn[kBQ / 16], q_mn[kBQ / 16];
    mn_major(dos, do_mn);
    mn_major(qs, q_mn);
    flash::wgmma_fence();
    flash::wgmma_av(dv, pa, do_mn, i == i_lo);
    flash::wgmma_av(dk, da, q_mn, i == i_lo);
    flash::wgmma_commit();
  }
  flash::wgmma_wait<0>();
  flash::pin(dk);
  flash::pin(dv);
  store_dkdv(p, b, h, key0, c2, dk, dv);
}

// dK and dV (B, T, KH, D) in bf16 from the g heads' f32 shares (B, T, H,
// D), added in head order: element n = (row, c), row = (b T + t) KH + kh,
// whose shares are rows row g .. row g + g - 1 of the (B T H, D) scratch
__global__ void __launch_bounds__(256) attention_bwd_dkdv_sum(Params p, int64_t n) {
  for (int64_t idx = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x; idx < n;
       idx += static_cast<int64_t>(gridDim.x) * 256) {
    const int64_t row = idx / p.d, c = idx % p.d;
    const int64_t at = row * p.group * p.d + c;
    float sk = 0.0f, sv = 0.0f;
    for (int hh = 0; hh < p.group; ++hh) {
      sk += p.dk_part[at + hh * p.d];
      sv += p.dv_part[at + hh * p.d];
    }
    static_cast<bf16*>(p.dk)[idx] = __float2bfloat16_rn(sk);
    static_cast<bf16*>(p.dv)[idx] = __float2bfloat16_rn(sv);
  }
}

__global__ void __launch_bounds__(kWG, 2) attention_bwd_dq_bf16(Params p) {
  extern __shared__ float4 smem4[];
  bf16* q_s = reinterpret_cast<bf16*>(smem4);  // resident: kBQ x kMaxD each
  bf16* do_s = q_s + kTile;
  bf16* k_s = do_s + kTile;                    // kStages stages of kBK x kMaxD each
  bf16* v_s = k_s + kStages * kTile;

  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int g = lane / 4, c2 = 2 * (lane % 4);
  const int b = blockIdx.x / p.n_heads, h = blockIdx.x % p.n_heads, kh = h / p.group;
  const int num_q = (p.s_len + kBQ - 1) / kBQ;
  const int i = num_q - 1 - static_cast<int>(blockIdx.y);  // longest walks first
  const int q0 = i * kBQ + warp * 16 + g;      // this thread's rows: q0, q0 + 8
  int j_lo, j_hi;
  flash::kv_tile_bounds(i, p.t_len, p.causal, p.window, j_lo, j_hi);
  zero_padding(p, smem4, 2 + 2 * kStages);

  const bf16* k = static_cast<const bf16*>(p.k);
  const bf16* v = static_cast<const bf16*>(p.v);
  const int64_t q_row = static_cast<int64_t>(p.n_heads) * p.d;
  const int64_t kv_row = static_cast<int64_t>(p.n_kv) * p.d;
  const int64_t q_off = (static_cast<int64_t>(b) * p.s_len + i * kBQ) * q_row +
                        static_cast<int64_t>(h) * p.d;
  flash::stage_bf16<kWG>(p, static_cast<const bf16*>(p.q) + q_off, q_row, p.s_len - i * kBQ,
                         q_s, t);
  flash::stage_bf16<kWG>(p, static_cast<const bf16*>(p.dout) + q_off, q_row,
                         p.s_len - i * kBQ, do_s, t);
  float lse[2], delta[2];                      // rows past S: +inf and 0, never written
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = q0 + 8 * r;
    const int64_t at = (static_cast<int64_t>(b) * p.n_heads + h) * p.s_len + s;
    lse[r] = s < p.s_len ? p.lse[at] : __int_as_float(0x7f800000);
    delta[r] = s < p.s_len ? p.delta[at] : 0.0f;
  }
  // KV tile jj into its stage, one commit group per tile (the first with Q
  // and dO; an empty group past j_hi keeps the count uniform)
  auto stage_kv = [&](int jj) {
    if (jj <= j_hi) {
      const int64_t off = (static_cast<int64_t>(b) * p.t_len + jj * kBK) * kv_row +
                          static_cast<int64_t>(kh) * p.d;
      const int slot = (jj - j_lo) % kStages;
      flash::stage_bf16<kWG>(p, k + off, kv_row, p.t_len - jj * kBK, k_s + slot * kTile, t);
      flash::stage_bf16<kWG>(p, v + off, kv_row, p.t_len - jj * kBK, v_s + slot * kTile, t);
    }
    async_copy::commit();
  };

  uint64_t q_desc[kMaxD / 16], do_desc[kMaxD / 16];  // Q and dO, K-major
  k_major(q_s, q_desc);
  k_major(do_s, do_desc);
  float dq[kMaxD / 8][4];                      // 64 q rows x kMaxD a warpgroup (the
                                               // first tile's product writes it)
  const int zero = 0;
  stage_kv(j_lo);
  for (int jj = j_lo; jj <= j_hi; ++jj) {
    async_copy::wait<0>();
    flash::wgmma_wait<0>();                    // tile jj - 1's dA K, whose stage
    flash::pin(dq);                            // tile jj + 1 is about to take
    published();
    stage_kv(jj + 1);
    const int slot = (jj - j_lo) % kStages;
    const bf16* ks = k_s + slot * kTile;
    const bf16* vs = v_s + slot * kTile;

    float s[kBK / 8][4], dp[kBK / 8][4];       // 64 q rows x 64 keys
    uint64_t k_desc[kMaxD / 16], v_desc[kMaxD / 16];
    k_major(ks, k_desc);
    k_major(vs, v_desc);
    flash::wgmma_fence();
    flash::wgmma_qk(s, q_desc, k_desc, zero);
    flash::wgmma_commit();
    flash::wgmma_qk(dp, do_desc, v_desc, zero);
    flash::wgmma_commit();
    flash::wgmma_wait<1>();
    flash::pin(s);

    const int k0 = jj * kBK;
    const bool full = k0 + kBK <= p.t_len && (!p.causal || k0 + kBK - 1 <= i * kBQ) &&
                      (p.window <= 0 || k0 > i * kBQ + kBQ - 1 - p.window);
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = full || flash::key_visible(k0 + 8 * nt + c2 + (e & 1), q0 + 8 * (e >> 1),
                                                   p.t_len, p.causal, p.window);
        probability(p, ok, s[nt][e], lse[e >> 1]);
      }
    flash::wgmma_wait<0>();
    flash::pin(dp);
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[nt][e] = s[nt][e] * (dp[nt][e] - delta[e >> 1]);
    uint32_t da[4][4];
    to_a(dp, da);

    uint64_t k_mn[kBK / 16];                  // dQ += dA K: left running
    mn_major(ks, k_mn);
    flash::wgmma_fence();
    flash::wgmma_av(dq, da, k_mn, jj == j_lo);
    flash::wgmma_commit();
  }
  flash::wgmma_wait<0>();
  flash::pin(dq);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = q0 + 8 * r;
    if (s >= p.s_len) continue;
    bf16* row = static_cast<bf16*>(p.dq) + (static_cast<int64_t>(b) * p.s_len + s) * q_row +
                static_cast<int64_t>(h) * p.d;
#pragma unroll
    for (int dt = 0; dt < kMaxD / 8; ++dt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * dt + c2 + e;
        if (c < p.d) row[c] = __float2bfloat16_rn(dq[dt][2 * r + e]);
      }
  }
}

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem, size_t& opted_in) {
  if (smem <= opted_in) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess) opted_in = smem;
  return err;
}

template <typename T>
cudaError_t launch_delta(const Params& p, int batch, cudaStream_t stream) {
  const int rows = batch * p.s_len * p.n_heads;
  attention_bwd_delta<T><<<(rows + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, stream>>>(
      p, rows);
  return cudaGetLastError();
}

int launch_f32(const Params& p, int batch, cudaStream_t stream) {
  const int num_q = (p.s_len + kBQ - 1) / kBQ;
  if (num_q > 65535 || (p.t_len + kKV - 1) / kKV > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = launch_delta<float>(p, batch, stream);
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t row_bytes = sizeof(float) * (p.dp + 4);
  const size_t rows_smem = sizeof(float) * 2 * kBQ;
  static size_t dkdv_opted = 48 * 1024, dq_opted = 48 * 1024;
  const size_t dkdv_smem = row_bytes * (2 * kKV + 2 * kBQ) + sizeof(float) * 2 * kKV * kTS +
                           rows_smem;
  err = opt_in(attention_bwd_dkdv_f32, dkdv_smem, dkdv_opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int num_kv_blocks = (p.t_len + kKV - 1) / kKV;
  attention_bwd_dkdv_f32<<<dim3(batch * p.n_kv, num_kv_blocks), kThreads, dkdv_smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t dq_smem = row_bytes * (2 * kBQ + 2 * kBK) + sizeof(float) * kBQ * kTS + rows_smem;
  err = opt_in(attention_bwd_dq_f32, dq_smem, dq_opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dq_f32<<<dim3(batch * p.n_heads, num_q), kThreads, dq_smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const Params& p, int batch, cudaStream_t stream) {
  const int num_q = (p.s_len + kBQ - 1) / kBQ, num_kv = (p.t_len + kBK - 1) / kBK;
  if (num_q > 65535 || num_kv > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = launch_delta<bf16>(p, batch, stream);
  if (err != cudaSuccess) return static_cast<int>(err);

  static size_t dkdv_opted = 48 * 1024, dq_opted = 48 * 1024;
  const size_t tiles = sizeof(bf16) * (2 + 2 * kStages) * kTile;
  const size_t dkdv_smem = tiles + sizeof(float) * kStages * 2 * kBQ;
  err = opt_in(attention_bwd_dkdv_bf16, dkdv_smem, dkdv_opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dkdv_bf16<<<dim3(batch * p.n_heads, num_kv), kWG, dkdv_smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.group > 1) {
    const int64_t n = static_cast<int64_t>(batch) * p.t_len * p.n_kv * p.d;
    const int64_t blocks = (n + 255) / 256;
    attention_bwd_dkdv_sum<<<static_cast<int>(blocks < 8192 ? blocks : 8192), 256, 0, stream>>>(
        p, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  err = opt_in(attention_bwd_dq_bf16, tiles, dq_opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dq_bf16<<<dim3(batch * p.n_heads, num_q), kWG, tiles, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

// q, dout, dq (B, S, H, D); k, v, dk, dv (B, T, KH, D); all bf16 when
// bf16_io, else f32.  o (B, S, H, D) f32 and lse (B, H, S) f32 as K5's
// forward wrote them.  delta: f32 scratch, (B, H, S) for D_i (its length
// rounded up to a multiple of 32), then with bf16 and H > KH the dK and dV
// shares (B, T, H, D) each: bwd_scratch_floats in
// kernels/flash_attention/kernel.py sizes it.  window <= 0 and softcap <= 0:
// none.
extern "C" int launch_flash_attention_bwd(const void* q, const void* k, const void* v,
                                          const float* o, const void* dout, const float* lse,
                                          float* delta, void* dq, void* dk, void* dv, int batch,
                                          int s_len, int t_len, int n_heads, int n_kv, int d,
                                          int causal, int window, float scale, float softcap,
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
  p.o = o;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.s_len = s_len;
  p.t_len = t_len;
  p.n_heads = n_heads;
  p.n_kv = n_kv;
  p.d = d;
  p.dp = (d + 3) / 4 * 4;
  p.group = n_heads / n_kv;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.softcap = softcap;
  if (!bf16_io) return launch_f32(p, batch, stream);
  const int64_t rows = static_cast<int64_t>(batch) * n_heads * s_len;
  p.dk_part = delta + (rows + 31) / 32 * 32;
  p.dv_part = p.dk_part + static_cast<int64_t>(batch) * t_len * n_heads * d;
  p.vec = d % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout);
  return launch_bf16(p, batch, stream);
}
