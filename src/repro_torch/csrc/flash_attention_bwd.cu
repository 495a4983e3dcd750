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
//           D <= 128; every product and sum is in f32.
// Bound:    operations.  Each visible (q, k) pair and head costs 10 D flops
//           (the recomputed QK, dO V^T, P^T dO, dA^T Q and dA K); at
//           qwen2.5-3b's training shape (S = T = 4096, D = 128) that is
//           ~1,300 flops per byte of q, k, v, O, dO and the gradients, far
//           above the card's ~295 bf16 tensor-core flops per byte.
// Design:   simple and deterministic, on the f32 ALUs (tensor cores, TMA and
//           wgmma are later work).  Three kernels, no atomics, so two runs
//           give the same bits:
//   delta:  D_i, one warp a row.
//   dK dV:  a block of 256 threads owns 32 keys of one KV head (half a
//           forward KV tile: the causal walks are uneven, and 32-key blocks
//           let the longest, which start first, take no more than the
//           card's share of the work), their K and V resident in shared
//           memory (as f32), and walks the g query heads and, for each, the
//           q tiles whose forward walk visits these keys (the transposed
//           walk); for each it stages Q and dO, recomputes S and dO V^T
//           (each thread 2 q rows x 4 keys), writes P^T and dA^T to shared
//           memory and accumulates dV += P^T dO and dK += dA^T Q in
//           registers (1 key x 16 columns each).
//   dQ:     a block of 256 threads owns one 64-row q tile of one head, its Q
//           and dO resident, walks the forward's KV tiles, recomputes S, P
//           and dA as above, writes dA to shared memory and accumulates dQ
//           += dA K in registers.
//           ~120 KB (dK dV) and ~155 KB (dQ) of shared memory at D = 128:
//           one block per SM.
//           Measured times: PERF.md section 6 (chip_smoke.py phase 6).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using flash::kBK;
using flash::kBQ;

constexpr int kThreads = 256;                 // 8 warps, 8 q rows of a tile each
constexpr int kKV = 32;                       // dK dV: keys a block
constexpr int kTS = kBQ + 4;                  // row stride of the P / dA tiles

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* o;                             // f32: K5's output before any rounding
  const void* dout;
  const float* lse;                           // (B, H, S)
  float* delta;                               // (B, H, S), the delta pass's output
  void* dq;
  void* dk;
  void* dv;
  int s_len, t_len, n_heads, n_kv, d;
  int dp;                                     // d padded to 4
  int group;                                  // H / KH
  int causal, window;                         // window <= 0: none
  float scale, softcap;                       // softcap <= 0: none
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16_rn(x); }

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

// Stage `tile` rows of one head into `dst` as f32 (row stride `stride`,
// columns [0, dp)): rows at or past `rows` and columns at or past d as 0.
// `src` points at the first row's head; rows are `row_stride` elements apart.
template <typename T>
__device__ __forceinline__ void load_tile(const Params& p, const T* src, int64_t row_stride,
                                          int rows, int tile, float* dst, int stride) {
  for (int idx = threadIdx.x; idx < tile * p.dp; idx += kThreads) {
    const int r = idx / p.dp, c = idx % p.dp;
    dst[r * stride + c] = (r < rows && c < p.d) ? to_f32(src[r * row_stride + c]) : 0.0f;
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

template <typename T>
__global__ void __launch_bounds__(kThreads) attention_bwd_dkdv(Params p) {
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

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const T* dout = static_cast<const T*>(p.dout);
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
  T* dk_out = static_cast<T*>(p.dk);
  T* dv_out = static_cast<T*>(p.dv);
  const int64_t at = (static_cast<int64_t>(b) * p.t_len + t) * kv_row +
                     static_cast<int64_t>(kh) * p.d;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 4 * cg + 32 * jj + e;
      if (c < p.d) {
        store(dk_out + at + c, dk[0][4 * jj + e]);
        store(dv_out + at + c, dv[0][4 * jj + e]);
      }
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) attention_bwd_dq(Params p) {
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

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const T* dout = static_cast<const T*>(p.dout);
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

  T* dq_out = static_cast<T*>(p.dq);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int s = i * kBQ + r0 + 4 * rr;
    if (s >= p.s_len) continue;
    T* row = dq_out + (static_cast<int64_t>(b) * p.s_len + s) * q_row + static_cast<int64_t>(h) * p.d;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * cg + 32 * jj + e;
        if (c < p.d) store(row + c, dq[rr][4 * jj + e]);
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
int launch(const Params& p, int batch, cudaStream_t stream) {
  const int num_q = (p.s_len + kBQ - 1) / kBQ;
  if (num_q > 65535 || (p.t_len + kKV - 1) / kKV > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = batch * p.s_len * p.n_heads;
  attention_bwd_delta<T><<<(rows + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, stream>>>(
      p, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t row_bytes = sizeof(float) * (p.dp + 4);
  const size_t rows_smem = sizeof(float) * 2 * kBQ;
  static size_t dkdv_opted = 48 * 1024, dq_opted = 48 * 1024;
  const size_t dkdv_smem = row_bytes * (2 * kKV + 2 * kBQ) + sizeof(float) * 2 * kKV * kTS +
                           rows_smem;
  err = opt_in(attention_bwd_dkdv<T>, dkdv_smem, dkdv_opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int num_kv_blocks = (p.t_len + kKV - 1) / kKV;
  attention_bwd_dkdv<T><<<dim3(batch * p.n_kv, num_kv_blocks), kThreads, dkdv_smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t dq_smem = row_bytes * (2 * kBQ + 2 * kBK) + sizeof(float) * kBQ * kTS + rows_smem;
  err = opt_in(attention_bwd_dq<T>, dq_smem, dq_opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dq<T><<<dim3(batch * p.n_heads, num_q), kThreads, dq_smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, dout, dq (B, S, H, D); k, v, dk, dv (B, T, KH, D); all bf16 when
// bf16_io, else f32.  o (B, S, H, D) f32 and lse (B, H, S) f32 as K5's
// forward wrote them; delta (B, H, S) f32 scratch.  window <= 0 and
// softcap <= 0: none.
extern "C" int launch_flash_attention_bwd(const void* q, const void* k, const void* v,
                                          const float* o, const void* dout, const float* lse,
                                          float* delta, void* dq, void* dk, void* dv, int batch,
                                          int s_len, int t_len, int n_heads, int n_kv, int d,
                                          int causal, int window, float scale, float softcap,
                                          int bf16_io, int device, cudaStream_t stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (d < 1 || d > 128 || s_len < 0 || t_len < 1 || n_kv < 1 || n_heads % n_kv != 0 ||
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
  return bf16_io ? launch<bf16>(p, batch, stream) : launch<float>(p, batch, stream);
}
