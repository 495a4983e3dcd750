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
#include "flash_wgmma.cuh"

namespace {

// kBQ q rows per block, kBK KV rows per step of the walk, the masks
// (flash_common.cuh); the wgmma helpers (flash_wgmma.cuh)
using namespace flash;

constexpr int kThreads = 128;                 // 4 warps, 16 q rows each
constexpr int kStages = 3;                    // bf16: K/V tile stages
constexpr int kPS = kBK + 8;                  // row stride of the f32 P tile

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
// bf16: tensor cores (wgmma, flash_wgmma.cuh)
// ---------------------------------------------------------------------------
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
