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
//           D <= 128.  The softmax is online, in f32: scores masked to
//           NEG_INF, p re-masked after the exp, V rows past T zeroed, p
//           rounded to v's dtype before the P.V product (as the TPU kernel
//           does), and the epilogue acc / max(l, 1e-37).
// Bound:    operations.  At the served shapes (S = T = 8192, D = 128) each
//           K/V row is used by g * (its visible q rows) query rows: 2,000
//           to 3,600 flops per byte of q, k, v and out, far above the
//           card's ~295 bf16 tensor-core flops per byte, so the least time
//           is the flops of the visible (q, k) pairs (4 * D per pair and
//           head: QK and PV) over the 989 TFLOP/s bf16 peak.
// Design:   one block of 128 threads per (b * H + h, q tile of 64 rows);
//           a loop inside the block walks the tile's own KV tiles of 64
//           rows, [j_lo, j_hi] by _kv_block_bounds' formula at these tile
//           sizes, so a fully masked KV tile is never loaded, and replaces
//           the TPU's sequential max_kv_steps grid axis.  q tiles run in
//           reverse order, so the longest causal walks start first.  Each
//           warp owns 16 q rows and each thread a 4 x 8 register tile of
//           the 64 x 64 score block (rows strided by 4, columns by 8, so
//           the 16-byte shared-memory reads are free of bank conflicts)
//           and a 4 x 16 tile of the 64 x D accumulator: every value read
//           from shared memory feeds 4 to 8 FMAs.  Tiles are staged in
//           shared memory as f32 with 16-byte global loads (98 KB at
//           D = 128, two blocks per SM); the probabilities reuse the K
//           tile's space.  The products run on the f32 ALUs (full f32, no
//           TF32, in both dtypes): this design is far from the operations
//           bound above, which only the tensor cores reach (mma / wgmma on
//           bf16 tiles, loads overlapped with TMA) - later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 128;                 // 4 warps, 16 q rows each
constexpr int kBQ = 64;                       // q rows per block
constexpr int kBK = 64;                       // KV rows per step of the walk
constexpr int kMaxD = 128;
constexpr int kPS = kBK + 8;                  // row stride of the P tile
constexpr float kNegInf = -2.3819763e38f;     // the reference's mask value

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int s_len, t_len, n_heads, n_kv, d;
  int dp;                                     // d rounded up to 4
  int group;                                  // H / KH
  int causal, window;                         // window <= 0: none
  float scale, softcap;                       // softcap <= 0: none
  int vec;                                    // 16-byte global loads
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// p rounded to v's dtype before P.V, as the reference's p.astype(v.dtype)
template <typename T>
__device__ __forceinline__ float round_p(float p) { return p; }
template <>
__device__ __forceinline__ float round_p<__nv_bfloat16>(float p) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

// Stage kBQ (= kBK) rows of one head into `dst` (row stride `stride`
// floats, columns [0, dp)) as f32: rows at or past `rows` and columns at or
// past d are written as 0.  `src` points at the first row's head; rows are
// `row_stride` elements apart.
template <typename T>
__device__ __forceinline__ void load_tile(const Params& p, const T* src,
                                          int64_t row_stride, int rows,
                                          float* dst, int stride) {
  constexpr int kVec = 16 / sizeof(T);
  if (p.vec) {                                // d % kVec == 0, so dp == d
    const int per_row = p.d / kVec;
    for (int idx = threadIdx.x; idx < kBQ * per_row; idx += kThreads) {
      const int r = idx / per_row, c = (idx % per_row) * kVec;
      float* o = dst + r * stride + c;
      if (r >= rows) {
#pragma unroll
        for (int e = 0; e < kVec; e += 4)
          *reinterpret_cast<float4*>(o + e) = make_float4(0.f, 0.f, 0.f, 0.f);
        continue;
      }
      union { uint4 u; T e[kVec]; } chunk;
      chunk.u = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
#pragma unroll
      for (int e = 0; e < kVec; e += 4)
        *reinterpret_cast<float4*>(o + e) =
            make_float4(to_f32(chunk.e[e]), to_f32(chunk.e[e + 1]),
                        to_f32(chunk.e[e + 2]), to_f32(chunk.e[e + 3]));
    }
  } else {
    for (int idx = threadIdx.x; idx < kBQ * p.dp; idx += kThreads) {
      const int r = idx / p.dp, c = idx % p.dp;
      dst[r * stride + c] =
          (r < rows && c < p.d) ? to_f32(src[r * row_stride + c]) : 0.0f;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(Params p) {
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

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const int64_t q_row = static_cast<int64_t>(p.n_heads) * p.d;
  const int64_t kv_row = static_cast<int64_t>(p.n_kv) * p.d;
  load_tile(p, q + (static_cast<int64_t>(b) * p.s_len + i * kBQ) * q_row +
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
    load_tile(p, k + kv_off, kv_row, kv_rows, k_s, qs);
    load_tile(p, v + kv_off, kv_row, kv_rows, v_s, dp);
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
        sc[rr][cc] = round_p<T>(e);
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

  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const int s = i * kBQ + row0 + 4 * rr;
    if (s >= p.s_len) continue;
    T* o = out + (static_cast<int64_t>(b) * p.s_len + s) * q_row +
           static_cast<int64_t>(h) * p.d;
    const float denom = fmaxf(l[rr], 1e-37f);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * cg + 32 * jj + e;
        if (c < p.d) store(o + c, __fdiv_rn(acc[rr][4 * jj + e], denom));
      }
  }
}

template <typename T>
int launch(Params p, int batch, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.d < 1 || p.d > kMaxD || p.s_len < 0 || p.t_len < 1 || p.n_kv < 1 ||
      p.n_heads % p.n_kv != 0 || batch < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || p.s_len == 0) return 0;
  constexpr int kVec = 16 / sizeof(T);
  p.group = p.n_heads / p.n_kv;
  p.dp = (p.d + 3) / 4 * 4;
  p.vec = p.d % kVec == 0 && reinterpret_cast<uintptr_t>(p.q) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(p.k) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(p.v) % 16 == 0;
  const int qs = p.dp + 4;
  const size_t smem = sizeof(float) * (static_cast<size_t>(kBQ) * qs +
                                       std::max(kBK * qs, kBQ * kPS) + kBK * p.dp);
  static size_t opted_in = 48 * 1024;         // per instantiation
  if (smem > opted_in) {
    err = cudaFuncSetAttribute(flash_attention_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = smem;
  }
  const int num_q = (p.s_len + kBQ - 1) / kBQ;
  if (num_q > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(batch * p.n_heads, num_q);
  flash_attention_kernel<T><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16: q, k, v and out are bf16 (else f32).  window <= 0 and softcap <= 0:
// none.  causal != 0: key t is visible to query s only if t <= s.
extern "C" int launch_flash_attention(const void* q, const void* k, const void* v,
                                      void* out, int batch, int s_len, int t_len,
                                      int n_heads, int n_kv, int d, int causal,
                                      int window, float scale, float softcap,
                                      int bf16, int device, cudaStream_t stream) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.s_len = s_len;
  p.t_len = t_len;
  p.n_heads = n_heads;
  p.n_kv = n_kv;
  p.d = d;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.softcap = softcap;
  return bf16 ? launch<__nv_bfloat16>(p, batch, device, stream)
              : launch<float>(p, batch, device, stream);
}
