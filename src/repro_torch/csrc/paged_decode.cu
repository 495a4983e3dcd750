// Paged flash attention over a KV page pool (K4) for sm_90a.
//
// Replaces: src/repro/kernels/flash_attention/decode.py, _decode_kernel
//           (launched by paged_decode_kernel), in its plain mode, its
//           int8 mode and its speculative verify mode (new_lens).
// Computes: for each sequence b, KV head kh and new row t of the step,
//           out[b, t, h] = softmax(q·K^T · scale [softcap]) · V over the
//           sequence's pages, with h = kh·g + gi for the g = H / KH query
//           heads of kh.  q and out are (B, q_len, H, D); the pools are
//           (P, page, KH, D) f32 / bf16, or int8 with (P, page, KH) f32
//           scale pools dequantized on load as values.f32 * scale;
//           page_table (B, max_pages) int32 maps logical page j to its
//           physical page; lengths (B,) int32 counts the context with the
//           step's new rows.  Row t sits at q_pos = lengths[b] - q_len + t
//           and sees k_pos <= q_pos (and k_pos > q_pos - window); a row
//           that sees nothing gives 0.  The softmax is online, in f32.
//           Verify mode (new_lens (B,) int32, non-null): only rows
//           t < new_lens[b] are live, at q_pos = lengths[b] - new_lens[b]
//           + t; dead rows see nothing and so give exact zeros.  The plain
//           launch is the verify launch with new_lens[b] = q_len: one code
//           path, in which new_lens changes only the rows' base position
//           and their liveness, so a verify launch of one live row is
//           bitwise the plain launch of one row.
// Bound:    bytes.  Each K/V element is read once from device memory and
//           used for 2 flops per query row: at decode (g = 1, one row) that
//           is 0.5-2 flops per byte, far below the card's ~20 f32 flops per
//           byte.  The least time is the bytes of the K/V rows some new
//           row sees (the context, or its last window + q_len - 1 rows)
//           over 3.35 TB/s; the kernel stages whole pages, so it reads
//           up to a page per sequence more.
// Design:   one block per (b·KH, q block, tile of 16 rows of the block's
//           g·q_chunk rows), so the f32 accumulator of a tile (16 x D)
//           sits in registers and never outgrows the SM; tiles of one q
//           block walk the same pages, the second from L2.  Each block
//           reads lengths[b] and the page table itself, computes the q
//           block's page range [j_lo, j_hi] as flash_decode_schedule's
//           _page_bounds does (from the live rows' base; a q block with
//           no live row walks nothing), and walks only those pages: per
//           page, K and V are staged in shared memory as f32 with 16-byte loads
//           (dequantized there in int8 mode; V rows past the context
//           zeroed), one thread per (row, key) dot product, one warp per
//           row for the running max and sum, one thread per (row, d) for
//           P·V.  The arithmetic is spelled with _rn intrinsics, so two
//           launches on equal f32 operands agree bit for bit (an int8 pool
//           and the same pool dequantized beforehand; two page tables over
//           the same history).  Speed (splitting long contexts over more
//           blocks, pipelined loads) is later work: at decode this grid has
//           only B·KH blocks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;                       // q rows per block
constexpr int kMaxD = 128;
constexpr int kAcc = kRows * kMaxD / kThreads;  // accumulators per thread
constexpr float kNegInf = -2.3819763e38f;       // the reference's mask value

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scales;      // int8 mode only
  const float* v_scales;
  const int* page_table;
  const int* lengths;
  const int* new_lens;        // verify mode only; null: all q_len rows live
  void* out;
  int q_len, n_heads, n_kv, d, page, max_pages, q_chunk, group, window;
  float scale, softcap;       // softcap <= 0: none; window <= 0: none
  int vec;                    // 16-byte loads of the pools
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// p rounded to the value dtype before P·V, as the reference's
// p.astype(v.dtype): bf16 for bf16 pools; f32 pools and dequantized int8
// values are f32.
template <typename TKV>
__device__ __forceinline__ float round_p(float p) { return p; }
template <>
__device__ __forceinline__ float round_p<__nv_bfloat16>(float p) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

__device__ __forceinline__ bool visible(int k_pos, int q_pos, int window) {
  return k_pos <= q_pos && (window <= 0 || k_pos > q_pos - window);
}

// Stage one page of one KV head (page x D) into `tile` (row stride
// `stride` floats), dequantizing int8 values with their row's scale.  Rows
// at or past `zero_from` are written as 0.
template <typename TKV>
__device__ __forceinline__ void load_tile(const Params& p, const TKV* pool,
                                          const float* scales, int64_t page_id,
                                          int kh, float* tile, int stride,
                                          int zero_from) {
  constexpr int kVec = 16 / sizeof(TKV);
  const int d = p.d;
  const int64_t slot_stride = static_cast<int64_t>(p.n_kv) * d;
  const TKV* base = pool + page_id * p.page * slot_stride + static_cast<int64_t>(kh) * d;
  const bool quant = scales != nullptr;
  if (p.vec) {
    const int per_row = d / kVec;
    for (int idx = threadIdx.x; idx < p.page * per_row; idx += kThreads) {
      const int row = idx / per_row, c = idx % per_row;
      float* dst = tile + row * stride + c * kVec;
      if (row >= zero_from) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) dst[e] = 0.0f;
        continue;
      }
      union { uint4 u; TKV e[kVec]; } chunk;
      chunk.u = reinterpret_cast<const uint4*>(base + row * slot_stride)[c];
      const float sc = quant ? scales[(page_id * p.page + row) * p.n_kv + kh] : 1.0f;
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float x = to_f32(chunk.e[e]);
        dst[e] = quant ? __fmul_rn(x, sc) : x;
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < p.page * d; idx += kThreads) {
      const int row = idx / d, c = idx % d;
      float x = 0.0f;
      if (row < zero_from) {
        x = to_f32(base[row * slot_stride + c]);
        if (quant) x = __fmul_rn(x, scales[(page_id * p.page + row) * p.n_kv + kh]);
      }
      tile[row * stride + c] = x;
    }
  }
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(Params p) {
  extern __shared__ float smem[];
  const int d = p.d, ps = p.page, qc = p.q_chunk;
  const int kd = d + 1;                          // padded: no bank conflicts
  float* k_s = smem;                             // ps x kd
  float* v_s = k_s + ps * kd;                    // ps x d
  float* q_s = v_s + ps * d;                     // kRows x d
  float* p_s = q_s + kRows * d;                  // kRows x ps
  float* m_s = p_s + kRows * ps;
  float* l_s = m_s + kRows;
  float* a_s = l_s + kRows;
  int* pos_s = reinterpret_cast<int*>(a_s + kRows);
  int* tok_s = pos_s + kRows;                    // new-row index, -1: none
  int* head_s = tok_s + kRows;
  int* live_s = head_s + kRows;                  // the row belongs to a token

  const int b = blockIdx.x / p.n_kv, kh = blockIdx.x % p.n_kv;
  const int i = blockIdx.y;                      // q block
  const int row0 = blockIdx.z * kRows;           // first of the group's rows
  const int nr = min(kRows, p.group * qc - row0);
  const int ctx = p.lengths[b];
  const int n_live = p.new_lens ? p.new_lens[b] : p.q_len;
  const int base = ctx - n_live;

  // rows of the group are laid out (g, q_chunk): row r is query head
  // kh·g + r / q_chunk at new row i·q_chunk + r % q_chunk
  if (threadIdx.x < kRows) {
    const int r = threadIdx.x;
    int tok = -1, head = 0;
    if (r < nr) {
      const int t = i * qc + (row0 + r) % qc;
      if (t < p.q_len) {
        tok = t;
        head = kh * p.group + (row0 + r) / qc;
      }
    }
    tok_s[r] = tok;
    head_s[r] = head;
    live_s[r] = tok >= 0 && tok < n_live;
    pos_s[r] = base + tok;
    m_s[r] = kNegInf;
    l_s[r] = 0.0f;
  }
  __syncthreads();
  const TQ* q = static_cast<const TQ*>(p.q);
  for (int idx = threadIdx.x; idx < nr * d; idx += kThreads) {
    const int r = idx / d, c = idx % d;
    const int t = tok_s[r];
    q_s[idx] = t < 0 ? 0.0f
                     : to_f32(q[(static_cast<int64_t>(b) * p.q_len + t) * p.n_heads * d +
                                static_cast<int64_t>(head_s[r]) * d + c]);
  }

  // the q block's pages, as _page_bounds computes them; none for a block
  // whose rows are all dead (verify mode)
  const int last = min(base + (i + 1) * qc - 1, ctx - 1);
  int j_hi = min(max(last, 0) / ps, p.max_pages - 1);
  int j_lo = 0;
  if (p.window > 0) j_lo = min(max(base + i * qc - p.window + 1, 0) / ps, j_hi);
  if (i * qc >= n_live) j_hi = j_lo - 1;

  float acc[kAcc];
#pragma unroll
  for (int a = 0; a < kAcc; ++a) acc[a] = 0.0f;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int j = j_lo; j <= j_hi; ++j) {
    const int64_t page_id = p.page_table[static_cast<int64_t>(b) * p.max_pages + j];
    __syncthreads();                             // the last page is consumed
    load_tile(p, static_cast<const TKV*>(p.k), p.k_scales, page_id, kh, k_s, kd, ps);
    load_tile(p, static_cast<const TKV*>(p.v), p.v_scales, page_id, kh, v_s, d,
              ctx - j * ps);                     // V past the context: 0
    __syncthreads();

    for (int idx = threadIdx.x; idx < nr * ps; idx += kThreads) {
      const int r = idx / ps, c = idx % ps;
      const float* qr = q_s + r * d;
      const float* kr = k_s + c * kd;
      float dot = 0.0f;
      for (int e = 0; e < d; ++e) dot = __fmaf_rn(qr[e], kr[e], dot);
      float s = __fmul_rn(dot, p.scale);
      if (p.softcap > 0.0f) s = __fmul_rn(p.softcap, tanhf(__fdiv_rn(s, p.softcap)));
      const bool ok = live_s[r] && visible(j * ps + c, pos_s[r], p.window);
      p_s[idx] = ok ? s : kNegInf;
    }
    __syncthreads();

    for (int r = warp; r < nr; r += kWarps) {
      float* sr = p_s + r * ps;
      float mx = kNegInf;
      for (int c = lane; c < ps; c += 32) mx = fmaxf(mx, sr[c]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = expf(__fsub_rn(m_prev, m_new));
      float sum = 0.0f;
      for (int c = lane; c < ps; c += 32) {
        // rows with nothing visible yet have m_new == NEG_INF: re-mask
        const bool ok = live_s[r] && visible(j * ps + c, pos_s[r], p.window);
        const float e = ok ? expf(__fsub_rn(sr[c], m_new)) : 0.0f;
        sum = __fadd_rn(sum, e);
        sr[c] = round_p<TKV>(e);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
      __syncwarp();
      if (lane == 0) {
        l_s[r] = __fadd_rn(__fmul_rn(l_s[r], alpha), sum);
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int a = 0; a < kAcc; ++a) {
      const int idx = threadIdx.x + a * kThreads;
      if (idx < nr * d) {
        const int r = idx / d, c = idx % d;
        const float* pr = p_s + r * ps;
        float pv = 0.0f;
        for (int e = 0; e < ps; ++e) pv = __fmaf_rn(pr[e], v_s[e * d + c], pv);
        acc[a] = __fadd_rn(__fmul_rn(acc[a], a_s[r]), pv);
      }
    }
  }

  TQ* out = static_cast<TQ*>(p.out);
#pragma unroll
  for (int a = 0; a < kAcc; ++a) {
    const int idx = threadIdx.x + a * kThreads;
    if (idx < nr * d) {
      const int r = idx / d, c = idx % d;
      const int t = tok_s[r];
      if (t >= 0)
        store(out + (static_cast<int64_t>(b) * p.q_len + t) * p.n_heads * d +
                  static_cast<int64_t>(head_s[r]) * d + c,
              __fdiv_rn(acc[a], fmaxf(l_s[r], 1e-37f)));
    }
  }
}

template <typename TQ, typename TKV>
int launch(Params p, int batch, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.d < 1 || p.d > kMaxD || p.page < 1 || p.q_chunk < 1 || p.q_len < 1 ||
      p.n_kv < 1 || p.n_heads % p.n_kv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  constexpr int kVec = 16 / sizeof(TKV);
  p.group = p.n_heads / p.n_kv;
  p.vec = p.d % kVec == 0 && reinterpret_cast<uintptr_t>(p.k) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(p.v) % 16 == 0;
  const size_t smem = sizeof(float) * (p.page * (2 * p.d + 1) + kRows * p.d +
                                       kRows * p.page + 3 * kRows) +
                      sizeof(int) * 4 * kRows;
  static size_t opted_in = 48 * 1024;           // per instantiation
  if (smem > opted_in) {
    err = cudaFuncSetAttribute(paged_decode_kernel<TQ, TKV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = smem;
  }
  const int q_blocks = (p.q_len + p.q_chunk - 1) / p.q_chunk;
  const int tiles = (p.group * p.q_chunk + kRows - 1) / kRows;
  dim3 grid(batch * p.n_kv, q_blocks, tiles);
  paged_decode_kernel<TQ, TKV><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q_bf16: q and out are bf16 (else f32).  kv_int8: int8 pools with scale
// pools (else pools of q's dtype).  window <= 0 and softcap <= 0: none.
// new_lens null: the plain launch; else the verify launch.
extern "C" int launch_paged_decode(const void* q, const void* k, const void* v,
                                   const void* k_scales, const void* v_scales,
                                   const void* page_table, const void* lengths,
                                   const void* new_lens, void* out, int batch,
                                   int q_len, int n_heads, int n_kv, int d,
                                   int page, int max_pages,
                                   int q_chunk, int window, float scale,
                                   float softcap, int q_bf16, int kv_int8,
                                   int device, cudaStream_t stream) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.k_scales = kv_int8 ? static_cast<const float*>(k_scales) : nullptr;
  p.v_scales = kv_int8 ? static_cast<const float*>(v_scales) : nullptr;
  p.page_table = static_cast<const int*>(page_table);
  p.lengths = static_cast<const int*>(lengths);
  p.new_lens = static_cast<const int*>(new_lens);
  p.out = out;
  p.q_len = q_len;
  p.n_heads = n_heads;
  p.n_kv = n_kv;
  p.d = d;
  p.page = page;
  p.max_pages = max_pages;
  p.q_chunk = q_chunk;
  p.window = window;
  p.scale = scale;
  p.softcap = softcap;
  if (q_bf16) {
    return kv_int8 ? launch<__nv_bfloat16, int8_t>(p, batch, device, stream)
                   : launch<__nv_bfloat16, __nv_bfloat16>(p, batch, device, stream);
  }
  return kv_int8 ? launch<float, int8_t>(p, batch, device, stream)
                 : launch<float, float>(p, batch, device, stream);
}
