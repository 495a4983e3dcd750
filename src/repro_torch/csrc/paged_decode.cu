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
//           over 3.35 TB/s.
// Design:   flash-decoding.  The grid is (b·KH, q block × tile of 16 rows
//           of the block's g·q_chunk rows, split).  Each block reads
//           lengths[b] and the page table itself and computes the q
//           block's page range [j_lo, j_hi] as flash_decode_schedule's
//           _page_bounds does (from the live rows' base; a q block with
//           no live row walks nothing).  The split axis cuts that range
//           into chunks of pages_per_split logical pages from j_lo, the
//           last split taking the rest; both numbers come from the host's
//           shapes alone (split_plan in kernels/flash_attention/decode.py),
//           never from the device's lengths, so the split boundaries
//           depend only on logical page indices, the live rows' base and
//           the shapes.  A split with no page of its q block writes an
//           empty partial.  With one split the block writes the output;
//           with more, each block writes f32 partials (m, l, unnormalised
//           acc) to scratch the wrapper allocates, and
//           paged_decode_combine merges them per row in split order (no
//           atomics), writing the output and the exact zeros of dead and
//           see-nothing rows.
//           Inside a block the walk runs in steps of 32 keys (a step may
//           span pages, or part of one): K and V rows stream as raw pool
//           bytes into a ring of three shared-memory stages by cp.async
//           (keys past the split's range or the context zero-filled), so
//           the next two steps load during this step's math (and the first
//           two while q is staged), with one barrier per step.  Each warp owns 4 rows; a lane owns 4 keys of
//           a step and a quarter of the head dim, so the QK dot products
//           run as 16 independent chains of D / 4 and are reduced over the
//           lane's quad by shuffles; the running max and sum stay in
//           registers (shuffles over the 8 key lanes), p goes through a
//           warp-private buffer, and P·V runs as 16 chains per lane over
//           its 4 head-dim columns.  Values are converted (bf16) or
//           dequantized (int8, __fmul_rn by the row's scale) as they are
//           read.  The arithmetic is spelled with _rn intrinsics, so two
//           launches on equal f32 operands agree bit for bit (an int8 pool
//           and the same pool dequantized beforehand; two page tables over
//           the same history).
//           Measured times: PERF.md section 6 (chip_smoke.py phase 6).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;                       // q rows per block, 4 per warp
constexpr int kKeys = 32;                       // keys per step of the walk
constexpr int kStages = 3;                      // steps staged at once
constexpr int kMaxD = 128;
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
  float* partial;             // n_splits > 1: (B·q_len·H, n_splits) x (m, l), then x D
  int q_len, n_heads, n_kv, d, page, max_pages, q_chunk, group, window;
  int pages_per_split, n_splits, tiles;
  float scale, softcap;       // softcap <= 0: none; window <= 0: none
  int vec;                    // 16-byte cp.async of the pools' rows
  int dp;                     // d rounded up to 16
  int rs;                     // row stride of a staged K/V step, bytes
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

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

// columns c..c+3 of a staged raw row as f32 (int8: times the row's scale)
__device__ __forceinline__ float4 load4(const float* row, int c, float) {
  return *reinterpret_cast<const float4*>(row + c);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* row, int c, float) {
  union { uint2 u; __nv_bfloat16 e[4]; } x;
  x.u = *reinterpret_cast<const uint2*>(row + c);
  return make_float4(to_f32(x.e[0]), to_f32(x.e[1]), to_f32(x.e[2]), to_f32(x.e[3]));
}
__device__ __forceinline__ float4 load4(const int8_t* row, int c, float sc) {
  const char4 x = *reinterpret_cast<const char4*>(row + c);
  return make_float4(__fmul_rn(static_cast<float>(x.x), sc), __fmul_rn(static_cast<float>(x.y), sc),
                     __fmul_rn(static_cast<float>(x.z), sc), __fmul_rn(static_cast<float>(x.w), sc));
}

// Stage keys k0 .. k0 + kKeys - 1 of KV head kh of sequence b, raw, into
// k_dst / v_dst (row stride p.rs bytes), and their scales (int8 mode); keys
// at or past key_end as 0.  Pages come from the sequence's table row.
template <typename TKV>
__device__ __forceinline__ void stage(const Params& p, const int* table, int kh, int k0,
                                      int key_end, char* k_dst, char* v_dst, float* ks_dst,
                                      float* vs_dst) {
  auto slot_of = [&](int key) -> int64_t {      // pool row of a key: (page id, slot)
    return (static_cast<int64_t>(table[key / p.page]) * p.page + key % p.page) * p.n_kv + kh;
  };
  if (p.vec) {
    const int chunks = p.d * static_cast<int>(sizeof(TKV)) / 16;
    for (int idx = threadIdx.x; idx < 2 * kKeys * chunks; idx += kThreads) {
      const int which = idx / (kKeys * chunks), rem = idx % (kKeys * chunks);
      const int r = rem / chunks, c = rem % chunks;
      const bool ok = k0 + r < key_end;
      const char* src = static_cast<const char*>(which ? p.v : p.k);
      if (ok) src += slot_of(k0 + r) * p.d * static_cast<int64_t>(sizeof(TKV)) + c * 16;
      async_copy::copy16((which ? v_dst : k_dst) + r * p.rs + c * 16, src, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < 2 * kKeys * p.d; idx += kThreads) {
      const int which = idx / (kKeys * p.d), rem = idx % (kKeys * p.d);
      const int r = rem / p.d, c = rem % p.d;
      TKV x{};
      if (k0 + r < key_end)
        x = static_cast<const TKV*>(which ? p.v : p.k)[slot_of(k0 + r) * p.d + c];
      reinterpret_cast<TKV*>((which ? v_dst : k_dst) + r * p.rs)[c] = x;
    }
  }
  if (p.k_scales != nullptr) {
    for (int idx = threadIdx.x; idx < 2 * kKeys; idx += kThreads) {
      const int which = idx / kKeys, r = idx % kKeys;
      const bool ok = k0 + r < key_end;
      const float* src = which ? p.v_scales : p.k_scales;
      if (ok) src += slot_of(k0 + r);
      async_copy::copy4((which ? vs_dst : ks_dst) + r, src, ok);
    }
  }
  async_copy::commit();
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(Params p) {
  extern __shared__ float4 smem4[];
  const int stage_bytes = kKeys * p.rs;
  char* raw = reinterpret_cast<char*>(smem4);    // [slot][K, V] kKeys x rs
  float* sc_s = reinterpret_cast<float*>(raw + 2 * kStages * stage_bytes);  // [slot][K, V] kKeys
  float* q_s = sc_s + 2 * kStages * kKeys;       // kRows x dp
  float* p_s = q_s + kRows * p.dp;               // [warp][4 rows] kKeys

  const int b = blockIdx.x / p.n_kv, kh = blockIdx.x % p.n_kv;
  const int i = blockIdx.y / p.tiles;            // q block
  const int row0 = (blockIdx.y % p.tiles) * kRows;  // first of the group's rows
  const int split = blockIdx.z;
  const int qc = p.q_chunk, ps = p.page, d = p.d;
  const int nr = min(kRows, p.group * qc - row0);
  const int ctx = p.lengths[b];
  const int n_live = p.new_lens ? p.new_lens[b] : p.q_len;
  const int base = ctx - n_live;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quarter = lane % 4, kg = lane / 4;   // QK: head-dim quarter, key group

  // the q block's pages, as _page_bounds computes them; none for a block
  // whose rows are all dead (verify mode); then this split's share
  const int last = min(base + (i + 1) * qc - 1, ctx - 1);
  int j_hi = min(max(last, 0) / ps, p.max_pages - 1);
  int j_lo = 0;
  if (p.window > 0) j_lo = min(max(base + i * qc - p.window + 1, 0) / ps, j_hi);
  if (i * qc >= n_live) j_hi = j_lo - 1;
  const int s_lo = j_lo + split * p.pages_per_split;
  const int s_hi = split == p.n_splits - 1 ? j_hi : min(s_lo + p.pages_per_split - 1, j_hi);
  const int key_begin = s_lo * ps;
  const int key_end = min((s_hi + 1) * ps, ctx);  // V past the context: 0
  const int steps = key_end > key_begin ? (key_end - key_begin + kKeys - 1) / kKeys : 0;
  const int* table = p.page_table + static_cast<int64_t>(b) * p.max_pages;

  if (p.dp != d) {                               // the padded columns: 0
    const int n16 = (2 * kStages * stage_bytes) / 16;
    for (int idx = threadIdx.x; idx < n16; idx += kThreads)
      smem4[idx] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();                             // before the copies
  }
  // steps 0 .. kStages - 2 in flight (one commit group each, empty past
  // the last step) while q is staged
  auto k_raw = [&](int slot) { return raw + (2 * slot) * stage_bytes; };
  auto v_raw = [&](int slot) { return raw + (2 * slot + 1) * stage_bytes; };
  auto stage_step = [&](int step) {
    const int slot = step % kStages;
    if (step < steps)
      stage<TKV>(p, table, kh, key_begin + step * kKeys, key_end, k_raw(slot), v_raw(slot),
                 sc_s + 2 * slot * kKeys, sc_s + (2 * slot + 1) * kKeys);
    async_copy::commit();
  };
#pragma unroll
  for (int step = 0; step < kStages - 1; ++step) stage_step(step);

  // rows of the group are laid out (g, q_chunk): row r is query head
  // kh·g + r / q_chunk at new row i·q_chunk + r % q_chunk
  int tok[4], head[4], pos[4];
  bool live[4];
  bool warp_live = false;
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const int r = 4 * warp + rr;
    tok[rr] = -1;
    head[rr] = 0;
    if (r < nr) {
      const int t = i * qc + (row0 + r) % qc;
      if (t < p.q_len) {
        tok[rr] = t;
        head[rr] = kh * p.group + (row0 + r) / qc;
      }
    }
    live[rr] = tok[rr] >= 0 && tok[rr] < n_live;
    pos[rr] = base + tok[rr];
    warp_live |= live[rr];
  }
  const TQ* q = static_cast<const TQ*>(p.q);
  for (int idx = threadIdx.x; idx < kRows * p.dp; idx += kThreads) {
    const int r = idx / p.dp, c = idx % p.dp;
    int t = -1, hd = 0;
    if (r < nr && c < d) {
      t = i * qc + (row0 + r) % qc;
      hd = kh * p.group + (row0 + r) / qc;
    }
    q_s[idx] = t < 0 || t >= p.q_len
                   ? 0.0f
                   : to_f32(q[(static_cast<int64_t>(b) * p.q_len + t) * p.n_heads * d +
                              static_cast<int64_t>(hd) * d + c]);
  }

  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.0f;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[rr][e] = 0.0f;
  }
  float* pw = p_s + warp * 4 * kKeys;            // this warp's p, 4 x kKeys

  for (int step = 0; step < steps; ++step) {
    const int slot = step % kStages;
    async_copy::wait<kStages - 2>();
    __syncthreads();                             // step landed (and q); step - 1 consumed
    const int k0 = key_begin + step * kKeys;
    stage_step(step + kStages - 1);              // into step - 1's stage
    if (!warp_live) continue;
    const TKV* ks = reinterpret_cast<const TKV*>(k_raw(slot));
    const TKV* vs = reinterpret_cast<const TKV*>(v_raw(slot));
    const float* ksc = sc_s + 2 * slot * kKeys;
    const float* vsc = ksc + kKeys;
    const int rs = p.rs / static_cast<int>(sizeof(TKV));
    const bool quant = p.k_scales != nullptr;

    // QK: rows 4 warp + rr, keys kg + 8 kk; this lane's head-dim quarter,
    // columns 16 mm + 4 quarter + (0..3)
    float dot[4][4];
#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) dot[rr][kk] = 0.0f;
    for (int c = 4 * quarter; c < p.dp; c += 16) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
        qv[rr] = *reinterpret_cast<const float4*>(q_s + (4 * warp + rr) * p.dp + c);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int key = kg + 8 * kk;
        kv[kk] = load4(ks + key * rs, c, quant ? ksc[key] : 1.0f);
      }
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float s = dot[rr][kk];
          s = __fmaf_rn(qv[rr].x, kv[kk].x, s);
          s = __fmaf_rn(qv[rr].y, kv[kk].y, s);
          s = __fmaf_rn(qv[rr].z, kv[kk].z, s);
          s = __fmaf_rn(qv[rr].w, kv[kk].w, s);
          dot[rr][kk] = s;
        }
    }

    // scores and masks; the online softmax per row over the 8 key lanes
    float alpha[4];
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      float mx = kNegInf;
      uint32_t ok_bits = 0;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float s = dot[rr][kk];
        s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 1));
        s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 2));
        s = __fmul_rn(s, p.scale);
        if (p.softcap > 0.0f) s = __fmul_rn(p.softcap, tanhf(__fdiv_rn(s, p.softcap)));
        const int key = k0 + kg + 8 * kk;
        const bool ok = live[rr] && key < key_end && visible(key, pos[rr], p.window);
        ok_bits |= static_cast<uint32_t>(ok) << kk;
        dot[rr][kk] = ok ? s : kNegInf;
        mx = fmaxf(mx, dot[rr][kk]);
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[rr], mx);
      alpha[rr] = expf(__fsub_rn(m[rr], m_new));
      float sum = 0.0f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // rows with nothing visible yet have m_new == NEG_INF: re-mask
        const float e = (ok_bits >> kk) & 1u ? expf(__fsub_rn(dot[rr][kk], m_new)) : 0.0f;
        sum = __fadd_rn(sum, e);
        if (quarter == 0) pw[rr * kKeys + kg + 8 * kk] = round_p<TKV>(e);
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
      l[rr] = __fadd_rn(__fmul_rn(l[rr], alpha[rr]), sum);
      m[rr] = m_new;
    }
    __syncwarp();                                // a warp reads its own p only

    // P·V: rows 4 warp + rr, columns 4 lane + (0..3)
    const int c = 4 * lane;
    if (c < p.dp) {
      float pv[4][4];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[rr][e] = 0.0f;
#pragma unroll 2
      for (int key = 0; key < kKeys; key += 4) {
        float4 pr[4];
#pragma unroll
        for (int rr = 0; rr < 4; ++rr)
          pr[rr] = *reinterpret_cast<const float4*>(pw + rr * kKeys + key);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 vv = load4(vs + (key + kk) * rs, c, quant ? vsc[key + kk] : 1.0f);
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) {
            const float w = kk == 0 ? pr[rr].x : kk == 1 ? pr[rr].y : kk == 2 ? pr[rr].z : pr[rr].w;
            pv[rr][0] = __fmaf_rn(w, vv.x, pv[rr][0]);
            pv[rr][1] = __fmaf_rn(w, vv.y, pv[rr][1]);
            pv[rr][2] = __fmaf_rn(w, vv.z, pv[rr][2]);
            pv[rr][3] = __fmaf_rn(w, vv.w, pv[rr][3]);
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[rr][e] = __fadd_rn(__fmul_rn(acc[rr][e], alpha[rr]), pv[rr][e]);
    }
    __syncwarp();                                // p is read before the next step writes it
  }

  // one split: the output; else this split's partial (m, l, acc)
  const int c = 4 * lane;
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    if (tok[rr] < 0) continue;
    const int64_t row = (static_cast<int64_t>(b) * p.q_len + tok[rr]) * p.n_heads + head[rr];
    if (p.n_splits == 1) {
      TQ* out = static_cast<TQ*>(p.out) + row * d;
      const float denom = fmaxf(l[rr], 1e-37f);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e < d) store(out + c + e, __fdiv_rn(acc[rr][e], denom));
    } else {
      const int64_t slot = row * p.n_splits + split;
      const int64_t n_rows = static_cast<int64_t>(gridDim.x / p.n_kv) * p.q_len * p.n_heads;
      if (lane == 0) {
        p.partial[2 * slot] = m[rr];
        p.partial[2 * slot + 1] = l[rr];
      }
      float* pa = p.partial + 2 * n_rows * p.n_splits + slot * d;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e < d) pa[c + e] = acc[rr][e];
    }
  }
}

// Merge the n_splits partials of each output row (one warp per row, lane
// columns 4 lane + (0..3)) in split order: out = sum_s acc_s w_s /
// max(sum_s l_s w_s, 1e-37) with w_s = exp(m_s - max_s m_s).  A row no
// split saw gives 0.
template <typename TQ>
__global__ void __launch_bounds__(kThreads) paged_decode_combine(Params p, int64_t n_rows) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (row >= n_rows) return;
  const int lane = threadIdx.x % 32, c = 4 * lane, d = p.d, n = p.n_splits;
  const float* ml = p.partial + 2 * row * n;
  const float* pa = p.partial + 2 * n_rows * n + row * n * d;
  float mx = kNegInf;
  for (int s = 0; s < n; ++s) mx = fmaxf(mx, ml[2 * s]);
  float lsum = 0.0f, acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int s = 0; s < n; ++s) {
    const float w = expf(__fsub_rn(ml[2 * s], mx));
    lsum = __fadd_rn(lsum, __fmul_rn(ml[2 * s + 1], w));
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c + e < d) acc[e] = __fadd_rn(acc[e], __fmul_rn(pa[s * d + c + e], w));
  }
  TQ* out = static_cast<TQ*>(p.out) + row * d;
  const float denom = fmaxf(lsum, 1e-37f);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (c + e < d) store(out + c + e, __fdiv_rn(acc[e], denom));
}

template <typename TQ, typename TKV>
int launch(Params p, int batch, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.d < 1 || p.d > kMaxD || p.page < 1 || p.q_chunk < 1 || p.q_len < 1 ||
      p.n_kv < 1 || p.n_heads % p.n_kv != 0 || p.pages_per_split < 1 || p.n_splits < 1 ||
      p.n_splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  if (p.n_splits > 1 && p.partial == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kElt = static_cast<int>(sizeof(TKV));
  p.group = p.n_heads / p.n_kv;
  p.dp = (p.d + 15) / 16 * 16;
  // a stride of 16 * kElt bytes mod 128 puts the rows a warp reads at once
  // on distinct banks
  p.rs = (p.dp * kElt + 127) / 128 * 128 + 16 * kElt;
  p.vec = p.d * kElt % 16 == 0 && reinterpret_cast<uintptr_t>(p.k) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(p.v) % 16 == 0;
  const int q_blocks = (p.q_len + p.q_chunk - 1) / p.q_chunk;
  p.tiles = (p.group * p.q_chunk + kRows - 1) / kRows;
  if (static_cast<int64_t>(q_blocks) * p.tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * kStages * static_cast<size_t>(kKeys) * p.rs +
                      sizeof(float) * (2 * kStages * kKeys + kRows * p.dp + kWarps * 4 * kKeys);
  static size_t opted_in = 48 * 1024;           // per instantiation
  if (smem > opted_in) {
    err = cudaFuncSetAttribute(paged_decode_kernel<TQ, TKV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = smem;
  }
  dim3 grid(batch * p.n_kv, q_blocks * p.tiles, p.n_splits);
  paged_decode_kernel<TQ, TKV><<<grid, kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.n_splits == 1) return static_cast<int>(err);
  const int64_t n_rows = static_cast<int64_t>(batch) * p.q_len * p.n_heads;
  paged_decode_combine<TQ><<<static_cast<unsigned>((n_rows + kWarps - 1) / kWarps), kThreads, 0,
                             stream>>>(p, n_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q_bf16: q and out are bf16 (else f32).  kv_int8: int8 pools with scale
// pools (else pools of q's dtype).  window <= 0 and softcap <= 0: none.
// new_lens null: the plain launch; else the verify launch.  The walk of
// each q block is cut into n_splits chunks of pages_per_split pages;
// n_splits > 1 needs `partial`, f32 scratch of B·q_len·H·n_splits·(D + 2)
// values.
extern "C" int launch_paged_decode(const void* q, const void* k, const void* v,
                                   const void* k_scales, const void* v_scales,
                                   const void* page_table, const void* lengths,
                                   const void* new_lens, void* out, void* partial,
                                   int batch, int q_len, int n_heads, int n_kv, int d,
                                   int page, int max_pages, int q_chunk, int window,
                                   int pages_per_split, int n_splits, float scale,
                                   float softcap, int q_bf16, int kv_int8, int device,
                                   cudaStream_t stream) {
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
  p.partial = static_cast<float*>(partial);
  p.q_len = q_len;
  p.n_heads = n_heads;
  p.n_kv = n_kv;
  p.d = d;
  p.page = page;
  p.max_pages = max_pages;
  p.q_chunk = q_chunk;
  p.window = window;
  p.pages_per_split = pages_per_split;
  p.n_splits = n_splits;
  p.scale = scale;
  p.softcap = softcap;
  if (q_bf16) {
    return kv_int8 ? launch<__nv_bfloat16, int8_t>(p, batch, device, stream)
                   : launch<__nv_bfloat16, __nv_bfloat16>(p, batch, device, stream);
  }
  return kv_int8 ? launch<float, int8_t>(p, batch, device, stream)
                 : launch<float, float>(p, batch, device, stream);
}
