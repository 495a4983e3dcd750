// What K5's forward (flash_attention.cu) and its backward
// (flash_attention_bwd.cu) must compute alike: the tile sizes of the walk,
// which KV tiles a q tile visits, which keys a query sees, and the score
// of a (query, key) pair from its raw dot product.
#pragma once

namespace flash {

constexpr int kBQ = 64;                       // q rows per tile
constexpr int kBK = 64;                       // KV rows per tile
constexpr float kNegInf = -2.3819763e38f;     // the reference's mask value

// the KV tiles [j_lo, j_hi] q tile i visits, as _kv_block_bounds computes
// them at these tile sizes (window <= 0: none)
__device__ __forceinline__ void kv_tile_bounds(int i, int t_len, int causal, int window,
                                               int& j_lo, int& j_hi) {
  const int num_kv = (t_len + kBK - 1) / kBK;
  j_lo = 0;
  j_hi = num_kv - 1;
  if (window > 0) j_lo = min(max(i * kBQ - (window - 1), 0) / kBK, num_kv - 1);
  if (causal) j_hi = min(((i + 1) * kBQ - 1) / kBK, num_kv - 1);
}

// the q tiles [i_lo, i_hi] whose walk (kv_tile_bounds) visits KV tile j,
// its inverse: i visits j iff j <= j_hi(i), i.e. (i + 1) kBQ > j kBK when
// causal, and j_lo(i) <= j, i.e. i kBQ < (j + 1) kBK + window - 1 with a
// window unless j is the last tile (j_lo is capped there); i_lo > i_hi
// when no q tile does
__device__ __forceinline__ void q_tile_bounds(int j, int s_len, int t_len, int causal,
                                              int window, int& i_lo, int& i_hi) {
  const int num_q = (s_len + kBQ - 1) / kBQ, num_kv = (t_len + kBK - 1) / kBK;
  i_lo = causal ? j * kBK / kBQ : 0;
  i_hi = num_q - 1;
  if (window > 0 && j < num_kv - 1) i_hi = min(((j + 1) * kBK + window - 2) / kBQ, num_q - 1);
}

// key k_pos is visible to query q_pos: t <= s when causal, t > s - window
__device__ __forceinline__ bool key_visible(int k_pos, int q_pos, int t_len, int causal,
                                            int window) {
  return k_pos < t_len && (!causal || k_pos <= q_pos) && (window <= 0 || k_pos > q_pos - window);
}

// the score: the dot product scaled by __fmul_rn, then capped as softcap *
// tanhf(s / softcap) (softcap <= 0: none)
__device__ __forceinline__ float cap_score(float acc, float scale, float softcap) {
  float s = __fmul_rn(acc, scale);
  if (softcap > 0.0f) s = __fmul_rn(softcap, tanhf(__fdiv_rn(s, softcap)));
  return s;
}

}  // namespace flash
