// The online-softmax stream of the flash-attention kernels, shared by K3
// (zo_dual_flash_attention.cu, two streams per sweep) and K5
// (flash_attention.cu, one stream).
//
// One block owns (batch*head, 64 query rows) and loops over 64-wide kv
// tiles.  256 threads, four per query row: a thread holds 16 of the row's
// 64 scores and D/4 of its D output columns.  Q, K, V and the probability
// tile live in shared memory as f32 with rows of D + 1 (or 64 + 1) floats.
// Tensors keep the model's (B, S, heads, D) layout and the loads compute
// their own offsets, so nothing is transposed or padded.  The mask value
// is the finite NEG_INF = -2e38 and l is clamped at 1e-30, as in the TPU
// kernels (never -inf: a row whose first tiles are all masked must not
// produce inf - inf).
//
// A stream's arithmetic is the same code whichever kernel runs it, with
// explicit fmaf where a product feeds a sum, so K5 equals the matching
// stream of K3 bit for bit when neither adds score noise.
#pragma once

#include "convert.cuh"

namespace fa_tile {

constexpr int BQ = 64, BKV = 64, THREADS = 256;
constexpr int LDP = BKV + 1;      // padded row of the probability tile
constexpr int SPT = BKV / 4;      // scores per thread (4 threads per row)
constexpr float NEG_INF = -2.0e38f;

// Rows [row0, row0 + n_rows) of head `head` of a (B, S, heads, D) tensor
// into a (n_rows, D + 1) f32 tile; rows past S are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst,
                                          const T* __restrict__ src, int b,
                                          int row0, int n_rows, int S,
                                          int heads, int head, int tid) {
  for (int idx = tid; idx < n_rows * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    const int g = row0 + r;
    dst[r * (D + 1) + d] =
        g < S ? zo_load(src + (((int64_t)b * S + g) * heads + head) * D + d)
              : 0.0f;
  }
}

// The kv tiles [lo, hi) that can hold a valid entry for some query row of
// the block at q0: tiles above the causal diagonal or left of the window
// add nothing to a row that has any valid entry, so they are skipped.
__device__ __forceinline__ void kv_tile_range(int q0, int Sq, int Skv,
                                              int causal, int window,
                                              int& lo, int& hi) {
  const int q_last = min(q0 + BQ, Sq) - 1;
  hi = (Skv + BKV - 1) / BKV;
  if (causal) hi = min(hi, q_last / BKV + 1);
  lo = 0;
  if (window > 0 && q0 - window + 1 > 0) lo = (q0 - window + 1) / BKV;
}

// Which of this thread's 16 kv columns of the tile at kv0 are valid for
// its query row: inside Skv, causal, inside the window.
__device__ __forceinline__ void kv_valid(bool (&valid)[SPT], int kv0,
                                         int lane4, int q_pos, int Skv,
                                         int causal, int window) {
#pragma unroll
  for (int c = 0; c < SPT; ++c) {
    const int kv_pos = kv0 + lane4 + 4 * c;
    bool ok = kv_pos < Skv;
    if (causal) ok = ok && q_pos >= kv_pos;
    if (window > 0) ok = ok && (q_pos - kv_pos) < window;
    valid[c] = ok;
  }
}

// This thread's scaled scores q . k for its row against the kv tile.
template <int D>
__device__ __forceinline__ void scores(float (&s)[SPT],
                                       const float* __restrict__ qs,
                                       const float* __restrict__ ks, int row,
                                       int lane4, float scale) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int c = 0; c < SPT; ++c) s[c] = 0.0f;
  for (int d = 0; d < D; ++d) {
    const float q = qs[row * LD + d];
#pragma unroll
    for (int c = 0; c < SPT; ++c)
      s[c] = fmaf(q, ks[(lane4 + 4 * c) * LD + d], s[c]);
  }
#pragma unroll
  for (int c = 0; c < SPT; ++c) s[c] *= scale;
}

// gemma2-style soft-cap (cap <= 0: none)
__device__ __forceinline__ float softcap(float s, float cap) {
  return cap > 0.0f ? cap * tanhf(s / cap) : s;
}

// One stream's online-softmax update for the current kv tile.  `s` holds
// this thread's scores (scaled, capped, perturbed and masked); the four
// threads of a row are lanes 4i..4i+3 of one warp.
template <int D>
__device__ __forceinline__ void stream_update(
    float (&s)[SPT], const float* __restrict__ vs, float* __restrict__ ps,
    float& m, float& l, float (&acc)[D / 4], int row, int lane4) {
  constexpr int LD = D + 1, DPT = D / 4;
  float mx = NEG_INF;
#pragma unroll
  for (int c = 0; c < SPT; ++c) mx = fmaxf(mx, s[c]);
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  const float m_new = fmaxf(m, mx);
  float sum = 0.0f;
#pragma unroll
  for (int c = 0; c < SPT; ++c) {
    s[c] = expf(s[c] - m_new);
    sum += s[c];
    ps[row * LDP + lane4 + 4 * c] = s[c];
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  const float alpha = expf(m - m_new);
  l = fmaf(l, alpha, sum);
  m = m_new;
  __syncwarp();
  float pv[DPT] = {};
  for (int j = 0; j < BKV; ++j) {
    const float p = ps[row * LDP + j];
#pragma unroll
    for (int e = 0; e < DPT; ++e)
      pv[e] = fmaf(p, vs[j * LD + lane4 + 4 * e], pv[e]);
  }
#pragma unroll
  for (int e = 0; e < DPT; ++e) acc[e] = fmaf(acc[e], alpha, pv[e]);
  __syncwarp();  // the row's p is read before the next stream rewrites it
}

// acc / max(l, 1e-30) into this thread's D/4 columns of the output row.
template <typename T, int D>
__device__ __forceinline__ void store_row(T* __restrict__ o,
                                          const float (&acc)[D / 4], float l,
                                          int b, int q_pos, int Sq, int H,
                                          int h, int lane4) {
  if (q_pos >= Sq) return;
  const int64_t base = (((int64_t)b * Sq + q_pos) * H + h) * D;
  const float lc = fmaxf(l, 1e-30f);
#pragma unroll
  for (int e = 0; e < D / 4; ++e) zo_store(o + base + lane4 + 4 * e,
                                           acc[e] / lc);
}

}  // namespace fa_tile
