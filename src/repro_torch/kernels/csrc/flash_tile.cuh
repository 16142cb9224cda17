// The online-softmax stream of the flash-attention kernels, shared by K3
// (zo_dual_flash_attention.cu, two streams per sweep) and K5
// (flash_attention.cu, one stream).
//
// One block owns (batch*head, BQ query rows) and loops over BKV-wide kv
// tiles.  4 * BQ threads, four per query row: a thread holds BKV/4 of the
// row's BKV scores and DC/4 of its output columns.  Q, K, V and the
// probability tile live in shared memory as f32 with rows of DC + 1 (or
// BKV + 1) floats.  DC is the compiled width: the head width D (any D <=
// 256, a runtime argument) loads into the next compiled width, columns
// past D as zeros, so they add exact zeros to every score and the columns
// past D of the output are never stored.  Tensors keep the model's (B, S,
// heads, D) layout and the loads compute their own offsets, so nothing is
// transposed, copied or padded in device memory.  The mask value is the
// finite NEG_INF = -2e38 and l is clamped at 1e-30, as in the TPU kernels
// (never -inf: a row whose first tiles are all masked must not produce
// inf - inf).
//
// Tiles (Tile<DC>): BQ = BKV = 64 up to DC = 128, 32 at DC = 256, where
// 64-row f32 tiles would not fit shared memory.  Shared memory, rows of
// DC + 1 floats:
//   DC = 128: K5 Q + K + V + P = 3 * 64 * 129 * 4 + 64 * 65 * 4 = 115,712 B;
//             K3 weights 2 Q + 4 KV + P = 214,784 B, scores 2 Q + 2 KV + P
//             = 148,736 B;
//   DC = 256: K5 3 * 32 * 257 * 4 + 32 * 33 * 4 = 102,912 B; K3 weights
//             6 * 32,896 + 4,224 = 201,600 B, scores 4 * 32,896 + 4,224 =
//             135,808 B;
// all within the 232,448 bytes a block can have.
//
// A stream's arithmetic is the same code whichever kernel runs it, with
// explicit fmaf where a product feeds a sum, and both kernels take the
// same Tile for a width, so K5 equals the matching stream of K3 bit for
// bit when neither adds score noise.
#pragma once

#include "convert.cuh"

namespace fa_tile {

constexpr float NEG_INF = -2.0e38f;

template <int DC_, int BQ_, int BKV_>
struct TileShape {
  static constexpr int DC = DC_, BQ = BQ_, BKV = BKV_;
  static constexpr int THREADS = 4 * BQ;   // four threads per query row
  static constexpr int LD = DC + 1;        // padded row of Q, K, V
  static constexpr int LDP = BKV + 1;      // padded row of P
  static constexpr int SPT = BKV / 4;      // scores per thread
  static constexpr int DPT = DC / 4;       // output columns per thread
  static constexpr int TILE_FLOATS = BQ * LD;   // one Q, K or V tile
  static constexpr int P_FLOATS = BQ * LDP;
  static_assert(BQ == BKV, "Q and K/V tiles share their row count");
};

// the compiled widths: 8, 16, 32, 64, 128 (64-row tiles) and 256 (32-row)
template <int DC>
using Tile = TileShape<DC, DC == 256 ? 32 : 64, DC == 256 ? 32 : 64>;

// Rows [row0, row0 + n_rows) of head `head` of a (B, S, heads, D) tensor
// into an (n_rows, DC + 1) f32 tile; rows past S and columns past D are
// zero.
template <class L, typename T>
__device__ __forceinline__ void load_tile(float* dst,
                                          const T* __restrict__ src, int b,
                                          int row0, int n_rows, int S,
                                          int heads, int head, int D,
                                          int tid) {
  for (int idx = tid; idx < n_rows * L::DC; idx += L::THREADS) {
    const int r = idx / L::DC, d = idx % L::DC;
    const int g = row0 + r;
    dst[r * L::LD + d] =
        g < S && d < D
            ? zo_load(src + (((int64_t)b * S + g) * heads + head) * D + d)
            : 0.0f;
  }
}

// The kv tiles [lo, hi) that can hold a valid entry for some query row of
// the block at q0: tiles above the causal diagonal or left of the window
// add nothing to a row that has any valid entry, so they are skipped.
template <class L>
__device__ __forceinline__ void kv_tile_range(int q0, int Sq, int Skv,
                                              int causal, int window,
                                              int& lo, int& hi) {
  const int q_last = min(q0 + L::BQ, Sq) - 1;
  hi = (Skv + L::BKV - 1) / L::BKV;
  if (causal) hi = min(hi, q_last / L::BKV + 1);
  lo = 0;
  if (window > 0 && q0 - window + 1 > 0) lo = (q0 - window + 1) / L::BKV;
}

// Which of this thread's kv columns of the tile at kv0 are valid for its
// query row: inside Skv, causal, inside the window.
template <class L>
__device__ __forceinline__ void kv_valid(bool (&valid)[L::SPT], int kv0,
                                         int lane4, int q_pos, int Skv,
                                         int causal, int window) {
#pragma unroll
  for (int c = 0; c < L::SPT; ++c) {
    const int kv_pos = kv0 + lane4 + 4 * c;
    bool ok = kv_pos < Skv;
    if (causal) ok = ok && q_pos >= kv_pos;
    if (window > 0) ok = ok && (q_pos - kv_pos) < window;
    valid[c] = ok;
  }
}

// This thread's scaled scores q . k for its row against the kv tile.
template <class L>
__device__ __forceinline__ void scores(float (&s)[L::SPT],
                                       const float* __restrict__ qs,
                                       const float* __restrict__ ks, int row,
                                       int lane4, float scale) {
#pragma unroll
  for (int c = 0; c < L::SPT; ++c) s[c] = 0.0f;
  for (int d = 0; d < L::DC; ++d) {
    const float q = qs[row * L::LD + d];
#pragma unroll
    for (int c = 0; c < L::SPT; ++c)
      s[c] = fmaf(q, ks[(lane4 + 4 * c) * L::LD + d], s[c]);
  }
#pragma unroll
  for (int c = 0; c < L::SPT; ++c) s[c] *= scale;
}

// gemma2-style soft-cap (cap <= 0: none)
__device__ __forceinline__ float softcap(float s, float cap) {
  return cap > 0.0f ? cap * tanhf(s / cap) : s;
}

// One stream's online-softmax update for the current kv tile.  `s` holds
// this thread's scores (scaled, capped, perturbed and masked); the four
// threads of a row are lanes 4i..4i+3 of one warp.
template <class L>
__device__ __forceinline__ void stream_update(
    float (&s)[L::SPT], const float* __restrict__ vs, float* __restrict__ ps,
    float& m, float& l, float (&acc)[L::DPT], int row, int lane4) {
  float mx = NEG_INF;
#pragma unroll
  for (int c = 0; c < L::SPT; ++c) mx = fmaxf(mx, s[c]);
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  const float m_new = fmaxf(m, mx);
  float sum = 0.0f;
#pragma unroll
  for (int c = 0; c < L::SPT; ++c) {
    s[c] = expf(s[c] - m_new);
    sum += s[c];
    ps[row * L::LDP + lane4 + 4 * c] = s[c];
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  const float alpha = expf(m - m_new);
  l = fmaf(l, alpha, sum);
  m = m_new;
  __syncwarp();
  float pv[L::DPT] = {};
  for (int j = 0; j < L::BKV; ++j) {
    const float p = ps[row * L::LDP + j];
#pragma unroll
    for (int e = 0; e < L::DPT; ++e)
      pv[e] = fmaf(p, vs[j * L::LD + lane4 + 4 * e], pv[e]);
  }
#pragma unroll
  for (int e = 0; e < L::DPT; ++e) acc[e] = fmaf(acc[e], alpha, pv[e]);
  __syncwarp();  // the row's p is read before the next stream rewrites it
}

// acc / max(l, 1e-30) into this thread's output columns below D.
template <class L, typename T>
__device__ __forceinline__ void store_row(T* __restrict__ o,
                                          const float (&acc)[L::DPT], float l,
                                          int b, int q_pos, int Sq, int H,
                                          int h, int D, int lane4) {
  if (q_pos >= Sq) return;
  const int64_t base = (((int64_t)b * Sq + q_pos) * H + h) * D;
  const float lc = fmaxf(l, 1e-30f);
#pragma unroll
  for (int e = 0; e < L::DPT; ++e) {
    const int col = lane4 + 4 * e;
    if (col < D) zo_store(o + base + col, acc[e] / lc);
  }
}

// The compiled width a head width D runs at: the smallest of 8, 16, 32,
// 64, 128, 256 that holds it; 0 past 256.
inline int compiled_width(int D) {
  for (int dc = 8; dc <= 256; dc *= 2)
    if (D <= dc) return dc;
  return 0;
}

}  // namespace fa_tile
