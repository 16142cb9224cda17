// Kernel K3: fused dual-probe flash attention.  Both streams of the
// two-point ZO estimator go through ONE sweep over the K/V tiles, each
// with its own online-softmax state (m, l, acc).
//
// Replaces the Pallas kernel `_zo_dual_fa_kernel` /
// `zo_dual_flash_attention` of src/repro/kernels/flash_attention.py.
// There the kv axis is a sequential grid axis with (m, l, acc) in VMEM
// scratch; here one block owns (batch*head, 64 query rows) and loops over
// 64-wide kv tiles itself.  Two modes:
//   * weights probe (kb != k): each stream attends its own K/V (the weight
//     noise was applied upstream by K2); the sweep, positions and mask are
//     shared;
//   * scores probe (kb == k): both streams share every K/V tile load, and
//     a perturbed stream adds mu * U[row_offset + h*Sq + q, kv] (hash.cuh)
//     to its scores after the soft-cap and before the mask.
// GQA reads kv head h / (H / Kv); causal masking, a local window and the
// soft-cap are supported.  The mask value is the finite NEG_INF = -2e38
// and l is clamped at 1e-30, as in the TPU kernel (never -inf: a row whose
// first tiles are all masked must not produce inf - inf).  kv tiles that
// are masked for every row of the block (above the causal diagonal, or
// left of the window) are skipped: they add nothing to a row that has any
// valid entry.  Tensors keep the model's (B, S, heads, D) layout; the
// kernel computes its own strides, so no transpose or padding is needed.
//
// Thread layout: 256 threads, four per query row.  A thread holds 16 of
// the row's 64 scores and D/4 of its D output columns per stream (D is a
// template parameter: 16, 32 or 64).  Q, K, V and the probability tile
// live in dynamic shared memory as f32 (116 KB in the weights mode at
// D = 64, above the 48 KB default, so the launch raises the limit with
// cudaFuncSetAttribute).
//
// Bound on the H100: at gpt2-small (B=4, S=256, H=12, D=64) a call reads
// q, k, v of both streams and writes two outputs, ~12.6 MB in bf16, and
// does ~0.8 GFLOP on its causal half, so memory bounds it (~3.8 us).  This
// simple design does the products with f32 FMAs on the CUDA cores, reads
// shared memory at every FMA, and runs one block per SM; mma/wgmma on
// bf16 tiles, K/V in bf16 shared memory and a cp.async/TMA ring are what
// it leaves on the table.
#include "convert.cuh"
#include "hash.cuh"

namespace {

constexpr int BQ = 64, BKV = 64, THREADS = 256;
constexpr int LDP = BKV + 1;      // padded row of the probability tile
constexpr int SPT = BKV / 4;      // scores per thread (4 threads per row)
constexpr float NEG_INF = -2.0e38f;

struct Params {
  int B, Sq, Skv, H, Kv;
  int causal, window, perturb_a, perturb_b, shared_kv;
  float cap, scale, mu_a, mu_b;
  uint32_t seed, row_offset;
};

template <typename T, int D>
__device__ void load_tile(float* dst, const T* __restrict__ src, int b,
                          int row0, int n_rows, int S, int heads, int head,
                          int tid) {
  for (int idx = tid; idx < n_rows * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    const int g = row0 + r;
    dst[r * (D + 1) + d] =
        g < S ? zo_load(src + (((int64_t)b * S + g) * heads + head) * D + d)
              : 0.0f;
  }
}

// One stream's online-softmax update for the current kv tile.  `s` holds
// this thread's scores (already scaled, capped and perturbed); the four
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
  l = l * alpha + sum;
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
  for (int e = 0; e < DPT; ++e) acc[e] = acc[e] * alpha + pv[e];
  __syncwarp();  // the row's p is read before the next stream rewrites it
}

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

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    zo_dual_fa_kernel(const T* __restrict__ qa, const T* __restrict__ qb,
                      const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ kb, const T* __restrict__ vb,
                      T* __restrict__ oa, T* __restrict__ ob, Params p) {
  constexpr int LD = D + 1, DPT = D / 4;
  extern __shared__ __align__(16) float smem[];
  float* qs_a = smem;
  float* qs_b = qs_a + BQ * LD;
  float* ks_a = qs_b + BQ * LD;
  float* vs_a = ks_a + BKV * LD;
  float* ps = vs_a + BKV * LD;
  float* ks_b = p.shared_kv ? ks_a : ps + BQ * LDP;
  float* vs_b = p.shared_kv ? vs_a : ks_b + BKV * LD;

  const int tid = threadIdx.x;
  const int row = tid >> 2, lane4 = tid & 3;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.Kv);
  const int q0 = blockIdx.x * BQ;
  const int q_pos = q0 + row;

  load_tile<T, D>(qs_a, qa, b, q0, BQ, p.Sq, p.H, h, tid);
  load_tile<T, D>(qs_b, qb, b, q0, BQ, p.Sq, p.H, h, tid);

  float m_a = NEG_INF, l_a = 0.0f, m_b = NEG_INF, l_b = 0.0f;
  float acc_a[DPT] = {}, acc_b[DPT] = {};

  // kv tiles that can hold a valid entry for some row of this block
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  int t_hi = (p.Skv + BKV - 1) / BKV;
  if (p.causal) t_hi = min(t_hi, q_last / BKV + 1);
  int t_lo = 0;
  if (p.window > 0 && q0 - p.window + 1 > 0)
    t_lo = (q0 - p.window + 1) / BKV;

  const uint32_t noise_row = p.row_offset + (uint32_t)(h * p.Sq + q_pos);
  for (int t = t_lo; t < t_hi; ++t) {
    const int kv0 = t * BKV;
    __syncthreads();  // the previous tile's K/V reads are done
    load_tile<T, D>(ks_a, k, b, kv0, BKV, p.Skv, p.Kv, kvh, tid);
    load_tile<T, D>(vs_a, v, b, kv0, BKV, p.Skv, p.Kv, kvh, tid);
    if (!p.shared_kv) {
      load_tile<T, D>(ks_b, kb, b, kv0, BKV, p.Skv, p.Kv, kvh, tid);
      load_tile<T, D>(vs_b, vb, b, kv0, BKV, p.Skv, p.Kv, kvh, tid);
    }
    __syncthreads();

    // shared between the streams: mask and (when probing) the noise
    bool valid[SPT];
    float un[SPT];
#pragma unroll
    for (int c = 0; c < SPT; ++c) {
      const int kv_pos = kv0 + lane4 + 4 * c;
      bool ok = kv_pos < p.Skv;
      if (p.causal) ok = ok && q_pos >= kv_pos;
      if (p.window > 0) ok = ok && (q_pos - kv_pos) < p.window;
      valid[c] = ok;
      un[c] = (p.perturb_a || p.perturb_b)
                  ? zo_uniform(p.seed, noise_row, (uint32_t)kv_pos)
                  : 0.0f;
    }

    float s[SPT];
    // stream a
    scores<D>(s, qs_a, ks_a, row, lane4, p.scale);
#pragma unroll
    for (int c = 0; c < SPT; ++c) {
      if (p.cap > 0.0f) s[c] = p.cap * tanhf(s[c] / p.cap);
      if (p.perturb_a) s[c] = __fadd_rn(s[c], __fmul_rn(p.mu_a, un[c]));
      if (!valid[c]) s[c] = NEG_INF;
    }
    stream_update<D>(s, vs_a, ps, m_a, l_a, acc_a, row, lane4);
    // stream b
    scores<D>(s, qs_b, ks_b, row, lane4, p.scale);
#pragma unroll
    for (int c = 0; c < SPT; ++c) {
      if (p.cap > 0.0f) s[c] = p.cap * tanhf(s[c] / p.cap);
      if (p.perturb_b) s[c] = __fadd_rn(s[c], __fmul_rn(p.mu_b, un[c]));
      if (!valid[c]) s[c] = NEG_INF;
    }
    stream_update<D>(s, vs_b, ps, m_b, l_b, acc_b, row, lane4);
  }

  if (q_pos < p.Sq) {
    const int64_t base = (((int64_t)b * p.Sq + q_pos) * p.H + h) * D;
    const float la = fmaxf(l_a, 1e-30f), lb = fmaxf(l_b, 1e-30f);
#pragma unroll
    for (int e = 0; e < DPT; ++e) {
      const int d = lane4 + 4 * e;
      zo_store(oa + base + d, acc_a[e] / la);
      zo_store(ob + base + d, acc_b[e] / lb);
    }
  }
}

template <typename T, int D>
int launch(const void* qa, const void* qb, const void* k, const void* v,
           const void* kb, const void* vb, void* oa, void* ob,
           const Params& p, cudaStream_t stream) {
  // Q a/b, K/V of one or both streams (BQ == BKV rows of D + 1), and P
  const int kv_tiles = p.shared_kv ? 2 : 4;
  const size_t smem =
      ((size_t)(2 + kv_tiles) * BQ * (D + 1) + (size_t)BQ * LDP) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      zo_dual_fa_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.B * p.H);
  zo_dual_fa_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      (const T*)qa, (const T*)qb, (const T*)k, (const T*)v, (const T*)kb,
      (const T*)vb, (T*)oa, (T*)ob, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int zo_dual_flash_attention(
    const void* qa, const void* qb, const void* k, const void* v,
    const void* kb, const void* vb, void* oa, void* ob, int B, int Sq,
    int Skv, int H, int Kv, int head_dim, int dtype, int shared_kv,
    int perturb_a, int perturb_b, int causal, int window, float cap,
    float scale, unsigned int seed, float mu_a, float mu_b,
    unsigned int row_offset, void* stream) {
  if (Kv <= 0 || H % Kv != 0) return (int)cudaErrorInvalidValue;
  const Params p{B,         Sq,        Skv,       H,      Kv,
                 causal,    window,    perturb_a, perturb_b, shared_kv,
                 cap,       scale,     mu_a,      mu_b,   seed,
                 row_offset};
  cudaStream_t s = (cudaStream_t)stream;
#define REPRO_FA_CASE(DIM)                                                \
  if (head_dim == DIM) {                                                  \
    if (dtype == REPRO_DTYPE_BF16)                                        \
      return launch<__nv_bfloat16, DIM>(qa, qb, k, v, kb, vb, oa, ob, p, s); \
    if (dtype == REPRO_DTYPE_F32)                                         \
      return launch<float, DIM>(qa, qb, k, v, kb, vb, oa, ob, p, s);      \
  }
  REPRO_FA_CASE(16)
  REPRO_FA_CASE(32)
  REPRO_FA_CASE(64)
#undef REPRO_FA_CASE
  return (int)cudaErrorInvalidValue;
}
