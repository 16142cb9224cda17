// Kernel K3: fused dual-probe flash attention.  Both streams of the
// two-point ZO estimator go through ONE sweep over the K/V tiles, each
// with its own online-softmax state (m, l, acc).
//
// Replaces the Pallas kernel `_zo_dual_fa_kernel` /
// `zo_dual_flash_attention` of src/repro/kernels/flash_attention.py.
// There the kv axis is a sequential grid axis with (m, l, acc) in VMEM
// scratch; here a block owns one query tile (64 rows; 32 on the loop
// past head_dim 128) of one (batch, head) and loops over the kv tiles
// itself.  Two modes:
//   * weights probe (kb != k): each stream attends its own K/V (the weight
//     noise was applied upstream by K2); the sweep, positions and mask are
//     shared;
//   * scores probe (kb == k): both streams share every K/V tile load, and
//     a perturbed stream adds mu * U[row_offset + h*Sq + q, kv] (hash.cuh)
//     to its scores after the soft-cap and before the mask.
// GQA reads kv head h / (H / Kv); causal masking, a local window and the
// soft-cap are supported; kv tiles masked for every row of the query tile
// are skipped.  Two routes, each running the stream code K5
// (flash_attention.cu) runs for its one stream, so in the weights mode
// each stream equals a K5 call on the same route bit for bit:
//   * zo_dual_flash_attention_tc: bf16 operands on the tensor cores
//     (flash_wgmma.cuh: one consumer warpgroup per stream, a producer warp
//     with a TMA ring of K/V tiles, wgmma for Q K^T and P V with P split
//     into two bf16 terms, the softmax and the score noise on the
//     accumulator fragments in registers), D a multiple of 8 up to 256;
//   * zo_dual_flash_attention: the CUDA-core loop (flash_tile.cuh; Q, K, V
//     and P as f32 in shared memory), for f32 and for bf16 that TMA cannot
//     take, any D up to 256: 64-row tiles up to D = 128 (the weights mode
//     takes 214,784 bytes of shared memory there), 32-row tiles past it
//     (201,600 bytes at D = 256).
//
// Bound on the H100: at gpt2-small (B=4, S=256, H=12, D=64) a call reads
// q, k, v of both streams and writes two outputs, ~12.6 MB in bf16, and
// does ~0.8 GFLOP on its causal half, so memory bounds it (~3.8 us).  The
// CUDA-core loop reads shared memory at every f32 FMA and runs one block
// per SM.  The tensor-core route reads each tile once with TMA, runs both
// products on the tensor cores (the P V product twice, for P's hi and lo
// terms) and keeps the scores in registers; at this shape its 192 blocks
// run 1-4 kv tiles each, so per-tile latency (the load, two dependent
// wgmma groups, the softmax between them) sets the time.
#include "flash_tile.cuh"
#include "flash_wgmma.cuh"
#include "hash.cuh"

namespace {

using namespace fa_tile;

struct Params {
  int B, Sq, Skv, H, Kv, D;
  int causal, window, perturb_a, perturb_b, shared_kv;
  float cap, scale, mu_a, mu_b;
  uint32_t seed, row_offset;
};

template <typename T, int DC>
__global__ void __launch_bounds__(Tile<DC>::THREADS)
    zo_dual_fa_kernel(const T* __restrict__ qa, const T* __restrict__ qb,
                      const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ kb, const T* __restrict__ vb,
                      T* __restrict__ oa, T* __restrict__ ob, Params p) {
  using L = Tile<DC>;
  extern __shared__ __align__(16) float smem[];
  float* qs_a = smem;
  float* qs_b = qs_a + L::TILE_FLOATS;
  float* ks_a = qs_b + L::TILE_FLOATS;
  float* vs_a = ks_a + L::TILE_FLOATS;
  float* ps = vs_a + L::TILE_FLOATS;
  float* ks_b = p.shared_kv ? ks_a : ps + L::P_FLOATS;
  float* vs_b = p.shared_kv ? vs_a : ks_b + L::TILE_FLOATS;

  const int tid = threadIdx.x;
  const int row = tid >> 2, lane4 = tid & 3;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.Kv);
  const int q0 = blockIdx.x * L::BQ;
  const int q_pos = q0 + row;

  load_tile<L>(qs_a, qa, b, q0, L::BQ, p.Sq, p.H, h, p.D, tid);
  load_tile<L>(qs_b, qb, b, q0, L::BQ, p.Sq, p.H, h, p.D, tid);

  float m_a = NEG_INF, l_a = 0.0f, m_b = NEG_INF, l_b = 0.0f;
  float acc_a[L::DPT] = {}, acc_b[L::DPT] = {};

  int t_lo, t_hi;
  kv_tile_range<L>(q0, p.Sq, p.Skv, p.causal, p.window, t_lo, t_hi);

  const uint32_t noise_row = p.row_offset + (uint32_t)(h * p.Sq + q_pos);
  for (int t = t_lo; t < t_hi; ++t) {
    const int kv0 = t * L::BKV;
    __syncthreads();  // the previous tile's K/V reads are done
    load_tile<L>(ks_a, k, b, kv0, L::BKV, p.Skv, p.Kv, kvh, p.D, tid);
    load_tile<L>(vs_a, v, b, kv0, L::BKV, p.Skv, p.Kv, kvh, p.D, tid);
    if (!p.shared_kv) {
      load_tile<L>(ks_b, kb, b, kv0, L::BKV, p.Skv, p.Kv, kvh, p.D, tid);
      load_tile<L>(vs_b, vb, b, kv0, L::BKV, p.Skv, p.Kv, kvh, p.D, tid);
    }
    __syncthreads();

    // shared between the streams: mask and (when probing) the noise
    bool valid[L::SPT];
    kv_valid<L>(valid, kv0, lane4, q_pos, p.Skv, p.causal, p.window);
    float un[L::SPT];
#pragma unroll
    for (int c = 0; c < L::SPT; ++c)
      un[c] = (p.perturb_a || p.perturb_b)
                  ? zo_uniform(p.seed, noise_row,
                               (uint32_t)(kv0 + lane4 + 4 * c))
                  : 0.0f;

    float s[L::SPT];
    // stream a
    scores<L>(s, qs_a, ks_a, row, lane4, p.scale);
#pragma unroll
    for (int c = 0; c < L::SPT; ++c) {
      s[c] = softcap(s[c], p.cap);
      if (p.perturb_a) s[c] = __fadd_rn(s[c], __fmul_rn(p.mu_a, un[c]));
      if (!valid[c]) s[c] = NEG_INF;
    }
    stream_update<L>(s, vs_a, ps, m_a, l_a, acc_a, row, lane4);
    // stream b
    scores<L>(s, qs_b, ks_b, row, lane4, p.scale);
#pragma unroll
    for (int c = 0; c < L::SPT; ++c) {
      s[c] = softcap(s[c], p.cap);
      if (p.perturb_b) s[c] = __fadd_rn(s[c], __fmul_rn(p.mu_b, un[c]));
      if (!valid[c]) s[c] = NEG_INF;
    }
    stream_update<L>(s, vs_b, ps, m_b, l_b, acc_b, row, lane4);
  }

  store_row<L>(oa, acc_a, l_a, b, q_pos, p.Sq, p.H, h, p.D, lane4);
  store_row<L>(ob, acc_b, l_b, b, q_pos, p.Sq, p.H, h, p.D, lane4);
}

template <typename T, int DC>
int launch(const void* qa, const void* qb, const void* k, const void* v,
           const void* kb, const void* vb, void* oa, void* ob,
           const Params& p, cudaStream_t stream) {
  using L = Tile<DC>;
  // Q a/b, K/V of one or both streams, and P (flash_tile.cuh has the sums)
  const int kv_tiles = p.shared_kv ? 2 : 4;
  const size_t smem =
      ((size_t)(2 + kv_tiles) * L::TILE_FLOATS + L::P_FLOATS) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      zo_dual_fa_kernel<T, DC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Sq + L::BQ - 1) / L::BQ, p.B * p.H);
  zo_dual_fa_kernel<T, DC><<<grid, L::THREADS, smem, stream>>>(
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
  if (Kv <= 0 || H % Kv != 0 || head_dim <= 0)
    return (int)cudaErrorInvalidValue;
  const Params p{B,         Sq,        Skv,       H,         Kv,
                 head_dim,  causal,    window,    perturb_a, perturb_b,
                 shared_kv, cap,       scale,     mu_a,      mu_b,
                 seed,      row_offset};
  cudaStream_t s = (cudaStream_t)stream;
  const int dc = fa_tile::compiled_width(head_dim);
#define REPRO_FA_CASE(DIM)                                                \
  if (dc == DIM) {                                                        \
    if (dtype == REPRO_DTYPE_BF16)                                        \
      return launch<__nv_bfloat16, DIM>(qa, qb, k, v, kb, vb, oa, ob, p, s); \
    if (dtype == REPRO_DTYPE_F32)                                         \
      return launch<float, DIM>(qa, qb, k, v, kb, vb, oa, ob, p, s);      \
  }
  REPRO_FA_CASE(8)
  REPRO_FA_CASE(16)
  REPRO_FA_CASE(32)
  REPRO_FA_CASE(64)
  REPRO_FA_CASE(128)
  REPRO_FA_CASE(256)
#undef REPRO_FA_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" int zo_dual_flash_attention_tc(
    const void* qa, const void* qb, const void* k, const void* v,
    const void* kb, const void* vb, void* oa, void* ob, int B, int Sq,
    int Skv, int H, int Kv, int head_dim, int shared_kv, int perturb_a,
    int perturb_b, int causal, int window, float cap, float scale,
    unsigned int seed, float mu_a, float mu_b, unsigned int row_offset,
    void* stream) {
  const void* const qs[2] = {qa, qb};
  const void* const ks[2] = {k, kb};
  const void* const vs[2] = {v, vb};
  void* const os[2] = {oa, ob};
  const float mu[2] = {mu_a, mu_b};
  const int perturb[2] = {perturb_a, perturb_b};
  return fa_wgmma::launch<2>(qs, ks, vs, os, mu, perturb, shared_kv != 0, B,
                             Sq, Skv, H, Kv, head_dim, causal, window, cap,
                             scale, seed, row_offset, (cudaStream_t)stream);
}
