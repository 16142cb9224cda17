// Kernel K5: single-stream flash attention (online softmax),
//   o = softmax(mask(softcap(scale * q k^T))) v,
// q (B, Sq, H, D), k and v (B, Skv, Kv, D), o like q.
//
// Replaces the Pallas kernel `_fa_kernel` / `flash_attention` of
// src/repro/kernels/flash_attention.py.  There the kv axis is a sequential
// grid axis with (m, l, acc) in VMEM scratch, and the wrapper transposes
// to (B*H, S, D) and pads Skv to the block; here one block owns one
// query tile (64 rows; 32 on the loop past head_dim 128) of one (batch,
// head) and loops over the kv tiles itself, reading the (B, S, heads, D)
// layout with its own offsets.  GQA
// (q head h reads kv head h / (H / Kv)), causal masking, a local window
// and the soft-cap; the finite NEG_INF = -2e38 and l >= 1e-30 as in the TPU
// kernel.  The single-probe model forward calls it for the attention of
// every perturbed layer.  Two routes, each the one-stream instance of
// K3's (zo_dual_flash_attention.cu), so K5 equals K3's stream in the
// weights mode bit for bit on either:
//   * flash_attention_tc: bf16 operands on the tensor cores
//     (flash_wgmma.cuh: TMA ring, wgmma for Q K^T and P V, the softmax on
//     the accumulator fragments in registers), D a multiple of 8 up to 256;
//   * flash_attention: the CUDA-core loop (flash_tile.cuh), for f32 and
//     for bf16 that TMA cannot take, any D up to 256 (32-row tiles at
//     widths past 128, so the f32 tiles fit shared memory).
//
// Bound on the H100: at gpt2-small (B=4, S=256, H=12, D=64, bf16) a call
// reads q, k, v and writes o, ~6.3 MB, and does ~0.4 GFLOP on its causal
// half, so memory bounds it (~1.9 us).  The CUDA-core loop sits far above
// that: f32 FMAs from shared memory.  The tensor-core route loads each
// tile once with TMA and keeps the products on the tensor cores and the
// softmax in registers; at this shape its 192 blocks run 1-4 kv tiles
// each, so the latency of a tile's load, its two dependent wgmma groups
// and its softmax set the time, not bytes or operations.
#include "flash_tile.cuh"
#include "flash_wgmma.cuh"

namespace {

using namespace fa_tile;

struct Params {
  int B, Sq, Skv, H, Kv, D, causal, window;
  float cap, scale;
};

template <typename T, int DC>
__global__ void __launch_bounds__(Tile<DC>::THREADS)
    fa_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, Params p) {
  using L = Tile<DC>;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + L::TILE_FLOATS;
  float* vs = ks + L::TILE_FLOATS;
  float* ps = vs + L::TILE_FLOATS;

  const int tid = threadIdx.x;
  const int row = tid >> 2, lane4 = tid & 3;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.Kv);
  const int q0 = blockIdx.x * L::BQ;
  const int q_pos = q0 + row;

  load_tile<L>(qs, q, b, q0, L::BQ, p.Sq, p.H, h, p.D, tid);

  float m = NEG_INF, l = 0.0f;
  float acc[L::DPT] = {};

  int t_lo, t_hi;
  kv_tile_range<L>(q0, p.Sq, p.Skv, p.causal, p.window, t_lo, t_hi);
  for (int t = t_lo; t < t_hi; ++t) {
    const int kv0 = t * L::BKV;
    __syncthreads();  // the previous tile's K/V reads are done
    load_tile<L>(ks, k, b, kv0, L::BKV, p.Skv, p.Kv, kvh, p.D, tid);
    load_tile<L>(vs, v, b, kv0, L::BKV, p.Skv, p.Kv, kvh, p.D, tid);
    __syncthreads();

    bool valid[L::SPT];
    kv_valid<L>(valid, kv0, lane4, q_pos, p.Skv, p.causal, p.window);
    float s[L::SPT];
    scores<L>(s, qs, ks, row, lane4, p.scale);
#pragma unroll
    for (int c = 0; c < L::SPT; ++c) {
      s[c] = softcap(s[c], p.cap);
      if (!valid[c]) s[c] = NEG_INF;
    }
    stream_update<L>(s, vs, ps, m, l, acc, row, lane4);
  }

  store_row<L>(o, acc, l, b, q_pos, p.Sq, p.H, h, p.D, lane4);
}

template <typename T, int DC>
int launch(const void* q, const void* k, const void* v, void* o,
           const Params& p, cudaStream_t stream) {
  using L = Tile<DC>;
  // Q, K, V and P (flash_tile.cuh has the sums)
  const size_t smem = (3 * (size_t)L::TILE_FLOATS + L::P_FLOATS) *
                      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fa_kernel<T, DC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Sq + L::BQ - 1) / L::BQ, p.B * p.H);
  fa_kernel<T, DC><<<grid, L::THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int Sq, int Skv, int H,
                               int Kv, int head_dim, int dtype, int causal,
                               int window, float cap, float scale,
                               void* stream) {
  if (Kv <= 0 || H % Kv != 0 || head_dim <= 0)
    return (int)cudaErrorInvalidValue;
  const Params p{B, Sq, Skv, H, Kv, head_dim, causal, window, cap, scale};
  cudaStream_t s = (cudaStream_t)stream;
  const int dc = fa_tile::compiled_width(head_dim);
#define REPRO_FA_CASE(DIM)                                          \
  if (dc == DIM) {                                                  \
    if (dtype == REPRO_DTYPE_BF16)                                  \
      return launch<__nv_bfloat16, DIM>(q, k, v, o, p, s);          \
    if (dtype == REPRO_DTYPE_F32)                                   \
      return launch<float, DIM>(q, k, v, o, p, s);                  \
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

extern "C" int flash_attention_tc(const void* q, const void* k,
                                  const void* v, void* o, int B, int Sq,
                                  int Skv, int H, int Kv, int head_dim,
                                  int causal, int window, float cap,
                                  float scale, void* stream) {
  const void* const qs[1] = {q};
  const void* const ks[1] = {k};
  const void* const vs[1] = {v};
  void* const os[1] = {o};
  const float mu[1] = {0.0f};
  const int perturb[1] = {0};
  return fa_wgmma::launch<1>(qs, ks, vs, os, mu, perturb, false, B, Sq, Skv,
                             H, Kv, head_dim, causal, window, cap, scale, 0u,
                             0u, (cudaStream_t)stream);
}
