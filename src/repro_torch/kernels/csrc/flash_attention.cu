// Kernel K5: single-stream flash attention (online softmax),
//   o = softmax(mask(softcap(scale * q k^T))) v,
// q (B, Sq, H, D), k and v (B, Skv, Kv, D), o like q.
//
// Replaces the Pallas kernel `_fa_kernel` / `flash_attention` of
// src/repro/kernels/flash_attention.py.  There the kv axis is a sequential
// grid axis with (m, l, acc) in VMEM scratch, and the wrapper transposes
// to (B*H, S, D) and pads Skv to the block; here one block owns
// (batch*head, 64 query rows), loops over 64-wide kv tiles itself with
// flash_tile.cuh's stream code, reads the (B, S, heads, D) layout with
// its own offsets and masks the ragged Skv tail.  It is the stream code K3
// (zo_dual_flash_attention.cu) runs twice per sweep, so K5 equals K3's
// stream in the weights mode bit for bit.  The single-probe model forward
// calls it for the attention of every perturbed layer.  GQA (q head h
// reads kv head h / (H / Kv)), causal masking, a local window and the
// soft-cap; the finite NEG_INF = -2e38 and l >= 1e-30 as in the TPU
// kernel.  D is a template parameter: 16, 32 or 64.  Q, K, V and the
// probability tile take 66.5 KB of dynamic shared memory at D = 64, so the
// launch raises the 48 KB default with cudaFuncSetAttribute.
//
// Bound on the H100: at gpt2-small (B=4, S=256, H=12, D=64, bf16) a call
// reads q, k, v and writes o, ~6.3 MB, and does ~0.4 GFLOP on its causal
// half, so memory bounds it (~1.9 us).  Like K3 it does the products with
// f32 FMAs on the CUDA cores from shared memory; mma/wgmma on bf16 tiles
// and a cp.async/TMA ring are what it leaves on the table.
#include "flash_tile.cuh"

namespace {

using namespace fa_tile;

struct Params {
  int B, Sq, Skv, H, Kv, causal, window;
  float cap, scale;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    fa_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, Params p) {
  constexpr int LD = D + 1, DPT = D / 4;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + BQ * LD;
  float* vs = ks + BKV * LD;
  float* ps = vs + BKV * LD;

  const int tid = threadIdx.x;
  const int row = tid >> 2, lane4 = tid & 3;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.Kv);
  const int q0 = blockIdx.x * BQ;
  const int q_pos = q0 + row;

  load_tile<T, D>(qs, q, b, q0, BQ, p.Sq, p.H, h, tid);

  float m = NEG_INF, l = 0.0f;
  float acc[DPT] = {};

  int t_lo, t_hi;
  kv_tile_range(q0, p.Sq, p.Skv, p.causal, p.window, t_lo, t_hi);
  for (int t = t_lo; t < t_hi; ++t) {
    const int kv0 = t * BKV;
    __syncthreads();  // the previous tile's K/V reads are done
    load_tile<T, D>(ks, k, b, kv0, BKV, p.Skv, p.Kv, kvh, tid);
    load_tile<T, D>(vs, v, b, kv0, BKV, p.Skv, p.Kv, kvh, tid);
    __syncthreads();

    bool valid[SPT];
    kv_valid(valid, kv0, lane4, q_pos, p.Skv, p.causal, p.window);
    float s[SPT];
    scores<D>(s, qs, ks, row, lane4, p.scale);
#pragma unroll
    for (int c = 0; c < SPT; ++c) {
      s[c] = softcap(s[c], p.cap);
      if (!valid[c]) s[c] = NEG_INF;
    }
    stream_update<D>(s, vs, ps, m, l, acc, row, lane4);
  }

  store_row<T, D>(o, acc, l, b, q_pos, p.Sq, p.H, h, lane4);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const Params& p, cudaStream_t stream) {
  // Q, K, V (BQ == BKV rows of D + 1) and P
  const size_t smem =
      ((size_t)3 * BQ * (D + 1) + (size_t)BQ * LDP) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fa_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.B * p.H);
  fa_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int Sq, int Skv, int H,
                               int Kv, int head_dim, int dtype, int causal,
                               int window, float cap, float scale,
                               void* stream) {
  if (Kv <= 0 || H % Kv != 0) return (int)cudaErrorInvalidValue;
  const Params p{B, Sq, Skv, H, Kv, causal, window, cap, scale};
  cudaStream_t s = (cudaStream_t)stream;
#define REPRO_FA_CASE(DIM)                                          \
  if (head_dim == DIM) {                                            \
    if (dtype == REPRO_DTYPE_BF16)                                  \
      return launch<__nv_bfloat16, DIM>(q, k, v, o, p, s);          \
    if (dtype == REPRO_DTYPE_F32)                                   \
      return launch<float, DIM>(q, k, v, o, p, s);                  \
  }
  REPRO_FA_CASE(16)
  REPRO_FA_CASE(32)
  REPRO_FA_CASE(64)
#undef REPRO_FA_CASE
  return (int)cudaErrorInvalidValue;
}
