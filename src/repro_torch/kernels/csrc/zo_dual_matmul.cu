// Kernel K2: the fused dual probe of the two-point ZO estimator,
//   (ya, yb) = (xa @ (W + mu_a*U), xb @ (W + mu_b*U)),
// with U the counter-hash field of hash.cuh on W's global coordinates
// (rows shifted by row_offset for a leaf stacked along a scan axis).
//
// Replaces the Pallas kernel `_zo_dual_kernel` / `zo_dual_matmul` of
// src/repro/kernels/zo_matmul.py.  There the k axis is a sequential grid
// axis with an f32 VMEM accumulator; here it is a loop inside one block,
// and blocks run in parallel over 64x64 output tiles.  At each k step of
// 32 the block loads one W tile into shared memory, forms W + mu*U for it
// once (noise from global coordinates, so the tiling never shows in the
// result), and feeds it to TWO register accumulators, one per stream:
// one read of W and one noise tile serve both losses of the pair.
// perturb_a / perturb_b are template parameters, as the TPU kernel's
// static flags.  bf16 or f32 inputs, f32 accumulation, output in x's type;
// ragged edges are masked in the kernel, nothing needs padding.
//
// Bound on the H100: at gpt2-small's client shapes (M = 1024 rows per
// stream, K x N up to 768 x 3072) the work is ~9.7 GFLOP for ~20 MB, so
// the bf16 tensor-core rate bounds it (~10 us).  This simple design runs
// f32 FMAs on the CUDA cores (67 TFLOP/s peak, before the hash and the
// shared-memory traffic), so it sits far above that bound.  What it leaves
// on the table: wgmma on bf16 tiles, TMA loads into a multi-stage ring,
// and generating the noise tile once per W tile across the M blocks.
#include "convert.cuh"
#include "hash.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 32, THREADS = 256;

template <typename T, bool PA, bool PB>
__global__ void __launch_bounds__(THREADS)
    zo_dual_matmul_kernel(const T* __restrict__ xa, const T* __restrict__ xb,
                          const T* __restrict__ w, T* __restrict__ ya,
                          T* __restrict__ yb, int M, int K, int N,
                          uint32_t seed, float mu_a, float mu_b,
                          uint32_t row_offset) {
  // x tiles are stored k-major (transposed) so a thread's 4 rows are one
  // float4; the +4 pad keeps rows 16-byte aligned and spreads the banks.
  __shared__ __align__(16) float xs_a[BK][BM + 4];
  __shared__ __align__(16) float xs_b[BK][BM + 4];
  __shared__ __align__(16) float ws_a[BK][BN];
  __shared__ __align__(16) float ws_b[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // 4 cols x 4 rows per thread
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc_a[4][4] = {}, acc_b[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int e = 0; e < (BM * BK) / THREADS; ++e) {
      const int idx = tid + e * THREADS;
      const int mi = idx / BK, ki = idx % BK;
      const int gm = m0 + mi, gk = k0 + ki;
      const bool ok = gm < M && gk < K;
      const int64_t off = (int64_t)gm * K + gk;
      xs_a[ki][mi] = ok ? zo_load(xa + off) : 0.0f;
      xs_b[ki][mi] = ok ? zo_load(xb + off) : 0.0f;
    }
#pragma unroll
    for (int e = 0; e < (BK * BN) / THREADS; ++e) {
      const int idx = tid + e * THREADS;
      const int ki = idx / BN, ni = idx % BN;
      const int gk = k0 + ki, gn = n0 + ni;
      const bool ok = gk < K && gn < N;
      const float wv = ok ? zo_load(w + (int64_t)gk * N + gn) : 0.0f;
      float u = 0.0f;
      if (PA || PB) {
        u = ok ? zo_uniform(seed, row_offset + (uint32_t)gk, (uint32_t)gn)
               : 0.0f;
      }
      ws_a[ki][ni] = PA ? __fadd_rn(wv, __fmul_rn(mu_a, u)) : wv;
      ws_b[ki][ni] = PB ? __fadd_rn(wv, __fmul_rn(mu_b, u)) : wv;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs_a[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&xs_b[kk][ty * 4]);
      const float4 wa = *reinterpret_cast<const float4*>(&ws_a[kk][tx * 4]);
      const float4 wb = *reinterpret_cast<const float4*>(&ws_b[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
      const float wav[4] = {wa.x, wa.y, wa.z, wa.w};
      const float wbv[4] = {wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc_a[i][j] = fmaf(av[i], wav[j], acc_a[i][j]);
          acc_b[i][j] = fmaf(bv[i], wbv[j], acc_b[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn >= N) continue;
      zo_store(ya + (int64_t)gm * N + gn, acc_a[i][j]);
      zo_store(yb + (int64_t)gm * N + gn, acc_b[i][j]);
    }
  }
}

template <typename T>
int launch(const void* xa, const void* xb, const void* w, void* ya, void* yb,
           int M, int K, int N, int pa, int pb, uint32_t seed, float mu_a,
           float mu_b, uint32_t row_offset, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const T* a = (const T*)xa;
  const T* b = (const T*)xb;
  const T* ww = (const T*)w;
  T* oa = (T*)ya;
  T* ob = (T*)yb;
  if (pa && pb)
    zo_dual_matmul_kernel<T, true, true><<<grid, THREADS, 0, stream>>>(
        a, b, ww, oa, ob, M, K, N, seed, mu_a, mu_b, row_offset);
  else if (pa)
    zo_dual_matmul_kernel<T, true, false><<<grid, THREADS, 0, stream>>>(
        a, b, ww, oa, ob, M, K, N, seed, mu_a, mu_b, row_offset);
  else if (pb)
    zo_dual_matmul_kernel<T, false, true><<<grid, THREADS, 0, stream>>>(
        a, b, ww, oa, ob, M, K, N, seed, mu_a, mu_b, row_offset);
  else
    zo_dual_matmul_kernel<T, false, false><<<grid, THREADS, 0, stream>>>(
        a, b, ww, oa, ob, M, K, N, seed, mu_a, mu_b, row_offset);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int zo_dual_matmul(const void* xa, const void* xb, const void* w,
                              void* ya, void* yb, int M, int K, int N,
                              int dtype, int perturb_a, int perturb_b,
                              unsigned int seed, float mu_a, float mu_b,
                              unsigned int row_offset, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == REPRO_DTYPE_BF16)
    return launch<__nv_bfloat16>(xa, xb, w, ya, yb, M, K, N, perturb_a,
                                 perturb_b, seed, mu_a, mu_b, row_offset, s);
  if (dtype == REPRO_DTYPE_F32)
    return launch<float>(xa, xb, w, ya, yb, M, K, N, perturb_a, perturb_b,
                         seed, mu_a, mu_b, row_offset, s);
  return (int)cudaErrorInvalidValue;
}
