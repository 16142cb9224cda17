// Kernel K2: the fused dual probe of the two-point ZO estimator,
//   (ya, yb) = (xa @ (W + mu_a*U), xb @ (W + mu_b*U)),
// with U the counter-hash field of hash.cuh on W's global coordinates
// (rows shifted by row_offset for a leaf stacked along a scan axis,
// columns by col_offset for a column slab of a tensor-parallel W;
// col_offset = 0 is the whole W).
//
// Replaces the Pallas kernel `_zo_dual_kernel` / `zo_dual_matmul` of
// src/repro/kernels/zo_matmul.py.  Two routes, each run with TWO streams,
// so one read of W and one noise tile per k step serve both losses of the
// pair; perturb_a / perturb_b are template parameters, as the TPU kernel's
// static flags:
//   * zo_dual_matmul_tc: the tensor cores, where K and N are multiples of 8
//     and the pointers 16-byte aligned: bf16 operands through
//     zo_wgmma_matmul.cuh (TMA ring, wgmma with the perturbed W fragment
//     split into two bf16 terms in registers), f32 through
//     zo_tf32_matmul.cuh (3xTF32: W + mu*U hashed and split into two tf32
//     terms once per launch into `scratch`, 4 x K x N floats; x split in
//     registers; wgmma on a TMA ring);
//   * zo_dual_matmul: the CUDA-core tile loop (zo_tile_matmul.cuh), for the
//     shapes the tensor-core route does not take (K or N not a multiple of
//     8, a pointer not 16-byte aligned: a 3x3x3 stem conv, a 10-way head).
// K4 (zo_matmul.cu) runs the same routes with one stream, so it matches
// either stream bit for bit on the same route.
//
// Bound on the H100: at gpt2-small's client shapes (M = 1024 rows per
// stream, K x N up to 768 x 3072, bf16) the work is ~9.7 GFLOP for ~20 MB,
// so the bf16 tensor-core rate bounds it (~10 us); the route runs 3 wgmmas
// per k16 step for a clean + perturbed pair (the perturbed stream's hi and
// lo terms), plus the hash of each W element once per 128 rows.  At
// ResNet-18's block convs (f32, M = 65536 rows per stream, 576 x 64) the
// 336 MB of patches, W and outputs bound it (~100 us); the three tf32
// terms take ~59 us at 495 TFLOP/s.
#include "zo_tile_matmul.cuh"
#include "zo_tf32_matmul.cuh"
#include "zo_wgmma_matmul.cuh"

namespace {

// stream a is bit 0 of PMASK, stream b bit 1
template <typename T, unsigned PMASK>
__global__ void __launch_bounds__(zo_tile::THREADS)
    zo_dual_matmul_kernel(zo_tile::Streams<T, 2> st, const T* __restrict__ w,
                          int M, int K, int N, uint32_t seed,
                          uint32_t row_offset, uint32_t col_offset) {
  zo_tile::block_tile<T, 2, PMASK>(st, w, M, K, N, seed, row_offset,
                                    col_offset);
}

template <typename T>
int launch(const void* xa, const void* xb, const void* w, void* ya, void* yb,
           int M, int K, int N, int pa, int pb, uint32_t seed, float mu_a,
           float mu_b, uint32_t row_offset, uint32_t col_offset,
           cudaStream_t stream) {
  const dim3 grid = zo_tile::grid(M, N);
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  const zo_tile::Streams<T, 2> st{{{(const T*)xa, (T*)ya, mu_a},
                                   {(const T*)xb, (T*)yb, mu_b}}};
  const T* ww = (const T*)w;
  const unsigned mask = (pa ? 1u : 0u) | (pb ? 2u : 0u);
  if (mask == 3u)
    zo_dual_matmul_kernel<T, 3u><<<grid, zo_tile::THREADS, 0, stream>>>(
        st, ww, M, K, N, seed, row_offset, col_offset);
  else if (mask == 1u)
    zo_dual_matmul_kernel<T, 1u><<<grid, zo_tile::THREADS, 0, stream>>>(
        st, ww, M, K, N, seed, row_offset, col_offset);
  else if (mask == 2u)
    zo_dual_matmul_kernel<T, 2u><<<grid, zo_tile::THREADS, 0, stream>>>(
        st, ww, M, K, N, seed, row_offset, col_offset);
  else
    zo_dual_matmul_kernel<T, 0u><<<grid, zo_tile::THREADS, 0, stream>>>(
        st, ww, M, K, N, seed, row_offset, col_offset);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int zo_dual_matmul(const void* xa, const void* xb, const void* w,
                              void* ya, void* yb, int M, int K, int N,
                              int dtype, int perturb_a, int perturb_b,
                              unsigned int seed, float mu_a, float mu_b,
                              unsigned int row_offset,
                              unsigned int col_offset, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == REPRO_DTYPE_BF16)
    return launch<__nv_bfloat16>(xa, xb, w, ya, yb, M, K, N, perturb_a,
                                 perturb_b, seed, mu_a, mu_b, row_offset,
                                 col_offset, s);
  if (dtype == REPRO_DTYPE_F32)
    return launch<float>(xa, xb, w, ya, yb, M, K, N, perturb_a, perturb_b,
                         seed, mu_a, mu_b, row_offset, col_offset, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int zo_dual_matmul_tc(const void* xa, const void* xb,
                                 const void* w, void* ya, void* yb, int M,
                                 int K, int N, int dtype, int perturb_a,
                                 int perturb_b, unsigned int seed, float mu_a,
                                 float mu_b, unsigned int row_offset,
                                 unsigned int col_offset, void* scratch,
                                 void* stream) {
  const void* const x[2] = {xa, xb};
  void* const y[2] = {ya, yb};
  const float mu[2] = {mu_a, mu_b};
  const unsigned mask = (perturb_a ? 1u : 0u) | (perturb_b ? 2u : 0u);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == REPRO_DTYPE_BF16)
    return zo_wgmma::launch<2>(x, w, y, mu, mask, M, K, N, seed, row_offset,
                               col_offset, s);
  if (dtype == REPRO_DTYPE_F32)
    return zo_tf32::launch<2>(x, w, y, mu, mask, M, K, N, seed, row_offset,
                              col_offset, scratch, s);
  return (int)cudaErrorInvalidValue;
}
