// Kernel K4: the single-probe ZO matmul,
//   y = x @ (W + mu*U)   (perturb), or   y = x @ W   (!perturb),
// with U the counter-hash field of hash.cuh on W's global coordinates
// (rows shifted by row_offset for a leaf stacked along a scan axis,
// columns by col_offset for a column slab of a tensor-parallel W;
// col_offset = 0 is the whole W).
//
// Replaces the Pallas kernel `_zo_matmul_kernel` / `zo_matmul` of
// src/repro/kernels/zo_matmul.py.  It runs K2's (zo_dual_matmul.cu) routes
// with ONE stream: the tensor cores (zo_matmul_tc) where K and N are
// multiples of 8 and the pointers 16-byte aligned, bf16 through
// zo_wgmma_matmul.cuh and f32 through zo_tf32_matmul.cuh (3xTF32, with
// 2 x K x N floats of `scratch` for W + mu*U's split terms);
// everything else on the CUDA-core tile loop (zo_matmul,
// zo_tile_matmul.cuh).  On the same route K4 equals K2's matching stream
// bit for bit (the property the TPU kernels' docstring claims).
// `perturb` is a template parameter, as the TPU kernel's static flag: with
// it off the kernel is the plain blocked matmul, the clean pass of the
// unfused two-pass baseline (`zo_dual_forward_split`).  The single-probe
// model forward calls it for every perturbed dense layer and, over im2col
// patches, every perturbed conv.  f32 accumulation, output in x's type;
// ragged edges are masked.
//
// Bound on the H100: at gpt2-small's client shapes (M = 1024, K x N up to
// 768 x 3072, bf16) ~4.8 GFLOP for ~11 MB, so the tensor-core rate bounds
// it (~5 us; the perturbed pass runs two wgmmas per k16 step, hi and lo);
// at ResNet-18's block convs (f32, M = 65536, 576 x 64) the 151 MB of
// patches bound it (~50 us with W and the output), and the three tf32
// terms take ~29 us at 495 TFLOP/s.
#include "zo_tile_matmul.cuh"
#include "zo_tf32_matmul.cuh"
#include "zo_wgmma_matmul.cuh"

namespace {

template <typename T, unsigned PMASK>
__global__ void __launch_bounds__(zo_tile::THREADS)
    zo_matmul_kernel(zo_tile::Streams<T, 1> st, const T* __restrict__ w,
                     int M, int K, int N, uint32_t seed,
                     uint32_t row_offset, uint32_t col_offset) {
  zo_tile::block_tile<T, 1, PMASK>(st, w, M, K, N, seed, row_offset,
                                    col_offset);
}

template <typename T>
int launch(const void* x, const void* w, void* y, int M, int K, int N,
           int perturb, uint32_t seed, float mu, uint32_t row_offset,
           uint32_t col_offset, cudaStream_t stream) {
  const dim3 grid = zo_tile::grid(M, N);
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  const zo_tile::Streams<T, 1> st{{{(const T*)x, (T*)y, mu}}};
  if (perturb)
    zo_matmul_kernel<T, 1u><<<grid, zo_tile::THREADS, 0, stream>>>(
        st, (const T*)w, M, K, N, seed, row_offset, col_offset);
  else
    zo_matmul_kernel<T, 0u><<<grid, zo_tile::THREADS, 0, stream>>>(
        st, (const T*)w, M, K, N, seed, row_offset, col_offset);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int zo_matmul(const void* x, const void* w, void* y, int M, int K,
                         int N, int dtype, int perturb, unsigned int seed,
                         float mu, unsigned int row_offset,
                         unsigned int col_offset, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == REPRO_DTYPE_BF16)
    return launch<__nv_bfloat16>(x, w, y, M, K, N, perturb, seed, mu,
                                 row_offset, col_offset, s);
  if (dtype == REPRO_DTYPE_F32)
    return launch<float>(x, w, y, M, K, N, perturb, seed, mu, row_offset,
                         col_offset, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int zo_matmul_tc(const void* x, const void* w, void* y, int M,
                            int K, int N, int dtype, int perturb,
                            unsigned int seed, float mu,
                            unsigned int row_offset,
                            unsigned int col_offset, void* scratch,
                            void* stream) {
  const void* const xs[1] = {x};
  void* const ys[1] = {y};
  const float mus[1] = {mu};
  const unsigned mask = perturb ? 1u : 0u;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == REPRO_DTYPE_BF16)
    return zo_wgmma::launch<1>(xs, w, ys, mus, mask, M, K, N, seed,
                               row_offset, col_offset, s);
  if (dtype == REPRO_DTYPE_F32)
    return zo_tf32::launch<1>(xs, w, ys, mus, mask, M, K, N, seed,
                              row_offset, col_offset, scratch, s);
  return (int)cudaErrorInvalidValue;
}
