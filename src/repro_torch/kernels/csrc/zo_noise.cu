// Kernel K1: materialise the counter-hash noise U(seed), f32.
//
// Replaces the Pallas kernel `_noise_kernel` / `zo_noise` of
// src/repro/kernels/zo_matmul.py.  The TPU kernel tiles a (K, N) field
// over a grid and draws each tile from its global coordinates; here one
// thread computes one element in a grid-stride loop, so the field has no
// tiles at all and any shape or offset works.
//
// Two modes:
//   * field:   out[r, c] = U[row_offset + r, col_offset + c]
//              (a leaf's direction, the tied-table noise, norm leaves);
//   * rows:    out[i, c] = U[ids[i], c]
//              (the embedding-lookup form: noise rows of the table for
//              the batch's token ids, without the (vocab, d) field).
//
// Bound on the H100: the 4-byte store of each element.  The hash is
// about 20 integer operations per element, well under the card's integer
// rate for the 3.35 TB/s store stream.  The simple design leaves only
// vector (16-byte) stores on the table.
#include "hash.cuh"

__global__ void zo_noise_field_kernel(float* __restrict__ out, int64_t rows,
                                      int64_t cols, uint32_t seed,
                                      uint32_t row_offset,
                                      uint32_t col_offset) {
  const int64_t n = rows * cols;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const uint32_t r = (uint32_t)(i / cols) + row_offset;
    const uint32_t c = (uint32_t)(i % cols) + col_offset;
    out[i] = zo_uniform(seed, r, c);
  }
}

__global__ void zo_noise_rows_kernel(float* __restrict__ out,
                                     const int32_t* __restrict__ ids,
                                     int64_t n_ids, int64_t cols,
                                     uint32_t seed) {
  const int64_t n = n_ids * cols;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const uint32_t r = (uint32_t)ids[i / cols];
    const uint32_t c = (uint32_t)(i % cols);
    out[i] = zo_uniform(seed, r, c);
  }
}

static int zo_noise_grid(int64_t n) {
  const int64_t blocks = (n + 255) / 256;
  return (int)(blocks < 132 * 16 ? blocks : 132 * 16);
}

extern "C" int zo_noise_field(void* out, long long rows, long long cols,
                              unsigned int seed, unsigned int row_offset,
                              unsigned int col_offset, void* stream) {
  zo_noise_field_kernel<<<zo_noise_grid(rows * cols), 256, 0,
                          (cudaStream_t)stream>>>(
      (float*)out, rows, cols, seed, row_offset, col_offset);
  return (int)cudaGetLastError();
}

extern "C" int zo_noise_rows(void* out, const void* ids, long long n_ids,
                             long long cols, unsigned int seed,
                             void* stream) {
  zo_noise_rows_kernel<<<zo_noise_grid(n_ids * cols), 256, 0,
                         (cudaStream_t)stream>>>(
      (float*)out, (const int32_t*)ids, n_ids, cols, seed);
  return (int)cudaGetLastError();
}
