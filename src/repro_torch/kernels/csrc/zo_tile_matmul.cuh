// The CUDA-core tile loop of the ZO matmul kernels, shared by K2
// (zo_dual_matmul.cu, two streams) and K4 (zo_matmul.cu, one stream): the
// route for the f32 and bf16 shapes the tensor-core routes
// (zo_tf32_matmul.cuh, zo_wgmma_matmul.cuh) do not take.
//   y_s = x_s @ (W + mu_s*U)   for each stream s of the launch,
// with U the counter-hash field of hash.cuh on W's global coordinates
// (rows shifted by row_offset for a leaf stacked along a scan axis,
// columns by col_offset for a column slab of a tensor-parallel W).
//
// One block owns a 64x64 output tile and loops over k in steps of 32 (the
// TPU kernels' sequential k grid axis and f32 VMEM accumulator).  At each
// step it loads one W tile, forms W + mu_s*U once per stream (noise from
// global coordinates, so the tiling never shows in the result) and feeds
// the streams' register accumulators: one read of W serves every stream.
// f32 or bf16 inputs, f32 accumulation, output in x's type; ragged edges
// are masked, nothing needs padding (K = 27 for a 3x3x3 stem conv, N = 10
// for a classifier head).
//
// A stream accumulates in the same order whatever other streams share the
// loop: k tiles ascending, kk ascending inside a tile, one explicit fmaf
// per product, and W + mu*U with explicit round-to-nearest intrinsics.  So
// K4 gives bit for bit what K2 gives on the matching stream.
#pragma once

#include "convert.cuh"
#include "hash.cuh"

namespace zo_tile {

constexpr int BM = 64, BN = 64, BK = 32, THREADS = 256;

template <typename T>
struct Stream {
  const T* x;  // (M, K) rows of this stream
  T* y;        // (M, N) output
  float mu;    // noise scale (read only if the stream is perturbed)
};

// The streams of one launch, passed to the kernel by value.
template <typename T, int NS>
struct Streams {
  Stream<T> s[NS];
};

// The block's output tile for NS streams; bit s of PMASK says whether
// stream s sees the noise.
template <typename T, int NS, unsigned PMASK>
__device__ __forceinline__ void block_tile(const Streams<T, NS>& st,
                                           const T* __restrict__ w, int M,
                                           int K, int N, uint32_t seed,
                                           uint32_t row_offset,
                                           uint32_t col_offset) {
  // x tiles are stored k-major (transposed) so a thread's 4 rows are one
  // float4; the +4 pad keeps rows 16-byte aligned and spreads the banks.
  __shared__ __align__(16) float xs[NS][BK][BM + 4];
  __shared__ __align__(16) float ws[NS][BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // 4 cols x 4 rows per thread
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[NS][4][4];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[s][i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int e = 0; e < (BM * BK) / THREADS; ++e) {
      const int idx = tid + e * THREADS;
      const int mi = idx / BK, ki = idx % BK;
      const int gm = m0 + mi, gk = k0 + ki;
      const bool ok = gm < M && gk < K;
      const int64_t off = (int64_t)gm * K + gk;
#pragma unroll
      for (int s = 0; s < NS; ++s)
        xs[s][ki][mi] = ok ? zo_load(st.s[s].x + off) : 0.0f;
    }
#pragma unroll
    for (int e = 0; e < (BK * BN) / THREADS; ++e) {
      const int idx = tid + e * THREADS;
      const int ki = idx / BN, ni = idx % BN;
      const int gk = k0 + ki, gn = n0 + ni;
      const bool ok = gk < K && gn < N;
      const float wv = ok ? zo_load(w + (int64_t)gk * N + gn) : 0.0f;
      float u = 0.0f;
      if (PMASK != 0u) {
        u = ok ? zo_uniform(seed, row_offset + (uint32_t)gk,
                            col_offset + (uint32_t)gn)
               : 0.0f;
      }
#pragma unroll
      for (int s = 0; s < NS; ++s)
        ws[s][ki][ni] = ((PMASK >> s) & 1u)
                            ? __fadd_rn(wv, __fmul_rn(st.s[s].mu, u))
                            : wv;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const float4 a =
            *reinterpret_cast<const float4*>(&xs[s][kk][ty * 4]);
        const float4 b =
            *reinterpret_cast<const float4*>(&ws[s][kk][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[s][i][j] = fmaf(av[i], bv[j], acc[s][i][j]);
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
#pragma unroll
      for (int s = 0; s < NS; ++s)
        zo_store(st.s[s].y + (int64_t)gm * N + gn, acc[s][i][j]);
    }
  }
}

inline dim3 grid(int M, int N) {
  return dim3((N + BN - 1) / BN, (M + BM - 1) / BM);
}

}  // namespace zo_tile
