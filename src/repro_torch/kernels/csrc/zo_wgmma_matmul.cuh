// The tensor-core route of the ZO matmul kernels for bf16 operands, shared
// by K2 (zo_dual_matmul.cu, two streams) and K4 (zo_matmul.cu, one stream):
//   y_s = x_s @ (W + mu_s*U)   for each stream s of the launch,
// with U the counter-hash field of hash.cuh on W's global coordinates
// (rows shifted by row_offset, columns by col_offset: a stacked leaf's
// layer, a column slab of a tensor-parallel W).  f32 operands take the
// 3xTF32 route of
// zo_tf32_matmul.cuh.
//
// Form.  The block computes y^T = p^T x^T with wgmma (sm_90a): the
// perturbed W fragment is A, held in registers, and an x tile is B, read by
// wgmma from shared memory.  So the noise is added in registers, on the
// fragment each thread already holds, and no thread ever writes a tile that
// wgmma reads (no swizzled stores, no proxy fence).  x is (M, K) row-major,
// which is B's K-major layout; W's (K, N) tile is read with
// ldmatrix.trans, which hands out A's fragments of W^T.
//
// Numerics.  A perturbed stream forms p = __fadd_rn(w, __fmul_rn(mu, u)) in
// f32, as the CUDA-core loop does, and splits it into hi = bf16_rn(p) and
// lo = bf16_rn(p - hi) (p - hi is exact in f32).  Each k16 step runs two
// wgmmas into one f32 accumulator, x·hi then x·lo: hi + lo carries p to
// 2^-16 relative, where one bf16 rounding of p (2^-9) would move the
// outputs by more than the plain version's tolerance.  A clean stream runs
// one wgmma on W's own bf16 fragment, which is exact.
//
// Tiles and schedule.  A block owns 64 W columns (the wgmma M) by 128 x
// rows (the wgmma N, m64n128k16): at M = 1024, N = 768 that is 96 blocks
// for the 132 SMs (128x128 tiles would give 48), and each W tile's noise is
// hashed once per block for 128 rows (M/128 = 8 hashes of each W element
// per call at M = 1024, where the 64x64 CUDA-core loop hashed 16).  One
// producer warp keeps a ring of 4 stages of 64-deep k tiles in flight with
// TMA (W tile 64x64, one 128x64 x tile per stream, 128-byte swizzle,
// out-of-range rows and columns zero-filled).  Two consumer warpgroups
// share each stage: the first takes its k16 chunks 0-1, the second 2-3, so
// both hash and issue wgmma on every stage; each keeps its own f32
// accumulators, and the epilogue adds the second's into the first's in one
// fixed order, rounds to bf16, stages the tile in shared memory and stores
// it row by row (the M and N tails masked).  In a clean launch a thread
// loads the next chunk's fragments while the previous chunk's wgmmas run
// (two register buffers, wgmma.wait_group 1); in a perturbed one it waits
// for its chunk's wgmmas (one buffer, wait_group 0), since with the hash's
// registers live ptxas cannot keep register-A wgmmas in flight and would
// serialize all of them; the other warpgroup hashes meanwhile.
//
// Shared memory: the ring (4 x (8 + 16 * streams) KB) and 1 KB of
// alignment slack, 164,928 bytes for K2 and 99,392 for K4; one 288-thread
// block per SM.
//
// Bound.  At gpt2-small's shapes the bf16 tensor-core rate bounds the
// function; this route runs 1.5x those operations for a clean + perturbed
// pair (the lo term), and hashing W's tile once per 128 rows adds ALU work
// of the same order as the wgmmas (~20 integer and float operations per
// element and block).
//
// Bit equality.  A stream's accumulator sees the same wgmmas in the same
// order whatever else shares the block: k tiles ascending, each
// warpgroup's chunks ascending, hi before lo, then the fixed sum of the two
// warpgroups.  So K4 gives bit for bit what K2 gives on the matching
// stream.  No split-K across blocks, no atomics.
//
// Route.  The wrappers (kernels/zo_matmul.py) send a bf16 launch here when
// K and N are multiples of 8 (TMA's 16-byte row strides) and every base
// pointer is 16-byte aligned (f32 under the same rule goes to
// zo_tf32_matmul.cuh); anything else takes the CUDA-core loop.  The
// tensor maps are encoded on the host at each launch, with
// cuTensorMapEncodeTiled fetched from the driver through the runtime (no
// -lcuda), and passed as __grid_constant__ kernel parameters.  The PTX
// wrappers and the encoder shared with the flash-attention kernels are in
// hopper.cuh.
#pragma once

#include <cstdint>
#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hash.cuh"
#include "hopper.cuh"

namespace zo_wgmma {

using namespace hopper;

constexpr int BN = 64;       // W columns per block: the wgmma M
constexpr int BM = 128;      // x rows per block: the wgmma N
constexpr int BK = 64;       // k per stage: one 128-byte swizzle row of bf16
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;                     // warpgroups
constexpr int THREADS = 128 * CONSUMERS + 32;    // + one producer warp
constexpr int W_BYTES = BK * BN * 2;             // 8 KB
constexpr int X_BYTES = BM * BK * 2;             // 16 KB
constexpr int OUT_LD = BN + 8;   // staged output row in bf16 (144 bytes)

template <int NS>
__host__ __device__ constexpr int stage_bytes() {
  return W_BYTES + NS * X_BYTES;
}

// the ring, 1024 bytes of alignment slack, the full and empty barriers
template <int NS>
__host__ __device__ constexpr int smem_bytes() {
  return STAGES * stage_bytes<NS>() + 1024 + 2 * STAGES * 8;
}

template <int NS>
struct Args {
  CUtensorMap w;        // W (K, N): box 64 columns x 64 rows
  CUtensorMap x[NS];    // x_s (M, K): box 64 columns x 128 rows
  __nv_bfloat16* y[NS];
  float mu[NS];
  int M, K, N;
  uint32_t seed, row_offset, col_offset;
};

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// the consumer warpgroups' own barrier (the producer warp does not take part)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(128 * CONSUMERS) : "memory");
}

// d (64 rows x 128 cols, f32) += a (64 x 16, bf16, registers) * b (16 x 128,
// bf16, K-major in shared memory)
__device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4],
                                    uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ---------------------------------------------------------------------------
// the block
// ---------------------------------------------------------------------------

// One k16 chunk's A fragments for every perturbed stream: register r of the
// W fragment holds W[k][n] (low half) and W[k+1][n] (high half) with
// k = kb + (r & 2 ? 8 : 0) and n = n_lo (r even) or n_lo + 8 (r odd).  rt
// holds the hash's row terms of kb, kb+1, kb+8, kb+9; ct its column terms.
template <int NS, unsigned PMASK>
__device__ __forceinline__ void perturb_frags(const uint32_t (&w)[4],
                                              const uint32_t (&rt)[4],
                                              const uint32_t (&ct)[2],
                                              const float (&mu)[NS],
                                              uint32_t (&hi)[NS][4],
                                              uint32_t (&lo)[NS][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float w0 = low_f32(w[r]), w1 = high_f32(w[r]);
    const int kq = (r & 2) ? 2 : 0;
    const float u0 = zo_bits_to_uniform(zo_mix_final(rt[kq] ^ ct[r & 1]));
    const float u1 = zo_bits_to_uniform(zo_mix_final(rt[kq + 1] ^ ct[r & 1]));
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if (!((PMASK >> s) & 1u)) continue;
      const float p0 = __fadd_rn(w0, __fmul_rn(mu[s], u0));
      const float p1 = __fadd_rn(w1, __fmul_rn(mu[s], u1));
      const uint32_t h = pack_bf16x2(p0, p1);
      hi[s][r] = h;
      lo[s][r] = pack_bf16x2(__fsub_rn(p0, low_f32(h)),
                             __fsub_rn(p1, high_f32(h)));
    }
  }
}

template <int NS, unsigned PMASK>
__device__ __forceinline__ void block_tile(const Args<NS>& a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * stage_bytes<NS>());
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int KT = (a.K + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * CONSUMERS);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * CONSUMERS) {               // the producer warp
    if (lane == 0) {
      for (int kt = 0; kt < KT; ++kt) {
        const int st = kt % STAGES;
        mbar_wait(&empty[st], ((kt / STAGES) & 1) ^ 1);
        uint8_t* base = smem + st * stage_bytes<NS>();
        mbar_expect_tx(&full[st], stage_bytes<NS>());
        tma_load_2d(base, &a.w, &full[st], n0, kt * BK);
#pragma unroll
        for (int s = 0; s < NS; ++s)
          tma_load_2d(base + W_BYTES + s * X_BYTES, &a.x[s], &full[st],
                      kt * BK, m0);
      }
    }
    return;
  }

  // consumers: warpgroup wg takes k16 chunks 2*wg and 2*wg + 1 of a stage;
  // warp wq of it holds W columns n0 + 16*wq .. + 15
  const int wg = warp / 4, wq = warp % 4, g = lane / 4, t4 = lane % 4;
  // ldmatrix.trans: lane gives row (lane % 8) of 8x8 matrix lane / 8, the
  // four matrices being (k 0-7 | 8-15) x (n 0-7 | 8-15) of the warp's
  // 16x16 fragment; the W tile's rows are 128 bytes, 16-byte chunks
  // swizzled by (row % 8)
  const int lk = lane % 8 + ((lane & 16) ? 8 : 0);
  const int lchunk = 2 * wq + ((lane >> 3) & 1);
  const uint32_t ld_off = lk * 128 + ((lchunk ^ (lane % 8)) * 16);
  const uint32_t n_lo = a.col_offset + (uint32_t)(n0 + 16 * wq + g);
  const uint32_t ct[2] = {zo_mix_col(n_lo), zo_mix_col(n_lo + 8u)};
  float mu[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) mu[s] = a.mu[s];

  float acc[NS][64];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[s][i] = 0.0f;

  constexpr bool ANY_CLEAN = PMASK != (1u << NS) - 1u;
  // wgmma groups left in flight while the next chunk's fragments are made:
  // one for clean launches; none when a stream is perturbed, where the
  // hashing's registers leave ptxas too few to keep a register-A wgmma in
  // flight (it would serialize every wgmma instead)
  constexpr int IN_FLIGHT = PMASK != 0u ? 0 : 1;
  constexpr int NBUF = IN_FLIGHT + 1;   // fragment buffers
  uint32_t wr[NBUF][4];                 // W's own fragments
  uint32_t hi[NBUF][NS][4], lo[NBUF][NS][4];

#pragma unroll 1
  for (int kt = 0; kt < KT; ++kt) {
    const int st = kt % STAGES;
    mbar_wait(&full[st], (kt / STAGES) & 1);
    uint8_t* base = smem + st * stage_bytes<NS>();
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int c = 2 * wg + cc;            // k16 chunk of the stage
      const int bi = cc % NBUF, bo = (cc + 1) % NBUF;   // this / the other
      ldsm_x4_trans(smem_u32(base) + c * 16 * 128 + ld_off, wr[bi]);
      if (PMASK != 0u) {
        const uint32_t kb =
            a.row_offset + (uint32_t)(kt * BK + 16 * c + 2 * t4);
        uint32_t rt[4];
        rt[0] = zo_mix_row(a.seed, kb);
        rt[1] = zo_mix_row(a.seed, kb + 1u);
        rt[2] = zo_mix_row(a.seed, kb + 8u);
        rt[3] = zo_mix_row(a.seed, kb + 9u);
        perturb_frags<NS, PMASK>(wr[bi], rt, ct, mu, hi[bi], lo[bi]);
      }
#pragma unroll
      for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int i = 0; i < 64; ++i) pin(acc[s][i]);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const uint64_t b =
            desc_sw128(smem_u32(base + W_BYTES + s * X_BYTES) + c * 32);
        if ((PMASK >> s) & 1u) {
          mma(acc[s], hi[bi][s], b);
          mma(acc[s], lo[bi][s], b);
        } else {
          mma(acc[s], wr[bi], b);
        }
      }
      wgmma_commit();
      wgmma_wait<IN_FLIGHT>();        // the previous chunk's group is done
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (ANY_CLEAN) pin(wr[bo][r]);
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          if (!((PMASK >> s) & 1u)) continue;
          pin(hi[bo][s][r]);
          pin(lo[bo][s][r]);
        }
      }
      if (cc == 0 && kt > 0) {        // so is all of stage kt - 1
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
      }
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int i = 0; i < 64; ++i) pin(acc[s][i]);

  // epilogue: every load has landed and every wgmma is done, so the ring is
  // free.  The second warpgroup's sums go through shared memory into the
  // first's; the first rounds and stages the (128 x 64) tile of each stream.
  consumer_sync();
  float* red = reinterpret_cast<float*>(smem);                  // [NS][64][128]
  __nv_bfloat16* stg =
      reinterpret_cast<__nv_bfloat16*>(smem + NS * 64 * 128 * 4);  // [NS][BM][OUT_LD]
  const int ct_id = tid % 128;
  if (wg == 1) {
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int i = 0; i < 64; ++i) red[(s * 64 + i) * 128 + ct_id] = acc[s][i];
  }
  consumer_sync();
  if (wg == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        // accumulator layout: row (W column) 16*wq + g (+8 for i % 4 >= 2),
        // column (x row) 8*(i / 4) + 2*t4 (+1 for odd i)
        const int nl = 16 * wq + g + ((i & 2) ? 8 : 0);
        const int ml = 8 * (i / 4) + 2 * t4 + (i & 1);
        const float v = __fadd_rn(acc[s][i], red[(s * 64 + i) * 128 + ct_id]);
        stg[(s * BM + ml) * OUT_LD + nl] = __float2bfloat16_rn(v);
      }
  }
  consumer_sync();
  for (int v = tid; v < NS * BM * (BN / 8); v += 128 * CONSUMERS) {
    const int s = v / (BM * (BN / 8)), row = (v / (BN / 8)) % BM,
              c8 = v % (BN / 8);
    const int gm = m0 + row, gn = n0 + 8 * c8;
    if (gm < a.M && gn < a.N)
      *reinterpret_cast<uint4*>(a.y[s] + (int64_t)gm * a.N + gn) =
          *reinterpret_cast<const uint4*>(stg + (s * BM + row) * OUT_LD +
                                          8 * c8);
  }
}

template <int NS, unsigned PMASK>
__global__ void __launch_bounds__(THREADS, 1)
    zo_wgmma_kernel(const __grid_constant__ Args<NS> a) {
  block_tile<NS, PMASK>(a);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// a row-major bf16 (rows, cols) matrix, tiles of box_rows x box_cols with
// 128-byte swizzle; out-of-range elements load as zeros
inline bool encode(CUtensorMap* map, const void* ptr, int rows, int cols,
                   int box_rows, int box_cols) {
  return encode_2d(map, ptr, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, rows, cols,
                   box_rows, box_cols, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int NS, unsigned PMASK>
int launch_masked(const Args<NS>& a, cudaStream_t stream) {
  auto kernel = zo_wgmma_kernel<NS, PMASK>;
  static uint64_t ready = 0;   // devices whose shared-memory limit is raised
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 64 && !((ready >> dev) & 1u)) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes<NS>());
    if (e != cudaSuccess) return (int)e;
    ready |= 1ull << dev;
  }
  const dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM);
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  kernel<<<grid, THREADS, smem_bytes<NS>(), stream>>>(a);
  return (int)cudaGetLastError();
}

// The launch of NS streams (x[s], y[s], mu[s]); bit s of mask says whether
// stream s sees the noise.  Returns a cudaError_t code.
template <int NS>
int launch(const void* const (&x)[NS], const void* w, void* const (&y)[NS],
           const float (&mu)[NS], unsigned mask, int M, int K, int N,
           uint32_t seed, uint32_t row_offset, uint32_t col_offset,
           cudaStream_t stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 != 0 || N % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)w % 16 != 0) return (int)cudaErrorInvalidValue;
  Args<NS> a;
  if (!encode(&a.w, w, K, N, BK, BN)) return (int)cudaErrorInvalidValue;
  for (int s = 0; s < NS; ++s) {
    if ((uintptr_t)x[s] % 16 != 0 || (uintptr_t)y[s] % 16 != 0)
      return (int)cudaErrorInvalidValue;
    if (!encode(&a.x[s], x[s], M, K, BM, BK)) return (int)cudaErrorInvalidValue;
    a.y[s] = (__nv_bfloat16*)y[s];
    a.mu[s] = mu[s];
  }
  a.M = M;
  a.K = K;
  a.N = N;
  a.seed = seed;
  a.row_offset = row_offset;
  a.col_offset = col_offset;
  if constexpr (NS == 1) {
    return mask ? launch_masked<1, 1u>(a, stream)
                : launch_masked<1, 0u>(a, stream);
  } else {
    switch (mask & 3u) {
      case 3u: return launch_masked<2, 3u>(a, stream);
      case 2u: return launch_masked<2, 2u>(a, stream);
      case 1u: return launch_masked<2, 1u>(a, stream);
      default: return launch_masked<2, 0u>(a, stream);
    }
  }
}

}  // namespace zo_wgmma
