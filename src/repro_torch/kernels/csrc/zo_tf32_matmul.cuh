// The tensor-core route of the ZO matmul kernels for f32 operands, shared
// by K2 (zo_dual_matmul.cu, two streams) and K4 (zo_matmul.cu, one stream):
//   y_s = x_s @ (W + mu_s*U)   for each stream s of the launch,
// with U the counter-hash field of hash.cuh on W's global coordinates
// (rows shifted by row_offset, columns by col_offset), f32 in and out.
// bf16 operands take zo_wgmma_matmul.cuh; shapes TMA cannot take stay on
// the CUDA-core loop of zo_tile_matmul.cuh.
//
// Numerics (3xTF32).  A stream forms p = __fadd_rn(w, __fmul_rn(mu, u)) in
// f32 as the CUDA-core loop does (p = w for a clean stream), and both p and
// x are split into two tf32 terms, hi = tf32(v) and lo = tf32(v - hi), where
// tf32() keeps the upper 19 bits rounded to nearest with ties away from zero
// (cvt.rna.tf32.f32's rounding, done as an integer add and mask, so the
// tensor cores never see the low 13 bits of an operand) and v - hi is exact
// in f32.  Each k8 step runs three wgmmas, x_hi·p_hi, x_hi·p_lo and
// x_lo·p_hi: the first into a partial that the thread adds to its f32
// accumulator, the other two into a tile-long sum of the small terms, added
// at the tile's end (see the schedule).  A tf32 product is exact in f32, so
// ref.zo_matmul_tf32x3_ref repeats the arithmetic with three f32 matmuls; hi
// + lo carries each operand to 2^-21 relative, where one tf32 term (2^-11)
// would move the outputs past the plain version's f32 tolerance.  A clean
// stream runs the three terms too, since w is not exact in tf32.
//
// Two kernels a launch.  zo_tf32_pt_kernel hashes each W element once per
// launch (one thread per 4 k of a column), forms p per stream and writes
// p_hi^T and p_lo^T (N x K, K contiguous) into the caller's scratch: 2 x
// streams x K x N f32, 0.6 MB at ResNet-18's block convs.  zo_tf32_kernel
// then computes y = x·p with wgmma m64n64k8 (sm_90a), tf32 operands K-major:
// an x tile (A) and the p^T tiles (B) come by TMA into a 128-byte-swizzled
// ring (BK = 32 f32 is one swizzle row); x goes to registers with ld.shared,
// where it is split, and the p^T tiles are read by wgmma where TMA put them.
// Hashing W's tile in every block and k step, as the CUDA-core loop does,
// costs integer work that, with two consumer warps a scheduler, outlasts
// the tensor cores and the loads together on the H100; hence the separate
// pass, which hashes each element once.
//
// Tiles and schedule.  Each consumer warpgroup takes one stream and 64 x
// rows (the wgmma M) of a tile, by 64 W columns (the wgmma N): a tile is 128
// rows of K4's stream, or 64 rows of each of K2's two (so no thread holds
// two streams' accumulators).  Blocks are persistent (one per SM, tiles
// strided by the grid), and one producer warp keeps a 4-stage TMA ring of (x
// tile, p_hi^T and p_lo^T tiles) per stream in flight across tile
// boundaries.  Per k8 step a consumer thread loads and splits its x
// fragments, issues the step's three wgmmas as one group, waits for it and
// adds the x_hi·p_hi partial into its f32 accumulator; the two warpgroups
// run apart (no barrier between them), so one's group runs on the tensor
// cores while the other makes fragments and adds.  A ring slot is released
// after the stage's last group; after a tile's last k step the accumulators
// go straight from registers to global memory (M and N tails masked; TMA
// zero-fills the K, N and M tails of the loads).
//
// Shared memory: the ring (4 stages of 32 KB for K4, 48 KB for K2) and 1 KB
// of alignment slack: 197,696 bytes for K2, 132,160 for K4; one 288-thread
// block per SM.
//
// Bound.  At ResNet-18's block convs (M = 65536 rows per stream, 576 x 64)
// the 151 MB of patches a stream over 3.35 TB/s take 45 us; the three tf32
// terms (3 x 2MKN at 495 TFLOP/s) take 29 us, so bytes bound it.
//
// Bit equality.  A stream's accumulator sees the same wgmmas and adds in the
// same order whatever else shares the block (k tiles ascending, k8 steps
// ascending, each step's big partial, the small sum at the tile's end), each
// row sits at the same place in its 64-row wgmma in K2 and K4, and nothing
// is split across blocks: K4 gives bit for bit what K2 gives on the matching
// stream.
//
// Route.  The wrappers (kernels/zo_matmul.py) send an f32 launch here under
// the bf16 route's rule: K and N multiples of 8 and every base pointer
// 16-byte aligned (TMA's strides and base addresses).
#pragma once

#include <cstdint>
#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>

#include "hash.cuh"
#include "hopper.cuh"

namespace zo_tf32 {

using namespace hopper;

constexpr int BN = 64;      // W columns per tile: the wgmma N
constexpr int BK = 32;      // k per stage: one 128-byte swizzle row of f32
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;                    // warpgroups
constexpr int THREADS = 128 * CONSUMERS + 32;   // + one producer warp
constexpr int B_BYTES = BN * BK * 4;            // one tf32 term of p^T, 8 KB
constexpr int PT_THREADS = 256;                 // of the p^T kernel

// x rows per tile: warpgroup w takes stream w % NS, rows 64 * (w / NS) ..
// + 63 (the wgmma M)
template <int NS>
__host__ __device__ constexpr int rows() {
  return 64 * CONSUMERS / NS;
}

// one stream's x tile
template <int NS>
__host__ __device__ constexpr int x_bytes() {
  return rows<NS>() * BK * 4;
}

// per stream: its x tile, then its p_hi^T and p_lo^T tiles
template <int NS>
__host__ __device__ constexpr int stream_bytes() {
  return x_bytes<NS>() + 2 * B_BYTES;
}

// the ring, 1024 bytes of alignment slack, the full and empty barriers
template <int NS>
__host__ __device__ constexpr int smem_bytes() {
  return STAGES * NS * stream_bytes<NS>() + 1024 + 2 * STAGES * 8;
}

template <int NS>
struct Args {
  CUtensorMap x[NS];      // x_s (M, K): box 32 columns x rows<NS>() rows
  CUtensorMap pt[NS][2];  // p_hi^T, p_lo^T of stream s (N, K): 32 x 64
  float* y[NS];
  int M, K, N;
};

template <int NS>
struct PtArgs {
  const float* w;         // W (K, N)
  float* pt;              // [stream][hi, lo] (N, K)
  float mu[NS];
  int K, N;
  uint32_t seed, row_offset, col_offset;
};

// ---------------------------------------------------------------------------
// PTX wrappers and the split
// ---------------------------------------------------------------------------

// f32 -> tf32 in an f32 container: round the 13 dropped bits to nearest,
// ties away from zero (cvt.rna.tf32.f32), by adding half their range to
// the magnitude and clearing them
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

// hi = tf32(v), lo = tf32(v - hi); v - hi is exact in f32
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(__fsub_rn(v, __uint_as_float(hi)));
}

// d (64 x rows x 64 W columns, f32) = a (64 x 8, tf32, registers) *
// b (8 x 64, tf32, K-major in shared memory) + (acc ? d : 0)
__device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4],
                                    uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// ---------------------------------------------------------------------------
// the p^T kernel
// ---------------------------------------------------------------------------

// Thread (k4, n) takes W[4*k4 .. + 3][n]: hashes each element once, forms
// p = w + mu_s*u (or w) per stream and writes the split terms as one
// 16-byte chunk of row n of p_hi^T and of p_lo^T.
template <int NS, unsigned PMASK>
__global__ void __launch_bounds__(PT_THREADS)
    zo_tf32_pt_kernel(const PtArgs<NS> a) {
  const int64_t idx = (int64_t)blockIdx.x * PT_THREADS + threadIdx.x;
  if (idx >= (int64_t)(a.K / 4) * a.N) return;
  const int n = (int)(idx % a.N), k = 4 * (int)(idx / a.N);
  float w[4], u[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    w[e] = a.w[(int64_t)(k + e) * a.N + n];
    u[e] = PMASK != 0u
               ? zo_uniform(a.seed, a.row_offset + (uint32_t)(k + e),
                            a.col_offset + (uint32_t)n)
               : 0.0f;
  }
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split((PMASK >> s) & 1u ? __fadd_rn(w[e], __fmul_rn(a.mu[s], u[e]))
                              : w[e],
            hi[e], lo[e]);
    const int64_t row = (int64_t)(2 * s) * a.N + n;
    *reinterpret_cast<uint4*>(a.pt + row * a.K + k) =
        make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(a.pt + (row + a.N) * a.K + k) =
        make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// ---------------------------------------------------------------------------
// the matmul kernel
// ---------------------------------------------------------------------------

template <int NS>
__device__ __forceinline__ void block_tiles(const Args<NS>& a) {
  constexpr int BM = rows<NS>(), SB = stream_bytes<NS>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * NS * SB);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tiles_n = (a.N + BN - 1) / BN;
  const int tiles = tiles_n * ((a.M + BM - 1) / BM);
  const int KT = (a.K + BK - 1) / BK;
  // this block's tiles: blockIdx.x, + gridDim.x, ... (the grid is at most
  // the tile count); `it` counts the stages of the ring

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
      int it = 0;
      for (int tile = (int)blockIdx.x; tile < tiles; tile += (int)gridDim.x) {
        const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int st = it % STAGES;
          mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
          uint8_t* base = smem + st * NS * SB;
          mbar_expect_tx(&full[st], NS * SB);
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            uint8_t* b = base + s * SB;
            tma_load_2d(b, &a.x[s], &full[st], kt * BK, m0);
            tma_load_2d(b + x_bytes<NS>(), &a.pt[s][0], &full[st], kt * BK,
                        n0);
            tma_load_2d(b + x_bytes<NS>() + B_BYTES, &a.pt[s][1], &full[st],
                        kt * BK, n0);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg takes stream s = wg % NS and x rows 64*(wg /
  // NS) .. + 63 of a tile; warp wq of it rows 16*wq .. + 15 (the wgmma M
  // split); lane (g, t4) holds A elements (g | g + 8, t4 | t4 + 4) of each
  // k8 step and accumulators (g | g + 8, 8*i + 2*t4 | + 1)
  const int wg = warp / 4, wq = warp % 4, g = lane / 4, t4 = lane % 4;
  const int s = wg % NS;
  const int row = 64 * (wg / NS) + 16 * wq + g;   // and row + 8; % 8 == g
  const uint32_t xoff = (uint32_t)(s * SB + row * 128 + 4 * t4);
  const uint32_t boff = (uint32_t)(s * SB + x_bytes<NS>());

  // A wgmma group is one k8 step: x_hi·p_hi into `big`, started with
  // scale-d 0, and x_hi·p_lo + x_lo·p_hi into `small`, which sums the
  // tile's small terms on the tensor cores; the thread waits for the group
  // and adds `big` into `acc` in f32 (round to nearest), while the other
  // warpgroup's group keeps the tensor cores busy.  The tensor cores' f32
  // sums drift when they carry the whole of K (on the H100 several times
  // further from the exact product than torch's f32 matmul at K = 576);
  // one big partial per k8 step leaves one rounding of eight products a
  // step, and the small terms, ~2^-11 of y, drift far below that.  (A
  // group of one k8 step with a register set in flight made ptxas
  // serialize the wgmmas, C7513.)
  float acc[32], big[32], small[32];
  uint32_t ah[4], al[4];
  int it = 0;                                // the block's stage count

#pragma unroll 1
  for (int tile = (int)blockIdx.x; tile < tiles; tile += (int)gridDim.x) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
#pragma unroll 1
    for (int kt = 0; kt < KT; ++kt, ++it) {
      const int st = it % STAGES;
      mbar_wait(&full[st], (it / STAGES) & 1);
      const uint8_t* xt = smem + st * NS * SB + xoff;
      const uint32_t bb = smem_u32(smem + st * NS * SB + boff);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {          // the k8 steps
        const uint32_t c0 = (uint32_t)(((2 * j) ^ g) << 4);
        const uint32_t c1 = (uint32_t)(((2 * j + 1) ^ g) << 4);
        split(*reinterpret_cast<const float*>(xt + c0), ah[0], al[0]);
        split(*reinterpret_cast<const float*>(xt + 8 * 128 + c0), ah[1],
              al[1]);
        split(*reinterpret_cast<const float*>(xt + c1), ah[2], al[2]);
        split(*reinterpret_cast<const float*>(xt + 8 * 128 + c1), ah[3],
              al[3]);
        wgmma_fence();
        const uint64_t bh = desc_sw128(bb + 32 * j);
        const uint64_t bl = desc_sw128(bb + B_BYTES + 32 * j);
        mma(big, ah, bh, 0);
        mma(small, ah, bl, kt > 0 || j > 0 ? 1 : 0);
        mma(small, al, bh, 1);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pin(ah[e]);
          pin(al[e]);
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          pin(big[i]);
          acc[i] = __fadd_rn(acc[i], big[i]);
        }
      }
      __syncwarp();                 // every group reading the slot is done
      if (lane == 0) mbar_arrive(&empty[st]);
    }

#pragma unroll
    for (int i = 0; i < 32; ++i) {
      pin(small[i]);
      acc[i] = __fadd_rn(acc[i], small[i]);
    }

    // the epilogue, from registers
    const int gm = (tile / tiles_n) * BM + row;
    const int n0 = (tile % tiles_n) * BN + 2 * t4;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int gn = n0 + 8 * i;
      if (gn >= a.N) continue;
      if (gm < a.M)
        *reinterpret_cast<float2*>(a.y[s] + (int64_t)gm * a.N + gn) =
            make_float2(acc[4 * i], acc[4 * i + 1]);
      if (gm + 8 < a.M)
        *reinterpret_cast<float2*>(a.y[s] + (int64_t)(gm + 8) * a.N + gn) =
            make_float2(acc[4 * i + 2], acc[4 * i + 3]);
    }
  }
}

template <int NS>
__global__ void __launch_bounds__(THREADS, 1)
    zo_tf32_kernel(const __grid_constant__ Args<NS> a) {
  block_tiles<NS>(a);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <int NS, unsigned PMASK>
int launch_pt(const PtArgs<NS>& p, cudaStream_t stream) {
  const int64_t n = (int64_t)(p.K / 4) * p.N;
  const int64_t blocks = (n + PT_THREADS - 1) / PT_THREADS;
  if (blocks > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  zo_tf32_pt_kernel<NS, PMASK><<<(unsigned)blocks, PT_THREADS, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

// The launch of NS streams (x[s], y[s], mu[s]); bit s of mask says whether
// stream s sees the noise.  `scratch` holds 2 * NS * K * N floats, 16-byte
// aligned (the p^T terms).  Returns a cudaError_t code.
template <int NS>
int launch(const void* const (&x)[NS], const void* w, void* const (&y)[NS],
           const float (&mu)[NS], unsigned mask, int M, int K, int N,
           uint32_t seed, uint32_t row_offset, uint32_t col_offset,
           void* scratch,
           cudaStream_t stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 != 0 || N % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (scratch == nullptr || (uintptr_t)w % 16 != 0 ||
      (uintptr_t)scratch % 16 != 0)
    return (int)cudaErrorInvalidValue;
  PtArgs<NS> p;
  p.w = (const float*)w;
  p.pt = (float*)scratch;
  p.K = K;
  p.N = N;
  p.seed = seed;
  p.row_offset = row_offset;
  p.col_offset = col_offset;
  Args<NS> a;
  for (int s = 0; s < NS; ++s) {
    if ((uintptr_t)x[s] % 16 != 0 || (uintptr_t)y[s] % 16 != 0)
      return (int)cudaErrorInvalidValue;
    if (!encode_2d(&a.x[s], x[s], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, M, K,
                   rows<NS>(), BK, CU_TENSOR_MAP_SWIZZLE_128B))
      return (int)cudaErrorInvalidValue;
    for (int h = 0; h < 2; ++h)
      if (!encode_2d(&a.pt[s][h], p.pt + (int64_t)(2 * s + h) * N * K,
                     CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, N, K, BN, BK,
                     CU_TENSOR_MAP_SWIZZLE_128B))
        return (int)cudaErrorInvalidValue;
    a.y[s] = (float*)y[s];
    p.mu[s] = mu[s];
  }
  a.M = M;
  a.K = K;
  a.N = N;

  int e;
  if constexpr (NS == 1) {
    e = mask ? launch_pt<1, 1u>(p, stream) : launch_pt<1, 0u>(p, stream);
  } else {
    switch (mask & 3u) {
      case 3u: e = launch_pt<2, 3u>(p, stream); break;
      case 2u: e = launch_pt<2, 2u>(p, stream); break;
      case 1u: e = launch_pt<2, 1u>(p, stream); break;
      default: e = launch_pt<2, 0u>(p, stream);
    }
  }
  if (e != 0) return e;

  auto kernel = zo_tf32_kernel<NS>;
  static uint64_t ready = 0;   // devices whose shared-memory limit is raised
  static int sms[64] = {};     // their SM counts
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!((ready >> dev) & 1u)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes<NS>());
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return (int)err;
    ready |= 1ull << dev;
  }
  const long long tiles =
      (long long)((N + BN - 1) / BN) * ((M + rows<NS>() - 1) / rows<NS>());
  if (tiles * ((K + BK - 1) / BK) > 0x7FFFFFFFll)
    return (int)cudaErrorInvalidValue;
  const int grid = (int)(tiles < sms[dev] ? tiles : sms[dev]);
  kernel<<<grid, THREADS, smem_bytes<NS>(), stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace zo_tf32
