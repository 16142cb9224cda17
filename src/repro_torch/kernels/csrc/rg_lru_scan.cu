// Kernel K6: the RG-LRU linear recurrence over time, f32,
//   forward:  h_t = a_t * h_{t-1} + b_t            (h_{-1} = 0)
//   reverse:  G_t = g_t + a_{t+1} * G_{t+1}         (G_S = 0)
//             da_t = G_t * h_{t-1}, and db_t = G_t,
// the second being the gradient of the first given g = dL/dh, run as the
// same recurrence backwards over time.  a, b, g, h: (B, S, W) contiguous.
//
// Replaces the Pallas kernel `_rg_lru_kernel` / `rg_lru_scan` of
// src/repro/kernels/rg_lru.py.  The TPU kernel walks (width, time) tiles
// with the running state in VMEM scratch and a sequential time axis.  The
// TPU kernel has no backward (JAX differentiates `associative_scan`); on
// the card the reverse mode is a flag of this kernel.
//
// Rounding: each step is __fadd_rn(__fmul_rn(.)), never contracted into
// an FMA, and each channel is one sequential chain, so the kernel equals
// the plain version (a multiply, then an add, step by step) bit for bit
// in both modes.  A scan split over time would round differently.
//
// Design.  A block owns 32 channels (b, w0 .. w0 + 31) over the whole
// sequence: 256 blocks at (2, 512, 4096).  Its producer warp keeps a ring
// of STAGES = 4 stages in flight, each a (T = 32 steps x 32 channels) tile
// of every input: a and b forward; a, g and the forward's h shifted one
// step back (h_{t-1}) in reverse.  Where W % 4 == 0 and the pointers are
// 16-byte aligned the tiles come by TMA (a 3-D map over (W, S, B);
// channels past W, steps past S and the step before 0 arrive as zeros);
// otherwise each producer lane copies its channel with 4-byte cp.async
// (zero-filled the same way).  The consumer warp, one lane per channel,
// moves a stage into registers, releases it, and walks its T steps
// carrying h (reverse: G and a_{t+1}) in a register, storing each step's
// 32 outputs as one 128-byte row.
//
// Bound on the H100: bytes, 12 per element forward (read a, b; write h)
// and 20 reverse (read a, g, h; write da, db), over 3.35 TB/s.  At the
// round's shapes about two blocks share an SM, so the ring keeps up to
// 2 x 4 x 8 KB = 64 KB (forward) and 2 x 4 x 12 KB = 96 KB (reverse) of
// loads in flight per SM, against the ~25-40 KB that Little's law asks at
// 3.35 TB/s / 132 SMs and about a microsecond of latency.  The chain
// itself is ~512 steps x ~8 cycles, about 2 us.
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int CH = 32;                  // channels per block: a warp's lanes
constexpr int T = 32;                   // time steps per stage
constexpr int STAGES = 4;
constexpr int TILE_BYTES = T * CH * 4;  // one input's tile of a stage: 4 KB
constexpr int THREADS = 64;             // consumer warp, producer warp

template <bool REVERSE>
struct Ring {
  static constexpr int INPUTS = REVERSE ? 3 : 2;
  static constexpr int STAGE_BYTES = INPUTS * TILE_BYTES;
  // the ring, the barriers, 128 bytes of alignment slack
  static constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 128;
};

struct Args {
  CUtensorMap map[3];        // TMA: a, x, hs as (W, S, B), box (32, T, 1)
  const float* in[3];        // cp.async: a, x, hs
  float* out;                // forward h; reverse db
  float* da;                 // reverse da
  int B, S, W;
};

template <bool REVERSE, bool TMA>
__global__ void __launch_bounds__(THREADS)
    rg_lru_scan_kernel(const __grid_constant__ Args p) {
  using R = Ring<REVERSE>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * R::STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int w0 = blockIdx.x * CH, b = blockIdx.y;
  const int chunks = (p.S + T - 1) / T;

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], TMA ? 1 : 32);
      mbar_init(&empty[st], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 1) {  // the producer
    const int w = w0 + lane;
    for (int i = 0; i < chunks; ++i) {
      const int st = i % STAGES;
      const int t0 = (REVERSE ? chunks - 1 - i : i) * T;
      mbar_wait(&empty[st], ((i / STAGES) & 1) ^ 1);
      uint8_t* base = ring + st * R::STAGE_BYTES;
      if (TMA) {
        if (lane == 0) {
          mbar_expect_tx(&full[st], R::STAGE_BYTES);
          for (int k = 0; k < R::INPUTS; ++k)
            tma_load_3d(base + k * TILE_BYTES, &p.map[k], &full[st], w0,
                        t0 - (k == 2), b);
        }
      } else {
        for (int k = 0; k < R::INPUTS; ++k)
          for (int j = 0; j < T; ++j) {
            const int t = t0 + j - (k == 2);   // hs: the step before
            const bool ok = w < p.W && t >= 0 && t < p.S;
            const float* src =
                ok ? p.in[k] + ((int64_t)b * p.S + t) * p.W + w : p.in[k];
            cp_async4(base + k * TILE_BYTES + (j * CH + lane) * 4, src,
                      ok ? 4u : 0u);
          }
        cp_async_arrive(&full[st]);
      }
    }
    if (!TMA) asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }

  // the consumer: lane = channel w0 + lane.  A stage's inputs go to
  // registers first, so the chain of T steps waits on no shared-memory
  // load (the compiler may not move a load past the global stores).
  const int w = w0 + lane;
  const bool keep = w < p.W;
  float h = 0.f;       // forward: h_{t-1}; reverse: G_{t+1}
  float a_next = 0.f;  // reverse: a_{t+1}
  for (int i = 0; i < chunks; ++i) {
    const int st = i % STAGES;
    const int t0 = (REVERSE ? chunks - 1 - i : i) * T;
    const int n = min(T, p.S - t0);
    mbar_wait(&full[st], (i / STAGES) & 1);
    const float* tile =
        reinterpret_cast<const float*>(ring + st * R::STAGE_BYTES) + lane;
    float av[T], xv[T], hv[REVERSE ? T : 1];
#pragma unroll
    for (int j = 0; j < T; ++j) {
      av[j] = tile[j * CH];
      xv[j] = tile[(T + j) * CH];
      if constexpr (REVERSE) hv[j] = tile[(2 * T + j) * CH];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);   // the stage is in registers
    float* out = p.out + ((int64_t)b * p.S + t0) * p.W + w;
    float* da = REVERSE ? p.da + (out - p.out) : nullptr;
    if constexpr (!REVERSE) {
#pragma unroll
      for (int j = 0; j < T; ++j) {
        if (j >= n) break;
        h = __fadd_rn(__fmul_rn(av[j], h), xv[j]);
        if (keep) out[(int64_t)j * p.W] = h;
      }
    } else {
#pragma unroll
      for (int j = T - 1; j >= 0; --j) {
        if (j >= n) continue;
        h = __fadd_rn(xv[j], __fmul_rn(a_next, h));
        if (keep) {
          out[(int64_t)j * p.W] = h;
          da[(int64_t)j * p.W] = __fmul_rn(h, hv[j]);
        }
        a_next = av[j];
      }
    }
  }
}

// one (B, S, W) f32 tensor as (W, S, B), boxes of 32 channels x T steps
bool encode(CUtensorMap* map, const void* ptr, int B, int S, int W) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)W * 4, (cuuint64_t)S * W * 4};
  const cuuint32_t box[3] = {CH, T, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool REVERSE, bool TMA>
int launch(const Args& p, cudaStream_t stream) {
  using R = Ring<REVERSE>;
  auto kernel = rg_lru_scan_kernel<REVERSE, TMA>;
  static uint64_t ready = 0;   // devices whose shared-memory limit is raised
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 64 && !((ready >> dev) & 1u)) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             R::SMEM);
    if (e != cudaSuccess) return (int)e;
    ready |= 1ull << dev;
  }
  const dim3 grid((p.W + CH - 1) / CH, p.B);
  kernel<<<grid, THREADS, R::SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// forward (reverse == 0): x = b, out = h; hs and da are not read.
// reverse (reverse != 0): x = g, hs = the forward's h, out = db, da = da.
extern "C" int rg_lru_scan(const void* a, const void* x, const void* hs,
                           void* out, void* da, int B, int S, int W,
                           int reverse, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  Args p = {};
  const void* in[3] = {a, x, reverse ? hs : nullptr};
  const int inputs = reverse ? 3 : 2;
  bool tma = W % 4 == 0;
  for (int k = 0; k < inputs; ++k) {
    p.in[k] = (const float*)in[k];
    tma = tma && (uintptr_t)in[k] % 16 == 0;
  }
  for (int k = 0; k < inputs && tma; ++k)
    if (!encode(&p.map[k], in[k], B, S, W)) return (int)cudaErrorInvalidValue;
  p.out = (float*)out;
  p.da = (float*)da;
  p.B = B;
  p.S = S;
  p.W = W;
  cudaStream_t s = (cudaStream_t)stream;
  if (reverse)
    return tma ? launch<true, true>(p, s) : launch<true, false>(p, s);
  return tma ? launch<false, true>(p, s) : launch<false, false>(p, s);
}
