// The tensor-core route of the flash-attention kernels for bf16 operands,
// shared by K3 (zo_dual_flash_attention.cu, two streams per block) and K5
// (flash_attention.cu, one stream): per stream s,
//   o_s = softmax(mask(softcap(scale * q_s k_s^T) [+ mu_s * U])) v_s,
// q (B, Sq, H, D), k and v (B, Skv, Kv, D), o like q, with GQA (q head h
// reads kv head h / (H / Kv)), causal masking, a local window, the soft-cap
// and, for a perturbed stream, mu * U[row_offset + h*Sq + q, kv] (hash.cuh)
// added after the soft-cap and before the mask.  f32 operands, and bf16
// that TMA cannot take, stay on the CUDA-core loop of flash_tile.cuh.
//
// Layout.  The tensors keep the model's (B, S, heads, D) layout.  A 4-D
// TMA tensor map over (D, heads, S, B) cuts a tile of 64 (Q) or BKV (K, V)
// rows of one head as 64-column sub-tiles with 128-byte rows and 128-byte
// swizzle; rows past S and columns past D load as zeros, so ragged tails
// need no code.  A head width D (a multiple of 8, for TMA's 16-byte row
// strides) runs at the compiled width DC = 16, 32, 64, 128 or 256 that
// holds it: DC/16 k16 steps of Q K^T (the columns past D add exact zeros)
// and ceil(DC/64) sub-tiles of O, whose columns past D are not stored.
//
// Products.  S = Q K^T is wgmma m64nBKVk16 with both operands in shared
// memory, K-major (K's (S, D) rows are K-major for K^T): D/16 steps.  The
// products of bf16 values are exact in f32, so the scores keep the
// CUDA-core loop's precision up to summation order.  O += P V is wgmma
// m64n64k16 per 64-column chunk of O, P from registers (the S accumulator
// layout is the A-fragment layout) and V from shared memory MN-major (the
// transpose bit).  P is f32 in (0, 1]; one bf16 rounding of it moves the
// outputs outside the plain version's tolerance
// (tests/test_torch_flash_split.py), so P goes in as hi = bf16(p) and
// lo = bf16(p - hi), two wgmmas into one f32 accumulator, as the ZO
// matmul's perturbed weights do (zo_wgmma_matmul.cuh).
//
// Softmax.  Mask, soft-cap, score noise and the online softmax run on the
// S accumulator fragment in registers: a thread holds two rows (g and
// g + 8 of its warp's 16) and BKV/4 columns of each; row max and row sum
// take two quad shuffles; exp(x - m) is exp2f((x - m) * log2 e), and the
// epilogue multiplies by the rounded reciprocal of l.  The mask value is
// the finite NEG_INF = -2e38 and l is clamped at 1e-30, as in the TPU
// kernels; a tile whose every entry is valid skips the mask, and kv tiles
// masked for every row of the 64-row query tile are never loaded.  Every
// product and sum is written as an explicit intrinsic, so nvcc contracts
// nothing.
//
// Blocks.  A block owns one 64-row query tile of one (batch, head) and
// runs one consumer warpgroup per stream: K5 one; K3 two, streams a and b
// on the same query tile, for D <= 128 (its scores mode loads each K/V
// tile once for both), and one per block at D = 256, where two
// 128-register O accumulators in one block would spill (launch_dim).  One
// producer warp loads the Q tiles once and keeps a ring of 2 stages of
// K/V tiles in flight with TMA (K3's weights mode: K_a, V_a, K_b, V_b per
// stage; its scores mode and K5: one K and one V).  The kv tile is 64
// columns, 32 at D = 256, which keeps D = 256's O accumulator, S and P
// within 190 registers.  Query tiles run heaviest (most causal kv tiles)
// first.
//
// Bit equality.  A stream runs the same wgmmas and the same register
// arithmetic in the same order in both kernels (the same template), so
// K5 equals the matching stream of K3 in the weights mode bit for bit.
//
// Route.  The wrappers (kernels/flash_attention.py) send a bf16 launch here
// when D is a multiple of 8 up to 256, Skv > 0 and every base pointer is
// 16-byte aligned (TMA's strides are then multiples of 16 bytes).
#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hash.cuh"
#include "hopper.cuh"

namespace fa_wgmma {

using namespace hopper;

constexpr int BQ = 64;            // query rows per stream: the wgmma M
constexpr int STAGES = 2;
constexpr int ROW = 128;          // bytes of a sub-tile row: 64 bf16
constexpr float NEG_INF = -2.0e38f;
constexpr float LOG2E = 1.4426950408889634f;   // exp(x) = 2^(x log2 e)

template <int D, int NS, bool SHARED>
struct Layout {
  static constexpr int BKV = D > 128 ? 32 : 64;   // kv columns per tile
  static constexpr int NC = D < 64 ? 1 : D / 64;  // 64-column sub-tiles
  static constexpr int Q_BYTES = NC * BQ * ROW;   // one stream's Q tile
  static constexpr int KV_BYTES = NC * BKV * ROW; // one K or V tile
  static constexpr int KV_TILES = (NS == 2 && !SHARED) ? 4 : 2;
  static constexpr int STAGE_BYTES = KV_TILES * KV_BYTES;
  static constexpr int THREADS = 128 * NS + 32;   // + one producer warp
  // Q tiles, the ring, 1024 bytes of alignment slack, the barriers
  static constexpr int SMEM =
      NS * Q_BYTES + STAGES * STAGE_BYTES + 1024 + (1 + 2 * STAGES) * 8;
};

template <int NA>
struct Args {
  CUtensorMap q[NA];   // (D, H, Sq, B): box 64 x 1 x 64 x 1
  CUtensorMap k[NA];   // (D, Kv, Skv, B): box 64 x 1 x BKV x 1; equal
  CUtensorMap v[NA];   //   for every stream when the streams share K/V
  __nv_bfloat16* o[NA];
  float mu[NA];
  int perturb[NA];
  int B, Sq, Skv, H, Kv, D, causal, window;   // D: the real head width
  float cap, scale;
  uint32_t seed, row_offset;
};

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Descriptor of an MN-major operand tile with 128-byte swizzle (V as B of
// P V): 64 N columns per 128-byte row, 8-row K groups 1024 bytes apart.  A
// 64-wide N needs one swizzle atom, so the leading field (the atom stride
// along N) is not used; it is set to the K-group stride as well.
__device__ __forceinline__ uint64_t desc_mn_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// d (64 x 64, f32) (+)= a (64 x 16) b (16 x 64), both bf16 K-major in
// shared memory; acc == 0 overwrites d
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                       int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

// the same with a 32-wide N (the kv tile at D = 256)
__device__ __forceinline__ void mma_ss(float (&d)[16], uint64_t a, uint64_t b,
                                       int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}

// d (64 x 64, f32) += a (64 x 16, bf16, registers) b (16 x 64, bf16,
// MN-major in shared memory)
__device__ __forceinline__ void mma_rs_t(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ---------------------------------------------------------------------------
// the block
// ---------------------------------------------------------------------------

// The kv tiles [lo, hi) that can hold a valid entry for some query row of
// the tile at q0 (flash_tile.cuh's rule at this route's kv tile width).
template <int BKV>
__device__ __forceinline__ void kv_tile_range(int q0, int Sq, int Skv,
                                              int causal, int window, int& lo,
                                              int& hi) {
  const int q_last = min(q0 + BQ, Sq) - 1;
  hi = (Skv + BKV - 1) / BKV;
  if (causal) hi = min(hi, q_last / BKV + 1);
  lo = 0;
  if (window > 0 && q0 - window + 1 > 0) lo = (q0 - window + 1) / BKV;
}

// One stream of one query tile: the consumer warpgroup's whole life.
// Accumulator element e of a thread sits at row 16*wq + g + 8*((e >> 1) & 1)
// and column 8*(e >> 2) + 2*t4 + (e & 1) of its 64-row tile.
template <int D, int NA, int NS, bool SHARED, bool NOISE>
__device__ __forceinline__ void consume(const Args<NA>& a, int s, int wg,
                                        const uint8_t* q_tile,
                                        const uint8_t* ring, uint64_t* qbar,
                                        uint64_t* full, uint64_t* empty,
                                        int b, int h, int q0, int t_lo,
                                        int t_hi) {
  using L = Layout<D, NS, SHARED>;
  constexpr int BKV = L::BKV, NC = L::NC;
  constexpr int SR = BKV / 2, KJ = BKV / 16;   // S registers, kv k16 chunks
  const int tid = threadIdx.x % 128, wq = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int row0 = q0 + 16 * wq + g;           // this thread's rows: +0, +8
  const int k_off = SHARED ? 0 : 2 * wg * L::KV_BYTES;
  const bool perturb = NOISE && a.perturb[s];
  const float mu = a.mu[s], scale = a.scale, cap = a.cap;
  uint32_t rterm[2] = {0u, 0u};
  if (perturb) {
    rterm[0] = zo_mix_row(a.seed, a.row_offset + (uint32_t)(h * a.Sq + row0));
    rterm[1] =
        zo_mix_row(a.seed, a.row_offset + (uint32_t)(h * a.Sq + row0 + 8));
  }

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
  float o[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[c][e] = 0.0f;

  mbar_wait(qbar, 0);
  const uint32_t qa = smem_u32(q_tile);
#pragma unroll 1
  for (int t = t_lo; t < t_hi; ++t) {
    const int i = t - t_lo, st = i % STAGES;
    mbar_wait(&full[st], (i / STAGES) & 1);
    const uint32_t ka = smem_u32(ring + st * L::STAGE_BYTES + k_off);
    const uint32_t va = ka + L::KV_BYTES;

    // S = Q K^T
    float sc[SR];
#pragma unroll
    for (int e = 0; e < SR; ++e) {
      sc[e] = 0.0f;
      pin(sc[e]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk / 4, off = (kk % 4) * 32;
      mma_ss(sc, desc_sw128(qa + c * BQ * ROW + off),
             desc_sw128(ka + c * BKV * ROW + off), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int e = 0; e < SR; ++e) pin(sc[e]);

    // scale, soft-cap, noise, mask; the rows' max.  A tile whose every
    // (row, col) pair is valid skips the mask.
    const int kv0 = t * BKV;
    const bool masked =
        kv0 + BKV > a.Skv || (a.causal && kv0 + BKV - 1 > q0) ||
        (a.window > 0 && q0 + BQ - 1 - kv0 >= a.window);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int e = 0; e < SR; ++e) {
      const int r = (e >> 1) & 1;
      const int row = row0 + 8 * r;
      const int col = kv0 + 8 * (e >> 2) + 2 * t4 + (e & 1);
      float x = __fmul_rn(sc[e], scale);
      if (cap > 0.0f) x = __fmul_rn(cap, tanhf(__fdiv_rn(x, cap)));
      if (perturb)
        x = __fadd_rn(x, __fmul_rn(mu, zo_bits_to_uniform(zo_mix_final(
                                           rterm[r] ^ zo_mix_col(col)))));
      if (masked) {
        bool ok = col < a.Skv;
        if (a.causal) ok = ok && row >= col;
        if (a.window > 0) ok = ok && row - col < a.window;
        x = ok ? x : NEG_INF;
      }
      sc[e] = x;
      mx[r] = fmaxf(mx[r], x);
    }
    float alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      mx[r] = fmaxf(m[r], mx[r]);                 // m_new
    }
#pragma unroll
    for (int e = 0; e < SR; ++e) {
      const int r = (e >> 1) & 1;
      sc[e] = exp2f(__fmul_rn(__fsub_rn(sc[e], mx[r]), LOG2E));
      sum[r] = __fadd_rn(sum[r], sc[e]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] = __fadd_rn(sum[r], __shfl_xor_sync(0xffffffffu, sum[r], 1));
      sum[r] = __fadd_rn(sum[r], __shfl_xor_sync(0xffffffffu, sum[r], 2));
      alpha[r] = exp2f(__fmul_rn(__fsub_rn(m[r], mx[r]), LOG2E));
      l[r] = fmaf(l[r], alpha[r], sum[r]);
      m[r] = mx[r];
    }

    // P's A fragments, hi and lo: register j of kv chunk kc holds
    // elements 8*kc + 2*j and + 1
    uint32_t phi[KJ][4], plo[KJ][4];
#pragma unroll
    for (int kc = 0; kc < KJ; ++kc)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p0 = sc[8 * kc + 2 * j], p1 = sc[8 * kc + 2 * j + 1];
        const uint32_t hv = pack_bf16x2(p0, p1);
        phi[kc][j] = hv;
        plo[kc][j] = pack_bf16x2(__fsub_rn(p0, low_f32(hv)),
                                 __fsub_rn(p1, high_f32(hv)));
      }
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        o[c][e] = __fmul_rn(o[c][e], alpha[(e >> 1) & 1]);
        pin(o[c][e]);
      }

    // O += P V
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < KJ; ++kc)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const uint64_t vd = desc_mn_sw128(va + c * BKV * ROW + kc * 16 * ROW);
        mma_rs_t(o[c], phi[kc], vd);
        mma_rs_t(o[c], plo[kc], vd);
      }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) pin(o[c][e]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // o / max(l, 1e-30), as o times the rounded reciprocal, into the rows
  // below Sq and the columns below the real width a.D
  __nv_bfloat16* out = a.o[s];
  const float inv[2] = {__frcp_rn(fmaxf(l[0], 1e-30f)),
                        __frcp_rn(fmaxf(l[1], 1e-30f))};
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int r = (e >> 1) & 1;
      const int row = row0 + 8 * r;
      const int col = 64 * c + 8 * (e >> 2) + 2 * t4;
      if (row < a.Sq && col < a.D)
        *reinterpret_cast<__nv_bfloat162*>(
            out + (((int64_t)b * a.Sq + row) * a.H + h) * a.D + col) =
            __floats2bfloat162_rn(__fmul_rn(o[c][e], inv[r]),
                                  __fmul_rn(o[c][e + 1], inv[r]));
    }
}

template <int D, int NA, int NS, bool SHARED, bool NOISE>
__global__ void __launch_bounds__(Layout<D, NS, SHARED>::THREADS, 1)
    fa_wgmma_kernel(const __grid_constant__ Args<NA> a) {
  using L = Layout<D, NS, SHARED>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = smem + NS * L::Q_BYTES;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(ring + STAGES * L::STAGE_BYTES);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + STAGES;

  // consumer warpgroups 0 .. NS - 1 run streams s0 .. s0 + NS - 1; then
  // the producer warp
  const int wg = threadIdx.x / 128, s0 = blockIdx.z * NS;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int kvh = h / (a.H / a.Kv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest tiles first
  int t_lo, t_hi;
  kv_tile_range<L::BKV>(q0, a.Sq, a.Skv, a.causal, a.window, t_lo, t_hi);

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 4 * NS);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == NS) {                       // the producer warp
    if (threadIdx.x == 128 * NS) {
      mbar_expect_tx(qbar, NS * L::Q_BYTES);
      for (int s = 0; s < NS; ++s)
        for (int c = 0; c < L::NC; ++c)
          tma_load_4d(smem + s * L::Q_BYTES + c * BQ * ROW, &a.q[s0 + s],
                      qbar, 64 * c, h, q0, b);
      for (int t = t_lo; t < t_hi; ++t) {
        const int i = t - t_lo, st = i % STAGES;
        mbar_wait(&empty[st], ((i / STAGES) & 1) ^ 1);
        uint8_t* base = ring + st * L::STAGE_BYTES;
        mbar_expect_tx(&full[st], L::STAGE_BYTES);
        for (int s = 0; s < L::KV_TILES / 2; ++s)
          for (int c = 0; c < L::NC; ++c) {
            tma_load_4d(base + 2 * s * L::KV_BYTES + c * L::BKV * ROW,
                        &a.k[s0 + s], &full[st], 64 * c, kvh, t * L::BKV, b);
            tma_load_4d(base + (2 * s + 1) * L::KV_BYTES + c * L::BKV * ROW,
                        &a.v[s0 + s], &full[st], 64 * c, kvh, t * L::BKV, b);
          }
      }
    }
  } else {
    consume<D, NA, NS, SHARED, NOISE>(a, s0 + wg, wg, smem + wg * L::Q_BYTES,
                                      ring, qbar, full, empty, b, h, q0,
                                      t_lo, t_hi);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// one (B, S, heads, D) bf16 tensor as (D, heads, S, B), tiles of 64 columns
// x 1 head x `rows` positions x 1 batch with 128-byte swizzle; out-of-range
// elements load as zeros
inline bool encode_heads(CUtensorMap* map, const void* ptr, int B, int S,
                         int heads, int D, int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int NA, int NS, bool SHARED, bool NOISE>
int launch_kernel(const Args<NA>& a, cudaStream_t stream) {
  using L = Layout<D, NS, SHARED>;
  static_assert(L::SMEM <= 232448, "shared memory over the 227 KB limit");
  auto kernel = fa_wgmma_kernel<D, NA, NS, SHARED, NOISE>;
  static uint64_t ready = 0;   // devices whose shared-memory limit is raised
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 64 && !((ready >> dev) & 1u)) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::SMEM);
    if (e != cudaSuccess) return (int)e;
    ready |= 1ull << dev;
  }
  const dim3 grid(a.B * a.H, (a.Sq + BQ - 1) / BQ, NA / NS);
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  kernel<<<grid, L::THREADS, L::SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

// K5 (NA = 1) runs one stream per block.  K3 (NA = 2) runs both streams in
// one block, sharing the K/V stages in the scores mode, up to D = 128; at
// D = 256 two 128-register O accumulators do not fit the 168 registers
// ptxas gives a block of two consumer warpgroups and a producer (it spills
// and serializes the wgmmas), so K3 runs one stream per block there, a
// grid of 2 x K5's blocks.
template <int D, int NA>
int launch_dim(const Args<NA>& a, bool shared, bool noise,
               cudaStream_t stream) {
  if constexpr (NA == 1) {
    return launch_kernel<D, 1, 1, false, false>(a, stream);
  } else if constexpr (D == 256) {
    return noise ? launch_kernel<D, 2, 1, false, true>(a, stream)
                 : launch_kernel<D, 2, 1, false, false>(a, stream);
  } else {
    // the scores mode always instantiates the noise path; its runtime
    // flags leave a clean stream without noise
    if (shared) return launch_kernel<D, 2, 2, true, true>(a, stream);
    return noise ? launch_kernel<D, 2, 2, false, true>(a, stream)
                 : launch_kernel<D, 2, 2, false, false>(a, stream);
  }
}

// The launch of NA streams: q[s], k[s], v[s] -> o[s] (k[s], v[s] the same
// for every s when `shared`); perturb[s] adds mu[s] * U to stream s's
// scores.  Returns a cudaError_t code.
template <int NA>
int launch(const void* const (&q)[NA], const void* const (&k)[NA],
           const void* const (&v)[NA], void* const (&o)[NA],
           const float (&mu)[NA], const int (&perturb)[NA], bool shared,
           int B, int Sq, int Skv, int H, int Kv, int D, int causal,
           int window, float cap, float scale, uint32_t seed,
           uint32_t row_offset, cudaStream_t stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Kv <= 0 || H % Kv != 0 || D <= 0 ||
      D > 256 || D % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const int bkv = D > 128 ? 32 : 64;
  Args<NA> a;
  bool noise = false;
  for (int s = 0; s < NA; ++s) {
    if ((uintptr_t)q[s] % 16 || (uintptr_t)k[s] % 16 ||
        (uintptr_t)v[s] % 16 || (uintptr_t)o[s] % 16)
      return (int)cudaErrorInvalidValue;
    if (!encode_heads(&a.q[s], q[s], B, Sq, H, D, BQ) ||
        !encode_heads(&a.k[s], k[s], B, Skv, Kv, D, bkv) ||
        !encode_heads(&a.v[s], v[s], B, Skv, Kv, D, bkv))
      return (int)cudaErrorInvalidValue;
    a.o[s] = (__nv_bfloat16*)o[s];
    a.mu[s] = mu[s];
    a.perturb[s] = perturb[s];
    noise = noise || perturb[s];
  }
  a.B = B;
  a.Sq = Sq;
  a.Skv = Skv;
  a.H = H;
  a.Kv = Kv;
  a.D = D;
  a.causal = causal;
  a.window = window;
  a.cap = cap;
  a.scale = scale;
  a.seed = seed;
  a.row_offset = row_offset;
  if (D <= 16) return launch_dim<16, NA>(a, shared, noise, stream);
  if (D <= 32) return launch_dim<32, NA>(a, shared, noise, stream);
  if (D <= 64) return launch_dim<64, NA>(a, shared, noise, stream);
  if (D <= 128) return launch_dim<128, NA>(a, shared, noise, stream);
  return launch_dim<256, NA>(a, shared, noise, stream);
}

}  // namespace fa_wgmma
