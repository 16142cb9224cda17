// Kernel K6: the RG-LRU linear recurrence over time, f32,
//   forward:  h_t = a_t * h_{t-1} + b_t            (h_{-1} = 0)
//   reverse:  G_t = g_t + a_{t+1} * G_{t+1}         (G_S = 0)
//             da_t = G_t * h_{t-1}, and db_t = G_t,
// the second being the gradient of the first given g = dL/dh, run as the
// same recurrence backwards over time.  a, b, g, h: (B, S, W) contiguous.
//
// Replaces the Pallas kernel `_rg_lru_kernel` / `rg_lru_scan` of
// src/repro/kernels/rg_lru.py.  The TPU kernel walks (width, time) tiles
// with the running state in VMEM scratch and a sequential time axis; here
// one thread owns one (b, w) channel, carries h in a register and loops
// over t, with neighbouring threads on neighbouring w, so each time step's
// loads and stores are coalesced.  The TPU kernel has no backward (JAX
// differentiates `associative_scan`); on the card the alternative is the
// plain per-step loop, S small launches per block, so the reverse mode is
// a flag of this kernel.
//
// Rounding: each step is __fadd_rn(__fmul_rn(.)), never contracted into
// an FMA, so the kernel equals the plain version (a multiply, then an add)
// bit for bit in both modes.
//
// Bound on the H100: bytes, 12 per element forward (read a, b; write h)
// and 20 reverse (read a, g, h; write da, db), over 3.35 TB/s.  The
// design is far from it: at the round's shapes (B*W = 8192 channels)
// there is about one 64-thread block per SM, and each thread's chain
// through h is sequential.  Loads of CHUNK steps are issued together
// ahead of their use to keep some bytes in flight; a time-chunked
// two-pass scan would fill the card.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 64;
constexpr int CHUNK = 16;

template <bool REVERSE>
__global__ void __launch_bounds__(THREADS)
    rg_lru_scan_kernel(const float* __restrict__ a,
                       const float* __restrict__ x,
                       const float* __restrict__ hs, float* __restrict__ out,
                       float* __restrict__ da, int B, int S, int W) {
  const int64_t ch = blockIdx.x * (int64_t)THREADS + threadIdx.x;
  if (ch >= (int64_t)B * W) return;
  const int64_t base = (ch / W) * (int64_t)S * W + ch % W;   // (b, 0, w)
  float h = 0.f;       // forward: h_{t-1}; reverse: G_{t+1}
  float a_next = 0.f;  // reverse: a_{t+1}
  for (int c0 = 0; c0 < S; c0 += CHUNK) {
    float av[CHUNK], xv[CHUNK], hv[CHUNK];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      const int t = REVERSE ? S - 1 - (c0 + j) : c0 + j;
      av[j] = xv[j] = hv[j] = 0.f;
      if (c0 + j < S) {
        const int64_t i = base + (int64_t)t * W;
        av[j] = a[i];
        xv[j] = x[i];
        if (REVERSE && t > 0) hv[j] = hs[i - W];
      }
    }
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      if (c0 + j >= S) break;
      const int t = REVERSE ? S - 1 - (c0 + j) : c0 + j;
      const int64_t i = base + (int64_t)t * W;
      if (REVERSE) {
        h = __fadd_rn(xv[j], __fmul_rn(a_next, h));
        out[i] = h;
        da[i] = __fmul_rn(h, hv[j]);
        a_next = av[j];
      } else {
        h = __fadd_rn(__fmul_rn(av[j], h), xv[j]);
        out[i] = h;
      }
    }
  }
}

}  // namespace

// forward (reverse == 0): x = b, out = h; hs and da are not read.
// reverse (reverse != 0): x = g, hs = the forward's h, out = db, da = da.
extern "C" int rg_lru_scan(const void* a, const void* x, const void* hs,
                           void* out, void* da, int B, int S, int W,
                           int reverse, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const int64_t blocks = ((int64_t)B * W + THREADS - 1) / THREADS;
  if (blocks > 2147483647) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (reverse)
    rg_lru_scan_kernel<true><<<(unsigned)blocks, THREADS, 0, s>>>(
        (const float*)a, (const float*)x, (const float*)hs, (float*)out,
        (float*)da, B, S, W);
  else
    rg_lru_scan_kernel<false><<<(unsigned)blocks, THREADS, 0, s>>>(
        (const float*)a, (const float*)x, nullptr, (float*)out, nullptr, B,
        S, W);
  return (int)cudaGetLastError();
}
