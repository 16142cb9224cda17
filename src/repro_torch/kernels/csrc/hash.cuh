// The counter-hash noise stream U(seed)[r, c], the one device definition
// shared by kernels K1 (zo_noise.cu), K2 (zo_dual_matmul.cu), K3
// (zo_dual_flash_attention.cu) and K4 (zo_matmul.cu).
//
// It must equal, bit for bit, `_mix_bits` / `_bits_to_uniform` of
// src/repro/kernels/zo_matmul.py and the plain PyTorch version in
// src/repro_torch/kernels/noise.py:
//   * uint32 products wrap modulo 2^32 and shifts are logical;
//   * bits -> float rounds once, to nearest (__uint2float_rn);
//   * u01 = f * 2^-32 exactly, then (u01 * 2 - 1) * sqrt(3) in f32 with
//     explicit round-to-nearest intrinsics, so nvcc cannot contract the
//     multiply and add into one FMA (which rounds once instead of twice).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// The first XOR of the mix takes a row term, a column term and a seed term,
// so a tile loop can hoist the row and column parts (zo_mix_row /
// zo_mix_col) and finish each element with zo_mix_final; XOR is
// associative, so the split form gives the same bits.
__device__ __forceinline__ uint32_t zo_mix_row(uint32_t seed, uint32_t r) {
  return (r * 0x9E3779B9u) ^ (seed * 0x27D4EB2Fu + 0x165667B1u);
}

__device__ __forceinline__ uint32_t zo_mix_col(uint32_t c) {
  return c * 0x85EBCA6Bu;
}

__device__ __forceinline__ uint32_t zo_mix_final(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t zo_mix_bits(uint32_t seed, uint32_t r,
                                                uint32_t c) {
  return zo_mix_final(zo_mix_row(seed, r) ^ zo_mix_col(c));
}

__device__ __forceinline__ float zo_bits_to_uniform(uint32_t bits) {
  const float u01 = __fmul_rn(__uint2float_rn(bits), 2.3283064365386963e-10f);
  return __fmul_rn(__fadd_rn(__fmul_rn(u01, 2.0f), -1.0f),
                   1.7320508075688772f);
}

__device__ __forceinline__ float zo_uniform(uint32_t seed, uint32_t r,
                                            uint32_t c) {
  return zo_bits_to_uniform(zo_mix_bits(seed, r, c));
}
