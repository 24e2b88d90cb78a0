// Q-format helpers of the SILK kernels (K5-K9), wrap-exact.
//
// They reproduce esp32_opus_player_tpu/ops/silk/jax_core.py's int32
// chains op for op. Signed overflow is undefined in CUDA C++ and nvcc has
// no -fwrapv, so every product, sum or left shift that can leave int32 is
// taken in uint32_t (or exactly in int64_t) and cast back; `>>` on a
// negative int32 is arithmetic in nvcc, as the JAX chains assume.
#pragma once
#include <cuda_pipeline.h>

#include <cstdint>

#include "celt_common.cuh"

namespace otpu {

constexpr int32_t kInt32Max = 2147483647;
constexpr int32_t kInt32Min = -2147483647 - 1;

__device__ __forceinline__ int32_t wshl(int32_t a, int s) {
  return (int32_t)((uint32_t)a << s);
}

__device__ __forceinline__ int32_t wmul(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a * (uint32_t)b);
}

// jax_core.smulwb: (a >> 16) * b + (((a & 0xFFFF) * b) >> 16), each
// product wrapped to int32 as the JAX chain wraps it (for |b| <= 2^15
// this is ((int64)a * b) >> 16).
__device__ __forceinline__ int32_t smulwb(int32_t a, int32_t b) {
  return wadd(wmul(a >> 16, b), wmul(a & 0xFFFF, b) >> 16);
}

__device__ __forceinline__ int32_t smlawb(int32_t a, int32_t b, int32_t c) {
  return wadd(a, smulwb(b, c));
}

// jax_core.smulww: ((int64)a * b) >> 16 modulo 2^32 (the int64 product is
// exact; its hi/lo split on the TPU gives the same low 32 bits).
__device__ __forceinline__ int32_t smulww(int32_t a, int32_t b) {
  return (int32_t)(uint32_t)(uint64_t)(((int64_t)a * (int64_t)b) >> 16);
}

// Saturating add: the exact sum clamped (the JAX form detects overflow
// from the wrapped sum; the values agree).
__device__ __forceinline__ int32_t add_sat32(int32_t a, int32_t b) {
  const int64_t s = (int64_t)a + (int64_t)b;
  return s > kInt32Max ? kInt32Max : (s < kInt32Min ? kInt32Min : (int32_t)s);
}

// add_sat32 without the 64-bit sum: the wrapped sum overflowed iff both
// operands differ from it in sign.
__device__ __forceinline__ int32_t add_sat(int32_t a, int32_t b) {
  const int32_t s = wadd(a, b);
  return ((a ^ s) & (b ^ s)) < 0 ? (a < 0 ? kInt32Min : kInt32Max) : s;
}

// smulwb(a, b) with a already split into a >> 16 and a & 0xFFFF.
__device__ __forceinline__ int32_t smul_split(int32_t hi, int32_t lo,
                                              int32_t b) {
  return wadd(wmul(hi, b), wmul(lo, b) >> 16);
}

// Clip first, so the shift cannot overflow.
__device__ __forceinline__ int32_t lshift_sat32(int32_t a, int s) {
  return wshl(clamp32(a, kInt32Min >> s, kInt32Max >> s), s);
}

__device__ __forceinline__ int32_t rshift_round(int32_t a, int s) {
  return s == 1 ? (a >> 1) + (a & 1) : ((a >> (s - 1)) + 1) >> 1;
}

__device__ __forceinline__ int32_t sat16(int32_t a) {
  return clamp32(a, -32768, 32767);
}

// One LPC synthesis step (silk_decode_core :1930-1950): ring holds the
// last 16 outputs, oldest first; returns the new output and shifts it in.
template <int ORDER>
__device__ __forceinline__ int32_t lpc_step(int32_t (&ring)[16],
                                            const int32_t (&a)[ORDER],
                                            int32_t x) {
  int32_t pred = ORDER >> 1;
#pragma unroll
  for (int j = 0; j < ORDER; ++j) pred = wadd(pred, smulwb(ring[15 - j], a[j]));
  const int32_t v = add_sat32(x, lshift_sat32(pred, 4));
#pragma unroll
  for (int j = 0; j < 15; ++j) ring[j] = ring[j + 1];
  ring[15] = v;
  return v;
}

// Stage n words of a row into shared memory, a lane per word, 32 lanes
// apart: 4-byte cp.async, so a row may start at any word. The caller
// commits and waits.
__device__ __forceinline__ void stage_row(int32_t* dst, const int32_t* src,
                                          int n, int lane) {
  for (int c = lane; c < n; c += 32)
    __pipeline_memcpy_async(dst + c, src + c, 4);
}

}  // namespace otpu
