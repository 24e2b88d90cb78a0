// Q-format helpers shared by the CELT synthesis kernels.
//
// The decoder's int32 chains wrap as two's complement (the reference is
// built with -fwrapv; XLA's int32 ops wrap). Signed overflow is undefined
// in CUDA C++, so every sum that can wrap goes through uint32_t, and no
// signed value is shifted left. `>>` on a negative int32 is arithmetic
// in nvcc, as the reference assumes.
#pragma once
#include <cstdint>

namespace otpu {

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}

__device__ __forceinline__ int32_t wneg(int32_t a) {
  return (int32_t)(0u - (uint32_t)a);
}

// S_MUL(x, t) = ((int64)t * x) >> 15, truncated to int32. For the 16-bit
// t of every call site this equals the hi/lo split of
// ops/celt/jax_synthesis.py::smul modulo 2^32.
__device__ __forceinline__ int32_t smul(int32_t x, int32_t t) {
  return (int32_t)(((int64_t)x * (int64_t)t) >> 15);
}

// MULT16_16_Q15 on 16-bit operands: the product fits int32.
__device__ __forceinline__ int32_t mult16_16_q15(int32_t a, int32_t b) {
  return (a * b) >> 15;
}

// The deemphasis coefficient (0.85 in Q15), and 27853 << 17 read as int32
// (27853 * 2^17 - 2^32): smul(t, 27853), the 64-bit product shifted right
// by 15, is the high word of t * (27853 << 17) as unsigned, which is
// __mulhi(t, kPreemphHi) + t (exact; the sum wraps as uint32, and its
// value fits int32). K3 and K4's epilogue take the product so.
constexpr int32_t kPreemph = 27853;
constexpr int32_t kPreemphHi = (int32_t)(27853u << 17);

__device__ __forceinline__ int32_t clamp32(int32_t x, int32_t lo,
                                           int32_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

}  // namespace otpu
