// The comb postfilter of one region, shared by K2 (celt_comb.cu) and K4
// (celt_comb_deemph.cu): one comb_filter call (reference src/celt.cpp:848)
// walked by one thread over one stream's column, sample by sample.
#pragma once
#include <cuda_runtime.h>

#include "celt_common.cuh"

namespace otpu {

constexpr int kOverlap = 120;
constexpr int kMinPeriod = 15;
constexpr int kMaxPeriod = 1024;
constexpr int32_t kSigSat = 300000000;

__device__ __forceinline__ void comb_region(
    int32_t* __restrict__ col, int B, int start, int N,
    const int32_t* __restrict__ par, int b,
    const int32_t* __restrict__ ftab, const int32_t* __restrict__ gains) {
  int T0 = min(max(par[0 * B + b], kMinPeriod), kMaxPeriod);
  int T1 = min(max(par[1 * B + b], kMinPeriod), kMaxPeriod);
  const int32_t g0 = par[2 * B + b], g1 = par[3 * B + b];
  const int tap0 = min(max(par[4 * B + b], 0), 2);
  const int tap1 = min(max(par[5 * B + b], 0), 2);
  if (g0 == 0 && g1 == 0) return;
  const bool same = g0 == g1 && T0 == T1 && tap0 == tap1;
  // MULT16_16_P15(g, gain): 16-bit operands, the product fits int32
  const int32_t g00 = (16384 + g0 * gains[3 * tap0]) >> 15;
  const int32_t g01 = (16384 + g0 * gains[3 * tap0 + 1]) >> 15;
  const int32_t g02 = (16384 + g0 * gains[3 * tap0 + 2]) >> 15;
  const int32_t g10 = (16384 + g1 * gains[3 * tap1]) >> 15;
  const int32_t g11 = (16384 + g1 * gains[3 * tap1 + 1]) >> 15;
  const int32_t g12 = (16384 + g1 * gains[3 * tap1 + 2]) >> 15;
  // with g1 == 0 nothing changes past the crossfade
  const int n_end = g1 == 0 ? min(N, kOverlap) : N;
  const size_t ld = (size_t)B;
  // taps at pos - T + {-2, -1, 0, +1}; the +2 tap is loaded per sample
  int32_t a0 = col[(start - T0 - 2) * ld], a1 = col[(start - T0 - 1) * ld];
  int32_t a2 = col[(start - T0) * ld], a3 = col[(start - T0 + 1) * ld];
  int32_t c0 = col[(start - T1 - 2) * ld], c1 = col[(start - T1 - 1) * ld];
  int32_t c2 = col[(start - T1) * ld], c3 = col[(start - T1 + 1) * ld];
  for (int rel = 0; rel < n_end; ++rel) {
    const int pos = start + rel;
    const int32_t a4 = col[(pos - T0 + 2) * ld];
    const int32_t c4 = col[(pos - T1 + 2) * ld];
    const int32_t x = col[pos * ld];
    int32_t y;
    if (rel < kOverlap && !same) {
      const int32_t f = ftab[rel], fa = 32767 - f;
      y = wadd(x, smul(a2, mult16_16_q15(fa, g00)));
      y = wadd(y, smul(wadd(a3, a1), mult16_16_q15(fa, g01)));
      y = wadd(y, smul(wadd(a4, a0), mult16_16_q15(fa, g02)));
      y = wadd(y, smul(c2, mult16_16_q15(f, g10)));
      y = wadd(y, smul(wadd(c3, c1), mult16_16_q15(f, g11)));
      y = wadd(y, smul(wadd(c4, c0), mult16_16_q15(f, g12)));
    } else {
      // comb_filter_const: the new params with the raw gains
      y = wadd(x, smul(c2, g10));
      y = wadd(y, smul(wadd(c3, c1), g11));
      y = wadd(y, smul(wadd(c4, c0), g12));
    }
    col[pos * ld] = clamp32(y, -kSigSat, kSigSat);
    a0 = a1; a1 = a2; a2 = a3; a3 = a4;
    c0 = c1; c1 = c2; c2 = c3; c3 = c4;
  }
}

}  // namespace otpu
