// The comb postfilter (reference comb_filter, src/celt.cpp:848) shared by
// K2 (celt_comb.cu) and K4 (celt_comb_deemph.cu): the per-stream derived
// parameters, the arithmetic of one output sample, and K4's walk of one
// region by one thread over one stream's column in global memory. K2 walks
// the same samples from a shared-memory tile with a warp per stream
// (celt_comb.cu).
#pragma once
#include <cuda_runtime.h>

#include "celt_common.cuh"

namespace otpu {

constexpr int kOverlap = 120;
constexpr int kMinPeriod = 15;
constexpr int kMaxPeriod = 1024;
constexpr int32_t kSigSat = 300000000;

// One comb_filter call's parameters for one stream: lags clamped to
// [15, 1024], tapsets to [0, 2], the three tap gains of both parameter
// sets.
struct CombPar {
  int T0, T1;
  int32_t g00, g01, g02, g10, g11, g12;
  bool nop;    // both gains 0: the call changes nothing
  bool same;   // unchanged parameters: no crossfade
  bool g1z;    // new gain 0: nothing changes past the crossfade
};

// The six raw parameters of one stream (T0, T1, g0, g1, tapset0, tapset1);
// gains: the (3, 3) tapset gain table.
__device__ __forceinline__ CombPar comb_par(int32_t T0, int32_t T1,
                                            int32_t g0, int32_t g1,
                                            int32_t tapset0, int32_t tapset1,
                                            const int32_t* __restrict__ gains) {
  CombPar p;
  p.T0 = min(max(T0, kMinPeriod), kMaxPeriod);
  p.T1 = min(max(T1, kMinPeriod), kMaxPeriod);
  const int tap0 = min(max(tapset0, 0), 2);
  const int tap1 = min(max(tapset1, 0), 2);
  p.nop = g0 == 0 && g1 == 0;
  p.same = g0 == g1 && p.T0 == p.T1 && tap0 == tap1;
  p.g1z = g1 == 0;
  // MULT16_16_P15(g, gain): 16-bit operands, the product fits int32
  p.g00 = (16384 + g0 * gains[3 * tap0]) >> 15;
  p.g01 = (16384 + g0 * gains[3 * tap0 + 1]) >> 15;
  p.g02 = (16384 + g0 * gains[3 * tap0 + 2]) >> 15;
  p.g10 = (16384 + g1 * gains[3 * tap1]) >> 15;
  p.g11 = (16384 + g1 * gains[3 * tap1 + 1]) >> 15;
  p.g12 = (16384 + g1 * gains[3 * tap1 + 2]) >> 15;
  return p;
}

// One sample inside the crossfade: f = window^2 >> 15 at the in-call
// index; a0..a4 the taps at pos - T0 + {-2..2}, c0..c4 at pos - T1 + {-2..2}.
__device__ __forceinline__ int32_t comb_xfade(
    const CombPar& p, int32_t f, int32_t x, int32_t a0, int32_t a1,
    int32_t a2, int32_t a3, int32_t a4, int32_t c0, int32_t c1, int32_t c2,
    int32_t c3, int32_t c4) {
  const int32_t fa = 32767 - f;
  int32_t y = wadd(x, smul(a2, mult16_16_q15(fa, p.g00)));
  y = wadd(y, smul(wadd(a3, a1), mult16_16_q15(fa, p.g01)));
  y = wadd(y, smul(wadd(a4, a0), mult16_16_q15(fa, p.g02)));
  y = wadd(y, smul(c2, mult16_16_q15(f, p.g10)));
  y = wadd(y, smul(wadd(c3, c1), mult16_16_q15(f, p.g11)));
  y = wadd(y, smul(wadd(c4, c0), mult16_16_q15(f, p.g12)));
  return clamp32(y, -kSigSat, kSigSat);
}

// One sample past the crossfade (comb_filter_const): the new parameters
// with the raw gains.
__device__ __forceinline__ int32_t comb_const(const CombPar& p, int32_t x,
                                              int32_t c0, int32_t c1,
                                              int32_t c2, int32_t c3,
                                              int32_t c4) {
  int32_t y = wadd(x, smul(c2, p.g10));
  y = wadd(y, smul(wadd(c3, c1), p.g11));
  y = wadd(y, smul(wadd(c4, c0), p.g12));
  return clamp32(y, -kSigSat, kSigSat);
}

// K4's walk: one comb_filter call over rows [start, start+N) of one
// stream's column `col` (row stride B), by one thread, sample by sample.
__device__ __forceinline__ void comb_region(
    int32_t* __restrict__ col, int B, int start, int N,
    const int32_t* __restrict__ par, int b,
    const int32_t* __restrict__ ftab, const int32_t* __restrict__ gains) {
  const CombPar p = comb_par(par[b], par[B + b], par[2 * B + b],
                             par[3 * B + b], par[4 * B + b], par[5 * B + b],
                             gains);
  if (p.nop) return;
  const int T0 = p.T0, T1 = p.T1;
  const int n_end = p.g1z ? min(N, kOverlap) : N;
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
    col[pos * ld] = (rel < kOverlap && !p.same)
        ? comb_xfade(p, ftab[rel], x, a0, a1, a2, a3, a4, c0, c1, c2, c3, c4)
        : comb_const(p, x, c0, c1, c2, c3, c4);
    a0 = a1; a1 = a2; a2 = a3; a3 = a4;
    c0 = c1; c1 = c2; c2 = c3; c3 = c4;
  }
}

}  // namespace otpu
