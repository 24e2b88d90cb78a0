// K2: both comb-postfilter calls of one CELT frame, in place, int32.
//
// Replaces: esp32_opus_player_tpu/ops/celt/pallas_comb.py::comb_filter_step_T
// (kernel _make_comb_kernel / _comb_region, launched by _run_comb).
// Reference: comb_filter src/celt.cpp:848, called twice per frame at
// :2385-2389.
//
// Layout: buf (L, B) int32, time on rows, streams contiguous. Region 1 is
// rows [start, start+120) with the crossfade (T0, g0, tap0) -> (T1, g1,
// tap1) of params rows 0..5; region 2 is [start+120, start+N) with rows
// 6..11, and its own 120-sample crossfade.
//
// What bounds it: a 5-tap feedback recurrence at a per-stream lag T in
// 15..1024 is sequential in time and independent across streams. One
// thread walks one stream sample by sample, in the reference's own order.
// The TPU kernel's bit-decomposed row shift and 13-sample chunk walk are
// Mosaic workarounds (no per-lane dynamic indexing); every tap lies at
// least T-2 >= 13 samples back, so the chunk walk and this walk read the
// same finished values and give the same bits. Adjacent threads read
// adjacent streams of one row, so each access of a warp is coalesced;
// the taps slide by one row per sample, so each thread keeps the last
// four of each tap window in registers and loads two taps per sample.
// With one thread per stream the card runs only B threads: the kernel is
// bound by the latency of that dependent chain, not by bandwidth.
#include <cuda_runtime.h>

#include "celt_common.cuh"

using namespace otpu;

namespace {

constexpr int kOverlap = 120;
constexpr int kMinPeriod = 15;
constexpr int kMaxPeriod = 1024;
constexpr int32_t kSigSat = 300000000;

__device__ void comb_region(int32_t* __restrict__ col, int B, int start,
                            int N, const int32_t* __restrict__ par, int b,
                            const int32_t* __restrict__ ftab,
                            const int32_t* __restrict__ gains) {
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

__global__ void comb_step_kernel(int32_t* __restrict__ buf, int B,
                                 int start, int N,
                                 const int32_t* __restrict__ par,
                                 const int32_t* __restrict__ ftab,
                                 const int32_t* __restrict__ gains) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int n1 = min(kOverlap, N);
  comb_region(buf + b, B, start, n1, par, b, ftab, gains);
  if (N > n1)
    comb_region(buf + b, B, start + n1, N - n1, par + 6 * B, b, ftab, gains);
}

}  // namespace

// buf: (L, B) int32, updated in place over rows [start, start+N);
// start >= MAX_PERIOD + 2 and start + N <= L are the caller's to check.
// par: (12, B) int32 = comb1 then comb2, each (T0, T1, g0, g1, tapset0,
// tapset1). ftab: 120 crossfade factors (window^2 >> 15); gains: the
// (3, 3) tapset gain table. Returns cudaGetLastError().
extern "C" int celt_comb_step(int32_t* buf, int B, int start, int N,
                              const int32_t* par, const int32_t* ftab,
                              const int32_t* gains, void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 64;
  comb_step_kernel<<<(B + threads - 1) / threads, threads, 0,
                     (cudaStream_t)stream>>>(buf, B, start, N, par, ftab,
                                             gains);
  return (int)cudaGetLastError();
}
