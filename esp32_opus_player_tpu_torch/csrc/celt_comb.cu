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

#include "celt_comb.cuh"

using namespace otpu;

namespace {

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
