// K4: both comb-postfilter calls of one CELT frame, then the deemphasis
// IIR over the rows they wrote, one channel, one launch.
//
// Replaces: esp32_opus_player_tpu/ops/celt/pallas_comb.py::comb_deemph_step_T
// (kernel _make_comb_deemph_kernel). Reference: comb_filter src/celt.cpp:848
// (called at :2385-2389), deemphasis :1988 at downsample 1.
//
// Layout: buf (L, B) int32, time on rows, streams contiguous, updated in
// place over rows [start, start+N); par (12, B) as K2's; mem (B,) int32;
// pcm (N, B) int16.
//
// What bounds it: the comb's walk by one thread per stream through global
// memory (celt_comb.cuh::comb_region: a 5-tap feedback recurrence at a
// per-stream lag, a load behind each store) followed by K3's first-order
// recurrence over the same N rows: latency-bound like both. The TPU kernel
// fused them to keep the frame's rows in VMEM between the two and to save
// a launch. Here the fusion saves a launch and one read of the rows from
// L2, microseconds both, while both walks wait on load latency sample by
// sample: as on the TPU, this fused form is no faster than two launches.
// On an H100 80GB HBM3 at 700 W, at (2168, 2048) and N 960
// (chip_smoke.py): 0.443 ms against 0.388 ms for the same one-thread comb
// and K3 apart; a variant that fed the deemphasis from the comb's
// registers instead of reading the rows back took 0.506 ms. K2 has since
// left this walk for a shared-memory tile with a warp per stream
// (celt_comb.cu); whether a deemphasis epilogue on that tile pays is open
// (PERF.md). The epilogue below reads back the rows its thread wrote.
#include <cuda_runtime.h>

#include "celt_comb.cuh"

using namespace otpu;

namespace {

constexpr int32_t kPreemph = 27853;

__global__ void comb_deemph_kernel(int32_t* __restrict__ buf, int B,
                                   int start, int N,
                                   const int32_t* __restrict__ par,
                                   const int32_t* __restrict__ ftab,
                                   const int32_t* __restrict__ gains,
                                   const int32_t* __restrict__ mem_in,
                                   int32_t* __restrict__ mem_out,
                                   int16_t* __restrict__ pcm) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int32_t* col = buf + b;
  const int n1 = min(kOverlap, N);
  comb_region(col, B, start, n1, par, b, ftab, gains);
  if (N > n1)
    comb_region(col, B, start + n1, N - n1, par + 6 * B, b, ftab, gains);
  // deemphasis over the rows just written (K3's body at downsample 1)
  int32_t m = mem_in[b];
  int16_t* out = pcm + b;
  for (int n = 0; n < N; ++n) {
    const int32_t tmp = wadd(col[(size_t)(start + n) * B], m);
    m = smul(tmp, kPreemph);
    out[(size_t)n * B] =
        (int16_t)clamp32(wadd(tmp, 2048) >> 12, -32768, 32767);
  }
  mem_out[b] = m;
}

}  // namespace

// buf: (L, B) int32, updated in place over rows [start, start+N);
// start >= MAX_PERIOD + 2 and start + N <= L are the caller's to check.
// par, ftab, gains: as celt_comb_step. mem_in, mem_out: (B,) int32 (may
// not alias); pcm: (N, B) int16. Returns cudaGetLastError().
extern "C" int celt_comb_deemph(int32_t* buf, int B, int start, int N,
                                const int32_t* par, const int32_t* ftab,
                                const int32_t* gains, const int32_t* mem_in,
                                int32_t* mem_out, int16_t* pcm,
                                void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 64;
  comb_deemph_kernel<<<(B + threads - 1) / threads, threads, 0,
                       (cudaStream_t)stream>>>(buf, B, start, N, par, ftab,
                                               gains, mem_in, mem_out, pcm);
  return (int)cudaGetLastError();
}
