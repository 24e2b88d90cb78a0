// K5: the SILK order-10/16 LPC synthesis recurrence.
//
// Replaces: esp32_opus_player_tpu/ops/silk/pallas_core.py::lpc_synth_pallas
// (kernel _lpc_kernel). Reference: silk_decode_core src/silk.cpp:1930-1950.
//
// Layout: the JAX row layout, pres and vs (B, n), A (B, order), state
// (B, 16), all int32 and contiguous.
//
// What bounds it: its int32 operations (order x 7 + 8 per sample) over
// its bytes, but a feedback recurrence, sequential in time and
// independent across streams, is latency-bound on the card: at the
// pool's widths (buckets below 128 rows) only B threads exist. One thread
// per stream keeps the 16-sample ring and the coefficients in registers
// (the TPU kernel kept the ring as a trace-time list of rows for the same
// reason) and walks the samples in order; each input is read once and
// each output written once.
#include <cuda_runtime.h>

#include "silk_common.cuh"

using namespace otpu;

namespace {

template <int ORDER>
__global__ void lpc_kernel(const int32_t* __restrict__ pres, int B, int n,
                           const int32_t* __restrict__ A,
                           const int32_t* __restrict__ st_in,
                           int32_t* __restrict__ vs,
                           int32_t* __restrict__ st_out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int32_t ring[16];
  int32_t a[ORDER];
#pragma unroll
  for (int j = 0; j < 16; ++j) ring[j] = st_in[b * 16 + j];
#pragma unroll
  for (int j = 0; j < ORDER; ++j) a[j] = A[b * ORDER + j];
  const int32_t* x = pres + (size_t)b * n;
  int32_t* y = vs + (size_t)b * n;
  for (int t = 0; t < n; ++t) y[t] = lpc_step<ORDER>(ring, a, x[t]);
#pragma unroll
  for (int j = 0; j < 16; ++j) st_out[b * 16 + j] = ring[j];
}

}  // namespace

// pres, vs: (B, n); A: (B, order) Q12; st_in, st_out: (B, 16), most
// recent sample last. order is 10 or 16. Returns cudaGetLastError().
extern "C" int silk_lpc_synth(const int32_t* pres, int B, int n,
                              const int32_t* A, int order,
                              const int32_t* st_in, int32_t* vs,
                              int32_t* st_out, void* stream) {
  if (B <= 0 || n < 0) return (int)cudaErrorInvalidValue;
  const int threads = 32;
  const int blocks = (B + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  if (order == 16)
    lpc_kernel<16><<<blocks, threads, 0, s>>>(pres, B, n, A, st_in, vs,
                                              st_out);
  else if (order == 10)
    lpc_kernel<10><<<blocks, threads, 0, s>>>(pres, B, n, A, st_in, vs,
                                              st_out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
