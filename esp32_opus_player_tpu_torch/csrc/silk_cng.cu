// K9: comfort noise added to a concealed SILK frame.
//
// Replaces: esp32_opus_player_tpu/ops/silk/pallas_core.py::cng_add_pallas
// (kernel _cng_kernel). Reference: silk_CNG src/silk.cpp:1342, lossCnt
// branch: the CNG LPC synthesis ring over the comfort-noise excitation,
// scaled by the CNG gain and added to the frame with two saturations.
//
// Layout: the JAX row layout. xq and exc (B, >= frame) int32 with unit
// column stride and any row stride; A (B, ORDER) Q12; gain (B,); mask
// (B,) int32; state (B, 16), most recent sample last; out (B, frame).
//
// What bounds it: K5's recurrence (order x 7 + 8 int32 operations per
// sample) plus 11 for the scaling, the sum and the clips, far above its
// bytes; sequential in time and independent across streams, so one
// thread per stream with the ring and the coefficients in registers:
// latency-bound. A row with its mask off copies its frame and keeps its
// state without walking the ring.
#include <cuda_runtime.h>

#include "silk_common.cuh"

using namespace otpu;

namespace {

template <int ORDER>
__global__ void cng_kernel(const int32_t* __restrict__ xq,
                           long long xq_stride,
                           const int32_t* __restrict__ exc,
                           long long exc_stride,
                           const int32_t* __restrict__ A,
                           const int32_t* __restrict__ gain,
                           const int32_t* __restrict__ mask,
                           const int32_t* __restrict__ st_in,
                           int32_t* __restrict__ out,
                           int32_t* __restrict__ st_out, int B, int frame) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int32_t* x = xq + (size_t)b * xq_stride;
  int32_t* y = out + (size_t)b * frame;
  int32_t ring[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) ring[j] = st_in[b * 16 + j];
  if (mask[b] != 0) {
    const int32_t* e = exc + (size_t)b * exc_stride;
    const int32_t g = gain[b];
    int32_t a[ORDER];
#pragma unroll
    for (int j = 0; j < ORDER; ++j) a[j] = A[b * ORDER + j];
    for (int t = 0; t < frame; ++t) {
      const int32_t v = lpc_step<ORDER>(ring, a, e[t]);
      const int32_t noise = sat16(rshift_round(smulww(v, g), 8));
      y[t] = sat16(wadd(x[t], noise));
    }
  } else {
    for (int t = 0; t < frame; ++t) y[t] = x[t];
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) st_out[b * 16 + j] = ring[j];
}

}  // namespace

// xq, exc: B rows of >= frame int32, xq_stride and exc_stride apart; A:
// (B, order) Q12; gain, mask: (B,); st_in, st_out: (B, 16); out:
// (B, frame). order is 10 or 16. Returns cudaGetLastError().
extern "C" int silk_cng(const int32_t* xq, long long xq_stride,
                        const int32_t* exc, long long exc_stride,
                        const int32_t* A, const int32_t* gain,
                        const int32_t* mask, const int32_t* st_in,
                        int32_t* out, int32_t* st_out, int B, int frame,
                        int order, void* stream) {
  if (B <= 0 || frame <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 32;
  const int blocks = (B + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  if (order == 16)
    cng_kernel<16><<<blocks, threads, 0, s>>>(xq, xq_stride, exc, exc_stride,
                                              A, gain, mask, st_in, out,
                                              st_out, B, frame);
  else if (order == 10)
    cng_kernel<10><<<blocks, threads, 0, s>>>(xq, xq_stride, exc, exc_stride,
                                              A, gain, mask, st_in, out,
                                              st_out, B, frame);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
