// K6: the SILK 2x allpass HQ upsampler.
//
// Replaces: esp32_opus_player_tpu/ops/silk/pallas_core.py::up2_hq_pallas
// (kernel _up2_kernel). Reference: silk_resampler_private_up2_HQ
// src/silk.cpp:3513, coefficients silk_resampler_up2_hq_0/1.
//
// Layout: the JAX row layout. inp (B, n) int32 with unit column stride,
// rows in_stride apart (a column slice of a frame is fine); S (B, 6);
// out (B, 2n) with the even and odd outputs interleaved.
//
// What bounds it: its int32 operations (~65 per input sample) slightly
// more than its bytes, but six carried first-order allpass states make a
// recurrence sequential in time and independent across streams, so at
// the pool's widths it is latency-bound. One thread per stream holds the
// states in registers and walks any n (the TPU kernel unrolled blocks of
// 20 with a remainder); each input is read once and each output written
// once.
#include <cuda_runtime.h>

#include "silk_common.cuh"

using namespace otpu;

namespace {

__global__ void up2_kernel(const int32_t* __restrict__ inp, int B, int n,
                           long long in_stride,
                           const int32_t* __restrict__ s_in,
                           int32_t* __restrict__ out,
                           int32_t* __restrict__ s_out) {
  constexpr int32_t c00 = 1746, c01 = 14986, c02 = -26453;
  constexpr int32_t c10 = 6854, c11 = 25769, c12 = -9994;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int32_t S[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) S[j] = s_in[b * 6 + j];
  const int32_t* x = inp + (size_t)b * in_stride;
  int32_t* y = out + (size_t)b * 2 * n;
  for (int t = 0; t < n; ++t) {
    const int32_t in32 = wshl(x[t], 10);
    // even output: three allpass sections over S[0..2]
    int32_t Y = wsub(in32, S[0]);
    int32_t X = smulwb(Y, c00);
    int32_t out1 = wadd(S[0], X);
    S[0] = wadd(in32, X);
    Y = wsub(out1, S[1]);
    X = smulwb(Y, c01);
    int32_t out2 = wadd(S[1], X);
    S[1] = wadd(out1, X);
    Y = wsub(out2, S[2]);
    X = smlawb(Y, Y, c02);
    const int32_t oe = wadd(S[2], X);
    S[2] = wadd(out2, X);
    // odd output: S[3..5]
    Y = wsub(in32, S[3]);
    X = smulwb(Y, c10);
    out1 = wadd(S[3], X);
    S[3] = wadd(in32, X);
    Y = wsub(out1, S[4]);
    X = smulwb(Y, c11);
    out2 = wadd(S[4], X);
    S[4] = wadd(out1, X);
    Y = wsub(out2, S[5]);
    X = smlawb(Y, Y, c12);
    const int32_t oo = wadd(S[5], X);
    S[5] = wadd(out2, X);
    y[2 * t] = sat16(rshift_round(oe, 10));
    y[2 * t + 1] = sat16(rshift_round(oo, 10));
  }
#pragma unroll
  for (int j = 0; j < 6; ++j) s_out[b * 6 + j] = S[j];
}

}  // namespace

// inp: B rows of n int32, in_stride apart; s_in, s_out: (B, 6); out:
// (B, 2n). Returns cudaGetLastError().
extern "C" int silk_up2_hq(const int32_t* inp, int B, int n,
                           long long in_stride, const int32_t* s_in,
                           int32_t* out, int32_t* s_out, void* stream) {
  if (B <= 0 || n < 0) return (int)cudaErrorInvalidValue;
  const int threads = 32;
  up2_kernel<<<(B + threads - 1) / threads, threads, 0,
               (cudaStream_t)stream>>>(inp, B, n, in_stride, s_in, out,
                                       s_out);
  return (int)cudaGetLastError();
}
