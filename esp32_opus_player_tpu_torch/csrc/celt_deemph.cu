// K3: the CELT deemphasis IIR with Q12 rounding to int16 PCM.
//
// Replaces: esp32_opus_player_tpu/ops/celt/pallas_kernels.py::_deemph_kernel
// as launched by ops/celt/jax_synthesis_T.py::deemphasis_T. Reference:
// deemphasis src/celt.cpp:1988 (downsample: scratch-then-decimate,
// :2000-2013).
//
// Layout: syn (CC, N, B) int32 with streams contiguous (a strided view of
// decode_mem is fine: rows are B apart, channels cc_stride apart); mem
// (B, CC) int32; pcm (CC, N/d, B) int16.
//
// What bounds it: a first-order recurrence, sequential over the N samples
// and independent per (channel, stream) column. One thread per column
// walks the samples in order, reading each input once and writing each
// output once, coalesced across the streams of a warp. The PCM is written
// as int16 directly (the JAX path returned int32 and cast afterwards).
#include <cuda_runtime.h>

#include "celt_common.cuh"

using namespace otpu;

namespace {

constexpr int32_t kPreemph = 27853;

__global__ void deemph_kernel(const int32_t* __restrict__ syn,
                              long long cc_stride, int N, int B, int CC,
                              const int32_t* __restrict__ mem_in,
                              int32_t* __restrict__ mem_out,
                              int16_t* __restrict__ pcm, int d) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= CC * B) return;
  const int cc = t / B, b = t - cc * B;
  const int32_t* x = syn + cc * cc_stride + b;
  const int nd = N / d;
  int16_t* out = pcm + (size_t)cc * nd * B + b;
  int32_t m = mem_in[b * CC + cc];
  for (int n = 0, k = 0; n < N; ++n) {
    const int32_t tmp = wadd(x[(size_t)n * B], m);
    m = smul(tmp, kPreemph);
    if (n == k * d && k < nd) {
      out[(size_t)k * B] = (int16_t)clamp32(wadd(tmp, 2048) >> 12, -32768,
                                            32767);
      ++k;
    }
  }
  mem_out[b * CC + cc] = m;
}

}  // namespace

// syn: CC channel planes of N rows of B int32, planes cc_stride elements
// apart; mem_in, mem_out: (B, CC) int32 (may not alias); pcm: (CC, N/d, B)
// int16, keeping samples 0, d, 2d, ... Returns cudaGetLastError().
extern "C" int celt_deemph(const int32_t* syn, long long cc_stride, int N,
                           int B, int CC, const int32_t* mem_in,
                           int32_t* mem_out, int16_t* pcm, int d,
                           void* stream) {
  if (B <= 0 || CC <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 64;
  const int cols = CC * B;
  deemph_kernel<<<(cols + threads - 1) / threads, threads, 0,
                  (cudaStream_t)stream>>>(syn, cc_stride, N, B, CC, mem_in,
                                          mem_out, pcm, d);
  return (int)cudaGetLastError();
}

extern "C" const char* otpu_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
