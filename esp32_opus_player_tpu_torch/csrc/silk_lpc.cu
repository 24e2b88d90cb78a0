// K5: the SILK order-10/16 LPC synthesis recurrence.
//
// Replaces: esp32_opus_player_tpu/ops/silk/pallas_core.py::lpc_synth_pallas
// (kernel _lpc_kernel). Reference: silk_decode_core src/silk.cpp:1930-1950.
//
// Layout: the JAX row layout, pres and vs (B, n), A (B, order), state
// (B, 16), all int32 and contiguous. The call is this one launch.
//
// Tile and threads: a block of kThreads threads owns kStreams adjacent
// streams (128 blocks at B = 2048, one at the pools' 16-row buckets). The
// block stages its (kStreams, kChunk) tile of pres into shared memory
// (4-byte cp.async, a warp per row, the lanes on neighbouring words, every
// load in flight before the one wait), lane s of warp 0 walks stream s
// over the tile in place, and then every warp writes the tile back, a row
// at a time, the lanes on neighbouring words; a longer row takes its
// chunks in turn. Rows are odd words apart, so the walkers' shared loads
// and stores fall on distinct banks. The new state, the last 16 outputs
// (behind the older state for n under 16), is written once at the end.
//
// The walk: the LPC recurrence in transposed form, as K8's and K9's: P[j]
// is what the outputs so far add to the prediction j samples on, built
// once from the incoming state; a new output y updates every P with ORDER
// products that do not depend on each other, so one sample's dependent
// chain is the newest tap alone: smulwb(y, A[0]) -> the sum with P[1] ->
// lshift_sat32's clip and shift -> the saturating add of the next input.
// Every sum is taken modulo 2^32 (uint32_t), so its order is free and the
// bits are those of the reference's left-to-right sum; each product is the
// reference's smulwb (the hi/lo split of y, taken once per output); the
// saturating add is the exact sum clamped (add.sat.s32). The walker holds
// the input a group of 4 samples ahead in registers, so no shared load
// waits on the chain.
//
// What bounds it: the floor is the chain, n samples of ~6 dependent
// integer instructions each (chip_smoke.py's LPC_CHAIN_CYCLES, 24 cycles
// a sample at the SM clock); its bytes and operations are far below it.
// What holds it (tools/kernel_variants.py k5; PERF.md has the times):
// the walking warp's issue, ~75 instructions a sample at order 16 (the
// ORDER products, ~4 instructions each, for every lane of the warp at
// once), ~3x the chain; at the pools' 16-row shapes, the call's fixed
// part (launch, the staging's and the write-back's memory latency), as
// large as the walk. A high-word product (__mulhi of a << 16, or the
// 64-bit product) measured slower than the split.
#include <cuda_runtime.h>

#include "silk_common.cuh"

using namespace otpu;

namespace {

constexpr int kThreads = 128;   // of a block
constexpr int kStreams = 16;    // that share a block and its tile (<= 32)
constexpr int kChunk = 320;     // samples of a row staged at a time

__device__ __forceinline__ int32_t sat_add(int32_t a, int32_t b) {
  int32_t s;
  asm("add.sat.s32 %0, %1, %2;" : "=r"(s) : "r"(a), "r"(b));
  return s;
}

// The walk of one stream over len inputs at x, outputs in place; P
// carries from chunk to chunk.
template <int ORDER>
__device__ __forceinline__ void walk(uint32_t (&P)[ORDER],
                                     const int32_t (&a)[ORDER], int32_t* x,
                                     int len) {
  auto step = [&](int32_t in) {
    const int32_t y = sat_add(
        in, wshl(clamp32((int32_t)P[0], kInt32Min >> 4, kInt32Max >> 4), 4));
    const int32_t hi = y >> 16, lo16 = y & 0xFFFF;
#pragma unroll
    for (int j = 0; j < ORDER - 1; ++j)
      P[j] = P[j + 1] + (uint32_t)smul_split(hi, lo16, a[j]);
    P[ORDER - 1] =
        (uint32_t)(ORDER >> 1) + (uint32_t)smul_split(hi, lo16, a[ORDER - 1]);
    return y;
  };
  // the input a group of 4 samples ahead, in registers: a load issued
  // after the previous outputs' stores to the same array would wait for
  // them, its latency on the chain
  int32_t xn[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) xn[j] = x[min(j, len - 1)];
  int i = 0;
  for (; i + 4 <= len; i += 4) {
    int32_t xc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      xc[j] = xn[j];
      xn[j] = x[min(i + 4 + j, len - 1)];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) x[i + j] = step(xc[j]);
  }
  for (; i < len; ++i) x[i] = step(x[i]);
}

template <int ORDER>
__global__ void __launch_bounds__(kThreads)
lpc_kernel(const int32_t* __restrict__ pres, int B, int n,
           const int32_t* __restrict__ A, const int32_t* __restrict__ st_in,
           int32_t* __restrict__ vs, int32_t* __restrict__ st_out) {
  __shared__ int32_t tile[kStreams * (kChunk | 1)];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int nwarps = kThreads / 32;
  const int b0 = blockIdx.x * kStreams;
  const int ns = min(kStreams, B - b0);      // streams of this block
  const bool walker = tid < ns;

  // the walker's coefficients and P, built from the incoming state (its
  // loads in flight together, ahead of the first stage's wait)
  int32_t a[ORDER];
  uint32_t P[ORDER];
  if (walker) {
    const int32_t* s = st_in + (size_t)(b0 + tid) * 16;
    int32_t u[ORDER];
#pragma unroll
    for (int j = 0; j < ORDER; ++j) {
      a[j] = A[(size_t)(b0 + tid) * ORDER + j];
      u[j] = s[15 - j];                      // j + 1 samples back
    }
#pragma unroll
    for (int j = 0; j < ORDER; ++j) P[j] = ORDER >> 1;
#pragma unroll
    for (int i = 0; i < ORDER; ++i)
#pragma unroll
      for (int j = 0; j + i < ORDER; ++j)
        P[j] += (uint32_t)smulwb(u[i], a[j + i]);
  }

  for (int c0 = 0; c0 < n; c0 += kChunk) {
    const int len = min(kChunk, n - c0);
    const int w = len | 1;                   // odd: walkers on 16 banks
    if (c0 > 0) __syncthreads();             // the last chunk written back
    for (int s = warp; s < ns; s += nwarps)
      stage_row(tile + s * w, pres + (size_t)(b0 + s) * n + c0, len, lane);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    if (walker) walk<ORDER>(P, a, tile + tid * w, len);
    __syncthreads();
    for (int s = warp; s < ns; s += nwarps) {
      const size_t b = b0 + s;
      int32_t* y = vs + b * n + c0;
      for (int k = lane; k < len; k += 32) y[k] = tile[s * w + k];
      // with the last chunk, the new state: the last 16 outputs (from
      // the tile, or from vs for an earlier chunk's), behind the older
      // state for n under 16
      if (c0 + len == n && lane < 16) {
        const int t = n - 16 + lane;
        st_out[b * 16 + lane] = t >= c0  ? tile[s * w + t - c0]
                                : t >= 0 ? vs[b * n + t]
                                         : st_in[b * 16 + lane + n];
      }
    }
  }
  if (n == 0)
    for (int s = warp; s < ns; s += nwarps)
      if (lane < 16)
        st_out[(size_t)(b0 + s) * 16 + lane] =
            st_in[(size_t)(b0 + s) * 16 + lane];
}

}  // namespace

// pres, vs: (B, n); A: (B, order) Q12; st_in, st_out: (B, 16), most
// recent sample last. order is 10 or 16. Returns cudaGetLastError().
extern "C" int silk_lpc_synth(const int32_t* pres, int B, int n,
                              const int32_t* A, int order,
                              const int32_t* st_in, int32_t* vs,
                              int32_t* st_out, void* stream) {
  if (B <= 0 || n < 0) return (int)cudaErrorInvalidValue;
  const int blocks = (B + kStreams - 1) / kStreams;
  cudaStream_t s = (cudaStream_t)stream;
  if (order == 16)
    lpc_kernel<16><<<blocks, kThreads, 0, s>>>(pres, B, n, A, st_in, vs,
                                               st_out);
  else if (order == 10)
    lpc_kernel<10><<<blocks, kThreads, 0, s>>>(pres, B, n, A, st_in, vs,
                                               st_out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
