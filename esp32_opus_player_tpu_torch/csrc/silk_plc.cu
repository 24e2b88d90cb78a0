// K8: the dense phase of silk_PLC_conceal for one lost frame.
//
// Replaces: esp32_opus_player_tpu/ops/silk/pallas_core.py::
// silk_plc_conceal_pallas (kernel _plc_conceal_kernel). Reference:
// silk_PLC_conceal src/silk.cpp:2973. The rewhitening FIR of the last
// lag0 + 2 history samples, the rand-excited 5-tap LTP recurrence at the
// per-subframe lags, the LPC synthesis ring and the output gain.
//
// Layout: the JAX row layout at the interface. outBuf (B, >= 20 fs) and
// rand (B, >= frame) with unit column stride and any row stride; A
// (B, ORDER) Q12; Bq (B, nb, 5) Q14; par (B, nb + 2) = [lag per subframe,
// inv_gain_Q30, prev_gain_Q10]; sLPC (B, 16); xq (B, frame), all int32.
// The LTP state lives in a global scratch `sltp` (20 fs + frame, B), one
// column per stream: a warp's accesses are coalesced and the working set
// stays in L2 (K7, silk_core.cu, keeps the same state in shared memory:
// the scheme to carry over here); the LPC ring, the
// coefficients and the sliding taps stay in registers.
//
// What bounds it: its int32 operations (per sample 5 LTP taps, ORDER LPC
// taps and the scaling: ~160 at order 16; per rewhitened position
// 3 ORDER + 12), far above its bytes. The recurrences are sequential in
// time and independent across streams, so one thread per stream:
// bound by the latency of its own chain through the scratch.
//
// Against the TPU kernel: Mosaic has no per-lane dynamic index, so the
// TPU shifted rows in bit-decomposed steps and walked the LTP in chunks of
// CH = 2 fs - 2 samples. A thread reads sltp[i - lag + 2 - t] directly,
// sample by sample; the walks agree because a conceal lag is at least
// 2 fs (the rounded plc_pitchL_Q8: a decoded pitch lag or 18 fs, drifting
// up), so a chunk reads only samples finished before it. Lags are clamped
// to [2 fs, 18 fs] so that every read stays inside the scratch; a row that
// is not concealed is staged with lag 2 fs. The LTP output of a sample
// feeds the LPC ring at once (the TPU kernel ran the ring as a second
// pass over the finished LTP frame; the values are the same).
#include <cuda_runtime.h>

#include "silk_common.cuh"

using namespace otpu;

namespace {

template <int ORDER>
__global__ void plc_conceal_kernel(const int32_t* __restrict__ ob,
                                   long long ob_stride,
                                   const int32_t* __restrict__ rnd,
                                   long long rnd_stride,
                                   const int32_t* __restrict__ A,
                                   const int32_t* __restrict__ Bq,
                                   const int32_t* __restrict__ par,
                                   const int32_t* __restrict__ st_in,
                                   int32_t* __restrict__ xq,
                                   int32_t* __restrict__ st_out,
                                   int32_t* __restrict__ sltp, int B, int fs,
                                   int nb) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int subfr = 5 * fs;
  const int frame = nb * subfr;
  const int lm = 20 * fs;
  const int W = 18 * fs + 2;                 // max_lag + 2
  const int32_t* obr = ob + (size_t)b * ob_stride;
  const int32_t* rr = rnd + (size_t)b * rnd_stride;
  int32_t* xr = xq + (size_t)b * frame;
  int32_t* s = sltp + b;                     // s[i * B]: LTP state
  const int32_t* P = par + (size_t)b * (nb + 2);
  const int32_t inv_gain = P[nb];
  const int32_t prev_gain = P[nb + 1];
  int32_t ring[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) ring[j] = st_in[b * 16 + j];
  int32_t a[ORDER];
#pragma unroll
  for (int j = 0; j < ORDER; ++j) a[j] = A[b * ORDER + j];

  // rewhitening of the last lag0 + 2 history samples; the window's older
  // positions are zero (no tap reaches below lm - W)
  const int lag0 = min(max(P[0], 2 * fs), 18 * fs);
  const int first = lm - (lag0 + 2);
  for (int p = lm - W; p < first; ++p) s[(size_t)p * B] = 0;
  {
    int32_t w[ORDER];                        // w[j] = outBuf[p - 1 - j]
#pragma unroll
    for (int j = 0; j < ORDER; ++j) w[j] = obr[first - 1 - j];
    for (int p = first; p < lm; ++p) {
      uint32_t acc = 0;
#pragma unroll
      for (int j = 0; j < ORDER; ++j)
        acc += (uint32_t)((int64_t)w[j] * a[j]);
      const int32_t cur = obr[p];
      const int32_t out = (int32_t)((uint32_t)wshl(cur, 12) - acc);
      s[(size_t)p * B] = smulwb(inv_gain, sat16(rshift_round(out, 12)));
#pragma unroll
      for (int j = ORDER - 1; j > 0; --j) w[j] = w[j - 1];
      w[0] = cur;
    }
  }

  // LTP recurrence, LPC ring and output gain, sample by sample. The 5
  // taps slide in registers, tap[t] = s[g - lag + 2 - t]: one load per
  // sample, of a position at least 2 fs - 3 samples back.
  for (int k = 0; k < nb; ++k) {
    int32_t bt[5];
#pragma unroll
    for (int t = 0; t < 5; ++t) bt[t] = Bq[((size_t)b * nb + k) * 5 + t];
    const int lag = min(max(P[k], 2 * fs), 18 * fs);
    const int g0 = lm + k * subfr;
    int32_t tap[5];
#pragma unroll
    for (int t = 0; t < 5; ++t) tap[t] = s[(size_t)(g0 - lag + 2 - t) * B];
    for (int i = 0; i < subfr; ++i) {
      const int g = g0 + i;
      int32_t pred = 2;
#pragma unroll
      for (int t = 0; t < 5; ++t) pred = smlawb(pred, tap[t], bt[t]);
      const int32_t v = wshl(wadd(pred, rr[k * subfr + i]), 2);
      s[(size_t)g * B] = v;
#pragma unroll
      for (int t = 4; t > 0; --t) tap[t] = tap[t - 1];
      tap[0] = s[(size_t)(g + 3 - lag) * B];
      const int32_t y = lpc_step<ORDER>(ring, a, v);
      xr[k * subfr + i] = sat16(rshift_round(smulww(y, prev_gain), 8));
    }
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) st_out[b * 16 + j] = ring[j];
}

}  // namespace

// ob: B rows of >= 20 fs int32, ob_stride apart; rnd: B rows of >= frame,
// rnd_stride apart; A: (B, order); Bq: (B, nb, 5); par: (B, nb + 2);
// st_in, st_out: (B, 16); xq: (B, nb * 5 fs); sltp: scratch of
// (20 fs + nb * 5 fs) * B int32. Returns cudaGetLastError().
extern "C" int silk_plc(const int32_t* ob, long long ob_stride,
                        const int32_t* rnd, long long rnd_stride,
                        const int32_t* A, const int32_t* Bq,
                        const int32_t* par, const int32_t* st_in,
                        int32_t* xq, int32_t* st_out, int32_t* sltp, int B,
                        int fs, int nb, int order, void* stream) {
  if (B <= 0 || (fs != 8 && fs != 12 && fs != 16) || (nb != 2 && nb != 4))
    return (int)cudaErrorInvalidValue;
  const int threads = 32;
  const int blocks = (B + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  if (order == 16)
    plc_conceal_kernel<16><<<blocks, threads, 0, s>>>(
        ob, ob_stride, rnd, rnd_stride, A, Bq, par, st_in, xq, st_out, sltp,
        B, fs, nb);
  else if (order == 10)
    plc_conceal_kernel<10><<<blocks, threads, 0, s>>>(
        ob, ob_stride, rnd, rnd_stride, A, Bq, par, st_in, xq, st_out, sltp,
        B, fs, nb);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
