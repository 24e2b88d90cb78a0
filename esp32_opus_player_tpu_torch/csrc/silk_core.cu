// K7: the whole SILK decode_core of one frame.
//
// Replaces: esp32_opus_player_tpu/ops/silk/pallas_core.py::silk_core_pallas
// (kernel _silk_core_kernel). Reference: silk_decode_core
// src/silk.cpp:1806. Per subframe k: the gain adjustment of the LPC
// state, the rewhitening FIR of the LTP history (or its rescale), the
// 5-tap LTP feedback recurrence at the stream's lag, the LPC synthesis
// recurrence and the gain scaling to int16-range xq.
//
// Layout: the JAX row layout at the interface. outBuf (B, >= 40 fs) and
// exc (B, >= frame) with unit column stride and any row stride; A
// (B, 2, ORDER), Bq (B, nb, 5), par (B, 7, nb) = [gains, inv_gain, lag,
// adj, voiced, rewhiten, match], sLPC (B, 16), xq (B, frame), all int32.
// The LTP state lives in a global scratch `sltp` (ltp_mem + frame, B),
// one column per stream, so a warp's accesses are coalesced and the
// working set (2.5 KiB per stream at 16 kHz, 5 MiB at B = 2048) stays in
// L2. The LPC ring, the coefficients and the taps of the LTP and of the
// rewhitening FIR (sliding windows, one load per sample) stay in
// registers.
//
// What bounds it: its int32 operations (at B = 2048, WB: ~147 M, ~9 us on
// an H100 80GB HBM3 at 700 W, by chip_smoke.py's count), far more than
// its ~8 MB of inputs and outputs. But the three recurrences are
// sequential in time and independent across streams, so one thread per
// stream: only B threads exist, and each waits on its own chain (0.27 ms
// there, chip_smoke.py): latency-bound.
//
// Against the TPU kernel: Mosaic has no per-lane dynamic index, so the
// TPU shifted rows in bit-decomposed steps (_shift_fwd) and walked the
// LTP in chunks of CH = 2 fs - 2 samples. Here a thread reads
// sltp[i - lag + 2 - t] directly, sample by sample. The two walks agree
// because every tap lies at least lag - 2 >= 2 fs - 2 = CH samples back
// (PE_MIN_LAG, also the dummy rows' lag): a chunk reads only samples
// finished before it. The chunk walk's writes past the subframe end are
// never read, so the sample walk does not make them. The rewhitening is
// computed only where it is used (rewhiten rows, the last lag + 2
// positions) and reads this frame's first two subframes of xq in place of
// outBuf from subframe 2 on, which is the JAX path's `work` update.
#include <cuda_runtime.h>

#include "silk_common.cuh"

using namespace otpu;

namespace {

template <int ORDER>
__global__ void silk_core_kernel(const int32_t* __restrict__ ob,
                                 long long ob_stride,
                                 const int32_t* __restrict__ exc,
                                 long long exc_stride,
                                 const int32_t* __restrict__ A,
                                 const int32_t* __restrict__ Bq,
                                 const int32_t* __restrict__ par,
                                 const int32_t* __restrict__ st_in,
                                 int32_t* xq, int32_t* __restrict__ st_out,
                                 int32_t* __restrict__ sltp, int B, int fs,
                                 int nb) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int subfr = 5 * fs;
  const int frame = nb * subfr;
  const int ltp_mem = 20 * fs;
  const int W = 18 * fs + 4;                 // max_lag + LTP_ORDER/2 + 2
  const int32_t* obr = ob + (size_t)b * ob_stride;
  const int32_t* er = exc + (size_t)b * exc_stride;
  int32_t* xr = xq + (size_t)b * frame;
  int32_t* s = sltp + b;                     // s[i * B]: LTP state
  const int32_t* P = par + (size_t)b * 7 * nb;
  // positions below ltp_mem are read (rescale, taps) before any write
  for (int i = 0; i < ltp_mem; ++i) s[(size_t)i * B] = 0;
  int32_t ring[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) ring[j] = st_in[b * 16 + j];

  for (int k = 0; k < nb; ++k) {
    int32_t a[ORDER];
#pragma unroll
    for (int j = 0; j < ORDER; ++j)
      a[j] = A[((size_t)b * 2 + (k >> 1)) * ORDER + j];
    int32_t bt[5];
#pragma unroll
    for (int t = 0; t < 5; ++t) bt[t] = Bq[((size_t)b * nb + k) * 5 + t];
    const int32_t gain_q10 = P[k] >> 6;
    const int32_t inv_gain = P[nb + k];
    const int32_t lag = P[2 * nb + k];
    const int32_t adj = P[3 * nb + k];
    const bool voiced = P[4 * nb + k] != 0;
    const bool rewhiten = P[5 * nb + k] != 0;
    const bool no_adj = P[6 * nb + k] != 0;

    if (!no_adj) {
#pragma unroll
      for (int j = 0; j < 16; ++j) ring[j] = smulww(adj, ring[j]);
    }

    // rewhitening / rescale of the last lag + 2 positions of the window
    const int win_end = ltp_mem + k * subfr;
    const int first = max(win_end - W, win_end - (lag + 2));
    if (rewhiten) {
      // work(q): outBuf, or this frame's xq for q in
      // [ltp_mem, ltp_mem + 2 subfr) from subframe 2 on
      auto work = [&](int q) -> int32_t {
        return (k >= 2 && q >= ltp_mem && q < ltp_mem + 2 * subfr)
                   ? xr[q - ltp_mem] : obr[q];
      };
      // the FIR's taps slide in registers: w[j] = work(p - 1 - j)
      int32_t w[ORDER];
#pragma unroll
      for (int j = 0; j < ORDER; ++j) w[j] = work(first - 1 - j);
      for (int p = first; p < win_end; ++p) {
        uint32_t acc = 0;
#pragma unroll
        for (int j = 0; j < ORDER; ++j)
          acc += (uint32_t)((int64_t)w[j] * a[j]);
        const int32_t cur = work(p);
        const int32_t out = (int32_t)((uint32_t)wshl(cur, 12) - acc);
        s[(size_t)p * B] = smulwb(inv_gain, sat16(rshift_round(out, 12)));
#pragma unroll
        for (int j = ORDER - 1; j > 0; --j) w[j] = w[j - 1];
        w[0] = cur;
      }
    } else if (voiced && !no_adj) {
      for (int p = first; p < win_end; ++p)
        s[(size_t)p * B] = smulww(adj, s[(size_t)p * B]);
    }

    // LTP recurrence, LPC recurrence and gain scaling, sample by sample.
    // The 5 taps slide in registers, tap[t] = s[g - lag + 2 - t]: one
    // load per sample, of a position at least 2 fs - 3 samples back
    // (final since long before).
    int32_t tap[5];
#pragma unroll
    for (int t = 0; t < 5; ++t) tap[t] = s[(size_t)(win_end - lag + 2 - t) * B];
    for (int i = 0; i < subfr; ++i) {
      const int g = win_end + i;
      int32_t pred = 2;
#pragma unroll
      for (int t = 0; t < 5; ++t) pred = smlawb(pred, tap[t], bt[t]);
      const int32_t e = er[k * subfr + i];
      const int32_t r = wadd(e, wshl(pred, 1));
      s[(size_t)g * B] = wshl(r, 1);
#pragma unroll
      for (int t = 4; t > 0; --t) tap[t] = tap[t - 1];
      tap[0] = s[(size_t)(g + 3 - lag) * B];
      const int32_t v = lpc_step<ORDER>(ring, a, voiced ? r : e);
      xr[k * subfr + i] = sat16(rshift_round(smulww(v, gain_q10), 8));
    }
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) st_out[b * 16 + j] = ring[j];
}

}  // namespace

// ob: B rows of >= 40 fs int32, ob_stride apart; exc: B rows of >= frame,
// exc_stride apart; A: (B, 2, order); Bq: (B, nb, 5); par: (B, 7, nb);
// st_in, st_out: (B, 16); xq: (B, nb * 5 fs); sltp: scratch of
// (20 fs + nb * 5 fs) * B int32. Lags must be >= 2 fs. Returns
// cudaGetLastError().
extern "C" int silk_core(const int32_t* ob, long long ob_stride,
                         const int32_t* exc, long long exc_stride,
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
    silk_core_kernel<16><<<blocks, threads, 0, s>>>(
        ob, ob_stride, exc, exc_stride, A, Bq, par, st_in, xq, st_out, sltp,
        B, fs, nb);
  else if (order == 10)
    silk_core_kernel<10><<<blocks, threads, 0, s>>>(
        ob, ob_stride, exc, exc_stride, A, Bq, par, st_in, xq, st_out, sltp,
        B, fs, nb);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
