// K7: the whole SILK decode_core of one frame.
//
// Replaces: esp32_opus_player_tpu/ops/silk/pallas_core.py::silk_core_pallas
// (kernel _silk_core_kernel). Reference: silk_decode_core
// src/silk.cpp:1806. Per subframe k: the gain adjustment of the LPC
// state, the rewhitening FIR of the LTP history (or its rescale), the
// 5-tap LTP feedback recurrence at the stream's lag, the LPC synthesis
// recurrence and the gain scaling to int16-range xq.
//
// Layout: the JAX row layout at the interface, each operand read where
// the caller has it (CoreRows: a pointer and a row stride each, unit
// element stride, any 4-byte alignment; the pool passes column slices of
// its staging rows, the flags as bools): outBuf (B, >= 40 fs), exc
// (B, >= frame), A (B, 2, ORDER), Bq (B, nb, 5), the seven parameters
// gains, inv_gain, lag, adj, voiced, rewhiten, match (B, nb) and sLPC
// (B, 16). xq (B, frame) and sLPC' (B, 16) are written contiguous. The
// call is this one launch.
//
// Tile and threads: a block of 512 threads owns S = 16 adjacent streams
// (kStreams, kThreads: the best of the shapes tried on an H100, PERF.md;
// 128 blocks at B = 2048) and keeps, per stream, in dynamic shared memory: the LTP state (20 fs +
// frame words, the first 20 fs zeroed), the outBuf window the rewhitening
// reads, the excitation (overwritten by the LPC's input), the LPC state
// followed by the LPC's output, the parameters and the coefficients:
// 8.1 KB per stream at 16 kHz, 129 KB at S = 16. No global scratch. Rows
// are staged warp by warp, the lanes on neighbouring words (4-byte
// cp.async: fully used sectors whatever the slice's alignment), and xq
// goes back the same way. Row strides in shared memory are odd, so threads
// that walk different streams at one sample index fall on different banks.
// Registers: 64 a thread at order 16, 40 at order 10 (ptxas -v, printed by
// chip_smoke.py); 512 threads allow 128.
//
// Per subframe, three phases with __syncthreads() between:
// 1. The rewhitening FIR (or the rescale) of the last min(18 fs + 4,
//    lag + 2) positions. It has no feedback (position p reads only inputs
//    p - 1 - j), so a warp takes a stream and its lanes consecutive
//    positions, the coefficients in registers. From subframe 2 on the
//    window holds this frame's first two subframes of xq in place of
//    outBuf, which is the JAX path's `work` update.
// 2. The LTP recurrence, a warp per stream, the lanes on the samples of a
//    chunk of min(32, lag - 2): every tap of sample g lies at g - lag + 2
//    or earlier, so a chunk reads only values finished before it, which
//    are the values the reference's sample walk reads. (The TPU kernel
//    walks chunks of 2 fs - 2 for the same reason, Mosaic having no
//    per-lane dynamic index; the two agree for every lag >= 2 fs. Lags are
//    clamped to [3, 18 fs], which keeps every index inside the tile; below
//    2 fs the plain version's fixed chunk differs from the reference walk
//    (the caller's error; an unvoiced row's LTP output is unused).)
// 3. The LPC recurrence, the only true sample-by-sample chain, one thread
//    per stream, in transposed form: P[j] is what the outputs so far add to
//    the prediction j samples on. A new output updates all P with ORDER
//    products that do not depend on each other, so they start back to back
//    while the chain (P[0], the two clips, the saturating add) runs beside
//    them. Every sum is taken modulo 2^32 (uint32_t), so its order is free
//    and the bits are those of the reference's left-to-right sum; products
//    and shifts are the reference's own. The gain scaling to xq is left to
//    all threads afterwards.
//
// What bounds it: its int32 operations (at B = 2048, WB: ~148 M, ~9 us on
// an H100 80GB HBM3 at 700 W, by chip_smoke.py's count) against ~8 MB of
// inputs and outputs. On that card chip_smoke.py times the call at
// 0.035 ms (one thread per stream through a global scratch took 0.270 ms;
// PERF.md). With a phase left out at a time, phase 3 is 0.021 ms of it:
// ~130 cycles a sample for a chain of ~12 dependent instructions, 320
// samples, one warp per block busy; the FIR 0.005, the LTP 0.002, the
// staging 0.001, and 0.007 remain with all of them left out (launch,
// parameter staging, output scaling; an empty graph replay: 0.0015-0.0044).
#include <cuda_runtime.h>

#include "silk_common.cuh"

using namespace otpu;

namespace {

constexpr int kThreads = 512;   // of a block
constexpr int kStreams = 16;    // that share a block and its tile

// words of shared memory per stream
inline __host__ __device__ int core_words(int fs, int nb) {
  const int frame = nb * 5 * fs;
  return 2 * ((20 * fs + frame) | 1) + (frame | 1) + ((16 + frame) | 1) +
         7 * nb + 2 * 16 + 5 * nb;
}

// The per-stream operands, read where the caller has them: row b of each
// starts b * stride elements in. The seven parameters (gains, inv_gain,
// lag, adj, voiced, rewhiten, match: nb values a row) are int32 or, for the
// flags, one-byte bools.
struct CoreRows {
  const int32_t* ob;            // >= 40 fs a row
  const int32_t* exc;           // >= frame a row
  const int32_t* A;             // 2 x ORDER a row, the halves A_half apart
  const int32_t* Bq;            // nb x 5 a row
  const int32_t* st;            // 16 a row
  const void* par[7];
  long long ob_stride, exc_stride, A_stride, A_half, Bq_stride, st_stride;
  long long par_stride[7];
  int par_bytes[7];             // 4 or 1
};

template <int ORDER>
__global__ void __launch_bounds__(kThreads)
silk_core_kernel(const CoreRows in, int32_t* __restrict__ xq,
                 int32_t* __restrict__ st_out, int B, int fs, int nb, int S) {
  // S (always kStreams) and the thread count are read at run time: folded
  // in as constants they change nvcc 12's schedule of the LPC loop (59
  // registers for 64) and the call takes 11 % longer on an H100 (PERF.md).
  extern __shared__ int32_t sm[];
  const int subfr = 5 * fs;
  const int frame = nb * subfr;
  const int ltp_mem = 20 * fs;
  const int W = 18 * fs + 4;                 // max_lag + LTP_ORDER/2 + 2
  const int ls = (ltp_mem + frame) | 1, es = frame | 1;
  const int vs = (16 + frame) | 1, np = 7 * nb;
  int32_t* sl = sm;                          // S x ls: LTP state
  int32_t* wk = sl + S * ls;                 // S x ls: outBuf window
  int32_t* ex = wk + S * ls;                 // S x es: exc, then LPC input
  int32_t* vh = ex + S * es;                 // S x vs: sLPC, then LPC output
  int32_t* pr = vh + S * vs;                 // S x np: parameters
  int32_t* ac = pr + S * np;                 // S x 2 x 16: LPC coefficients
  int32_t* bc = ac + S * 32;                 // S x nb x 5: LTP coefficients
  const int tid = threadIdx.x, T = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = T >> 5;
  const int b0 = blockIdx.x * S;
  const int ns = min(S, B - b0);             // streams of this block

  // stage the rows; zero the LTP positions that are read before written
  const int n_ob = ltp_mem + (nb - 1) * subfr;   // the FIR reads no further
  for (int s = warp; s < ns; s += nwarps) {
    const int32_t* obr = in.ob + (size_t)(b0 + s) * in.ob_stride;
    const int32_t* er = in.exc + (size_t)(b0 + s) * in.exc_stride;
    stage_row(wk + s * ls, obr, n_ob, lane);
    stage_row(ex + s * es, er, frame, lane);
    for (int c = lane; c < ltp_mem; c += 32) sl[s * ls + c] = 0;
  }
  for (int i = tid; i < ns * np; i += T) {
    const int s = i / np, r = (i - s * np) / nb;
    const size_t at = (size_t)(b0 + s) * in.par_stride[r] + (i - s * np - r * nb);
    pr[i] = in.par_bytes[r] == 1 ? ((const uint8_t*)in.par[r])[at]
                                 : ((const int32_t*)in.par[r])[at];
  }
  for (int i = tid; i < ns * nb * 5; i += T) {
    const int s = i / (nb * 5);
    __pipeline_memcpy_async(
        bc + i, in.Bq + (size_t)(b0 + s) * in.Bq_stride + (i - s * nb * 5),
        4);
  }
  for (int i = tid; i < ns * 2 * ORDER; i += T) {
    const int s = i / (2 * ORDER), h = (i / ORDER) & 1, j = i % ORDER;
    __pipeline_memcpy_async(
        ac + s * 32 + h * 16 + j,
        in.A + (size_t)(b0 + s) * in.A_stride + h * in.A_half + j, 4);
  }
  for (int i = tid; i < ns * 16; i += T)
    __pipeline_memcpy_async(
        vh + (i >> 4) * vs + (i & 15),
        in.st + (size_t)(b0 + (i >> 4)) * in.st_stride + (i & 15), 4);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // xq of sample c of stream s from the LPC output
  auto scaled = [&](int s, int c) -> int32_t {
    const int32_t gain_q10 = pr[s * np + c / subfr] >> 6;
    return sat16(rshift_round(smulww(vh[s * vs + 16 + c], gain_q10), 8));
  };

  for (int k = 0; k < nb; ++k) {
    const int win_end = ltp_mem + k * subfr;
    if (k == 2) {
      // the window gains this frame's first two subframes
      for (int s = warp; s < ns; s += nwarps)
        for (int c = lane; c < 2 * subfr; c += 32)
          wk[s * ls + ltp_mem + c] = scaled(s, c);
      __syncthreads();
    }

    // phase 1: rewhitening / rescale of the last lag + 2 positions, a
    // warp per stream, the lanes on consecutive positions
    for (int s = warp; s < ns; s += nwarps) {
      const int32_t* P = pr + s * np;
      const bool rewhiten = P[5 * nb + k] != 0;
      if (!rewhiten && (P[4 * nb + k] == 0 || P[6 * nb + k] != 0)) continue;
      const int lag = min(max(P[2 * nb + k], 3), 18 * fs);
      const int n_pos = min(W, lag + 2);
      int32_t* st = sl + s * ls + win_end - n_pos;
      if (rewhiten) {
        int32_t a[ORDER];
#pragma unroll
        for (int t = 0; t < ORDER; ++t) a[t] = ac[s * 32 + (k >> 1) * 16 + t];
        const int32_t inv_gain = P[nb + k];
        const int32_t* w = wk + s * ls + win_end - n_pos;
        for (int j = lane; j < n_pos; j += 32) {
          uint32_t acc = 0;
#pragma unroll
          for (int t = 0; t < ORDER; ++t)
            acc += (uint32_t)w[j - 1 - t] * (uint32_t)a[t];
          const int32_t out = (int32_t)((uint32_t)wshl(w[j], 12) - acc);
          st[j] = smulwb(inv_gain, sat16(rshift_round(out, 12)));
        }
      } else {
        const int32_t adj = P[3 * nb + k];
        for (int j = lane; j < n_pos; j += 32) st[j] = smulww(adj, st[j]);
      }
    }
    __syncthreads();

    // phase 2: the LTP recurrence, a warp per stream, the lanes on the
    // samples of a chunk; it leaves the LPC's input where exc was
    for (int s = warp; s < ns; s += nwarps) {
      const int32_t* P = pr + s * np;
      const int lag = min(max(P[2 * nb + k], 3), 18 * fs);
      const bool voiced = P[4 * nb + k] != 0;
      int32_t bt[5];
#pragma unroll
      for (int t = 0; t < 5; ++t) bt[t] = bc[(s * nb + k) * 5 + t];
      int32_t* st = sl + s * ls + win_end;
      int32_t* e = ex + s * es + k * subfr;
      const int ch = min(32, lag - 2);
      for (int c0 = 0; c0 < subfr; c0 += ch) {
        const int i = c0 + lane;
        if (lane < ch && i < subfr) {
          int32_t pred = 2;
#pragma unroll
          for (int t = 0; t < 5; ++t)
            pred = smlawb(pred, st[i - lag + 2 - t], bt[t]);
          const int32_t r = wadd(e[i], wshl(pred, 1));
          st[i] = wshl(r, 1);
          if (voiced) e[i] = r;
        }
        __syncwarp();
      }
    }
    __syncthreads();

    // phase 3: the LPC recurrence, one thread per stream, in transposed
    // form: P[j] is what the outputs so far add to the prediction j
    // samples on, so a sample's chain is its newest tap and the clips,
    // and the other taps' products fill the slots beside it
    if (tid < ns) {
      const int32_t* Pk = pr + tid * np;
      int32_t* v_out = vh + tid * vs + 16 + k * subfr;
      int32_t a[ORDER];
#pragma unroll
      for (int j = 0; j < ORDER; ++j)
        a[j] = ac[tid * 32 + (k >> 1) * 16 + j];
      const bool no_adj = Pk[6 * nb + k] != 0;
      const int32_t adj = Pk[3 * nb + k];
      uint32_t P[ORDER];
#pragma unroll
      for (int j = 0; j < ORDER; ++j) P[j] = 0;
#pragma unroll
      for (int i = 0; i < ORDER; ++i) {
        // the state i + 1 samples back, after the gain adjustment
        int32_t u = v_out[-1 - i];
        if (!no_adj) u = smulww(adj, u);
        const int32_t hi = u >> 16, lo = u & 0xFFFF;
#pragma unroll
        for (int j = 0; j + i < ORDER; ++j)
          P[j] += (uint32_t)smul_split(hi, lo, a[j + i]);
      }
      const int32_t* x = ex + tid * es + k * subfr;
#pragma unroll 4
      for (int i = 0; i < subfr; ++i) {
        const int32_t pred = (int32_t)((uint32_t)(ORDER >> 1) + P[0]);
        const int32_t v = add_sat(x[i], lshift_sat32(pred, 4));
        const int32_t hi = v >> 16, lo = v & 0xFFFF;
#pragma unroll
        for (int j = 0; j < ORDER - 1; ++j)
          P[j] = P[j + 1] + (uint32_t)smul_split(hi, lo, a[j]);
        P[ORDER - 1] = (uint32_t)smul_split(hi, lo, a[ORDER - 1]);
        v_out[i] = v;
      }
    }
    __syncthreads();
  }

  for (int s = warp; s < ns; s += nwarps)
    for (int c = lane; c < frame; c += 32)
      xq[(size_t)(b0 + s) * frame + c] = scaled(s, c);
  for (int i = tid; i < ns * 16; i += T)
    st_out[(size_t)b0 * 16 + i] = vh[(i >> 4) * vs + frame + (i & 15)];
}

template <int ORDER>
int launch_core(const CoreRows& in, int32_t* xq, int32_t* st_out, int B,
                int fs, int nb, cudaStream_t stream) {
  const int smem = kStreams * core_words(fs, nb) * (int)sizeof(int32_t);
  static int smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        silk_core_kernel<ORDER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    smem_allowed = smem;
  }
  silk_core_kernel<ORDER>
      <<<(B + kStreams - 1) / kStreams, kThreads, smem, stream>>>(
          in, xq, st_out, B, fs, nb, kStreams);
  return (int)cudaGetLastError();
}

}  // namespace

// ptr: the operands ob, exc, A, Bq, sLPC and the seven parameters gains,
// inv_gain, lag, adj, voiced, rewhiten, match (12 device pointers), each
// B rows; stride: the row stride of each in elements; A_half: the distance
// of A's two coefficient sets; par_bytes: the element size of each
// parameter (4: int32, 1: bool). Rows: ob >= 40 fs, exc >= frame, A 2 x
// order, Bq nb x 5, sLPC 16, a parameter nb, all with unit element stride.
// xq: (B, nb * 5 fs) and st_out: (B, 16), contiguous. Lags must be
// >= 2 fs. Returns the CUDA error of the launch.
extern "C" int silk_core(const void* const* ptr, const long long* stride,
                         long long A_half, const int* par_bytes, int32_t* xq,
                         int32_t* st_out, int B, int fs, int nb, int order,
                         void* stream) {
  if (B <= 0 || (fs != 8 && fs != 12 && fs != 16) || (nb != 2 && nb != 4))
    return (int)cudaErrorInvalidValue;
  CoreRows in;
  in.ob = (const int32_t*)ptr[0];
  in.exc = (const int32_t*)ptr[1];
  in.A = (const int32_t*)ptr[2];
  in.Bq = (const int32_t*)ptr[3];
  in.st = (const int32_t*)ptr[4];
  in.ob_stride = stride[0];
  in.exc_stride = stride[1];
  in.A_stride = stride[2];
  in.Bq_stride = stride[3];
  in.st_stride = stride[4];
  in.A_half = A_half;
  for (int r = 0; r < 7; ++r) {
    if (par_bytes[r] != 1 && par_bytes[r] != 4)
      return (int)cudaErrorInvalidValue;
    in.par[r] = ptr[5 + r];
    in.par_stride[r] = stride[5 + r];
    in.par_bytes[r] = par_bytes[r];
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (order == 16)
    return launch_core<16>(in, xq, st_out, B, fs, nb, s);
  if (order == 10)
    return launch_core<10>(in, xq, st_out, B, fs, nb, s);
  return (int)cudaErrorInvalidValue;
}
