// K8: the dense phase of silk_PLC_conceal for one lost frame.
//
// Replaces: esp32_opus_player_tpu/ops/silk/pallas_core.py::
// silk_plc_conceal_pallas (kernel _plc_conceal_kernel). Reference:
// silk_PLC_conceal src/silk.cpp:2973. The rewhitening FIR of the last
// lag0 + 2 history samples, the rand-excited 5-tap LTP recurrence at the
// per-subframe lags, the LPC synthesis and the output gain.
//
// Layout: the JAX row layout at the interface, each operand read where
// the caller has it (PlcRows: a pointer and a row stride each, unit
// element stride, any 4-byte alignment; the pool passes column slices of
// its staging rows and of its dense conceal inputs): outBuf (B, >= 20 fs),
// rand (B, >= frame), A (B, >= ORDER) Q12, Bq (B, >= nb, 5) Q14 (the 5
// taps packed), lag (B, >= nb), inv_gain_Q30 and prev_gain_Q10 (B,),
// sLPC (B, 16). xq (B, frame) and sLPC' (B, 16) are written contiguous.
// The call is this one launch; no global scratch.
//
// Tile and threads: a block of kThreads threads owns kStreams adjacent
// streams (kThreads, kStreams below: 128 blocks at B = 2048, two to an SM)
// and keeps, per stream, in dynamic shared memory: the LTP state over
// positions [20 fs - W, 20 fs + frame), W = 18 fs + 2 (the rand
// excitation is staged into its frame part: a sample reads its own rand,
// then writes its LTP output over it; the LPC then runs over the same
// words in place), the outBuf window the rewhitening reads, the incoming
// LPC state, the coefficients and the parameters: 3.8 KB per stream at
// 16 kHz, 61 KB per block. Rows are staged
// warp by warp, the lanes on neighbouring words (4-byte cp.async: fully
// used sectors whatever the slice's alignment), and xq goes back the same
// way. Row strides in shared memory are odd, so threads that walk
// different streams at one sample index fall on different banks. Only the
// LTP positions that are read before they are written are zeroed: those
// below 20 fs - (lag0 + 2). Registers: chip_smoke.py prints ptxas -v
// for every build; PERF.md gives the committed source's counts.
//
// Three phases:
// 1. The rewhitening FIR of the last lag0 + 2 history positions. It has
//    no feedback (position p reads only outBuf inputs p - 1 - j), so a
//    warp takes a stream and its lanes consecutive positions, the
//    coefficients in registers.
// 2. The LTP recurrence of the whole frame, by the same warp (so a
//    __syncwarp() joins the phases), the lanes on the samples of a chunk
//    of min(32, L - 2), L the subframe's lag clamped to [2 fs, 18 fs]
//    (the conceal prep's range; a row that is not concealed is staged
//    with lag 2 fs). Every tap of sample g lies at g - L + 2 or earlier,
//    so a chunk reads only values finished before it, which are the
//    values the reference's sample walk reads (the TPU kernel walks
//    chunks of 2 fs - 2 for the same reason, Mosaic having no per-lane
//    dynamic index). The chunk length follows each subframe's own lag.
//    The LTP does not depend on the LPC, so every subframe runs before
//    the LPC phase.
// 3. The LPC recurrence over the frame, the only true sample-by-sample
//    chain, one thread per stream, in transposed form as in K7
//    (silk_core.cu): P[j] is what the outputs so far add to the
//    prediction j samples on, built once from the incoming state (a
//    conceal has no gain adjustment of the LPC state); a new output
//    updates all P with ORDER products that do not depend on each other,
//    while the chain (P[0], the two clips, the saturating add) runs
//    beside them. Every sum is taken modulo 2^32 (uint32_t), so its order
//    is free and the bits are those of the reference's left-to-right sum;
//    products and shifts are the reference's own. The output gain is left
//    to all threads afterwards.
//
// What bounds it (NVIDIA H100 80GB HBM3, 700 W; PERF.md has the times
// and tools/kernel_variants.py the phases): phase 3, about two thirds of
// the call at WB and B = 2048, ~110 cycles a sample in the one walking
// warp of each block; neither one multiply a tap (IMAD.HI) nor a walk
// without the clips (redone where one would have clipped) made it
// faster. The function's int32 operations (per sample 5 LTP taps,
// ORDER LPC taps and the scaling: ~160 at order 16) over the whole card
// would take under a third of the call.
#include <cuda_runtime.h>

#include "silk_common.cuh"

using namespace otpu;

namespace {

constexpr int kThreads = 512;   // of a block
constexpr int kStreams = 16;    // that share a block and its tile

// words of shared memory per stream: the LTP state (with rand and then
// the LPC output in its frame part), the outBuf window, the incoming LPC
// state, A, Bq and the parameters (nb lags, inv_gain, prev_gain)
inline __host__ __device__ int plc_words(int fs, int nb) {
  const int frame = nb * 5 * fs, W = 18 * fs + 2;
  return ((W + frame) | 1) + ((W + 16) | 1) + 16 + 16 + 5 * nb + nb + 2;
}

// The per-stream operands, read where the caller has them: row b of each
// starts b * stride elements in; Bq's nb rows of 5 lie Bq_sub apart.
struct PlcRows {
  const int32_t* ob;            // >= 20 fs a row
  const int32_t* rnd;           // >= frame a row
  const int32_t* A;             // ORDER a row
  const int32_t* Bq;            // nb x 5 a row
  const int32_t* lag;           // nb a row
  const int32_t* inv;           // 1 a row
  const int32_t* pg;            // 1 a row
  const int32_t* st;            // 16 a row
  long long ob_stride, rnd_stride, A_stride, Bq_stride, Bq_sub, lag_stride,
      inv_stride, pg_stride, st_stride;
};

template <int ORDER>
__global__ void __launch_bounds__(kThreads)
plc_conceal_kernel(const PlcRows in, int32_t* __restrict__ xq,
                   int32_t* __restrict__ st_out, int B, int fs, int nb,
                   int S) {
  extern __shared__ int32_t sm[];
  const int subfr = 5 * fs;
  const int frame = nb * subfr;
  const int lm = 20 * fs;
  const int W = 18 * fs + 2;                 // max_lag + 2
  const int lo = lm - W;                     // sl[q]: LTP position lo + q
  const int wlo = lo - 16;                   // wk[q]: outBuf at wlo + q
  const int ls = (W + frame) | 1, ws = (W + 16) | 1;
  const int np = nb + 2;
  int32_t* sl = sm;                          // S x ls: LTP state
  int32_t* wk = sl + S * ls;                 // S x ws: outBuf window
  int32_t* s0 = wk + S * ws;                 // S x 16: incoming sLPC
  int32_t* ac = s0 + S * 16;                 // S x 16: A
  int32_t* bc = ac + S * 16;                 // S x nb x 5: Bq
  int32_t* pr = bc + S * nb * 5;             // S x np: lags, inv, prev
  const int tid = threadIdx.x, T = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = T >> 5;
  const int b0 = blockIdx.x * S;
  const int ns = min(S, B - b0);             // streams of this block
  auto lag_of = [&](int32_t v) { return min(max(v, 2 * fs), 18 * fs); };

  // stage the rows: the outBuf positions the FIR reads, rand into the
  // LTP state's frame part; zero the LTP positions read before written
  for (int s = warp; s < ns; s += nwarps) {
    const size_t b = b0 + s;
    const int first = lm - (lag_of(in.lag[b * in.lag_stride]) + 2);
    stage_row(wk + s * ws + (first - ORDER - wlo),
              in.ob + b * in.ob_stride + (first - ORDER), lm - first + ORDER,
              lane);
    stage_row(sl + s * ls + W, in.rnd + b * in.rnd_stride, frame, lane);
    for (int q = lane; q < first - lo; q += 32) sl[s * ls + q] = 0;
  }
  for (int i = tid; i < ns * 16; i += T) {
    const size_t b = b0 + (i >> 4);
    __pipeline_memcpy_async(s0 + i, in.st + b * in.st_stride + (i & 15), 4);
    if ((i & 15) < ORDER)
      __pipeline_memcpy_async(ac + i, in.A + b * in.A_stride + (i & 15), 4);
  }
  for (int i = tid; i < ns * nb * 5; i += T) {
    const int s = i / (nb * 5), r = i - s * nb * 5, k = r / 5;
    __pipeline_memcpy_async(
        bc + i,
        in.Bq + (size_t)(b0 + s) * in.Bq_stride + k * in.Bq_sub + (r - 5 * k),
        4);
  }
  for (int i = tid; i < ns * np; i += T) {
    const int s = i / np, r = i - s * np;
    const size_t b = b0 + s;
    const int32_t* src = r < nb ? in.lag + b * in.lag_stride + r
                         : r == nb ? in.inv + b * in.inv_stride
                                   : in.pg + b * in.pg_stride;
    __pipeline_memcpy_async(pr + i, src, 4);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // phases 1 and 2, a warp per stream
  for (int s = warp; s < ns; s += nwarps) {
    const int32_t* par = pr + s * np;
    int32_t* st = sl + s * ls;               // st[p - lo]: LTP position p
    const int32_t* w = wk + s * ws;          // w[p - wlo]: outBuf at p
    // phase 1: rewhitening of positions [first, lm), lanes on positions
    {
      int32_t a[ORDER];
#pragma unroll
      for (int t = 0; t < ORDER; ++t) a[t] = ac[s * 16 + t];
      const int32_t inv_gain = par[nb];
      const int first = lm - (lag_of(par[0]) + 2);
      for (int p = first + lane; p < lm; p += 32) {
        uint32_t acc = 0;
#pragma unroll
        for (int t = 0; t < ORDER; ++t)
          acc += (uint32_t)w[p - 1 - t - wlo] * (uint32_t)a[t];
        const int32_t out = (int32_t)((uint32_t)wshl(w[p - wlo], 12) - acc);
        st[p - lo] = smulwb(inv_gain, sat16(rshift_round(out, 12)));
      }
    }
    __syncwarp();
    // phase 2: the LTP recurrence, chunk by chunk; st[g - lo] holds the
    // sample's rand until its output replaces it
    for (int k = 0; k < nb; ++k) {
      const int L = lag_of(par[k]);
      int32_t bt[5];
#pragma unroll
      for (int t = 0; t < 5; ++t) bt[t] = bc[(s * nb + k) * 5 + t];
      int32_t* sg = st + (lm + k * subfr - lo);    // sg[i]: sample i
      const int ch = min(32, L - 2);
      for (int c0 = 0; c0 < subfr; c0 += ch) {
        const int i = c0 + lane;
        if (lane < ch && i < subfr) {
          int32_t pred = 2;
#pragma unroll
          for (int t = 0; t < 5; ++t)
            pred = smlawb(pred, sg[i - L + 2 - t], bt[t]);
          sg[i] = wshl(wadd(pred, sg[i]), 2);
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();

  // phase 3: the LPC recurrence over the frame, one thread per stream,
  // in transposed form, over the LTP output in place. P[j] is what the
  // outputs so far add to the prediction j samples on, the rounding
  // constant ORDER / 2 included; a new output updates every P with
  // products that do not depend on each other, beside the chain
  if (tid < ns) {
    int32_t a[ORDER];
#pragma unroll
    for (int j = 0; j < ORDER; ++j) a[j] = ac[tid * 16 + j];
    uint32_t P[ORDER];
#pragma unroll
    for (int j = 0; j < ORDER; ++j) P[j] = ORDER >> 1;
#pragma unroll
    for (int i = 0; i < ORDER; ++i) {
      // the state i + 1 samples back
      const int32_t u = s0[tid * 16 + 15 - i];
      const int32_t hi = u >> 16, lo16 = u & 0xFFFF;
#pragma unroll
      for (int j = 0; j + i < ORDER; ++j)
        P[j] += (uint32_t)smul_split(hi, lo16, a[j + i]);
    }
    int32_t* x = sl + tid * ls + W;
#pragma unroll 4
    for (int i = 0; i < frame; ++i) {
      const int32_t y = add_sat(x[i], lshift_sat32((int32_t)P[0], 4));
      const int32_t hi = y >> 16, lo16 = y & 0xFFFF;
#pragma unroll
      for (int j = 0; j < ORDER - 1; ++j)
        P[j] = P[j + 1] + (uint32_t)smul_split(hi, lo16, a[j]);
      P[ORDER - 1] = (uint32_t)(ORDER >> 1) +
                     (uint32_t)smul_split(hi, lo16, a[ORDER - 1]);
      x[i] = y;
    }
  }
  __syncthreads();

  // the output gain, and the last 16 LPC outputs as the new state
  for (int s = warp; s < ns; s += nwarps) {
    const int32_t prev_gain = pr[s * np + nb + 1];
    const int32_t* v = sl + s * ls + W;
    int32_t* xr = xq + (size_t)(b0 + s) * frame;
    for (int c = lane; c < frame; c += 32)
      xr[c] = sat16(rshift_round(smulww(v[c], prev_gain), 8));
  }
  for (int i = tid; i < ns * 16; i += T)
    st_out[(size_t)b0 * 16 + i] =
        sl[(i >> 4) * ls + W + frame - 16 + (i & 15)];
}

template <int ORDER>
int launch_plc(const PlcRows& in, int32_t* xq, int32_t* st_out, int B,
               int fs, int nb, cudaStream_t stream) {
  const int smem = kStreams * plc_words(fs, nb) * (int)sizeof(int32_t);
  static int smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        plc_conceal_kernel<ORDER>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_allowed = smem;
  }
  plc_conceal_kernel<ORDER>
      <<<(B + kStreams - 1) / kStreams, kThreads, smem, stream>>>(
          in, xq, st_out, B, fs, nb, kStreams);
  return (int)cudaGetLastError();
}

}  // namespace

// ptr: the operands outBuf, rand, A, Bq, lag, inv_gain, prev_gain, sLPC
// (8 device pointers), each B rows; stride: the row stride of each in
// elements; Bq_sub: the distance of Bq's subframe rows. Rows: outBuf
// >= 20 fs, rand >= frame, A order, Bq nb x 5, lag nb, the gains 1,
// sLPC 16, all int32 with unit element stride. xq: (B, nb * 5 fs) and
// st_out: (B, 16), contiguous. Order 16 needs fs >= 12 (the FIR reads
// order positions below 2 fs - 2). Returns the CUDA error of the launch.
extern "C" int silk_plc(const void* const* ptr, const long long* stride,
                        long long Bq_sub, int32_t* xq, int32_t* st_out,
                        int B, int fs, int nb, int order, void* stream) {
  if (B <= 0 || (fs != 8 && fs != 12 && fs != 16) || (nb != 2 && nb != 4) ||
      (order == 16 && fs == 8))
    return (int)cudaErrorInvalidValue;
  PlcRows in;
  in.ob = (const int32_t*)ptr[0];
  in.rnd = (const int32_t*)ptr[1];
  in.A = (const int32_t*)ptr[2];
  in.Bq = (const int32_t*)ptr[3];
  in.lag = (const int32_t*)ptr[4];
  in.inv = (const int32_t*)ptr[5];
  in.pg = (const int32_t*)ptr[6];
  in.st = (const int32_t*)ptr[7];
  in.ob_stride = stride[0];
  in.rnd_stride = stride[1];
  in.A_stride = stride[2];
  in.Bq_stride = stride[3];
  in.lag_stride = stride[4];
  in.inv_stride = stride[5];
  in.pg_stride = stride[6];
  in.st_stride = stride[7];
  in.Bq_sub = Bq_sub;
  cudaStream_t s = (cudaStream_t)stream;
  if (order == 16) return launch_plc<16>(in, xq, st_out, B, fs, nb, s);
  if (order == 10) return launch_plc<10>(in, xq, st_out, B, fs, nb, s);
  return (int)cudaErrorInvalidValue;
}
