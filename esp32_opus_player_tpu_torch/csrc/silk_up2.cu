// K6: the SILK 2x allpass HQ upsampler, and with it, as its epilogue,
// the whole IIR-FIR resampler call it sits in.
//
// Replaces: esp32_opus_player_tpu/ops/silk/pallas_core.py::up2_hq_pallas
// (kernel _up2_kernel). Reference: silk_resampler_private_up2_HQ
// src/silk.cpp:3513, coefficients silk_resampler_up2_hq_0/1; the fused
// entry also does silk_resampler_private_IIR_FIR (:3481) with
// silk_resampler_private_IIR_FIR_INTERPOL (:3451), which the JAX package
// runs in XLA around the Pallas kernel (jax_core.resample_batch, kind
// iir_fir).
//
// Two entries, one kernel (the FIR epilogue is a template flag):
// - silk_up2_hq: inp (B, n) -> out (B, 2n), even and odd outputs
//   interleaved, and the six allpass states; the TPU kernel's exact
//   counterpart.
// - silk_up2_fir: one iir_fir call over a block of n samples in
//   batchSize chunks: per chunk the up2 allpass, buf = [sFIR[:8], up],
//   the 8-tap 12-phase FIR at the output indices 0, inv, 2 inv, ... below
//   n_in << 17, and sFIR' = buf[2 n_in : 2 n_in + 8]. The allpass carries
//   its state from chunk to chunk, so the up-sampled block is one walk;
//   and chunk c's buf is the words [2 off_c, 2 off_c + 2 n_c + 8) of
//   U = [sFIR[:8], up of the whole block], since each chunk's carried 8
//   samples are the last 8 of the one before. Only the output indices
//   restart per chunk (the rounded-up inv makes their phases, and in
//   general their count, depend on the chunking).
//
// Layout: the JAX row layout at the interface, each operand read where
// the caller has it (Up2Rows: a pointer and a row stride each, unit
// element stride, any 4-byte alignment): the block (B, n), sIIR (B, 6),
// sFIR (B, >= 8). Outputs contiguous.
//
// Tile and threads: a block of kThreads threads owns kStreams adjacent
// streams (128 blocks at B = 2048) and keeps per stream in dynamic shared
// memory its input row and U (~12 n bytes; 61 KB a block at the longest
// block the resampler gives it, 19 fs = 304 samples at WB), plus the FIR
// table. Rows are staged warp by warp with 4-byte cp.async, the lanes on
// neighbouring words.
//
// Two phases:
// 1. The allpass walk: two threads per stream, one for the even chain
//    (S[0..2]) and one for the odd chain (S[3..5]), which do not depend
//    on each other; four warps walk, each one chain of half the streams,
//    one warp on each of the SM's schedulers. A chain's loop-carried step
//    is one section's sum, product and sum; its three sections pipeline.
//    smulwb(y, c) is taken as __mulhi(y, c << 16), one instruction,
//    equal for every int32 y because each |c| < 2^15
//    (tests/test_torch_kernel_schedules.py). The walker holds its input
//    a group of 4 samples ahead in registers. Row strides are 2 mod 32
//    (U) and odd (input), so a warp's walkers fall on distinct banks.
// 2. The bare entry writes U's up-sampled part out a warp per row, the
//    lanes on neighbouring words. The fused entry runs the FIR: a warp
//    per stream, its lanes on consecutive output positions (no
//    recurrence: 8 taps of U with the phase's coefficients from a table
//    in shared memory, coef_row), the sum taken modulo 2^32 (the
//    reference's int64 sum reduced to int32 has the same bits), stored a
//    sector at a time.
//
// What bounds it (NVIDIA H100 80GB HBM3, 700 W; PERF.md has the times and
// tools/kernel_variants.py the phases): the walk, ~43 cycles a sample,
// set by its chain (a warp issues in order, so a group's last section
// holds back the next group's first); then the FIR, bound by its shared
// loads (64 bytes an output). Its bytes (each input word read once, each
// output written once) take under a tenth of the call.
#include <cuda_runtime.h>

#include "silk_common.cuh"

using namespace otpu;

namespace {

constexpr int kThreads = 512;   // of a block
constexpr int kStreams = 16;    // that share a block and its tile
static_assert(kThreads >= 128 && kStreams % 2 == 0 && kStreams <= 64,
              "four walking warps, each on half the streams");

// silk_resampler_frac_FIR_12 (src/silk.cpp), 12 phases x 4 taps
__constant__ int16_t kFracFir12[12][4] = {
    {189, -600, 617, 30567},   {117, -159, -1070, 29704},
    {52, 221, -2392, 28276},   {-4, 529, -3350, 26341},
    {-48, 758, -3956, 23973},  {-80, 905, -4235, 21254},
    {-99, 972, -4222, 18278},  {-107, 967, -3957, 15143},
    {-103, 896, -3487, 11950}, {-91, 773, -2865, 8798},
    {-71, 611, -2143, 5784},   {-46, 425, -1375, 2996}};

// A phase's 8 taps lie at word coef_row(t) of the table in shared
// memory, 16-byte aligned (two 16-byte loads) and spread so that the
// phases one output ratio uses together (0, 4 and 8 into 48 kHz from 8
// and 16 kHz, 0 and 6 from 12 kHz) fall on different banks.
__host__ __device__ constexpr int coef_row(int t) { return 8 * (t + (t >> 2)); }
constexpr int kCoefWords = 112;

struct Up2Rows {
  const int32_t* x;             // n a row
  const int32_t* s;             // 6 a row
  const int32_t* f;             // >= 8 a row (fused entry only)
  long long x_stride, s_stride, f_stride;
};

// A fused call's chunking: m_full outputs per full chunk of `batch`
// input samples, n_out in all.
struct FirPlan {
  int batch, inv, m_full, n_out, f_width;
};

// row strides in shared memory, in words: the input odd, U 2 mod 32
inline __host__ __device__ int x_words(int n) { return n | 1; }
inline __host__ __device__ int u_words(int n) {
  return 2 * n + 8 + ((34 - (2 * n + 8) % 32) % 32);
}

template <bool kFir>
__global__ void __launch_bounds__(kThreads)
up2_kernel(const Up2Rows in, int32_t* __restrict__ out,
           int32_t* __restrict__ s_out, int32_t* __restrict__ f_out, int B,
           int n, const FirPlan plan, int S) {
  extern __shared__ int32_t sm[];
  const int xs = x_words(n), us = u_words(n);
  int32_t* coef = sm;                        // 12 rows of 8, coef_row()
  int32_t* xsh = coef + kCoefWords;          // S x xs: the input rows
  int32_t* ush = xsh + S * xs;               // S x us: U
  int32_t* sst = ush + S * us;               // S x 6: sIIR
  const int tid = threadIdx.x, T = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = T >> 5;
  const int b0 = blockIdx.x * S;
  const int ns = min(S, B - b0);             // streams of this block

  for (int s = warp; s < ns; s += nwarps) {
    const size_t b = b0 + s;
    stage_row(xsh + s * xs, in.x + b * in.x_stride, n, lane);
    if (lane < 6)
      __pipeline_memcpy_async(sst + s * 6 + lane,
                              in.s + b * in.s_stride + lane, 4);
    if (kFir && lane < 8)
      __pipeline_memcpy_async(ush + s * us + lane,
                              in.f + b * in.f_stride + lane, 4);
  }
  if (kFir)
    for (int i = tid; i < 96; i += T) {
      const int t = i >> 3, q = i & 7;
      coef[coef_row(t) + q] =
          q < 4 ? kFracFir12[t][q] : kFracFir12[11 - t][7 - q];
    }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // phase 1: the allpass walk. Warp w < 4 walks chain p = w & 1 of the
  // streams (w >> 1) S/2 + lane, lane < S/2: the four walking warps fall
  // on the SM's four schedulers, so each issues a quarter of the walk
  const int p = warp & 1, s = (warp >> 1) * (S >> 1) + lane;
  if (warp < 4 && lane < (S >> 1) && s < ns) {
    // silk_resampler_up2_hq_0/1 as high-word multipliers c << 16
    const int32_t h0 = wshl(p ? 6854 : 1746, 16);
    const int32_t h1 = wshl(p ? 25769 : 14986, 16);
    const int32_t h2 = wshl(p ? -9994 : -26453, 16);
    int32_t S0 = sst[s * 6 + 3 * p], S1 = sst[s * 6 + 3 * p + 1],
            S2 = sst[s * 6 + 3 * p + 2];
    auto step = [&](int32_t x) {
      const int32_t in32 = wshl(x, 10);
      int32_t X = __mulhi(wsub(in32, S0), h0);
      const int32_t out1 = wadd(S0, X);
      S0 = wadd(in32, X);
      X = __mulhi(wsub(out1, S1), h1);
      const int32_t out2 = wadd(S1, X);
      S1 = wadd(out1, X);
      const int32_t Y = wsub(out2, S2);
      X = wadd(Y, __mulhi(Y, h2));
      const int32_t o = wadd(S2, X);
      S2 = wadd(out2, X);
      return sat16(rshift_round(o, 10));
    };
    const int32_t* xr = xsh + s * xs;
    int32_t* ur = ush + s * us + 8 + p;
    // the input a group of 4 samples ahead, in registers: the outputs'
    // stores lie in the same shared array, so a load issued after them
    // would wait for them and put its latency on the chain
    int32_t xn[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) xn[j] = xr[max(min(j, n - 1), 0)];
    int t = 0;
    for (; t + 4 <= n; t += 4) {
      int32_t xc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        xc[j] = xn[j];
        xn[j] = xr[min(t + 4 + j, n - 1)];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) ur[2 * (t + j)] = step(xc[j]);
    }
    for (; t < n; ++t) ur[2 * t] = step(xr[t]);
    int32_t* so = s_out + (size_t)(b0 + s) * 6 + 3 * p;
    so[0] = S0;
    so[1] = S1;
    so[2] = S2;
  }
  __syncthreads();

  // phase 2: write out, a warp per stream
  for (int s = warp; s < ns; s += nwarps) {
    const int32_t* u = ush + s * us;
    const size_t b = b0 + s;
    if (!kFir) {
      int32_t* o = out + b * 2 * n;
      for (int c = lane; c < 2 * n; c += 32) o[c] = u[8 + c];
      continue;
    }
    int32_t* o = out + b * plan.n_out;
    for (int j0 = 0, c = 0; j0 < plan.n_out; j0 += plan.m_full, ++c) {
      const int m = min(plan.m_full, plan.n_out - j0);
      const int32_t* uc = u + 2 * c * plan.batch;   // chunk c's buf
      for (int k = lane; k < m; k += 32) {
        const int idx = k * plan.inv;
        const int32_t* v = uc + (idx >> 16);
        // the phase's 8 taps as two 16-byte loads
        const int4* cf = reinterpret_cast<const int4*>(
            coef + coef_row(((idx & 0xFFFF) * 12) >> 16));
        const int4 c0 = cf[0], c1 = cf[1];
        const int32_t c[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
        uint32_t acc = 0;
#pragma unroll
        for (int q = 0; q < 8; ++q) acc += (uint32_t)v[q] * (uint32_t)c[q];
        o[j0 + k] = sat16(rshift_round((int32_t)acc, 15));
      }
    }
    // sFIR': the last 8 words of U, then the columns past 8 unchanged
    for (int i = lane; i < plan.f_width; i += 32)
      f_out[b * plan.f_width + i] =
          i < 8 ? u[2 * n + i] : in.f[b * in.f_stride + i];
  }
}

template <bool kFir>
int launch_up2(const Up2Rows& in, int32_t* out, int32_t* s_out,
               int32_t* f_out, int B, int n, const FirPlan& plan,
               cudaStream_t stream) {
  const int smem =
      (kCoefWords + kStreams * (x_words(n) + u_words(n) + 6)) * 4;
  static int smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        up2_kernel<kFir>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_allowed = smem;
  }
  up2_kernel<kFir><<<(B + kStreams - 1) / kStreams, kThreads, smem,
                      stream>>>(in, out, s_out, f_out, B, n, plan, kStreams);
  return (int)cudaGetLastError();
}

}  // namespace

// inp: B rows of n int32, in_stride apart; s_in, s_out: (B, 6); out:
// (B, 2n). Returns the CUDA error of the launch.
extern "C" int silk_up2_hq(const int32_t* inp, int B, int n,
                           long long in_stride, const int32_t* s_in,
                           int32_t* out, int32_t* s_out, void* stream) {
  if (B <= 0 || n < 0) return (int)cudaErrorInvalidValue;
  const Up2Rows in{inp, s_in, nullptr, in_stride, 6, 0};
  return launch_up2<false>(in, out, s_out, nullptr, B, n, FirPlan{},
                           (cudaStream_t)stream);
}

// One iir_fir call: block B rows of n int32 (x_stride apart), sIIR (B, 6)
// and sFIR (B, f_width >= 8) rows s_stride and f_stride apart; chunks of
// batch samples (the last one shorter, at least one), output index step
// inv (Q16). out: (B, n_out), s_out: (B, 6), f_out: (B, f_width),
// contiguous. n_out must be the chunking's output count. Returns the CUDA
// error of the launch.
extern "C" int silk_up2_fir(const int32_t* x, long long x_stride,
                            const int32_t* s_in, long long s_stride,
                            const int32_t* f_in, long long f_stride,
                            int f_width, int B, int n, int batch, int inv,
                            int32_t* out, int n_out, int32_t* s_out,
                            int32_t* f_out, void* stream) {
  if (B <= 0 || n < 0 || batch <= 0 || batch > 4096 || inv <= 0 ||
      f_width < 8)
    return (int)cudaErrorInvalidValue;
  // ceil((n_in << 17) / inv) outputs per chunk, as np.arange counts them
  auto count = [&](int n_in) {
    return (int)((((long long)n_in << 17) + inv - 1) / inv);
  };
  const int full = n / batch, last = n - full * batch;
  const int chunks_full = last == 0 && full > 0 ? full - 1 : full;
  const int n_last = last == 0 && full > 0 ? batch : last;
  const FirPlan plan{batch, inv, count(batch),
                     chunks_full * count(batch) + count(n_last), f_width};
  if (plan.n_out != n_out) return (int)cudaErrorInvalidValue;
  const Up2Rows in{x, s_in, f_in, x_stride, s_stride, f_stride};
  return launch_up2<true>(in, out, s_out, f_out, B, n, plan,
                          (cudaStream_t)stream);
}
