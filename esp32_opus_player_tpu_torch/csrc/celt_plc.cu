// P1: CELT pitch-repeat packet-loss concealment, float32, one concealed
// 20 ms frame per lost row, in place on a lane's transposed state.
//
// Replaces: esp32_opus_player_tpu/ops/celt/jax_plc.py::celt_plc_core (jnp
// under one jit, no pl.pallas_call: three lax.scans, an unrolled
// Levinson-24 and ~30 correlation einsums), as the JAX pool's lossy
// superstep (_celt_pool_superstep_T_lossy) runs it on a frame's compact
// lost rows. Reference: libopus 1.3.1 celt_decoder.c::celt_decode_lost,
// pitch branch (the reference decoder deleted it). The plain version is
// ops/celt/torch_plc.py::celt_plc_core; the wrapper ops/celt/
// plc_kernel.py.
//
// Layout: decode_mem (CC, 2168, cap) int32 Q12 with streams contiguous,
// preemph (cap, CC) int32, pitch (cap,) int32, lpc (cap, CC, 24) float32,
// pcm (CC, 960, cap) int16 (one frame of the window's PCM), rows (R,)
// int64, the lane columns to conceal, all distinct; first (R,) bool. Each
// row's column is read and written in place: no gather, no scatter, no
// global scratch; the call is one launch.
//
// Tile and threads: one block of kThreads threads per lost row (205
// blocks at the pools' 10 % loss of 2048 streams), all CC channels in the
// block. The row's history is staged once as float (2168 x CC words read
// with the column stride, ~17 KB at CC 2) and everything after works in
// static shared memory (41 KB).
//
// Phases, with the block's threads across what is independent:
// 1. pitch search (first conceal only; a repeated conceal takes the
//    carried pitch and skips it): the 2x downsample of the channel sum,
//    the LPC-4 whitening, the 155 lags of the 4x correlation (a thread a
//    lag), find_best_pitch's top-2 scan on one thread in lag order with
//    its running Syy and strict comparisons, then only the <= 10 lags
//    within +-2 of the two candidates at 2x (every other lag is 0 in the
//    reference: it skips them), the second scan and the pseudo-
//    interpolation;
// 2. per channel: the 25 windowed autocorrelation lags, Levinson-24 on
//    one thread (first conceal; else the carried LPC), the whitening FIR,
//    the E1/E2 decay energies, the extrapolated period and S1;
// 3. the order-24 IIR over 1080 samples, one thread per channel (the
//    channels on different warps run side by side), in transposed form:
//    each new output updates 24 partial sums that do not depend on each
//    other, so a sample waits on one FMA and one add;
// 4. S2, the energy clamp and ratio fade, the TDAC blend;
// 5. the float deemphasis over 960 samples, one thread per channel (its
//    chain: the add and the product);
// 6. the stores: decode_mem (the history rolled by 960, the new samples,
//    the blended tail), PCM, preemph, pitch and LPC.
//
// Sums: every reduction has a fixed order inside the block (a group of
// threads sums fixed strides, then one thread adds the group's partials
// in order), so a row's bits depend on nothing else in the call: a row
// concealed alone and in a bucket of any size gives the same result.
// The plain version sums in torch's order, so the two agree to float32
// rounding, not bit for bit. Build flags (ops/_build.py): -fmad=false for
// this file, so every product and sum rounds on its own as the plain
// version's separate torch operations do (the element-wise stages are then
// the plain version's bits); the IIR's state update alone uses explicit
// fmaf, where its order differs from the plain version's sum anyway. No
// --use_fast_math: division and sqrt stay IEEE, rintf rounds half to even
// (jnp.rint, torch.round).
//
// What bounds it: the chains of one row, not bytes or operations. The
// staging and the stores move ~3.6 MB for 205 rows at CC 1 (~1.1 us at
// 3.35 TB/s) and the float work is ~60 MFLOP (~1 us); but a row's IIR
// runs ~25 instructions a sample on one thread (1080 samples), the
// deemphasis waits ~8 cycles a sample (960), the two top-2 scans 465 steps
// and Levinson-24 ~300 dependent steps: ~20 us of one warp's instruction
// slots per row at 1.98 GHz by count, and the rows run side by side. The
// measured call is ~4x that count and its phases are not yet timed apart
// (PERF.md has the times).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kDBS = 2048, kOV = 120, kL = kDBS + kOV;       // 2168
constexpr int kMaxPeriod = 1024, kOrd = 24, kN = 960;
constexpr int kElen = kN + kOV;                               // 1080
constexpr int kLagMax = 720, kLagMin = 100;
constexpr int kHL = kDBS / 2;                                 // 1024
constexpr int kN4 = 332, kMP4 = 155, kN2 = 664, kMP2 = 310;   // pitch_search
constexpr int kXOff = kLagMax / 2;                            // 360
constexpr int kWraps = kElen / kLagMin + 1;                   // 11
constexpr float kPre = 27853.0f / 32768.0f;
constexpr int kMaxCC = 2;
constexpr int kGroup = 8;      // samples a chain loads ahead (divides 960, 1080)

__constant__ int16_t kWindow[kOV] = {
    2,     20,    55,    108,   178,   266,   372,   494,   635,   792,
    966,   1157,  1365,  1590,  1831,  2089,  2362,  2651,  2956,  3276,
    3611,  3961,  4325,  4703,  5094,  5499,  5916,  6346,  6788,  7241,
    7705,  8179,  8663,  9156,  9657,  10167, 10684, 11207, 11736, 12271,
    12810, 13353, 13899, 14447, 14997, 15547, 16098, 16648, 17197, 17744,
    18287, 18827, 19363, 19893, 20418, 20936, 21447, 21950, 22445, 22931,
    23407, 23874, 24330, 24774, 25208, 25629, 26039, 26435, 26819, 27190,
    27548, 27893, 28224, 28541, 28845, 29135, 29411, 29674, 29924, 30160,
    30384, 30594, 30792, 30977, 31151, 31313, 31463, 31602, 31731, 31849,
    31958, 32057, 32148, 32229, 32303, 32370, 32429, 32481, 32528, 32568,
    32604, 32634, 32661, 32683, 32701, 32717, 32729, 32740, 32748, 32754,
    32758, 32762, 32764, 32766, 32767, 32767, 32767, 32767, 32767, 32767};

// window120 / 32768 (exact)
__device__ __forceinline__ float win(int i) {
  return (float)kWindow[i] * (1.0f / 32768.0f);
}

// 1 - (0.008 k)^2, the autocorrelation lag window
__device__ __forceinline__ float lag_window(int k) {
  const float t = 0.008f * (float)k;
  return 1.0f - t * t;
}

// Q dot products at once. Thread q * P + p (q < Q) sums term(q, i) for
// i = p, p + P, ... < len(q) in order into part[]; then thread q adds its
// group's P partials in order into out[q]. The order is fixed, so the
// sums depend on nothing but this block's data.
template <class Len, class Term>
__device__ __forceinline__ void group_sums(int Q, int P, Len len, Term term,
                                           float* part, float* out) {
  const int tid = threadIdx.x;
  const int q = tid / P, p = tid - q * P;
  if (q < Q) {
    float s = 0.0f;
    const int n = len(q);
    for (int i = p; i < n; i += P) s += term(q, i);
    part[tid] = s;
  }
  __syncthreads();
  if (tid < Q) {
    float s = 0.0f;
    for (int j = 0; j < P; ++j) s += part[tid * P + j];
    out[tid] = s;
  }
  __syncthreads();
}

// Levinson-Durbin (celt_lpc.c::_celt_lpc) on one thread: lpc[0..p) from
// ac[0..p]; a row stops at its 30 dB bail-out.
__device__ void levinson(const float* ac, int p, float* lpc) {
  for (int i = 0; i < p; ++i) lpc[i] = 0.0f;
  float error = ac[0];
  bool done = ac[0] == 0.0f;
  for (int i = 0; i < p && !done; ++i) {
    float rr = ac[i + 1];
    for (int j = 0; j < i; ++j) rr = rr + lpc[j] * ac[i - j];
    const float r = -rr / (error != 0.0f ? error : 1.0f);
    lpc[i] = r;
    for (int j = 0; j < (i + 1) >> 1; ++j) {
      const float t1 = lpc[j], t2 = lpc[i - 1 - j];
      lpc[j] = t1 + r * t2;
      lpc[i - 1 - j] = t2 + r * t1;
    }
    error = error - r * r * error;
    done = error < 0.001f * ac[0];
  }
}

// pitch.c::find_best_pitch on one thread: the two best lags by normalised
// squared correlation; y2(i) is y[i]^2.
template <class Y2>
__device__ void best_pitch(const float* xcorr, Y2 y2, float Syy, int length,
                           int max_pitch, int* best) {
  float bn0 = -1.0f, bn1 = -1.0f, bd0 = 0.0f, bd1 = 0.0f;
  int bp0 = 0, bp1 = 1;
  for (int i = 0; i < max_pitch; ++i) {
    const float xc = xcorr[i];
    const float x16 = xc * 1e-12f;
    const float num = x16 * x16;
    const bool c1 = xc > 0.0f && num * bd1 > bn1 * Syy;
    const bool c0 = c1 && num * bd0 > bn0 * Syy;
    if (c0) {
      bn1 = bn0; bd1 = bd0; bp1 = bp0;
      bn0 = num; bd0 = Syy; bp0 = i;
    } else if (c1) {
      bn1 = num; bd1 = Syy; bp1 = i;
    }
    Syy = fmaxf(1.0f, Syy + y2(i + length) - y2(i));
  }
  best[0] = bp0;
  best[1] = bp1;
}

struct Smem {
  float buf[kMaxCC][kL];      // the row's decode_mem as float
  float syn[kMaxCC][kElen];   // the extrapolation, then the synthesis
  float a[kHL];               // x_lp / the windowed excitation
  float b[kHL];               // whitened x_lp / the whitened excitation
  float part[kThreads];       // group_sums partials
  float xc[kMP2 + 1];         // correlations by lag
  float sums[32];
  float ac[kOrd + 1];
  float lpc[kMaxCC][kOrd];
  float att[kMaxCC][kWraps];
  float S1[kMaxCC], ratio[kMaxCC];
  int mode[kMaxCC];           // 0 silence, 1 gain, 2 as it is
  int16_t pcm[kMaxCC][kN];
  int best[2];
  int T;
  int32_t pre[kMaxCC];
};

__global__ void __launch_bounds__(kThreads)
plc_kernel(int32_t* __restrict__ dm, long long cap, int CC,
           int32_t* __restrict__ preemph, int32_t* __restrict__ pitch,
           float* __restrict__ lpc_io, int16_t* __restrict__ pcm,
           const long long* __restrict__ rows,
           const bool* __restrict__ first_in) {
  __shared__ Smem s;
  const int tid = threadIdx.x;
  const long long row = rows[blockIdx.x];
  const bool first = first_in[blockIdx.x];

  // stage the history: column `row` of each channel plane, as float
  for (int c = 0; c < CC; ++c)
    for (int j = tid; j < kL; j += kThreads)
      s.buf[c][j] = (float)dm[((long long)c * kL + j) * cap + row] / 4096.0f;
  __syncthreads();

  // ---- 1. pitch search (celt_plc_pitch_search)
  if (first) {
    float* x_lp = s.a;
    for (int i = tid; i < kHL; i += kThreads) {
      auto x = [&](int j) {
        return CC == 2 ? s.buf[0][j] + s.buf[1][j] : s.buf[0][j];
      };
      x_lp[i] = i == 0 ? 0.25f * x(1) + 0.5f * x(0)
                       : 0.25f * (x(2 * i - 1) + x(2 * i + 1)) + 0.5f * x(2 * i);
    }
    __syncthreads();
    group_sums(5, 50, [](int q) { return kHL - q; },
               [&](int q, int i) { return x_lp[i] * x_lp[i + q]; }, s.part,
               s.ac);
    if (tid == 0) {
      s.ac[0] *= 1.0001f;
      for (int k = 1; k <= 4; ++k) s.ac[k] *= lag_window(k);
      float l4[4];
      levinson(s.ac, 4, l4);
      float g = 0.9f;
      for (int k = 0; k < 4; ++k) {
        l4[k] = l4[k] * g;
        g = g * 0.9f;
      }
      const float c1 = 0.8f;
      s.sums[0] = l4[0] + 0.8f;
      s.sums[1] = l4[1] + c1 * l4[0];
      s.sums[2] = l4[2] + c1 * l4[1];
      s.sums[3] = l4[3] + c1 * l4[2];
      s.sums[4] = c1 * l4[3];
    }
    __syncthreads();
    float* xw = s.b;            // x_lp whitened by the 5-tap FIR
    for (int i = tid; i < kHL; i += kThreads) {
      float y = x_lp[i];
      for (int k = 0; k < 5; ++k)
        y = y + s.sums[k] * (i - k - 1 >= 0 ? x_lp[i - k - 1] : 0.0f);
      xw[i] = y;
    }
    __syncthreads();
    // 4x: x4[n] = xw[360 + 2n], y4[n] = xw[2n]; Syy0 as group kMP4
    group_sums(kMP4 + 1, 1, [](int q) { return kN4; },
               [&](int q, int n) {
                 return q < kMP4 ? xw[kXOff + 2 * n] * xw[2 * (q + n)]
                                 : xw[2 * n] * xw[2 * n];
               },
               s.part, s.xc);
    if (tid == 0)
      best_pitch(s.xc, [&](int i) { return xw[2 * i] * xw[2 * i]; },
                 1.0f + s.xc[kMP4], kN4, kMP4, s.best);
    __syncthreads();
    // 2x, only the lags within +-2 of the doubled candidates (the second
    // candidate's lags that the first already has are skipped); Syy0 as
    // group 10
    const int b0 = 2 * s.best[0], b1 = 2 * s.best[1];
    auto cand = [&](int q) {
      const int lag = (q < 5 ? b0 : b1) - 2 + q % 5;
      const bool ok = lag >= 0 && lag < kMP2 &&
                      (q < 5 || lag < b0 - 2 || lag > b0 + 2);
      return ok ? lag : -1;
    };
    group_sums(11, 23, [&](int q) { return q == 10 || cand(q) >= 0 ? kN2 : 0; },
               [&](int q, int n) {
                 return q < 10 ? xw[kXOff + n] * xw[cand(q) + n]
                               : xw[n] * xw[n];
               },
               s.part, s.sums);
    for (int i = tid; i < kMP2; i += kThreads) s.xc[i] = 0.0f;
    __syncthreads();
    if (tid < 10 && cand(tid) >= 0) s.xc[cand(tid)] = fmaxf(-1.0f, s.sums[tid]);
    __syncthreads();
    if (tid == 0) {
      int bb[2];
      best_pitch(s.xc, [&](int i) { return xw[i] * xw[i]; },
                 1.0f + s.sums[10], kN2, kMP2, bb);
      const int p = bb[0];
      const float a = s.xc[p > 0 ? p - 1 : 0], b = s.xc[p];
      const float c = s.xc[p < kMP2 - 1 ? p + 1 : kMP2 - 1];
      int off = (c - a) > 0.7f * (b - a) ? 1 : ((a - c) > 0.7f * (b - c) ? -1 : 0);
      if (!(p > 0 && p < kMP2 - 1)) off = 0;
      s.T = kLagMax - (2 * p - off);
    }
  } else if (tid == 0) {
    s.T = pitch[row];
  }
  __syncthreads();
  const int T = min(max(s.T, kLagMin), kLagMax);
  const float fade = first ? 1.0f : 0.8f;
  const int exc_len = min(2 * T, kMaxPeriod);
  const int dl = exc_len >> 1;

  // ---- 2. per channel: LPC fit, whitening, decay, extrapolation
  for (int c = 0; c < CC; ++c) {
    const float* buf = s.buf[c];
    const float* exc = buf + kDBS - kMaxPeriod;   // 1024 samples
    if (first) {
      float* xw = s.a;
      for (int i = tid; i < kMaxPeriod; i += kThreads) {
        float v = exc[i];
        if (i < kOV) v = v * win(i);
        else if (i >= kMaxPeriod - kOV) v = v * win(kMaxPeriod - 1 - i);
        xw[i] = v;
      }
      __syncthreads();
      group_sums(kOrd + 1, 10, [](int q) { return kMaxPeriod - q; },
                 [&](int q, int i) { return xw[i] * xw[i + q]; }, s.part,
                 s.ac);
      if (tid == 0) {
        s.ac[0] *= 1.0001f;
        for (int k = 1; k <= kOrd; ++k) s.ac[k] *= lag_window(k);
        levinson(s.ac, kOrd, s.lpc[c]);
      }
    } else if (tid < kOrd) {
      s.lpc[c][tid] = lpc_io[(row * CC + c) * kOrd + tid];
    }
    __syncthreads();
    // whiten the last exc_len samples (FIR over past inputs, taps in order)
    float* exc_w = s.b;
    const float* a = s.lpc[c];
    for (int i = tid; i < kMaxPeriod; i += kThreads) {
      float y = exc[i];
      if (i >= kMaxPeriod - exc_len)
        for (int k = 0; k < kOrd; ++k) y = y + a[k] * exc[i - k - 1];
      exc_w[i] = y;
    }
    __syncthreads();
    group_sums(2, 128, [](int q) { return kMaxPeriod; },
               [&](int q, int i) {
                 const bool in1 = i >= kMaxPeriod - dl;
                 const bool in2 = i >= kMaxPeriod - exc_len && !in1;
                 return (q == 0 ? in1 : in2) ? exc_w[i] * exc_w[i] : 0.0f;
               },
               s.part, s.sums);
    if (tid == 0) {
      const float E1 = 1.0f + s.sums[0], E2 = 1.0f + s.sums[1];
      const float decay = sqrtf(fminf(E1, E2) / E2);
      float p = decay;
      for (int w = 0; w < kWraps; ++w) {
        s.att[c][w] = fade * p;
        p = p * decay;
      }
    }
    __syncthreads();
    float* ex = s.syn[c];
    for (int i = tid; i < kElen; i += kThreads)
      ex[i] = s.att[c][i / T] * exc_w[kMaxPeriod - T + i % T];
    group_sums(1, 128, [](int q) { return kElen; },
               [&](int q, int i) {
                 const float v = buf[kDBS - T + i % T];
                 return v * v;
               },
               s.part, s.sums);
    if (tid == 0) s.S1[c] = s.sums[0] / 1024.0f;
    __syncthreads();
  }

  // ---- 3. the order-24 IIR (celt_lpc.c::celt_iir), a thread a channel:
  // y[i] = x[i] + s0; s_k <- s_{k+1} - a_k y[i]; state from the history
  if (tid % 32 == 0 && tid / 32 < CC) {
    const int c = tid / 32;
    float* y = s.syn[c];
    const float* hist = s.buf[c] + kDBS;        // hist[-1 - k] = y[-1 - k]
    float av[kOrd], st[kOrd];
#pragma unroll
    for (int k = 0; k < kOrd; ++k) av[k] = s.lpc[c][k];
#pragma unroll
    for (int k = 0; k < kOrd; ++k) {
      // s_k = -sum_{j >= k} a_j y[-1 - (j - k)], oldest term first
      float v = 0.0f;
#pragma unroll
      for (int j = kOrd - 1; j >= k; --j) v = fmaf(-av[j], hist[-1 - (j - k)], v);
      st[k] = v;
    }
    // the inputs come into registers a group ahead of the walk, so no
    // shared-memory load waits inside the chain
    float nx[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) nx[u] = y[u];
    for (int i0 = 0; i0 < kElen; i0 += kGroup) {
      float xv[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) xv[u] = nx[u];
      if (i0 + kGroup < kElen) {
#pragma unroll
        for (int u = 0; u < kGroup; ++u) nx[u] = y[i0 + kGroup + u];
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const float yi = xv[u] + st[0];
        xv[u] = yi;
#pragma unroll
        for (int k = 0; k < kOrd - 1; ++k) st[k] = fmaf(-av[k], yi, st[k + 1]);
        st[kOrd - 1] = -av[kOrd - 1] * yi;
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u) y[i0 + u] = xv[u];
    }
  }
  __syncthreads();

  // ---- 4. S2, the energy clamp and the ratio fade
  group_sums(CC, 128, [](int q) { return kElen; },
             [&](int q, int i) { return s.syn[q][i] * s.syn[q][i]; }, s.part,
             s.sums);
  if (tid < CC) {
    const float S1 = s.S1[tid], S2 = s.sums[tid] / 1024.0f;
    s.ratio[tid] = sqrtf((S1 / 2.0f + 1.0f) / (S2 / 2.0f + 1.0f));
    s.mode[tid] = S1 > 0.25f * S2 ? (S1 < S2 ? 1 : 2) : 0;
    s.pre[tid] = preemph[row * CC + tid];
  }
  __syncthreads();
  for (int c = 0; c < CC; ++c) {
    const int mode = s.mode[c];
    const float ratio = s.ratio[c];
    for (int i = tid; i < kElen; i += kThreads) {
      const float v = s.syn[c][i];
      const float g = i < kOV ? 1.0f - win(i) * (1.0f - ratio) : ratio;
      s.syn[c][i] = mode == 0 ? 0.0f : (mode == 1 ? v * g : v);
    }
  }
  __syncthreads();

  // ---- 5. the float deemphasis, a thread a channel
  if (tid % 32 == 0 && tid / 32 < CC) {
    const int c = tid / 32;
    const float* x = s.syn[c];
    float m = (float)s.pre[c] / 4096.0f;
    float nx[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) nx[u] = x[u];
    for (int i0 = 0; i0 < kN; i0 += kGroup) {
      float t[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) t[u] = nx[u];
      if (i0 + kGroup < kN) {
#pragma unroll
        for (int u = 0; u < kGroup; ++u) nx[u] = x[i0 + kGroup + u];
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        t[u] = t[u] + m;
        m = kPre * t[u];
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u)
        s.pcm[c][i0 + u] =
            (int16_t)fminf(fmaxf(rintf(t[u]), -32768.0f), 32767.0f);
    }
    preemph[row * CC + c] = (int32_t)rintf(m * 4096.0f);
  }
  __syncthreads();

  // ---- 6. stores
  auto q12 = [](float v) {
    return (int32_t)rintf(fminf(fmaxf(v, -524288.0f), 524287.0f) * 4096.0f);
  };
  for (int c = 0; c < CC; ++c) {
    const float* buf = s.buf[c];
    const float* syn = s.syn[c];
    int32_t* col = dm + (long long)c * kL * cap + row;
    for (int j = tid; j < kL; j += kThreads) {
      float v;
      if (j < kDBS - kN) {
        v = buf[j + kN];
      } else if (j < kDBS) {
        v = syn[j - (kDBS - kN)];
      } else if (j < kDBS + kOV / 2) {
        const int i2 = j - kDBS;        // TDAC of the overlap tail
        v = win(i2) * syn[kN + kOV - 1 - i2] + win(kOV - 1 - i2) * syn[kN + i2];
      } else {
        v = buf[j];
      }
      col[(long long)j * cap] = q12(v);
    }
    int16_t* out = pcm + (long long)c * kN * cap + row;
    for (int i = tid; i < kN; i += kThreads) out[(long long)i * cap] = s.pcm[c][i];
    if (tid < kOrd) lpc_io[(row * CC + c) * kOrd + tid] = s.lpc[c][tid];
  }
  if (tid == 0) pitch[row] = T;
}

}  // namespace

// dm: (CC, 2168, cap) int32; preemph (cap, CC) int32; pitch (cap,) int32;
// lpc (cap, CC, 24) float32, each updated in place at the R columns
// `rows` (int64, distinct); pcm (CC, 960, cap) int16, written at those
// columns; first (R,) bool. Returns the CUDA error of the launch.
extern "C" int celt_plc(int32_t* dm, long long cap, int CC, int32_t* preemph,
                        int32_t* pitch, float* lpc, int16_t* pcm,
                        const long long* rows, const bool* first, int R,
                        void* stream) {
  if (R <= 0 || cap <= 0 || CC < 1 || CC > kMaxCC)
    return (int)cudaErrorInvalidValue;
  plc_kernel<<<R, kThreads, 0, (cudaStream_t)stream>>>(
      dm, cap, CC, preemph, pitch, lpc, pcm, rows, first);
  return (int)cudaGetLastError();
}
