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
// block, everything after the staging in static shared memory (~44 KB).
// A call takes as long as its slowest row, and a row is a string of
// phases that each wait on the one before, so the design shortens that
// string (tools/kernel_variants.py p1 times each phase; PERF.md has the
// times):
// 0. staging: every thread issues all its column loads (kStage a channel)
//    into registers before its first shared store, so a row's history
//    costs one memory latency; the deemphasis memory and a repeated
//    conceal's carried LPC come in with it; then the decode_mem rows
//    that do not depend on the conceal (the history rolled by 960, the
//    tail past the TDAC half) go back, and drain while it runs;
// 1. pitch search (first conceal only; a repeated conceal takes the
//    carried pitch): the 2x downsample of the channel sum, its LPC-4
//    whitening filter (Levinson-4 on every thread: the same bits
//    everywhere, no barrier), the 155 lags of the 4x correlation (a
//    thread a lag) and beside them, a thread each, the two scans'
//    window-energy (Syy) chains; then find_best_pitch's top-2 walk on one
//    thread in lag order with its strict comparisons, a group of lags at
//    a time (a group that holds no new best, most of them, costs one test
//    a lag); then only the <= 10 lags within +-2 of the two candidates at
//    2x (every other lag is 0 in the reference: it skips them), the
//    second walk, stopped after the last candidate, and the
//    pseudo-interpolation;
// 2. all channels side by side: the 25 windowed autocorrelation lags,
//    Levinson-24 (first conceal; else the carried LPC) in registers on
//    one thread a channel, the whitening FIR, the E1/E2 decay energies,
//    S1, and the extrapolated period (its decay powers on every thread);
//    the synthesis filter's first 32 impulse-response samples h (one
//    thread a channel) and from them G, its response over 32 samples to
//    each of its 24 states;
// 3. the order-24 IIR over 1080 samples, a warp a channel, 32 samples a
//    step: lane j's output is the step's own inputs through h plus the 24
//    outputs before the step through G[j] (G[j] in registers; h read
//    from a copy with 32 zeros before it, so no lane branches); a step
//    waits on the one before only through those 24 outputs, 34 steps
//    instead of 1080 dependent samples of ~26 instructions on one
//    thread;
// 4. S2, then the energy clamp and ratio fade (the ratio on every
//    thread);
// 5. the decode_mem stores of the new samples and the TDAC-blended tail,
//    LPC and pitch, by every thread; beside them the float deemphasis, a
//    warp a channel: a first-order linear recurrence, so each lane walks
//    30 samples from a zero memory, the lanes' end memories meet in a
//    5-step shuffle scan (the memory after lane l is kPre^30 times the one
//    before it plus lane l's own), and each lane walks its 30 samples
//    again from its true memory, the PCM into shared memory; 60 dependent
//    steps a lane instead of 960; then every thread writes the PCM.
//
// Sums: every dot product and energy is a warp's (warp w takes sums w, w +
// kWarps, ...; lane l accumulates terms l, l + 32, ... with fmaf, then a
// fixed xor-shuffle tree), or one thread's in a fixed order; so a row's
// bits depend on nothing else in the call: a row concealed alone and in a
// bucket of any size gives the same result. The plain version sums in
// torch's order, so the two agree to float32 rounding, not bit for bit.
// Build flags (ops/_build.py): -fmad=false for this file, so every
// element-wise product and sum rounds on its own as the plain version's
// separate torch operations do; only the sums above, the IIR (h, G and
// its steps) and the deemphasis scan's carries use explicit fmaf, where
// their order differs from the plain version's anyway. No --use_fast_math:
// division and sqrt stay IEEE, rintf rounds half to even (torch.round).
//
// The phases a row runs on one thread or one warp (the scans, Levinson,
// h, the IIR, the deemphasis) run on warp 0 for channel 0 and warp 2 for
// channel 1, so the channels' chains run side by side on different SM
// sub-partitions.
//
// What bounds it: the chains of one row, not bytes or operations. The
// staging and the stores move ~4 MB for 205 rows at CC 1 (~1.2 us at
// 3.35 TB/s; but every 4-byte word of a column is its own 32-byte
// sector, so each warp access is 32 transactions) and the float work is
// ~60 MFLOP (~1 us); a row waits on its Syy chain (310 dependent steps),
// its top-2 walks, Levinson-24 (~300 dependent steps), the IIR's 34
// steps, and the phases' barriers.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kDBS = 2048, kOV = 120, kL = kDBS + kOV;       // 2168
constexpr int kMaxPeriod = 1024, kOrd = 24, kN = 960;
constexpr int kElen = kN + kOV;                               // 1080
constexpr int kLagMax = 720, kLagMin = 100;
constexpr int kHL = kDBS / 2;                                 // 1024
constexpr int kN4 = 332, kMP4 = 155, kN2 = 664, kMP2 = 310;   // pitch_search
constexpr int kXOff = kLagMax / 2;                            // 360
constexpr float kPre = 27853.0f / 32768.0f;
constexpr int kMaxCC = 2;
constexpr int kGroup = 8;      // samples a chain loads ahead (divides 960, 1080)
constexpr int kStage = (kL + kThreads - 1) / kThreads;   // loads a thread
constexpr int kSpan = kN / 32;   // deemphasis samples a lane (30)
constexpr int kBlk = 32;         // IIR samples a step of its warp

// kPre^n as n float32 products
constexpr float pre_power(int n) { return n == 0 ? 1.0f : kPre * pre_power(n - 1); }
constexpr float kPreSpan = pre_power(kSpan);

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

// the sum of a value over a warp's lanes, in a fixed xor tree (every lane
// gets the same bits: a + b == b + a)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kAll, v, off);
  return v;
}

// Q dot products over the block's warps: warp w takes q = w, w + kWarps,
// ...; lane l accumulates pair(q, i) = (a, b) for i = l, l + 32, ... <
// len(q) in order with fmaf, then the lanes meet in warp_sum; out[q] gets
// the sum. The order is fixed, so the sums depend on nothing but this
// block's data. The caller synchronises before reading out.
template <class Len, class Pair>
__device__ __forceinline__ void warp_dots(int Q, Len len, Pair pair,
                                          float* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int q = warp; q < Q; q += kWarps) {
    const int n = len(q);
    float s = 0.0f;
    for (int i = lane; i < n; i += 32) {
      float a, b;
      pair(q, i, a, b);
      s = fmaf(a, b, s);
    }
    s = warp_sum(s);
    if (lane == 0) out[q] = s;
  }
}

// Levinson-Durbin (celt_lpc.c::_celt_lpc) on one thread, in registers
// (fully unrolled): lpc[0..P) from ac[0..P]; a row stops at its 30 dB
// bail-out. Each product and sum rounds on its own, in the plain
// version's order.
template <int P>
__device__ __forceinline__ void levinson(const float (&ac)[P + 1],
                                         float* out) {
  float lpc[P];
#pragma unroll
  for (int i = 0; i < P; ++i) lpc[i] = 0.0f;
  float error = ac[0];
  bool done = ac[0] == 0.0f;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    if (!done) {
      float rr = ac[i + 1];
#pragma unroll
      for (int j = 0; j < i; ++j) rr = rr + lpc[j] * ac[i - j];
      const float r = -rr / (error != 0.0f ? error : 1.0f);
      lpc[i] = r;
#pragma unroll
      for (int j = 0; j < (i + 1) >> 1; ++j) {
        const float t1 = lpc[j], t2 = lpc[i - 1 - j];
        lpc[j] = t1 + r * t2;
        lpc[i - 1 - j] = t2 + r * t1;
      }
      error = error - r * r * error;
      done = error < 0.001f * ac[0];
    }
  }
#pragma unroll
  for (int i = 0; i < P; ++i) out[i] = lpc[i];
}

// find_best_pitch's window energy before each of n lags (pitch.c): Syy,
// then max(1, Syy + y2[i + length] - y2[i]) (y2: the squares), one
// thread, the inputs a group of kGroup ahead in registers.
__device__ void syy_chain(const float* y2, float Syy, int length, int n,
                          float* out) {
  float ni[kGroup], no[kGroup];
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    ni[u] = y2[u + length];
    no[u] = y2[u];
  }
  int i0 = 0;
  for (; i0 + kGroup <= n; i0 += kGroup) {
    float ci[kGroup], co[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      ci[u] = ni[u];
      co[u] = no[u];
      ni[u] = y2[i0 + kGroup + u + length];
      no[u] = y2[i0 + kGroup + u];
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      out[i0 + u] = Syy;
      Syy = fmaxf(1.0f, Syy + ci[u] - co[u]);
    }
  }
  for (int i = i0; i < n; ++i) {
    out[i] = Syy;
    Syy = fmaxf(1.0f, Syy + y2[i + length] - y2[i]);
  }
}

// (xc * 1e-12)^2, find_best_pitch's numerator, for a positive
// correlation; NaN for any other, which loses every comparison, as the
// reference's xc > 0 test does
__device__ __forceinline__ float pitch_num(float xc) {
  const float x16 = xc * 1e-12f;
  return xc > 0.0f ? x16 * x16 : __int_as_float(0x7fffffff);
}

// pitch.c::find_best_pitch's top-2 walk on one thread, in lag order, over
// the numerators num[i] (pitch_num) and window energies syy[i] (syy_chain)
// of n lags. A group of kGroup lags is first tested against the second
// best as it stands, all at once: a lag that beats neither best changes
// nothing, so a group where none does (most of them) is done, and only a
// group where one does takes its steps one by one. Either way each lag
// meets the bests the reference's walk gives it, so the result is the
// walk's. The group's inputs come into registers a group ahead.
__device__ void best_pitch(const float* num, const float* syy, int n,
                           int* best) {
  float bn0 = -1.0f, bn1 = -1.0f, bd0 = 0.0f, bd1 = 0.0f;
  int bp0 = 0, bp1 = 1;
  auto step = [&](int i, float nm, float sy) {
    if (nm * bd1 > bn1 * sy) {
      if (nm * bd0 > bn0 * sy) {
        bn1 = bn0; bd1 = bd0; bp1 = bp0;
        bn0 = nm; bd0 = sy; bp0 = i;
      } else {
        bn1 = nm; bd1 = sy; bp1 = i;
      }
    }
  };
  float nn[kGroup], ns[kGroup];
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    nn[u] = num[u];
    ns[u] = syy[u];
  }
  int i0 = 0;
  for (; i0 + kGroup <= n; i0 += kGroup) {
    float cn[kGroup], cs[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      cn[u] = nn[u];
      cs[u] = ns[u];
      nn[u] = num[i0 + kGroup + u];
      ns[u] = syy[i0 + kGroup + u];
    }
    bool any = false;
#pragma unroll
    for (int u = 0; u < kGroup; ++u) any |= cn[u] * bd1 > bn1 * cs[u];
    if (any) {
#pragma unroll
      for (int u = 0; u < kGroup; ++u) step(i0 + u, cn[u], cs[u]);
    }
  }
  for (int i = i0; i < n; ++i) step(i, num[i], syy[i]);
  best[0] = bp0;
  best[1] = bp1;
}

struct Smem {
  float buf[kMaxCC][kL];        // the row's decode_mem as float
  float syn[kMaxCC][kElen + 8]; // x4 (the search), the extrapolation, then
                                // the synthesis; 8 zeros past its end
  float a[kMaxCC][kMaxPeriod];  // x_lp / each channel's windowed excitation
  float b[kMaxCC][kMaxPeriod];  // whitened x_lp / whitened excitation
  float xc[kMP2 + 1];           // correlations by lag
  float sums[32];
  float ac[kMaxCC][kOrd + 1];
  float lpc[kMaxCC][kOrd];
  float h[kMaxCC][2 * kBlk];    // kBlk zeros, then the IIR's impulse
                                // response
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
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long row = rows[blockIdx.x];
  const bool first = first_in[blockIdx.x];

  // ---- 0. stage the history (column `row` of each channel plane, as
  // float): every load of a thread in flight before its first store
  {
    int32_t v[kMaxCC][kStage];
#pragma unroll
    for (int c = 0; c < kMaxCC; ++c)
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int j = tid + u * kThreads;
        v[c][u] = c < CC && j < kL
                      ? dm[((long long)c * kL + j) * cap + row] : 0;
      }
    if (tid < CC) s.pre[tid] = preemph[row * CC + tid];
    if (!first && tid < CC * kOrd)
      s.lpc[tid / kOrd][tid % kOrd] = lpc_io[row * CC * kOrd + tid];
    if (tid == 0) s.T = first ? 0 : pitch[row];
#pragma unroll
    for (int c = 0; c < kMaxCC; ++c)
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int j = tid + u * kThreads;
        if (c < CC && j < kL) s.buf[c][j] = (float)v[c][u] / 4096.0f;
      }
  }
  __syncthreads();
  auto q12 = [](float v) {
    return (int32_t)rintf(fminf(fmaxf(v, -524288.0f), 524287.0f) * 4096.0f);
  };
  // the rolled history (rows [0, 1088) <- [960, 2048)) and the tail past
  // the TDAC half (rows [2108, 2168), as they were) go back now and drain
  // while the conceal runs
  constexpr int kKeep = kDBS - kN, kTail = kDBS + kOV / 2;
  for (int c = 0; c < CC; ++c) {
    int32_t* col = dm + (long long)c * kL * cap + row;
    for (int j = tid; j < kKeep + kL - kTail; j += kThreads) {
      const int r = j < kKeep ? j : j - kKeep + kTail;
      col[(long long)r * cap] = q12(s.buf[c][j < kKeep ? j + kN : r]);
    }
  }
  // the channel whose one-thread phases this warp's lane 0 runs (warps 0
  // and 2, on different SM sub-partitions), or -1
  const int chan = warp % 2 == 0 && warp / 2 < CC ? warp / 2 : -1;

  // ---- 1. pitch search (celt_plc_pitch_search)
  if (first) {
    float* x_lp = s.a[0];
    for (int i = tid; i < kHL; i += kThreads) {
      auto x = [&](int j) {
        return CC == 2 ? s.buf[0][j] + s.buf[1][j] : s.buf[0][j];
      };
      x_lp[i] = i == 0 ? 0.25f * x(1) + 0.5f * x(0)
                       : 0.25f * (x(2 * i - 1) + x(2 * i + 1)) + 0.5f * x(2 * i);
    }
    __syncthreads();
    warp_dots(5, [](int q) { return kHL - q; },
              [&](int q, int i, float& a, float& b) {
                a = x_lp[i];
                b = x_lp[i + q];
              },
              s.ac[0]);
    __syncthreads();
    // the 5-tap whitening filter from Levinson-4, on every thread (the same
    // bits everywhere, so no barrier for it)
    float fir[5];
    {
      float ac[5];
      ac[0] = s.ac[0][0] * 1.0001f;
#pragma unroll
      for (int k = 1; k <= 4; ++k) ac[k] = s.ac[0][k] * lag_window(k);
      float l4[4];
      levinson<4>(ac, l4);
      float g = 0.9f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        l4[k] = l4[k] * g;
        g = g * 0.9f;
      }
      const float c1 = 0.8f;
      fir[0] = l4[0] + 0.8f;
      fir[1] = l4[1] + c1 * l4[0];
      fir[2] = l4[2] + c1 * l4[1];
      fir[3] = l4[3] + c1 * l4[2];
      fir[4] = c1 * l4[3];
    }
    float* xw = s.b[0];         // x_lp whitened by the 5-tap FIR
    float* x4 = s.syn[0];       // its even samples (the 4x search's)
    float* sq2 = s.a[1];        // xw^2, the 2x scan's energies
    float* sq4 = s.syn[1];      // x4^2, the 4x scan's
    for (int i = tid; i < kHL; i += kThreads) {
      float y = x_lp[i];
#pragma unroll
      for (int k = 0; k < 5; ++k)
        y = y + fir[k] * (i - k - 1 >= 0 ? x_lp[i - k - 1] : 0.0f);
      xw[i] = y;
      sq2[i] = y * y;
      if (!(i & 1)) {
        x4[i >> 1] = y;
        sq4[i >> 1] = y * y;
      }
    }
    __syncthreads();
    // 4x: x4[180 + n] against x4[q + n], a thread a lag (its even and odd
    // n apart, then added), with its numerator; beside them, on the last
    // two warps, the two scans' window energies: Syy0 (x4^2 and xw^2
    // summed as the lags are), then the Syy chain of every lag
    float* syy4 = s.a[0];           // x_lp is spent
    float* syy2 = s.a[0] + kMP4;
    float* num4 = s.b[1];
    float* num2 = s.b[1] + 512;
    auto square_sum = [](const float* v, int n) {   // n: a multiple of 4
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int i = 0; i < n; i += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[u] = fmaf(v[i + u], v[i + u], acc[u]);
      }
      return (acc[0] + acc[1]) + (acc[2] + acc[3]);
    };
    for (int q = tid; q < kMP4; q += kThreads) {
      float acc0 = 0.0f, acc1 = 0.0f;
      for (int n = 0; n < kN4; n += 2) {
        acc0 = fmaf(x4[kXOff / 2 + n], x4[q + n], acc0);
        acc1 = fmaf(x4[kXOff / 2 + n + 1], x4[q + n + 1], acc1);
      }
      const float v = acc0 + acc1;
      s.xc[q] = v;
      num4[q] = pitch_num(v);
    }
    if (tid == 32 * (kWarps - 2))
      syy_chain(sq4, 1.0f + square_sum(x4, kN4), kN4, kMP4, syy4);
    if (tid == 32 * (kWarps - 1))
      syy_chain(sq2, 1.0f + square_sum(xw, kN2), kN2, kMP2, syy2);
    __syncthreads();
    if (tid == 0) {
      best_pitch(num4, syy4, kMP4, s.best);
    } else {
      // meanwhile: the 2x lags, 0 until their candidates are known
      for (int i = tid - 1; i < kMP2; i += kThreads - 1) {
        s.xc[i] = 0.0f;
        num2[i] = pitch_num(0.0f);
      }
    }
    __syncthreads();
    // 2x, only the lags within +-2 of the doubled candidates (the second
    // candidate's lags that the first already has are skipped)
    const int b0 = 2 * s.best[0], b1 = 2 * s.best[1];
    auto cand = [&](int q) {
      const int lag = (q < 5 ? b0 : b1) - 2 + q % 5;
      const bool ok = lag >= 0 && lag < kMP2 &&
                      (q < 5 || lag < b0 - 2 || lag > b0 + 2);
      return ok ? lag : -1;
    };
    warp_dots(10, [&](int q) { return cand(q) >= 0 ? kN2 : 0; },
              [&](int q, int n, float& a, float& b) {
                a = xw[kXOff + n];
                b = xw[cand(q) + n];
              },
              s.sums);
    __syncthreads();
    if (tid == 0) {
      for (int q = 0; q < 10; ++q) {
        if (cand(q) >= 0) {
          const float v = fmaxf(-1.0f, s.sums[q]);
          s.xc[cand(q)] = v;
          num2[cand(q)] = pitch_num(v);
        }
      }
      // the lags past the last candidate hold 0 and change nothing
      int bb[2];
      best_pitch(num2, syy2, min(kMP2, max(b0, b1) + 3), bb);
      const int p = bb[0];
      const float a = s.xc[p > 0 ? p - 1 : 0], b = s.xc[p];
      const float c = s.xc[p < kMP2 - 1 ? p + 1 : kMP2 - 1];
      int off = (c - a) > 0.7f * (b - a) ? 1 : ((a - c) > 0.7f * (b - c) ? -1 : 0);
      if (!(p > 0 && p < kMP2 - 1)) off = 0;
      s.T = kLagMax - (2 * p - off);
    }
    __syncthreads();
  }
  const int T = min(max(s.T, kLagMin), kLagMax);
  const float fade = first ? 1.0f : 0.8f;
  const int exc_len = min(2 * T, kMaxPeriod);
  const int dl = exc_len >> 1;

  // ---- 2. every channel at once: LPC fit, whitening, decay,
  // extrapolation (exc: the last 1024 samples of the history)
  if (first) {
    for (int k = tid; k < CC * kMaxPeriod; k += kThreads) {
      const int c = k / kMaxPeriod, i = k % kMaxPeriod;
      float v = s.buf[c][kDBS - kMaxPeriod + i];
      if (i < kOV) v = v * win(i);
      else if (i >= kMaxPeriod - kOV) v = v * win(kMaxPeriod - 1 - i);
      s.a[c][i] = v;
    }
    __syncthreads();
    warp_dots(CC * (kOrd + 1),
              [](int q) { return kMaxPeriod - q % (kOrd + 1); },
              [&](int q, int i, float& a, float& b) {
                const int c = q / (kOrd + 1);
                a = s.a[c][i];
                b = s.a[c][i + q - c * (kOrd + 1)];
              },
              &s.ac[0][0]);
    __syncthreads();
    if (chan >= 0 && lane == 0) {
      float ac[kOrd + 1];
      ac[0] = s.ac[chan][0] * 1.0001f;
#pragma unroll
      for (int k = 1; k <= kOrd; ++k) ac[k] = s.ac[chan][k] * lag_window(k);
      levinson<kOrd>(ac, s.lpc[chan]);
    }
    __syncthreads();
  }
  // the synthesis filter's first kBlk impulse-response samples, a thread
  // a channel (the IIR below runs on them)
  if (chan >= 0 && lane == 0) {
    float st[kOrd];
#pragma unroll
    for (int k = 0; k < kOrd; ++k) st[k] = 0.0f;
    for (int n = 0; n < kBlk; ++n) {
      const float yn = (n == 0 ? 1.0f : 0.0f) + st[0];
      s.h[chan][n] = 0.0f;
      s.h[chan][kBlk + n] = yn;
#pragma unroll
      for (int k = 0; k < kOrd - 1; ++k)
        st[k] = fmaf(-s.lpc[chan][k], yn, st[k + 1]);
      st[kOrd - 1] = -s.lpc[chan][kOrd - 1] * yn;
    }
  }
  // whiten the last exc_len samples (FIR over past inputs, taps in order)
  for (int k = tid; k < CC * kMaxPeriod; k += kThreads) {
    const int c = k / kMaxPeriod, i = k % kMaxPeriod;
    const float* exc = s.buf[c] + kDBS - kMaxPeriod;
    float y = exc[i];
    if (i >= kMaxPeriod - exc_len)
      for (int j = 0; j < kOrd; ++j) y = y + s.lpc[c][j] * exc[i - j - 1];
    s.b[c][i] = y;
  }
  __syncthreads();
  // E1, E2 (the whitened energies of the last two half-exc_len windows)
  // and S1 (the source period's), three sums a channel
  warp_dots(3 * CC, [](int q) { return q % 3 == 2 ? kElen : kMaxPeriod; },
            [&](int q, int i, float& a, float& b) {
              const int c = q / 3, k = q % 3;
              if (k == 2) {
                a = s.buf[c][kDBS - T + i % T];
              } else {
                const bool in1 = i >= kMaxPeriod - dl;
                const bool in = k == 0 ? in1
                                       : i >= kMaxPeriod - exc_len && !in1;
                a = in ? s.b[c][i] : 0.0f;
              }
              b = a;
            },
            s.sums);
  __syncthreads();
  // the extrapolation: one period of the whitened excitation, wrap w
  // scaled by fade decay^(1 + w) (decay from the energies, the powers as
  // running products, on every thread)
  for (int c = 0; c < CC; ++c) {
    const float E1 = 1.0f + s.sums[3 * c], E2 = 1.0f + s.sums[3 * c + 1];
    const float decay = sqrtf(fminf(E1, E2) / E2);
    for (int i = tid; i < kElen + 8; i += kThreads) {
      float p = decay;
      for (int w = 0; w < i / T; ++w) p = p * decay;
      s.syn[c][i] = i < kElen ? fade * p * s.b[c][kMaxPeriod - T + i % T]
                              : 0.0f;
    }
  }
  // G[j][k], the IIR's output j samples into a step from a unit k-th
  // state (the output k + 1 samples before the step) and zero input:
  // sum_{t <= min(j, 23 - k)} h[j - t] (-a[t + k]); into s.a at [k][j]
  // (the LPC fit is done with it)
  for (int q = tid; q < CC * kBlk * kOrd; q += kThreads) {
    const int c = q / (kBlk * kOrd), k = q / kBlk % kOrd, j = q % kBlk;
    float g = 0.0f;
    for (int t = 0; t <= min(j, kOrd - 1 - k); ++t)
      g = fmaf(s.h[c][kBlk + j - t], -s.lpc[c][t + k], g);
    s.a[c][k * kBlk + j] = g;
  }
  __syncthreads();

  // ---- 3. the order-24 IIR (celt_lpc.c::celt_iir), y[t] = x[t] - sum_k
  // a_k y[t - 1 - k], a warp a channel, kBlk samples a step: lane j's
  // output is the step's inputs through h (zero state) plus the 24
  // outputs before the step through G[j] (zero input); a step waits on
  // the one before it only through those 24 outputs
  if (chan >= 0) {
    float* y = s.syn[chan];
    float g[kOrd];
#pragma unroll
    for (int k = 0; k < kOrd; ++k) g[k] = s.a[chan][k * kBlk + lane];
    // h[kBlk + lane - i]: h[lane - i], and 0 for an input after the lane's
    // own (i > lane), so no lane branches
    const float* h = s.h[chan] + kBlk + lane;
    for (int t0 = 0; t0 < kElen; t0 += kBlk) {
      const int t = t0 + lane;
      // prev[-1 - k]: the output k + 1 samples before the step (the
      // history's before the first)
      const float* prev = t0 ? y + t0 : s.buf[chan] + kDBS;
      float z0 = 0.0f, z1 = 0.0f, p0 = 0.0f, p1 = 0.0f;
#pragma unroll
      for (int i = 0; i < kBlk; i += 2) {
        z0 = fmaf(h[-i], y[t0 + i], z0);
        z1 = fmaf(h[-i - 1], y[t0 + i + 1], z1);
      }
#pragma unroll
      for (int k = 0; k < kOrd; k += 2) {
        p0 = fmaf(g[k], prev[-1 - k], p0);
        p1 = fmaf(g[k + 1], prev[-2 - k], p1);
      }
      __syncwarp();
      if (t < kElen) y[t] = (z0 + z1) + (p0 + p1);
      __syncwarp();
    }
  }
  __syncthreads();

  // ---- 4. S2, the energy clamp and the ratio fade
  warp_dots(CC, [](int q) { return kElen; },
            [&](int q, int i, float& a, float& b) { a = b = s.syn[q][i]; },
            s.sums);
  __syncthreads();
  for (int c = 0; c < CC; ++c) {
    // S1 (the channel's third energy sum) against S2, on every thread
    const float S1 = s.sums[3 * c + 2] / 1024.0f, S2 = s.sums[c] / 1024.0f;
    const float ratio = sqrtf((S1 / 2.0f + 1.0f) / (S2 / 2.0f + 1.0f));
    const int mode = S1 > 0.25f * S2 ? (S1 < S2 ? 1 : 2) : 0;
    for (int i = tid; i < kElen; i += kThreads) {
      const float v = s.syn[c][i];
      const float g = i < kOV ? 1.0f - win(i) * (1.0f - ratio) : ratio;
      s.syn[c][i] = mode == 0 ? 0.0f : (mode == 1 ? v * g : v);
    }
  }
  __syncthreads();

  // ---- 5. the stores of the new rows, and beside them the float
  // deemphasis
  for (int c = 0; c < CC; ++c) {
    const float* syn = s.syn[c];
    int32_t* col = dm + (long long)c * kL * cap + row;
    for (int i = tid; i < kN + kOV / 2; i += kThreads) {
      float v;
      if (i < kN) {
        v = syn[i];
      } else {
        const int i2 = i - kN;          // TDAC of the overlap tail
        v = win(i2) * syn[kN + kOV - 1 - i2] + win(kOV - 1 - i2) * syn[kN + i2];
      }
      col[(long long)(kDBS - kN + i) * cap] = q12(v);
    }
  }
  if (tid < CC * kOrd)
    lpc_io[row * CC * kOrd + tid] = s.lpc[tid / kOrd][tid % kOrd];
  if (tid == 0) pitch[row] = T;
  if (chan >= 0) {
    // t = x + m, m <- kPre t over the channel's 960 samples, lane l on
    // [30 l, 30 l + 30): its own walk from m = 0, then the memory after
    // each lane, m_l = kPre^30 m_{l-1} + (lane l's end), by a shuffle
    // scan, then the walk again from the memory before it
    const float* x = s.syn[chan] + kSpan * lane;
    float xv[kSpan];
#pragma unroll
    for (int u = 0; u < kSpan; ++u) xv[u] = x[u];
    float m = 0.0f;
#pragma unroll
    for (int u = 0; u < kSpan; ++u) m = kPre * (xv[u] + m);
    const float m0 = (float)s.pre[chan] / 4096.0f;
    if (lane == 0) m = fmaf(kPreSpan, m0, m);
    float ad = kPreSpan;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float up = __shfl_up_sync(kAll, m, d);
      if (lane >= d) m = fmaf(ad, up, m);
      ad = ad * ad;
    }
    float mi = __shfl_up_sync(kAll, m, 1);
    if (lane == 0) mi = m0;
    int16_t* out = (int16_t*)s.b[chan] + kSpan * lane;    // exc_w is spent
#pragma unroll
    for (int u = 0; u < kSpan; ++u) {
      const float t = xv[u] + mi;
      mi = kPre * t;
      out[u] = (int16_t)fminf(fmaxf(rintf(t), -32768.0f), 32767.0f);
    }
    if (lane == 31) preemph[row * CC + chan] = (int32_t)rintf(mi * 4096.0f);
  }
  __syncthreads();
  // the PCM column, by every thread
  for (int k = tid; k < CC * kN; k += kThreads) {
    const int c = k / kN, i = k % kN;
    pcm[((long long)c * kN + i) * cap + row] = ((const int16_t*)s.b[c])[i];
  }
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
