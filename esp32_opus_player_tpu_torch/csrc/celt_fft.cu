// K1: the CELT inverse-MDCT core (pre-rotation, mixed-radix kiss FFT,
// post-rotation) over a batch of streams, int32 Q15, bit-exact; two
// entries.
//
// Replaces: esp32_opus_player_tpu/ops/celt/pallas_fft.py::fft_blocks_pallas
// (kernel body _make_kernel, static plan _plan) and, in the fused entry,
// the block loop and TDAC of jax_synthesis_T.celt_imdct_frame_T plus the
// per-stream select, clamp and decode_mem stores of
// jax_synthesis_T.celt_synth_step_dual_T (:221-233). Reference:
// clt_mdct_backward src/celt.cpp:3204-3296, opus_fft_impl :2997,
// kf_bfly* :2545-2930, the block loop :2057.
//
// celt_fft_blocks (the bare entry): one static plan for every stream.
// freq_T (n_freq, B) and the outputs yr, yi (rows, B) keep the transposed
// layout of the JAX path: FFT index on rows, streams contiguous. One block
// owns kStreams streams; its threads are (stream, butterfly lane), so
// every global access of a warp is a run of consecutive streams. Each
// stream's working set is rows x 2 int32 (3.75 KiB at rows = 480) and
// every stage touches all of it, so the FFT lives in shared memory from
// the gathered input to the post-rotated output. Kiss-FFT butterflies
// write the positions they read, so each stage runs in place with one
// barrier between stages.
//
// celt_imdct_tdac (the fused entry, what the CELT frame step runs): a
// whole frame's iMDCT of one channel, in place in decode_mem. Each stream
// runs only ITS plan (non-transient: one block of N4 = N/2; transient:
// 1 << LM blocks of N4 = 60; both have rows = N/2, so the tile has one
// shape), so the FFT work is half that of running both plans and
// selecting. What bounds it: the FFT's operations and, around them, one
// read of the spectrum and one write of N + 60 decode_mem rows. Design:
// - a block owns kTdacStreams contiguous streams; the staging and the
//   epilogue read and write rows of kTdacStreams streams (32 bytes), so
//   global memory stays coalesced without any permutation of streams;
// - each stream's FFT is one warp's, lanes across its butterflies: the
//   plan is warp-uniform, so two streams of a block with other flags
//   never serialise each other's stages; __syncwarp() between stages;
// - the tile is [stream][row]: a warp touches one stream's rows. The
//   stride-4 accesses of the last radix-4 stage (m = 1) go as one 16-byte
//   load and store per butterfly;
// - the twiddle table (3.75 KiB) and the window sit in shared memory;
// - the TDAC needs no chain across blocks: block b's mirror reads the
//   history (b = 0) or the previous block's raw post-rotated rows
//   [60, 120) (the TDAC leaves those untouched), and its own rows
//   [0, 60). So after the post-rotate interleave every output row is a
//   function of the tile alone and the epilogue runs on all threads at
//   once, one row of kTdacStreams streams per 8 lanes; it writes the N
//   finished rows clamped to +-SIG_SAT and the 60-row tail as it is.
//   The history rows are read into shared memory before any row is
//   written, and each stream's rows are its block's alone.
#include <cuda_runtime.h>

#include "celt_common.cuh"

using namespace otpu;

namespace {

constexpr int kStreams = 8;   // bare entry: streams per block (threadIdx.x)
constexpr int kLanes = 32;    // bare entry: butterfly lanes per stream
constexpr int kMaxStages = 6;
constexpr int kMaxRows = 480;
constexpr int kTwiddles = 480;  // (480, 2) kiss-FFT twiddle table

constexpr int kTdacStreams = 8;           // fused entry: streams per block
constexpr int kTdacThreads = 32 * kTdacStreams;   // one warp per stream
constexpr int kHalfOverlap = 60;
constexpr int32_t kSigSat = 300000000;

struct FftPlan {
  int rows;    // Bblk * N4
  int n4;      // FFT size
  int nstage;  // stages in execution order
  int p[kMaxStages], m[kMaxStages], fs[kMaxStages];
};

__device__ __forceinline__ void cmul(int32_t ar, int32_t ai, int2 b,
                                     int32_t& cr, int32_t& ci) {
  cr = wsub(smul(ar, b.x), smul(ai, b.y));
  ci = wadd(smul(ar, b.y), smul(ai, b.x));
}

// One kiss-FFT stage (radix p, m butterflies per group, twiddle stride
// fs) over rows points held at R[k * S], I[k * S], in place; lanes lane,
// lane + nlanes, ... take its butterflies. The caller syncs between
// stages.
template <int S>
__device__ __forceinline__ void kiss_stage(int32_t* R, int32_t* I, int rows,
                                           int p, int m, int fs,
                                           const int2* __restrict__ tw,
                                           int lane, int nlanes) {
  const int ngroups = rows / (p * m);
  if (p == 2) {
    // kf_bfly2 with m == 4 and the fixed sqrt(1/2) twiddle
    const int32_t t = 23170;
    for (int u = lane; u < ngroups * 4; u += nlanes) {
      const int k0 = (u >> 2) * 8 + (u & 3), k2 = k0 + 4;
      int32_t f2r = R[k2 * S], f2i = I[k2 * S], tr, ti;
      switch (u & 3) {
        case 0: tr = f2r; ti = f2i; break;
        case 1: tr = smul(wadd(f2r, f2i), t); ti = smul(wsub(f2i, f2r), t);
                break;
        case 2: tr = f2i; ti = wneg(f2r); break;
        default: tr = smul(wsub(f2i, f2r), t);
                 ti = smul(wneg(wadd(f2i, f2r)), t);
      }
      int32_t f0r = R[k0 * S], f0i = I[k0 * S];
      R[k0 * S] = wadd(f0r, tr); I[k0 * S] = wadd(f0i, ti);
      R[k2 * S] = wsub(f0r, tr); I[k2 * S] = wsub(f0i, ti);
    }
  } else if (p == 4 && m == 1) {
    for (int g = lane; g < ngroups; g += nlanes) {
      const int k = g * 4;
      int32_t r0, r1, r2, r3, i0, i1, i2, i3;
      if constexpr (S == 1) {
        // one 16-byte access per butterfly (stride-4 words otherwise)
        const int4 rv = reinterpret_cast<const int4*>(R)[g];
        const int4 iv = reinterpret_cast<const int4*>(I)[g];
        r0 = rv.x; r1 = rv.y; r2 = rv.z; r3 = rv.w;
        i0 = iv.x; i1 = iv.y; i2 = iv.z; i3 = iv.w;
      } else {
        r0 = R[k * S]; r1 = R[(k + 1) * S]; r2 = R[(k + 2) * S];
        r3 = R[(k + 3) * S];
        i0 = I[k * S]; i1 = I[(k + 1) * S]; i2 = I[(k + 2) * S];
        i3 = I[(k + 3) * S];
      }
      int32_t s0r = wsub(r0, r2), s0i = wsub(i0, i2);
      int32_t f0r = wadd(r0, r2), f0i = wadd(i0, i2);
      int32_t s1r = wadd(r1, r3), s1i = wadd(i1, i3);
      int32_t d1r = wsub(r1, r3), d1i = wsub(i1, i3);
      const int32_t o0r = wadd(f0r, s1r), o0i = wadd(f0i, s1i);
      const int32_t o1r = wadd(s0r, d1i), o1i = wsub(s0i, d1r);
      const int32_t o2r = wsub(f0r, s1r), o2i = wsub(f0i, s1i);
      const int32_t o3r = wsub(s0r, d1i), o3i = wadd(s0i, d1r);
      if constexpr (S == 1) {
        reinterpret_cast<int4*>(R)[g] = make_int4(o0r, o1r, o2r, o3r);
        reinterpret_cast<int4*>(I)[g] = make_int4(o0i, o1i, o2i, o3i);
      } else {
        R[k * S] = o0r; I[k * S] = o0i;
        R[(k + 1) * S] = o1r; I[(k + 1) * S] = o1i;
        R[(k + 2) * S] = o2r; I[(k + 2) * S] = o2i;
        R[(k + 3) * S] = o3r; I[(k + 3) * S] = o3i;
      }
    }
  } else if (p == 4) {
    for (int u = lane; u < ngroups * m; u += nlanes) {
      const int j = u % m, k = (u / m) * 4 * m + j;
      const int w = j * fs;
      int32_t s0r, s0i, s1r, s1i, s2r, s2i;
      cmul(R[(k + m) * S], I[(k + m) * S], tw[w], s0r, s0i);
      cmul(R[(k + 2 * m) * S], I[(k + 2 * m) * S], tw[2 * w], s1r, s1i);
      cmul(R[(k + 3 * m) * S], I[(k + 3 * m) * S], tw[3 * w], s2r, s2i);
      int32_t r0 = R[k * S], i0 = I[k * S];
      int32_t s5r = wsub(r0, s1r), s5i = wsub(i0, s1i);
      int32_t f0r = wadd(r0, s1r), f0i = wadd(i0, s1i);
      int32_t s3r = wadd(s0r, s2r), s3i = wadd(s0i, s2i);
      int32_t s4r = wsub(s0r, s2r), s4i = wsub(s0i, s2i);
      R[k * S] = wadd(f0r, s3r);           I[k * S] = wadd(f0i, s3i);
      R[(k + m) * S] = wadd(s5r, s4i);     I[(k + m) * S] = wsub(s5i, s4r);
      R[(k + 2 * m) * S] = wsub(f0r, s3r); I[(k + 2 * m) * S] = wsub(f0i, s3i);
      R[(k + 3 * m) * S] = wsub(s5r, s4i); I[(k + 3 * m) * S] = wadd(s5i, s4r);
    }
  } else if (p == 3) {
    const int32_t epi3i = -28378;
    for (int u = lane; u < ngroups * m; u += nlanes) {
      const int j = u % m, k = (u / m) * 3 * m + j;
      const int w = j * fs;
      int32_t s1r, s1i, s2r, s2i;
      cmul(R[(k + m) * S], I[(k + m) * S], tw[w], s1r, s1i);
      cmul(R[(k + 2 * m) * S], I[(k + 2 * m) * S], tw[2 * w], s2r, s2i);
      int32_t s3r = wadd(s1r, s2r), s3i = wadd(s1i, s2i);
      int32_t s0r = wsub(s1r, s2r), s0i = wsub(s1i, s2i);
      int32_t r0 = R[k * S], i0 = I[k * S];
      int32_t f1r = wsub(r0, s3r >> 1), f1i = wsub(i0, s3i >> 1);
      s0r = smul(s0r, epi3i);
      s0i = smul(s0i, epi3i);
      R[k * S] = wadd(r0, s3r);            I[k * S] = wadd(i0, s3i);
      R[(k + m) * S] = wsub(f1r, s0i);     I[(k + m) * S] = wadd(f1i, s0r);
      R[(k + 2 * m) * S] = wadd(f1r, s0i); I[(k + 2 * m) * S] = wsub(f1i, s0r);
    }
  } else {  // p == 5
    const int32_t yar = 10126, yai = -31164, ybr = -26510, ybi = -19261;
    for (int u = lane; u < ngroups * m; u += nlanes) {
      const int j = u % m, k = (u / m) * 5 * m + j;
      const int w = j * fs;
      int32_t s0r = R[k * S], s0i = I[k * S];
      int32_t s1r, s1i, s2r, s2i, s3r, s3i, s4r, s4i;
      cmul(R[(k + m) * S], I[(k + m) * S], tw[w], s1r, s1i);
      cmul(R[(k + 2 * m) * S], I[(k + 2 * m) * S], tw[2 * w], s2r, s2i);
      cmul(R[(k + 3 * m) * S], I[(k + 3 * m) * S], tw[3 * w], s3r, s3i);
      cmul(R[(k + 4 * m) * S], I[(k + 4 * m) * S], tw[4 * w], s4r, s4i);
      int32_t s7r = wadd(s1r, s4r), s7i = wadd(s1i, s4i);
      int32_t s10r = wsub(s1r, s4r), s10i = wsub(s1i, s4i);
      int32_t s8r = wadd(s2r, s3r), s8i = wadd(s2i, s3i);
      int32_t s9r = wsub(s2r, s3r), s9i = wsub(s2i, s3i);
      int32_t o0r = wadd(s0r, wadd(s7r, s8r));
      int32_t o0i = wadd(s0i, wadd(s7i, s8i));
      int32_t s5r = wadd(s0r, wadd(smul(s7r, yar), smul(s8r, ybr)));
      int32_t s5i = wadd(s0i, wadd(smul(s7i, yar), smul(s8i, ybr)));
      int32_t s6r = wadd(smul(s10i, yai), smul(s9i, ybi));
      int32_t s6i = wneg(wadd(smul(s10r, yai), smul(s9r, ybi)));
      int32_t s11r = wadd(s0r, wadd(smul(s7r, ybr), smul(s8r, yar)));
      int32_t s11i = wadd(s0i, wadd(smul(s7i, ybr), smul(s8i, yar)));
      int32_t s12r = wsub(smul(s9i, yai), smul(s10i, ybi));
      int32_t s12i = wsub(smul(s10r, ybi), smul(s9r, yai));
      R[k * S] = o0r;                        I[k * S] = o0i;
      R[(k + m) * S] = wsub(s5r, s6r);       I[(k + m) * S] = wsub(s5i, s6i);
      R[(k + 2 * m) * S] = wadd(s11r, s12r); I[(k + 2 * m) * S] = wadd(s11i, s12i);
      R[(k + 3 * m) * S] = wsub(s11r, s12r); I[(k + 3 * m) * S] = wsub(s11i, s12i);
      R[(k + 4 * m) * S] = wadd(s5r, s6r);   I[(k + 4 * m) * S] = wadd(s5i, s6i);
    }
  }
}

__global__ void __launch_bounds__(kStreams * kLanes)
fft_blocks_kernel(const int32_t* __restrict__ freq, int B,
                  int32_t* __restrict__ yr_out, int32_t* __restrict__ yi_out,
                  const int32_t* __restrict__ i1g,
                  const int32_t* __restrict__ i2g,
                  const int32_t* __restrict__ pre,
                  const int32_t* __restrict__ post,
                  const int2* __restrict__ tw, FftPlan plan) {
  __shared__ int32_t sr[kMaxRows * kStreams];
  __shared__ int32_t si[kMaxRows * kStreams];
  const int s = threadIdx.x;
  const int b = blockIdx.x * kStreams + s;
  const bool valid = b < B;
  const int rows = plan.rows;
  int32_t* R = sr + s;
  int32_t* I = si + s;

  // pre-rotation; the prerotate swap stores rbuf <- yi, ibuf <- yr
  for (int j = threadIdx.y; j < rows; j += kLanes) {
    int32_t xp1 = valid ? freq[(size_t)i1g[j] * B + b] : 0;
    int32_t xp2 = valid ? freq[(size_t)i2g[j] * B + b] : 0;
    int32_t t0 = pre[2 * j], t1 = pre[2 * j + 1];
    R[j * kStreams] = wsub(smul(xp1, t0), smul(xp2, t1));
    I[j * kStreams] = wadd(smul(xp2, t0), smul(xp1, t1));
  }
  __syncthreads();

  for (int st = 0; st < plan.nstage; ++st) {
    kiss_stage<kStreams>(R, I, rows, plan.p[st], plan.m[st], plan.fs[st],
                         tw, threadIdx.y, kLanes);
    __syncthreads();
  }

  // post-rotation: re <- ibuf, im <- rbuf
  if (valid) {
    for (int j = threadIdx.y; j < rows; j += kLanes) {
      int32_t re = I[j * kStreams], im = R[j * kStreams];
      int32_t p0 = post[2 * j], p1 = post[2 * j + 1];
      yr_out[(size_t)j * B + b] = wadd(smul(re, p0), smul(im, p1));
      yi_out[(size_t)j * B + b] = wsub(smul(re, p1), smul(im, p0));
    }
  }
}

// The fused entry's arguments. Plan 0 is the non-transient block
// structure (shift 3 - LM, one block of n4 = N/2), plan 1 the transient
// one (shift 3, 1 << LM blocks of n4 = 60); each has its gather rows as
// (i1g, i2g) pairs and its pre/post twiddles, (rows, 2) each, read as
// one 8-byte load a row.
struct TdacArgs {
  const int32_t* freq;       // (N, B) rows freq_stride apart
  long long freq_stride;
  int32_t* dcc;              // decode_mem of one channel, rows dcc_stride
  long long dcc_stride;      // apart; rows row0 .. row0 + N + 59 written
  const unsigned char* tr;   // (B,) transient flags (bool)
  int B, N, row0;
  const int2* tw;            // (480, 2) kiss-FFT twiddles
  const int32_t* window;     // (120,) window120
  const int2* gather[2];
  const int2* pre[2];
  const int2* post[2];
  int nstage[2];
  int stage[2][kMaxStages][3];   // (p, m, fs) in execution order
};

__host__ __device__ constexpr int tdac_x_stride(int N) {
  // a stream's spectrum / output row: >= N words, = 4 mod 32, so that the
  // staging and the epilogue (8 streams x 4 rows a warp) hit 32 banks
  return (N + 31) / 32 * 32 + 4;
}

__host__ __device__ constexpr int tdac_smem_words(int N) {
  return 2 * kTwiddles + 120 + kTdacStreams * kHalfOverlap + kTdacStreams +
         kTdacStreams * tdac_x_stride(N) + 2 * kTdacStreams * (N / 2);
}

__global__ void __launch_bounds__(kTdacThreads)
imdct_tdac_kernel(const TdacArgs a) {
  extern __shared__ __align__(16) int32_t sm[];
  constexpr int T = kTdacThreads, S = kTdacStreams;
  const int N = a.N, rows = N >> 1, xs = tdac_x_stride(N);
  int2* tw_s = reinterpret_cast<int2*>(sm);
  int32_t* win_s = sm + 2 * kTwiddles;
  int32_t* hist_s = win_s + 120;                 // [stream][60]
  int32_t* flag_s = hist_s + S * kHalfOverlap;   // [stream]
  int32_t* X = flag_s + S;                       // [stream][xs]
  int32_t* Rs = X + S * xs;                      // [stream][rows]
  int32_t* Is = Rs + S * rows;
  const int tid = threadIdx.x, b0 = blockIdx.x * S;
  const int ns = min(S, a.B - b0);
  const int sc = tid % S;          // the stream of this thread's columns

  // 1. stage the tables, the flags, the spectrum and the history: rows of
  //    S consecutive streams, several loads in flight per thread
  for (int i = tid; i < kTwiddles; i += T) tw_s[i] = a.tw[i];
  for (int i = tid; i < 120; i += T) win_s[i] = a.window[i];
  if (tid < S) flag_s[tid] = tid < ns ? (a.tr[b0 + tid] != 0) : 0;
  {
    constexpr int U = 8;
    const int n = N * S;
    for (int base = tid; base < n; base += T * U) {
      int32_t v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = base + u * T;
        v[u] = (i < n && sc < ns)
            ? __ldg(a.freq + (size_t)(i / S) * a.freq_stride + b0 + sc) : 0;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = base + u * T;
        if (i < n) X[sc * xs + i / S] = v[u];
      }
    }
  }
  for (int i = tid; i < kHalfOverlap * S; i += T)
    hist_s[sc * kHalfOverlap + i / S] = sc < ns
        ? a.dcc[(size_t)(a.row0 + i / S) * a.dcc_stride + b0 + sc] : 0;
  __syncthreads();

  // 2. warp w: stream w's iMDCT by its own plan, in shared memory
  {
    const int w = tid >> 5, lane = tid & 31;
    const int pl = flag_s[w];
    const int2* __restrict__ gather = a.gather[pl];
    const int2* __restrict__ pre = a.pre[pl];
    const int2* __restrict__ post = a.post[pl];
    int32_t* x = X + w * xs;
    int32_t* R = Rs + w * rows;
    int32_t* I = Is + w * rows;
    // pre-rotation (gather in bitrev order); rbuf <- yi, ibuf <- yr
    for (int j = lane; j < rows; j += 32) {
      const int2 g = __ldg(gather + j), t = __ldg(pre + j);
      const int32_t xp1 = x[g.x], xp2 = x[g.y];
      R[j] = wsub(smul(xp1, t.x), smul(xp2, t.y));
      I[j] = wadd(smul(xp2, t.x), smul(xp1, t.y));
    }
    __syncwarp();
    for (int st = 0; st < a.nstage[pl]; ++st) {
      kiss_stage<1>(R, I, rows, a.stage[pl][st][0], a.stage[pl][st][1],
                    a.stage[pl][st][2], tw_s, lane, 32);
      __syncwarp();
    }
    // post-rotation (re <- ibuf, im <- rbuf) and the interleave of each
    // block of n4 points (60 when transient, else all rows): out[2i] =
    // yr[i], out[2 n4 - 1 - 2i] = yi[i], over this stream's spectrum,
    // which no thread reads any more
    const int n4 = pl ? 60 : rows;
    for (int j = lane; j < rows; j += 32) {
      const int blk = pl ? j / 60 : 0, i = j - blk * n4;
      const int32_t re = I[j], im = R[j];
      const int2 t = __ldg(post + j);
      x[2 * blk * n4 + 2 * i] = wadd(smul(re, t.x), smul(im, t.y));
      x[2 * blk * n4 + 2 * n4 - 1 - 2 * i] = wsub(smul(re, t.y),
                                                  smul(im, t.x));
    }
  }
  __syncthreads();

  // 3. the TDAC mirror, clamp and stores, every output row at once:
  //    region row r of a stream with nb samples a block (N, or 120 when
  //    transient), block blk = r / nb, rr = r - blk nb:
  //    - rr < 120: the mirror of hist_b (the history for blk 0, else the
  //      previous block's out[60 + k] = x[blk nb - 60 + k]) against
  //      out_b[59 - k] = x[blk nb + 59 - k], k = rr or 119 - rr;
  //    - otherwise, and for the tail rows r >= N: x[r - 60].
  if (sc < ns) {
    const int32_t* x = X + sc * xs;
    const int32_t* hist = hist_s + sc * kHalfOverlap;
    const bool transient = flag_s[sc] != 0;
    const int nb = transient ? 120 : N;
    int32_t* out = a.dcc + (size_t)a.row0 * a.dcc_stride + b0 + sc;
#pragma unroll 4
    for (int r = tid / S; r < N + kHalfOverlap; r += T / S) {
      int32_t v;
      const int blk = transient ? r / 120 : 0, rr = r - blk * nb;
      if (r >= N || rr >= 120) {
        v = x[r - kHalfOverlap];
      } else {
        const int k = rr < kHalfOverlap ? rr : 119 - rr;
        const int32_t x2 = blk == 0 ? hist[k] : x[blk * nb - 60 + k];
        const int32_t x1 = x[blk * nb + 59 - k];
        const int32_t w1 = win_s[k], w2 = win_s[119 - k];
        v = rr < kHalfOverlap ? wsub(smul(x2, w2), smul(x1, w1))
                              : wadd(smul(x2, w1), smul(x1, w2));
      }
      out[(size_t)r * a.dcc_stride] =
          r < N ? clamp32(v, -kSigSat, kSigSat) : v;
    }
  }
}

}  // namespace

// stages: nstage rows of (p, m, fs) in execution order, host memory.
// Tables are device pointers: i1g, i2g (rows,), pre and post (rows, 2),
// tw the (480, 2) kiss-FFT twiddle table. Returns cudaGetLastError().
extern "C" int celt_fft_blocks(const int32_t* freq, int B, int32_t* yr,
                               int32_t* yi, const int32_t* i1g,
                               const int32_t* i2g, const int32_t* pre,
                               const int32_t* post, const int32_t* tw,
                               int rows, int n4, int nstage,
                               const int32_t* stages, void* stream) {
  if (rows > kMaxRows || nstage > kMaxStages || B <= 0)
    return (int)cudaErrorInvalidValue;
  FftPlan plan;
  plan.rows = rows;
  plan.n4 = n4;
  plan.nstage = nstage;
  for (int k = 0; k < nstage; ++k) {
    plan.p[k] = stages[3 * k];
    plan.m[k] = stages[3 * k + 1];
    plan.fs[k] = stages[3 * k + 2];
  }
  dim3 block(kStreams, kLanes);
  dim3 grid((B + kStreams - 1) / kStreams);
  fft_blocks_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      freq, B, yr, yi, i1g, i2g, pre, post,
      reinterpret_cast<const int2*>(tw), plan);
  return (int)cudaGetLastError();
}

// One channel's frame iMDCT, in place. freq: (N, B) int32, rows
// freq_stride apart (elements); dcc: that channel's decode_mem (>= row0 +
// N + 60 rows of B columns, dcc_stride apart), whose rows row0 .. row0 +
// 59 hold the history and rows row0 .. row0 + N + 59 are written; tr:
// (B,) bool. tables: 6 device pointers, the (rows, 2) tables gather
// (i1g, i2g), pre and post of plan 0 (non-transient, one block of N/2)
// then of plan 1 (transient, blocks of 60); stages: host memory, per plan
// nstage, then kMaxStages rows of (p, m, fs). Returns
// cudaGetLastError().
extern "C" int celt_imdct_tdac(const int32_t* freq, long long freq_stride,
                               int32_t* dcc, long long dcc_stride,
                               const unsigned char* tr, int B, int N,
                               int row0, const int32_t* tw,
                               const int32_t* window,
                               const int32_t* const* tables,
                               const int32_t* stages, void* stream) {
  if (B <= 0 || (N != 120 && N != 240 && N != 480 && N != 960))
    return (int)cudaErrorInvalidValue;
  TdacArgs a;
  a.freq = freq;
  a.freq_stride = freq_stride;
  a.dcc = dcc;
  a.dcc_stride = dcc_stride;
  a.tr = tr;
  a.B = B;
  a.N = N;
  a.row0 = row0;
  a.tw = reinterpret_cast<const int2*>(tw);
  a.window = window;
  for (int pl = 0; pl < 2; ++pl) {
    const int32_t* st = stages + pl * (1 + 3 * kMaxStages);
    a.gather[pl] = reinterpret_cast<const int2*>(tables[3 * pl]);
    a.pre[pl] = reinterpret_cast<const int2*>(tables[3 * pl + 1]);
    a.post[pl] = reinterpret_cast<const int2*>(tables[3 * pl + 2]);
    a.nstage[pl] = st[0];
    if (st[0] > kMaxStages) return (int)cudaErrorInvalidValue;
    for (int k = 0; k < kMaxStages; ++k)
      for (int q = 0; q < 3; ++q) a.stage[pl][k][q] = st[1 + 3 * k + q];
  }
  const int smem = tdac_smem_words(N) * (int)sizeof(int32_t);
  static int smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        imdct_tdac_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    smem_allowed = smem;
  }
  imdct_tdac_kernel<<<(B + kTdacStreams - 1) / kTdacStreams, kTdacThreads,
                      smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
