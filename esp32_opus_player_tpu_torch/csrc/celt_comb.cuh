// The comb postfilter (reference comb_filter, src/celt.cpp:848) of one
// CELT frame as K2 (celt_comb.cu) and K4 (celt_comb_deemph.cu) run it: the
// per-stream derived parameters, the arithmetic of one output sample, and
// the tile kernel both launch, comb_tile_kernel<kDeemph>: K2's walk from
// a shared-memory tile with a warp per stream (celt_comb.cu says why it
// has that shape), and with kDeemph the deemphasis over the rows it wrote
// as its epilogue (K4).
#pragma once
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "celt_common.cuh"

namespace otpu {

constexpr int kOverlap = 120;
constexpr int kMinPeriod = 15;
constexpr int kMaxPeriod = 1024;
constexpr int32_t kSigSat = 300000000;

// One comb_filter call's parameters for one stream: lags clamped to
// [15, 1024], tapsets to [0, 2], the three tap gains of both parameter
// sets.
struct CombPar {
  int T0, T1;
  int32_t g00, g01, g02, g10, g11, g12;
  bool nop;    // both gains 0: the call changes nothing
  bool same;   // unchanged parameters: no crossfade
  bool g1z;    // new gain 0: nothing changes past the crossfade
};

// The six raw parameters of one stream (T0, T1, g0, g1, tapset0, tapset1);
// gains: the (3, 3) tapset gain table.
__device__ __forceinline__ CombPar comb_par(int32_t T0, int32_t T1,
                                            int32_t g0, int32_t g1,
                                            int32_t tapset0, int32_t tapset1,
                                            const int32_t* __restrict__ gains) {
  CombPar p;
  p.T0 = min(max(T0, kMinPeriod), kMaxPeriod);
  p.T1 = min(max(T1, kMinPeriod), kMaxPeriod);
  const int tap0 = min(max(tapset0, 0), 2);
  const int tap1 = min(max(tapset1, 0), 2);
  p.nop = g0 == 0 && g1 == 0;
  p.same = g0 == g1 && p.T0 == p.T1 && tap0 == tap1;
  p.g1z = g1 == 0;
  // MULT16_16_P15(g, gain): 16-bit operands, the product fits int32
  p.g00 = (16384 + g0 * gains[3 * tap0]) >> 15;
  p.g01 = (16384 + g0 * gains[3 * tap0 + 1]) >> 15;
  p.g02 = (16384 + g0 * gains[3 * tap0 + 2]) >> 15;
  p.g10 = (16384 + g1 * gains[3 * tap1]) >> 15;
  p.g11 = (16384 + g1 * gains[3 * tap1 + 1]) >> 15;
  p.g12 = (16384 + g1 * gains[3 * tap1 + 2]) >> 15;
  return p;
}

// One sample inside the crossfade: f = window^2 >> 15 at the in-call
// index; a0..a4 the taps at pos - T0 + {-2..2}, c0..c4 at pos - T1 + {-2..2}.
__device__ __forceinline__ int32_t comb_xfade(
    const CombPar& p, int32_t f, int32_t x, int32_t a0, int32_t a1,
    int32_t a2, int32_t a3, int32_t a4, int32_t c0, int32_t c1, int32_t c2,
    int32_t c3, int32_t c4) {
  const int32_t fa = 32767 - f;
  int32_t y = wadd(x, smul(a2, mult16_16_q15(fa, p.g00)));
  y = wadd(y, smul(wadd(a3, a1), mult16_16_q15(fa, p.g01)));
  y = wadd(y, smul(wadd(a4, a0), mult16_16_q15(fa, p.g02)));
  y = wadd(y, smul(c2, mult16_16_q15(f, p.g10)));
  y = wadd(y, smul(wadd(c3, c1), mult16_16_q15(f, p.g11)));
  y = wadd(y, smul(wadd(c4, c0), mult16_16_q15(f, p.g12)));
  return clamp32(y, -kSigSat, kSigSat);
}

// One sample past the crossfade (comb_filter_const): the new parameters
// with the raw gains.
__device__ __forceinline__ int32_t comb_const(const CombPar& p, int32_t x,
                                              int32_t c0, int32_t c1,
                                              int32_t c2, int32_t c3,
                                              int32_t c4) {
  int32_t y = wadd(x, smul(c2, p.g10));
  y = wadd(y, smul(wadd(c3, c1), p.g11));
  y = wadd(y, smul(wadd(c4, c0), p.g12));
  return clamp32(y, -kSigSat, kSigSat);
}

constexpr int kTileStreams = 8;    // K2's streams a block (a warp each)
constexpr int kDeemphStreams = 16; // K4's (one block an SM: one walker)

// The 12 parameter vectors of a frame (comb1 then comb2, each T0, T1, g0,
// g1, tapset0, tapset1), each B values `stride` elements apart: the caller's
// own tensors, whatever they are columns of.
struct CombRows {
  const int32_t* p[12];
  long long stride[12];
};

__device__ __forceinline__ CombPar comb_par_rows(
    const CombRows& rows, int first, int b,
    const int32_t* __restrict__ gains) {
  int32_t v[6];
#pragma unroll
  for (int i = 0; i < 6; ++i)
    v[i] = rows.p[first + i][(size_t)b * rows.stride[first + i]];
  return comb_par(v[0], v[1], v[2], v[3], v[4], v[5], gains);
}

// the smallest stride >= rows that is 4 modulo 32
inline __host__ __device__ int tile_stride(int rows) {
  return (rows + 27) / 32 * 32 + 4;
}

// One comb_filter call over x[0, n) of one stream's tile row (x[-k] is
// the sample k rows back), by the 32 lanes of the stream's warp.
__device__ __forceinline__ void comb_region_tile(
    int32_t* x, int n, const CombPar& p, const int32_t* __restrict__ ftab,
    int lane) {
  if (p.nop) return;
  const int n_end = p.g1z ? min(n, kOverlap) : n;
  const int n_ov = p.same ? 0 : min(n_end, kOverlap);
  int ch = min(32, min(p.T0, p.T1) - 2);
  for (int c0 = 0; c0 < n_ov; c0 += ch) {
    const int i = c0 + lane;
    if (lane < ch && i < n_ov) {
      const int32_t* a = x + i - p.T0;
      const int32_t* c = x + i - p.T1;
      x[i] = comb_xfade(p, ftab[i], x[i], a[-2], a[-1], a[0], a[1], a[2],
                        c[-2], c[-1], c[0], c[1], c[2]);
    }
    __syncwarp();
  }
  ch = min(32, p.T1 - 2);
  for (int c0 = n_ov; c0 < n_end; c0 += ch) {
    const int i = c0 + lane;
    if (lane < ch && i < n_end) {
      const int32_t* c = x + i - p.T1;
      x[i] = comb_const(p, x[i], c[-2], c[-1], c[0], c[1], c[2]);
    }
    __syncwarp();
  }
}

// K4's epilogue: the deemphasis chain (K3's body at downsample 1, K3's
// arithmetic: celt_deemph.cu) over one stream's n comb outputs x[0, n),
// by one lane: each sum tmp into out[k * stride] (its rounding to int16
// is left to the write-out, off the chain), the memory returned. A
// group's samples come into registers a group ahead of the stores, and a
// whole group is walked with no guard per sample.
__device__ __forceinline__ int32_t deemph_walk(const int32_t* x, int n,
                                               int32_t m, int32_t* out,
                                               int stride) {
  constexpr int kGroup = 8;
  auto step = [&](int k, int32_t xk) {
    const int32_t tmp = wadd(xk, m);
    m = wadd(__mulhi(tmp, kPreemphHi), tmp);     // smul(tmp, kPreemph)
    out[k * stride] = tmp;
  };
  int k = 0;
  if (n >= kGroup) {
    int32_t nx[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) nx[u] = x[u];
    for (; k + kGroup <= n; k += kGroup) {
      int32_t cur[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) cur[u] = nx[u];
      if (k + 2 * kGroup <= n) {
#pragma unroll
        for (int u = 0; u < kGroup; ++u) nx[u] = x[k + kGroup + u];
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u) step(k + u, cur[u]);
    }
  }
  for (; k < n; ++k) step(k, x[k]);
  return m;
}

}  // namespace otpu

// The tile kernel and its launch have internal linkage: each source that
// includes this header (K2's, K4's) has its own, and so its own record of
// the shared memory it has allowed, even when several builds of the
// library are loaded in one process (tools/kernel_variants.py).
namespace {

using namespace otpu;

// K2 (kDeemph false) and K4 (true): the streams a block.
template <bool kDeemph>
constexpr int kStreams = kDeemph ? kDeemphStreams : kTileStreams;

// Both comb_filter calls of a frame over rows [start, start+N) of a block
// of S = kStreams<kDeemph> streams (a warp each), in place (K2); with
// kDeemph, then the deemphasis of those rows from mem_in into pcm (N, B)
// int16 and mem_out (K4). The tile: S rows of `stride` int32 (the
// stream's rows [start - hist, start + N)), then with kDeemph N rows of S
// int32 deemphasis sums.
template <bool kDeemph>
__global__ void __launch_bounds__(32 * kStreams<kDeemph>)
comb_tile_kernel(int32_t* __restrict__ buf, int B, int start, int N,
                 const CombRows rows, const int32_t* __restrict__ ftab,
                 const int32_t* __restrict__ gains, int stride,
                 const int32_t* __restrict__ mem_in,
                 int32_t* __restrict__ mem_out, int16_t* __restrict__ pcm) {
  constexpr int S = kStreams<kDeemph>;
  constexpr int kThreads = 32 * S, kRowsPerPass = kThreads / S;   // 32
  extern __shared__ int32_t tile[];          // S x stride
  __shared__ int need[S];
  const int b0 = blockIdx.x * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n1 = min(kOverlap, N);

  // the walker's parameters; how much history its stream needs
  const bool live = b0 + warp < B;
  CombPar p1, p2;
  p1.nop = p2.nop = true;
  int reach = 0;
  if (live) {
    p1 = comb_par_rows(rows, 0, b0 + warp, gains);
    if (N > n1) p2 = comb_par_rows(rows, 6, b0 + warp, gains);
    if (!p1.nop) reach = max(p1.T0, p1.T1) + 2;
    if (!p2.nop) reach = max(reach, max(p2.T0, p2.T1) + 2);
  }
  if (lane == 0) need[warp] = reach;
  __syncthreads();
  int hist = 0;
#pragma unroll
  for (int s = 0; s < S; ++s) hist = max(hist, need[s]);
  // a block whose streams are all no-ops: K2 has nothing to do; K4 stages
  // only the frame's rows, for the deemphasis
  if (!kDeemph && hist == 0) return;

  // stage rows [start - hist, start + N): S streams x 32 rows a pass
  const int s = threadIdx.x % S;
  const int r0 = threadIdx.x / S;
  const int n_rows = hist + N;
  const bool mine = b0 + s < B;
  int32_t* g = buf + (size_t)(start - hist) * B + b0 + s;
  int32_t* t = tile + s * stride;
  if (mine)
    for (int r = r0; r < n_rows; r += kRowsPerPass)
      __pipeline_memcpy_async(t + r, g + (size_t)r * B, 4);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  if (live) {
    int32_t* x = tile + warp * stride + hist;
    comb_region_tile(x, n1, p1, ftab, lane);
    if (N > n1) comb_region_tile(x + n1, N - n1, p2, ftab, lane);
  }
  __syncthreads();

  if constexpr (!kDeemph) {
    if (mine)
      for (int r = hist + r0; r < n_rows; r += kRowsPerPass)
        g[(size_t)r * B] = t[r];
  } else {
    // lane s of warp 0 walks stream s's deemphasis chain (one warp for
    // the tile's streams, as K3: the walks take one warp's issue slots,
    // not S warps'), while the other warps write the comb's rows back;
    // then every thread rounds the sums to int16 and writes the PCM rows
    int32_t* dtile = tile + S * stride;
    if (warp == 0) {
      if (lane < S && b0 + lane < B)
        mem_out[b0 + lane] = deemph_walk(tile + lane * stride + hist, N,
                                         mem_in[b0 + lane], dtile + lane, S);
    } else if (mine && hist > 0) {
      constexpr int kBackRows = (kThreads - 32) / S;
      for (int r = hist + r0 - 32 / S; r < n_rows; r += kBackRows)
        g[(size_t)r * B] = t[r];
    }
    __syncthreads();
    int16_t* out = pcm + b0 + s;
    if (mine)
      for (int r = r0; r < N; r += kRowsPerPass)
        out[(size_t)r * B] = (int16_t)clamp32(
            wadd(dtile[r * S + s], 2048) >> 12, -32768, 32767);
  }
}

// The bytes of dynamic shared memory a K2 or K4 block takes at N.
template <bool kDeemph>
inline int comb_tile_smem(int N) {
  return kStreams<kDeemph> * (tile_stride(kMaxPeriod + 2 + N) +
                              (kDeemph ? N : 0)) * 4;
}

// Launch comb_tile_kernel<kDeemph> over B streams (the dynamic shared
// memory above 48 KB allowed first); returns the CUDA error.
template <bool kDeemph>
int launch_comb_tile(int32_t* buf, int B, int start, int N,
                     const int32_t* const* par, const long long* par_stride,
                     const int32_t* ftab, const int32_t* gains,
                     const int32_t* mem_in, int32_t* mem_out, int16_t* pcm,
                     cudaStream_t stream) {
  constexpr int S = kStreams<kDeemph>;
  if (B <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  CombRows rows;
  for (int i = 0; i < 12; ++i) {
    rows.p[i] = par[i];
    rows.stride[i] = par_stride[i];
  }
  const int smem = comb_tile_smem<kDeemph>(N);
  static int smem_allowed = 0;
  if (smem > smem_allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        comb_tile_kernel<kDeemph>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_allowed = smem;
  }
  comb_tile_kernel<kDeemph><<<(B + S - 1) / S, 32 * S, smem, stream>>>(
      buf, B, start, N, rows, ftab, gains, tile_stride(kMaxPeriod + 2 + N),
      mem_in, mem_out, pcm);
  return (int)cudaGetLastError();
}

}  // namespace
