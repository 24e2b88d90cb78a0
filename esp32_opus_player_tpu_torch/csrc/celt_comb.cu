// K2: both comb-postfilter calls of one CELT frame, in place, int32.
//
// Replaces: esp32_opus_player_tpu/ops/celt/pallas_comb.py::comb_filter_step_T
// (kernel _make_comb_kernel / _comb_region, launched by _run_comb).
// Reference: comb_filter src/celt.cpp:848, called twice per frame at
// :2385-2389.
//
// Layout: buf (L, B) int32, time on rows, streams contiguous. Region 1 is
// rows [start, start+120) with the crossfade (T0, g0, tap0) -> (T1, g1,
// tap1) of parameter vectors 0..5; region 2 is [start+120, start+N) with
// vectors 6..11, and its own 120-sample crossfade. The 12 parameter
// vectors are read where the caller has them (a pointer and an element
// stride each: the pool passes columns of its staging rows), so the call
// is this one launch.
//
// Tile and threads: a block owns kTileStreams = 8 adjacent streams, so a
// row of its tile is one 32-byte sector of buf, and has 8 warps, one per
// stream. It stages rows [start - hist, start + N) of its 8 columns into
// shared memory with 4-byte cp.async copies (hist = the largest lag of
// its streams + 2, at most 1026; a block whose streams are all no-ops
// returns before it stages anything), transposed so that one stream's
// samples are contiguous, the stream stride being 4 modulo 32 words: the
// 32 lanes of a staging access (8 streams x 4 rows) and of a walking
// access (32 consecutive samples of one stream) each fall on 32 different
// banks. Rows [start, start + N) go back the same way, a sector per row;
// a stream that a region leaves alone (both gains 0, or the new gain 0
// past the crossfade) gets its staged values back bit for bit. The ragged
// edge (B not a multiple of 8) is masked in staging, walk and write-back.
// Shared memory per block: 8 x 1988 x 4 B = 63.6 KB at N = 960 (dynamic,
// above the 48 KB default: cudaFuncAttributeMaxDynamicSharedMemorySize),
// three blocks to an SM; B = 2048 is 256 blocks of 256 threads, B = 1024
// is 128. Registers: 40 a thread (ptxas -v, printed by chip_smoke.py);
// the tile, not the registers, limits the occupancy.
//
// The walk: a 5-tap feedback recurrence at a per-stream lag T in
// 15..1024 is sequential in time only at distance T - 2 and more: every
// tap of sample pos lies at pos - T + 2 or earlier. So the lanes of the
// stream's warp take the consecutive samples of a chunk of
// min(32, min(T0, T1) - 2) samples in the crossfade and min(32, T1 - 2)
// after it (at least 13), with __syncwarp() between chunks: every tap a
// chunk reads is a value finished in an earlier chunk (or history), which
// is the value the reference's sample-by-sample walk reads, so the bits
// are the reference's whatever the chunk length. Region 2 starts after
// region 1 has ended (its taps may reach into region 1's output). The TPU
// kernel walks fixed chunks of 13 for the same reason (Mosaic has no
// per-lane dynamic index; a warp reads tile[pos - T] directly).
//
// What bounds it: the bytes. At (N 960, B 2048) with random lags it
// reads ~16 MB and writes ~8 MB (22.5 MB by chip_smoke.py's count, 6.7 us
// at 3.35 TB/s) while the walk is 30-74 chunk steps from shared memory.
// On an H100 80GB HBM3 at 700 W chip_smoke.py times the call at 0.020 ms
// (an empty graph replay, the floor of that method: 0.0015-0.0044 ms) and
// the profiler reads 0.0145 ms a call in the mono pool; one thread per
// stream through global memory took 0.288 ms (PERF.md).
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "celt_comb.cuh"

using namespace otpu;

namespace {

constexpr int kTileStreams = 8;
constexpr int kThreads = 32 * kTileStreams;
constexpr int kRowsPerPass = kThreads / kTileStreams;

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

__global__ void __launch_bounds__(kThreads)
comb_step_kernel(int32_t* __restrict__ buf, int B, int start, int N,
                 const CombRows rows, const int32_t* __restrict__ ftab,
                 const int32_t* __restrict__ gains, int stride) {
  extern __shared__ int32_t tile[];          // kTileStreams x stride
  __shared__ int need[kTileStreams];
  const int b0 = blockIdx.x * kTileStreams;
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
  for (int s = 0; s < kTileStreams; ++s) hist = max(hist, need[s]);
  if (hist == 0) return;                     // the whole block: no-ops

  // stage rows [start - hist, start + N): 8 streams x 4 rows per warp
  const int s = threadIdx.x % kTileStreams;
  const int r0 = threadIdx.x / kTileStreams;
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

  if (mine)
    for (int r = hist + r0; r < n_rows; r += kRowsPerPass)
      g[(size_t)r * B] = t[r];
}

}  // namespace

// buf: (L, B) int32, updated in place over rows [start, start+N);
// start >= MAX_PERIOD + 2 and start + N <= L are the caller's to check.
// par, par_stride: 12 vectors of B int32 = comb1 then comb2, each (T0, T1,
// g0, g1, tapset0, tapset1), and the element stride of each. ftab: 120
// crossfade factors (window^2 >> 15); gains: the (3, 3) tapset gain table.
// Returns the CUDA error of the launch (an N whose tile does not fit a
// block's shared memory is refused here).
extern "C" int celt_comb_step(int32_t* buf, int B, int start, int N,
                              const int32_t* const* par,
                              const long long* par_stride,
                              const int32_t* ftab, const int32_t* gains,
                              void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  CombRows rows;
  for (int i = 0; i < 12; ++i) {
    rows.p[i] = par[i];
    rows.stride[i] = par_stride[i];
  }
  const int stride = tile_stride(kMaxPeriod + 2 + N);
  const int smem = kTileStreams * stride * (int)sizeof(int32_t);
  static int smem_allowed = 0;
  if (smem > smem_allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        comb_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_allowed = smem;
  }
  comb_step_kernel<<<(B + kTileStreams - 1) / kTileStreams, kThreads, smem,
                     (cudaStream_t)stream>>>(buf, B, start, N, rows, ftab,
                                             gains, stride);
  return (int)cudaGetLastError();
}
