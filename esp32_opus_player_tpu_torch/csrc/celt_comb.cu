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
// Tile and threads (comb_tile_kernel<false>, celt_comb.cuh, which K4
// shares): a block owns kTileStreams = 8 adjacent streams, so a row of its
// tile is one 32-byte sector of buf, and has 8 warps, one per stream. It
// stages rows [start - hist, start + N) of its 8 columns into shared
// memory with 4-byte cp.async copies (hist = the largest lag of
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
#include <cuda_runtime.h>

#include "celt_comb.cuh"

using namespace otpu;

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
  return launch_comb_tile<false>(buf, B, start, N, par, par_stride, ftab,
                                 gains, nullptr, nullptr, nullptr,
                                 (cudaStream_t)stream);
}
