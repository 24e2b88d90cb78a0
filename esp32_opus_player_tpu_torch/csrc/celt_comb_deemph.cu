// K4: both comb-postfilter calls of one CELT frame, then the deemphasis
// IIR over the rows they wrote, one channel, one launch.
//
// Replaces: esp32_opus_player_tpu/ops/celt/pallas_comb.py::comb_deemph_step_T
// (kernel _make_comb_deemph_kernel). Reference: comb_filter src/celt.cpp:848
// (called at :2385-2389), deemphasis :1988 at downsample 1.
//
// Layout: buf (L, B) int32, time on rows, streams contiguous, updated in
// place over rows [start, start+N); the 12 parameter vectors as K2 reads
// them (a pointer and an element stride each); mem_in, mem_out (B,)
// int32; pcm (N, B) int16.
//
// Tile and threads: K2's tile kernel (celt_comb.cu; comb_tile_kernel<true>
// in celt_comb.cuh): a warp a stream, rows [start - hist, start + N)
// staged with 4-byte cp.async, transposed at a stride 4 mod 32, the comb
// walked in chunks of min(32, lag - 2) by the stream's lanes. After a
// block barrier, lane s of warp 0 walks stream s's deemphasis chain over
// its N tile samples as K3 walks (the product as a high word, the samples
// a group of 8 ahead in registers, no guard per sample), each sum into a
// shared int32 tile, while the other warps write the comb's rows back;
// after a second barrier every thread rounds the sums to int16 and
// writes the PCM rows. kDeemphStreams = 16 streams a block (512 threads,
// 16 x (1988 + 960) x 4 B = 189 KB of shared memory at N 960): one block
// an SM, so one walking warp an SM (tools/kernel_variants.py k4 times 8
// and 4; PERF.md). Two walks on a sub-partition made the chain
// issue-bound: a walk by lane 0 of each stream's own warp, with the
// rounding inside the chain, took 0.0515 ms at N 960. A block whose
// streams are all no-ops stages only [start, start + N) and writes back
// only the PCM.
//
// What bounds it: the bytes (K2's plus the PCM, each read or written
// once), ~7.9 us at N 960 and 3.35 TB/s; the deemphasis chain after the
// comb's chunks has a floor of 8 cycles a sample (K3's two dependent
// instructions, celt_deemph.cu), 3.9 us at N 960 and 1980 MHz, and is
// walked at ~24 cycles a sample (PERF.md). The fusion saves K3's launch
// and its read of the rows. As in the JAX package, no path calls it: the
// CELT frame step runs K2 and K3 apart (PERF.md has K4 against K2 then K3
// at each frame size).
#include <cuda_runtime.h>

#include "celt_comb.cuh"

using namespace otpu;

// buf: (L, B) int32, updated in place over rows [start, start+N);
// start >= MAX_PERIOD + 2 and start + N <= L are the caller's to check.
// par, par_stride, ftab, gains: as celt_comb_step. mem_in, mem_out: (B,)
// int32 (may not alias); pcm: (N, B) int16. Returns the CUDA error of the
// launch.
extern "C" int celt_comb_deemph(int32_t* buf, int B, int start, int N,
                                const int32_t* const* par,
                                const long long* par_stride,
                                const int32_t* ftab, const int32_t* gains,
                                const int32_t* mem_in, int32_t* mem_out,
                                int16_t* pcm, void* stream) {
  return launch_comb_tile<true>(buf, B, start, N, par, par_stride, ftab,
                                gains, mem_in, mem_out, pcm,
                                (cudaStream_t)stream);
}
