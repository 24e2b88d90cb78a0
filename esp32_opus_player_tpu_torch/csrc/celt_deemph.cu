// K3: the CELT deemphasis IIR with Q12 rounding to int16 PCM.
//
// Replaces: esp32_opus_player_tpu/ops/celt/pallas_kernels.py::_deemph_kernel
// as launched by ops/celt/jax_synthesis_T.py::deemphasis_T. Reference:
// deemphasis src/celt.cpp:1988 (downsample: scratch-then-decimate,
// :2000-2013).
//
// Layout: syn (CC, N, B) int32 with streams contiguous (a strided view of
// decode_mem is fine: rows are B apart, channels cc_stride apart); mem
// (B, CC) int32; pcm (CC, N/d, B) int16.
//
// Tile and threads: a block of kThreads threads owns kCols adjacent
// columns (streams) of one channel: ceil(B / kCols) x CC blocks, 256 at
// both of the paths' shapes (CC 1 at B 2048, CC 2 at B 1024), two to an
// SM. All its threads stage the columns' N rows into shared memory with
// 4-byte cp.async (rows of kCols words, neighbouring threads on
// neighbouring words: coalesced whatever B and the view's offset), in
// kPieces commit groups, so the walk starts on the first piece while the
// rest lands. One thread per column (warp 0) walks the samples from
// shared memory and writes every d-th output as int16 into a shared
// tile; at each piece boundary the other warps write the tile's finished
// rows out (rows of kCols int16) while warp 0 walks the next piece.
// Shared memory: (N + 16) x kCols x 4 bytes in, N/d x kCols x 2 out:
// 45.5 KB at N 960, d 1. Columns past B are masked in staging, walk and
// write-back. The shape is the best of those tools/kernel_variants.py
// times (PERF.md). Registers (ptxas -v, sm_90a): 32 at d 1, 38 for any d.
//
// The walk: a first-order recurrence, sequential over the N samples and
// truncating at every step (smul), so no exact scan exists. A sample's
// chain is two instructions: the sum, and the product as the high word
// of one multiply (kPreemphHi, celt_common.cuh). The samples come into
// registers a group of kGroup ahead of the stores, and a whole group is
// walked with no guard per sample (nvcc makes each guard a branch, which
// costs more than the chain).
//
// What bounds it: that chain. Its floor is the two instructions' latency,
// ~4 cycles each, 8 cycles a sample (3.9 us at N 960 and 1980 MHz;
// chip_smoke.py's DEEMPH_CHAIN_CYCLES); the walk takes ~17 cycles a
// sample, about half the call, then the first piece's staging and the
// launch; the bytes (each input read once, each output written once)
// would take a fifth of it (NVIDIA H100 80GB HBM3, 700 W; PERF.md has the
// times).
// The walk reads no global memory.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "celt_common.cuh"

using namespace otpu;

namespace {

constexpr int kThreads = 256;   // of a block
constexpr int kCols = 8;        // columns of one channel a block owns
constexpr int kPieces = 4;      // commit groups of the staging
constexpr int kGroup = 8;       // samples a walker loads ahead

// D: the downsample factor, or 0 for any (read from d)
template <int D>
__global__ void __launch_bounds__(kThreads)
deemph_kernel(const int32_t* __restrict__ syn, long long cc_stride, int N,
              int B, int CC, const int32_t* __restrict__ mem_in,
              int32_t* __restrict__ mem_out, int16_t* __restrict__ pcm,
              int d) {
  extern __shared__ int32_t sm[];
  const int dd = D ? D : d;
  const int nd = N / dd;
  // N + 2 kGroup rows: a walker's loads ahead run past the last row
  int32_t* xs = sm;                              // N x kCols: input rows
  int16_t* os = (int16_t*)(sm + (N + 2 * kGroup) * kCols);  // nd x kCols
  const int tid = threadIdx.x, T = blockDim.x;
  const int cc = blockIdx.y;
  const int b0 = blockIdx.x * kCols;
  const int ns = min(kCols, B - b0);             // columns of this block
  // rows of a piece: a multiple of d, so a piece holds whole outputs
  const int R = ((N + kPieces - 1) / kPieces + dd - 1) / dd * dd;
  const int32_t* x = syn + cc * cc_stride + b0;
  int16_t* out = pcm + (size_t)cc * nd * B + b0;

#pragma unroll
  for (int p = 0; p < kPieces; ++p) {
    const int n0 = min(p * R, N), n1 = min(n0 + R, N);
    for (int i = n0 * kCols + tid; i < n1 * kCols; i += T) {
      const int c = i % kCols;
      if (c < ns)
        __pipeline_memcpy_async(xs + i, x + (size_t)(i / kCols) * B + c, 4);
    }
    __pipeline_commit();
  }
  int32_t m = tid < ns ? mem_in[(size_t)(b0 + tid) * CC + cc] : 0;

  // write the PCM rows [k0, k1) of the tile out, threads t0.. of the block
  auto write_rows = [&](int k0, int k1, int t0) {
    for (int i = k0 * kCols + tid - t0; i < k1 * kCols; i += T - t0) {
      const int c = i % kCols;
      if (c < ns) out[(size_t)(i / kCols) * B + c] = os[i];
    }
  };

#pragma unroll
  for (int p = 0; p < kPieces; ++p) {
    __pipeline_wait_prior(kPieces - 1 - p);
    __syncthreads();
    const int n0 = min(p * R, N), n1 = min(n0 + R, N);
    if (tid < 32) {
      if (tid < ns) {
        // one sample: the chain (sum, product, shift); every d-th sum,
        // rounded and clipped, into the tile
        int ph = 0, k = n0 / dd;             // n0 is a multiple of d
        auto step = [&](int32_t xn) {
          const int32_t tmp = wadd(xn, m);
          m = wadd(__mulhi(tmp, kPreemphHi), tmp);   // smul(tmp, kPreemph)
          if (ph == 0)
            os[k++ * kCols + tid] =
                (int16_t)clamp32(wadd(tmp, 2048) >> 12, -32768, 32767);
          if (++ph == dd) ph = 0;
        };
        // whole groups of samples, loaded into registers a group ahead
        // of the stores (the tile shares the shared array with the rows,
        // so a load written after a store waits for it) and walked
        // without a branch; then the rows left over, one at a time
        const int32_t* xc = xs + tid;
        int32_t nx[kGroup];
#pragma unroll
        for (int u = 0; u < kGroup; ++u) nx[u] = xc[(n0 + u) * kCols];
        int n = n0;
        for (; n + kGroup <= n1; n += kGroup) {
          int32_t cur[kGroup];
#pragma unroll
          for (int u = 0; u < kGroup; ++u) {
            cur[u] = nx[u];
            nx[u] = xc[(n + kGroup + u) * kCols];
          }
#pragma unroll
          for (int u = 0; u < kGroup; ++u) step(cur[u]);
        }
        for (; n < n1; ++n) step(xc[n * kCols]);
      }
    } else if (p > 0) {
      // the previous piece's outputs, while warp 0 walks this one
      write_rows(min((p - 1) * R, N) / dd, n0 / dd, 32);
    }
  }
  __syncthreads();
  write_rows(min((kPieces - 1) * R, N) / dd, nd, 0);
  if (tid < ns) mem_out[(size_t)(b0 + tid) * CC + cc] = m;
}

template <int D>
int launch_deemph(const int32_t* syn, long long cc_stride, int N, int B,
                  int CC, const int32_t* mem_in, int32_t* mem_out,
                  int16_t* pcm, int d, cudaStream_t stream) {
  const int smem = (N + 2 * kGroup) * kCols * 4 + N / d * kCols * 2;
  static int smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        deemph_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_allowed = smem;
  }
  const dim3 grid((B + kCols - 1) / kCols, CC);
  deemph_kernel<D><<<grid, kThreads, smem, stream>>>(
      syn, cc_stride, N, B, CC, mem_in, mem_out, pcm, d);
  return (int)cudaGetLastError();
}

}  // namespace

// syn: CC channel planes of N rows of B int32, planes cc_stride elements
// apart; mem_in, mem_out: (B, CC) int32 (may not alias); pcm: (CC, N/d, B)
// int16, keeping samples 0, d, 2d, ... N must be a multiple of d.
// Returns the CUDA error of the launch.
extern "C" int celt_deemph(const int32_t* syn, long long cc_stride, int N,
                           int B, int CC, const int32_t* mem_in,
                           int32_t* mem_out, int16_t* pcm, int d,
                           void* stream) {
  if (B <= 0 || CC <= 0 || N <= 0 || d <= 0 || N % d)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 1)
    return launch_deemph<1>(syn, cc_stride, N, B, CC, mem_in, mem_out, pcm,
                            1, s);
  return launch_deemph<0>(syn, cc_stride, N, B, CC, mem_in, mem_out, pcm, d,
                          s);
}

extern "C" const char* otpu_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
