// K9: comfort noise added to a concealed SILK frame.
//
// Replaces: esp32_opus_player_tpu/ops/silk/pallas_core.py::cng_add_pallas
// (kernel _cng_kernel). Reference: silk_CNG src/silk.cpp:1342, lossCnt
// branch: the CNG LPC synthesis ring over the comfort-noise excitation,
// scaled by the CNG gain and added to the frame with two saturations. A
// row with its mask off passes its frame through and keeps its state.
//
// Layout: the JAX row layout at the interface, each operand read where
// the caller has it (CngRows: a pointer and a row stride each, unit
// element stride, any 4-byte alignment; the lossy frame passes column
// slices of its staging rows and of its dense conceal inputs): xq and exc
// (B, >= frame), A (B, >= ORDER) Q12, gain (B,), mask (B,) bool bytes,
// state (B, 16), most recent sample last. out (B, frame) and state'
// (B, 16) are written contiguous. The call is this one launch.
//
// Tile and threads: a block of kThreads threads owns kStreams adjacent
// streams (128 blocks at B = 2048). Every warp takes the tile's mask as
// one ballot. Rows with the mask on have their frame, excitation, state,
// coefficients and gain staged into dynamic shared memory (4-byte
// cp.async, a warp per row, the lanes on neighbouring words; 43 KB a
// block at frame 320); rows with the mask off are copied out, frame and
// state, a sector at a time, by the warps that do not walk while warp 0
// walks. A tile with no row on walks nothing.
//
// The walk: one thread per row with the mask on, the LPC recurrence in
// transposed form as K8's (silk_plc.cu, phase 3): P[j] is what the
// outputs so far add to the prediction j samples on, built once from the
// incoming state; a new output updates every P with ORDER products that
// do not depend on each other, while the chain (P[0], the clips, the
// saturating add) runs beside them. Every sum is taken modulo 2^32
// (uint32_t), so its order is free and the bits are those of the
// reference's left-to-right sum; products and shifts are the reference's
// own; the saturating add is the exact sum clamped. The output replaces
// the excitation in place; the walker holds the excitation a group of 4
// samples ahead in registers, so no shared load waits on the chain. Then
// the warps scale the output by the gain and add it to the frame, a row
// at a time, lanes on neighbouring samples.
//
// What bounds it (NVIDIA H100 80GB HBM3, 700 W; PERF.md has the times and
// tools/kernel_variants.py the phases): the walk, one per tile that has
// a row on (a tenth of the rows are on in the lossy pools, so nearly
// every tile walks), ~95 instructions a sample at order 16 for the one
// walking warp, as K8's; its bytes take a twelfth of the call.
#include <cuda_runtime.h>

#include "silk_common.cuh"

using namespace otpu;

namespace {

constexpr int kThreads = 512;   // of a block
constexpr int kStreams = 16;    // that share a block and its tile (<= 32)

struct CngRows {
  const int32_t* xq;            // >= frame a row
  const int32_t* exc;           // >= frame a row
  const int32_t* A;             // ORDER a row
  const int32_t* gain;          // 1 a row
  const uint8_t* mask;          // 1 a row
  const int32_t* st;            // 16 a row
  long long xq_stride, exc_stride, A_stride, gain_stride, mask_stride,
      st_stride;
};

template <int ORDER>
__global__ void __launch_bounds__(kThreads)
cng_kernel(const CngRows in, int32_t* __restrict__ out,
           int32_t* __restrict__ st_out, int B, int frame, int S) {
  extern __shared__ int32_t sm[];
  const int fw = frame | 1;                  // odd: walkers on 16 banks
  int32_t* ex = sm;                          // S x fw: exc, then the output
  int32_t* xs = ex + S * fw;                 // S x fw: xq
  int32_t* s0 = xs + S * fw;                 // S x 16: incoming state
  int32_t* ac = s0 + S * 16;                 // S x 16: A
  int32_t* gn = ac + S * 16;                 // S: gain
  const int tid = threadIdx.x, T = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = T >> 5;
  const int b0 = blockIdx.x * S;
  const int ns = min(S, B - b0);             // streams of this block
  // bit s: stream b0 + s has its mask on (the same in every warp)
  const unsigned on = __ballot_sync(
      0xffffffffu, lane < ns && in.mask[(b0 + lane) * in.mask_stride] != 0);

  // the rows with the mask off: their frame and state copied out, a
  // warp per row, the lanes on neighbouring words (by the warps that do
  // not walk, while warp 0 walks)
  auto copy_off = [&](int w0, int nw) {
    for (int s = w0; s < ns; s += nw) {
      if (on >> s & 1) continue;
      const size_t b = b0 + s;
      const int32_t* x = in.xq + b * in.xq_stride;
      int32_t* y = out + b * frame;
      // 4 loads in flight a lane before their stores
      for (int c0 = lane; c0 < frame; c0 += 128) {
        int32_t v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c0 + 32 * j < frame) v[j] = x[c0 + 32 * j];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c0 + 32 * j < frame) y[c0 + 32 * j] = v[j];
      }
      if (lane < 16) st_out[b * 16 + lane] = in.st[b * in.st_stride + lane];
    }
  };
  if (on == 0) {                             // the whole block agrees
    copy_off(warp, nwarps);
    return;
  }

  // stage the rows that walk
  for (int s = warp; s < ns; s += nwarps) {
    if (!(on >> s & 1)) continue;
    const size_t b = b0 + s;
    stage_row(ex + s * fw, in.exc + b * in.exc_stride, frame, lane);
    stage_row(xs + s * fw, in.xq + b * in.xq_stride, frame, lane);
    if (lane < 16)
      __pipeline_memcpy_async(s0 + s * 16 + lane,
                              in.st + b * in.st_stride + lane, 4);
    if (lane < ORDER)
      __pipeline_memcpy_async(ac + s * 16 + lane,
                              in.A + b * in.A_stride + lane, 4);
    if (lane == 0)
      __pipeline_memcpy_async(gn + s, in.gain + b * in.gain_stride, 4);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  if (warp > 0) copy_off(warp - 1, nwarps - 1);
  if (tid < ns && (on >> tid & 1)) {
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
    auto step = [&](int32_t x) {
      const int32_t y = add_sat(x, lshift_sat32((int32_t)P[0], 4));
      const int32_t hi = y >> 16, lo16 = y & 0xFFFF;
#pragma unroll
      for (int j = 0; j < ORDER - 1; ++j)
        P[j] = P[j + 1] + (uint32_t)smul_split(hi, lo16, a[j]);
      P[ORDER - 1] = (uint32_t)(ORDER >> 1) +
                     (uint32_t)smul_split(hi, lo16, a[ORDER - 1]);
      return y;
    };
    int32_t* x = ex + tid * fw;
    // the excitation a group of 4 samples ahead, in registers: a load
    // issued after the previous outputs' stores to the same array would
    // wait for them, its latency on the chain
    int32_t xn[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) xn[j] = x[min(j, frame - 1)];
    int i = 0;
    for (; i + 4 <= frame; i += 4) {
      int32_t xc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        xc[j] = xn[j];
        xn[j] = x[min(i + 4 + j, frame - 1)];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) x[i + j] = step(xc[j]);
    }
    for (; i < frame; ++i) x[i] = step(x[i]);
  }
  if (nwarps == 1) copy_off(0, 1);
  __syncthreads();

  // the rows that walked: the noise scaled and added to the frame, the
  // last 16 outputs (behind the older state for a frame under 16) as the
  // new state
  for (int s = warp; s < ns; s += nwarps) {
    if (!(on >> s & 1)) continue;
    const size_t b = b0 + s;
    const int32_t g = gn[s];
    const int32_t* v = ex + s * fw;
    const int32_t* x = xs + s * fw;
    int32_t* y = out + b * frame;
    for (int c = lane; c < frame; c += 32)
      y[c] = sat16(wadd(x[c], sat16(rshift_round(smulww(v[c], g), 8))));
    if (lane < 16)
      st_out[b * 16 + lane] = lane >= 16 - frame ? v[frame - 16 + lane]
                                                 : s0[s * 16 + lane + frame];
  }
}

template <int ORDER>
int launch_cng(const CngRows& in, int32_t* out, int32_t* st_out, int B,
               int frame, cudaStream_t stream) {
  const int smem =
      (kStreams * (2 * (frame | 1) + 33)) * (int)sizeof(int32_t);
  static int smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        cng_kernel<ORDER>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_allowed = smem;
  }
  cng_kernel<ORDER><<<(B + kStreams - 1) / kStreams, kThreads, smem,
                      stream>>>(in, out, st_out, B, frame, kStreams);
  return (int)cudaGetLastError();
}

}  // namespace

// ptr: the operands xq, exc, A, gain, mask, state (6 device pointers),
// each B rows; stride: the row stride of each in elements. Rows: xq and
// exc >= frame int32, A order int32, gain 1 int32, mask 1 bool byte,
// state 16 int32, unit element stride. out: (B, frame), st_out: (B, 16),
// contiguous. order is 10 or 16. Returns the CUDA error of the launch.
extern "C" int silk_cng(const void* const* ptr, const long long* stride,
                        int32_t* out, int32_t* st_out, int B, int frame,
                        int order, void* stream) {
  if (B <= 0 || frame <= 0) return (int)cudaErrorInvalidValue;
  CngRows in;
  in.xq = (const int32_t*)ptr[0];
  in.exc = (const int32_t*)ptr[1];
  in.A = (const int32_t*)ptr[2];
  in.gain = (const int32_t*)ptr[3];
  in.mask = (const uint8_t*)ptr[4];
  in.st = (const int32_t*)ptr[5];
  in.xq_stride = stride[0];
  in.exc_stride = stride[1];
  in.A_stride = stride[2];
  in.gain_stride = stride[3];
  in.mask_stride = stride[4];
  in.st_stride = stride[5];
  cudaStream_t s = (cudaStream_t)stream;
  if (order == 16) return launch_cng<16>(in, out, st_out, B, frame, s);
  if (order == 10) return launch_cng<10>(in, out, st_out, B, frame, s);
  return (int)cudaErrorInvalidValue;
}
