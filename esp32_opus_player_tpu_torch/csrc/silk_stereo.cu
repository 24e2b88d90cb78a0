// S1: the SILK stereo unmix, mid/side to left/right.
//
// Replaces: esp32_opus_player_tpu/ops/silk/jax_stereo.py::ms_to_lr_batch
// (jnp under a jit; no pl.pallas_call). Reference: silk_stereo_MS_to_LR,
// src/silk.cpp:4028-4076: the side signal is predicted from a 3-tap
// smoothed mid and the mid itself with two Q13 predictors, which ramp
// from the previous frame's pair to this frame's over the first 8 ms;
// then L = mid + side, R = mid - side, each saturated to int16.
//
// The unmix has no recurrence: with the ramp in closed form
// (prev + delta * (n + 1)), output sample n needs only mid[n - 1 .. n + 1]
// and side[n] of the frame with the 2-sample histories in front. So one
// thread computes one (stream, sample): it reads its four inputs (from
// the histories at n < 2), and writes L and R into the 2-row layout the
// resampler reads, (B, 2, frame): row 2s is stream s's L, row 2s + 1 its
// R. The thread of a stream's last sample also writes the new histories
// (the frame's last two mid and side samples). Threads of a warp take
// neighbouring samples of one stream, so loads and stores coalesce.
//
// Layout at the interface: xq, (B, 2, >= frame), mid then side of each
// stream, rows and channels any stride apart (unit element stride: the
// pool passes its row-major frame); sMid, sSide, the previous and the
// new predictors, (B, >= 2) each with its own row stride (the new
// predictors are two columns of the pool's staging rows). Outputs are
// contiguous: lr (B, 2, frame), sMid' and sSide' (B, 2).
//
// Arithmetic: every product, sum and left shift that can wrap is taken
// in uint32_t (nvcc has no -fwrapv), as ms_to_lr_batch's int32 chain
// wraps; smulwb is silk_common.cuh's hi/lo split.
#include <cuda_runtime.h>

#include "silk_common.cuh"

using namespace otpu;

namespace {

constexpr int kThreads = 256;
constexpr int kInterpMs = 8;    // STEREO_INTERP_LEN_MS

struct StereoIn {
  const int32_t* xq;            // (B, 2, >= frame)
  const int32_t* sMid;          // (B, >= 2)
  const int32_t* sSide;
  const int32_t* prev;          // the predictors of the previous frame
  const int32_t* pred;          // this frame's
  long long xq_stride, xq_ch_stride, mid_stride, side_stride, prev_stride,
      pred_stride;
};

// the predictor at sample n: the closed-form ramp over the first
// interp samples, this frame's value after
__device__ __forceinline__ int32_t ramp(int32_t prev, int32_t pred,
                                        int32_t denom, int n, int interp) {
  if (n >= interp) return pred;
  const int32_t delta = rshift_round(wmul(wsub(pred, prev), denom), 16);
  return wadd(prev, wmul(delta, n + 1));
}

__global__ void __launch_bounds__(kThreads)
ms_to_lr_kernel(const StereoIn in, int32_t* __restrict__ lr,
                int32_t* __restrict__ mid_out, int32_t* __restrict__ side_out,
                int B, int frame, int fs) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)B * frame) return;
  const int s = (int)(t / frame), n = (int)(t - (long long)s * frame);
  const int32_t* mid = in.xq + s * in.xq_stride;
  const int32_t* side = mid + in.xq_ch_stride;
  const int32_t* hm = in.sMid + s * in.mid_stride;
  const int32_t* hs = in.sSide + s * in.side_stride;
  // x1[j] = mid with its 2-sample history in front: x1[j] is hm[j] for
  // j < 2, else mid[j - 2]; sample n reads x1[n], x1[n + 1], x1[n + 2]
  // and x2[n + 1]
  const int32_t m_m1 = n < 2 ? __ldg(hm + n) : __ldg(mid + n - 2);
  const int32_t m_0 = n < 1 ? __ldg(hm + 1) : __ldg(mid + n - 1);
  const int32_t m_p1 = __ldg(mid + n);
  const int32_t s_0 = n < 1 ? __ldg(hs + 1) : __ldg(side + n - 1);
  const int32_t* pv = in.prev + s * in.prev_stride;
  const int32_t* pr = in.pred + s * in.pred_stride;
  const int interp = kInterpMs * fs;
  const int32_t denom = (1 << 16) / interp;
  const int32_t p0 = ramp(__ldg(pv), __ldg(pr), denom, n, interp);
  const int32_t p1 = ramp(__ldg(pv + 1), __ldg(pr + 1), denom, n, interp);
  // 3-tap smoothed mid, Q9, then the side prediction (wrapping sums)
  int32_t acc = wshl(wadd(wadd(m_m1, m_p1), wshl(m_0, 1)), 9);
  acc = wadd(wshl(s_0, 8), smulwb(acc, p0));
  acc = wadd(acc, smulwb(wshl(m_0, 11), p1));
  const int32_t sp = sat16(rshift_round(acc, 8));
  int32_t* out = lr + (long long)s * 2 * frame;
  out[n] = sat16(wadd(m_0, sp));
  out[frame + n] = sat16(wsub(m_0, sp));
  if (n == frame - 1) {
    mid_out[2 * s] = __ldg(mid + frame - 2);
    mid_out[2 * s + 1] = __ldg(mid + frame - 1);
    side_out[2 * s] = __ldg(side + frame - 2);
    side_out[2 * s + 1] = __ldg(side + frame - 1);
  }
}

}  // namespace

extern "C" int silk_ms_to_lr(const void* const* ptrs,
                             const long long* strides, int32_t* lr,
                             int32_t* mid_out, int32_t* side_out, int B,
                             int frame, int fs, cudaStream_t stream) {
  if (B <= 0) return 0;
  StereoIn in;
  in.xq = (const int32_t*)ptrs[0];
  in.sMid = (const int32_t*)ptrs[1];
  in.sSide = (const int32_t*)ptrs[2];
  in.prev = (const int32_t*)ptrs[3];
  in.pred = (const int32_t*)ptrs[4];
  in.xq_stride = strides[0];
  in.xq_ch_stride = strides[1];
  in.mid_stride = strides[2];
  in.side_stride = strides[3];
  in.prev_stride = strides[4];
  in.pred_stride = strides[5];
  const long long total = (long long)B * frame;
  const int blocks = (int)((total + kThreads - 1) / kThreads);
  ms_to_lr_kernel<<<blocks, kThreads, 0, stream>>>(in, lr, mid_out,
                                                   side_out, B, frame, fs);
  return (int)cudaGetLastError();
}
