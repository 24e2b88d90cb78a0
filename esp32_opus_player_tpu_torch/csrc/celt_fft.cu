// K1: the CELT inverse-MDCT core (pre-rotation, mixed-radix kiss FFT,
// post-rotation) over a batch of streams, int32 Q15, bit-exact.
//
// Replaces: esp32_opus_player_tpu/ops/celt/pallas_fft.py::fft_blocks_pallas
// (kernel body _make_kernel, static plan _plan). Reference: clt_mdct_backward
// src/celt.cpp:3204-3280, opus_fft_impl :2997, kf_bfly* :2545-2930.
//
// Layout: freq_T (n_freq, B) and the outputs yr, yi (rows, B) keep the
// transposed layout of the JAX path: FFT index on rows, streams
// contiguous. One block owns kStreams streams; its threads are
// (stream, butterfly lane), so every global access of a warp is a run of
// consecutive streams.
//
// What bounds it: each stream's working set is rows x 2 int32 (3.75 KiB
// at rows = 480) and every stage touches all of it, so the FFT lives in
// shared memory from the gathered input to the post-rotated output:
// device memory sees one read of the gathered spectrum and one write of
// yr/yi. The input gather (bitrev composed with the pre-rotation
// interleave) reads freq_T straight through the static i1g/i2g row
// tables, so the two (rows, B) gathered temporaries of the JAX wrapper
// never exist. Kiss-FFT butterflies write the positions they read, so
// each stage runs in place with one __syncthreads() between stages.
#include <cuda_runtime.h>

#include "celt_common.cuh"

using namespace otpu;

namespace {

constexpr int kStreams = 8;   // streams per block (threadIdx.x)
constexpr int kLanes = 32;    // butterfly lanes per stream (threadIdx.y)
constexpr int kMaxStages = 6;
constexpr int kMaxRows = 480;

struct FftPlan {
  int rows;    // Bblk * N4
  int n4;      // FFT size
  int nstage;  // stages in execution order
  int p[kMaxStages], m[kMaxStages], fs[kMaxStages];
};

__device__ __forceinline__ void cmul(int32_t ar, int32_t ai, int32_t br,
                                     int32_t bi, int32_t& cr, int32_t& ci) {
  cr = wsub(smul(ar, br), smul(ai, bi));
  ci = wadd(smul(ar, bi), smul(ai, br));
}

__global__ void __launch_bounds__(kStreams * kLanes)
fft_blocks_kernel(const int32_t* __restrict__ freq, int B,
                  int32_t* __restrict__ yr_out, int32_t* __restrict__ yi_out,
                  const int32_t* __restrict__ i1g,
                  const int32_t* __restrict__ i2g,
                  const int32_t* __restrict__ pre,
                  const int32_t* __restrict__ post,
                  const int32_t* __restrict__ tw, FftPlan plan) {
  __shared__ int32_t sr[kMaxRows * kStreams];
  __shared__ int32_t si[kMaxRows * kStreams];
  const int s = threadIdx.x;
  const int b = blockIdx.x * kStreams + s;
  const bool valid = b < B;
  const int rows = plan.rows;
#define R(k) sr[(k) * kStreams + s]
#define I(k) si[(k) * kStreams + s]

  // pre-rotation; the prerotate swap stores rbuf <- yi, ibuf <- yr
  for (int j = threadIdx.y; j < rows; j += kLanes) {
    int32_t xp1 = valid ? freq[(size_t)i1g[j] * B + b] : 0;
    int32_t xp2 = valid ? freq[(size_t)i2g[j] * B + b] : 0;
    int32_t t0 = pre[2 * j], t1 = pre[2 * j + 1];
    R(j) = wsub(smul(xp1, t0), smul(xp2, t1));
    I(j) = wadd(smul(xp2, t0), smul(xp1, t1));
  }
  __syncthreads();

  for (int st = 0; st < plan.nstage; ++st) {
    const int p = plan.p[st], m = plan.m[st], fs = plan.fs[st];
    const int ngroups = rows / (p * m);
    if (p == 2) {
      // kf_bfly2 with m == 4 and the fixed sqrt(1/2) twiddle
      const int32_t t = 23170;
      for (int u = threadIdx.y; u < ngroups * 4; u += kLanes) {
        const int k0 = (u >> 2) * 8 + (u & 3), k2 = k0 + 4;
        int32_t f2r = R(k2), f2i = I(k2), tr, ti;
        switch (u & 3) {
          case 0: tr = f2r; ti = f2i; break;
          case 1: tr = smul(wadd(f2r, f2i), t); ti = smul(wsub(f2i, f2r), t);
                  break;
          case 2: tr = f2i; ti = wneg(f2r); break;
          default: tr = smul(wsub(f2i, f2r), t);
                   ti = smul(wneg(wadd(f2i, f2r)), t);
        }
        int32_t f0r = R(k0), f0i = I(k0);
        R(k0) = wadd(f0r, tr); I(k0) = wadd(f0i, ti);
        R(k2) = wsub(f0r, tr); I(k2) = wsub(f0i, ti);
      }
    } else if (p == 4 && m == 1) {
      for (int g = threadIdx.y; g < ngroups; g += kLanes) {
        const int k = g * 4;
        int32_t r0 = R(k), r1 = R(k + 1), r2 = R(k + 2), r3 = R(k + 3);
        int32_t i0 = I(k), i1 = I(k + 1), i2 = I(k + 2), i3 = I(k + 3);
        int32_t s0r = wsub(r0, r2), s0i = wsub(i0, i2);
        int32_t f0r = wadd(r0, r2), f0i = wadd(i0, i2);
        int32_t s1r = wadd(r1, r3), s1i = wadd(i1, i3);
        int32_t d1r = wsub(r1, r3), d1i = wsub(i1, i3);
        R(k) = wadd(f0r, s1r);     I(k) = wadd(f0i, s1i);
        R(k + 1) = wadd(s0r, d1i); I(k + 1) = wsub(s0i, d1r);
        R(k + 2) = wsub(f0r, s1r); I(k + 2) = wsub(f0i, s1i);
        R(k + 3) = wsub(s0r, d1i); I(k + 3) = wadd(s0i, d1r);
      }
    } else if (p == 4) {
      for (int u = threadIdx.y; u < ngroups * m; u += kLanes) {
        const int j = u % m, k = (u / m) * 4 * m + j;
        const int w = j * fs;
        int32_t s0r, s0i, s1r, s1i, s2r, s2i;
        cmul(R(k + m), I(k + m), tw[2 * w], tw[2 * w + 1], s0r, s0i);
        cmul(R(k + 2 * m), I(k + 2 * m), tw[4 * w], tw[4 * w + 1], s1r, s1i);
        cmul(R(k + 3 * m), I(k + 3 * m), tw[6 * w], tw[6 * w + 1], s2r, s2i);
        int32_t r0 = R(k), i0 = I(k);
        int32_t s5r = wsub(r0, s1r), s5i = wsub(i0, s1i);
        int32_t f0r = wadd(r0, s1r), f0i = wadd(i0, s1i);
        int32_t s3r = wadd(s0r, s2r), s3i = wadd(s0i, s2i);
        int32_t s4r = wsub(s0r, s2r), s4i = wsub(s0i, s2i);
        R(k) = wadd(f0r, s3r);         I(k) = wadd(f0i, s3i);
        R(k + m) = wadd(s5r, s4i);     I(k + m) = wsub(s5i, s4r);
        R(k + 2 * m) = wsub(f0r, s3r); I(k + 2 * m) = wsub(f0i, s3i);
        R(k + 3 * m) = wsub(s5r, s4i); I(k + 3 * m) = wadd(s5i, s4r);
      }
    } else if (p == 3) {
      const int32_t epi3i = -28378;
      for (int u = threadIdx.y; u < ngroups * m; u += kLanes) {
        const int j = u % m, k = (u / m) * 3 * m + j;
        const int w = j * fs;
        int32_t s1r, s1i, s2r, s2i;
        cmul(R(k + m), I(k + m), tw[2 * w], tw[2 * w + 1], s1r, s1i);
        cmul(R(k + 2 * m), I(k + 2 * m), tw[4 * w], tw[4 * w + 1], s2r, s2i);
        int32_t s3r = wadd(s1r, s2r), s3i = wadd(s1i, s2i);
        int32_t s0r = wsub(s1r, s2r), s0i = wsub(s1i, s2i);
        int32_t r0 = R(k), i0 = I(k);
        int32_t f1r = wsub(r0, s3r >> 1), f1i = wsub(i0, s3i >> 1);
        s0r = smul(s0r, epi3i);
        s0i = smul(s0i, epi3i);
        R(k) = wadd(r0, s3r);          I(k) = wadd(i0, s3i);
        R(k + m) = wsub(f1r, s0i);     I(k + m) = wadd(f1i, s0r);
        R(k + 2 * m) = wadd(f1r, s0i); I(k + 2 * m) = wsub(f1i, s0r);
      }
    } else {  // p == 5
      const int32_t yar = 10126, yai = -31164, ybr = -26510, ybi = -19261;
      for (int u = threadIdx.y; u < ngroups * m; u += kLanes) {
        const int j = u % m, k = (u / m) * 5 * m + j;
        const int w = j * fs;
        int32_t s0r = R(k), s0i = I(k);
        int32_t s1r, s1i, s2r, s2i, s3r, s3i, s4r, s4i;
        cmul(R(k + m), I(k + m), tw[2 * w], tw[2 * w + 1], s1r, s1i);
        cmul(R(k + 2 * m), I(k + 2 * m), tw[4 * w], tw[4 * w + 1], s2r, s2i);
        cmul(R(k + 3 * m), I(k + 3 * m), tw[6 * w], tw[6 * w + 1], s3r, s3i);
        cmul(R(k + 4 * m), I(k + 4 * m), tw[8 * w], tw[8 * w + 1], s4r, s4i);
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
        R(k) = o0r;                      I(k) = o0i;
        R(k + m) = wsub(s5r, s6r);       I(k + m) = wsub(s5i, s6i);
        R(k + 2 * m) = wadd(s11r, s12r); I(k + 2 * m) = wadd(s11i, s12i);
        R(k + 3 * m) = wsub(s11r, s12r); I(k + 3 * m) = wsub(s11i, s12i);
        R(k + 4 * m) = wadd(s5r, s6r);   I(k + 4 * m) = wadd(s5i, s6i);
      }
    }
    __syncthreads();
  }

  // post-rotation: re <- ibuf, im <- rbuf
  if (valid) {
    for (int j = threadIdx.y; j < rows; j += kLanes) {
      int32_t re = I(j), im = R(j);
      int32_t p0 = post[2 * j], p1 = post[2 * j + 1];
      yr_out[(size_t)j * B + b] = wadd(smul(re, p0), smul(im, p1));
      yi_out[(size_t)j * B + b] = wsub(smul(re, p1), smul(im, p0));
    }
  }
#undef R
#undef I
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
      freq, B, yr, yi, i1g, i2g, pre, post, tw, plan);
  return (int)cudaGetLastError();
}
