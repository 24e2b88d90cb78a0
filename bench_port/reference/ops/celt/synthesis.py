"""CELT dense synthesis phase: denormalization, iMDCT (mixed-radix kiss FFT
+ pre/post rotation + TDAC), anti-collapse, comb postfilter, deemphasis.

Bit-exact integer model of the reference synthesis path (reference
src/celt.cpp: denormalise_bands :948, anti_collapse :1010, celt_synthesis
:2057, clt_mdct_backward :3204, opus_fft_impl :2997, kf_bfly2/3/4/5
:2794-2995, comb_filter :848, deemphasis :1988). All 32-bit stores wrap
(ADD32_ovflw et al); S_MUL is the 16x32 Q15 product truncated to int32.

This numpy version is the semantic model AND the shape template for the
batched JAX device kernels in ops/celt/jax_synthesis.py: every loop here is
either elementwise over a block (vectorized) or a short recurrence (scan).

The port's copy of esp32_opus_player_tpu/ops/celt/synthesis.py (numpy
and Python ints; nothing of the JAX package is imported).
"""
from __future__ import annotations

import numpy as np

from ..fixed_point import s16, s32
from ..tables.celt_tables import (eMeans, eband5ms, fft_bitrev60,
                                  fft_bitrev120, fft_bitrev240, fft_bitrev480,
                                  fft_twiddles48000_960, mdct_twiddles960,
                                  window120)
from .math import (DB_SHIFT, celt_exp2, celt_exp2_frac, celt_ilog2,
                   celt_lcg_rand, celt_rsqrt_norm)
from ..fixed_point import (MULT16_16_Q14, MULT16_16_Q15, MULT16_16_P15,
                           MULT16_32_Q15, SHR16)
from .pvq import renormalise_vector

NB_EBANDS = 21
SHORT_MDCT_SIZE = 120
MAX_LM = 3
OVERLAP = 120
DECODE_BUFFER_SIZE = 2048
SIG_SAT = 300000000
COMBFILTER_MINPERIOD = 15
BITRES = 3

_EBANDS = [int(x) for x in eband5ms]
_WINDOW = window120.astype(np.int64)
_MDCT_TRIG = mdct_twiddles960.astype(np.int64)
_TWIDDLES = fft_twiddles48000_960.astype(np.int64)  # (480, 2)

_M32 = 0xFFFFFFFF


def w32(x):
    """Wrap numpy int64 array/scalar to signed 32-bit."""
    return ((x + 0x80000000) & _M32) - 0x80000000


def _smul(x, t):
    """S_MUL(x, t) = ((int64)t * x) >> 15, truncated to int32."""
    return w32((x * t) >> 15)


class FFTState:
    def __init__(self, nfft, shift, factors, bitrev):
        self.nfft = nfft
        self.shift = shift
        self.factors = factors
        self.bitrev = bitrev.astype(np.int64)


FFT_STATES = {
    0: FFTState(480, -1, [(5, 96), (3, 32), (4, 8), (2, 4), (4, 1)],
                fft_bitrev480),
    1: FFTState(240, 1, [(5, 48), (3, 16), (4, 4), (4, 1)], fft_bitrev240),
    2: FFTState(120, 2, [(5, 24), (3, 8), (2, 4), (4, 1)], fft_bitrev120),
    3: FFTState(60, 3, [(5, 12), (3, 4), (4, 1)], fft_bitrev60),
}


def _tw(idx):
    """Twiddle lookup: returns (re, im) int64 arrays for index array idx."""
    return _TWIDDLES[idx, 0], _TWIDDLES[idx, 1]


def _c_mul(ar, ai, br, bi):
    """C_MUL: complex multiply, a=int32 data, b=int16 twiddle."""
    return (w32(_smul(ar, br) - _smul(ai, bi)),
            w32(_smul(ar, bi) + _smul(ai, br)))


def kf_bfly2(r, i_, N):
    """m==4 radix-2 (src/celt.cpp:2794). Data viewed as blocks of 8."""
    tw = 23170  # QCONST16(0.7071067812, 15)
    r = r.reshape(N, 8)
    i_ = i_.reshape(N, 8)
    f0r, f0i = r[:, 0:4].copy(), i_[:, 0:4].copy()
    f2r, f2i = r[:, 4:8].copy(), i_[:, 4:8].copy()
    tr = np.empty_like(f2r)
    ti = np.empty_like(f2i)
    tr[:, 0] = f2r[:, 0]
    ti[:, 0] = f2i[:, 0]
    tr[:, 1] = _smul(w32(f2r[:, 1] + f2i[:, 1]), tw)
    ti[:, 1] = _smul(w32(f2i[:, 1] - f2r[:, 1]), tw)
    tr[:, 2] = f2i[:, 2]
    ti[:, 2] = w32(-f2r[:, 2])
    tr[:, 3] = _smul(w32(f2i[:, 3] - f2r[:, 3]), tw)
    ti[:, 3] = _smul(w32(-w32(f2i[:, 3] + f2r[:, 3])), tw)
    r[:, 4:8] = w32(f0r - tr)
    i_[:, 4:8] = w32(f0i - ti)
    r[:, 0:4] = w32(f0r + tr)
    i_[:, 0:4] = w32(f0i + ti)


def kf_bfly4(r, i_, fstride, m, N, mm):
    if m == 1:
        idx = (np.arange(N) * mm)[:, None] + np.arange(4)[None, :]
        fr = r[idx]
        fi = i_[idx]
        s0r = w32(fr[:, 0] - fr[:, 2])
        s0i = w32(fi[:, 0] - fi[:, 2])
        f0r = w32(fr[:, 0] + fr[:, 2])
        f0i = w32(fi[:, 0] + fi[:, 2])
        s1r = w32(fr[:, 1] + fr[:, 3])
        s1i = w32(fi[:, 1] + fi[:, 3])
        out2r = w32(f0r - s1r)
        out2i = w32(f0i - s1i)
        f0r = w32(f0r + s1r)
        f0i = w32(f0i + s1i)
        d1r = w32(fr[:, 1] - fr[:, 3])
        d1i = w32(fi[:, 1] - fi[:, 3])
        r[idx[:, 0]] = f0r
        i_[idx[:, 0]] = f0i
        r[idx[:, 1]] = w32(s0r + d1i)
        i_[idx[:, 1]] = w32(s0i - d1r)
        r[idx[:, 2]] = out2r
        i_[idx[:, 2]] = out2i
        r[idx[:, 3]] = w32(s0r - d1i)
        i_[idx[:, 3]] = w32(s0i + d1r)
    else:
        j = np.arange(m)
        tw1, tw1i = _tw(j * fstride)
        tw2, tw2i = _tw(j * fstride * 2)
        tw3, tw3i = _tw(j * fstride * 3)
        base = (np.arange(N) * mm)[:, None] + j[None, :]
        f0 = base
        f1 = base + m
        f2 = base + 2 * m
        f3 = base + 3 * m
        s0r, s0i = _c_mul(r[f1], i_[f1], tw1, tw1i)
        s1r, s1i = _c_mul(r[f2], i_[f2], tw2, tw2i)
        s2r, s2i = _c_mul(r[f3], i_[f3], tw3, tw3i)
        s5r = w32(r[f0] - s1r)
        s5i = w32(i_[f0] - s1i)
        f0r = w32(r[f0] + s1r)
        f0i = w32(i_[f0] + s1i)
        s3r = w32(s0r + s2r)
        s3i = w32(s0i + s2i)
        s4r = w32(s0r - s2r)
        s4i = w32(s0i - s2i)
        r[f2] = w32(f0r - s3r)
        i_[f2] = w32(f0i - s3i)
        r[f0] = w32(f0r + s3r)
        i_[f0] = w32(f0i + s3i)
        r[f1] = w32(s5r + s4i)
        i_[f1] = w32(s5i - s4r)
        r[f3] = w32(s5r - s4i)
        i_[f3] = w32(s5i + s4r)


def kf_bfly3(r, i_, fstride, m, N, mm):
    epi3i = -28378
    j = np.arange(m)
    tw1, tw1i = _tw(j * fstride)
    tw2, tw2i = _tw(j * fstride * 2)
    base = (np.arange(N) * mm)[:, None] + j[None, :]
    f0 = base
    f1 = base + m
    f2 = base + 2 * m
    s1r, s1i = _c_mul(r[f1], i_[f1], tw1, tw1i)
    s2r, s2i = _c_mul(r[f2], i_[f2], tw2, tw2i)
    s3r = w32(s1r + s2r)
    s3i = w32(s1i + s2i)
    s0r = w32(s1r - s2r)
    s0i = w32(s1i - s2i)
    f1r = w32(r[f0] - (s3r >> 1))
    f1i = w32(i_[f0] - (s3i >> 1))
    s0r = _smul(s0r, epi3i)
    s0i = _smul(s0i, epi3i)
    r[f0] = w32(r[f0] + s3r)
    i_[f0] = w32(i_[f0] + s3i)
    r[f2] = w32(f1r + s0i)
    i_[f2] = w32(f1i - s0r)
    r[f1] = w32(f1r - s0i)
    i_[f1] = w32(f1i + s0r)


def kf_bfly5(r, i_, fstride, m, N, mm):
    yar, yai = 10126, -31164
    ybr, ybi = -26510, -19261
    u = np.arange(m)
    t1r, t1i = _tw(u * fstride)
    t2r, t2i = _tw(2 * u * fstride)
    t3r, t3i = _tw(3 * u * fstride)
    t4r, t4i = _tw(4 * u * fstride)
    base = (np.arange(N) * mm)[:, None] + u[None, :]
    f0, f1, f2, f3, f4 = base, base + m, base + 2 * m, base + 3 * m, \
        base + 4 * m
    s0r, s0i = r[f0].copy(), i_[f0].copy()
    s1r, s1i = _c_mul(r[f1], i_[f1], t1r, t1i)
    s2r, s2i = _c_mul(r[f2], i_[f2], t2r, t2i)
    s3r, s3i = _c_mul(r[f3], i_[f3], t3r, t3i)
    s4r, s4i = _c_mul(r[f4], i_[f4], t4r, t4i)
    s7r = w32(s1r + s4r)
    s7i = w32(s1i + s4i)
    s10r = w32(s1r - s4r)
    s10i = w32(s1i - s4i)
    s8r = w32(s2r + s3r)
    s8i = w32(s2i + s3i)
    s9r = w32(s2r - s3r)
    s9i = w32(s2i - s3i)
    r[f0] = w32(s0r + w32(s7r + s8r))
    i_[f0] = w32(s0i + w32(s7i + s8i))
    s5r = w32(s0r + w32(_smul(s7r, yar) + _smul(s8r, ybr)))
    s5i = w32(s0i + w32(_smul(s7i, yar) + _smul(s8i, ybr)))
    s6r = w32(_smul(s10i, yai) + _smul(s9i, ybi))
    s6i = w32(-w32(_smul(s10r, yai) + _smul(s9r, ybi)))
    r[f1] = w32(s5r - s6r)
    i_[f1] = w32(s5i - s6i)
    r[f4] = w32(s5r + s6r)
    i_[f4] = w32(s5i + s6i)
    s11r = w32(s0r + w32(_smul(s7r, ybr) + _smul(s8r, yar)))
    s11i = w32(s0i + w32(_smul(s7i, ybr) + _smul(s8i, yar)))
    s12r = w32(_smul(s9i, yai) - _smul(s10i, ybi))
    s12i = w32(_smul(s10r, ybi) - _smul(s9r, yai))
    r[f2] = w32(s11r + s12r)
    i_[f2] = w32(s11i + s12i)
    r[f3] = w32(s11r - s12r)
    i_[f3] = w32(s11i - s12i)


def opus_fft_impl(st: FFTState, r, i_):
    """(src/celt.cpp:2997)"""
    shift = st.shift if st.shift > 0 else 0
    factors = st.factors
    L = len(factors)
    fstride = [1]
    for lvl in range(L):
        fstride.append(fstride[lvl] * factors[lvl][0])
    for lvl in range(L - 1, -1, -1):
        m2 = factors[lvl - 1][1] if lvl != 0 else 1
        p = factors[lvl][0]
        m = factors[lvl][1]
        fs = fstride[lvl]
        if p == 2:
            kf_bfly2(r, i_, fs)
        elif p == 4:
            kf_bfly4(r, i_, fs << shift, m, fs, m2)
        elif p == 3:
            kf_bfly3(r, i_, fs << shift, m, fs, m2)
        elif p == 5:
            kf_bfly5(r, i_, fs << shift, m, fs, m2)


def clt_mdct_backward(freq, out, ooff: int, overlap: int, shift: int,
                      stride: int) -> None:
    """iMDCT one block (src/celt.cpp:3204). freq is an int64 array view of
    the spectral input with the given stride; out[ooff:] receives the
    time-domain block (in-place TDAC with pre-existing history)."""
    N = 1920
    trig_off = 0
    for _ in range(shift):
        N >>= 1
        trig_off += N
    N2 = N >> 1
    N4 = N >> 2
    st = FFT_STATES[shift]
    trig = _MDCT_TRIG

    # pre-rotate into bitrev order
    idx = np.arange(N4)
    xp1 = freq[2 * stride * idx]                  # in[0], step 2*stride
    xp2 = freq[stride * (N2 - 1) - 2 * stride * idx]
    t0 = trig[trig_off + idx]
    t1 = trig[trig_off + N4 + idx]
    yr = w32(_smul(xp2, t0) + _smul(xp1, t1))
    yi = w32(_smul(xp1, t0) - _smul(xp2, t1))
    rbuf = np.zeros(N4, dtype=np.int64)
    ibuf = np.zeros(N4, dtype=np.int64)
    rev = st.bitrev
    # swapped real/imag (FFT instead of IFFT)
    rbuf[rev] = yi
    ibuf[rev] = yr

    opus_fft_impl(st, rbuf, ibuf)

    # post-rotate; both halves computed from the FFT result
    # (middle-pair double-compute in the reference is idempotent)
    i = np.arange(N4)
    re = ibuf  # swapped
    im = rbuf
    t0 = trig[trig_off + i]
    t1 = trig[trig_off + N4 + i]
    yr = w32(_smul(re, t0) + _smul(im, t1))
    yi = w32(_smul(re, t1) - _smul(im, t0))
    # yp0[2i] = yr[i]; yp1[(N2-2) - 2i + 1] = yi[i]
    half = out[ooff + (overlap >> 1): ooff + (overlap >> 1) + N2]
    tmp = np.empty(N2, dtype=np.int64)
    tmp[2 * i] = yr
    tmp[N2 - 1 - 2 * i] = yi
    out[ooff + (overlap >> 1): ooff + (overlap >> 1) + N2] = tmp

    # TDAC mirror
    i = np.arange(overlap // 2)
    x2 = out[ooff + i].copy()
    x1 = out[ooff + overlap - 1 - i].copy()
    wp1 = _WINDOW[i]
    wp2 = _WINDOW[overlap - 1 - i]
    out[ooff + i] = w32(_smul(x2, wp2) - _smul(x1, wp1))
    out[ooff + overlap - 1 - i] = w32(_smul(x2, wp1) + _smul(x1, wp2))


def denormalise_bands(X, xoff: int, freq, bandLogE, eoff: int, start: int,
                      end: int, M: int, downsample: int,
                      silence: int) -> None:
    """(src/celt.cpp:948). X int16-range array view; freq int64 out (len N)."""
    N = M * SHORT_MDCT_SIZE
    bound = M * _EBANDS[end]
    if downsample != 1:
        bound = min(bound, N // downsample)
    if silence:
        bound = 0
        start = end = 0
    freq[:M * _EBANDS[start]] = 0
    for i in range(start, end):
        j = M * _EBANDS[i]
        band_end = M * _EBANDS[i + 1]
        lg = int(bandLogE[eoff + i]) + (int(eMeans[i]) << 6)
        lg = max(-32768, min(32767, lg))
        shift = 16 - (lg >> DB_SHIFT)
        if shift > 31:
            shift = 0
            g = 0
        else:
            g = celt_exp2_frac(lg & ((1 << DB_SHIFT) - 1))
        if shift < 0:
            if shift <= -2:
                g = 16384
                shift = -2
            xs = X[xoff + j:xoff + band_end].astype(np.int64)
            freq[j:band_end] = w32(w32(xs * g) << -shift)
        else:
            xs = X[xoff + j:xoff + band_end].astype(np.int64)
            freq[j:band_end] = w32(xs * g) >> shift
    freq[bound:N] = 0


def anti_collapse(X, collapse_masks, LM: int, C: int, size: int, start: int,
                  end: int, logE, prev1logE, prev2logE, pulses,
                  seed: int) -> None:
    """(src/celt.cpp:1010). Host-side: sequential LCG seed evolution."""
    for i in range(start, end):
        N0 = _EBANDS[i + 1] - _EBANDS[i]
        depth = ((1 + pulses[i]) // N0) >> LM
        thresh32 = celt_exp2(s16(-(depth << (10 - BITRES)))) >> 1
        thresh = MULT16_32_Q15(16384, min(32767, thresh32))
        t = N0 << LM
        shift = celt_ilog2(t) >> 1
        t = s32(t << ((7 - shift) << 1))
        sqrt_1 = celt_rsqrt_norm(t)

        for c in range(C):
            prev1 = int(prev1logE[c * NB_EBANDS + i])
            prev2 = int(prev2logE[c * NB_EBANDS + i])
            if C == 1:
                prev1 = max(prev1, int(prev1logE[NB_EBANDS + i]))
                prev2 = max(prev2, int(prev2logE[NB_EBANDS + i]))
            Ediff = int(logE[c * NB_EBANDS + i]) - min(prev1, prev2)
            Ediff = max(0, Ediff)
            if Ediff < 16384:
                r32 = celt_exp2(s16(-Ediff)) >> 1
                r = 2 * min(16383, r32)
            else:
                r = 0
            if LM == 3:
                r = MULT16_16_Q14(23170, min(23169, r))
            r = SHR16(min(thresh, r), 1)
            r = MULT16_16_Q15(sqrt_1, r) >> shift

            xbase = c * size + (_EBANDS[i] << LM)
            renormalize = 0
            for k in range(1 << LM):
                if not (int(collapse_masks[i * C + c]) & (1 << k)):
                    for j in range(N0):
                        seed = celt_lcg_rand(seed)
                        X[xbase + (j << LM) + k] = r if (seed & 0x8000) \
                            else -r
                    renormalize = 1
            if renormalize:
                renormalise_vector(X[xbase:xbase + (N0 << LM)], N0 << LM,
                                   32767)


def celt_synthesis(X, out_syn, oldBandE, start: int, effEnd: int, C: int,
                   CC: int, isTransient: int, LM: int, downsample: int,
                   silence: int) -> None:
    """(src/celt.cpp:2057). out_syn: list of (array, offset) per channel."""
    N = SHORT_MDCT_SIZE << LM
    M = 1 << LM
    if isTransient:
        B = M
        NB = SHORT_MDCT_SIZE
        shift = MAX_LM
    else:
        B = 1
        NB = SHORT_MDCT_SIZE << LM
        shift = MAX_LM - LM

    freq = np.zeros(N, dtype=np.int64)
    if CC == 2 and C == 1:
        denormalise_bands(X, 0, freq, oldBandE, 0, start, effEnd, M,
                          downsample, silence)
        arr0, off0 = out_syn[0]
        arr1, off1 = out_syn[1]
        freq2_off = off1 + OVERLAP // 2
        arr1[freq2_off:freq2_off + N] = freq
        for b in range(B):
            clt_mdct_backward(arr1[freq2_off + b:], arr0, off0 + NB * b,
                              OVERLAP, shift, B)
        # re-derive freq view for channel 1 (the IMDCT destroys its input)
        for b in range(B):
            clt_mdct_backward(freq[b:], arr1, off1 + NB * b, OVERLAP,
                              shift, B)
    elif CC == 1 and C == 2:
        arr0, off0 = out_syn[0]
        denormalise_bands(X, 0, freq, oldBandE, 0, start, effEnd, M,
                          downsample, silence)
        freq2 = np.zeros(N, dtype=np.int64)
        denormalise_bands(X, N, freq2, oldBandE, NB_EBANDS, start, effEnd,
                          M, downsample, silence)
        freq = w32((freq >> 1) + (freq2 >> 1))
        for b in range(B):
            clt_mdct_backward(freq[b:], arr0, off0 + NB * b, OVERLAP,
                              shift, B)
    else:
        for c in range(CC):
            arr, off = out_syn[c]
            denormalise_bands(X, c * N, freq, oldBandE, c * NB_EBANDS,
                              start, effEnd, M, downsample, silence)
            for b in range(B):
                clt_mdct_backward(freq[b:], arr, off + NB * b, OVERLAP,
                                  shift, B)
    for c in range(CC):
        arr, off = out_syn[c]
        arr[off:off + N] = np.clip(arr[off:off + N], -SIG_SAT, SIG_SAT)


_COMB_GAINS = ((10048, 7112, 4248), (15200, 8784, 0), (26208, 3280, 0))
# QCONST16(0.3066406250f,15) etc (src/celt.cpp:855-858); rows by tapset


def comb_filter(buf, yoff: int, xoff: int, T0: int, T1: int, N: int,
                g0: int, g1: int, tapset0: int, tapset1: int) -> None:
    """(src/celt.cpp:848). In-place feedback comb filter over buf; x==y.
    Scalar model (sequential feedback when T < N)."""
    if g0 == 0 and g1 == 0:
        if yoff != xoff:
            buf[yoff:yoff + N] = buf[xoff:xoff + N]
        return
    overlap = OVERLAP
    T0 = max(T0, COMBFILTER_MINPERIOD)
    T1 = max(T1, COMBFILTER_MINPERIOD)
    g00 = MULT16_16_P15(g0, _COMB_GAINS[tapset0][0])
    g01 = MULT16_16_P15(g0, _COMB_GAINS[tapset0][1])
    g02 = MULT16_16_P15(g0, _COMB_GAINS[tapset0][2])
    g10 = MULT16_16_P15(g1, _COMB_GAINS[tapset1][0])
    g11 = MULT16_16_P15(g1, _COMB_GAINS[tapset1][1])
    g12 = MULT16_16_P15(g1, _COMB_GAINS[tapset1][2])
    x1 = int(buf[xoff - T1 + 1])
    x2 = int(buf[xoff - T1])
    x3 = int(buf[xoff - T1 - 1])
    x4 = int(buf[xoff - T1 - 2])
    if g0 == g1 and T0 == T1 and tapset0 == tapset1:
        overlap = 0
    i = 0
    while i < overlap:
        x0 = int(buf[xoff + i - T1 + 2])
        f = MULT16_16_Q15(int(_WINDOW[i]), int(_WINDOW[i]))
        y = int(buf[xoff + i]) \
            + MULT16_32_Q15(MULT16_16_Q15(32767 - f, g00),
                            int(buf[xoff + i - T0])) \
            + MULT16_32_Q15(MULT16_16_Q15(32767 - f, g01),
                            s32(int(buf[xoff + i - T0 + 1])
                                + int(buf[xoff + i - T0 - 1]))) \
            + MULT16_32_Q15(MULT16_16_Q15(32767 - f, g02),
                            s32(int(buf[xoff + i - T0 + 2])
                                + int(buf[xoff + i - T0 - 2]))) \
            + MULT16_32_Q15(MULT16_16_Q15(f, g10), x2) \
            + MULT16_32_Q15(MULT16_16_Q15(f, g11), s32(x1 + x3)) \
            + MULT16_32_Q15(MULT16_16_Q15(f, g12), s32(x0 + x4))
        y = max(-SIG_SAT, min(SIG_SAT, s32(y)))
        buf[yoff + i] = y
        x4, x3, x2, x1 = x3, x2, x1, x0
        i += 1
    if g1 == 0:
        if yoff != xoff:
            buf[yoff + overlap:yoff + N] = buf[xoff + overlap:xoff + N]
        return
    # constant filter part (src/celt.cpp:830): sequential feedback
    x4 = int(buf[xoff + i - T1 - 2])
    x3 = int(buf[xoff + i - T1 - 1])
    x2 = int(buf[xoff + i - T1])
    x1 = int(buf[xoff + i - T1 + 1])
    while i < N:
        x0 = int(buf[xoff + i - T1 + 2])
        y = int(buf[xoff + i]) + MULT16_32_Q15(g10, x2) \
            + MULT16_32_Q15(g11, s32(x1 + x3)) \
            + MULT16_32_Q15(g12, s32(x0 + x4))
        y = max(-SIG_SAT, min(SIG_SAT, s32(y)))
        buf[yoff + i] = y
        x4, x3, x2, x1 = x3, x2, x1, x0
        i += 1


PREEMPH_COEF = 27853  # m_CELTMode.preemph[0] (src/celt.cpp:634)
VERY_SMALL = 0


def sig2word16(x: int) -> int:
    x = (x + 2048) >> 12
    return max(-32768, min(32767, x))


def deemphasis(chans, pcm, N: int, C: int, downsample: int, mem,
               accum: int = 0) -> None:
    """(src/celt.cpp:1988). chans: list of (array, offset); pcm int16-range
    numpy array, interleaved C channels; mem: per-channel int32 state list.
    Scalar IIR model."""
    coef0 = PREEMPH_COEF
    Nd = N // downsample
    for c in range(C):
        arr, off = chans[c]
        m = int(mem[c])
        if downsample > 1:
            scratch = np.zeros(N, dtype=np.int64)
            for j in range(N):
                tmp = s32(int(arr[off + j]) + VERY_SMALL + m)
                m = MULT16_32_Q15(coef0, tmp)
                scratch[j] = tmp
            for j in range(Nd):
                v = sig2word16(int(scratch[j * downsample]))
                if accum:
                    pcm[j * C + c] = max(-32768, min(
                        32767, int(pcm[j * C + c]) + v))
                else:
                    pcm[j * C + c] = v
        else:
            for j in range(N):
                tmp = s32(int(arr[off + j]) + VERY_SMALL + m)
                m = MULT16_32_Q15(coef0, tmp)
                v = sig2word16(tmp)
                if accum:
                    pcm[j * C + c] = max(-32768, min(
                        32767, int(pcm[j * C + c]) + v))
                else:
                    pcm[j * C + c] = v
        mem[c] = m
