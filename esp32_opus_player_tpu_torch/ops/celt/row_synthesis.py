"""Row-layout CELT frame synthesis in plain torch: streams on dim 0,
time/frequency on the last dim.

Port of the row functions of esp32_opus_player_tpu/ops/celt/
jax_synthesis.py: `denormalise_bands_b` (:74), the iMDCT
`celt_imdct_frame` (:378) with its pre-rotation, kiss FFT
(`opus_fft_batch`), post-rotation and TDAC, `comb_filter_batch` (:421)
and `deemphasis_batch` (:518). It is the plain version of
models/batch_celt.py's row-layout step on CPU tensors; on the card that
step transposes and runs the hand-written kernels K1-K3
(ops/celt/synthesis_T.py). Reference: src/celt.cpp denormalise_bands
:948, clt_mdct_backward :3204, opus_fft_impl :2997, comb_filter :848,
deemphasis :1988. Every int32 sum wraps as two's complement.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..tables.celt_tables import fft_twiddles48000_960
from .fft import FFT_STATES
from .torch_synthesis import (COMBFILTER_MINPERIOD, EB, EMEANS, I32,
                              MAX_PERIOD, NB_EBANDS, OVERLAP,
                              PREEMPH_COEF, SHORT_MDCT_SIZE, SIG_SAT, TRIG,
                              WINDOW, const, exp2_frac, mult16_16_p15,
                              mult16_16_q15, smul)

_TW = np.asarray(fft_twiddles48000_960, dtype=np.int32)
_COMB_GAINS = np.array([[10048, 7112, 4248], [15200, 8784, 0],
                        [26208, 3280, 0]], dtype=np.int32)
# crossfade factor per in-call index (window^2 >> 15)
_F_TAB = (np.asarray(WINDOW, np.int64) ** 2 >> 15).astype(np.int32)


def _idx(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)


# ---------------------------------------------------------------------
# denormalise_bands
# ---------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _bin_band(M: int, device):
    bin_band = np.zeros(M * SHORT_MDCT_SIZE, dtype=np.int64)
    for i in range(NB_EBANDS):
        bin_band[M * EB[i]:M * EB[i + 1]] = i
    return _idx(bin_band, device)


def denormalise_bands_b(X, bandLogE, start, end, M: int,
                        downsample: int = 1):
    """Denormalise one channel (src/celt.cpp:948): X (B, N) int32 Q14,
    bandLogE (B, 21) int32 Q10, start/end (B,). Returns freq (B, N).
    downsample > 1 caps the spectral bound at N/downsample (the
    reference's anti-alias clamp, src/celt.cpp:957)."""
    N = M * SHORT_MDCT_SIZE
    dev = X.device
    lg = (bandLogE + (const(EMEANS[:NB_EBANDS], dev) << 6)[None, :]).clamp(
        -32768, 32767)
    shift = 16 - (lg >> 10)
    g = exp2_frac(lg & 1023)
    big = shift > 31          # -> g = 0, shift = 0
    neg2 = shift <= -2        # -> g = 16384, shift = -2
    g = torch.where(big, 0, torch.where(neg2, 16384, g))
    shift = torch.where(big, 0, torch.where(neg2, -2, shift))
    bin_band = _bin_band(M, dev)
    gb = g[:, bin_band]                                   # (B, N)
    sb = shift[:, bin_band]
    prod = X * gb
    f = torch.where(sb >= 0, prod >> sb.clamp(min=0),
                    torch.bitwise_left_shift(prod, (-sb).clamp(min=0)))
    band = bin_band[None, :]
    active = (band >= start[:, None]) & (band < end[:, None])
    ends = const(EB, dev)[end.long()] * M
    if downsample > 1:
        ends = ends.clamp(max=N // downsample)
    active &= torch.arange(N, device=dev)[None, :] < ends[:, None]
    return torch.where(active, f, 0)


# ---------------------------------------------------------------------
# kiss FFT over the last dim (jax_synthesis._kf_bfly*, opus_fft_batch)
# ---------------------------------------------------------------------

def _c_mul(ar, ai, br, bi):
    return smul(ar, br) - smul(ai, bi), smul(ar, bi) + smul(ai, br)


def _tw(idx, device):
    return const(_TW[idx, 0], device), const(_TW[idx, 1], device)


def _assemble(parts, idx_list, nfft: int):
    """parts[q] lands at positions idx_list[q] (a static permutation)."""
    flat = torch.cat([p.reshape(p.shape[:-2] + (-1,)) for p in parts],
                     dim=-1)
    order = np.concatenate([ix.ravel() for ix in idx_list])
    perm = np.empty(nfft, dtype=np.int64)
    perm[order] = np.arange(len(order))
    return flat[..., _idx(perm, flat.device)]


def _kf_bfly2(r, i_, Nblk: int):
    tw = 23170
    r = r.reshape(r.shape[:-1] + (Nblk, 8))
    i_ = i_.reshape(i_.shape[:-1] + (Nblk, 8))
    f0r, f0i = r[..., 0:4], i_[..., 0:4]
    f2r, f2i = r[..., 4:8], i_[..., 4:8]
    t1r = smul(f2r[..., 1] + f2i[..., 1], tw)
    t1i = smul(f2i[..., 1] - f2r[..., 1], tw)
    t3r = smul(f2i[..., 3] - f2r[..., 3], tw)
    t3i = smul(-(f2i[..., 3] + f2r[..., 3]), tw)
    tr = torch.stack([f2r[..., 0], t1r, f2i[..., 2], t3r], dim=-1)
    ti = torch.stack([f2i[..., 0], t1i, -f2r[..., 2], t3i], dim=-1)
    newr = torch.cat([f0r + tr, f0r - tr], dim=-1)
    newi = torch.cat([f0i + ti, f0i - ti], dim=-1)
    return (newr.reshape(r.shape[:-2] + (Nblk * 8,)),
            newi.reshape(r.shape[:-2] + (Nblk * 8,)))


def _kf_bfly4(r, i_, fstride, m, Nblk, mm, nfft):
    dev = r.device
    if m == 1:
        idx = np.arange(Nblk)[:, None] * mm + np.arange(4)[None, :]
        fr = r[..., _idx(idx, dev)]
        fi = i_[..., _idx(idx, dev)]
        s0r = fr[..., 0] - fr[..., 2]
        s0i = fi[..., 0] - fi[..., 2]
        f0r = fr[..., 0] + fr[..., 2]
        f0i = fi[..., 0] + fi[..., 2]
        s1r = fr[..., 1] + fr[..., 3]
        s1i = fi[..., 1] + fi[..., 3]
        d1r = fr[..., 1] - fr[..., 3]
        d1i = fi[..., 1] - fi[..., 3]
        idxs = [idx[:, q:q + 1] for q in range(4)]
        r = _assemble([(f0r + s1r)[..., None], (s0r + d1i)[..., None],
                       (f0r - s1r)[..., None], (s0r - d1i)[..., None]],
                      idxs, nfft)
        i_ = _assemble([(f0i + s1i)[..., None], (s0i - d1r)[..., None],
                        (f0i - s1i)[..., None], (s0i + d1r)[..., None]],
                       idxs, nfft)
        return r, i_
    j = np.arange(m)
    tw1r, tw1i = _tw(j * fstride, dev)
    tw2r, tw2i = _tw(j * fstride * 2, dev)
    tw3r, tw3i = _tw(j * fstride * 3, dev)
    base = np.arange(Nblk)[:, None] * mm + j[None, :]
    f0, f1, f2, f3 = base, base + m, base + 2 * m, base + 3 * m
    g = lambda x, f: x[..., _idx(f, dev)]
    s0r, s0i = _c_mul(g(r, f1), g(i_, f1), tw1r, tw1i)
    s1r, s1i = _c_mul(g(r, f2), g(i_, f2), tw2r, tw2i)
    s2r, s2i = _c_mul(g(r, f3), g(i_, f3), tw3r, tw3i)
    s5r = g(r, f0) - s1r
    s5i = g(i_, f0) - s1i
    f0r = g(r, f0) + s1r
    f0i = g(i_, f0) + s1i
    s3r, s3i = s0r + s2r, s0i + s2i
    s4r, s4i = s0r - s2r, s0i - s2i
    idxs = [f0, f1, f2, f3]
    return (_assemble([f0r + s3r, s5r + s4i, f0r - s3r, s5r - s4i], idxs,
                      nfft),
            _assemble([f0i + s3i, s5i - s4r, f0i - s3i, s5i + s4r], idxs,
                      nfft))


def _kf_bfly3(r, i_, fstride, m, Nblk, mm, nfft):
    dev = r.device
    epi3i = -28378
    j = np.arange(m)
    tw1r, tw1i = _tw(j * fstride, dev)
    tw2r, tw2i = _tw(j * fstride * 2, dev)
    base = np.arange(Nblk)[:, None] * mm + j[None, :]
    f0, f1, f2 = base, base + m, base + 2 * m
    g = lambda x, f: x[..., _idx(f, dev)]
    s1r, s1i = _c_mul(g(r, f1), g(i_, f1), tw1r, tw1i)
    s2r, s2i = _c_mul(g(r, f2), g(i_, f2), tw2r, tw2i)
    s3r, s3i = s1r + s2r, s1i + s2i
    s0r, s0i = s1r - s2r, s1i - s2i
    f1r = g(r, f0) - (s3r >> 1)
    f1i = g(i_, f0) - (s3i >> 1)
    s0r, s0i = smul(s0r, epi3i), smul(s0i, epi3i)
    idxs = [f0, f1, f2]
    return (_assemble([g(r, f0) + s3r, f1r - s0i, f1r + s0i], idxs, nfft),
            _assemble([g(i_, f0) + s3i, f1i + s0r, f1i - s0r], idxs, nfft))


def _kf_bfly5(r, i_, fstride, m, Nblk, mm, nfft):
    dev = r.device
    yar, yai, ybr, ybi = 10126, -31164, -26510, -19261
    u = np.arange(m)
    t1r, t1i = _tw(u * fstride, dev)
    t2r, t2i = _tw(2 * u * fstride, dev)
    t3r, t3i = _tw(3 * u * fstride, dev)
    t4r, t4i = _tw(4 * u * fstride, dev)
    base = np.arange(Nblk)[:, None] * mm + u[None, :]
    f0, f1, f2, f3, f4 = (base + q * m for q in range(5))
    g = lambda x, f: x[..., _idx(f, dev)]
    s0r, s0i = g(r, f0), g(i_, f0)
    s1r, s1i = _c_mul(g(r, f1), g(i_, f1), t1r, t1i)
    s2r, s2i = _c_mul(g(r, f2), g(i_, f2), t2r, t2i)
    s3r, s3i = _c_mul(g(r, f3), g(i_, f3), t3r, t3i)
    s4r, s4i = _c_mul(g(r, f4), g(i_, f4), t4r, t4i)
    s7r, s7i = s1r + s4r, s1i + s4i
    s10r, s10i = s1r - s4r, s1i - s4i
    s8r, s8i = s2r + s3r, s2i + s3i
    s9r, s9i = s2r - s3r, s2i - s3i
    o0r = s0r + (s7r + s8r)
    o0i = s0i + (s7i + s8i)
    s5r = s0r + (smul(s7r, yar) + smul(s8r, ybr))
    s5i = s0i + (smul(s7i, yar) + smul(s8i, ybr))
    s6r = smul(s10i, yai) + smul(s9i, ybi)
    s6i = -(smul(s10r, yai) + smul(s9r, ybi))
    s11r = s0r + (smul(s7r, ybr) + smul(s8r, yar))
    s11i = s0i + (smul(s7i, ybr) + smul(s8i, yar))
    s12r = smul(s9i, yai) - smul(s10i, ybi)
    s12i = smul(s10r, ybi) - smul(s9r, yai)
    idxs = [f0, f1, f2, f3, f4]
    return (_assemble([o0r, s5r - s6r, s11r + s12r, s11r - s12r, s5r + s6r],
                      idxs, nfft),
            _assemble([o0i, s5i - s6i, s11i + s12i, s11i - s12i, s5i + s6i],
                      idxs, nfft))


def opus_fft_batch(shift: int, r, i_):
    """opus_fft_impl (src/celt.cpp:2997) over leading batch dims."""
    st = FFT_STATES[shift]
    sh = st.shift if st.shift > 0 else 0
    factors = st.factors
    fstride = [1]
    for p, _ in factors:
        fstride.append(fstride[-1] * p)
    for lvl in range(len(factors) - 1, -1, -1):
        m2 = factors[lvl - 1][1] if lvl != 0 else 1
        p, m = factors[lvl]
        fs = fstride[lvl]
        if p == 2:
            r, i_ = _kf_bfly2(r, i_, fs)
        else:
            bfly = {3: _kf_bfly3, 4: _kf_bfly4, 5: _kf_bfly5}[p]
            r, i_ = bfly(r, i_, fs << sh, m, fs, m2, st.nfft)
    return r, i_


# ---------------------------------------------------------------------
# iMDCT
# ---------------------------------------------------------------------

def _trig_off(shift: int) -> int:
    return sum(1920 >> s for s in range(1, shift + 1))


def imdct_prerotate(freq, shift: int, stride: int, b: int):
    """Pre-rotate block b (src/celt.cpp:3221-3240): freq (B, N). Returns
    (rbuf, ibuf) (B, N4) in bitrev order."""
    dev = freq.device
    N = 1920 >> shift
    N2, N4 = N >> 1, N >> 2
    off = _trig_off(shift)
    idx = np.arange(N4)
    t0 = const(TRIG[off + idx], dev)
    t1 = const(TRIG[off + N4 + idx], dev)
    xp1 = freq[..., _idx(b + 2 * stride * idx, dev)]
    xp2 = freq[..., _idx(b + stride * (N2 - 1) - 2 * stride * idx, dev)]
    yr = smul(xp2, t0) + smul(xp1, t1)
    yi = smul(xp1, t0) - smul(xp2, t1)
    inv = np.empty(N4, dtype=np.int64)
    inv[FFT_STATES[shift].bitrev] = np.arange(N4)
    inv = _idx(inv, dev)
    return yi[..., inv], yr[..., inv]


def imdct_postrotate(rbuf, ibuf, shift: int):
    """Post-rotate (src/celt.cpp:3244-3280). Returns (B, N2)."""
    dev = rbuf.device
    N = 1920 >> shift
    N2, N4 = N >> 1, N >> 2
    off = _trig_off(shift)
    i = np.arange(N4)
    t0 = const(TRIG[off + i], dev)
    t1 = const(TRIG[off + N4 + i], dev)
    yr = smul(ibuf, t0) + smul(rbuf, t1)
    yi = smul(ibuf, t1) - smul(rbuf, t0)
    out = torch.zeros(rbuf.shape[:-1] + (N2,), dtype=I32, device=dev)
    out[..., _idx(2 * i, dev)] = yr
    out[..., _idx(N2 - 1 - 2 * i, dev)] = yi
    return out


def imdct_tdac(hist_half, block):
    """TDAC mirror (src/celt.cpp:3283-3296): hist_half (B, OVERLAP/2), the
    samples at the block's start, block (B, N2) post-rotated. Returns
    (B, OVERLAP/2 + N2): the first OVERLAP mixed, the rest passed."""
    ov = OVERLAP
    full = torch.cat([hist_half, block], dim=-1)
    x2 = full[..., :ov // 2]
    x1 = full[..., ov // 2:ov].flip(-1)
    wp1 = const(WINDOW[:ov // 2], full.device)
    wp2 = const(WINDOW[ov // 2:][::-1], full.device)
    lo = smul(x2, wp2) - smul(x1, wp1)
    hi = smul(x2, wp1) + smul(x1, wp2)
    return torch.cat([lo, hi.flip(-1), full[..., ov:]], dim=-1)


def celt_imdct_frame(freq, hist, LM: int, transient: bool):
    """Whole-frame iMDCT with overlap (the block loop, src/celt.cpp:2057):
    freq (B, N), hist (B, OVERLAP/2) the previous unwindowed tail.
    Returns (B, N + OVERLAP/2): N finished samples, then the new tail."""
    N = SHORT_MDCT_SIZE << LM
    if transient:
        Bblk, NB, shift = 1 << LM, SHORT_MDCT_SIZE, 3
    else:
        Bblk, NB, shift = 1, N, 3 - LM
    parts, cur = [], hist
    for b in range(Bblk):
        rbuf, ibuf = imdct_prerotate(freq, shift, Bblk, b)
        rbuf, ibuf = opus_fft_batch(shift, rbuf, ibuf)
        region = imdct_tdac(cur, imdct_postrotate(rbuf, ibuf, shift))
        parts.append(region[..., :NB])
        cur = region[..., NB:NB + OVERLAP // 2]
    return torch.cat(parts + [cur], dim=-1)


# ---------------------------------------------------------------------
# comb postfilter and deemphasis
# ---------------------------------------------------------------------

def comb_filter_batch(buf, start: int, N: int, T0, T1, g0, g1, tapset0,
                      tapset1):
    """Feedback comb over buf[:, start:start+N] (src/celt.cpp:848), in
    feedback-safe chunks (every tap lies >= T - 2 >= 13 samples back).
    buf (B, L) int32 with at least MAX_PERIOD + 2 samples before start;
    the params (B,) int32. Returns a new buffer."""
    dev = buf.device
    buf = buf.clone()
    gains = const(_COMB_GAINS, dev)
    T0 = T0.clamp(COMBFILTER_MINPERIOD, MAX_PERIOD)
    T1 = T1.clamp(COMBFILTER_MINPERIOD, MAX_PERIOD)
    ga, gb = gains[tapset0.long()], gains[tapset1.long()]
    g00, g01, g02 = (mult16_16_p15(g0, ga[:, k]) for k in range(3))
    g10, g11, g12 = (mult16_16_p15(g1, gb[:, k]) for k in range(3))
    same = ((g0 == g1) & (T0 == T1) & (tapset0 == tapset1))[:, None]
    nop = ((g0 == 0) & (g1 == 0))[:, None]
    g1z = (g1 == 0)[:, None]
    f_tab = const(_F_TAB, dev)
    CH = min(COMBFILTER_MINPERIOD - 2, N)
    win = torch.arange(CH + 4, device=dev)[None, :]
    T0, T1 = T0.long()[:, None], T1.long()[:, None]
    col = lambda v: v[:, None]
    for i0 in range(0, N, CH):
        n = min(CH, N - i0)
        rel = i0 + torch.arange(n, device=dev)[None, :]    # in-call index
        w0 = buf.gather(1, start + i0 - 2 - T0 + win[:, :n + 4])
        w1 = buf.gather(1, start + i0 - 2 - T1 + win[:, :n + 4])
        x = buf[:, start + i0:start + i0 + n]
        f = f_tab[rel.clamp(max=OVERLAP - 1)]
        use_ov = (rel < OVERLAP) & ~same
        fc = torch.where(use_ov, f, 0)
        fa = 32767 - fc
        y_ov = (x
                + smul(w0[:, 2:n + 2], mult16_16_q15(fa, col(g00)))
                + smul(w0[:, 3:n + 3] + w0[:, 1:n + 1],
                       mult16_16_q15(fa, col(g01)))
                + smul(w0[:, 4:n + 4] + w0[:, 0:n],
                       mult16_16_q15(fa, col(g02)))
                + smul(w1[:, 2:n + 2], mult16_16_q15(fc, col(g10)))
                + smul(w1[:, 3:n + 3] + w1[:, 1:n + 1],
                       mult16_16_q15(fc, col(g11)))
                + smul(w1[:, 4:n + 4] + w1[:, 0:n],
                       mult16_16_q15(fc, col(g12))))
        y_const = (x + smul(w1[:, 2:n + 2], col(g10))
                   + smul(w1[:, 3:n + 3] + w1[:, 1:n + 1], col(g11))
                   + smul(w1[:, 4:n + 4] + w1[:, 0:n], col(g12)))
        y = torch.where(use_ov, y_ov, y_const).clamp(-SIG_SAT, SIG_SAT)
        keep = nop | (g1z & ~use_ov)
        buf[:, start + i0:start + i0 + n] = torch.where(keep, x, y)
    return buf


def deemphasis_batch(syn, mem, downsample: int = 1):
    """First-order IIR and Q12 rounding (src/celt.cpp:1988): syn (B, C,
    N) int32, mem (B, C) int32. Returns (pcm (B, C, N//downsample) int32
    in int16 range, mem'). The IIR runs at 48 kHz and keeps every
    downsample-th sample (src/celt.cpp:2000-2013)."""
    N = syn.shape[-1]
    tmp = torch.empty_like(syn)
    m = mem
    for n in range(N):
        t = syn[..., n] + m
        m = smul(t, PREEMPH_COEF)
        tmp[..., n] = t
    pcm = ((tmp + 2048) >> 12).clamp(-32768, 32767)
    if downsample > 1:
        pcm = pcm[..., ::downsample].contiguous()
    return pcm, m
