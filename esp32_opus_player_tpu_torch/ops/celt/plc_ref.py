"""Scalar CELT packet-loss concealment — the numpy semantic reference
for ops/celt/jax_plc.py (libopus 1.3.1 celt_decoder.c::celt_decode_lost,
pitch branch; the reference deleted this function, so lost CELT frames
play silence there — reference src/celt.cpp, pruned dispatch).

Float64 throughout (the libopus float build is the golden;
tests/test_celt_plc.py bounds the divergence). Operates in int16-scale
float: callers convert from the Q12 int32 decode_mem (x / 4096) and
back. The batched device twin lives in jax_plc.py; keep the two in
lockstep.

The port's copy of esp32_opus_player_tpu/ops/celt/plc_ref.py (numpy and
Python ints; nothing of the JAX package is imported).
"""
from __future__ import annotations

import numpy as np

from ..tables.celt_tables import window120

OVERLAP = 120
DBS = 2048
MAX_PERIOD = 1024
LPC_ORDER = 24
PLC_PITCH_LAG_MAX = 720
PLC_PITCH_LAG_MIN = 100

_WIN = np.asarray(window120, np.float64) / 32768.0
PREEMPH = 27853.0 / 32768.0


def autocorr(x, lag, window=None, overlap=0):
    xx = np.asarray(x, np.float64).copy()
    if window is not None and overlap:
        xx[:overlap] *= window[:overlap]
        xx[len(xx) - overlap:] *= window[:overlap][::-1]
    return np.array([np.dot(xx[:len(xx) - k], xx[k:]) if k
                     else np.dot(xx, xx) for k in range(lag + 1)])


def celt_lpc(ac, p):
    """Levinson-Durbin with the 30 dB bail-out
    (celt_lpc.c::_celt_lpc)."""
    lpc = np.zeros(p)
    error = ac[0]
    if ac[0] != 0:
        for i in range(p):
            rr = ac[i + 1]
            for j in range(i):
                rr += lpc[j] * ac[i - j]
            r = -rr / error
            lpc[i] = r
            for j in range((i + 1) >> 1):
                t1, t2 = lpc[j], lpc[i - 1 - j]
                lpc[j] = t1 + r * t2
                lpc[i - 1 - j] = t2 + r * t1
            error -= r * r * error
            if error < 0.001 * ac[0]:
                break
    return lpc


def _fir(xh, num, n, ord_):
    """y[i] = x[i] + sum num[k]*x[i-k-1]; xh carries ord_ history."""
    y = np.zeros(n)
    for i in range(n):
        s = xh[ord_ + i]
        for k in range(ord_):
            s += num[k] * xh[ord_ + i - k - 1]
        y[i] = s
    return y


def _iir(x, den, mem, n, ord_):
    """y[i] = x[i] - sum den[k]*y[i-k-1]; mem[k] = y[-k-1]."""
    y = np.zeros(n + ord_)
    y[:ord_] = mem[::-1]
    for i in range(n):
        s = x[i]
        for k in range(ord_):
            s -= den[k] * y[ord_ + i - k - 1]
        y[ord_ + i] = s
    return y[ord_:]


def _find_best_pitch(xcorr, y, length, max_pitch):
    Syy = 1.0 + np.dot(y[:length], y[:length])
    bn = [-1.0, -1.0]
    bd = [0.0, 0.0]
    bp = [0, 1]
    for i in range(max_pitch):
        if xcorr[i] > 0:
            x16 = xcorr[i] * 1e-12
            num = x16 * x16
            if num * bd[1] > bn[1] * Syy:
                if num * bd[0] > bn[0] * Syy:
                    bn[1], bd[1], bp[1] = bn[0], bd[0], bp[0]
                    bn[0], bd[0], bp[0] = num, Syy, i
                else:
                    bn[1], bd[1], bp[1] = num, Syy, i
        Syy += y[i + length] ** 2 - y[i] ** 2
        Syy = max(1.0, Syy)
    return bp


def pitch_search(x_lp, y, length, max_pitch):
    lag = length + max_pitch
    n4, mp4 = length >> 2, max_pitch >> 2
    n2, mp2 = length >> 1, max_pitch >> 1
    x4 = x_lp[:2 * n4:2]
    y4 = y[:2 * (lag >> 2):2]
    xc4 = np.array([np.dot(x4, y4[i:i + n4]) for i in range(mp4)])
    bp = _find_best_pitch(xc4, y4, n4, mp4)
    xc = np.zeros(mp2)
    for i in range(mp2):
        if abs(i - 2 * bp[0]) > 2 and abs(i - 2 * bp[1]) > 2:
            continue
        xc[i] = max(-1.0, np.dot(x_lp[:n2], y[i:i + n2]))
    bp = _find_best_pitch(xc, y, n2, mp2)
    b0 = bp[0]
    off = 0
    if 0 < b0 < mp2 - 1:
        a, b, c = xc[b0 - 1], xc[b0], xc[b0 + 1]
        if (c - a) > 0.7 * (b - a):
            off = 1
        elif (a - c) > 0.7 * (b - c):
            off = -1
    return 2 * b0 - off


def pitch_downsample(chans, length):
    """pitch.c::pitch_downsample — 2x decimate + order-4 whitening."""
    hl = length >> 1
    x_lp = np.zeros(hl)
    for x in chans:
        x = np.asarray(x, np.float64)
        i = np.arange(1, hl)
        x_lp[1:] += 0.25 * (x[2 * i - 1] + x[2 * i + 1]) \
            + 0.5 * x[2 * i]
        x_lp[0] += 0.25 * x[1] + 0.5 * x[0]
    ac = autocorr(x_lp, 4)
    ac[0] *= 1.0001
    for i in range(1, 5):
        ac[i] -= ac[i] * (0.008 * i) ** 2
    lpc = celt_lpc(ac, 4)
    tmp = 1.0
    for i in range(4):
        tmp *= 0.9
        lpc[i] *= tmp
    c1 = 0.8
    lpc2 = np.array([lpc[0] + 0.8, lpc[1] + c1 * lpc[0],
                     lpc[2] + c1 * lpc[1], lpc[3] + c1 * lpc[2],
                     c1 * lpc[3]])
    return _fir(np.concatenate([np.zeros(5), x_lp]), lpc2, hl, 5)


def plc_pitch_search(chans):
    lp = pitch_downsample(chans, DBS)
    pi = pitch_search(lp[PLC_PITCH_LAG_MAX >> 1:], lp,
                      DBS - PLC_PITCH_LAG_MAX,
                      PLC_PITCH_LAG_MAX - PLC_PITCH_LAG_MIN)
    return PLC_PITCH_LAG_MAX - pi


def conceal(dm, first: bool, state: dict, N: int = 960):
    """One concealed frame over dm (CC, DBS+OVERLAP) float (int16
    scale), in place. state carries pitch + per-channel lpc across a
    loss burst. Returns the (CC, N) synthesized region."""
    CC = dm.shape[0]
    if first:
        state["pitch"] = plc_pitch_search(
            [dm[c][:DBS] for c in range(CC)])
        fade = 1.0
    else:
        fade = 0.8
    T = int(state["pitch"])
    exc_length = min(2 * T, MAX_PERIOD)
    out = np.zeros((CC, N))
    for c in range(CC):
        buf = dm[c]
        _exc = buf[DBS - MAX_PERIOD - LPC_ORDER:DBS].copy()
        exc = _exc[LPC_ORDER:]
        if first:
            ac = autocorr(exc, LPC_ORDER, _WIN, OVERLAP)
            ac[0] *= 1.0001
            for i in range(1, LPC_ORDER + 1):
                ac[i] -= ac[i] * (0.008 * i) ** 2
            state.setdefault("lpc", {})[c] = celt_lpc(ac, LPC_ORDER)
        lpc = state["lpc"][c]
        exc[MAX_PERIOD - exc_length:] = _fir(
            _exc[MAX_PERIOD - exc_length:], lpc, exc_length, LPC_ORDER)
        dl = exc_length >> 1
        E1 = 1.0 + np.dot(exc[MAX_PERIOD - dl:], exc[MAX_PERIOD - dl:])
        E2 = 1.0 + np.dot(exc[MAX_PERIOD - 2 * dl:MAX_PERIOD - dl],
                          exc[MAX_PERIOD - 2 * dl:MAX_PERIOD - dl])
        decay = np.sqrt(min(E1, E2) / E2)
        buf[:DBS - N] = buf[N:DBS]
        eoff = MAX_PERIOD - T
        elen = N + OVERLAP
        att = fade * decay
        S1 = 0.0
        j = 0
        ex = np.zeros(elen)
        for i in range(elen):
            if j >= T:
                j -= T
                att *= decay
            ex[i] = att * exc[eoff + j]
            tmp = buf[DBS - MAX_PERIOD - N + eoff + j]
            S1 += tmp * tmp / 1024.0
            j += 1
        lpc_mem = np.array([buf[DBS - N - 1 - i]
                            for i in range(LPC_ORDER)])
        syn = _iir(ex, lpc, lpc_mem, elen, LPC_ORDER)
        S2 = np.dot(syn, syn) / 1024.0
        if not (S1 > 0.25 * S2):
            syn[:] = 0.0
        elif S1 < S2:
            ratio = np.sqrt((S1 / 2 + 1) / (S2 / 2 + 1))
            syn[:OVERLAP] *= 1.0 - _WIN * (1.0 - ratio)
            syn[OVERLAP:] *= ratio
        buf[DBS - N:DBS] = syn[:N]
        etmp = syn[N:N + OVERLAP]
        i = np.arange(OVERLAP // 2)
        buf[DBS + i] = _WIN[i] * etmp[OVERLAP - 1 - i] \
            + _WIN[OVERLAP - 1 - i] * etmp[i]
        out[c] = syn[:N]
    return out
