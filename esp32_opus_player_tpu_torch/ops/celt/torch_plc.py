"""CELT pitch-repeat packet-loss concealment, float32: the plain version
of kernel P1 (ops/celt/plc_kernel.py).

Port of esp32_opus_player_tpu/ops/celt/jax_plc.py (libopus 1.3.1
celt_decoder.c::celt_decode_lost, pitch branch; the reference deleted
it): a pitch search over the decode history (2x downsample, LPC-4
whitening, 4x-decimated cross-correlation, 2x refinement around the two
best candidates, pseudo-interpolation), an order-24 LPC fit per channel,
one period of the whitened excitation extrapolated with a per-period
decay and re-synthesised through 1/A(z), an energy clamp, the TDAC blend
of the overlap tail and the float deemphasis. Every value is float32;
the scans of the JAX functions are loops over time on (R,) tensors.

Where the JAX function leaves an order open the port fixes one that the
kernel repeats: the 0.9^k and decay^(1 + w) factors are running
products, not pow, and the 2x refinement computes only the lags within
+-2 of the two candidates (the JAX function computes every lag and
zeroes the rest, so the result is the same). Sums are taken in torch's
own order, the kernel's in its own: the two agree to float32 rounding,
not bit for bit (the North star's float32 rule, ROADMAP.md).

Nothing here makes a host tensor or synchronises with the device after
the first call on a device (the constants are cached), so a call can be
captured in a CUDA graph.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..tables.celt_tables import window120
from .torch_synthesis import DECODE_BUFFER_SIZE as DBS, OVERLAP

MAX_PERIOD = 1024
LPC_ORDER = 24
PLC_PITCH_LAG_MAX = 720
PLC_PITCH_LAG_MIN = 100
N = 960                        # the 20 ms frame the conceal fills (LM 3)
ELEN = N + OVERLAP
F32 = torch.float32

_WIN = np.asarray(window120, np.float32) / np.float32(32768.0)
_PRE = 27853.0 / 32768.0       # the 0.85 deemphasis coefficient, exact


def _running_powers(x: np.float32, n: int) -> np.ndarray:
    """x, x*x, ... (n values), each a float32 product of the one before."""
    out = np.empty(n, np.float32)
    p = np.float32(x)
    for k in range(n):
        out[k] = p
        p = np.float32(p * np.float32(x))
    return out


def _lag_window(order: int) -> np.ndarray:
    """1 - (0.008 k)^2 for k = 1..order, in float32."""
    t = np.float32(0.008) * np.arange(1, order + 1, dtype=np.float32)
    return np.float32(1.0) - t * t


@functools.lru_cache(maxsize=None)
def _consts(device) -> dict:
    dev = torch.device(device)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    return dict(win=t(_WIN), lagw4=t(_lag_window(4)),
                lagw24=t(_lag_window(LPC_ORDER)),
                g09=t(_running_powers(np.float32(0.9), 4)),
                iota_mp=torch.arange(MAX_PERIOD, device=dev),
                iota_el=torch.arange(ELEN, device=dev),
                cand=torch.arange(-2, 3, device=dev))


# ------------------------------------------------------------ helpers
def _autocorr(x, lag: int, window=None, overlap: int = 0):
    """ac[k] = sum x[i] x[i+k], k = 0..lag, with `overlap` samples at
    both ends windowed (celt_lpc.c::_celt_autocorr)."""
    if window is not None and overlap:
        n = x.shape[1]
        x = torch.cat([x[:, :overlap] * window[:overlap],
                       x[:, overlap:n - overlap],
                       x[:, n - overlap:] * window[:overlap].flip(0)], 1)
    n = x.shape[1]
    return torch.stack([(x[:, :n - k] * x[:, k:]).sum(1)
                        for k in range(lag + 1)], 1)


def _celt_lpc(ac, p: int):
    """Levinson-Durbin (celt_lpc.c::_celt_lpc) over rows: a row stops at
    its 30 dB bail-out (its `done` flag)."""
    R = ac.shape[0]
    lpc = [ac.new_zeros(R) for _ in range(p)]
    error = ac[:, 0]
    done = ac[:, 0] == 0
    for i in range(p):
        rr = ac[:, i + 1]
        for j in range(i):
            rr = rr + lpc[j] * ac[:, i - j]
        r = -rr / torch.where(error != 0, error, 1.0)
        r = torch.where(done, 0.0, r)
        new = list(lpc)
        new[i] = r
        for j in range((i + 1) >> 1):
            t1, t2 = new[j], new[i - 1 - j]
            new[j] = t1 + r * t2
            new[i - 1 - j] = t2 + r * t1
        lpc = [torch.where(done, a, b) for a, b in zip(lpc, new)]
        error = torch.where(done, error, error - r * r * error)
        done = done | (error < 0.001 * ac[:, 0])
    return torch.stack(lpc, 1)


def _fir_shifted(xh, num, hist):
    """y[i] = x[i] + sum_k num[k] x[i-k-1], k in order (celt_lpc.c::
    celt_fir over past inputs); hist (R, ord) holds the ord samples
    before xh[:, 0]."""
    full = torch.cat([hist, xh], 1)
    ordn, n = num.shape[1], xh.shape[1]
    y = xh
    for k in range(ordn):
        y = y + num[:, k:k + 1] * full[:, ordn - k - 1:ordn - k - 1 + n]
    return y


def _find_best_pitch(xcorr, y, length: int, max_pitch: int):
    """pitch.c::find_best_pitch: the two best lags by normalised squared
    correlation, a sequential scan with a running window energy."""
    R = y.shape[0]
    Syy = 1.0 + (y[:, :length] * y[:, :length]).sum(1)
    e_in = y[:, length:length + max_pitch] * y[:, length:length + max_pitch]
    e_out = y[:, :max_pitch] * y[:, :max_pitch]
    bn0 = y.new_full((R,), -1.0)
    bn1 = y.new_full((R,), -1.0)
    bd0 = y.new_zeros(R)
    bd1 = y.new_zeros(R)
    bp0 = torch.zeros(R, dtype=torch.int32, device=y.device)
    bp1 = torch.ones(R, dtype=torch.int32, device=y.device)
    for i in range(max_pitch):
        xc = xcorr[:, i]
        x16 = xc * 1e-12
        num = x16 * x16
        c1 = (xc > 0) & (num * bd1 > bn1 * Syy)
        c0 = c1 & (num * bd0 > bn0 * Syy)
        bn1 = torch.where(c0, bn0, torch.where(c1, num, bn1))
        bd1 = torch.where(c0, bd0, torch.where(c1, Syy, bd1))
        bp1 = torch.where(c0, bp0, torch.where(c1, i, bp1))
        bn0 = torch.where(c0, num, bn0)
        bd0 = torch.where(c0, Syy, bd0)
        bp0 = torch.where(c0, i, bp0)
        Syy = torch.clamp_min(Syy + e_in[:, i] - e_out[:, i], 1.0)
    return bp0, bp1


def _corr(y, x, out_len: int):
    """out[r, i] = sum_n x[r, n] y[r, i + n], i < out_len
    (celt_pitch_xcorr)."""
    win = y.unfold(1, x.shape[1], 1)[:, :out_len]
    return torch.matmul(win, x[:, :, None])[:, :, 0]


def _pitch_search(x_lp, y, length: int, max_pitch: int):
    """pitch.c::pitch_search at the conceal's operating point (inputs
    already 2x-decimated; length and max_pitch at the full rate)."""
    R = x_lp.shape[0]
    lag = length + max_pitch
    n4, mp4 = length >> 2, max_pitch >> 2
    n2, mp2 = length >> 1, max_pitch >> 1
    x4 = x_lp[:, :2 * n4:2]
    y4 = y[:, :2 * (lag >> 2):2]
    bp0, bp1 = _find_best_pitch(_corr(y4, x4, mp4), y4, n4, mp4)
    # refine at 2x over the lags within +-2 of the doubled candidates;
    # every other lag stays 0 (the reference skips them)
    c = _consts(x_lp.device)["cand"]
    lags = torch.cat([2 * bp0[:, None] + c, 2 * bp1[:, None] + c], 1)
    ok = (lags >= 0) & (lags < mp2)
    win = y.unfold(1, n2, 1)[torch.arange(R, device=y.device)[:, None],
                             lags.clamp(0, mp2 - 1)]
    dots = torch.matmul(win, x_lp[:, :n2, None])[:, :, 0].clamp_min(-1.0)
    xc = y.new_zeros((R, mp2 + 1))
    xc.scatter_(1, torch.where(ok, lags, mp2).long(),
                torch.where(ok, dots, 0.0))
    xc = xc[:, :mp2]
    b0, _ = _find_best_pitch(xc, y, n2, mp2)
    b0 = b0.long()
    a = xc.gather(1, (b0 - 1).clamp_min(0)[:, None])[:, 0]
    b = xc.gather(1, b0[:, None])[:, 0]
    cc = xc.gather(1, (b0 + 1).clamp_max(mp2 - 1)[:, None])[:, 0]
    off = torch.where((cc - a) > 0.7 * (b - a), 1,
                      torch.where((a - cc) > 0.7 * (b - cc), -1, 0))
    off = torch.where((b0 > 0) & (b0 < mp2 - 1), off, 0)
    return 2 * b0 - off


def _plc_pitch_search(chans):
    """celt_decoder.c::celt_plc_pitch_search: 2x downsample and whitening
    (pitch.c::pitch_downsample), then the search. chans (R, CC, DBS)."""
    k = _consts(chans.device)
    x = chans.sum(1)
    x_lp = torch.cat([0.25 * x[:, 1:2] + 0.5 * x[:, 0:1],
                      0.25 * (x[:, 1:DBS - 2:2] + x[:, 3:DBS:2])
                      + 0.5 * x[:, 2:DBS - 1:2]], 1)
    ac = _autocorr(x_lp, 4)
    ac = torch.cat([ac[:, :1] * 1.0001, ac[:, 1:] * k["lagw4"]], 1)
    lpc = _celt_lpc(ac, 4) * k["g09"]
    c1 = 0.8
    lpc2 = torch.stack([lpc[:, 0] + 0.8,
                        lpc[:, 1] + c1 * lpc[:, 0],
                        lpc[:, 2] + c1 * lpc[:, 1],
                        lpc[:, 3] + c1 * lpc[:, 2],
                        c1 * lpc[:, 3]], 1)
    x_lp = _fir_shifted(x_lp, lpc2, x_lp.new_zeros((x_lp.shape[0], 5)))
    pi = _pitch_search(x_lp[:, PLC_PITCH_LAG_MAX >> 1:], x_lp,
                       DBS - PLC_PITCH_LAG_MAX,
                       PLC_PITCH_LAG_MAX - PLC_PITCH_LAG_MIN)
    return PLC_PITCH_LAG_MAX - pi


def _iir24(x, den, mem):
    """y[i] = x[i] - sum_k den[k] y[i-k-1] (celt_lpc.c::celt_iir), a loop
    over time; mem[:, k] = y[-k-1]."""
    R, n = x.shape
    o = den.shape[1]
    ys = x.new_empty((R, o + n))
    ys[:, :o] = mem.flip(1)
    rden = den.flip(1)
    for i in range(n):
        ys[:, o + i] = x[:, i] - (rden * ys[:, i:i + o]).sum(1)
    return ys[:, o:]


# ------------------------------------------------------------ conceal
def celt_plc_core(dm, pre, pitch, lpc, first, *, CC: int):
    """One concealed 20 ms frame per row, no masking (jax_plc.
    celt_plc_core at downsample 1). dm (R, CC, 2168) int32 Q12
    decode_mem rows; pre (R, CC) int32 deemphasis memory; pitch (R,)
    int32, the pitch of the previous conceal (taken when first is
    False); lpc (R, CC, 24) float32, its LPC fit; first (R,) bool, the
    row's first conceal since a good frame. Returns (pcm (R, 960, CC)
    int16, dm', pre', T (R,) int32, lpc')."""
    k = _consts(dm.device)
    win = k["win"]
    iota_mp, iota_el = k["iota_mp"], k["iota_el"]
    f = dm.to(F32) / 4096.0
    new_pitch = _plc_pitch_search(f[:, :, :DBS])
    T = torch.where(first, new_pitch, pitch).clamp(
        PLC_PITCH_LAG_MIN, PLC_PITCH_LAG_MAX).to(torch.int32)
    fade = torch.where(first, 1.0, 0.8).to(F32)
    exc_len = torch.clamp_max(2 * T, MAX_PERIOD)
    Tl = T.long()
    eoff = (MAX_PERIOD - Tl)[:, None]
    jmod = iota_el[None, :] % Tl[:, None]
    wraps = iota_el[None, :] // Tl[:, None]
    outs, dms, pres, lpcs = [], [], [], []
    for c in range(CC):
        buf = f[:, c]
        _exc = buf[:, DBS - MAX_PERIOD - LPC_ORDER:DBS]
        exc = _exc[:, LPC_ORDER:]
        ac = _autocorr(exc, LPC_ORDER, win, OVERLAP)
        ac = torch.cat([ac[:, :1] * 1.0001, ac[:, 1:] * k["lagw24"]], 1)
        lpc_c = torch.where(first[:, None], _celt_lpc(ac, LPC_ORDER),
                            lpc[:, c])
        # whiten the last exc_len samples (FIR over past inputs)
        wh = _fir_shifted(exc, lpc_c, _exc[:, :LPC_ORDER])
        mask_wh = iota_mp[None, :] >= (MAX_PERIOD - exc_len)[:, None]
        exc_w = torch.where(mask_wh, wh, exc)
        # energy decay over the last two half-exc_len windows
        m1 = iota_mp[None, :] >= (MAX_PERIOD - (exc_len >> 1))[:, None]
        m2 = mask_wh & ~m1
        e2sq = exc_w * exc_w
        E1 = 1.0 + torch.where(m1, e2sq, 0.0).sum(1)
        E2 = 1.0 + torch.where(m2, e2sq, 0.0).sum(1)
        decay = torch.sqrt(torch.minimum(E1, E2) / E2)
        # one period extrapolated with decay: att = fade decay^(1 + w),
        # the powers as running products
        p, pw = decay, []
        for _ in range(ELEN // PLC_PITCH_LAG_MIN + 1):
            pw.append(fade * p)
            p = p * decay
        att = torch.stack(pw, 1).gather(1, wraps)
        ex = att * exc_w.gather(1, eoff + jmod)
        # the source period: the last T samples before the loss
        src = buf.gather(1, DBS - Tl[:, None] + jmod)
        S1 = (src * src).sum(1) / 1024.0
        syn = _iir24(ex, lpc_c, buf[:, DBS - LPC_ORDER:DBS].flip(1))
        S2 = (syn * syn).sum(1) / 1024.0
        # anti-explosion clamp and soft ratio fade (celt_decoder.c)
        ratio = torch.sqrt((S1 / 2 + 1) / (S2 / 2 + 1))
        g_ov = 1.0 - win[None, :] * (1.0 - ratio[:, None])
        gain = torch.cat([g_ov, ratio[:, None].expand(-1, ELEN - OVERLAP)],
                         1)
        gain = torch.where((S1 < S2)[:, None], gain, 1.0)
        syn = torch.where((S1 > 0.25 * S2)[:, None], syn * gain, 0.0)
        # write back: the history rolled by N, the N new samples and the
        # TDAC-blended half of the overlap tail
        etmp = syn[:, N:N + OVERLAP]
        h = OVERLAP // 2
        tdac = win[:h] * etmp[:, h:].flip(1) + win[h:].flip(0) * etmp[:, :h]
        buf2 = torch.cat([buf[:, N:DBS], syn[:, :N], tdac,
                          buf[:, DBS + h:]], 1)
        # deemphasis (the float mirror of the integer one)
        m = pre[:, c].to(F32) / 4096.0
        pcm48 = torch.empty_like(syn[:, :N])
        for i in range(N):
            t = syn[:, i] + m
            m = _PRE * t
            pcm48[:, i] = t
        outs.append(torch.clamp(torch.round(pcm48), -32768, 32767))
        dms.append(torch.round(torch.clamp(buf2, -2.0 ** 19, 2.0 ** 19 - 1)
                               * 4096.0).to(torch.int32))
        pres.append(torch.round(m * 4096.0).to(torch.int32))
        lpcs.append(lpc_c)
    pcm = torch.stack(outs, 2).to(torch.int16)
    return (pcm, torch.stack(dms, 1), torch.stack(pres, 1), T,
            torch.stack(lpcs, 1))


def celt_plc_bucket(dm, pre, pitch, lpc, first, active, *, CC: int):
    """celt_plc_core with inactive rows left as they were and their PCM
    zero (jax_plc.celt_plc_bucket). Returns (pcm, dm', pre', pitch',
    lpc')."""
    pcm, dm2, pre2, T, lpc2 = celt_plc_core(dm, pre, pitch, lpc, first,
                                            CC=CC)
    am = active[:, None]
    return (torch.where(am[:, :, None], pcm, 0).to(torch.int16),
            torch.where(am[:, :, None], dm2, dm),
            torch.where(am, pre2, pre), torch.where(active, T, pitch),
            torch.where(am[:, :, None], lpc2, lpc))
