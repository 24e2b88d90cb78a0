"""Batched SILK dense phase in torch: int32 tensors with a streams axis.

Port of esp32_opus_player_tpu/ops/silk/jax_core.py, function for
function and bit for bit (reference src/silk.cpp): the LTP-state
rewhitening FIR (silk_LPC_analysis_filter :2268), the 5-tap LTP
feedback recurrence in lag-safe chunks, the order-10/16 LPC synthesis
recurrence, and the resampler bank that takes the 8/12/16 kHz internal
rate to the API rate (silk_resampler :3676).

Integer semantics: the JAX chains are int32 and wrap as two's
complement. Here every sum, product or left shift that can leave int32
is taken in int64 and reduced modulo 2^32 (`w32`) before any operation
that would see the difference (a right shift, a compare, a clamp); no
result relies on int32 overflow inside torch.

On a CUDA tensor `silk_core_frame` launches kernel K7 (ops/silk/
core_kernel.py) at every width. The JAX package sends buckets under 128
rows to the chunked form instead (jax_core.py:125-128: below one TPU
lane tile its gathers win); that is a TPU lane-tile rule, and K7 is held
bit-equal on the card down to B = 1, so on the card the chunked form
below, whose LPC recurrence is kernel K5 (ops/silk/lpc_synth.py), is
K7's plain version only. The 2x allpass inside `resample_batch` is
kernel K6 (ops/silk/up2_hq.py), whose fused entry also does the IIR-FIR
interpolation around it. On a CPU tensor every kernel's wrapper runs its
plain version.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..tables import silk_tables as st
from .resampler import _DELAY_MATRIX_DEC, _rate_id

I32 = torch.int32
I64 = torch.int64
INT32_MAX = 2147483647
INT32_MIN = -2147483648
LTP_ORDER = 5
MAX_LPC_ORDER = 16


# ---------------------------------------------------------------------
# exact fixed-point lane ops (int32 results, wrapping)
# ---------------------------------------------------------------------

def w32(x):
    """An int64 tensor reduced modulo 2^32 to int32."""
    return x.to(I32)


def w64(x):
    """An int64 tensor reduced modulo 2^32 into int32 range, kept int64."""
    return x.to(I32).to(I64)


def _i64(x):
    return x.to(I64) if isinstance(x, torch.Tensor) else int(x)


def smulwb(a, b):
    """jax_core.smulwb: (a >> 16) * b + (((a & 0xFFFF) * b) >> 16), each
    product wrapped to int32 as the JAX chain wraps it. For |b| <= 2^15
    (every call site of the decoder) this is ((int64)a * b) >> 16."""
    a = a.to(I64)
    b = _i64(b)
    if isinstance(b, int) and -32768 <= b <= 32767:
        return w32((a * b) >> 16)
    return w32((a >> 16) * b + (w32((a & 0xFFFF) * b).to(I64) >> 16))


def smlawb(a, b, c):
    return w32(_i64(a) + smulwb(b, c))


def smulww(a, b):
    """((int64)a * b) >> 16 modulo 2^32: equal to the hi/lo split of
    jax_core.smulww (the int64 product is exact)."""
    return w32((_i64(a) * _i64(b)) >> 16)


def add_sat32(a, b):
    """Saturating int32 add: the JAX form detects overflow from the
    wrapped sum; the exact sum clamped is the same value."""
    return (_i64(a) + _i64(b)).clamp(INT32_MIN, INT32_MAX).to(I32)


def lshift_sat32(a, shift: int):
    return a.clamp(INT32_MIN >> shift, INT32_MAX >> shift) << shift


def rshift_round(a, shift: int):
    if shift == 1:
        return (a >> 1) + (a & 1)
    return ((a >> (shift - 1)) + 1) >> 1


def sat16(a):
    return a.clamp(-32768, 32767)


# ---------------------------------------------------------------------
# LTP-state rewhitening FIR (silk_LPC_analysis_filter)
# ---------------------------------------------------------------------

def lpc_analysis_tail(inp, A_Q12, W: int, order: int):
    """FIR whitening of the last W samples of inp (B, L) with per-stream
    coefficients A_Q12 (B, order): out32_Q12 wraps, then rounds and
    saturates to int16. Returns (B, W) int32."""
    L = inp.shape[-1]
    pos = torch.arange(L - W, L, device=inp.device)
    idx = pos[:, None] - 1 - torch.arange(order, device=inp.device)[None]
    taps = inp[:, idx].to(I64)                      # (B, W, order)
    acc = (taps * A_Q12[:, None, :order].to(I64)).sum(-1)
    out = w32((inp[:, L - W:].to(I64) << 12) - acc)
    return sat16(rshift_round(out, 12))


# ---------------------------------------------------------------------
# batched decode_core (one frame, static bucket)
# ---------------------------------------------------------------------

def silk_core_frame(outBuf, sLPC0, exc, A_Q12, B_Q14, gains_q16,
                    inv_gain_q31_k0, pitchL, signal_type_voiced,
                    rewhiten_k, gain_adj_q16, prev_gain_match, *,
                    fs_khz: int, nb_subfr: int, order: int):
    """Batched silk_decode_core (src/silk.cpp:1806); arguments and
    results as jax_core.silk_core_frame. On a CUDA tensor the whole core
    is one launch of kernel K7, at any number of rows; on a CPU tensor
    the chunked form `silk_core_frame_xla` runs."""
    args = (outBuf, sLPC0, exc, A_Q12, B_Q14, gains_q16, inv_gain_q31_k0,
            pitchL, signal_type_voiced, rewhiten_k, gain_adj_q16,
            prev_gain_match)
    kw = dict(fs_khz=fs_khz, nb_subfr=nb_subfr, order=order)
    if exc.device.type == "cuda":
        from .core_kernel import silk_core
        return silk_core(*args, **kw)
    return silk_core_frame_xla(*args, **kw)


def silk_core_frame_xla(outBuf, sLPC0, exc, A_Q12, B_Q14, gains_q16,
                        inv_gain_q31_k0, pitchL, signal_type_voiced,
                        rewhiten_k, gain_adj_q16, prev_gain_match, *,
                        fs_khz: int, nb_subfr: int, order: int,
                        lpc=None):
    """The chunked expression of silk_core_frame (jax_core.
    silk_core_frame_xla): the plain version of K7. lpc: the LPC
    recurrence, (pres, A, state, order=) -> (vs, state'); by default
    K5's wrapper (its plain version on a CPU tensor). Returns (xq (B,
    frame) int32 in int16 range, sLPC' (B, 16))."""
    if lpc is None:
        from .lpc_synth import lpc_synth as lpc
    dev = exc.device
    Bsz = exc.shape[0]
    subfr = 5 * fs_khz
    frame = nb_subfr * subfr
    ltp_mem = 20 * fs_khz
    max_lag = 18 * fs_khz
    W = max_lag + LTP_ORDER // 2 + 2          # rewhitening tail window
    # lag-safe chunk: every LTP tap lies >= PE_MIN_LAG - 2 = 2*fs - 2
    # samples back, so a chunk of that many reads only finished samples
    CH = 2 * fs_khz - 2
    n_chunks = (subfr + CH - 1) // CH

    sLTP = torch.zeros((Bsz, ltp_mem + frame + CH), dtype=I32, device=dev)
    excp = torch.cat([exc, torch.zeros((Bsz, CH), dtype=I32, device=dev)],
                     dim=1)
    xq = torch.zeros((Bsz, frame), dtype=I32, device=dev)
    work = outBuf                  # history + this frame's xq (k >= 2)
    col = torch.arange(W, device=dev)
    win_off = torch.arange(CH + LTP_ORDER - 1, device=dev)
    sLPC = sLPC0
    for k in range(nb_subfr):
        Ak = A_Q12[:, k >> 1, :order]
        Bk = B_Q14[:, k]
        voiced = signal_type_voiced[:, k]
        lag = pitchL[:, k].to(I64)
        gain_q10 = gains_q16[:, k] >> 6
        adj = gain_adj_q16[:, k, None]
        no_adj = prev_gain_match[:, k, None]

        # gain adjustment of the LPC state
        sLPC = torch.where(no_adj, sLPC, smulww(adj, sLPC))

        # ---- rewhitening / rescale of the LTP state -----------------
        if k == 2:
            # the buffer gains this frame's first two subframes
            work = torch.cat([work[:, :ltp_mem], xq[:, :2 * subfr],
                              work[:, ltp_mem + 2 * subfr:]], dim=1)
        win_end = ltp_mem + k * subfr
        white = lpc_analysis_tail(work[:, :win_end], Ak, W, order)
        # column i is position base + i: rewritten for the last lag + 2
        valid = (W - 1 - col)[None, :] < (lag[:, None] + LTP_ORDER // 2)
        scaled = smulwb(inv_gain_q31_k0[:, k, None], white)
        base = win_end - W
        cur = sLTP[:, base:win_end]
        rescaled = torch.where(no_adj, cur, smulww(adj, cur))
        do_rw = rewhiten_k[:, k, None]
        sLTP[:, base:win_end] = torch.where(
            do_rw & valid, scaled,
            torch.where(~do_rw & valid & voiced[:, None], rescaled, cur))

        # ---- LTP 5-tap feedback recurrence, lag-safe chunks ---------
        res = torch.empty((Bsz, n_chunks * CH), dtype=I32, device=dev)
        for c in range(n_chunks):
            i0 = c * CH
            gidx0 = win_end + i0
            # the 5 taps read consecutive positions i - lag + 2 - t: one
            # window of CH + 4 samples serves all of them
            win = sLTP.gather(1, (gidx0 - lag - LTP_ORDER // 2)[:, None]
                              + win_off[None, :])
            pred = torch.full((Bsz, CH), 2, dtype=I32, device=dev)
            for t in range(LTP_ORDER):
                tap = win[:, LTP_ORDER - 1 - t:LTP_ORDER - 1 - t + CH]
                pred = smlawb(pred, tap, Bk[:, t, None])
            exc_sl = excp[:, k * subfr + i0:k * subfr + i0 + CH]
            r = w32(exc_sl.to(I64) + (pred.to(I64) << 1))
            sLTP[:, gidx0:gidx0 + CH] = w32(r.to(I64) << 1)
            res[:, i0:i0 + CH] = r
        exc_k = exc[:, k * subfr:(k + 1) * subfr]
        pres = torch.where(voiced[:, None], res[:, :subfr], exc_k)

        # ---- LPC synthesis recurrence (K5) ---------------------------
        vs, sLPC = lpc(pres, Ak, sLPC, order=order)
        xq[:, k * subfr:(k + 1) * subfr] = sat16(rshift_round(
            smulww(vs, gain_q10[:, None]), 8))
    return xq, sLPC


# ---------------------------------------------------------------------
# batched resampler: up2-HQ allpass (K6) + 12-phase FIR interpolation
# ---------------------------------------------------------------------

_UP2_HQ = [[int(x) for x in st.silk_resampler_up2_hq_0],
           [int(x) for x in st.silk_resampler_up2_hq_1]]
_FRAC_FIR_12 = np.asarray(st.silk_resampler_frac_FIR_12,
                          dtype=np.int32).reshape(12, 4)


@functools.lru_cache(maxsize=None)
def _up2_coefs(device):
    """The three allpass sections' coefficients for the even and the odd
    branch, (3, 2) int64."""
    return torch.tensor(np.asarray(_UP2_HQ, np.int64).T, device=device)


def up2_hq_scan(S, inp):
    """silk_resampler_private_up2_HQ (:3513) batched, the plain version of
    K6: S (B, 6), inp (B, L) int32. Returns (out (B, 2L) interleaved
    even/odd, S'). The even (S[0:3]) and odd (S[3:6]) branches run side
    by side as the two columns of each state.

    The chain runs in int64. A value that only enters sums stays
    unreduced (it is right modulo 2^32, and a few int32-sized terms
    cannot leave int64); a value that enters a product or a shift is
    reduced first (`w64`). The coefficients are below 2^15, so smulwb is
    the exact (Y * c) >> 16."""
    B, L = inp.shape
    c = _up2_coefs(inp.device)
    s = [S[:, j::3].to(I64) for j in range(3)]   # (B, 2) each
    out = torch.empty((B, L, 2), dtype=I32, device=inp.device)
    x10 = w64(inp.to(I64) << 10)
    for t in range(L):
        in32 = x10[:, t, None]
        X = (w64(in32 - s[0]) * c[0]) >> 16
        out1 = s[0] + X
        s0 = in32 + X
        X = (w64(out1 - s[1]) * c[1]) >> 16
        out2 = s[1] + X
        s1 = out1 + X
        Y = w64(out2 - s[2])
        X = Y + ((Y * c[2]) >> 16)
        out[:, t] = sat16(rshift_round(w32(s[2] + X), 10))
        s = [s0, s1, out2 + X]
    S2 = torch.stack([s[0][:, 0], s[1][:, 0], s[2][:, 0],
                      s[0][:, 1], s[1][:, 1], s[2][:, 1]], dim=1)
    return out.reshape(B, 2 * L), w32(S2)


@functools.lru_cache(maxsize=None)
def _iir_fir_plan(max_index_q16: int, index_increment_q16: int, device):
    idxs = np.arange(0, max_index_q16, index_increment_q16, dtype=np.int64)
    table_index = ((idxs & 0xFFFF) * 12) >> 16
    base = idxs >> 16
    fir = _FRAC_FIR_12
    coef = np.stack([np.concatenate([fir[t], fir[11 - t][::-1]])
                     for t in table_index])                     # (n, 8)
    return (torch.as_tensor(base[:, None] + np.arange(8), device=device),
            torch.as_tensor(coef.astype(np.int64), device=device))


def iir_fir_interpol(buf, max_index_q16: int, index_increment_q16: int):
    """silk_resampler_private_IIR_FIR_INTERPOL (:3451) batched, static
    rate: buf (B, 2L + 8). Output length = the number of indices."""
    idx, coef = _iir_fir_plan(max_index_q16, index_increment_q16,
                              buf.device)
    acc = w32((buf[:, idx].to(I64) * coef[None]).sum(-1))
    return sat16(rshift_round(acc, 15))


@functools.lru_cache(maxsize=None)
def _down_fir_plan(max_index_q16: int, index_increment_q16: int,
                   order: int, fracs: int, fir_coefs: tuple, device):
    idxs = np.arange(0, max_index_q16, index_increment_q16, dtype=np.int64)
    base = idxs >> 16
    fir = np.asarray(fir_coefs, dtype=np.int64)
    if order == 18:                       # RESAMPLER_DOWN_ORDER_FIR0
        ii = ((idxs & 0xFFFF) * fracs) >> 16
        coef = np.zeros((len(idxs), 18), dtype=np.int64)
        for r, i in enumerate(ii):
            coef[r, :9] = fir[9 * i:9 * i + 9]
            coef[r, 9:] = fir[9 * (fracs - 1 - i):
                              9 * (fracs - 1 - i) + 9][::-1]
    else:                                 # 24 = RESAMPLER_DOWN_ORDER_FIR1
        coef = fir[None, :12].repeat(len(idxs), 0)
    return (torch.as_tensor(base[:, None] + np.arange(order), device=device),
            torch.as_tensor(coef, device=device))


def down_fir_interpol(buf, max_index_q16: int, index_increment_q16: int,
                      *, order: int, fracs: int, fir_coefs):
    """silk_resampler_private_down_FIR_INTERPOL (:3305) batched, static
    rate: one windowed gather and per-output coefficient rows; per-tap
    SMULWB truncation and wrapping accumulation as in the reference."""
    idx, coef = _down_fir_plan(max_index_q16, index_increment_q16, order,
                               fracs, tuple(int(v) for v in fir_coefs),
                               buf.device)
    taps = buf[:, idx]                                   # (B, n, order)
    if order == 24:
        # ADD32 wrap of the symmetric pair
        taps = w32(taps[..., :12].to(I64) + taps[..., 12:].flip(-1))
    acc = w32(smulwb(taps, coef[None]).to(I64).sum(-1))
    return sat16(rshift_round(acc, 6))


def ar2_scan(sIIR2, inp, a0: int, a1: int):
    """silk_resampler_private_AR2 (:3286) batched: sIIR2 (B, 2) int32,
    inp (B, L) int32. Returns (out_Q8 (B, L) int32, sIIR2')."""
    S0, S1 = sIIR2[:, 0], sIIR2[:, 1]
    ys = torch.empty_like(inp)
    for t in range(inp.shape[1]):
        out32 = w32(S0.to(I64) + (inp[:, t].to(I64) << 8))
        tq = w32(out32.to(I64) << 2)
        S0, S1 = smlawb(S1, tq, a0), smulwb(tq, a1)
        ys[:, t] = out32
    return ys, torch.stack([S0, S1], dim=1)


def _resampler_spec(fs_in_khz: int, fs_out_khz: int) -> dict:
    """silk_resampler_init (:3590) constants for a decoder rate pair."""
    fs_in, fs_out = fs_in_khz * 1000, fs_out_khz * 1000
    spec = dict(
        delay=int(_DELAY_MATRIX_DEC[_rate_id(fs_in)][_rate_id(fs_out)]),
        batch_size=fs_in_khz * 10, order=0, fracs=1, coefs=None)
    if fs_out == fs_in:
        spec["kind"] = "copy"
        spec["inv_ratio"] = 0
        return spec
    if fs_out > fs_in:
        spec["kind"] = "up2" if fs_out == 2 * fs_in else "iir_fir"
        inv = ((fs_in << 15) // fs_out) << 2          # up2x = 1
        while ((inv * fs_out) >> 16) < (fs_in << 1):
            inv += 1
        spec["inv_ratio"] = inv
        return spec
    spec["kind"] = "down_fir"
    if fs_out * 4 == fs_in * 3:
        spec.update(fracs=3, order=18, coefs=st.silk_Resampler_3_4_COEFS)
    elif fs_out * 3 == fs_in * 2:
        spec.update(fracs=2, order=18, coefs=st.silk_Resampler_2_3_COEFS)
    elif fs_out * 2 == fs_in:
        spec.update(fracs=1, order=24, coefs=st.silk_Resampler_1_2_COEFS)
    else:
        raise ValueError(f"no decoder resampler {fs_in_khz}->"
                         f"{fs_out_khz} kHz")
    inv = ((fs_in << 14) // fs_out) << 2              # up2x = 0
    while ((inv * fs_out) >> 16) < fs_in:
        inv += 1
    spec["inv_ratio"] = inv
    return spec


def resampler_chunks(n: int, batch_size: int) -> list:
    """(offset, length) of the batchSize chunks of an n-sample block (at
    least one, as the reference's do-while)."""
    out, off = [], 0
    while True:
        n_in = min(n - off, batch_size)
        out.append((off, n_in))
        off += n_in
        if off >= n:
            return out


def iir_fir_out_len(n: int, batch_size: int, inv_ratio: int) -> int:
    """Outputs of one private_IIR_FIR call over n samples: per chunk the
    indices 0, inv, 2 inv, ... below n_in << 17."""
    return sum(-(-(n_in << 17) // inv_ratio)
               for _, n_in in resampler_chunks(n, batch_size))


def iir_fir_chunks(sIIR, sFIR, block, *, batch_size: int, inv_ratio: int,
                   up2=up2_hq_scan):
    """private_IIR_FIR (:3481) batched, the plain version of K6's fused
    entry: batchSize chunks of block (B, n), each the 2x allpass `up2`
    (K6's plain version by default), buf = [sFIR[:, :8], up], the FIR
    interpolation of buf, and sFIR' = buf[:, 2 n_in : 2 n_in + 8] (the
    columns past 8 kept). Returns (out (B, iir_fir_out_len), sIIR',
    sFIR')."""
    outs = []
    for off, n_in in resampler_chunks(block.shape[-1], batch_size):
        up, sIIR = up2(sIIR, block[:, off:off + n_in])
        buf = torch.cat([sFIR[:, :8], up], dim=1)
        outs.append(iir_fir_interpol(buf, n_in << 17, inv_ratio))
        sFIR = torch.cat([buf[:, 2 * n_in:2 * n_in + 8], sFIR[:, 8:]],
                         dim=1)
    return torch.cat(outs, dim=1), sIIR, sFIR


def sfir_width(fs_in_khz: int, fs_out_khz: int) -> int:
    """FIR-state columns a pool bucket carries for this rate pair
    (sFIR_i16[8] for IIR_FIR, sFIR_i32[order] for down-FIR; up2 and copy
    carry none but keep 8 for a uniform minimum)."""
    return max(8, _resampler_spec(fs_in_khz, fs_out_khz)["order"])


def resample_batch(sIIR, sFIR, delay_buf, inp, *, fs_in_khz: int,
                   fs_out_khz: int, in_len: int):
    """Batched silk_resampler (:3676) for every decoder rate pair (8/12/16
    kHz internal -> 8/12/16/24/48 kHz API): copy, 2x allpass (K6),
    IIR-FIR up, and the AR2 + FIR down paths. inp: (B, in_len) int32.
    Returns (out (B, in_len*out/in), sIIR', sFIR', delay_buf'); the
    inputs are not written. Mirrors the reference's two calls and
    batchSize chunking (the rounded-up invRatio makes output counts
    chunking-dependent). Kind iir_fir is one call of K6's fused entry
    (`up2_hq.up2_fir`) per block, kind up2 one of its bare entry."""
    from .up2_hq import up2_fir, up2_hq
    spec = _resampler_spec(fs_in_khz, fs_out_khz)
    delay = spec["delay"]
    n_samples = fs_in_khz - delay
    batch_size = spec["batch_size"]
    inv_ratio = spec["inv_ratio"]
    db = torch.cat([delay_buf[:, :delay], inp[:, :n_samples],
                    delay_buf[:, delay + n_samples:]], dim=1)

    def iir_fir(sIIR, sFIR, block):
        return up2_fir(sIIR, sFIR, block, batch_size=batch_size,
                       inv_ratio=inv_ratio)

    def down_fir(sIIR, sFIR, block):
        """private_down_FIR (:3420): AR2 prefilter into a Q8 buffer, then
        the static-index FIR interpolation; batchSize chunks."""
        a0, a1 = int(spec["coefs"][0]), int(spec["coefs"][1])
        order = spec["order"]
        outs = []
        for off, n_in in resampler_chunks(block.shape[-1], batch_size):
            ar2, s2 = ar2_scan(sIIR[:, :2], block[:, off:off + n_in], a0,
                               a1)
            sIIR = torch.cat([s2, sIIR[:, 2:]], dim=1)
            buf = torch.cat([sFIR[:, :order], ar2], dim=1)
            outs.append(down_fir_interpol(
                buf, n_in << 16, inv_ratio, order=order,
                fracs=spec["fracs"], fir_coefs=spec["coefs"][2:]))
            sFIR = torch.cat([buf[:, n_in:n_in + order], sFIR[:, order:]],
                             dim=1)
        return torch.cat(outs, dim=1), sIIR, sFIR

    def up2_block(sIIR, sFIR, block):
        out, sIIR = up2_hq(sIIR, block)
        return out, sIIR, sFIR

    def copy_block(sIIR, sFIR, block):
        return block, sIIR, sFIR

    fn = dict(copy=copy_block, up2=up2_block, iir_fir=iir_fir,
              down_fir=down_fir)[spec["kind"]]
    out1, sIIR, sFIR = fn(sIIR, sFIR, db[:, :fs_in_khz])
    out2, sIIR, sFIR = fn(
        sIIR, sFIR, inp[:, n_samples:n_samples + in_len - fs_in_khz])
    if delay > 0:
        delay_buf = torch.cat([inp[:, in_len - delay:in_len],
                               delay_buf[:, delay:]], dim=1)
    return torch.cat([out1, out2], dim=1), sIIR, sFIR, delay_buf
