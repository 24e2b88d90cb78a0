"""Batched SILK packet-loss concealment in torch (RFC mode): int32
tensors with a streams axis.

Port of esp32_opus_player_tpu/ops/silk/jax_plc.py, function for function
and bit for bit: silk_PLC_conceal (reference src/silk.cpp:2973), silk_CNG
(:1342) and silk_PLC_glue_frames (:3138). Everything sequential or
symbolic is prepared on the host (the rand excitation, the per-subframe
decayed LTP coefficients and drifting lags, the bandwidth-expanded LPC:
models/batch_silk.py::NativePlcTracker.conceal_prep); the dense feedback
recurrences run here.

`silk_plc_conceal_frame_xla` and `cng_add_xla` are the plain versions of
kernels K8 (ops/silk/plc_kernel.py) and K9 (ops/silk/cng_kernel.py).
Integer semantics as in torch_core.py: whatever can leave int32 is taken
in int64 and reduced modulo 2^32 where the JAX chain wraps.
"""
from __future__ import annotations

import torch

from .lpc_synth import lpc_synth_ref
from .torch_core import (I32, I64, LTP_ORDER, lpc_analysis_tail,
                         rshift_round, sat16, smlawb, smulwb, smulww, w32,
                         w64)

_U32 = 0xFFFFFFFF


def clz32(x):
    """Leading zeros of the 32-bit pattern of x (jax.lax.clz on int32):
    a negative value gives 0, zero gives 32. From shifts and compares."""
    u = x.to(I64) & _U32
    n = torch.zeros_like(u)
    for s in (16, 8, 4, 2, 1):
        big = (u >> s) != 0
        n = n + big * s
        u = torch.where(big, u >> s, u)
    return (32 - (n + (u != 0))).to(I32)


def _ror32(x, rot):
    """Rotate the 32-bit pattern of x right by rot (per element, may be
    negative)."""
    u = x.to(I64) & _U32
    r = torch.remainder(rot.to(I64), 32)
    return w32((u >> r) | (u << (32 - r)))


def sqrt_approx(x):
    """m.SQRT_APPROX, elementwise (int32 -> int32)."""
    lz = clz32(x)
    frac_q7 = _ror32(x, 24 - lz) & 0x7F
    y = torch.where((lz & 1) == 1, 32768, 46214).to(I32)
    y = y >> (lz >> 1)
    out = smlawb(y, y, 213 * frac_q7)
    return torch.where(x <= 0, 0, out).to(I32)


def sum_sqr_shift_b(x, length: int):
    """silk_sum_sqr_shift (:3839) batched over rows, as jax_plc.
    sum_sqr_shift_b: x (B, length) int32. Returns (nrg (B,), shift (B,)).
    The pair sums and the accumulation wrap as int32 (a pair of -32768s
    squares to -2^31, and the shifts of it are arithmetic, as in JAX)."""
    shft0 = max(length.bit_length() - 1, 0)
    npairs = length // 2
    x0 = x[:, 0:2 * npairs:2].to(I64)
    x1 = x[:, 1:2 * npairs:2].to(I64)
    pair = w32(w64(x0 * x0) + w64(x1 * x1))
    if length % 2:
        last = x[:, -1].to(I64)
        tail = w32(last * last)
    else:
        tail = torch.zeros(x.shape[0], dtype=I32, device=x.device)
    nrg1 = w32((pair >> shft0).to(I64).sum(-1) + length + (tail >> shft0))
    shft = (shft0 + 3 - clz32(nrg1)).clamp(min=0)
    nrg = w32((pair >> shft[:, None]).to(I64).sum(-1) + (tail >> shft))
    return nrg, shft


def silk_plc_conceal_frame_xla(outBuf, sLPC0, rand_q12, A_Q12, B_Q14_4,
                               lag4, inv_gain_q30, prev_gain_q10_1, *,
                               fs_khz: int, nb_subfr: int, order: int):
    """The plain version of K8: jax_plc.silk_plc_conceal_frame_xla, the
    dense phase of silk_PLC_conceal.

    outBuf (B, >= 20 fs) int32 synthesis history; sLPC0 (B, 16); rand_q12
    (B, frame) the host's SMULWB(exc_rand, rand_scale) per sample; A_Q12
    (B, >= order) bandwidth-expanded prevLPC; B_Q14_4 (B, >= nb, 5) and
    lag4 (B, >= nb) per-subframe LTP coefficients and lags; inv_gain_q30,
    prev_gain_q10_1 (B,). Returns (xq (B, frame) int32 in int16 range,
    sLPC' (B, 16)). The LTP walks in chunks of 2 fs - 2 samples like the
    JAX form, so any lag >= 0 stays inside the buffer; a real conceal lag
    is at least 2 fs, where the chunk walk equals a sample walk."""
    dev = outBuf.device
    Bsz = outBuf.shape[0]
    subfr = 5 * fs_khz
    frame = nb_subfr * subfr
    lm = 20 * fs_khz
    CH = 2 * fs_khz - 2
    n_chunks = (subfr + CH - 1) // CH

    # rewhitening of the last lag0 + 2 history samples
    W = 18 * fs_khz + 2
    white = lpc_analysis_tail(outBuf[:, :lm], A_Q12, W, order)
    scaled = smulwb(inv_gain_q30[:, None], white)
    t = torch.arange(W, device=dev)[None, :]
    valid = (W - t) <= (lag4[:, 0, None] + 2)
    sLTP = torch.zeros((Bsz, lm + frame + CH), dtype=I32, device=dev)
    sLTP[:, lm - W:lm] = torch.where(valid, scaled, 0)

    # LTP recurrence with the rand excitation, lag-safe chunks
    rand_pad = torch.cat([rand_q12, torch.zeros((Bsz, CH), dtype=I32,
                                                device=dev)], dim=1)
    win_off = torch.arange(CH + LTP_ORDER - 1, device=dev)
    for k in range(nb_subfr):
        Bk = B_Q14_4[:, k]
        lag = lag4[:, k].to(I64)
        for c in range(n_chunks):
            gidx0 = lm + k * subfr + c * CH
            win = sLTP.gather(1, (gidx0 - lag - LTP_ORDER // 2)[:, None]
                              + win_off[None, :])
            pred = torch.full((Bsz, CH), 2, dtype=I32, device=dev)
            for tt in range(LTP_ORDER):
                tap = win[:, LTP_ORDER - 1 - tt:LTP_ORDER - 1 - tt + CH]
                pred = smlawb(pred, tap, Bk[:, tt, None])
            rnd = rand_pad[:, k * subfr + c * CH:k * subfr + (c + 1) * CH]
            sLTP[:, gidx0:gidx0 + CH] = w32(
                (pred.to(I64) + rnd.to(I64)) << 2)

    # LPC synthesis over the frame, then the output gain
    vs, sLPC = lpc_synth_ref(sLTP[:, lm:lm + frame].contiguous(), A_Q12,
                             sLPC0, order=order)
    xq = sat16(rshift_round(smulww(vs, prev_gain_q10_1[:, None]), 8))
    return xq, sLPC


def cng_add_xla(xq, cng_exc_q14, a_q12, gain_q10, state0, apply_mask, *,
                frame: int, order: int):
    """The plain version of K9: jax_plc.cng_add_xla, the comfort-noise
    addition on concealed frames (silk_CNG :1342, lossCnt branch). xq,
    cng_exc_q14 (B, frame); a_q12 (B, >= order); gain_q10 (B,); state0
    (B, 16); apply_mask (B,) bool. Rows with the mask off pass through
    and keep their state. Returns (xq', state')."""
    vs, state = lpc_synth_ref(cng_exc_q14[:, :frame], a_q12, state0,
                              order=order)
    noise = sat16(rshift_round(smulww(vs, gain_q10[:, None]), 8))
    outs = sat16(w32(xq.to(I64) + noise))
    m = apply_mask[:, None]
    return torch.where(m, outs, xq), torch.where(m, state, state0)


def glue_frames(xq, conc_energy, conc_shift, apply_mask, *, frame: int):
    """Batched silk_PLC_glue_frames (:3138), the energy ramp of the first
    good frame after a loss (jax_plc.glue_frames). xq (B, frame);
    conc_energy, conc_shift (B,) the concealed frame's energy;
    apply_mask (B,) bool. Returns the smoothed frame (masked)."""
    energy, eshift = sum_sqr_shift_b(xq, frame)
    d1 = (eshift - conc_shift).clamp(0, 31)
    d2 = (conc_shift - eshift).clamp(0, 31)
    ce = conc_energy >> d1
    en = energy >> d2
    cond = apply_mask & (en > ce)
    lz = clz32(ce) - 1
    # a shift count outside 0..31 (ce < 0: -1) gives 0, as XLA defines it
    ce2 = torch.where(lz < 0, 0, w32((ce.to(I64) & _U32)
                                     << lz.clamp(0, 31))).to(I32)
    en2 = en >> (24 - lz).clamp(min=0)
    frac_q24 = torch.div(ce2, en2.clamp(min=1), rounding_mode="floor")
    gain_q16 = sqrt_approx(frac_q24) << 4
    slope_q16 = torch.div(65536 - gain_q16, frame,
                          rounding_mode="floor") * 4
    i = torch.arange(frame, dtype=I32, device=xq.device)[None, :]
    g = gain_q16[:, None] + i * slope_q16[:, None]
    live = (i == 0) | (g <= 65536)    # the scalar loop breaks once g > 1
    out = torch.where(live, smulwb(g, xq), xq)
    return torch.where(cond[:, None], out, xq)


def frame_energy(xq, *, frame: int):
    """sum_sqr_shift of the audible (post-CNG) concealed frame: the glue's
    reference energy (silk_PLC_glue_frames :2590, lost branch)."""
    return sum_sqr_shift_b(xq, frame)
