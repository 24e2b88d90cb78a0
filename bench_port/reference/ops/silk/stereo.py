"""SILK stereo MS->LR unmixing with predictor interpolation.

Mirrors silk_stereo_MS_to_LR (reference src/silk.cpp:4028-4076).

The port's copy of esp32_opus_player_tpu/ops/silk/stereo.py (numpy and
Python ints; nothing of the JAX package is imported).
"""
from __future__ import annotations

from . import macros as m

STEREO_INTERP_LEN_MS = 8


def ms_to_lr(state, x1, x2, pred_q13, fs_khz: int, frame_length: int):
    """x1/x2: lists of length frame_length + 2 (with 2-sample headroom)."""
    x1[0:2] = state.sMid
    x2[0:2] = state.sSide
    state.sMid = [x1[frame_length], x1[frame_length + 1]]
    state.sSide = [x2[frame_length], x2[frame_length + 1]]

    pred0 = state.pred_prev_Q13[0]
    pred1 = state.pred_prev_Q13[1]
    denom_q16 = m.DIV32_16(1 << 16, STEREO_INTERP_LEN_MS * fs_khz)
    delta0 = m.RSHIFT_ROUND(
        m.SMULBB(pred_q13[0] - state.pred_prev_Q13[0], denom_q16), 16)
    delta1 = m.RSHIFT_ROUND(
        m.SMULBB(pred_q13[1] - state.pred_prev_Q13[1], denom_q16), 16)
    interp_len = STEREO_INTERP_LEN_MS * fs_khz
    for n in range(interp_len):
        pred0 += delta0
        pred1 += delta1
        s = m.LSHIFT32(m.s32(x1[n] + x1[n + 2] + (x1[n + 1] << 1)), 9)
        s = m.SMLAWB(m.LSHIFT32(x2[n + 1], 8), s, pred0)
        s = m.SMLAWB(s, m.LSHIFT32(x1[n + 1], 11), pred1)
        x2[n + 1] = m.SAT16(m.RSHIFT_ROUND(s, 8))
    pred0 = pred_q13[0]
    pred1 = pred_q13[1]
    for n in range(interp_len, frame_length):
        s = m.LSHIFT32(m.s32(x1[n] + x1[n + 2] + (x1[n + 1] << 1)), 9)
        s = m.SMLAWB(m.LSHIFT32(x2[n + 1], 8), s, pred0)
        s = m.SMLAWB(s, m.LSHIFT32(x1[n + 1], 11), pred1)
        x2[n + 1] = m.SAT16(m.RSHIFT_ROUND(s, 8))
    state.pred_prev_Q13 = [pred_q13[0], pred_q13[1]]

    for n in range(frame_length):
        ssum = x1[n + 1] + x2[n + 1]
        diff = x1[n + 1] - x2[n + 1]
        x1[n + 1] = m.SAT16(ssum)
        x2[n + 1] = m.SAT16(diff)
