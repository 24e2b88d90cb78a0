"""SILK core synthesis (inverse NSQ): excitation -> LTP -> LPC -> PCM.

Mirrors the reference (reference src/silk.cpp): silk_decode_core :1806,
silk_LPC_analysis_filter :2268. Scalar model; the per-sample LTP/LPC
recurrence becomes a batched lax.scan on the TPU path.

The port's copy of esp32_opus_player_tpu/ops/silk/core.py (numpy and
Python ints; nothing of the JAX package is imported).
"""
from __future__ import annotations

from ..tables import silk_tables as st
from . import macros as m
from .decode import TYPE_VOICED, LTP_ORDER

MAX_LPC_ORDER = 16
QUANT_LEVEL_ADJUST_Q10 = 80

_QUANT_OFFSETS = st.silk_Quantization_Offsets_Q10.reshape(2, 2)


def lpc_analysis_filter(out, in_buf, in_off: int, B, length: int,
                        d: int) -> None:
    """silk_LPC_analysis_filter (:2268). out: list[length]."""
    for ix in range(d, length):
        p = in_off + ix - 1
        out32_q12 = m.SMULBB(int(in_buf[p]), B[0])
        for j in range(1, d):
            out32_q12 = m.SMLABB_ovflw(out32_q12, int(in_buf[p - j]), B[j])
        out32_q12 = m.SUB32_ovflw(m.LSHIFT32(int(in_buf[p + 1]), 12),
                                  out32_q12)
        out[ix] = m.SAT16(m.RSHIFT_ROUND(out32_q12, 12))
    for ix in range(d):
        out[ix] = 0


def decode_core(ch, ctrl, xq, xq_off: int, pulses) -> None:
    """silk_decode_core (:1806). ch: SilkChannelState, ctrl: DecoderControl.
    xq: int16-range output list/array segment."""
    assert ch.prev_gain_Q16 != 0
    frame_length = ch.frame_length
    subfr_length = ch.subfr_length
    lpc_order = ch.LPC_order

    sLTP = [0] * ch.ltp_mem_length
    sLTP_Q15 = [0] * (ch.ltp_mem_length + frame_length)
    res_Q14 = [0] * subfr_length
    sLPC_Q14 = [0] * (subfr_length + MAX_LPC_ORDER)

    offset_q10 = int(_QUANT_OFFSETS[ch.ind_signalType >> 1]
                     [ch.ind_quantOffsetType])
    nlsf_interp_flag = 1 if ch.ind_NLSFInterpCoef_Q2 < 4 else 0

    rand_seed = ch.ind_Seed
    for i in range(frame_length):
        rand_seed = m.silk_RAND(rand_seed)
        exc = m.s32(pulses[i] << 14)
        if exc > 0:
            exc -= QUANT_LEVEL_ADJUST_Q10 << 4
        elif exc < 0:
            exc += QUANT_LEVEL_ADJUST_Q10 << 4
        exc += offset_q10 << 4
        if rand_seed < 0:
            exc = -exc
        ch.exc_Q14[i] = exc
        rand_seed = m.ADD32_ovflw(rand_seed, pulses[i])

    sLPC_Q14[:MAX_LPC_ORDER] = ch.sLPC_Q14_buf[:MAX_LPC_ORDER]

    pexc_off = 0
    pxq_off = xq_off
    sLTP_buf_idx = ch.ltp_mem_length
    lag = 0
    for k in range(ch.nb_subfr):
        A_Q12 = ctrl.PredCoef_Q12[k >> 1]
        B_Q14 = ctrl.LTPCoef_Q14[k * LTP_ORDER:(k + 1) * LTP_ORDER]
        signal_type = ch.ind_signalType

        gain_q10 = ctrl.Gains_Q16[k] >> 6
        inv_gain_q31 = m.INVERSE32_varQ(ctrl.Gains_Q16[k], 47)

        if ctrl.Gains_Q16[k] != ch.prev_gain_Q16:
            gain_adj_q16 = m.DIV32_varQ(ch.prev_gain_Q16,
                                        ctrl.Gains_Q16[k], 16)
            for i in range(MAX_LPC_ORDER):
                sLPC_Q14[i] = m.SMULWW(gain_adj_q16, sLPC_Q14[i])
        else:
            gain_adj_q16 = 1 << 16

        ch.prev_gain_Q16 = ctrl.Gains_Q16[k]

        # voiced-PLC to unvoiced transition smoothing (:1871)
        if ch.lossCnt and ch.prevSignalType == TYPE_VOICED and \
                ch.ind_signalType != TYPE_VOICED and k < 2:
            B_Q14 = [0] * LTP_ORDER
            B_Q14[LTP_ORDER // 2] = 4096  # SILK_FIX_CONST(0.25, 14)
            ctrl.LTPCoef_Q14[k * LTP_ORDER:(k + 1) * LTP_ORDER] = B_Q14
            signal_type = TYPE_VOICED
            ctrl.pitchL[k] = ch.lagPrev

        if signal_type == TYPE_VOICED:
            lag = ctrl.pitchL[k]
            if k == 0 or (k == 2 and nlsf_interp_flag):
                start_idx = ch.ltp_mem_length - lag - lpc_order \
                    - LTP_ORDER // 2
                assert start_idx > 0
                if k == 2:
                    for i in range(2 * subfr_length):
                        ch.outBuf[ch.ltp_mem_length + i] = xq[xq_off + i]
                lpc_analysis_filter(
                    sLTP_view(sLTP, start_idx), ch.outBuf,
                    start_idx + k * subfr_length, A_Q12,
                    ch.ltp_mem_length - start_idx, lpc_order)
                if k == 0:
                    inv_gain_q31 = m.LSHIFT32(
                        m.SMULWB(inv_gain_q31, ctrl.LTP_scale_Q14), 2)
                for i in range(lag + LTP_ORDER // 2):
                    sLTP_Q15[sLTP_buf_idx - i - 1] = m.SMULWB(
                        inv_gain_q31, sLTP[ch.ltp_mem_length - i - 1])
            else:
                if gain_adj_q16 != 1 << 16:
                    for i in range(lag + LTP_ORDER // 2):
                        sLTP_Q15[sLTP_buf_idx - i - 1] = m.SMULWW(
                            gain_adj_q16, sLTP_Q15[sLTP_buf_idx - i - 1])

        if signal_type == TYPE_VOICED:
            pred_base = sLTP_buf_idx - lag + LTP_ORDER // 2
            for i in range(subfr_length):
                ltp_pred_q13 = 2
                p = pred_base + i
                ltp_pred_q13 = m.SMLAWB(ltp_pred_q13, sLTP_Q15[p], B_Q14[0])
                ltp_pred_q13 = m.SMLAWB(ltp_pred_q13, sLTP_Q15[p - 1],
                                        B_Q14[1])
                ltp_pred_q13 = m.SMLAWB(ltp_pred_q13, sLTP_Q15[p - 2],
                                        B_Q14[2])
                ltp_pred_q13 = m.SMLAWB(ltp_pred_q13, sLTP_Q15[p - 3],
                                        B_Q14[3])
                ltp_pred_q13 = m.SMLAWB(ltp_pred_q13, sLTP_Q15[p - 4],
                                        B_Q14[4])
                res_Q14[i] = m.s32(ch.exc_Q14[pexc_off + i]
                                   + m.LSHIFT32(ltp_pred_q13, 1))
                sLTP_Q15[sLTP_buf_idx] = m.LSHIFT32(res_Q14[i], 1)
                sLTP_buf_idx += 1
            pres = res_Q14
            pres_off = 0
        else:
            pres = ch.exc_Q14
            pres_off = pexc_off

        for i in range(subfr_length):
            lpc_pred_q10 = lpc_order >> 1
            for j in range(lpc_order):
                lpc_pred_q10 = m.SMLAWB(
                    lpc_pred_q10, sLPC_Q14[MAX_LPC_ORDER + i - j - 1],
                    A_Q12[j])
            v = m.ADD_SAT32(pres[pres_off + i],
                            m.LSHIFT_SAT32(lpc_pred_q10, 4))
            sLPC_Q14[MAX_LPC_ORDER + i] = v
            xq[pxq_off + i] = m.SAT16(
                m.RSHIFT_ROUND(m.SMULWW(v, gain_q10), 8))

        sLPC_Q14[:MAX_LPC_ORDER] = \
            sLPC_Q14[subfr_length:subfr_length + MAX_LPC_ORDER]
        pexc_off += subfr_length
        pxq_off += subfr_length

    ch.sLPC_Q14_buf[:MAX_LPC_ORDER] = sLPC_Q14[:MAX_LPC_ORDER]


class sLTP_view:
    """List view with offset (mirrors &sLTP[start_idx] pointer math)."""

    def __init__(self, base, off):
        self.base = base
        self.off = off

    def __setitem__(self, i, v):
        self.base[self.off + i] = v

    def __getitem__(self, i):
        return self.base[self.off + i]
