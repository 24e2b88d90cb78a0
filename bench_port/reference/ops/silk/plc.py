"""SILK packet-loss concealment + comfort noise generation.

Mirrors the reference (reference src/silk.cpp): silk_PLC :2871,
silk_PLC_update :2895, silk_PLC_energy :2957, silk_PLC_conceal :2973,
silk_PLC_glue_frames :3138, silk_CNG(_exc/_Reset) :1305-1432,
silk_sum_sqr_shift :3839.

The port's copy of esp32_opus_player_tpu/ops/silk/plc.py (numpy and
Python ints; nothing of the JAX package is imported).
"""
from __future__ import annotations

from ..tables import silk_tables as st
from . import macros as m
from .core import MAX_LPC_ORDER, lpc_analysis_filter, sLTP_view
from .decode import TYPE_VOICED, TYPE_NO_VOICE_ACTIVITY, LTP_ORDER

NB_ATT = 2
HARM_ATT_Q15 = (32440, 31130)
PLC_RAND_ATTENUATE_V_Q15 = (31130, 26214)
PLC_RAND_ATTENUATE_UV_Q15 = (32440, 29491)
V_PITCH_GAIN_START_MIN_Q14 = 11469
V_PITCH_GAIN_START_MAX_Q14 = 15565
MAX_PITCH_LAG_MS = 18
RAND_BUF_SIZE = 128
RAND_BUF_MASK = RAND_BUF_SIZE - 1
LOG2_INV_LPC_GAIN_HIGH_THRES = 3
LOG2_INV_LPC_GAIN_LOW_THRES = 8
PITCH_DRIFT_FAC_Q16 = 655
BWE_COEF_Q16 = 64881  # SILK_FIX_CONST(0.99, 16)
CNG_BUF_MASK_MAX = 255
CNG_GAIN_SMTH_Q16 = 4634
CNG_NLSF_SMTH_Q16 = 16348


def sum_sqr_shift(x, length: int):
    """silk_sum_sqr_shift (:3839). Returns (energy, shift)."""
    shft = 31 - m.CLZ32(length)
    nrg = length
    i = 0
    while i < length - 1:
        nrg_tmp = m.SMULBB(int(x[i]), int(x[i]))
        nrg_tmp = m.SMLABB_ovflw(nrg_tmp, int(x[i + 1]), int(x[i + 1]))
        nrg = m.s32(nrg + (m.u32(nrg_tmp) >> shft))
        i += 2
    if i < length:
        nrg_tmp = m.SMULBB(int(x[i]), int(x[i]))
        nrg = m.s32(nrg + (m.u32(nrg_tmp) >> shft))
    shft = max(0, shft + 3 - m.CLZ32(nrg))
    nrg = 0
    i = 0
    while i < length - 1:
        nrg_tmp = m.SMULBB(int(x[i]), int(x[i]))
        nrg_tmp = m.SMLABB_ovflw(nrg_tmp, int(x[i + 1]), int(x[i + 1]))
        nrg = m.s32(nrg + (m.u32(nrg_tmp) >> shft))
        i += 2
    if i < length:
        nrg_tmp = m.SMULBB(int(x[i]), int(x[i]))
        nrg = m.s32(nrg + (m.u32(nrg_tmp) >> shft))
    return nrg, shft


def plc_reset(ch) -> None:
    """silk_PLC_Reset (:2862)."""
    ch.plc_pitchL_Q8 = m.LSHIFT32(ch.frame_length, 8 - 1)
    ch.plc_prevGain_Q16 = [1 << 16, 1 << 16]
    ch.plc_subfr_length = 20
    ch.plc_nb_subfr = 2


def plc(ch, ctrl, frame, frame_off: int, lost: int) -> None:
    """silk_PLC (:2871)."""
    if ch.fs_kHz != ch.plc_fs_kHz:
        plc_reset(ch)
        ch.plc_fs_kHz = ch.fs_kHz
    if lost:
        plc_conceal(ch, ctrl, frame, frame_off)
        ch.lossCnt += 1
    else:
        plc_update(ch, ctrl)


def plc_update(ch, ctrl) -> None:
    """silk_PLC_update (:2895)."""
    ch.prevSignalType = ch.ind_signalType
    ltp_gain_q14 = 0
    if ch.ind_signalType == TYPE_VOICED:
        j = 0
        while j * ch.subfr_length < ctrl.pitchL[ch.nb_subfr - 1]:
            if j == ch.nb_subfr:
                break
            temp = 0
            for i in range(LTP_ORDER):
                temp += ctrl.LTPCoef_Q14[(ch.nb_subfr - 1 - j)
                                         * LTP_ORDER + i]
            if temp > ltp_gain_q14:
                ltp_gain_q14 = temp
                base = (ch.nb_subfr - 1 - j) * LTP_ORDER
                ch.plc_LTPCoef_Q14 = list(
                    ctrl.LTPCoef_Q14[base:base + LTP_ORDER])
                ch.plc_pitchL_Q8 = m.LSHIFT32(
                    ctrl.pitchL[ch.nb_subfr - 1 - j], 8)
            j += 1
        ch.plc_LTPCoef_Q14 = [0] * LTP_ORDER
        ch.plc_LTPCoef_Q14[LTP_ORDER // 2] = ltp_gain_q14

        if ltp_gain_q14 < V_PITCH_GAIN_START_MIN_Q14:
            scale_q10 = m.DIV32(m.LSHIFT32(V_PITCH_GAIN_START_MIN_Q14, 10),
                                max(ltp_gain_q14, 1))
            for i in range(LTP_ORDER):
                ch.plc_LTPCoef_Q14[i] = \
                    m.SMULBB(ch.plc_LTPCoef_Q14[i], scale_q10) >> 10
        elif ltp_gain_q14 > V_PITCH_GAIN_START_MAX_Q14:
            scale_q14 = m.DIV32(m.LSHIFT32(V_PITCH_GAIN_START_MAX_Q14, 14),
                                max(ltp_gain_q14, 1))
            for i in range(LTP_ORDER):
                ch.plc_LTPCoef_Q14[i] = \
                    m.SMULBB(ch.plc_LTPCoef_Q14[i], scale_q14) >> 14
    else:
        ch.plc_pitchL_Q8 = m.LSHIFT32(m.SMULBB(ch.fs_kHz, 18), 8)
        ch.plc_LTPCoef_Q14 = [0] * LTP_ORDER

    ch.plc_prevLPC_Q12 = list(ctrl.PredCoef_Q12[1][:ch.LPC_order])
    ch.plc_prevLTP_scale_Q14 = ctrl.LTP_scale_Q14
    ch.plc_prevGain_Q16 = list(ctrl.Gains_Q16[ch.nb_subfr - 2:ch.nb_subfr])
    ch.plc_subfr_length = ch.subfr_length
    ch.plc_nb_subfr = ch.nb_subfr


def plc_energy(ch, prev_gain_q10):
    """silk_PLC_energy (:2957)."""
    sl = ch.subfr_length
    exc_buf = [0] * (2 * sl)
    for k in range(2):
        for i in range(sl):
            exc_buf[k * sl + i] = m.SAT16(
                m.SMULWW(ch.exc_Q14[i + (k + ch.nb_subfr - 2) * sl],
                         prev_gain_q10[k]) >> 8)
    e1, s1 = sum_sqr_shift(exc_buf[:sl], sl)
    e2, s2 = sum_sqr_shift(exc_buf[sl:], sl)
    return e1, s1, e2, s2


def plc_conceal(ch, ctrl, frame, frame_off: int) -> None:
    """silk_PLC_conceal (:2973)."""
    from .nlsf import bwexpander, lpc_inverse_pred_gain
    lm = ch.ltp_mem_length
    fl = ch.frame_length
    sLTP_Q14 = [0] * (lm + fl)
    sLTP = [0] * lm
    prev_gain_q10 = [ch.plc_prevGain_Q16[0] >> 6,
                     ch.plc_prevGain_Q16[1] >> 6]

    if ch.first_frame_after_reset:
        ch.plc_prevLPC_Q12 = [0] * MAX_LPC_ORDER

    e1, s1, e2, s2 = plc_energy(ch, prev_gain_q10)
    if (e1 >> s2) < (e2 >> s1):
        rand_off = max(0, (ch.plc_nb_subfr - 1) * ch.plc_subfr_length
                       - RAND_BUF_SIZE)
    else:
        rand_off = max(0, ch.plc_nb_subfr * ch.plc_subfr_length
                       - RAND_BUF_SIZE)

    B_Q14 = ch.plc_LTPCoef_Q14
    rand_scale_q14 = ch.plc_randScale_Q14
    harm_gain_q15 = HARM_ATT_Q15[min(NB_ATT - 1, ch.lossCnt)]
    if ch.prevSignalType == TYPE_VOICED:
        rand_gain_q15 = PLC_RAND_ATTENUATE_V_Q15[min(NB_ATT - 1,
                                                     ch.lossCnt)]
    else:
        rand_gain_q15 = PLC_RAND_ATTENUATE_UV_Q15[min(NB_ATT - 1,
                                                      ch.lossCnt)]

    bwexpander(ch.plc_prevLPC_Q12, ch.LPC_order, BWE_COEF_Q16)
    A_Q12 = ch.plc_prevLPC_Q12

    if ch.lossCnt == 0:
        rand_scale_q14 = 1 << 14
        if ch.prevSignalType == TYPE_VOICED:
            for i in range(LTP_ORDER):
                rand_scale_q14 -= B_Q14[i]
            rand_scale_q14 = max(3277, rand_scale_q14)
            rand_scale_q14 = m.s16(
                m.SMULBB(rand_scale_q14, ch.plc_prevLTP_scale_Q14) >> 14)
        else:
            inv_gain_q30 = lpc_inverse_pred_gain(ch.plc_prevLPC_Q12,
                                                 ch.LPC_order)
            down_scale_q30 = min((1 << 30) >> LOG2_INV_LPC_GAIN_HIGH_THRES,
                                 inv_gain_q30)
            down_scale_q30 = max((1 << 30) >> LOG2_INV_LPC_GAIN_LOW_THRES,
                                 down_scale_q30)
            down_scale_q30 = m.LSHIFT32(down_scale_q30,
                                        LOG2_INV_LPC_GAIN_HIGH_THRES)
            rand_gain_q15 = m.SMULWB(down_scale_q30, rand_gain_q15) >> 14

    rand_seed = ch.plc_rand_seed
    lag = m.RSHIFT_ROUND(ch.plc_pitchL_Q8, 8)
    sLTP_buf_idx = lm

    idx = lm - lag - ch.LPC_order - LTP_ORDER // 2
    assert idx > 0
    lpc_analysis_filter(sLTP_view(sLTP, idx), ch.outBuf, idx, A_Q12,
                        lm - idx, ch.LPC_order)
    inv_gain_q30 = m.INVERSE32_varQ(ch.plc_prevGain_Q16[1], 46)
    inv_gain_q30 = min(inv_gain_q30, m.INT32_MAX >> 1)
    for i in range(idx + ch.LPC_order, lm):
        sLTP_Q14[i] = m.SMULWB(inv_gain_q30, sLTP[i])

    for k in range(ch.nb_subfr):
        pred_base = sLTP_buf_idx - lag + LTP_ORDER // 2
        for i in range(ch.subfr_length):
            p = pred_base + i
            ltp_pred_q12 = 2
            ltp_pred_q12 = m.SMLAWB(ltp_pred_q12, sLTP_Q14[p], B_Q14[0])
            ltp_pred_q12 = m.SMLAWB(ltp_pred_q12, sLTP_Q14[p - 1], B_Q14[1])
            ltp_pred_q12 = m.SMLAWB(ltp_pred_q12, sLTP_Q14[p - 2], B_Q14[2])
            ltp_pred_q12 = m.SMLAWB(ltp_pred_q12, sLTP_Q14[p - 3], B_Q14[3])
            ltp_pred_q12 = m.SMLAWB(ltp_pred_q12, sLTP_Q14[p - 4], B_Q14[4])
            rand_seed = m.silk_RAND(rand_seed)
            idx2 = (rand_seed >> 25) & RAND_BUF_MASK
            sLTP_Q14[sLTP_buf_idx] = m.LSHIFT32(
                m.SMLAWB(ltp_pred_q12, ch.exc_Q14[rand_off + idx2],
                         rand_scale_q14), 2)
            sLTP_buf_idx += 1
        for j in range(LTP_ORDER):
            B_Q14[j] = m.SMULBB(harm_gain_q15, B_Q14[j]) >> 15
        if ch.ind_signalType != TYPE_NO_VOICE_ACTIVITY:
            rand_scale_q14 = m.SMULBB(rand_scale_q14, rand_gain_q15) >> 15
        ch.plc_pitchL_Q8 = m.SMLAWB(ch.plc_pitchL_Q8, ch.plc_pitchL_Q8,
                                    PITCH_DRIFT_FAC_Q16)
        ch.plc_pitchL_Q8 = min(ch.plc_pitchL_Q8,
                               m.LSHIFT32(m.SMULBB(MAX_PITCH_LAG_MS,
                                                   ch.fs_kHz), 8))
        lag = m.RSHIFT_ROUND(ch.plc_pitchL_Q8, 8)

    # LPC synthesis over sLTP_Q14[lm - 16:]
    base = lm - MAX_LPC_ORDER
    sLTP_Q14[base:base + MAX_LPC_ORDER] = ch.sLPC_Q14_buf[:MAX_LPC_ORDER]
    for i in range(fl):
        lpc_pred_q10 = ch.LPC_order >> 1
        for j in range(ch.LPC_order):
            lpc_pred_q10 = m.SMLAWB(
                lpc_pred_q10, sLTP_Q14[base + MAX_LPC_ORDER + i - j - 1],
                A_Q12[j])
        v = m.ADD_SAT32(sLTP_Q14[base + MAX_LPC_ORDER + i],
                        m.LSHIFT_SAT32(lpc_pred_q10, 4))
        sLTP_Q14[base + MAX_LPC_ORDER + i] = v
        frame[frame_off + i] = m.SAT16(
            m.RSHIFT_ROUND(m.SMULWW(v, prev_gain_q10[1]), 8))

    ch.sLPC_Q14_buf[:MAX_LPC_ORDER] = \
        sLTP_Q14[base + fl:base + fl + MAX_LPC_ORDER]
    ch.plc_rand_seed = rand_seed
    ch.plc_randScale_Q14 = rand_scale_q14
    for i in range(4):
        ctrl.pitchL[i] = lag


def plc_glue_frames(ch, frame, frame_off: int, length: int) -> None:
    """silk_PLC_glue_frames (:3138)."""
    if ch.lossCnt:
        ch.plc_conc_energy, ch.plc_conc_energy_shift = sum_sqr_shift(
            frame[frame_off:frame_off + length], length)
        ch.plc_last_frame_lost = 1
    else:
        if ch.plc_last_frame_lost:
            energy, energy_shift = sum_sqr_shift(
                frame[frame_off:frame_off + length], length)
            if energy_shift > ch.plc_conc_energy_shift:
                ch.plc_conc_energy >>= energy_shift - \
                    ch.plc_conc_energy_shift
            elif energy_shift < ch.plc_conc_energy_shift:
                energy >>= ch.plc_conc_energy_shift - energy_shift
            if energy > ch.plc_conc_energy:
                lz = m.CLZ32(ch.plc_conc_energy) - 1
                ch.plc_conc_energy = m.LSHIFT32(ch.plc_conc_energy, lz)
                energy >>= max(24 - lz, 0)
                frac_q24 = m.DIV32(ch.plc_conc_energy, max(energy, 1))
                gain_q16 = m.LSHIFT32(m.SQRT_APPROX(frac_q24), 4)
                slope_q16 = m.DIV32_16((1 << 16) - gain_q16, length)
                slope_q16 = m.LSHIFT32(slope_q16, 2)
                for i in range(length):
                    frame[frame_off + i] = m.SMULWB(
                        gain_q16, int(frame[frame_off + i]))
                    gain_q16 += slope_q16
                    if gain_q16 > 1 << 16:
                        break
        ch.plc_last_frame_lost = 0


# ---------------------------------------------------------------------------
# comfort noise generation
# ---------------------------------------------------------------------------

def cng_reset(ch) -> None:
    """silk_CNG_Reset (:1327)."""
    nlsf_step = m.DIV32_16(32767, ch.LPC_order + 1)
    acc = 0
    ch.cng_smth_NLSF_Q15 = [0] * MAX_LPC_ORDER
    for i in range(ch.LPC_order):
        acc += nlsf_step
        ch.cng_smth_NLSF_Q15[i] = acc
    ch.cng_smth_Gain_Q16 = 0
    ch.cng_rand_seed = 3176576


def cng_exc(exc_q14, off, exc_buf_q14, length: int, rand_seed: int) -> int:
    """silk_CNG_exc (:1305)."""
    exc_mask = CNG_BUF_MASK_MAX
    while exc_mask > length:
        exc_mask >>= 1
    seed = rand_seed
    for i in range(length):
        seed = m.silk_RAND(seed)
        idx = (seed >> 24) & exc_mask
        exc_q14[off + i] = exc_buf_q14[idx]
    return seed


def cng(ch, ctrl, frame, frame_off: int, length: int) -> None:
    """silk_CNG (:1342)."""
    from .nlsf import nlsf2a
    if ch.fs_kHz != ch.cng_fs_kHz:
        cng_reset(ch)
        ch.cng_fs_kHz = ch.fs_kHz
    if ch.lossCnt == 0 and ch.prevSignalType == TYPE_NO_VOICE_ACTIVITY:
        for i in range(ch.LPC_order):
            ch.cng_smth_NLSF_Q15[i] += m.SMULWB(
                ch.prevNLSF_Q15[i] - ch.cng_smth_NLSF_Q15[i],
                CNG_NLSF_SMTH_Q16)
        max_gain = 0
        subfr = 0
        for i in range(ch.nb_subfr):
            if ctrl.Gains_Q16[i] > max_gain:
                max_gain = ctrl.Gains_Q16[i]
                subfr = i
        sl = ch.subfr_length
        ch.cng_exc_buf_Q14[sl:ch.nb_subfr * sl] = \
            ch.cng_exc_buf_Q14[:(ch.nb_subfr - 1) * sl]
        ch.cng_exc_buf_Q14[:sl] = \
            [ch.exc_Q14[subfr * sl + i] for i in range(sl)]
        for i in range(ch.nb_subfr):
            ch.cng_smth_Gain_Q16 += m.SMULWB(
                ctrl.Gains_Q16[i] - ch.cng_smth_Gain_Q16,
                CNG_GAIN_SMTH_Q16)
    if ch.lossCnt:
        cng_sig_q14 = [0] * (length + MAX_LPC_ORDER)
        gain_q16 = m.SMULWW(ch.plc_randScale_Q14, ch.plc_prevGain_Q16[1])
        if gain_q16 >= (1 << 21) or ch.cng_smth_Gain_Q16 > (1 << 23):
            gain_q16 = m.SMULTT(gain_q16, gain_q16)
            gain_q16 = m.SUB32(
                m.SMULTT(ch.cng_smth_Gain_Q16, ch.cng_smth_Gain_Q16),
                m.LSHIFT32(gain_q16, 5))
            gain_q16 = m.LSHIFT32(m.SQRT_APPROX(gain_q16), 16)
        else:
            gain_q16 = m.SMULWW(gain_q16, gain_q16)
            gain_q16 = m.SUB32(
                m.SMULWW(ch.cng_smth_Gain_Q16, ch.cng_smth_Gain_Q16),
                m.LSHIFT32(gain_q16, 5))
            gain_q16 = m.LSHIFT32(m.SQRT_APPROX(gain_q16), 8)
        gain_q10 = gain_q16 >> 6
        ch.cng_rand_seed = cng_exc(cng_sig_q14, MAX_LPC_ORDER,
                                   ch.cng_exc_buf_Q14, length,
                                   ch.cng_rand_seed)
        a_q12 = nlsf2a(ch.cng_smth_NLSF_Q15, ch.LPC_order)
        cng_sig_q14[:MAX_LPC_ORDER] = ch.cng_synth_state[:MAX_LPC_ORDER]
        for i in range(length):
            lpc_pred_q10 = ch.LPC_order >> 1
            for j in range(ch.LPC_order):
                lpc_pred_q10 = m.SMLAWB(
                    lpc_pred_q10, cng_sig_q14[MAX_LPC_ORDER + i - j - 1],
                    a_q12[j])
            cng_sig_q14[MAX_LPC_ORDER + i] = m.ADD_SAT32(
                cng_sig_q14[MAX_LPC_ORDER + i],
                m.LSHIFT_SAT32(lpc_pred_q10, 4))
            frame[frame_off + i] = m.ADD_SAT16(
                int(frame[frame_off + i]),
                m.SAT16(m.RSHIFT_ROUND(
                    m.SMULWW(cng_sig_q14[MAX_LPC_ORDER + i], gain_q10), 8)))
        ch.cng_synth_state[:MAX_LPC_ORDER] = \
            cng_sig_q14[length:length + MAX_LPC_ORDER]
    else:
        ch.cng_synth_state = [0] * MAX_LPC_ORDER
