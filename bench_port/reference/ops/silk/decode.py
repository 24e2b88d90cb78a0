"""SILK side-info and excitation decoding (host symbol phase).

Mirrors the reference (reference src/silk.cpp): silk_decode_indices :708,
silk_decode_pulses :898, silk_shell_decoder/decode_split :1146-1184,
silk_decode_signs :1436, silk_gains_dequant :2148, silk_decode_pitch :2055,
silk_lin2log/log2lin :2233-2265, stereo pred decode :592-623.

The port's copy of esp32_opus_player_tpu/ops/silk/decode.py (numpy and
Python ints; nothing of the JAX package is imported).
"""
from __future__ import annotations

from ..tables import silk_tables as st
from . import macros as m

TYPE_NO_VOICE_ACTIVITY = 0
TYPE_UNVOICED = 1
TYPE_VOICED = 2
CODE_INDEPENDENTLY = 0
CODE_INDEPENDENTLY_NO_LTP_SCALING = 1
CODE_CONDITIONALLY = 2
MAX_NB_SUBFR = 4
LTP_ORDER = 5
SHELL_FRAME = 16
SILK_MAX_PULSES = 16
N_RATE_LEVELS = 10
MIN_DELTA_GAIN_QUANT = -4
MAX_DELTA_GAIN_QUANT = 36
N_LEVELS_QGAIN = 64
OFFSET_GAIN = (2 * 128) // 6 + 16 * 128          # silk.h OFFSET
INV_SCALE_Q16 = (65536 * (((88 - 2) * 128) // 6)) // (64 - 1)
PE_MIN_LAG_MS = 2
PE_MAX_LAG_MS = 18

_SHELL_TABLES = (st.silk_shell_code_table0, st.silk_shell_code_table1,
                 st.silk_shell_code_table2, st.silk_shell_code_table3)
_SHELL_OFFSETS = [int(x) for x in st.silk_shell_code_table_offsets]
LTP_GAIN_ICDF_PTRS = (st.silk_LTP_gain_iCDF_0, st.silk_LTP_gain_iCDF_1,
                      st.silk_LTP_gain_iCDF_2)
LTP_VQ_PTRS_Q7 = (st.silk_LTP_gain_vq_0.reshape(-1),
                  st.silk_LTP_gain_vq_1.reshape(-1),
                  st.silk_LTP_gain_vq_2.reshape(-1))
LBRR_FLAGS_ICDF_PTR = (st.silk_LBRR_flags_2_iCDF, st.silk_LBRR_flags_3_iCDF)


def lin2log(in_lin: int) -> int:
    """silk_lin2log (:2233)."""
    lz, frac_q7 = m.CLZ_FRAC(in_lin)
    return m.s32(m.SMLAWB(frac_q7, m.MUL(frac_q7, 128 - frac_q7), 179)
                 + ((31 - lz) << 7))


def log2lin(in_log_q7: int) -> int:
    """silk_log2lin (:2246)."""
    if in_log_q7 < 0:
        return 0
    if in_log_q7 >= 3967:
        return m.INT32_MAX
    out = m.LSHIFT32(1, in_log_q7 >> 7)
    frac_q7 = in_log_q7 & 0x7F
    if in_log_q7 < 2048:
        out = m.s32(out + (m.MUL(out, m.SMLAWB(
            frac_q7, m.SMULBB(frac_q7, 128 - frac_q7), -174)) >> 7))
    else:
        out = m.MLA(out, out >> 7, m.SMLAWB(
            frac_q7, m.SMULBB(frac_q7, 128 - frac_q7), -174))
    return out


def gains_dequant(gains_indices, prev_ind: int, conditional: int,
                  nb_subfr: int):
    """silk_gains_dequant (:2148). Returns (gains_Q16, prev_ind)."""
    gains_q16 = [0] * nb_subfr
    for k in range(nb_subfr):
        if k == 0 and not conditional:
            prev_ind = max(gains_indices[k], prev_ind - 16)
        else:
            ind_tmp = gains_indices[k] + MIN_DELTA_GAIN_QUANT
            double_step = 2 * MAX_DELTA_GAIN_QUANT - N_LEVELS_QGAIN \
                + prev_ind
            if ind_tmp > double_step:
                prev_ind += m.LSHIFT32(ind_tmp, 1) - double_step
            else:
                prev_ind += ind_tmp
        prev_ind = m.LIMIT(prev_ind, 0, N_LEVELS_QGAIN - 1)
        gains_q16[k] = log2lin(
            min(m.SMULWB(INV_SCALE_Q16, prev_ind) + OFFSET_GAIN, 3967))
    return gains_q16, prev_ind


def decode_pitch(lag_index: int, contour_index: int, fs_khz: int,
                 nb_subfr: int):
    """silk_decode_pitch (:2055)."""
    if fs_khz == 8:
        if nb_subfr == 4:
            cb = st.silk_CB_lags_stage2
            cbk_size = 11
        else:
            cb = st.silk_CB_lags_stage2_10_ms
            cbk_size = 3
    else:
        if nb_subfr == 4:
            cb = st.silk_CB_lags_stage3
            cbk_size = 34
        else:
            cb = st.silk_CB_lags_stage3_10_ms
            cbk_size = 12
    cb = cb.reshape(-1)
    min_lag = PE_MIN_LAG_MS * fs_khz
    max_lag = PE_MAX_LAG_MS * fs_khz
    lag = min_lag + lag_index
    return [m.LIMIT(lag + int(cb[k * cbk_size + contour_index]),
                    min_lag, max_lag) for k in range(nb_subfr)]


def decode_indices(dec, ch, frame_index: int, decode_lbrr: int,
                   cond_coding: int) -> None:
    """silk_decode_indices (:708). ch: SilkChannelState."""
    if decode_lbrr or ch.VAD_flags[frame_index]:
        ix = dec.dec_icdf(st.silk_type_offset_VAD_iCDF, 8) + 2
    else:
        ix = dec.dec_icdf(st.silk_type_offset_no_VAD_iCDF, 8)
    ch.ind_signalType = ix >> 1
    ch.ind_quantOffsetType = ix & 1

    if cond_coding == CODE_CONDITIONALLY:
        ch.ind_GainsIndices[0] = dec.dec_icdf(st.silk_delta_gain_iCDF, 8)
    else:
        ch.ind_GainsIndices[0] = dec.dec_icdf(
            st.silk_gain_iCDF[ch.ind_signalType], 8) << 3
        ch.ind_GainsIndices[0] += dec.dec_icdf(st.silk_uniform8_iCDF, 8)
    for i in range(1, ch.nb_subfr):
        ch.ind_GainsIndices[i] = dec.dec_icdf(st.silk_delta_gain_iCDF, 8)

    cb = ch.psNLSF_CB
    ch.ind_NLSFIndices[0] = dec.dec_icdf(
        cb.CB1_iCDF[(ch.ind_signalType >> 1) * cb.nVectors:], 8)
    from .nlsf import nlsf_unpack, NLSF_QUANT_MAX_AMPLITUDE
    ec_ix, _pred = nlsf_unpack(cb, ch.ind_NLSFIndices[0])
    for i in range(cb.order):
        ix = dec.dec_icdf(cb.ec_iCDF[ec_ix[i]:], 8)
        if ix == 0:
            ix -= dec.dec_icdf(st.silk_NLSF_EXT_iCDF, 8)
        elif ix == 2 * NLSF_QUANT_MAX_AMPLITUDE:
            ix += dec.dec_icdf(st.silk_NLSF_EXT_iCDF, 8)
        ch.ind_NLSFIndices[i + 1] = ix - NLSF_QUANT_MAX_AMPLITUDE

    if ch.nb_subfr == MAX_NB_SUBFR:
        ch.ind_NLSFInterpCoef_Q2 = dec.dec_icdf(
            st.silk_NLSF_interpolation_factor_iCDF, 8)
    else:
        ch.ind_NLSFInterpCoef_Q2 = 4

    if ch.ind_signalType == TYPE_VOICED:
        decode_absolute = 1
        if cond_coding == CODE_CONDITIONALLY and \
                ch.ec_prevSignalType == TYPE_VOICED:
            delta_lag = dec.dec_icdf(st.silk_pitch_delta_iCDF, 8)
            if delta_lag > 0:
                ch.ind_lagIndex = m.s16(ch.ec_prevLagIndex + delta_lag - 9)
                decode_absolute = 0
        if decode_absolute:
            lag = dec.dec_icdf(st.silk_pitch_lag_iCDF, 8) * (ch.fs_kHz >> 1)
            lag += dec.dec_icdf(ch.pitch_lag_low_bits_iCDF, 8)
            ch.ind_lagIndex = m.s16(lag)
        ch.ec_prevLagIndex = ch.ind_lagIndex
        ch.ind_contourIndex = dec.dec_icdf(ch.pitch_contour_iCDF, 8)
        ch.ind_PERIndex = dec.dec_icdf(st.silk_LTP_per_index_iCDF, 8)
        for k in range(ch.nb_subfr):
            ch.ind_LTPIndex[k] = dec.dec_icdf(
                LTP_GAIN_ICDF_PTRS[ch.ind_PERIndex], 8)
        if cond_coding == CODE_INDEPENDENTLY:
            ch.ind_LTP_scaleIndex = dec.dec_icdf(st.silk_LTPscale_iCDF, 8)
        else:
            ch.ind_LTP_scaleIndex = 0
    ch.ec_prevSignalType = ch.ind_signalType
    ch.ind_Seed = dec.dec_icdf(st.silk_uniform4_iCDF, 8)


def _decode_split(dec, p: int, shell_table):
    if p > 0:
        c1 = dec.dec_icdf(shell_table[_SHELL_OFFSETS[p]:], 8)
        return c1, p - c1
    return 0, 0


def shell_decoder(dec, pulses, off: int, pulses4: int) -> None:
    """silk_shell_decoder (:1162)."""
    t0, t1, t2, t3 = _SHELL_TABLES
    p3 = _decode_split(dec, pulses4, t3)
    p2_01 = _decode_split(dec, p3[0], t2)
    p1_01 = _decode_split(dec, p2_01[0], t1)
    pulses[off + 0], pulses[off + 1] = _decode_split(dec, p1_01[0], t0)
    pulses[off + 2], pulses[off + 3] = _decode_split(dec, p1_01[1], t0)
    p1_23 = _decode_split(dec, p2_01[1], t1)
    pulses[off + 4], pulses[off + 5] = _decode_split(dec, p1_23[0], t0)
    pulses[off + 6], pulses[off + 7] = _decode_split(dec, p1_23[1], t0)
    p2_23 = _decode_split(dec, p3[1], t2)
    p1_45 = _decode_split(dec, p2_23[0], t1)
    pulses[off + 8], pulses[off + 9] = _decode_split(dec, p1_45[0], t0)
    pulses[off + 10], pulses[off + 11] = _decode_split(dec, p1_45[1], t0)
    p1_67 = _decode_split(dec, p2_23[1], t1)
    pulses[off + 12], pulses[off + 13] = _decode_split(dec, p1_67[0], t0)
    pulses[off + 14], pulses[off + 15] = _decode_split(dec, p1_67[1], t0)


def decode_signs(dec, pulses, length: int, signal_type: int,
                 quant_offset_type: int, sum_pulses) -> None:
    """silk_decode_signs (:1436)."""
    icdf = [0, 0]
    base = 7 * (quant_offset_type + (signal_type << 1))
    n_blocks = (length + SHELL_FRAME // 2) >> 4
    off = 0
    for i in range(n_blocks):
        p = sum_pulses[i]
        if p > 0:
            icdf[0] = int(st.silk_sign_iCDF[base + min(p & 0x1F, 6)])
            for j in range(SHELL_FRAME):
                if pulses[off + j] > 0:
                    pulses[off + j] *= 2 * dec.dec_icdf(icdf, 8) - 1
        off += SHELL_FRAME


def decode_pulses(dec, signal_type: int, quant_offset_type: int,
                  frame_length: int):
    """silk_decode_pulses (:898). Returns pulses list."""
    rate_level = dec.dec_icdf(
        st.silk_rate_levels_iCDF[signal_type >> 1], 8)
    niter = frame_length >> 4
    if niter * SHELL_FRAME < frame_length:
        assert frame_length == 120
        niter += 1
    sum_pulses = [0] * niter
    n_lshifts = [0] * niter
    cdf = st.silk_pulses_per_block_iCDF[rate_level]
    for i in range(niter):
        sum_pulses[i] = dec.dec_icdf(cdf, 8)
        while sum_pulses[i] == SILK_MAX_PULSES + 1:
            n_lshifts[i] += 1
            sum_pulses[i] = dec.dec_icdf(
                st.silk_pulses_per_block_iCDF[N_RATE_LEVELS - 1]
                [(1 if n_lshifts[i] == 10 else 0):], 8)
    pulses = [0] * (niter * SHELL_FRAME)
    for i in range(niter):
        if sum_pulses[i] > 0:
            shell_decoder(dec, pulses, i * SHELL_FRAME, sum_pulses[i])
    for i in range(niter):
        if n_lshifts[i] > 0:
            nls = n_lshifts[i]
            for k in range(SHELL_FRAME):
                abs_q = pulses[i * SHELL_FRAME + k]
                for _ in range(nls):
                    abs_q = (abs_q << 1) + dec.dec_icdf(st.silk_lsb_iCDF, 8)
                pulses[i * SHELL_FRAME + k] = abs_q
            sum_pulses[i] |= nls << 5
    decode_signs(dec, pulses, frame_length, signal_type, quant_offset_type,
                 sum_pulses)
    return pulses


def stereo_decode_pred(dec):
    """silk_stereo_decode_pred (:592). Returns pred_Q13[2]."""
    n = dec.dec_icdf(st.silk_stereo_pred_joint_iCDF, 8)
    ix = [[0, 0, 0], [0, 0, 0]]
    ix[0][2] = n // 5
    ix[1][2] = n - 5 * ix[0][2]
    for ch in range(2):
        ix[ch][0] = dec.dec_icdf(st.silk_uniform3_iCDF, 8)
        ix[ch][1] = dec.dec_icdf(st.silk_uniform5_iCDF, 8)
    pred = [0, 0]
    for ch in range(2):
        ix[ch][0] += 3 * ix[ch][2]
        low = int(st.silk_stereo_pred_quant_Q13[ix[ch][0]])
        step = m.SMULWB(int(st.silk_stereo_pred_quant_Q13[ix[ch][0] + 1])
                        - low, 6554)  # SILK_FIX_CONST(0.5/5, 16)
        pred[ch] = m.SMLABB(low, step, 2 * ix[ch][1] + 1)
    pred[0] -= pred[1]
    return pred


def stereo_decode_mid_only(dec) -> int:
    return dec.dec_icdf(st.silk_stereo_only_code_mid_iCDF, 8)
