"""SILK NLSF machinery: 2-stage VQ decode, stabilization, NLSF->LPC.

Mirrors the reference (reference src/silk.cpp): silk_NLSF_unpack :2762,
silk_NLSF_residual_dequant :2445, silk_NLSF_decode :2466,
silk_NLSF_stabilize :2676, silk_NLSF2A(_find_poly) :626-705,
silk_LPC_fit :2314, LPC_inverse_pred_gain :2359-2442,
silk_bwexpander(_32) :561-590, silk_interpolate :2219.

The port's copy of esp32_opus_player_tpu/ops/silk/nlsf.py (numpy and
Python ints; nothing of the JAX package is imported).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..tables import silk_tables as st
from . import macros as m

NLSF_QUANT_MAX_AMPLITUDE = 4
NLSF_QUANT_LEVEL_ADJ_Q10 = 102  # SILK_FIX_CONST(0.1, 10)
MAX_LPC_ORDER = 16
MAX_LOOPS = 20
MAX_LPC_STABILIZE_ITERATIONS = 16
A_LIMIT = 16773022  # SILK_FIX_CONST(0.99975, 24)
LSF_COS_TAB = [int(x) for x in st.silk_LSFCosTab_FIX_Q12]


@dataclass(frozen=True)
class NLSFCodebook:
    """silk_NLSF_CB_struct (reference src/silk.cpp:384-427)."""
    nVectors: int
    order: int
    quantStepSize_Q16: int
    invQuantStepSize_Q6: int
    CB1_NLSF_Q8: np.ndarray
    CB1_Wght_Q9: np.ndarray
    CB1_iCDF: np.ndarray
    pred_Q8: np.ndarray
    ec_sel: np.ndarray
    ec_iCDF: np.ndarray
    ec_Rates_Q5: np.ndarray
    deltaMin_Q15: np.ndarray


NLSF_CB_NB_MB = NLSFCodebook(
    nVectors=32, order=10,
    quantStepSize_Q16=11796,       # SILK_FIX_CONST(0.18, 16)
    invQuantStepSize_Q6=356,       # SILK_FIX_CONST(1/0.18, 6)
    CB1_NLSF_Q8=st.silk_NLSF_CB1_NB_MB_Q8,
    CB1_Wght_Q9=st.silk_NLSF_CB1_Wght_Q9,
    CB1_iCDF=st.silk_NLSF_CB1_iCDF_NB_MB,
    pred_Q8=st.silk_NLSF_PRED_NB_MB_Q8,
    ec_sel=st.silk_NLSF_CB2_SELECT_NB_MB,
    ec_iCDF=st.silk_NLSF_CB2_iCDF_NB_MB,
    ec_Rates_Q5=st.silk_NLSF_CB2_BITS_NB_MB_Q5,
    deltaMin_Q15=st.silk_NLSF_DELTA_MIN_NB_MB_Q15)

NLSF_CB_WB = NLSFCodebook(
    nVectors=32, order=16,
    quantStepSize_Q16=9830,        # SILK_FIX_CONST(0.15, 16)
    invQuantStepSize_Q6=427,       # SILK_FIX_CONST(1/0.15, 6)
    CB1_NLSF_Q8=st.silk_NLSF_CB1_WB_Q8,
    CB1_Wght_Q9=st.silk_NLSF_CB1_WB_Wght_Q9,
    CB1_iCDF=st.silk_NLSF_CB1_iCDF_WB,
    pred_Q8=st.silk_NLSF_PRED_WB_Q8,
    ec_sel=st.silk_NLSF_CB2_SELECT_WB,
    ec_iCDF=st.silk_NLSF_CB2_iCDF_WB,
    ec_Rates_Q5=st.silk_NLSF_CB2_BITS_WB_Q5,
    deltaMin_Q15=st.silk_NLSF_DELTA_MIN_WB_Q15)


def nlsf_unpack(cb: NLSFCodebook, cb1_index: int):
    """silk_NLSF_unpack (:2762)."""
    ec_ix = [0] * cb.order
    pred_q8 = [0] * cb.order
    sel = cb.ec_sel
    base = cb1_index * cb.order // 2
    for i in range(0, cb.order, 2):
        entry = int(sel[base + i // 2])
        ec_ix[i] = ((entry >> 1) & 7) * (2 * NLSF_QUANT_MAX_AMPLITUDE + 1)
        pred_q8[i] = int(cb.pred_Q8[i + (entry & 1) * (cb.order - 1)])
        ec_ix[i + 1] = ((entry >> 5) & 7) * (2 * NLSF_QUANT_MAX_AMPLITUDE + 1)
        pred_q8[i + 1] = int(cb.pred_Q8[i + ((entry >> 4) & 1)
                                        * (cb.order - 1) + 1])
    return ec_ix, pred_q8


def nlsf_residual_dequant(indices, pred_q8, quant_step_size_q16: int,
                          order: int):
    """silk_NLSF_residual_dequant (:2445)."""
    x_q10 = [0] * order
    out_q10 = 0
    for i in range(order - 1, -1, -1):
        pred_q10 = m.SMULBB(out_q10, pred_q8[i]) >> 8
        out_q10 = m.s32(indices[i] << 10)
        if out_q10 > 0:
            out_q10 = out_q10 - NLSF_QUANT_LEVEL_ADJ_Q10
        elif out_q10 < 0:
            out_q10 = out_q10 + NLSF_QUANT_LEVEL_ADJ_Q10
        out_q10 = m.SMLAWB(pred_q10, out_q10, quant_step_size_q16)
        x_q10[i] = out_q10
    return x_q10


def nlsf_stabilize(nlsf_q15, delta_min_q15, L: int) -> None:
    """silk_NLSF_stabilize (:2676)."""
    dmin = [int(x) for x in delta_min_q15]
    for _ in range(MAX_LOOPS):
        min_diff = nlsf_q15[0] - dmin[0]
        I = 0
        for i in range(1, L):
            diff = nlsf_q15[i] - (nlsf_q15[i - 1] + dmin[i])
            if diff < min_diff:
                min_diff = diff
                I = i
        diff = (1 << 15) - (nlsf_q15[L - 1] + dmin[L])
        if diff < min_diff:
            min_diff = diff
            I = L
        if min_diff >= 0:
            return
        if I == 0:
            nlsf_q15[0] = dmin[0]
        elif I == L:
            nlsf_q15[L - 1] = (1 << 15) - dmin[L]
        else:
            min_center = sum(dmin[:I]) + (dmin[I] >> 1)
            max_center = (1 << 15) - (dmin[I] >> 1)
            for k in range(L, I, -1):
                max_center -= dmin[k]
            center = m.LIMIT(m.RSHIFT_ROUND(nlsf_q15[I - 1] + nlsf_q15[I], 1),
                             min_center, max_center)
            center = m.s16(center)
            nlsf_q15[I - 1] = center - (dmin[I] >> 1)
            nlsf_q15[I] = nlsf_q15[I - 1] + dmin[I]
    # fallback (:2745)
    nlsf_q15[:L] = sorted(nlsf_q15[:L])
    nlsf_q15[0] = max(nlsf_q15[0], dmin[0])
    for i in range(1, L):
        nlsf_q15[i] = max(nlsf_q15[i],
                          m.ADD_SAT16(nlsf_q15[i - 1], dmin[i]))
    nlsf_q15[L - 1] = min(nlsf_q15[L - 1], (1 << 15) - dmin[L])
    for i in range(L - 2, -1, -1):
        nlsf_q15[i] = min(nlsf_q15[i], nlsf_q15[i + 1] - dmin[i + 1])


def nlsf_decode(nlsf_indices, cb: NLSFCodebook):
    """silk_NLSF_decode (:2466). Returns list of Q15 NLSFs."""
    ec_ix, pred_q8 = nlsf_unpack(cb, nlsf_indices[0])
    res_q10 = nlsf_residual_dequant(nlsf_indices[1:], pred_q8,
                                    cb.quantStepSize_Q16, cb.order)
    base = nlsf_indices[0] * cb.order
    nlsf_q15 = [0] * cb.order
    for i in range(cb.order):
        w = int(cb.CB1_Wght_Q9[base + i])
        nlsf_tmp = m.DIV32_16(m.LSHIFT32(res_q10[i], 14), w) + \
            (int(cb.CB1_NLSF_Q8[base + i]) << 7)
        nlsf_q15[i] = m.LIMIT(m.s32(nlsf_tmp), 0, 32767)
    nlsf_stabilize(nlsf_q15, cb.deltaMin_Q15, cb.order)
    return nlsf_q15


def bwexpander(ar, d: int, chirp_q16: int) -> None:
    """silk_bwexpander (:578) — int16 coefficients."""
    chirp_minus_one = chirp_q16 - 65536
    for i in range(d - 1):
        ar[i] = m.s16(m.RSHIFT_ROUND(m.MUL(chirp_q16, int(ar[i])), 16))
        chirp_q16 += m.RSHIFT_ROUND(m.MUL(chirp_q16, chirp_minus_one), 16)
    ar[d - 1] = m.s16(m.RSHIFT_ROUND(m.MUL(chirp_q16, int(ar[d - 1])), 16))


def bwexpander_32(ar, d: int, chirp_q16: int) -> None:
    """silk_bwexpander_32 (:561)."""
    chirp_minus_one = chirp_q16 - 65536
    for i in range(d - 1):
        ar[i] = m.SMULWW(chirp_q16, int(ar[i]))
        chirp_q16 += m.RSHIFT_ROUND(m.MUL(chirp_q16, chirp_minus_one), 16)
    ar[d - 1] = m.SMULWW(chirp_q16, int(ar[d - 1]))


def lpc_fit(a_qin, qout: int, qin: int, d: int):
    """silk_LPC_fit (:2314). a_qin: list modified in place; returns a_qout."""
    clipped = True
    for it in range(10):
        maxabs = 0
        idx = 0
        for k in range(d):
            absval = abs(a_qin[k])
            if absval > maxabs:
                maxabs = absval
                idx = k
        maxabs = m.RSHIFT_ROUND(maxabs, qin - qout)
        if maxabs > 32767:
            maxabs = min(maxabs, 163838)
            chirp_q16 = 65470 - m.DIV32(  # SILK_FIX_CONST(0.999,16)
                m.LSHIFT32(maxabs - 32767, 14),
                m.RSHIFT32(m.MUL(maxabs, idx + 1), 2))
            bwexpander_32(a_qin, d, chirp_q16)
        else:
            clipped = False
            break
    a_qout = [0] * d
    if clipped:
        for k in range(d):
            a_qout[k] = m.SAT16(m.RSHIFT_ROUND(a_qin[k], qin - qout))
            a_qin[k] = m.LSHIFT32(a_qout[k], qin - qout)
    else:
        for k in range(d):
            a_qout[k] = m.s16(m.RSHIFT_ROUND(a_qin[k], qin - qout))
    return a_qout


def _mul32_frac_q(a32: int, b32: int, q: int) -> int:
    return m.s32(_rshift_round64(a32 * b32, q))


def _rshift_round64(a: int, shift: int) -> int:
    if shift == 1:
        return (a >> 1) + (a & 1)
    return ((a >> (shift - 1)) + 1) >> 1


def lpc_inverse_pred_gain_qa(A_QA, order: int) -> int:
    """LPC_inverse_pred_gain_QA_c (:2359), QA = 24."""
    invGain_Q30 = 1 << 30
    for k in range(order - 1, 0, -1):
        if A_QA[k] > A_LIMIT or A_QA[k] < -A_LIMIT:
            return 0
        rc_Q31 = -m.LSHIFT32(A_QA[k], 31 - 24)
        rc_mult1_Q30 = m.SUB32(1 << 30, m.SMMUL(rc_Q31, rc_Q31))
        invGain_Q30 = m.LSHIFT32(m.SMMUL(invGain_Q30, rc_mult1_Q30), 2)
        if invGain_Q30 < 107374:  # SILK_FIX_CONST(1/1e4, 30)
            return 0
        mult2Q = 32 - m.CLZ32(m.silk_abs(rc_mult1_Q30))
        rc_mult2 = m.INVERSE32_varQ(rc_mult1_Q30, mult2Q + 30)
        for n in range((k + 1) >> 1):
            tmp1 = A_QA[n]
            tmp2 = A_QA[k - n - 1]
            tmp64 = _rshift_round64(
                m.SUB_SAT32(tmp1, _mul32_frac_q(tmp2, rc_Q31, 31))
                * rc_mult2, mult2Q)
            if tmp64 > m.INT32_MAX or tmp64 < m.INT32_MIN:
                return 0
            A_QA[n] = tmp64
            tmp64 = _rshift_round64(
                m.SUB_SAT32(tmp2, _mul32_frac_q(tmp1, rc_Q31, 31))
                * rc_mult2, mult2Q)
            if tmp64 > m.INT32_MAX or tmp64 < m.INT32_MIN:
                return 0
            A_QA[k - n - 1] = tmp64
    if A_QA[0] > A_LIMIT or A_QA[0] < -A_LIMIT:
        return 0
    rc_Q31 = -m.LSHIFT32(A_QA[0], 31 - 24)
    rc_mult1_Q30 = m.SUB32(1 << 30, m.SMMUL(rc_Q31, rc_Q31))
    invGain_Q30 = m.LSHIFT32(m.SMMUL(invGain_Q30, rc_mult1_Q30), 2)
    if invGain_Q30 < 107374:
        return 0
    return invGain_Q30


def lpc_inverse_pred_gain(a_q12, order: int) -> int:
    """silk_LPC_inverse_pred_gain_c (:2425)."""
    dc_resp = 0
    A_QA = [0] * order
    for k in range(order):
        dc_resp += int(a_q12[k])
        A_QA[k] = m.LSHIFT32(int(a_q12[k]), 24 - 12)
    if dc_resp >= 4096:
        return 0
    return lpc_inverse_pred_gain_qa(A_QA, order)


_ORDERING16 = (0, 15, 8, 7, 4, 11, 12, 3, 2, 13, 10, 5, 6, 9, 14, 1)
_ORDERING10 = (0, 9, 6, 3, 4, 5, 8, 1, 2, 7)


def _nlsf2a_find_poly(cLSF, off: int, dd: int):
    """silk_NLSF2A_find_poly (:626), QA16 = 16."""
    out = [0] * (dd + 1)
    out[0] = 1 << 16
    out[1] = -cLSF[off]
    for k in range(1, dd):
        ftmp = cLSF[off + 2 * k]
        out[k + 1] = m.s32(m.LSHIFT32(out[k - 1], 1)
                           - m.s32(_rshift_round64(ftmp * out[k], 16)))
        for n in range(k, 1, -1):
            out[n] = m.s32(out[n] + out[n - 2]
                           - m.s32(_rshift_round64(ftmp * out[n - 1], 16)))
        out[1] -= ftmp
    return out


def nlsf2a(nlsf_q15, d: int):
    """silk_NLSF2A (:642). Returns a_Q12 list of int16."""
    ordering = _ORDERING16 if d == 16 else _ORDERING10
    cos_lsf_qa = [0] * d
    for k in range(d):
        f_int = nlsf_q15[k] >> (15 - 7)
        f_frac = nlsf_q15[k] - (f_int << (15 - 7))
        cos_val = LSF_COS_TAB[f_int]
        delta = LSF_COS_TAB[f_int + 1] - cos_val
        cos_lsf_qa[ordering[k]] = m.RSHIFT_ROUND(
            m.LSHIFT32(cos_val, 8) + m.MUL(delta, f_frac), 20 - 16)
    dd = d >> 1
    P = _nlsf2a_find_poly(cos_lsf_qa, 0, dd)
    Q = _nlsf2a_find_poly(cos_lsf_qa, 1, dd)
    a32_qa1 = [0] * d
    for k in range(dd):
        Ptmp = m.s32(P[k + 1] + P[k])
        Qtmp = m.s32(Q[k + 1] - Q[k])
        a32_qa1[k] = m.s32(-Qtmp - Ptmp)
        a32_qa1[d - k - 1] = m.s32(Qtmp - Ptmp)
    a_q12 = lpc_fit(a32_qa1, 12, 16 + 1, d)
    i = 0
    while lpc_inverse_pred_gain(a_q12, d) == 0 and \
            i < MAX_LPC_STABILIZE_ITERATIONS:
        bwexpander_32(a32_qa1, d, 65536 - m.LSHIFT32(2, i))
        for k in range(d):
            a_q12[k] = m.s16(m.RSHIFT_ROUND(a32_qa1[k], 16 + 1 - 12))
        i += 1
    return a_q12


def interpolate(x0, x1, ifact_q2: int, d: int):
    """silk_interpolate (:2219)."""
    return [m.s16(x0[i] + (m.SMULBB(x1[i] - x0[i], ifact_q2) >> 2))
            for i in range(d)]
