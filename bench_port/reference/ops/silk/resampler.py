"""SILK polyphase resampler bank (internal 8/12/16 kHz -> API rate).

Mirrors the reference (reference src/silk.cpp): silk_resampler_init :3590,
silk_resampler :3676, private_up2_HQ :3513, private_IIR_FIR(_INTERPOL)
:3451-3511, private_down_FIR(_INTERPOL) :3305-3448, private_AR2 :3286,
down2 :3240, down2_3 :3187; coefficient tables src/silk.cpp:333-373.

The port's copy of esp32_opus_player_tpu/ops/silk/resampler.py: the
scalar decoders' ResamplerState; the batched resampler
(ops/silk/torch_core.py) takes its delay matrix and rateID.
"""
from __future__ import annotations

from ..tables import silk_tables as st
from . import macros as m

RESAMPLER_MAX_BATCH_SIZE_MS = 10
RESAMPLER_DOWN_ORDER_FIR0 = 18
RESAMPLER_DOWN_ORDER_FIR1 = 24
RESAMPLER_DOWN_ORDER_FIR2 = 36
RESAMPLER_ORDER_FIR_12 = 8

_DELAY_MATRIX_DEC = st.delay_matrix_dec.reshape(3, 5)
_FRAC_FIR_12 = st.silk_resampler_frac_FIR_12.reshape(12, 4)

USE_COPY = 0
USE_UP2_HQ = 1
USE_IIR_FIR = 2
USE_DOWN_FIR = 3


def _rate_id(r: int) -> int:
    """rateID macro (reference src/silk.h:397)."""
    return (((r >> 12) - (1 if r > 16000 else 0))
            >> (1 if r > 24000 else 0)) - 1


class ResamplerState:
    """silk_resampler_state_struct (reference src/silk.h:654-670)."""

    def __init__(self):
        self.sIIR = [0] * 6
        self.sFIR_i32 = [0] * 36
        self.sFIR_i16 = [0] * 36
        self.delayBuf = [0] * 48
        self.resampler_function = USE_COPY
        self.batchSize = 0
        self.invRatio_Q16 = 0
        self.FIR_Order = 0
        self.FIR_Fracs = 0
        self.Fs_in_kHz = 0
        self.Fs_out_kHz = 0
        self.inputDelay = 0
        self.coefs = None

    def init(self, fs_hz_in: int, fs_hz_out: int) -> None:
        """silk_resampler_init (:3590), decoder side."""
        self.__init__()
        if fs_hz_in not in (8000, 12000, 16000) or \
                fs_hz_out not in (8000, 12000, 16000, 24000, 48000):
            raise ValueError("unsupported resampler rates")
        self.inputDelay = int(
            _DELAY_MATRIX_DEC[_rate_id(fs_hz_in)][_rate_id(fs_hz_out)])
        self.Fs_in_kHz = fs_hz_in // 1000
        self.Fs_out_kHz = fs_hz_out // 1000
        self.batchSize = self.Fs_in_kHz * RESAMPLER_MAX_BATCH_SIZE_MS
        up2x = 0
        if fs_hz_out > fs_hz_in:
            if fs_hz_out == 2 * fs_hz_in:
                self.resampler_function = USE_UP2_HQ
            else:
                self.resampler_function = USE_IIR_FIR
                up2x = 1
        elif fs_hz_out < fs_hz_in:
            self.resampler_function = USE_DOWN_FIR
            if fs_hz_out * 4 == fs_hz_in * 3:
                self.FIR_Fracs = 3
                self.FIR_Order = RESAMPLER_DOWN_ORDER_FIR0
                self.coefs = st.silk_Resampler_3_4_COEFS
            elif fs_hz_out * 3 == fs_hz_in * 2:
                self.FIR_Fracs = 2
                self.FIR_Order = RESAMPLER_DOWN_ORDER_FIR0
                self.coefs = st.silk_Resampler_2_3_COEFS
            elif fs_hz_out * 2 == fs_hz_in:
                self.FIR_Fracs = 1
                self.FIR_Order = RESAMPLER_DOWN_ORDER_FIR1
                self.coefs = st.silk_Resampler_1_2_COEFS
            elif fs_hz_out * 3 == fs_hz_in:
                self.FIR_Fracs = 1
                self.FIR_Order = RESAMPLER_DOWN_ORDER_FIR2
                self.coefs = st.silk_Resampler_1_3_COEFS
            elif fs_hz_out * 4 == fs_hz_in:
                self.FIR_Fracs = 1
                self.FIR_Order = RESAMPLER_DOWN_ORDER_FIR2
                self.coefs = st.silk_Resampler_1_4_COEFS
            elif fs_hz_out * 6 == fs_hz_in:
                self.FIR_Fracs = 1
                self.FIR_Order = RESAMPLER_DOWN_ORDER_FIR2
                self.coefs = st.silk_Resampler_1_6_COEFS
            else:
                raise ValueError("no fractional resampler")
        else:
            self.resampler_function = USE_COPY
        self.invRatio_Q16 = m.LSHIFT32(
            m.DIV32(m.LSHIFT32(fs_hz_in, 14 + up2x), fs_hz_out), 2)
        while m.SMULWW(self.invRatio_Q16, fs_hz_out) < \
                m.LSHIFT32(fs_hz_in, up2x):
            self.invRatio_Q16 += 1

    # ------------------------------------------------------------------
    def process(self, out, out_off: int, inp, in_off: int,
                in_len: int) -> None:
        """silk_resampler (:3676). Writes the resampled signal to out."""
        n_samples = self.Fs_in_kHz - self.inputDelay
        self.delayBuf[self.inputDelay:self.inputDelay + n_samples] = \
            [int(inp[in_off + i]) for i in range(n_samples)]
        fn = {USE_UP2_HQ: self._up2_hq_block,
              USE_IIR_FIR: self._iir_fir_block,
              USE_DOWN_FIR: self._down_fir_block,
              USE_COPY: self._copy_block}[self.resampler_function]
        fn(out, out_off, self.delayBuf, 0, self.Fs_in_kHz)
        fn(out, out_off + self.Fs_out_kHz, inp, in_off + n_samples,
           in_len - self.Fs_in_kHz)
        self.delayBuf[:self.inputDelay] = \
            [int(inp[in_off + in_len - self.inputDelay + i])
             for i in range(self.inputDelay)]

    def _copy_block(self, out, out_off, inp, in_off, length):
        for i in range(length):
            out[out_off + i] = int(inp[in_off + i])

    # ------------------------------------------------------------------
    def _up2_hq(self, out, out_off, inp, in_off, length):
        """silk_resampler_private_up2_HQ (:3513)."""
        S = self.sIIR
        c0 = [int(x) for x in st.silk_resampler_up2_hq_0]
        c1 = [int(x) for x in st.silk_resampler_up2_hq_1]
        for k in range(length):
            in32 = m.LSHIFT32(int(inp[in_off + k]), 10)
            Y = m.SUB32(in32, S[0])
            X = m.SMULWB(Y, c0[0])
            out1 = m.ADD32(S[0], X)
            S[0] = m.ADD32(in32, X)
            Y = m.SUB32(out1, S[1])
            X = m.SMULWB(Y, c0[1])
            out2 = m.ADD32(S[1], X)
            S[1] = m.ADD32(out1, X)
            Y = m.SUB32(out2, S[2])
            X = m.SMLAWB(Y, Y, c0[2])
            out1 = m.ADD32(S[2], X)
            S[2] = m.ADD32(out2, X)
            out[out_off + 2 * k] = m.SAT16(m.RSHIFT_ROUND(out1, 10))
            Y = m.SUB32(in32, S[3])
            X = m.SMULWB(Y, c1[0])
            out1 = m.ADD32(S[3], X)
            S[3] = m.ADD32(in32, X)
            Y = m.SUB32(out1, S[4])
            X = m.SMULWB(Y, c1[1])
            out2 = m.ADD32(S[4], X)
            S[4] = m.ADD32(out1, X)
            Y = m.SUB32(out2, S[5])
            X = m.SMLAWB(Y, Y, c1[2])
            out1 = m.ADD32(S[5], X)
            S[5] = m.ADD32(out2, X)
            out[out_off + 2 * k + 1] = m.SAT16(m.RSHIFT_ROUND(out1, 10))

    def _up2_hq_block(self, out, out_off, inp, in_off, length):
        self._up2_hq(out, out_off, inp, in_off, length)

    # ------------------------------------------------------------------
    def _iir_fir_block(self, out, out_off, inp, in_off, in_len):
        """silk_resampler_private_IIR_FIR (:3481)."""
        buf = [0] * (2 * self.batchSize + RESAMPLER_ORDER_FIR_12)
        buf[:RESAMPLER_ORDER_FIR_12] = \
            self.sFIR_i16[:RESAMPLER_ORDER_FIR_12]
        index_increment_q16 = self.invRatio_Q16
        while True:
            n_in = min(in_len, self.batchSize)
            self._up2_hq(buf, RESAMPLER_ORDER_FIR_12, inp, in_off, n_in)
            max_index_q16 = m.LSHIFT32(n_in, 16 + 1)
            out_off = self._iir_fir_interpol(out, out_off, buf,
                                             max_index_q16,
                                             index_increment_q16)
            in_off += n_in
            in_len -= n_in
            if in_len > 0:
                buf[:RESAMPLER_ORDER_FIR_12] = \
                    buf[n_in << 1:(n_in << 1) + RESAMPLER_ORDER_FIR_12]
            else:
                break
        self.sFIR_i16[:RESAMPLER_ORDER_FIR_12] = \
            buf[n_in << 1:(n_in << 1) + RESAMPLER_ORDER_FIR_12]

    def _iir_fir_interpol(self, out, out_off, buf, max_index_q16,
                          index_increment_q16):
        """(:3451)"""
        fir = _FRAC_FIR_12
        index_q16 = 0
        while index_q16 < max_index_q16:
            table_index = m.SMULWB(index_q16 & 0xFFFF, 12)
            b = index_q16 >> 16
            res = m.SMULBB(buf[b], int(fir[table_index][0]))
            res = m.SMLABB(res, buf[b + 1], int(fir[table_index][1]))
            res = m.SMLABB(res, buf[b + 2], int(fir[table_index][2]))
            res = m.SMLABB(res, buf[b + 3], int(fir[table_index][3]))
            res = m.SMLABB(res, buf[b + 4], int(fir[11 - table_index][3]))
            res = m.SMLABB(res, buf[b + 5], int(fir[11 - table_index][2]))
            res = m.SMLABB(res, buf[b + 6], int(fir[11 - table_index][1]))
            res = m.SMLABB(res, buf[b + 7], int(fir[11 - table_index][0]))
            out[out_off] = m.SAT16(m.RSHIFT_ROUND(res, 15))
            out_off += 1
            index_q16 += index_increment_q16
        return out_off

    # ------------------------------------------------------------------
    def _ar2(self, S_off, out_q8, out_off, inp, in_off, coefs, length):
        """silk_resampler_private_AR2 (:3286)."""
        S = self.sIIR
        a0 = int(coefs[0])
        a1 = int(coefs[1])
        for k in range(length):
            out32 = m.s32(S[S_off] + m.LSHIFT32(int(inp[in_off + k]), 8))
            out_q8[out_off + k] = out32
            out32 = m.LSHIFT32(out32, 2)
            S[S_off] = m.SMLAWB(S[S_off + 1], out32, a0)
            S[S_off + 1] = m.SMULWB(out32, a1)

    def _down_fir_block(self, out, out_off, inp, in_off, in_len):
        """silk_resampler_private_down_FIR (:3420)."""
        buf = [0] * (self.batchSize + self.FIR_Order)
        buf[:self.FIR_Order] = self.sFIR_i32[:self.FIR_Order]
        fir_coefs = self.coefs[2:]
        index_increment_q16 = self.invRatio_Q16
        while True:
            n_in = min(in_len, self.batchSize)
            self._ar2(0, buf, self.FIR_Order, inp, in_off, self.coefs, n_in)
            max_index_q16 = m.LSHIFT32(n_in, 16)
            out_off = self._down_fir_interpol(out, out_off, buf, fir_coefs,
                                              max_index_q16,
                                              index_increment_q16)
            in_off += n_in
            in_len -= n_in
            if in_len > 1:
                buf[:self.FIR_Order] = buf[n_in:n_in + self.FIR_Order]
            else:
                break
        self.sFIR_i32[:self.FIR_Order] = buf[n_in:n_in + self.FIR_Order]

    def _down_fir_interpol(self, out, out_off, buf, fir, max_index_q16,
                           index_increment_q16):
        """(:3305)"""
        order = self.FIR_Order
        fracs = self.FIR_Fracs
        index_q16 = 0
        while index_q16 < max_index_q16:
            b = index_q16 >> 16
            if order == RESAMPLER_DOWN_ORDER_FIR0:
                interpol_ind = m.SMULWB(index_q16 & 0xFFFF, fracs)
                p1 = 9 * interpol_ind
                res = m.SMULWB(buf[b], int(fir[p1]))
                for j in range(1, 9):
                    res = m.SMLAWB(res, buf[b + j], int(fir[p1 + j]))
                p2 = 9 * (fracs - 1 - interpol_ind)
                for j in range(9):
                    res = m.SMLAWB(res, buf[b + 17 - j], int(fir[p2 + j]))
            elif order == RESAMPLER_DOWN_ORDER_FIR1:
                res = m.SMULWB(m.s32(buf[b] + buf[b + 23]), int(fir[0]))
                for j in range(1, 12):
                    res = m.SMLAWB(res, m.s32(buf[b + j] + buf[b + 23 - j]),
                                   int(fir[j]))
            else:  # FIR2 = 36
                res = m.SMULWB(m.ADD32(buf[b], buf[b + 35]), int(fir[0]))
                for j in range(1, 18):
                    res = m.SMLAWB(res,
                                   m.ADD32(buf[b + j], buf[b + 35 - j]),
                                   int(fir[j]))
            out[out_off] = m.SAT16(m.RSHIFT_ROUND(res, 6))
            out_off += 1
            index_q16 += index_increment_q16
        return out_off
