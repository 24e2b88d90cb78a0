"""SILK decoder model: packet-level control, per-frame decode, stereo,
resampling — the host orchestration layer.

Mirrors the reference (reference src/silk.cpp): silk_Decode :1481,
silk_decode_frame :1974, silk_decoder_set_fs :978, silk_init_decoder :2192,
silk_decode_parameters :827, state structs src/silk.h:705-815.

The port's copy of esp32_opus_player_tpu/models/silk_decoder.py (numpy
and Python ints; nothing of the JAX package is imported).
"""
from __future__ import annotations

import numpy as np

from ..ops.silk import macros as m
from ..ops.silk import decode as sd
from ..ops.silk import nlsf as sn
from ..ops.silk import core as sc
from ..ops.silk import plc as sp
from ..ops.silk.resampler import ResamplerState
from ..ops.silk import stereo as sst
from ..ops.tables import silk_tables as st

MAX_LPC_ORDER = 16
MAX_FRAME_LENGTH = 320
MAX_NB_SUBFR = 4
LTP_ORDER = 5
FLAG_DECODE_NORMAL = 0
FLAG_PACKET_LOST = 1
FLAG_DECODE_LBRR = 2
BWE_AFTER_LOSS_Q16 = 63570


class DecoderControl:
    """silk_decoder_control_t (reference src/silk.h:747-755)."""

    def __init__(self):
        self.pitchL = [0] * MAX_NB_SUBFR
        self.Gains_Q16 = [0] * MAX_NB_SUBFR
        self.PredCoef_Q12 = [[0] * MAX_LPC_ORDER, [0] * MAX_LPC_ORDER]
        self.LTPCoef_Q14 = [0] * (LTP_ORDER * MAX_NB_SUBFR)
        self.LTP_scale_Q14 = 0


class SilkChannelState:
    """silk_decoder_state_t (reference src/silk.h:705-741)."""

    def __init__(self):
        self.reset()

    def reset(self):
        """silk_init_decoder (:2192): full clear + specific re-inits."""
        self.prev_gain_Q16 = 65536
        self.exc_Q14 = [0] * MAX_FRAME_LENGTH
        self.sLPC_Q14_buf = [0] * MAX_LPC_ORDER
        self.outBuf = [0] * (MAX_FRAME_LENGTH + 2 * 80)
        self.lagPrev = 0
        self.LastGainIndex = 0
        self.fs_kHz = 0
        self.fs_API_hz = 0
        self.nb_subfr = 0
        self.frame_length = 0
        self.subfr_length = 0
        self.ltp_mem_length = 0
        self.LPC_order = 0
        self.prevNLSF_Q15 = [0] * MAX_LPC_ORDER
        self.first_frame_after_reset = 1
        self.pitch_lag_low_bits_iCDF = None
        self.pitch_contour_iCDF = None
        self.psNLSF_CB = None
        self.nFramesDecoded = 0
        self.nFramesPerPacket = 0
        self.ec_prevSignalType = 0
        self.ec_prevLagIndex = 0
        self.VAD_flags = [0, 0, 0]
        self.LBRR_flag = 0
        self.LBRR_flags = [0, 0, 0]
        self.lossCnt = 0
        self.prevSignalType = 0
        # indices (SideInfoIndices, src/silk.h:690-703)
        self.ind_GainsIndices = [0] * MAX_NB_SUBFR
        self.ind_LTPIndex = [0] * MAX_NB_SUBFR
        self.ind_NLSFIndices = [0] * (MAX_LPC_ORDER + 1)
        self.ind_lagIndex = 0
        self.ind_contourIndex = 0
        self.ind_signalType = 0
        self.ind_quantOffsetType = 0
        self.ind_NLSFInterpCoef_Q2 = 0
        self.ind_PERIndex = 0
        self.ind_LTP_scaleIndex = 0
        self.ind_Seed = 0
        # CNG state (silk_CNG_struct)
        self.cng_exc_buf_Q14 = [0] * MAX_FRAME_LENGTH
        self.cng_smth_NLSF_Q15 = [0] * MAX_LPC_ORDER
        self.cng_synth_state = [0] * MAX_LPC_ORDER
        self.cng_smth_Gain_Q16 = 0
        self.cng_rand_seed = 0
        self.cng_fs_kHz = 0
        # PLC state (silk_PLC_struct)
        self.plc_pitchL_Q8 = 0
        self.plc_LTPCoef_Q14 = [0] * LTP_ORDER
        self.plc_prevLPC_Q12 = [0] * MAX_LPC_ORDER
        self.plc_last_frame_lost = 0
        self.plc_rand_seed = 0
        self.plc_randScale_Q14 = 0
        self.plc_conc_energy = 0
        self.plc_conc_energy_shift = 0
        self.plc_prevLTP_scale_Q14 = 0
        self.plc_prevGain_Q16 = [0, 0]
        self.plc_fs_kHz = 0
        self.plc_nb_subfr = 0
        self.plc_subfr_length = 0
        sp.cng_reset(self)
        sp.plc_reset(self)


class StereoState:
    def __init__(self):
        self.pred_prev_Q13 = [0, 0]
        self.sMid = [0, 0]
        self.sSide = [0, 0]


class SilkDecoder:
    """Top-level SILK decoder (reference silk_decoder_t + globals)."""

    def __init__(self):
        self.channel_states = [SilkChannelState(), SilkChannelState()]
        self.resamplers = [ResamplerState(), ResamplerState()]
        self.stereo = StereoState()
        self.prev_decode_only_middle = 0
        self.nChannelsAPI = 0
        self.nChannelsInternal = 0
        # setRawParams side channel (src/silk.cpp:1468)
        self.s_channelsInternal = 1
        self.s_API_channels = 1
        self.s_payloadSize_ms = 20
        self.s_internalSampleRate = 16000
        self.s_API_sampleRate = 48000
        self.prevPitchLag = 0

    def init_decoder(self):
        """silk_InitDecoder (:1792)."""
        for chst in self.channel_states:
            chst.reset()
        self.stereo = StereoState()
        self.prev_decode_only_middle = 0

    def set_raw_params(self, channels, api_channels, payload_ms,
                       internal_rate, api_rate):
        self.s_channelsInternal = channels
        self.s_API_channels = api_channels
        self.s_payloadSize_ms = payload_ms
        self.s_internalSampleRate = internal_rate
        self.s_API_sampleRate = api_rate

    # ------------------------------------------------------------------
    def _set_fs(self, n: int, fs_khz: int, fs_api_hz: int):
        """silk_decoder_set_fs (:978)."""
        ch = self.channel_states[n]
        ch.subfr_length = 5 * fs_khz
        frame_length = ch.nb_subfr * ch.subfr_length
        if ch.fs_kHz != fs_khz or ch.fs_API_hz != fs_api_hz:
            self.resamplers[n].init(fs_khz * 1000, fs_api_hz)
            ch.fs_API_hz = fs_api_hz
        if ch.fs_kHz != fs_khz or frame_length != ch.frame_length:
            if fs_khz == 8:
                ch.pitch_contour_iCDF = st.silk_pitch_contour_NB_iCDF \
                    if ch.nb_subfr == MAX_NB_SUBFR \
                    else st.silk_pitch_contour_10_ms_NB_iCDF
            else:
                ch.pitch_contour_iCDF = st.silk_pitch_contour_iCDF \
                    if ch.nb_subfr == MAX_NB_SUBFR \
                    else st.silk_pitch_contour_10_ms_iCDF
            if ch.fs_kHz != fs_khz:
                ch.ltp_mem_length = 20 * fs_khz
                if fs_khz in (8, 12):
                    ch.LPC_order = 10
                    ch.psNLSF_CB = sn.NLSF_CB_NB_MB
                else:
                    ch.LPC_order = 16
                    ch.psNLSF_CB = sn.NLSF_CB_WB
                if fs_khz == 16:
                    ch.pitch_lag_low_bits_iCDF = st.silk_uniform8_iCDF
                elif fs_khz == 12:
                    ch.pitch_lag_low_bits_iCDF = st.silk_uniform6_iCDF
                else:
                    ch.pitch_lag_low_bits_iCDF = st.silk_uniform4_iCDF
                ch.first_frame_after_reset = 1
                ch.lagPrev = 100
                ch.LastGainIndex = 10
                ch.prevSignalType = sd.TYPE_NO_VOICE_ACTIVITY
                ch.outBuf = [0] * (MAX_FRAME_LENGTH + 2 * 80)
                ch.sLPC_Q14_buf = [0] * MAX_LPC_ORDER
            ch.fs_kHz = fs_khz
            ch.frame_length = frame_length

    # ------------------------------------------------------------------
    def _decode_parameters(self, n: int, ctrl: DecoderControl,
                           cond_coding: int):
        """silk_decode_parameters (:827)."""
        ch = self.channel_states[n]
        ctrl.Gains_Q16, ch.LastGainIndex = sd.gains_dequant(
            ch.ind_GainsIndices, ch.LastGainIndex,
            cond_coding == sd.CODE_CONDITIONALLY, ch.nb_subfr)
        nlsf_q15 = sn.nlsf_decode(ch.ind_NLSFIndices, ch.psNLSF_CB)
        ctrl.PredCoef_Q12[1] = sn.nlsf2a(nlsf_q15, ch.LPC_order)
        if ch.first_frame_after_reset == 1:
            ch.ind_NLSFInterpCoef_Q2 = 4
        if ch.ind_NLSFInterpCoef_Q2 < 4:
            nlsf0 = [m.s16(ch.prevNLSF_Q15[i]
                           + ((ch.ind_NLSFInterpCoef_Q2
                               * (nlsf_q15[i] - ch.prevNLSF_Q15[i])) >> 2))
                     for i in range(ch.LPC_order)]
            ctrl.PredCoef_Q12[0] = sn.nlsf2a(nlsf0, ch.LPC_order)
        else:
            ctrl.PredCoef_Q12[0] = list(ctrl.PredCoef_Q12[1])
        ch.prevNLSF_Q15[:ch.LPC_order] = nlsf_q15
        if ch.lossCnt:
            sn.bwexpander(ctrl.PredCoef_Q12[0], ch.LPC_order,
                          BWE_AFTER_LOSS_Q16)
            sn.bwexpander(ctrl.PredCoef_Q12[1], ch.LPC_order,
                          BWE_AFTER_LOSS_Q16)
        if ch.ind_signalType == sd.TYPE_VOICED:
            ctrl.pitchL = sd.decode_pitch(ch.ind_lagIndex,
                                          ch.ind_contourIndex, ch.fs_kHz,
                                          ch.nb_subfr)
            cbk = sd.LTP_VQ_PTRS_Q7[ch.ind_PERIndex]
            for k in range(ch.nb_subfr):
                ix = ch.ind_LTPIndex[k]
                for i in range(LTP_ORDER):
                    ctrl.LTPCoef_Q14[k * LTP_ORDER + i] = \
                        int(cbk[ix * LTP_ORDER + i]) << 7
            ctrl.LTP_scale_Q14 = int(
                st.silk_LTPScales_table_Q14[ch.ind_LTP_scaleIndex])
        else:
            ctrl.pitchL = [0] * MAX_NB_SUBFR
            ctrl.LTPCoef_Q14 = [0] * (LTP_ORDER * MAX_NB_SUBFR)
            ch.ind_PERIndex = 0
            ctrl.LTP_scale_Q14 = 0

    # ------------------------------------------------------------------
    def _decode_frame(self, dec, n: int, pout, pout_off: int,
                      lost_flag: int, cond_coding: int) -> int:
        """silk_decode_frame (:1974)."""
        ch = self.channel_states[n]
        ctrl = DecoderControl()
        L = ch.frame_length
        assert 0 < L <= MAX_FRAME_LENGTH
        if lost_flag == FLAG_DECODE_NORMAL or \
                (lost_flag == FLAG_DECODE_LBRR
                 and ch.LBRR_flags[ch.nFramesDecoded] == 1):
            sd.decode_indices(dec, ch, ch.nFramesDecoded, lost_flag,
                              cond_coding)
            pulses = sd.decode_pulses(dec, ch.ind_signalType,
                                      ch.ind_quantOffsetType,
                                      ch.frame_length)
            self._decode_parameters(n, ctrl, cond_coding)
            sc.decode_core(ch, ctrl, pout, pout_off, pulses)
            sp.plc(ch, ctrl, pout, pout_off, 0)
            ch.lossCnt = 0
            ch.prevSignalType = ch.ind_signalType
            ch.first_frame_after_reset = 0
        else:
            ch.ind_signalType = ch.prevSignalType
            sp.plc(ch, ctrl, pout, pout_off, 1)
        # update output buffer (:2032)
        mv_len = ch.ltp_mem_length - ch.frame_length
        ch.outBuf[:mv_len] = ch.outBuf[ch.frame_length:ch.ltp_mem_length]
        for i in range(ch.frame_length):
            ch.outBuf[mv_len + i] = int(pout[pout_off + i])
        sp.cng(ch, ctrl, pout, pout_off, L)
        sp.plc_glue_frames(ch, pout, pout_off, L)
        ch.lagPrev = ctrl.pitchL[ch.nb_subfr - 1]
        return L

    # ------------------------------------------------------------------
    def decode(self, dec, lost: int, first_frame: bool, pcm) -> int:
        """silk_Decode (:1481). Returns samples per channel at API rate,
        written interleaved (nChannelsAPI) into pcm."""
        n_ch_int = self.s_channelsInternal
        n_ch_api = self.s_API_channels
        api_rate = self.s_API_sampleRate
        decode_only_middle = 0
        ms_pred_q13 = [0, 0]

        if first_frame:
            for n in range(n_ch_int):
                self.channel_states[n].nFramesDecoded = 0

        if n_ch_int > self.nChannelsInternal:
            self.channel_states[1].reset()

        stereo_to_mono = (n_ch_int == 1 and self.nChannelsInternal == 2 and
                          self.s_internalSampleRate ==
                          1000 * self.channel_states[0].fs_kHz)

        if self.channel_states[0].nFramesDecoded == 0:
            for n in range(n_ch_int):
                ch = self.channel_states[n]
                ms = self.s_payloadSize_ms
                if ms in (0, 10):
                    ch.nFramesPerPacket = 1
                    ch.nb_subfr = 2
                elif ms == 20:
                    ch.nFramesPerPacket = 1
                    ch.nb_subfr = 4
                elif ms == 40:
                    ch.nFramesPerPacket = 2
                    ch.nb_subfr = 4
                elif ms == 60:
                    ch.nFramesPerPacket = 3
                    ch.nb_subfr = 4
                else:
                    raise ValueError("invalid frame size")
                fs_khz_dec = (self.s_internalSampleRate >> 10) + 1
                assert fs_khz_dec in (8, 12, 16)
                self._set_fs(n, fs_khz_dec, api_rate)

        if n_ch_api == 2 and n_ch_int == 2 and \
                (self.nChannelsAPI == 1 or self.nChannelsInternal == 1):
            self.stereo.pred_prev_Q13 = [0, 0]
            self.stereo.sSide = [0, 0]
        self.nChannelsAPI = n_ch_api
        self.nChannelsInternal = n_ch_int

        cs0 = self.channel_states[0]
        cs1 = self.channel_states[1]

        if lost != FLAG_PACKET_LOST and cs0.nFramesDecoded == 0:
            for n in range(n_ch_int):
                ch = self.channel_states[n]
                for i in range(ch.nFramesPerPacket):
                    ch.VAD_flags[i] = dec.dec_bit_logp(1)
                ch.LBRR_flag = dec.dec_bit_logp(1)
            for n in range(n_ch_int):
                ch = self.channel_states[n]
                ch.LBRR_flags = [0, 0, 0]
                if ch.LBRR_flag:
                    if ch.nFramesPerPacket == 1:
                        ch.LBRR_flags[0] = 1
                    else:
                        sym = dec.dec_icdf(
                            sd.LBRR_FLAGS_ICDF_PTR[ch.nFramesPerPacket - 2],
                            8) + 1
                        for i in range(ch.nFramesPerPacket):
                            ch.LBRR_flags[i] = (sym >> i) & 1
            if lost == FLAG_DECODE_NORMAL:
                # skip LBRR data (:1590)
                for i in range(cs0.nFramesPerPacket):
                    for n in range(n_ch_int):
                        ch = self.channel_states[n]
                        if ch.LBRR_flags[i]:
                            if n_ch_int == 2 and n == 0:
                                sd.stereo_decode_pred(dec)
                                if cs1.LBRR_flags[i] == 0:
                                    sd.stereo_decode_mid_only(dec)
                            cond = sd.CODE_CONDITIONALLY if (
                                i > 0 and ch.LBRR_flags[i - 1]) \
                                else sd.CODE_INDEPENDENTLY
                            sd.decode_indices(dec, ch, i, 1, cond)
                            sd.decode_pulses(dec, ch.ind_signalType,
                                             ch.ind_quantOffsetType,
                                             ch.frame_length)

        if n_ch_int == 2:
            if lost == FLAG_DECODE_NORMAL or \
                    (lost == FLAG_DECODE_LBRR
                     and cs0.LBRR_flags[cs0.nFramesDecoded] == 1):
                ms_pred_q13 = sd.stereo_decode_pred(dec)
                if (lost == FLAG_DECODE_NORMAL
                        and cs1.VAD_flags[cs0.nFramesDecoded] == 0) or \
                        (lost == FLAG_DECODE_LBRR
                         and cs1.LBRR_flags[cs0.nFramesDecoded] == 0):
                    decode_only_middle = sd.stereo_decode_mid_only(dec)
                else:
                    decode_only_middle = 0
            else:
                ms_pred_q13 = list(self.stereo.pred_prev_Q13)

        if n_ch_int == 2 and decode_only_middle == 0 and \
                self.prev_decode_only_middle == 1:
            cs1.outBuf = [0] * (MAX_FRAME_LENGTH + 2 * 80)
            cs1.sLPC_Q14_buf = [0] * MAX_LPC_ORDER
            cs1.lagPrev = 100
            cs1.LastGainIndex = 10
            cs1.prevSignalType = sd.TYPE_NO_VOICE_ACTIVITY
            cs1.first_frame_after_reset = 1

        if lost == FLAG_DECODE_NORMAL:
            has_side = not decode_only_middle
        else:
            has_side = (not self.prev_decode_only_middle) or \
                (n_ch_int == 2 and lost == FLAG_DECODE_LBRR and
                 cs1.LBRR_flags[cs1.nFramesDecoded] == 1)

        fl = cs0.frame_length
        out_tmp = [[0] * (fl + 2), [0] * (fl + 2)]
        n_samples_dec = fl
        for n in range(n_ch_int):
            if n == 0 or has_side:
                frame_index = cs0.nFramesDecoded - n
                if frame_index <= 0:
                    cond = sd.CODE_INDEPENDENTLY
                elif lost == FLAG_DECODE_LBRR:
                    cond = sd.CODE_CONDITIONALLY if \
                        self.channel_states[n].LBRR_flags[frame_index - 1] \
                        else sd.CODE_INDEPENDENTLY
                elif n > 0 and self.prev_decode_only_middle:
                    cond = sd.CODE_INDEPENDENTLY_NO_LTP_SCALING
                else:
                    cond = sd.CODE_CONDITIONALLY
                n_samples_dec = self._decode_frame(dec, n, out_tmp[n], 2,
                                                   lost, cond)
            else:
                for i in range(n_samples_dec):
                    out_tmp[n][2 + i] = 0
            self.channel_states[n].nFramesDecoded += 1

        if n_ch_api == 2 and n_ch_int == 2:
            sst.ms_to_lr(self.stereo, out_tmp[0], out_tmp[1], ms_pred_q13,
                         cs0.fs_kHz, n_samples_dec)
        else:
            out_tmp[0][0:2] = self.stereo.sMid
            self.stereo.sMid = [out_tmp[0][n_samples_dec],
                                out_tmp[0][n_samples_dec + 1]]

        n_samples_out = (n_samples_dec * api_rate) // (cs0.fs_kHz * 1000)

        resample_out = [0] * n_samples_out
        for n in range(min(n_ch_api, n_ch_int)):
            self.resamplers[n].process(resample_out, 0, out_tmp[n], 1,
                                       n_samples_dec)
            if n_ch_api == 2:
                for i in range(n_samples_out):
                    pcm[n + 2 * i] = resample_out[i]
            else:
                for i in range(n_samples_out):
                    pcm[i] = resample_out[i]

        if n_ch_api == 2 and n_ch_int == 1:
            if stereo_to_mono:
                self.resamplers[1].process(resample_out, 0, out_tmp[0], 1,
                                           n_samples_dec)
                for i in range(n_samples_out):
                    pcm[1 + 2 * i] = resample_out[i]
            else:
                for i in range(n_samples_out):
                    pcm[1 + 2 * i] = pcm[2 * i]

        if cs0.prevSignalType == sd.TYPE_VOICED:
            mult_tab = (6, 4, 3)
            self.prevPitchLag = cs0.lagPrev * \
                mult_tab[(cs0.fs_kHz - 8) >> 2]
        else:
            self.prevPitchLag = 0

        if lost == FLAG_PACKET_LOST:
            for i in range(self.nChannelsInternal):
                self.channel_states[i].LastGainIndex = 10
        else:
            self.prev_decode_only_middle = decode_only_middle
        return n_samples_out
