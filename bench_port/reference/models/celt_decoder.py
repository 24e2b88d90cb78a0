"""CELT decoder model: per-frame bitstream walk + synthesis orchestration.

Mirrors the reference frame decoder celt_decode_with_ec (reference
src/celt.cpp:2162-2446), decoder state (src/celt.h:150-171,
src/celt.cpp:1933-1961) and ctl semantics (src/celt.cpp:2448-2543).

Reference quirk handled via `compat_ref`: the reference hard-codes
end = effEBands = 21 (src/celt.cpp:2199), ignoring CELT_SET_END_BAND — which
mis-decodes non-fullband CELT-only streams. compat_ref=True reproduces that
bit-exactly (the parity target); compat_ref=False honors the end band like
upstream libopus/RFC 6716 (correct decoding).

This scalar model is the semantic reference; the batched pools
(models/stream_pool.py) are held to it.

The benchmark's frozen copy of the scalar CELT decoder (numpy and
Python ints). The pitch branch of a lost frame (float32 in the decoder
under test) is not part of this copy: decode_lost raises where it would
run, so the reference decodes lossless CELT and lossy hybrid streams
(whose conceal is always the noise branch).
"""
from __future__ import annotations

import numpy as np

from ..host.range_decoder import RangeDecoder
from ..ops.celt import bands, synthesis
from ..ops.celt.bands import BITRES, NB_EBANDS
from ..ops.celt.synthesis import (DECODE_BUFFER_SIZE, OVERLAP,
                                  SHORT_MDCT_SIZE, MAX_LM)
from ..ops.fixed_point import s16
from ..ops.tables.celt_tables import spread_icdf, tapset_icdf, trim_icdf

SPREAD_NORMAL = 2
DB_SHIFT = 10
MINUS_28DB = -(28 << DB_SHIFT)


class CELTDecoder:
    """State mirrors CELTDecoder_t (src/celt.h:150-171)."""

    def __init__(self, channels: int, compat_ref: bool = False):
        self.channels = channels            # CC
        self.stream_channels = channels     # C
        self.downsample = 1
        self.disable_inv = 1 if channels == 1 else 0
        self.start = 0
        self.end = NB_EBANDS
        self.compat_ref = compat_ref
        self.signalling = 1
        self.error = 0
        # flat state blobs
        self.decode_mem = [np.zeros(DECODE_BUFFER_SIZE + OVERLAP,
                                    dtype=np.int64) for _ in range(channels)]
        self.oldBandE = np.zeros(2 * NB_EBANDS, dtype=np.int64)
        self.oldLogE = np.zeros(2 * NB_EBANDS, dtype=np.int64)
        self.oldLogE2 = np.zeros(2 * NB_EBANDS, dtype=np.int64)
        self.backgroundLogE = np.zeros(2 * NB_EBANDS, dtype=np.int64)
        self.preemph_memD = [0, 0]
        self.rng = 0
        self.postfilter_period = 0
        self.postfilter_period_old = 0
        self.postfilter_gain = 0
        self.postfilter_gain_old = 0
        self.postfilter_tapset = 0
        self.postfilter_tapset_old = 0
        self.loss_count = 0
        self.skip_plc = 1
        # pitch-branch PLC carry (libopus keeps the fit in decoder
        # state across consecutive losses; decode_lost below)
        self.plc_pitch = 0
        self.plc_lpc = np.zeros((channels, 24), dtype=np.float32)
        self.reset_state()

    def reset_state(self) -> None:
        """OPUS_RESET_STATE (src/celt.cpp:2489-2507). NOTE: unlike upstream
        libopus, the reference does NOT clear decode_mem, oldBandE,
        backgroundLogE or preemph_memD here — only the fields below."""
        self.rng = 0
        self.error = 0
        self.postfilter_period = 0
        self.postfilter_period_old = 0
        self.postfilter_gain = 0
        self.postfilter_gain_old = 0
        self.postfilter_tapset = 0
        self.postfilter_tapset_old = 0
        self.oldLogE[:] = MINUS_28DB
        self.oldLogE2[:] = MINUS_28DB
        self.skip_plc = 1

    # ------------------------------------------------------------------
    def decode_with_ec(self, dec: RangeDecoder, pcm, frame_size: int,
                       defer_synthesis: bool = False):
        """celt_decode_with_ec (src/celt.cpp:2162). pcm: int16-range numpy
        array of size frame_size * CC (interleaved). Returns frame_size.

        defer_synthesis=True runs only the host symbol phase (everything
        through anti-collapse + the energy/postfilter state bookkeeping)
        and returns the dense-phase inputs for the batched device path
        (ops/celt/jax_synthesis.py) instead of producing PCM. The device
        then owns decode_mem and the deemphasis memory.
        """
        CC = self.channels
        C = self.stream_channels
        start = self.start
        end = NB_EBANDS if self.compat_ref else self.end
        frame_size *= self.downsample

        LM = 0
        while LM <= MAX_LM:
            if SHORT_MDCT_SIZE << LM == frame_size:
                break
            LM += 1
        if LM > MAX_LM:
            raise ValueError("bad frame size")
        M = 1 << LM

        if dec.storage > 1275 or dec.storage <= 1:
            raise ValueError("bad packet size")

        N = M * SHORT_MDCT_SIZE
        effEnd = min(end, NB_EBANDS)

        oldBandE = self.oldBandE
        oldLogE = self.oldLogE
        oldLogE2 = self.oldLogE2
        backgroundLogE = self.backgroundLogE

        self.skip_plc = 1 if self.loss_count != 0 else 0

        if C == 1:
            for i in range(NB_EBANDS):
                oldBandE[i] = max(int(oldBandE[i]),
                                  int(oldBandE[NB_EBANDS + i]))

        total_bits = dec.storage * 8
        tell = dec.tell()
        if tell >= total_bits:
            silence = 1
        elif tell == 1:
            silence = dec.dec_bit_logp(15)
        else:
            silence = 0
        if silence:
            tell = dec.storage * 8
            dec.nbits_total += tell - dec.tell()

        postfilter_gain = 0
        postfilter_pitch = 0
        postfilter_tapset = 0
        if start == 0 and tell + 16 <= total_bits:
            if dec.dec_bit_logp(1):
                octave = dec.dec_uint(6)
                postfilter_pitch = (16 << octave) \
                    + dec.dec_bits(4 + octave) - 1
                qg = dec.dec_bits(3)
                if dec.tell() + 2 <= total_bits:
                    postfilter_tapset = dec.dec_icdf(tapset_icdf, 2)
                postfilter_gain = 3072 * (qg + 1)  # QCONST16(.09375,15)
            tell = dec.tell()

        if LM > 0 and tell + 3 <= total_bits:
            isTransient = dec.dec_bit_logp(3)
            tell = dec.tell()
        else:
            isTransient = 0
        shortBlocks = M if isTransient else 0

        intra_ener = dec.dec_bit_logp(3) if tell + 3 <= total_bits else 0
        bands.unquant_coarse_energy(dec, start, end, oldBandE, intra_ener,
                                    C, LM)
        tf_res = [0] * NB_EBANDS
        bands.tf_decode(dec, start, end, isTransient, tf_res, LM)

        tell = dec.tell()
        spread_decision = SPREAD_NORMAL
        if tell + 4 <= total_bits:
            spread_decision = dec.dec_icdf(spread_icdf, 5)

        cap = bands.init_caps(LM, C)

        offsets = [0] * NB_EBANDS
        dynalloc_logp = 6
        total_bits <<= BITRES
        tell = dec.tell_frac()
        for i in range(start, end):
            width = C * (bands._EBANDS[i + 1] - bands._EBANDS[i]) << LM
            quanta = min(width << BITRES, max(6 << BITRES, width))
            dynalloc_loop_logp = dynalloc_logp
            boost = 0
            while tell + (dynalloc_loop_logp << BITRES) < total_bits \
                    and boost < cap[i]:
                flag = dec.dec_bit_logp(dynalloc_loop_logp)
                tell = dec.tell_frac()
                if not flag:
                    break
                boost += quanta
                total_bits -= quanta
                dynalloc_loop_logp = 1
            offsets[i] = boost
            if boost > 0:
                dynalloc_logp = max(2, dynalloc_logp - 1)

        alloc_trim = 5
        if tell + (6 << BITRES) <= total_bits:
            alloc_trim = dec.dec_icdf(trim_icdf, 7)

        bits = (dec.storage * 8 << BITRES) - dec.tell_frac() - 1
        anti_collapse_rsv = (1 << BITRES) if (
            isTransient and LM >= 2 and bits >= ((LM + 2) << BITRES)) else 0
        bits -= anti_collapse_rsv

        (codedBands, intensity, dual_stereo, balance, pulses, fine_quant,
         fine_priority) = bands.clt_compute_allocation(
            dec, start, end, offsets, cap, alloc_trim, bits, C, LM)

        bands.unquant_fine_energy(dec, start, end, oldBandE, fine_quant, C)

        if not defer_synthesis:
            for c in range(CC):
                dm = self.decode_mem[c]
                dm[:DECODE_BUFFER_SIZE - N + OVERLAP // 2] = \
                    dm[N:DECODE_BUFFER_SIZE + OVERLAP // 2].copy()

        collapse_masks = np.zeros(C * NB_EBANDS, dtype=np.int64)
        X = np.zeros(C * N, dtype=np.int64)

        self.rng = bands.quant_all_bands(
            dec, start, end, X, C, collapse_masks, pulses, shortBlocks,
            spread_decision, dual_stereo, intensity, tf_res,
            dec.storage * (8 << BITRES) - anti_collapse_rsv, balance, LM,
            codedBands, self.rng, self.disable_inv)

        anti_collapse_on = 0
        if anti_collapse_rsv > 0:
            anti_collapse_on = dec.dec_bits(1)

        bands.unquant_energy_finalise(dec, start, end, oldBandE, fine_quant,
                                      fine_priority,
                                      dec.storage * 8 - dec.tell(), C)

        if anti_collapse_on:
            synthesis.anti_collapse(X, collapse_masks, LM, C, N, start, end,
                                    oldBandE, oldLogE, oldLogE2, pulses,
                                    self.rng)

        if silence:
            oldBandE[:] = MINUS_28DB

        synth_inputs = None
        if defer_synthesis:
            self.postfilter_period = max(self.postfilter_period,
                                         synthesis.COMBFILTER_MINPERIOD)
            self.postfilter_period_old = max(self.postfilter_period_old,
                                             synthesis.COMBFILTER_MINPERIOD)
            # silence zeroes the synthesis via bound=0: emulate with X=0
            # and start=end=0 semantics handled by energies below
            synth_inputs = dict(
                X=X, bandE=oldBandE.copy(), start=start,
                end=0 if silence else effEnd,
                C=C, CC=CC, LM=LM, transient=bool(isTransient),
                silence=silence,
                comb1=(self.postfilter_period_old, self.postfilter_period,
                       self.postfilter_gain_old, self.postfilter_gain,
                       self.postfilter_tapset_old, self.postfilter_tapset),
                comb2=(self.postfilter_period, postfilter_pitch,
                       self.postfilter_gain, postfilter_gain,
                       self.postfilter_tapset, postfilter_tapset),
            )
        else:
            out_syn = [(self.decode_mem[c], DECODE_BUFFER_SIZE - N)
                       for c in range(CC)]
            synthesis.celt_synthesis(X, out_syn, oldBandE, start, effEnd,
                                     C, CC, isTransient, LM,
                                     self.downsample, silence)

            for c in range(CC):
                self.postfilter_period = max(
                    self.postfilter_period, synthesis.COMBFILTER_MINPERIOD)
                self.postfilter_period_old = max(
                    self.postfilter_period_old,
                    synthesis.COMBFILTER_MINPERIOD)
                arr, off = out_syn[c]
                synthesis.comb_filter(arr, off, off,
                                      self.postfilter_period_old,
                                      self.postfilter_period,
                                      SHORT_MDCT_SIZE,
                                      self.postfilter_gain_old,
                                      self.postfilter_gain,
                                      self.postfilter_tapset_old,
                                      self.postfilter_tapset)
                if LM != 0:
                    synthesis.comb_filter(arr, off + SHORT_MDCT_SIZE,
                                          off + SHORT_MDCT_SIZE,
                                          self.postfilter_period,
                                          postfilter_pitch,
                                          N - SHORT_MDCT_SIZE,
                                          self.postfilter_gain,
                                          postfilter_gain,
                                          self.postfilter_tapset,
                                          postfilter_tapset)
        self.postfilter_period_old = self.postfilter_period
        self.postfilter_gain_old = self.postfilter_gain
        self.postfilter_tapset_old = self.postfilter_tapset
        self.postfilter_period = postfilter_pitch
        self.postfilter_gain = postfilter_gain
        self.postfilter_tapset = postfilter_tapset
        if LM != 0:
            self.postfilter_period_old = self.postfilter_period
            self.postfilter_gain_old = self.postfilter_gain
            self.postfilter_tapset_old = self.postfilter_tapset

        if C == 1:
            oldBandE[NB_EBANDS:] = oldBandE[:NB_EBANDS]

        if not isTransient:
            oldLogE2[:] = oldLogE
            oldLogE[:] = oldBandE
            if self.loss_count < 10:
                max_background_increase = M * 1  # QCONST16(0.001,10)
            else:
                max_background_increase = 1 << DB_SHIFT
            np.minimum(backgroundLogE + max_background_increase, oldBandE,
                       out=backgroundLogE)
        else:
            np.minimum(oldLogE, oldBandE, out=oldLogE)
        for c in range(2):
            base = c * NB_EBANDS
            for i in range(start):
                oldBandE[base + i] = 0
                oldLogE[base + i] = MINUS_28DB
                oldLogE2[base + i] = MINUS_28DB
            for i in range(end, NB_EBANDS):
                oldBandE[base + i] = 0
                oldLogE[base + i] = MINUS_28DB
                oldLogE2[base + i] = MINUS_28DB
        self.rng = dec.rng

        if not defer_synthesis:
            synthesis.deemphasis(out_syn, pcm, N, CC, self.downsample,
                                 self.preemph_memD, 0)
        self.loss_count = 0
        if dec.tell() > 8 * dec.storage:
            raise ValueError("overran the bit budget")
        if dec.error:
            self.error = 1
        if defer_synthesis:
            return synth_inputs
        return frame_size // self.downsample

    # ------------------------------------------------------------------
    def decode_lost(self, pcm, frame_size: int) -> int:
        """celt_decode_lost — libopus 1.3.1 celt_decoder.c semantics
        (the reference DELETED this function: its celt_decode_with_ec
        requires a live bitstream, src/celt.cpp:2216, and loss plays
        silence). Restored here for RFC mode so the scalar decoder's
        loss behavior matches the batched pools.

        Two branches, like libopus:
          * noise-based (loss_count >= 5, hybrid/high-band start != 0,
            or skip_plc): decay oldBandE toward backgroundLogE, fill
            bands start..effEnd with renormalised LCG noise, run the
            NORMAL synthesis (no comb filter) — exact fixed-point via
            the scalar helpers, so the batched noise conceal (host-
            fabricated staging through the decode bucket) must match
            it bit-for-bit;
          * pitch-based (CELT-only, loss_count < 5): float32 in the
            decoder under test; this copy raises NotImplementedError.
        pcm: int16-range numpy buffer, frame_size*CC interleaved.
        Returns frame_size."""
        CC = self.channels
        N = frame_size * self.downsample
        LM = 0
        while LM <= MAX_LM:
            if SHORT_MDCT_SIZE << LM == N:
                break
            LM += 1
        if LM > MAX_LM:
            raise ValueError("bad frame size")
        start = self.start
        loss_count = self.loss_count
        noise_based = loss_count >= 5 or start != 0 or self.skip_plc \
            or N != 960
        if noise_based:
            # (N != 960 is a deviation: libopus runs the pitch branch
            # for any N; the batched kernel is built for the 20 ms
            # frame, so shorter frames noise-fill instead)
            from ..ops.celt.math import celt_lcg_rand
            from ..ops.celt.pvq import renormalise_vector
            from ..ops.tables.celt_tables import eband5ms
            end = NB_EBANDS if self.compat_ref else self.end
            effEnd = max(start, min(end, NB_EBANDS))
            decay = 1536 if loss_count == 0 else 512   # 1.5 / 0.5 dB
            for c in range(CC):
                base = c * NB_EBANDS
                for i in range(start, end):
                    self.oldBandE[base + i] = max(
                        int(self.backgroundLogE[base + i]),
                        int(self.oldBandE[base + i]) - decay)
            seed = self.rng
            C = CC
            X = np.zeros(C * N, dtype=np.int64)
            for c in range(C):
                for i in range(start, effEnd):
                    boffs = N * c + (int(eband5ms[i]) << LM)
                    blen = (int(eband5ms[i + 1])
                            - int(eband5ms[i])) << LM
                    for j in range(blen):
                        seed = celt_lcg_rand(seed)
                        v = seed if seed < (1 << 31) else seed - (1 << 32)
                        X[boffs + j] = v >> 20
                    renormalise_vector(X[boffs:boffs + blen], blen,
                                       32767)
            self.rng = seed
            for c in range(CC):
                dm = self.decode_mem[c]
                dm[:DECODE_BUFFER_SIZE - N + OVERLAP // 2] = \
                    dm[N:DECODE_BUFFER_SIZE + OVERLAP // 2].copy()
            out_syn = [(self.decode_mem[c], DECODE_BUFFER_SIZE - N)
                       for c in range(CC)]
            synthesis.celt_synthesis(X, out_syn, self.oldBandE, start,
                                     effEnd, C, CC, 0, LM,
                                     self.downsample, 0)
            synthesis.deemphasis(out_syn, pcm, N, CC, self.downsample,
                                 self.preemph_memD, 0)
        else:
            raise NotImplementedError(
                "the CELT pitch conceal is not part of the reference copy")
        self.loss_count = loss_count + 1
        return frame_size
