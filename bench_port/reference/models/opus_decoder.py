"""Opus packet-level decoder: TOC dispatch, SILK/CELT/hybrid mixing.

Mirrors the reference packet layer (reference src/opus_decoder.cpp):
opus_decoder_init :82, opus_decode_frame :154, opus_decode_native :280,
decoder ctl semantics :361-454.

Reference quirks (followed when compat_ref=True, which is the bit-exactness
parity mode):
  * audiosize is hard-coded to 960 (20 ms) in opus_decode_frame
    (src/opus_decoder.cpp:161) — the reference crashes on other frame sizes.
    compat_ref=False decodes all RFC 6716 frame sizes.
  * hybrid redundancy payload is ignored (only the flag bit is read,
    src/opus_decoder.cpp:218-221).
  * CELT END_BAND is set but ignored downstream (see models/celt_decoder.py).

The benchmark's frozen copy of the scalar Opus decoder (numpy and
Python ints).
"""
from __future__ import annotations

import numpy as np

from ..host import packet as pkt
from ..host.packet import Bandwidth, Mode
from ..host.range_decoder import RangeDecoder
from ..ops.fixed_point import s16
from .celt_decoder import CELTDecoder


class OpusDecoder:
    def __init__(self, channels: int, fs: int = 48000,
                 compat_ref: bool = False):
        if channels not in (1, 2):
            raise ValueError("channels must be 1 or 2")
        if fs not in (8000, 12000, 16000, 24000, 48000):
            raise ValueError("fs must be 8/12/16/24/48 kHz "
                             "(opus_decoder_init, src/opus_decoder.cpp:85)")
        self.channels = channels
        self.fs = fs
        # API decode rate: CELT decimates on device (resampling_factor,
        # src/celt.cpp:817), SILK resamples its internal rate straight
        # to fs — the reference's multi-rate decoder API
        self._d48 = 48000 // fs
        self.compat_ref = compat_ref
        self.celt = CELTDecoder(channels, compat_ref=compat_ref)
        self.celt.downsample = self._d48
        self.silk = None  # created lazily (models/silk_decoder.py)
        self.mode = 0
        self.prev_mode = 0
        self.bandwidth = 0
        self.frame_size = fs // 400
        self.stream_channels = channels
        self.decode_gain = 0
        self.last_packet_duration = 0
        self.final_range = 0

    # ------------------------------------------------------------------
    def _get_silk(self):
        if self.silk is None:
            from .silk_decoder import SilkDecoder
            self.silk = SilkDecoder()
        return self.silk

    def decode_frame(self, data: bytes, pcm, samples_per_frame: int) -> int:
        """opus_decode_frame (src/opus_decoder.cpp:154). pcm: numpy int64
        interleaved buffer of size audiosize*channels. Returns audiosize."""
        mode = self.mode
        channels = self.stream_channels
        audiosize = (960 if self.compat_ref else samples_per_frame) \
            // self._d48

        dec = RangeDecoder(data)

        pcm_silk = None
        if mode != Mode.CELT_ONLY:
            silk = self._get_silk()
            if self.prev_mode == Mode.CELT_ONLY:
                silk.init_decoder()
            payload_ms = max(10, 1000 * audiosize // self.fs)
            if mode == Mode.SILK_ONLY:
                if self.bandwidth == Bandwidth.NARROWBAND:
                    internal_rate = 8000
                elif self.bandwidth == Bandwidth.MEDIUMBAND:
                    internal_rate = 12000
                else:
                    internal_rate = 16000
            else:
                internal_rate = 16000
            pcm_silk = np.zeros(audiosize * self.channels, dtype=np.int64)
            silk.set_raw_params(channels, self.channels, payload_ms,
                                internal_rate, self.fs)
            decoded = 0
            while decoded < audiosize:
                n = silk.decode(dec, lost=0, first_frame=decoded == 0,
                                pcm=pcm_silk[decoded * self.channels:])
                decoded += n

        start_band = 0
        if mode != Mode.CELT_ONLY and \
                dec.tell() + 17 + 20 * (mode == Mode.HYBRID) <= 8 * len(data):
            if mode == Mode.HYBRID:
                dec.dec_bit_logp(12)  # redundancy flag, payload ignored
        if mode != Mode.CELT_ONLY:
            start_band = 17

        endband = 21
        if self.bandwidth:
            if self.bandwidth == Bandwidth.NARROWBAND:
                endband = 13
            elif self.bandwidth in (Bandwidth.MEDIUMBAND,
                                    Bandwidth.WIDEBAND):
                endband = 17
            elif self.bandwidth == Bandwidth.SUPERWIDEBAND:
                endband = 19
            self.celt.end = endband
            self.celt.stream_channels = channels
        self.celt.start = start_band

        celt_ret = 0
        if mode != Mode.SILK_ONLY:
            if mode != self.prev_mode and self.prev_mode > 0:
                self.celt.reset_state()
            celt_ret = self.celt.decode_with_ec(dec, pcm, audiosize)
        else:
            pcm[:audiosize * self.channels] = 0
            # hybrid -> SILK: decode a silence frame for the CELT fade-out
            if self.prev_mode == Mode.HYBRID:
                self.celt.start = 0
                self.celt.decode_with_ec(dec, pcm, 120 // self._d48)

        if mode != Mode.CELT_ONLY:
            for i in range(audiosize * self.channels):
                pcm[i] = s16(max(-32768, min(
                    32767, int(pcm[i]) + int(pcm_silk[i]))))

        self.prev_mode = mode
        self.final_range = dec.rng
        return audiosize

    def decode(self, data: bytes | None, pcm_out=None,
               frame_size: int | None = None, decode_fec: bool = False,
               self_delimited: bool = False):
        """opus_decode_native (src/opus_decoder.cpp:280) — returns int16
        numpy array (n, channels). data=None triggers PLC; decode_fec=True
        recovers the previous (lost) frame from this packet's in-band FEC
        (SILK LBRR, silk_Decode lostFlag=2 — reachable in the reference's
        silk layer at src/silk.cpp:1682 but never wired to its app).
        self_delimited: parse with the self-delimiting framing used for
        all but the last elementary stream of a multistream packet."""
        if data is None or len(data) == 0:
            return self._decode_plc(frame_size)
        if decode_fec:
            return self._decode_fec(data, frame_size)
        parsed = pkt.parse_packet(data, self_delimited=self_delimited)
        spf = parsed.frame_size
        count = len(parsed.frames)
        self.mode = parsed.mode
        self.bandwidth = parsed.bandwidth
        self.frame_size = spf // self._d48      # in Fs samples
        self.stream_channels = parsed.stream_channels

        audiosize = (960 if self.compat_ref else spf) // self._d48
        out = np.zeros(count * audiosize * self.channels, dtype=np.int64)
        nb = 0
        for f in parsed.frames:
            ret = self.decode_frame(f, out[nb * self.channels:], spf)
            nb += ret
        self.last_packet_duration = nb
        pcm = np.array(out[:nb * self.channels], dtype=np.int16)
        return pcm.reshape(nb, self.channels)

    def _decode_fec(self, data: bytes, frame_size: int | None):
        """Recover one lost frame from this packet's SILK LBRR data.
        Falls back to PLC when the packet carries no usable FEC
        (CELT-only mode, or LBRR flag clear)."""
        parsed = pkt.parse_packet(data)
        mode = parsed.mode
        spf = parsed.frame_size
        if mode == Mode.CELT_ONLY:
            return self._decode_plc(frame_size if frame_size is not None
                                    else spf // self._d48)
        # configure SILK like a normal decode of this packet would
        self.mode = mode
        self.bandwidth = parsed.bandwidth
        self.stream_channels = parsed.stream_channels
        silk = self._get_silk()
        if self.prev_mode == Mode.CELT_ONLY:
            silk.init_decoder()
        payload_ms = max(10, 1000 * spf // 48000)
        if frame_size is None:
            frame_size = spf // self._d48
        if mode == Mode.SILK_ONLY:
            if self.bandwidth == Bandwidth.NARROWBAND:
                internal_rate = 8000
            elif self.bandwidth == Bandwidth.MEDIUMBAND:
                internal_rate = 12000
            else:
                internal_rate = 16000
        else:
            internal_rate = 16000
        silk.set_raw_params(self.stream_channels, self.channels, payload_ms,
                            internal_rate, self.fs)
        dec = RangeDecoder(parsed.frames[0])
        out = np.zeros(frame_size * self.channels, dtype=np.int64)
        decoded = 0
        first = True
        while decoded < frame_size:
            n = silk.decode(dec, lost=2, first_frame=first,
                            pcm=out[decoded * self.channels:])
            first = False
            decoded += n
        self.prev_mode = mode
        self.last_packet_duration = frame_size
        self.final_range = dec.rng
        return np.array(out[:frame_size * self.channels],
                        dtype=np.int16).reshape(frame_size, self.channels)

    def _decode_plc(self, frame_size: int):
        """Packet-loss path (src/opus_decoder.cpp:294-307, data==NULL).

        compat_ref: the reference's opus_decode_frame has NO lost-packet
        branch (the upstream PLC dispatch was pruned), so a NULL decode
        runs the normal frame path over an EMPTY bitstream: the range
        decoder yields the all-zeros symbol sequence. Works for SILK mode;
        CELT/hybrid error out in the reference (storage<=1 check,
        src/celt.cpp:2226) — we produce silence instead of failing.

        RFC mode (libopus semantics): SILK PLC (silk_Decode lostFlag=1:
        conceal via attenuated LTP/LPC extrapolation, src/silk.cpp:2973)
        for SILK/hybrid; celt_decode_lost (CELTDecoder.decode_lost —
        pitch-repeat for CELT-only short losses, noise-fill for long
        bursts and the hybrid high band) for CELT/hybrid; a lost hybrid
        frame SAT16-sums both conceals exactly like a decoded hybrid
        frame mixes its layers (src/opus_decoder.cpp:272 anchor for the
        mix; the reference's NULL path itself has no CELT branch — its
        celt_decode_lost was deleted).
        """
        if frame_size is None:
            frame_size = (960 // self._d48 if self.compat_ref
                          else self.frame_size)
        out = np.zeros(frame_size * self.channels, dtype=np.int64)
        if self.compat_ref:
            if self.mode != Mode.CELT_ONLY:
                nb = 0
                while nb < frame_size:
                    ret = self.decode_frame(b"", out[nb * self.channels:],
                                            frame_size - nb)
                    nb += ret
            self.last_packet_duration = frame_size
            return np.array(out[:frame_size * self.channels],
                            dtype=np.int16).reshape(frame_size,
                                                    self.channels)
        if self.prev_mode in (Mode.SILK_ONLY, Mode.HYBRID) and self.silk:
            decoded = 0
            while decoded < frame_size:
                n = self.silk.decode(None, lost=1, first_frame=decoded == 0,
                                     pcm=out[decoded * self.channels:])
                decoded += n
        if self.prev_mode in (Mode.CELT_ONLY, Mode.HYBRID):
            celt_pcm = np.zeros(frame_size * self.channels,
                                dtype=np.int64)
            nb = 0
            while nb < frame_size:
                # conceal in 20 ms chunks like opus_decode_native's
                # data==NULL frame loop (src/opus_decoder.cpp:294)
                n = min(frame_size - nb, 960 // self._d48)
                self.celt.decode_lost(
                    celt_pcm[nb * self.channels:], n)
                nb += n
            if self.prev_mode == Mode.HYBRID:
                for i in range(frame_size * self.channels):
                    out[i] = s16(max(-32768, min(
                        32767, int(out[i]) + int(celt_pcm[i]))))
            else:
                out = celt_pcm
        self.last_packet_duration = frame_size
        return np.array(out[:frame_size * self.channels],
                        dtype=np.int16).reshape(frame_size, self.channels)
