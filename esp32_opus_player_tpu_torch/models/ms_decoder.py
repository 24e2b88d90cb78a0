"""Multistream Opus decoder (mapping families 1 and 255).

A multistream packet is N self-delimited elementary Opus packets back to
back (coupled/stereo streams first, then mono streams); the channel
mapping table routes each decoded stream channel to output channels
(255 = muted). Mirrors the reference multistream machinery:

  * layout validation            — validate_layout,
    reference src/opus_decoder.cpp:688
  * channel routing              — get_left/right/mono_channel :700-727
  * init / sub-decoder layout    — opus_multistream_decoder_init :742
  * packet validation            — opus_multistream_packet_validate :803
  * decode walk + copy-out       — opus_multistream_decode_native :826,
    opus_copy_channel_out_short :917
  * ctl fan-out (final range XOR of streams, reset fan-out) :938-1035

The reference's opusfile layer drives ALL decode through this API
(src/opusfile.cpp:1238) but caps at 2 channels (OP_NCHANNELS_MAX,
src/opusfile.h:26); this implementation lifts the cap so family-1
surround files (e.g. 5.1) decode fully.

Parity note: the reference's hand-pruning replaced libopus's per-decoder
SILK/CELT state with file-scope singletons (s_channel_state,
src/silk.cpp:18-29), so its multistream walk makes every sub-decoder
share ONE codec state — N>1 streams decode to garbage on the device.
This implementation restores the per-stream state isolation of upstream
libopus (each OpusDecoder here owns its state), so the bit-exactness
golden for multichannel is libopus's multistream decoder, not the
reference binary.

The port's copy of esp32_opus_player_tpu/models/ms_decoder.py (numpy and
Python ints; nothing of the JAX package is imported).
"""
from __future__ import annotations

import numpy as np

from ..host import packet as pkt
from .opus_decoder import OpusDecoder


class OpusMSDecoder:
    def __init__(self, channels: int, streams: int, coupled_streams: int,
                 mapping, fs: int = 48000, compat_ref: bool = False,
                 device="cuda"):
        if not (1 <= channels <= 255) or streams < 1 \
                or coupled_streams < 0 or coupled_streams > streams \
                or streams > 255 - coupled_streams:
            raise ValueError("bad multistream layout args "
                             "(opus_multistream_decoder_init :749)")
        mapping = bytes(mapping)
        if len(mapping) < channels:
            raise ValueError("mapping table shorter than channel count")
        self.channels = channels
        self.streams = streams
        self.coupled_streams = coupled_streams
        self.mapping = mapping[:channels]
        self.fs = fs
        max_channel = streams + coupled_streams
        for m in self.mapping:
            if m >= max_channel and m != 255:
                raise ValueError(
                    f"mapping entry {m} out of range (validate_layout)")
        # coupled (stereo) sub-decoders first, then mono — the same
        # layout order as the reference's single allocation (:764-773)
        self.decoders = [OpusDecoder(2, fs, compat_ref=compat_ref,
                                     device=device)
                         for _ in range(coupled_streams)]
        self.decoders += [OpusDecoder(1, fs, compat_ref=compat_ref,
                                      device=device)
                          for _ in range(streams - coupled_streams)]
        self.last_packet_duration = 0

    # -- layout walks (get_left/right/mono_channel :700-727) ----------
    def _channels_of(self, stream_id: int):
        """Yield (output_channel, src_channel_within_stream) pairs."""
        if stream_id < self.coupled_streams:
            targets = {stream_id * 2: 0, stream_id * 2 + 1: 1}
        else:
            targets = {stream_id + self.coupled_streams: 0}
        for c, m in enumerate(self.mapping):
            if m in targets:
                yield c, targets[m]

    def packet_validate(self, data: bytes) -> int:
        """All elementary streams must carry the same duration
        (opus_multistream_packet_validate :803). Returns samples."""
        samples = None
        pos = 0
        for s in range(self.streams):
            if pos >= len(data):
                raise pkt.InvalidPacket("truncated multistream packet")
            sd = s != self.streams - 1
            parsed = pkt.parse_packet(data[pos:], self_delimited=sd)
            tmp = parsed.frame_size * len(parsed.frames)
            if samples is not None and tmp != samples:
                raise pkt.InvalidPacket(
                    "stream durations differ within packet")
            samples = tmp
            pos += parsed.packet_offset
        return samples

    def decode(self, data: bytes | None,
               frame_size: int | None = None) -> np.ndarray:
        """opus_multistream_decode (:931): returns (n, channels) int16.
        data=None/b'' runs loss concealment on every sub-decoder."""
        if data is None or len(data) == 0:
            outs = [d.decode(None, frame_size=frame_size)
                    for d in self.decoders]
        else:
            if len(data) < 2 * self.streams - 1:
                raise pkt.InvalidPacket(
                    "packet shorter than stream count allows (:851)")
            self.packet_validate(data)
            outs = []
            pos = 0
            for s, dec in enumerate(self.decoders):
                sd = s != self.streams - 1
                sub = data[pos:]
                parsed = pkt.parse_packet(sub, self_delimited=sd)
                outs.append(dec.decode(sub, self_delimited=sd))
                pos += parsed.packet_offset
        n = min(len(o) for o in outs)
        out = np.zeros((n, self.channels), dtype=np.int16)
        for s, dec_pcm in enumerate(outs):
            for chan, src in self._channels_of(s):
                out[:, chan] = dec_pcm[:n, src]
        # mapping 255 = muted channel (:906-910) — already zeros
        self.last_packet_duration = n
        return out

    # -- ctl surface (:938-1035) ---------------------------------------
    @property
    def final_range(self) -> int:
        """OPUS_GET_FINAL_RANGE: XOR over all sub-decoders (:957-975)."""
        r = 0
        for d in self.decoders:
            r ^= d.final_range
        return r & 0xFFFFFFFF

    def reset_state(self) -> None:
        for d in self.decoders:
            d.celt.reset_state()
            d.silk = None
            d.prev_mode = 0

    def decoder_state(self, stream_id: int) -> OpusDecoder:
        """OPUS_MULTISTREAM_GET_DECODER_STATE (:989-1006)."""
        if not 0 <= stream_id < self.streams:
            raise ValueError("bad stream id")
        return self.decoders[stream_id]

    def set_gain(self, gain_q8: int) -> None:
        """OPUS_SET_GAIN fan-out to every sub-decoder (:1008-1023)."""
        for d in self.decoders:
            d.decode_gain = gain_q8

    def set_phase_inversion_disabled(self, value: bool) -> None:
        for d in self.decoders:
            d.celt.disable_inv = 1 if value else 0
