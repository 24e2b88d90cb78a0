"""Public decode API: file/stream -> PCM.

The framework equivalent of the reference's public surface
(opus_init_decoder + op_read_stereo, reference src/opusfile.cpp:784,1293):
open an Ogg/Opus file or byte stream and pull PCM frames, with pre-skip,
end-trim, gain and hole handling applied. Adds what the reference lacks:
WAV export, non-20ms frames (RFC mode), and a streaming reader.

The port's copy of esp32_opus_player_tpu/api.py (numpy and Python ints;
nothing of the JAX package is imported).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from .host import opusfile
from .host.packet import get_nb_samples
from .models.opus_decoder import OpusDecoder
from .utils.device import resolve_device

OP_HOLE_DISCARD_MS = 80


@dataclass
class DecoderConfig:
    """Typed replacement for the reference's three config layers
    (SURVEY.md §5: ctl varargs + silk_DecControlStruct + compile-time)."""
    channels: int = 2
    sample_rate: int = 48000      # API decode rate (8/12/16/24/48 kHz,
    #                               opus_decoder_init src/opus_decoder.cpp:85)
    gain_q8: int = 0              # OPUS_SET_GAIN equivalent (Q8 dB)
    phase_inversion_disabled: bool = False
    compat_ref: bool = False      # bit-exact reference behavior
    apply_header_gain: bool = True
    # where a lost CELT frame's pitch conceal runs (the scalar route's one
    # device call): "cuda" raises without a card; "cpu" for its plain
    # version
    device: str = "cuda"


class OpusFile:
    """Pull-based file decoder (op_read_stereo equivalent)."""

    def __init__(self, path_or_bytes, config: DecoderConfig | None = None):
        if isinstance(path_or_bytes, (bytes, bytearray)):
            self.stream = opusfile.parse_stream(bytes(path_or_bytes))
        else:
            self.stream = opusfile.open_file(path_or_bytes)
        head = self.stream.head
        self._multistream = head.stream_count > 1 or head.channel_count > 2
        self.config = config or DecoderConfig(
            channels=head.channel_count if self._multistream
            else min(head.channel_count, 2))
        self.decoder = self._make_decoder()
        self._job_idx = 0
        self._cur_link = 0
        self._hole_discard = 0
        self._buffer = np.zeros((0, self.config.channels), dtype=np.int16)
        self._gain_q8 = (head.output_gain if self.config.apply_header_gain
                         else 0) + self.config.gain_q8
        # bitrate accumulators (bytes_tracked/samples_tracked,
        # src/opusfile.h:87-88, updated :550,875,1249-1270)
        self.bytes_tracked = 0
        self.samples_tracked = 0

    def _make_decoder(self, link: int = 0):
        """Multichannel (family-1 surround / multi-stream) files decode
        through OpusMSDecoder, like the reference's opusfile layer always
        does (src/opusfile.cpp:1238) — but without its 2-channel cap.
        link: chain link index (each link is an independent stream, so a
        fresh decoder per link — op_make_decode_ready, :671)."""
        heads = self.stream.link_heads or [self.stream.head]
        head = heads[min(link, len(heads) - 1)]
        if self._multistream:
            from .models.ms_decoder import OpusMSDecoder
            return OpusMSDecoder(head.channel_count, head.stream_count,
                                 head.coupled_count, head.mapping,
                                 fs=self.config.sample_rate,
                                 compat_ref=self.config.compat_ref,
                                 device=self.config.device)
        dec = OpusDecoder(self.config.channels,
                          fs=self.config.sample_rate,
                          compat_ref=self.config.compat_ref,
                          device=self.config.device)
        if self.config.phase_inversion_disabled:
            dec.celt.disable_inv = 1
        return dec

    @property
    def channel_count(self) -> int:
        return self.stream.head.channel_count

    @property
    def pre_skip(self) -> int:
        return self.stream.head.pre_skip

    def _apply_gain(self, pcm: np.ndarray) -> np.ndarray:
        """OPUS_SET_GAIN semantics (Q8 dB scale, like src/opus_decoder.cpp
        decode_gain handling)."""
        if self._gain_q8 == 0:
            return pcm
        from .ops.silk.decode import log2lin
        from .ops.silk import macros as m
        gain = log2lin(m.SMULWB(6488, self._gain_q8) + (16 << 7))
        x = pcm.astype(np.int64)
        out = np.clip((x * gain) >> 16, -32768, 32767)
        return out.astype(np.int16)

    def _decode_next_job(self):
        while self._job_idx < len(self.stream.jobs):
            job = self.stream.jobs[self._job_idx]
            self._job_idx += 1
            if job.link != self._cur_link:
                # chain boundary: new link = independent stream — fresh
                # decoder, new header gain (src/opusfile.cpp:835-1133)
                self._cur_link = job.link
                self.decoder = self._make_decoder(job.link)
                heads = self.stream.link_heads
                self._gain_q8 = (heads[job.link].output_gain
                                 if self.config.apply_header_gain else 0) \
                    + self.config.gain_q8
                self._hole_discard = 0
            if job.hole_before:
                # hole policy: decode continues; discard 80 ms to
                # re-converge (src/opusfile.cpp:1022-1046)
                self._hole_discard = (OP_HOLE_DISCARD_MS
                                      * self.config.sample_rate // 1000)
            pcm = self.decoder.decode(job.data)
            self.bytes_tracked += len(job.data)
            self.samples_tracked += len(pcm)
            d = 48000 // self.config.sample_rate
            # pre-skip/end-trim are 48 kHz granule quantities; at lower
            # API rates keep the decimated samples whose 48k index
            # survives the trim (same mapping as StreamPool._trim)
            lo = -(-job.discard_front // d)
            hi = -(-(len(pcm) * d - job.trim_end) // d)
            hole = min(self._hole_discard, max(0, len(pcm) - lo))
            self._hole_discard -= hole
            lo += hole
            if lo >= hi:
                continue
            return self._apply_gain(pcm[lo:hi])
        return None

    # -- ctl read-outs (opus_decoder_ctl GETs, src/opus_decoder.cpp:361-454,
    # and the opusfile bitrate trackers) --------------------------------
    def bitrate_instant(self) -> int:
        """Average bitrate (bits/s) of the data decoded since the last
        call, then reset — op_bitrate_instant semantics (the reference
        keeps the accumulators at src/opusfile.h:87-88)."""
        if self.samples_tracked == 0:
            return 0
        bps = (self.bytes_tracked * 8 * self.config.sample_rate
               // self.samples_tracked)
        self.bytes_tracked = 0
        self.samples_tracked = 0
        return bps

    @property
    def final_range(self) -> int:
        """OPUS_GET_FINAL_RANGE (:375) — the conformance probe."""
        return self.decoder.final_range

    @property
    def bandwidth(self) -> int:
        """OPUS_GET_BANDWIDTH (:367): last packet's audio bandwidth."""
        d = self.decoder
        if hasattr(d, "decoders"):   # multistream: first stream (:945)
            d = d.decoders[0]
        return int(d.bandwidth)

    @property
    def last_packet_duration(self) -> int:
        """OPUS_GET_LAST_PACKET_DURATION (:430)."""
        return self.decoder.last_packet_duration

    @property
    def pitch(self) -> int:
        """OPUS_GET_PITCH (:396): SILK prevPitchLag, or the CELT
        postfilter period for CELT-only streams."""
        from .host.packet import Mode
        d = self.decoder
        if hasattr(d, "decoders"):
            d = d.decoders[0]
        if d.prev_mode == Mode.CELT_ONLY:
            return int(d.celt.postfilter_period)
        return int(d.silk.prevPitchLag) if d.silk is not None else 0

    def read(self, n_samples: int = 2048) -> np.ndarray:
        """Return up to n_samples frames of PCM, (n, channels) int16.
        Empty array = end of stream."""
        while len(self._buffer) < n_samples:
            nxt = self._decode_next_job()
            if nxt is None:
                break
            self._buffer = np.concatenate([self._buffer, nxt])
        out = self._buffer[:n_samples]
        self._buffer = self._buffer[n_samples:]
        self._pos = getattr(self, "_pos", 0) + len(out)
        return out

    # -- seeking (op_pcm_seek equivalent; the reference ships with
    # seekable=0, so this is a TPU-framework addition) ------------------
    def _cum_offsets(self):
        if not hasattr(self, "_cum"):
            offs = [0]
            for job in self.stream.jobs:
                offs.append(offs[-1] + job.keep)
            self._cum = offs
        return self._cum

    @property
    def duration(self) -> int:
        """Total output samples at 48 kHz (after pre-skip/end-trim)."""
        return self._cum_offsets()[-1]

    def tell(self) -> int:
        """Current PCM position in samples (like op_pcm_tell)."""
        return getattr(self, "_pos", 0)

    def seek(self, pcm_offset: int) -> None:
        """Reposition to an absolute PCM offset (op_pcm_seek semantics):
        the decoder restarts 80 ms before the target and the pre-roll is
        discarded, so decode state has re-converged by the target sample.
        Sample-accurate positioning; the audio near the seek point is the
        usual reconverged approximation every Opus seek produces."""
        import bisect
        cum = self._cum_offsets()
        pcm_offset = max(0, min(int(pcm_offset), cum[-1]))
        pre_target = max(0, pcm_offset - OP_HOLE_DISCARD_MS * 48)
        j0 = bisect.bisect_right(cum, pre_target) - 1
        self._cur_link = self.stream.jobs[j0].link
        self.decoder = self._make_decoder(self._cur_link)
        self._job_idx = j0
        self._hole_discard = 0
        self._buffer = np.zeros((0, self.config.channels), dtype=np.int16)
        skip = pcm_offset - cum[j0]
        while skip > 0:
            nxt = self._decode_next_job()
            if nxt is None:
                break
            if len(nxt) <= skip:
                skip -= len(nxt)
                continue
            self._buffer = nxt[skip:]
            skip = 0
        self._pos = pcm_offset

    def read_stereo(self, n_samples: int = 2048) -> np.ndarray:
        """op_read_stereo semantics (src/opusfile.cpp:1293): mono is
        duplicated into both channels."""
        pcm = self.read(n_samples)
        if pcm.shape[1] == 1:
            pcm = np.repeat(pcm, 2, axis=1)
        return pcm

    def read_all(self) -> np.ndarray:
        chunks = []
        while True:
            c = self.read(48000)
            if len(c) == 0:
                break
            chunks.append(c)
        if not chunks:
            return np.zeros((0, self.config.channels), dtype=np.int16)
        return np.concatenate(chunks)


class StreamingOpusFile:
    """Push-based incremental reader: feed() raw Ogg bytes as they arrive
    (network / SD-card chunks, like the reference's SD_read pull loop,
    reference src/main.cpp), read() decoded PCM as it becomes available.
    Pre-skip, holes, gain and the EOS end-trim are applied on the fly —
    the end-trim is computed when the EOS page arrives, before its
    packets are decoded (the whole file never needs to be in memory)."""

    def __init__(self, config: DecoderConfig | None = None):
        from .host import ogg
        resolve_device((config or DecoderConfig()).device,
                       "StreamingOpusFile")
        self._sync = ogg.OggSync()
        self._stream = None
        self.head = None
        self._tags_done = False
        self._cfg = config
        self.decoder = None
        self._preskip_left = 0
        self._pcm_start = None
        self._cum_dur = 0
        self._trim_left = 0
        self._buffer = None
        self._gain_q8 = 0
        self._hole_discard = 0
        self._link_done = False
        self.eos = False

    def feed(self, data: bytes) -> None:
        self._sync.write(data)
        self._drain()

    def close(self) -> None:
        """Signal end of input (flushes a final unterminated page)."""
        self._sync.set_eof()
        self._drain()
        self.eos = True

    def _init_decoder(self):
        head = self.head
        self.config = self._cfg or DecoderConfig(
            channels=min(head.channel_count, 2))
        self.decoder = OpusDecoder(self.config.channels,
                                   compat_ref=self.config.compat_ref,
                                   device=self.config.device)
        if self.config.phase_inversion_disabled:
            self.decoder.celt.disable_inv = 1
        self._preskip_left = head.pre_skip
        self._gain_q8 = (head.output_gain
                         if self.config.apply_header_gain else 0) \
            + (self._cfg.gain_q8 if self._cfg else 0)
        self._buffer = np.zeros((0, self.config.channels), dtype=np.int16)

    def _drain(self) -> None:
        from .host import ogg, packet as pkt2
        while True:
            page = self._sync.pageout()
            if page is None:
                return
            if self.head is None or (self._link_done and page.bos
                                     and page.body[:8] == b"OpusHead"):
                if page.bos and page.body[:8] == b"OpusHead":
                    # new (or first) chain link: fresh decoder + per-link
                    # pre-skip/granule tracking (op_fetch_and_process_page
                    # chain boundaries, src/opusfile.cpp:835-1133)
                    self._stream = ogg.OggStream(serialno=page.serialno)
                    for p in self._stream.pagein(page):
                        self.head = opusfile.OpusHead.parse(p.data)
                    buf = self._buffer
                    self._init_decoder()
                    if buf is not None and len(buf):
                        self._buffer = buf   # keep undrained PCM
                    self._tags_done = False
                    self._pcm_start = None
                    self._cum_dur = 0
                    self._trim_left = 0
                    self._hole_discard = 0
                    self._link_done = False
                    self.eos = False
                continue
            if page.serialno != self._stream.serialno:
                continue
            packets = self._stream.pagein(page)
            if not self._tags_done and packets:
                if packets[0].data[:8] == b"OpusTags":
                    packets = packets[1:]
                self._tags_done = True
            # EOS page: end-trim for its packets from the final granulepos
            if page.eos and page.granulepos >= 0:
                page_dur = 0
                durs = []
                for p in packets:
                    try:
                        d = pkt2.get_nb_samples(p.data)
                    except pkt2.InvalidPacket:
                        d = 0
                    durs.append(d)
                    page_dur += d
                if self._pcm_start is None:
                    self._pcm_start = max(
                        page.granulepos - self._cum_dur - page_dur, 0)
                overshoot = (self._pcm_start + self._cum_dur + page_dur
                             - page.granulepos)
                self._trim_left = max(0, overshoot)
            outs = [self._decode_packet(p) for p in packets]
            outs = [o for o in outs if o is not None and len(o)]
            if page.eos and self._trim_left > 0:
                # end-trim comes off the TAIL of the stream
                tail = (np.concatenate(outs) if outs else
                        np.zeros((0, self.config.channels), np.int16))
                trim = self._trim_left
                if trim >= len(tail):
                    extra = trim - len(tail)
                    outs = []
                    if extra and self._buffer is not None:
                        keep = max(0, len(self._buffer) - extra)
                        self._buffer = self._buffer[:keep]
                else:
                    outs = [tail[:len(tail) - trim]]
                self._trim_left = 0
            for o in outs:
                self._buffer = np.concatenate([self._buffer, o])
            if self._pcm_start is None and page.granulepos >= 0:
                self._pcm_start = max(page.granulepos - self._cum_dur, 0)
            if page.eos:
                self.eos = True
                self._link_done = True

    def _decode_packet(self, p):
        from .host import packet as pkt2
        try:
            dur = pkt2.get_nb_samples(p.data)
        except pkt2.InvalidPacket:
            return None
        if p.hole_before:
            self._hole_discard = OP_HOLE_DISCARD_MS * 48
        pcm = self.decoder.decode(p.data)
        self._cum_dur += dur
        lo = min(self._preskip_left, len(pcm))
        self._preskip_left -= lo
        lo2 = min(self._hole_discard, len(pcm) - lo)
        self._hole_discard -= lo2
        if len(pcm) <= lo + lo2:
            return None
        out = pcm[lo + lo2:]
        if self._gain_q8:
            from .ops.silk.decode import log2lin
            from .ops.silk import macros as m
            gain = log2lin(m.SMULWB(6488, self._gain_q8) + (16 << 7))
            out = np.clip((out.astype(np.int64) * gain) >> 16,
                          -32768, 32767).astype(np.int16)
        return out

    def read(self, n_samples: int = 2048) -> np.ndarray:
        """PCM decoded so far (up to n_samples frames); empty when more
        input is needed (feed more bytes, or close() at true EOF)."""
        if self._buffer is None:
            return np.zeros((0, 2), dtype=np.int16)
        out = self._buffer[:n_samples]
        self._buffer = self._buffer[n_samples:]
        return out


def decode_file(path, config: DecoderConfig | None = None) -> np.ndarray:
    """One-shot: Ogg/Opus file -> (n, channels) int16 PCM at
    config.sample_rate (48 kHz default)."""
    return OpusFile(path, config).read_all()


def write_wav(path, pcm: np.ndarray, rate: int = 48000) -> None:
    """Minimal WAV writer (s16le)."""
    pcm = np.ascontiguousarray(pcm, dtype="<i2")
    n, ch = pcm.shape
    data = pcm.tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, ch, rate,
                                      rate * ch * 2, ch * 2, 16))
        f.write(b"data" + struct.pack("<I", len(data)) + data)


def decode_to_wav(in_path, out_path,
                  config: DecoderConfig | None = None) -> int:
    """BASELINE config 1: Ogg/Opus file -> PCM WAV (at the config's
    sample_rate). Returns sample count."""
    pcm = decode_file(in_path, config)
    write_wav(out_path, pcm,
              rate=(config.sample_rate if config else 48000))
    return len(pcm)
