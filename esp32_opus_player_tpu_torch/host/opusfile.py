"""Ogg/Opus stream reader — header parse, timestamping, pre-skip/end-trim.

Host-side equivalent of the reference stream reader (reference
src/opusfile.cpp): OpusHead parsing (:1333-1385), BOS stream selection
(:106-259), initial PCM offset from the first audio page's granulepos
(:486-633), steady-state packet collection with hole handling and end-trim
(:835-1133), and the pre-skip/end-trim bookkeeping of op_read_native
(:1171-1291).

Instead of a pull-based singleton, this emits an explicit sequence of
DecodeJobs (packet bytes + how many output samples to keep), which the decode
engines consume — the boundary where batching across streams happens.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field

from . import ogg
from . import packet as pkt

OP_HOLE_DISCARD_MS = 80  # re-convergence discard after a hole (:1022-1046)

INT64_MAX = (1 << 63) - 1
INT64_MIN = -(1 << 63)


class GranposError(ValueError):
    """OP_EINVAL from the granule-position math (result out of range)."""


def granpos_add(src_gp: int, delta: int) -> int:
    """Overflow-safe granule position + delta with the 64-bit WRAPPING
    semantics of op_granpos_add (reference src/opusfile.cpp:299-331):
    positive granule positions wrap through INT64_MIN and keep counting;
    -1 must never be produced (it means 'invalid'). Raises GranposError
    where the reference returns OP_EINVAL."""
    assert src_gp != -1
    if delta > 0:
        if src_gp < 0 and src_gp >= -1 - delta:
            raise GranposError("granpos add would hit -1")
        if src_gp > INT64_MAX - delta:
            delta -= (INT64_MAX - src_gp) + 1
            src_gp = INT64_MIN
    elif delta < 0:
        if src_gp >= 0 and src_gp < -delta:
            raise GranposError("granpos add would underflow past 0")
        if src_gp < INT64_MIN - delta:
            delta += (src_gp - INT64_MIN) + 1
            src_gp = INT64_MAX
    return src_gp + delta


def granpos_diff(gp_a: int, gp_b: int) -> int:
    """Wrap-aware gp_a - gp_b (op_granpos_diff, :345-384)."""
    assert gp_a != -1 and gp_b != -1
    a_neg, b_neg = gp_a < 0, gp_b < 0
    if a_neg ^ b_neg:
        if a_neg:
            da = (INT64_MIN - gp_a) - 1
            db = INT64_MAX - gp_b
            if INT64_MAX + da < db:
                raise GranposError("granpos diff overflow")
            return db - da
        da = gp_a + INT64_MIN
        db = INT64_MIN - gp_b
        if da < INT64_MIN - db:
            raise GranposError("granpos diff underflow")
        return da + db
    return gp_a - gp_b


def granpos_cmp(gp_a: int, gp_b: int) -> int:
    """Wrap-aware ordering (op_granpos_cmp, :386-401): negative granule
    positions are wrapped continuations ABOVE the positive range."""
    assert gp_a != -1 and gp_b != -1
    if gp_a < 0:
        if gp_b >= 0:
            return 1
    elif gp_b < 0:
        return -1
    return (gp_a > gp_b) - (gp_b > gp_a)


class NotOpusError(ValueError):
    pass


class BadHeaderError(ValueError):
    pass


@dataclass
class OpusHead:
    """ID header (RFC 7845 §5.1; reference OpusHead_t src/opusfile.h:42-52)."""
    version: int
    channel_count: int
    pre_skip: int
    input_sample_rate: int
    output_gain: int          # Q8 dB
    mapping_family: int
    stream_count: int = 1
    coupled_count: int = 0
    mapping: bytes = b"\x00\x01"

    @classmethod
    def parse(cls, data: bytes) -> "OpusHead":
        if len(data) < 8 or data[:8] != b"OpusHead":
            raise NotOpusError("missing OpusHead magic")
        if len(data) < 19:
            raise BadHeaderError("OpusHead too short")
        version, channels, pre_skip, rate, gain, family = struct.unpack_from(
            "<BBHIhB", data, 8)
        if (version & 0xF0) != 0:  # accept versions 0..15 (:1340)
            raise BadHeaderError(f"unsupported version {version}")
        if channels == 0:
            raise BadHeaderError("zero channels")
        if family == 0:
            if channels > 2:
                raise BadHeaderError("family 0 allows at most 2 channels")
            streams, coupled = 1, channels - 1
            mapping = bytes([0, 1])
        elif family == 1:
            if channels > 8:
                raise BadHeaderError("family 1 allows at most 8 channels")
            if len(data) < 21 + channels:
                raise BadHeaderError("truncated mapping table")
            streams, coupled = data[19], data[20]
            if streams < 1 or coupled > streams or streams + coupled > 255:
                raise BadHeaderError("bad stream counts")
            mapping = data[21:21 + channels]
            for m in mapping:
                if m != 255 and m >= streams + coupled:
                    raise BadHeaderError("bad channel mapping")
        else:
            raise BadHeaderError(f"unsupported mapping family {family}")
        return cls(version, channels, pre_skip, rate, gain, family,
                   streams, coupled, mapping)


@dataclass
class DecodeJob:
    """One packet to decode, with output bookkeeping applied afterwards."""
    data: bytes | None        # None = lost packet (PLC)
    duration: int             # samples at 48 kHz the decoder will produce
    discard_front: int = 0    # pre-skip / hole re-convergence discard
    trim_end: int = 0         # end-trim from the final granulepos
    granulepos: int = -1
    hole_before: bool = False
    link: int = 0             # chain link index (op_fetch_and_process_page
    #                           chain boundaries, src/opusfile.cpp:835-1133)

    @property
    def keep(self) -> int:
        return max(self.duration - self.discard_front - self.trim_end, 0)


@dataclass
class OggOpusStream:
    """Parsed Ogg/Opus stream (one or more chained links): headers +
    timestamped decode jobs. jobs carry their link index; decoders must
    reset at link boundaries (each link is an independent stream)."""
    head: OpusHead
    tags_vendor: str
    jobs: list[DecodeJob]
    pcm_start: int = 0
    pcm_end: int = -1
    bytes_skipped: int = 0
    link_heads: list = field(default_factory=list)

    @property
    def n_links(self) -> int:
        return max(len(self.link_heads), 1)

    @property
    def total_samples(self) -> int:
        return sum(j.keep for j in self.jobs)


def _collect_packets(data: bytes):
    """Demux all pages into LINKS; within each link, select the first
    Opus BOS stream like op_fetch_headers_impl (:106-259). A new link
    begins at a BOS OpusHead page after the current link\'s EOS
    (chain handling of op_fetch_and_process_page, :835-1133)."""
    sync = ogg.OggSync()
    sync.write(data)
    sync.set_eof()
    links: list[tuple[OpusHead, list]] = []
    opus_stream: ogg.OggStream | None = None
    head: OpusHead | None = None
    link_done = False
    while True:
        page = sync.pageout()
        if page is None:
            break
        if head is None or (link_done and page.bos
                            and page.body[:8] == b"OpusHead"):
            if head is None and not page.bos and opus_stream is None:
                raise NotOpusError("no BOS page found")
            if page.bos and page.body[:8] == b"OpusHead" \
                    and (opus_stream is None or link_done):
                opus_stream = ogg.OggStream(serialno=page.serialno)
                for p in opus_stream.pagein(page):
                    head = OpusHead.parse(p.data)
                links.append((head, []))
                link_done = False
            continue
        if opus_stream is not None and page.serialno == opus_stream.serialno \
                and not link_done:
            links[-1][1].extend(opus_stream.pagein(page))
            if page.eos:
                link_done = True
    if not links:
        raise NotOpusError("no Opus stream found")
    return links, sync.bytes_skipped


def _link_jobs(head: OpusHead, packets, link: int):
    """Timestamp one link's packets into DecodeJobs: pre-skip spread,
    initial PCM offset (op_find_initial_pcm_offset :486-633), end-trim
    from the final granulepos (:1056-1092)."""
    tags_pkt = packets[0] if packets else None
    vendor = ""
    if tags_pkt is not None and tags_pkt.data[:8] == b"OpusTags":
        vlen = struct.unpack_from("<I", tags_pkt.data, 8)[0]
        vendor = tags_pkt.data[12:12 + vlen].decode("utf-8", "replace")
        audio = packets[1:]
    else:
        audio = packets

    jobs: list[DecodeJob] = []
    for p in audio:
        try:
            dur = pkt.get_nb_samples(p.data)
        except pkt.InvalidPacket:
            continue  # undecodable packet: skipped (treated as a hole)
        jobs.append(DecodeJob(data=p.data, duration=dur,
                              granulepos=p.granulepos,
                              hole_before=p.hole_before, link=link))
    if not jobs:
        return vendor, [], 0, -1

    first_gp_idx = next((i for i, j in enumerate(jobs)
                         if j.granulepos != -1), None)
    pcm_start = 0
    if first_gp_idx is not None:
        dur_to_first = sum(j.duration for j in jobs[:first_gp_idx + 1])
        try:
            pcm_start = granpos_add(jobs[first_gp_idx].granulepos,
                                    -dur_to_first)
        except GranposError:
            pcm_start = 0   # gp smaller than the leading duration (:560)
        if pcm_start >= 0 and granpos_cmp(pcm_start, 0) < 0:
            pcm_start = 0

    # pre-skip discard spread over the first packets (:1242-1275)
    remaining = head.pre_skip
    for j in jobs:
        if remaining <= 0:
            break
        d = min(remaining, j.duration)
        j.discard_front = d
        remaining -= d

    last_gp = next((j.granulepos for j in reversed(jobs)
                    if j.granulepos != -1), -1)
    if last_gp != -1:
        cum = pcm_start
        try:
            for j in jobs:
                cum = granpos_add(cum, j.duration)
            overshoot = granpos_diff(cum, last_gp)
        except GranposError:
            overshoot = 0   # un-trimmable wrap edge: keep everything
        if overshoot > 0:
            for j in reversed(jobs):
                if overshoot <= 0:
                    break
                t = min(overshoot, j.duration - j.trim_end)
                j.trim_end += t
                overshoot -= t
    return vendor, jobs, pcm_start, last_gp


def parse_stream(data: bytes) -> OggOpusStream:
    links, skipped = _collect_packets(data)
    all_jobs: list[DecodeJob] = []
    link_heads: list[OpusHead] = []
    vendor0 = ""
    pcm_start0 = 0
    last_gp = -1
    for li, (head, packets) in enumerate(links):
        vendor, jobs, pcm_start, gp = _link_jobs(head, packets,
                                                 len(link_heads))
        if not jobs:
            continue
        link_heads.append(head)
        all_jobs.extend(jobs)
        if len(link_heads) == 1:
            vendor0, pcm_start0 = vendor, pcm_start
        last_gp = gp
    if not all_jobs:
        raise BadHeaderError("no audio packets")
    return OggOpusStream(head=link_heads[0], tags_vendor=vendor0,
                         jobs=all_jobs, pcm_start=pcm_start0,
                         pcm_end=last_gp, bytes_skipped=skipped,
                         link_heads=link_heads)


def open_file(path) -> OggOpusStream:
    with open(path, "rb") as f:
        return parse_stream(f.read())


def split_multistream(s: OggOpusStream) -> list[OggOpusStream]:
    """Lift a single-link family>=1 multistream source into its
    elementary streams: per composite packet, walk the self-delimited
    sub-packets in stream order (the same walk as
    opus_multistream_decode_native, reference src/opus_decoder.cpp:
    826-931) and re-frame each as a REGULAR packet
    (pkt.repack_packet). Child k inherits the parent job's timing
    bookkeeping verbatim — RFC 6716 requires every stream in a packet
    to share the frame duration, so duration/discard/trim align.
    Children get synthetic single-stream OpusHeads (coupled -> stereo,
    else mono) so a StreamPool can classify and batch them as ordinary
    rows; the channel mapping stays with the parent for egress
    interleave."""
    head = s.head
    if s.n_links > 1:
        raise ValueError("split_multistream: single-link sources only")
    S = head.stream_count
    children: list[list[DecodeJob]] = [[] for _ in range(S)]
    for j in s.jobs:
        if j.data is None:          # hole: every elementary stream PLCs
            for k in range(S):
                children[k].append(DecodeJob(
                    data=None, duration=j.duration,
                    discard_front=j.discard_front, trim_end=j.trim_end,
                    granulepos=j.granulepos, hole_before=j.hole_before,
                    link=j.link))
            continue
        pos = 0
        for k in range(S):
            sd = k != S - 1
            p = pkt.parse_packet(j.data[pos:], self_delimited=sd)
            sub = pkt.repack_packet(p) if sd \
                else j.data[pos:pos + p.packet_offset]
            children[k].append(DecodeJob(
                data=sub, duration=j.duration,
                discard_front=j.discard_front, trim_end=j.trim_end,
                granulepos=j.granulepos, hole_before=j.hole_before,
                link=j.link))
            pos += p.packet_offset
    out = []
    for k in range(S):
        cc = 2 if k < head.coupled_count else 1
        ch = OpusHead(version=head.version, channel_count=cc,
                      pre_skip=head.pre_skip,
                      input_sample_rate=head.input_sample_rate,
                      output_gain=head.output_gain, mapping_family=0,
                      stream_count=1,
                      coupled_count=1 if cc == 2 else 0,
                      mapping=b"\x00\x01")
        out.append(OggOpusStream(head=ch, tags_vendor=s.tags_vendor,
                                 jobs=children[k],
                                 pcm_start=s.pcm_start,
                                 pcm_end=s.pcm_end))
    return out
