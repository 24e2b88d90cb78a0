"""Opus packet layer: TOC parsing and frame splitting — host-side.

Matches the reference packet machinery (reference src/opus_decoder.cpp:
opus_packet_get_mode at :135, get_bandwidth :460, get_samples_per_frame :541,
get_nb_frames :477, parse_size :524, opus_packet_parse_impl :559; RFC 6716 §3).
"""
from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum


class Mode(IntEnum):
    SILK_ONLY = 1000
    HYBRID = 1001
    CELT_ONLY = 1002


class Bandwidth(IntEnum):
    NARROWBAND = 1101     # 4 kHz
    MEDIUMBAND = 1102     # 6 kHz
    WIDEBAND = 1103       # 8 kHz
    SUPERWIDEBAND = 1104  # 12 kHz
    FULLBAND = 1105       # 20 kHz


class InvalidPacket(ValueError):
    pass


def get_mode(toc: int) -> Mode:
    if toc & 0x80:
        return Mode.CELT_ONLY
    if (toc & 0x60) == 0x60:
        return Mode.HYBRID
    return Mode.SILK_ONLY


def get_bandwidth(toc: int) -> Bandwidth:
    if toc & 0x80:
        bw = Bandwidth.MEDIUMBAND + ((toc >> 5) & 0x3)
        if bw == Bandwidth.MEDIUMBAND:
            bw = Bandwidth.NARROWBAND
    elif (toc & 0x60) == 0x60:
        bw = Bandwidth.FULLBAND if toc & 0x10 else Bandwidth.SUPERWIDEBAND
    else:
        bw = Bandwidth.NARROWBAND + ((toc >> 5) & 0x3)
    return Bandwidth(bw)


def get_nb_channels(toc: int) -> int:
    return 2 if toc & 0x4 else 1


def get_samples_per_frame(toc, fs: int = 48000) -> int:
    if isinstance(toc, (bytes, bytearray)):
        toc = toc[0]
    if toc & 0x80:
        return (fs << ((toc >> 3) & 0x3)) // 400
    if (toc & 0x60) == 0x60:
        return fs // 50 if toc & 0x08 else fs // 100
    audiosize = (toc >> 3) & 0x3
    if audiosize == 3:
        return fs * 60 // 1000
    return (fs << audiosize) // 100


def get_nb_frames(packet: bytes) -> int:
    if len(packet) < 1:
        raise InvalidPacket("empty packet")
    code = packet[0] & 0x3
    if code == 0:
        return 1
    if code != 3:
        return 2
    if len(packet) < 2:
        raise InvalidPacket("code-3 packet too short")
    return packet[1] & 0x3F


def get_nb_samples(packet: bytes, fs: int = 48000) -> int:
    samples = get_nb_frames(packet) * get_samples_per_frame(packet, fs)
    if samples * 25 > fs * 3:  # > 120 ms
        raise InvalidPacket("packet exceeds 120 ms")
    return samples


def _parse_size(data: bytes, pos: int, end: int) -> tuple[int, int]:
    """Returns (size, bytes_consumed). RFC 6716 §3.2.1 length coding."""
    if end - pos < 1:
        raise InvalidPacket("truncated size")
    b0 = data[pos]
    if b0 < 252:
        return b0, 1
    if end - pos < 2:
        raise InvalidPacket("truncated 2-byte size")
    return 4 * data[pos + 1] + b0, 2


@dataclass
class ParsedPacket:
    toc: int
    frames: list[bytes]
    payload_offset: int
    packet_offset: int

    @property
    def mode(self) -> Mode:
        return get_mode(self.toc)

    @property
    def bandwidth(self) -> Bandwidth:
        return get_bandwidth(self.toc)

    @property
    def stream_channels(self) -> int:
        return get_nb_channels(self.toc)

    @property
    def frame_size(self) -> int:
        return get_samples_per_frame(self.toc)


def parse_packet(packet: bytes, self_delimited: bool = False) -> ParsedPacket:
    """Split an Opus packet into its frames (opus_packet_parse_impl,
    reference src/opus_decoder.cpp:559-686)."""
    if len(packet) == 0:
        raise InvalidPacket("empty packet")
    data = packet
    framesize = get_samples_per_frame(data, 48000)
    toc = data[0]
    pos = 1
    end = len(data)
    pad = 0
    cbr = False
    sizes: list[int] = []
    last_size = end - pos
    code = toc & 0x3
    if code == 0:
        count = 1
    elif code == 1:
        count = 2
        cbr = True
        if not self_delimited:
            if (end - pos) & 1:
                raise InvalidPacket("odd length for code-1 packet")
            last_size = (end - pos) // 2
            sizes = [last_size]
    elif code == 2:
        count = 2
        sz, nb = _parse_size(data, pos, end)
        pos += nb
        if sz > end - pos:
            raise InvalidPacket("code-2 first frame too large")
        sizes = [sz]
        last_size = end - pos - sz
    else:
        if end - pos < 1:
            raise InvalidPacket("code-3 packet too short")
        ch = data[pos]
        pos += 1
        count = ch & 0x3F
        if count <= 0 or framesize * count > 5760:
            raise InvalidPacket("bad frame count")
        if ch & 0x40:  # padding
            while True:
                if pos >= end:
                    raise InvalidPacket("truncated padding")
                p = data[pos]
                pos += 1
                tmp = 254 if p == 255 else p
                end -= tmp
                pad += tmp
                if p != 255:
                    break
        if end - pos < 0:
            raise InvalidPacket("padding exceeds packet")
        cbr = not (ch & 0x80)
        if not cbr:
            last_size = end - pos
            for _ in range(count - 1):
                sz, nb = _parse_size(data, pos, end)
                pos += nb
                if sz > end - pos:
                    raise InvalidPacket("VBR frame too large")
                sizes.append(sz)
                last_size -= nb + sz
            if last_size < 0:
                raise InvalidPacket("VBR sizes exceed packet")
        elif not self_delimited:
            if (end - pos) % count:
                raise InvalidPacket("CBR length not divisible")
            last_size = (end - pos) // count
            sizes = [last_size] * (count - 1)

    if self_delimited:
        sz, nb = _parse_size(data, pos, end)
        pos += nb
        if sz > end - pos:
            raise InvalidPacket("self-delimited size too large")
        if cbr:
            if sz * count > end - pos:
                raise InvalidPacket("self-delimited CBR overflow")
            sizes = [sz] * (count - 1)
        elif nb + sz > last_size:
            raise InvalidPacket("self-delimited last frame too large")
        sizes.append(sz)
    else:
        if last_size > 1275:
            raise InvalidPacket("frame exceeds 1275 bytes")
        sizes.append(last_size)

    payload_offset = pos
    frames = []
    for sz in sizes:
        frames.append(data[pos:pos + sz])
        pos += sz
    assert len(frames) == count
    return ParsedPacket(toc=toc, frames=frames,
                        payload_offset=payload_offset,
                        packet_offset=pad + pos)


def _encode_size(sz: int) -> bytes:
    """One- or two-byte frame length (RFC 6716 §3.2.1, inverse of
    _parse_size)."""
    if sz < 252:
        return bytes([sz])
    b0 = 252 + ((sz - 252) & 3)
    return bytes([b0, (sz - b0) >> 2])


def repack_packet(p: ParsedPacket) -> bytes:
    """Re-serialize a parsed (possibly self-delimited) packet as a
    REGULAR undelimited packet: identical TOC and frame payloads, no
    length suffix, no padding. Used to lift elementary streams out of a
    multistream packet so the batched engines — which speak undelimited
    framing only — can decode them as ordinary pool rows; the reference
    instead threads self_delimited through every per-frame decode call
    (opus_multistream_decode_native, src/opus_decoder.cpp:826-931)."""
    toc = p.toc
    fr = p.frames
    code = toc & 3
    if code == 0:
        return bytes([toc]) + fr[0]
    if code == 1:
        if len(fr[0]) != len(fr[1]):
            raise InvalidPacket("code-1 frames must be equal length")
        return bytes([toc]) + fr[0] + fr[1]
    if code == 2:
        return bytes([toc]) + _encode_size(len(fr[0])) + fr[0] + fr[1]
    eq = all(len(f) == len(fr[0]) for f in fr)
    out = bytearray([toc, len(fr) | (0 if eq else 0x80)])
    if not eq:
        for f in fr[:-1]:
            out += _encode_size(len(f))
    for f in fr:
        out += f
    return bytes(out)
