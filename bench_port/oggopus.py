"""Plain Ogg/Opus demux for the benchmark's own side: the packets of the
first logical stream of a single-link file and its OpusHead pre-skip.

The reference decodes what this module reads, and the harness checks at
set-up that the decoder under test was handed the same packets. Only
what the frozen fixtures need: one link, one logical stream, no holes
(RFC 3533 pages, RFC 7845 headers).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass


@dataclass(frozen=True)
class OpusSource:
    packets: tuple          # audio packets (bytes), in order
    pre_skip: int           # samples at 48 kHz dropped from the start
    channels: int


def read_packets(data: bytes) -> list:
    """Every packet of the first logical stream (serial number of the first
    page), in order; a packet may span pages (lacing value 255)."""
    out, partial, pos, serial = [], b"", 0, None
    while pos < len(data):
        if data[pos:pos + 4] != b"OggS":
            raise ValueError(f"no Ogg page at byte {pos}")
        nseg = data[pos + 26]
        sno = struct.unpack_from("<I", data, pos + 14)[0]
        lacing = data[pos + 27:pos + 27 + nseg]
        body = pos + 27 + nseg
        if serial is None:
            serial = sno
        for lv in lacing:
            if sno == serial:
                partial += data[body:body + lv]
                if lv < 255:
                    out.append(partial)
                    partial = b""
            body += lv
        pos = body
    return out


def parse(data: bytes) -> OpusSource:
    pkts = read_packets(data)
    head = pkts[0]
    if head[:8] != b"OpusHead" or pkts[1][:8] != b"OpusTags":
        raise ValueError("not an Ogg/Opus stream")
    channels = head[9]
    pre_skip = struct.unpack_from("<H", head, 10)[0]
    return OpusSource(packets=tuple(pkts[2:]), pre_skip=pre_skip,
                      channels=channels)
