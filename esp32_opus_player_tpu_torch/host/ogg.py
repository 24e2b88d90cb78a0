"""Ogg container demux — host-side byte work (RFC 3533).

Covers the behavior of the reference container layer (reference src/ogg.cpp):
capture-pattern scan + CRC verification with resync on mismatch
(src/ogg.cpp:839-923), lacing-value packet reassembly with continued packets,
hole detection on page-sequence discontinuities (src/ogg.cpp:1020-1033), and
granule positions attached to the last packet completed on a page.

Implemented as a clean streaming parser rather than a port of libogg's
buffer machinery: pages in, packets out.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class OggPage:
    version: int
    continued: bool
    bos: bool
    eos: bool
    granulepos: int          # signed 64-bit; -1 = no packet ends on page
    serialno: int
    pageno: int
    lacing: bytes            # segment table
    body: bytes

    @property
    def num_packets(self) -> int:
        """Packets *completed* on this page (ogg_page_packets semantics)."""
        n = 0
        for v in self.lacing:
            if v < 255:
                n += 1
        return n


def _load_native_scan():
    """The native page scanner (host/native/ogg_host.cpp): capture sync +
    slice-by-8 CRC over a whole buffer in one call. A library that does
    not build or load raises here, at parse time: the decode that
    follows needs the same library."""
    import ctypes
    from .native import load
    lib = load()
    if not getattr(lib, "_ogg_bound", False):
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.ogg_page_scan.restype = ctypes.c_int32
        lib.ogg_page_scan.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, i64p, i32p, i32p, i64p,
            i32p, i32p, i32p, ctypes.c_int32, i64p, i64p]
        lib._ogg_bound = True
    return lib


class OggSync:
    """Byte stream -> verified pages. Mirrors ogg_sync_* behavior:
    scans for 'OggS', validates header + CRC, skips garbage. Page
    scanning + CRC run in the native engine."""

    def __init__(self) -> None:
        self._buf = bytearray()
        self._eof = False
        self.bytes_skipped = 0
        self._queue: list[OggPage] = []
        self._lib = _load_native_scan()

    def write(self, data: bytes) -> None:
        self._buf.extend(data)

    def set_eof(self) -> None:
        self._eof = True

    def pageout(self):
        """Return the next verified OggPage, or None if more data is needed.
        Invalid bytes are skipped (counted in bytes_skipped)."""
        import ctypes
        import numpy as np
        if self._queue:
            return self._queue.pop(0)
        buf = self._buf
        if not buf:
            return None
        cap = 256
        offs = np.zeros(cap, dtype=np.int64)
        hdr = np.zeros(cap, dtype=np.int32)
        body = np.zeros(cap, dtype=np.int32)
        gps = np.zeros(cap, dtype=np.int64)
        serial = np.zeros(cap, dtype=np.int32)
        pageno = np.zeros(cap, dtype=np.int32)
        flags = np.zeros(cap, dtype=np.int32)
        consumed = ctypes.c_int64(0)
        skipped = ctypes.c_int64(0)
        raw = bytes(buf)

        def p64(a):
            return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

        def p32(a):
            return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

        n = self._lib.ogg_page_scan(
            raw, len(raw), p64(offs), p32(hdr), p32(body), p64(gps),
            p32(serial), p32(pageno), p32(flags), cap,
            ctypes.byref(consumed), ctypes.byref(skipped))
        self.bytes_skipped += int(skipped.value)
        for k in range(n):
            o, hl, bl = int(offs[k]), int(hdr[k]), int(body[k])
            ht = int(flags[k])
            self._queue.append(OggPage(
                version=0,
                continued=bool(ht & 0x01),
                bos=bool(ht & 0x02),
                eos=bool(ht & 0x04),
                granulepos=int(gps[k]),
                serialno=int(serial[k]) & 0xFFFFFFFF,
                pageno=int(pageno[k]) & 0xFFFFFFFF,
                lacing=raw[o + 27:o + hl],
                body=raw[o + hl:o + hl + bl],
            ))
        del buf[:consumed.value]
        return self._queue.pop(0) if self._queue else None


@dataclass
class OggPacket:
    data: bytes
    granulepos: int          # -1 unless this packet completes on a gp page
    hole_before: bool = False  # a page-sequence gap preceded this packet
    bos: bool = False
    eos: bool = False


@dataclass
class OggStream:
    """Pages (one serialno) -> packets, with hole flagging on pageno gaps
    (matching the 0x400 lacing marker policy, src/ogg.cpp:1020-1033)."""
    serialno: int
    _partial: bytearray = field(default_factory=bytearray)
    _have_partial: bool = False
    _pageno: int = -1
    _pending_hole: bool = False

    def pagein(self, page: OggPage) -> list[OggPacket]:
        assert page.serialno == self.serialno
        out: list[OggPacket] = []
        if self._pageno >= 0 and page.pageno != self._pageno + 1:
            # lost page(s): drop any partial packet, flag a hole
            self._partial.clear()
            self._have_partial = False
            self._pending_hole = True
        elif self._have_partial and not page.continued:
            # continuation expected but page starts fresh
            self._partial.clear()
            self._have_partial = False
            self._pending_hole = True
        self._pageno = page.pageno

        # continuation data for a packet we never started (e.g. we resynced
        # mid-packet): skip segments until one terminates
        skipping = page.continued and not self._have_partial
        if skipping:
            self._pending_hole = True

        pos = 0
        completed_on_page = []
        for lace in page.lacing:
            seg = page.body[pos:pos + lace]
            pos += lace
            if skipping:
                if lace < 255:
                    skipping = False
                continue
            self._partial.extend(seg)
            self._have_partial = True
            if lace < 255:
                completed_on_page.append(bytes(self._partial))
                self._partial.clear()
                self._have_partial = False
        # a page ending mid-packet keeps _have_partial for the next page

        for j, pkt in enumerate(completed_on_page):
            is_last = j == len(completed_on_page) - 1
            out.append(OggPacket(
                data=pkt,
                granulepos=page.granulepos if is_last else -1,
                hole_before=self._pending_hole and j == 0,
                bos=page.bos and j == 0,
                eos=page.eos and is_last,
            ))
        if completed_on_page:
            self._pending_hole = False
        return out
