"""Batched host symbol phase for StreamPool: one C++ call per group/step.

Round-1 profiling showed the per-frame host phase cost ~105 us of which
only ~33 us is the actual C++ symbol decode — the rest was per-frame
ctypes marshalling, numpy allocs, and dict building. These group managers
remove all of it:

  * each group of same-kind streams packs every packet's frame payload
    into ONE contiguous blob at pool init (offsets/lens tables indexed by
    (row, packet));
  * per step, one batch entry (host/native/batch_entry.cpp) decodes all
    active rows into preallocated contiguous output tensors — the GIL is
    released once per group per step, and the C++ loop strip-mines over
    host threads (each stream's decoder state is independent);
  * the device-bucket assembly then becomes vectorized numpy gathers over
    the contiguous outputs instead of per-stream dict stacking.

Native decoder states live in a StateArray (one buffer, per-row ctypes
views), so the per-stream fallback paths (loss, FEC, PLC) and
checkpointing operate on the same memory the batch calls use.

Reference anchor: the host/device split cuts inside opus_decode_frame
(reference src/opus_decoder.cpp:154); these groups are the N-stream host
half (SURVEY.md §7.1 phase 1).
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from ..host.native import (CeltHostState, SilkHostState, NativeCELTHost,
                           NativeSilkHost, NativeSilkStereoHost,
                           StateArray, load, ptr)
from ..host.packet import parse_packet


def default_threads() -> int:
    return max(1, len(os.sched_getaffinity(0)))


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _i16p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))


class FrameTable:
    """Contiguous packed frame payloads for a group of streams.

    blob: all frames back to back; offs/lens: (n_rows, max_packets),
    lens = -1 past each stream's end (the batch entries skip those rows).
    """

    def __init__(self, job_lists):
        parts = []
        npk = [len(jl) for jl in job_lists]
        mx = max(npk) if npk else 0
        m = len(job_lists)
        self.offs = np.zeros((m, mx), dtype=np.int64)
        self.lens = np.full((m, mx), -1, dtype=np.int32)
        self.pkt_bytes = np.zeros((m, mx), dtype=np.int64)
        self.disc = np.zeros((m, mx), dtype=np.int32)   # discard_front
        self.trim = np.zeros((m, mx), dtype=np.int32)   # trim_end
        off = 0
        for r, jl in enumerate(job_lists):
            for k, job in enumerate(jl):
                fr = parse_packet(job.data).frames[0]
                parts.append(fr)
                self.offs[r, k] = off
                self.lens[r, k] = len(fr)
                self.pkt_bytes[r, k] = len(job.data)
                self.disc[r, k] = job.discard_front
                self.trim[r, k] = job.trim_end
                off += len(fr)
        self.blob = np.frombuffer(b"".join(parts) or b"\x00",
                                  dtype=np.uint8)
        self.n_packets = np.asarray(npk, dtype=np.int64)

    def frame0(self, r: int, k: int) -> bytes:
        """The first frame's payload of packet k of row r."""
        o = int(self.offs[r, k])
        return self.blob[o:o + int(self.lens[r, k])].tobytes()

    def row_args(self, pos, active):
        """Per-row (off, len) for packet cursor `pos` (len -1 where
        inactive). pos: (m,) int array; active: (m,) bool."""
        m = len(self.n_packets)
        offs = np.zeros(m, dtype=np.int64)
        lens = np.full(m, -1, dtype=np.int32)
        ok = active & (pos < self.n_packets)
        pc = np.clip(pos, 0, self.offs.shape[1] - 1 if self.offs.size
                     else 0)
        if self.offs.size:
            rows = np.arange(m)
            offs[ok] = self.offs[rows[ok], pc[ok]]
            lens[ok] = self.lens[rows[ok], pc[ok]]
        return offs, lens, ok


class CeltGroup:
    """Batched CELT symbol phase over one group of streams (pure CELT
    rows, or the CELT half of hybrid rows resumed from the SILK ec
    state)."""

    def __init__(self, idxs, job_lists, spf: int, channels: int,
                 start: int, ends, n_threads: int = 0, C: int = 0,
                 table: FrameTable | None = None):
        """channels: the decoder's output channels (CC); C: the coded
        channels of the group's packets (0: the same as CC); table: the
        job lists' FrameTable, if the caller has built it."""
        self.idxs = list(idxs)
        m = len(self.idxs)
        self.table = FrameTable(job_lists) if table is None else table
        self.spf = spf
        self.channels = channels           # CC
        self.C = C or (2 if channels == 2 else 1)
        self.start = np.full(m, start, dtype=np.int32)
        self.ends = np.asarray(ends, dtype=np.int32)
        self.states = StateArray(m, CeltHostState)
        self.hosts = [NativeCELTHost(channels, st=self.states[r])
                      for r in range(m)]
        for r, h in enumerate(self.hosts):
            h.start = start
            h.end = int(self.ends[r])
        self.lib = load()
        self.n_threads = n_threads or default_threads()
        N = spf
        self.X = np.zeros((m, self.C * N), dtype=np.int16)
        self.bandE = np.zeros((m, 42), dtype=np.int16)
        self.params = np.zeros((m, 18), dtype=np.int32)
        self.rets = np.zeros(m, dtype=np.int32)

    def decode(self, pos, active, ec_in=None):
        """Decode packet `pos[r]` of every active row. Returns the row
        mask actually decoded; outputs land in self.X/bandE/params."""
        offs, lens, ok = self.table.row_args(pos, active)
        m = len(self.idxs)
        disable_inv = 1 if self.channels == 1 else 0
        self.lib.celt_host_decode_batch(
            m, self.table.blob.ctypes.data_as(
                ctypes.POINTER(ctypes.c_uint8)),
            _i64p(offs), ptr(lens), self.spf, self.channels, self.C,
            ptr(self.start), ptr(self.ends), disable_inv,
            self.states.base_ptr(), self.states.stride,
            None if ec_in is None else ptr(np.ascontiguousarray(
                ec_in, dtype=np.int32)),
            _i16p(self.X), _i16p(self.bandE), ptr(self.params),
            ptr(self.rets), self.n_threads)
        bad = ok & (self.rets != 0)
        if bad.any():
            r = int(np.nonzero(bad)[0][0])
            raise ValueError(
                f"celt_host_decode_batch failed on stream "
                f"{self.idxs[r]}: {int(self.rets[r])}")
        return ok


_SILK_COL_SPECS = (("A", (2, 16)), ("B", (4, 5)), ("gains", (4,)),
                   ("inv", (4,)), ("lag", (4,)), ("flags", (12,)),
                   ("adj", (4,)), ("misc", (24,)))


class _SilkBuffers:
    def __init__(self, m: int, frame_len: int, nfr: int = 1):
        self.exc = np.zeros((m, nfr * frame_len), dtype=np.int32)
        for name, shp in _SILK_COL_SPECS:
            setattr(self, name,
                    np.zeros((m, nfr) + shp if nfr > 1 else (m,) + shp,
                             dtype=np.int32))
        self.rets = np.zeros(m, dtype=np.int32)

    def cols(self, j: int = 0, nfr: int = 1, frame_len: int = 0):
        """Device-frame j as the column dict _silk_launch consumes."""
        if nfr > 1:
            g = {name: np.ascontiguousarray(getattr(self, name)[:, j])
                 for name, _ in _SILK_COL_SPECS}
            exc = np.ascontiguousarray(
                self.exc[:, j * frame_len:(j + 1) * frame_len])
        else:
            g = {name: getattr(self, name) for name, _ in _SILK_COL_SPECS}
            exc = self.exc
        flags = g["flags"]
        return dict(exc=exc, A=g["A"], B=g["B"], gains=g["gains"],
                    inv=g["inv"], lag=g["lag"],
                    voiced=flags[:, 0:4].astype(bool),
                    rewhiten=flags[:, 4:8].astype(bool),
                    match=flags[:, 8:12].astype(bool), adj=g["adj"])


def put_row(b: _SilkBuffers, r: int, p: dict) -> None:
    """Write one frame's params dict (as NativeSilkHost.frame, .packet or
    .fec_frame returns it) into row r of single-frame buffers b, as the
    batch entry would have left it."""
    b.exc[r] = p["exc"]
    for name in ("A", "B", "gains", "inv", "lag", "adj"):
        getattr(b, name)[r] = p[name]
    b.flags[r, 0:4] = p["voiced"]
    b.flags[r, 4:8] = p["rewhiten"]
    b.flags[r, 8:12] = p["match"]
    b.misc[r] = 0
    b.misc[r, 0] = p["signal_type"]
    b.misc[r, 3] = p["lag_prev"]
    b.misc[r, 4] = p["ltp_scale"]
    b.misc[r, 8:24] = p["nlsf"]


def put_stereo(mid: _SilkBuffers, side: _SilkBuffers, info, r: int,
               sp: dict) -> None:
    """Write one stereo frame's dict (as NativeSilkStereoHost.packet,
    .packet_multi or .fec_packet returns it) into row r of the mid and
    side buffers and of info, as silk_host_stereo_batch leaves them
    (info: has_side, side_reset, prev_dom, pred (2), and for an LBRR
    frame side_conceal and mid_conceal); a channel the frame does not
    code leaves its row as it was."""
    if not sp.get("mid_conceal"):
        put_row(mid, r, sp["mid"])
    if sp["side"] is not None:
        put_row(side, r, sp["side"])
    info[r, 0] = sp["side"] is not None
    info[r, 1] = sp["side_reset"]
    info[r, 3:5] = sp["pred"]
    info[r, 5] = sp.get("side_conceal", False)
    info[r, 6] = sp.get("mid_conceal", False)


class SilkGroup:
    """Batched mono SILK symbol phase: 10/20 ms payloads via the frame
    entry (also the SILK half of hybrid rows, exporting ec states for the
    CELT resume batch); 40/60 ms payloads via the packet entry."""

    def __init__(self, idxs, job_lists, fs: int, payload_ms: int,
                 hybrid: bool = False, n_threads: int = 0,
                 table: FrameTable | None = None):
        self.idxs = list(idxs)
        m = len(self.idxs)
        self.table = FrameTable(job_lists) if table is None else table
        self.fs = fs
        self.payload_ms = payload_ms
        self.hybrid = hybrid
        self.nfr = 1 if payload_ms <= 20 else payload_ms // 20
        self.frame_len = (payload_ms if payload_ms <= 20 else 20) * fs
        self.states = StateArray(m, SilkHostState)
        self.hosts = [NativeSilkHost(st=self.states[r]) for r in range(m)]
        self.lib = load()
        self.n_threads = n_threads or default_threads()
        self.buf = _SilkBuffers(m, self.frame_len, self.nfr)
        self.ec = np.zeros((m, 9), dtype=np.int32)

    def decode(self, pos, active):
        offs, lens, ok = self.table.row_args(pos, active)
        m = len(self.idxs)
        blob = self.table.blob.ctypes.data_as(
            ctypes.POINTER(ctypes.c_uint8))
        b = self.buf
        if self.nfr == 1:
            self.lib.silk_host_frame_batch(
                m, blob, _i64p(offs), ptr(lens), self.fs, self.payload_ms,
                int(self.hybrid), self.states.base_ptr(),
                self.states.stride,
                ptr(b.exc), ptr(b.A), ptr(b.B), ptr(b.gains), ptr(b.inv),
                ptr(b.lag), ptr(b.flags), ptr(b.adj), ptr(self.ec),
                ptr(b.misc), ptr(b.rets), self.n_threads)
        else:
            self.lib.silk_host_packet_batch(
                m, blob, _i64p(offs), ptr(lens), self.fs, self.payload_ms,
                self.states.base_ptr(), self.states.stride,
                ptr(b.exc), ptr(b.A), ptr(b.B), ptr(b.gains), ptr(b.inv),
                ptr(b.lag), ptr(b.flags), ptr(b.adj), ptr(b.misc),
                ptr(b.rets), self.n_threads)
        bad = ok & (b.rets != 0)
        if bad.any():
            r = int(np.nonzero(bad)[0][0])
            raise ValueError(f"silk batch decode failed on stream "
                             f"{self.idxs[r]}: {int(b.rets[r])}")
        return ok


class SilkStereoGroup:
    """Batched stereo SILK symbol phase (single-frame packets: 20 ms,
    or 10 ms with frame_ms=10 -> nb_subfr 2; also the SILK half of
    stereo hybrid rows). prev_decode_only_middle is carried per row and
    mirrored onto the per-stream host objects so fallback paths stay
    coherent."""

    def __init__(self, idxs, job_lists, fs: int, hybrid: bool = False,
                 n_threads: int = 0, frame_ms: int = 20,
                 table: FrameTable | None = None):
        self.idxs = list(idxs)
        m = len(self.idxs)
        self.table = FrameTable(job_lists) if table is None else table
        self.fs = fs
        self.hybrid = hybrid
        self.frame_ms = frame_ms
        self.frame_len = frame_ms * fs
        self.states = StateArray(2 * m, SilkHostState)
        self.hosts = [NativeSilkStereoHost(
            st=(self.states[2 * r], self.states[2 * r + 1]))
            for r in range(m)]
        self.lib = load()
        self.n_threads = n_threads or default_threads()
        self.mid = _SilkBuffers(m, self.frame_len)
        self.side = _SilkBuffers(m, self.frame_len)
        self.ec = np.zeros((m, 9), dtype=np.int32)
        self.info = np.zeros((m, 8), dtype=np.int32)
        self.prev_dom = np.zeros(m, dtype=np.int32)


    def decode(self, pos, active):
        offs, lens, ok = self.table.row_args(pos, active)
        m = len(self.idxs)
        # fallback paths mutate host.prev_dom — sync in, batch, sync out
        for r, h in enumerate(self.hosts):
            self.prev_dom[r] = h.prev_dom
        mb, sb = self.mid, self.side
        self.info[:, 5:] = 0       # the batch entry writes words 0-4 only
        self.lib.silk_host_stereo_batch(
            m, self.table.blob.ctypes.data_as(
                ctypes.POINTER(ctypes.c_uint8)),
            _i64p(offs), ptr(lens), self.fs, self.frame_ms,
            ptr(self.prev_dom),
            int(self.hybrid), self.states.base_ptr(), self.states.stride,
            ptr(mb.exc), ptr(mb.A), ptr(mb.B), ptr(mb.gains), ptr(mb.inv),
            ptr(mb.lag), ptr(mb.flags), ptr(mb.adj), ptr(mb.misc),
            ptr(sb.exc), ptr(sb.A), ptr(sb.B), ptr(sb.gains), ptr(sb.inv),
            ptr(sb.lag), ptr(sb.flags), ptr(sb.adj), ptr(sb.misc),
            ptr(self.ec), ptr(self.info), ptr(mb.rets), self.n_threads)
        bad = ok & (mb.rets != 0)
        if bad.any():
            r = int(np.nonzero(bad)[0][0])
            raise ValueError(f"silk stereo batch failed on stream "
                             f"{self.idxs[r]}: {int(mb.rets[r])}")
        for r in np.nonzero(ok)[0]:
            self.hosts[r].prev_dom = int(self.info[r, 2])
        return ok
