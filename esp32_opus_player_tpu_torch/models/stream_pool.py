"""StreamPool: decode many concurrent Ogg/Opus streams with torch.

Port of the CELT transposed ("T-mode") path and the SILK and hybrid
paths of esp32_opus_player_tpu/models/stream_pool.py. The streams fall
into lanes: one CELT lane per frame size (LM 0-3) and coded channel
count (the JAX pool's (LM, C) superstep keys), one SILK lane per class
("silk" or "silk2", internal rate, device frames a packet, frame size),
or one hybrid lane per ("hybrid" or "hybrid2", frame size), each a
device bucket of its streams in row order with its own state and its
own K-frame window. Per step, for each lane:

1. host: the batched native symbol phase over its streams with a packet
   left (models/host_groups.py, the port's copy; a hybrid lane's CELT
   half resumes its SILK half's range coder);
2. one packed staging row per stream (and channel, stereo SILK) and
   device frame: int16 for CELT (models/celt_pool_T.py), int32 for SILK
   (models/silk_pool.py); a packet of 40 or 60 ms, or a code-3 packet,
   is several device frames of the window;
3. device: one whole-lane frame step, or with superstep_k = K one
   K-frame window run as a unit: one upload, K frame steps, one PCM
   fetch (a hybrid lane's: both halves' windows, then their SAT16 mix);
4. host: the PCM is fetched `pipeline_depth` steps later (the device
   works while the next steps' symbol phases run), trimmed (pre-skip,
   end-trim) and appended per stream.

Supported, as the JAX pool batches them: CELT-only streams with one
frame per packet, channels 1 or 2: in compat mode (compat_ref=True) 20
ms frames only; in RFC mode 2.5, 5, 10 and 20 ms frames at any one
bandwidth per stream (the end band per bandwidth, _ENDBAND_OF_BW); SILK
streams at one internal rate whose coded channels are the pool's (mono
at channels 1, stereo at channels 2): one 20 ms frame a packet in compat
mode, 10, 20, 40 and 60 ms payloads and code-3 packets of up to 120 ms
in RFC mode (stereo 10 ms payloads one a packet); hybrid streams at one
bandwidth whose coded channels are the pool's, 20 ms (and 10 ms in RFC
mode) frames one a packet. All with superstep_k >= 1, out_fs 48000,
output "host"; one batched kind a pool.

Scalar rows, as in the JAX pool: a stream the JAX pool decodes with its
scalar decoders is classified `("scalar",)` (chained sources, mode or
bandwidth switches, multi-frame CELT packets, compat-mode CELT other
than 20 ms, compat-mode SILK other than one 20 ms frame a packet, compat
hybrid at 10 ms, SILK or hybrid whose coded channels differ from the
pool's) and decodes on the host in step() through the port's
OpusDecoder (models/opus_decoder.py, a fresh one at each chain link); a
multistream source (more than one stream or 2 channels) is `("ms",)`
and decodes through one OpusMSDecoder (the JAX pool's ms_batch=False
route). Their PCM is trimmed and appended as a lane's; a lost packet is
the decoder's own loss path. `path[i]` holds each stream's class:
("celt", LM, coded channels, end band), ("silk", fs, dfp, ms, frame_ms)
or ("silk2", ...) (dfp device frames of frame_ms a packet, ms a frame
of the packet), ("hybrid", end band, frame_ms) or ("hybrid2", ...),
("scalar",) or ("ms",).

stats() gives the JAX pool's counters, and _phase_s its per-phase host
wall time (seconds): host_symbol (the batched symbol phase and, for
lost SILK rows, the conceal preps and FEC decodes), dispatch (staging
and the device enqueues), materialize (the PCM fetch and the routing to
the streams). The pool records where that time goes as spans on the
process's recorder (utils/spans.py): each phase is a span from the same
stamps as its _phase_s key, with the symbol call, the staging and its
wait, the window's enqueue, the wait for a window's PCM and the routing
of each step inside, and its construction as `pool.build`.

Lost packets (step(lost=, fec=), run(loss=, fec=)): a lost CELT packet
gives silence and leaves the stream's state untouched, a masked row,
unless the pool conceals (RFC mode with rfc_plc=True): then, as in the
JAX pool, libopus' celt_decode_lost runs in the window frame of the
step: its pitch branch (a stream's first five conceals of a 20 ms frame
since the second good frame after a loss run) on the device with kernel
P1 after the frame's decode, its noise branch (the rest) as a host-built
row of decayed band energies and LCG noise through the frame's normal
decode. A lost SILK packet, as in the JAX pool: in compat mode it
decodes the normal frame path over an empty bitstream; in RFC mode with
rfc_plc=True it is concealed on the device (silk_PLC conceal, kernel K8,
then comfort noise, K9), one conceal a device frame of the packet, a
stereo side only where the previous frame had one, as rows of the same
window frames as the step's decoded rows, and the first good frame after
a loss run is glue-smoothed; with fec, in both modes, a lost single-frame
packet is decoded from the next packet's in-band LBRR copy when that
packet has one (stereo: a channel the copy lacks is concealed; no copy
at all, rfc_plc: concealed as silk_Decode conceals at lostFlag 2). A
lost hybrid packet: compat mode, the SILK state advances over an empty
bitstream and the frame is muted (the reference's CELT stage fails);
FEC, the SILK frame alone; rfc_plc, the SILK conceal and CELT's noise
branch from band 17, mixed. Where the JAX pool and the port's scalar
decoder differ, the pool follows the scalar decoder (ROADMAP.md section
C). A pool that mixes batched kinds, and every option the port lacks,
raises NotImplementedError naming the ROADMAP.md item that brings it.
"""
from __future__ import annotations

import collections
import os
import pathlib
import time

import numpy as np
import torch

from ..host import opusfile
from ..host.native import CeltHostState
from ..host.packet import (Mode, get_bandwidth, get_nb_channels,
                           get_nb_frames, get_samples_per_frame,
                           parse_packet)
from ..ops.celt.math import celt_lcg_rand
from ..ops.celt.pvq import renormalise_vector
from ..ops.celt.torch_plc import LPC_ORDER
from ..ops.celt.torch_synthesis import (DECODE_BUFFER_SIZE, EB, I32,
                                        NB_EBANDS, OVERLAP, SHORT_MDCT_SIZE)
from ..host.native import cut_T, take_strips
from ..utils import spans
from ..utils.device import resolve_device
from . import host_groups as hg
from . import silk_pool
from .batch_silk import TrackerArray
from .celt_pool_T import _CELT_HDR, celt_pool_superstep_T
from .ms_decoder import OpusMSDecoder
from .opus_decoder import OpusDecoder

_FS_OF_BW = {1101: 8, 1102: 12, 1103: 16}    # SILK-only: NB, MB, WB
# CELT end band per bandwidth (opus_decode_frame, src/opus_decoder.cpp:199)
_ENDBAND_OF_BW = {1101: 13, 1102: 17, 1103: 17, 1104: 19, 1105: 21}
_LM_OF_SPF = {120: 0, 240: 1, 480: 2, 960: 3}


def _todo(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to torch yet (ROADMAP.md queue A item "
        f"{item})")


class _Window:
    """The PCM of one window of a lane's frames: a host copy (K, ...) of
    the device output, fetched once, on first use."""

    __slots__ = ("lane", "host_t", "done")

    def __init__(self, lane):
        self.lane = lane
        self.host_t = None
        self.done = None          # CUDA event: the host copy has landed

    def host(self) -> np.ndarray:
        if self.host_t is None:        # fetched before K frames buffered
            self.lane.dispatch()
        if self.done is not None:
            self.done.synchronize()
        return self.host_t.numpy()


class _Lane:
    """One device bucket: a host symbol group over the streams `idxs`
    (row r is stream idxs[r]), their device state, and one staging
    window of K frames on the host, pinned on a card so the upload is
    asynchronous. Subclasses fill a staging frame, run a window and cut
    a frame's PCM per stream."""

    N = 960                       # samples a frame at 48 kHz
    kind = ""                     # the stats() frame counter it adds to
    # a window frame's layout: stream-major, cut by `frames`, or
    # transposed (streams contiguous), cut by `cut`
    transposed = False

    def __init__(self, pool, group, idxs, width: int, dtype):
        self.pool = pool
        self.index = len(pool._lanes)   # a hybrid lane's halves share it
        self.group = group
        self.idxs = np.asarray(idxs, dtype=np.int64)
        self.n = len(self.idxs)
        self.stg = torch.zeros((pool._ss_k, self.n, width), dtype=dtype,
                               device="cpu", pin_memory=pool._cuda)
        self.stg_np = self.stg.numpy()
        self.stg_free = None      # event after the last upload out of stg
        self.masked: list[bool] = []
        self.win = _Window(self)

    def decode(self, pos, active):
        """The batched symbol phase of packet pos[r] of every active row;
        returns the rows decoded."""
        return self.group.decode(pos, active)

    def host_step(self, pos, ok, lost, fec):
        """The host work of one step after the symbol phase (`ok`: the rows
        decoded; `lost`: the rows whose packet was lost; `fec`: those of
        them that may take the next packet's LBRR copy). Returns (sel,
        infos, n_fec): the rows that take part in the step's frames, one
        `fill` info per device frame of the step, and the number of lost
        rows the LBRR copy recovered. Here: no loss handling."""
        return np.nonzero(ok)[0], [None], 0

    def put(self, sel, info=None) -> int:
        """Write the next staging frame (rows `sel` take part, the rest
        are inactive; `info` is the lane's own per-frame data). `fill`
        says whether the frame has inactive rows (it is masked). Returns
        the frame's index in the window."""
        rec, sn = self.pool._rec, self.pool._step_no
        sp = rec.open("stage", sn, self.index)
        if not self.masked and self.stg_free is not None:
            w = rec.open("stage_wait", sn, self.index)
            self.stg_free.synchronize()
            rec.close(w)
        k = len(self.masked)
        self.masked.append(self.fill(self.stg_np[k], sel, info))
        rec.close(sp)
        return k

    def stage(self, sel, info=None):
        """`put` a frame and dispatch the window once it holds K frames.
        Returns (window, frame index) of the frame."""
        win, k = self.win, self.put(sel, info)
        if len(self.masked) == self.pool._ss_k:
            self.dispatch()
        return win, k

    def upload_aux(self):
        """Whatever the window needs on the device beside its staging
        frames (uploaded before the staging is free for the next
        window)."""
        return None

    def dispatch(self) -> None:
        """Run the buffered frames of the window on the device."""
        pool, win, K = self.pool, self.win, len(self.masked)
        sp = pool._rec.open("enqueue", pool._step_no, self.index)
        stgK = self.stg[:K].to(pool.device, non_blocking=True)
        aux = self.upload_aux()
        if pool._cuda:
            self.stg_free = torch.cuda.Event()
            self.stg_free.record()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
        pcmK = self.run(stgK, self.masked, aux)
        if pool._cuda:
            t1.record()
            pool._win_events.append((K, t0, t1))
            win.host_t = torch.empty(pcmK.shape, dtype=pcmK.dtype,
                                     device="cpu", pin_memory=True)
            win.host_t.copy_(pcmK, non_blocking=True)
            win.done = torch.cuda.Event()
            win.done.record()
        else:
            win.host_t = pcmK
        self.win = _Window(self)
        self.masked = []
        pool._rec.close(sp)


class _Pinned:
    """Rows collected over a window's frames in growing host buffers,
    pinned on a card so their upload is asynchronous: `cols` maps a name
    to (dtype, row width, None for a scalar). `off` holds the row count at
    each frame's start."""

    def __init__(self, pin: bool, **cols):
        self.pin, self.cols = pin, cols
        self.off = [0]
        self.t = {}
        self._alloc(64)

    def _alloc(self, cap: int) -> None:
        used = self.off[-1]
        t = {k: torch.empty((cap,) + (() if w is None else (w,)), dtype=d,
                            pin_memory=self.pin)
             for k, (d, w) in self.cols.items()}
        for k in t:
            if used:
                t[k][:used] = self.t[k][:used]
        self.t = t
        self.np = {k: v.numpy() for k, v in t.items()}

    def add(self, **arrays) -> None:
        """Append one frame's rows (every column, the same row count; the
        frame may have none)."""
        used = self.off[-1]
        n = len(next(iter(arrays.values())))
        if used + n > len(self.np[next(iter(self.np))]):
            self._alloc(2 * (used + n))
        for k, a in arrays.items():
            self.np[k][used:used + n] = a
        self.off.append(used + n)

    def upload(self, dev):
        """(frame offsets, {name: device tensor}) of the window so far; the
        next window starts empty."""
        off, used = self.off, self.off[-1]
        self.off = [0]
        return off, {k: v[:used].to(dev, non_blocking=True)
                     for k, v in self.t.items()}


# the noise branch's comb filter: gains 0, so it passes the signal through
_NO_COMB = (15, 15, 0, 0, 0, 0) * 2
_LOSS_COUNT_WORD = CeltHostState.loss_count.offset // 4


def _lcg_tables(n: int):
    """(A, B) uint64 with lcg^d(s) = (A[d] s + B[d]) mod 2^32, d < n + 1:
    the LCG's d-th draw from any seed in one step."""
    ab = np.zeros((n + 1, 2), dtype=np.uint64)  # lcg^d(0), lcg^d(1)
    ab[0, 1] = 1
    for d in range(1, n + 1):
        ab[d] = celt_lcg_rand(ab[d - 1])
    return (ab[:, 1] - ab[:, 0]) & 0xFFFFFFFF, ab[:, 0]


_LCG = _lcg_tables(2 * 960)


def celt_noise_rows(sts, cnts, ends, CC: int, N: int, LM: int,
                    start: int = 0):
    """libopus celt_decode_lost's noise branch for R streams of one lane
    (the JAX pool's _celt_noise_si): decay each host state's oldBandE
    over bands start..end toward backgroundLogE (1.5 dB on a first
    conceal, then 0.5 dB), fill bands start..end of each of the CC
    channels with LCG noise from the state's rng, in order, renormalised
    band by band, and advance the rng. start is 0 for a CELT stream and
    17 for the high band of a hybrid one (libopus takes this branch
    whenever start != 0). sts: the CeltHostStates; cnts: their conceals
    since the last good frame; ends: their end bands. The frame then runs
    through the normal synthesis with C = CC and no comb filter
    (_NO_COMB). Returns (X (R, CC * N) int16, bandE (R, 42) int16)."""
    R = len(sts)
    X = np.zeros((R, CC, N), dtype=np.int64)
    bandE = np.zeros((R, 2 * NB_EBANDS), dtype=np.int16)
    if R == 0:
        return X.reshape(0, CC * N).astype(np.int16), bandE
    A, B = _LCG
    for r, (st, cnt, end) in enumerate(zip(sts, cnts, ends)):
        old = np.ctypeslib.as_array(st.oldBandE)
        bg = np.ctypeslib.as_array(st.backgroundLogE)
        for c in range(CC):
            band = slice(c * NB_EBANDS + start, c * NB_EBANDS + end)
            old[band] = np.maximum(bg[band], old[band].astype(np.int32)
                                   - (1536 if cnt == 0 else 512))
        lo = int(EB[start]) << LM
        M = max(0, (int(EB[end]) << LM) - lo)     # draws a channel
        seeds = (A[1:CC * M + 1] * np.uint64(st.rng)
                 + B[1:CC * M + 1]) & np.uint64(0xFFFFFFFF)
        if seeds.size:
            st.rng = int(seeds[-1])
        X[r, :, lo:lo + M] = (seeds.astype(np.uint32).view(np.int32)
                              >> 20).reshape(CC, M)
        bandE[r] = old
    # renormalise band by band, the bands of one width together (a band
    # past a row's end band is zero and stays so)
    for w in np.unique(np.diff(EB)):
        idx = np.concatenate([np.arange(int(EB[b]) << LM, int(EB[b + 1]) << LM)
                              for b in range(NB_EBANDS)
                              if EB[b + 1] - EB[b] == w])
        v = X[:, :, idx].reshape(R, CC, -1, int(w) << LM)
        renormalise_vector(v, int(w) << LM, 32767)
        X[:, :, idx] = v.reshape(R, CC, -1)
    return X.reshape(R, CC * N).astype(np.int16), bandE


class _CeltLane(_Lane):
    """The CELT streams of one frame size N = 120 << LM and one coded
    channel count C, transposed state (models/celt_pool_T.py); `ends` is
    each stream's end band. In a pool that conceals (rfc_plc) the state
    also holds the carried pitch and LPC fit of the pitch branch, and the
    host keeps each stream's conceal count, its skip flag (the first good
    frame after a loss run sets it, the second clears it) and whether the
    previous step concealed it by pitch; a window collects its pitch
    rows, and its noise rows of another channel count, compact."""

    kind = "celt"
    transposed = True

    def __init__(self, pool, LM: int, C: int, idxs, ends, start: int = 0,
                 table=None):
        self.LM, self.N = LM, SHORT_MDCT_SIZE << LM
        self.start = start
        g = hg.CeltGroup(idxs, [pool.streams[i].jobs for i in idxs], self.N,
                         pool.channels, start, ends, C=C, table=table)
        self.C = g.C
        super().__init__(pool, g, idxs,
                         _CELT_HDR + 2 * NB_EBANDS + g.C * self.N,
                         torch.int16)
        CC = pool.channels
        self.state = {
            "decode_mem": torch.zeros(
                (CC, DECODE_BUFFER_SIZE + OVERLAP, self.n),
                dtype=torch.int32, device=pool.device),
            "preemph": torch.zeros((self.n, CC), dtype=torch.int32,
                                   device=pool.device),
        }
        self.bucket = ("celtT", LM, self.C, CC, self.n)
        # the routing buffer: a window frame's rows cut stream-major
        self.cut_buf = np.empty((self.n * self.N, CC), dtype=np.int16)
        self.cut_off = np.empty(self.n + 1, dtype=np.int64)
        self.plc = pool.rfc_plc
        if self.plc:
            self.state["plc_pitch"] = torch.zeros(
                self.n, dtype=torch.int32, device=pool.device)
            self.state["plc_lpc"] = torch.zeros(
                (self.n, CC, LPC_ORDER), dtype=torch.float32,
                device=pool.device)
            self.loss_cnt = np.zeros(self.n, dtype=np.int32)
            self.skip = np.zeros(self.n, dtype=bool)
            self.prev_pitch = np.zeros(self.n, dtype=bool)
            # the native state's loss_count: its next good decode reads it
            # (the background energy's step after a long loss run)
            self.native_cnt = g.states.buf.view(np.int32)[:, _LOSS_COUNT_WORD]
            self.pitch_rows = _Pinned(pool._cuda, rows=(torch.int64, None),
                                      first=(torch.bool, None))
            self.noise_rows = None if self.C == CC else _Pinned(
                pool._cuda, rows=(torch.int64, None), stg=(
                    torch.int16, _CELT_HDR + 2 * NB_EBANDS + CC * self.N))

    def host_step(self, pos, ok, lost, fec):
        if not self.plc:
            return np.nonzero(ok)[0], [None], 0
        sel, info = self.conceal_step(ok, lost)
        return sel, [info], 0

    def conceal_step(self, ok, lost):
        """The conceal bookkeeping of one step after the batched symbol
        decode of the good rows `ok` (the JAX pool's, stream_pool.py:
        2187-2198 and 2438-2455): every good row sets its skip flag if it
        ends a loss run and clears it otherwise; each row in `lost` takes
        the noise branch after 5 conceals, while its skip flag is set, in
        a frame shorter than 20 ms or in a hybrid stream's high band
        (start 17), and the pitch branch otherwise.
        Returns (sel, info): every decoded or concealed row, and for
        `fill` the decoded rows, the noise rows with their staging
        contents and the pitch rows with their first-conceal flags."""
        good, gone = np.nonzero(ok)[0], np.nonzero(lost)[0]
        self.skip[good] = self.loss_cnt[good] > 0
        self.loss_cnt[good] = 0
        noisy = (self.loss_cnt[gone] >= 5) | self.skip[gone] | (
            self.N != 960) | (self.start != 0)
        pitch, noise = gone[~noisy], gone[noisy]
        g = self.group
        X, bandE = celt_noise_rows(
            [g.states[r] for r in noise.tolist()], self.loss_cnt[noise],
            np.minimum(g.ends[noise], NB_EBANDS), self.pool.channels, self.N,
            self.LM, self.start)
        first = ~self.prev_pitch[pitch]
        self.loss_cnt[gone] += 1
        self.native_cnt[gone] = self.loss_cnt[gone]
        self.prev_pitch[:] = False
        self.prev_pitch[pitch] = True
        return np.nonzero(ok | lost)[0], (good, (noise, X, bandE), pitch,
                                          first)

    def fill(self, stg, sel, info=None) -> bool:
        g = self.group
        stg[:] = 0
        rows = sel if info is None else info[0]
        p = g.params
        stg[rows, 2] = p[rows, 1]                       # transient
        stg[rows, 3] = g.start[rows]
        stg[rows, 4] = p[rows, 15]                      # end
        stg[rows, 5:17] = p[rows, 3:15]                 # comb1, comb2
        stg[rows, 17] = 1                               # active
        stg[rows, _CELT_HDR:_CELT_HDR + 2 * NB_EBANDS] = g.bandE[rows]
        stg[rows, _CELT_HDR + 2 * NB_EBANDS:] = g.X[rows]
        if info is None:
            return rows.size < self.n
        _, (noise, X, bandE), pitch, first = info
        if self.noise_rows is None:
            nstg, active = stg, rows.size + noise.size
            at = noise
        else:
            nstg, active = np.zeros((noise.size, self.noise_rows.np[
                "stg"].shape[1]), dtype=np.int16), rows.size
            at = np.arange(noise.size)
        nstg[at, 3] = self.start
        nstg[at, 4] = np.minimum(g.ends[noise], NB_EBANDS)
        nstg[at, 5:17] = _NO_COMB
        nstg[at, 17] = 1
        nstg[at, _CELT_HDR:_CELT_HDR + 2 * NB_EBANDS] = bandE
        nstg[at, _CELT_HDR + 2 * NB_EBANDS:] = X
        self.pitch_rows.add(rows=pitch, first=first)
        if self.noise_rows is not None:
            self.noise_rows.add(rows=noise, stg=nstg)
        return active < self.n

    def upload_aux(self):
        if not self.plc:
            return None
        dev = self.pool.device
        offs, t = self.pitch_rows.upload(dev)
        if self.noise_rows is None:
            return (offs, t["rows"], t["first"], [0] * len(offs), None, None)
        noffs, nt = self.noise_rows.upload(dev)
        return (offs, t["rows"], t["first"], noffs, nt["rows"], nt["stg"])

    def run(self, stgK, masked, aux=None):
        st = self.state
        return celt_pool_superstep_T(
            st["decode_mem"], st["preemph"], stgK, LM=self.LM, C=self.C,
            CC=self.pool.channels, masked=masked, pitch=st.get("plc_pitch"),
            lpc=st.get("plc_lpc"), conceal=aux)

    def cut(self, frame, sel, lo, te):
        """Rows `sel` of a window frame (CC, N, n): row j's samples [lo[j],
        N - te[j]) as a (samples, CC) int16 chunk, cut stream-major into
        the lane's routing buffer in one native pass (host/native/
        route_entry.cpp, pcm_cut_T), then each copied out, so that no
        chunk keeps the buffer or the window alive. Returns (chunks,
        samples)."""
        off = self.cut_off[:len(sel) + 1]
        total = cut_T(frame, sel, lo, te, self.cut_buf, off)
        o, buf = off.tolist(), self.cut_buf
        return [buf[a:b].copy() for a, b in zip(o, o[1:])], total


class _SilkLane(_Lane):
    """The SILK streams of one class ("silk", fs, dfp, ms, frame_ms) or
    ("silk2", ...) (models/silk_pool.py): mono or stereo, internal rate
    fs, device frames of frame_ms (nb = 2 or 4 subframes), `dfp` device
    frames a packet (40/60 ms payloads and code-3 packets), each a frame
    of the K-frame window. The symbol phase of single-frame packets (and
    mono 40/60 ms ones) is the group's batch entry; code-3 packets and
    stereo multi-frame packets decode a row at a time through the
    group's per-stream hosts, as the JAX pool's _host_one does. The
    device frames' symbols sit in `fb`, one set of group-shaped buffers
    each (mono: _SilkBuffers; stereo: mid, side and the stereo info).

    In a pool that conceals (rfc_plc) every row and channel has a PLC
    tracker, the staging rows carry the conceal columns, and the frame-
    sized conceal inputs of the window's lost rows collect compact in
    `conceal` (`cx`: rand then cng_exc per lost channel row, `pos`: its
    bucket row). As the sub-lane of a hybrid lane (hybrid=True, fs 16) it
    is the SILK half of a hybrid stream."""

    kind = "silk"

    def __init__(self, pool, idxs, fs: int, dfp: int = 1, ms: int = 20,
                 frame_ms: int = 20, stereo: bool = False,
                 hybrid: bool = False, table=None):
        jobs = [pool.streams[i].jobs for i in idxs]
        self.fs, self.dfp, self.ms, self.stereo = fs, dfp, ms, stereo
        self.nb = frame_ms // 5
        self.frame_ms, self.hybrid = frame_ms, hybrid
        self.order = 16 if fs == 16 else 10
        self.frame = self.nb * 5 * fs
        self.N = 48 * frame_ms
        self.plc = pool.rfc_plc
        if stereo:
            g = hg.SilkStereoGroup(idxs, jobs, fs, hybrid=hybrid,
                                   frame_ms=frame_ms, table=table)
        else:
            g = hg.SilkGroup(idxs, jobs, fs, ms, hybrid=hybrid, table=table)
        # one frame a packet (mono: one payload of 1-3 internal frames)
        one = dfp // max(1, ms // 20) == 1
        self.batched = one and (not stereo or dfp == 1)
        n = len(idxs)
        if self.batched and dfp == 1:
            self.fb = [(g.mid, g.side, g.info) if stereo else g.buf]
        else:
            mk = lambda: hg._SilkBuffers(n, self.frame)
            self.fb = [(mk(), mk(), np.zeros((n, 8), dtype=np.int32))
                       if stereo else mk() for _ in range(dfp)]
        self.width1 = silk_pool.stage_width(self.frame, self.nb, self.plc,
                                            stereo)
        self.dummy = silk_pool.dummy_row(fs, self.nb, self.plc, stereo)
        super().__init__(pool, g, idxs, self.width1 * (2 if stereo else 1),
                         torch.int32)
        self.state = silk_pool.make_bucket(self.n, fs, pool.device, stereo)
        self.bucket = ("silk2" if stereo else "silk", fs, frame_ms, dfp,
                       self.n)
        self.glue: list[bool] = []
        if self.plc:
            self.trk = [TrackerArray(n, fs, frame_ms)
                        for _ in range(2 if stereo else 1)]
            # each stream's predictors of its last good frame: a
            # concealed frame unmixes with them (silk_Decode's lost
            # branch keeps sStereo.pred)
            self.last_pred = np.zeros((n, 2), dtype=np.int32)
            self.conceal = _Pinned(pool._cuda, pos=(torch.int64, None),
                                   cx=(torch.int32, 2 * self.frame))

    def decode(self, pos, active):
        g = self.group
        if self.batched:
            ok = g.decode(pos, active)
            if self.dfp > 1:      # a mono 40/60 ms payload's frames
                F, b = self.frame, g.buf
                for j, fb in enumerate(self.fb):
                    fb.exc[:] = b.exc[:, j * F:(j + 1) * F]
                    for name, _ in hg._SILK_COL_SPECS:
                        getattr(fb, name)[:] = getattr(b, name)[:, j]
            return ok
        ok = g.table.row_args(pos, active)[2]
        for r in np.nonzero(ok)[0].tolist():
            frames = parse_packet(self.pool.streams[self.idxs[r]].jobs[
                int(pos[r])].data).frames
            h = g.hosts[r]
            if self.stereo:
                sps = [sp for fr in frames
                       for sp in h.packet_multi(fr, self.fs, self.ms)]
                for (mid, side, info), sp in zip(self.fb, sps):
                    hg.put_stereo(mid, side, info, r, sp)
            else:
                ps = [p for fr in frames
                      for p in h.packet(fr, self.fs, self.ms)]
                for fb, p in zip(self.fb, ps):
                    hg.put_row(fb, r, p)
        return ok

    def _put_frame(self, r: int, p) -> None:
        """A lost row's single frame, recovered or decoded from an empty
        bitstream, into the first device frame's buffers."""
        if self.stereo:
            hg.put_stereo(*self.fb[0], r, p)
        else:
            hg.put_row(self.fb[0], r, p)

    def _good(self, rows) -> None:
        """Ingest the decoded rows of each device frame, in order, into
        their trackers: the post-loss transition on the buffers in place,
        then the tracker update; stereo: the side's partial reset where
        the side comes back, the side only where the frame has one, and
        the frame's predictors kept (the JAX pool's _track_stereo_good)."""
        for fb in self.fb:
            if not self.stereo:
                self.trk[0].good(rows, fb)
                continue
            mid, side, info = fb
            self.trk[1].side_reset(rows[info[rows, 1] != 0])
            mrows = rows[info[rows, 6] == 0]
            self.trk[0].good(mrows, mid)
            self.trk[1].good(rows[info[rows, 0] != 0], side)
            self.last_pred[mrows] = info[mrows, 3:5]

    def host_step(self, pos, ok, lost, fec):
        sel, infos, fec_rows, _, _ = self.loss_step(pos, ok, lost, fec)
        return sel, infos, len(fec_rows)

    def loss_step(self, pos, ok, lost, fec):
        """After the batched symbol decode of the good rows (`ok`):
        recover or prepare the rows in `lost` (fec: the rows among them
        that may take the next packet's LBRR copy, single-frame packets
        only; pos: every row's packet index), as the JAX pool's
        _host_one_lost. Returns (sel, infos, fec_rows, silk_only, mute):
        the rows that take part in the frames, for `fill` per device
        frame j (j, the decoded rows, their conceal preps by row, the
        glue flags of the decoded rows), the rows the LBRR copy
        recovered, the rows asked of an LBRR copy in all (a hybrid
        stream's output is then the SILK frame alone) and the
        compat-mode rows of a hybrid stream whose output is muted."""
        g, pool, fs = self.group, self.pool, self.fs
        decoded = ok.copy()
        preps = [{} for _ in range(self.dfp)]
        fec_rows, silk_only, mute = [], [], []
        # the glue flags (a channel's last frame was concealed), taken
        # before this step's conceals set them anew
        glue = np.stack([t.take_glue(np.arange(self.n)) for t in self.trk],
                        axis=1) if self.plc else None
        for r in np.nonzero(lost)[0].tolist():
            h, p = g.hosts[r], None
            want_fec = bool(fec[r]) and self.dfp == 1 and \
                pos[r] + 1 < g.table.n_packets[r]
            if want_fec:
                # the LBRR copy in the NEXT packet, which stays unread
                nxt = g.table.frame0(r, int(pos[r]) + 1)
                p = h.fec_packet(nxt, fs, payload_ms=self.frame_ms) \
                    if self.stereo else h.fec_frame(nxt, fs, self.frame_ms)
                if p is not None:
                    fec_rows.append(r)
                    silk_only.append(r)
            if p is None and pool.compat_ref:
                # compat: the normal frame over an empty bitstream (a
                # hybrid stream's CELT stage then fails: muted)
                p = h.packet(b"", fs) if self.stereo else \
                    h.frame(b"", fs, hybrid=self.hybrid)
                if self.hybrid:
                    mute.append(r)
            if p is not None:
                self._put_frame(r, p)
                decoded[r] = True
                if self.plc and self.stereo and p.get("side_conceal"):
                    # the LBRR copy has the mid only: the side conceals
                    preps[0][r] = (None, self.trk[1].prep(r), False)
                elif self.plc and self.stereo and p.get("mid_conceal"):
                    # the side only: the mid conceals
                    preps[0][r] = (self.trk[0].prep(r), None, False)
            elif self.plc:
                # one conceal per device frame, the loss count deepening;
                # a stereo side only where the previous frame had one
                side = self.stereo and not h.prev_dom
                # an FEC decode whose packet has no LBRR copy conceals as
                # silk_Decode at lostFlag 2 does: the gain index stays and
                # the frame is not mid-only, so a side the previous frame
                # lacked resets now (:378); a hybrid stream's output is
                # the SILK frame alone (the scalar decoder's decode_fec)
                reset = want_fec and self.stereo and bool(h.prev_dom)
                for pj in preps:
                    pj[r] = (self.trk[0].prep(r),
                             self.trk[1].prep(r) if side else None, reset)
                if want_fec:
                    silk_only.append(r)
                    if reset:
                        self.trk[1].side_reset([r])
                        st1 = h.st[1]
                        st1.lagPrev, st1.LastGainIndex = 100, 10
                        st1.prevSignalType = 0
                        st1.first_frame_after_reset = 1
                    if self.stereo:
                        h.prev_dom = 0
                else:
                    for st in (h.st if self.stereo else (h.st,)):
                        st.LastGainIndex = 10     # silk_Decode on loss
            else:
                raise NotImplementedError(
                    "a lost SILK packet in RFC mode needs rfc_plc=True")
        rows = np.nonzero(decoded)[0]
        if self.plc:
            self._good(rows)
            glue = glue[rows]
        infos = [(j, rows, preps[j], glue if j == 0 else None)
                 for j in range(self.dfp)]
        return (np.nonzero(decoded | lost)[0], infos, fec_rows, silk_only,
                mute)

    def fill(self, stg, sel, info=None) -> bool:
        j, rows, preps, glue = info if info is not None else (0, sel, {},
                                                              None)
        F, nb, W = self.frame, self.nb, self.width1
        s = stg.reshape(self.n, 2, W) if self.stereo else stg
        s[:] = self.dummy
        if self.stereo:
            mid, side, inf = self.fb[j]
            silk_pool.decode_cols(s[:, 0], rows[inf[rows, 6] == 0], mid, F,
                                  nb)
            srows = rows[inf[rows, 0] != 0]
            silk_pool.decode_cols(s[:, 1], srows, side, F, nb)
            s[:, 0, -5] = 1                           # has_ch: mid
            s[srows, 1, -5] = 1                       # has_ch: side
            s[rows, 1, -4] = inf[rows, 1]             # side_reset
            s[rows, 0, -3:-1] = inf[rows, 3:5]        # pred
        else:
            silk_pool.decode_cols(s, rows, self.fb[j], F, nb)
        s[sel, ..., -1] = 1                           # active
        if not self.plc:
            return sel.size < self.n
        q = silk_pool._decode_width(F, nb)
        if glue is not None:
            if self.stereo:
                s[rows, :, q] = glue
            else:
                s[rows, q] = glue[:, 0]
        self.glue.append(glue is not None and bool(glue.any()))
        pos, cx = [], []
        for r, (m, sd, reset) in preps.items():
            for c, prep in enumerate((m, sd)):
                if prep is None:
                    continue
                row = s[r, c] if self.stereo else s[r]
                row[q:q + silk_pool.PLC_COLS] = silk_pool.conceal_cols(prep)
                if self.stereo:
                    row[-5] = 1                       # has_ch
                pos.append(2 * r + c if self.stereo else r)
                cx.append(np.concatenate([prep["rand"], prep["cng_exc"]]))
            if self.stereo and m is not None:
                s[r, 0, -3:-1] = self.last_pred[r]
                s[r, 1, -4] |= reset                  # side_reset
        self.conceal.add(pos=pos, cx=np.reshape(cx, (len(pos), 2 * F)))
        return sel.size < self.n

    def upload_aux(self):
        if not self.plc:
            return None
        offs, t = self.conceal.upload(self.pool.device)
        return offs, t["pos"], t["cx"]

    def run(self, stgK, masked, aux=None):
        glue, self.glue = self.glue, []
        if not self.stereo:
            return silk_pool.silk_pool_superstep(
                self.state, stgK, fs=self.fs, nb=self.nb, order=self.order,
                masked=masked, glue=glue, conceal=aux)
        pcmK = silk_pool.silk_pool_superstep(
            self.state, stgK.view(stgK.shape[0], self.n, 2, self.width1),
            fs=self.fs, nb=self.nb, order=self.order, masked=masked,
            glue=glue, conceal=aux, stereo=True)
        # (K, n, L48, 2): L and R interleaved, as a stream's PCM is, so
        # the host takes each stream's rows as they are
        return pcmK.transpose(2, 3)

    def frames(self, frame, sel):
        """Frame (n, L48) or, stereo, (n, L48, 2) -> (len(sel), L48,
        channels)."""
        if self.stereo:
            return frame[sel]
        return frame[sel][:, :, None]


def hybrid_mix(pcm_c, pcm_s, mode):
    """The hybrid output of a window (the JAX pool's _hybrid_mix_step, the
    reference's mix src/opus_decoder.cpp:272), on the device: the CELT
    high band pcm_c (K, CC, N, n) and the SILK part pcm_s, (K, n, N) mono
    (added to every channel) or (K, n, N, 2), summed and saturated to
    int16. mode (K, n): 0 mixes, 1 keeps the SILK part alone (an FEC
    frame has no CELT layer), 2 mutes (a compat-mode lost frame, whose
    CELT stage fails). Returns (K, n, N, CC) int16."""
    c = pcm_c.permute(0, 3, 2, 1).to(I32)
    s = pcm_s[..., None] if pcm_s.dim() == 3 else pcm_s
    m = mode[:, :, None, None]
    out = (torch.where(m == 0, c, 0) + s).clamp_(-32768, 32767)
    return torch.where(m == 2, 0, out).to(torch.int16)


class _HybridLane(_Lane):
    """The hybrid streams of one class ("hybrid", end, frame_ms) or
    ("hybrid2", ...), any end band a stream: a SILK sub-lane at 16 kHz
    (mono or stereo, hybrid=True) and a CELT sub-lane from band 17 at LM
    3 (20 ms) or 2 (10 ms) whose symbol phase resumes the SILK group's
    range coder (the JAX pool's _hybrid1/2_pool_superstep). Each sub-lane
    stages its own rows and runs its own K-frame window; the lane's own
    staging is each row's mix mode, and its window ends with one
    `hybrid_mix` of both windows' PCM on the device, so a window is one
    fetch of the mixed PCM. A lost frame: compat mode, the SILK state
    advances over an empty bitstream and the output is muted, CELT left
    as it is; FEC, the SILK frame alone; rfc_plc, the SILK conceal plus
    CELT's noise branch from band 17, mixed."""

    kind = "hybrid"

    def __init__(self, pool, idxs, frame_ms: int, stereo: bool,
                 table=None):
        # both halves read the same packets: one FrameTable
        self.silk = _SilkLane(pool, idxs, 16, 1, frame_ms, frame_ms,
                              stereo=stereo, hybrid=True, table=table)
        self.celt = _CeltLane(pool, 3 if frame_ms == 20 else 2,
                              2 if stereo else 1, idxs,
                              [pool.path[i][1] for i in idxs], start=17,
                              table=self.silk.group.table)
        super().__init__(pool, self.silk.group, idxs, 1, torch.int8)
        self.N = 48 * frame_ms
        self.bucket = ("hybrid2" if stereo else "hybrid", frame_ms, self.n)

    def decode(self, pos, active):
        ok = self.silk.decode(pos, active)
        self.celt.group.decode(pos, ok, ec_in=self.silk.group.ec)
        return ok

    def host_step(self, pos, ok, lost, fec):
        sel, infos, fec_rows, silk_only, mute = self.silk.loss_step(
            pos, ok, lost, fec)
        conceal = lost.copy()
        conceal[silk_only + mute] = False
        if self.celt.plc:
            csel, cinfo = self.celt.conceal_step(ok, conceal)
        else:
            csel, cinfo = np.nonzero(ok)[0], None
        mode = np.zeros(self.n, dtype=np.int8)
        mode[silk_only] = 1
        mode[mute] = 2
        return sel, [(sel, infos[0], csel, cinfo, mode)], len(fec_rows)

    def fill(self, stg, sel, info=None) -> bool:
        if info is None:
            info = (sel, None, sel, None, np.zeros(self.n, dtype=np.int8))
        ssel, sinfo, csel, cinfo, mode = info
        self.silk.put(ssel, sinfo)
        self.celt.put(csel, cinfo)
        stg[:, 0] = mode
        return sel.size < self.n

    def upload_aux(self):
        dev, K = self.pool.device, len(self.masked)
        return (self.silk.stg[:K].to(dev, non_blocking=True),
                self.silk.upload_aux(),
                self.celt.stg[:K].to(dev, non_blocking=True),
                self.celt.upload_aux())

    def run(self, stgK, masked, aux=None):
        s_stg, s_aux, c_stg, c_aux = aux
        pcm_s = self.silk.run(s_stg, self.silk.masked, s_aux)
        pcm_c = self.celt.run(c_stg, self.celt.masked, c_aux)
        self.silk.masked, self.celt.masked = [], []
        return hybrid_mix(pcm_c, pcm_s, stgK[..., 0])

    def frames(self, frame, sel):
        """Frame (n, N, CC) -> (len(sel), N, CC)."""
        return frame[sel]


class StreamPool:
    def __init__(self, sources, channels: int = 1, native: bool = True,
                 compat_ref: bool = True, rfc_plc: bool = False,
                 output: str = "host", out_fs: int = 48000,
                 superstep_k: int = 1, device="cuda"):
        """sources: paths, bytes or parsed OggOpusStream objects (equal
        paths or bytes are parsed once).
        device: where the decoder state lives and the frame steps run.
        On "cuda" (the default) the steps launch the hand-written
        kernels; without a card that raises. On "cpu" every kernel's
        plain torch version runs."""
        self._rec = rec = spans.recorder()
        with rec.span("pool.build"):
            self._build(sources, channels, native, compat_ref, rfc_plc,
                        output, out_fs, superstep_k, device)

    def _build(self, sources, channels, native, compat_ref, rfc_plc,
               output, out_fs, superstep_k, device) -> None:
        """__init__'s work: the `classify`, `tables` and `lanes` spans."""
        rec = self._rec
        if channels < 1:
            raise ValueError("channels must be >= 1")
        if not native:
            raise _todo("the Python symbol phase (native=False)", "12b")
        if rfc_plc and compat_ref:
            raise ValueError("rfc_plc requires compat_ref=False")
        if output != "host":
            raise _todo("device-resident output", "12b")
        if out_fs != 48000:
            raise _todo("decimated output (out_fs < 48000)", "12b")
        if int(superstep_k) < 1:
            raise ValueError("superstep_k must be >= 1")
        self.device = resolve_device(device, "StreamPool")
        self._cuda = self.device.type == "cuda"
        with rec.span("classify"):
            parsed = {}
            self.streams = [self._parse(s, parsed) for s in sources]
            self.n = len(self.streams)
            if self.n == 0:
                raise ValueError("StreamPool needs at least one source")
            self.channels = channels
            self.compat_ref = compat_ref
            self.rfc_plc = rfc_plc
            self.path = [self._check_source(i, s)
                         for i, s in enumerate(self.streams)]
        if channels > 2 and any(k != ("ms",) for k in self.path):
            raise ValueError("channels > 2 takes multistream sources only")
        batched = {k[0] for k in self.path} - {"scalar", "ms"}
        if len(batched) > 1:
            raise _todo("a pool that mixes CELT and SILK streams", "12b")
        self._ss_k = int(superstep_k)
        self.positions = np.zeros(self.n, dtype=np.int64)
        self.pcm_out = [[] for _ in range(self.n)]
        # one lane per CELT (LM, coded channels), per SILK class or per
        # hybrid frame size, streams in index order (a CELT or hybrid
        # stream's end band is its row's own)
        by_key = collections.defaultdict(list)
        for i, k in enumerate(self.path):
            if k[0] in batched:
                by_key[k[:-1] if k[0] == "celt" else k[:1] + k[2:]
                       if k[0] in ("hybrid", "hybrid2") else k].append(i)
        keys = sorted(by_key.items())
        with rec.span("tables"):
            tables = [hg.FrameTable([self.streams[i].jobs for i in idxs])
                      for _, idxs in keys]
        self._lanes = []
        self._step_no = -1                 # the step running, or the last
        with rec.span("lanes"):
            for (key, idxs), table in zip(keys, tables):
                if key[0] == "celt":
                    lane = _CeltLane(self, key[1], key[2], idxs,
                                     [self.path[i][-1] for i in idxs],
                                     table=table)
                elif key[0] in ("silk", "silk2"):
                    lane = _SilkLane(self, idxs, *key[1:],
                                     stereo=key[0] == "silk2", table=table)
                else:
                    lane = _HybridLane(self, idxs, key[1],
                                       stereo=key[0] == "hybrid2",
                                       table=table)
                self._lanes.append(lane)
        # scalar and multistream rows: one host decoder each, made at its
        # stream's first packet and anew at each chain link
        self._scalar_rows = [i for i, k in enumerate(self.path)
                             if k in (("scalar",), ("ms",))]
        self._scalar_decs: dict[int, tuple] = {}
        self._stats = dict(steps=0, frames=0, bytes_in=0, samples_out=0,
                           frames_celt=0, frames_silk=0, frames_hybrid=0,
                           frames_scalar=0, frames_lost=0, frames_fec=0,
                           buckets={})
        self._phase_s = dict(host_symbol=0.0, dispatch=0.0,
                             materialize=0.0)
        # CUDA events around the frame steps of the latest windows
        self._win_events = collections.deque(maxlen=1024)
        # device work of step t is fetched at the end of step t+depth, so
        # the host symbol phases of the next steps overlap it; superstep
        # windows dispatch every K steps, so retirement lags K steps
        self.pipeline_depth = max(2, self._ss_k)
        self._pending: list[list] = []

    @property
    def state(self) -> dict:
        """The state (decode_mem, preemph) of a pool with one CELT lane."""
        lanes = [lane for lane in self._lanes if isinstance(lane, _CeltLane)]
        if len(lanes) != 1:
            raise ValueError(f"the pool has {len(lanes)} CELT lanes")
        return lanes[0].state

    @property
    def silk_buckets(self) -> dict:
        """The mono SILK lanes' states by internal rate (the JAX pool's
        silk_buckets; rows are the lane's streams in index order)."""
        return {lane.fs: lane.state for lane in self._lanes
                if isinstance(lane, _SilkLane) and not lane.stereo}

    @staticmethod
    def _parse(s, parsed: dict):
        """A source as an OggOpusStream. Equal paths or equal bytes are
        parsed once (`parsed` maps them to their stream) and share it."""
        if isinstance(s, opusfile.OggOpusStream):
            return s
        key = bytes(s) if isinstance(s, (bytes, bytearray)) else os.fspath(s)
        if key not in parsed:
            data = key if isinstance(key, bytes) else pathlib.Path(
                key).read_bytes()
            parsed[key] = opusfile.parse_stream(data)
        return parsed[key]

    def _check_source(self, i: int, s):
        """The stream's class, as the JAX pool's classification gives it
        (stream_pool.py:1284-1396 of the JAX package): ("ms",) for a
        multistream source, ("scalar",) for one its scalar decoders take,
        and for the lanes ("celt", LM, coded channels, end band), ("silk",
        fs, dfp, ms, frame_ms) or ("silk2", ...) (dfp device frames of
        frame_ms a packet, ms a frame of the packet), ("hybrid", end band,
        frame_ms) or ("hybrid2", ...); the CELT tuple keys by (LM, C)
        where the JAX pool's is ("celt", spf, end band)."""
        head = s.head
        if head is not None and (head.stream_count > 1
                                 or head.channel_count > 2):
            return ("ms",)
        if s.n_links > 1:
            return ("scalar",)
        kinds, fss, bws = set(), set(), set()
        for j in s.jobs:
            p0 = j.data[0]
            mode = Mode.CELT_ONLY if p0 & 0x80 else (
                Mode.HYBRID if (p0 & 0x60) == 0x60 else Mode.SILK_ONLY)
            kinds.add((mode, get_samples_per_frame(p0),
                       get_nb_frames(j.data), get_nb_channels(p0)))
            bw = int(get_bandwidth(p0))
            fss.add(_FS_OF_BW.get(bw, 16))
            bws.add(bw)
        if len(kinds) != 1:
            return ("scalar",)                 # mode-switching sources
        mode, spf, nfr, sch = next(iter(kinds))
        compat, ch = self.compat_ref, self.channels
        # compat mode decodes one 20 ms frame a packet (the reference
        # hard-codes audiosize 960) and pins end band 21
        # (src/celt.cpp:2199); RFC mode codes the real end band per
        # bandwidth, so a stream's bandwidth must not change
        one_bw = compat or len(bws) == 1
        if mode == Mode.CELT_ONLY:
            spf_ok = spf == 960 if compat else spf in _LM_OF_SPF
            if spf_ok and nfr == 1 and one_bw:
                end = 21 if compat else _ENDBAND_OF_BW[next(iter(bws))]
                return ("celt", _LM_OF_SPF[spf], sch, end)
            return ("scalar",)
        # SILK: compat mode decodes one 20 ms frame a packet; RFC mode 10,
        # 20, 40 and 60 ms payloads and code-3 packets of up to 120 ms
        # (stereo: 10 ms payloads one a packet); frame_ms is a device
        # frame's duration (10 for nb_subfr 2 payloads, else 20)
        frame_ms = 10 if spf == 480 else 20
        if mode == Mode.SILK_ONLY:
            if len(fss) != 1 or sch != ch:
                return ("scalar",)             # SILK bandwidth switches
            if sch == 1:
                ok = (spf == 960 and nfr == 1) if compat else (
                    spf in (480, 960, 1920, 2880) and spf * nfr <= 5760)
            else:
                ok = (spf == 960 and nfr == 1) if compat else (
                    (spf in (960, 1920, 2880) and spf * nfr <= 5760)
                    or (spf == 480 and nfr == 1))
            if not ok:
                return ("scalar",)
            return ("silk" if sch == 1 else "silk2", next(iter(fss)),
                    nfr * max(1, spf // 960), spf // 48, frame_ms)
        spf_ok = spf == 960 if compat else spf in (480, 960)
        if spf_ok and nfr == 1 and sch == ch and one_bw:
            end = 21 if compat else _ENDBAND_OF_BW[next(iter(bws))]
            return ("hybrid" if sch == 1 else "hybrid2", end, frame_ms)
        return ("scalar",)

    # ------------------------------------------------------------ steps
    def step(self, lost=None, fec=None) -> bool:
        """Decode one packet of every stream with a packet left. lost:
        stream indices whose next packet was lost in transit: it is
        consumed but not decoded. A lost CELT packet gives silence and
        leaves the stream's state untouched, or is concealed (rfc_plc); a
        lost SILK or hybrid packet is decoded over an empty bitstream
        (compat mode) or concealed (rfc_plc). fec: the subset of lost whose frame the NEXT packet's
        in-band SILK LBRR copy should reconstruct when it has one (that
        packet stays unread: the next step decodes it). Returns False
        once every stream is exhausted."""
        rec = self._rec
        self._step_no = sn = self._step_no + 1
        t0 = time.perf_counter()
        sp = rec.open("step", sn, -1, t0)
        try:
            lost = np.isin(np.arange(self.n), list(lost or ()))
            fec = np.isin(np.arange(self.n), list(fec or ())) & lost
            st, ph = self._stats, self._phase_s
            parts = []
            hs = rec.open("host_symbol", sn, -1, t0)
            for lane in self._lanes:
                g, idxs = lane.group, lane.idxs
                pos = self.positions[idxs]
                live = pos < g.table.n_packets
                if not live.any():
                    continue
                gone = live & lost[idxs]
                active = live & ~gone
                ok = active
                if active.any():
                    sym = rec.open("symbol", sn, lane.index)
                    ok = lane.decode(pos, active)
                    rec.close(sym, None, take_strips())
                dec = np.nonzero(ok)[0]
                st["bytes_in"] += int(g.table.pkt_bytes[dec, pos[dec]].sum())
                sel, infos, n_fec = lane.host_step(pos, ok, gone, fec[idxs])
                st["frames_fec"] += n_fec
                gone[sel] = False
                rows = np.nonzero(live)[0]
                st["frames"] += rows.size
                st[f"frames_{lane.kind}"] += rows.size
                st["frames_lost"] += int((live & lost[idxs]).sum())
                part = dict(lane=lane, sel=sel, lost=np.nonzero(gone)[0],
                            rows=rows, disc=g.table.disc[rows, pos[rows]],
                            trim=g.table.trim[rows, pos[rows]], wins=[])
                self.positions[idxs[live]] += 1
                if sel.size:
                    t1 = rec.close(hs)
                    ph["host_symbol"] += t1 - t0
                    d = rec.open("dispatch", sn, -1, t1)
                    # a packet of dfp device frames stages dfp window frames
                    for info in infos:
                        part["wins"].append(lane.stage(sel, info))
                    st["buckets"][lane.bucket] = st["buckets"].get(
                        lane.bucket, 0) + len(infos)
                    t0 = rec.close(d)
                    ph["dispatch"] += t0 - t1
                    hs = rec.open("host_symbol", sn, -1, t0)
                parts.append(part)
            if self._scalar_rows:
                part = self._scalar_step(lost)
                if part["direct"]:
                    parts.append(part)
            t1 = rec.close(hs)
            ph["host_symbol"] += t1 - t0
            if parts:
                st["steps"] += 1
                self._pending.append(parts)
                m = rec.open("materialize", sn, -1, t1)
                while len(self._pending) > self.pipeline_depth:
                    self._route(self._pending.pop(0))
                ph["materialize"] += rec.close(m) - t1
        finally:
            rec.close(sp)
        if not parts:
            self._flush()
        return bool(parts)

    def _scalar_decoder(self, i: int, link: int):
        """Row i's host decoder for chain link `link`: an OpusMSDecoder
        for a multistream source, else an OpusDecoder at the pool's
        channels; a fresh one at each link (op_make_decode_ready,
        src/opusfile.cpp:671)."""
        dec = self._scalar_decs.get(i)
        if dec is None or dec[0] != link:
            s = self.streams[i]
            if self.path[i] == ("ms",):
                heads = s.link_heads or [s.head]
                h = heads[min(link, len(heads) - 1)]
                d = OpusMSDecoder(h.channel_count, h.stream_count,
                                  h.coupled_count, h.mapping,
                                  compat_ref=self.compat_ref,
                                  device=self.device)
            else:
                d = OpusDecoder(self.channels, compat_ref=self.compat_ref,
                                device=self.device)
            dec = self._scalar_decs[i] = (link, d)
        return dec[1]

    def _scalar_step(self, lost) -> dict:
        """One packet of every scalar and multistream row with a packet
        left, decoded on the host (the JAX pool's _host_one and, for a
        lost packet, _host_one_lost: the decoder's own loss path, or
        silence where that raises). Returns the step's part: (row, PCM,
        pre-skip, end-trim) in `direct`."""
        st = self._stats
        out = []
        for i in self._scalar_rows:
            jobs = self.streams[i].jobs
            k = int(self.positions[i])
            if k >= len(jobs):
                continue
            job = jobs[k]
            self.positions[i] += 1
            ms = self.path[i] == ("ms",)
            # a lost packet of a scalar row keeps the decoder of the link
            # so far, as the JAX pool's _host_one_lost
            link = job.link if ms or not lost[i] else \
                self._scalar_decs.get(i, (0,))[0]
            dec = self._scalar_decoder(i, link)
            try:
                pcm = dec.decode(None if lost[i] else job.data)
            except ValueError:
                if ms or not lost[i]:
                    raise
                pcm = np.zeros((960, self.channels), dtype=np.int16)
            st["frames"] += 1
            st["frames_scalar"] += 1
            if lost[i]:
                st["frames_lost"] += 1
            else:
                st["bytes_in"] += len(job.data)
            out.append((i, pcm, job.discard_front, job.trim_end))
        return dict(lane=None, direct=out)

    def _route(self, parts) -> None:
        """Trim and append one step's PCM per stream (a lost CELT frame
        that is not concealed as N samples of silence, N the lane's frame
        size; a scalar row's PCM as its decoder gave it): a `fetch_wait`
        span for the wait for the part's windows, a `route` span for the
        rest. A transposed frame (a CELT lane's) is cut by the lane's
        native pass, counted in `route.rows_native`; a stream-major one,
        lost and scalar rows a row at a time, in `route.rows_numpy`;
        `route.rows_trimmed` counts the rows with a pre-skip or
        end-trim."""
        rec, sn, out = self._rec, self._step_no, self.pcm_out
        for p in parts:
            if p["lane"] is None:
                rs = rec.open("route", sn)
                for i, pcm, lo, te in p["direct"]:
                    out[i].append(self._trim(pcm, lo, te))
                rec.count("route.rows_numpy", len(p["direct"]))
                rec.count("route.rows_trimmed", sum(
                    1 for d in p["direct"] if d[2] or d[3]))
                rec.close(rs)
                continue
            lane, sel, lost = p["lane"], p["sel"], p["lost"]
            if sel.size:
                fw = rec.open("fetch_wait", sn, lane.index)
                frames = [win.host()[k] for win, k in p["wins"]]
                rec.close(fw)
            rs = rec.open("route", sn, lane.index)
            idxs = lane.idxs
            # each row's pre-skip and end-trim (p["rows"] is sorted)
            at = np.searchsorted(p["rows"], sel)
            lo, te = p["disc"][at], p["trim"][at]
            if sel.size and lane.transposed:
                (frame,) = frames
                chunks, n_out = lane.cut(frame, sel, lo, te)
                for i, c in zip(idxs[sel].tolist(), chunks):
                    out[i].append(c)
                self._stats["samples_out"] += n_out
                rec.count("route.rows_native", sel.size)
            elif sel.size:
                blks = [lane.frames(f, sel) for f in frames]
                blk = blks[0] if len(blks) == 1 else np.concatenate(blks,
                                                                    axis=1)
                for pcm, i, a, t in zip(blk, idxs[sel].tolist(),
                                        lo.tolist(), te.tolist()):
                    out[i].append(self._trim(pcm, a, t))
                rec.count("route.rows_numpy", sel.size)
            at = np.searchsorted(p["rows"], lost)
            lo_l, te_l = p["disc"][at], p["trim"][at]
            for i, a, t in zip(idxs[lost].tolist(), lo_l.tolist(),
                               te_l.tolist()):
                out[i].append(self._trim(
                    np.zeros((lane.N, self.channels), dtype=np.int16), a, t))
            rec.count("route.rows_numpy", lost.size)
            rec.count("route.rows_trimmed", int(np.count_nonzero(lo | te))
                      + int(np.count_nonzero(lo_l | te_l)))
            rec.close(rs)

    def _trim(self, pcm, lo: int, te: int):
        # a copy, so the stream's PCM keeps no window buffer, nor the
        # step's block of rows, alive
        hi = pcm.shape[0] - te
        out = pcm[lo:max(hi, lo)].copy()
        self._stats["samples_out"] += out.shape[0]
        return out

    def _flush(self) -> None:
        """Dispatch every partial window and retire every pending step
        (a step of its own on the recorder)."""
        rec, ph = self._rec, self._phase_s
        self._step_no = sn = self._step_no + 1
        t0 = time.perf_counter()
        sp = rec.open("step", sn, -1, t0)
        try:
            d = rec.open("dispatch", sn, -1, t0)
            for lane in self._lanes:
                if lane.masked:
                    lane.dispatch()
            t1 = rec.close(d)
            ph["dispatch"] += t1 - t0
            m = rec.open("materialize", sn, -1, t1)
            pends, self._pending = self._pending, []
            for p in pends:
                self._route(p)
            ph["materialize"] += rec.close(m) - t1
        finally:
            rec.close(sp)

    def stats(self) -> dict:
        """Decode counters (stream_pool.py:4456-4470 of the JAX package):
        steps, frames, bytes_in (of the packets decoded), samples_out,
        frames per kind (stereo SILK counts as silk, as in the JAX pool;
        frames_scalar counts the scalar and multistream rows' frames),
        frames_lost, frames_fec (lost frames the next
        packet's LBRR copy recovered), buckets (device frames by lane:
        ("celtT", LM, C, CC, rows), ("silk" or "silk2", fs, frame_ms,
        dfp, rows) or ("hybrid" or "hybrid2", frame_ms, rows)), phase_s,
        streams and active_streams. Flushes the pipeline first."""
        self._flush()
        active = int(sum(int(p) < len(s.jobs)
                         for p, s in zip(self.positions, self.streams)))
        return dict(self._stats, buckets=dict(self._stats["buckets"]),
                    phase_s=dict(self._phase_s), streams=self.n,
                    active_streams=active)

    def window_device_ms(self):
        """(frames, device ms) of the latest 1024 windows dispatched, from
        CUDA events around their frame steps (empty off CUDA)."""
        out = []
        for k, t0, t1 in self._win_events:
            t1.synchronize()
            out.append((k, t0.elapsed_time(t1)))
        return out

    def run(self, loss=None, fec=False):
        """Decode everything; returns a list of (n_i, channels) int16.
        loss: optional callable (stream_idx, packet_idx) -> bool marking
        packets lost in transit (see step). fec=True reconstructs a lost
        SILK frame from the next packet's in-band LBRR copy when that
        packet arrived (exists and was not itself lost)."""
        while True:
            lost, fec_set = set(), set()
            if loss is not None:
                for i in range(self.n):
                    k = int(self.positions[i])
                    n = len(self.streams[i].jobs)
                    if k >= n or not loss(i, k):
                        continue
                    lost.add(i)
                    if fec and k + 1 < n and not loss(i, k + 1):
                        fec_set.add(i)
            if not self.step(lost, fec_set):
                break
        return self.collected()

    def collected(self):
        """PCM accumulated so far per stream (without clearing): flushes
        the pipeline first."""
        self._flush()
        return [np.concatenate(p) if p else
                np.zeros((0, self.channels), dtype=np.int16)
                for p in self.pcm_out]
