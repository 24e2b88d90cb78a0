"""StreamPool: decode many concurrent Ogg/Opus streams with torch.

Port of the CELT transposed ("T-mode") path and the mono SILK path of
esp32_opus_player_tpu/models/stream_pool.py. The streams fall into
lanes: one CELT lane per frame size (LM 0-3) and coded channel count
(the JAX pool's (LM, C) superstep keys), or one SILK lane per internal
rate (8, 12, 16 kHz), each a device bucket of its streams in row order
with its own state and its own K-frame window. Per step, for each lane:

1. host: the batched native symbol phase over its streams with a packet
   left (models/host_groups.py, the port's copy);
2. one packed staging row per stream: int16 for CELT
   (models/celt_pool_T.py), int32 for SILK (models/silk_pool.py);
3. device: one whole-lane frame step, or with superstep_k = K one
   K-frame window run as a unit: one upload, K frame steps, one PCM
   fetch;
4. host: the PCM is fetched `pipeline_depth` steps later (the device
   works while the next steps' symbol phases run), trimmed (pre-skip,
   end-trim) and appended per stream.

Supported: CELT-only streams with one frame per packet, channels 1 or
2: in compat mode (compat_ref=True) 20 ms frames only; in RFC mode
2.5, 5, 10 and 20 ms frames at any one bandwidth per stream (the end
band per bandwidth, _ENDBAND_OF_BW); mono SILK-only streams with one 20
ms frame per packet at a constant bandwidth, channels 1. Both with
superstep_k >= 1, out_fs 48000, output "host".

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
("celt", LM, coded channels, end band), ("silk", fs), ("scalar",) or
("ms",).

stats() gives the JAX pool's counters, and _phase_s its per-phase host
wall time (seconds): host_symbol (the batched symbol phase and, for
lost SILK rows, the conceal preps and FEC decodes), dispatch (staging
and the device enqueues), materialize (the PCM fetch and the routing to
the streams). _fetch_s is the part of materialize spent in the fetch
itself, _Window.host(): the wait for the window's frame steps and its
copy to the host.

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
then comfort noise, K9), as a row of the same window frame as the
step's decoded rows, and the first good frame after a loss run is
glue-smoothed; with fec, in both modes, the lost frame is decoded from
the next packet's in-band LBRR copy when that packet has one.
Every stream the JAX pool batches on a path the port lacks (stereo
SILK, hybrid, RFC-mode SILK of 10, 40 or 60 ms or code-3 packets), and
every option the port lacks, raises NotImplementedError naming the
ROADMAP.md item that brings it.
"""
from __future__ import annotations

import collections
import os
import pathlib
import time

import numpy as np
import torch

from ..host import opusfile
from ..host.native import CeltHostState, PlcTrackerState, StateArray
from ..host.packet import (Mode, get_bandwidth, get_nb_channels,
                           get_nb_frames, get_samples_per_frame)
from ..ops.celt.math import celt_lcg_rand
from ..ops.celt.pvq import renormalise_vector
from ..ops.celt.torch_plc import LPC_ORDER
from ..ops.celt.torch_synthesis import (DECODE_BUFFER_SIZE, EB, NB_EBANDS,
                                        OVERLAP, SHORT_MDCT_SIZE)
from ..utils.device import resolve_device
from . import host_groups as hg
from . import silk_pool
from .batch_silk import LAST_LOST_WORD, NativePlcTracker, good_frames
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

    def __init__(self, pool, group, idxs, width: int, dtype):
        self.pool = pool
        self.group = group
        self.idxs = np.asarray(idxs, dtype=np.int64)
        self.n = len(self.idxs)
        self.stg = torch.zeros((pool._ss_k, self.n, width), dtype=dtype,
                               device="cpu", pin_memory=pool._cuda)
        self.stg_np = self.stg.numpy()
        self.stg_free = None      # event after the last upload out of stg
        self.masked: list[bool] = []
        self.win = _Window(self)

    def stage(self, sel, info=None):
        """Write this step's staging frame (rows `sel` take part, the
        rest are inactive; `info` is the lane's own per-step data) and
        dispatch the window once it holds K frames. `fill` says whether
        the frame has inactive rows (it is masked). Returns (window,
        frame index) of the frame."""
        if not self.masked and self.stg_free is not None:
            self.stg_free.synchronize()
        win, k = self.win, len(self.masked)
        self.masked.append(self.fill(self.stg_np[k], sel, info))
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


def celt_noise_rows(sts, cnts, ends, CC: int, N: int, LM: int):
    """libopus celt_decode_lost's noise branch for R streams of one lane
    (the JAX pool's _celt_noise_si, start band 0): decay each host
    state's oldBandE toward backgroundLogE (1.5 dB on a first conceal,
    then 0.5 dB), fill bands 0..end of each of the CC channels with LCG
    noise from the state's rng, in order, renormalised band by band, and
    advance the rng. sts: the CeltHostStates; cnts: their conceals since
    the last good frame; ends: their end bands. The frame then runs
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
            band = slice(c * NB_EBANDS, c * NB_EBANDS + end)
            old[band] = np.maximum(bg[band], old[band].astype(np.int32)
                                   - (1536 if cnt == 0 else 512))
        M = int(EB[end]) << LM               # draws a channel
        seeds = (A[1:CC * M + 1] * np.uint64(st.rng)
                 + B[1:CC * M + 1]) & np.uint64(0xFFFFFFFF)
        if seeds.size:
            st.rng = int(seeds[-1])
        X[r, :, :M] = (seeds.astype(np.uint32).view(np.int32)
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

    def __init__(self, pool, LM: int, C: int, idxs, ends):
        self.LM, self.N = LM, SHORT_MDCT_SIZE << LM
        g = hg.CeltGroup(idxs, [pool.streams[i].jobs for i in idxs], self.N,
                         pool.channels, 0, ends, C=C)
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

    def host_step(self, ok, lost):
        """The conceal bookkeeping of one step after the batched symbol
        decode of the good rows `ok` (the JAX pool's, stream_pool.py:
        2187-2198 and 2438-2455): every good row sets its skip flag if it
        ends a loss run and clears it otherwise; each row in `lost` takes
        the noise branch after 5 conceals, while its skip flag is set, or
        in a frame shorter than 20 ms, and the pitch branch otherwise.
        Returns (sel, info): every decoded or concealed row, and for
        `fill` the decoded rows, the noise rows with their staging
        contents and the pitch rows with their first-conceal flags."""
        good, gone = np.nonzero(ok)[0], np.nonzero(lost)[0]
        self.skip[good] = self.loss_cnt[good] > 0
        self.loss_cnt[good] = 0
        noisy = (self.loss_cnt[gone] >= 5) | self.skip[gone] | (self.N != 960)
        pitch, noise = gone[~noisy], gone[noisy]
        g = self.group
        X, bandE = celt_noise_rows(
            [g.states[r] for r in noise.tolist()], self.loss_cnt[noise],
            np.minimum(g.ends[noise], NB_EBANDS), self.pool.channels, self.N,
            self.LM)
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

    @staticmethod
    def frames(frame, sel):
        """Frame (CC, N, n) -> (len(sel), N, CC)."""
        return frame[:, :, sel].transpose(2, 1, 0)


class _SilkLane(_Lane):
    """Mono SILK streams at one internal rate fs, 20 ms frames
    (models/silk_pool.py). In a pool that conceals (rfc_plc) every row
    has a PLC tracker, the staging rows carry the conceal columns, and
    the frame-sized conceal inputs of the window's lost rows collect
    compact in `conceal` (`cx`: rand then cng_exc per lost row, `pos`:
    its bucket row)."""

    NB = 4
    kind = "silk"

    def __init__(self, pool, fs: int, idxs):
        g = hg.SilkGroup(idxs, [pool.streams[i].jobs for i in idxs], fs, 20)
        self.fs = fs
        self.order = 16 if fs == 16 else 10
        self.frame = self.NB * 5 * fs
        self.plc = pool.rfc_plc
        self.dummy = silk_pool.dummy_row(fs, self.NB, self.plc)
        super().__init__(pool, g, idxs,
                         silk_pool.stage_width(self.frame, self.NB, self.plc),
                         torch.int32)
        self.state = silk_pool.make_bucket(self.n, fs, pool.device)
        self.bucket = ("silk", fs, 20, 1, self.n)
        self.glue: list[bool] = []
        if self.plc:
            self.trk_states = StateArray(self.n, PlcTrackerState)
            self.trackers = [NativePlcTracker(fs, 20, st=v)
                             for v in self.trk_states.views]
            self.last_lost = self.trk_states.buf.view(np.int32)[
                :, LAST_LOST_WORD]
            self.conceal = _Pinned(pool._cuda, pos=(torch.int64, None),
                                   cx=(torch.int32, 2 * self.frame))

    def host_step(self, pos, ok, lost, fec):
        """The host work of one step after the batched symbol decode of
        the good rows (`ok`): recover or prepare the rows in `lost` (fec:
        the rows among them that may take the next packet's LBRR copy;
        pos: every row's packet index). Returns (sel, info, n_fec): the
        rows that take part in the frame, for `fill` the conceal preps by
        row and the glue flags of the decoded rows, and the number of
        lost rows the LBRR copy recovered."""
        g, pool = self.group, self.pool
        decoded = ok.copy()
        preps = {}
        n_fec = 0
        for r in np.nonzero(lost)[0].tolist():
            p = None
            if fec[r] and pos[r] + 1 < g.table.n_packets[r]:
                # the LBRR copy in the NEXT packet, which stays unread
                p = g.hosts[r].fec_frame(g.frame0(r, int(pos[r]) + 1),
                                         self.fs, 20)
                n_fec += p is not None
            if p is None and pool.compat_ref:
                # compat: the normal frame path over an empty bitstream
                p = g.hosts[r].frame(b"", self.fs)
            if p is not None:
                g.put_row(r, p)
                decoded[r] = True
            elif self.plc:
                preps[r] = self.trackers[r].conceal_prep()
                g.hosts[r].st.LastGainIndex = 10   # silk_Decode on loss
            else:
                raise NotImplementedError(
                    "a lost SILK packet in RFC mode needs rfc_plc=True")
        rows = np.nonzero(decoded)[0]
        glue = None
        if self.plc:
            # the post-loss transition (on the group buffers, in place)
            # and the tracker update of every decoded or FEC row
            good_frames(self.trk_states, rows, g.buf)
            glue = self.last_lost[rows]
            self.last_lost[rows] = 0
        return np.nonzero(decoded | lost)[0], (rows, preps, glue), n_fec

    def fill(self, stg, sel, info=None) -> bool:
        b, F = self.group.buf, self.frame
        rows, preps, glue = info if info is not None else (sel, {}, None)
        p = F + 32 + 5 * self.NB
        stg[:] = self.dummy
        stg[rows, :F] = b.exc[rows]
        stg[rows, F:F + 32] = b.A[rows].reshape(-1, 32)
        stg[rows, F + 32:p] = b.B[rows].reshape(-1, 5 * self.NB)
        for j, col in enumerate((b.gains, b.inv, b.lag, b.adj)):
            stg[rows, p + 4 * j:p + 4 * j + 4] = col[rows]
        stg[rows, p + 16:p + 28] = b.flags[rows]  # voiced, rewhiten, match
        stg[sel, -1] = 1                          # active
        if not self.plc:
            return sel.size < self.n
        q = p + 7 * self.NB
        stg[rows, q] = glue
        self.glue.append(bool(glue.any()))
        for r, prep in preps.items():
            stg[r, q:q + silk_pool.PLC_COLS] = silk_pool.conceal_cols(prep)
        self.conceal.add(pos=list(preps), cx=np.reshape(
            [np.concatenate([v["rand"], v["cng_exc"]]) for v in
             preps.values()], (len(preps), 2 * F)))
        return sel.size < self.n

    def upload_aux(self):
        if not self.plc:
            return None
        offs, t = self.conceal.upload(self.pool.device)
        return offs, t["pos"], t["cx"]

    def run(self, stgK, masked, aux=None):
        glue, self.glue = self.glue, []
        return silk_pool.silk_pool_superstep(
            self.state, stgK, fs=self.fs, nb=self.NB, order=self.order,
            masked=masked, glue=glue, conceal=aux)

    @staticmethod
    def frames(frame, sel):
        """Frame (n, L48) -> (len(sel), L48, 1)."""
        return frame[sel][:, :, None]


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
        # one lane per CELT (LM, coded channels) or SILK rate, streams in
        # index order
        by_key = collections.defaultdict(list)
        for i, k in enumerate(self.path):
            if k[0] in batched:
                by_key[k[:-1] if k[0] == "celt" else k].append(i)
        if batched == {"celt"}:
            self._lanes = [_CeltLane(self, LM, C, idxs,
                                     [self.path[i][-1] for i in idxs])
                           for (_, LM, C), idxs in sorted(by_key.items())]
        else:
            self._lanes = [_SilkLane(self, fs, idxs)
                           for (_, fs), idxs in sorted(by_key.items())]
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
        self._fetch_s = 0.0
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
        """The SILK lanes' states by internal rate (the JAX pool's
        silk_buckets; rows are the lane's streams in index order)."""
        return {lane.fs: lane.state for lane in self._lanes
                if isinstance(lane, _SilkLane)}

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
        ("celt", LM, coded channels, end band) or ("silk", fs) for the
        lanes; raises for the batched kinds the port lacks."""
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
        if mode == Mode.SILK_ONLY:
            if len(fss) != 1:
                return ("scalar",)             # SILK bandwidth switches
            if sch == 1 and ch == 1:
                if spf == 960 and nfr == 1:
                    return ("silk", next(iter(fss)))
                if not compat and spf in (480, 960, 1920, 2880) \
                        and spf * nfr <= 5760:
                    raise _todo(f"stream {i}: RFC-mode SILK packets of 10, "
                                f"40 or 60 ms or several frames", "12b")
            if sch == 2 and ch == 2 and (
                    (spf == 960 and nfr == 1) if compat else
                    (spf in (960, 1920, 2880) and spf * nfr <= 5760)
                    or (spf == 480 and nfr == 1)):
                raise _todo(f"stream {i}: stereo SILK", "10")
            return ("scalar",)
        spf_ok = spf == 960 if compat else spf in (480, 960)
        if spf_ok and nfr == 1 and sch == ch and one_bw:
            raise _todo(f"stream {i}: hybrid", "11")
        return ("scalar",)

    # ------------------------------------------------------------ steps
    def step(self, lost=None, fec=None) -> bool:
        """Decode one frame of every stream with a packet left. lost:
        stream indices whose next packet was lost in transit: it is
        consumed but not decoded. A lost CELT packet gives silence and
        leaves the stream's state untouched, or is concealed (rfc_plc); a
        lost SILK packet is decoded over an empty bitstream (compat mode)
        or concealed (rfc_plc). fec: the subset of lost whose frame the NEXT packet's
        in-band SILK LBRR copy should reconstruct when it has one (that
        packet stays unread: the next step decodes it). Returns False
        once every stream is exhausted."""
        t0 = time.perf_counter()
        lost = np.isin(np.arange(self.n), list(lost or ()))
        fec = np.isin(np.arange(self.n), list(fec or ())) & lost
        st, ph = self._stats, self._phase_s
        parts = []
        for lane in self._lanes:
            g, idxs = lane.group, lane.idxs
            pos = self.positions[idxs]
            live = pos < g.table.n_packets
            if not live.any():
                continue
            gone = live & lost[idxs]
            active = live & ~gone
            ok = g.decode(pos, active) if active.any() else active
            sel, info = np.nonzero(ok)[0], None
            st["bytes_in"] += int(g.table.pkt_bytes[sel, pos[sel]].sum())
            if isinstance(lane, _SilkLane) and (lane.plc or gone.any()):
                sel, info, n_fec = lane.host_step(pos, ok, gone, fec[idxs])
                st["frames_fec"] += n_fec
                gone[sel] = False
            elif isinstance(lane, _CeltLane) and lane.plc:
                sel, info = lane.host_step(ok, gone)
                gone[sel] = False
            rows = np.nonzero(live)[0]
            st["frames"] += rows.size
            st[f"frames_{lane.kind}"] += rows.size
            st["frames_lost"] += int((live & lost[idxs]).sum())
            part = dict(lane=lane, sel=sel, lost=np.nonzero(gone)[0],
                        rows=rows, disc=g.table.disc[rows, pos[rows]],
                        trim=g.table.trim[rows, pos[rows]], win=None, k=0)
            self.positions[idxs[live]] += 1
            if sel.size:
                t1 = time.perf_counter()
                ph["host_symbol"] += t1 - t0
                part["win"], part["k"] = lane.stage(sel, info)
                st["buckets"][lane.bucket] = st["buckets"].get(
                    lane.bucket, 0) + 1
                t0 = time.perf_counter()
                ph["dispatch"] += t0 - t1
            parts.append(part)
        if self._scalar_rows:
            part = self._scalar_step(lost)
            if part["direct"]:
                parts.append(part)
        ph["host_symbol"] += time.perf_counter() - t0
        if not parts:
            self._flush()
            return False
        st["steps"] += 1
        self._pending.append(parts)
        t0 = time.perf_counter()
        while len(self._pending) > self.pipeline_depth:
            self._route(self._pending.pop(0))
        ph["materialize"] += time.perf_counter() - t0
        return True

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
        size; a scalar row's PCM as its decoder gave it)."""
        for p in parts:
            if p["lane"] is None:
                for i, pcm, lo, te in p["direct"]:
                    self.pcm_out[i].append(self._trim(pcm, lo, te))
                continue
            lane, idxs = p["lane"], p["lane"].idxs
            meta = {int(r): (int(d), int(t)) for r, d, t in
                    zip(p["rows"], p["disc"], p["trim"])}
            if p["sel"].size:
                t0 = time.perf_counter()
                frame = p["win"].host()[p["k"]]
                self._fetch_s += time.perf_counter() - t0
                blk = lane.frames(frame, p["sel"])
                for pcm, r in zip(blk, p["sel"].tolist()):
                    self.pcm_out[idxs[r]].append(self._trim(pcm, *meta[r]))
            for r in p["lost"].tolist():
                self.pcm_out[idxs[r]].append(self._trim(
                    np.zeros((lane.N, self.channels), dtype=np.int16),
                    *meta[r]))

    def _trim(self, pcm, lo: int, te: int):
        # a copy, so the stream's PCM keeps no window buffer alive
        hi = pcm.shape[0] - te
        out = np.ascontiguousarray(pcm[lo:max(hi, lo)])
        self._stats["samples_out"] += out.shape[0]
        return out

    def _flush(self) -> None:
        """Dispatch every partial window and retire every pending step."""
        t0 = time.perf_counter()
        for lane in self._lanes:
            if lane.masked:
                lane.dispatch()
        t1 = time.perf_counter()
        self._phase_s["dispatch"] += t1 - t0
        pends, self._pending = self._pending, []
        for p in pends:
            self._route(p)
        self._phase_s["materialize"] += time.perf_counter() - t1

    def stats(self) -> dict:
        """Decode counters (stream_pool.py:4456-4470 of the JAX package):
        steps, frames, bytes_in (of the packets decoded), samples_out,
        frames per kind (frames_hybrid stays 0: no such path is ported;
        frames_scalar counts the scalar and multistream rows' frames),
        frames_lost, frames_fec (lost frames the next
        packet's LBRR copy recovered), buckets (device frames by lane:
        ("celtT", LM, C, CC, rows) or ("silk", fs, 20, 1, rows)), phase_s,
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
