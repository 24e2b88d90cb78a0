"""StreamPool: decode many concurrent Ogg/Opus streams with torch.

Port of the uniform-CELT transposed ("T-mode") path of
esp32_opus_player_tpu/models/stream_pool.py. Per step:

1. host: the batched native CELT symbol phase over every stream with a
   packet left (esp32_opus_player_tpu/models/host_groups.py, shared with
   the JAX package);
2. one packed int16 staging row per stream (models/celt_pool_T.py);
3. device: one whole-pool frame step, or with superstep_k = K one
   K-frame window run as a unit: one upload, K frame steps, one PCM
   fetch;
4. host: the PCM is fetched `pipeline_depth` steps later (the device
   works while the next steps' symbol phases run), trimmed (pre-skip,
   end-trim) and appended per stream.

Supported: uniform 20 ms (LM 3) CELT-only streams (compat_ref=True, or
RFC mode at fullband), channels 1 or 2, superstep_k >= 1, out_fs 48000,
output "host". A lost packet (step(lost=...), run(loss=...)) gives
silence and leaves the stream's state untouched: a masked pool row.
Everything else raises NotImplementedError naming the ROADMAP.md item
that brings it.
"""
from __future__ import annotations

import collections
import os
import pathlib

import numpy as np
import torch

from esp32_opus_player_tpu.host import opusfile
from esp32_opus_player_tpu.host.packet import (Mode, get_bandwidth,
                                               get_nb_frames,
                                               get_samples_per_frame)

from ..ops.celt.torch_synthesis import (DECODE_BUFFER_SIZE, NB_EBANDS,
                                        OVERLAP)
from .celt_pool_T import _CELT_HDR, celt_pool_superstep_T

_FULLBAND = 1105
_LM = 3
_N = 960


def _todo(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to torch yet (ROADMAP.md queue A item "
        f"{item})")


class _Window:
    """The PCM of one window of frames: a host copy (K, CC, N, n) of the
    device output, fetched once, on first use."""

    __slots__ = ("pool", "host_t", "done")

    def __init__(self, pool):
        self.pool = pool
        self.host_t = None
        self.done = None          # CUDA event: the host copy has landed

    def host(self) -> np.ndarray:
        if self.host_t is None:        # fetched before K frames buffered
            self.pool._dispatch()
        if self.done is not None:
            self.done.synchronize()
        return self.host_t.numpy()


class StreamPool:
    def __init__(self, sources, channels: int = 1, native: bool = True,
                 compat_ref: bool = True, rfc_plc: bool = False,
                 output: str = "host", out_fs: int = 48000,
                 superstep_k: int = 1, device="cpu"):
        """sources: paths, bytes or parsed OggOpusStream objects (equal
        paths or bytes are parsed once).
        device: where the decoder state lives and the frame steps run;
        on "cuda" the steps launch the hand-written kernels K1-K3, on
        "cpu" their plain torch twins."""
        if channels not in (1, 2):
            raise ValueError("channels must be 1 or 2")
        if not native:
            raise _todo("the Python symbol phase (native=False)", "12")
        if rfc_plc:
            raise _todo("CELT packet-loss concealment (rfc_plc)", "7")
        if output != "host":
            raise _todo("device-resident output", "12")
        if out_fs != 48000:
            raise _todo("decimated output (out_fs < 48000)", "12")
        if int(superstep_k) < 1:
            raise ValueError("superstep_k must be >= 1")
        self.device = torch.device(device)
        parsed = {}
        self.streams = [self._parse(s, parsed) for s in sources]
        self.n = len(self.streams)
        if self.n == 0:
            raise ValueError("StreamPool needs at least one source")
        self.channels = channels
        self.compat_ref = compat_ref
        for i, s in enumerate(self.streams):
            self._check_source(i, s)

        from esp32_opus_player_tpu.models import host_groups as hg
        self._group = hg.CeltGroup(list(range(self.n)),
                                   [s.jobs for s in self.streams], _N,
                                   channels, 0, [21] * self.n)
        self._C = self._group.C
        self._W = _CELT_HDR + 2 * NB_EBANDS + self._C * _N
        self.positions = np.zeros(self.n, dtype=np.int64)
        self.pcm_out = [[] for _ in range(self.n)]
        self.state = {
            "decode_mem": torch.zeros(
                (channels, DECODE_BUFFER_SIZE + OVERLAP, self.n),
                dtype=torch.int32, device=self.device),
            "preemph": torch.zeros((self.n, channels), dtype=torch.int32,
                                   device=self.device),
        }
        self._ss_k = int(superstep_k)
        cuda = self.device.type == "cuda"
        # one staging window on the host, pinned on a card so the upload
        # is asynchronous; `_stg_free` is the event after which the last
        # upload out of it has finished
        self._stg = torch.zeros((self._ss_k, self.n, self._W),
                                dtype=torch.int16, device="cpu",
                                pin_memory=cuda)
        self._stg_np = self._stg.numpy()
        self._stg_free = None
        self._masked: list[bool] = []
        self._win = _Window(self)
        # CUDA events around the frame steps of the latest windows
        self._win_events = collections.deque(maxlen=1024)
        # device work of step t is fetched at the end of step t+depth, so
        # the host symbol phases of the next steps overlap it; superstep
        # windows dispatch every K steps, so retirement lags K steps
        self.pipeline_depth = max(2, self._ss_k)
        self._pending: list[dict] = []

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

    def _check_source(self, i: int, s) -> None:
        head = s.head
        if head is not None and (head.stream_count > 1
                                 or head.channel_count > 2):
            raise _todo(f"stream {i}: multistream sources", "12")
        if s.n_links > 1:
            raise _todo(f"stream {i}: chained sources", "12")
        kinds, bws = set(), set()
        for j in s.jobs:
            p0 = j.data[0]
            mode = Mode.CELT_ONLY if p0 & 0x80 else (
                Mode.HYBRID if (p0 & 0x60) == 0x60 else Mode.SILK_ONLY)
            kinds.add((mode, get_samples_per_frame(p0),
                       get_nb_frames(j.data)))
            bws.add(int(get_bandwidth(p0)))
        if len(kinds) != 1:
            raise _todo(f"stream {i}: mode-switching sources", "12")
        mode, spf, nfr = next(iter(kinds))
        if mode == Mode.SILK_ONLY:
            raise _todo(f"stream {i}: SILK",
                        "8" if self.channels == 1 else "10")
        if mode == Mode.HYBRID:
            raise _todo(f"stream {i}: hybrid", "11")
        if spf != _N or nfr != 1:
            raise _todo(f"stream {i}: CELT frames other than one 20 ms "
                        f"frame per packet", "6")
        if not self.compat_ref and bws != {_FULLBAND}:
            # RFC mode codes the real end band per bandwidth
            raise _todo(f"stream {i}: RFC-mode CELT below fullband", "6")

    # ------------------------------------------------------------ steps
    def step(self, lost=None) -> bool:
        """Decode one frame of every stream with a packet left. lost:
        stream indices whose next packet was lost in transit: it is
        consumed, its PCM is silence and the stream's state is untouched.
        Returns False once every stream is exhausted."""
        g = self._group
        live = self.positions < g.table.n_packets
        if not live.any():
            self._flush()
            return False
        active = live.copy()
        if lost:
            active[list(lost)] = False
        pos = self.positions
        ok = g.decode(pos, active) if active.any() else active
        sel = np.nonzero(ok)[0]
        rows = np.nonzero(live)[0]
        pend = dict(sel=sel, lost=np.nonzero(live & ~ok)[0],
                    disc=g.table.disc[rows, pos[rows]],
                    trim=g.table.trim[rows, pos[rows]], rows=rows,
                    win=None, k=0)
        self.positions[live] += 1
        if sel.size:
            pend["win"], pend["k"] = self._win, len(self._masked)
            self._stage(sel)
        self._pending.append(pend)
        while len(self._pending) > self.pipeline_depth:
            self._route(self._pending.pop(0))
        return True

    def _stage(self, sel) -> None:
        """Write this step's staging row per stream into the window and
        dispatch the window once it holds K frames."""
        if not self._masked and self._stg_free is not None:
            self._stg_free.synchronize()
        g = self._group
        stg = self._stg_np[len(self._masked)]
        stg[:] = 0
        p = g.params
        stg[sel, 2] = p[sel, 1]                         # transient
        stg[sel, 3] = g.start[sel]
        stg[sel, 4] = p[sel, 15]                        # end
        stg[sel, 5:17] = p[sel, 3:15]                   # comb1, comb2
        stg[sel, 17] = 1                                # active
        stg[sel, _CELT_HDR:_CELT_HDR + 2 * NB_EBANDS] = g.bandE[sel]
        stg[sel, _CELT_HDR + 2 * NB_EBANDS:] = g.X[sel]
        self._masked.append(sel.size < self.n)
        if len(self._masked) == self._ss_k:
            self._dispatch()

    def _dispatch(self) -> None:
        """Run the buffered frames of the window on the device."""
        win, K = self._win, len(self._masked)
        cuda = self.device.type == "cuda"
        stgK = self._stg[:K].to(self.device, non_blocking=True)
        if cuda:
            self._stg_free = torch.cuda.Event()
            self._stg_free.record()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
        pcmK = celt_pool_superstep_T(
            self.state["decode_mem"], self.state["preemph"], stgK, LM=_LM,
            C=self._C, CC=self.channels, masked=self._masked)
        if cuda:
            t1.record()
            self._win_events.append((K, t0, t1))
            win.host_t = torch.empty(pcmK.shape, dtype=pcmK.dtype,
                                     device="cpu", pin_memory=True)
            win.host_t.copy_(pcmK, non_blocking=True)
            win.done = torch.cuda.Event()
            win.done.record()
        else:
            win.host_t = pcmK
        self._win = _Window(self)
        self._masked = []

    def _route(self, pend) -> None:
        """Trim and append one step's PCM per stream."""
        CC = self.channels
        meta = {int(r): (int(d), int(t)) for r, d, t in
                zip(pend["rows"], pend["disc"], pend["trim"])}
        if pend["sel"].size:
            frame = pend["win"].host()[pend["k"]]       # (CC, N, n)
            blk = frame[:, :, pend["sel"]].transpose(2, 1, 0)
            for pcm, i in zip(blk, pend["sel"].tolist()):
                self.pcm_out[i].append(self._trim(pcm, *meta[i]))
        for i in pend["lost"].tolist():
            self.pcm_out[i].append(self._trim(
                np.zeros((_N, CC), dtype=np.int16), *meta[i]))

    @staticmethod
    def _trim(pcm, lo: int, te: int):
        # a copy, so the stream's PCM keeps no window buffer alive
        hi = pcm.shape[0] - te
        return np.ascontiguousarray(pcm[lo:max(hi, lo)])

    def _flush(self) -> None:
        """Dispatch a partial window and retire every pending step."""
        if self._masked:
            self._dispatch()
        pends, self._pending = self._pending, []
        for p in pends:
            self._route(p)

    def window_device_ms(self):
        """(frames, device ms) of the latest 1024 windows dispatched, from
        CUDA events around their frame steps (empty off CUDA)."""
        out = []
        for k, t0, t1 in self._win_events:
            t1.synchronize()
            out.append((k, t0.elapsed_time(t1)))
        return out

    def run(self, loss=None):
        """Decode everything; returns a list of (n_i, channels) int16.
        loss: optional callable (stream_idx, packet_idx) -> bool marking
        packets lost in transit."""
        while True:
            lost = set()
            if loss is not None:
                for i in range(self.n):
                    k = int(self.positions[i])
                    if k < len(self.streams[i].jobs) and loss(i, k):
                        lost.add(i)
            if not self.step(lost):
                break
        return self.collected()

    def collected(self):
        """PCM accumulated so far per stream (without clearing): flushes
        the pipeline first."""
        self._flush()
        return [np.concatenate(p) if p else
                np.zeros((0, self.channels), dtype=np.int16)
                for p in self.pcm_out]
