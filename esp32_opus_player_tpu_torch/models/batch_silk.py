"""The host half of SILK packet-loss concealment: the PLC/CNG parameter
state that follows each stream's decoded frames.

Port of NativePlcTracker of esp32_opus_player_tpu/models/batch_silk.py
(with silk_PLC_Reset and silk_CNG_Reset of ops/silk/plc.py, reference
src/silk.cpp:2862 and :1327). The native engine decodes symbols; the
tracker ingests its per-frame outputs (`good_frames`, over the rows of a
group's buffers) to keep the concealment state (silk_PLC_update :2895,
silk_CNG :1342 good branch) and, for a lost frame, produces the device
kernels' inputs (silk_PLC_conceal :2973 and the CNG loss branch, host
half). Both run as single native calls on a C struct (host/native
PlcTrackerState). A stereo stream has one tracker per internal channel
(the JAX pool's _plc_tracker2 and silk_plc_host_params(..., ch_idx)),
kept in one `TrackerArray` per channel of a lane; a side channel that
comes back after mid-only frames resets the channel-state half of its
tracker (`side_reset`, silk_Decode :378). The Python symbol walk of the
JAX package (native=False) is not part of the port.
"""
from __future__ import annotations

import ctypes

import numpy as np

from ..host.native import PlcTrackerState, StateArray, _bind_silk, load

MAX_LPC_ORDER = 16
_I32P = ctypes.POINTER(ctypes.c_int32)


def _ptr(a):
    return a.ctypes.data_as(_I32P)


class NativePlcTracker:
    """PLC/CNG state of one mono SILK stream at internal rate fs_khz
    (20 or 10 ms frames); `c` is the C struct the native calls update
    (st: a row of a StateArray of PlcTrackerState, so that `good_frames`
    can walk a lane's trackers in one call)."""

    def __init__(self, fs_khz: int, frame_ms: int = 20, st=None):
        self._lib = load()
        _bind_silk(self._lib)
        c = self.c = st if st is not None else PlcTrackerState()
        c.fs_kHz = fs_khz
        c.nb_subfr = 2 if frame_ms == 10 else 4
        c.subfr_length = 5 * fs_khz
        c.frame_length = frame_ms * fs_khz
        c.ltp_mem_length = 20 * fs_khz
        c.LPC_order = 16 if fs_khz == 16 else 10
        c.first_frame_after_reset = 1
        c.lagPrev = 100
        c.LastGainIndex = 10
        # silk_CNG_Reset: NLSFs spread evenly, no gain, the fixed seed
        step = 32767 // (c.LPC_order + 1)
        for i in range(c.LPC_order):
            c.cng_smth_NLSF_Q15[i] = (i + 1) * step
        c.cng_smth_Gain_Q16 = 0
        c.cng_rand_seed = 3176576
        # silk_PLC_Reset
        c.plc_pitchL_Q8 = c.frame_length << 7
        c.plc_prevGain_Q16[0] = c.plc_prevGain_Q16[1] = 1 << 16
        c.plc_subfr_length = 20
        c.plc_nb_subfr = 2

    def conceal_prep(self) -> dict:
        """The host half of one concealed frame as a single C call; it
        advances the tracker (loss count, seeds, decayed LTP, drifted
        pitch) exactly once. Returns the device kernels' inputs: rand
        (frame,), A (16,), B4 (nb, 5), lag4 (nb,), inv_gain, prev_gain,
        cng_exc (frame,), cng_a (16,), cng_gain, cng_first."""
        nb = int(self.c.nb_subfr)
        fl = int(self.c.frame_length)
        rand_q12 = np.empty(fl, dtype=np.int32)
        A = np.empty(MAX_LPC_ORDER, dtype=np.int32)
        B4 = np.empty((nb, 5), dtype=np.int32)
        lag4 = np.empty(nb, dtype=np.int32)
        cng_exc = np.empty(fl, dtype=np.int32)
        cng_a = np.empty(MAX_LPC_ORDER, dtype=np.int32)
        sc = np.empty(4, dtype=np.int32)
        self._lib.plc_trk_conceal_prep_c(
            ctypes.byref(self.c), _ptr(rand_q12), _ptr(A), _ptr(B4),
            _ptr(lag4), _ptr(cng_exc), _ptr(cng_a), _ptr(sc))
        return dict(rand=rand_q12, A=A, B4=B4, lag4=lag4,
                    inv_gain=np.int32(sc[0]), prev_gain=np.int32(sc[1]),
                    cng_exc=cng_exc, cng_a=cng_a,
                    cng_gain=np.int32(sc[2]), cng_first=bool(sc[3]))


# int32 word of plc_last_frame_lost in a StateArray row: set by a conceal
# prep, read and cleared for the glue of the next good frame
LAST_LOST_WORD = PlcTrackerState.plc_last_frame_lost.offset // 4


def good_frames(states, rows, buf) -> None:
    """Ingest the freshly decoded rows `rows` of a SilkGroup's buffers
    `buf` into their trackers (states: the lane's StateArray of
    PlcTrackerState, row r following buffer row r) in one native call:
    per row the post-loss transition, applied to the group buffers in
    place, then the tracker update."""
    if len(rows) == 0:
        return
    lib = load()
    _bind_silk(lib)
    addr = (states.buf.ctypes.data
            + np.asarray(rows, dtype=np.uint64) * np.uint64(states.stride))
    trks = addr.ctypes.data_as(
        ctypes.POINTER(ctypes.POINTER(PlcTrackerState)))
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    lib.plc_trk_good_batch_c(
        trks, _ptr(rows), len(rows), _ptr(buf.A), _ptr(buf.B),
        _ptr(buf.gains), _ptr(buf.inv), _ptr(buf.lag), _ptr(buf.flags),
        _ptr(buf.exc), _ptr(buf.misc), buf.exc.shape[1])


def _word(field: str) -> int:
    return getattr(PlcTrackerState, field).offset // 4


class TrackerArray:
    """The PLC/CNG trackers of n streams (or of one channel of n stereo
    streams) at internal rate fs_khz with frame_ms device frames, in one
    StateArray: `good(rows, buf)` ingests decoded rows, `prep(r)` is row
    r's conceal prep, `last_lost` its plc_last_frame_lost words."""

    def __init__(self, n: int, fs_khz: int, frame_ms: int):
        self.states = StateArray(n, PlcTrackerState)
        self.trackers = [NativePlcTracker(fs_khz, frame_ms, st=v)
                         for v in self.states.views]
        self.words = self.states.buf.view(np.int32)
        self.last_lost = self.words[:, LAST_LOST_WORD]

    def good(self, rows, buf) -> None:
        good_frames(self.states, rows, buf)

    def prep(self, r: int) -> dict:
        return self.trackers[r].conceal_prep()

    def take_glue(self, rows):
        """The glue flags of rows (their last frame was concealed), which
        are cleared: the first good frame after a loss run glues."""
        glue = self.last_lost[rows] != 0
        self.last_lost[rows] = 0
        return glue

    def side_reset(self, rows) -> None:
        """A side channel that comes back (silk_Decode :378): only the
        channel-state half of its tracker resets (outBuf and sLPC are
        zeroed on the device); the PLC and CNG history stays."""
        w = self.words
        w[rows, _word("lagPrev")] = 100
        w[rows, _word("LastGainIndex")] = 10
        w[rows, _word("prevSignalType")] = 0
        w[rows, _word("first_frame_after_reset")] = 1
