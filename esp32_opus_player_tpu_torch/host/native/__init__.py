"""ctypes binding for the native host entropy engine (libcelt_host.so).

The port's own copy of esp32_opus_player_tpu/host/native/__init__.py;
only the build differs. The library builds at first load (g++, ~10 s)
from the sources in this directory into
esp32_opus_player_tpu_torch/build/host-<key>/, where the key hashes the
sources, the Makefile and the host CPU: the Makefile builds with
-march=native, so a library built on another CPU is never loaded.
"""
from __future__ import annotations

import array
import ctypes
import hashlib
import os
import pathlib
import platform
import subprocess
import threading

import numpy as np

from ...utils import spans

_DIR = pathlib.Path(__file__).resolve().parent
BUILD_ROOT = _DIR.parents[1] / "build"

_lib = None


def _host_cpu() -> bytes:
    """What -march=native compiles for: the CPU model and its flags."""
    keep = [platform.machine()]
    try:
        for line in pathlib.Path("/proc/cpuinfo").read_text().splitlines():
            if line.split(":")[0].strip() in ("model name", "flags"):
                keep.append(line)
            if line.strip() == "":
                break                  # the first processor is enough
    except OSError:
        keep.append(platform.processor())
    return "\n".join(keep).encode()


def library_path() -> pathlib.Path:
    h = hashlib.sha256(_host_cpu())
    for p in sorted(_DIR.glob("*.cpp")) + sorted(_DIR.glob("*.h")) + [
            _DIR / "Makefile"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / f"host-{h.hexdigest()[:16]}" / "libcelt_host.so"


def _build() -> pathlib.Path:
    out = library_path()
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["make", "-C", str(_DIR), "-s", f"OUT={tmp}"],
                       check=True)
        os.replace(tmp, out)
    return out


class CeltHostState(ctypes.Structure):
    _fields_ = [
        ("oldBandE", ctypes.c_int16 * 42),
        ("oldLogE", ctypes.c_int16 * 42),
        ("oldLogE2", ctypes.c_int16 * 42),
        ("backgroundLogE", ctypes.c_int16 * 42),
        ("rng", ctypes.c_uint32),
        ("pf_period", ctypes.c_int32),
        ("pf_period_old", ctypes.c_int32),
        ("pf_gain", ctypes.c_int32),
        ("pf_gain_old", ctypes.c_int32),
        ("pf_tapset", ctypes.c_int32),
        ("pf_tapset_old", ctypes.c_int32),
        ("loss_count", ctypes.c_int32),
        ("error", ctypes.c_int32),
    ]


def load():
    """The library, built if absent (a `load.native` span, its `compiled`
    1 where it was built)."""
    global _lib
    if _lib is None:
        rec = spans.recorder()
        sp = rec.open("load.native")
        compiled = not library_path().exists()
        try:
            _lib = _bind(ctypes.CDLL(str(_build())))
        finally:
            rec.close(sp, None, (float(compiled),))
        if compiled:
            rec.count("load.native.compiled")
    return _lib


def _bind(lib):
    lib.celt_host_decode.restype = ctypes.c_int
    lib.celt_host_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(CeltHostState),
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int16),
        ctypes.POINTER(ctypes.c_int32)]
    lib.celt_host_decode_resume.restype = ctypes.c_int
    lib.celt_host_decode_resume.argtypes = \
        lib.celt_host_decode.argtypes + [ctypes.POINTER(ctypes.c_int32)]
    lib.celt_host_reset.argtypes = [ctypes.POINTER(CeltHostState)]
    _bind_batch(lib)
    return lib


def _bind_batch(lib):
    """Batched symbol-phase entries (batch_entry.cpp): one call decodes N
    streams' frames into contiguous output tensors, strip-mined over
    host threads with the GIL released once per step; and the CELT
    window's PCM cut (route_entry.cpp)."""
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i16p = ctypes.POINTER(ctypes.c_int16)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.celt_host_decode_batch.restype = None
    lib.celt_host_decode_batch.argtypes = [
        ctypes.c_int, u8p, i64p, i32p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, i32p, i32p, ctypes.c_int, u8p, ctypes.c_int64,
        i32p, i16p, i16p, i32p, i32p, ctypes.c_int]
    lib.silk_host_frame_batch.restype = None
    lib.silk_host_frame_batch.argtypes = [
        ctypes.c_int, u8p, i64p, i32p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, u8p, ctypes.c_int64,
        i32p, i32p, i32p, i32p, i32p, i32p, i32p, i32p, i32p, i32p,
        i32p, ctypes.c_int]
    lib.silk_host_packet_batch.restype = None
    lib.silk_host_packet_batch.argtypes = [
        ctypes.c_int, u8p, i64p, i32p, ctypes.c_int, ctypes.c_int,
        u8p, ctypes.c_int64,
        i32p, i32p, i32p, i32p, i32p, i32p, i32p, i32p, i32p,
        i32p, ctypes.c_int]
    lib.silk_host_stereo_batch.restype = None
    lib.silk_host_stereo_batch.argtypes = [
        ctypes.c_int, u8p, i64p, i32p, ctypes.c_int, ctypes.c_int, i32p,
        ctypes.c_int,
        u8p, ctypes.c_int64,
        i32p, i32p, i32p, i32p, i32p, i32p, i32p, i32p, i32p,
        i32p, i32p, i32p, i32p, i32p, i32p, i32p, i32p, i32p,
        i32p, i32p, i32p, ctypes.c_int]
    lib.pcm_cut_T.restype = ctypes.c_int64
    lib.pcm_cut_T.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, i64p,
        i32p, i32p, ctypes.c_int, ctypes.c_void_p, i64p]
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.host_batch_last_strips.restype = ctypes.c_int
    lib.host_batch_last_strips.argtypes = [f64p, f64p, ctypes.c_int, f64p]
    lib.host_batch_take_strips.restype = None
    lib.host_batch_take_strips.argtypes = [ctypes.c_void_p]


def last_strips():
    """(wall_s, cpu_s, entry_wall_s) of the last batch entry this thread
    called: each strip's wall and CPU seconds (lists of T) and the
    entry's own wall seconds."""
    lib = load()
    cap = 1024
    wall, cpu = (ctypes.c_double * cap)(), (ctypes.c_double * cap)()
    entry = ctypes.c_double()
    T = min(lib.host_batch_last_strips(wall, cpu, cap, ctypes.byref(entry)),
            cap)
    return wall[:T], cpu[:T], entry.value


_take = threading.local()


def take_strips() -> tuple:
    """(strips, cpu_s, wall_s, thread_s) summed over the batch entries
    this thread called since its last take: their strips, the strips' CPU
    seconds, the entries' wall seconds, and strips x entry wall."""
    buf = getattr(_take, "buf", None)
    if buf is None:
        buf = _take.buf = array.array("d", bytes(32))
    (_lib or load()).host_batch_take_strips(buf.buffer_info()[0])
    return tuple(buf)


def cut_T(frame, sel, lo, te, out, off) -> int:
    """The PCM of rows `sel` of one transposed window frame (CC, N, n)
    int16 (a CELT lane's, streams contiguous), stream-major: row j's
    samples [lo[j], N - te[j]) of stream sel[j] into out[off[j]:off[j +
    1]], (samples, CC) with the channels interleaved (empty where lo[j] +
    te[j] >= N), in one pass over tiles of streams x samples
    (route_entry.cpp, pcm_cut_T). sel int64, lo and te
    int32 (>= 0), out int16 (at least len(sel) * N, CC) and off int64
    (len(sel) + 1,), all C-contiguous. Returns off[-1], the samples
    written."""
    CC, N, n = frame.shape
    m = len(sel)
    if frame.dtype != np.int16 or not frame.flags.c_contiguous \
            or CC not in (1, 2):
        raise ValueError("frame must be C-contiguous int16 (CC 1|2, N, n)")
    for a, dt, size in ((sel, np.int64, m), (lo, np.int32, m),
                        (te, np.int32, m), (off, np.int64, m + 1)):
        if a.dtype != dt or not a.flags.c_contiguous or a.shape != (size,):
            raise ValueError(f"expected C-contiguous {dt.__name__} ({size},)")
    if out.dtype != np.int16 or not out.flags.c_contiguous \
            or out.ndim != 2 or out.shape[0] < m * N or out.shape[1] != CC:
        raise ValueError(f"out must be C-contiguous int16 (>= {m * N}, "
                         f"{CC})")
    if m and (sel.min() < 0 or sel.max() >= n or lo.min() < 0
              or te.min() < 0):
        raise ValueError("sel out of the frame's streams, or a negative "
                         "trim")
    return load().pcm_cut_T(
        frame.ctypes.data, CC, N, n, ptr(sel, ctypes.c_int64), ptr(lo),
        ptr(te), m, out.ctypes.data, ptr(off, ctypes.c_int64))


def ptr(a, typ=ctypes.c_int32):
    return a.ctypes.data_as(ctypes.POINTER(typ))


class StateArray:
    """n contiguous native decoder states in one numpy byte buffer, with
    per-row ctypes struct views — the batch entries walk the buffer with
    a stride, while per-stream fallback paths (loss, FEC) and
    checkpointing keep using the individual struct views."""

    def __init__(self, n: int, struct_type):
        self.struct_type = struct_type
        self.stride = ctypes.sizeof(struct_type)
        self.buf = np.zeros((n, self.stride), dtype=np.uint8)
        self.views = [struct_type.from_buffer(self.buf, i * self.stride)
                      for i in range(n)]

    def __len__(self):
        return len(self.views)

    def __getitem__(self, i):
        return self.views[i]

    def base_ptr(self):
        return self.buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class NativeCELTHost:
    """Per-stream native CELT symbol phase; drop-in producer of the same
    synth-inputs dict as CELTDecoder.decode_with_ec(defer_synthesis=True)."""

    def __init__(self, channels: int, st=None):
        """st: optional external CeltHostState view (a StateArray row) so
        batch calls and per-stream calls share the same state memory."""
        self.lib = load()
        self.channels = channels
        self.stream_channels = channels
        self.start = 0
        self.end = 21
        self.disable_inv = 1 if channels == 1 else 0
        self.st = st if st is not None else CeltHostState()
        self.lib.celt_host_reset(ctypes.byref(self.st))

    def reset_state(self):
        # match the reference's partial OPUS_RESET_STATE (src/celt.cpp:2489)
        self.st.rng = 0
        self.st.error = 0
        self.st.pf_period = self.st.pf_period_old = 0
        self.st.pf_gain = self.st.pf_gain_old = 0
        self.st.pf_tapset = self.st.pf_tapset_old = 0
        for i in range(42):
            self.st.oldLogE[i] = -(28 << 10)
            self.st.oldLogE2[i] = -(28 << 10)

    def decode_symbol_phase(self, data: bytes, frame_size: int,
                            ec_state=None):
        """ec_state: RangeDecoder.export_state() to resume mid-packet
        (hybrid frames after the host SILK symbol phase)."""
        C = self.stream_channels
        N = frame_size
        X = np.zeros(C * N, dtype=np.int16)
        bandE = np.zeros(42, dtype=np.int16)
        params = np.zeros(18, dtype=np.int32)
        if ec_state is None:
            ret = self.lib.celt_host_decode(
                data, len(data), frame_size, self.channels, C, self.start,
                self.end, self.disable_inv, ctypes.byref(self.st),
                X.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                bandE.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                params.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        else:
            ec = (ctypes.c_int32 * 9)(*[int(v) - (1 << 32)
                                        if int(v) >= 1 << 31 else int(v)
                                        for v in ec_state])
            ret = self.lib.celt_host_decode_resume(
                data, len(data), frame_size, self.channels, C, self.start,
                self.end, self.disable_inv, ctypes.byref(self.st),
                X.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                bandE.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                params.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), ec)
        if ret != 0:
            raise ValueError(f"celt_host_decode failed: {ret}")
        return dict(
            X=X.astype(np.int64), bandE=bandE.astype(np.int64),
            start=self.start, end=int(params[15]), C=C, CC=self.channels,
            LM=int(params[2]), transient=bool(params[1]),
            silence=int(params[0]),
            comb1=tuple(int(v) for v in params[3:9]),
            comb2=tuple(int(v) for v in params[9:15]),
            tell=int(params[16]), rng=int(params[17]) & 0xFFFFFFFF,
        )


class SilkHostState(ctypes.Structure):
    _fields_ = [
        ("fs_kHz", ctypes.c_int32), ("nb_subfr", ctypes.c_int32),
        ("frame_length", ctypes.c_int32), ("subfr_length", ctypes.c_int32),
        ("LPC_order", ctypes.c_int32),
        ("prevNLSF_Q15", ctypes.c_int32 * 16),
        ("LastGainIndex", ctypes.c_int32),
        ("prev_gain_Q16", ctypes.c_int32),
        ("ec_prevSignalType", ctypes.c_int32),
        ("ec_prevLagIndex", ctypes.c_int32),
        ("first_frame_after_reset", ctypes.c_int32),
        ("lagPrev", ctypes.c_int32), ("prevSignalType", ctypes.c_int32),
        ("nFramesPerPacket", ctypes.c_int32),
        ("VAD_flags", ctypes.c_int32 * 3), ("LBRR_flag", ctypes.c_int32),
        ("LBRR_flags", ctypes.c_int32 * 3),
    ]


class PlcTrackerState(ctypes.Structure):
    """Mirror of PlcTrackerC (silk_host.cpp) — the native PLC/CNG
    concealment-state tracker (reference silk_PLC src/silk.cpp:2871,
    silk_CNG :1342). Scalars first, then the fixed arrays."""
    _fields_ = [(n, ctypes.c_int32) for n in (
        "fs_kHz", "nb_subfr", "subfr_length", "frame_length",
        "ltp_mem_length", "LPC_order",
        "lossCnt", "prevSignalType", "ind_signalType",
        "first_frame_after_reset", "lagPrev", "LastGainIndex",
        "cng_smth_Gain_Q16", "cng_rand_seed", "cng_fs_kHz",
        "plc_pitchL_Q8", "plc_last_frame_lost", "plc_rand_seed",
        "plc_randScale_Q14",
        "plc_conc_energy", "plc_conc_energy_shift",
        "plc_prevLTP_scale_Q14",
        "plc_fs_kHz", "plc_subfr_length", "plc_nb_subfr",
    )] + [
        ("plc_prevGain_Q16", ctypes.c_int32 * 2),
        ("plc_LTPCoef_Q14", ctypes.c_int32 * 5),
        ("plc_prevLPC_Q12", ctypes.c_int32 * 16),
        ("prevNLSF_Q15", ctypes.c_int32 * 16),
        ("cng_smth_NLSF_Q15", ctypes.c_int32 * 16),
        ("cng_synth_state", ctypes.c_int32 * 16),
        ("exc_Q14", ctypes.c_int32 * 320),
        ("cng_exc_buf_Q14", ctypes.c_int32 * 320),
    ]


def _bind_silk(lib):
    if getattr(lib, "_silk_bound", False):
        return
    I32P = ctypes.POINTER(ctypes.c_int32)
    lib.silk_host_frame_c.restype = ctypes.c_int
    lib.silk_host_frame_c.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(SilkHostState),
        I32P, I32P, I32P, I32P, I32P, I32P, I32P, I32P, I32P, I32P]
    lib.silk_host_frame_fec_c.restype = ctypes.c_int
    lib.silk_host_frame_fec_c.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(SilkHostState),
        I32P, I32P, I32P, I32P, I32P, I32P, I32P, I32P, I32P]
    lib.silk_host_packet_c.restype = ctypes.c_int
    lib.silk_host_packet_c.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(SilkHostState),
        I32P, I32P, I32P, I32P, I32P, I32P, I32P, I32P, I32P]
    lib.silk_host_stereo_c.restype = ctypes.c_int
    lib.silk_host_stereo_c.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(SilkHostState),
        ctypes.POINTER(SilkHostState),
        I32P, I32P, I32P, I32P, I32P, I32P, I32P, I32P, I32P,
        I32P, I32P, I32P, I32P, I32P, I32P, I32P, I32P, I32P,
        I32P, I32P]
    lib.silk_host_reset.argtypes = [ctypes.POINTER(SilkHostState)]
    lib.silk_nlsf2a_batch_c.restype = None
    lib.silk_nlsf2a_batch_c.argtypes = [I32P, ctypes.c_int,
                                        ctypes.c_int, I32P]
    lib.silk_lpc_inv_pred_gain_batch_c.restype = None
    lib.silk_lpc_inv_pred_gain_batch_c.argtypes = [I32P, ctypes.c_int,
                                                   ctypes.c_int, I32P]
    lib.silk_host_stereo_packet_c.restype = ctypes.c_int
    lib.silk_host_stereo_packet_c.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(SilkHostState), ctypes.POINTER(SilkHostState),
        I32P, I32P, I32P, I32P, I32P, I32P, I32P, I32P, I32P,
        I32P, I32P, I32P, I32P, I32P, I32P, I32P, I32P, I32P,
        I32P, I32P]
    lib.silk_host_stereo_fec_c.restype = ctypes.c_int
    lib.silk_host_stereo_fec_c.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(SilkHostState), ctypes.POINTER(SilkHostState),
        I32P, I32P, I32P, I32P, I32P, I32P, I32P, I32P, I32P,
        I32P, I32P, I32P, I32P, I32P, I32P, I32P, I32P, I32P, I32P]
    lib.plc_trk_good_c.restype = None
    lib.plc_trk_good_c.argtypes = [
        ctypes.POINTER(PlcTrackerState), I32P, I32P, I32P, I32P, I32P,
        I32P, I32P, I32P]
    lib.plc_trk_good_batch_c.restype = None
    lib.plc_trk_good_batch_c.argtypes = [
        ctypes.POINTER(ctypes.POINTER(PlcTrackerState)), I32P,
        ctypes.c_int, I32P, I32P, I32P, I32P, I32P, I32P, I32P, I32P,
        ctypes.c_int]
    lib.plc_trk_conceal_prep_c.restype = None
    lib.plc_trk_conceal_prep_c.argtypes = [
        ctypes.POINTER(PlcTrackerState), I32P, I32P, I32P, I32P, I32P,
        I32P, I32P]
    lib._silk_bound = True


def nlsf2a_batch(nlsf_q15: "np.ndarray", order: int) -> "np.ndarray":
    """Native batched silk_NLSF2A (src/silk.cpp:642): nlsf_q15
    (n, 16) int32 -> a_q12 (n, 16) int32 (cols >= order zero)."""
    import numpy as np
    lib = load()
    _bind_silk(lib)
    nlsf = np.ascontiguousarray(nlsf_q15, dtype=np.int32)
    n = nlsf.shape[0]
    out = np.empty((n, 16), dtype=np.int32)
    lib.silk_nlsf2a_batch_c(
        nlsf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n, order,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out


def lpc_inverse_pred_gain_batch(a_q12: "np.ndarray",
                                order: int) -> "np.ndarray":
    """Native batched silk_LPC_inverse_pred_gain (src/silk.cpp:2359):
    a_q12 (n, 16) int32 -> invGain_Q30 (n,) int32 (0 = unstable)."""
    import numpy as np
    lib = load()
    _bind_silk(lib)
    a = np.ascontiguousarray(a_q12, dtype=np.int32)
    n = a.shape[0]
    out = np.empty(n, dtype=np.int32)
    lib.silk_lpc_inv_pred_gain_batch_c(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n, order,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out


class NativeSilkHost:
    """Per-stream native SILK symbol phase; drop-in producer of the same
    params dict as models/batch_silk.py::silk_host_frame. Mono 10/20 ms
    frames (packet() handles 40/60 ms payloads, fec_frame() the LBRR
    copy); hybrid=True also consumes the redundancy flag and returns the
    ec state for the CELT engine."""

    def __init__(self, st=None):
        self.lib = load()
        _bind_silk(self.lib)
        self.st = st if st is not None else SilkHostState()
        self.lib.silk_host_reset(ctypes.byref(self.st))

    def frame(self, data: bytes, fs_khz: int, payload_ms: int = 20,
              hybrid: bool = False):
        frame_len = payload_ms * fs_khz
        exc = np.zeros(frame_len, dtype=np.int32)
        A = np.zeros((2, 16), dtype=np.int32)
        B = np.zeros((4, 5), dtype=np.int32)
        gains = np.zeros(4, dtype=np.int32)
        inv = np.zeros(4, dtype=np.int32)
        lag = np.zeros(4, dtype=np.int32)
        flags = np.zeros(12, dtype=np.int32)
        adj = np.zeros(4, dtype=np.int32)
        ec = np.zeros(9, dtype=np.int32)
        misc = np.zeros(24, dtype=np.int32)

        def p(a):
            return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

        ret = self.lib.silk_host_frame_c(
            data, len(data), fs_khz, payload_ms, int(hybrid),
            ctypes.byref(self.st), p(exc), p(A), p(B), p(gains), p(inv),
            p(lag), p(flags), p(adj), p(ec), p(misc))
        if ret != 0:
            raise ValueError(f"silk_host_frame_c failed: {ret}")
        return dict(A=A, B=B, gains=gains, inv=inv, lag=lag,
                    voiced=flags[0:4].astype(bool),
                    rewhiten=flags[4:8].astype(bool),
                    match=flags[8:12].astype(bool), adj=adj, exc=exc,
                    signal_type=int(misc[0]), lag_prev=int(misc[3]),
                    ltp_scale=int(misc[4]), nlsf=misc[8:24].copy(),
                    rng=int(misc[6]) & 0xFFFFFFFF,
                    ec_state=[int(v) & 0xFFFFFFFF for v in ec])

    def packet(self, data: bytes, fs_khz: int, payload_ms: int = 20):
        """One mono SILK packet of 1-3 20 ms frames (20/40/60 ms payload).
        Returns a list of per-frame device param dicts."""
        if payload_ms in (10, 20):   # single internal frame
            return [self.frame(data, fs_khz, payload_ms)]
        n = payload_ms // 20
        fl = 20 * fs_khz
        exc = np.zeros(n * fl, dtype=np.int32)
        A = np.zeros((n, 2, 16), dtype=np.int32)
        B = np.zeros((n, 4, 5), dtype=np.int32)
        gains = np.zeros((n, 4), dtype=np.int32)
        inv = np.zeros((n, 4), dtype=np.int32)
        lag = np.zeros((n, 4), dtype=np.int32)
        flags = np.zeros((n, 12), dtype=np.int32)
        adj = np.zeros((n, 4), dtype=np.int32)
        misc = np.zeros((n, 24), dtype=np.int32)

        def p(a):
            return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

        ret = self.lib.silk_host_packet_c(
            data, len(data), fs_khz, payload_ms, ctypes.byref(self.st),
            p(exc), p(A), p(B), p(gains), p(inv), p(lag), p(flags), p(adj),
            p(misc))
        if ret != 0:
            raise ValueError(f"silk_host_packet_c failed: {ret}")
        return [dict(A=A[f], B=B[f], gains=gains[f], inv=inv[f],
                     lag=lag[f], voiced=flags[f, 0:4].astype(bool),
                     rewhiten=flags[f, 4:8].astype(bool),
                     match=flags[f, 8:12].astype(bool), adj=adj[f],
                     exc=exc[f * fl:(f + 1) * fl],
                     signal_type=int(misc[f, 0]),
                     lag_prev=int(misc[f, 3]), ltp_scale=int(misc[f, 4]),
                     nlsf=misc[f, 8:24].copy(),
                     rng=int(misc[f, 6]) & 0xFFFFFFFF)
                for f in range(n)]

    def fec_frame(self, data: bytes, fs_khz: int, payload_ms: int = 20):
        """In-band FEC: decode this packet's LBRR copy of the previous
        (lost) frame. Returns the device param dict, or None when the
        packet carries no usable LBRR."""
        frame_len = payload_ms * fs_khz
        exc = np.zeros(frame_len, dtype=np.int32)
        A = np.zeros((2, 16), dtype=np.int32)
        B = np.zeros((4, 5), dtype=np.int32)
        gains = np.zeros(4, dtype=np.int32)
        inv = np.zeros(4, dtype=np.int32)
        lag = np.zeros(4, dtype=np.int32)
        flags = np.zeros(12, dtype=np.int32)
        adj = np.zeros(4, dtype=np.int32)
        misc = np.zeros(24, dtype=np.int32)

        def p(a):
            return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

        ret = self.lib.silk_host_frame_fec_c(
            data, len(data), fs_khz, payload_ms, ctypes.byref(self.st),
            p(exc), p(A), p(B), p(gains), p(inv), p(lag), p(flags), p(adj),
            p(misc))
        if ret == -4:
            return None
        if ret != 0:
            raise ValueError(f"silk_host_frame_fec_c failed: {ret}")
        return dict(A=A, B=B, gains=gains, inv=inv, lag=lag,
                    voiced=flags[0:4].astype(bool),
                    rewhiten=flags[4:8].astype(bool),
                    match=flags[8:12].astype(bool), adj=adj, exc=exc,
                    signal_type=int(misc[0]), lag_prev=int(misc[3]),
                    ltp_scale=int(misc[4]), nlsf=misc[8:24].copy(),
                    rng=int(misc[6]) & 0xFFFFFFFF)


class NativeSilkStereoHost:
    """Per-stream native STEREO SILK symbol phase; drop-in producer of
    the same dict as models/batch_silk.silk_host_stereo_packet (mid/side
    device params + stereo predictor + side-reset flag). hybrid=True also
    consumes the redundancy flag and exports the ec state for the CELT
    engine."""

    def __init__(self, st=None):
        self.lib = load()
        _bind_silk(self.lib)
        self.st = st if st is not None else (SilkHostState(),
                                             SilkHostState())
        for s in self.st:
            self.lib.silk_host_reset(ctypes.byref(s))
        self.prev_dom = 0   # prev_decode_only_middle (silk_Decode :459)

    def packet(self, data: bytes, fs_khz: int, hybrid: bool = False,
               payload_ms: int = 20):
        fl = payload_ms * fs_khz

        def alloc():
            return dict(exc=np.zeros(fl, dtype=np.int32),
                        A=np.zeros((2, 16), dtype=np.int32),
                        B=np.zeros((4, 5), dtype=np.int32),
                        gains=np.zeros(4, dtype=np.int32),
                        inv=np.zeros(4, dtype=np.int32),
                        lag=np.zeros(4, dtype=np.int32),
                        flags=np.zeros(12, dtype=np.int32),
                        adj=np.zeros(4, dtype=np.int32),
                        misc=np.zeros(24, dtype=np.int32))

        mb, sb = alloc(), alloc()
        ec = np.zeros(9, dtype=np.int32)
        info = np.zeros(8, dtype=np.int32)

        def p(a):
            return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

        ret = self.lib.silk_host_stereo_c(
            data, len(data), fs_khz, payload_ms, self.prev_dom,
            int(hybrid),
            ctypes.byref(self.st[0]), ctypes.byref(self.st[1]),
            p(mb["exc"]), p(mb["A"]), p(mb["B"]), p(mb["gains"]),
            p(mb["inv"]), p(mb["lag"]), p(mb["flags"]), p(mb["adj"]),
            p(mb["misc"]),
            p(sb["exc"]), p(sb["A"]), p(sb["B"]), p(sb["gains"]),
            p(sb["inv"]), p(sb["lag"]), p(sb["flags"]), p(sb["adj"]),
            p(sb["misc"]), p(ec), p(info))
        if ret != 0:
            raise ValueError(f"silk_host_stereo_c failed: {ret}")
        self.prev_dom = int(info[2])

        def todict(b):
            return dict(A=b["A"], B=b["B"], gains=b["gains"], inv=b["inv"],
                        lag=b["lag"], voiced=b["flags"][0:4].astype(bool),
                        rewhiten=b["flags"][4:8].astype(bool),
                        match=b["flags"][8:12].astype(bool), adj=b["adj"],
                        exc=b["exc"], signal_type=int(b["misc"][0]),
                        lag_prev=int(b["misc"][3]),
                        ltp_scale=int(b["misc"][4]),
                        nlsf=b["misc"][8:24].copy())

        out = dict(mid=todict(mb),
                   side=todict(sb) if info[0] else None,
                   pred=np.asarray(info[3:5], dtype=np.int32),
                   side_reset=bool(info[1]),
                   rng=int(ec[6]) & 0xFFFFFFFF)
        if hybrid:
            out["ec_state"] = [int(v) & 0xFFFFFFFF for v in ec]
        return out

    def packet_multi(self, data: bytes, fs_khz: int, payload_ms: int):
        """One stereo SILK packet of payload_ms/20 internal frames
        (silk_Decode :1481, nChannelsInternal=2, nFramesPerPacket 1-3).
        Returns a LIST of per-frame dicts in the packet() shape; the
        last frame's dict carries the final range-coder state rng."""
        nfr = payload_ms // 20
        fl = 20 * fs_khz

        def alloc():
            return dict(exc=np.zeros((nfr, fl), dtype=np.int32),
                        A=np.zeros((nfr, 2, 16), dtype=np.int32),
                        B=np.zeros((nfr, 4, 5), dtype=np.int32),
                        gains=np.zeros((nfr, 4), dtype=np.int32),
                        inv=np.zeros((nfr, 4), dtype=np.int32),
                        lag=np.zeros((nfr, 4), dtype=np.int32),
                        flags=np.zeros((nfr, 12), dtype=np.int32),
                        adj=np.zeros((nfr, 4), dtype=np.int32),
                        misc=np.zeros((nfr, 24), dtype=np.int32))

        mb, sb = alloc(), alloc()
        ec = np.zeros(9, dtype=np.int32)
        info = np.zeros((nfr, 8), dtype=np.int32)

        def p(a):
            return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

        ret = self.lib.silk_host_stereo_packet_c(
            data, len(data), fs_khz, payload_ms, self.prev_dom,
            ctypes.byref(self.st[0]), ctypes.byref(self.st[1]),
            p(mb["exc"]), p(mb["A"]), p(mb["B"]), p(mb["gains"]),
            p(mb["inv"]), p(mb["lag"]), p(mb["flags"]), p(mb["adj"]),
            p(mb["misc"]),
            p(sb["exc"]), p(sb["A"]), p(sb["B"]), p(sb["gains"]),
            p(sb["inv"]), p(sb["lag"]), p(sb["flags"]), p(sb["adj"]),
            p(sb["misc"]), p(ec), p(info))
        if ret != 0:
            raise ValueError(f"silk_host_stereo_packet_c failed: {ret}")
        self.prev_dom = int(info[nfr - 1, 2])

        def todict(b, f):
            return dict(A=b["A"][f], B=b["B"][f], gains=b["gains"][f],
                        inv=b["inv"][f], lag=b["lag"][f],
                        voiced=b["flags"][f, 0:4].astype(bool),
                        rewhiten=b["flags"][f, 4:8].astype(bool),
                        match=b["flags"][f, 8:12].astype(bool),
                        adj=b["adj"][f], exc=b["exc"][f],
                        signal_type=int(b["misc"][f, 0]),
                        lag_prev=int(b["misc"][f, 3]),
                        ltp_scale=int(b["misc"][f, 4]),
                        nlsf=b["misc"][f, 8:24].copy())

        out = []
        for f in range(nfr):
            out.append(dict(
                mid=todict(mb, f),
                side=todict(sb, f) if info[f, 0] else None,
                pred=info[f, 3:5].astype(np.int32).copy(),
                side_reset=bool(info[f, 1]),
                rng=(int(ec[6]) & 0xFFFFFFFF) if f == nfr - 1 else None))
        return out

    def fec_packet(self, data: bytes, fs_khz: int,
                   payload_ms: int = 20):
        """Decode the LBRR copies of one lost stereo frame from the
        NEXT packet (silk_Decode lostFlag=FLAG_DECODE_LBRR,
        src/silk.cpp:1565-1690; payload_ms 10 packets carry one
        nb_subfr=2 LBRR copy). Returns the same dict shape as
        packet(), or None when the packet carries no usable stereo FEC
        (no mid LBRR) — the caller falls back to concealment. A frame
        whose side channel the previous frame had but the LBRR copy
        lacks comes back with side None and side_conceal True: the mid
        is the LBRR copy's, the side is concealed (silk_decode_frame's
        PLC branch, as the scalar SilkDecoder and libopus do); one with a
        side copy but no mid copy comes back with mid_conceal True: the
        mid is concealed (its params are zeros) and the side is the
        copy's, with no predictors of its own."""
        fl = payload_ms * fs_khz

        def alloc():
            return dict(exc=np.zeros(fl, dtype=np.int32),
                        A=np.zeros((2, 16), dtype=np.int32),
                        B=np.zeros((4, 5), dtype=np.int32),
                        gains=np.zeros(4, dtype=np.int32),
                        inv=np.zeros(4, dtype=np.int32),
                        lag=np.zeros(4, dtype=np.int32),
                        flags=np.zeros(12, dtype=np.int32),
                        adj=np.zeros(4, dtype=np.int32),
                        misc=np.zeros(24, dtype=np.int32))

        mb, sb = alloc(), alloc()
        info = np.zeros(8, dtype=np.int32)

        def p(a):
            return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

        ret = self.lib.silk_host_stereo_fec_c(
            data, len(data), fs_khz, payload_ms, self.prev_dom,
            ctypes.byref(self.st[0]), ctypes.byref(self.st[1]),
            p(mb["exc"]), p(mb["A"]), p(mb["B"]), p(mb["gains"]),
            p(mb["inv"]), p(mb["lag"]), p(mb["flags"]), p(mb["adj"]),
            p(mb["misc"]),
            p(sb["exc"]), p(sb["A"]), p(sb["B"]), p(sb["gains"]),
            p(sb["inv"]), p(sb["lag"]), p(sb["flags"]), p(sb["adj"]),
            p(sb["misc"]), p(info))
        if ret in (-4, -5):
            return None
        if ret != 0:
            raise ValueError(f"silk_host_stereo_fec_c failed: {ret}")
        self.prev_dom = int(info[2])

        def todict(b):
            return dict(A=b["A"], B=b["B"], gains=b["gains"],
                        inv=b["inv"], lag=b["lag"],
                        voiced=b["flags"][0:4].astype(bool),
                        rewhiten=b["flags"][4:8].astype(bool),
                        match=b["flags"][8:12].astype(bool), adj=b["adj"],
                        exc=b["exc"], signal_type=int(b["misc"][0]),
                        lag_prev=int(b["misc"][3]),
                        ltp_scale=int(b["misc"][4]),
                        nlsf=b["misc"][8:24].copy())

        return dict(mid=todict(mb),
                    side=todict(sb) if info[0] else None,
                    pred=np.asarray(info[3:5], dtype=np.int32),
                    side_reset=bool(info[1]),
                    side_conceal=bool(info[5]),
                    mid_conceal=bool(info[6]), rng=0)
