"""The CELT comb postfilter of one frame (kernel K2), the comb fused with
the deemphasis (kernel K4), and their plain twins.

`comb_filter_step_T(bufT, start, N, comb1, comb2)` runs both
comb_filter calls of a CELT frame (src/celt.cpp:2385-2389; comb_filter
:848) on bufT (L, B) int32, IN PLACE over rows [start, start+N): region 1
is [start, start+120) with comb1, region 2 the rest with comb2. comb1 and
comb2 are 6-tuples of (B,) int32 (T0, T1, g0, g1, tapset0, tapset1).
It replaces esp32_opus_player_tpu/ops/celt/pallas_comb.py::
comb_filter_step_T, which returned a new buffer. On a CUDA tensor it
launches csrc/celt_comb.cu; on a CPU tensor it runs the twin
`comb_filter_step_T_ref`, the port of jax_synthesis.comb_filter_batch's
chunk walk.

`comb_deemph_step_T(bufT, start, N, comb1, comb2, mem)` does in one
launch what `comb_filter_step_T` and then `deemphasis_T` over the rows it
wrote do for one channel at downsample 1: it replaces
pallas_comb.py::comb_deemph_step_T (csrc/celt_comb_deemph.cu; the twin
is the composition of the two twins). As in the JAX package, the frame
step (synthesis_T.celt_synth_step_dual_T) runs K2 and K3 apart and does
not call it.

Lags are clamped to [15, 1024] and tapsets to [0, 2] (the decoder never
produces others; the clamp keeps every read inside the buffer).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .deemph import deemphasis_T_ref
from .torch_synthesis import (COMBFILTER_MINPERIOD, I32, MAX_PERIOD,
                              OVERLAP, SHORT_MDCT_SIZE, SIG_SAT, WINDOW,
                              const, mult16_16_p15, mult16_16_q15, smul)

_COMB_GAINS = np.array([[10048, 7112, 4248], [15200, 8784, 0],
                        [26208, 3280, 0]], dtype=np.int32)
# crossfade factor per in-call index (window^2 >> 15)
_F_TAB = (np.asarray(WINDOW, np.int64) ** 2 >> 15).astype(np.int32)
# rows per step of the twin's walk: every tap lies >= T - 2 >= 13 rows
# back, so a chunk of 13 rows reads only finished rows
_CHUNK = COMBFILTER_MINPERIOD - 2


@functools.lru_cache(maxsize=None)
def _tables(device):
    return const(_COMB_GAINS, device), const(_F_TAB, device)


def _comb_params(T0, T1, g0, g1, tapset0, tapset1):
    """Per-stream derived params (pallas_comb._comb_params)."""
    gains, _ = _tables(T0.device)
    T0 = T0.clamp(COMBFILTER_MINPERIOD, MAX_PERIOD)
    T1 = T1.clamp(COMBFILTER_MINPERIOD, MAX_PERIOD)
    ga = gains[tapset0.clamp(0, 2).long()]
    gb = gains[tapset1.clamp(0, 2).long()]
    return dict(
        T0=T0, T1=T1,
        g00=mult16_16_p15(g0, ga[:, 0]), g01=mult16_16_p15(g0, ga[:, 1]),
        g02=mult16_16_p15(g0, ga[:, 2]), g10=mult16_16_p15(g1, gb[:, 0]),
        g11=mult16_16_p15(g1, gb[:, 1]), g12=mult16_16_p15(g1, gb[:, 2]),
        same=(g0 == g1) & (T0 == T1) & (tapset0 == tapset1),
        nop=(g0 == 0) & (g1 == 0), g1z=g1 == 0)


def _comb_region_ref(buf, start: int, N: int, prm):
    """One comb_filter call over rows [start, start+N), in place, in
    feedback-safe chunks of _CHUNK rows."""
    _, f_tab = _tables(buf.device)
    CH = min(_CHUNK, N)
    pos_base = torch.arange(CH, device=buf.device)
    win_base = torch.arange(CH + 4, device=buf.device)[:, None]
    T0, T1 = prm["T0"].long(), prm["T1"].long()
    same, nop, g1z = prm["same"], prm["nop"], prm["g1z"]
    g00, g01, g02 = prm["g00"], prm["g01"], prm["g02"]
    g10, g11, g12 = prm["g10"], prm["g11"], prm["g12"]
    for i0 in range(0, N, CH):
        n = min(CH, N - i0)
        rel = (i0 + pos_base[:n])[:, None]                 # in-call index
        w0 = buf.gather(0, (start + i0 - 2 - T0)[None, :] + win_base[:n + 4])
        w1 = buf.gather(0, (start + i0 - 2 - T1)[None, :] + win_base[:n + 4])
        x = buf[start + i0:start + i0 + n]
        # past the crossfade the new params apply with the raw gains
        # (comb_filter_const, src/celt.cpp:830)
        y = (x + smul(w1[2:n + 2], g10)
             + smul(w1[3:n + 3] + w1[1:n + 1], g11)
             + smul(w1[4:n + 4] + w1[0:n], g12))
        use_ov = (rel < OVERLAP) & ~same[None, :]
        if i0 < OVERLAP:
            fc = torch.where(use_ov, f_tab[rel.clamp(max=OVERLAP - 1)], 0)
            fa = 32767 - fc
            y_ov = (x
                    + smul(w0[2:n + 2], mult16_16_q15(fa, g00))
                    + smul(w0[3:n + 3] + w0[1:n + 1],
                           mult16_16_q15(fa, g01))
                    + smul(w0[4:n + 4] + w0[0:n], mult16_16_q15(fa, g02))
                    + smul(w1[2:n + 2], mult16_16_q15(fc, g10))
                    + smul(w1[3:n + 3] + w1[1:n + 1],
                           mult16_16_q15(fc, g11))
                    + smul(w1[4:n + 4] + w1[0:n], mult16_16_q15(fc, g12)))
            y = torch.where(use_ov, y_ov, y)
        y = y.clamp(-SIG_SAT, SIG_SAT)
        keep = nop[None, :] | (g1z[None, :] & ~use_ov)
        buf[start + i0:start + i0 + n] = torch.where(keep, x, y)
    return buf


def comb_filter_step_T_ref(bufT, start: int, N: int, comb1, comb2):
    """Plain torch twin of K2 (in place on bufT; also returned)."""
    n1 = min(SHORT_MDCT_SIZE, N)
    _comb_region_ref(bufT, start, n1, _comb_params(*comb1))
    if N > n1:
        _comb_region_ref(bufT, start + n1, N - n1, _comb_params(*comb2))
    return bufT


def _check_buf(what: str, bufT):
    if bufT.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {bufT.device}")
    if bufT.dtype != I32 or bufT.dim() != 2 or not bufT.is_contiguous():
        raise ValueError(f"{what}: bufT must be a contiguous 2-D int32 "
                         f"tensor")


def _par_args(what: str, bufT, comb1, comb2):
    """The 12 parameter vectors as the tile kernels read them: pointers
    and element strides (any stride: the pool passes columns of its
    staging rows), and the vectors, kept alive by the caller."""
    B = bufT.shape[1]
    par = [v.to(I32) for v in (*comb1, *comb2)]
    if len(par) != 12 or any(v.shape != (B,) or v.device != bufT.device
                             for v in par):
        raise ValueError(f"{what}: params must be 12 x (B,) on the "
                         f"buffer's device")
    ptrs = (ctypes.c_void_p * 12)(*(v.data_ptr() for v in par))
    strides = (ctypes.c_longlong * 12)(*(v.stride(0) for v in par))
    return ptrs, strides, par


def comb_filter_step_T(bufT, start: int, N: int, comb1, comb2):
    """K2 wrapper, in place on bufT (L, B) int32; returns bufT. CPU
    tensors take the twin; CUDA tensors launch csrc/celt_comb.cu (never
    the twin). The kernel reads the 12 parameter vectors where they lie."""
    if start < MAX_PERIOD + 2 or start + N > bufT.shape[0]:
        raise ValueError("comb_filter_step_T: rows out of range")
    if bufT.device.type == "cpu":
        return comb_filter_step_T_ref(bufT, start, N, comb1, comb2)
    from .. import _build
    _check_buf("comb_filter_step_T", bufT)
    ptrs, strides, _par = _par_args("comb_filter_step_T", bufT, comb1, comb2)
    gains, f_tab = _tables(bufT.device)
    with torch.cuda.device(bufT.device):
        err = _build.lib().celt_comb_step(
            bufT.data_ptr(), bufT.shape[1], start, N, ptrs, strides,
            f_tab.data_ptr(), gains.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "celt_comb_step")
    comb_filter_step_T.launches += 1
    return bufT


comb_filter_step_T.launches = 0


def comb_deemph_step_T_ref(bufT, start: int, N: int, comb1, comb2, mem):
    """Plain torch twin of K4: K2's twin, then K3's over the rows it
    wrote (in place on bufT)."""
    comb_filter_step_T_ref(bufT, start, N, comb1, comb2)
    pcm, mem2 = deemphasis_T_ref(bufT[None, start:start + N], mem[:, None])
    return bufT, pcm[0], mem2[:, 0]


def comb_deemph_step_T(bufT, start: int, N: int, comb1, comb2, mem):
    """K4 wrapper: the comb postfilter in place on bufT (L, B) int32,
    then the deemphasis of rows [start, start+N) with the channel's
    memory mem (B,) int32. Returns (bufT, pcm (N, B) int16, mem' (B,));
    mem is not written. CPU tensors take the twin; CUDA tensors launch
    csrc/celt_comb_deemph.cu (never the twin)."""
    if start < MAX_PERIOD + 2 or start + N > bufT.shape[0]:
        raise ValueError("comb_deemph_step_T: rows out of range")
    if bufT.device.type == "cpu":
        return comb_deemph_step_T_ref(bufT, start, N, comb1, comb2, mem)
    from .. import _build
    _check_buf("comb_deemph_step_T", bufT)
    B = bufT.shape[1]
    ptrs, strides, _par = _par_args("comb_deemph_step_T", bufT, comb1, comb2)
    mem = mem.to(I32).contiguous()
    if mem.shape != (B,) or mem.device != bufT.device:
        raise ValueError("comb_deemph_step_T: mem must be (B,) on the "
                         "buffer's device")
    gains, f_tab = _tables(bufT.device)
    pcm = torch.empty((N, B), dtype=torch.int16, device=bufT.device)
    mem2 = torch.empty_like(mem)
    with torch.cuda.device(bufT.device):
        err = _build.lib().celt_comb_deemph(
            bufT.data_ptr(), B, start, N, ptrs, strides, f_tab.data_ptr(),
            gains.data_ptr(), mem.data_ptr(), mem2.data_ptr(),
            pcm.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "celt_comb_deemph")
    comb_deemph_step_T.launches += 1
    return bufT, pcm, mem2


comb_deemph_step_T.launches = 0
