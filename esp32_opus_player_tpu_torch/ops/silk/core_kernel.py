"""The whole SILK decode_core of one frame (kernel K7) and its plain
version.

`silk_core(...)` computes what
esp32_opus_player_tpu/ops/silk/pallas_core.py::silk_core_pallas
computes, with the arguments and results of
torch_core.silk_core_frame: the per-subframe rewhitening FIR of the LTP
history, the 5-tap LTP recurrence at a per-stream lag, the LPC synthesis
ring and the gain scaling to int16-range xq (reference
src/silk.cpp:1806). On a CUDA tensor it launches csrc/silk_core.cu; on a
CPU tensor it runs `silk_core_ref`, which is
torch_core.silk_core_frame_xla with K5's plain version for its LPC
recurrence.
"""
from __future__ import annotations

import torch

from .lpc_synth import lpc_synth_ref
from .torch_core import I32, MAX_LPC_ORDER, silk_core_frame_xla


def silk_core_ref(*args, fs_khz: int, nb_subfr: int, order: int):
    """Plain torch version of K7 (pure torch, no kernel on any device)."""
    return silk_core_frame_xla(*args, fs_khz=fs_khz, nb_subfr=nb_subfr,
                               order=order, lpc=lpc_synth_ref)


def _rows(t, width: int, what: str):
    """t as (B, width) int32 with unit column stride (rows may be any
    stride apart)."""
    t = t.to(I32)
    if t.stride(-1) != 1:
        t = t.contiguous()
    if t.dim() != 2 or t.shape[1] < width:
        raise ValueError(f"{what} must be (B, >= {width}) int32")
    return t


def silk_core(outBuf, sLPC0, exc, A_Q12, B_Q14, gains_q16,
              inv_gain_q31_k0, pitchL, signal_type_voiced, rewhiten_k,
              gain_adj_q16, prev_gain_match, *, fs_khz: int,
              nb_subfr: int, order: int):
    """K7 wrapper: (xq, sLPC') as silk_core_ref. CPU tensors take the
    plain version; CUDA tensors launch csrc/silk_core.cu (never the plain
    version). Lags must be at least 2 * fs_khz (PE_MIN_LAG), as every
    decoded and every dummy row's are."""
    args = (outBuf, sLPC0, exc, A_Q12, B_Q14, gains_q16, inv_gain_q31_k0,
            pitchL, signal_type_voiced, rewhiten_k, gain_adj_q16,
            prev_gain_match)
    if exc.device.type == "cpu":
        return silk_core_ref(*args, fs_khz=fs_khz, nb_subfr=nb_subfr,
                             order=order)
    from .. import _build
    if exc.device.type != "cuda":
        raise ValueError(f"silk_core: unsupported device {exc.device}")
    if fs_khz not in (8, 12, 16) or nb_subfr not in (2, 4) \
            or order not in (10, 16):
        raise ValueError("silk_core: fs_khz 8/12/16, nb_subfr 2/4, order "
                         "10/16")
    B = exc.shape[0]
    frame = nb_subfr * 5 * fs_khz
    ltp_mem = 20 * fs_khz
    ob = _rows(outBuf, ltp_mem + frame, "outBuf")
    ex = _rows(exc, frame, "exc")
    A = A_Q12[:, :, :order].to(I32).contiguous()
    Bq = B_Q14[:, :nb_subfr].to(I32).contiguous()
    par = torch.stack([gains_q16, inv_gain_q31_k0, pitchL, gain_adj_q16,
                       signal_type_voiced, rewhiten_k, prev_gain_match],
                      dim=1)[:, :, :nb_subfr].to(I32).contiguous()
    st0 = sLPC0.to(I32).contiguous()
    if A.shape != (B, 2, order) or Bq.shape != (B, nb_subfr, 5) \
            or st0.shape != (B, MAX_LPC_ORDER) or ob.shape[0] != B \
            or len({t.device for t in (ob, ex, A, Bq, par, st0)}) != 1:
        raise ValueError("silk_core: shapes or devices disagree")
    xq = torch.empty((B, frame), dtype=I32, device=exc.device)
    st2 = torch.empty_like(st0)
    # the LTP state, one column per stream (coalesced across a warp)
    sltp = torch.empty((ltp_mem + frame, B), dtype=I32, device=exc.device)
    with torch.cuda.device(exc.device):
        err = _build.lib().silk_core(
            ob.data_ptr(), ob.stride(0), ex.data_ptr(), ex.stride(0),
            A.data_ptr(), Bq.data_ptr(), par.data_ptr(), st0.data_ptr(),
            xq.data_ptr(), st2.data_ptr(), sltp.data_ptr(), B, fs_khz,
            nb_subfr, order, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "silk_core")
    silk_core.launches += 1
    return xq, st2


silk_core.launches = 0
