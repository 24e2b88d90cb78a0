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

import ctypes

import torch

from .lpc_synth import lpc_synth_ref
from .torch_core import I32, MAX_LPC_ORDER, silk_core_frame_xla

def silk_core_ref(*args, fs_khz: int, nb_subfr: int, order: int):
    """Plain torch version of K7 (pure torch, no kernel on any device)."""
    return silk_core_frame_xla(*args, fs_khz=fs_khz, nb_subfr=nb_subfr,
                               order=order, lpc=lpc_synth_ref)


def _operand(t, tail: tuple, what: str, dtypes=(I32,)):
    """t as a (B, *tail) operand the kernel can read in place: one of
    `dtypes` (else cast to int32), the dimensions after the first packed
    (else copied). Returns (tensor, row stride)."""
    if t.dtype not in dtypes:
        t = t.to(I32)
    if t.dim() != 1 + len(tail) or any(n < m for n, m in zip(t.shape[1:],
                                                             tail)):
        raise ValueError(f"{what} must be (B, {tail}) or wider")
    if t.shape[0] and not t[0].is_contiguous():
        t = t.contiguous()
    return t, t.stride(0)


def silk_core(outBuf, sLPC0, exc, A_Q12, B_Q14, gains_q16,
              inv_gain_q31_k0, pitchL, signal_type_voiced, rewhiten_k,
              gain_adj_q16, prev_gain_match, *, fs_khz: int,
              nb_subfr: int, order: int):
    """K7 wrapper: (xq, sLPC') as silk_core_ref. CPU tensors take the
    plain version; CUDA tensors launch csrc/silk_core.cu (never the plain
    version). The kernel reads every operand where it lies (rows any
    stride apart, flags as bool or int32: the pool passes column slices
    of its staging rows), so the call is one launch. Lags must be at
    least 2 * fs_khz (PE_MIN_LAG), as every decoded and every dummy
    row's are."""
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
    # A's two coefficient sets may lie wider apart than `order`
    A = A_Q12.to(I32)
    if A.dim() != 3 or A.shape[1] != 2 or A.shape[2] < order:
        raise ValueError("silk_core: A_Q12 must be (B, 2, >= order)")
    if A.stride(2) != 1:
        A = A.contiguous()
    rows = [_operand(outBuf, (20 * fs_khz + frame,), "outBuf"),
            _operand(exc, (frame,), "exc"), (A, A.stride(0)),
            _operand(B_Q14[:, :nb_subfr], (nb_subfr, 5), "B_Q14"),
            _operand(sLPC0, (MAX_LPC_ORDER,), "sLPC0")]
    rows += [_operand(t, (nb_subfr,), "a parameter", (I32, torch.bool))
             for t in (gains_q16, inv_gain_q31_k0, pitchL, gain_adj_q16,
                       signal_type_voiced, rewhiten_k, prev_gain_match)]
    if any(t.shape[0] != B or t.device != exc.device for t, _ in rows):
        raise ValueError("silk_core: shapes or devices disagree")
    ptrs = (ctypes.c_void_p * 12)(*(t.data_ptr() for t, _ in rows))
    strides = (ctypes.c_longlong * 12)(*(st for _, st in rows))
    par_bytes = (ctypes.c_int * 7)(*(t.element_size() for t, _ in rows[5:]))
    xq = torch.empty((B, frame), dtype=I32, device=exc.device)
    st2 = torch.empty((B, MAX_LPC_ORDER), dtype=I32, device=exc.device)
    with torch.cuda.device(exc.device):
        err = _build.lib().silk_core(
            ptrs, strides, A.stride(1), par_bytes, xq.data_ptr(),
            st2.data_ptr(), B, fs_khz, nb_subfr, order,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "silk_core")
    silk_core.launches += 1
    return xq, st2


silk_core.launches = 0
