"""The SILK stereo unmix, mid/side to left/right (kernel S1), and its plain
version.

`ms_to_lr(...)` computes what
esp32_opus_player_tpu/ops/silk/jax_stereo.py::ms_to_lr_batch computes
(silk_stereo_MS_to_LR, reference src/silk.cpp:4028-4076): the side signal
predicted from the 3-tap smoothed mid and the mid with two Q13
predictors, which ramp from the previous frame's pair to this frame's
over the first 8 ms, then L = mid + side and R = mid - side, saturated to
int16. Its layout is the stereo pool's: the frame comes as (B, 2, frame),
mid then side of each stream, and L and R leave as (B, 2, frame), the
2B rows the resampler then takes. On a CUDA tensor it launches
csrc/silk_stereo.cu, one thread a (stream, sample); on a CPU tensor it
runs `ms_to_lr_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from .core_kernel import _operand
from .torch_core import I32, I64, rshift_round, sat16, smulwb, w32

STEREO_INTERP_LEN_MS = 8


def ms_to_lr_ref(sMid, sSide, pred_prev, xq, pred_q13, *, fs_khz: int,
                 frame: int):
    """Plain torch version of S1: ms_to_lr_batch op for op, the int32
    chain's wraps taken modulo 2^32. sMid, sSide, pred_prev, pred_q13
    (B, 2) int32; xq (B, 2, >= frame) int32, mid then side. Returns
    (lr (B, 2, frame), sMid' (B, 2), sSide' (B, 2)) int32."""
    fl = frame
    x1 = torch.cat([sMid.to(I32), xq[:, 0, :fl].to(I32)], dim=-1)
    x2 = torch.cat([sSide.to(I32), xq[:, 1, :fl].to(I32)], dim=-1)
    interp = STEREO_INTERP_LEN_MS * fs_khz
    denom = (1 << 16) // interp
    prev = pred_prev.to(I64)
    pred = pred_q13.to(I64)
    delta = rshift_round(w32(w32(pred - prev).to(I64) * denom), 16).to(I64)
    n = torch.arange(fl, dtype=I64, device=xq.device)
    on = (n < interp)[None, :]
    p0 = torch.where(on, w32(prev[:, :1] + delta[:, :1] * (n + 1)[None]),
                     pred[:, :1].to(I32))
    p1 = torch.where(on, w32(prev[:, 1:] + delta[:, 1:] * (n + 1)[None]),
                     pred[:, 1:].to(I32))
    m_m1 = x1[:, 0:fl].to(I64)
    m_0 = x1[:, 1:fl + 1].to(I64)
    m_p1 = x1[:, 2:fl + 2].to(I64)
    s_0 = x2[:, 1:fl + 1].to(I64)
    s = w32(w32(m_m1 + m_p1 + (m_0 << 1)).to(I64) << 9)
    s = w32((s_0 << 8) + smulwb(s, p0).to(I64))
    s = w32(s.to(I64) + smulwb(w32(m_0 << 11), p1).to(I64))
    side_pred = sat16(rshift_round(s, 8)).to(I64)
    L = sat16(w32(m_0 + side_pred))
    R = sat16(w32(m_0 - side_pred))
    return (torch.stack([L, R], dim=1), x1[:, fl:fl + 2].contiguous(),
            x2[:, fl:fl + 2].contiguous())


def ms_to_lr(sMid, sSide, pred_prev, xq, pred_q13, *, fs_khz: int,
             frame: int):
    """S1 wrapper: (lr, sMid', sSide') as ms_to_lr_ref. CPU tensors take
    the plain version; CUDA tensors launch csrc/silk_stereo.cu (never the
    plain version), which reads each operand where it lies (rows any
    stride apart, unit element stride; xq's two channel rows any stride
    apart too)."""
    if xq.device.type == "cpu":
        return ms_to_lr_ref(sMid, sSide, pred_prev, xq, pred_q13,
                            fs_khz=fs_khz, frame=frame)
    from .. import _build
    if xq.device.type != "cuda":
        raise ValueError(f"ms_to_lr: unsupported device {xq.device}")
    if fs_khz not in (8, 12, 16) or frame < 2:
        raise ValueError("ms_to_lr: fs_khz 8/12/16 and frame >= 2")
    B = xq.shape[0]
    if xq.dtype != I32 or xq.dim() != 3 or xq.shape[1] != 2 \
            or xq.shape[2] < frame or xq.stride(2) != 1:
        xq = xq[:, :, :frame].to(I32).contiguous()
    rows = [_operand(t, (2,), what) for t, what in (
        (sMid, "sMid"), (sSide, "sSide"), (pred_prev, "pred_prev"),
        (pred_q13, "pred_q13"))]
    if any(t.shape[0] != B or t.device != xq.device for t, _ in rows):
        raise ValueError("ms_to_lr: shapes or devices disagree")
    ptrs = (ctypes.c_void_p * 5)(xq.data_ptr(),
                                 *(t.data_ptr() for t, _ in rows))
    strides = (ctypes.c_longlong * 6)(xq.stride(0), xq.stride(1),
                                      *(st for _, st in rows))
    lr = torch.empty((B, 2, frame), dtype=I32, device=xq.device)
    mid2 = torch.empty((B, 2), dtype=I32, device=xq.device)
    side2 = torch.empty((B, 2), dtype=I32, device=xq.device)
    with torch.cuda.device(xq.device):
        err = _build.lib().silk_ms_to_lr(
            ptrs, strides, lr.data_ptr(), mid2.data_ptr(), side2.data_ptr(),
            B, frame, fs_khz, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "silk_ms_to_lr")
    ms_to_lr.launches += 1
    return lr, mid2, side2


ms_to_lr.launches = 0
