"""CELT pitch-repeat packet-loss concealment on a lane's state (kernel
P1) and its plain version.

`celt_plc_T(dmT, pre, pitch, lpc, pcmT, rows, first)` conceals one 20
ms frame for each lane column in `rows`, in place, as one frame of the
JAX pool's lossy superstep does (esp32_opus_player_tpu/models/
stream_pool.py::_celt_pool_superstep_T_lossy: gather the lost rows,
jax_plc.celt_plc_core, scatter back): dmT (CC, 2168, cap) int32, pre
(cap, CC) int32, pitch (cap,) int32 and lpc (cap, CC, 24) float32 are
updated at those columns, and the concealed PCM goes into pcmT (CC,
960, cap) int16, the frame's output. rows (R,) int64 holds distinct
columns; first (R,) bool marks a row's first conceal since a good frame.

On a CUDA tensor it launches csrc/celt_plc.cu, one block a row, no
gather and no scatter (its source has the design and what bounds it); on
a CPU tensor it runs `celt_plc_T_ref`, the gather, ops/celt/torch_plc.py
::celt_plc_core and the scatter. The two agree to float32 rounding
(ROADMAP.md's float32 rule); a row's result from the kernel depends on
nothing else in the call.
"""
from __future__ import annotations

import torch

from .torch_plc import LPC_ORDER, N, celt_plc_core


def celt_plc_T_ref(dmT, pre, pitch, lpc, pcmT, rows, first):
    """Plain version of P1: gather, celt_plc_core, scatter."""
    CC = dmT.shape[0]
    pcm, dm2, pre2, T, lpc2 = celt_plc_core(
        dmT[:, :, rows].permute(2, 0, 1), pre[rows], pitch[rows], lpc[rows],
        first, CC=CC)
    dmT[:, :, rows] = dm2.permute(1, 2, 0)
    pre[rows] = pre2
    pitch[rows] = T
    lpc[rows] = lpc2
    pcmT[:, :, rows] = pcm.permute(2, 1, 0)


def celt_plc_T(dmT, pre, pitch, lpc, pcmT, rows, first) -> None:
    """P1 wrapper. CPU tensors take the plain version; CUDA tensors launch
    csrc/celt_plc.cu (never the plain version), one launch per call with
    at least one row."""
    if dmT.device.type == "cpu":
        return celt_plc_T_ref(dmT, pre, pitch, lpc, pcmT, rows, first)
    from .. import _build
    if dmT.device.type != "cuda":
        raise ValueError(f"celt_plc_T: unsupported device {dmT.device}")
    CC, L, cap = dmT.shape
    R = rows.shape[0]
    want = ((dmT, torch.int32, (CC, L, cap)), (pre, torch.int32, (cap, CC)),
            (pitch, torch.int32, (cap,)),
            (lpc, torch.float32, (cap, CC, LPC_ORDER)),
            (pcmT, torch.int16, (CC, N, cap)), (rows, torch.int64, (R,)),
            (first, torch.bool, (R,)))
    for t, dtype, shape in want:
        if (t.device != dmT.device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"celt_plc_T: expected contiguous {dtype} {shape} on "
                f"{dmT.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if CC not in (1, 2) or L != 2168:
        raise ValueError(f"celt_plc_T: dmT must be (1 or 2, 2168, cap), got "
                         f"{tuple(dmT.shape)}")
    if R == 0:
        return None
    with torch.cuda.device(dmT.device):
        err = _build.lib().celt_plc(
            dmT.data_ptr(), cap, CC, pre.data_ptr(), pitch.data_ptr(),
            lpc.data_ptr(), pcmT.data_ptr(), rows.data_ptr(),
            first.data_ptr(), R, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "celt_plc")
    celt_plc_T.launches += 1
    return None


celt_plc_T.launches = 0
