"""Comfort noise added to concealed SILK frames (kernel K9) and its plain
version.

`cng_add(...)` computes what
esp32_opus_player_tpu/ops/silk/pallas_core.py::cng_add_pallas computes,
with the arguments and results of jax_plc.cng_add (reference silk_CNG
src/silk.cpp:1342, lossCnt branch): the CNG LPC ring over the
comfort-noise excitation, scaled and added to the frame under a row
mask; a row with its mask off passes through and keeps its state. On a
CUDA tensor it launches csrc/silk_cng.cu at every batch size; on a CPU
tensor it runs torch_plc.cng_add_xla.
"""
from __future__ import annotations

import torch

from .core_kernel import _rows
from .torch_core import I32, MAX_LPC_ORDER
from .torch_plc import cng_add_xla


def cng_add(xq, cng_exc_q14, a_q12, gain_q10, state0, apply_mask, *,
            frame: int, order: int):
    """K9 wrapper: (xq' (B, frame), state' (B, 16)) as cng_add_xla. CPU
    tensors take the plain version; CUDA tensors launch csrc/silk_cng.cu
    (never the plain version)."""
    if xq.device.type == "cpu":
        return cng_add_xla(xq, cng_exc_q14, a_q12, gain_q10, state0,
                           apply_mask, frame=frame, order=order)
    from .. import _build
    if xq.device.type != "cuda":
        raise ValueError(f"cng_add: unsupported device {xq.device}")
    if order not in (10, 16):
        raise ValueError("cng_add: order must be 10 or 16")
    B = xq.shape[0]
    x = _rows(xq, frame, "xq")
    exc = _rows(cng_exc_q14, frame, "cng_exc_q14")
    A = a_q12[:, :order].to(I32).contiguous()
    gain = gain_q10.to(I32).contiguous()
    mask = apply_mask.to(I32).contiguous()
    st0 = state0.to(I32).contiguous()
    if exc.shape[0] != B or A.shape != (B, order) \
            or gain.shape != (B,) or mask.shape != (B,) \
            or st0.shape != (B, MAX_LPC_ORDER) \
            or len({t.device for t in (x, exc, A, gain, mask, st0)}) != 1:
        raise ValueError("cng_add: shapes or devices disagree")
    out = torch.empty((B, frame), dtype=I32, device=x.device)
    st2 = torch.empty_like(st0)
    with torch.cuda.device(x.device):
        err = _build.lib().silk_cng(
            x.data_ptr(), x.stride(0), exc.data_ptr(), exc.stride(0),
            A.data_ptr(), gain.data_ptr(), mask.data_ptr(), st0.data_ptr(),
            out.data_ptr(), st2.data_ptr(), B, frame, order,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "silk_cng")
    cng_add.launches += 1
    return out, st2


cng_add.launches = 0
