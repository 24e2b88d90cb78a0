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

The kernel (its source has the details and what bounds it): 16 streams
to a block of 512 threads (128 blocks at 2048 rows); the rows with the
mask on are staged into shared memory and walked by one thread each, the
LPC in transposed form with its running sums built once from the state
(as K8's); the rows with the mask off are copied out by the block
meanwhile. It reads every operand where the caller has it (the lossy
frame passes column slices of its staging rows), so a call is one launch
and allocates only its outputs.
"""
from __future__ import annotations

import ctypes

import torch

from .core_kernel import _operand
from .torch_core import MAX_LPC_ORDER
from .torch_plc import cng_add_xla


def cng_add(xq, cng_exc_q14, a_q12, gain_q10, state0, apply_mask, *,
            frame: int, order: int):
    """K9 wrapper: (xq' (B, frame), state' (B, 16)) as cng_add_xla. CPU
    tensors take the plain version; CUDA tensors launch csrc/silk_cng.cu
    (never the plain version), which reads each operand in place (rows
    any stride apart, unit element stride; the mask as bool bytes)."""
    if xq.device.type == "cpu":
        return cng_add_xla(xq, cng_exc_q14, a_q12, gain_q10, state0,
                           apply_mask, frame=frame, order=order)
    from .. import _build
    if xq.device.type != "cuda":
        raise ValueError(f"cng_add: unsupported device {xq.device}")
    if order not in (10, 16):
        raise ValueError("cng_add: order must be 10 or 16")
    if apply_mask.dtype != torch.bool:
        raise ValueError("cng_add: apply_mask must be bool")
    B = xq.shape[0]
    rows = [_operand(xq, (frame,), "xq"),
            _operand(cng_exc_q14, (frame,), "cng_exc_q14"),
            _operand(a_q12, (order,), "a_q12"),
            _operand(gain_q10[:, None], (1,), "gain_q10"),
            _operand(apply_mask[:, None], (1,), "apply_mask",
                     dtypes=(torch.bool,)),
            _operand(state0, (MAX_LPC_ORDER,), "state0")]
    if any(t.shape[0] != B or t.device != xq.device for t, _ in rows):
        raise ValueError("cng_add: shapes or devices disagree")
    ptrs = (ctypes.c_void_p * 6)(*(t.data_ptr() for t, _ in rows))
    strides = (ctypes.c_longlong * 6)(*(st for _, st in rows))
    out = torch.empty((B, frame), dtype=torch.int32, device=xq.device)
    st2 = torch.empty((B, MAX_LPC_ORDER), dtype=torch.int32,
                      device=xq.device)
    with torch.cuda.device(xq.device):
        err = _build.lib().silk_cng(
            ptrs, strides, out.data_ptr(), st2.data_ptr(), B, frame, order,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "silk_cng")
    cng_add.launches += 1
    return out, st2


cng_add.launches = 0
