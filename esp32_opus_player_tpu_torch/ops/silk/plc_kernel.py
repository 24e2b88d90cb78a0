"""The dense phase of SILK packet-loss concealment (kernel K8) and its
plain version.

`silk_plc_conceal(...)` computes what
esp32_opus_player_tpu/ops/silk/pallas_core.py::silk_plc_conceal_pallas
computes, with the arguments and results of
jax_plc.silk_plc_conceal_frame (reference silk_PLC_conceal
src/silk.cpp:2973): the rewhitening FIR of the last lag0 + 2 history
samples, the rand-excited 5-tap LTP recurrence at per-subframe lags, the
LPC synthesis and the output gain. On a CUDA tensor it launches
csrc/silk_plc.cu at every batch size (the JAX package's 128-row
threshold is a TPU lane-tile matter); on a CPU tensor it runs
torch_plc.silk_plc_conceal_frame_xla.

The kernel (its source has the details and what bounds it): 16 streams
to a block of 512 threads (128 blocks at 2048 rows), each stream's LTP
state, outBuf window, coefficients and parameters in shared memory (61
KB a block at WB), no global scratch; the rewhitening by a
warp per stream, the LTP by the same warp in chunks of min(32, lag - 2)
samples (every tap of a chunk was finished before it, so the bits are
the reference's sample walk), the LPC by one thread per stream in
transposed form (running sums built once from the incoming state). It
reads every operand where the caller has it, so the call is one launch
and allocates only its outputs; the LPC chain bounds it.

Lags: the kernel clamps each lag to [2 fs, 18 fs], the range the
conceal prep produces; there it equals the plain version's chunk walk.
A row that is not concealed (the lossy frame step runs both halves on
every row and selects by mask) is therefore staged with lag 2 fs, not
with the JAX pool's lag 0.
"""
from __future__ import annotations

import ctypes

import torch

from .core_kernel import _operand
from .torch_core import MAX_LPC_ORDER
from .torch_plc import silk_plc_conceal_frame_xla


def silk_plc_conceal(outBuf, sLPC0, rand_q12, A_Q12, B_Q14_4, lag4,
                     inv_gain_q30, prev_gain_q10_1, *, fs_khz: int,
                     nb_subfr: int, order: int):
    """K8 wrapper: (xq (B, frame), sLPC' (B, 16)) as
    silk_plc_conceal_frame_xla. CPU tensors take the plain version; CUDA
    tensors launch csrc/silk_plc.cu (never the plain version), which
    reads each operand in place (rows any stride apart, unit element
    stride: the pool passes column slices of its staging rows). Only the
    first nb_subfr rows of B_Q14_4 and lag4 are read."""
    if outBuf.device.type == "cpu":
        return silk_plc_conceal_frame_xla(
            outBuf, sLPC0, rand_q12, A_Q12, B_Q14_4, lag4, inv_gain_q30,
            prev_gain_q10_1, fs_khz=fs_khz, nb_subfr=nb_subfr, order=order)
    from .. import _build
    if outBuf.device.type != "cuda":
        raise ValueError(f"silk_plc_conceal: unsupported device "
                         f"{outBuf.device}")
    if fs_khz not in (8, 12, 16) or nb_subfr not in (2, 4) \
            or order not in (10, 16) or (fs_khz, order) == (8, 16):
        raise ValueError("silk_plc_conceal: fs_khz 8/12/16, nb_subfr 2/4, "
                         "order 10/16 (16 needs fs_khz >= 12)")
    B = outBuf.shape[0]
    frame = nb_subfr * 5 * fs_khz
    rows = [_operand(outBuf, (20 * fs_khz,), "outBuf"),
            _operand(rand_q12, (frame,), "rand_q12"),
            _operand(A_Q12, (order,), "A_Q12"),
            _operand(B_Q14_4[:, :nb_subfr], (nb_subfr, 5), "B_Q14_4"),
            _operand(lag4, (nb_subfr,), "lag4"),
            _operand(inv_gain_q30[:, None], (1,), "inv_gain_q30"),
            _operand(prev_gain_q10_1[:, None], (1,), "prev_gain_q10_1"),
            _operand(sLPC0, (MAX_LPC_ORDER,), "sLPC0")]
    if any(t.shape[0] != B or t.device != outBuf.device for t, _ in rows):
        raise ValueError("silk_plc_conceal: shapes or devices disagree")
    ptrs = (ctypes.c_void_p * 8)(*(t.data_ptr() for t, _ in rows))
    strides = (ctypes.c_longlong * 8)(*(st for _, st in rows))
    xq = torch.empty((B, frame), dtype=torch.int32, device=outBuf.device)
    st2 = torch.empty((B, MAX_LPC_ORDER), dtype=torch.int32,
                      device=outBuf.device)
    with torch.cuda.device(outBuf.device):
        err = _build.lib().silk_plc(
            ptrs, strides, rows[3][0].stride(1), xq.data_ptr(),
            st2.data_ptr(), B, fs_khz, nb_subfr, order,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "silk_plc")
    silk_plc_conceal.launches += 1
    return xq, st2


silk_plc_conceal.launches = 0
