"""The dense phase of SILK packet-loss concealment (kernel K8) and its
plain version.

`silk_plc_conceal(...)` computes what
esp32_opus_player_tpu/ops/silk/pallas_core.py::silk_plc_conceal_pallas
computes, with the arguments and results of
jax_plc.silk_plc_conceal_frame (reference silk_PLC_conceal
src/silk.cpp:2973): the rewhitening FIR of the last lag0 + 2 history
samples, the rand-excited 5-tap LTP recurrence at per-subframe lags, the
LPC synthesis ring and the output gain. On a CUDA tensor it launches
csrc/silk_plc.cu at every batch size (the JAX package's 128-row
threshold is a TPU lane-tile matter); on a CPU tensor it runs
torch_plc.silk_plc_conceal_frame_xla.

Lags: the kernel indexes its lag directly and clamps it to
[2 fs, 18 fs], the range the conceal prep produces; there it equals the
plain version's chunk walk. A row that is not concealed (the lossy frame
step runs both halves on every row and selects by mask) is therefore
staged with lag 2 fs, not with the JAX pool's lag 0.
"""
from __future__ import annotations

import torch

from .core_kernel import _rows
from .torch_core import I32, MAX_LPC_ORDER
from .torch_plc import silk_plc_conceal_frame_xla


def silk_plc_conceal(outBuf, sLPC0, rand_q12, A_Q12, B_Q14_4, lag4,
                     inv_gain_q30, prev_gain_q10_1, *, fs_khz: int,
                     nb_subfr: int, order: int):
    """K8 wrapper: (xq (B, frame), sLPC' (B, 16)) as
    silk_plc_conceal_frame_xla. CPU tensors take the plain version; CUDA
    tensors launch csrc/silk_plc.cu (never the plain version). Only the
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
            or order not in (10, 16):
        raise ValueError("silk_plc_conceal: fs_khz 8/12/16, nb_subfr 2/4, "
                         "order 10/16")
    B = outBuf.shape[0]
    frame = nb_subfr * 5 * fs_khz
    ltp_mem = 20 * fs_khz
    ob = _rows(outBuf, ltp_mem, "outBuf")
    rnd = _rows(rand_q12, frame, "rand_q12")
    A = A_Q12[:, :order].to(I32).contiguous()
    Bq = B_Q14_4[:, :nb_subfr].to(I32).contiguous()
    par = torch.cat([lag4[:, :nb_subfr], inv_gain_q30[:, None],
                     prev_gain_q10_1[:, None]], dim=1).to(I32).contiguous()
    st0 = sLPC0.to(I32).contiguous()
    if A.shape != (B, order) or Bq.shape != (B, nb_subfr, 5) \
            or par.shape != (B, nb_subfr + 2) \
            or st0.shape != (B, MAX_LPC_ORDER) or rnd.shape[0] != B \
            or len({t.device for t in (ob, rnd, A, Bq, par, st0)}) != 1:
        raise ValueError("silk_plc_conceal: shapes or devices disagree")
    xq = torch.empty((B, frame), dtype=I32, device=ob.device)
    st2 = torch.empty_like(st0)
    # the LTP state, one column per stream (coalesced across a warp)
    sltp = torch.empty((ltp_mem + frame, B), dtype=I32, device=ob.device)
    with torch.cuda.device(ob.device):
        err = _build.lib().silk_plc(
            ob.data_ptr(), ob.stride(0), rnd.data_ptr(), rnd.stride(0),
            A.data_ptr(), Bq.data_ptr(), par.data_ptr(), st0.data_ptr(),
            xq.data_ptr(), st2.data_ptr(), sltp.data_ptr(), B, fs_khz,
            nb_subfr, order, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "silk_plc")
    silk_plc_conceal.launches += 1
    return xq, st2


silk_plc_conceal.launches = 0
