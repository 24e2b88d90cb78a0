"""Whole-bucket mono SILK frame steps over packed int32 staging (row
layout). Port of esp32_opus_player_tpu/models/stream_pool.py:279-361 and
:1868-1885: `silk_packed_frame` is _silk_step_body without the glue of
rfc_plc (ROADMAP A9), with the bucket state updated in place;
`silk_pool_superstep` is _silk_pool_superstep, which runs only the frames
it is given (a shorter last window) instead of padding to K; `make_bucket`
is _silk_bucket without the PLC state (A9).

A bucket holds the streams of one internal rate fs, in row order
(identity rows, like the CELT pool), so no per-row gather or scatter
runs. Staging: one int32 row per stream and frame: the excitation
(frame), A_Q12 (2 x 16), B_Q14 (nb x 5), then 7 x nb parameters [gains,
inv_gain, lag, adj, voiced, rewhiten, match], then the active flag.
Inactive rows carry harmless parameters (`dummy_row`) and keep their
state bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.silk.torch_core import (I32, MAX_LPC_ORDER, resample_batch,
                                   sfir_width, silk_core_frame)

OUT_KHZ = 48


def stage_width(frame: int, nb: int) -> int:
    return frame + 2 * MAX_LPC_ORDER + 5 * nb + 7 * nb + 1


def dummy_row(fs: int, nb: int) -> np.ndarray:
    """The staging row of a stream that does not decode this frame
    (stream_pool.py:1847 _dummy_silk_params, inactive): lag 2 fs keeps
    every LTP read inside the state."""
    frame = nb * 5 * fs
    row = np.zeros(stage_width(frame, nb), dtype=np.int32)
    p = frame + 2 * MAX_LPC_ORDER + 5 * nb
    row[p:p + nb] = 1 << 16                  # gains
    row[p + nb:p + 2 * nb] = 1 << 15         # inv_gain
    row[p + 2 * nb:p + 3 * nb] = 2 * fs      # lag
    row[p + 3 * nb:p + 4 * nb] = 1 << 16     # adj
    row[p + 6 * nb:p + 7 * nb] = 1           # match
    return row


def make_bucket(n: int, fs: int, device) -> dict:
    """Zero decoder state of n streams at internal rate fs (20 ms
    frames, 48 kHz out): the layout of the JAX pool's silk_buckets[fs]."""
    z = lambda *shape: torch.zeros(shape, dtype=I32, device=device)
    return dict(outBuf=z(n, 40 * fs), sLPC=z(n, MAX_LPC_ORDER),
                sIIR=z(n, 6), sFIR=z(n, sfir_width(fs, OUT_KHZ)),
                delay=z(n, fs), sMid=z(n, 2))


def silk_packed_frame(st: dict, stg, *, fs: int, nb: int, order: int,
                      masked: bool):
    """One mono SILK frame over a whole bucket: decode_core, the outBuf
    roll and the resampler to 48 kHz. st (make_bucket) is updated in
    place; stg (n, stage_width) int32 on the state's device. Returns the
    PCM (n, 20 ms at 48 kHz) int16. masked=True honours the active flag:
    inactive rows keep their state bit for bit."""
    n = stg.shape[0]
    frame = nb * 5 * fs
    ltp = 20 * fs
    a0 = frame
    b0 = a0 + 2 * MAX_LPC_ORDER
    p0 = b0 + 5 * nb
    exc = stg[:, :frame]
    A = stg[:, a0:b0].unflatten(1, (2, MAX_LPC_ORDER))
    Bq = stg[:, b0:p0].unflatten(1, (nb, 5))
    par = stg[:, p0:p0 + 7 * nb].unflatten(1, (7, nb))
    ob = st["outBuf"]
    xq, sLPC = silk_core_frame(
        ob, st["sLPC"], exc, A, Bq, par[:, 0], par[:, 1], par[:, 2],
        par[:, 4] != 0, par[:, 5] != 0, par[:, 3], par[:, 6] != 0,
        fs_khz=fs, nb_subfr=nb, order=order)
    # outBuf rolls the decoded signal; its tail is this frame's slot
    new = dict(outBuf=torch.cat([ob[:, frame:ltp], xq, torch.zeros(
        (n, 20 * fs), dtype=I32, device=xq.device)], dim=1), sLPC=sLPC)
    resin = torch.cat([st["sMid"][:, 1:2], xq[:, :-1]], dim=1)
    out48, new["sIIR"], new["sFIR"], new["delay"] = resample_batch(
        st["sIIR"], st["sFIR"], st["delay"], resin, fs_in_khz=fs,
        fs_out_khz=OUT_KHZ, in_len=frame)
    new["sMid"] = xq[:, frame - 2:frame]
    act = (stg[:, -1] != 0)[:, None] if masked else None
    for k, v in new.items():
        st[k].copy_(v if act is None else torch.where(act, v, st[k]))
    return out48.to(torch.int16)


def silk_pool_superstep(st: dict, stgK, *, fs: int, nb: int, order: int,
                        masked):
    """K frames in order: stgK (K, n, stage_width) int32; masked: K
    flags, one per frame. State in place; returns pcmK (K, n, L48)
    int16."""
    K, n = stgK.shape[0], stgK.shape[1]
    pcmK = torch.empty((K, n, nb * 5 * OUT_KHZ), dtype=torch.int16,
                       device=stgK.device)
    for k in range(K):
        pcmK[k] = silk_packed_frame(st, stgK[k], fs=fs, nb=nb, order=order,
                                    masked=masked[k])
    return pcmK
