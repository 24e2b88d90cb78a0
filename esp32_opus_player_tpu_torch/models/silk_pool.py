"""Whole-bucket mono SILK frame steps over packed int32 staging (row
layout). Port of esp32_opus_player_tpu/models/stream_pool.py:279-361,
:413-474 and :1868-1885: `silk_packed_frame` is _silk_step_body,
`silk_lossy_frame` is _silk_lossy_body (each row either decoded or
concealed), both with the bucket state updated in place;
`silk_pool_superstep` is _silk_pool_superstep(_lossy), which runs only the
frames it is given (a shorter last window) instead of padding to K, and
picks the lossy form per frame; `make_bucket` is _silk_bucket.

A bucket holds the streams of one internal rate fs, in row order
(identity rows, like the CELT pool), so no per-row gather or scatter
runs. Staging: one int32 row per stream and frame: the excitation
(frame), A_Q12 (2 x 16), B_Q14 (nb x 5), then 7 x nb parameters [gains,
inv_gain, lag, adj, voiced, rewhiten, match]; with plc=True (a pool that
conceals, rfc_plc) the PLC_COLS columns [glue, lost, A (16), B4 (4 x 5),
lag4 (4), inv_gain, prev_gain, cng_gain, cng_a (16), first]; then the
active flag. Inactive rows carry harmless parameters (`dummy_row`) and
keep their state bit for bit. A row that is not concealed in a lossy
frame carries the dummy conceal columns (zeros, lag 2 fs: kernel K8
indexes its lag directly, so the JAX pool's lag 0 would not do); a lost
row carries the dummy decode columns. Both halves run on every row and
the lost flag selects.

The two frame-sized conceal inputs (rand, cng_exc) do not ride with the
row: they come compact, one row per lost stream with its position, and
are made dense on the device (`index_copy_` into zeros), so the upload
grows with the lost share and not with the bucket.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.silk.cng_kernel import cng_add
from ..ops.silk.plc_kernel import silk_plc_conceal
from ..ops.silk.torch_core import (I32, MAX_LPC_ORDER, resample_batch,
                                   sfir_width, silk_core_frame)
from ..ops.silk.torch_plc import frame_energy, glue_frames

OUT_KHZ = 48
# glue, lost, A, B4, lag4, (inv_gain, prev_gain, cng_gain), cng_a, first
PLC_COLS = 2 + MAX_LPC_ORDER + 4 * 5 + 4 + 3 + MAX_LPC_ORDER + 1


def _decode_width(frame: int, nb: int) -> int:
    return frame + 2 * MAX_LPC_ORDER + 5 * nb + 7 * nb


def stage_width(frame: int, nb: int, plc: bool = False) -> int:
    return _decode_width(frame, nb) + (PLC_COLS if plc else 0) + 1


def dummy_row(fs: int, nb: int, plc: bool = False) -> np.ndarray:
    """The staging row of a stream that does not decode this frame
    (stream_pool.py:1847 _dummy_silk_params, inactive): lag 2 fs keeps
    every LTP read inside the state, in the decode columns and in the
    conceal columns alike."""
    frame = nb * 5 * fs
    row = np.zeros(stage_width(frame, nb, plc), dtype=np.int32)
    p = frame + 2 * MAX_LPC_ORDER + 5 * nb
    row[p:p + nb] = 1 << 16                  # gains
    row[p + nb:p + 2 * nb] = 1 << 15         # inv_gain
    row[p + 2 * nb:p + 3 * nb] = 2 * fs      # lag
    row[p + 3 * nb:p + 4 * nb] = 1 << 16     # adj
    row[p + 6 * nb:p + 7 * nb] = 1           # match
    if plc:
        q = p + 7 * nb + 2 + MAX_LPC_ORDER + 4 * 5
        row[q:q + 4] = 2 * fs                # conceal lag4
    return row


def conceal_cols(prep: dict) -> np.ndarray:
    """The PLC_COLS columns of a lost row from its conceal prep
    (models/batch_silk.py::NativePlcTracker.conceal_prep): glue 0, lost
    1, then the small per-row conceal inputs (stream_pool.py:526
    _stack_conceal_cols)."""
    cols = np.zeros(PLC_COLS, dtype=np.int32)
    cols[1] = 1
    o = 2
    cols[o:o + MAX_LPC_ORDER] = prep["A"]
    o += MAX_LPC_ORDER
    b4 = np.asarray(prep["B4"]).reshape(-1)
    cols[o:o + b4.size] = b4
    o += 4 * 5
    cols[o:o + len(prep["lag4"])] = prep["lag4"]
    o += 4
    cols[o:o + 3] = (prep["inv_gain"], prep["prev_gain"], prep["cng_gain"])
    o += 3
    cols[o:o + MAX_LPC_ORDER] = prep["cng_a"]
    cols[o + MAX_LPC_ORDER] = prep["cng_first"]
    return cols


def make_bucket(n: int, fs: int, device) -> dict:
    """Zero decoder state of n streams at internal rate fs (20 ms
    frames, 48 kHz out): the layout of the JAX pool's silk_buckets[fs],
    the concealment state (CNG synthesis state, the concealed frame's
    energy and its shift) included."""
    z = lambda *shape: torch.zeros(shape, dtype=I32, device=device)
    return dict(outBuf=z(n, 40 * fs), sLPC=z(n, MAX_LPC_ORDER),
                cng=z(n, MAX_LPC_ORDER), conc_e=z(n), conc_s=z(n),
                sIIR=z(n, 6), sFIR=z(n, sfir_width(fs, OUT_KHZ)),
                delay=z(n, fs), sMid=z(n, 2))


def _decode_half(st: dict, stg, fs: int, nb: int, order: int):
    """decode_core over the bucket from the row's decode columns."""
    frame = nb * 5 * fs
    a0 = frame
    b0 = a0 + 2 * MAX_LPC_ORDER
    p0 = b0 + 5 * nb
    exc = stg[:, :frame]
    A = stg[:, a0:b0].unflatten(1, (2, MAX_LPC_ORDER))
    Bq = stg[:, b0:p0].unflatten(1, (nb, 5))
    par = stg[:, p0:p0 + 7 * nb].unflatten(1, (7, nb))
    return silk_core_frame(
        st["outBuf"], st["sLPC"], exc, A, Bq, par[:, 0], par[:, 1],
        par[:, 2], par[:, 4] != 0, par[:, 5] != 0, par[:, 3],
        par[:, 6] != 0, fs_khz=fs, nb_subfr=nb, order=order)


def _finish(st: dict, new: dict, xq, xq_out, stg, *, fs: int, frame: int,
            masked: bool):
    """The tail both frame forms share: outBuf rolls the RAW signal xq,
    the resampler and sMid take the audible one xq_out, and the new
    state lands in place (under the active flag when masked). Returns
    the PCM (n, 20 ms at 48 kHz) int16."""
    n = xq.shape[0]
    ob = st["outBuf"]
    # outBuf's tail is this frame's slot
    new["outBuf"] = torch.cat([ob[:, frame:20 * fs], xq, torch.zeros(
        (n, 20 * fs), dtype=I32, device=xq.device)], dim=1)
    resin = torch.cat([st["sMid"][:, 1:2], xq_out[:, :-1]], dim=1)
    out48, new["sIIR"], new["sFIR"], new["delay"] = resample_batch(
        st["sIIR"], st["sFIR"], st["delay"], resin, fs_in_khz=fs,
        fs_out_khz=OUT_KHZ, in_len=frame)
    new["sMid"] = xq_out[:, frame - 2:frame]
    act = (stg[:, -1] != 0) if masked else None
    for k, v in new.items():
        if act is not None:
            v = torch.where(act if v.dim() == 1 else act[:, None], v, st[k])
        st[k].copy_(v)
    return out48.to(torch.int16)


def silk_packed_frame(st: dict, stg, *, fs: int, nb: int, order: int,
                      masked: bool, glue: bool = False):
    """One mono SILK frame over a whole bucket: decode_core, the outBuf
    roll and the resampler to 48 kHz. st (make_bucket) is updated in
    place; stg (n, stage_width) int32 on the state's device. Returns the
    PCM (n, 20 ms at 48 kHz) int16. masked=True honours the active flag:
    inactive rows keep their state bit for bit. glue=True (plc staging)
    smooths the audible frame of the rows whose glue flag is set, the
    first good frame after a loss run (silk_PLC_glue_frames)."""
    frame = nb * 5 * fs
    xq, sLPC = _decode_half(st, stg, fs, nb, order)
    xq_out = xq
    if glue:
        flags = stg[:, _decode_width(frame, nb)] != 0
        xq_out = glue_frames(xq, st["conc_e"], st["conc_s"], flags,
                             frame=frame)
    return _finish(st, dict(sLPC=sLPC), xq, xq_out, stg, fs=fs,
                   frame=frame, masked=masked)


def silk_lossy_frame(st: dict, stg, rand, cng_exc, *, fs: int, nb: int,
                     order: int, masked: bool):
    """One mono SILK frame in which each row is either decoded from its
    staged symbols or concealed, under the row's lost flag: both halves
    run on every row and the flag selects. stg has the plc columns; rand
    and cng_exc (n, frame) int32 are the dense frame-sized conceal
    inputs (zeros on rows that are not lost). Order, as src/silk.cpp:
    1974-2050: conceal (K8), outBuf takes the RAW concealed signal,
    comfort noise on the lost rows (K9), the glue's reference energy
    from the post-CNG frame, kept only on lost rows; decoded rows are
    glue-smoothed. State in place; returns the PCM int16."""
    frame = nb * 5 * fs
    q = _decode_width(frame, nb)
    glue = stg[:, q] != 0
    lost = stg[:, q + 1] != 0
    o = q + 2
    cA = stg[:, o:o + MAX_LPC_ORDER]
    o += MAX_LPC_ORDER
    cB4 = stg[:, o:o + 4 * 5].unflatten(1, (4, 5))
    o += 4 * 5
    clag4 = stg[:, o:o + 4]
    o += 4
    inv_gain, prev_gain, cng_gain = stg[:, o], stg[:, o + 1], stg[:, o + 2]
    o += 3
    cng_a = stg[:, o:o + MAX_LPC_ORDER]
    first = stg[:, o + MAX_LPC_ORDER] != 0

    xq_d, sLPC_d = _decode_half(st, stg, fs, nb, order)
    xq_c, sLPC_c = silk_plc_conceal(
        st["outBuf"], st["sLPC"], rand, cA, cB4, clag4, inv_gain,
        prev_gain, fs_khz=fs, nb_subfr=nb, order=order)
    lm = lost[:, None]
    xq = torch.where(lm, xq_c, xq_d)
    xq_dg = glue_frames(xq_d, st["conc_e"], st["conc_s"], glue,
                        frame=frame)
    state0 = torch.where((first & lost)[:, None], 0, st["cng"])
    xq_cng, cng2 = cng_add(xq_c, cng_exc, cng_a, cng_gain, state0, lost,
                           frame=frame, order=order)
    ce, cs = frame_energy(xq_cng, frame=frame)
    new = dict(sLPC=torch.where(lm, sLPC_c, sLPC_d), cng=cng2,
               conc_e=torch.where(lost, ce, st["conc_e"]),
               conc_s=torch.where(lost, cs, st["conc_s"]))
    return _finish(st, new, xq, torch.where(lm, xq_cng, xq_dg), stg,
                   fs=fs, frame=frame, masked=masked)


def silk_pool_superstep(st: dict, stgK, *, fs: int, nb: int, order: int,
                        masked, glue=None, conceal=None):
    """K frames in order: stgK (K, n, stage_width) int32; masked: K
    flags, one per frame. With plc staging: glue, K flags (a row of the
    frame has its glue flag set), and conceal = (offs, rows, vals): frame
    k's lost rows are rows[offs[k]:offs[k + 1]] (int64, on the device)
    and vals (m, 2 * frame) int32 holds their rand then cng_exc; a frame
    with lost rows runs `silk_lossy_frame`. State in place; returns pcmK
    (K, n, L48) int16."""
    K, n = stgK.shape[0], stgK.shape[1]
    frame = nb * 5 * fs
    pcmK = torch.empty((K, n, nb * 5 * OUT_KHZ), dtype=torch.int16,
                       device=stgK.device)
    kw = dict(fs=fs, nb=nb, order=order)
    for k in range(K):
        lo, hi = (conceal[0][k], conceal[0][k + 1]) if conceal else (0, 0)
        if hi > lo:
            dense = torch.zeros((n, 2 * frame), dtype=I32,
                                device=stgK.device)
            dense.index_copy_(0, conceal[1][lo:hi], conceal[2][lo:hi])
            pcmK[k] = silk_lossy_frame(st, stgK[k], dense[:, :frame],
                                       dense[:, frame:], masked=masked[k],
                                       **kw)
        else:
            pcmK[k] = silk_packed_frame(st, stgK[k], masked=masked[k],
                                        glue=bool(glue and glue[k]), **kw)
    return pcmK
