"""Whole-bucket SILK frame steps over packed int32 staging (row layout),
mono and stereo, 10 or 20 ms device frames. Port of
esp32_opus_player_tpu/models/stream_pool.py:279-361, :413-474, :590-968
and :1822-1885: `silk_frame` is _silk_step_body and _silk_lossy_body
(mono, each row decoded or concealed) and _silk2_step_body and
_silk2_lossy_body (stereo), with the bucket state updated in place;
`silk_pool_superstep` is _silk_pool_superstep(_lossy) and
_silk2_pool_superstep(_lossy), which runs only the frames it is given (a
shorter last window) instead of padding to K, and picks the lossy form
per frame; `make_bucket` is _silk_bucket and _silk2_bucket. The JAX
pool's conceal-only stereo step (_silk2_plc_pool_step) is the lossy frame
with every row lost, so it has no form of its own here.

A bucket holds the streams of one lane in row order (identity rows, like
the CELT pool), so no per-row gather or scatter runs. A stereo bucket
keeps each stream's two channels side by side, (n, 2, ...): mid and side
for the core state, L and R for the resampler's, so the 2n channel rows
of a frame are one view of the bucket and run as ONE call of each
kernel, as the JAX pool runs mid and side as one 2n-row core call.

Staging: one int32 row per stream and channel and frame: the excitation
(frame), A_Q12 (2 x 16), B_Q14 (nb x 5), then 7 x nb parameters [gains,
inv_gain, lag, adj, voiced, rewhiten, match]; with plc=True (a pool that
conceals, rfc_plc) the PLC_COLS columns [glue, lost, A (16), B4 (4 x 5),
lag4 (4), inv_gain, prev_gain, cng_gain, cng_a (16), first]; with
stereo=True the STEREO_COLS columns [has_ch, side_reset, pred (2)]; then
the active flag. Inactive rows carry harmless parameters (`dummy_row`)
and keep their state bit for bit. A row that is not concealed in a lossy
frame carries the dummy conceal columns (zeros, lag 2 fs: kernel K8
indexes its lag directly, so the JAX pool's lag 0 would not do); a lost
row carries the dummy decode columns. Both halves run on every row and
the lost flag selects.

Stereo: has_ch is 1 on every mid row and, on a side row, says whether
the frame has a side channel (decoded: the packet coded one; concealed:
the previous frame had one). A side row without it keeps its core state
and gives a zero side frame (silk_Decode :397-415); side_reset (a side
that comes back) zeroes its outBuf and sLPC before the frame; pred, on
the mid row, is the frame's predictor pair (a concealed frame's is the
last good frame's). The unmix is kernel S1 (ops/silk/stereo_kernel.py).

The two frame-sized conceal inputs (rand, cng_exc) do not ride with the
row: they come compact, one row per lost channel row with its position,
and are made dense on the device (`index_copy_` into zeros), so the
upload grows with the lost share and not with the bucket.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.silk.cng_kernel import cng_add
from ..ops.silk.plc_kernel import silk_plc_conceal
from ..ops.silk.stereo_kernel import ms_to_lr
from ..ops.silk.torch_core import (I32, MAX_LPC_ORDER, resample_batch,
                                   sfir_width, silk_core_frame)
from ..ops.silk.torch_plc import frame_energy, glue_frames

OUT_KHZ = 48
# glue, lost, A, B4, lag4, (inv_gain, prev_gain, cng_gain), cng_a, first
PLC_COLS = 2 + MAX_LPC_ORDER + 4 * 5 + 4 + 3 + MAX_LPC_ORDER + 1
# has_ch, side_reset, pred (2)
STEREO_COLS = 4


def _decode_width(frame: int, nb: int) -> int:
    return frame + 2 * MAX_LPC_ORDER + 5 * nb + 7 * nb


def stage_width(frame: int, nb: int, plc: bool = False,
                stereo: bool = False) -> int:
    return (_decode_width(frame, nb) + (PLC_COLS if plc else 0)
            + (STEREO_COLS if stereo else 0) + 1)


def dummy_row(fs: int, nb: int, plc: bool = False,
              stereo: bool = False) -> np.ndarray:
    """The staging row of a stream (or channel) that does not decode this
    frame (stream_pool.py:1847 _dummy_silk_params, inactive): lag 2 fs
    keeps every LTP read inside the state, in the decode columns and in
    the conceal columns alike."""
    frame = nb * 5 * fs
    row = np.zeros(stage_width(frame, nb, plc, stereo), dtype=np.int32)
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


def decode_cols(stg, rows, b, frame: int, nb: int) -> None:
    """Write the decode columns of buffer rows `rows` (a SilkGroup's
    _SilkBuffers, whose per-subframe columns are 4 wide) into the
    staging rows `rows` of stg (numpy, (n, width))."""
    F, p = frame, frame + 2 * MAX_LPC_ORDER + 5 * nb
    stg[rows, :F] = b.exc[rows, :F]
    stg[rows, F:F + 2 * MAX_LPC_ORDER] = b.A[rows].reshape(-1, 32)
    stg[rows, F + 2 * MAX_LPC_ORDER:p] = b.B[rows, :nb].reshape(-1, 5 * nb)
    for j, col in enumerate((b.gains, b.inv, b.lag, b.adj)):
        stg[rows, p + nb * j:p + nb * (j + 1)] = col[rows, :nb]
    for j in range(3):                       # voiced, rewhiten, match
        stg[rows, p + nb * (4 + j):p + nb * (5 + j)] = \
            b.flags[rows, 4 * j:4 * j + nb]


def conceal_cols(prep: dict) -> np.ndarray:
    """The PLC_COLS columns of a lost row from its conceal prep
    (models/batch_silk.py::NativePlcTracker.conceal_prep): glue 0, lost
    1, then the small per-row conceal inputs (stream_pool.py:526
    _stack_conceal_cols; B4 and lag4 padded to 4 subframes)."""
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


def make_bucket(n: int, fs: int, device, stereo: bool = False) -> dict:
    """Zero decoder state of n streams at internal rate fs (up to 20 ms
    frames, 48 kHz out): the layout of the JAX pool's silk_buckets[fs]
    (mono) or silk2_buckets[fs] (stereo: every per-channel entry (n, 2,
    ...), plus the unmix state pred_prev and sSide; sMid is the 2-sample
    mid history there, the resampler input's 1-sample delay in mono),
    the concealment state (CNG synthesis state, the concealed frame's
    energy and its shift) included."""
    c = (2,) if stereo else ()
    z = lambda *shape: torch.zeros(shape, dtype=I32, device=device)
    st = dict(outBuf=z(n, *c, 40 * fs), sLPC=z(n, *c, MAX_LPC_ORDER),
              cng=z(n, *c, MAX_LPC_ORDER), conc_e=z(n, *c),
              conc_s=z(n, *c), sIIR=z(n, *c, 6),
              sFIR=z(n, *c, sfir_width(fs, OUT_KHZ)), delay=z(n, *c, fs),
              sMid=z(n, 2))
    if stereo:
        st.update(pred_prev=z(n, 2), sSide=z(n, 2))
    return st


_CORE = ("outBuf", "sLPC", "cng", "conc_e", "conc_s")
_RESAMPLER = ("sIIR", "sFIR", "delay")


def _rows(t, stereo: bool):
    """A bucket entry as its channel rows: (n, 2, ...) -> (2n, ...)."""
    return t.flatten(0, 1) if stereo else t


def silk_frame(st: dict, stg, rand=None, cng_exc=None, *, fs: int, nb: int,
               order: int, masked: bool, glue: bool = False,
               stereo: bool = False):
    """One SILK frame over a whole bucket. stg: (n, width) int32 staging
    (mono) or (n, 2, width) (stereo) on the state's device. Without
    rand, every active row decodes its staged symbols (decode_core, K7);
    glue=True (plc staging) smooths the audible frame of the rows whose
    glue flag is set, the first good frame after a loss run
    (silk_PLC_glue_frames). With rand and cng_exc ((rows, frame) int32,
    the dense conceal inputs, zeros on rows that are not lost; plc
    staging), each row is decoded or concealed under its lost flag: both
    halves run on every row and the flag selects. Order, as
    src/silk.cpp:1974-2050: conceal (K8), outBuf takes the RAW concealed
    signal, comfort noise on the lost rows (K9), the glue's reference
    energy from the post-CNG frame, kept only on lost rows; decoded rows
    are glue-smoothed. Then the outBuf roll of the raw signal, the
    unmix (stereo, S1) and the resampler to 48 kHz (K6) of the audible
    one. masked=True honours the active flag: inactive rows keep their
    state bit for bit. State in place; returns the PCM, (n, L48) or (n,
    2, L48) int16."""
    frame = nb * 5 * fs
    rows = _rows(stg, stereo)
    R = rows.shape[0]
    core = {k: _rows(st[k], stereo) for k in _CORE}
    ob, sl = core["outBuf"], core["sLPC"]
    upd = (rows[:, -1] != 0) if masked else None
    if stereo:
        has_ch = rows[:, -5] != 0
        reset = (rows[:, -4] != 0)[:, None]
        ob, sl = torch.where(reset, 0, ob), torch.where(reset, 0, sl)
        upd = has_ch if upd is None else upd & has_ch
    a0, p0 = frame + 2 * MAX_LPC_ORDER, frame + 2 * MAX_LPC_ORDER + 5 * nb
    par = rows[:, p0:p0 + 7 * nb].unflatten(1, (7, nb))
    xq_d, sLPC_d = silk_core_frame(
        ob, sl, rows[:, :frame],
        rows[:, frame:a0].unflatten(1, (2, MAX_LPC_ORDER)),
        rows[:, a0:p0].unflatten(1, (nb, 5)), par[:, 0], par[:, 1],
        par[:, 2], par[:, 4] != 0, par[:, 5] != 0, par[:, 3],
        par[:, 6] != 0, fs_khz=fs, nb_subfr=nb, order=order)
    q = _decode_width(frame, nb)
    if rand is None:
        xq, aud = xq_d, xq_d
        if glue:
            aud = glue_frames(xq_d, core["conc_e"], core["conc_s"],
                              rows[:, q] != 0, frame=frame)
        new = dict(sLPC=sLPC_d)
    else:
        gl, lost = rows[:, q] != 0, rows[:, q + 1] != 0
        o = q + 2
        cA = rows[:, o:o + MAX_LPC_ORDER]
        o += MAX_LPC_ORDER
        cB4 = rows[:, o:o + 4 * 5].unflatten(1, (4, 5))
        o += 4 * 5
        clag4 = rows[:, o:o + 4]
        o += 4
        inv_gain, prev_gain, cng_gain = rows[:, o], rows[:, o + 1], \
            rows[:, o + 2]
        o += 3
        cng_a = rows[:, o:o + MAX_LPC_ORDER]
        first = rows[:, o + MAX_LPC_ORDER] != 0
        xq_c, sLPC_c = silk_plc_conceal(
            ob, sl, rand, cA, cB4, clag4, inv_gain, prev_gain, fs_khz=fs,
            nb_subfr=nb, order=order)
        lm = lost[:, None]
        xq = torch.where(lm, xq_c, xq_d)
        xq_dg = glue_frames(xq_d, core["conc_e"], core["conc_s"], gl,
                            frame=frame)
        state0 = torch.where((first & lost)[:, None], 0, core["cng"])
        xq_cng, cng2 = cng_add(xq_c, cng_exc, cng_a, cng_gain, state0, lost,
                               frame=frame, order=order)
        ce, cs = frame_energy(xq_cng, frame=frame)
        aud = torch.where(lm, xq_cng, xq_dg)
        new = dict(sLPC=torch.where(lm, sLPC_c, sLPC_d), cng=cng2,
                   conc_e=torch.where(lost, ce, core["conc_e"]),
                   conc_s=torch.where(lost, cs, core["conc_s"]))
    # outBuf's tail is this frame's slot; it rolls the RAW signal
    new["outBuf"] = torch.cat([ob[:, frame:20 * fs], xq, torch.zeros(
        (R, 20 * fs), dtype=I32, device=xq.device)], dim=1)
    # a row that does not update keeps its state; a side that resets
    # without a frame (an FEC frame without an LBRR copy) keeps it zeroed
    old = dict(core, outBuf=ob, sLPC=sl)
    for k, v in new.items():
        if upd is not None:
            v = torch.where(upd if v.dim() == 1 else upd[:, None], v,
                            old[k])
        core[k].copy_(v)
    act = (stg[..., -1] != 0) if masked else None
    if stereo:
        aud = torch.where(has_ch[:, None], aud, 0).view(-1, 2, frame)
        pred = stg[:, 0, -3:-1]
        resin, sMid, sSide = ms_to_lr(st["sMid"], st["sSide"],
                                      st["pred_prev"], aud, pred, fs_khz=fs,
                                      frame=frame)
        stream = dict(sMid=sMid, sSide=sSide, pred_prev=pred)
        resin = resin.flatten(0, 1)
    else:
        resin = torch.cat([st["sMid"][:, 1:2], aud[:, :-1]], dim=1)
        stream = dict(sMid=aud[:, frame - 2:frame])
    res = {k: _rows(st[k], stereo) for k in _RESAMPLER}
    out48, *res_new = resample_batch(
        res["sIIR"], res["sFIR"], res["delay"], resin, fs_in_khz=fs,
        fs_out_khz=OUT_KHZ, in_len=frame)
    act_r = _rows(act, stereo) if masked else None
    for k, v in zip(_RESAMPLER, res_new):
        if masked:
            v = torch.where(act_r[:, None], v, res[k])
        res[k].copy_(v)
    for k, v in stream.items():
        if masked:
            v = torch.where(act[:, 0:1] if stereo else act[:, None], v,
                            st[k])
        st[k].copy_(v)
    out48 = out48.to(torch.int16)
    return out48.view(-1, 2, out48.shape[-1]) if stereo else out48


def silk_pool_superstep(st: dict, stgK, *, fs: int, nb: int, order: int,
                        masked, glue=None, conceal=None,
                        stereo: bool = False):
    """K frames in order: stgK (K, n, width) or, stereo, (K, n, 2, width)
    int32; masked: K flags, one per frame. With plc staging: glue, K
    flags (a row of the frame has its glue flag set), and conceal =
    (offs, rows, vals): frame k's lost rows are rows[offs[k]:offs[k + 1]]
    (int64 channel-row positions, stream s's channel c at 2 s + c in a
    stereo bucket; on the device) and vals (m, 2 * frame) int32 holds
    their rand then cng_exc; a frame with lost rows runs the lossy form.
    State in place; returns pcmK (K, n, L48) or (K, n, 2, L48) int16."""
    K, n = stgK.shape[0], stgK.shape[1]
    frame = nb * 5 * fs
    R = 2 * n if stereo else n
    pcmK = torch.empty((K, n) + ((2,) if stereo else ()) + (nb * 5 * OUT_KHZ,),
                       dtype=torch.int16, device=stgK.device)
    kw = dict(fs=fs, nb=nb, order=order, stereo=stereo)
    for k in range(K):
        lo, hi = (conceal[0][k], conceal[0][k + 1]) if conceal else (0, 0)
        if hi > lo:
            dense = torch.zeros((R, 2 * frame), dtype=I32,
                                device=stgK.device)
            dense.index_copy_(0, conceal[1][lo:hi], conceal[2][lo:hi])
            pcmK[k] = silk_frame(st, stgK[k], dense[:, :frame],
                                 dense[:, frame:], masked=masked[k], **kw)
        else:
            pcmK[k] = silk_frame(st, stgK[k], masked=masked[k],
                                 glue=bool(glue and glue[k]), **kw)
    return pcmK
