"""Decoder state between the JAX package and the port.

CELT: what a T-mode pool carries across frames, decode_mem in the
transposed layout, (CC, 2048+120, B) int32, and the deemphasis memory,
(B, CC) int32 — the layout of the JAX T-mode StreamPool.state; in a pool
that conceals (rfc_plc) also the pitch conceal's carried fit, plc_pitch
(B,) int32 and plc_lpc (B, CC, 24) float32.

Mono SILK: one bucket per internal rate fs, the JAX pool's
`silk_buckets[fs]` dict, one row per stream: outBuf (B, 40 fs), sLPC
(B, 16), sIIR (B, 6), sFIR (B, >= 8), delay (B, fs), sMid (B, 2) and the
loss-concealment state: cng (B, 16), the comfort-noise synthesis state,
and conc_e, conc_s (B,), the last concealed frame's energy and its
shift. All int32. The host's PLC trackers are not part of a bucket.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.celt.torch_synthesis import DECODE_BUFFER_SIZE, OVERLAP

SILK_KEYS = ("outBuf", "sLPC", "cng", "conc_e", "conc_s", "sIIR", "sFIR",
             "delay", "sMid")


def _i32(a) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype != np.int32:
        raise ValueError("decoder state must be int32")
    return a


def from_jax_state(state, preemph=None, *, device, rows=None,
                   plc_pitch=None, plc_lpc=None) -> dict:
    """The JAX pool's state as the port's state dict on `device`.

    CELT: from_jax_state(decode_mem, preemph, device=...) with arrays in
    the JAX T layout, and from a pool that conceals plc_pitch= and
    plc_lpc= as well (both or neither). SILK: from_jax_state(bucket,
    device=..., rows=...) with a JAX `silk_buckets[fs]` dict; rows picks
    the bucket rows of the port's bucket (its streams of that rate, in
    index order), all rows when None."""
    if isinstance(state, dict):
        if preemph is not None:
            raise ValueError("a SILK bucket takes no preemph")
        return _silk_from_jax(state, device, rows)
    dm, pre = _i32(state), _i32(preemph)
    CC, L, B = dm.shape
    if L != DECODE_BUFFER_SIZE + OVERLAP or pre.shape != (B, CC):
        raise ValueError(f"state shapes {dm.shape}, {pre.shape} are not "
                         f"(CC, {DECODE_BUFFER_SIZE + OVERLAP}, B), (B, CC)")
    out = {"decode_mem": torch.tensor(dm, device=device),
           "preemph": torch.tensor(pre, device=device)}
    if (plc_pitch is None) != (plc_lpc is None):
        raise ValueError("plc_pitch and plc_lpc go together")
    if plc_pitch is not None:
        pitch, lpc = _i32(plc_pitch), np.asarray(plc_lpc)
        if pitch.shape != (B,) or lpc.shape != (B, CC, 24) \
                or lpc.dtype != np.float32:
            raise ValueError(f"plc state {pitch.shape}, {lpc.shape} "
                             f"{lpc.dtype} is not (B,), (B, CC, 24) float32")
        out["plc_pitch"] = torch.tensor(pitch, device=device)
        out["plc_lpc"] = torch.tensor(lpc, device=device)
    return out


def _silk_from_jax(bucket: dict, device, rows) -> dict:
    arr = {k: _i32(v) for k, v in bucket.items()}
    missing = [k for k in SILK_KEYS if k not in arr]
    if missing:
        raise ValueError(f"SILK bucket lacks {missing}")
    B, width = arr["outBuf"].shape
    fs = width // 40
    want = dict(outBuf=(B, 40 * fs), sLPC=(B, 16), cng=(B, 16),
                conc_e=(B,), conc_s=(B,), sIIR=(B, 6), delay=(B, fs),
                sMid=(B, 2))
    bad = {k: arr[k].shape for k, s in want.items() if arr[k].shape != s}
    if bad or fs not in (8, 12, 16) or arr["sFIR"].shape[0] != B \
            or arr["sFIR"].shape[1] < 8:
        raise ValueError(
            f"not a mono SILK bucket: {bad or arr['sFIR'].shape}")
    sel = slice(None) if rows is None else np.asarray(rows, dtype=np.int64)
    return {k: torch.tensor(arr[k][sel], device=device) for k in SILK_KEYS}


def to_numpy(state: dict):
    """A copy of the port's state dict as numpy int32: (decode_mem,
    preemph) for a CELT state, a dict of the SILK_KEYS arrays for a SILK
    bucket."""
    def copy(t):
        return t.cpu().numpy().copy()
    if "decode_mem" in state:
        return copy(state["decode_mem"]), copy(state["preemph"])
    return {k: copy(state[k]) for k in SILK_KEYS}
