"""The card's peaks and the tally of launches against them.

A launch's least time is the larger of its bytes over the memory rate
and its operations over the peak rate of their type, the bytes and
operations counted by the kernel's own file in this folder from the
cell's shapes (each input byte read once, each output byte written once;
each product and each sum one operation; only what every input needs,
so a share never counts work a launch may skip). Dependent-chain floors
are latency estimates, not peaks, and are not charged.

Peaks: NVIDIA's H100 SXM data sheet at the full 700 W: 3.35 TB/s of HBM,
67 TFLOP/s float32 outside the tensor cores; int32 as 132 SMs x 64 INT32
lanes x 1980 MHz (the SM clock's maximum), as chip_smoke.py takes it.
"""
from __future__ import annotations

import re

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int32": 132 * 64 * 1.98e9, "float32": 67e12}


def least_s(nbytes: float, ops: float, kind: str) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[kind])


def tally(launches, counts: dict, shapes: dict):
    """launches: (name, device seconds) of every kernel launch. counts:
    {stem: module with NAME, MATCH, KIND, work(shapes) -> (bytes, ops)}.
    Returns (least s, device s, {NAME: (launches, least s, device s)})
    over the launches some module matches."""
    mods = [(re.compile(m.MATCH), m) for m in counts.values()]
    least = {}
    per = {}
    for name, dur in launches:
        for rx, m in mods:
            if rx.search(name):
                if m.NAME not in least:
                    least[m.NAME] = least_s(*m.work(shapes), m.KIND)
                n, lt, d = per.get(m.NAME, (0, 0.0, 0.0))
                per[m.NAME] = (n + 1, lt + least[m.NAME], d + dur)
                break
    return (sum(v[1] for v in per.values()),
            sum(v[2] for v in per.values()), per)
