"""CELT fixed-point math of the noise conceal (host path).

The port's copy of what the noise branch of celt_decode_lost needs from
esp32_opus_player_tpu/ops/celt/math.py (reference src/celt.cpp:3108,
src/celt.h:430-531): the integer log2, the Q14 reciprocal square root
and the LCG noise generator. Each takes a Python int or a numpy int64
array (uint64 for the LCG), element by element the same.
"""
from __future__ import annotations

import numpy as np

from ..fixed_point import (ADD16, EC_ILOG, MULT16_16_Q15, SHL16, SUB16,
                           s16)


def celt_ilog2(x):
    assert np.all(x > 0)
    return EC_ILOG(x) - 1


def celt_rsqrt_norm(x):
    """Q16 in [0.25,1) -> Q14 reciprocal sqrt (src/celt.cpp:3108)."""
    n = s16(x - 32768)
    r = ADD16(23557, MULT16_16_Q15(n, ADD16(-13490, MULT16_16_Q15(n, 6713))))
    r2 = MULT16_16_Q15(r, r)
    y = SHL16(SUB16(ADD16(MULT16_16_Q15(r2, n), r2), 16384), 1)
    return ADD16(r, MULT16_16_Q15(
        r, MULT16_16_Q15(y, SUB16(MULT16_16_Q15(y, 12288), 16384))))


def celt_lcg_rand(seed):
    return (1664525 * seed + 1013904223) & 0xFFFFFFFF
