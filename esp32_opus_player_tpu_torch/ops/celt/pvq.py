"""The band renormalisation of the CELT noise conceal (host path).

The port's copy of esp32_opus_player_tpu/ops/celt/pvq.py::
renormalise_vector and celt_inner_prod (reference src/celt.cpp
renormalise_vector): scale a band of X to unit energy at Q15 `gain`.
Vectors lie along the last axis of a numpy int64 array; every vector of
the array is renormalised on its own, as the scalar loop would.
"""
from __future__ import annotations

import numpy as np

from ..fixed_point import MULT16_16, MULT16_16_P15, PSHR32, VSHR32, s16, s32
from .math import celt_ilog2, celt_rsqrt_norm


def celt_inner_prod(x, y, N: int):
    """The int32 running sum of x[i] y[i], i < N (its wraps sum modulo
    2^32 like one wrapped total)."""
    return s32(np.sum(MULT16_16(x[..., :N], y[..., :N]), axis=-1))


def renormalise_vector(X, N: int, gain: int) -> None:
    """X[..., :N] (a numpy int64 array, updated in place)."""
    E = 1 + celt_inner_prod(X, X, N)
    k = celt_ilog2(E) >> 1
    t = VSHR32(E, 2 * (k - 7))
    g = MULT16_16_P15(celt_rsqrt_norm(t), gain)
    X[..., :N] = s16(PSHR32(MULT16_16(np.expand_dims(g, -1), X[..., :N]),
                            np.expand_dims(k + 1, -1)))
