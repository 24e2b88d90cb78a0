"""PVQ unquantization: CWRS index -> pulse vector -> normalized band.

Mirrors the reference PVQ layer (reference src/celt.cpp: cwrsi :2545,
decode_pulses :2622, alg_unquant :782, normalise_residual :744,
exp_rotation(1) :684-739, extract_collapse_mask :758, renormalise_vector
:797; RFC 6716 §4.3.4.*). Operates on numpy int arrays (views into the
frame's X buffer) with scalar fixed-point arithmetic on the host.

The port's copy of esp32_opus_player_tpu/ops/celt/pvq.py.
celt_inner_prod and renormalise_vector take vectors along the last axis
of a numpy int64 array, each vector on its own as the scalar loop would:
one band of the scalar decoder, or every band of the noise conceal's
rows at once.
"""
from __future__ import annotations

import numpy as np

from ..fixed_point import (MAC16_16, MULT16_16, MULT16_16_P15, MULT16_16_Q15,
                           PSHR32, VSHR32, celt_udiv, s16, s32)
from ..tables.celt_tables import CELT_PVQ_U_DATA, row_idx
from .math import celt_div, celt_cos_norm, celt_ilog2, celt_rsqrt_norm

SPREAD_NONE = 0
SPREAD_NORMAL = 2
SPREAD_AGGRESSIVE = 3

_U = CELT_PVQ_U_DATA.astype(np.int64)
_ROW = row_idx.astype(np.int64)


def pvq_u(n: int, k: int) -> int:
    lo, hi = (n, k) if n < k else (k, n)
    return int(_U[_ROW[lo] + hi])


def pvq_v(n: int, k: int) -> int:
    return pvq_u(n, k) + pvq_u(n, k + 1)


def cwrsi(n: int, k: int, i: int, y) -> int:
    """Index -> pulse vector; returns Ryy (src/celt.cpp:2545)."""
    assert k > 0 and n > 1
    yy = 0
    pos = 0
    while n > 2:
        if k >= n:
            row = _ROW[n]
            p = int(_U[row + k + 1])
            s = -1 if i >= p else 0
            if s:
                i -= p
            k0 = k
            q = int(_U[row + n])
            if q > i:
                k = n
                while True:
                    k -= 1
                    p = pvq_u(k, n)
                    if p <= i:
                        break
            else:
                while True:
                    p = int(_U[row + k])
                    if p <= i:
                        break
                    k -= 1
            i -= p
            val = (k0 - k + s) ^ s
            y[pos] = val
            pos += 1
            yy = MAC16_16(yy, val, val)
        else:
            p = pvq_u(k, n)
            q = pvq_u(k + 1, n)
            if p <= i < q:
                i -= p
                y[pos] = 0
                pos += 1
            else:
                s = -1 if i >= q else 0
                if s:
                    i -= q
                k0 = k
                while True:
                    k -= 1
                    p = pvq_u(k, n)
                    if p <= i:
                        break
                i -= p
                val = (k0 - k + s) ^ s
                y[pos] = val
                pos += 1
                yy = MAC16_16(yy, val, val)
        n -= 1
    # n == 2
    p = 2 * k + 1
    s = -1 if i >= p else 0
    if s:
        i -= p
    k0 = k
    k = (i + 1) >> 1
    if k:
        i -= 2 * k - 1
    val = (k0 - k + s) ^ s
    y[pos] = val
    pos += 1
    yy = MAC16_16(yy, val, val)
    # n == 1
    s = -i
    val = (k + s) ^ s
    y[pos] = val
    yy = MAC16_16(yy, val, val)
    return yy


def decode_pulses(dec, y, n: int, k: int) -> int:
    return cwrsi(n, k, dec.dec_uint(pvq_v(n, k)), y)


def normalise_residual(iy, X, N: int, Ryy: int, gain: int) -> None:
    k = celt_ilog2(Ryy) >> 1
    t = VSHR32(Ryy, 2 * (k - 7))
    g = MULT16_16_P15(celt_rsqrt_norm(t), gain)
    for i in range(N):
        X[i] = s16(PSHR32(MULT16_16(g, int(iy[i])), k + 1))


def exp_rotation1(X, start: int, length: int, stride: int, c: int, s: int):
    ms = -s
    p = start
    for _ in range(length - stride):
        x1 = int(X[p])
        x2 = int(X[p + stride])
        X[p + stride] = s16(PSHR32(MAC16_16(MULT16_16(c, x2), s, x1), 15))
        X[p] = s16(PSHR32(MAC16_16(MULT16_16(c, x1), ms, x2), 15))
        p += 1
    p = start + length - 2 * stride - 1
    for _ in range(length - 2 * stride):
        x1 = int(X[p])
        x2 = int(X[p + stride])
        X[p + stride] = s16(PSHR32(MAC16_16(MULT16_16(c, x2), s, x1), 15))
        X[p] = s16(PSHR32(MAC16_16(MULT16_16(c, x1), ms, x2), 15))
        p -= 1


_SPREAD_FACTOR = (15, 10, 5)


def exp_rotation(X, length: int, direction: int, stride: int, K: int,
                 spread: int) -> None:
    if 2 * K >= length or spread == SPREAD_NONE:
        return
    factor = _SPREAD_FACTOR[spread - 1]
    gain = celt_div(MULT16_16(32767, length), length + factor * K)
    theta = MULT16_16_Q15(gain, gain) >> 1

    c = celt_cos_norm(theta)
    s = celt_cos_norm(32767 - theta)

    stride2 = 0
    if length >= 8 * stride:
        stride2 = 1
        while (stride2 * stride2 + stride2) * stride + (stride >> 2) < length:
            stride2 += 1
    length = celt_udiv(length, stride)
    for i in range(stride):
        if direction < 0:
            if stride2:
                exp_rotation1(X, i * length, length, stride2, s, c)
            exp_rotation1(X, i * length, length, 1, c, s)
        else:
            exp_rotation1(X, i * length, length, 1, c, -s)
            if stride2:
                exp_rotation1(X, i * length, length, stride2, s, -c)


def extract_collapse_mask(iy, N: int, B: int) -> int:
    if B <= 1:
        return 1
    N0 = celt_udiv(N, B)
    collapse_mask = 0
    for i in range(B):
        if np.any(iy[i * N0:(i + 1) * N0]):
            collapse_mask |= 1 << i
    return collapse_mask


def alg_unquant(dec, X, N: int, K: int, spread: int, B: int,
                gain: int) -> int:
    """(src/celt.cpp:782)"""
    assert K > 0 and N > 1
    iy = np.zeros(N + 3, dtype=np.int64)
    Ryy = decode_pulses(dec, iy, N, K)
    normalise_residual(iy, X, N, Ryy, gain)
    exp_rotation(X, N, -1, B, K, spread)
    return extract_collapse_mask(iy, N, B)


def celt_inner_prod(x, y, N: int):
    """The int32 running sum of x[i] y[i], i < N (its wraps sum modulo
    2^32 like one wrapped total)."""
    return s32(np.sum(MULT16_16(x[..., :N], y[..., :N]), axis=-1))


def dual_inner_prod(x, y01, y02, N: int):
    xy1 = xy2 = 0
    for i in range(N):
        xy1 = MAC16_16(xy1, int(x[i]), int(y01[i]))
        xy2 = MAC16_16(xy2, int(x[i]), int(y02[i]))
    return xy1, xy2


def renormalise_vector(X, N: int, gain: int) -> None:
    E = 1 + celt_inner_prod(X, X, N)
    k = celt_ilog2(E) >> 1
    t = VSHR32(E, 2 * (k - 7))
    g = MULT16_16_P15(celt_rsqrt_norm(t), gain)
    X[..., :N] = s16(PSHR32(MULT16_16(np.expand_dims(g, -1), X[..., :N]),
                            np.expand_dims(k + 1, -1)))
