"""CELT bit-exact fixed-point math primitives (scalar, host path).

Mirrors the reference math library (reference src/celt.cpp:3086-3202 and
inline helpers src/celt.h:430-531): integer sqrt, polynomial log2/exp2,
reciprocal and rsqrt approximations, bit-exact cos/log2tan used by the bit
allocator, and the LCG noise generator.

The port's copy of esp32_opus_player_tpu/ops/celt/math.py. celt_ilog2,
celt_rsqrt_norm and celt_lcg_rand also take numpy int64 arrays (uint64
for the LCG), element by element the same: the noise conceal's batches.
"""
from __future__ import annotations

import numpy as np

from ..fixed_point import (ADD16, ADD32, EC_ILOG, FRAC_MUL16, MULT16_16_P15,
                           MULT16_16_Q15, SHL16, SHR16, SUB16, SUB32, VSHR32,
                           s16, s32)

DB_SHIFT = 10


def celt_ilog2(x):
    assert x > 0 if isinstance(x, int) else np.all(x > 0)
    return EC_ILOG(x) - 1


def celt_zlog2(x: int) -> int:
    return 0 if x <= 0 else celt_ilog2(x)


def isqrt32(val: int) -> int:
    """floor(sqrt(val)) in exact integer arithmetic (src/celt.cpp:3086)."""
    g = 0
    bshift = (EC_ILOG(val) - 1) >> 1
    b = 1 << bshift
    while bshift >= 0:
        t = ((g << 1) + b) << bshift
        if t <= val:
            g += b
            val -= t
        b >>= 1
        bshift -= 1
    return g


def celt_rsqrt_norm(x: int) -> int:
    """Q16 in [0.25,1) -> Q14 reciprocal sqrt (src/celt.cpp:3108)."""
    n = s16(x - 32768)
    r = ADD16(23557, MULT16_16_Q15(n, ADD16(-13490, MULT16_16_Q15(n, 6713))))
    r2 = MULT16_16_Q15(r, r)
    y = SHL16(SUB16(ADD16(MULT16_16_Q15(r2, n), r2), 16384), 1)
    return ADD16(r, MULT16_16_Q15(
        r, MULT16_16_Q15(y, SUB16(MULT16_16_Q15(y, 12288), 16384))))


_SQRT_C = (23175, 11561, -3011, 1699, -664)


def celt_sqrt(x: int) -> int:
    """QX input, QX/2 output (src/celt.cpp:3130)."""
    if x == 0:
        return 0
    if x >= 1073741824:
        return 32767
    k = (celt_ilog2(x) >> 1) - 7
    x = VSHR32(x, 2 * k)
    n = s16(x - 32768)
    C = _SQRT_C
    rt = ADD16(C[0], MULT16_16_Q15(n, ADD16(C[1], MULT16_16_Q15(
        n, ADD16(C[2], MULT16_16_Q15(n, ADD16(C[3], MULT16_16_Q15(
            n, C[4]))))))))
    return VSHR32(rt, 7 - k)


def _celt_cos_pi_2(x: int) -> int:
    x2 = MULT16_16_P15(x, x)
    return ADD16(1, min(32766, ADD32(SUB16(32767, x2), MULT16_16_P15(
        x2, ADD32(-7651, MULT16_16_P15(x2, ADD32(8277, MULT16_16_P15(
            -626, x2))))))))


def celt_cos_norm(x: int) -> int:
    """(src/celt.cpp:3161)"""
    x = x & 0x0001FFFF
    if x > (1 << 16):
        x = SUB32(1 << 17, x)
    if x & 0x00007FFF:
        if x < (1 << 15):
            return _celt_cos_pi_2(s16(x))
        return -_celt_cos_pi_2(s16(65536 - x))
    if x & 0x0000FFFF:
        return 0
    if x & 0x0001FFFF:
        return -32767
    return 32767


def celt_rcp(x: int) -> int:
    """Q15 input -> Q16 reciprocal (src/celt.cpp:3180)."""
    assert x > 0
    i = celt_ilog2(x)
    n = s16(VSHR32(x, i - 15) - 32768)
    r = ADD16(30840, MULT16_16_Q15(-15420, n))
    r = SUB16(r, MULT16_16_Q15(r, ADD16(MULT16_16_Q15(r, n),
                                        ADD16(r, -32768))))
    r = SUB16(r, ADD16(1, MULT16_16_Q15(r, ADD16(MULT16_16_Q15(r, n),
                                                 ADD16(r, -32768)))))
    return VSHR32(r, i - 16)


def celt_div(a: int, b: int) -> int:
    from ..fixed_point import MULT32_32_Q31
    return MULT32_32_Q31(s32(a), celt_rcp(b))


_LOG2_C = (-6801 + (1 << (13 - DB_SHIFT)), 15746, -5217, 2545, -1401)


def celt_log2(x: int) -> int:
    """Q14 in -> Q10 out (src/celt.h:481)."""
    if x == 0:
        return -32767
    i = celt_ilog2(x)
    n = s16(VSHR32(x, i - 15) - 32768 - 16384)
    C = _LOG2_C
    frac = ADD16(C[0], MULT16_16_Q15(n, ADD16(C[1], MULT16_16_Q15(
        n, ADD16(C[2], MULT16_16_Q15(n, ADD16(C[3], MULT16_16_Q15(
            n, C[4]))))))))
    return s16(SHL16(i - 13, DB_SHIFT) + SHR16(frac, 14 - DB_SHIFT))


def celt_exp2_frac(x: int) -> int:
    frac = SHL16(x, 4)
    return ADD16(16383, MULT16_16_Q15(frac, ADD16(22804, MULT16_16_Q15(
        frac, ADD16(14819, MULT16_16_Q15(10204, frac))))))


def celt_exp2(x: int) -> int:
    """Q10 in -> Q16 out (src/celt.h:500)."""
    integer = SHR16(x, 10)
    if integer > 14:
        return 0x7F000000
    if integer < -15:
        return 0
    frac = celt_exp2_frac(s16(x - SHL16(integer, 10)))
    return VSHR32(frac, -integer - 2)


def celt_lcg_rand(seed: int) -> int:
    return (1664525 * seed + 1013904223) & 0xFFFFFFFF


def bitexact_cos(x: int) -> int:
    """(src/celt.cpp:919)"""
    tmp = (4096 + x * x) >> 13
    x2 = tmp
    x2 = (32767 - x2) + FRAC_MUL16(x2, -7651 + FRAC_MUL16(
        x2, 8277 + FRAC_MUL16(-626, x2)))
    return 1 + x2


def bitexact_log2tan(isin: int, icos: int) -> int:
    """(src/celt.cpp:934)"""
    lc = EC_ILOG(icos)
    ls = EC_ILOG(isin)
    icos = s32(icos << (15 - lc))
    isin = s32(isin << (15 - ls))
    return ((ls - lc) * (1 << 11)
            + FRAC_MUL16(isin, FRAC_MUL16(isin, -2597) + 7932)
            - FRAC_MUL16(icos, FRAC_MUL16(icos, -2597) + 7932))
