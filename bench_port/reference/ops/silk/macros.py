"""SILK fixed-point macro layer (scalar, host path).

Semantics mirror the reference (reference src/silk.h:50-166, 427-530,
845-1006): SMULWB-family 16/32-bit products with 64-bit intermediates
truncated (rounded toward -inf by arithmetic shifts), saturating adds,
the LCG (silk_RAND), SQRT_APPROX and varQ division/inversion helpers.

The port's copy of esp32_opus_player_tpu/ops/silk/macros.py (numpy and
Python ints; nothing of the JAX package is imported).
"""
from __future__ import annotations

INT32_MAX = 0x7FFFFFFF
INT32_MIN = -0x80000000
_M32 = 0xFFFFFFFF


def s32(x: int) -> int:
    x &= _M32
    return x - 0x100000000 if x & 0x80000000 else x


def s16(x: int) -> int:
    x &= 0xFFFF
    return x - 0x10000 if x & 0x8000 else x


def u32(x: int) -> int:
    return x & _M32


def SAT16(a: int) -> int:
    return 32767 if a > 32767 else (-32768 if a < -32768 else a)


def SAT32(a: int) -> int:
    return INT32_MAX if a > INT32_MAX else (INT32_MIN if a < INT32_MIN
                                            else a)


def SMULWB(a: int, b: int) -> int:
    return s32((s32(a) * s16(b)) >> 16)


def SMLAWB(a: int, b: int, c: int) -> int:
    return s32(s32(a) + ((s32(b) * s16(c)) >> 16))


def SMULWT(a: int, b: int) -> int:
    return s32((s32(a) * (s32(b) >> 16)) >> 16)


def SMLAWT(a: int, b: int, c: int) -> int:
    return s32(s32(a) + ((s32(b) * (s32(c) >> 16)) >> 16))


def SMULBB(a: int, b: int) -> int:
    return s32(s16(a) * s16(b))


def SMLABB(a: int, b: int, c: int) -> int:
    return s32(s32(a) + s16(b) * s16(c))


def SMULBT(a: int, b: int) -> int:
    return s32(s16(a) * (s32(b) >> 16))


def SMLABT(a: int, b: int, c: int) -> int:
    return s32(s32(a) + s16(b) * (s32(c) >> 16))


def SMULWW(a: int, b: int) -> int:
    return s32((s32(a) * s32(b)) >> 16)


def SMLAWW(a: int, b: int, c: int) -> int:
    return s32(s32(a) + ((s32(b) * s32(c)) >> 16))


def SMULTT(a: int, b: int) -> int:
    return s32((s32(a) >> 16) * (s32(b) >> 16))


def SMMUL(a: int, b: int) -> int:
    return s32((s32(a) * s32(b)) >> 32)


def MLA(a: int, b: int, c: int) -> int:
    return s32(s32(a) + s32(b) * s32(c))


def MUL(a: int, b: int) -> int:
    return s32(s32(a) * s32(b))


def ADD32(a: int, b: int) -> int:
    return s32(s32(a) + s32(b))


def SUB32(a: int, b: int) -> int:
    return s32(s32(a) - s32(b))


def ADD32_ovflw(a: int, b: int) -> int:
    return s32(u32(a) + u32(b))


def SUB32_ovflw(a: int, b: int) -> int:
    return s32(u32(a) - u32(b))


def MLA_ovflw(a: int, b: int, c: int) -> int:
    return s32(u32(a) + u32(u32(b) * u32(c)))


def SMLABB_ovflw(a: int, b: int, c: int) -> int:
    return s32(u32(a) + u32(s16(b) * s16(c)))


def ADD_SAT32(a: int, b: int) -> int:
    return SAT32(s32(a) + s32(b))


def SUB_SAT32(a: int, b: int) -> int:
    return SAT32(s32(a) - s32(b))


def ADD_SAT16(a: int, b: int) -> int:
    return SAT16(s32(a) + s32(b))


def LSHIFT32(a: int, shift: int) -> int:
    return s32((u32(a) << shift) & _M32)


def LSHIFT_ovflw(a: int, shift: int) -> int:
    return LSHIFT32(a, shift)


def RSHIFT32(a: int, shift: int) -> int:
    return s32(a) >> shift


def RSHIFT_ROUND(a: int, shift: int) -> int:
    a = s32(a)
    if shift == 1:
        return (a >> 1) + (a & 1)
    return ((a >> (shift - 1)) + 1) >> 1


def LSHIFT_SAT32(a: int, shift: int) -> int:
    lo = INT32_MIN >> shift
    hi = INT32_MAX >> shift
    a = s32(a)
    a = lo if a < lo else (hi if a > hi else a)
    return LSHIFT32(a, shift)


def LIMIT(a: int, l1: int, l2: int) -> int:
    if l1 > l2:
        return l1 if a > l1 else (l2 if a < l2 else a)
    return l2 if a > l2 else (l1 if a < l1 else a)


def silk_abs(a: int) -> int:
    return a if a > 0 else -a


def silk_min(a: int, b: int) -> int:
    return a if a < b else b


def silk_max(a: int, b: int) -> int:
    return a if a > b else b


def silk_sign(a: int) -> int:
    return 1 if a > 0 else (-1 if a < 0 else 0)


def CLZ32(x: int) -> int:
    x = s32(x)
    if x == 0:
        return 32
    return 32 - u32(x).bit_length() if x > 0 else 32 - 32
    # note: negative x has bit 31 set -> clz 0


def CLZ16(x: int) -> int:
    v = ((s16(x) << 16) | 0x8000) & _M32
    return 32 - v.bit_length()


RAND_MULTIPLIER = 196314165
RAND_INCREMENT = 907633515


def silk_RAND(seed: int) -> int:
    return MLA_ovflw(RAND_INCREMENT, seed, RAND_MULTIPLIER)


def ROR32(a32: int, rot: int) -> int:
    x = u32(a32)
    if rot == 0:
        return s32(x)
    if rot < 0:
        m = -rot
        return s32(((x << m) | (x >> (32 - m))) & _M32)
    return s32(((x << (32 - rot)) | (x >> rot)) & _M32)


def CLZ_FRAC(x: int):
    lz = CLZ32(x)
    frac_q7 = ROR32(x, 24 - lz) & 0x7F
    return lz, frac_q7


def SQRT_APPROX(x: int) -> int:
    if s32(x) <= 0:
        return 0
    lz, frac_q7 = CLZ_FRAC(x)
    y = 32768 if (lz & 1) else 46214
    y >>= lz >> 1
    return SMLAWB(y, y, SMULBB(213, frac_q7))


def DIV32_16(a: int, b: int) -> int:
    q = abs(a) // abs(b)
    return s32(-q if (a < 0) != (b < 0) else q)


def DIV32(a: int, b: int) -> int:
    return DIV32_16(a, b)


def DIV32_varQ(a32: int, b32: int, qres: int) -> int:
    assert b32 != 0 and qres >= 0
    a_headrm = CLZ32(silk_abs(a32)) - 1
    a32_nrm = LSHIFT32(a32, a_headrm)
    b_headrm = CLZ32(silk_abs(b32)) - 1
    b32_nrm = LSHIFT32(b32, b_headrm)
    b32_inv = DIV32_16(INT32_MAX >> 2, RSHIFT32(b32_nrm, 16))
    result = SMULWB(a32_nrm, b32_inv)
    a32_nrm = SUB32_ovflw(a32_nrm, LSHIFT_ovflw(SMMUL(b32_nrm, result), 3))
    result = SMLAWB(result, a32_nrm, b32_inv)
    lshift = 29 + a_headrm - b_headrm - qres
    if lshift < 0:
        return LSHIFT_SAT32(result, -lshift)
    if lshift < 32:
        return RSHIFT32(result, lshift)
    return 0


def INVERSE32_varQ(b32: int, qres: int) -> int:
    assert b32 != 0 and qres > 0
    b_headrm = CLZ32(silk_abs(b32)) - 1
    b32_nrm = LSHIFT32(b32, b_headrm)
    b32_inv = DIV32_16(INT32_MAX >> 2, RSHIFT32(b32_nrm, 16))
    result = LSHIFT32(b32_inv, 16)
    err_q32 = LSHIFT32((1 << 29) - SMULWB(b32_nrm, b32_inv), 3)
    result = SMLAWW(result, err_q32, b32_inv)
    lshift = 61 - b_headrm - qres
    if lshift <= 0:
        return LSHIFT_SAT32(result, -lshift)
    if lshift < 32:
        return RSHIFT32(result, lshift)
    return 0
