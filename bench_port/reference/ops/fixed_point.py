"""Bit-exact fixed-point primitives of the scalar decoders and the CELT
noise conceal.

The port's copy of esp32_opus_player_tpu/ops/fixed_point.py's scalar ops
(reference macro layer, src/celt.h:252-430, src/silk.h:50-156), with its
quirks:
  * MULT16_32_Q16 wraps the 16x32 product to int32 BEFORE the >>16
    (reference src/celt.h:256 casts before shifting) — this deviates from
    upstream libopus and is reproduced faithfully.
  * MULT16_32_Q15 shifts the full 48-bit product, then truncates to int32.
Values wrap to 16 or 32 bits as the reference's two's-complement
arithmetic does. s32, s16, VSHR32 and EC_ILOG are branch-free, so the
macros built on them take Python ints and numpy int64 arrays alike (an
int64 array holds every intermediate without overflow): the noise
conceal renormalises one band or every band of a step's noise rows at
once with the code the scalar decoder runs. The JAX package's array ops
(hi/lo splits for int32-only devices) have no user here.
"""
from __future__ import annotations

import numpy as np

_M32 = 0xFFFFFFFF
_M16 = 0xFFFF


def s32(x):
    """Wrap to signed 32-bit (two's complement)."""
    return ((x + 0x80000000) & _M32) - 0x80000000


def s16(x):
    return ((x + 0x8000) & _M16) - 0x8000


def u32(x: int) -> int:
    return x & _M32


# ---------------------------------------------------------------------------
# scalar (Python int) ops — host symbol-walk path
# ---------------------------------------------------------------------------

def SAT16(x: int) -> int:
    return 32767 if x > 32767 else (-32768 if x < -32768 else x)


def MULT16_16(a: int, b: int) -> int:
    return s32(s16(a) * s16(b))


def MULT16_16_16(a: int, b: int) -> int:
    # reference keeps this as a plain product in int space (src/celt.h:337)
    return s16(a) * s16(b)


def MULT16_16_Q15(a: int, b: int) -> int:
    return MULT16_16(a, b) >> 15


def MULT16_16_Q14(a: int, b: int) -> int:
    return MULT16_16(a, b) >> 14


def MULT16_16_P15(a: int, b: int) -> int:
    return s32(16384 + MULT16_16(a, b)) >> 15


def MULT16_32_Q15(a: int, b: int) -> int:
    """((int64)a*b) >> 15, truncated to int32 (src/celt.h:263)."""
    return s32((s16(a) * s32(b)) >> 15)


def MULT16_32_Q16(a: int, b: int) -> int:
    """(int32)(a*b) >> 16 — product wraps to int32 FIRST (src/celt.h:256)."""
    return s32(s16(a) * s32(b)) >> 16


def MULT32_32_Q31(a: int, b: int) -> int:
    return s32((s32(a) * s32(b)) >> 31)


def MAC16_16(c: int, a: int, b: int) -> int:
    return ADD32(c, MULT16_16(a, b))


def MAC16_32_Q15(c: int, a: int, b: int) -> int:
    # c + a*(b>>15) + ((a*(b&0x7fff))>>15), all in wrapping int32
    # (src/celt.h:348)
    b = s32(b)
    return ADD32(c, ADD32(MULT16_16(a, b >> 15),
                          MULT16_16(a, b & 0x7FFF) >> 15))


def MAC16_32_Q16(c: int, a: int, b: int) -> int:
    b = s32(b)
    return ADD32(c, ADD32(MULT16_16(a, b >> 16),
                          (s16(a) * (b & 0xFFFF)) >> 16))


def ADD32(a: int, b: int) -> int:
    return s32(s32(a) + s32(b))


def SUB32(a: int, b: int) -> int:
    return s32(s32(a) - s32(b))


def ADD16(a: int, b: int) -> int:
    return s16(s16(a) + s16(b))


def SUB16(a: int, b: int) -> int:
    return s16(a) - s16(b)


def SHL16(a: int, shift: int) -> int:
    return s16((a & _M16) << shift)


def SHL32(a: int, shift: int) -> int:
    return s32((a & _M32) << shift)


def SHR16(a: int, shift: int) -> int:
    return s16(a) >> shift


def SHR32(a: int, shift: int) -> int:
    return s32(a) >> shift


def PSHR32(a: int, shift: int) -> int:
    return SHR32(ADD32(a, 1 << shift >> 1), shift)


def VSHR32(a, shift):
    """a >> shift, or a << -shift for shift <= 0 (per element)."""
    right = shift > 0
    return (SHR32(a, shift * right) * right
            + SHL32(a, -shift * (1 - right)) * (1 - right))


def ROUND16(x: int, a: int) -> int:
    return s16(PSHR32(x, a))


def SATURATE(x: int, a: int) -> int:
    return a if x > a else (-a if x < -a else x)


def ADD32_ovflw(a: int, b: int) -> int:
    return s32((u32(a) + u32(b)))


def SUB32_ovflw(a: int, b: int) -> int:
    return s32((u32(a) - u32(b)))


def NEG32_ovflw(a: int) -> int:
    return s32(0x100000000 - u32(a))


def FRAC_MUL16(a: int, b: int) -> int:
    return (16384 + s16(a) * s16(b)) >> 15


def EC_ILOG(x):
    """The bit length of x >= 0 (below 2^53)."""
    if isinstance(x, int):
        return x.bit_length()
    return np.frexp(np.asarray(x, dtype=np.float64))[1].astype(np.int64)


def celt_udiv(n: int, d: int) -> int:
    assert d > 0
    return u32(n) // u32(d)


def celt_sudiv(n: int, d: int) -> int:
    assert d > 0
    # C int division truncates toward zero
    q = abs(n) // d
    return -q if n < 0 else q


def QCONST16(x: float, bits: int) -> int:
    return int(0.5 + x * (1 << bits))


def QCONST32(x: float, bits: int) -> int:
    return int(0.5 + x * (1 << bits))
