"""Fixed-point macros of the CELT noise conceal, on Python ints and on
numpy int64 arrays alike.

The port's copy of the part of esp32_opus_player_tpu/ops/fixed_point.py
that ops/celt/math.py and ops/celt/pvq.py use (reference macro layer,
src/celt.h:252-430): values wrap to 16 or 32 bits as the reference's
two's-complement arithmetic does. The JAX package's scalar forms branch
on a value; these are branch-free, so the same code renormalises one
band or every band of a step's noise rows at once (an int64 array holds
every intermediate without overflow).
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


def MULT16_16(a, b):
    return s32(s16(a) * s16(b))


def MULT16_16_Q15(a, b):
    return MULT16_16(a, b) >> 15


def MULT16_16_P15(a, b):
    return s32(16384 + MULT16_16(a, b)) >> 15


def MAC16_16(c, a, b):
    return ADD32(c, MULT16_16(a, b))


def ADD32(a, b):
    return s32(s32(a) + s32(b))


def ADD16(a, b):
    return s16(s16(a) + s16(b))


def SUB16(a, b):
    return s16(a) - s16(b)


def SHL16(a, shift):
    return s16((a & _M16) << shift)


def SHL32(a, shift):
    return s32((a & _M32) << shift)


def SHR32(a, shift):
    return s32(a) >> shift


def PSHR32(a, shift):
    return SHR32(ADD32(a, (1 << shift) >> 1), shift)


def VSHR32(a, shift):
    """a >> shift, or a << -shift for shift <= 0 (per element)."""
    right = shift > 0
    return (SHR32(a, shift * right) * right
            + SHL32(a, -shift * (1 - right)) * (1 - right))


def EC_ILOG(x):
    """The bit length of x >= 0 (below 2^53)."""
    if isinstance(x, int):
        return x.bit_length()
    return np.frexp(np.asarray(x, dtype=np.float64))[1].astype(np.int64)
