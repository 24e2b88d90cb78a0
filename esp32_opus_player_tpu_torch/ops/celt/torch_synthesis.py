"""Int32 Q-format helpers of the CELT synthesis, in torch.

Port of the constants and scalar helpers of
esp32_opus_player_tpu/ops/celt/jax_synthesis.py (smul, mult16_16_q15,
mult16_16_p15, sat16, exp2_frac, imdct_tdac). Every value is an int32
tensor and every int32 sum wraps as two's complement, as XLA's do.
Products that could leave int32 are taken in int64 and truncated back
with `.to(torch.int32)`, which wraps.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..tables.celt_tables import (eMeans, eband5ms, mdct_twiddles960,
                                  window120)

NB_EBANDS = 21
SHORT_MDCT_SIZE = 120
OVERLAP = 120
DECODE_BUFFER_SIZE = 2048
SIG_SAT = 300000000
COMBFILTER_MINPERIOD = 15
PREEMPH_COEF = 27853
MAX_PERIOD = 1024

EB = np.asarray(eband5ms, dtype=np.int32)
WINDOW = np.asarray(window120, dtype=np.int32)
TRIG = np.asarray(mdct_twiddles960, dtype=np.int32)
EMEANS = np.asarray(eMeans, dtype=np.int32)

I32 = torch.int32


def smul(x, t):
    """S_MUL: ((int64)t * x) >> 15, truncated to int32.

    The JAX path splits x into hi/lo halves because the TPU has no int64;
    with a 16-bit t the product fits int64, and floor(t*x / 2^15) taken
    there equals the split form modulo 2^32."""
    return ((x.to(torch.int64) * t) >> 15).to(I32)


def mult16_16_q15(a, b):
    return (a * b) >> 15


def mult16_16_p15(a, b):
    return (16384 + a * b) >> 15


def sat16(x):
    return torch.clamp(x, -32768, 32767)


def exp2_frac(x):
    """celt_exp2_frac (src/celt.h:494): Q10 frac -> Q14, int32."""
    frac = torch.bitwise_left_shift(x, 4) & 0xFFFF
    frac = torch.where(frac >= 32768, frac - 65536, frac)   # SHL16 wrap
    r = 14819 + mult16_16_q15(10204, frac)
    r = 22804 + mult16_16_q15(frac, r)
    return 16383 + mult16_16_q15(frac, r)


def const(a, device) -> torch.Tensor:
    """A numpy table as an int32 tensor on `device`."""
    return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32),
                           device=device)


@functools.lru_cache(maxsize=None)
def _tdac_window(device):
    ov = OVERLAP
    return (const(WINDOW[:ov // 2], device)[:, None],
            const(WINDOW[ov // 2:][::-1], device)[:, None])


def imdct_tdac(hist_half, block):
    """TDAC mirror (src/celt.cpp:3283-3296) with time on dim 0 (the
    transposed layout): hist_half (OVERLAP/2, B) previous tail, block
    (N2, B) post-rotated output. Returns (OVERLAP/2 + N2, B): the first
    OVERLAP rows mixed, the rest passed through."""
    ov = OVERLAP
    full = torch.cat([hist_half, block], dim=0)
    x2 = full[:ov // 2]
    x1 = full[ov // 2:ov].flip(0)
    wp1, wp2 = _tdac_window(block.device)
    lo = smul(x2, wp2) - smul(x1, wp1)
    hi = smul(x2, wp1) + smul(x1, wp2)
    return torch.cat([lo, hi.flip(0), full[ov:]], dim=0)
