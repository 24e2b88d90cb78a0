"""SILK resampler constants the batched resampler needs (the port's copy
of esp32_opus_player_tpu/ops/silk/resampler.py:19-32): the decoder's
delay matrix (reference src/silk.cpp:333) and the rateID macro."""
from __future__ import annotations

from ..tables import silk_tables as st

_DELAY_MATRIX_DEC = st.delay_matrix_dec.reshape(3, 5)


def _rate_id(r: int) -> int:
    """rateID macro (reference src/silk.h:397)."""
    return (((r >> 12) - (1 if r > 16000 else 0))
            >> (1 if r > 24000 else 0)) - 1
