"""Decoder state between the JAX package and the port.

The pool state is what a run carries across frames: decode_mem in the
transposed layout, (CC, 2048+120, B) int32, and the deemphasis memory,
(B, CC) int32 — the layout of the JAX T-mode StreamPool.state.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.celt.torch_synthesis import DECODE_BUFFER_SIZE, OVERLAP


def from_jax_state(decode_mem, preemph, device="cpu") -> dict:
    """numpy arrays in the JAX T layout -> the port's state dict."""
    dm = np.asarray(decode_mem)
    pre = np.asarray(preemph)
    if dm.dtype != np.int32 or pre.dtype != np.int32:
        raise ValueError("decoder state must be int32")
    CC, L, B = dm.shape
    if L != DECODE_BUFFER_SIZE + OVERLAP or pre.shape != (B, CC):
        raise ValueError(f"state shapes {dm.shape}, {pre.shape} are not "
                         f"(CC, {DECODE_BUFFER_SIZE + OVERLAP}, B), (B, CC)")
    return {"decode_mem": torch.tensor(dm, device=device),
            "preemph": torch.tensor(pre, device=device)}


def to_numpy(state: dict):
    """The port's state dict -> (decode_mem, preemph) numpy int32."""
    return (state["decode_mem"].cpu().numpy(),
            state["preemph"].cpu().numpy())
