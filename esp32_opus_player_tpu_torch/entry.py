"""The port's entry point: one batched CELT frame synthesis step and its
example arguments.

Port of __graft_entry__.entry() and _example_args (:19-46): `entry()`
returns (fn, args), fn the row-layout step models/batch_celt.py::
celt_synth_step at LM 3, C 1, CC 1, transient False, args eight streams
of seeded inputs built with numpy exactly as the JAX entry builds them.
The args lie on the card unless device="cpu" is asked for; without a
card that raises. fn on the card runs the hand-written kernels K1-K3.

    fn, args = entry()
    pcm, decode_mem, preemph = fn(*args)
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .models.batch_celt import celt_synth_step, make_state
from .ops.celt.torch_synthesis import I32


def _example_args(B: int, LM: int = 3, C: int = 1, CC: int = 1,
                  device="cuda"):
    N = 120 << LM

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=I32, device=device)

    state = make_state(B, CC, device)
    rng = np.random.default_rng(0)
    X = t(rng.integers(-8192, 8192, (B, C, N)))
    bandE = t(rng.integers(-2000, 2000, (B, 2, 21)))
    start = t(np.zeros(B))
    end = t(np.full(B, 21))
    comb1 = tuple(t(v) for v in (np.full(B, 15), np.full(B, 15),
                                 np.zeros(B), np.zeros(B), np.zeros(B),
                                 np.zeros(B)))
    comb2 = tuple(t(v) for v in (np.full(B, 15), np.full(B, 120),
                                 np.zeros(B), np.full(B, 12288),
                                 np.zeros(B), np.zeros(B)))
    return (state["decode_mem"], state["preemph"], X, bandE, start, end,
            comb1, comb2)


def entry(device="cuda", B: int = 8):
    """(fn, example_args): the batched CELT synthesis step over B
    streams (8, as the JAX entry)."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("entry: no CUDA device; pass device='cpu' to run "
                           "the plain version on the CPU")
    fn = functools.partial(celt_synth_step, LM=3, C=1, CC=1,
                           transient=False)
    return fn, _example_args(B, device=device)
