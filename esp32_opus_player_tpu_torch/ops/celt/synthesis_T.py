"""Transposed-layout CELT frame synthesis in torch: time/frequency on
dim 0, streams on the last dim.

Port of esp32_opus_player_tpu/ops/celt/jax_synthesis_T.py. The chain
(src/celt.cpp:2057-2446) is denormalise -> iMDCT with TDAC (kernel K1's
fused entry: each stream's own block structure, the decode_mem stores as
its epilogue) -> comb postfilter (K2) -> deemphasis (K3). Around the
kernels the code is plain torch on the tensors' own device. decode_mem
is carried transposed per channel: (CC, 2048+120, B) int32.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .comb import comb_filter_step_T
from .deemph import deemphasis_T
from .fft import celt_imdct_tdac_T
from .torch_synthesis import (DECODE_BUFFER_SIZE, EB, EMEANS, I32,
                              NB_EBANDS, SHORT_MDCT_SIZE, const, exp2_frac)


@functools.lru_cache(maxsize=None)
def _band_tables(M: int, device):
    """Per-bin band index (bins past eBands[21] map to band 0, as in the
    JAX path; they are always masked), eBands and eMeans<<6."""
    N = M * SHORT_MDCT_SIZE
    bin_band = np.zeros(N, dtype=np.int64)
    for i in range(NB_EBANDS):
        bin_band[M * EB[i]:M * EB[i + 1]] = i
    return (torch.as_tensor(bin_band, device=device), const(EB, device),
            const(EMEANS[:NB_EBANDS] << 6, device))


def denormalise_bands_T(X_T, bandLogE, start, end, M: int,
                        downsample: int = 1):
    """Transposed denormalise (src/celt.cpp:948): X_T (N, B) int32 Q14,
    bandLogE (B, 21) int32 Q10, start/end (B,). Returns freq (N, B)."""
    N = M * SHORT_MDCT_SIZE
    bin_band, eb, emeans = _band_tables(M, X_T.device)
    lg = (bandLogE + emeans[None, :]).clamp(-32768, 32767)
    shift = 16 - (lg >> 10)
    g = exp2_frac(lg & 1023)
    big = shift > 31          # -> g = 0, shift = 0
    neg2 = shift <= -2        # -> g = 16384, shift = -2
    g = torch.where(big, 0, torch.where(neg2, 16384, g))
    shift = torch.where(big, 0, torch.where(neg2, -2, shift))
    gb = g.T.index_select(0, bin_band)            # (N, B)
    sb = shift.T.index_select(0, bin_band)
    prod = (X_T.to(torch.int64) * gb).to(I32)
    f = torch.where(sb >= 0, prod >> sb.clamp(min=0),
                    torch.bitwise_left_shift(prod, (-sb).clamp(min=0)))
    band = bin_band[:, None]
    active = (band >= start[None, :]) & (band < end[None, :])
    ends = eb[end.long()] * M
    if downsample > 1:
        # anti-alias clamp before decimated output (src/celt.cpp:957)
        ends = ends.clamp(max=N // downsample)
    rows = torch.arange(N, device=X_T.device)[:, None]
    active &= rows < ends[None, :]
    return torch.where(active, f, 0)


def celt_synth_step_dual_T(dmT, preemph, X_T, bandE, start, end, comb1,
                           comb2, tr, *, LM: int, C: int, CC: int,
                           downsample: int = 1):
    """One batched CELT frame, fully transposed (bit-exact to
    jax_synthesis_T.celt_synth_step_dual_T).

    dmT: (CC, 2048+120, B) int32 decode_mem. preemph: (B, CC) int32.
    X_T: (C, N, B) int32 Q14. bandE: (B, 2, 21) int32 Q10. start/end:
    (B,) int32. comb1/comb2: 6-tuples of (B,) int32. tr: (B,) bool
    per-stream transient flag. Returns (pcmT (CC, N//downsample, B)
    int16, dmT', preemph'). The inputs are not written: dmT' is a new
    buffer (the history roll copies anyway), which the comb updates in
    place."""
    N = SHORT_MDCT_SIZE << LM
    DBS = DECODE_BUFFER_SIZE
    # roll history left by N (OPUS_MOVE, src/celt.cpp:2347); the rolled
    # tail rows are rewritten below
    dm = torch.cat([dmT[:, N:], dmT[:, :N]], dim=1)
    freqs = [denormalise_bands_T(X_T[c], bandE[:, c], start, end, 1 << LM,
                                 downsample=downsample) for c in range(C)]
    if CC == 1 and C == 2:
        freqs = [(freqs[0] >> 1) + (freqs[1] >> 1)]
    for cc in range(CC):
        freq = freqs[min(cc, len(freqs) - 1)]
        dcc = dm[cc]
        # each stream's iMDCT by its own block structure (tr), the TDAC and
        # the stores of dcc[DBS-N:DBS+60], in place
        celt_imdct_tdac_T(freq, dcc, tr, LM=LM)
        comb_filter_step_T(dcc, DBS - N, N, comb1, comb2)
    pcmT, pre2 = deemphasis_T(dm[:, DBS - N:DBS], preemph,
                              downsample=downsample)
    return pcmT, dm, pre2
