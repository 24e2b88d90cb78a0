"""Row-layout batched CELT frame synthesis: the decoder state and frame
inputs carry the streams on dim 0.

Port of esp32_opus_player_tpu/models/batch_celt.py:28-165 (`make_state`,
`celt_synth_step`, `celt_synth_step_dual`, and `NB_EBANDS`, imported
here for its callers). On a CUDA tensor each step transposes its
operands to the streams-last layout and runs the pool's frame step,
ops/celt/synthesis_T.py::celt_synth_step_dual_T, with its hand-written
kernels K1 (the fused iMDCT + TDAC entry, the static transient flag
broadcast per stream), K2 and K3; then transposes back.
There is one synthesis, not two. On a CPU tensor it runs the plain
version, the port of the JAX row functions (ops/celt/row_synthesis.py).

BatchedCELTDecoder (:167) is not ported: its native=False branch is the
Python symbol walk (ROADMAP.md queue A item 12b).
"""
from __future__ import annotations

import torch

from ..ops.celt import row_synthesis as rs
from ..ops.celt.synthesis_T import celt_synth_step_dual_T
from ..ops.celt.torch_synthesis import (DECODE_BUFFER_SIZE, I32, NB_EBANDS,
                                        OVERLAP, SHORT_MDCT_SIZE, SIG_SAT)


def make_state(n_streams: int, channels: int, device="cuda") -> dict:
    """The decoder state of a pool of CELT streams: decode_mem (B, CC,
    2048+120) and preemph (B, CC), int32 zeros on `device`."""
    return {
        "decode_mem": torch.zeros(
            (n_streams, channels, DECODE_BUFFER_SIZE + OVERLAP), dtype=I32,
            device=device),
        "preemph": torch.zeros((n_streams, channels), dtype=I32,
                               device=device),
    }


def _step_T(decode_mem, preemph, X, bandE, start, end, comb1, comb2, tr,
            *, LM, C, CC, downsample=1):
    """The card's route: the transposed frame step between transposes."""
    pcmT, dmT, pre2 = celt_synth_step_dual_T(
        decode_mem.permute(1, 2, 0).contiguous(), preemph,
        X.permute(1, 2, 0).contiguous(), bandE, start, end, comb1, comb2,
        tr, LM=LM, C=C, CC=CC, downsample=downsample)
    return (pcmT.permute(2, 0, 1).to(I32), dmT.permute(2, 0, 1).contiguous(),
            pre2)


def _step_ref(decode_mem, preemph, X, bandE, start, end, comb1, comb2,
              imdct, *, LM, C, CC, downsample=1):
    """The plain version (batch_celt.py:50-95 of the JAX package): imdct
    (freq, hist) -> region is one channel's iMDCT."""
    N = SHORT_MDCT_SIZE << LM
    DBS = DECODE_BUFFER_SIZE
    dm = torch.roll(decode_mem, -N, dims=-1)
    freqs = [rs.denormalise_bands_b(X[:, c], bandE[:, c], start, end,
                                    1 << LM, downsample=downsample)
             for c in range(C)]
    if CC == 1 and C == 2:
        freqs = [(freqs[0] >> 1) + (freqs[1] >> 1)]
    for cc in range(CC):
        freq = freqs[min(cc, len(freqs) - 1)]
        region = imdct(freq, dm[:, cc, DBS - N:DBS - N + OVERLAP // 2])
        dm[:, cc, DBS - N:DBS] = region[:, :N].clamp(-SIG_SAT, SIG_SAT)
        dm[:, cc, DBS:DBS + OVERLAP // 2] = region[:, N:]
    for cc in range(CC):
        buf = rs.comb_filter_batch(dm[:, cc], DBS - N, SHORT_MDCT_SIZE,
                                   *comb1)
        if LM != 0:
            buf = rs.comb_filter_batch(buf, DBS - N + SHORT_MDCT_SIZE,
                                       N - SHORT_MDCT_SIZE, *comb2)
        dm[:, cc] = buf
    pcm, pre2 = rs.deemphasis_batch(dm[:, :, DBS - N:DBS], preemph,
                                    downsample=downsample)
    return pcm, dm, pre2


def celt_synth_step(decode_mem, preemph, X, bandE, start, end, comb1,
                    comb2, *, LM: int, C: int, CC: int, transient: bool):
    """One batched CELT frame, every stream with the same block structure
    (`transient`). decode_mem (B, CC, 2048+120) and preemph (B, CC)
    int32; X (B, C, N) int32 Q14; bandE (B, 2, 21) int32 Q10; start/end
    (B,) int32; comb1/comb2 six (B,) int32 each (T0, T1, g0, g1,
    tapset0, tapset1). Returns (pcm (B, CC, N) int32 in int16 range,
    decode_mem', preemph'); the inputs are not written."""
    if X.device.type == "cpu":
        return _step_ref(
            decode_mem, preemph, X, bandE, start, end, comb1, comb2,
            lambda f, h: rs.celt_imdct_frame(f, h, LM, transient),
            LM=LM, C=C, CC=CC)
    tr = torch.full((X.shape[0],), bool(transient), device=X.device)
    return _step_T(decode_mem, preemph, X, bandE, start, end, comb1, comb2,
                   tr, LM=LM, C=C, CC=CC)


def celt_synth_step_dual(decode_mem, preemph, X, bandE, start, end, comb1,
                         comb2, tr, *, LM: int, C: int, CC: int,
                         downsample: int = 1):
    """celt_synth_step with a per-stream transient flag tr (B,) bool and
    an output decimation (downsample: 1, 2, 3, 4 or 6)."""
    if X.device.type == "cpu":
        def imdct(freq, hist):
            a, b = (rs.celt_imdct_frame(freq, hist, LM, t)
                    for t in (False, True))
            return torch.where(tr[:, None], b, a)
        return _step_ref(decode_mem, preemph, X, bandE, start, end, comb1,
                         comb2, imdct, LM=LM, C=C, CC=CC,
                         downsample=downsample)
    return _step_T(decode_mem, preemph, X, bandE, start, end, comb1, comb2,
                   tr, LM=LM, C=C, CC=CC, downsample=downsample)
