"""The CELT deemphasis IIR (kernel K3) and its plain torch twin.

`deemphasis_T(synT, mem, downsample)` is the transposed deemphasis of
esp32_opus_player_tpu/ops/celt/jax_synthesis_T.py::deemphasis_T (the
Pallas _deemph_kernel of ops/celt/pallas_kernels.py): synT (CC, N, B)
int32, mem (B, CC) int32. Returns (pcmT (CC, N//downsample, B) int16,
mem' (B, CC) int32); `mem` itself is not written. On a CUDA tensor it
launches csrc/celt_deemph.cu; on a CPU tensor it runs the twin
`deemphasis_T_ref`, the port of jax_synthesis.deemphasis_batch.
Reference: deemphasis src/celt.cpp:1988; the IIR always runs at 48 kHz
and keeps every downsample-th output (:2000-2013).

The kernel (its source has the details and what bounds it): a block of
256 threads owns 8 adjacent columns of one channel (256 blocks at both
paths' shapes), stages their N rows into shared memory in four pieces
with cp.async, and one thread per column walks the recurrence from
shared memory while the other warps write the finished int16 rows out.
The walk waits on no global load; its floor is the per-sample chain (the
sum, and the Q15 product as one high-word multiply), which no exact scan
shortens (smul truncates).
"""
from __future__ import annotations

import torch

from .torch_synthesis import I32, PREEMPH_COEF, smul


def deemphasis_T_ref(synT, mem, downsample: int = 1):
    """Plain torch twin of K3 (a loop over the N samples)."""
    CC, N, B = synT.shape
    m = mem.T.contiguous()                       # (CC, B)
    tmp = torch.empty_like(synT)
    for n in range(N):
        t = synT[:, n] + m
        m = smul(t, PREEMPH_COEF)
        tmp[:, n] = t
    pcm = ((tmp + 2048) >> 12).clamp(-32768, 32767).to(torch.int16)
    if downsample > 1:
        pcm = pcm[:, ::downsample].contiguous()
    return pcm, m.T.contiguous()


def deemphasis_T(synT, mem, downsample: int = 1):
    """K3 wrapper. CPU tensors take the twin; CUDA tensors launch
    csrc/celt_deemph.cu (never the twin), one launch per call. synT may
    be a view whose rows are B apart with streams contiguous (a slice of
    decode_mem); any B >= 1."""
    if synT.device.type == "cpu":
        return deemphasis_T_ref(synT, mem, downsample)
    from .. import _build
    if synT.device.type != "cuda":
        raise ValueError(f"deemphasis_T: unsupported device {synT.device}")
    CC, N, B = synT.shape
    if synT.dtype != I32 or synT.stride(2) != 1 or synT.stride(1) != B:
        raise ValueError("deemphasis_T: synT must be int32 with rows B apart "
                         "and streams contiguous")
    if N % downsample:
        raise ValueError("deemphasis_T: N must be a multiple of downsample")
    mem = mem.to(I32).contiguous()
    if mem.shape != (B, CC) or mem.device != synT.device:
        raise ValueError("deemphasis_T: mem must be (B, CC) on synT's device")
    pcm = torch.empty((CC, N // downsample, B), dtype=torch.int16,
                      device=synT.device)
    mem2 = torch.empty_like(mem)
    with torch.cuda.device(synT.device):
        err = _build.lib().celt_deemph(
            synT.data_ptr(), synT.stride(0), N, B, CC, mem.data_ptr(),
            mem2.data_ptr(), pcm.data_ptr(), downsample,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "celt_deemph")
    deemphasis_T.launches += 1
    return pcm, mem2


deemphasis_T.launches = 0
