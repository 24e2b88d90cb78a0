"""The SILK 2x allpass upsampler (kernel K6), bare and with the IIR-FIR
resampler call around it, and their plain versions.

`up2_hq(S, inp)` computes what
esp32_opus_player_tpu/ops/silk/pallas_core.py::up2_hq_pallas computes:
silk_resampler_private_up2_HQ (reference src/silk.cpp:3513) over inp
(B, n) int32 for any n, with the 6 carried allpass states S (B, 6).
Returns (out (B, 2n) int32, even and odd outputs interleaved, S'). On a
CUDA tensor it launches csrc/silk_up2.cu; on a CPU tensor it runs
torch_core.up2_hq_scan.

`up2_fir(sIIR, sFIR, block, batch_size=, inv_ratio=)` is one
silk_resampler_private_IIR_FIR call (:3481), what the JAX package's
resample_batch does for kind iir_fir around the Pallas kernel: per
batchSize chunk the allpass, then the 12-phase FIR interpolation, the 8
FIR samples carried. On a CUDA tensor it is one launch of the same
kernel with the FIR as its epilogue; on a CPU tensor it runs
torch_core.iir_fir_chunks, the chunk loop, with up2_hq_scan.

The kernel (its source has the details and what bounds it): 16 streams
to a block of 512 threads (128 blocks at 2048 rows), each stream's input
row and up-sampled row in shared memory, two threads per stream walking
the even and the odd allpass chain (in four warps, one per scheduler),
then a warp per stream writing the rows out (bare) or computing the FIR
outputs, its lanes on consecutive positions (fused). It reads every
operand where the caller has it, so a call is one launch and allocates
only its outputs.
"""
from __future__ import annotations

import torch

from .core_kernel import _operand
from .torch_core import I32, iir_fir_chunks, iir_fir_out_len, up2_hq_scan


def up2_hq(S, inp):
    """K6 wrapper: (out, S') as torch_core.up2_hq_scan. CPU tensors take
    the plain version; CUDA tensors launch csrc/silk_up2.cu (never the
    plain version). inp may be a column slice (rows any stride apart)."""
    if inp.device.type == "cpu":
        return up2_hq_scan(S, inp)
    from .. import _build
    if inp.device.type != "cuda":
        raise ValueError(f"up2_hq: unsupported device {inp.device}")
    B, n = inp.shape
    if inp.stride(1) != 1:
        inp = inp.contiguous()
    S = S.to(I32).contiguous()
    if inp.dtype != I32 or S.shape != (B, 6) or S.device != inp.device:
        raise ValueError("up2_hq: inp (B, n) int32 and S (B, 6) on one "
                         "device")
    out = torch.empty((B, 2 * n), dtype=I32, device=inp.device)
    S2 = torch.empty_like(S)
    with torch.cuda.device(inp.device):
        err = _build.lib().silk_up2_hq(
            inp.data_ptr(), B, n, inp.stride(0), S.data_ptr(),
            out.data_ptr(), S2.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "silk_up2_hq")
    up2_hq.launches += 1
    return out, S2


up2_hq.launches = 0


def up2_fir(sIIR, sFIR, block, *, batch_size: int, inv_ratio: int):
    """K6 fused-entry wrapper: (out (B, iir_fir_out_len), sIIR' (B, 6),
    sFIR' shaped as sFIR) as torch_core.iir_fir_chunks. CPU tensors take
    the plain version; CUDA tensors launch csrc/silk_up2.cu once (never
    the plain version), which reads block, sIIR and sFIR in place (rows
    any stride apart, unit element stride)."""
    if block.device.type == "cpu":
        return iir_fir_chunks(sIIR, sFIR, block, batch_size=batch_size,
                              inv_ratio=inv_ratio)
    from .. import _build
    if block.device.type != "cuda":
        raise ValueError(f"up2_fir: unsupported device {block.device}")
    B, n = block.shape
    x, xs = _operand(block, (n,), "block")
    s, ss = _operand(sIIR, (6,), "sIIR")
    f, fs = _operand(sFIR, (8,), "sFIR")
    if s.shape != (B, 6) or f.shape[0] != B \
            or len({t.device for t in (x, s, f)}) != 1:
        raise ValueError("up2_fir: block (B, n), sIIR (B, 6) and sFIR "
                         "(B, >= 8) on one device")
    n_out = iir_fir_out_len(n, batch_size, inv_ratio)
    out = torch.empty((B, n_out), dtype=I32, device=x.device)
    s2 = torch.empty((B, 6), dtype=I32, device=x.device)
    f2 = torch.empty((B, f.shape[1]), dtype=I32, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.lib().silk_up2_fir(
            x.data_ptr(), xs, s.data_ptr(), ss, f.data_ptr(), fs,
            f.shape[1], B, n, batch_size, inv_ratio, out.data_ptr(), n_out,
            s2.data_ptr(), f2.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "silk_up2_fir")
    up2_fir.launches += 1
    return out, s2, f2


up2_fir.launches = 0
