"""The SILK 2x allpass upsampler (kernel K6) and its plain version.

`up2_hq(S, inp)` computes what
esp32_opus_player_tpu/ops/silk/pallas_core.py::up2_hq_pallas computes:
silk_resampler_private_up2_HQ (reference src/silk.cpp:3513) over inp
(B, n) int32 for any n, with the 6 carried allpass states S (B, 6).
Returns (out (B, 2n) int32, even and odd outputs interleaved, S'). On a
CUDA tensor it launches csrc/silk_up2.cu; on a CPU tensor it runs
torch_core.up2_hq_scan.
"""
from __future__ import annotations

import torch

from .torch_core import I32, up2_hq_scan


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
