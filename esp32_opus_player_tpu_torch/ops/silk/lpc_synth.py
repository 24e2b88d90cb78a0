"""The SILK LPC synthesis recurrence (kernel K5) and its plain version.

`lpc_synth(pres, A, state0, order=)` computes what
esp32_opus_player_tpu/ops/silk/pallas_core.py::lpc_synth_pallas
computes: the order-10/16 LPC synthesis feedback of silk_decode_core
(reference src/silk.cpp:1930-1950) over pres (B, n) int32 with
per-stream A (B, order) Q12 and the carried state (B, 16), most recent
sample last. Returns (vs (B, n), state' (B, 16)). On a CUDA tensor it
launches csrc/silk_lpc.cu; on a CPU tensor it runs `lpc_synth_ref`, the
LPC loop of jax_core.silk_core_frame_xla. No pool reaches the kernel on
the card: `torch_core.silk_core_frame` sends every CUDA bucket, whatever
its width, to K7, which runs this recurrence itself.

The kernel (its source has the design): 16 streams a block, their rows
of pres staged into shared memory with every load in flight, lane s of
warp 0 walking stream s in transposed form (only the newest tap on the
sample's dependent chain), the outputs written back coalesced and the
state once. chip_smoke.py holds it bit-equal to `lpc_synth_ref` and
times it against its bound: the larger of its bytes, its int32
operations and the chain, n samples of LPC_CHAIN_CYCLES at the SM clock.
"""
from __future__ import annotations

import torch

from .torch_core import (I32, I64, MAX_LPC_ORDER, add_sat32, lshift_sat32,
                         w32, w64)


def lpc_synth_ref(pres, A, state0, *, order: int):
    """Plain torch version of K5: one step per sample over the batch; the
    order taps of a step are one vectorised smulwb over a window of the
    state ring."""
    B, n = pres.shape
    # the ring in int64 (its values are int32); pred is reduced modulo
    # 2^32 once per sample, as the JAX chain's wrapping sum leaves it
    ring = torch.empty((B, MAX_LPC_ORDER + n), dtype=I64,
                       device=pres.device)
    ring[:, :MAX_LPC_ORDER] = state0
    x = pres.to(I64)
    # tap j pairs ring[15 - j] with A[j]: the window, oldest first,
    # pairs with A reversed
    a_rev = A[:, :order].flip(1).to(I64)
    for t in range(n):
        win = ring[:, MAX_LPC_ORDER - order + t:MAX_LPC_ORDER + t]
        # smulwb: the high half's product only enters the wrapping sum;
        # the low half's is wrapped before its shift
        taps = (win >> 16) * a_rev + (w64((win & 0xFFFF) * a_rev) >> 16)
        pred = w32(taps.sum(1) + (order >> 1))
        ring[:, MAX_LPC_ORDER + t] = add_sat32(x[:, t], lshift_sat32(pred, 4))
    ring = ring.to(I32)
    return ring[:, MAX_LPC_ORDER:], ring[:, n:].contiguous()


def lpc_synth(pres, A, state0, *, order: int):
    """K5 wrapper: (vs, state') as lpc_synth_ref. CPU tensors take the
    plain version; CUDA tensors launch csrc/silk_lpc.cu (never the plain
    version)."""
    if pres.device.type == "cpu":
        return lpc_synth_ref(pres, A, state0, order=order)
    from .. import _build
    if pres.device.type != "cuda":
        raise ValueError(f"lpc_synth: unsupported device {pres.device}")
    B, n = pres.shape
    pres = pres.contiguous()
    A = A[:, :order].to(I32).contiguous()
    state0 = state0.to(I32).contiguous()
    if pres.dtype != I32 or A.shape != (B, order) \
            or state0.shape != (B, MAX_LPC_ORDER) \
            or not (A.device == state0.device == pres.device):
        raise ValueError("lpc_synth: pres (B, n) int32, A (B, order) and "
                         "state (B, 16) on one device")
    if order not in (10, 16):
        raise ValueError("lpc_synth: order must be 10 or 16")
    vs = torch.empty_like(pres)
    st2 = torch.empty_like(state0)
    with torch.cuda.device(pres.device):
        err = _build.lib().silk_lpc_synth(
            pres.data_ptr(), B, n, A.data_ptr(), order, state0.data_ptr(),
            vs.data_ptr(), st2.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "silk_lpc_synth")
    lpc_synth.launches += 1
    return vs, st2


lpc_synth.launches = 0
