"""K1's fused entry (`ops/celt/fft.py::celt_imdct_tdac_T`: one channel's
frame iMDCT, each stream by its own block structure, with the TDAC and
the decode_mem stores as its epilogue) held on the CPU, bit for bit
(tolerance 0: int32 fixed point).

- Its plain version, which CPU tensors take, against the JAX step's
  composition (jax_synthesis_T.celt_synth_step_dual_T:221-233: both
  block structures through celt_imdct_frame_T with the Pallas FFT in
  interpret mode, the per-stream select, the clamp and the two row
  stores), at LM 0-3, with no stream, every stream, every 3rd stream or
  a random set transient, at a width (11) that fills no 8-stream tile.
- The schedule csrc/celt_fft.cu runs, modelled in numpy: each stream's
  FFT by its own plan only, the post-rotate interleave, then every
  output row computed at once from the tile (the TDAC needs no chain:
  block b's mirror reads the history or block b - 1's raw post-rotated
  rows [60, 120), which the mirror leaves as they are). It is held to
  the sequential block loop of `celt_imdct_frame_T` for both block
  structures at every LM, and to the plain version with mixed flags.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from esp32_opus_player_tpu.ops.celt import jax_synthesis_T as jt
from esp32_opus_player_tpu_torch.ops.celt.fft import (
    FFT_STATES, celt_imdct_frame_T, celt_imdct_tdac_T, celt_imdct_tdac_T_ref,
    fft_blocks_ref)
from esp32_opus_player_tpu_torch.ops.celt.torch_synthesis import (SIG_SAT,
                                                                  WINDOW)

from torch_port_util import DBS, OV, assert_equal, imdct_tdac_inputs, t32

FLAGS = ["false", "true", "third", "random"]


def _jax_imdct_tdac(freq, dcc, tr, LM):
    """jax_synthesis_T.celt_synth_step_dual_T:221-233 for one channel."""
    N = 120 << LM
    freq, dcc, tr = jnp.asarray(freq), jnp.asarray(dcc), jnp.asarray(tr)
    hist = dcc[DBS - N:DBS - N + OV // 2]
    regions = [jt.celt_imdct_frame_T(freq, hist, LM, t, interpret=True)
               for t in (False, True)]
    region = jnp.where(tr[None, :], regions[1], regions[0])
    finished = jnp.clip(region[:N], -SIG_SAT, SIG_SAT)
    return jnp.concatenate([dcc[:DBS - N], finished, region[N:],
                            dcc[DBS + OV // 2:]], axis=0)


@pytest.mark.parametrize("flags", FLAGS)
@pytest.mark.parametrize("LM", [3, 2, 1, 0])
def test_imdct_tdac_plain_matches_jax(LM, flags):
    rng = np.random.default_rng(70 + 4 * LM + FLAGS.index(flags))
    freq, dcc, tr = imdct_tdac_inputs(rng, 11, LM, flags)
    want = _jax_imdct_tdac(freq, dcc, tr, LM)
    before = celt_imdct_tdac_T.launches
    got = celt_imdct_tdac_T(t32(freq), t32(dcc), torch.as_tensor(tr), LM=LM)
    assert celt_imdct_tdac_T.launches == before     # CPU: the plain version
    assert_equal(got, want, f"LM {LM} flags {flags}")
    N = 120 << LM
    if flags != "false" or LM == 3:
        # the inputs reach the clamp
        assert (np.abs(np.asarray(want[DBS - N:DBS])) == SIG_SAT).any()


# ---- the kernel's schedule, in numpy -------------------------------------

def _smul(x, t):
    return ((x.astype(np.int64) * t) >> 15).astype(np.int32)


def _interleave(yr, yi, n4):
    """The kernel's post-rotate interleave of each block of n4 points:
    x[2 n4 blk + 2i] = yr[j], x[2 n4 blk + 2 n4 - 1 - 2i] = yi[j]."""
    rows = yr.shape[0]
    x = np.empty((2 * rows,) + yr.shape[1:], np.int32)
    for j in range(rows):
        blk, i = divmod(j, n4)
        x[2 * n4 * blk + 2 * i] = yr[j]
        x[2 * n4 * blk + 2 * n4 - 1 - 2 * i] = yi[j]
    return x


def _rows_at_once(x, hist, N, nb):
    """Every output row r of the region (N finished + 60 tail) from the
    interleaved tile x and the history alone, in any order (here in
    reverse, to show no row needs another): the kernel's epilogue before
    its clamp."""
    out = np.empty((N + OV // 2,) + x.shape[1:], np.int32)
    w = WINDOW.astype(np.int64)
    for r in reversed(range(N + OV // 2)):
        blk, rr = divmod(r, nb)
        if r >= N or rr >= 120:
            out[r] = x[r - 60]
            continue
        k = rr if rr < 60 else 119 - rr
        x2 = hist[k] if blk == 0 else x[blk * nb - 60 + k]
        x1 = x[blk * nb + 59 - k]
        if rr < 60:
            out[r] = _smul(x2, w[119 - k]) - _smul(x1, w[k])
        else:
            out[r] = _smul(x2, w[k]) + _smul(x1, w[119 - k])
    return out


def _plan_of(LM, transient):
    """(shift, Bblk, n4, samples a block) of one block structure."""
    if transient:
        return 3, 1 << LM, 60, 120
    return 3 - LM, 1, FFT_STATES[3 - LM].nfft, 120 << LM


@pytest.mark.parametrize("transient", [False, True])
@pytest.mark.parametrize("LM", [3, 2, 1, 0])
def test_tdac_rows_at_once_match_block_loop(LM, transient):
    """The block-parallel epilogue equals the sequential block loop."""
    rng = np.random.default_rng(90 + 2 * LM + transient)
    freq, dcc, _ = imdct_tdac_inputs(rng, 7, LM, "false")
    N = 120 << LM
    hist = dcc[DBS - N:DBS - N + OV // 2]
    shift, Bblk, n4, nb = _plan_of(LM, transient)
    yr, yi = fft_blocks_ref(t32(freq), shift, Bblk)
    x = _interleave(yr.numpy(), yi.numpy(), n4)
    got = _rows_at_once(x, hist, N, nb)
    want = celt_imdct_frame_T(t32(freq), t32(hist), LM, transient,
                              fft=fft_blocks_ref)
    assert_equal(got, want.numpy(), f"LM {LM} transient {transient}")


@pytest.mark.parametrize("LM", [3, 2, 1, 0])
def test_kernel_schedule_matches_plain(LM):
    """Per stream only its own plan's FFT, the rows at once, the clamp of
    the N finished rows and the stores: equal to the plain version, flags
    mixed within every 8-stream tile."""
    rng = np.random.default_rng(110 + LM)
    B = 19
    freq, dcc, tr = imdct_tdac_inputs(rng, B, LM, "random")
    N = 120 << LM
    want = celt_imdct_tdac_T_ref(t32(freq), t32(dcc), torch.as_tensor(tr),
                                 LM=LM).numpy()
    got = dcc.copy()
    hist = dcc[DBS - N:DBS - N + OV // 2].copy()
    for b in range(B):
        shift, Bblk, n4, nb = _plan_of(LM, bool(tr[b]))
        yr, yi = fft_blocks_ref(t32(freq[:, b:b + 1]), shift, Bblk)
        x = _interleave(yr.numpy(), yi.numpy(), n4)
        region = _rows_at_once(x, hist[:, b:b + 1], N, nb)
        got[DBS - N:DBS, b] = np.clip(region[:N, 0], -SIG_SAT, SIG_SAT)
        got[DBS:DBS + OV // 2, b] = region[N:, 0]
    assert_equal(got, want, f"LM {LM}")
