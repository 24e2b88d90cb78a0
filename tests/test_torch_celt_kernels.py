"""The torch twins of the three CELT kernels (K1 iMDCT FFT, K2 comb
postfilter, K3 deemphasis) and the Q15 helpers, held bit for bit against
the JAX functions they port: the Pallas kernels in interpret mode and
the XLA paths the kernels replaced. Tolerance: 0 (int32 fixed point)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from esp32_opus_player_tpu.ops.celt import jax_synthesis as js
from esp32_opus_player_tpu.ops.celt import jax_synthesis_T as jt
from esp32_opus_player_tpu.ops.celt.pallas_comb import (
    comb_filter_step_T as jax_comb_step_T)
from esp32_opus_player_tpu.ops.celt.pallas_fft import fft_blocks_pallas
from esp32_opus_player_tpu_torch.ops.celt import torch_synthesis as ts
from esp32_opus_player_tpu_torch.ops.celt.comb import (
    comb_filter_step_T, comb_filter_step_T_ref)
from esp32_opus_player_tpu_torch.ops.celt.deemph import (deemphasis_T,
                                                         deemphasis_T_ref)
from esp32_opus_player_tpu_torch.ops.celt.fft import (celt_imdct_frame_T,
                                                      fft_blocks,
                                                      fft_blocks_ref)

from torch_port_util import DBS, OV, assert_equal, comb_params, t32

# (LM, transient) covering the 7 iMDCT plans (LM 0 has one plan)
PLANS = [(3, False), (3, True), (2, False), (2, True), (1, False),
         (1, True), (0, False)]


def test_q15_helpers_match_jax():
    rng = np.random.default_rng(1)
    edge = np.array([0, 1, -1, 32767, -32768, 65535, -65536, 2 ** 31 - 1,
                     -2 ** 31, 2 ** 30, -2 ** 30], np.int64)
    x = np.concatenate([edge, rng.integers(-2 ** 31, 2 ** 31, 4000)])
    x = x.astype(np.int32)
    t = np.concatenate([np.array([0, 1, -1, 32767, -32768] * 2 + [23170]),
                        rng.integers(-32768, 32768, 4000)]).astype(np.int32)
    assert_equal(ts.smul(t32(x), t32(t)), js.smul(jnp.asarray(x),
                                                  jnp.asarray(t)), "smul")
    a = rng.integers(-32768, 32768, 4000).astype(np.int32)
    b = rng.integers(-32768, 32768, 4000).astype(np.int32)
    assert_equal(ts.mult16_16_q15(t32(a), t32(b)),
                 js.mult16_16_q15(jnp.asarray(a), jnp.asarray(b)), "q15")
    assert_equal(ts.mult16_16_p15(t32(a), t32(b)),
                 js.mult16_16_p15(jnp.asarray(a), jnp.asarray(b)), "p15")
    assert_equal(ts.sat16(t32(x)), js.sat16(jnp.asarray(x)), "sat16")
    q = rng.integers(0, 1 << 16, 4000).astype(np.int32)
    assert_equal(ts.exp2_frac(t32(q)), js.exp2_frac(jnp.asarray(q)),
                 "exp2_frac")


@pytest.mark.parametrize("shift,Bblk", [(0, 1), (3, 8)])
def test_fft_twin_matches_pallas_interpret(shift, Bblk):
    """Both LM-3 plans: the twin against the Pallas kernel itself."""
    rng = np.random.default_rng(10 + shift)
    freq = rng.integers(-(1 << 22), 1 << 22, (960, 6)).astype(np.int32)
    yr, yi = fft_blocks_pallas(jnp.asarray(freq), shift=shift, Bblk=Bblk,
                               interpret=True)
    gr, gi = fft_blocks_ref(t32(freq), shift, Bblk)
    assert_equal(gr, yr, "yr")
    assert_equal(gi, yi, "yi")


@pytest.mark.parametrize("LM,transient", PLANS)
def test_imdct_frame_matches_xla(LM, transient):
    """All 7 plans: the twin inside the port's transposed iMDCT frame
    against the row-layout XLA iMDCT (opus_fft_batch, pre/post-rotate,
    TDAC) that the Pallas kernel replaced."""
    rng = np.random.default_rng(20 + 2 * LM + transient)
    B, N = 5, 120 << LM
    freq = rng.integers(-(1 << 22), 1 << 22, (B, N)).astype(np.int32)
    hist = rng.integers(-(1 << 22), 1 << 22, (B, OV // 2)).astype(np.int32)
    want = js.celt_imdct_frame(jnp.asarray(freq), jnp.asarray(hist), LM,
                               transient)
    got = celt_imdct_frame_T(t32(freq.T), t32(hist.T), LM, transient)
    assert_equal(got.T, want, f"LM {LM} transient {transient}")


def test_fft_wrapper_takes_twin_on_cpu():
    freq = t32(np.random.default_rng(3).integers(-9999, 9999, (960, 4)))
    before = fft_blocks.launches
    got = fft_blocks(freq, 0, 1)
    want = fft_blocks_ref(freq, 0, 1)
    assert fft_blocks.launches == before
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _comb_case(seed, B=8, low=15):
    rng = np.random.default_rng(seed)
    buf = rng.integers(-(1 << 24), 1 << 24, (DBS + OV, B)).astype(np.int32)
    return buf, comb_params(rng, B, low), comb_params(rng, B, low)


def test_comb_twin_matches_pallas_interpret():
    """Both regions of an LM-1 frame (N = 240: the interpret-mode kernel
    unrolls every chunk, so the 960-sample frame is left to the XLA-walk
    tests below)."""
    buf, c1, c2 = _comb_case(30)
    N = 240
    want = jax_comb_step_T(jnp.asarray(buf), DBS - N, N,
                           tuple(jnp.asarray(v) for v in c1),
                           tuple(jnp.asarray(v) for v in c2), chunk=13,
                           interpret=True)
    got = comb_filter_step_T(t32(buf), DBS - N, N,
                             tuple(map(t32, c1)), tuple(map(t32, c2)))
    assert_equal(got, want, "comb vs pallas interpret")


@pytest.mark.parametrize("low", [15, 300])
def test_comb_twin_matches_xla_chunk_walk(low):
    """Both regions against two comb_filter_batch calls (chunk 13, the
    XLA walk); low = the smallest lag drawn (15 is the feedback edge)."""
    buf, c1, c2 = _comb_case(40 + low, low=low)
    start = DBS - 960
    row = jnp.asarray(buf.T)
    row = js.comb_filter_batch(row, start, 120,
                               *(jnp.asarray(v) for v in c1), chunk=13)
    row = js.comb_filter_batch(row, start + 120, 840,
                               *(jnp.asarray(v) for v in c2), chunk=13)
    got = comb_filter_step_T_ref(t32(buf), start, 960, tuple(map(t32, c1)),
                                 tuple(map(t32, c2)))
    assert_equal(got.T, row, "comb vs comb_filter_batch")


@pytest.mark.parametrize("downsample", [1, 2, 3, 4, 6])
def test_deemph_twin_matches_xla(downsample):
    rng = np.random.default_rng(50 + downsample)
    B, CC, N = 6, 2, 960
    syn = rng.integers(-(1 << 28), 1 << 28, (B, CC, N)).astype(np.int32)
    mem = rng.integers(-(1 << 20), 1 << 20, (B, CC)).astype(np.int32)
    pcm, mem2 = js.deemphasis_batch(jnp.asarray(syn), jnp.asarray(mem),
                                    downsample=downsample)
    gp, gm = deemphasis_T(t32(np.moveaxis(syn, 0, 2)), t32(mem),
                          downsample)
    assert gp.dtype == torch.int16
    assert_equal(gp, np.moveaxis(np.asarray(pcm), 0, 2), "pcm")
    assert_equal(gm, mem2, "mem")


def test_deemph_twin_matches_pallas_interpret():
    rng = np.random.default_rng(60)
    CC, N, B = 2, 960, 5
    synT = rng.integers(-(1 << 28), 1 << 28, (CC, N, B)).astype(np.int32)
    mem = rng.integers(-(1 << 20), 1 << 20, (B, CC)).astype(np.int32)
    pcm, mem2 = jt.deemphasis_T(jnp.asarray(synT), jnp.asarray(mem),
                                interpret=True)
    gp, gm = deemphasis_T_ref(t32(synT), t32(mem))
    assert_equal(gp, pcm, "pcm")
    assert_equal(gm, mem2, "mem")
