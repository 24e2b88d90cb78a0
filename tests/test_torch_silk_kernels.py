"""The plain torch versions of the three SILK kernels (K5 LPC synthesis,
K6 2x allpass upsampler, K7 whole decode_core) held bit for bit against
the JAX functions they port: the Pallas kernels in interpret mode and the
XLA paths (jax_core). Tolerance: 0 (int32 fixed point)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from esp32_opus_player_tpu.ops.silk import jax_core as sjc
from esp32_opus_player_tpu.ops.silk.pallas_core import (lpc_synth_pallas,
                                                        silk_core_pallas,
                                                        up2_hq_pallas)
from esp32_opus_player_tpu_torch.ops.silk import torch_core as tc
from esp32_opus_player_tpu_torch.ops.silk.core_kernel import (silk_core,
                                                              silk_core_ref)
from esp32_opus_player_tpu_torch.ops.silk.lpc_synth import (lpc_synth,
                                                            lpc_synth_ref)
from esp32_opus_player_tpu_torch.ops.silk.up2_hq import up2_hq

from torch_port_util import assert_equal, silk_core_inputs, t32

CORE_SETS = [(16, 4, 16), (12, 4, 16), (8, 4, 10), (16, 2, 16)]


def _torch_args(args):
    return tuple(torch.as_tensor(a) if a.dtype == bool else t32(a)
                 for a in args)


@pytest.mark.parametrize("n,order,a_max", [(80, 16, 20000),
                                           (80, 10, 20000),
                                           (40, 16, 20000),
                                           (80, 16, 1 << 17)])
def test_lpc_synth_matches_pallas(n, order, a_max):
    """K5's plain version against lpc_synth_pallas (interpret mode), with
    B = 8 as tests/test_device_batch.py draws the inputs; a_max 2^17
    gives coefficients where the JAX smulwb wraps."""
    rng = np.random.default_rng(5 + n + order)
    B = 8
    pres = rng.integers(-(1 << 24), 1 << 24, (B, n)).astype(np.int32)
    A = rng.integers(-a_max, a_max, (B, order)).astype(np.int32)
    st0 = rng.integers(-(1 << 24), 1 << 24, (B, 16)).astype(np.int32)
    vp, sp = lpc_synth_pallas(jnp.asarray(pres), jnp.asarray(A),
                              jnp.asarray(st0), order=order, interpret=True)
    n0 = lpc_synth.launches
    vt, stt = lpc_synth(t32(pres), t32(A), t32(st0), order=order)
    assert lpc_synth.launches == n0      # a CPU tensor takes the plain path
    assert_equal(vt, vp, "vs")
    assert_equal(stt, sp, "state")


@pytest.mark.parametrize("n,s_bits", [(144, 20), (80, 20), (16, 20),
                                      (1, 20), (160, 31)])
def test_up2_hq_matches_pallas(n, s_bits):
    """K6's plain version (torch_core.up2_hq_scan) against up2_hq_pallas
    in interpret mode and jax_core.up2_hq_scan; n = 144 is not a
    multiple of the TPU kernel's 20-sample block; states over the whole
    int32 range (s_bits 31) make the sums wrap."""
    rng = np.random.default_rng(6 + n)
    B = 8
    inp = rng.integers(-32768, 32768, (B, n)).astype(np.int32)
    S = rng.integers(-(1 << s_bits), 1 << s_bits, (B, 6)).astype(np.int32)
    op, sp = up2_hq_pallas(jnp.asarray(S), jnp.asarray(inp), interpret=True)
    ox, sx = sjc.up2_hq_scan(jnp.asarray(S), jnp.asarray(inp))
    ot, st2 = up2_hq(t32(S), t32(inp))
    assert_equal(ot, op, "out vs pallas")
    assert_equal(st2, sp, "S vs pallas")
    assert_equal(ot, ox, "out vs scan")
    assert_equal(st2, sx, "S vs scan")


@pytest.mark.parametrize("fs,nb,order", CORE_SETS)
def test_silk_core_matches_xla(fs, nb, order):
    """K7's plain version and the chunked core (with K5's wrapper) against
    jax_core.silk_core_frame_xla, for all four (fs, nb, order) sets, with
    edge rows at lag = 2 fs and every voiced/rewhiten/match combination."""
    rng = np.random.default_rng(42 + fs + nb)
    args = silk_core_inputs(rng, 12, fs, nb)
    kw = dict(fs_khz=fs, nb_subfr=nb, order=order)
    xr, sr = sjc.silk_core_frame_xla(*map(jnp.asarray, args), **kw)
    for fn in (silk_core_ref, tc.silk_core_frame, silk_core):
        xt, stt = fn(*_torch_args(args), **kw)
        assert_equal(xt, xr, f"{fn.__name__} xq")
        assert_equal(stt, sr, f"{fn.__name__} sLPC")


def test_silk_core_matches_pallas():
    """K7's plain version against silk_core_pallas in interpret mode at
    (16, 4, 16)."""
    rng = np.random.default_rng(7)
    args = silk_core_inputs(rng, 10, 16, 4)
    kw = dict(fs_khz=16, nb_subfr=4, order=16)
    xp, sp = silk_core_pallas(*map(jnp.asarray, args), **kw, interpret=True)
    xt, stt = silk_core_ref(*_torch_args(args), **kw)
    assert_equal(xt, xp, "xq")
    assert_equal(stt, sp, "sLPC")
