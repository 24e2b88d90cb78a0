"""The plain torch versions of the two concealment kernels (K8 conceal,
K9 comfort noise) and the glue helpers of torch_plc held bit for bit
against the JAX functions they port: the Pallas kernels in interpret mode
and the XLA bodies of jax_plc. Tolerance: 0 (int32 fixed point)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from esp32_opus_player_tpu.ops.silk import jax_plc as jp
from esp32_opus_player_tpu.ops.silk.pallas_core import (
    cng_add_pallas, silk_plc_conceal_pallas)
from esp32_opus_player_tpu_torch.ops.silk import torch_plc as tp
from esp32_opus_player_tpu_torch.ops.silk.cng_kernel import cng_add
from esp32_opus_player_tpu_torch.ops.silk.plc_kernel import silk_plc_conceal

from torch_port_util import assert_equal, silk_plc_inputs, t32

PLC_SETS = [(16, 4, 16), (8, 4, 10), (12, 4, 10), (16, 2, 16)]


@pytest.mark.parametrize("fs,nb,order", PLC_SETS)
def test_plc_conceal_matches_pallas_and_xla(fs, nb, order):
    """K8's plain version (through its wrapper: a CPU tensor launches
    nothing) against silk_plc_conceal_pallas in interpret mode and
    silk_plc_conceal_frame_xla; rows 0 and 1 sit at lag 2 fs and 18 fs."""
    rng = np.random.default_rng(7 + fs + nb)
    args = silk_plc_inputs(rng, 6, fs, nb, order)
    kw = dict(fs_khz=fs, nb_subfr=nb, order=order)
    # the TPU kernel takes exactly nb rows of B4 and lag4; the XLA body
    # and the port read the first nb of 4
    pargs = list(args)
    pargs[4], pargs[5] = args[4][:, :nb], args[5][:, :nb]
    xp, sp = silk_plc_conceal_pallas(*map(jnp.asarray, pargs), **kw,
                                     interpret=True)
    xr, sr = jp.silk_plc_conceal_frame_xla(*map(jnp.asarray, args), **kw)
    n0 = silk_plc_conceal.launches
    xt, st = silk_plc_conceal(*map(t32, args), **kw)
    assert silk_plc_conceal.launches == n0
    assert_equal(xt, xr, "xq vs xla")
    assert_equal(st, sr, "sLPC vs xla")
    assert_equal(xt, xp, "xq vs pallas")
    assert_equal(st, sp, "sLPC vs pallas")


@pytest.mark.parametrize("fs,nb,order", PLC_SETS)
def test_cng_add_matches_pallas_and_xla(fs, nb, order):
    """K9's plain version against cng_add_pallas (interpret mode) and
    cng_add_xla, with a mask of both values and a state over the whole
    int32 range."""
    rng = np.random.default_rng(11 + fs + nb)
    B, frame = 6, nb * 5 * fs
    xq = rng.integers(-32768, 32768, (B, frame)).astype(np.int32)
    exc = rng.integers(-(1 << 16), 1 << 16, (B, frame)).astype(np.int32)
    A = rng.integers(-(1 << 12), 1 << 12, (B, order)).astype(np.int32)
    gain = rng.integers(1 << 8, 1 << 14, B).astype(np.int32)
    st0 = rng.integers(-(1 << 31), 1 << 31, (B, 16)).astype(np.int32)
    mask = np.array([True, False, True, True, False, True])
    kw = dict(frame=frame, order=order)
    jargs = [jnp.asarray(a) for a in (xq, exc, A, gain, st0, mask)]
    op, sp = cng_add_pallas(*jargs, **kw, interpret=True)
    ox, sx = jp.cng_add_xla(*jargs, **kw)
    n0 = cng_add.launches
    ot, st = cng_add(t32(xq), t32(exc), t32(A), t32(gain), t32(st0),
                     torch.tensor(mask), **kw)
    assert cng_add.launches == n0
    assert_equal(ot, ox, "out vs xla")
    assert_equal(st, sx, "state vs xla")
    assert_equal(ot, op, "out vs pallas")
    assert_equal(st, sp, "state vs pallas")
    assert_equal(ot[1], xq[1], "a masked-out row passes through")
    assert_equal(st[1], st0[1], "a masked-out row keeps its state")


def _edge_values(rng):
    edge = [0, 1, 2, 3, -1, -2, 2 ** 31 - 1, -2 ** 31, 2 ** 30, 2 ** 30 - 1,
            65535, 65536, 1 << 24, (1 << 24) - 1]
    edge += [1 << k for k in range(31)] + [(1 << k) - 1 for k in range(2, 31)]
    rand = rng.integers(-2 ** 31, 2 ** 31, 4000)
    return np.concatenate([np.array(edge, np.int64), rand]).astype(np.int32)


def test_clz32_and_sqrt_approx_match_jax():
    """Over the whole int32 range: zero, negatives, every power of two
    and its predecessor."""
    x = _edge_values(np.random.default_rng(1))
    assert_equal(tp.clz32(t32(x)), jp.clz32(jnp.asarray(x)), "clz32")
    assert int(tp.clz32(t32([0]))[0]) == 32
    assert int(tp.clz32(t32([-5]))[0]) == 0
    assert_equal(tp.sqrt_approx(t32(x)), jp.sqrt_approx(jnp.asarray(x)),
                 "sqrt_approx")


@pytest.mark.parametrize("frame", [320, 160, 81])
def test_frame_energy_matches_jax(frame):
    """sum_sqr_shift over quiet, loud and full-scale rows (a row of
    -32768 makes every pair sum wrap to -2^31), even and odd lengths."""
    rng = np.random.default_rng(frame)
    x = rng.integers(-32768, 32768, (8, frame)).astype(np.int32)
    x[0] = 0
    x[1] = rng.integers(-3, 4, frame)
    x[2] = -32768
    x[3] = 32767
    x[4, ::2] = -32768
    ej, sj = jp.frame_energy(jnp.asarray(x), frame=frame)
    et, st = tp.frame_energy(t32(x), frame=frame)
    assert_equal(et, ej, "energy")
    assert_equal(st, sj, "shift")


@pytest.mark.parametrize("frame", [320, 160])
def test_glue_frames_matches_jax(frame):
    """glue_frames with a reference energy of 0 (ce = 0), negative
    (a wrapped sum), above and far below the frame's own, shifts on both
    sides, and the mask off."""
    rng = np.random.default_rng(3 + frame)
    B = 12
    x = rng.integers(-20000, 20000, (B, frame)).astype(np.int32)
    x[0] = rng.integers(-40, 40, frame)          # en < ce: no ramp
    x[5] = -32768                                # the energy sum wraps
    x[6] = 32767
    ce = rng.integers(1, 1 << 28, B).astype(np.int32)
    cs = rng.integers(0, 12, B).astype(np.int32)
    ce[0] = 1 << 30
    ce[1] = 0
    ce[2] = 1
    ce[3] = -12345
    ce[4] = 2 ** 31 - 1
    cs[7], cs[8] = 0, 11
    mask = np.ones(B, bool)
    mask[9] = False
    want = jp.glue_frames(jnp.asarray(x), jnp.asarray(ce), jnp.asarray(cs),
                          jnp.asarray(mask), frame=frame)
    got = tp.glue_frames(t32(x), t32(ce), t32(cs), torch.tensor(mask),
                         frame=frame)
    assert_equal(got, want, "glue_frames")
    assert not np.array_equal(np.asarray(want), x)   # some row did ramp
    assert_equal(got[9], x[9], "masked-off row")
