"""torch_core, the port of ops/silk/jax_core.py, held bit for bit against
it on the CPU: the Q-format helpers (with |b| >= 2^15 where the JAX
smulwb wraps), the rewhitening FIR and the batched resampler for every
decoder rate pair (8/12/16 kHz internal into 8/12/16/24/48 kHz), with
the resampler state carried over two frames. Tolerance: 0."""
import numpy as np
import pytest

import jax.numpy as jnp

from esp32_opus_player_tpu.ops.silk import jax_core as sjc
from esp32_opus_player_tpu_torch.ops.silk import torch_core as tc

from torch_port_util import assert_equal, t32


@pytest.mark.parametrize("order,W", [(16, 292), (10, 148), (16, 220)])
def test_lpc_analysis_tail_matches_jax(order, W):
    rng = np.random.default_rng(order + W)
    B, L = 6, W + order + 40
    inp = rng.integers(-32768, 32768, (B, L)).astype(np.int32)
    A = rng.integers(-32768, 32768, (B, order)).astype(np.int32)
    want = sjc.lpc_analysis_tail(jnp.asarray(inp), jnp.asarray(A), W, order)
    assert_equal(tc.lpc_analysis_tail(t32(inp), t32(A), W, order), want)


@pytest.mark.parametrize("fs_in", [8, 12, 16])
@pytest.mark.parametrize("fs_out", [8, 12, 16, 24, 48])
def test_resample_batch_matches_jax(fs_in, fs_out):
    """Two 20 ms frames through resample_batch, the state of the first
    carried into the second, against jax_core.resample_batch."""
    rng = np.random.default_rng(100 * fs_in + fs_out)
    B, n = 4, 20 * fs_in
    spec, jspec = (m._resampler_spec(fs_in, fs_out) for m in (tc, sjc))
    assert {k: v for k, v in spec.items() if k != "coefs"} == \
        {k: v for k, v in jspec.items() if k != "coefs"}
    assert np.array_equal(np.asarray(spec["coefs"]), np.asarray(jspec[
        "coefs"])) if spec["coefs"] is not None else jspec["coefs"] is None
    assert tc.sfir_width(fs_in, fs_out) == sjc.sfir_width(fs_in, fs_out)
    width = tc.sfir_width(fs_in, fs_out)
    j_state = (jnp.zeros((B, 6), jnp.int32), jnp.zeros((B, width),
                                                       jnp.int32),
               jnp.zeros((B, fs_in), jnp.int32))
    t_state = tuple(t32(np.asarray(a)) for a in j_state)
    kw = dict(fs_in_khz=fs_in, fs_out_khz=fs_out, in_len=n)
    for frame in range(2):
        inp = rng.integers(-32768, 32768, (B, n)).astype(np.int32)
        jo, *j_state = sjc.resample_batch(*j_state, jnp.asarray(inp), **kw)
        to, *t_state = tc.resample_batch(*t_state, t32(inp), **kw)
        assert_equal(to, jo, f"frame {frame} out")
        for name, got, want in zip(("sIIR", "sFIR", "delay"), t_state,
                                   j_state):
            assert_equal(got, want, f"frame {frame} {name}")


def test_helpers_match_jax_beyond_int16():
    """smulwb/smlawb with |b| >= 2^15 (where the JAX formula wraps and
    differs from the int64 product), smulww, add_sat32, lshift_sat32,
    rshift_round and sat16 on edge and random int32 values."""
    rng = np.random.default_rng(11)
    edge = np.array([0, 1, -1, 32767, -32768, 65535, -65536, 2 ** 31 - 1,
                     -2 ** 31, 2 ** 30, -2 ** 30, 2 ** 15, -2 ** 15 - 1],
                    np.int64)
    a = np.concatenate([np.repeat(edge, len(edge)),
                        rng.integers(-2 ** 31, 2 ** 31, 3000)]).astype(
        np.int32)
    b = np.concatenate([np.tile(edge, len(edge)),
                        rng.integers(-2 ** 31, 2 ** 31, 1000),
                        rng.integers(-2 ** 17, 2 ** 17, 1000),
                        rng.integers(-32768, 32768, 1000)]).astype(np.int32)
    c = rng.integers(-2 ** 31, 2 ** 31, len(a)).astype(np.int32)
    ja, jb, jc = map(jnp.asarray, (a, b, c))
    ta, tb, tcc = map(t32, (a, b, c))
    assert_equal(tc.smulwb(ta, tb), sjc.smulwb(ja, jb), "smulwb")
    assert_equal(tc.smlawb(tcc, ta, tb), sjc.smlawb(jc, ja, jb), "smlawb")
    assert_equal(tc.smulww(ta, tb), sjc.smulww(ja, jb), "smulww")
    assert_equal(tc.add_sat32(ta, tb), sjc.add_sat32(ja, jb), "add_sat32")
    for s in (1, 4, 8, 10, 12, 15):
        assert_equal(tc.rshift_round(ta, s), sjc.rshift_round(ja, s),
                     f"rshift_round {s}")
    for s in (1, 4, 10):
        assert_equal(tc.lshift_sat32(ta, s), sjc.lshift_sat32(ja, s),
                     f"lshift_sat32 {s}")
    assert_equal(tc.sat16(ta), sjc.sat16(ja), "sat16")
    for k in (-32768, -1, 0, 27853, 32767):       # the int16 fast path
        assert_equal(tc.smulwb(ta, k), sjc.smulwb(ja, np.int32(k)),
                     f"smulwb by {k}")
