"""The plain torch version of the fused comb + deemphasis kernel (K4)
held bit for bit against the JAX package: comb_deemph_step_T in interpret
mode, and comb_filter_step_T followed by deemphasis_T. No path of the JAX
package calls the fused kernel, so no JAX test covers it; this one does.
Tolerance: 0 (int32 fixed point)."""
import numpy as np
import pytest

import jax.numpy as jnp

from esp32_opus_player_tpu.ops.celt import jax_synthesis_T as jT
from esp32_opus_player_tpu.ops.celt import pallas_comb as pc
from esp32_opus_player_tpu_torch.ops.celt.comb import (
    comb_deemph_step_T, comb_deemph_step_T_ref, comb_filter_step_T)
from esp32_opus_player_tpu_torch.ops.celt.deemph import deemphasis_T

from torch_port_util import DBS, OV, assert_equal, comb_params, t32


@pytest.mark.parametrize("N", [960, 480, 240, 120])
def test_comb_deemph_matches_pallas_and_composition(N):
    """Every CELT frame size: N 960, 480 and 240 run both comb regions,
    N 120 only the first. The edge rows of comb_params (no-op, unchanged
    params, g1 = 0) are in."""
    rng = np.random.default_rng(40 + N)
    B = 8
    buf = rng.integers(-(1 << 26), 1 << 26, (DBS + OV, B)).astype(np.int32)
    c1, c2 = comb_params(rng, B), comb_params(rng, B)
    mem = rng.integers(-(1 << 20), 1 << 20, B).astype(np.int32)
    j = lambda c: tuple(map(jnp.asarray, c))
    start = DBS - N
    bp, pp, mp = pc.comb_deemph_step_T(jnp.asarray(buf), start, N, j(c1),
                                       j(c2), jnp.asarray(mem),
                                       interpret=True)
    bj = pc.comb_filter_step_T(jnp.asarray(buf), start, N, j(c1), j(c2),
                               interpret=True)
    pj, mj = jT.deemphasis_T(bj[None, start:start + N],
                             jnp.asarray(mem)[:, None], interpret=True)
    t = lambda c: tuple(map(t32, c))
    n0 = comb_deemph_step_T.launches
    bt, pt, mt = comb_deemph_step_T(t32(buf), start, N, t(c1), t(c2),
                                    t32(mem))
    assert comb_deemph_step_T.launches == n0   # a CPU tensor: the twin
    for what, got, want in [("buf", bt, bp), ("pcm", pt, pp),
                            ("mem", mt, mp), ("buf vs K2", bt, bj),
                            ("pcm vs K3", pt, pj[0]),
                            ("mem vs K3", mt, mj[:, 0])]:
        assert_equal(got, want, what)
    assert not np.array_equal(bt.numpy(), buf)      # the comb did run


def test_comb_deemph_is_the_two_wrappers_in_turn():
    """K4's twin equals the port's K2 wrapper followed by its K3 wrapper
    on the frame's rows (what the frame step runs today)."""
    rng = np.random.default_rng(9)
    B, N = 6, 960
    buf = t32(rng.integers(-(1 << 26), 1 << 26, (DBS + OV, B)))
    c1 = tuple(map(t32, comb_params(rng, B)))
    c2 = tuple(map(t32, comb_params(rng, B)))
    mem = t32(rng.integers(-(1 << 20), 1 << 20, B))
    b2 = comb_filter_step_T(buf.clone(), DBS - N, N, c1, c2)
    pcm, mem2 = deemphasis_T(b2[None, DBS - N:DBS], mem[:, None])
    bt, pt, mt = comb_deemph_step_T_ref(buf.clone(), DBS - N, N, c1, c2, mem)
    assert_equal(bt, b2.numpy(), "buf")
    assert_equal(pt, pcm[0].numpy(), "pcm")
    assert_equal(mt, mem2[:, 0].numpy(), "mem")
