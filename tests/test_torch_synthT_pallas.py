"""The port's transposed CELT frame step held bit for bit against the
JAX transposed step with its three Pallas kernels in interpret mode (the
TPU path itself). Tolerance: 0 (int32 fixed point)."""
import numpy as np

import jax.numpy as jnp

from esp32_opus_player_tpu.ops.celt import jax_synthesis_T as jt

from torch_port_util import assert_equal, port_synth_step, synth_inputs


def test_port_step_matches_pallas_interpret_lm3():
    """LM 3 against jax_synthesis_T with its three Pallas kernels in
    interpret mode (the TPU path itself, at B = 4; a stereo-coded frame
    downmixed to one output channel keeps the interpret-mode comb to one
    channel)."""
    rng = np.random.default_rng(99)
    C, CC = 2, 1
    dm, pre, X, bandE, start, end, c1, c2, tr = synth_inputs(rng, 4, C, CC,
                                                             3)
    pcm_t, dmT2, pre_t = jt.celt_synth_step_dual_T(
        jnp.asarray(np.moveaxis(dm, 0, 2)), jnp.asarray(pre),
        jnp.asarray(np.moveaxis(X, 0, 2)), jnp.asarray(bandE),
        jnp.asarray(start), jnp.asarray(end),
        tuple(jnp.asarray(v) for v in c1),
        tuple(jnp.asarray(v) for v in c2), jnp.asarray(tr),
        LM=3, C=C, CC=CC, chunk=13, interpret=True)
    pcm, dm2, pre2 = port_synth_step(dm, pre, X, bandE, start, end, c1,
                                     c2, tr, LM=3, C=C, CC=CC)
    assert_equal(pcm, np.moveaxis(np.asarray(pcm_t), 2, 0), "pcm")
    assert_equal(dm2, np.moveaxis(np.asarray(dmT2), 2, 0), "decode_mem")
    assert_equal(pre2, pre_t, "preemph")
