"""The port's transposed CELT frame step (ops/celt/synthesis_T.py) held
bit for bit against the JAX row-layout step (batch_celt) across channel
configs, frame sizes and downsample factors. Tolerance: 0 (int32 fixed
point). tests/test_torch_synthT_pallas.py holds it against the JAX
transposed step itself."""
import numpy as np
import pytest

import jax.numpy as jnp

from esp32_opus_player_tpu.models.batch_celt import celt_synth_step_dual

from torch_port_util import assert_equal, port_synth_step, synth_inputs


@pytest.mark.parametrize("C,CC,LM,downsample", [
    (1, 1, 3, 1), (2, 2, 3, 1), (2, 1, 3, 1), (1, 1, 1, 1),
    (1, 1, 0, 1), (1, 1, 3, 2), (1, 1, 3, 3),
])
def test_port_step_matches_row_layout(C, CC, LM, downsample):
    rng = np.random.default_rng(11 + C * 7 + CC + LM + downsample)
    ins = synth_inputs(rng, 8, C, CC, LM)
    dm, pre, X, bandE, start, end, c1, c2, tr = ins
    pcm_r, dm_r, pre_r = celt_synth_step_dual(
        jnp.asarray(dm), jnp.asarray(pre), jnp.asarray(X),
        jnp.asarray(bandE), jnp.asarray(start), jnp.asarray(end),
        tuple(jnp.asarray(v) for v in c1),
        tuple(jnp.asarray(v) for v in c2), jnp.asarray(tr),
        LM=LM, C=C, CC=CC, chunk=13, downsample=downsample)
    pcm, dm2, pre2 = port_synth_step(*ins, LM=LM, C=C, CC=CC,
                                     downsample=downsample)
    assert_equal(pcm, pcm_r, "pcm")
    assert_equal(dm2, dm_r, "decode_mem")
    assert_equal(pre2, pre_r, "preemph")
