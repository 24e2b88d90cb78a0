"""Decoder state carried from the JAX package into the port: frames 0-1
of a pool run in JAX's transposed packed step (Pallas kernels in
interpret mode), the state moves over with utils.state.from_jax_state,
and frame 2 is then bit-equal in both."""
import numpy as np
import torch

import jax.numpy as jnp

from esp32_opus_player_tpu.models.stream_pool import (
    _celt_pool_step_packed_T)
from esp32_opus_player_tpu_torch.models.celt_pool_T import (
    celt_packed_frame_T)
from esp32_opus_player_tpu_torch.models.stream_pool import StreamPool
from esp32_opus_player_tpu_torch.utils.state import from_jax_state, to_numpy

from conftest import fixture_path
from torch_port_util import assert_equal


def test_state_from_jax_then_one_frame():
    srcs = [str(fixture_path(n))
            for n in ("celt_fb_mono_20ms", "celt_fb_mono_drums_20ms")]
    pool = StreamPool(srcs, channels=1, superstep_k=4, device="cpu")
    for k in range(3):                  # stream 1 loses packet 1
        pool.step(lost={1} if k == 1 else None)
    stg = pool._lanes[0].stg_np[:3].copy()   # staging of frames 0-2
    kw = dict(LM=3, C=1, CC=1)

    def jax_step(dm, pre, s):
        *pcm, dm2, pre2 = _celt_pool_step_packed_T(
            jnp.asarray(dm), jnp.asarray(pre), jnp.asarray(s),
            d2h_chunks=1, masked=True, interpret=True, **kw)
        return np.asarray(pcm[0]), np.asarray(dm2), np.asarray(pre2)

    dm = np.zeros((1, 2168, 2), np.int32)
    pre = np.zeros((2, 1), np.int32)
    port = from_jax_state(dm, pre, device="cpu")
    for k in range(2):
        _, dm, pre = jax_step(dm, pre, stg[k])
        celt_packed_frame_T(port["decode_mem"], port["preemph"],
                            torch.from_numpy(stg[k]), masked=True, **kw)
    got_dm, got_pre = to_numpy(port)
    assert_equal(got_dm, dm, "decode_mem after frame 1")
    assert_equal(got_pre, pre, "preemph after frame 1")
    state = from_jax_state(dm, pre, device="cpu")
    pcm_j, dm_j, pre_j = jax_step(dm, pre, stg[2])
    pcm_t = celt_packed_frame_T(state["decode_mem"], state["preemph"],
                                torch.from_numpy(stg[2]), masked=True, **kw)
    assert_equal(pcm_t, pcm_j, "pcm of frame 2")
    dm_t, pre_t = to_numpy(state)
    assert_equal(dm_t, dm_j, "decode_mem after frame 2")
    assert_equal(pre_t, pre_j, "preemph after frame 2")
