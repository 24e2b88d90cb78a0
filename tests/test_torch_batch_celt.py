"""The port's row-layout CELT step (models/batch_celt.py) held bit for bit
against the JAX package's models/batch_celt.py on the CPU: the JAX side
runs its XLA path, the port its plain version (the port of the JAX row
functions, ops/celt/row_synthesis.py). LM 0-3, every stream transient
or none (celt_synth_step) or a per-stream mix (celt_synth_step_dual),
(C, CC) in ((1, 1), (2, 1), (2, 2)), 9 streams. Tolerance: 0 (int32
fixed point). Also the port's entry() against __graft_entry__.entry()."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import __graft_entry__
from esp32_opus_player_tpu.models import batch_celt as jbc
from esp32_opus_player_tpu_torch import entry as port_entry
from esp32_opus_player_tpu_torch.models import batch_celt as tbc

from torch_port_util import assert_equal, synth_inputs, t32

B = 9


@pytest.mark.parametrize("C,CC", [(1, 1), (2, 1), (2, 2)])
@pytest.mark.parametrize("LM", [0, 1, 2, 3])
@pytest.mark.parametrize("flags", ["none", "all", "mixed"])
def test_step_matches_jax(LM, C, CC, flags):
    rng = np.random.default_rng(100 + 10 * LM + 3 * C + CC)
    dm, pre, X, bandE, start, end, c1, c2, tr = synth_inputs(rng, B, C, CC,
                                                             LM)
    # below fullband in some rows (the end band of NB, MB/WB, SWB)
    end[:3] = (13, 17, 19)
    kw = dict(LM=LM, C=C, CC=CC)
    jargs = (jnp.asarray(dm), jnp.asarray(pre), jnp.asarray(X),
             jnp.asarray(bandE), jnp.asarray(start), jnp.asarray(end),
             tuple(map(jnp.asarray, c1)), tuple(map(jnp.asarray, c2)))
    targs = (t32(dm), t32(pre), t32(X), t32(bandE), t32(start), t32(end),
             tuple(map(t32, c1)), tuple(map(t32, c2)))
    if flags == "mixed":
        want = jbc.celt_synth_step_dual(*jargs, jnp.asarray(tr), chunk=13,
                                        pallas_fft=False, **kw)
        got = tbc.celt_synth_step_dual(*targs, torch.as_tensor(tr), **kw)
    else:
        want = jbc.celt_synth_step(*jargs, transient=flags == "all", **kw)
        got = tbc.celt_synth_step(*targs, transient=flags == "all", **kw)
    for what, g, w in zip(("pcm", "decode_mem", "preemph"), got, want):
        assert_equal(g, w, what)
    assert got[1].shape == (B, CC, 2168)
    assert_equal(targs[0], dm, "decode_mem input left unwritten")


@pytest.mark.parametrize("downsample", [2, 3])
def test_dual_step_downsampled(downsample):
    rng = np.random.default_rng(7 + downsample)
    *ins, tr = synth_inputs(rng, B, 2, 2, 3)
    jargs = [jnp.asarray(a) if not isinstance(a, tuple)
             else tuple(map(jnp.asarray, a)) for a in ins]
    targs = [t32(a) if not isinstance(a, tuple) else tuple(map(t32, a))
             for a in ins]
    kw = dict(LM=3, C=2, CC=2, downsample=downsample)
    want = jbc.celt_synth_step_dual(*jargs, jnp.asarray(tr),
                                    pallas_fft=False, **kw)
    got = tbc.celt_synth_step_dual(*targs, torch.as_tensor(tr), **kw)
    for what, g, w in zip(("pcm", "decode_mem", "preemph"), got, want):
        assert_equal(g, w, what)


def test_make_state():
    st = tbc.make_state(5, 2, device="cpu")
    want = jbc.make_state(5, 2)
    for k in ("decode_mem", "preemph"):
        assert st[k].dtype == torch.int32
        assert_equal(st[k], want[k], k)
    assert tbc.NB_EBANDS == jbc.NB_EBANDS


def test_entry_matches_graft_entry():
    """entry(device="cpu") builds the JAX entry's example args value for
    value, and its function gives the JAX function's outputs; two steps,
    the second on the first's state."""
    fn, args = port_entry.entry(device="cpu")
    jfn, jargs = __graft_entry__.entry()
    for a, w in zip(args[:6], jargs[:6]):
        assert_equal(a, w, "example arg")
    for a, w in zip(args[6] + args[7], jargs[6] + jargs[7]):
        assert_equal(a, w, "comb param")
    for _ in range(2):
        got, want = fn(*args), jfn(*jargs)
        for what, g, w in zip(("pcm", "decode_mem", "preemph"), got, want):
            assert_equal(g, w, what)
        args = (got[1], got[2]) + tuple(args[2:])
        jargs = (want[1], want[2]) + tuple(jargs[2:])
    assert got[0].shape == (8, 1, 960)


def test_entry_default_device_is_the_card():
    """Without a device the entry's args lie on the card; with no card it
    raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        assert port_entry.entry()[1][2].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_entry.entry()
