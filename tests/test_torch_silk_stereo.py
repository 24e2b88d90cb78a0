"""The port's stereo SILK and multi-frame SILK lanes on the CPU (the
kernels' plain versions): the stereo unmix (ops/silk/stereo_kernel.py,
kernel S1's plain version) bit-equal to the JAX package's
ms_to_lr_batch, and pools of stereo SILK (compat 20 ms; RFC 10, 40 and
60 ms) and of mono SILK in RFC mode at 10, 40 and 60 ms bit-equal to
tests/golden (compat) or to both the JAX package's decode_file and the
port's own (RFC: the reference crashes on these packet sizes, so there
is no golden). Tolerance: 0."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esp32_opus_player_tpu import DecoderConfig as JaxConfig
from esp32_opus_player_tpu import decode_file as jax_decode_file
from esp32_opus_player_tpu.ops.silk.jax_stereo import ms_to_lr_batch
from esp32_opus_player_tpu_torch import DecoderConfig, decode_file
from esp32_opus_player_tpu_torch.ops.silk.stereo_kernel import ms_to_lr
from esp32_opus_player_tpu_torch.models.stream_pool import StreamPool

from conftest import fixture_path, golden_pcm
from torch_port_util import assert_equal, t32


@pytest.mark.parametrize("ms", [10, 20])
@pytest.mark.parametrize("fs", [8, 12, 16])
def test_unmix_matches_jax(fs, ms):
    """Seeded frames and histories over the int16 range, predictors over
    the quantiser's Q13 range (+-13732) with rows at its extremes and at
    the int16 ones, a row with a zero delta, and histories at +-32767."""
    rng = np.random.default_rng(fs * 100 + ms)
    B, frame = 12, ms * fs
    i16 = lambda *sh: rng.integers(-32768, 32768, sh).astype(np.int32)
    hm, hs, xm, xs = i16(B, 2), i16(B, 2), i16(B, frame), i16(B, frame)
    prev = rng.integers(-13732, 13733, (B, 2)).astype(np.int32)
    pred = rng.integers(-13732, 13733, (B, 2)).astype(np.int32)
    edge = [(13732, -13732), (-13732, 13732), (32767, -32768),
            (-32768, 32767)]
    for r in range(4):
        prev[r], pred[r] = edge[r], edge[3 - r]
    pred[5] = prev[5]
    hm[6], hs[6] = (32767, 32767), (-32767, -32767)
    hm[7], hs[7] = (-32767, 32767), (32767, -32767)
    L, R, nm, ns = ms_to_lr_batch(*map(jnp.asarray, (hm, hs, prev, xm, xs,
                                                     pred)),
                                  fs_khz=fs, frame_length=frame)
    lr, m2, s2 = ms_to_lr(t32(hm), t32(hs), t32(prev),
                          torch.stack([t32(xm), t32(xs)], 1), t32(pred),
                          fs_khz=fs, frame=frame)
    assert_equal(lr[:, 0], np.asarray(L), "L")
    assert_equal(lr[:, 1], np.asarray(R), "R")
    assert_equal(m2, np.asarray(nm), "sMid")
    assert_equal(s2, np.asarray(ns), "sSide")


def _pool(name, channels, compat, K, n=2):
    pool = StreamPool([str(fixture_path(name))] * n, channels=channels,
                      compat_ref=compat, superstep_k=K, device="cpu")
    return pool, pool.run()


@pytest.mark.parametrize("name,fs", [("silk_nb_stereo_20ms", 8),
                                     ("silk_wb_stereo_20ms", 16)])
def test_stereo_pool_matches_golden(name, fs):
    """Compat mode, 20 ms: one lane, the mid and side rows of both
    streams through one core call a frame, in K = 3 windows."""
    pool, out = _pool(name, 2, True, 3)
    assert pool.path == [("silk2", fs, 1, 20, 20)] * 2
    gold = golden_pcm(name)
    for o in out:
        assert len(o) > 90000
        assert_equal(o, gold[:len(o)], name)


def _rfc_refs(name, channels):
    """The JAX package's decode_file and the port's, RFC mode."""
    jref = jax_decode_file(str(fixture_path(name)),
                           JaxConfig(channels=channels, compat_ref=False))
    pref = decode_file(str(fixture_path(name)),
                       DecoderConfig(channels=channels, compat_ref=False,
                                     device="cpu"))
    assert_equal(pref, jref, f"{name}: the two decode_files")
    return pref


@pytest.mark.parametrize("name,channels,path", [
    ("silk_nb_stereo_40ms", 2, ("silk2", 8, 2, 40, 20)),
    ("silk_wb_stereo_60ms", 2, ("silk2", 16, 3, 60, 20)),
    ("silk_wb_fec_stereo_10ms", 2, ("silk2", 16, 1, 10, 10)),
    ("silk_wb_mono_10ms", 1, ("silk", 16, 1, 10, 10)),
    ("silk_wb_mono_40ms", 1, ("silk", 16, 2, 40, 20)),
    ("silk_wb_mono_60ms", 1, ("silk", 16, 3, 60, 20))])
def test_rfc_multiframe_pool_matches_decode_files(name, channels, path):
    """RFC mode: 10 ms frames (nb 2) and packets of two or three 20 ms
    device frames, a window counting device frames (K = 4 cuts the
    packets of 60 ms across windows)."""
    pool, out = _pool(name, channels, False, 4)
    assert pool.path == [path] * 2
    ref = _rfc_refs(name, channels)
    for o in out:
        assert len(o) > 60000
        assert_equal(o, ref, name)
