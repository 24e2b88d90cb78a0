"""The port's hybrid lanes on the CPU (the kernels' plain versions): the
SILK half at 16 kHz and the CELT half from band 17, resumed from the
SILK group's range coder, each in its own K-frame window, mixed SAT16 on
the device once a window. Compat-mode pools of hybrid_swb_mono_20ms and
hybrid_fb_stereo_20ms bit-equal to tests/golden; RFC-mode pools of the
10 ms fixtures (CELT at LM 2, SILK at nb 2) bit-equal to both the JAX
package's decode_file and the port's (the reference crashes on 10 ms
hybrid, so there is no golden). Tolerance: 0."""
import numpy as np
import pytest
import torch

from esp32_opus_player_tpu import DecoderConfig as JaxConfig
from esp32_opus_player_tpu import decode_file as jax_decode_file
from esp32_opus_player_tpu_torch import DecoderConfig, decode_file
from esp32_opus_player_tpu_torch.host import opusfile
from esp32_opus_player_tpu_torch.models.stream_pool import (StreamPool,
                                                            hybrid_mix)

from conftest import fixture_path, golden_pcm
from torch_port_util import assert_equal


@pytest.mark.parametrize("name,channels,path", [
    ("hybrid_swb_mono_20ms", 1, ("hybrid", 21, 20)),
    ("hybrid_fb_stereo_20ms", 2, ("hybrid2", 21, 20))])
def test_compat_hybrid_pool_matches_golden(name, channels, path):
    pool = StreamPool([str(fixture_path(name))] * 2, channels=channels,
                      superstep_k=3, device="cpu")
    assert pool.path == [path] * 2
    gold = golden_pcm(name)[:, :channels]
    for o in pool.run():
        assert len(o) > 90000
        assert_equal(o, gold[:len(o)], name)
    assert pool.stats()["frames_hybrid"] == 2 * len(pool.streams[0].jobs)


@pytest.mark.parametrize("name,channels,path", [
    ("hybrid_fb_mono_10ms", 1, ("hybrid", 21, 10)),
    ("hybrid_fb_stereo_10ms", 2, ("hybrid2", 21, 10)),
    ("hybrid_swb_fec_mono_20ms", 1, ("hybrid", 19, 20))])
def test_rfc_hybrid_pool_matches_decode_files(name, channels, path):
    """RFC mode codes the end band per bandwidth (SWB: 19)."""
    pool = StreamPool([str(fixture_path(name))] * 2, channels=channels,
                      compat_ref=False, superstep_k=4, device="cpu")
    assert pool.path == [path] * 2
    jref = jax_decode_file(str(fixture_path(name)),
                           JaxConfig(channels=channels, compat_ref=False))
    pref = decode_file(str(fixture_path(name)),
                       DecoderConfig(channels=channels, compat_ref=False,
                                     device="cpu"))
    assert_equal(pref, jref, f"{name}: the two decode_files")
    for o in pool.run():
        assert len(o) > 60000
        assert_equal(o, pref, name)


def test_mix_modes():
    """hybrid_mix: SAT16 sum of the CELT high band and the SILK part
    (mono SILK on every channel), the SILK part alone (an FEC frame) or
    silence (a compat-mode lost frame), per row."""
    rng = np.random.default_rng(5)
    K, n, N = 2, 3, 8
    c = torch.tensor(rng.integers(-32768, 32768, (K, 2, N, n)),
                     dtype=torch.int16)
    s = torch.tensor(rng.integers(-32768, 32768, (K, n, N)),
                     dtype=torch.int16)
    mode = torch.tensor([[0, 1, 2], [2, 0, 1]], dtype=torch.int8)
    got = hybrid_mix(c, s, mode).numpy()
    cn, sn = c.numpy().astype(np.int64), s.numpy().astype(np.int64)
    for k in range(K):
        for r in range(n):
            m = int(mode[k, r])
            want = np.zeros((N, 2), dtype=np.int64)
            if m != 2:
                want[:] = sn[k, r][:, None] + (cn[k, :, :, r].T if m == 0
                                               else 0)
            assert_equal(got[k, r], np.clip(want, -32768, 32767), (k, r))


def test_lane_of_two_end_bands_and_an_early_end():
    """One RFC 10 ms lane of an FB stream (end band 21), an SWB one (19)
    and an FB one cut to 40 packets (its rows masked once it ends): each
    bit-equal to its own decode_file."""
    names = ["hybrid_fb_mono_10ms", "hybrid_swb_fec_mono_10ms"]
    cut = opusfile.parse_stream(fixture_path(names[0]).read_bytes())
    cut.jobs = cut.jobs[:40]
    pool = StreamPool([str(fixture_path(n)) for n in names] + [cut],
                      compat_ref=False, superstep_k=4, device="cpu")
    assert [p[1] for p in pool.path] == [21, 19, 21]
    out = pool.run()
    for o, n in zip(out, names):
        assert_equal(o, decode_file(str(fixture_path(n)), DecoderConfig(
            channels=1, compat_ref=False, device="cpu")), n)
    assert len(out[2]) == 40 * 480 - 312
    assert_equal(out[2], out[0][:len(out[2])], "the stream cut short")
