"""The port's StreamPool on CPU tensors in RFC mode (compat_ref=False)
over CELT streams of every frame size (2.5, 5, 10, 20 ms: LM 0-3) and
below fullband (NB, SWB): each stream bit-equal to the JAX package's
decode_file(..., compat_ref=False) alone, then all of them in one pool
(one lane per frame size and coded channel count, each with its own
state and K-frame window) at K 1 and K 3, mono fixtures in a stereo pool
and stereo ones in a mono pool (in RFC mode, and in compat mode at 20
ms against decode_file(..., compat_ref=True)), and a lost packet as N
samples of silence (N the stream's frame size) with the state
untouched."""
import functools

import numpy as np
import pytest

from esp32_opus_player_tpu import DecoderConfig, decode_file
from esp32_opus_player_tpu.host import opusfile
from esp32_opus_player_tpu.host.packet import get_samples_per_frame
from esp32_opus_player_tpu.models.opus_decoder import OpusDecoder
from esp32_opus_player_tpu_torch.models.stream_pool import StreamPool

from conftest import fixture_path

NAMES = ["celt_fb_mono_5ms", "celt_fb_stereo_2p5ms", "celt_swb_stereo_10ms",
         "celt_nb_mono_20ms"]
MIXED = NAMES + ["celt_fb_mono_20ms"]


@functools.lru_cache(maxsize=None)
def reference(name, channels):
    return decode_file(str(fixture_path(name)),
                       DecoderConfig(channels=channels, compat_ref=False))


@pytest.mark.parametrize("name", NAMES)
def test_each_frame_size_matches_jax(name):
    channels = 2 if "stereo" in name else 1
    pool = StreamPool([str(fixture_path(name))], channels=channels,
                      compat_ref=False, superstep_k=3, device="cpu")
    out = pool.run()[0]
    ref = reference(name, channels)
    assert len(out) > 20000
    assert np.array_equal(out, ref), name


@pytest.mark.parametrize("K", [1, 3])
def test_mixed_frame_sizes_in_one_pool(K):
    """Five streams over four frame sizes in a stereo pool (the mono
    fixtures decode with C 1, CC 2), each equal to its decode alone."""
    pool = StreamPool([str(fixture_path(n)) for n in MIXED], channels=2,
                      compat_ref=False, superstep_k=K, device="cpu")
    lanes = sorted((lane.LM, lane.C, lane.n) for lane in pool._lanes)
    assert lanes == [(0, 2, 1), (1, 1, 1), (2, 2, 1), (3, 1, 2)]
    for name, out in zip(MIXED, pool.run()):
        assert np.array_equal(out, reference(name, 2)), name
    st = pool.stats()
    assert st["steps"] == 200 and st["frames_celt"] == st["frames"] == sum(
        len(s.jobs) for s in pool.streams)


def test_stereo_streams_in_a_mono_pool():
    """C 2, CC 1: the synthesis down-mixes the two coded channels."""
    names = ["celt_fb_stereo_2p5ms", "celt_swb_stereo_10ms"]
    pool = StreamPool([str(fixture_path(n)) for n in names], channels=1,
                      compat_ref=False, superstep_k=2, device="cpu")
    assert sorted((lane.LM, lane.C) for lane in pool._lanes) == [(0, 2),
                                                                 (2, 2)]
    for name, out in zip(names, pool.run()):
        assert np.array_equal(out, reference(name, 1)), name


@pytest.mark.parametrize("channels", [2, 1])
def test_compat_mode_mono_and_stereo_in_one_pool(channels):
    """Compat mode (20 ms only, end band 21): a mono and a stereo 20 ms
    stream in one pool of either channel count take two lanes at LM 3,
    C 1 and C 2, each stream equal to decode_file(..., compat_ref=True)
    alone; the pool's `state` refuses to pick one of the two lanes."""
    names = ["celt_fb_mono_20ms", "celt_fb_stereo_20ms"]
    pool = StreamPool([str(fixture_path(n)) for n in names],
                      channels=channels, superstep_k=3, device="cpu")
    assert sorted((lane.LM, lane.C) for lane in pool._lanes) == [(3, 1),
                                                                 (3, 2)]
    with pytest.raises(ValueError, match="2 CELT lanes"):
        pool.state
    for name, out in zip(names, pool.run()):
        ref = decode_file(str(fixture_path(name)),
                          DecoderConfig(channels=channels, compat_ref=True))
        assert np.array_equal(out, ref), name


def test_lost_packets_are_silence_of_the_lanes_frame_size():
    """Packet 1 of every stream and packet 4 + i of stream i are lost
    (inside and across K = 3 windows): each lost packet gives N samples
    of silence, N the stream's frame size, and leaves the state
    untouched: exactly the scalar decode with those packets replaced by
    silence, the pre-skip trimmed across the short frames."""
    srcs = [str(fixture_path(n)) for n in NAMES]
    lost = lambda i, k: k in (1, 4 + i)
    steps = 12
    pool = StreamPool(srcs, channels=2, compat_ref=False, superstep_k=3,
                      device="cpu")
    for k in range(steps):
        pool.step(lost={i for i in range(len(srcs)) if lost(i, k)})
    outs = pool.collected()
    for i, src in enumerate(srcs):
        dec = OpusDecoder(2, compat_ref=False)
        exp = []
        for k, job in enumerate(opusfile.open_file(src).jobs[:steps]):
            if lost(i, k):
                n = get_samples_per_frame(job.data[0])
                pcm = np.zeros((n, 2), np.int16)
            else:
                pcm = dec.decode(job.data)
            exp.append(pcm[job.discard_front:pcm.shape[0] - job.trim_end])
        assert np.array_equal(outs[i], np.concatenate(exp)), NAMES[i]
    st = pool.stats()
    assert st["frames_lost"] == 4 + 4 and st["frames"] == 4 * steps
