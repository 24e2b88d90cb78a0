"""Multistream (mapping family 1) through the port, on the CPU: 5.1
surround decoded by its OpusMSDecoder bit-equal to tests/golden with
every packet's final range the reference's (the port's copy of
tests/test_multistream.py::test_ms51_bitexact_and_ranges), through its
file API (::test_ms51_through_file_api), and as the pool's ("ms",) row
beside a CELT lane (the JAX pool's ms_batch=False route), cut to 30
packets."""
import json

import numpy as np
import pytest

from esp32_opus_player_tpu_torch import DecoderConfig, OpusFile
from esp32_opus_player_tpu_torch.host import opusfile
from esp32_opus_player_tpu_torch.models.ms_decoder import OpusMSDecoder
from esp32_opus_player_tpu_torch.models.stream_pool import StreamPool

from conftest import GOLDEN, fixture_path

NAMES = ["ms51_silk_wb_20ms", "ms51_music_fb_20ms"]


def _load(name):
    s = opusfile.parse_stream(fixture_path(name).read_bytes())
    gold = np.fromfile(GOLDEN / f"{name}.pcm",
                       dtype=np.int16).reshape(-1, 6)
    ranges = json.loads((GOLDEN / f"{name}.ranges.json").read_text())
    return s, gold, ranges


@pytest.mark.parametrize("name", NAMES)
def test_ms51_bitexact_and_ranges(name):
    s, gold, ranges = _load(name)
    h = s.head
    assert (h.channel_count, h.stream_count, h.coupled_count) == (6, 4, 2)
    dec = OpusMSDecoder(h.channel_count, h.stream_count, h.coupled_count,
                        h.mapping, compat_ref=True, device="cpu")
    outs = []
    for k, job in enumerate(s.jobs):
        outs.append(dec.decode(job.data))
        assert dec.final_range == ranges[k]["final_range"], k
    got = np.concatenate(outs)
    assert got.shape == gold.shape
    assert np.array_equal(got, gold)


def test_ms51_through_file_api(manifest):
    name = "ms51_silk_wb_20ms"
    f = OpusFile(fixture_path(name), DecoderConfig(channels=6,
                                                   compat_ref=True,
                                                   device="cpu"))
    pcm = f.read_all()
    _, gold, _ = _load(name)
    pre = manifest[name]["pre_skip"]
    assert pcm.shape == (gold.shape[0] - pre, 6)
    assert np.array_equal(pcm, gold[pre:])


@pytest.mark.parametrize("name", NAMES)
def test_ms51_pool_row(name):
    """The pool's ("ms",) row (channels 6), its first 30 packets, against
    the golden's first 30 frames after the pre-skip; a lost packet is
    the decoder's own loss path on every elementary stream."""
    s, gold, _ = _load(name)
    s.jobs = s.jobs[:30]
    pool = StreamPool([s], channels=6, compat_ref=True, device="cpu")
    assert pool.path == [("ms",)]
    out = pool.run()[0]
    pre = s.jobs[0].discard_front
    assert out.shape == (30 * 960 - pre, 6)
    assert np.array_equal(out, gold[pre:pre + out.shape[0]])
    st = pool.stats()
    assert st["frames_scalar"] == st["frames"] == 30
    # the same with packet 10 lost: a fresh pool, the frames before it
    # equal, the lost frame as the multistream decoder conceals it
    dec = OpusMSDecoder(6, 4, 2, s.head.mapping, compat_ref=True,
                        device="cpu")
    want = [dec.decode(None if k == 10 else j.data)
            for k, j in enumerate(s.jobs[:12])]
    lossy = StreamPool([s], channels=6, compat_ref=True, device="cpu")
    for k in range(12):
        lossy.step(lost={0} if k == 10 else None)
    got = lossy.collected()[0]
    assert np.array_equal(got, np.concatenate(want)[pre:])
    assert lossy.stats()["frames_lost"] == 1


def test_channels_above_two_take_multistream_sources_only():
    with pytest.raises(ValueError, match="multistream"):
        StreamPool([fixture_path("celt_fb_mono_20ms")], channels=6,
                   device="cpu")
