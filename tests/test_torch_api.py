"""The port's public decode API (api.py: decode_file, OpusFile,
StreamingOpusFile, decode_to_wav) and chained Ogg streams, on the CPU
(device="cpu"): the port's copies of tests/test_api.py's and
tests/test_chained.py's checks, every PCM against tests/golden or the
port's own one-shot decode, and the chained pool's scalar row. Without a
card, the default device ("cuda") raises at every entry point."""
import functools

import numpy as np
import pytest
import torch

from esp32_opus_player_tpu_torch import (DecoderConfig, OpusDecoder,
                                         OpusFile, decode_file,
                                         decode_to_wav)
from esp32_opus_player_tpu_torch.api import StreamingOpusFile
from esp32_opus_player_tpu_torch.host import opusfile
from esp32_opus_player_tpu_torch.models.stream_pool import StreamPool

from conftest import fixture_path, golden_pcm
from test_api import _page_spans


def _cfg(channels, **kw):
    return DecoderConfig(channels=channels, compat_ref=True, device="cpu",
                         **kw)


@functools.lru_cache(maxsize=None)
def _decoded(name, channels):
    """decode_file of a fixture, compat mode, once per module."""
    return decode_file(fixture_path(name), _cfg(channels))


def test_decode_file_matches_oracle(manifest):
    name = "celt_fb_mono_20ms"
    pcm = _decoded(name, 1)
    assert len(pcm) == manifest[name]["oracle_samples"]
    assert np.array_equal(np.repeat(pcm, 2, axis=1), golden_pcm(name))


def test_read_stereo_duplicates_mono():
    f = OpusFile(fixture_path("silk_wb_mono_20ms"), _cfg(1))
    pcm = f.read_stereo(1024)
    assert pcm.shape == (1024, 2)
    assert np.array_equal(pcm[:, 0], pcm[:, 1])


def test_chunked_read_equals_bulk():
    name = "hybrid_fb_stereo_20ms"
    f = OpusFile(fixture_path(name), _cfg(2))
    chunks = []
    while True:
        c = f.read(777)   # odd chunk size on purpose
        if len(c) == 0:
            break
        chunks.append(c)
    got = np.concatenate(chunks)
    assert np.array_equal(got, _decoded(name, 2))
    assert np.array_equal(got, golden_pcm(name))


def test_wav_roundtrip(tmp_path):
    out = tmp_path / "out.wav"
    n = decode_to_wav(fixture_path("silk_nb_mono_20ms"), out, _cfg(1))
    data = out.read_bytes()
    assert data[:4] == b"RIFF" and data[8:12] == b"WAVE"
    assert len(data) == 44 + n * 2


def test_streaming_reader_incremental():
    """StreamingOpusFile fed arbitrary chunk sizes equals the one-shot
    decode (pre-skip, EOS end-trim and gain applied on the fly)."""
    src = fixture_path("silk_wb_mono_20ms")
    raw = src.read_bytes()
    rng = np.random.default_rng(3)
    sf = StreamingOpusFile(_cfg(1))
    got, pos = [], 0
    while pos < len(raw):
        n = int(rng.integers(1, 997))
        sf.feed(raw[pos:pos + n])
        pos += n
        got.append(sf.read(1 << 20))
    sf.close()
    got.append(sf.read(1 << 20))
    got = np.concatenate([g for g in got if len(g)])
    assert np.array_equal(got, _decoded("silk_wb_mono_20ms", 1))


def test_hole_discards_80ms_then_resumes(manifest):
    """A dropped page: the 80 ms re-converge discard, then the rest; the
    push reader agrees with the pull reader."""
    name = "silk_wb_mono_20ms"
    raw = fixture_path(name).read_bytes()
    spans = _page_spans(raw)
    lo, hi = spans[3]
    holey = raw[:lo] + raw[hi:]
    pcm = OpusFile(holey, _cfg(1)).read_all()
    full = manifest[name]["oracle_samples"]
    assert full - 48000 < len(pcm) < full
    sf = StreamingOpusFile(_cfg(1))
    sf.feed(holey)
    sf.close()
    assert np.array_equal(sf.read(1 << 22), pcm)


def test_seek_sample_accurate():
    ref = _decoded("silk_wb_mono_20ms", 1)
    f = OpusFile(fixture_path("silk_wb_mono_20ms"), _cfg(1))
    assert f.duration == len(ref)
    for off in (0, 1234, 48000, f.duration - 500):
        f.seek(off)
        assert f.tell() == off
        a = f.read(2000)
        b = ref[off:off + 2000]
        n = min(len(a), len(b))
        assert n > 0 and np.array_equal(a[:n], b[:n]), off


# ---------------------------------------------------------------- chained
A, B = "silk_wb_mono_20ms", "celt_fb_mono_20ms"


def _chain(*names):
    return b"".join(fixture_path(n).read_bytes() for n in names)


def _expected(*names):
    return np.concatenate([_decoded(n, 1) for n in names])


def test_parse_stream_links():
    s = opusfile.parse_stream(_chain(A, B))
    assert s.n_links == 2
    assert sorted({j.link for j in s.jobs}) == [0, 1]
    first_of_link1 = next(j for j in s.jobs if j.link == 1)
    assert first_of_link1.discard_front == s.link_heads[1].pre_skip


def test_chained_opusfile_decodes_both_links():
    got = OpusFile(_chain(A, B), _cfg(1)).read_all()
    assert np.array_equal(got, _expected(A, B))


def test_chained_three_links():
    got = OpusFile(_chain(A, B, A), _cfg(1)).read_all()
    assert np.array_equal(got, _expected(A, B, A))


def test_chained_streaming_reader():
    raw = _chain(A, B)
    sf = StreamingOpusFile(_cfg(1))
    rng = np.random.default_rng(5)
    got, pos = [], 0
    while pos < len(raw):
        n = int(rng.integers(1, 1499))
        sf.feed(raw[pos:pos + n])
        pos += n
        got.append(sf.read(1 << 20))
    sf.close()
    got.append(sf.read(1 << 20))
    got = np.concatenate([g for g in got if len(g)])
    assert np.array_equal(got, _expected(A, B))


def test_chained_pool_scalar_path():
    """A chained source beside a CELT lane: its row is ("scalar",) and
    decodes on the host with a fresh decoder at the link; the lane's
    streams are untouched by it."""
    pool = StreamPool([_chain(A, B), fixture_path(B)], channels=1,
                      compat_ref=True, superstep_k=3, device="cpu")
    assert pool.path[0] == ("scalar",)
    assert pool.path[1][0] == "celt"
    out = pool.run()
    assert np.array_equal(out[0], _expected(A, B))
    assert np.array_equal(out[1], _decoded(B, 1))
    st = pool.stats()
    n0 = len(pool.streams[0].jobs)
    assert st["frames_scalar"] == n0 and st["frames_celt"] == 100
    assert st["frames"] == n0 + 100


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("make", [
    lambda: OpusDecoder(1),
    lambda: OpusFile(fixture_path(B)),
    lambda: decode_file(fixture_path(B)),
    lambda: StreamingOpusFile(),
    lambda: StreamPool([_chain(A, B)], channels=1),
], ids=["OpusDecoder", "OpusFile", "decode_file", "StreamingOpusFile",
        "StreamPool"])
def test_entry_points_default_to_the_card(make):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
