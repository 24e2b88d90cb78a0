"""The port's pool on sources the JAX pool decodes with its scalar
decoders, on the CPU: each stream's class (`path[i]`) equal to the JAX
pool's for every source it takes to ("scalar",) or ("ms",) (the JAX pool
with ms_batch=False), the rows' PCM bit-equal to tests/golden or to the
JAX package's decode_file, and, for the sources that raised before
their lanes came (stereo SILK, hybrid, RFC SILK of 10 and 60 ms), the
JAX pool's class and a NotImplementedError naming ROADMAP.md item 12b
when they share a pool with a CELT stream. Synthetic sources are muxed from the fixtures' packets
(tools/oggmux.py): code-3 CELT packets of two 20 ms frames, and streams
that switch bandwidth every packet."""
import sys

import numpy as np
import pytest

from esp32_opus_player_tpu import DecoderConfig as JaxConfig
from esp32_opus_player_tpu import decode_file as jax_decode_file
from esp32_opus_player_tpu.models.stream_pool import StreamPool as JaxPool
from esp32_opus_player_tpu_torch import DecoderConfig, decode_file
from esp32_opus_player_tpu_torch.host import opusfile
from esp32_opus_player_tpu_torch.models.stream_pool import StreamPool

from conftest import ROOT, fixture_path, golden_pcm

sys.path.insert(0, str(ROOT.parent / "tools"))
import oggmux  # noqa: E402


def _packets(name, n):
    s = opusfile.parse_stream(fixture_path(name).read_bytes())
    return [j.data for j in s.jobs[:n]], s.head


def _code3(name, n):
    """Pairs of a 20 ms CELT stream's packets as code-3 VBR packets of two
    frames each (RFC 6716 3.2.5)."""
    pk, head = _packets(name, 2 * n)
    out = []
    for a, b in zip(pk[::2], pk[1::2]):
        d0, d1 = a[1:], b[1:]
        L = len(d0)
        size = bytes([L]) if L < 252 else bytes(
            [252 + (L & 3), (L - 252 - (L & 3)) >> 2])
        out.append(bytes([a[0] | 3, 0x80 | 2]) + size + d0 + d1)
    return oggmux.mux(out, [1920] * len(out), channels=head.channel_count,
                      pre_skip=head.pre_skip)


def _alternating(a, b, n):
    """Packets of fixtures a and b in turns: a stream whose bandwidth
    changes every packet."""
    pa, head = _packets(a, n)
    pb, _ = _packets(b, n)
    pk = [p for ab in zip(pa, pb) for p in ab][:n]
    return oggmux.mux(pk, [960] * n, channels=head.channel_count,
                      pre_skip=head.pre_skip)


def _chain(*names):
    return b"".join(fixture_path(n).read_bytes() for n in names)


SOURCES = {
    "chained": lambda: _chain("silk_wb_mono_20ms", "celt_fb_mono_20ms"),
    "code-3 CELT": lambda: _code3("celt_fb_mono_20ms", 20),
    "CELT bandwidth switch": lambda: _alternating(
        "celt_fb_mono_20ms", "celt_nb_mono_20ms", 40),
    "SILK bandwidth switch": lambda: _alternating(
        "silk_nb_mono_20ms", "silk_wb_mono_20ms", 40),
}


def _source(name):
    return SOURCES[name]() if name in SOURCES else \
        fixture_path(name).read_bytes()


# (source, pool channels, compat_ref): each a raise site of the port
# before its scalar route; the JAX pool's class is ("scalar",) or ("ms",)
ADMITTED = [
    ("chained", 1, True), ("modeswitch_stereo_20ms", 2, True),
    ("modeswitch_stereo_20ms", 2, False), ("code-3 CELT", 1, True),
    ("code-3 CELT", 1, False), ("celt_fb_mono_5ms", 1, True),
    ("celt_fb_stereo_2p5ms", 2, True), ("CELT bandwidth switch", 1, False),
    ("SILK bandwidth switch", 1, True), ("SILK bandwidth switch", 1, False),
    ("silk_wb_mono_60ms", 1, True), ("silk_wb_mono_10ms", 1, True),
    ("silk_wb_mono_20ms", 2, True), ("silk_wb_mono_20ms", 2, False),
    ("silk_wb_stereo_20ms", 1, True), ("silk_nb2mono_20ms", 2, False),
    ("silk_nb_stereo_40ms", 2, True), ("hybrid_swb_mono_20ms", 2, True),
    ("hybrid_fb_stereo_20ms", 1, False), ("hybrid_fb_mono_10ms", 1, True),
    ("ms51_music_fb_20ms", 6, True), ("ms51_silk_wb_20ms", 6, False),
]

# (source, pool channels, compat_ref, the JAX pool's kind, the item the
# port's NotImplementedError names): each was a raise site of the port
# before its lane; the kind takes its lane now, and a pool that mixes it
# with a CELT lane still raises (item 12b)
STILL_RAISING = [
    ("silk_wb_stereo_20ms", 2, True, "silk2", "12b"),
    ("silk_nb_stereo_40ms", 2, False, "silk2", "12b"),
    ("hybrid_swb_mono_20ms", 1, True, "hybrid", "12b"),
    ("hybrid_fb_stereo_20ms", 2, True, "hybrid2", "12b"),
    ("hybrid_fb_mono_10ms", 1, False, "hybrid", "12b"),
    ("silk_wb_mono_60ms", 1, False, "silk", "12b"),
    ("silk_wb_mono_10ms", 1, False, "silk", "12b"),
]


@pytest.mark.parametrize("name,channels,compat", ADMITTED)
def test_admitted_source_takes_the_jax_pools_class(name, channels, compat):
    src = _source(name)
    want = JaxPool([src], channels=channels, compat_ref=compat,
                   ms_batch=False).path[0]
    got = StreamPool([src], channels=channels, compat_ref=compat,
                     device="cpu").path[0]
    assert want in (("scalar",), ("ms",))
    assert got == want


@pytest.mark.parametrize("name,channels,compat,kind,item", STILL_RAISING)
def test_unported_batched_kind_still_raises(name, channels, compat, kind,
                                            item):
    """The kind takes the JAX pool's class on a lane of its own; beside a
    CELT stream (a pool of two batched kinds) it still raises."""
    src = _source(name)
    want = JaxPool([src], channels=channels, compat_ref=compat).path[0]
    assert want[0] == kind
    assert StreamPool([src], channels=channels, compat_ref=compat,
                      device="cpu").path[0] == want
    celt = fixture_path("celt_fb_stereo_20ms" if channels == 2
                        else "celt_fb_mono_20ms")
    with pytest.raises(NotImplementedError,
                       match=rf"queue A item {item}\)"):
        StreamPool([src, celt], channels=channels, compat_ref=compat,
                   device="cpu")


def test_modeswitch_stream_stays_scalar():
    """tests/test_pool_modes.py's check on the port: the stream switches
    from SILK to hybrid to CELT; compat mode bit-equal to tests/golden,
    RFC mode to the JAX package's decode_file; beside a CELT lane."""
    src = str(fixture_path("modeswitch_stereo_20ms"))
    for compat in (True, False):
        pool = StreamPool([src, fixture_path("celt_fb_stereo_20ms")],
                          channels=2, compat_ref=compat, superstep_k=2,
                          device="cpu")
        assert pool.path[0] == ("scalar",) and pool.path[1][0] == "celt"
        out = pool.run()[0]
        ref = golden_pcm("modeswitch_stereo_20ms") if compat else \
            jax_decode_file(src, JaxConfig(channels=2, compat_ref=False))
        assert np.array_equal(out, ref), compat


def test_pool_multiframe_stays_scalar_in_compat():
    pool = StreamPool([str(fixture_path("silk_wb_mono_60ms"))], channels=1,
                      compat_ref=True, device="cpu")
    assert pool.path[0] == ("scalar",)


@pytest.mark.parametrize("compat", [True, False])
def test_code3_celt_rows_match_the_jax_decode(compat):
    """Code-3 CELT packets (two 20 ms frames each) as a scalar row: the
    pool, the port's decode_file and the JAX package's decode_file
    bit-equal."""
    src = _source("code-3 CELT")
    pool = StreamPool([src], channels=1, compat_ref=compat, device="cpu")
    out = pool.run()[0]
    cfg = dict(channels=1, compat_ref=compat)
    ref = jax_decode_file(src, JaxConfig(**cfg))
    assert len(out) > 30000
    assert np.array_equal(out, ref)
    assert np.array_equal(decode_file(src, DecoderConfig(device="cpu",
                                                         **cfg)), ref)
    assert pool.stats()["frames_scalar"] == 20


@pytest.mark.parametrize("compat", [True, False])
def test_scalar_row_loss_is_the_decoders(compat):
    """Lost packets of a scalar row (code-3 CELT): the decoder's own loss
    path, as the JAX pool's _host_one_lost; compat mode plays silence
    for a lost CELT frame, RFC mode conceals (the pitch branch: P1's
    plain version at one row). The row equals the port's decoder
    replaying the same losses, trimmed as the pool trims; in compat mode
    also the JAX pool."""
    src = _source("code-3 CELT")
    lost = {3, 7, 8}
    loss = lambda i, k: k in lost
    pool = StreamPool([src], channels=1, compat_ref=compat, device="cpu")
    out = pool.run(loss=loss)[0]
    from esp32_opus_player_tpu_torch.models.opus_decoder import OpusDecoder
    dec = OpusDecoder(1, compat_ref=compat, device="cpu")
    want = []
    for k, job in enumerate(opusfile.parse_stream(src).jobs):
        pcm = dec.decode(None if k in lost else job.data)
        want.append(pcm[job.discard_front:pcm.shape[0] - job.trim_end])
    assert np.array_equal(out, np.concatenate(want))
    assert pool.stats()["frames_lost"] == 3
    if compat:
        ref = JaxPool([src], channels=1, compat_ref=True,
                      ms_batch=False).run(loss=loss)[0]
        assert np.array_equal(out, ref)
