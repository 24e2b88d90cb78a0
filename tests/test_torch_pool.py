"""The port's StreamPool on CPU tensors (the kernels' plain twins): the
fullband 20 ms CELT fixtures decode bit for bit to tests/golden, per
frame (K = 1) and in K = 3 windows (the last one partial), and a lost
packet gives silence with the stream's state untouched."""
import numpy as np
import pytest
import torch

from esp32_opus_player_tpu import DecoderConfig, decode_file
from esp32_opus_player_tpu.host import opusfile
from esp32_opus_player_tpu.models.opus_decoder import OpusDecoder
from esp32_opus_player_tpu_torch.models.stream_pool import StreamPool

from conftest import fixture_path, golden_pcm


@pytest.mark.parametrize("channels,K", [(1, 1), (1, 3), (2, 1), (2, 3)])
def test_pool_matches_golden(channels, K):
    kind = "mono" if channels == 1 else "stereo"
    names = [f"celt_fb_{kind}_20ms", f"celt_fb_{kind}_drums_20ms"]
    pool = StreamPool([str(fixture_path(n)) for n in names],
                      channels=channels, superstep_k=K, device="cpu")
    for name, out in zip(names, pool.run()):
        assert out.shape[1] == channels
        if channels == 1:          # goldens hold two identical columns
            out = np.repeat(out, 2, axis=1)
        gold = golden_pcm(name)
        n = min(len(out), len(gold))
        assert n > 90000
        assert np.array_equal(out[:n], gold[:n]), name


@pytest.mark.parametrize("K", [1, 3])
def test_lost_packet_is_silence_with_state_untouched(K):
    """Stream 2 loses packet 1 (inside the first window when K = 3; the
    second window is partial): silence out, state untouched, exactly the
    scalar decode with packet 1 replaced by silence."""
    src = str(fixture_path("celt_fb_mono_20ms"))
    pool = StreamPool([src] * 3, channels=1, superstep_k=K, device="cpu")
    for k in range(5):
        pool.step(lost={2} if k == 1 else None)
    outs = pool.collected()
    ref = decode_file(src, DecoderConfig(channels=1, compat_ref=True))
    assert np.array_equal(outs[0], ref[:outs[0].shape[0]])
    s = opusfile.open_file(src)
    dec = OpusDecoder(1, compat_ref=True)
    exp = []
    for k, job in enumerate(s.jobs[:5]):
        pcm = np.zeros((960, 1), np.int16) if k == 1 else \
            dec.decode(job.data)
        exp.append(pcm[job.discard_front:pcm.shape[0] - job.trim_end])
    assert np.array_equal(outs[2], np.concatenate(exp))


def test_all_lost_steps_inside_a_window():
    """Steps where every stream is lost stage no frame, so a window can
    span more steps than it holds frames and is fetched before it fills:
    the output equals the per-frame pool's."""
    src = str(fixture_path("celt_fb_mono_drums_20ms"))
    loss = lambda i, k: k in (2, 3, 7)
    outs = [StreamPool([src], superstep_k=K, device="cpu").run(loss=loss)[0]
            for K in (3, 1)]
    assert np.array_equal(outs[0], outs[1])
    skip = opusfile.open_file(src).jobs[0].discard_front
    assert not outs[0][2 * 960 - skip:4 * 960 - skip].any()


def test_unsupported_sources_raise():
    """What the port's pool still lacks raises with its ROADMAP.md item
    (12b): a pool that mixes batched kinds (CELT and SILK lanes, mono
    SILK and hybrid, stereo SILK and stereo hybrid), native=False, device
    output and out_fs below 48000. Stereo SILK (item 10), hybrid (11)
    and RFC-mode SILK of 10, 40 and 60 ms take lanes now; a 5 ms CELT
    stream batches in RFC mode and takes the scalar route in compat mode
    (20 ms only), as in the JAX pool."""
    for name, channels, compat, kind in [
            ("silk_wb_stereo_20ms", 2, True, "silk2"),
            ("hybrid_swb_mono_20ms", 1, True, "hybrid"),
            ("silk_wb_mono_60ms", 1, False, "silk")]:
        pool = StreamPool([str(fixture_path(name))], channels=channels,
                          compat_ref=compat, device="cpu")
        assert pool.path[0][0] == kind
    src = [str(fixture_path("celt_fb_mono_5ms"))]
    assert StreamPool(src, compat_ref=False, device="cpu").path[0][0] == \
        "celt"
    assert StreamPool(src, device="cpu").path[0] == ("scalar",)
    for names, channels in [
            (("celt_fb_mono_20ms", "silk_wb_mono_20ms"), 1),
            (("silk_wb_mono_20ms", "hybrid_swb_mono_20ms"), 1),
            (("silk_wb_stereo_20ms", "hybrid_fb_stereo_20ms"), 2)]:
        with pytest.raises(NotImplementedError, match="item 12b"):
            StreamPool([str(fixture_path(n)) for n in names],
                       channels=channels, device="cpu")
    src = [str(fixture_path("silk_wb_mono_20ms"))]
    for kw in (dict(native=False), dict(output="device"),
               dict(out_fs=16000)):
        with pytest.raises(NotImplementedError, match="item 12b"):
            StreamPool(src, device="cpu", **kw)


def test_default_device_is_the_card():
    """Without a device the pool runs on the card; with no card it
    raises instead of falling back to the CPU."""
    src = [str(fixture_path("celt_fb_mono_20ms"))]
    if torch.cuda.is_available():
        assert StreamPool(src).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            StreamPool(src)
