"""The port's stereo SILK, multi-frame SILK and hybrid lanes with lost
packets, on the CPU (the kernels' plain versions), each stream held to
the port's scalar OpusDecoder fed the same losses (a lost packet
decoded with data None, or from the next packet's LBRR copy with
decode_fec) and to the JAX StreamPool with the same arguments:

- compat mode, every 7th packet lost: the normal frame over an empty
  bitstream (stereo SILK), the SILK state advanced and the output muted
  (hybrid);
- RFC mode with rfc_plc, bursts: the SILK conceal per channel (a side
  only where the previous frame had one, the last good predictors for
  the unmix), one conceal per device frame of a 40 or 60 ms packet, and
  the hybrid high band's CELT noise branch from band 17;
- in-band FEC with rfc_plc.

Where the JAX pool and the scalar decoder differ, the port follows the
scalar decoder, and ROADMAP.md section C records it; the tests at the
end show each difference. The streams are cut to 30 packets. Tolerance:
0."""
import ctypes
import sys

import numpy as np
import pytest

from esp32_opus_player_tpu.host import opusfile as jax_opusfile
from esp32_opus_player_tpu.models.stream_pool import StreamPool as JaxPool
from esp32_opus_player_tpu_torch.host import opusfile
from esp32_opus_player_tpu_torch.models.opus_decoder import OpusDecoder
from esp32_opus_player_tpu_torch.models.stream_pool import StreamPool

from conftest import ROOT, fixture_path
from torch_port_util import assert_equal

N = 30
# an isolated loss, a run of four, and two more
BURST = {3, 8, 9, 10, 11, 20, 27}
SEVENTH = set(range(7, N, 7))


def _cut(mod, name, n=N):
    s = mod.parse_stream(fixture_path(name).read_bytes())
    s.jobs = s.jobs[:n]
    return s


def _scalar(name, channels, compat, lost, fec, n=N):
    """The port's scalar decoder replaying the losses, trimmed as the
    pool trims (a lost packet the decoder rejects: silence)."""
    dec = OpusDecoder(channels, compat_ref=compat, device="cpu")
    jobs = _cut(opusfile, name, n).jobs
    out = []
    for k, job in enumerate(jobs):
        if k not in lost:
            pcm = dec.decode(job.data)
        elif fec and k + 1 < len(jobs) and k + 1 not in lost:
            pcm = dec.decode(jobs[k + 1].data, decode_fec=True)
        else:
            try:
                pcm = dec.decode(None)
            except ValueError:
                # a compat-mode lost hybrid frame: the SILK state has
                # advanced, the CELT stage rejects the empty packet; the
                # pool mutes it, as the JAX pool's scalar rows do
                pcm = np.zeros((960, channels), dtype=np.int16)
        out.append(pcm[job.discard_front:pcm.shape[0] - job.trim_end])
    return np.concatenate(out)


def _pools(name, channels, compat, lost, fec, K, n=N, jax=True):
    """(port PCM, JAX pool PCM or None) of two streams each."""
    kw = dict(channels=channels, compat_ref=compat, rfc_plc=not compat,
              superstep_k=K)
    loss = lambda i, k: k in lost
    got = StreamPool([_cut(opusfile, name, n)] * 2, device="cpu",
                     **kw).run(loss=loss, fec=fec)
    assert_equal(got[1], got[0], f"{name}: the two streams")
    ref = JaxPool([_cut(jax_opusfile, name, n)] * 2, **kw).run(
        loss=loss, fec=fec)[0] if jax else None
    return got[0], ref


@pytest.mark.parametrize("name,channels", [
    ("silk_wb_stereo_20ms", 2), ("hybrid_swb_mono_20ms", 1),
    ("hybrid_fb_stereo_20ms", 2)])
def test_compat_loss_matches_scalar_and_jax(name, channels):
    got, ref = _pools(name, channels, True, SEVENTH, False, 3)
    assert len(got) > (N - 1) * 960 - 400
    assert_equal(got, ref, f"{name}: the JAX pool")
    assert_equal(got, _scalar(name, channels, True, SEVENTH, False),
                 f"{name}: the scalar decoder")
    if name.startswith("hybrid"):
        # a muted frame: the reference's CELT stage fails on it
        assert not got[7 * 960 - 312:8 * 960 - 312].any()


@pytest.mark.parametrize("name,channels,K", [
    ("silk_wb_stereo_20ms", 2, 3), ("silk_nb_stereo_40ms", 2, 2),
    ("silk_wb_mono_60ms", 1, 3), ("silk_wb_mono_10ms", 1, 3),
    ("hybrid_swb_mono_20ms", 1, 3), ("hybrid_fb_stereo_10ms", 2, 2)])
def test_rfc_conceal_matches_scalar_and_jax(name, channels, K):
    got, ref = _pools(name, channels, False, BURST, False, K)
    assert_equal(got, ref, f"{name}: the JAX pool")
    assert_equal(got, _scalar(name, channels, False, BURST, False),
                 f"{name}: the scalar decoder")
    fl = len(got) // N
    assert np.abs(got[9 * fl:10 * fl]).max() > 0     # concealed, not silent


@pytest.mark.parametrize("name,channels", [
    ("silk_wb_fec_stereo_20ms", 2), ("silk_wb_fec_stereo_10ms", 2),
    ("hybrid_swb_fec_mono_20ms", 1), ("hybrid_swb_fec_mono_10ms", 1)])
def test_rfc_fec_matches_scalar(name, channels):
    """With rfc_plc and FEC: a lost frame whose next packet arrived is
    that packet's LBRR copy (stereo: a channel the copy lacks is
    concealed; a hybrid frame is the SILK frame alone), else concealed.
    The JAX pool differs here (the tests below)."""
    got, _ = _pools(name, channels, False, BURST, True, 3, jax=False)
    assert_equal(got, _scalar(name, channels, False, BURST, True),
                 f"{name}: the scalar decoder")


def _libopus_stereo(name, lost, n, frame):
    """libopus (the system library) replaying the losses with FEC."""
    sys.path.insert(0, str(ROOT.parent / "tools"))
    try:
        import libopus_ctypes as lo
    except OSError:
        pytest.skip("system libopus unavailable")
    ref = lo.Decoder(48000, 2)
    jobs = _cut(opusfile, name, n).jobs
    out = []
    for k, job in enumerate(jobs):
        data, fec = job.data, 0
        if k in lost:
            data, fec = jobs[k + 1].data, 1
        pcm = np.empty(frame * 2, dtype=np.int16)
        m = lo.lib.opus_decode(ctypes.c_void_p(ref._st), data, len(data),
                               pcm.ctypes.data_as(
                                   ctypes.POINTER(ctypes.c_int16)),
                               frame, fec)
        assert m == frame
        out.append(pcm.reshape(frame, 2)[job.discard_front:
                                         frame - job.trim_end])
    return np.concatenate(out)


def test_stereo_fec_of_one_channel_follows_libopus():
    """ROADMAP.md section C: packet 21 of silk_wb_fec_stereo_10ms
    has an LBRR copy of the side channel only. silk_Decode (lostFlag 2)
    conceals the mid and decodes the side's copy; the JAX pool conceals
    both. The port equals the scalar decoder and libopus."""
    name, lost = "silk_wb_fec_stereo_10ms", {20}
    got, ref = _pools(name, 2, False, lost, True, 3)
    assert_equal(got, _scalar(name, 2, False, lost, True),
                 "the scalar decoder")
    assert_equal(got, _libopus_stereo(name, lost, N, 480), "libopus")
    bad = np.argwhere(got != ref)
    assert bad.size and tuple(bad[0]) == (9321, 0)
    assert (ref[9321, 0], got[9321, 0]) == (80, 79)


def test_hybrid_fec_without_lbrr_is_the_silk_conceal():
    """ROADMAP.md section C: a lost hybrid frame asked of the next
    packet's LBRR copy when that packet has none (packet 12 of
    hybrid_swb_fec_mono_20ms): the scalar decoder's decode_fec conceals
    the SILK part alone (silk_Decode at lostFlag 2) and leaves CELT as it
    is; the JAX pool conceals both layers. The port follows the scalar
    decoder."""
    name, lost = "hybrid_swb_fec_mono_20ms", {11}
    got, ref = _pools(name, 1, False, lost, True, 3, n=16)
    assert_equal(got, _scalar(name, 1, False, lost, True, n=16),
                 "the scalar decoder")
    bad = np.argwhere(got != ref)
    assert bad.size and tuple(bad[0]) == (10248, 0)
    assert (ref[10248, 0], got[10248, 0]) == (-78, -63)


def test_compat_fec_without_lbrr_differs_from_scalar():
    """ROADMAP.md section C (open): in compat mode, a lost frame
    asked of a next packet without an LBRR copy (packet 15 of
    silk_wb_fec_mono_20ms) is the empty-bitstream frame in both pools,
    while the scalar decoder's decode_fec conceals it (silk_PLC, which a
    compat pool keeps no state for)."""
    name, lost = "silk_wb_fec_mono_20ms", {7, 14}
    got, ref = _pools(name, 1, True, lost, True, 3, n=16)
    assert_equal(got, ref, "the JAX pool")
    want = _scalar(name, 1, True, lost, True, n=16)
    bad = np.argwhere(got != want)
    assert bad.size and tuple(bad[0]) == (13160, 0)
    assert (want[13160, 0], got[13160, 0]) == (-105, -104)
    assert_equal(got[:13160], want[:13160], "before the frame")


@pytest.mark.parametrize("compat", [True, False])
def test_loss_before_the_first_packet(compat):
    """ROADMAP.md section C: the first packet lost. The pools
    decode it as the stream's own kind (compat: the empty-bitstream
    stereo frame; RFC: a conceal from the zero state, silence), as the
    JAX pool does; the scalar decoder knows neither the mode nor the
    frame size yet: in compat mode its CELT stage rejects the empty
    packet (ValueError), in RFC mode it returns 120 samples (2.5 ms) of
    silence."""
    name = "silk_wb_stereo_20ms"
    got, ref = _pools(name, 2, compat, {0}, False, 2, n=6)
    assert_equal(got, ref, "the JAX pool")
    assert len(got) == 6 * 960 - 312
    dec = OpusDecoder(2, compat_ref=compat, device="cpu")
    if compat:
        with pytest.raises(ValueError):
            dec.decode(None)
    else:
        pcm = dec.decode(None)
        assert pcm.shape == (120, 2) and not pcm.any()
        assert not got[:960 - 312].any()
