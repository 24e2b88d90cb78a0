"""The port's scalar decoder (models/opus_decoder.py) on lost packets, on
the CPU: the loss paths it copies from the JAX package, held against the
reference's golden, the system libopus and the JAX OpusDecoder.

- compat mode (`_decode_plc`: the normal frame path over an empty
  bitstream): bit-equal to tests/golden/silk_wb_mono_20ms.loss7.pcm, as
  tests/test_plc.py holds the JAX decoder;
- RFC mode, the SILK conceal (ops/silk/plc.py) and, for hybrid, the CELT
  noise branch: it extrapolates and decays (tests/test_plc.py's check),
  and every frame is bit-equal to the JAX decoder's on the same losses,
  for SILK at 10, 20, 40 and 60 ms, mono and stereo, and for hybrid;
- in-band FEC (`_decode_fec`, SILK LBRR): bit-equal to libopus's
  opus_decode(..., decode_fec=1) (tests/test_fec.py's check) and to the
  JAX decoder's decode_fec, mono, stereo and hybrid.

The JAX comparisons cut each stream to its first 30 packets."""
import ctypes
import sys

import numpy as np
import pytest

from esp32_opus_player_tpu.host import opusfile as jax_opusfile
from esp32_opus_player_tpu.models.opus_decoder import \
    OpusDecoder as JaxDecoder
from esp32_opus_player_tpu_torch.host import opusfile
from esp32_opus_player_tpu_torch.models.opus_decoder import OpusDecoder

from conftest import GOLDEN, ROOT, fixture_path

N = 30
# an isolated loss, a burst of three and a loss after a recovered frame
LOST = {5, 12, 13, 14, 22}


def replay(mod, dec, name, lost, n=None, fec=False):
    """Each packet's PCM as `dec` decodes it, a lost one by its loss path:
    with fec, from the next packet's LBRR copy where that packet arrived,
    else concealed."""
    jobs = mod.open_file(fixture_path(name)).jobs[:n]
    out = []
    for k, job in enumerate(jobs):
        if k not in lost:
            out.append(dec.decode(job.data))
        elif fec and k + 1 < len(jobs) and k + 1 not in lost:
            out.append(dec.decode(jobs[k + 1].data, decode_fec=True))
        else:
            out.append(dec.decode(None))
    return out


def test_plc_compat_bitexact_vs_reference():
    """Every 7th packet lost, compat mode: bit-equal to the reference."""
    gold = np.fromfile(GOLDEN / "silk_wb_mono_20ms.loss7.pcm",
                       dtype=np.int16).reshape(-1, 1)
    lost = set(range(7, 10000, 7))
    mine = np.concatenate(replay(opusfile, OpusDecoder(
        1, compat_ref=True, device="cpu"), "silk_wb_mono_20ms", lost))
    n = min(len(mine), len(gold))
    assert n > 90000
    assert np.array_equal(mine[:n], gold[:n])


def test_plc_rfc_conceals_and_decays():
    s = opusfile.open_file(fixture_path("silk_wb_mono_20ms"))
    dec = OpusDecoder(1, compat_ref=False, device="cpu")
    for job in s.jobs[:40]:
        dec.decode(job.data)
    # consecutive losses: energy must be nonzero then decay
    energies = []
    for _ in range(6):
        pcm = dec.decode(None)
        energies.append(float(np.abs(pcm.astype(np.int64)).mean()))
    assert energies[0] > 0, "PLC produced silence immediately"
    assert energies[-1] < energies[0], "PLC energy did not decay"


def test_fec_bitexact_vs_libopus():
    """Every 7th packet lost and recovered from the next one's LBRR copy,
    then that packet decoded normally: each output libopus's."""
    sys.path.insert(0, str(ROOT.parent / "tools"))
    try:
        import libopus_ctypes as lo
    except OSError:
        pytest.skip("system libopus unavailable")
    jobs = opusfile.open_file(fixture_path("silk_wb_fec_mono_20ms")).jobs
    ref = lo.Decoder(48000, 1)

    def ref_decode(packet, fec):
        out = np.empty(960, dtype=np.int16)
        n = lo.lib.opus_decode(
            ctypes.c_void_p(ref._st), packet, len(packet),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), 960, fec)
        assert n > 0
        return out[:n].reshape(n, 1)

    mine = OpusDecoder(1, compat_ref=False, device="cpu")
    i, n_fec = 0, 0
    while i < len(jobs):
        if i > 0 and i % 7 == 0 and i + 1 < len(jobs):
            nxt = jobs[i + 1].data
            assert np.array_equal(ref_decode(nxt, 1),
                                  mine.decode(nxt, decode_fec=True)), i
            assert np.array_equal(ref_decode(nxt, 0), mine.decode(nxt)), i
            i, n_fec = i + 2, n_fec + 1
        else:
            assert np.array_equal(ref_decode(jobs[i].data, 0),
                                  mine.decode(jobs[i].data)), i
            i += 1
    assert n_fec > 10


@pytest.mark.parametrize("name,channels,fec", [
    ("silk_wb_mono_20ms", 1, False), ("silk_wb_stereo_20ms", 2, False),
    ("silk_nb_stereo_40ms", 2, False), ("silk_wb_mono_10ms", 1, False),
    ("silk_wb_mono_60ms", 1, False), ("hybrid_swb_mono_20ms", 1, False),
    ("hybrid_fb_stereo_20ms", 2, False), ("hybrid_fb_mono_10ms", 1, False),
    ("silk_wb_fec_mono_20ms", 1, True), ("silk_wb_fec_stereo_20ms", 2, True),
    ("hybrid_swb_fec_mono_20ms", 1, True)])
def test_rfc_loss_against_jax(name, channels, fec):
    got = replay(opusfile, OpusDecoder(channels, device="cpu"), name, LOST,
                 N, fec)
    want = replay(jax_opusfile, JaxDecoder(channels), name, LOST, N, fec)
    assert len(got) == len(want) == N
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and np.array_equal(g, w), k
    # the lost frames were concealed, not silenced
    assert all(np.abs(got[k]).max() > 0 for k in LOST)
