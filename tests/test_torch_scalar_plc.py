"""The scalar route's one device call, on the CPU: a lost 20 ms CELT
frame's pitch conceal in the port's scalar decoder (models/
celt_decoder.py::decode_lost: ops/celt/plc_kernel.py::celt_plc_T at one
row, kernel P1's plain version here), RFC mode. Held, at the bounds of
tests/test_torch_celt_plc.py (float32: the JAX package is not bit-stable
against itself across shapes), to the JAX scalar decoder on the same
losses: every frame before the first loss bit-equal, every later frame
within 16 LSB at SNR >= 40 dB; bit-equal to the port's own concealing
pool (its batched path); and above tests/test_celt_plc.py's floors
against the system libopus. Streams are cut to 50 packets."""
import numpy as np
import pytest

from esp32_opus_player_tpu.host import opusfile as jax_opusfile
from esp32_opus_player_tpu.models.opus_decoder import \
    OpusDecoder as JaxDecoder
from esp32_opus_player_tpu_torch.host import opusfile
from esp32_opus_player_tpu_torch.models.opus_decoder import OpusDecoder
from esp32_opus_player_tpu_torch.models.stream_pool import StreamPool
from esp32_opus_player_tpu_torch.ops.celt import plc_kernel

from conftest import fixture_path
from test_torch_celt_plc import (TOL_PCM, _cut, _frames, _libopus_conceals,
                                 _snr)

N = 50
LOSSES = {"isolated and a 3-frame burst": {20, 40, 41, 42},
          "an 8-frame burst": set(range(20, 28))}


def _replay(mod, dec, name, lost):
    s = mod.open_file(fixture_path(name))
    out = []
    for k, job in enumerate(s.jobs[:N]):
        pcm = dec.decode(None if k in lost else job.data)
        lo, hi = job.discard_front, pcm.shape[0] - job.trim_end
        out.append(pcm[lo:max(hi, lo)])
    return np.concatenate(out)


@pytest.mark.parametrize("lost", list(LOSSES), ids=list(LOSSES))
@pytest.mark.parametrize("name,channels", [("celt_fb_mono_20ms", 1),
                                           ("celt_fb_stereo_20ms", 2)])
def test_scalar_conceal_against_jax_and_the_pool(name, channels, lost):
    lost = LOSSES[lost]
    n0 = plc_kernel.celt_plc_T.launches
    got = _replay(opusfile, OpusDecoder(channels, device="cpu"), name, lost)
    ref = _replay(jax_opusfile, JaxDecoder(channels), name, lost)
    assert got.shape == ref.shape
    for k in range(N):
        fa, fb = _frames(got, k), _frames(ref, k)
        if k < min(lost):
            assert np.array_equal(fa, fb), k
            continue
        err = np.abs(fa.astype(np.int64) - fb).max()
        snr = _snr(fb, fa)
        assert err <= TOL_PCM and snr >= 40.0, (k, err, snr)
    # the port's batched path: the concealing pool, P1's plain version
    # over the lane's lost rows
    pool = StreamPool(_cut(opusfile, [name], N), channels=channels,
                      superstep_k=3, compat_ref=False, rfc_plc=True,
                      device="cpu").run(loss=lambda i, k: k in lost)[0]
    assert np.array_equal(got, pool)
    # the CPU takes the plain version: no kernel launch is counted
    assert plc_kernel.celt_plc_T.launches == n0


@pytest.mark.parametrize("lost,floor", [(LOSSES["isolated and a 3-frame "
                                                "burst"], 15.0),
                                        (LOSSES["an 8-frame burst"], 30.0)])
def test_scalar_conceal_against_libopus(lost, floor):
    name = "celt_fb_mono_20ms"
    ref = _libopus_conceals(_cut(opusfile, [name], N)[0].jobs, lost, N)
    got = _replay(opusfile, OpusDecoder(1, device="cpu"), name, lost)[:, 0]
    for k in sorted(lost):
        frame = _frames(got, k)
        assert np.sqrt(np.mean(frame.astype(np.float64) ** 2)) > 100, k
        assert _snr(ref[k], frame) > floor, (k, _snr(ref[k], frame))
