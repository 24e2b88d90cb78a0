"""Lost packets of streams that switch modes and of multistream sources,
on the CPU, against the JAX package on the same losses:

- `modeswitch_stereo_20ms` (50 SILK, 50 CELT, then hybrid packets) in
  RFC mode through the port's OpusDecoder and the JAX one: losses in
  each mode and at both switches. A loss whose last decoded packet was
  CELT takes the CELT pitch conceal (P1's plain version at one row,
  float32), so that frame and the next are held at the bounds of
  tests/test_torch_celt_plc.py (within 16 LSB at SNR >= 40 dB); every
  other frame is bit-equal;
- the pool's lossy ("scalar",) rows in compat mode (the decoder's own
  loss path, silence where a lost hybrid frame makes the decoder raise,
  as the JAX pool's _host_one_lost) bit-equal to the JAX pool's;
- the pool's lossy ("ms",) rows, both ms51_* fixtures, bit-equal to the
  JAX pool's (ms_batch=False) in compat mode; in RFC mode likewise but
  for the CELT conceal's frames, at the bounds above.

Streams are cut to their first 24 (ms51) or 110 (modeswitch) packets."""
import numpy as np
import pytest

from esp32_opus_player_tpu.host import opusfile as jax_opusfile
from esp32_opus_player_tpu.models.opus_decoder import \
    OpusDecoder as JaxDecoder
from esp32_opus_player_tpu.models.stream_pool import StreamPool as JaxPool
from esp32_opus_player_tpu_torch.host import opusfile
from esp32_opus_player_tpu_torch.host.packet import Mode, parse_packet
from esp32_opus_player_tpu_torch.models.opus_decoder import OpusDecoder
from esp32_opus_player_tpu_torch.models.stream_pool import StreamPool

from conftest import fixture_path
from test_torch_celt_plc import TOL_PCM, _snr

MODESWITCH = "modeswitch_stereo_20ms"
# SILK 0-49 (a loss and a burst), the first CELT packet (after SILK: the
# SILK conceal), CELT losses, the first hybrid packet (after CELT: the
# CELT conceal) and a hybrid burst
MODESWITCH_LOST = {10, 30, 31, 50, 62, 63, 64, 80, 100, 104, 105, 106}


def _cut(mod, name, n):
    s = mod.open_file(fixture_path(name))
    s.jobs = s.jobs[:n]
    return s


def _pitch_concealed(jobs, lost):
    """Frames the CELT pitch conceal reaches: a lost packet whose last
    decoded one was CELT (RFC mode), and the frame after it."""
    out, prev = set(), None
    for k, job in enumerate(jobs):
        if k not in lost:
            prev = parse_packet(job.data).mode
        elif prev == Mode.CELT_ONLY:
            out |= {k, k + 1}
    return out


def _hold(got, want, near):
    """Frame k of two lists of frames bit-equal, or within the float32
    conceal's bounds where k is in `near`."""
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, k
        if k not in near:
            assert np.array_equal(g, w), k
            continue
        err = int(np.abs(g.astype(np.int64) - w).max())
        snr = _snr(w, g)
        assert err <= TOL_PCM and snr >= 40.0, (k, err, snr)


def test_modeswitch_rfc_loss_against_jax():
    lost = MODESWITCH_LOST
    jobs = _cut(opusfile, MODESWITCH, 110).jobs
    near = _pitch_concealed(jobs, lost)
    assert near == {62, 63, 64, 65, 80, 81, 100, 101}
    got, want = [], []
    for mod, dec, out in ((opusfile, OpusDecoder(2, device="cpu"), got),
                          (jax_opusfile, JaxDecoder(2), want)):
        for k, job in enumerate(_cut(mod, MODESWITCH, 110).jobs):
            out.append(dec.decode(None if k in lost else job.data))
    assert len(got) == len(want) == 110
    _hold(got, want, near)


@pytest.mark.parametrize("name,channels,n", [
    (MODESWITCH, 2, 110), ("hybrid_fb_mono_10ms", 1, 60),
    ("hybrid_swb_mono_20ms", 2, 60)])
def test_compat_scalar_row_loss_against_jax_pool(name, channels, n):
    loss = lambda i, k: k in MODESWITCH_LOST or k % 9 == 4
    pool = StreamPool([_cut(opusfile, name, n)], channels=channels,
                      compat_ref=True, device="cpu")
    assert pool.path == [("scalar",)]
    got = pool.run(loss=loss)[0]
    want = JaxPool([_cut(jax_opusfile, name, n)], channels=channels,
                   compat_ref=True, ms_batch=False).run(loss=loss)[0]
    assert got.shape == want.shape and len(got) > 0.9 * n * 960 * \
        (0.5 if "10ms" in name else 1)
    assert np.array_equal(got, want)
    assert pool.stats()["frames_lost"] == sum(loss(0, k) for k in range(n))


@pytest.mark.parametrize("compat", [True, False])
@pytest.mark.parametrize("name", ["ms51_music_fb_20ms", "ms51_silk_wb_20ms"])
def test_ms51_lossy_row_against_jax_pool(name, compat):
    n, lost = 24, {6, 14, 15}
    loss = lambda i, k: k in lost
    s = _cut(opusfile, name, n)
    pool = StreamPool([s], channels=6, compat_ref=compat, device="cpu")
    assert pool.path == [("ms",)]
    got = pool.run(loss=loss)[0]
    want = JaxPool([_cut(jax_opusfile, name, n)], channels=6,
                   compat_ref=compat, ms_batch=False).run(loss=loss)[0]
    pre = s.jobs[0].discard_front
    assert got.shape == want.shape == (n * 960 - pre, 6)
    assert pool.stats()["frames_lost"] == len(lost)
    # each 20 ms frame, the first one short by the pre-skip
    cuts = [max(0, 960 * k - pre) for k in range(n + 1)]
    frames = lambda pcm: [pcm[a:b] for a, b in zip(cuts, cuts[1:])]
    # every elementary stream of ms51_music is CELT; of ms51_silk, SILK
    near = set() if compat or "silk" in name else \
        {k + d for k in lost for d in (0, 1)}
    _hold(frames(got), frames(want), near)
