"""CELT packet-loss concealment in the port, on the CPU (kernel P1's plain
version): ops/celt/torch_plc.py against the JAX package's jax_plc on the
same numpy inputs, and the port's concealing CELT pool (RFC mode,
rfc_plc=True) against the JAX pool, the JAX scalar decoder and the
system libopus.

Tolerances (float32, ROADMAP.md's North star: the JAX package is not
bit-stable against itself across batch shapes):
- the conceal against jax_plc.celt_plc_core: the pitch T equal on every
  row, PCM within 16 LSB, decode_mem and preemph within 16 LSB (16 *
  4096 in Q12), each channel's LPC fit within 5 % of its largest
  coefficient (Levinson-24 on tonal music amplifies the autocorrelation
  sums' rounding: 1.4 % measured on the pools' rows);
- the pool against the JAX pool: every frame before a stream's first
  conceal bit-equal; every other frame within 16 LSB and at SNR >= 40 dB;
- the noise branch (every conceal of a frame shorter than 20 ms) is
  integer work: bit-equal to the JAX scalar decoder's replay;
- against libopus, as tests/test_celt_plc.py: a concealed frame above 15
  dB on the pitch branch, above 30 dB over a long burst.
Streams are cut to at most 50 packets."""
import ctypes
import ctypes.util

import numpy as np
import pytest
import torch

from esp32_opus_player_tpu.host import opusfile as jax_opusfile
from esp32_opus_player_tpu.models.opus_decoder import OpusDecoder
from esp32_opus_player_tpu.models.stream_pool import StreamPool as JaxPool
from esp32_opus_player_tpu.ops.celt import jax_plc
from esp32_opus_player_tpu_torch.host import opusfile
from esp32_opus_player_tpu_torch.models.stream_pool import StreamPool
from esp32_opus_player_tpu_torch.ops.celt import plc_kernel, torch_plc
from esp32_opus_player_tpu_torch.utils.state import from_jax_state

from conftest import fixture_path
from torch_port_util import assert_equal, plc_rows

RFC = dict(compat_ref=False, rfc_plc=True)
TOL_PCM = 16                 # LSB
TOL_Q12 = 16 * 4096          # decode_mem, preemph: 16 LSB in Q12
TOL_LPC = 0.05             # of the channel's largest LPC coefficient
PRE_SKIP = 312


def _cut(mod, names, n):
    out = []
    for name in names:
        s = mod.parse_stream(fixture_path(name).read_bytes())
        s.jobs = s.jobs[:n]
        out.append(s)
    return out


def _snr(ref, got):
    e = got.astype(np.float64) - ref.astype(np.float64)
    return 10 * np.log10((np.sum(ref.astype(np.float64) ** 2) + 1)
                         / (np.sum(e ** 2) + 1))


@pytest.fixture(scope="module")
def pool_rows():
    """decode_mem and preemph rows of JAX rfc_plc pools 12 frames in: the
    mono pool (celt_fb_mono_20ms, _drums) and the stereo one
    (celt_fb_stereo_20ms, _drums), by channels."""
    out = {}
    for CC, kind in ((1, "mono"), (2, "stereo")):
        names = [f"celt_fb_{kind}_20ms", f"celt_fb_{kind}_drums_20ms"]
        pool = JaxPool(_cut(jax_opusfile, names, 12), channels=CC, **RFC)
        for _ in range(12):
            pool.step()
        out[CC] = (np.asarray(pool.state["decode_mem"]),
                   np.asarray(pool.state["preemph"]))
    return out


def _check_core(got, ref, what):
    """got: the port's (pcm, dm, pre, T, lpc); ref: JAX's."""
    pcm, dm, pre, T, lpc = (t.numpy() for t in got)
    rp, rdm, rpre, rT, rlpc = (np.asarray(a) for a in ref)
    assert_equal(T, rT, f"{what}: T")
    err = dict(pcm=np.abs(pcm.astype(np.int64) - rp).max(),
               dm=np.abs(dm.astype(np.int64) - rdm).max(),
               pre=np.abs(pre.astype(np.int64) - rpre).max(),
               lpc=float((np.abs(lpc - rlpc).max(2)
                          / np.maximum(1.0, np.abs(rlpc).max(2))).max()))
    print(f"{what}: max |port - JAX| {err} (bounds pcm {TOL_PCM}, dm and "
          f"pre {TOL_Q12}, lpc {TOL_LPC} relative)")
    assert err["pcm"] <= TOL_PCM and err["dm"] <= TOL_Q12, (what, err)
    assert err["pre"] <= TOL_Q12 and err["lpc"] <= TOL_LPC, (what, err)


@pytest.mark.parametrize("source", ["seeded", "pool"])
@pytest.mark.parametrize("CC", [1, 2])
def test_core_matches_jax(source, CC, pool_rows):
    """celt_plc_core on 8 rows, first True and False, against
    jax_plc.celt_plc_core: seeded rows, or the rows of a JAX pool (each
    pool row four times, twice a first conceal, twice a repeated one)."""
    rng = np.random.default_rng(7 + CC)
    dm, pre, pitch, lpc, first = plc_rows(rng, 8, CC)
    if source == "pool":
        pdm, ppre = pool_rows[CC]
        dm, pre = np.concatenate([pdm] * 4), np.concatenate([ppre] * 4)
        first = np.arange(8) < 4
    ref = jax_plc.celt_plc_core(dm, pre, pitch, lpc, first, CC=CC)
    got = torch_plc.celt_plc_core(
        torch.tensor(dm), torch.tensor(pre), torch.tensor(pitch),
        torch.tensor(lpc), torch.tensor(first), CC=CC)
    _check_core(got, ref, f"celt_plc_core {source} CC {CC}")


def test_bucket_matches_jax():
    """celt_plc_bucket: inactive rows keep their state and give silence."""
    rng = np.random.default_rng(3)
    args = plc_rows(rng, 8, 1)
    active = np.arange(8) % 3 != 1
    ref = jax_plc.celt_plc_bucket(*args, active, CC=1)
    got = torch_plc.celt_plc_bucket(*(torch.tensor(a) for a in args),
                                    torch.tensor(active), CC=1)
    idle = torch.tensor(~active)
    assert not got[0][idle].any()
    for t, a, what in zip(got[1:], args, ("dm", "pre", "pitch", "lpc")):
        assert torch.equal(t[idle], torch.tensor(a[~active])), what
    _check_core([t[torch.tensor(active)] for t in got],
                [np.asarray(r)[active] for r in ref], "celt_plc_bucket")


def test_kernel_wrapper_scatters_into_the_lane():
    """P1's plain version on a lane: the rows' columns of decode_mem,
    preemph, pitch, LPC and the frame's PCM are celt_plc_core's results;
    every other column is left as it was."""
    rng = np.random.default_rng(11)
    dm, pre, pitch, lpc, _ = plc_rows(rng, 6, 2)
    rows = torch.tensor([4, 1, 5])
    first = torch.tensor([True, False, True])
    st = [torch.tensor(dm.transpose(1, 2, 0)), torch.tensor(pre),
          torch.tensor(pitch), torch.tensor(lpc)]
    before = [t.clone() for t in st]
    pcmT = torch.zeros((2, 960, 6), dtype=torch.int16)
    plc_kernel.celt_plc_T(*st, pcmT, rows, first)
    pcm, dm2, pre2, T, lpc2 = torch_plc.celt_plc_core(
        torch.tensor(dm)[rows], torch.tensor(pre)[rows],
        torch.tensor(pitch)[rows], torch.tensor(lpc)[rows], first, CC=2)
    for got, want in ((st[0][:, :, rows], dm2.permute(1, 2, 0)),
                      (st[1][rows], pre2), (st[2][rows], T),
                      (pcmT[:, :, rows], pcm.permute(2, 1, 0))):
        assert torch.equal(got, want)
    assert torch.equal(st[3][rows], lpc2)
    other = torch.tensor([0, 2, 3])
    assert torch.equal(st[0][:, :, other], before[0][:, :, other])
    for t, b in zip(st[1:], before[1:]):
        assert torch.equal(t[other], b[other])
    assert not pcmT[:, :, other].any()


@pytest.mark.parametrize("width", [1, 2, 4, 8, 12, 18, 22, 176])
def test_noise_renormalise_matches_jax(width):
    """The port's renormalise_vector (many bands at once) and
    celt_rsqrt_norm (many values at once) against the JAX package's
    scalar ones, band by band: bit-equal, zero bands included."""
    from esp32_opus_player_tpu.ops.celt import math as jmath, pvq as jpvq
    from esp32_opus_player_tpu_torch.ops.celt import math as tmath, pvq
    rng = np.random.default_rng(width)
    X = rng.integers(-2048, 2048, (3, 7, width)).astype(np.int64)
    X[0, 0] = 0
    ref = X.copy()
    for v in ref.reshape(-1, width):
        jpvq.renormalise_vector(v, width, 32767)
    pvq.renormalise_vector(X, width, 32767)
    assert_equal(X, ref, f"width {width}")
    t = rng.integers(16384, 65536, 64)
    assert_equal(tmath.celt_rsqrt_norm(t),
                 [jmath.celt_rsqrt_norm(int(x)) for x in t], "rsqrt_norm")


def _frames(pcm, k):
    lo = max(0, 960 * k - PRE_SKIP)
    return pcm[lo:960 * (k + 1) - PRE_SKIP]


@pytest.mark.parametrize("channels", [1, 2])
def test_pool_matches_jax(channels):
    """A burst over the pitch branch (conceals 1-5), the noise branch
    (6-8), then a loss right after it (skip_plc: the noise branch) and
    one two good frames later (the pitch branch again), in K = 3
    windows, against the JAX pool on the same loss."""
    kind = "mono" if channels == 1 else "stereo"
    names = [f"celt_fb_{kind}_20ms", f"celt_fb_{kind}_drums_20ms"]
    loss = lambda i, k: 6 <= k < 14 or k in (15, 18) or (i == 1 and k == 3)
    pool = StreamPool(_cut(opusfile, names, 24), channels=channels,
                      superstep_k=3, device="cpu", **RFC)
    got = pool.run(loss=loss)
    ref = JaxPool(_cut(jax_opusfile, names, 24), channels=channels,
                  **RFC).run(loss=loss)
    assert pool.stats()["frames_lost"] == 2 * 10 + 1
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape and len(a) > 23 * 960 - PRE_SKIP, i
        first = min(k for k in range(24) if loss(i, k))
        for k in range(24):
            fa, fb = _frames(a, k), _frames(b, k)
            if k < first:
                assert_equal(fa, fb, f"stream {i} frame {k}")
                continue
            err = np.abs(fa.astype(np.int64) - fb).max()
            snr = _snr(fb, fa)
            assert err <= TOL_PCM and snr >= 40.0, (i, k, err, snr)
        assert _frames(a, 8).any()


def _scalar_rfc_loss(name, lossfn, channels, n):
    """The JAX scalar decoder replaying a loss pattern (RFC mode: a lost
    frame is celt_decode_lost), trimmed as the pool trims."""
    s = jax_opusfile.open_file(fixture_path(name))
    dec = OpusDecoder(channels, compat_ref=False)
    out = []
    for k, job in enumerate(s.jobs[:n]):
        pcm = dec.decode(None) if lossfn(k) else dec.decode(job.data)
        lo, hi = job.discard_front, pcm.shape[0] - job.trim_end
        out.append(pcm[lo:max(hi, lo)])
    return np.concatenate(out)


@pytest.mark.parametrize("channels", [1, 2])
def test_short_frames_noise_branch_matches_scalar(channels):
    """Frames of 2.5, 5 and 10 ms conceal by the noise branch only:
    integer work through the lanes' normal frame steps, bit-equal to the
    JAX scalar decoder's replay. At channels 1 the stereo streams, and at
    channels 2 the mono one, are noise rows of a lane whose coded
    channel count is not the pool's (their own compact step at C = CC).
    The 12-frame burst reaches the engine's loss count of 10 (the
    background energy's step on the next good frame)."""
    names = ["celt_fb_mono_5ms", "celt_fb_stereo_2p5ms",
             "celt_swb_stereo_10ms"]
    lossfn = lambda k: 5 <= k < 17 or k in (18, 21, 30, 31)
    got = StreamPool(_cut(opusfile, names, 50), channels=channels,
                     superstep_k=4, device="cpu", **RFC).run(
        loss=lambda i, k: lossfn(k))
    for name, out in zip(names, got):
        assert_equal(out, _scalar_rfc_loss(name, lossfn, channels, 50),
                     f"{name} at channels {channels}")


@pytest.mark.parametrize("name,channels", [("celt_fb_stereo_20ms", 1),
                                           ("celt_fb_mono_20ms", 2)])
def test_coded_channel_mismatch_20ms(name, channels):
    """A stereo stream in a mono pool and a mono one in a stereo pool,
    20 ms: P1 conceals with the pool's channels, the noise rows step at
    C = CC on their own; against the JAX scalar decoder's replay (which
    decodes with the stream's coded channels too): bit-equal before the
    first conceal, within the float bounds after it."""
    lossfn = lambda k: 6 <= k < 14 or k == 15
    got = StreamPool(_cut(opusfile, [name], 30), channels=channels,
                     superstep_k=2, device="cpu", **RFC).run(
        loss=lambda i, k: lossfn(k))[0]
    ref = _scalar_rfc_loss(name, lossfn, channels, 30)
    assert got.shape == ref.shape
    for k in range(30):
        fa, fb = _frames(got, k), _frames(ref, k)
        if k < 6:
            assert_equal(fa, fb, f"frame {k}")
        else:
            err = np.abs(fa.astype(np.int64) - fb).max()
            assert err <= TOL_PCM and _snr(fb, fa) >= 40.0, (k, err)
    assert _frames(got, 12).any()


def test_plc_state_carries_across_burst():
    """Consecutive losses reuse the first conceal's pitch and LPC fit;
    an untouched stream keeps zeros there and decodes bit-equal to its
    lossless run (tests/test_celt_plc.py:87-108)."""
    src = fixture_path("celt_fb_mono_drums_20ms")
    pool = StreamPool([src] * 2, superstep_k=1, device="cpu", **RFC)
    for k in range(30):
        pool.step(lost={0} if 20 <= k < 24 else None)
    st = pool.state
    assert st["plc_pitch"][0] > 0 and st["plc_pitch"][1] == 0
    assert st["plc_lpc"][0].any() and not st["plc_lpc"][1].any()
    out = pool.collected()
    ref = StreamPool([src], superstep_k=1, device="cpu", **RFC)
    for _ in range(30):
        ref.step()
    assert_equal(out[1], ref.collected()[0], "lossless stream")


def test_carried_state_from_jax_pool():
    """Both pools run into a burst; the JAX pool's state (decode_mem,
    preemph, plc_pitch, plc_lpc) is moved into the port's pool with
    from_jax_state after the second conceal; the third conceal, a
    repeated one, then takes the carried pitch: the same T, the frame
    within 16 LSB."""
    names = ["celt_fb_mono_20ms", "celt_fb_mono_drums_20ms"]
    lost = lambda k: {0, 1} if 12 <= k < 15 else None
    port = StreamPool(_cut(opusfile, names, 16), superstep_k=1,
                      device="cpu", **RFC)
    jx = JaxPool(_cut(jax_opusfile, names, 16), channels=1, **RFC)
    for k in range(14):
        port.step(lost(k))
        jx.step(lost(k))
    port.collected()
    jst = jx.state
    port.state.update(from_jax_state(
        np.asarray(jst["decode_mem"]).transpose(1, 2, 0),
        np.asarray(jst["preemph"]), device="cpu",
        plc_pitch=np.asarray(jst["plc_pitch"]),
        plc_lpc=np.asarray(jst["plc_lpc"])))
    port.step(lost(14))
    jx.step(lost(14))
    got, ref = port.collected(), jx.collected()
    assert_equal(port.state["plc_pitch"], np.asarray(jx.state["plc_pitch"]),
                 "carried pitch")
    for a, b in zip(got, ref):
        fa, fb = _frames(a, 14), _frames(b, 14)
        assert fb.any()
        assert np.abs(fa.astype(np.int64) - fb).max() <= TOL_PCM


def _libopus():
    name = ctypes.util.find_library("opus")
    if not name:
        pytest.skip("system libopus not available")
    lib = ctypes.CDLL(name)
    lib.opus_decoder_create.restype = ctypes.c_void_p
    return lib


def _libopus_conceals(jobs, lost, n):
    """The system libopus over the first n packets with `lost` lost:
    {k: its concealed frame}."""
    lib = _libopus()
    err = ctypes.c_int()
    dec = lib.opus_decoder_create(48000, 1, ctypes.byref(err))
    out = {}
    for k, job in enumerate(jobs[:n]):
        pcm = np.zeros(960, np.int16)
        buf = pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_short))
        data = None if k in lost else job.data
        got = lib.opus_decode(ctypes.c_void_p(dec), data,
                              0 if data is None else len(data), buf, 960, 0)
        assert got == 960
        if k in lost:
            out[k] = pcm
    lib.opus_decoder_destroy(ctypes.c_void_p(dec))
    return out


@pytest.mark.parametrize("lost,floor", [({20, 40, 41, 42}, 15.0),
                                        (set(range(20, 28)), 30.0)])
def test_concealed_frames_against_libopus(lost, floor):
    """tests/test_celt_plc.py's floors for the port's pool: an isolated
    loss and a 3-frame burst (the pitch branch) above 15 dB, an 8-frame
    burst (pitch, then noise) above 30 dB, every concealed frame
    audible."""
    src = _cut(opusfile, ["celt_fb_mono_20ms"], 50)
    ref = _libopus_conceals(src[0].jobs, lost, 50)
    pool = StreamPool(src, superstep_k=4, device="cpu", **RFC)
    got = pool.run(loss=lambda i, k: k in lost)[0][:, 0]
    for k in sorted(lost):
        frame = _frames(got, k)
        snr = _snr(ref[k], frame)
        print(f"frame {k}: SNR {snr:.1f} dB against libopus (floor "
              f"{floor})")
        assert np.sqrt(np.mean(frame.astype(np.float64) ** 2)) > 100, k
        assert snr > floor, (k, snr)
