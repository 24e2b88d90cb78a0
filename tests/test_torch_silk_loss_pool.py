"""The port's mono SILK StreamPool with lost packets, on CPU tensors (the
kernels' plain versions), bit for bit against the JAX StreamPool with the
same arguments: RFC mode with real concealment (rfc_plc: silk_PLC conceal,
comfort noise, glue), in-band FEC in both modes, compat-mode loss (the
empty-bitstream frame) against tests/golden, and a lossy bucket carried
over from the JAX pool inside a loss run. The streams are cut to 30
packets, as the JAX package's own lossy tests are marked slow for their
length. Tolerance: 0."""
import numpy as np
import pytest

from esp32_opus_player_tpu.host import opusfile as jax_opusfile
from esp32_opus_player_tpu.models.opus_decoder import OpusDecoder
from esp32_opus_player_tpu.models.stream_pool import StreamPool as JaxPool
from esp32_opus_player_tpu_torch.host import opusfile
from esp32_opus_player_tpu_torch.models.stream_pool import StreamPool
from esp32_opus_player_tpu_torch.utils.state import (SILK_KEYS,
                                                     from_jax_state, to_numpy)

from conftest import GOLDEN, fixture_path
from torch_port_util import assert_equal

RATES = ["silk_nb_mono_20ms", "silk_mb_mono_20ms", "silk_wb_mono_20ms"]
RFC = dict(compat_ref=False, rfc_plc=True)


def _cut(mod, names, n=30):
    """The named fixtures parsed by `mod` (the port's or the JAX
    package's opusfile) and cut to their first n packets."""
    out = []
    for name in names:
        s = mod.parse_stream(fixture_path(name).read_bytes())
        s.jobs = s.jobs[:n]
        out.append(s)
    return out


def _both(names, loss, fec=False, K=1, n=30, **kw):
    """(port PCM, JAX PCM) of the same lossy run."""
    got = StreamPool(_cut(opusfile, names, n), superstep_k=K, device="cpu",
                     **kw).run(loss=loss, fec=fec)
    ref = JaxPool(_cut(jax_opusfile, names, n), channels=1, superstep_k=K,
                  **kw).run(loss=loss, fec=fec)
    return got, ref


def _assert_same(got, ref, n=30):
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape and len(a) > (n - 1) * 960 - 400, i
        assert_equal(a, b, f"stream {i}")


@pytest.mark.parametrize("K", [1, 3])
def test_rfc_periodic_loss_matches_jax(K):
    """Every 7th packet lost, the first one included (a conceal before
    any decoded frame), on the NB, MB and WB fixtures in one pool (three
    buckets, orders 10 and 16): conceal, CNG and glue per frame and in
    K = 3 windows."""
    got, ref = _both(RATES, lambda i, k: k % 7 == 0, K=K, **RFC)
    _assert_same(got, ref)


def _scalar_rfc_loss(name, lossfn, n):
    """The JAX package's scalar RFC decoder replaying the loss pattern
    (tests/test_pool_rfc_plc.py)."""
    dec = OpusDecoder(1, compat_ref=False)
    out = []
    for k, job in enumerate(_cut(jax_opusfile, [name], n)[0].jobs):
        pcm = dec.decode(None if lossfn(k) else job.data)
        lo, hi = job.discard_front, pcm.shape[0] - job.trim_end
        out.append(pcm[lo:max(hi, lo)])
    return np.concatenate(out)


def test_rfc_burst_loss_matches_jax_and_scalar():
    """Consecutive losses (packets 8-11, then 20): the attenuation
    deepens with the loss count, the CNG state persists across the run,
    glue fires on recovery."""
    burst = set(range(8, 12)) | {20}
    name = "silk_wb_mono_20ms"
    got, ref = _both([name], lambda i, k: k in burst, K=3, **RFC)
    _assert_same(got, ref)
    assert_equal(got[0], _scalar_rfc_loss(name, lambda k: k in burst, 30),
                 "scalar RFC replay")
    clean = StreamPool(_cut(opusfile, [name]), device="cpu").run()[0]
    lo = 8 * 960 - 400
    assert got[0][lo:lo + 4 * 960].any()            # concealed, not silent
    assert not np.array_equal(got[0], clean)


@pytest.mark.parametrize("kw", [RFC, dict(compat_ref=True)],
                         ids=["rfc", "compat"])
def test_fec_matches_jax(kw):
    """Every 5th packet lost with fec: the lost frame comes from the
    next packet's LBRR copy where it has one, else it is concealed (RFC)
    or decoded over an empty bitstream (compat)."""
    name = "silk_wb_fec_mono_20ms"
    loss = lambda i, k: k > 0 and k % 5 == 0
    got, ref = _both([name], loss, fec=True, K=3, **kw)
    _assert_same(got, ref)
    plain, _ = _both([name], loss, fec=False, K=3, **kw)
    assert not np.array_equal(got[0], plain[0])     # some frame took FEC


def test_compat_loss_matches_jax():
    """compat mode, every 7th packet lost on two rates: the normal frame
    path over an empty bitstream, no concealment state involved."""
    got, ref = _both(RATES[1:], lambda i, k: k > 0 and k % 7 == 0, K=3,
                     compat_ref=True)
    _assert_same(got, ref)


def test_compat_loss_matches_golden():
    """The whole WB fixture with every 7th packet lost, against the PCM
    of the compiled reference (tests/golden/silk_wb_mono_20ms.loss7.pcm,
    untrimmed: the pool's output starts after the pre-skip)."""
    src = fixture_path("silk_wb_mono_20ms")
    pool = StreamPool([src], superstep_k=4, device="cpu")
    out = pool.run(loss=lambda i, k: k > 0 and k % 7 == 0)[0]
    gold = np.fromfile(GOLDEN / "silk_wb_mono_20ms.loss7.pcm",
                       dtype=np.int16).reshape(-1, 1)
    pre = sum(j.discard_front for j in pool.streams[0].jobs)
    n = min(len(out), len(gold) - pre)
    assert n > 90000
    assert_equal(out[:n], gold[pre:pre + n], "loss7 golden")


def test_lossy_bucket_handed_over_from_jax():
    """Both pools see the same packets and losses for 10 steps, the
    last two inside a loss run; then the JAX bucket (concealment state
    included) replaces the port's scrambled one, and after each of the
    next 8 steps, run in lockstep (the loss run goes on, then recovery
    with glue, then another loss), the nine keys are equal. The host's
    trackers cannot cross, which is why both pools run from the start."""
    lost_at = {8, 9, 10, 11, 15}
    name = "silk_wb_mono_20ms"
    jax_pool = JaxPool(_cut(jax_opusfile, [name]), channels=1, **RFC)
    pool = StreamPool(_cut(opusfile, [name]), device="cpu", **RFC)

    def step(k):
        lost = {0} if k in lost_at else set()
        jax_pool.step(lost)
        pool.step(lost)

    for k in range(10):
        step(k)
    jax_pool.collected()
    pool.collected()
    bucket = pool.silk_buckets[16]
    rng = np.random.default_rng(5)
    for v in bucket.values():
        v.copy_(v.new_tensor(rng.integers(-999, 999, tuple(v.shape))))
    jb = {k: np.asarray(v) for k, v in jax_pool.silk_buckets[16].items()}
    assert jb["cng"].any() and jb["conc_e"].any()
    bucket.update(from_jax_state(jb, device="cpu", rows=[0]))
    for k in range(10, 18):
        step(k)
        jax_pool.collected()
        pool.collected()
        got = to_numpy(bucket)
        for key in SILK_KEYS:
            assert_equal(got[key], np.asarray(
                jax_pool.silk_buckets[16][key])[:1], f"step {k} {key}")
    _assert_same(pool.collected(), jax_pool.collected(), n=18)


def test_ended_stream_keeps_its_lossy_state():
    """A stream that ends inside a lossy pool: its row is inactive from
    then on and keeps all nine state keys bit for bit while the other
    row goes on concealing and decoding."""
    streams = _cut(opusfile, ["silk_wb_mono_20ms"] * 2, 24)
    streams[1].jobs = streams[1].jobs[:9]
    pool = StreamPool(streams, superstep_k=2, device="cpu", **RFC)
    loss = lambda i, k: k % 4 == 3
    for _ in range(10):
        pool.step({i for i in range(2) if loss(i, pool.positions[i])
                   and pool.positions[i] < len(streams[i].jobs)})
    pool.collected()
    before = to_numpy(pool.silk_buckets[16])
    assert before["cng"][1].any() and before["conc_e"][1] != 0
    for _ in range(8):
        pool.step({0} if loss(0, pool.positions[0]) else set())
    pool.collected()
    after = to_numpy(pool.silk_buckets[16])
    for key in SILK_KEYS:
        assert_equal(after[key][1], before[key][1], f"ended row's {key}")
    assert not np.array_equal(after["outBuf"][0], before["outBuf"][0])


def test_rfc_plc_argument_checks():
    src = [fixture_path("silk_wb_mono_20ms")]
    with pytest.raises(ValueError):
        StreamPool(src, compat_ref=True, rfc_plc=True, device="cpu")
    # a CELT pool conceals: the lost packet's frame is not silence
    celt = StreamPool([fixture_path("celt_fb_mono_20ms")], compat_ref=False,
                      rfc_plc=True, device="cpu")
    for k in range(4):
        celt.step(lost={0} if k == 3 else None)
    out = celt.collected()[0]
    assert len(out) == 4 * 960 - 312 and out[-960:].any()
    assert celt.stats()["frames_lost"] == 1
    pool = StreamPool(src, compat_ref=False, device="cpu")
    pool.step()
    with pytest.raises(NotImplementedError, match="rfc_plc"):
        pool.step(lost={0})     # RFC-mode loss without concealment
