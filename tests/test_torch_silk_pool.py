"""The port's mono SILK StreamPool on CPU tensors (the kernels' plain
versions): the NB, MB, WB and WB-FEC 20 ms fixtures in one pool (three
rates, three buckets) decode bit for bit to tests/golden and to the JAX
StreamPool, per frame (K = 1) and in K = 3 windows (the last one
partial); a stream that ends early keeps its bucket state bit for bit;
and a bucket carried over from the JAX pool mid-run continues bit-equal.
Tolerance: 0."""
import numpy as np
import pytest

from esp32_opus_player_tpu.models.stream_pool import StreamPool as JaxPool
from esp32_opus_player_tpu_torch.host import opusfile
from esp32_opus_player_tpu_torch.models.stream_pool import StreamPool
from esp32_opus_player_tpu_torch.utils.state import (SILK_KEYS,
                                                     from_jax_state, to_numpy)

from conftest import fixture_path, golden_pcm
from torch_port_util import assert_equal

NAMES = ["silk_nb_mono_20ms", "silk_mb_mono_20ms", "silk_wb_mono_20ms",
         "silk_wb_fec_mono_20ms"]
FS = [8, 12, 16, 16]


def _paths(names=NAMES):
    return [str(fixture_path(n)) for n in names]


@pytest.fixture(scope="module")
def jax_out():
    return JaxPool(_paths(), channels=1).run()


@pytest.mark.parametrize("K", [1, 3])
def test_silk_pool_matches_golden_and_jax(K, jax_out):
    pool = StreamPool(_paths(), channels=1, superstep_k=K, device="cpu")
    assert sorted(pool.silk_buckets) == [8, 12, 16]
    outs = pool.run()
    ref = JaxPool(_paths(), channels=1, superstep_k=K).run()
    for name, out, j, jk in zip(NAMES, outs, jax_out, ref):
        gold = golden_pcm(name)
        assert out.shape == j.shape == jk.shape and len(out) > 90000
        assert np.array_equal(np.repeat(out, 2, axis=1), gold[:len(out)]), \
            name
        assert np.array_equal(out, j) and np.array_equal(out, jk), name


def test_ended_stream_keeps_its_state():
    """A WB stream cut to 6 packets beside a full one: after its end its
    row is inactive and its bucket state stays bit for bit, while the
    other row goes on decoding to tests/golden."""
    streams = [opusfile.parse_stream(open(p, "rb").read())
               for p in _paths(["silk_wb_mono_20ms"] * 2)]
    streams[1].jobs = streams[1].jobs[:6]
    pool = StreamPool(streams, channels=1, superstep_k=4, device="cpu")
    for _ in range(7):
        pool.step()
    pool.collected()
    before = to_numpy(pool.silk_buckets[16])
    for _ in range(6):
        pool.step()
    outs = pool.collected()
    after = to_numpy(pool.silk_buckets[16])
    for k in SILK_KEYS:
        assert_equal(after[k][1], before[k][1], f"ended row's {k}")
        # the live row moved on (keys this stream never uses stay zero:
        # the resampler's unused states, the concealment state)
        assert not np.array_equal(after[k][0], before[k][0]) \
            or k in ("sIIR", "sFIR", "cng", "conc_e", "conc_s") \
            and not before[k][0].any(), k
    gold = golden_pcm("silk_wb_mono_20ms")
    assert len(outs[0]) > len(outs[1]) > 4 * 960
    for out in outs:
        assert np.array_equal(np.repeat(out, 2, axis=1), gold[:len(out)])


def test_bucket_handed_over_from_jax():
    """The JAX pool decodes 4 frames; its SILK buckets move into a port
    pool (whose own state is first scrambled) with from_jax_state, and
    the port decodes the next 8 frames bit-equal to the JAX pool's."""
    jax_pool = JaxPool(_paths(), channels=1)
    pool = StreamPool(_paths(), channels=1, device="cpu")
    for _ in range(4):
        jax_pool.step()
        pool.step()
    rng = np.random.default_rng(3)
    for fs, bucket in pool.silk_buckets.items():
        rows = [i for i, f in enumerate(FS) if f == fs]
        for v in bucket.values():
            v.copy_(v.new_tensor(rng.integers(-999, 999, tuple(v.shape))))
        bucket.update(from_jax_state(
            {k: np.asarray(v) for k, v in jax_pool.silk_buckets[fs].items()},
            device="cpu", rows=rows))
        got = to_numpy(bucket)
        for k in SILK_KEYS:
            assert_equal(got[k], np.asarray(
                jax_pool.silk_buckets[fs][k])[rows], f"{fs} kHz {k}")
    head = [len(o) for o in pool.collected()]
    for _ in range(8):
        jax_pool.step()
        pool.step()
    for name, out, ref, h in zip(NAMES, pool.collected(),
                                 jax_pool.collected(), head):
        assert len(out) == len(ref) > h + 7 * 960, name
        assert np.array_equal(out[h:], ref[h:]), name
