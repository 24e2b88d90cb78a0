"""The CELT lane's PCM routing on the CPU: the native cut of a transposed
window frame (host/native/route_entry.cpp, pcm_cut_T, through
host.native.cut_T) against numpy's `frame[:, :, sel].transpose(2, 1,
0)[r, lo:N - te]`, byte for byte, at every frame size, one and two
channels, stream counts around its 8 x 8 blocks and tiles, whole and
partial selections, pre-skips, end-trims and trims that empty a row; and
a small stereo CELT pool (K 1 and 4) whose streams start with their
pre-skip, end at different lengths and lose packets: its chunks own
their memory, its PCM equals tests/golden (and the scalar decode with
silence for the lost packets), and its `route.*` counters add up."""
import dataclasses

import numpy as np
import pytest

from esp32_opus_player_tpu.models.opus_decoder import OpusDecoder
from esp32_opus_player_tpu_torch.host import native, opusfile
from esp32_opus_player_tpu_torch.models.stream_pool import StreamPool
from esp32_opus_player_tpu_torch.utils import spans

from conftest import fixture_path, golden_pcm

SENTINEL = -12345


def _trims(kind, N, m, rng):
    lo, te = np.zeros(m, np.int32), np.zeros(m, np.int32)
    if kind == "preskip":                 # a stream's first frame
        lo[::2] = 312
    elif kind == "end":
        te[::3] = rng.integers(1, N, len(te[::3]))
    elif kind == "over":                  # lo + te >= N: an empty chunk
        lo[::2] = N // 2
        te[::2] = N - N // 2
        lo[1::4] = N + 5
        te[3::4] = N
    return lo, te


@pytest.mark.parametrize("trim", ["zero", "preskip", "end", "over"])
@pytest.mark.parametrize("select", ["all", "subset", "empty"])
@pytest.mark.parametrize("n", [1, 63, 65, 2048])
@pytest.mark.parametrize("N", [120, 240, 480, 960])
@pytest.mark.parametrize("CC", [1, 2])
def test_cut_T_matches_numpy(CC, N, n, select, trim):
    rng = np.random.default_rng([CC, N, n, len(select), len(trim)])
    frame = rng.integers(-32768, 32768, (CC, N, n), dtype=np.int16)
    if select == "all":
        sel = np.arange(n)
    elif select == "subset":              # ragged: no whole 8-stream runs
        keep = rng.random(n) < 0.8
        keep[rng.integers(n)] = False
        sel = np.nonzero(keep)[0]
    else:
        sel = np.arange(0)
    sel = sel.astype(np.int64)
    m = sel.size
    lo, te = _trims(trim, N, m, rng)
    out = np.full((m * N + 8, CC), SENTINEL, dtype=np.int16)
    off = np.full(m + 1, -1, dtype=np.int64)
    total = native.cut_T(frame, sel, lo, te, out, off)
    ref = frame[:, :, sel].transpose(2, 1, 0)
    want = [ref[r, lo[r]:max(N - te[r], lo[r])] for r in range(m)]
    lens = [w.shape[0] for w in want]
    assert total == off[-1] == sum(lens)
    assert off.tolist() == np.concatenate([[0], np.cumsum(lens)]).tolist()
    for r in range(m):
        assert np.array_equal(out[off[r]:off[r + 1]], want[r]), r
    assert (out[total:] == SENTINEL).all()


def test_cut_T_checks_its_inputs():
    frame = np.zeros((2, 120, 16), dtype=np.int16)
    sel = np.arange(16, dtype=np.int64)
    z = np.zeros(16, dtype=np.int32)
    out, off = np.zeros((16 * 120, 2), np.int16), np.zeros(17, np.int64)
    native.cut_T(frame, sel, z, z, out, off)
    bad = [
        (frame.transpose(0, 2, 1), sel, z, z, out, off),   # not contiguous
        (frame, sel + 1, z, z, out, off),                  # stream 16
        (frame, sel, z - 1, z, out, off),                  # negative trim
        (frame, sel.astype(np.int32), z, z, out, off),
        (frame, sel, z, z, out[:-1], off),                 # out too short
        (frame, sel, z, z, out, off[:-1]),
        (np.zeros((3, 120, 16), np.int16), sel, z, z, out, off),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            native.cut_T(*args)


def _streams():
    """Five stereo CELT streams: full, full with an end-trim of 200 on
    its last packet, and three cut short (37, 58, 71 packets)."""
    a, b = fixture_path("celt_fb_stereo_20ms"), \
        fixture_path("celt_fb_stereo_drums_20ms")
    out = []
    for path, n, te in ((a, None, 0), (b, None, 200), (a, 37, 0),
                        (b, 58, 0), (b, 71, 0)):
        s = opusfile.open_file(path)
        if n is not None:
            s.jobs = s.jobs[:n]
        if te:
            s.jobs[-1] = dataclasses.replace(s.jobs[-1], trim_end=te)
        out.append((path, s))
    return out


@pytest.mark.parametrize("K", [1, 4])
def test_pool_route(K):
    srcs = _streams()
    lost = {3: {2, 9, 10}, 4: {0, 40}}    # stream: its lost packets
    pool = StreamPool([s for _, s in srcs], channels=2, superstep_k=K,
                      device="cpu")
    (lane,) = pool._lanes
    rec = spans.recorder()
    before = dict(rec.counters)
    got = [[] for _ in srcs]
    k = 0
    while pool.step({i for i, ks in lost.items() if k in ks}):
        k += 1
        for i, chunks in enumerate(pool.pcm_out):
            for c in chunks:
                assert c.dtype == np.int16 and c.shape[1] == 2
                assert c.flags.c_contiguous and c.flags.owndata
                assert c.base is None
                assert not np.shares_memory(c, lane.cut_buf)
            got[i].extend(chunks)
            chunks.clear()
    pool.stats()                          # flushes the pipeline
    for i, chunks in enumerate(pool.pcm_out):
        got[i].extend(chunks)
    assert all(len(g) == len(s.jobs) for g, (_, s) in zip(got, srcs))
    outs = [np.concatenate(g) for g in got]

    for i in (0, 1, 2):
        gold = golden_pcm(srcs[i][0].stem)
        n = sum(j.keep for j in srcs[i][1].jobs)
        assert outs[i].shape[0] == n
        assert np.array_equal(outs[i], gold[:n]), i
    assert outs[1].shape[0] == 100 * 960 - 312 - 200
    for i in (3, 4):                      # silence for a lost packet
        dec, exp = OpusDecoder(2, compat_ref=True), []
        for k, job in enumerate(srcs[i][1].jobs):
            pcm = np.zeros((960, 2), np.int16) if k in lost[i] else \
                dec.decode(job.data)
            exp.append(pcm[job.discard_front:960 - job.trim_end])
        assert np.array_equal(outs[i], np.concatenate(exp)), i

    c = {k: rec.counters.get(k, 0) - before.get(k, 0) for k in
         ("route.rows_native", "route.rows_numpy", "route.rows_trimmed")}
    rows = sum(len(s.jobs) for _, s in srcs)
    n_lost = sum(len(v) for v in lost.values())
    assert c["route.rows_native"] + c["route.rows_numpy"] == rows
    assert c["route.rows_numpy"] == n_lost
    # each stream's pre-skip (stream 4's first packet is lost: its
    # silence is trimmed too) and stream 1's end-trim
    assert c["route.rows_trimmed"] == len(srcs) + 1
    assert pool.stats()["samples_out"] == sum(o.shape[0] for o in outs)
