"""The port's bench (esp32_opus_player_tpu_torch/bench.py) and the pool
counters it reads, on the CPU: StreamPool.stats() of the port equals the
JAX pool's stats() for the same small CELT, SILK, lossy SILK, lossy
stereo SILK, concealing hybrid and multi-frame SILK pools
(every counter but the device bucket histogram, whose keys name each
pool's own device programs), the per-phase host timer adds up (the
recorder's fetch_wait spans inside materialize), and each bench function
runs at B 4 on device="cpu" and returns its keys."""
import os
import time

import numpy as np
import pytest

from esp32_opus_player_tpu.host import opusfile as jax_opusfile
from esp32_opus_player_tpu.models.stream_pool import StreamPool as JaxPool
from esp32_opus_player_tpu_torch import bench
from esp32_opus_player_tpu_torch.host import opusfile
from esp32_opus_player_tpu_torch.models.stream_pool import StreamPool
from esp32_opus_player_tpu_torch.utils import spans

from conftest import fixture_path

COUNTERS = ("steps", "frames", "bytes_in", "samples_out", "frames_celt",
            "frames_silk", "frames_hybrid", "frames_scalar", "frames_lost",
            "frames_fec", "streams", "active_streams")


def _cut(mod, names, n):
    out = []
    for name in names:
        s = mod.parse_stream(fixture_path(name).read_bytes())
        s.jobs = s.jobs[:n]
        out.append(s)
    return out


RFC = dict(compat_ref=False, rfc_plc=True)
CASES = {
    "celt": (["celt_fb_mono_20ms", "celt_fb_mono_drums_20ms"] * 2, {},
             lambda i, k: (3 * i + k) % 5 == 0, False, 1),
    "silk": (["silk_nb_mono_20ms", "silk_wb_mono_20ms"], {}, None, False,
             1),
    "lossy_silk": (["silk_wb_fec_mono_20ms", "silk_wb_mono_20ms"] * 2, RFC,
                   lambda i, k: i % 4 == k % 4, True, 1),
    "lossy_silk_stereo": (["silk_wb_fec_stereo_20ms", "silk_wb_stereo_20ms"],
                          {}, lambda i, k: k % 4 == 2, True, 2),
    "hybrid_conceal": (["hybrid_swb_mono_20ms"] * 2, RFC,
                       lambda i, k: i % 2 == k % 3, False, 1),
    "silk_60ms": (["silk_wb_mono_60ms"], dict(compat_ref=False), None,
                  False, 1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_stats_match_jax(case):
    names, kw, loss, fec, channels = CASES[case]
    n = 12
    port = StreamPool(_cut(opusfile, names, n), channels=channels,
                      superstep_k=3, device="cpu", **kw)
    ref = JaxPool(_cut(jax_opusfile, names, n), channels=channels,
                  superstep_k=3, **kw)
    t0 = time.perf_counter()
    got_pcm = port.run(loss=loss, fec=fec)
    ref_pcm = ref.run(loss=loss, fec=fec)
    for a, b in zip(got_pcm, ref_pcm):
        assert np.array_equal(a, b)
    got, want = port.stats(), ref.stats()
    assert {k: got[k] for k in COUNTERS} == {k: want[k] for k in COUNTERS}
    assert got["frames"] == len(names) * n and got["active_streams"] == 0
    if loss is not None:
        assert got["frames_lost"] > 0
    if fec:
        assert 0 < got["frames_fec"] <= got["frames_lost"]
    assert set(got["phase_s"]) == {"host_symbol", "dispatch", "materialize"}
    assert all(v > 0 for v in got["phase_s"].values())
    fetch = spans.recorder().totals(t0)["fetch_wait"].total_s
    assert 0 < fetch <= got["phase_s"]["materialize"]
    assert sum(got["buckets"].values()) >= got["steps"]


def test_stats_mid_run_counts_active_streams():
    src = _cut(opusfile, ["celt_fb_mono_20ms", "celt_nb_mono_20ms"], 6)
    src[1].jobs = src[1].jobs[:3]
    pool = StreamPool(src, compat_ref=False, superstep_k=2, device="cpu")
    for _ in range(4):
        pool.step()
    st = pool.stats()
    assert (st["steps"], st["frames"], st["active_streams"]) == (4, 7, 1)
    assert st["buckets"] == {("celtT", 3, 1, 1, 2): 4}


def _keys(r, *keys):
    assert set(keys) <= set(r), sorted(r)
    for k in keys:
        if isinstance(r[k], dict) and "median" in r[k]:
            assert r[k]["median"] > 0 and r[k]["spread"] >= 0


def test_bench_device():
    r = bench.bench_device(B=4, iters=2, K=2, repeats=2, device="cpu")
    _keys(r, "ms_per_frame_k1", "streams_k1", "windows", "first_call_s")
    assert sorted(r["windows"]) == [4, 8, 16]
    for w in r["windows"].values():
        _keys(w, "ms_per_frame", "ms_per_frame_upload", "streams",
              "streams_upload")


def test_bench_device_silk():
    r = bench.bench_device_silk(B=4, iters=2, K=2, repeats=2, device="cpu")
    _keys(r, "ms_per_frame_k1", "streams_k1", "windows")
    assert sorted(r["windows"]) == [4, 8, 16]
    for w in r["windows"].values():
        _keys(w, "ms_per_frame", "ms_per_frame_upload")


def test_bench_host():
    r = bench.bench_host(B=4, reps=1)
    threads = sorted(r["us_per_frame_by_threads"])
    assert threads[0] == 1 and threads[-1] == r["cores"] == min(
        len(os.sched_getaffinity(0)), 4)
    assert r["us_per_frame"] > 0 and r["streams_per_core"] > 0


@pytest.mark.parametrize("name", list(bench.POOLS))
def test_bench_pool(name):
    r = bench.bench_named_pool(name, B=4, K=2, iters=2, repeats=2,
                               device="cpu")
    _keys(r, "streams", "step_ms", "phase_ms_per_step", "stats", "setup_s")
    assert (r["K"], r["iters"], r["warm"]) == (2, 4, 4)
    ph = r["phase_ms_per_step"]
    assert set(ph) == {"host_symbol", "dispatch", "materialize",
                       "materialize_fetch"}
    assert all(0 < f <= m for f, m in zip(ph["materialize_fetch"]["runs"],
                                          ph["materialize"]["runs"]))
    st = r["stats"]
    assert st["steps"] == 4 + 2 * 4 and st["streams"] == 4
    assert (st["frames_lost"] > 0) == ("loss" in name or "fec" in name)


def test_looped_stream_keeps_the_trims_at_its_ends():
    s = bench.looped("celt_fb_mono_20ms", 3)
    one = opusfile.parse_stream(
        fixture_path("celt_fb_mono_20ms").read_bytes())
    n = len(one.jobs)
    assert len(s.jobs) == 3 * n
    assert sum(j.discard_front for j in s.jobs) == sum(
        j.discard_front for j in one.jobs)
    assert s.jobs[-1].trim_end == one.jobs[-1].trim_end
    assert all(j.trim_end == 0 for j in s.jobs[:-n])


def test_bench_without_a_card_raises():
    import torch
    if torch.cuda.is_available():
        assert bench._check_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench.main(["--only", "host"])
