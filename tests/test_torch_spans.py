"""The port's span recorder (esp32_opus_player_tpu_torch/utils/spans.py)
and the spans the pool records on it, on the CPU: nesting and self time,
the ring's bound and its `dropped` count, reads by time that leave the
pool's pipeline alone; a K-3 pool's tree of spans (one `symbol` a
lane-step, one `enqueue` a lane every 3 steps, one `fetch_wait` and one
`route` a retired part, `pool.build` over its three children), each
`_phase_s` key equal to its span's total; the six benchmark readers on
a run of bench_port.drive.offline; the native strips' times; the
collector's and the library loaders' spans."""
import gc
import json
import pathlib
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

from esp32_opus_player_tpu_torch.host import native
from esp32_opus_player_tpu_torch.host import opusfile
from esp32_opus_player_tpu_torch.models import host_groups as hg
from esp32_opus_player_tpu_torch.models.stream_pool import StreamPool
from esp32_opus_player_tpu_torch.utils import spans

from conftest import fixture_path

ROOT = pathlib.Path(__file__).resolve().parents[1]
STEREO = fixture_path("celt_fb_stereo_20ms")
READERS = ("route_ms", "device_wait_ms", "enqueue_ms", "symbol_cpu_pct",
           "gc_ms", "pool_build_s")


def _stepped(sources, steps, **kw):
    """A CPU pool (K 3 unless given) stepped `steps` times, and the
    perf_counter time before it was built."""
    t0 = time.perf_counter()
    kw.setdefault("superstep_k", 3)
    pool = StreamPool(sources, device="cpu", **kw)
    for _ in range(steps):
        assert pool.step()
    return pool, t0


def test_nesting_and_self_time():
    rec = spans.Recorder(capacity=16)
    a = rec.open("a", 4, -1, t=10.0)
    b = rec.open("b", 4, 2, t=11.0)
    rec.close(b, 13.0, (1.0, 2.0, 3.0, 4.0))
    c = rec.open("b", 4, 3, t=14.0)
    rec.close(c, 14.5)
    assert rec.close(a, 20.0) == 20.0
    recs = rec.records()
    assert [(s.name, s.parent, s.step, s.lane) for s in recs] == [
        ("a", -1, 4, -1), ("b", a, 4, 2), ("b", a, 4, 3)]
    assert recs[1].t0 == 11.0 and recs[1].t1 == 13.0
    assert recs[1].args == {}           # "b" names no numbers
    tot = rec.totals()
    assert tot["a"] == spans.Total(1, 10.0, 7.5)
    assert tot["b"] == spans.Total(2, 2.5, 2.5)
    # a raise inside a block closes the block's span and any span left
    # open inside it; the next span is a root again
    with pytest.raises(KeyError):
        with rec.span("outer"):
            rec.open("left_open")
            raise KeyError
    assert rec._stack == []
    assert [s.name for s in rec.records()][-1] == "outer"
    assert rec.records()[-1].parent == -1


def test_ring_bound_and_dropped():
    rec = spans.Recorder(capacity=8)
    for i in range(20):
        rec.close(rec.open("s", i, t=float(i)), float(i) + 0.5)
    recs = rec.records()
    assert [s.step for s in recs] == list(range(12, 20))
    assert rec.dropped == 12 and rec.n == 20
    assert rec.lost(11.0) and not rec.lost(11.5)
    # a span still open when its slot is taken is gone too
    rec.open("long", t=30.0)
    for i in range(8):
        rec.close(rec.open("s", t=31.0 + i), 31.5 + i)
    assert "long" not in rec.totals()
    rec.reset()
    assert rec.records() == [] and rec.dropped == 0 and not rec.lost(-1e9)
    with pytest.raises(ValueError):
        spans.Recorder(capacity=12)


def test_records_and_totals_by_time():
    rec = spans.Recorder(capacity=64)
    p = rec.open("p", t=0.0)
    for i in range(5):
        rec.close(rec.open("c", i, t=1.0 + i), 1.5 + i)
    rec.close(p, 10.0)
    assert [s.step for s in rec.records(2.0, 4.5)] == [1, 2, 3]
    # a span that reaches past either end is left out, so the stretch's
    # children count for themselves alone
    tot = rec.totals(0.5, 6.0)
    assert set(tot) == {"c"} and tot["c"].count == 5
    assert tot["c"].total_s == pytest.approx(2.5)
    assert rec.totals(100.0, 200.0) == {}
    # an open span is not read
    rec.open("open", t=20.0)
    assert "open" not in rec.totals()


def test_reading_leaves_the_pipeline_alone():
    pool, t0 = _stepped([STEREO] * 2, 4, channels=2)
    pending = [list(p) for p in pool._pending]
    out = [len(c) for c in pool.pcm_out]
    rec = spans.recorder()
    assert rec.records(t0) and rec.totals(t0)["step"].count == 4
    assert [list(p) for p in pool._pending] == pending
    assert [len(c) for c in pool.pcm_out] == out
    assert pool.stats()["steps"] == 4       # stats() flushes: more spans
    assert rec.totals(t0)["step"].count == 5


def _by_step(recs):
    out = {}
    for s in recs:
        out.setdefault(s.step, []).append(s)
    return out


@pytest.mark.parametrize("case", ["celt_two_lanes", "hybrid_stereo"])
def test_pool_tree(case):
    """Two CELT lanes (20 and 5 ms RFC streams) or one hybrid lane, K 3,
    11 steps: the tree of each step."""
    if case == "celt_two_lanes":
        src = [fixture_path("celt_fb_mono_20ms"),
               fixture_path("celt_fb_mono_5ms")] * 2
        kw = dict(channels=1, compat_ref=False)
    else:
        src = [fixture_path("hybrid_fb_stereo_20ms")] * 3
        kw = dict(channels=2)
    pool, t0 = _stepped(src, 11, **kw)
    lanes = len(pool._lanes)
    assert lanes == (2 if case == "celt_two_lanes" else 1)
    recs = spans.recorder().records(t0)
    by_seq = {s.seq: s for s in recs}
    steps = _by_step(s for s in recs if s.step >= 0)
    assert sorted(steps) == list(range(11))
    for sn, ss in steps.items():
        names = [s.name for s in ss]
        assert names.count("step") == 1
        root = next(s for s in ss if s.name == "step")
        for s in ss:
            if s.name != "step" and s.name != "gc":
                par = by_seq[s.parent]
                assert par.step == sn and par.t0 <= s.t0 <= s.t1 <= par.t1
                want = dict(host_symbol="step", dispatch="step",
                            materialize="step", symbol="host_symbol",
                            stage=("dispatch", "stage"),
                            enqueue="dispatch", stage_wait="stage",
                            fetch_wait="materialize",
                            route="materialize")[s.name]
                assert par.name in want, (s.name, par.name)
        assert root.parent == -1
        # one symbol per lane-step, with its strips
        sym = [s for s in ss if s.name == "symbol"]
        assert sorted(s.lane for s in sym) == list(range(lanes))
        assert all(s.args["strips"] >= 1 and s.args["thread_s"] > 0
                   for s in sym)
        # one enqueue per lane every 3 steps, at the window's third frame
        enq = [s.lane for s in ss if s.name == "enqueue"]
        assert sorted(enq) == (list(range(lanes)) if sn % 3 == 2 else [])
        # the step retires the part of step sn - 3 of every lane: one
        # fetch_wait and one route each
        for name in ("fetch_wait", "route"):
            got = sorted(s.lane for s in ss if s.name == name)
            assert got == (list(range(lanes)) if sn >= 3 else []), name


def test_pool_build_has_its_children():
    t0 = time.perf_counter()
    StreamPool([STEREO] * 2, channels=2, device="cpu")
    recs = spans.recorder().records(t0)
    build = [s for s in recs if s.name == "pool.build"]
    assert len(build) == 1
    kids = [s.name for s in recs if s.parent == build[0].seq]
    assert kids == ["classify", "tables", "lanes"]
    # a construction that raises closes its spans
    with pytest.raises(ValueError):
        StreamPool([STEREO], channels=2, rfc_plc=True, device="cpu")
    assert spans.recorder()._stack == []


@pytest.mark.parametrize("k", [1, 3])
def test_phase_s_equals_span_totals(k):
    src = [STEREO, fixture_path("celt_fb_stereo_drums_20ms")]
    pool, t0 = _stepped(src, 7, channels=2, superstep_k=k)
    pool.collected()                # a _flush: dispatch and materialize
    tot = spans.recorder().totals(t0)
    for key, v in pool._phase_s.items():
        assert v > 0
        assert tot[key].total_s == pytest.approx(v, rel=1e-9, abs=1e-12)
    assert tot["step"].count == 8


def _window_run(seconds=0.4):
    """A tiny run as the benchmark makes one: a K-2 pool of the music
    cell's sources stepped closed loop by bench_port.drive.offline."""
    sys.path.insert(0, str(ROOT))
    from bench_port import drive
    cfg = json.loads((ROOT / "bench_port/configs/"
                      "music_celt_fb_stereo.json").read_text())
    src = [opusfile.parse_stream((ROOT / p).read_bytes())
           for p in cfg["sources"]] * 2
    pool = StreamPool(src, channels=2, superstep_k=2, device="cpu")
    drain = drive.Drain(pool, [0])
    sched = drive.Schedule(SimpleNamespace(lost=None, fec=False))
    drive.warm_up(pool, drain, sched, 4)
    win = drive.offline(pool, drain, sched, seconds, 2, True)
    return pool, SimpleNamespace(window=win, log=lambda msg: None)


def test_benchmark_readers_on_a_cpu_run():
    sys.path.insert(0, str(ROOT))
    from bench_port import spec
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = {m["name"].split(".")[0] for m in bench["per_layer"]}
    assert set(READERS) <= names
    pool, run = _window_run()
    got = {n: spec.metric_reader((ROOT / "bench_port",), n)(run)
           for n in READERS}
    assert all(isinstance(v, float) and v >= 0 for v in got.values()), got
    w = run.window
    mat = w.phase_s["materialize"] / w.steps * 1e3
    disp = w.phase_s["dispatch"] / w.steps * 1e3
    assert 0 < got["route_ms"] <= mat
    assert 0 < got["device_wait_ms"] <= mat + disp
    # every window the run dispatched, inside the dispatch phase
    assert 0 < got["enqueue_ms"] * (w.steps // 2) <= disp * w.steps
    assert 0 < got["symbol_cpu_pct"] <= 100
    assert got["pool_build_s"] > 0
    # a window the recorder lost part of reads nothing
    rec = spans.recorder()
    keep = rec._lost_until
    rec._lost_until = w.t0
    try:
        assert spec.metric_reader((ROOT / "bench_port",),
                                  "route_ms")(run) is None
    finally:
        rec._lost_until = keep


def test_gc_is_a_span():
    rec = spans.recorder()
    t0 = time.perf_counter()
    with rec.span("outer", 77, 5):
        gc.collect()
    got = [s for s in rec.records(t0) if s.name == "gc"]
    outer = [s for s in rec.records(t0) if s.name == "outer"][0]
    assert got and all(s.parent == outer.seq and s.step == 77 and
                       s.lane == 5 for s in got)
    assert got[-1].args["generation"] == 2
    assert rec.totals(t0)["outer"].self_s < outer.t1 - outer.t0


@pytest.mark.parametrize("rows,threads", [(5, 3), (2, 8), (4, 1), (1, 4)])
def test_native_strips(rows, threads):
    s = opusfile.parse_stream(STEREO.read_bytes())
    g = hg.CeltGroup(list(range(rows)), [s.jobs] * rows, 960, 2, 0,
                     [21] * rows, n_threads=threads)
    native.take_strips()
    for k in range(3):
        g.decode(np.full(rows, k), np.ones(rows, dtype=bool))
        wall, cpu, entry = native.last_strips()
        assert len(wall) == len(cpu) == min(threads, rows)
        assert all(c <= w + 1e-3 for w, c in zip(wall, cpu))
        assert all(0 < w <= entry for w in wall)
    T, cpu_s, wall_s, thread_s = native.take_strips()
    assert T == 3 * min(threads, rows)
    assert 0 < cpu_s <= thread_s + 3e-3 and wall_s > 0
    assert native.take_strips() == (0.0, 0.0, 0.0, 0.0)


def test_loader_spans_in_a_fresh_process():
    """A fresh interpreter loads the native library once, inside the
    pool's build (already built: compiled 0), and records it."""
    probe = f"""
import json, sys
from esp32_opus_player_tpu_torch.models.stream_pool import StreamPool
from esp32_opus_player_tpu_torch.utils import spans
StreamPool([{str(STEREO)!r}], channels=2, device="cpu")
recs = spans.recorder().records()
load = [s for s in recs if s.name.startswith("load.")]
print(json.dumps(dict(names=[s.name for s in load],
                      compiled=[s.args["compiled"] for s in load],
                      build=[s.name for s in recs
                             if any(b.name == "pool.build" and
                                    b.t0 <= s.t0 and s.t1 <= b.t1
                                    for b in recs)],
                      counters=spans.recorder().counters,
                      jax=any(m.split(".")[0] == "jax" for m in sys.modules))))
"""
    native.load()                   # built here first, if it was not
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["names"] == ["load.native"] and got["compiled"] == [0.0]
    assert "load.native" in got["build"]
    assert got["counters"] == {} and not got["jax"]
