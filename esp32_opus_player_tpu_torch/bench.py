"""Benchmark of the torch port: realtime streams per card, device time per
frame, and where a pool step's host time goes.

    python -m esp32_opus_player_tpu_torch.bench [--repeats 5]
        [--device cuda] [--only NAME ...]

Port of the root bench.py's bench_device (:222), bench_device_silk
(:312), bench_host (:179), bench_pool (:44) and bench_pool_loss (:95,
here bench_pool's `loss` argument), on the card by default (no card: it
raises; device="cpu" runs the plain versions, as the tests do). Device
times come from CUDA events (on the CPU from the host clock). Every pool and device measurement runs
`repeats` times and reports its median and its spread, (max - min) /
median.

Pools (`POOLS`): 2048 streams of one source (or one source per stream
in turn), each source looped (its packets repeated, the pre-skip kept on
the first copy and the end trim on the last) so that the warm-up and
every timed run are whole K-frame windows of the same pool. The warm-up
and the iterations are aligned to whole windows, as in the JAX bench.
Realtime streams = seconds of audio decoded per second of wall time,
B * 0.02 s / wall time per step for a pool of 20 ms streams. The per-step
host phases come from the pool's `_phase_s`: host_symbol, dispatch and
materialize (models/stream_pool.py), and materialize_fetch, the part of
materialize that waits for a window's PCM (the `fetch_wait` spans on the
port's recorder, utils/spans.py).

The port's pool has no fixed_buckets, warmup() or device-resident output
(ROADMAP.md queue A item 12b), so the pool benches take PCM to the host
and warm up by stepping. Left out: bench_link, bench_sharded_device and
bench_farm_loss (item 14), and the on-card consumer (consume=True, item
13).

Prints progress lines to stderr and, as the last line of stdout, one
JSON object: every metric with its unit, and the card's name and power
limit as `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
prints them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from .host import opusfile
from .models import host_groups as hg
from .models.celt_pool_T import (_CELT_HDR, celt_packed_frame_T,
                                 celt_pool_superstep_T)
from .models.silk_pool import (make_bucket, silk_frame, silk_pool_superstep,
                               stage_width)
from .ops.celt.torch_synthesis import DECODE_BUFFER_SIZE, NB_EBANDS, OVERLAP
from .utils import spans

FIX = pathlib.Path(__file__).resolve().parents[1] / "tests" / "fixtures"
# name: (fixtures, channels, streams, superstep_k, pool options, loss)
POOLS = {
    "celt_fb_mono": (("celt_fb_mono_20ms",), 1, 2048, 64, {}, None),
    "silk_wb_mono": (("silk_wb_mono_20ms",), 1, 2048, 64, {}, None),
    "silk_wb_10pct_loss_plc": (("silk_wb_mono_20ms",), 1, 2048, 64,
                               dict(compat_ref=False, rfc_plc=True),
                               "plc"),
    "silk_wb_10pct_fec": (("silk_wb_fec_mono_20ms",), 1, 2048, 64,
                          dict(compat_ref=False, rfc_plc=True), "fec"),
    "celt_fb_10pct_loss_plc": (("celt_fb_mono_20ms",), 1, 2048, 64,
                               dict(compat_ref=False, rfc_plc=True),
                               "plc"),
    "celt_mixed_lm_rfc": (("celt_fb_mono_5ms", "celt_fb_stereo_2p5ms",
                           "celt_swb_stereo_10ms", "celt_nb_mono_20ms",
                           "celt_fb_mono_20ms"), 2, 2048, 16,
                          dict(compat_ref=False), None),
    "silk_wb_stereo": (("silk_wb_stereo_20ms",), 2, 1024, 64, {}, None),
    "hybrid_swb_mono": (("hybrid_swb_mono_20ms",), 1, 2048, 64, {}, None),
    "hybrid_fb_stereo": (("hybrid_fb_stereo_20ms",), 2, 1024, 64, {}, None),
}


def card_name(device) -> str:
    """`name, power.limit` of the card (nvidia-smi), or "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _check_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench: no CUDA device; pass device='cpu' to run "
                           "the plain versions on the CPU")
    return dev


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed_ms(fn, dev) -> float:
    """Time of one fn() call in ms: CUDA events around it on the card's
    current stream, the host clock on the CPU."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1)


def summary(xs) -> dict:
    """Median and spread ((max - min) / median) of repeated runs."""
    med = statistics.median(xs)
    return dict(median=med, spread=(max(xs) - min(xs)) / med if med else 0.0,
                runs=list(xs))


def _align(warm: int, iters: int, K: int) -> tuple:
    """warm and iters as whole K-frame windows (bench.py:64-68)."""
    if K > 1:
        warm = max(warm, K)
        warm -= warm % K
        iters = max(iters, 2 * K)
        iters -= iters % K
    return warm, iters


# ---------------------------------------------------------------- device

def celt_staging(B: int) -> np.ndarray:
    """bench.py:235-247: B packed int16 staging rows of a fullband 20 ms
    mono frame, random transient flags, varied comb lags, gains 12288,
    random spectrum and band energies."""
    W = _CELT_HDR + 2 * NB_EBANDS + 960
    rng = np.random.default_rng(0)
    stg = np.zeros((B, W), dtype=np.int16)
    stg[:, 2] = rng.integers(0, 2, B)                   # transient
    stg[:, 4] = 21
    stg[:, 5:7] = rng.integers(15, 1024, (B, 2))        # comb1 T
    stg[:, 11:13] = rng.integers(15, 1024, (B, 2))      # comb2 T
    stg[:, 7:9] = 12288
    stg[:, 13:15] = 12288
    stg[:, 17] = 1
    stg[:, _CELT_HDR:] = rng.integers(-8192, 8192, (B, W - _CELT_HDR),
                                      dtype=np.int16)
    return stg


def silk_staging(B: int, fs: int) -> np.ndarray:
    """bench.py:330-349 as the port's staging rows (models/silk_pool.py):
    random excitation and filters, gains 1 << 16, inverse gains 1 << 30,
    random lags in [2 fs, 18 fs), adj 1 << 14, every subframe voiced, the
    first rewhitened; active."""
    nb, frame = 4, 20 * fs
    rng = np.random.default_rng(0)
    stg = np.zeros((B, stage_width(frame, nb)), dtype=np.int32)
    stg[:, :frame] = rng.integers(-(1 << 16), 1 << 16, (B, frame))
    stg[:, frame:frame + 32] = rng.integers(-(1 << 12), 1 << 12, (B, 32))
    stg[:, frame + 32:frame + 52] = rng.integers(-(1 << 12), 1 << 12,
                                                 (B, 20))
    p = frame + 52
    stg[:, p:p + 4] = 1 << 16                              # gains
    stg[:, p + 4:p + 8] = 1 << 30                          # inv_gain
    stg[:, p + 8:p + 12] = rng.integers(2 * fs, 18 * fs, (B, 4))
    stg[:, p + 12:p + 16] = 1 << 14                        # adj
    stg[:, p + 16:p + 20] = 1                              # voiced
    stg[:, p + 20] = 1                                     # rewhiten sf 0
    stg[:, -1] = 1                                         # active
    return stg


def _window_bench(step, stg, K: int, widths, repeats: int, dev,
                  make_state) -> dict:
    """K-frame windows of `step(state, stgK)` at each width, timed
    without the staging upload (the window's staging already on the
    card) and with it (from pinned host memory inside the timed region).
    Returns per width: ms per frame and realtime streams, each a
    summary."""
    B = stg.shape[0]
    out = {}
    for Bs in widths:
        rows = np.repeat(stg, -(-Bs // B), axis=0)[:Bs]
        host = torch.from_numpy(np.broadcast_to(rows, (K,) + rows.shape)
                                .copy())
        if dev.type == "cuda":
            host = host.pin_memory()
        sK = host.to(dev)
        st = make_state(Bs)
        for _ in range(2):
            step(st, sK)
        _sync(dev)
        res = {}
        for label, src in (("", lambda: sK),
                           ("_upload", lambda: host.to(dev,
                                                       non_blocking=True))):
            ms = [timed_ms(lambda: step(st, src()), dev) / K
                  for _ in range(repeats)]
            res["ms_per_frame" + label] = summary(ms)
            res["streams" + label] = summary([Bs * 0.02 / (m / 1e3)
                                              for m in ms])
        out[Bs] = res
    return out


def bench_device(B: int = 2048, iters: int = 12, K: int = 64,
                 repeats: int = 5, device="cuda") -> dict:
    """The packed transposed CELT frame step (kernels K1-K3) with varied
    lags: one frame at a time (K = 1, masked=False, chained on the
    card), then K-frame windows (masked, the served form) at B, 2B, 4B
    (2048, 4096, 8192 by default), without and with the staging upload
    (bench.py:222)."""
    dev = _check_device(device)
    widths = (B, 2 * B, 4 * B)
    stg = celt_staging(B)
    sdev = torch.as_tensor(stg, device=dev)

    def state(n):
        return (torch.zeros((1, DECODE_BUFFER_SIZE + OVERLAP, n),
                            dtype=torch.int32, device=dev),
                torch.zeros((n, 1), dtype=torch.int32, device=dev))

    dm, pre = state(B)
    frame = lambda: celt_packed_frame_T(dm, pre, sdev, LM=3, C=1, CC=1,
                                        masked=False)
    t0 = time.perf_counter()
    frame()                        # the kernel build and lazy tables
    _sync(dev)
    first_s = time.perf_counter() - t0
    ms = [timed_ms(lambda: [frame() for _ in range(iters)], dev) / iters
          for _ in range(repeats)]
    win = _window_bench(
        lambda s, sK: celt_pool_superstep_T(s[0], s[1], sK, LM=3, C=1, CC=1,
                                            masked=[True] * K),
        stg, K, widths, repeats, dev, state)
    return dict(B=B, K=K, first_call_s=first_s,
                ms_per_frame_k1=summary(ms),
                streams_k1=summary([B * 0.02 / (m / 1e3) for m in ms]),
                windows=win)


def bench_device_silk(B: int = 2048, iters: int = 10, K: int = 64,
                      repeats: int = 5, device="cuda") -> dict:
    """The WB SILK frame step (decode_core, kernel K7, and the resampler,
    K6's fused entry) over one bucket: one frame at a time, then K-frame
    windows at B, 2B, 4B (2048, 4096, 8192 by default) without and with
    the staging upload (bench.py:312)."""
    dev = _check_device(device)
    widths = (B, 2 * B, 4 * B)
    fs = 16
    stg = silk_staging(B, fs)
    sdev = torch.as_tensor(stg, device=dev)
    kw = dict(fs=fs, nb=4, order=16)
    st = make_bucket(B, fs, dev)
    frame = lambda: silk_frame(st, sdev, masked=False, **kw)
    frame()
    _sync(dev)
    ms = [timed_ms(lambda: [frame() for _ in range(iters)], dev) / iters
          for _ in range(repeats)]
    win = _window_bench(
        lambda s, sK: silk_pool_superstep(s, sK, masked=[True] * K, **kw),
        stg, K, widths, repeats, dev, lambda n: make_bucket(n, fs, dev))
    return dict(B=B, K=K, ms_per_frame_k1=summary(ms),
                streams_k1=summary([B * 0.02 / (m / 1e3) for m in ms]),
                windows=win)


# ------------------------------------------------------------------ host

def bench_host(B: int = 2048, reps: int = 5) -> dict:
    """The batched native CELT symbol phase (models/host_groups.py), us
    per frame at every thread count 1, 2, 4, ... up to the cores or B,
    whichever is fewer (the minimum over reps timed passes over the
    whole fixture, bench.py:179). B defaults to the pools' width, so
    that B times its us per frame compares with a pool's host_symbol
    (the JAX bench's 256 rows spread each call's cost over fewer)."""
    s = opusfile.parse_stream((FIX / "celt_fb_mono_20ms.opus").read_bytes())
    npk = len(s.jobs)
    active = np.ones(B, dtype=bool)
    cores = min(len(os.sched_getaffinity(0)), B)
    threads = [1]
    while threads[-1] * 2 <= cores:
        threads.append(threads[-1] * 2)
    if cores not in threads:
        threads.append(cores)
    curve = {}
    for nt in threads:
        g = hg.CeltGroup(list(range(B)), [s.jobs] * B, 960, 1, 0, [21] * B,
                         n_threads=nt)
        for k in range(min(3, npk)):
            g.decode(np.full(B, k, dtype=np.int64), active)
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            for k in range(npk):
                g.decode(np.full(B, k, dtype=np.int64), active)
            best = min(best, (time.perf_counter() - t0) / (npk * B))
        curve[nt] = best * 1e6
    return dict(B=B, cores=cores, us_per_frame_by_threads=curve,
                us_per_frame=min(curve.values()),
                streams_per_core=0.02 / (curve[1] / 1e6))


# ----------------------------------------------------------------- pools

def looped(name: str, times: int):
    """The fixture's stream with its packets repeated `times` times: the
    pre-skip stays on the first copy's packets, the end trim on the
    last's."""
    s = opusfile.parse_stream((FIX / f"{name}.opus").read_bytes())
    n = len(s.jobs)
    jobs = []
    for c in range(times):
        for j in s.jobs:
            jobs.append(dataclasses.replace(
                j, discard_front=j.discard_front if c == 0 else 0,
                trim_end=j.trim_end if c == times - 1 else 0))
    assert len(jobs) == n * times
    return dataclasses.replace(s, jobs=jobs)


def _tenth(B: int, k: int) -> set:
    """Stream i loses packet k where i % 10 == k % 10 (bench.py:117)."""
    return {i for i in range(B) if i % 10 == k % 10}


def bench_pool(names, B: int, channels: int, K: int, iters: int = 10,
               repeats: int = 5, device="cuda", loss=None,
               **pool_kw) -> dict:
    """Steady-state end-to-end rate of one StreamPool of B streams
    (names[i % len(names)], each looped to cover the run): 4 steps of
    warm-up, then `repeats` timed runs of `iters` steps each, all whole K-frame
    windows; the pipeline is drained (PCM on the host) at the end of the
    warm-up and of each timed run. loss: None, "plc" (10 % lost,
    concealed; the pool needs compat_ref=False, rfc_plc=True) or "fec"
    (the same, recovered from the next packet's LBRR copy where it has
    one): bench.py:95's bench_pool_loss. Returns the realtime streams, the wall
    ms per step and the host phases per step (ms), each a summary, and
    the pool's stats."""
    from .models.stream_pool import StreamPool
    dev = _check_device(device)
    warm, iters = _align(4, iters, K)
    steps = warm + repeats * iters
    srcs = {}
    for m in names:
        n = len(opusfile.parse_stream((FIX / f"{m}.opus").read_bytes()).jobs)
        srcs[m] = looped(m, -(-steps // n))
    t0 = time.perf_counter()
    pool = StreamPool([srcs[names[i % len(names)]] for i in range(B)],
                      channels=channels, superstep_k=K, device=dev,
                      **pool_kw)
    setup_s = time.perf_counter() - t0
    # seconds of audio one step decodes, over the streams
    audio_s = sum(pool.streams[i].jobs[0].duration for i in range(B)) / 48e3

    def run(n_steps: int) -> None:
        for k in range(n_steps):
            lost = _tenth(B, k) if loss else None
            if not pool.step(lost, fec=lost if loss == "fec" else None):
                raise RuntimeError("bench_pool: the looped streams ended")
        pool._flush()
        _sync(dev)

    run(warm)
    walls, phases = [], {k: [] for k in (*pool._phase_s,
                                         "materialize_fetch")}
    rec = spans.recorder()
    for _ in range(repeats):
        for k in pool._phase_s:
            pool._phase_s[k] = 0.0
        t0 = time.perf_counter()
        run(iters)
        t1 = time.perf_counter()
        walls.append((t1 - t0) / iters)
        fetch = rec.totals(t0, t1).get("fetch_wait")
        for k, v in (*pool._phase_s.items(),
                     ("materialize_fetch", fetch.total_s if fetch else 0.0)):
            phases[k].append(v / iters * 1e3)
    return dict(B=B, K=K, iters=iters, warm=warm, setup_s=setup_s,
                streams=summary([audio_s / w for w in walls]),
                step_ms=summary([w * 1e3 for w in walls]),
                phase_ms_per_step={k: summary(v) for k, v in phases.items()},
                stats={k: v for k, v in pool.stats().items()
                       if k not in ("buckets", "phase_s")})


def bench_named_pool(name: str, B: int = 0, K: int = 0, **kw) -> dict:
    """One pool of POOLS (B and K override its stream count and window)."""
    names, channels, n, K0, opts, loss = POOLS[name]
    return bench_pool(names, B or n, channels, K or K0, loss=loss, **opts,
                      **kw)


# ------------------------------------------------------------------ main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--only", nargs="*", default=None,
                    help="device, silk_device, host and pool names "
                         f"({', '.join(POOLS)}); default all")
    args = ap.parse_args(argv)
    dev = _check_device(args.device)
    want = set(args.only or ["device", "silk_device", "host", *POOLS])
    card = card_name(dev)
    log = lambda msg: print(f"# [{card}] {msg}", file=sys.stderr, flush=True)
    out = dict(card=card, device=str(dev), repeats=args.repeats,
               units=dict(streams="realtime streams (seconds of audio "
                          "decoded per second of wall time)",
                          ms="milliseconds", us="microseconds",
                          spread="(max - min) / median over the repeats"))
    if "device" in want:
        r = bench_device(repeats=args.repeats, device=dev)
        out["device_celt"] = r
        log(f"CELT frame step B={r['B']}: K=1 "
            f"{r['ms_per_frame_k1']['median']:.4f} ms/frame; K=64 by B: "
            + ", ".join(f"{b}: {w['ms_per_frame']['median']:.4f} / with "
                        f"upload {w['ms_per_frame_upload']['median']:.4f}"
                        for b, w in r["windows"].items()))
    if "silk_device" in want:
        r = bench_device_silk(repeats=args.repeats, device=dev)
        out["device_silk"] = r
        log(f"SILK WB frame step B={r['B']}: K=1 "
            f"{r['ms_per_frame_k1']['median']:.4f} ms/frame; K=64 by B: "
            + ", ".join(f"{b}: {w['ms_per_frame']['median']:.4f} / with "
                        f"upload {w['ms_per_frame_upload']['median']:.4f}"
                        for b, w in r["windows"].items()))
    if "host" in want:
        r = bench_host()
        out["host_celt_symbol"] = r
        log(f"native CELT symbol phase B={r['B']}: "
            f"{r['us_per_frame_by_threads']} "
            f"us/frame by threads")
    pools = {}
    for name in POOLS:
        if name not in want:
            continue
        r = pools[name] = bench_named_pool(name, repeats=args.repeats,
                                           device=dev)
        ph = {k: round(v["median"], 3)
              for k, v in r["phase_ms_per_step"].items()}
        log(f"pool {name} B={r['B']} K={r['K']}: "
            f"{r['streams']['median']:.1f} realtime streams (spread "
            f"{r['streams']['spread']:.3f}), {r['step_ms']['median']:.2f} "
            f"ms/step, phases ms/step {ph}")
    out["pools"] = pools
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
