"""Run one cell of the benchmark of esp32_opus_player_tpu_torch once.

    python -m bench_port --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout (BENCHMARK.json there). The cell's
configuration and traffic mix give the streams (bench_port/generator.py);
the decoder's StreamPool is built, warmed up over a whole window, and
driven closed loop for at least S seconds, ending on a whole K-frame
window (bench_port/drive.py). With --trace 0 the result carries the cell's
end-to-end metrics, with --trace 1 its per-layer ones, read in a window
traced by torch.profiler (bench_port/trace.py). Each metric is read by
its own file, bench_port/metrics/<name>.py. Then the pool is freed and a
seeded sample of streams is compared with the plain reference
(bench_port/compare.py).

Prints progress on stderr, the compared numbers with their limits as
the last lines of stderr, and one JSON object as the last line of
stdout. Exits 1 without a result when there is no CUDA card (or fewer
than the cell asks for), or when a JAX module is loaded once the window
has closed.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

from . import compare, drive, generator, spec

FORBIDDEN = ("jax", "jaxlib", "flax", "esp32_opus_player_tpu")


def log(msg: str) -> None:
    print(f"# bench_port: {msg}", file=sys.stderr, flush=True)


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start_ticks / os.sysconf("SC_CLK_TCK")


def run_seconds(root) -> int:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return int(json.load(f)["run_seconds"])


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def reference_tasks(plan, cell, steps: int) -> list:
    """One reference task per compared stream: its first `steps` packets."""
    opts = dict(cell.config["pool"])
    opts.update(cell.traffic.get("pool", {}))
    tasks = []
    for i in plan.compare:
        pk = plan.packets(i)[:steps]
        tasks.append(dict(packets=pk, discard=plan.discard(i),
                          channels=opts["channels"],
                          compat=opts.get("compat_ref", True),
                          lost=None if plan.lost is None
                          else plan.lost[i, :steps].tolist(),
                          fec=plan.fec))
    return tasks


def shapes(cell) -> dict:
    """The shapes the kernels' counts take: the configuration's, and the
    rows of a frame step (every stream has a packet every step)."""
    return dict(cell.config["shapes"], B=int(cell.traffic["streams"]))


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_origin: float | None = None) -> dict:
    """One run of `cell`: the result object, `checks` its last key.
    t_origin: the process's start on the perf_counter clock (setup_s
    counts from it; default: this call)."""
    import torch
    if t_origin is None:
        t_origin = time.perf_counter()
    cuda = torch.device(device).type == "cuda"
    tr = cell.traffic
    plan = generator.plan(cell.config, tr, seed, seconds, cell.root)
    log(f"{cell.name}: {len(plan.src)} streams of {plan.length} packets, "
        f"comparing streams {plan.compare}")
    pool = drive.build_pool(plan, cell.config, tr, device)
    drain = drive.Drain(pool, plan.compare)
    sched = drive.Schedule(plan)
    drive.warm_up(pool, drain, sched, int(tr["warm_steps"]))
    drive.settle()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_origin
    log(f"setup {setup_s:.3f} s")
    tracer = None
    if trace and cuda:                # on the CPU: no device trace to read
        from .trace import Tracer
        tracer = Tracer(device)
        tracer.start()
    mark = pool._win_events[-1] if pool._win_events else None
    win = drive.offline(pool, drain, sched, seconds,
                        int(tr["superstep_k"]), trace)
    dtrace = tracer.stop(win.t0, win.t0 + win.wall_s) if tracer else None
    mem_peak = torch.cuda.max_memory_allocated() if cuda else 0
    events = list(pool._win_events)
    if mark is not None and any(e is mark for e in events):
        events = events[[e is mark for e in events].index(True) + 1:]
    win_ms = pool.window_device_ms() if cuda else []
    win_ms = win_ms[len(win_ms) - len(events):] if events else []
    pool.stats()                      # flushes: every step's PCM routed
    drain()
    steps_done = sched.k
    got = [drain.pcm(i, pool.channels) for i in plan.compare]
    del pool, drain
    if cuda:
        torch.cuda.empty_cache()
    run = SimpleNamespace(
        setup_s=setup_s, window=win, seconds=seconds,
        window_device_ms=win_ms, trace=dtrace, shapes=shapes(cell),
        kernel_counts=spec.kernel_counts(cell.dirs), log=log)
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        v = spec.metric_reader(cell.dirs, m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    log(f"window {win.wall_s:.3f} s, {win.steps} steps; comparing "
        f"{len(got)} streams over {steps_done} packets each")
    log("step ms " + drive.step_profile(win))
    t_ref = time.perf_counter()
    want = compare.reference(reference_tasks(plan, cell, steps_done),
                             int(tr["compare_workers"]))
    res = compare.compare(got, want)
    log(f"reference {time.perf_counter() - t_ref:.3f} s")
    out = dict(correct=compare.correct(res["values"]),
               attempted=res["attempted"], failed=res["failed"],
               metrics=metrics)
    dev = dict(platform="gpu" if cuda else "cpu",
               kind=torch.cuda.get_device_name() if cuda else "cpu",
               count=1, memory_peak_bytes=int(mem_peak))
    if dtrace is not None:
        dev.update(busy_s=dtrace.busy_s, window_s=dtrace.window_s)
        spans = drive.host_spans(win)
        out["breakdown"] = dict(
            device_ops=dtrace.top_ops(),
            idle_gaps=dtrace.idle_gaps(win.t0, win.t0 + win.wall_s, spans))
    out["device"] = dev
    out["checks"] = compare.checks_json(res["values"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_origin = time.perf_counter() - process_age_s()
    cell = spec.load_cell(args.workload, ".")
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"bench_port: {cell.name} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    log(f"card {power_limit()}")
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   t_origin=t_origin)
    bad = forbidden_modules()
    if bad:
        print(f"bench_port: JAX modules loaded in this process: {bad}",
              file=sys.stderr)
        return 1
    for line in compare.check_lines({k: v["value"]
                                     for k, v in out["checks"].items()}):
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0
