"""Where the time of the torch port's pools goes on one CUDA card.

Runs the pools of chip_smoke.py (2048 mono CELT streams in K = 64
windows, 1024 stereo CELT streams one frame at a time, 2048 mono WB
SILK streams in K = 64 windows, 48 mono NB/MB/WB SILK streams in K = 3
windows, three buckets of 16 rows, the 2048 WB streams again in RFC
mode with concealment, a tenth of the rows lost on every step, with
in-band FEC, and 2048 RFC-mode CELT streams over five fixtures of every
frame size in a stereo pool in K = 16 windows) on the card, each twice
in one
process: first plain, for the wall time of run() and the device time of
its windows (CUDA events), then under torch.profiler, for the card's
busy time (device time of every kernel and copy), the kernel launches
per frame step and the device time per kernel. A small pool runs first,
so kernel builds and lazy tables stay out of both. Run from the
repository root:

    python3 tools/profile_torch_pool.py [mono] [stereo] [silk] [silk_small]
        [silk_loss] [mixed] [--out DIR]

Prints one JSON line per pool; with --out, also writes the profiler's
per-kernel table for each pool to DIR/profile_<pool>.txt.
"""
import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
# pool: (fixtures, channels, streams, superstep_k[, mode]); mode "loss":
# RFC mode with concealment and a tenth lost; "rfc": RFC mode
POOLS = {
    "mono": (("celt_fb_mono_20ms", "celt_fb_mono_drums_20ms"), 1, 2048, 64),
    "stereo": (("celt_fb_stereo_20ms", "celt_fb_stereo_drums_20ms"), 2,
               1024, 1),
    "silk": (("silk_wb_mono_20ms", "silk_wb_fec_mono_20ms"), 1, 2048, 64),
    "silk_small": (("silk_nb_mono_20ms", "silk_mb_mono_20ms",
                    "silk_wb_mono_20ms"), 1, 48, 3),
    "silk_loss": (("silk_wb_mono_20ms", "silk_wb_fec_mono_20ms"), 1, 2048,
                  64, "loss"),
    "mixed": (("celt_fb_mono_5ms", "celt_fb_stereo_2p5ms",
               "celt_swb_stereo_10ms", "celt_nb_mono_20ms",
               "celt_fb_mono_20ms"), 2, 2048, 16, "rfc"),
}


def run_pool(names, channels: int, n: int, K: int, mode=None):
    """One pool of n streams (names[i % len(names)]) through
    StreamPool.run(); returns (pool, wall s of run). mode "loss": RFC
    mode with concealment, stream i losing packet k where i % 10 ==
    k % 10, with in-band FEC; "rfc": RFC mode."""
    import torch
    from esp32_opus_player_tpu_torch.models.stream_pool import StreamPool
    paths = [ROOT / "tests" / "fixtures" / f"{m}.opus" for m in names]
    lossy = mode == "loss"
    kw = dict(compat_ref=False, rfc_plc=True) if lossy else dict(
        compat_ref=mode != "rfc")
    pool = StreamPool([paths[i % len(paths)] for i in range(n)],
                      channels=channels, superstep_k=K, device="cuda", **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if lossy:
        pool.run(loss=lambda i, k: i % 10 == k % 10, fec=True)
    else:
        pool.run()
    torch.cuda.synchronize()
    return pool, time.perf_counter() - t0


def device_us(e) -> float:
    t = getattr(e, "self_device_time_total", None)
    return e.self_cuda_time_total if t is None else t


def profile(name: str, out: pathlib.Path | None) -> dict:
    import torch
    from torch.profiler import ProfilerActivity
    pool, wall = run_pool(*POOLS[name])
    win = pool.window_device_ms()
    steps = max(len(s.jobs) for s in pool.streams)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, prof_wall = run_pool(*POOLS[name])
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(device_us(e) for e in dev)
    kernels = [e for e in dev if not e.key.startswith(("Memcpy", "Memset"))]
    launches = sum(e.count for e in kernels)
    top = sorted(dev, key=device_us, reverse=True)[:12]
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)
        sort = ("self_device_time_total" if hasattr(dev[0],
                "self_device_time_total") else "self_cuda_time_total")
        (out / f"profile_{name}.txt").write_text(
            prof.key_averages().table(sort_by=sort, row_limit=40))
    return {
        "pool": name, "streams": POOLS[name][2],
        "superstep_k": POOLS[name][3], "frame_steps": steps,
        "wall_s": wall, "window_device_ms": sum(ms for _, ms in win),
        "profiled_wall_s": prof_wall, "busy_ms": busy_us / 1e3,
        "busy_ms_per_step": busy_us / 1e3 / steps,
        "launches_per_step": launches / steps,
        "idle_share_profiled_run": 1 - busy_us / 1e6 / prof_wall,
        "device": [{"name": e.key[:60], "calls": e.count,
                    "ms": device_us(e) / 1e3} for e in top],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("pools", nargs="*",
                    help=f"{', '.join(POOLS)} (default all)")
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args()
    args.pools = args.pools or list(POOLS)
    if not set(args.pools) <= set(POOLS):
        ap.error(f"pools are {', '.join(POOLS)}")
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_pool: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    card = card.strip().splitlines()[0]
    for names, channels, _, _, *mode in POOLS.values():  # builds, tables
        run_pool(names, channels, 4, 3, *mode)
    for name in args.pools:
        print(json.dumps({"card": card, **profile(name, args.out)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
