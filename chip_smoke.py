#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on an NVIDIA card and check it.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; there is no CPU path):
1. the card: name, count, `nvidia-smi` name and power limit;
2. build the hand-written kernels from csrc/ (prints ptxas -v);
3. each kernel against its plain torch twin on the card at the main
   path's width (B = 2048 streams), bit for bit, and both timed: as
   device time (one call captured in a CUDA graph, replayed) and as
   eager stream time;
4. the slice, through StreamPool.run(): a mono pool of 2048 streams in
   K = 64 windows and a stereo pool of 1024 streams per frame, every
   stream bit-equal to tests/golden, with every kernel's launch count
   from that run; then a small pool with packet loss, card against CPU;
5. one JSON line of per-kernel results, and last the line
   {"ok": true, "device": {...}}.
"""
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
B = 2048
DBS, OV = 2048, 120


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def eager_ms(fn, reps: int) -> float:
    """Mean stream time of fn() called reps times back to back, CUDA
    events: what an eager caller pays, host launch overhead included."""
    import torch
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def device_ms(fn, reps: int) -> float:
    """Mean device time of one fn() call: fn is captured once into a
    CUDA graph and the graph replayed reps times between CUDA events, so
    host launch overhead stays out of the number."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                          # lazy tables and allocations first
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        graph.replay()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def timings(fn, plain, reps: int) -> dict:
    """Kernel and plain version, each as device time (CUDA graph) and as
    eager stream time."""
    return dict(ms=device_ms(fn, reps), plain_ms=device_ms(plain, 3),
                eager_ms=eager_ms(fn, reps), plain_eager_ms=eager_ms(plain,
                                                                     3))


def report(card, what, t) -> None:
    print(f"[{card}] {what}: bit-equal to the plain version; device time "
          f"(CUDA graph) kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f}"
          f" ms; eager stream time kernel {t['eager_ms']:.4f} ms, plain "
          f"{t['plain_eager_ms']:.4f} ms")


def max_err(got, want) -> int:
    return int((got.long() - want.long()).abs().max())


def check_kernels(dev, card):
    """Phase 3: every kernel against its twin at B = 2048 (bit-equal),
    and both timed at the main path's shapes."""
    import numpy as np
    import torch
    from esp32_opus_player_tpu_torch.ops.celt.comb import (
        comb_filter_step_T, comb_filter_step_T_ref)
    from esp32_opus_player_tpu_torch.ops.celt.deemph import (
        deemphasis_T, deemphasis_T_ref)
    from esp32_opus_player_tpu_torch.ops.celt.fft import (fft_blocks,
                                                          fft_blocks_ref)
    rng = np.random.default_rng(2024)

    def t32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)

    res = {}
    # K1: all 7 plans (LM 3-0 x transient); LM 3 runs (0, 1) and (3, 8)
    err = 0
    freq = t32(rng.integers(-(1 << 24), 1 << 24, (960, B)))
    for shift, Bblk in [(0, 1), (3, 8), (1, 1), (3, 4), (2, 1), (3, 2),
                        (3, 1)]:
        got = fft_blocks(freq, shift, Bblk)
        want = fft_blocks_ref(freq, shift, Bblk)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                             want[1])):
            raise SystemExit(f"K1 plan ({shift}, {Bblk}) differs from its "
                             f"twin: {max_err(got[0], want[0])}")
        err = max(err, max_err(got[0], want[0]), max_err(got[1], want[1]))
    both = [(0, 1), (3, 8)]
    res["K1"] = dict(max_abs_err=err, **timings(
        lambda: [fft_blocks(freq, s, b) for s, b in both],
        lambda: [fft_blocks_ref(freq, s, b) for s, b in both], 20))
    report(card, f"K1 fft_blocks, all 7 plans; timed: both LM-3 plans, "
           f"B={B}", res["K1"])

    # K2: lags 15..1024, both regions of a 960-sample frame
    def params():
        v = [rng.integers(15, 1025, B), rng.integers(15, 1025, B),
             rng.integers(0, 32768, B), rng.integers(0, 32768, B),
             rng.integers(0, 3, B), rng.integers(0, 3, B)]
        v[0][:8] = v[1][:8] = 15
        v[2][8:16] = v[3][8:16] = 0            # no-op rows
        v[3][16:24] = 0                        # g1 = 0 rows
        return tuple(t32(a) for a in v)
    c1, c2 = params(), params()
    buf = t32(rng.integers(-(1 << 26), 1 << 26, (DBS + OV, B)))
    want = comb_filter_step_T_ref(buf.clone(), DBS - 960, 960, c1, c2)
    got = comb_filter_step_T(buf.clone(), DBS - 960, 960, c1, c2)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise SystemExit(f"K2 differs from its twin: {max_err(got, want)}")
    work = buf.clone()
    res["K2"] = dict(max_abs_err=max_err(got, want), **timings(
        lambda: comb_filter_step_T(work, DBS - 960, 960, c1, c2),
        lambda: comb_filter_step_T_ref(work, DBS - 960, 960, c1, c2), 20))
    report(card, f"K2 comb_filter_step_T, N=960, B={B}", res["K2"])

    # K3: CC 1 (B = 2048, the mono pool) and CC 2 (B = 1024, stereo)
    err = 0
    for CC, nb in [(1, B), (2, B // 2)]:
        dm = t32(rng.integers(-(1 << 28), 1 << 28, (CC, DBS + OV, nb)))
        mem = t32(rng.integers(-(1 << 20), 1 << 20, (nb, CC)))
        syn = dm[:, DBS - 960:DBS]
        got = deemphasis_T(syn, mem)
        want = deemphasis_T_ref(syn, mem)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                             want[1])):
            raise SystemExit(f"K3 CC={CC} differs from its twin")
        err = max(err, max_err(got[0], want[0]), max_err(got[1], want[1]))
        t = timings(lambda: deemphasis_T(syn, mem),
                    lambda: deemphasis_T_ref(syn, mem), 20)
        report(card, f"K3 deemphasis_T, CC={CC}, B={nb}", t)
        if CC == 1:
            res["K3"] = t
    res["K3"]["max_abs_err"] = err
    return res


def golden(name):
    import numpy as np
    return np.fromfile(ROOT / "tests" / "golden" / f"{name}.pcm",
                       dtype=np.int16).reshape(-1, 2)


def run_pool(dev, card, channels, n, K):
    """Phase 4: one pool through StreamPool.run(), every stream held
    against tests/golden."""
    import numpy as np
    import torch
    from esp32_opus_player_tpu_torch.models.stream_pool import StreamPool
    kind = "mono" if channels == 1 else "stereo"
    names = [f"celt_fb_{kind}_20ms", f"celt_fb_{kind}_drums_20ms"]
    paths = [ROOT / "tests" / "fixtures" / f"{m}.opus" for m in names]
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    pool = StreamPool([paths[i % 2] for i in range(n)], channels=channels,
                      superstep_k=K, device=dev)
    t1 = time.perf_counter()
    outs = pool.run()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    frames = int(sum(len(p.jobs) for p in pool.streams))
    gold = [golden(m) for m in names]
    for i, out in enumerate(outs):
        g = gold[i % 2]
        if channels == 1:
            out = np.repeat(out, 2, axis=1)
        m = min(len(out), len(g))
        if m < 90000 or not np.array_equal(out[:m], g[:m]):
            raise SystemExit(f"{kind} pool stream {i} ({names[i % 2]}) "
                             f"differs from tests/golden")
    win = pool.window_device_ms()
    dev_ms = sum(ms for _, ms in win)
    fps = frames / (t2 - t1)
    print(f"[{card}] {kind} pool B={n} K={K}: all {n} streams bit-equal to "
          f"tests/golden; {frames} frames; setup {t1 - t0:.3f} s; run "
          f"{t2 - t1:.3f} s wall = {fps:.1f} frames/s = "
          f"{fps * 0.02:.1f} realtime streams; device {dev_ms:.3f} ms in "
          f"{len(win)} windows = {dev_ms / len(win):.3f} ms/window, "
          f"{dev_ms / (frames / n):.4f} ms/frame step; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB")


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from esp32_opus_player_tpu_torch.ops import _build
    from esp32_opus_player_tpu_torch.ops.celt import comb, deemph, fft
    dev = torch.device("cuda")
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    card = card_line()
    print(f"device: {kind} x {count}")
    print(card)

    t0 = time.perf_counter()
    _build.lib()
    print(f"kernels built in {time.perf_counter() - t0:.3f} s "
          f"({_build.library_path()})")
    for line in _build.ptxas_log.splitlines():
        if "Compiling entry" in line or "Used" in line:
            print("  " + line.strip())

    res = check_kernels(dev, card)

    wrappers = {"K1": fft.fft_blocks, "K2": comb.comb_filter_step_T,
                "K3": deemph.deemphasis_T}
    for w in wrappers.values():
        w.launches = 0
    run_pool(dev, card, channels=1, n=B, K=64)
    run_pool(dev, card, channels=2, n=B // 2, K=1)
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"[{card}] main-path launches: {launches}")
    for k, v in launches.items():
        if v <= 0:
            raise SystemExit(f"{k} was never launched on the main path")

    from esp32_opus_player_tpu_torch.models.stream_pool import StreamPool
    src = [ROOT / "tests" / "fixtures" / f"celt_fb_mono{d}_20ms.opus"
           for d in ("", "_drums")] * 2
    loss = lambda i, k: (3 * i + k) % 5 == 0
    a, b = (StreamPool(src, superstep_k=3, device=d).run(loss=loss)
            for d in (dev, "cpu"))
    if not all(np.array_equal(x, y) for x, y in zip(a, b)):
        raise SystemExit("lossy pool: card and CPU differ")
    print("lossy pool (4 streams, K=3, every 5th packet lost): card == CPU")

    meta = {
        "K1": ("celt_fft_blocks", "esp32_opus_player_tpu_torch/csrc/"
               "celt_fft.cu", "esp32_opus_player_tpu/ops/celt/"
               "pallas_fft.py:311"),
        "K2": ("celt_comb_step", "esp32_opus_player_tpu_torch/csrc/"
               "celt_comb.cu", "esp32_opus_player_tpu/ops/celt/"
               "pallas_comb.py:237"),
        "K3": ("celt_deemph", "esp32_opus_player_tpu_torch/csrc/"
               "celt_deemph.cu", "esp32_opus_player_tpu/ops/celt/"
               "jax_synthesis_T.py:162"),
    }
    kernels = [dict(name=n, route="cuda", source=s, replaces=r,
                    launches=launches[k], **res[k])
               for k, (n, s, r) in meta.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
