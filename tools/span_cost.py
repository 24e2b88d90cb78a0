"""What the pool's span recording costs the host: microseconds per lane
and step (esp32_opus_player_tpu_torch/utils/spans.py).

    python tools/span_cost.py [--steps 30] [--k 3] [--reps 200000]

A one-lane CPU pool (two looped stereo CELT streams, K-frame windows) is
stepped so that the recorder shows how many spans a lane-step records
(its collections included) and how many reads of the native strips'
times it makes; then the recorder's calls are timed in a loop on a
private Recorder: one open and close pair, and one read of the strips.
A lane-step costs the pair's time times its spans plus the read's time
times its reads. Prints one JSON line. A smaller K dispatches more
often, so K 3 counts more enqueue and stage_wait spans a step than a
K-64 window does.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import platform
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from esp32_opus_player_tpu_torch.host import native, opusfile  # noqa: E402
from esp32_opus_player_tpu_torch.models.stream_pool import \
    StreamPool  # noqa: E402
from esp32_opus_player_tpu_torch.utils import spans  # noqa: E402

SOURCE = ROOT / "bench_port" / "fixtures" / "celt_fb_stereo_20ms.opus"


def spans_per_lane_step(steps: int, k: int) -> tuple:
    """(spans, strip reads) a lane-step records, from a pool's run."""
    src = opusfile.parse_stream(SOURCE.read_bytes())
    src.jobs = src.jobs * -(-(steps + k) // len(src.jobs))    # looped
    pool = StreamPool([src] * 2, channels=2, superstep_k=k, device="cpu")
    for _ in range(k):                  # past the pipeline's fill
        pool.step()
    t0 = time.perf_counter()
    for _ in range(steps):
        pool.step()
    recs = spans.recorder().records(t0)
    n = steps * len(pool._lanes)
    return len(recs) / n, sum(s.name == "symbol" for s in recs) / n


def timed(fn, reps: int) -> float:
    """Seconds a call of fn, the best of five loops of `reps`."""
    best = float("inf")
    for _ in range(5):
        t = time.perf_counter()
        for i in range(reps):
            fn(i)
        best = min(best, (time.perf_counter() - t) / reps)
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--reps", type=int, default=200000)
    args = ap.parse_args(argv)
    n_spans, n_reads = spans_per_lane_step(args.steps, args.k)
    rec = spans.Recorder()
    pair = timed(lambda i: rec.close(rec.open("x", i, 0)), args.reps)
    read = timed(lambda i: native.take_strips(), args.reps)
    us = 1e6 * (n_spans * pair + n_reads * read)
    print(json.dumps(dict(
        us_per_lane_step=round(us, 3), spans_per_lane_step=n_spans,
        strip_reads_per_lane_step=n_reads, us_per_span=round(1e6 * pair, 4),
        us_per_strip_read=round(1e6 * read, 4), k=args.k,
        cpu=platform.processor() or platform.machine())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
