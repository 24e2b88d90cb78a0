"""The system under test, driven: a StreamPool of esp32_opus_player_tpu_torch
built from a Plan with the pool's own defaults, warmed up, then stepped
closed loop through the measured window. The PCM is taken out of the
pool's public `pcm_out` after every step, as a caller consumes it; the
streams the comparison reads keep theirs.

Nothing here imports the port at module level: `import bench_port.drive`
stays cheap and CPU-only.
"""
from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np

PHASES = ("host_symbol", "dispatch", "materialize")


def pool_sources(plan, config: dict):
    """The pool's per-stream sources: the port's own parse of each source
    (checked against the benchmark's demux, packet for packet), looped,
    each stream the slice of the loop from its start packet on."""
    from esp32_opus_player_tpu_torch.host import opusfile
    loops = []
    for name, path, src in zip(plan.names, plan.paths, plan.sources):
        s = opusfile.parse_stream(path.read_bytes())
        got = tuple(j.data for j in s.jobs)
        if got != src.packets:
            raise RuntimeError(f"{name}: the decoder under test reads other "
                               "packets than the benchmark's demux")
        n = len(s.jobs)
        copies = -(-(n + plan.length) // n)
        jobs = [dataclasses.replace(j, discard_front=j.discard_front
                                    if c == 0 else 0, trim_end=0)
                for c in range(copies) for j in s.jobs]
        loops.append((s, jobs))
    out = []
    for i in range(len(plan.src)):
        s, jobs = loops[plan.src[i]]
        st = int(plan.start[i])
        out.append(dataclasses.replace(s, jobs=jobs[st:st + plan.length]))
    return out


def build_pool(plan, config: dict, traffic: dict, device):
    """The pool of the plan's streams, with the configuration's and the
    mix's pool options and the pool's defaults for everything else."""
    from esp32_opus_player_tpu_torch.models.stream_pool import StreamPool
    opts = dict(config["pool"])
    opts.update(traffic.get("pool", {}))
    channels = opts.pop("channels")
    return StreamPool(pool_sources(plan, config), channels=channels,
                      superstep_k=int(traffic["superstep_k"]),
                      device=device, **opts)


class Drain:
    """Takes every stream's PCM out of the pool: counts its samples (at
    48 kHz, per stream) and keeps the chunks of the streams in `keep`."""

    def __init__(self, pool, keep):
        self.pool = pool
        self.keep = {int(i): [] for i in keep}
        self.samples = 0

    def __call__(self) -> None:
        out = self.pool.pcm_out
        n = 0
        for chunks in out:
            for c in chunks:
                n += c.shape[0]
        for i, kept in self.keep.items():
            kept.extend(out[i])
        for chunks in out:
            chunks.clear()
        self.samples += n

    def pcm(self, i: int, channels: int) -> np.ndarray:
        kept = self.keep[i]
        return np.concatenate(kept) if kept else np.zeros(
            (0, channels), dtype=np.int16)


class Schedule:
    """Which packets of step k are lost (and which of those take the next
    packet's LBRR copy), from the plan; every stream is at packet k."""

    def __init__(self, plan):
        self.lost = plan.lost
        self.fec = plan.fec
        self.k = 0

    def next(self):
        k, self.k = self.k, self.k + 1
        if self.lost is None:
            return None, None
        lost = np.nonzero(self.lost[:, k])[0]
        fec = None
        if self.fec and k + 1 < self.lost.shape[1]:
            fec = lost[~self.lost[lost, k + 1]]
        return lost.tolist(), (None if fec is None else fec.tolist())


def _step(pool, sched) -> None:
    lost, fec = sched.next()
    if not pool.step(lost, fec):
        raise RuntimeError("the streams ended before the window did")


def settle() -> None:
    """After set-up: collect its garbage once and move every object it
    made (the streams' packet records, the pool's tables) out of the
    cyclic collector's reach. Full collections over those objects, which
    otherwise fall into the window at moments that differ from run to
    run, are then not part of what the window measures."""
    gc.collect()
    gc.freeze()


def warm_up(pool, drain, sched, steps: int) -> None:
    for _ in range(steps):
        _step(pool, sched)
        drain()


@dataclasses.dataclass
class Window:
    wall_s: float           # the window's length, host clock
    t0: float               # its start (perf_counter)
    steps: int              # pool steps inside it
    samples: int            # samples handed to the caller inside it
    phase_s: dict           # the pool's phase seconds spent inside it
    records: list           # per step (start, end, drained, phases after)
    ph_start: tuple         # the pool's phase seconds at the start
    step_s: list            # each step's host time, start to drained


def _phases(pool):
    ph = pool._phase_s
    return tuple(ph[k] for k in PHASES)


def offline(pool, drain, sched, seconds: float, window_k: int,
            record: bool) -> Window:
    """Steps back to back (closed loop: every stream always has its next
    packet) until `seconds` have passed and the steps make a whole number
    of K-frame windows, so that every run holds as many of the steps
    that dispatch a window and fetch its PCM as its length gives."""
    rec, dur = [], []
    ph0, s0 = _phases(pool), drain.samples
    steps = 0
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        _step(pool, sched)
        te = time.perf_counter()
        drain()
        steps += 1
        td = time.perf_counter()
        dur.append(td - ts)
        if record:
            rec.append((ts, te, td, _phases(pool)))
        if td - t0 >= seconds and steps % window_k == 0:
            break
    wall = time.perf_counter() - t0
    ph1 = _phases(pool)
    return Window(wall, t0, steps, drain.samples - s0,
                  {k: b - a for k, a, b in zip(PHASES, ph0, ph1)},
                  rec, ph0, dur)


def step_profile(win: Window) -> str:
    """The window's step times: median, 90th percentile and largest, and
    the median of each quarter of the window (ms)."""
    d = np.asarray(win.step_s) * 1e3
    q = np.array_split(d, 4)
    return (f"median {np.median(d):.3f} p90 {np.percentile(d, 90):.3f} "
            f"max {d.max():.3f}; by quarter "
            + " ".join(f"{np.median(x):.3f}" for x in q if x.size))


def host_spans(win: Window) -> list:
    """(start, end, label) host spans of the window, from the per-step
    records: a step's phases in the order step() runs them (one lane:
    its symbol phase, its staging and dispatch, then the routing of an
    older step), the caller's take of the PCM, and the loop between."""
    spans, prev_end, prev_ph = [], win.t0, win.ph_start
    for ts, te, td, ph in win.records:
        hs, disp, mat = (b - a for a, b in zip(prev_ph, ph))
        if ts > prev_end:
            spans.append((prev_end, ts, "loop"))
        a = min(ts + hs, te)
        b = min(a + disp, te)
        m = max(b, te - mat)
        spans += [(ts, a, "host_symbol"), (a, b, "dispatch"),
                  (b, m, "host_symbol"), (m, te, "materialize"),
                  (te, td, "consume")]
        prev_end, prev_ph = td, ph
    return spans
