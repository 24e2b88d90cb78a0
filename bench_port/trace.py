"""The device trace of a measured window: torch.profiler (CUPTI) with the
CUDA activity only, so the host pays no per-operator cost, exported as a
Chrome trace and read back.

Busy time is the union of the intervals in which a kernel, copy or
memset ran (tools/profile_torch_pool.py sums the device times of every
kernel and copy and takes idle = 1 - busy / wall: on one stream the sum
is the union; the union is kept here so overlapping work is not counted
twice). The device clock is tied to the host's by a marker copy of
MARKER_BYTES enqueued on an idle card right after a host time stamp, so
each idle gap can be named by the host span it falls in.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import dataclass, field

MARKER_BYTES = 4099
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    # (name, start_s, dur_s, cat) on the host clock, of every device
    # event that overlaps the window
    events: list = field(repr=False)
    aligned: bool = True

    def kernels(self) -> list:
        """(name, seconds) of every kernel launch in the window."""
        return [(n, d) for n, _, d, c in self.events if c == "kernel"]

    def top_ops(self, n: int = 10) -> list:
        tot: dict = {}
        for name, _, dur, _ in self.events:
            key = short_name(name)
            tot[key] = tot.get(key, 0.0) + dur
        return sorted(([k, v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, t0: float, t1: float, spans, n: int = 10) -> list:
        """The n longest stretches of [t0, t1] with nothing on the device,
        each named by the host span its middle falls in."""
        gaps, cur = [], t0
        for a, b in _merged((s, s + d) for _, s, d, _ in self.events):
            if a > cur:
                gaps.append((cur, min(a, t1)))
            cur = max(cur, b)
            if cur >= t1:
                break
        if cur < t1:
            gaps.append((cur, t1))
        gaps = sorted((g for g in gaps if g[1] > g[0]),
                      key=lambda g: g[0] - g[1])[:n]
        out = []
        for a, b in gaps:
            mid = 0.5 * (a + b)
            label = next((lab for s, e, lab in spans if s <= mid < e),
                         "other")
            if not self.aligned:
                label = "unaligned"
            out.append([label, b - a])
        return out


def short_name(name: str) -> str:
    """A kernel's name without its argument list and return type."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    n = name.replace("(anonymous namespace)::", "")
    n = n[5:] if n.startswith("void ") else n
    return n.split("(")[0][:100]


def _merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Tracer:
    """Wraps the window: start() before it, stop() after it."""

    def __init__(self, device):
        self.device = device

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        buf = torch.zeros(MARKER_BYTES, dtype=torch.uint8).pin_memory()
        dst = torch.empty(MARKER_BYTES, dtype=torch.uint8, device=self.device)
        torch.cuda.synchronize(self.device)
        self.t_marker = time.perf_counter()
        dst.copy_(buf, non_blocking=True)
        torch.cuda.synchronize(self.device)

    def stop(self, t0: float, t1: float) -> DeviceTrace:
        """The trace of host interval [t0, t1] (perf_counter)."""
        import torch
        torch.cuda.synchronize(self.device)
        self.prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                raw = json.load(f)
        finally:
            os.unlink(path)
        evs = [e for e in raw.get("traceEvents", [])
               if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS]
        marker = [e for e in evs if e["cat"] == "gpu_memcpy"
                  and int(e.get("args", {}).get("bytes", -1)) == MARKER_BYTES]
        aligned = bool(marker)
        ts0 = marker[0]["ts"] if aligned else min(
            (e["ts"] for e in evs), default=0.0)
        host0 = self.t_marker if aligned else t0
        events = []
        for e in evs:
            if e is (marker[0] if aligned else None):
                continue
            s = host0 + (e["ts"] - ts0) / 1e6
            d = e.get("dur", 0) / 1e6
            if s < t1 and s + d > t0:
                events.append((e.get("name", "?"), s, d, e["cat"]))
        busy = sum(b - a for a, b in _merged(
            (max(s, t0), min(s + d, t1)) for _, s, d, _ in events))
        return DeviceTrace(window_s=t1 - t0, busy_s=busy, events=events,
                           aligned=aligned)
