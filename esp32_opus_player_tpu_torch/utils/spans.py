"""The port's span recorder: where the host time of a pool goes.

One recorder per process (`recorder()`), so that it outlives a pool: the
pool and the library loaders open and close named spans on it where the
work happens, and a reader takes them afterwards without touching the
pool (`records`, `totals`; `StreamPool.stats()` flushes the pipeline,
this does not). Every time is `time.perf_counter()`, CLOCK_MONOTONIC on
Linux, the clock a device trace can be tied to.

A span has a name, a start, an end, its parent (the span open when it
opened), the pool step it belongs to (every span of one step shares it)
and a lane index (-1 outside a lane), and up to four numbers whose
meaning its name fixes (`ARGS`). Spans sit in a ring of `CAPACITY` slots
preallocated once (~8 MB); once the ring is full each new span takes the
oldest one's slot, `dropped` counts those, and `lost(t0)` says whether a
span that started at or after t0 was among them. Named counters sit
beside the spans (`count`, `counters`).

The names, per pool step (models/stream_pool.py):

    step                  one per StreamPool.step (and per _flush)
    host_symbol           StreamPool._phase_s["host_symbol"], same stamps
      symbol      [lane]  the lane's native batch call(s); ARGS below
    dispatch              _phase_s["dispatch"]
      stage       [lane]  the put/fill of one staging frame
        stage_wait [lane] the wait for the staging's last upload
      enqueue     [lane]  _Lane.dispatch: upload, K frame steps, PCM copy
    materialize           _phase_s["materialize"]
      fetch_wait  [lane]  _Window.host(): the wait for the window's PCM
      route       [lane]  the cut, trim and append of one pending step
    gc                    a collection (the hook `recorder()` installs)

and at set-up: `pool.build` (StreamPool.__init__) over `classify`,
`tables` and `lanes`; `load.native` and `load.cuda`, the build-or-load of
each library wherever it happens.

Spans are recorded from one thread at a time, the one that steps the
pool; the collector's spans only where that thread collects.
"""
from __future__ import annotations

import array
import contextlib
import gc
import math
import threading
import time
from typing import NamedTuple

import numpy as np

CAPACITY = 1 << 17
# what a span's numbers mean, by its name
ARGS = {
    # the strips of the native batch entries the span called: their
    # count, their summed CPU and the entries' summed wall seconds, and
    # the strips' wall capacity, sum over entries of strips x entry wall
    "symbol": ("strips", "cpu_s", "wall_s", "thread_s"),
    "gc": ("generation", "collected", "uncollectable"),
    "load.native": ("compiled",),
    "load.cuda": ("compiled",),
}
_NAN = float("nan")


class Span(NamedTuple):
    seq: int                # the span's number in the process
    name: str
    t0: float               # perf_counter seconds
    t1: float
    parent: int             # the parent's seq, -1 for none
    step: int               # the pool step, -1 outside one
    lane: int               # the lane index, -1 outside a lane
    args: dict              # ARGS[name] -> value


class Total(NamedTuple):
    count: int
    total_s: float          # the spans' summed durations
    self_s: float           # less the durations of their child spans


class Recorder:
    """A ring of spans and a dict of counters; see the module's text."""

    def __init__(self, capacity: int = CAPACITY):
        if capacity & (capacity - 1):
            raise ValueError("capacity must be a power of two")
        self.capacity = capacity
        self._mask = capacity - 1
        zeros = bytes(8 * capacity)
        self._t0 = array.array("d", zeros)
        self._t1 = array.array("d", zeros)
        self._parent = array.array("q", zeros)
        self._step = array.array("q", zeros)
        self._name = array.array("h", zeros[:2 * capacity])
        self._lane = array.array("h", zeros[:2 * capacity])
        self._args = [array.array("d", zeros) for _ in range(4)]
        self._ids: dict = {}
        self.names: list = []
        self._thread = threading.get_ident()
        self._gc_t0 = _NAN
        self.reset()

    def reset(self) -> None:
        """Forget every span and counter."""
        self.n = 0              # spans opened so far: the next seq
        self.dropped = 0
        self._lost_until = -math.inf
        self._stack: list = []
        self.counters: dict = {}
        np.frombuffer(self._t1, dtype=np.float64)[:] = _NAN

    # ---------------------------------------------------------- writing
    def _id(self, name: str) -> int:
        nid = self._ids[name] = len(self.names)
        self.names.append(name)
        return nid

    def _reuse(self, j: int) -> None:
        """Slot j's span is dropped for a new one."""
        self.dropped += 1
        if self._t0[j] > self._lost_until:
            self._lost_until = self._t0[j]
        self._t1[j] = _NAN

    def open(self, name: str, step: int = -1, lane: int = -1,
             t: float | None = None) -> int:
        """Open a span at `t` (default: now), a child of the span open
        now. Returns its seq, for `close`."""
        seq = self.n
        self.n = seq + 1
        j = seq & self._mask
        if seq > self._mask:
            self._reuse(j)
        self._t0[j] = time.perf_counter() if t is None else t
        nid = self._ids.get(name)
        self._name[j] = self._id(name) if nid is None else nid
        stack = self._stack
        self._parent[j] = stack[-1] if stack else -1
        self._step[j] = step
        self._lane[j] = lane
        stack.append(seq)
        return seq

    def close(self, seq: int, t: float | None = None,
              args: tuple | None = None) -> float:
        """Close span `seq` at `t` (default: now), with its numbers
        (`ARGS`), and any span opened inside it and left open (a raise).
        Returns the end time."""
        if t is None:
            t = time.perf_counter()
        stack = self._stack
        if stack and stack[-1] == seq:
            stack.pop()
        elif seq in stack:
            del stack[stack.index(seq):]
        else:
            return t
        if self.n - seq <= self.capacity:
            j = seq & self._mask
            self._t1[j] = t
            if args is not None:
                for a, v in zip(self._args, args):
                    a[j] = v
        return t

    @contextlib.contextmanager
    def span(self, name: str, step: int = -1, lane: int = -1):
        """`open` and `close` around a block (closed if it raises)."""
        seq = self.open(name, step, lane)
        try:
            yield seq
        finally:
            self.close(seq)

    def count(self, name: str, n: float = 1) -> None:
        """Add n to counter `name`."""
        self.counters[name] = self.counters.get(name, 0) + n

    def _gc(self, phase: str, info: dict) -> None:
        if threading.get_ident() != self._thread:
            return
        if phase == "start":
            self._gc_t0 = time.perf_counter()
            return
        t1 = time.perf_counter()
        parent = self._stack[-1] if self._stack else -1
        step = lane = -1
        if parent >= 0 and self.n - parent <= self.capacity:
            step = self._step[parent & self._mask]
            lane = self._lane[parent & self._mask]
        seq = self.open("gc", step, lane, self._gc_t0)
        self.close(seq, t1, (info.get("generation", -1),
                             info.get("collected", 0),
                             info.get("uncollectable", 0)))

    # ---------------------------------------------------------- reading
    def lost(self, t0: float) -> bool:
        """Whether a span that started at or after t0 was dropped."""
        return self._lost_until >= t0

    def _select(self, t0: float, t1: float):
        """(slots, seqs) of the closed spans inside [t0, t1], in seq
        order."""
        n, cap = self.n, self.capacity
        seqs = np.arange(max(0, n - cap), n, dtype=np.int64)
        slots = seqs & self._mask
        s0 = np.frombuffer(self._t0, dtype=np.float64)[slots]
        s1 = np.frombuffer(self._t1, dtype=np.float64)[slots]
        keep = (s0 >= t0) & (s1 <= t1)          # NaN ends (open) fail
        return slots[keep], seqs[keep]

    def records(self, t0: float = -math.inf,
                t1: float = math.inf) -> list:
        """The closed spans that lie inside [t0, t1], as `Span`s in the
        order they opened (a collection's at its end)."""
        slots, seqs = self._select(t0, t1)
        out = []
        for j, seq in zip(slots.tolist(), seqs.tolist()):
            name = self.names[self._name[j]]
            out.append(Span(seq, name, self._t0[j], self._t1[j],
                            self._parent[j], self._step[j], self._lane[j],
                            {k: self._args[i][j] for i, k in
                             enumerate(ARGS.get(name, ()))}))
        return out

    def totals(self, t0: float = -math.inf,
               t1: float = math.inf) -> dict:
        """{name: Total} over the closed spans inside [t0, t1]: their
        count, summed duration, and self time (less the durations of
        their children inside the same stretch)."""
        slots, seqs = self._select(t0, t1)
        if not slots.size:
            return {}
        dur = (np.frombuffer(self._t1, dtype=np.float64)[slots]
               - np.frombuffer(self._t0, dtype=np.float64)[slots])
        name = np.frombuffer(self._name, dtype=np.int16)[slots]
        parent = np.frombuffer(self._parent, dtype=np.int64)[slots]
        own = dur.copy()
        at = np.searchsorted(seqs, parent)
        at = np.minimum(at, seqs.size - 1)
        child = (parent >= 0) & (seqs[at] == parent)
        np.subtract.at(own, at[child], dur[child])
        out = {}
        for nid in np.unique(name).tolist():
            m = name == nid
            out[self.names[nid]] = Total(int(m.sum()), float(dur[m].sum()),
                                         float(own[m].sum()))
        return out


_lock = threading.Lock()
_recorder: Recorder | None = None


def recorder() -> Recorder:
    """The process's recorder, made on first use; it then hooks the
    collector (gc.callbacks) once, so that each collection is a span."""
    global _recorder
    with _lock:
        if _recorder is None:
            _recorder = Recorder()
            gc.callbacks.append(_recorder._gc)
        return _recorder
