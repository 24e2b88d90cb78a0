"""device_idle_pct (%): 100 * (1 - busy / window), busy the union of the
intervals in which a kernel, copy or memset ran on the card inside the
traced window (bench_port/trace.py). Device trace."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
