"""symbol_cpu_pct (%): over the pool's `symbol` spans inside the window
(each lane's batched native symbol call), the CPU seconds of the native
entries' strips of rows over the strips' wall capacity, the sum over
entries of strips x the entry's wall seconds: 100 when every strip's
thread ran on a core from the entry's start to its end; lower where
strips were descheduled, or finished early and idled until the slowest
was done. The strips time themselves (host/native/batch_entry.cpp);
nothing where the program records none, or dropped some of the
window's."""


def read(run):
    try:
        from esp32_opus_player_tpu_torch.utils import spans
    except ImportError:
        return None
    w, rec = run.window, spans.recorder()
    if rec.lost(w.t0):
        return None
    sym = [s.args for s in rec.records(w.t0, w.t0 + w.wall_s)
           if s.name == "symbol"]
    cap = sum(a["thread_s"] for a in sym)
    if cap <= 0:
        return None
    return 100.0 * sum(a["cpu_s"] for a in sym) / cap
