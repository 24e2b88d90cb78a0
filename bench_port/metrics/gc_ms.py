"""gc_ms (ms/step): the time of the collector's `gc` spans inside the
window (each collection the process's main thread ran, every
generation), over the window's steps. The program's recorder hooks the
collector (esp32_opus_player_tpu_torch/utils/spans.py); nothing where
the program records no spans, or dropped some of the window's; 0 where
no collection ran."""


def read(run):
    try:
        from esp32_opus_player_tpu_torch.utils import spans
    except ImportError:
        return None
    w, rec = run.window, spans.recorder()
    tot = rec.totals(w.t0, w.t0 + w.wall_s)
    if not w.steps or "step" not in tot or rec.lost(w.t0):
        return None
    gc = tot.get("gc")
    return (gc.total_s if gc else 0.0) / w.steps * 1e3
