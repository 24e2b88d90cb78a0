"""enqueue_ms (ms/window): the self time of the pool's `enqueue` spans
inside the window over their count: per K-frame window dispatched, the
host time of _Lane.dispatch, which uploads the staging, launches the K
frame steps and enqueues the PCM copy. Near the card's time for a window
(device_ms_per_frame x K) it says the enqueue waits on the card. The
program's own spans (esp32_opus_player_tpu_torch/utils/spans.py);
nothing where the program records none, or dropped some of the
window's."""


def read(run):
    try:
        from esp32_opus_player_tpu_torch.utils import spans
    except ImportError:
        return None
    w, rec = run.window, spans.recorder()
    tot = rec.totals(w.t0, w.t0 + w.wall_s)
    if "enqueue" not in tot or rec.lost(w.t0):
        return None
    return tot["enqueue"].self_s / tot["enqueue"].count * 1e3
