"""device_wait_ms (ms/step): the self time of the pool's `fetch_wait`
spans (the wait for a window's PCM on the card and its host view,
_Window.host()) and `stage_wait` spans (the wait for the staging
buffer's last upload before it is written again) inside the window, over
the window's steps: the host's time blocked on the card. The program's
own spans (esp32_opus_player_tpu_torch/utils/spans.py); nothing where
the program records none, or dropped some of the window's."""


def read(run):
    try:
        from esp32_opus_player_tpu_torch.utils import spans
    except ImportError:
        return None
    w, rec = run.window, spans.recorder()
    tot = rec.totals(w.t0, w.t0 + w.wall_s)
    if not w.steps or "step" not in tot or rec.lost(w.t0):
        return None
    wait = sum(tot[k].self_s for k in ("fetch_wait", "stage_wait")
               if k in tot)
    return wait / w.steps * 1e3
