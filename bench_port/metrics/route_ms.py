"""route_ms (ms/step): the self time of the pool's `route` spans inside
the window, over the window's steps: the cut of each retired step's
frames per stream, their trim and their append (StreamPool._route), the
part of materialize_ms that is not the wait for the card. The program's
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
    route = tot.get("route")
    return (route.self_s if route else 0.0) / w.steps * 1e3
