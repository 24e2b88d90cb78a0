"""realtime_streams (audio_s/s): seconds of audio (per stream, at 48 kHz)
handed to the caller inside the window, over the window's wall seconds:
all the work over all the time (the window ends on a whole K-frame
window). Host clock. The
arithmetic of the port's bench (esp32_opus_player_tpu_torch/bench.py::
bench_pool: audio seconds over wall seconds), taken over the window."""


def read(run):
    w = run.window
    return w.samples / 48000.0 / w.wall_s
