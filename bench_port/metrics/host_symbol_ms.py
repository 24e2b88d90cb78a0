"""host_symbol_ms (ms/step): the pool's own host_symbol phase time
(StreamPool._phase_s["host_symbol"], the same dict stats()["phase_s"] copies;
read directly, since stats() flushes the pipeline), its growth over the
window over the window's steps. The program's span timer."""


def read(run):
    w = run.window
    return w.phase_s["host_symbol"] / w.steps * 1e3 if w.steps else None
