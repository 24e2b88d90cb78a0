"""setup_s (s): process start to the first timed step: interpreter and
torch start, the streams' generation, the pool's construction (and, in a
checkout's first run, the kernels' and the native library's builds),
and the warm-up steps, ended by a device synchronise. Host clock."""


def read(run):
    return run.setup_s
