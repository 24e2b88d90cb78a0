"""pool_build_s (s): the duration of the last `pool.build` span before
the window, the StreamPool's construction: the sources' parse and
classification, the packet tables, the lanes' host and device state,
and, in a checkout's first run, the native library's build inside it
(a `load.native` span). Part of setup_s. The program's own spans
(esp32_opus_player_tpu_torch/utils/spans.py); nothing where the program
records none, or dropped it."""


def read(run):
    try:
        from esp32_opus_player_tpu_torch.utils import spans
    except ImportError:
        return None
    builds = [s for s in spans.recorder().records(t1=run.window.t0)
              if s.name == "pool.build"]
    return builds[-1].t1 - builds[-1].t0 if builds else None
