"""The control of the comparison: the plain reference put in the decoder's
place with one step computed in a lower precision, the step a later
change would be tempted to take: the CELT inverse MDCT's FFT in float32
(a library FFT in place of the fixed-point one, kernel K1) instead of
the fixed-point decoder's int32 butterflies. Every other step stays
exact. The configurations state PCM bit-exact to the fixed-point
decoder, so the comparison has to find the control not correct.

    python -m bench_port.control --workload NAME --seed N [N ...]
        --packets P [--seconds S]

For each seed: the cell's streams and compared sample as a run draws
them, each compared stream's first P packets (as many as a run of the
cell decodes: its log's "over P packets each"), decoded by the control
and by the reference, compared by the harness's own comparison. Needs
no card.
Prints one JSON line per seed and, last, a summary line.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys

import numpy as np


def _fft_f32(st, r, i_):
    """opus_fft_impl's result in float32: r, i_ hold the input in the
    plan's bit-reversed order and receive the unscaled DFT, rounded."""
    rev = np.asarray(st.bitrev)
    x = np.empty(len(r), dtype=np.complex64)
    x.real = r[rev]
    x.imag = i_[rev]
    y = np.fft.fft(x)
    if y.dtype != np.complex64:           # numpy < 2 computes in float64
        import torch
        y = torch.fft.fft(torch.from_numpy(x)).numpy()
    r[:] = np.rint(y.real.astype(np.float64)).astype(np.int64)
    i_[:] = np.rint(y.imag.astype(np.float64)).astype(np.int64)


@contextlib.contextmanager
def lower_precision():
    """The reference in the control's precision while the block runs."""
    from .reference.ops.celt import synthesis
    exact, synthesis.opus_fft_impl = synthesis.opus_fft_impl, _fft_f32
    try:
        yield
    finally:
        synthesis.opus_fft_impl = exact


def main(argv=None) -> int:
    from . import compare, generator, run, spec
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, nargs="+", required=True)
    ap.add_argument("--packets", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--root", default=".")
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload, args.root)
    tr = cell.traffic
    seconds = args.seconds or run.run_seconds(cell.root)
    steps = args.packets
    lows = []
    for seed in args.seed:
        plan = generator.plan(cell.config, tr, seed, seconds, cell.root)
        tasks = run.reference_tasks(plan, cell, steps)
        want = compare.reference(tasks, tr["compare_workers"])
        ctl = compare.reference([dict(t, control=True) for t in tasks],
                                tr["compare_workers"])
        res = compare.compare(ctl, want)
        lows.append(res["values"])
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "control_correct": compare.correct(res["values"]),
                          "frames": res["attempted"],
                          "failed": res["failed"], **res["values"]}),
              flush=True)
    print(json.dumps({"workload": cell.name, "seeds": args.seed,
                      "control_min": {k: min(v[k] for v in lows)
                                      for k in compare.CHECKS}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
