"""The comparison that decides `correct`: each compared stream's PCM, as
the caller took it from the pool, against the plain reference decoding
the same packets from the stream's first one (bench_port/reference, a
frozen numpy decoder that imports nothing of the decoder under test).

Two numbers are held to their limits (CHECKS): the largest absolute
difference of any sample of any compared stream, and the frames the pool
owes (a frame of the reference with no PCM from the pool counts, as does
a stream that ends short). Both limits are 0: the configurations state
PCM bit-exact to the fixed-point reference decoder.

The reference runs in worker processes (spawn; numpy only, no torch, so
no worker touches the card), a stream to a task, longest first.
"""
from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import numpy as np

CHECKS = {"pcm_max_abs_diff": 0, "frames_missing": 0}
FRAME = 960                 # samples a packet at 48 kHz (20 ms)


def decode_stream(task) -> np.ndarray:
    """The reference PCM of one stream: (samples, channels) int16.

    task: dict(packets, discard, channels, compat, lost, fec, control).
    lost[k]: packet k was lost; fec: a lost packet whose next packet
    arrived is decoded from that packet's LBRR copy. control: run the
    reference in the control's lower precision (bench_port/control.py)."""
    if task.get("control"):
        from . import control
        with control.lower_precision():
            return decode_stream(dict(task, control=False))
    from .reference.models.opus_decoder import OpusDecoder
    dec = OpusDecoder(task["channels"], compat_ref=task["compat"])
    pkts, lost = task["packets"], task.get("lost")
    out = []
    for k, data in enumerate(pkts):
        if lost is not None and lost[k]:
            nxt = k + 1 < len(pkts) and not lost[k + 1]
            if task.get("fec") and nxt:
                pcm = dec.decode(pkts[k + 1], frame_size=FRAME,
                                 decode_fec=True)
            else:
                pcm = dec.decode(None, frame_size=FRAME)
        else:
            pcm = dec.decode(data)
        d = task["discard"][k] if k < len(task["discard"]) else 0
        out.append(np.asarray(pcm, dtype=np.int16)[d:])
    return np.concatenate(out) if out else np.zeros(
        (0, task["channels"]), dtype=np.int16)


def reference(tasks, workers: int) -> list:
    """decode_stream over `tasks`, in `workers` spawned processes (in this
    process when workers <= 1); results in task order."""
    if workers <= 1 or len(tasks) <= 1:
        return [decode_stream(t) for t in tasks]
    order = sorted(range(len(tasks)), key=lambda i: -len(tasks[i]["packets"]))
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=min(workers, len(tasks)),
                             mp_context=ctx) as ex:
        futs = {i: ex.submit(decode_stream, tasks[i]) for i in order}
        return [futs[i].result() for i in range(len(tasks))]


def compare(got: list, want: list) -> dict:
    """got, want: per compared stream (samples, channels) int16. Returns
    the checks' values and the frames compared and failed."""
    diff, missing, frames, failed = 0, 0, 0, 0
    for g, w in zip(got, want):
        n = min(len(g), len(w))
        nf = -(-len(w) // FRAME)
        short = -(-(len(w) - n) // FRAME)
        frames += nf
        missing += short
        if len(g) > len(w):               # PCM the reference has not
            failed += -(-(len(g) - n) // FRAME)
            diff = max(diff, 1, int(np.abs(g[n:].astype(np.int32)).max()))
        if n:
            d = np.abs(g[:n].astype(np.int32) - w[:n].astype(np.int32))
            per = d.reshape(d.shape[0], -1).max(axis=1)
            pad = (-n) % FRAME
            per = np.concatenate([per, np.zeros(pad, per.dtype)])
            bad = per.reshape(-1, FRAME).max(axis=1) > 0
            failed += int(bad.sum())
            diff = max(diff, int(d.max()))
        failed += short
    return dict(values={"pcm_max_abs_diff": diff, "frames_missing": missing},
                attempted=frames, failed=failed)


def correct(values: dict) -> bool:
    return all(values[k] <= lim for k, lim in CHECKS.items())


def check_lines(values: dict) -> list:
    return [f"check {k} {values[k]} limit {lim}" for k, lim in CHECKS.items()]


def checks_json(values: dict) -> dict:
    return {k: {"value": values[k], "limit": lim} for k, lim in CHECKS.items()}
