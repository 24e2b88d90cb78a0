"""Lossy VoIP traffic on the CPU: the pool against the reference, stream by
stream, over many seeds, to find where (if anywhere) they part.

    python -m bench_port.lossy_voip_probe [--seeds 200] [--first 0]
        [--also 1386869985] [--streams 16] [--packets 120]
        [--workers 6] [--device cpu] [--ref-workers 1]

The traffic is the mix kept for the lossy VoIP cell
(traffic/live_k1_loss.json: 10 % of packets lost in Gilbert runs of 2.5
on average, RFC-mode conceal, in-band FEC where the next packet arrived)
over the voip_hybrid_swb_mono configuration's sources, from the
harness's own generator, at a small size: `streams` streams of `packets`
packets, one step a tick (K 1). Each stream starts at a seeded packet of
its looped 100-packet source, so most streams cross the loop's seam. The
decoder's StreamPool runs on `device` (cpu: the kernels' plain versions;
cuda: the card), every stream's PCM is compared with the reference
(bench_port/compare.py) frame by frame. Prints one JSON line per seed
(each stream that differs: its first differing frame, the largest
difference, the losses and seams around it) and a summary line.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import sys
from concurrent.futures import ProcessPoolExecutor
from types import SimpleNamespace

import numpy as np

FRAME = 960


def _cell(root):
    from . import spec
    config, traffic = spec.load_parts("voip_hybrid_swb_mono", "live_k1_loss")
    return SimpleNamespace(config=config, traffic=traffic, root=root)


def probe_seed(seed: int, streams: int, packets: int, device: str,
               root: str, ref_workers: int = 1) -> dict:
    import torch
    torch.set_num_threads(1)
    from . import compare, drive, generator, run
    cell = _cell(root)
    cell.traffic = dict(cell.traffic, streams=streams,
                        compare_streams=streams, superstep_k=1)
    plan = generator.plan(cell.config, cell.traffic, seed, 0, root,
                          length=packets)
    pool = drive.build_pool(plan, cell.config, cell.traffic, device)
    drain = drive.Drain(pool, range(streams))
    sched = drive.Schedule(plan)
    for _ in range(packets):
        drive._step(pool, sched)
        drain()
    pool.stats()
    drain()
    got = [drain.pcm(i, 1) for i in range(streams)]
    want = compare.reference(run.reference_tasks(plan, cell, packets),
                             ref_workers)
    bad = []
    for i, (g, w) in enumerate(zip(got, want)):
        n = min(len(g), len(w))
        d = np.abs(g[:n, 0].astype(np.int32) - w[:n, 0].astype(np.int32))
        lead = FRAME - sum(plan.discard(i))      # samples of packet 0
        if len(g) == len(w) and not d.any():
            continue
        first = int(np.nonzero(d)[0][0]) if d.any() else n
        k = 0 if first < lead else 1 + (first - lead) // FRAME
        src = plan.sources[plan.src[i]]
        seam = [j for j in range(packets)
                if (int(plan.start[i]) + j) % len(src.packets) == 0]
        lost = plan.lost[i]
        lo = max(0, k - 6)
        bad.append(dict(
            stream=i, source=plan.names[plan.src[i]],
            start=int(plan.start[i]), first_packet=k,
            max_diff=int(d.max()) if d.size else None,
            len_got=len(g), len_want=len(w),
            lost_around=[int(j) for j in range(lo, min(packets, k + 3))
                         if lost[j]],
            fec_taken=[int(j) for j in range(lo, min(packets, k + 3))
                       if lost[j] and j + 1 < packets and not lost[j + 1]],
            seams=seam, lost=[int(j) for j in np.nonzero(lost)[0]]))
    return dict(seed=seed, streams=streams, packets=packets,
                lost_share=float(plan.lost.mean()), differ=bad)


def main(argv=None) -> int:
    import os
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=200)
    ap.add_argument("--first", type=int, default=0)
    ap.add_argument("--also", type=int, nargs="*", default=[1386869985])
    ap.add_argument("--streams", type=int, default=16)
    ap.add_argument("--packets", type=int, default=120)
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--ref-workers", type=int, default=1,
                    help="processes for the reference of one seed (with "
                         "--workers 1, as on the card)")
    args = ap.parse_args(argv)
    root = os.getcwd()
    seeds = list(args.also) + list(range(args.first,
                                         args.first + args.seeds))
    n_bad, streams_bad = 0, 0
    kw = (args.streams, args.packets, args.device, root, args.ref_workers)
    if args.workers <= 1:
        results = (probe_seed(s, *kw) for s in seeds)
    else:
        ex = ProcessPoolExecutor(args.workers,
                                 mp_context=multiprocessing.get_context(
                                     "spawn"))
        results = ex.map(probe_seed, seeds, *[[a] * len(seeds) for a in kw])
    try:
        for r in results:
            print(json.dumps(r), flush=True)
            n_bad += bool(r["differ"])
            streams_bad += len(r["differ"])
    finally:
        if args.workers > 1:
            ex.shutdown(wait=True)
    print(json.dumps(dict(seeds=len(seeds), seeds_differ=n_bad,
                          streams_differ=streams_bad,
                          streams=args.streams, packets=args.packets,
                          device=args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
