#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on an NVIDIA card and check it.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; there is no CPU path):
1. the card: name, count, `nvidia-smi` name, power limit and SM clock;
2. build the hand-written kernels from csrc/ (prints ptxas -v: each
   kernel's registers, shared memory and spills);
3. each kernel against its plain torch version on the card at the main
   paths' shapes, bit for bit (tolerance 0: int32 fixed point), and both
   timed: as device time (one call captured in a CUDA graph, replayed)
   and as eager stream time; beside each, its bound (the least time the
   card could take for the same work, from this run's inputs). K1 as
   its bare entry over all 7 plans and as its fused entry (what the
   frame step runs: each stream's own plan, the TDAC and the decode_mem
   stores as its epilogue) at LM 0-3, B 2048, 1024 and ragged widths,
   with no stream, every stream, every 3rd or a seeded random set
   transient, timed beside the chain it replaced. The tiled kernels,
   K2, K3, K6-K9, are first held at widths that leave their tiles
   ragged (K3 at every downsample factor), K2, K7 and K8 at the lag
   edges, K6-K9 also on misaligned column slices; K3 is timed at both
   paths' shapes (CC 1, B 2048 and CC 2, B 1024); K2 and K3 also at the
   frames of 2.5, 5 and 10 ms (N 120, 240, 480, B 2048); K4 (the comb
   with the deemphasis as its epilogue) at N 960, 480, 240 and 120, B
   2048, each beside K2 then K3 on the same inputs, and at ragged
   widths, both lag edges and a block of no-op streams; K6 as its bare
   entry and as its fused one (the resampler's FIR as its epilogue, what the
   SILK pools launch), beside the chain the fused entry replaced. P1,
   the CELT pitch conceal, is float32: it is held to its plain version
   at the bounds PLC_TOL (T equal on every row) on seeded lanes of 2048
   columns (CC 1 and 2, 205 and 7 rows, first and repeated conceals,
   both pitch clamps), and bit-identical to itself for a row alone and
   among 205; timed at 205 rows, CC 1 and 2. K1's fused entry, K2 and
   K3 are also timed at the mixed-LM pool's lane widths ((LM, rows) (0,
   410), (1, 410), (2, 410), (3, 818)). K5 is held and timed at (B, n,
   order) (16, 40, 10), (16, 60, 10), (16, 80, 16) (the 48-stream SILK
   pool's buckets), (16, 320, 16) (the JAX conceal frame's) and (2048,
   320, 16). The bounds of K5 and of K7-K9's LPC walks take the LPC
   chain (LPC_CHAIN_CYCLES a sample), as K3's and K4's take the
   deemphasis chain. S1, the stereo unmix, at ragged widths (1, 9, 1023
   and 2048 rows), fs 8, 12 and 16, 10 and 20 ms frames, predictors at
   the Q13 and int16 extremes, timed at the stereo WB pool's shape (B
   1024, frame 320) and at B 2048; K7 and K8 are held at nb 2 (10 ms)
   too, and K9 at a 10 ms WB frame;
4. the CELT path through StreamPool.run(): a mono pool of 2048 streams in
   K = 64 windows and a stereo pool of 1024 streams per frame, every
   stream bit-equal to tests/golden; then a small CELT pool with packet
   loss, card against CPU; then RFC-mode CELT at every frame size and
   below fullband: 2048 streams over five fixtures (2.5, 5, 10, 20 ms;
   NB, SWB, FB; mono and stereo) in a stereo pool in K = 16 windows,
   one lane per (LM, coded channels), every stream bit-equal to a CPU
   pool of one stream per fixture; then entry()'s function (the
   row-layout step, K1-K3 behind transposes) at B 8 and 2048 against
   its plain version on the CPU. Every wrapper's launch count is set to
   0 just before each path (each pool, each entry() run) and read just
   after; each path prints the launches it made, and the slice's paths
   (the mixed pool, entry()) must have launched K1's fused entry, K2
   and K3. One call of K1's
   fused entry in each of the two large pools is kept (the first with a
   transient stream) and, after the pools, held and timed again on those
   inputs (the fixtures' own flags). Then the concealing CELT pools
   (RFC mode, rfc_plc=True: P1 in each window frame, the noise branch
   through the frames' normal steps), each held frame by frame to a CPU
   pool of its 10 distinct (fixture, loss) streams: 2048 mono streams
   in K = 64 windows losing a tenth of their packets, 1024 stereo
   streams in K = 16 windows with 8-frame bursts besides, and the
   mixed-LM pool above with a tenth lost (its 2.5, 5 and 10 ms lanes
   conceal by the noise branch only, bit-equal; its 20 ms streams are
   mono in a stereo pool); one P1 call of each is kept and held and
   timed again after the pools;
5. the mono SILK path: a 2048-stream WB pool in K = 64 windows (one
   device bucket of 2048 rows: kernels K7 and K6's fused entry) and a
   48-stream pool over the NB, MB and WB fixtures in K = 3 windows
   (buckets of 16 rows: K7, at every width on the card, and K6's fused
   entry), every stream bit-equal to tests/golden and the small pool
   equal between card and CPU;
6. the lossy mono SILK path: 2048 WB streams in K = 64 windows, RFC mode
   with concealment (rfc_plc), a tenth of the rows lost on every step,
   once without and once with in-band FEC; no golden exists for RFC
   concealment, so the 20 distinct (fixture, loss phase) streams run
   first as a CPU pool and every card stream is held to its twin among
   them (K7, K6, K8 and K9 run here). Then compat
   loss (every 7th packet) on the card against the reference's
   tests/golden/silk_wb_mono_20ms.loss7.pcm;
7. stereo SILK and hybrid (check_stereo_hybrid_paths): compat pools of
   1024 stereo SILK (NB and WB), 2048 mono hybrid and 1024 stereo hybrid
   streams, K = 64, bit-equal to tests/golden; RFC pools of 10, 40 and 60
   ms stereo and mono SILK, 10 ms mono and stereo hybrid, each held to a
   CPU pool of one stream a fixture; a lossy stereo SILK and a lossy mono
   hybrid pool (rfc_plc, FEC, a tenth lost) held to their 20 CPU twins;
   each must have launched its kernels (S1 on every stereo pool);
8. the scalar route (check_scalar_route): a chained and a mode-switching
   stream beside a CELT lane and a 5.1 multistream row, bit-equal to
   tests/golden; a lossy RFC mode-switching row whose lost CELT frames
   launch P1 at one row from the scalar decoder, held to its CPU twin at
   P1's bounds; its wall seconds and frames printed;
9. one JSON line of per-kernel results (all nine kernels, P1 and S1,
   which have no pl.pallas_call: they replace jax_plc.celt_plc_core and
   jax_stereo.ms_to_lr_batch; K1's row is
   its fused entry, with its bare entry beside it; K4, the fused comb +
   deemphasis, is held to its plain version and timed beside K2 + K3
   but, as in the JAX package, no path calls it; K5 is held and timed
   at its five shapes, but K7 does every bucket's LPC recurrence on the
   card: K4, K5 and K1's bare entry must show 0
   launches on the pools), and last the line {"ok": true, "device":
   {...}}.
"""
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
B = 2048
DBS, OV = 2048, 120
# (LM, rows) of the mixed-LM pool's lanes: 2048 streams over five
# fixtures, the two 20 ms ones in one lane
MIXED_LANES = [(0, 410), (1, 410), (2, 410), (3, 818)]
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (data sheet)
INT32_LANES = 132 * 64             # SMs x INT32 lanes per SM
# The deemphasis (K3, K4's epilogue) truncates at every step, so no exact
# scan exists: a stream's samples run one after another, each through two
# dependent integer instructions (the sum, and the product as a high
# word: csrc/celt_deemph.cu), at least ~4 cycles each at the SM clock
DEEMPH_CHAIN_CYCLES = 8
# The SILK LPC synthesis (K5, and the walks of K7, K8 and K9) has one
# dependent chain a sample once every older tap is summed off it: the
# newest output's smulwb (its high half times the coefficient, the sum,
# as one product: ~1 instruction at best), the sum with the older taps
# (1), lshift_sat32's clip (2) and shift (1) and the saturating add of
# the next input (1): six dependent integer instructions at ~4 cycles
LPC_CHAIN_CYCLES = 24


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def eager_ms(fn, reps: int) -> float:
    """Mean stream time of fn() called reps times back to back, CUDA
    events: what an eager caller pays, host launch overhead included."""
    import torch
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def device_ms(fn, reps: int) -> float:
    """Mean device time of one fn() call: fn is captured once into a
    CUDA graph and the graph replayed reps times between CUDA events, so
    host launch overhead stays out of the number."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                          # lazy tables and allocations first
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        graph.replay()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def timings(fn, plain, reps: int) -> dict:
    """Kernel and plain version, each as device time (CUDA graph) and as
    eager stream time."""
    return dict(ms=device_ms(fn, reps), plain_ms=device_ms(plain, 3),
                eager_ms=eager_ms(fn, reps), plain_eager_ms=eager_ms(plain,
                                                                     3))


def bound(nbytes: float, ops: float, sm_hz: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the int32 operations over the INT32 issue rate
    (132 SMs x 64 lanes x SM clock)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / (INT32_LANES * sm_hz) * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes"
                if t_bytes >= t_ops else "operations", bytes=nbytes,
                int32_ops=ops)


def chain_floor(t: dict, n: int, cycles: int, sm_hz: float) -> float:
    """A recurrence's floor (ms): n dependent steps of `cycles` each at
    the SM clock, folded into t's bound (from `bound`) where it is the
    larger (by "operations": the chain's dependent instructions)."""
    chain = n * cycles / sm_hz * 1e3
    if chain > t["bound_ms"]:
        t.update(bound_ms=chain, bound_by="operations")
    return chain


def report(card, what, t) -> None:
    print(f"[{card}] {what}: bit-equal to the plain version (tolerance "
          f"0); device time (CUDA graph) kernel {t['ms']:.4f} ms, plain "
          f"{t['plain_ms']:.4f} ms; eager stream time kernel "
          f"{t['eager_ms']:.4f} ms, plain {t['plain_eager_ms']:.4f} ms; "
          f"bound {t['bound_ms']:.5f} ms by {t['bound_by']} "
          f"({t['bytes'] / 1e6:.2f} MB, {t['int32_ops'] / 1e6:.1f} M int32 "
          f"ops)")


def max_err(got, want) -> int:
    return int((got.long() - want.long()).abs().max())


def same(got, want) -> bool:
    import torch
    torch.cuda.synchronize()
    return all(torch.equal(g, w) for g, w in zip(got, want))


# Operation counts for the bounds: int32 operations per sample (or per
# point) of each kernel's arithmetic, read off its source; a Q15/Q16
# product taken as a widening multiply and a shift (2), a smulwb as
# shift, mask, two multiplies, shift and add (6).

def k1_stage_ops(p: int, m: int) -> float:
    """int32 operations per point of one kiss stage of celt_fft.cu, as
    its body does them (a complex twiddle product is 4 products and 2
    sums, 10):
    - radix 2 (m = 4): twiddle cases 0-3 cost 0, 6, 1 and 7 (sums,
      negations, two products), then 4 sums per butterfly of 2 points;
    - radix 4, m = 1: no twiddles, 16 sums per butterfly of 4 points;
    - radix 4: 3 twiddle products and 16 sums per 4 points;
    - radix 3: 2 twiddle products, 2 + 2 sums, 2 shifts and 2 sums, 2
      products and 6 sums per 3 points;
    - radix 5: 4 twiddle products, 8 + 4 sums, 12 + 11 + 12 + 10 for
      the rotated sums, 8 output sums per 5 points."""
    if p == 2:
        return ((0 + 6 + 1 + 7) / 4 + 4) / 2
    if p == 4:
        return 16 / 4 if m == 1 else (3 * 10 + 16) / 4
    if p == 3:
        return (2 * 10 + 2 + 2 + 4 + 2 * 2 + 6) / 3
    return (4 * 10 + 8 + 4 + 12 + 11 + 12 + 10 + 8) / 5


def k1_work(B: int, plans) -> tuple:
    """Both LM-3 plans over one (960, B) freq: freq read once, (yr, yi)
    written per plan. Per point: pre- and post-rotation (4 products and
    2 sums each, 10), and each stage of the plan (k1_stage_ops)."""
    from esp32_opus_player_tpu_torch.ops.celt.fft import _plan
    nbytes, ops = 960 * B * 4, 0
    for shift, Bblk in plans:
        plan = _plan(shift, Bblk)
        nbytes += 2 * plan["rows"] * B * 4
        per_point = 20 + sum(k1_stage_ops(p, m)
                             for p, m, _ in plan["stages"])
        ops += plan["rows"] * B * per_point
    return nbytes, ops


def k1_tdac_work(tr, LM: int) -> tuple:
    """One channel's call of K1's fused entry, from this run's flags tr
    (numpy bool): the spectrum's N rows, the 60 history rows and the
    flags read once, N + 60 decode_mem rows written. Operations: per
    stream only its own plan's points (pre- and post-rotation and the
    stages, as k1_work), the mirror (2 products and a sum, 5, per
    mirrored row: 120 a block) and the clamp of the N finished rows
    (2)."""
    from esp32_opus_player_tpu_torch.ops.celt.fft import _plan
    N, Bn, nt = 120 << LM, len(tr), int(tr.sum())
    nbytes = Bn * ((N + 60) * 4 + 1 + (N + 60) * 4)
    ops = 0.0
    for count, (shift, Bblk) in ((Bn - nt, (3 - LM, 1)), (nt, (3, 1 << LM))):
        plan = _plan(shift, Bblk)
        per_point = 20 + sum(k1_stage_ops(p, m) for p, m, _ in plan["stages"])
        ops += count * (plan["rows"] * per_point + 120 * Bblk * 5 + N * 2)
    return float(nbytes), ops


def k2_work(N: int, c1, c2) -> tuple:
    """Both comb calls of a frame, from this run's params: a region whose
    gains are both 0 does nothing; an active row reads its N rows and
    max(T) + 2 rows of history and writes the rows of its active
    regions (a frame of N 120 has region 1 only). Per sample: 3 gain
    products and 5 sums with the clip (13),
    30 in the 120-sample crossfade (both parameter sets and the
    window)."""
    import numpy as np
    T = [np.maximum(c[0].cpu().numpy(), c[1].cpu().numpy()) for c in (c1, c2)]
    act = [((c[2] != 0) | (c[3] != 0)).cpu().numpy() for c in (c1, c2)]
    if N <= 120:                        # a 2.5 ms frame: region 1 only
        act[1] = np.zeros_like(act[1])
    any_act = act[0] | act[1]
    Tmax = np.where(act[0] & act[1], np.maximum(T[0], T[1]),
                    np.where(act[0], T[0], T[1]))
    reads = np.where(any_act, N + Tmax + 2, 0).sum() + 12 * len(T[0])
    n1 = min(N, 120)
    writes = (act[0] * n1 + act[1] * (N - n1)).sum()
    ops = (act[0] * n1 * 30 + act[1] * (N - n1) * 13).sum()
    return float(reads + writes) * 4, float(ops)


def k7_work(args, fs: int, nb: int, order: int) -> tuple:
    """One decode_core frame from this run's inputs. Reads: exc, A, B,
    the 7 parameters, sLPC, and the outBuf positions the rewhitening
    reads (only rows that rewhiten, only the last lag + 2 positions and
    the order before them; this frame's xq replaces outBuf from subframe
    2 on); writes: xq and sLPC. Per sample: the 5 LTP taps (smlawb, 6
    each) and 4 more, the LPC taps (7 each) and 8 more, the gain scaling
    (9); per rewhitened position 3 * order + 12; per rescaled position 4;
    16 * 4 per LPC-state gain adjustment."""
    import numpy as np
    (ob, _, exc, _, _, _, _, lag, voiced, rw, _, match) = [
        np.asarray(a) for a in args]
    Bn = exc.shape[0]
    subfr, ltp = 5 * fs, 20 * fs
    frame = nb * subfr
    pos = np.arange(ltp + frame)[None, :]
    read = np.zeros((Bn, ltp + frame), dtype=bool)
    ops = float(Bn * frame * (5 * 6 + 4 + 7 * order + 8 + 9))
    for k in range(nb):
        end = ltp + k * subfr
        first = np.maximum(end - 18 * fs - 4, end - lag[:, k] - 2)
        span = (pos >= (first - order)[:, None]) & (pos < end)
        if k >= 2:
            span &= (pos < ltp) | (pos >= ltp + 2 * subfr)
        read |= span & rw[:, k, None]
        n_pos = end - first
        rescale = ~rw[:, k] & voiced[:, k] & ~match[:, k]
        ops += float((rw[:, k] * n_pos * (3 * order + 12)).sum())
        ops += float((rescale * n_pos * 4).sum())
        ops += float((~match[:, k]).sum() * 16 * 4)
    nbytes = 4 * (read.sum() + Bn * (frame + 2 * order + 5 * nb + 7 * nb
                                     + 16) + Bn * (frame + 16))
    return float(nbytes), ops


def k8_work(args, fs: int, nb: int, order: int) -> tuple:
    """One concealed frame from this run's inputs. Reads: rand, A, B4,
    the lags and two gains, sLPC, and the outBuf positions the
    rewhitening reads (the last lag0 + 2 and the order before them);
    writes: xq and sLPC. Per sample: the 5 LTP taps (smlawb, 6 each) and
    4 more, the LPC taps (7 each) and 8 more, the gain scaling (9); per
    rewhitened position 3 * order + 12."""
    import numpy as np
    lag0 = np.clip(np.asarray(args[5])[:, 0], 2 * fs, 18 * fs)
    Bn, frame = len(lag0), nb * 5 * fs
    n_pos = float((lag0 + 2).sum())
    nbytes = 4 * (n_pos + Bn * order + Bn * (frame + order + 5 * nb + nb
                                             + 2 + 16) + Bn * (frame + 16))
    ops = Bn * frame * (5 * 6 + 4 + 7 * order + 8 + 9) \
        + n_pos * (3 * order + 12)
    return float(nbytes), float(ops)


def k9_work(mask, frame: int, order: int) -> tuple:
    """One comfort-noise frame from this run's mask: every row reads its
    frame, its mask and its state and writes both back; a row with the
    mask on also reads its excitation, A and gain and walks the ring:
    per sample the order taps (7 each) and 8 more, then the scaling, two
    clips and the sum (11)."""
    Bn, on = len(mask), float(mask.sum())
    nbytes = 4 * (Bn * (2 * frame + 1 + 32) + on * (frame + order + 1))
    return float(nbytes), on * frame * (7 * order + 8 + 11)


def k1_fused_timings(what, card, sm_hz, freq, dcc, tr, LM=3) -> dict:
    """K1's fused entry on one channel's inputs, timed against its plain
    version and against the chain it replaced in the frame step (the
    bare entry's two plans, then the select, the TDAC, the clamp and the
    stores in torch), all in CUDA graphs; dcc is updated in place on
    every replay, which changes no shape or branch."""
    from esp32_opus_player_tpu_torch.ops.celt.fft import (
        celt_imdct_tdac_T, celt_imdct_tdac_T_ref, fft_blocks)
    work = dcc.clone()
    t = dict(**timings(lambda: celt_imdct_tdac_T(freq, work, tr, LM=LM),
                       lambda: celt_imdct_tdac_T_ref(freq, work, tr, LM=LM),
                       20),
             **bound(*k1_tdac_work(tr.cpu().numpy(), LM), sm_hz),
             chain_ms=device_ms(lambda: celt_imdct_tdac_T_ref(
                 freq, work, tr, LM=LM, fft=fft_blocks), 20),
             transient=int(tr.sum()), streams=len(tr))
    report(card, f"{what} ({t['transient']} of {t['streams']} transient; "
           f"the chain it replaced: {t['chain_ms']:.4f} ms)", t)
    return t


def check_k1_path(dev, card, sm_hz, captured, res):
    """K1's fused entry on inputs the CELT pools gave it (one call each of
    the mono and the stereo pool, the fixtures' own flags): bit-equal to
    its plain version, and timed there."""
    from esp32_opus_player_tpu_torch.ops.celt.fft import (
        celt_imdct_tdac_T, celt_imdct_tdac_T_ref)
    for label, (freq, dcc, tr, LM) in captured.items():
        got = celt_imdct_tdac_T(freq, dcc.clone(), tr, LM=LM)
        want = celt_imdct_tdac_T_ref(freq, dcc.clone(), tr, LM=LM)
        if not same([got], [want]):
            raise SystemExit(f"K1 fused on the {label} pool's inputs differs "
                             f"from its plain version")
        res["K1"]["max_abs_err"] = max(res["K1"]["max_abs_err"],
                                       max_err(got, want))
        res["K1"][label] = k1_fused_timings(
            f"K1 celt_imdct_tdac_T (fused) on a {label} pool call's inputs, "
            f"B={len(tr)}", card, sm_hz, freq, dcc, tr, LM)


# P1, the CELT pitch conceal, is float32: it is held to its plain version
# at these bounds (T equal on every row; PCM in LSB; decode_mem and
# preemph in Q12, 16 LSB; the LPC fit relative to a channel's largest
# coefficient), and bit-identical to itself whatever the rows beside a
# row. The pools that conceal are held to their CPU twins frame by frame:
# bit-equal before a stream's first conceal and on every stream only the
# noise branch touched; every other frame bit-equal, or within PLC_PCM at
# SNR >= PLC_SNR dB, or within 1 LSB on a quiet frame: one whose twin's
# RMS is below PLC_QUIET_RMS, the level under which one LSB of float32
# rounding on every sample is already above -40 dB (20 log10 100 = 40).
PLC_TOL = dict(pcm=16, dm=16 * 4096, pre=16 * 4096, lpc=0.05)
PLC_PCM, PLC_SNR, PLC_QUIET_RMS = 16, 40.0, 100.0
F32_FLOPS = 67e12                  # H100 SXM float32, no tensor cores


def p1_work(first, T, CC: int) -> tuple:
    """(bytes, float32 operations) of one P1 call on this run's rows:
    each row's decode_mem read and written once, its PCM written, its
    preemph, pitch and LPC read and written; operations from
    csrc/celt_plc.cu's stages, the pitch search and Levinson-24 only on
    first conceals, the whitening over the row's exc_len = min(2T, 1024)
    samples."""
    import numpy as np
    first = np.asarray(first, dtype=bool)
    exc_len = np.minimum(2 * np.asarray(T, dtype=np.int64), 1024)
    R = len(first)
    nbytes = R * (CC * (2 * 2168 * 4 + 960 * 2 + 2 * 4 + 2 * 24 * 4)
                  + 2 * 4 + 8 + 1)
    search = (2048 * (CC - 1) + 1024 * 4 + 5 * 1024 * 2 + 1024 * 10
              + 156 * 332 * 2 + 155 * 10 + 11 * 664 * 2 + 310 * 10)
    fit = 240 + 25 * 1024 * 2 + 24 * 24 * 2       # a channel, first only
    rest = (exc_len * 48 + 1024 * 4 + 1080 * 3 + 1080 * 48 + 1080 * 4
            + 60 * 3 + 960 * 2 + 2168 * 2)        # a channel, every row
    ops = int(first.sum()) * (search + CC * fit) + CC * int(rest.sum())
    return float(nbytes), float(ops)


def p1_bound(nbytes: float, ops: float) -> dict:
    """The larger of the bytes over the memory rate and the float32
    operations over the float32 rate. No chain of a row is charged: the
    IIR and the deemphasis run as blocks of a warp (csrc/celt_plc.cu), and
    the chains left (the Syy walk, Levinson-24, the top-2 walks) have no
    floor that can be stated without the kernel's own schedule."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes"
                if t_bytes >= t_ops else "operations",
                bytes=nbytes, f32_ops=ops, bytes_ms=t_bytes, ops_ms=t_ops)


def p1_check(what, st, pcmT, rows, first) -> dict:
    """P1 against its plain version on one lane's inputs: T equal, the
    rest within PLC_TOL, every other column untouched by both. Returns
    the measured maxima and the rows' pitch out."""
    import torch
    from esp32_opus_player_tpu_torch.ops.celt.plc_kernel import (
        celt_plc_T, celt_plc_T_ref)
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_port_util import plc_run
    (dm, pre, pitch, lpc), pcm = plc_run(celt_plc_T, st, pcmT, rows, first)
    (rdm, rpre, rpitch, rlpc), rpcm = plc_run(celt_plc_T_ref, st, pcmT,
                                              rows, first)
    if not torch.equal(pitch, rpitch):
        raise SystemExit(f"P1 {what}: T differs from its plain version")
    err = dict(pcm=max_err(pcm, rpcm), dm=max_err(dm, rdm),
               pre=max_err(pre, rpre),
               lpc=float(((lpc - rlpc).abs().amax(2)
                          / rlpc.abs().amax(2).clamp_min(1.0)).max()))
    keep = torch.ones(dm.shape[2], dtype=torch.bool, device=dm.device)
    keep[rows] = False
    untouched = (torch.equal(dm[:, :, keep], st[0][:, :, keep])
                 and torch.equal(lpc[keep], st[3][keep])
                 and torch.equal(pcm[:, :, keep], pcmT[:, :, keep]))
    bad = {k: v for k, v in err.items() if v > PLC_TOL[k]}
    print(f"P1 {what}: T equal on all {len(rows)} rows; max |kernel - "
          f"plain| {err} (bounds {PLC_TOL})")
    if bad or not untouched:
        raise SystemExit(f"P1 {what}: beyond its bounds {bad} or wrote "
                         f"outside its rows ({not untouched})")
    return dict(err=err, T=pitch[rows])


def p1_timings(what, card, st, pcmT, rows, first, T) -> dict:
    """P1 and its plain version on one lane's inputs, both in CUDA graphs
    (the state is updated in place on every replay, which changes no
    shape), beside the bound from these rows."""
    from esp32_opus_player_tpu_torch.ops.celt.plc_kernel import (
        celt_plc_T, celt_plc_T_ref)
    work = [t.clone() for t in st]
    pcm = pcmT.clone()
    t = dict(**timings(lambda: celt_plc_T(*work, pcm, rows, first),
                       lambda: celt_plc_T_ref(*work, pcm, rows, first), 20),
             **p1_bound(*p1_work(first.cpu().numpy(), T.cpu().numpy(),
                                 st[0].shape[0])),
             rows=len(rows), first=int(first.sum()))
    print(f"[{card}] P1 celt_plc, {what} ({t['rows']} rows, {t['first']} "
          f"first conceals): device time (CUDA graph) kernel "
          f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms; eager stream "
          f"time kernel {t['eager_ms']:.4f} ms, plain "
          f"{t['plain_eager_ms']:.4f} ms; bound {t['bound_ms']:.5f} ms by "
          f"{t['bound_by']}: the larger of {t['bytes'] / 1e6:.2f} MB "
          f"({t['bytes_ms']:.5f} ms) and {t['f32_ops'] / 1e6:.1f} M "
          f"float32 ops ({t['ops_ms']:.5f} ms)")
    return t


def check_plc_kernel(dev, card) -> dict:
    """P1 against its plain version on seeded lanes of 2048 columns
    (tests/torch_port_util.py::plc_lane: rows 0 and 1 repeat a conceal at
    pitch 60 and 800): CC 1 and 2, 205 rows (the pools' tenth) and 7,
    first conceals and repeated ones, both pitch clamps; bit-identical to itself for five rows alone
    and among 205; timed at 205 rows, CC 1 and CC 2."""
    import torch
    from esp32_opus_player_tpu_torch.ops.celt.plc_kernel import celt_plc_T
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_port_util import plc_lane, plc_run
    res = dict(err=dict.fromkeys(PLC_TOL, 0))
    for CC in (1, 2):
        for R in (205, 7):
            lane = plc_lane(dev, CC, R, 10 * CC + R)
            c = p1_check(f"seeded, CC {CC}, {R} rows", *lane)
            if c["T"][:2].tolist() != [100, 720]:
                raise SystemExit(f"P1 missed a pitch clamp: {c['T'][:2]}")
            res["err"] = {k: max(v, c["err"][k])
                          for k, v in res["err"].items()}
        st, pcmT, rows, first = lane = plc_lane(dev, CC, 205, 77 + CC)
        (dm, pre, pitch, lpc), pcm = plc_run(celt_plc_T, *lane)
        for j in (0, 2, 3, 100, 204):
            (dm1, pre1, pitch1, lpc1), pcm1 = plc_run(
                celt_plc_T, st, pcmT, rows[j:j + 1].clone(),
                first[j:j + 1].clone())
            r = int(rows[j])
            if not (torch.equal(dm1[:, :, r], dm[:, :, r])
                    and torch.equal(pcm1[:, :, r], pcm[:, :, r])
                    and torch.equal(pre1[r], pre[r])
                    and torch.equal(lpc1[r], lpc[r])
                    and int(pitch1[r]) == int(pitch[r])):
                raise SystemExit(f"P1 CC {CC}: row {r} alone differs from "
                                 f"the same row among 205")
        print(f"P1 CC {CC}: five rows alone bit-identical to themselves "
              f"among 205")
        res[f"seeded_cc{CC}"] = p1_timings(
            f"seeded lane CC {CC}, B={B}", card, *lane, pitch[rows])
    return res


def check_celt_kernels(dev, card, sm_hz):
    """Every CELT kernel against its plain version at B = 2048
    (bit-equal), timed at the main path's shapes."""
    import numpy as np
    import torch
    from esp32_opus_player_tpu_torch.ops.celt.comb import (
        comb_deemph_step_T, comb_deemph_step_T_ref, comb_filter_step_T,
        comb_filter_step_T_ref)
    from esp32_opus_player_tpu_torch.ops.celt.deemph import (
        deemphasis_T, deemphasis_T_ref)
    from esp32_opus_player_tpu_torch.ops.celt.fft import (
        celt_imdct_tdac_T, celt_imdct_tdac_T_ref, fft_blocks, fft_blocks_ref)
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_port_util import imdct_tdac_inputs
    rng = np.random.default_rng(2024)

    def t32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)

    res = {}
    # K1: all 7 plans (LM 3-0 x transient); LM 3 runs (0, 1) and (3, 8)
    err = 0
    freq = t32(rng.integers(-(1 << 24), 1 << 24, (960, B)))
    for shift, Bblk in [(0, 1), (3, 8), (1, 1), (3, 4), (2, 1), (3, 2),
                        (3, 1)]:
        got = fft_blocks(freq, shift, Bblk)
        want = fft_blocks_ref(freq, shift, Bblk)
        if not same(got, want):
            raise SystemExit(f"K1 plan ({shift}, {Bblk}) differs from its "
                             f"plain version: {max_err(got[0], want[0])}")
        err = max(err, max_err(got[0], want[0]), max_err(got[1], want[1]))
    both = [(0, 1), (3, 8)]
    res["K1 bare"] = dict(max_abs_err=err, **timings(
        lambda: [fft_blocks(freq, s, b) for s, b in both],
        lambda: [fft_blocks_ref(freq, s, b) for s, b in both], 20),
        **bound(*k1_work(B, both), sm_hz))
    report(card, f"K1 fft_blocks (bare entry), all 7 plans; timed: both "
           f"LM-3 plans, B={B}", res["K1 bare"])

    # K1's fused entry (what the frame step runs): LM 3 at the paths'
    # widths (B 2048 mono, 1024 a stereo channel) and ragged ones, LM 0-2
    # at ragged widths; no stream, every stream, every 3rd stream or a
    # seeded random set transient; timed at B 2048 with the random set
    # (the fixtures' own flags are timed after the pools, check_k1_path)
    err = 0
    for LM in (3, 2, 1, 0):
        for Bn in ((B, B // 2, 2047, 9, 1) if LM == 3 else (2047, 9)):
            for flags in ("false", "true", "third", "random"):
                f, d, tr = imdct_tdac_inputs(rng, Bn, LM, flags)
                f, d = t32(f), t32(d)
                tr = torch.as_tensor(tr, device=dev)
                got = celt_imdct_tdac_T(f, d.clone(), tr, LM=LM)
                want = celt_imdct_tdac_T_ref(f, d.clone(), tr, LM=LM)
                if not same([got], [want]):
                    raise SystemExit(f"K1 fused (LM {LM}, B {Bn}, flags "
                                     f"{flags}) differs from its plain "
                                     f"version: {max_err(got, want)}")
                err = max(err, max_err(got, want))
                if (LM, Bn, flags) == (3, B, "random"):
                    timed = (f, d, tr)
    res["K1"] = dict(max_abs_err=err, mix=k1_fused_timings(
        f"K1 celt_imdct_tdac_T (fused), LM 0-3, B in (2048, 1024, 2047, "
        f"9, 1), flags none / all / every 3rd / random; timed: LM 3, "
        f"B={B}, a seeded random set transient", card, sm_hz, *timed))

    # K2: lags 15..1024, both regions of a 960-sample frame
    def params(Bn, lag):
        v = [rng.integers(15, 1025, Bn), rng.integers(15, 1025, Bn),
             rng.integers(0, 32768, Bn), rng.integers(0, 32768, Bn),
             rng.integers(0, 3, Bn), rng.integers(0, 3, Bn)]
        if lag is None:
            v[0][:8] = v[1][:8] = 15
        else:
            v[0][:] = v[1][:] = lag
        v[2][8:16] = v[3][8:16] = 0            # no-op rows
        v[3][16:24] = 0                        # g1 = 0 rows
        return tuple(t32(a) for a in v)

    def k2_case(Bn, lag=None, N=960):
        c1, c2 = params(Bn, lag), params(Bn, lag)
        buf = t32(rng.integers(-(1 << 26), 1 << 26, (DBS + OV, Bn)))
        want = comb_filter_step_T_ref(buf.clone(), DBS - N, N, c1, c2)
        got = comb_filter_step_T(buf.clone(), DBS - N, N, c1, c2)
        if not same([got], [want]):
            raise SystemExit(f"K2 (B {Bn}, N {N}, lags {lag}) differs from "
                             f"its plain version: {max_err(got, want)}")
        return buf, c1, c2, max_err(got, want)

    # widths around the 8-stream tile, every lag at either edge, then the
    # timed shape
    for Bn in (1, 7, 9, 2047):
        k2_case(Bn)
    for lag in (15, 1024):
        k2_case(B, lag)
    buf, c1, c2, err = k2_case(B)
    work = buf.clone()
    res["K2"] = dict(max_abs_err=err, **timings(
        lambda: comb_filter_step_T(work, DBS - 960, 960, c1, c2),
        lambda: comb_filter_step_T_ref(work, DBS - 960, 960, c1, c2), 20),
        **bound(*k2_work(960, c1, c2), sm_hz))
    report(card, f"K2 comb_filter_step_T, also B in (1, 7, 9, 2047) and "
           f"all lags 15 / 1024; timed: N=960, B={B}", res["K2"])
    # the frames of 2.5, 5 and 10 ms (LM 0-2: N 120 runs region 1 only)
    res["K2"]["by_N"] = {}
    for N in (120, 240, 480):
        bufN, d1, d2, e = k2_case(B, N=N)
        res["K2"]["max_abs_err"] = max(res["K2"]["max_abs_err"], e)
        workN = bufN.clone()
        t = dict(**timings(
            lambda: comb_filter_step_T(workN, DBS - N, N, d1, d2),
            lambda: comb_filter_step_T_ref(workN, DBS - N, N, d1, d2), 20),
            **bound(*k2_work(N, d1, d2), sm_hz))
        report(card, f"K2 comb_filter_step_T, N={N}, B={B}", t)
        res["K2"]["by_N"][N] = {k: t[k] for k in ("ms", "plain_ms",
                                                  "bound_ms", "bound_by")}

    # K3: widths around a block's 8 columns at CC 1 and CC 2, every
    # downsample factor; then timed at CC 1 (B = 2048, the mono pool) and
    # CC 2 (B = 1024, stereo), both on a strided view of decode_mem, and
    # at N 120, 240 and 480 (CC 1, B 2048)
    def k3_case(CC, nb, d=1, N=960):
        dm = t32(rng.integers(-(1 << 28), 1 << 28, (CC, DBS + OV, nb)))
        mem = t32(rng.integers(-(1 << 20), 1 << 20, (nb, CC)))
        syn = dm[:, DBS - N:DBS]
        got = deemphasis_T(syn, mem, d)
        want = deemphasis_T_ref(syn, mem, d)
        if not same(got, want):
            raise SystemExit(f"K3 (CC {CC}, B {nb}, N {N}, downsample {d}) "
                             f"differs from its plain version")
        return syn, mem, max(max_err(got[0], want[0]),
                             max_err(got[1], want[1]))

    err = 0
    for CC, nb in [(1, 1), (1, 7), (1, 9), (1, 15), (1, 17), (1, 2047),
                   (2, 1023)]:
        for d in (1, 2, 3, 4, 6):
            err = max(err, k3_case(CC, nb, d)[2])
    for CC, nb in [(1, B), (2, B // 2)]:
        syn, mem, e = k3_case(CC, nb)
        err = max(err, e)
        # reads: the frame's rows and the memory; writes: int16 PCM and
        # the memory. Per sample: sum, Q15 product, round, clip (8).
        t = dict(**timings(lambda: deemphasis_T(syn, mem),
                           lambda: deemphasis_T_ref(syn, mem), 20),
                 **bound(CC * nb * (960 * 4 + 960 * 2 + 8),
                         CC * nb * 960 * 8, sm_hz))
        chain = chain_floor(t, 960, DEEMPH_CHAIN_CYCLES, sm_hz)
        report(card, f"K3 deemphasis_T, CC={CC}, B={nb} (the chain's floor "
               f"{chain:.5f} ms)", t)
        if CC == 1:
            res["K3"] = t
    res["K3"].update(ms_cc2=t["ms"], bound_ms_cc2=t["bound_ms"], by_N={})
    for N in (120, 240, 480):
        syn, mem, e = k3_case(1, B, N=N)
        err = max(err, e)
        t = dict(**timings(lambda: deemphasis_T(syn, mem),
                           lambda: deemphasis_T_ref(syn, mem), 20),
                 **bound(B * (N * 4 + N * 2 + 8), B * N * 8, sm_hz))
        chain = chain_floor(t, N, DEEMPH_CHAIN_CYCLES, sm_hz)
        report(card, f"K3 deemphasis_T, CC=1, N={N}, B={B} (the chain's "
               f"floor {chain:.5f} ms)", t)
        res["K3"]["by_N"][N] = {k: t[k] for k in ("ms", "plain_ms",
                                                  "bound_ms", "bound_by")}
    res["K3"]["max_abs_err"] = err
    print(f"[{card}] K3 also at B in (1, 7, 9, 15, 17, 2047) (CC 1) and "
          f"1023 (CC 2), downsample 1/2/3/4/6: bit-equal")

    # K4: K2 then K3 in one launch (K2's tile with the deemphasis as its
    # epilogue), on K2's inputs and one channel's memory, at every frame
    # size; also at ragged widths, with every lag at either edge and with
    # a block of no-op streams; timed beside the two launches it would
    # replace on the same inputs
    def k4_case(buf, c1, c2, N):
        mem = t32(rng.integers(-(1 << 20), 1 << 20, buf.shape[1]))
        want = comb_deemph_step_T_ref(buf.clone(), DBS - N, N, c1, c2, mem)
        got = comb_deemph_step_T(buf.clone(), DBS - N, N, c1, c2, mem)
        if not same(got, want):
            raise SystemExit(f"K4 (B {buf.shape[1]}, N {N}) differs from its "
                             f"plain version: {max_err(got[0], want[0])}")
        return mem, max(max_err(g, w) for g, w in zip(got, want))

    err = 0
    for Bn, lag, N in [(1, None, 960), (9, None, 120), (2047, None, 480),
                       (B, 15, 960), (B, 1024, 240)]:
        e1, e2 = params(Bn, lag), params(Bn, lag)
        for e in (e1, e2):        # streams 16..31: a K4 block of no-ops
            e[2][16:32] = 0
            e[3][16:32] = 0
        bufe = t32(rng.integers(-(1 << 26), 1 << 26, (DBS + OV, Bn)))
        err = max(err, k4_case(bufe, e1, e2, N)[1])
    res["K4"] = dict(by_N={})
    for N in (960, 480, 240, 120):
        bufN, d1, d2, _ = (buf, c1, c2, 0) if N == 960 else k2_case(B, N=N)
        mem, e = k4_case(bufN, d1, d2, N)
        err = max(err, e)
        workN = bufN.clone()

        def k2_then_k3():
            comb_filter_step_T(workN, DBS - N, N, d1, d2)
            return deemphasis_T(workN[None, DBS - N:DBS], mem[:, None])

        # reads and operations: K2's, then K3's 8 per sample; the frame's
        # rows are read once (not again by the epilogue); writes: K2's
        # rows, the int16 PCM and the memory; or the deemphasis chain
        k2_bytes, k2_ops = k2_work(N, d1, d2)
        t = dict(**timings(
            lambda: comb_deemph_step_T(workN, DBS - N, N, d1, d2, mem),
            lambda: comb_deemph_step_T_ref(workN, DBS - N, N, d1, d2, mem),
            20),
            **bound(k2_bytes + B * (N * 2 + 8), k2_ops + B * N * 8, sm_hz),
            k2_then_k3_ms=device_ms(k2_then_k3, 20))
        chain = chain_floor(t, N, DEEMPH_CHAIN_CYCLES, sm_hz)
        report(card, f"K4 comb_deemph_step_T, N={N}, B={B} (K2 then K3 in "
               f"two launches: {t['k2_then_k3_ms']:.4f} ms; the deemphasis "
               f"chain's floor {chain:.5f} ms)", t)
        if N == 960:
            res["K4"].update(t)
        else:
            res["K4"]["by_N"][N] = {k: t[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "k2_then_k3_ms")}
    res["K4"]["max_abs_err"] = err
    print(f"[{card}] K4 also at B 1, 9, 2047 (ragged), every lag 15 or "
          f"1024, and a block of no-op streams (16..31): bit-equal")

    # K1's fused entry, K2 and K3 at the widths the mixed-LM pool launches
    # them: its lanes (LM, rows) (0, 410), (1, 410), (2, 410), (3, 818),
    # one K1 and one K2 call a channel and one K3 call (CC 2) a frame
    for k in ("K1", "K2", "K3"):
        res[k]["by_lane"] = {}
    for LM, Bn in MIXED_LANES:
        N = 120 << LM
        f, d, tr = imdct_tdac_inputs(rng, Bn, LM, "random")
        f, d = t32(f), t32(d)
        tr = torch.as_tensor(tr, device=dev)
        if not same([celt_imdct_tdac_T(f, d.clone(), tr, LM=LM)],
                    [celt_imdct_tdac_T_ref(f, d.clone(), tr, LM=LM)]):
            raise SystemExit(f"K1 fused (LM {LM}, B {Bn}) differs from its "
                             f"plain version")
        work = d.clone()
        t1 = dict(**timings(
            lambda: celt_imdct_tdac_T(f, work, tr, LM=LM),
            lambda: celt_imdct_tdac_T_ref(f, work, tr, LM=LM), 20),
            **bound(*k1_tdac_work(tr.cpu().numpy(), LM), sm_hz))
        bufN, d1, d2, _ = k2_case(Bn, N=N)
        workN = bufN.clone()
        t2 = dict(**timings(
            lambda: comb_filter_step_T(workN, DBS - N, N, d1, d2),
            lambda: comb_filter_step_T_ref(workN, DBS - N, N, d1, d2), 20),
            **bound(*k2_work(N, d1, d2), sm_hz))
        syn, mem, _ = k3_case(2, Bn, N=N)
        t3 = dict(**timings(lambda: deemphasis_T(syn, mem),
                            lambda: deemphasis_T_ref(syn, mem), 20),
                  **bound(2 * Bn * (N * 4 + N * 2 + 8), 2 * Bn * N * 8,
                          sm_hz))
        chain_floor(t3, N, DEEMPH_CHAIN_CYCLES, sm_hz)
        for k, t in (("K1", t1), ("K2", t2), ("K3", t3)):
            report(card, f"{k} at the mixed-LM lane (LM {LM}, B {Bn}, "
                   f"N {N})", t)
            res[k]["by_lane"][f"LM{LM}x{Bn}"] = {x: t[x] for x in (
                "ms", "plain_ms", "bound_ms", "bound_by")}
    return res


def check_silk_kernels(dev, card, sm_hz):
    """K5-K7 against their plain versions on the card (bit-equal),
    timed at the SILK path's shapes: K7 at B = 2048 and 16, WB (fs 16,
    nb 4, order 16), with the other (fs, nb, order) sets for equality;
    K6's bare entry at n = 160, B = 2048 and 16, with every chunk length
    of both SILK pools for equality, and its fused entry (the whole
    iir_fir call, which the pools run) on both blocks of a frame at
    every rate, timed at WB, n = 304, B = 2048 and 16; K5 (off every
    pool's path:
    K7 takes every bucket on the card) at the shape of the 48-stream
    pool's WB bucket (B = 16, n = 80, order 16), with its NB and MB
    buckets for equality."""
    import numpy as np
    import torch
    from esp32_opus_player_tpu_torch.ops.silk.core_kernel import (
        silk_core, silk_core_ref)
    from esp32_opus_player_tpu_torch.ops.silk.lpc_synth import (
        lpc_synth, lpc_synth_ref)
    from esp32_opus_player_tpu_torch.ops.silk.torch_core import (
        _resampler_spec, iir_fir_chunks, up2_hq_scan)
    from esp32_opus_player_tpu_torch.ops.silk.up2_hq import up2_fir, up2_hq
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_port_util import silk_core_inputs
    rng = np.random.default_rng(2025)

    def dev_t(a):
        return torch.as_tensor(np.asarray(a), device=dev)

    res = {}
    # K7: widths around a block's 16 streams, every lag at either edge,
    # outBuf and exc as misaligned column slices of wider tensors; then
    # all four sets at B = 2048, (16, 4, 16) timed
    def k7_case(Bn, fs, nb, order, lag_fs=None, sliced=False):
        args = list(silk_core_inputs(rng, Bn, fs, nb))
        if lag_fs is not None:
            args[7][:] = lag_fs * fs
        targs = [dev_t(a) for a in args]
        if sliced:
            for i, off in ((0, 3), (2, 5)):
                wide = torch.zeros((Bn, targs[i].shape[1] + 9),
                                   dtype=torch.int32, device=dev)
                wide[:, off:off + targs[i].shape[1]] = targs[i]
                targs[i] = wide[:, off:off + targs[i].shape[1]]
        kw = dict(fs_khz=fs, nb_subfr=nb, order=order)
        got = silk_core(*targs, **kw)
        want = silk_core_ref(*targs, **kw)
        if not same(got, want):
            raise SystemExit(f"K7 (B {Bn}, {fs}, {nb}, {order}, lags "
                             f"{lag_fs} fs, sliced {sliced}) differs from "
                             f"its plain version: {max_err(got[0], want[0])}")
        return args, tuple(targs), kw, max(max_err(got[0], want[0]),
                                           max_err(got[1], want[1]))

    for Bn in (1, 15, 17, 2047):
        k7_case(Bn, 16, 4, 16)
    for lag_fs in (2, 18):
        k7_case(B, 16, 4, 16, lag_fs=lag_fs)
    k7_case(B, 16, 4, 16, sliced=True)
    k7_case(2047, 8, 4, 10, sliced=True)
    err = 0
    for fs, nb, order in [(16, 4, 16), (12, 4, 16), (8, 4, 10),
                          (16, 2, 16)]:
        args, targs, kw, e = k7_case(B, fs, nb, order)
        err = max(err, e)
        if (fs, nb, order) == (16, 4, 16):
            res["K7"] = dict(**timings(lambda: silk_core(*targs, **kw),
                                       lambda: silk_core_ref(*targs, **kw),
                                       20),
                             **bound(*k7_work(args, fs, nb, order), sm_hz))
            chain_floor(res["K7"], nb * 5 * fs, LPC_CHAIN_CYCLES, sm_hz)
    # and at a 16-row bucket of the 48-stream pool (WB), which K7 takes
    # on the card as it takes every bucket
    args, targs16, kw16, e = k7_case(16, 16, 4, 16)
    t16 = dict(**timings(lambda: silk_core(*targs16, **kw16),
                         lambda: silk_core_ref(*targs16, **kw16), 20),
               **bound(*k7_work(args, 16, 4, 16), sm_hz))
    chain_floor(t16, 4 * 5 * 16, LPC_CHAIN_CYCLES, sm_hz)
    res["K7"].update(max_abs_err=max(err, e), ms_b16=t16["ms"],
                     bound_ms_b16=t16["bound_ms"])
    report(card, f"K7 silk_core, all 4 (fs, nb, order) sets, also ragged "
           f"widths, all lags 2 fs / 18 fs and misaligned slices; timed: "
           f"(16, 4, 16), B={B}", res["K7"])
    report(card, "K7 silk_core; timed: (16, 4, 16), B=16", t16)

    # K6, bare entry: every chunk length the resampler gave it before
    # the fused entry (the first block of fs samples, then batchSize
    # chunks of the rest: WB 16, 160, 144; MB 12, 120, 108; NB 8, 80,
    # 72), at the WB pool's B = 2048 and the small pool's 16 rows; timed
    # at one 10 ms chunk of a WB frame at both widths. Only the up2 kind
    # (out_fs = 2 fs_in) calls it on a path; no pool reaches that yet.
    err = 0
    for Bn, n in ([(B, n) for n in (16, 144, 160)]
                  + [(16, n) for n in (8, 80, 72, 12, 120, 108, 16, 160,
                                       144)]):
        x = dev_t(rng.integers(-32768, 32768, (Bn, n)).astype(np.int32))
        S = dev_t(rng.integers(-(1 << 31), 1 << 31, (Bn, 6)).astype(
            np.int32))
        got, want = up2_hq(S, x), up2_hq_scan(S, x)
        if not same(got, want):
            raise SystemExit(f"K6 (B {Bn}, n {n}) differs from its plain "
                             f"version")
        err = max(err, max_err(got[0], want[0]), max_err(got[1], want[1]))
        if n == 160:
            # reads: input and state; writes: 2n outputs and the state.
            # Per input sample: 6 allpass sections (sum, smulwb, 2 sums:
            # 9), the two outputs' rounding and clip (5 each) and the
            # input shift (1).
            t = dict(**timings(lambda: up2_hq(S, x),
                               lambda: up2_hq_scan(S, x), 20),
                     **bound(Bn * 4 * (n + 6 + 2 * n + 6), Bn * n * 65,
                             sm_hz))
            if Bn == B:
                res["K6"] = t
            else:
                t16 = t
    res["K6"].update(max_abs_err=err, ms_b16=t16["ms"],
                     bound_ms_b16=t16["bound_ms"])
    report(card, f"K6 up2_hq, all 9 chunk lengths; timed: n=160, B={B}",
           res["K6"])
    report(card, "K6 up2_hq; timed: n=160, B=16", t16)

    # K6, fused entry (one iir_fir call: the allpass, then the FIR
    # interpolation as its epilogue): each rate's two calls of a frame
    # (fs samples, then 19 fs in chunks of 10 fs and 9 fs), the state
    # carried, the blocks misaligned column slices, at B = 2048 and 16;
    # timed at WB on the 19 fs block at both widths, beside the chain it
    # replaces (K6's bare entry, then the FIR in torch)
    for Bn in (B, 16):
        for fs in (8, 12, 16):
            spec = _resampler_spec(fs, 48)
            kw = dict(batch_size=spec["batch_size"],
                      inv_ratio=spec["inv_ratio"])
            wide = dev_t(rng.integers(-32768, 32768, (Bn, 20 * fs + 7))
                         .astype(np.int32))
            st = (dev_t(rng.integers(-(1 << 31), 1 << 31, (Bn, 6)).astype(
                np.int32)), dev_t(rng.integers(-32768, 32768, (Bn, 8))
                                  .astype(np.int32)))
            for lo, hi in ((3, 3 + fs), (3 + fs, 3 + 20 * fs)):
                x = wide[:, lo:hi]
                got = up2_fir(*st, x, **kw)
                want = iir_fir_chunks(*st, x, **kw)
                if not same(got, want) or any(
                        g.shape != w.shape for g, w in zip(got, want)):
                    raise SystemExit(f"K6 fused (B {Bn}, fs {fs}, n "
                                     f"{hi - lo}) differs from its plain "
                                     f"version")
                err = max(err, *(max_err(g, w) for g, w in zip(got, want)))
                if fs == 16 and hi - lo > fs:
                    # reads: block and both states; writes: the outputs
                    # and both states. Per input sample the allpass (65,
                    # as the bare entry); per output the index and phase
                    # (5), 8 taps (multiply and add, 16), rounding and
                    # clip (5).
                    n, n_out = hi - lo, got[0].shape[1]
                    ft = dict(**timings(
                        lambda: up2_fir(*st, x, **kw),
                        lambda: iir_fir_chunks(*st, x, **kw), 20),
                        **bound(Bn * 4 * (n + 14 + n_out + 14),
                                Bn * (n * 65 + n_out * 26), sm_hz),
                        chain_ms=device_ms(lambda: iir_fir_chunks(
                            *st, x, up2=up2_hq, **kw), 20))
                    report(card, f"K6 up2_fir (fused), NB/MB/WB, both "
                           f"blocks of a frame, B 2048 and 16; timed: WB, "
                           f"n={n}, B={Bn} (K6 bare then the torch FIR: "
                           f"{ft['chain_ms']:.4f} ms)", ft)
                    pre = "fused_" if Bn == B else "fused_b16_"
                    res["K6"].update({pre + k: ft[k] for k in (
                        "ms", "plain_ms", "bound_ms", "bound_by",
                        "chain_ms")})
                st = got[1:]
    res["K6"]["max_abs_err"] = err

    # K5: the LPC recurrence of one subframe in each bucket of the
    # 48-stream pool (16 rows: NB n 40 and MB n 60 at order 10, WB n 80
    # at order 16), the JAX conceal frame's (16, 320, 16) and a wide
    # (2048, 320, 16), each held and timed (ragged widths and wide
    # coefficients: tests/test_torch_cuda.py::test_lpc_kernel_shapes)
    err = 0
    by_shape = {}
    for Bs, n, order in [(16, 40, 10), (16, 60, 10), (16, 80, 16),
                         (16, 320, 16), (2048, 320, 16)]:
        pres = dev_t(rng.integers(-(1 << 24), 1 << 24, (Bs, n)).astype(
            np.int32))
        A = dev_t(rng.integers(-(1 << 12), 1 << 12, (Bs, order)).astype(
            np.int32))
        s0 = dev_t(rng.integers(-(1 << 24), 1 << 24, (Bs, 16)).astype(
            np.int32))
        got = lpc_synth(pres, A, s0, order=order)
        want = lpc_synth_ref(pres, A, s0, order=order)
        if not same(got, want):
            raise SystemExit(f"K5 (B {Bs}, n {n}, order {order}) differs "
                             f"from its plain version")
        err = max(err, max_err(got[0], want[0]), max_err(got[1], want[1]))
        # reads: pres, A, state; writes: vs and the state. Per sample:
        # the order taps (smulwb and sum, 7) and the shift, clip and
        # saturating sum (8); or the chain, n samples of LPC_CHAIN_CYCLES
        t = dict(**timings(lambda: lpc_synth(pres, A, s0, order=order),
                           lambda: lpc_synth_ref(pres, A, s0, order=order),
                           20),
                 **bound(Bs * 4 * (n + order + 16 + n + 16),
                         Bs * n * (7 * order + 8), sm_hz))
        chain = chain_floor(t, n, LPC_CHAIN_CYCLES, sm_hz)
        report(card, f"K5 lpc_synth, B={Bs}, n={n}, order={order} (the "
               f"chain's floor {chain:.5f} ms)", t)
        by_shape[f"{Bs}x{n}x{order}"] = {k: t[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by")}
        if (Bs, n, order) == (16, 80, 16):
            res["K5"] = t
    res["K5"].update(max_abs_err=err, by_shape=by_shape)
    return res


def check_loss_kernels(dev, card, sm_hz):
    """K8 and K9 against their plain versions on the card (bit-equal), at
    the lossy pool's shapes: K8 on all four (fs, nb, order) sets at
    B = 1, 15, 17, 2047 and 2048 (rows 0 and 1 at the lag edges 2 fs and
    18 fs) and at B = 2048 with every lag at 2 fs, at 18 fs or rising,
    its operands column slices of one wider tensor, timed at WB
    (16, 4, 16); K9 at orders 16 (frame 320) and 10 (frame 160) at
    B = 1, 15, 17, 2047 and 2048 with no row, every row and every 10th
    row masked on, its operands column slices of one wider tensor, timed
    with the pool's mask (every 10th row lost) at B = 2048, order 16."""
    import numpy as np
    import torch
    from esp32_opus_player_tpu_torch.ops.silk.cng_kernel import cng_add
    from esp32_opus_player_tpu_torch.ops.silk.plc_kernel import (
        silk_plc_conceal)
    from esp32_opus_player_tpu_torch.ops.silk.torch_plc import (
        cng_add_xla, silk_plc_conceal_frame_xla)
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_port_util import column_slices, silk_plc_inputs
    rng = np.random.default_rng(2026)

    def dev_t(a):
        return torch.as_tensor(np.asarray(a), device=dev)

    res = {}
    # K8: widths around a block's 16 streams, every lag at 2 fs or 18 fs
    # or rising across the subframes, every operand a column slice of one
    # wider tensor at an odd offset (as the pool passes them); all four
    # sets, then timed at B = 2048, (16, 4, 16) on such slices
    def k8_case(Bn, fs, nb, order, lags=None):
        args = silk_plc_inputs(rng, Bn, fs, nb, order, lags)
        targs = tuple(column_slices(args, dev))
        kw = dict(fs_khz=fs, nb_subfr=nb, order=order)
        got = silk_plc_conceal(*targs, **kw)
        want = silk_plc_conceal_frame_xla(*targs, **kw)
        if not same(got, want):
            raise SystemExit(f"K8 (B {Bn}, {fs}, {nb}, {order}, lags "
                             f"{lags}) differs from its plain version: "
                             f"{max_err(got[0], want[0])}")
        return args, targs, kw, max(max_err(got[0], want[0]),
                                    max_err(got[1], want[1]))

    err = 0
    sets = [(16, 4, 16), (12, 4, 10), (8, 4, 10), (16, 2, 16)]
    for fs, nb, order in sets:
        for Bn in (1, 15, 17, 2047):
            err = max(err, k8_case(Bn, fs, nb, order)[3])
        for lags in ("2fs", "18fs", "drift"):
            err = max(err, k8_case(B, fs, nb, order, lags)[3])
        args, targs, kw, e = k8_case(B, fs, nb, order)
        err = max(err, e)
        if (fs, nb, order) == (16, 4, 16):
            res["K8"] = dict(
                **timings(lambda: silk_plc_conceal(*targs, **kw),
                          lambda: silk_plc_conceal_frame_xla(*targs, **kw),
                          20),
                **bound(*k8_work(args, fs, nb, order), sm_hz))
            chain_floor(res["K8"], nb * 5 * fs, LPC_CHAIN_CYCLES, sm_hz)
    res["K8"]["max_abs_err"] = err
    report(card, f"K8 silk_plc_conceal, all 4 (fs, nb, order) sets, also "
           f"B in (1, 15, 17, 2047), all lags 2 fs / 18 fs / rising, "
           f"operands as misaligned column slices; timed: (16, 4, 16), "
           f"B={B}", res["K8"])

    # K9: widths around a block's 16 streams, with no row, every row and
    # every 10th row masked on, at both orders (WB frame 320 at order 16,
    # NB frame 160 at order 10); the operands column slices of one wider
    # tensor at odd offsets (as the lossy frame passes them); timed at
    # B = 2048, frame 320, order 16, every 10th row on (the pools' share)
    def k9_case(Bn, frame, order, masks):
        args = [rng.integers(-32768, 32768, (Bn, frame)),
                rng.integers(-(1 << 16), 1 << 16, (Bn, frame)),
                rng.integers(-(1 << 12), 1 << 12, (Bn, 16)),
                rng.integers(1 << 8, 1 << 14, Bn),
                rng.integers(-(1 << 31), 1 << 31, (Bn, 16))]
        m = dict(off=np.zeros(Bn, bool), on=np.ones(Bn, bool),
                 tenth=np.arange(Bn) % 10 == 3)[masks]
        targs = column_slices(args, dev) + [dev_t(m)]
        kw = dict(frame=frame, order=order)
        got, want = cng_add(*targs, **kw), cng_add_xla(*targs, **kw)
        if not same(got, want):
            raise SystemExit(f"K9 (B {Bn}, frame {frame}, order {order}, "
                             f"mask {masks}) differs from its plain "
                             f"version")
        return m, targs, kw, max(max_err(got[0], want[0]),
                                 max_err(got[1], want[1]))

    err = 0
    # (160, 16): a 10 ms WB or hybrid frame
    for frame, order in ((320, 16), (160, 10), (160, 16)):
        for Bn in (1, 15, 17, 2047, B):
            for masks in ("off", "on", "tenth"):
                err = max(err, k9_case(Bn, frame, order, masks)[3])
    m, targs, kw, e = k9_case(B, 320, 16, "tenth")
    res["K9"] = dict(
        max_abs_err=max(err, e),
        **timings(lambda: cng_add(*targs, **kw),
                  lambda: cng_add_xla(*targs, **kw), 20),
        **bound(*k9_work(m, kw["frame"], kw["order"]), sm_hz))
    chain_floor(res["K9"], kw["frame"], LPC_CHAIN_CYCLES, sm_hz)
    report(card, f"K9 cng_add, orders 16 and 10, B in (1, 15, 17, 2047, "
           f"2048), masks off / on / every 10th row, operands as "
           f"misaligned column slices; timed: every 10th row, frame 320, "
           f"order 16, B={B}", res["K9"])
    return res


def s1_work(B: int, frame: int) -> tuple:
    """(bytes, int32 operations) of one S1 call: reads the frame's mid and
    side and four 2-sample rows (the histories, both predictor pairs),
    writes L and R and the two new histories. Per sample: the two
    predictors' ramp (the delta's product, rounding and the step's
    product and sum, ~6 each), the 3-tap smoothed mid (4), the two
    smulwb (6 each) with the shifts and sums around them (4), the
    rounding and clip (4), L and R with their clips (6): ~40."""
    return B * 4 * (2 * frame + 8 + 2 * frame + 4), B * frame * 40


def check_stereo_kernel(dev, card, sm_hz) -> dict:
    """S1, the stereo unmix, against its plain version on the card at
    tolerance 0: at ragged widths (1, 9, 1023 and 2048 rows), at fs 8, 12
    and 16 with 10 and 20 ms frames, with the frame a misaligned slice of
    a wider tensor and the predictors a column slice of staging-like rows
    (as the pool passes them), predictors at the Q13 extremes (+-13732,
    the quantiser's) and at the int16 ones, rows with a zero delta, and
    histories at +-32767; timed at the stereo WB pool's shape (B 1024,
    frame 320) and at B 2048."""
    import numpy as np
    import torch
    from esp32_opus_player_tpu_torch.ops.silk.stereo_kernel import (
        ms_to_lr, ms_to_lr_ref)
    rng = np.random.default_rng(2027)

    def case(Bn, fs, ms):
        frame = ms * fs
        i16 = lambda *sh: rng.integers(-32768, 32768, sh).astype(np.int32)
        hm, hs = i16(Bn, 2), i16(Bn, 2)
        prev = rng.integers(-13732, 13733, (Bn, 2)).astype(np.int32)
        pred = rng.integers(-13732, 13733, (Bn, 2)).astype(np.int32)
        edge = np.array([[13732, -13732], [-13732, 13732], [32767, -32768],
                         [-32768, 32767]], dtype=np.int32)
        for r in range(min(Bn, 4)):
            prev[r], pred[r] = edge[r], edge[3 - r]
        if Bn > 5:
            pred[5] = prev[5]                       # a zero delta
            hm[4], hs[4] = (32767, -32767), (-32767, 32767)
        wide = torch.as_tensor(i16(Bn, 2, frame + 5), device=dev)
        xq = wide[:, :, 3:3 + frame]
        stg = torch.zeros((Bn, 2, 7), dtype=torch.int32, device=dev)
        stg[:, 0, 2:4] = torch.as_tensor(pred, device=dev)
        args = [torch.as_tensor(a, device=dev) for a in (hm, hs, prev)] + [
            xq, stg[:, 0, 2:4]]
        kw = dict(fs_khz=fs, frame=frame)
        got, want = ms_to_lr(*args, **kw), ms_to_lr_ref(*args, **kw)
        if not same(got, want):
            raise SystemExit(f"S1 (B {Bn}, fs {fs}, {ms} ms) differs from "
                             f"its plain version: "
                             f"{max(max_err(g, w) for g, w in zip(got, want))}")
        return args, kw, max(max_err(g, w) for g, w in zip(got, want))

    err = 0
    for Bn in (1, 9, 1023, 2048):
        for fs in (8, 12, 16):
            for ms in (10, 20):
                err = max(err, case(Bn, fs, ms)[2])
    res = {}
    for Bn in (1024, 2048):
        args, kw, e = case(Bn, 16, 20)
        t = dict(**timings(lambda: ms_to_lr(*args, **kw),
                           lambda: ms_to_lr_ref(*args, **kw), 20),
                 **bound(*s1_work(Bn, kw["frame"]), sm_hz))
        report(card, f"S1 silk_ms_to_lr, B in (1, 9, 1023, 2048), fs 8/12/"
               f"16, 10 and 20 ms, predictors at the Q13 and int16 "
               f"extremes; timed: WB 20 ms, B={Bn}", t)
        res[Bn] = t
    out = dict(res[1024], max_abs_err=err)
    out.update({k + "_b2048": res[2048][k] for k in ("ms", "plain_ms",
                                                     "bound_ms")})
    return out


def check_entry(card, counted) -> dict:
    """entry()'s function (the row-layout CELT step, models/batch_celt.py)
    on the card at B 8 and B 2048, two chained steps each, bit-equal to
    its plain version (the row functions on the CPU, same args); each
    card run counted as a path of its own (K1's fused entry, K2 and K3
    behind the transposes). At B 2048 it is timed as eager stream time
    beside the transposed step on the same inputs already transposed,
    and the transposes alone as device time (CUDA graph)."""
    import torch
    from esp32_opus_player_tpu_torch.entry import entry
    from esp32_opus_player_tpu_torch.ops.celt.synthesis_T import (
        celt_synth_step_dual_T)

    def two_steps(fn, args):
        outs = []
        for _ in range(2):
            out = fn(*args)
            outs += list(out)
            args = (out[1], out[2]) + tuple(args[2:])
        return outs

    res = {}
    for Bn in (8, B):
        fn, args = entry(B=Bn)
        _, cargs = entry(device="cpu", B=Bn)
        got = counted(f"entry() at B {Bn}", lambda: two_steps(fn, args))
        want = two_steps(fn, cargs)
        if any(g.shape != w.shape or not torch.equal(g.cpu(), w)
               for g, w in zip(got, want)):
            raise SystemExit(f"entry() at B {Bn} differs from its plain "
                             f"version")
        res[Bn] = max(max_err(g.cpu(), w) for g, w in zip(got, want))
        print(f"[{card}] entry() at B {Bn} (two steps): pcm, decode_mem and "
              f"preemph bit-equal to the plain version on the CPU")
    dm, pre, X, bandE, start, end, c1, c2 = args
    dmT = dm.permute(1, 2, 0).contiguous()
    XT = X.permute(1, 2, 0).contiguous()
    tr = torch.zeros(B, dtype=torch.bool, device=dm.device)
    pcmT = celt_synth_step_dual_T(dmT, pre, XT, bandE, start, end, c1, c2,
                                  tr, LM=3, C=1, CC=1)[0]
    t = dict(
        max_abs_err=max(res.values()), row_eager_ms=eager_ms(
            lambda: fn(*args), 20),
        transposed_eager_ms=eager_ms(lambda: celt_synth_step_dual_T(
            dmT, pre, XT, bandE, start, end, c1, c2, tr, LM=3, C=1, CC=1),
            20),
        transposes_ms=device_ms(lambda: (
            dm.permute(1, 2, 0).contiguous(), X.permute(1, 2, 0).contiguous(),
            pcmT.permute(2, 0, 1).to(torch.int32),
            dmT.permute(2, 0, 1).contiguous()), 20))
    print(f"[{card}] entry() step, B={B}: eager stream time "
          f"{t['row_eager_ms']:.4f} ms; the transposed step on the same "
          f"inputs {t['transposed_eager_ms']:.4f} ms; the four transposes "
          f"alone (device time, CUDA graph) {t['transposes_ms']:.4f} ms")
    return t


def golden(name):
    import numpy as np
    return np.fromfile(ROOT / "tests" / "golden" / f"{name}.pcm",
                       dtype=np.int16).reshape(-1, 2)


def fixture(name):
    return ROOT / "tests" / "fixtures" / f"{name}.opus"


def run_pool(dev, card, label, names, n, K, channels=1, twins=None,
             loss=None, fec=False, min_len=90000, match=None, **kw):
    """One pool of n streams (names[i % len(names)]) through
    StreamPool.run(), every stream held against tests/golden, or, with
    twins (a list of PCM arrays), stream i against twins[i % len(twins)]:
    bit-equal, or as match(i, out, twin) says; each stream at least
    min_len samples. Returns the PCM."""
    import numpy as np
    import torch
    from esp32_opus_player_tpu_torch.models.stream_pool import StreamPool
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    pool = StreamPool([fixture(names[i % len(names)]) for i in range(n)],
                      channels=channels, superstep_k=K, device=dev, **kw)
    t1 = time.perf_counter()
    outs = pool.run(loss=loss, fec=fec)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    frames = int(sum(len(p.jobs) for p in pool.streams))
    # seconds of audio decoded (frames x 0.02 s in a pool of 20 ms frames)
    audio_s = sum(j.duration for p in pool.streams for j in p.jobs) / 48e3
    gold = {m: golden(m) for m in names}
    for i, out in enumerate(outs):
        if twins is not None:
            ref = twins[i % len(twins)]
            ok = match(i, out, ref) if match else np.array_equal(out, ref)
            if len(out) < min_len or not ok:
                raise SystemExit(f"{label} pool stream {i} differs from "
                                 f"its CPU twin")
            continue
        g = gold[names[i % len(names)]]
        if channels == 1:
            out = np.repeat(out, 2, axis=1)
        m = min(len(out), len(g))
        if m < 90000 or not np.array_equal(out[:m], g[:m]):
            raise SystemExit(f"{label} pool stream {i} "
                             f"({names[i % len(names)]}) differs from "
                             f"tests/golden")
    win = pool.window_device_ms()
    dev_ms = sum(ms for _, ms in win)
    steps = max(len(p.jobs) for p in pool.streams)
    fps = frames / (t2 - t1)
    what = ("bit-equal to tests/golden" if twins is None else
            "bit-equal to their CPU twins" if match is None else
            "within the P1 bounds of their CPU twins")
    print(f"[{card}] {label} pool B={n} K={K}: all {n} streams {what}; "
          f"{frames} frames; setup {t1 - t0:.3f} s; run "
          f"{t2 - t1:.3f} s wall = {fps:.1f} frames/s = "
          f"{audio_s / (t2 - t1):.1f} realtime streams; device {dev_ms:.3f} "
          f"ms in "
          f"{len(win)} windows = {dev_ms / len(win):.3f} ms/window, "
          f"{dev_ms / steps:.4f} ms/frame step; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB")
    return outs


def plc_match(names, loss, noise_only=()):
    """The frame-by-frame hold of a concealing pool's stream i against
    its CPU twin: streams of `noise_only` fixtures (every conceal the
    noise branch: integer work) bit-equal; on the others every frame
    before the stream's first conceal bit-equal, and each later frame
    bit-equal, or within PLC_PCM at SNR >= PLC_SNR, or within 1 LSB with
    the twin's RMS below PLC_QUIET_RMS. Returns (match, stats: the frames
    compared, those equal, the largest error and the lowest SNR of the
    frames that differ, and of the quiet frames below PLC_SNR their
    count, largest twin RMS, most samples that differ and lowest
    SNR)."""
    import numpy as np
    from esp32_opus_player_tpu_torch.host import opusfile
    bounds = {}
    for m in set(names):
        jobs = opusfile.parse_stream(fixture(m).read_bytes()).jobs
        n = [max(0, j.duration - j.discard_front - j.trim_end) for j in jobs]
        bounds[m] = np.concatenate([[0], np.cumsum(n)])
    stats = dict(frames=0, equal=0, max_err=0, min_snr=float("inf"),
                 quiet=0, quiet_max_rms=0.0, quiet_max_diff=0,
                 quiet_min_snr=float("inf"))

    def match(i, out, ref):
        name = names[i % len(names)]
        if out.shape != ref.shape:
            return False
        b = bounds[name]
        if name in noise_only:
            stats["frames"] += len(b) - 1
            stats["equal"] += len(b) - 1
            return np.array_equal(out, ref)
        first = min((k for k in range(len(b) - 1) if loss(i, k)),
                    default=len(b))
        for k in range(len(b) - 1):
            fa, fb = out[b[k]:b[k + 1]], ref[b[k]:b[k + 1]]
            stats["frames"] += 1
            if np.array_equal(fa, fb):
                stats["equal"] += 1
                continue
            if k < first:
                return False
            e = fa.astype(np.float64) - fb
            err = float(np.abs(e).max())
            snr = 10 * np.log10((np.sum(fb.astype(np.float64) ** 2) + 1)
                                / (np.sum(e ** 2) + 1))
            rms = float(np.sqrt(np.mean(fb.astype(np.float64) ** 2)))
            stats["max_err"] = max(stats["max_err"], err)
            stats["min_snr"] = min(stats["min_snr"], float(snr))
            if snr < PLC_SNR:
                if err > 1 or rms >= PLC_QUIET_RMS:
                    return False
                stats["quiet"] += 1
                stats["quiet_max_rms"] = max(stats["quiet_max_rms"], rms)
                stats["quiet_max_diff"] = max(stats["quiet_max_diff"],
                                              int(np.count_nonzero(e)))
                stats["quiet_min_snr"] = min(stats["quiet_min_snr"],
                                             float(snr))
            if err > PLC_PCM:
                return False
        return True
    return match, stats


def check_scalar_route(dev, card, counted) -> dict:
    """The scalar route on the card (the JAX pool's scalar and
    multistream rows, decoded on the host beside the lanes), each pool
    counted as a path:
    - a stereo compat pool: a chained source (celt_fb_stereo_20ms, then
      silk_wb_stereo_20ms), modeswitch_stereo_20ms (SILK, hybrid, CELT)
      and 64 streams of celt_fb_stereo_20ms in a CELT lane, every stream
      bit-equal to tests/golden;
    - ms51_music_fb_20ms (5.1, four elementary streams) through the
      pool's ("ms",) row, bit-equal to tests/golden;
    - modeswitch_stereo_20ms in RFC mode with rfc_plc, packets lost in
      its SILK, CELT and hybrid parts: the lost CELT frames' pitch
      conceal is P1 at one row, launched by the scalar decoder; held
      frame by frame to the same pool on the CPU at P1's bounds, and P1
      must have been launched.
    Prints the phase's wall seconds and frames."""
    import numpy as np
    from esp32_opus_player_tpu_torch.models.stream_pool import StreamPool
    t0 = time.perf_counter()
    frames = 0
    a, b = "celt_fb_stereo_20ms", "silk_wb_stereo_20ms"
    chain = fixture(a).read_bytes() + fixture(b).read_bytes()
    want = [np.concatenate([golden(a), golden(b)]),
            golden("modeswitch_stereo_20ms")] + [golden(a)] * 64
    pool = StreamPool([chain, fixture("modeswitch_stereo_20ms")]
                      + [fixture(a)] * 64, channels=2, superstep_k=8,
                      device=dev)
    if pool.path[:2] != [("scalar",)] * 2 or pool.path[2][0] != "celt":
        raise SystemExit(f"scalar route: classes {pool.path[:3]}")
    outs = counted("the scalar route's stereo pool (chained, "
                   "mode-switching, a CELT lane)", pool.run)
    for i, (out, ref) in enumerate(zip(outs, want)):
        if not np.array_equal(out, ref):
            raise SystemExit(f"scalar route: stream {i} differs from "
                             f"tests/golden")
    frames += pool.stats()["frames"]
    name = "ms51_music_fb_20ms"
    pool = StreamPool([fixture(name)], channels=6, device=dev)
    out = counted("the scalar route's multistream row", pool.run)[0]
    gold = np.fromfile(ROOT / "tests" / "golden" / f"{name}.pcm",
                       dtype=np.int16).reshape(-1, 6)
    pre = pool.streams[0].jobs[0].discard_front
    if pool.path != [("ms",)] or len(out) < 90000 or not np.array_equal(
            out, gold[pre:pre + len(out)]):
        raise SystemExit(f"scalar route: {name} differs from tests/golden")
    frames += pool.stats()["frames"]
    print(f"[{card}] the scalar route: a chained and a mode-switching "
          f"stream beside a 64-stream CELT lane, and {name} as an ms row: "
          f"bit-equal to tests/golden")

    name = "modeswitch_stereo_20ms"
    lost = {20, 60, 70, 71, 72, 85, 120}          # SILK, CELT, hybrid
    loss = lambda i, k: k in lost
    rfc = dict(channels=2, compat_ref=False, rfc_plc=True)
    twin = StreamPool([fixture(name)], device="cpu", **rfc).run(loss=loss)
    pool = StreamPool([fixture(name)], device=dev, **rfc)
    label = "the scalar route's lossy RFC row (rfc_plc)"
    out = counted(label, lambda: pool.run(loss=loss))
    match, mstats = plc_match([name], loss)
    if not match(0, out[0], twin[0]):
        raise SystemExit(f"scalar route: the lossy {name} row is not within "
                         f"the P1 bounds of its CPU twin: {mstats}")
    frames += pool.stats()["frames"]
    wall = time.perf_counter() - t0
    print(f"[{card}] {label}: {len(lost)} packets lost, against the CPU "
          f"twin {mstats['frames']} frames, {mstats['equal']} bit-equal; "
          f"the rest max |card - CPU| {mstats['max_err']:.0f} LSB, min SNR "
          f"{mstats['min_snr']} dB; quiet frames {mstats['quiet']}")
    print(f"[{card}] scalar route phase: {wall:.1f} s wall (the CPU twin "
          f"included), {frames} frames on the card")
    return dict(wall_s=wall, frames=frames, lossy_row=mstats, label=label)


def check_stereo_hybrid_paths(dev, card, counted) -> dict:
    """Stereo SILK and hybrid through StreamPool.run() on the card, each
    pool counted as a path (returns {label: the kernels it must have
    launched}):
    - compat mode: 1024 stereo SILK streams (NB and WB, 20 ms; a lane a
      rate: K7 on the 2n channel rows, S1, K6's fused entry on 2n rows),
      2048 mono hybrid streams (SWB) and 1024 stereo hybrid ones (FB), K
      = 64, every stream bit-equal to tests/golden;
    - RFC mode: 1024 stereo SILK streams of 10, 40 and 60 ms packets (K7
      at nb 2; two and three device frames a packet), 1536 mono SILK
      streams of 10, 40 and 60 ms, 1024 mono and 512 stereo hybrid
      streams of 10 ms (CELT at LM 2), K = 64, each held to a CPU pool
      of one stream a fixture (no golden: the reference crashes on these
      packet sizes);
    - lossy RFC mode, rfc_plc and in-band FEC, a tenth of the packets
      lost: 1024 stereo SILK and 1024 mono hybrid streams, each held to a
      CPU pool of its 20 distinct (fixture, loss phase) streams (K8 and
      K9 on the channel rows; the hybrid conceal's CELT noise branch from
      band 17 through the normal frame step)."""
    from esp32_opus_player_tpu_torch.models.stream_pool import StreamPool
    silk = ("K6", "K7")
    hyb = ("K1", "K2", "K3", "K6", "K7")
    want = {}

    def pool(label, names, n, channels, kernels, twins=False, loss=None,
             min_len=90000, **kw):
        cpu = None
        if twins:
            t0 = time.perf_counter()
            m = 20 if loss else len(names)
            cpu = StreamPool([fixture(names[i % len(names)])
                              for i in range(m)], channels=channels,
                             superstep_k=64, device="cpu", **kw).run(
                loss=loss, fec=loss is not None)
            print(f"{label}: {m} CPU twins in "
                  f"{time.perf_counter() - t0:.1f} s")
        path = f"the {label} pool"
        counted(path, lambda: run_pool(
            dev, card, label, names, n, 64, channels=channels, twins=cpu,
            loss=loss, fec=loss is not None, min_len=min_len, **kw))
        want[path] = kernels

    pool("stereo SILK NB/WB", ["silk_nb_stereo_20ms", "silk_wb_stereo_20ms"],
         B // 2, 2, silk + ("S1",))
    pool("hybrid mono SWB", ["hybrid_swb_mono_20ms"], B, 1, hyb)
    pool("hybrid stereo FB", ["hybrid_fb_stereo_20ms"], B // 2, 2,
         hyb + ("S1",))
    rfc = dict(compat_ref=False)
    pool("RFC stereo SILK 10/40/60 ms", ["silk_wb_fec_stereo_10ms",
                                         "silk_nb_stereo_40ms",
                                         "silk_wb_stereo_60ms"],
         B // 2, 2, silk + ("S1",), twins=True, min_len=60000, **rfc)
    pool("RFC mono SILK 10/40/60 ms", ["silk_wb_mono_10ms",
                                       "silk_wb_mono_40ms",
                                       "silk_wb_mono_60ms"],
         3 * B // 4, 1, silk, twins=True, min_len=60000, **rfc)
    pool("RFC hybrid mono 10 ms", ["hybrid_fb_mono_10ms",
                                   "hybrid_swb_fec_mono_10ms"], B // 2, 1,
         hyb, twins=True, min_len=60000, **rfc)
    pool("RFC hybrid stereo 10 ms", ["hybrid_fb_stereo_10ms"], B // 4, 2,
         hyb + ("S1",), twins=True, min_len=60000, **rfc)
    tenth = lambda i, k: i % 10 == k % 10
    plc = dict(compat_ref=False, rfc_plc=True)
    pool("lossy stereo SILK (rfc_plc, FEC, a tenth lost)",
         ["silk_wb_fec_stereo_20ms", "silk_wb_stereo_20ms"], B // 2, 2,
         silk + ("S1", "K8", "K9"), twins=True, loss=tenth, **plc)
    pool("lossy hybrid mono (rfc_plc, FEC, a tenth lost)",
         ["hybrid_swb_fec_mono_20ms", "hybrid_swb_mono_20ms"], B // 2, 1,
         hyb + ("K8", "K9"), twins=True, loss=tenth, **plc)
    return want


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from esp32_opus_player_tpu_torch.models import celt_pool_T
    from esp32_opus_player_tpu_torch.models.stream_pool import StreamPool
    from esp32_opus_player_tpu_torch.ops import _build
    from esp32_opus_player_tpu_torch.ops.celt import (comb, deemph, fft,
                                                      synthesis_T)
    from esp32_opus_player_tpu_torch.ops.celt import plc_kernel as celt_plc
    from esp32_opus_player_tpu_torch.ops.silk import (cng_kernel,
                                                      core_kernel,
                                                      lpc_synth, plc_kernel,
                                                      stereo_kernel, up2_hq)
    dev = torch.device("cuda")
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    card = nvidia_smi("name,power.limit")
    sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    print(f"device: {kind} x {count}; max SM clock {sm_mhz:.0f} MHz")
    print(card)

    t0 = time.perf_counter()
    _build.lib()
    print(f"kernels built in {time.perf_counter() - t0:.3f} s "
          f"({_build.library_path()})")
    for line in _build.ptxas_log.splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print("  " + line.strip())

    # the floor of every device time below: a graph that holds nothing
    print(f"[{card}] an empty CUDA graph replays in "
          f"{device_ms(lambda: None, 200):.4f} ms")
    res = check_celt_kernels(dev, card, sm_mhz * 1e6)
    res.update(check_silk_kernels(dev, card, sm_mhz * 1e6))
    res.update(check_loss_kernels(dev, card, sm_mhz * 1e6))
    res["P1"] = check_plc_kernel(dev, card)
    res["S1"] = check_stereo_kernel(dev, card, sm_mhz * 1e6)

    # Every path below counts: each wrapper's count is set to 0 here, just
    # before the first pool, and read once after the last; `counted`
    # prints what one pool launched.
    # (K1's and K6's two entries each launch one kernel's source; "K1
    # bare" and "K6 fused" count one entry apart as well)
    wrappers = {"K1": [fft.fft_blocks, fft.celt_imdct_tdac_T],
                "K1 bare": [fft.fft_blocks],
                "K2": [comb.comb_filter_step_T],
                "K3": [deemph.deemphasis_T],
                "K4": [comb.comb_deemph_step_T],
                "K5": [lpc_synth.lpc_synth],
                "K6": [up2_hq.up2_hq, up2_hq.up2_fir],
                "K6 fused": [up2_hq.up2_fir],
                "K7": [core_kernel.silk_core],
                "K8": [plc_kernel.silk_plc_conceal],
                "K9": [cng_kernel.cng_add],
                "P1": [celt_plc.celt_plc_T],
                "S1": [stereo_kernel.ms_to_lr]}

    def launch_counts():
        return {k: sum(w.launches for w in ws) for k, ws in wrappers.items()}

    # each path's counts: set to 0 just before it, read just after
    totals = dict.fromkeys(wrappers, 0)
    paths = {}

    def counted(label, run):
        for ws in wrappers.values():
            for w in ws:
                w.launches = 0
        out = run()
        made = {k: v for k, v in launch_counts().items() if v}
        for k, v in made.items():
            totals[k] += v
        paths[label] = made
        print(f"[{card}] launches in {label}: {made}")
        return out

    # K1's fused entry is held again after the pools on the inputs of one
    # call of each CELT pool: the first with a transient stream among
    # its flags (one host read of the flags a call until then)
    captured = {}

    def capturing(label, run):
        def spy(freq, dcc, tr, *, LM):
            if label not in captured and bool(tr.any()):
                captured[label] = (freq.clone(), dcc.clone(), tr.clone(), LM)
            return fft.celt_imdct_tdac_T(freq, dcc, tr, LM=LM)
        synthesis_T.celt_imdct_tdac_T = spy
        try:
            return run()
        finally:
            synthesis_T.celt_imdct_tdac_T = fft.celt_imdct_tdac_T

    # the CELT path
    counted("the CELT mono pool", lambda: capturing("mono", lambda: run_pool(
        dev, card, "CELT mono", ["celt_fb_mono_20ms",
                                 "celt_fb_mono_drums_20ms"], B, 64)))
    counted("the CELT stereo pool", lambda: capturing("stereo", lambda:
        run_pool(dev, card, "CELT stereo", ["celt_fb_stereo_20ms",
                                            "celt_fb_stereo_drums_20ms"],
                 B // 2, 1, channels=2)))

    src = [fixture(f"celt_fb_mono{d}_20ms") for d in ("", "_drums")] * 2
    loss = lambda i, k: (3 * i + k) % 5 == 0
    a = counted("the lossy CELT pool", lambda: StreamPool(
        src, superstep_k=3, device=dev).run(loss=loss))
    b = StreamPool(src, superstep_k=3, device="cpu").run(loss=loss)
    if not all(np.array_equal(x, y) for x, y in zip(a, b)):
        raise SystemExit("lossy CELT pool: card and CPU differ")
    print("lossy CELT pool (4 streams, K=3, every 5th packet lost): "
          "card == CPU")

    # RFC-mode CELT at every frame size (2.5, 5, 10, 20 ms) and below
    # fullband in one stereo pool: one lane per (LM, coded channels), each
    # with its own state and K = 16 window; every card stream held to its
    # twin in a CPU pool of one stream per fixture
    mixed = ["celt_fb_mono_5ms", "celt_fb_stereo_2p5ms",
             "celt_swb_stereo_10ms", "celt_nb_mono_20ms",
             "celt_fb_mono_20ms"]
    t0 = time.perf_counter()
    mtwins = StreamPool([fixture(m) for m in mixed], channels=2,
                        compat_ref=False, superstep_k=16,
                        device="cpu").run()
    print(f"mixed-LM CELT twins ({len(mixed)} streams on the CPU): "
          f"{time.perf_counter() - t0:.1f} s")
    mlabel = "the mixed-LM RFC CELT pool"
    counted(mlabel, lambda: run_pool(
        dev, card, "CELT mixed LM (RFC, 2.5/5/10/20 ms)", mixed, B, 16,
        channels=2, twins=mtwins, min_len=20000, compat_ref=False))
    entry_t = check_entry(card, counted)

    # the concealing CELT pools (RFC mode, rfc_plc): P1 after each window
    # frame's decode on its pitch-branch rows, the noise branch through
    # the frames' normal steps. 2048 mono streams losing a tenth of their
    # packets (isolated: the pitch branch), 1024 stereo ones with 8-frame
    # bursts besides (the noise branch after five conceals), and the
    # mixed-LM pool with a tenth lost (its 2.5, 5 and 10 ms lanes conceal
    # by noise only; its 20 ms streams are mono in a stereo pool: P1 at
    # CC 2, and noise rows on a step of their own at C = CC). Each held to
    # a CPU pool of its 10 distinct (fixture, loss) streams; the first P1
    # call of each with enough rows kept and, after the pools, held and
    # timed again on those inputs (the 12th call with enough rows, so the
    # history is the fixtures' and not the silence before their start).
    tenth = lambda i, k: i % 10 == k % 10
    burst = lambda i, k: tenth(i, k) or (i % 10 == 3 and 30 <= k < 38)
    rfc = dict(compat_ref=False, rfc_plc=True)
    p1_captured = {}

    def capturing_p1(label, run, least):
        seen = []

        def spy(dmT, pre, pitch, lpc, pcmT, rows, first):
            if rows.shape[0] >= least:
                seen.append(None)
            if label not in p1_captured and len(seen) == 12:
                p1_captured[label] = (
                    [t.clone() for t in (dmT, pre, pitch, lpc)],
                    pcmT.clone(), rows.clone(), first.clone())
            return celt_plc.celt_plc_T(dmT, pre, pitch, lpc, pcmT, rows,
                                         first)
        celt_pool_T.celt_plc_T = spy
        try:
            return run()
        finally:
            celt_pool_T.celt_plc_T = celt_plc.celt_plc_T

    lossy = [("mono", "celt_fb_mono", ["celt_fb_mono_20ms",
                                       "celt_fb_mono_drums_20ms"], B, 64, 1,
              tenth, (), 150),
             ("stereo", "celt_fb_stereo", ["celt_fb_stereo_20ms",
                                           "celt_fb_stereo_drums_20ms"],
              B // 2, 16, 2, burst, (), 80),
             ("mixed-LM", "celt_mixed_lm_rfc", mixed, B, 16, 2, tenth,
              tuple(mixed[:3]), 50)]
    plc_labels = []
    for key, pool_name, names, n, K, ch, loss, noise_only, least in lossy:
        t0 = time.perf_counter()
        ptwins = StreamPool([fixture(names[i % len(names)])
                             for i in range(10)], channels=ch,
                            superstep_k=K, device="cpu", **rfc).run(loss=loss)
        print(f"lossy {key} CELT twins (10 streams on the CPU): "
              f"{time.perf_counter() - t0:.1f} s")
        match, mstats = plc_match(names, loss, noise_only)
        label = f"the lossy {key} RFC CELT pool (rfc_plc)"
        plc_labels.append(label)
        counted(label, lambda: capturing_p1(key, lambda: run_pool(
            dev, card, f"{pool_name} concealing ({key}, {n} streams)",
            names, n, K, channels=ch, twins=ptwins, loss=loss, match=match,
            min_len=20000, **rfc), least))
        print(f"[{card}] {label}: against the CPU twins {mstats['frames']} "
              f"frames, {mstats['equal']} bit-equal; the rest max |card - "
              f"CPU| {mstats['max_err']:.0f} LSB (bound {PLC_PCM}), min "
              f"SNR {mstats['min_snr']} dB (bound {PLC_SNR}); within 1 LSB "
              f"below {PLC_SNR} dB: {mstats['quiet']} quiet frames, twin "
              f"RMS at most {mstats['quiet_max_rms']:.2f} (bound "
              f"{PLC_QUIET_RMS}), at most {mstats['quiet_max_diff']} of a "
              f"frame's samples differing, min SNR "
              f"{mstats['quiet_min_snr']} dB")
        for k in ("min_snr", "quiet_min_snr"):
            if mstats[k] == float("inf"):
                mstats[k] = None                # no such frame
        res["P1"][f"pool_{key}"] = mstats

    # the mono SILK path
    counted("the SILK WB pool (2048-row bucket)", lambda: run_pool(
        dev, card, "SILK WB", ["silk_wb_mono_20ms", "silk_wb_fec_mono_20ms"],
        B, 64))
    small = ["silk_nb_mono_20ms", "silk_mb_mono_20ms", "silk_wb_mono_20ms"]
    outs = counted("the SILK NB/MB/WB pool (16-row buckets)",
                   lambda: run_pool(dev, card, "SILK NB/MB/WB", small, 48,
                                    3))
    cpu = StreamPool([fixture(small[i % 3]) for i in range(48)],
                     superstep_k=3, device="cpu").run()
    if not all(np.array_equal(x, y) for x, y in zip(outs, cpu)):
        raise SystemExit("SILK NB/MB/WB pool: card and CPU differ")
    print("SILK NB/MB/WB pool (48 streams, K=3): card == CPU")

    # the lossy mono SILK path. A tenth of the rows is lost on every
    # step; the 20 distinct (fixture, loss phase) streams run first on
    # the CPU as the twins.
    wb = ["silk_wb_mono_20ms", "silk_wb_fec_mono_20ms"]
    tenth = lambda i, k: i % 10 == k % 10
    rfc = dict(compat_ref=False, rfc_plc=True)
    twins = {}
    t0 = time.perf_counter()
    for fec in (False, True):
        twins[fec] = StreamPool([fixture(wb[i % 2]) for i in range(20)],
                                superstep_k=64, device="cpu",
                                **rfc).run(loss=tenth, fec=fec)
    if all(np.array_equal(a, b) for a, b in zip(twins[False], twins[True])):
        raise SystemExit("lossy SILK twins: FEC changed nothing")
    print(f"lossy SILK twins (20 streams on the CPU, without and with "
          f"FEC): {time.perf_counter() - t0:.1f} s")
    for fec in (False, True):
        counted(f"the lossy SILK WB pool, fec={fec} "
                f"({len(twins[fec][0]) // 960 + 1} frame steps)",
                lambda: run_pool(
                    dev, card, f"lossy SILK WB (10 % lost, fec={fec})", wb,
                    B, 64, twins=twins[fec], loss=tenth, fec=fec, **rfc))

    seventh = lambda i, k: k > 0 and k % 7 == 0
    pool = StreamPool([fixture(wb[0])] * 4, superstep_k=3, device=dev)
    outs = counted("the compat-loss SILK pool",
                   lambda: pool.run(loss=seventh))
    gold = np.fromfile(ROOT / "tests" / "golden"
                       / "silk_wb_mono_20ms.loss7.pcm",
                       dtype=np.int16).reshape(-1, 1)
    # the golden is untrimmed: the pool's PCM starts after the pre-skip
    pre = sum(j.discard_front for j in pool.streams[0].jobs)
    for out in outs:
        m = min(len(out), len(gold) - pre)
        if m < 90000 or not np.array_equal(out[:m], gold[pre:pre + m]):
            raise SystemExit("compat-loss SILK pool differs from "
                             "tests/golden/silk_wb_mono_20ms.loss7.pcm")
    print("compat-loss SILK pool (4 WB streams, K=3, every 7th packet "
          "lost): card == tests/golden loss7")

    # stereo SILK and hybrid (S1 on every stereo frame)
    stereo_paths = check_stereo_hybrid_paths(dev, card, counted)
    for label, need in stereo_paths.items():
        missing = [k for k in need if not paths[label].get(k)]
        if missing:
            raise SystemExit(f"{label} did not launch {missing}: "
                             f"{paths[label]}")

    scalar = check_scalar_route(dev, card, counted)
    if not paths[scalar["label"]].get("P1"):
        raise SystemExit(f"the scalar route's lossy row did not launch P1: "
                         f"{paths[scalar['label']]}")

    launches = totals
    print(f"[{card}] launches over every path: {launches}")
    for label in (mlabel, "entry() at B 8", f"entry() at B {B}"):
        missing = [k for k in ("K1", "K2", "K3") if not paths[label].get(k)]
        if missing or paths[label].get("K1 bare"):
            raise SystemExit(f"{label} did not run through K1's fused entry, "
                             f"K2 and K3: {paths[label]}")
    # off every pool's path: K4, as in the JAX package (the CELT frame
    # step runs K2 and K3 apart); K1's bare entry, since the frame step
    # runs the fused one; K5, since every SILK bucket on the card takes
    # K7, which does the LPC recurrence itself
    off_path = ("K4", "K1 bare", "K5")
    for k, v in launches.items():
        if k in off_path and v != 0:
            raise SystemExit(f"{k} was launched {v} times on the pools")
        if v <= 0 and k not in off_path:
            raise SystemExit(f"{k} was never launched on the main path")
    if set(captured) != {"mono", "stereo"}:
        raise SystemExit(f"no CELT pool call with a transient stream was "
                         f"captured: {sorted(captured)}")
    check_k1_path(dev, card, sm_mhz * 1e6, captured, res)
    for label in plc_labels:
        if not paths[label].get("P1"):
            raise SystemExit(f"{label} did not launch P1: {paths[label]}")
    if set(p1_captured) != {"mono", "stereo", "mixed-LM"}:
        raise SystemExit(f"P1 calls kept: {sorted(p1_captured)}")
    for key, lane in p1_captured.items():
        c = p1_check(f"on a {key} pool call's inputs", *lane)
        res["P1"]["err"] = {k: max(v, c["err"][k])
                            for k, v in res["P1"]["err"].items()}
        res["P1"][key] = p1_timings(f"a {key} pool call's inputs, B="
                                    f"{lane[0][0].shape[2]}", card,
                                    *lane, c["T"])

    pkg, jx = "esp32_opus_player_tpu_torch/csrc/", "esp32_opus_player_tpu/"
    meta = {
        "K1": ("celt_imdct_tdac", "celt_fft.cu",
               "ops/celt/pallas_fft.py:311"),
        "K2": ("celt_comb_step", "celt_comb.cu",
               "ops/celt/pallas_comb.py:237"),
        "K3": ("celt_deemph", "celt_deemph.cu",
               "ops/celt/jax_synthesis_T.py:162"),
        "K4": ("celt_comb_deemph", "celt_comb_deemph.cu",
               "ops/celt/pallas_comb.py:284"),
        "K5": ("silk_lpc_synth", "silk_lpc.cu",
               "ops/silk/pallas_core.py:96"),
        "K6": ("silk_up2_hq", "silk_up2.cu", "ops/silk/pallas_core.py:191"),
        "K7": ("silk_core", "silk_core.cu", "ops/silk/pallas_core.py:409"),
        "K8": ("silk_plc", "silk_plc.cu", "ops/silk/pallas_core.py:562"),
        "K9": ("silk_cng", "silk_cng.cu", "ops/silk/pallas_core.py:631"),
    }
    # K1's row: its fused entry (what the frame step runs) on the mono
    # pool's inputs; beside it the same on the stereo pool's and on a
    # seeded mix, the chain it replaced, and the bare entry
    fused = {k: res["K1"]["mono"][k] for k in ("ms", "plain_ms", "bound_ms",
                                               "bound_by")}
    res["K1"].update(fused)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    # no single PyTorch call computes these int32 fixed-point recurrences
    # (torch.fft is float and another function), so library_ms is null
    kernels = [dict(name=n, route="cuda", source=pkg + s, replaces=jx + r,
                    launches=launches[k], **{x: res[k][x] for x in keys},
                    library_ms=None)
               for k, (n, s, r) in meta.items()]
    # K3 at the stereo pool's shape too; K4's yardstick: the two launches
    # it would replace, same inputs
    k1 = res["K1"]
    kernels[0].update(
        chain_ms=k1["mono"]["chain_ms"], ms_stereo=k1["stereo"]["ms"],
        bound_ms_stereo=k1["stereo"]["bound_ms"],
        chain_ms_stereo=k1["stereo"]["chain_ms"], ms_mix=k1["mix"]["ms"],
        transient={k: f"{k1[k]['transient']}/{k1[k]['streams']}"
                   for k in ("mono", "stereo", "mix")},
        bare_launches=launches["K1 bare"],
        **{"bare_" + k: res["K1 bare"][k] for k in keys})
    kernels[2].update(ms_cc2=res["K3"]["ms_cc2"],
                      bound_ms_cc2=res["K3"]["bound_ms_cc2"],
                      by_N=res["K3"]["by_N"])
    kernels[1]["by_N"] = res["K2"]["by_N"]
    # K1's fused entry, K2 and K3 at the mixed-LM pool's lane widths
    for i, k in ((0, "K1"), (1, "K2"), (2, "K3")):
        kernels[i]["by_lane"] = res[k]["by_lane"]
    # K5 at each of its five timed shapes (its row: (16, 80, 16))
    kernels[4]["by_shape"] = res["K5"]["by_shape"]
    # the row-layout step (entry()) on K1-K3 behind its transposes
    kernels[0]["entry_step"] = entry_t
    kernels[3].update({k: res["K4"][k] for k in (
        "k2_then_k3_ms", "by_N")})
    # K7 at a 16-row bucket too (the 48-stream pool's)
    kernels[6].update(ms_b16=res["K7"]["ms_b16"],
                      bound_ms_b16=res["K7"]["bound_ms_b16"])
    # K6 at the 48-stream pool's 16 rows; its fused entry (what the SILK
    # pools launch) beside the chain it replaced, K6 then the torch FIR
    kernels[5].update(fused_launches=launches["K6 fused"], **{
        k: v for k, v in res["K6"].items()
        if k.startswith(("fused_", "ms_b16", "bound_ms_b16"))})
    # P1 (no pl.pallas_call: jax_plc.celt_plc_core is jnp under a jit):
    # its row is its time on the mono pool's inputs; float32, so its
    # max_abs_err is the PCM's (LSB) and `max_err` has every bound's
    p1 = res["P1"]
    kernels.append(dict(
        name="celt_plc", route="cuda", source=pkg + "celt_plc.cu",
        replaces=jx + "ops/celt/jax_plc.py:221", launches=launches["P1"],
        max_abs_err=p1["err"]["pcm"],
        **{x: p1["mono"][x] for x in ("ms", "plain_ms", "bound_ms",
                                      "bound_by")},
        library_ms=None, max_err=p1["err"], tolerance=PLC_TOL,
        rows=p1["mono"]["rows"],
        **{f"ms_{k}": p1[k]["ms"] for k in ("stereo", "mixed-LM",
                                            "seeded_cc1", "seeded_cc2")},
        **{f"bound_ms_{k}": p1[k]["bound_ms"] for k in (
            "stereo", "mixed-LM", "seeded_cc1", "seeded_cc2")},
        pools={k: p1[f"pool_{k}"] for k in ("mono", "stereo", "mixed-LM")}))
    # S1 (no pl.pallas_call: jax_stereo.ms_to_lr_batch is jnp under a
    # jit): its row is its time at the stereo WB pool's shape
    s1 = res["S1"]
    kernels.append(dict(
        name="silk_ms_to_lr", route="cuda", source=pkg + "silk_stereo.cu",
        replaces=jx + "ops/silk/jax_stereo.py:26", launches=launches["S1"],
        **{x: s1[x] for x in keys}, library_ms=None,
        **{k: s1[k] for k in ("ms_b2048", "plain_ms_b2048",
                               "bound_ms_b2048")}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
