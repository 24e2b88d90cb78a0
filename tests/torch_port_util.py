"""Shared helpers of the torch-port tests: seeded int32 inputs made with
numpy (so the JAX function and its torch port see the same values) and
a bit-equality check. Imports neither JAX nor the JAX package, so the
card-only tests (run without tests/conftest.py) can use it too."""
import numpy as np
import torch

DBS, OV = 2048, 120


def t32(a, device="cpu"):
    """numpy -> a new int32 torch tensor on `device`. Always a copy: the
    port updates some buffers in place, and JAX on the CPU may still be
    reading (asynchronously) the numpy array the same inputs came from."""
    return torch.tensor(np.asarray(a, dtype=np.int32), device=device)


def assert_equal(got, want, what=""):
    """Bit equality of a torch tensor (or numpy array) with a reference
    array, naming the first differing index on failure."""
    g = got.cpu().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape, f"{what}: shape {g.shape} != {w.shape}"
    bad = np.argwhere(g.astype(np.int64) != w.astype(np.int64))
    assert bad.size == 0, (f"{what}: {len(bad)} values differ, first at "
                           f"{tuple(bad[0])}: {g[tuple(bad[0])]} != "
                           f"{w[tuple(bad[0])]}")


def comb_params(rng, B, low=15):
    """A comb-postfilter param 6-tuple (T0, T1, g0, g1, tapset0,
    tapset1) of (B,) int32, with the edge rows the kernel special-cases:
    row 0 no-op (both gains 0), row 1 unchanged params, row 2 g1 = 0."""
    T0 = rng.integers(low, 1025, B)
    T1 = rng.integers(low, 1025, B)
    g0 = rng.integers(0, 32768, B)
    g1 = rng.integers(0, 32768, B)
    ta0 = rng.integers(0, 3, B)
    ta1 = rng.integers(0, 3, B)
    T0[:2] = T1[:2] = low
    if B > 2:
        g0[0] = g1[0] = 0
        g1[1], T1[1], ta1[1] = g0[1], T0[1], ta0[1]
        g1[2] = 0
    return tuple(v.astype(np.int32) for v in (T0, T1, g0, g1, ta0, ta1))


def synth_inputs(rng, B, C, CC, LM):
    """Random inputs of one CELT synthesis step, row layout (as
    tests/test_synthT.py draws them)."""
    N = 120 << LM
    dm = rng.integers(-(1 << 20), 1 << 20, (B, CC, DBS + OV)).astype(
        np.int32)
    pre = rng.integers(-100000, 100000, (B, CC)).astype(np.int32)
    X = rng.integers(-8192, 8192, (B, C, N)).astype(np.int32)
    bandE = rng.integers(0, 1200, (B, 2, 21)).astype(np.int32)
    start = np.zeros(B, np.int32)
    end = np.full(B, 21, np.int32)
    tr = rng.integers(0, 2, B).astype(bool)
    return (dm, pre, X, bandE, start, end, comb_params(rng, B),
            comb_params(rng, B), tr)


def silk_core_inputs(rng, B, fs, nb):
    """Random inputs of one SILK decode_core frame, row layout, drawn as
    tests/test_device_batch.py draws them: the 12 arguments of
    silk_core_frame as numpy (flags as bool). Edge rows: row 0 at the
    smallest lag (2 * fs, PE_MIN_LAG); rows 1-8 take the eight
    voiced/rewhiten/match combinations in every subframe."""
    subfr, ltp_mem = 5 * fs, 20 * fs
    frame = nb * subfr
    i32 = np.int32
    ob = rng.integers(-30000, 30000, (B, ltp_mem + frame)).astype(i32)
    sl = rng.integers(-(1 << 20), 1 << 20, (B, 16)).astype(i32)
    exc = rng.integers(-(1 << 16), 1 << 16, (B, frame)).astype(i32)
    A = rng.integers(-(1 << 12), 1 << 12, (B, 2, 16)).astype(i32)
    Bq = rng.integers(-(1 << 12), 1 << 12, (B, nb, 5)).astype(i32)
    gains = rng.integers(1 << 14, 1 << 20, (B, nb)).astype(i32)
    inv = rng.integers(1 << 24, 1 << 30, (B, nb)).astype(i32)
    lag = rng.integers(2 * fs, 18 * fs + 1, (B, nb)).astype(i32)
    voiced = rng.integers(0, 2, (B, nb)).astype(bool)
    rw = rng.integers(0, 2, (B, nb)).astype(bool)
    adj = rng.integers(1 << 14, 1 << 17, (B, nb)).astype(i32)
    match = rng.integers(0, 2, (B, nb)).astype(bool)
    lag[0] = 2 * fs
    for r in range(min(8, B - 1)):
        voiced[r + 1], rw[r + 1], match[r + 1] = r & 1, r >> 1 & 1, r >> 2
    return (ob, sl, exc, A, Bq, gains, inv, lag, voiced, rw, adj, match)


def silk_plc_inputs(rng, B, fs, nb, order, lags=None):
    """Random inputs of one concealed SILK frame (the 8 arguments of
    silk_plc_conceal_frame as numpy), drawn as tests/test_device_batch.py
    draws them; B4 and lag4 keep 4 rows whatever nb is. lags: None, each
    subframe's lag random in [2 fs, 18 fs] with row 0 at the smallest
    conceal lag (2 fs) and row 1 at the largest (18 fs); "2fs" or "18fs",
    every lag there; "drift", each row's lags rising across the
    subframes from a random start, as the conceal prep's drift does."""
    i32 = np.int32
    frame, lm = nb * 5 * fs, 20 * fs
    ob = rng.integers(-30000, 30000, (B, lm + frame)).astype(i32)
    sl = rng.integers(-(1 << 20), 1 << 20, (B, 16)).astype(i32)
    rand = rng.integers(-(1 << 14), 1 << 14, (B, frame)).astype(i32)
    A = rng.integers(-(1 << 12), 1 << 12, (B, order)).astype(i32)
    B4 = rng.integers(-(1 << 12), 1 << 12, (B, 4, 5)).astype(i32)
    lag4 = rng.integers(2 * fs, 18 * fs + 1, (B, 4)).astype(i32)
    inv = rng.integers(1 << 24, 1 << 30, B).astype(i32)
    pg = rng.integers(1 << 10, 1 << 16, B).astype(i32)
    if lags is None:
        lag4[0] = 2 * fs
        lag4[1:2] = 18 * fs
    elif lags == "drift":
        start = rng.integers(2 * fs, 14 * fs, (B, 1))
        step = rng.integers(0, fs, (B, 1))
        lag4[:] = np.minimum(start + step * np.arange(4)[None], 18 * fs)
    else:
        lag4[:] = {"2fs": 2, "18fs": 18}[lags] * fs
    return (ob, sl, rand, A, B4, lag4, inv, pg)


def column_slices(arrays, device="cpu"):
    """The (B, ...) or (B,) int32 arrays as column slices of one wider
    int32 tensor, each starting at an odd column (so never 16-byte
    aligned), as the SILK pool hands its staging columns to a kernel;
    the columns between them hold 0x5A5A5A5A."""
    B = len(arrays[0])
    flat = [np.asarray(a, np.int32).reshape(B, -1) for a in arrays]
    spans, o = [], 3
    for f in flat:
        spans.append(o)
        o += f.shape[1] + 1
        o += 1 - o % 2
    wide = np.full((B, o), 0x5A5A5A5A, np.int32)
    for f, at in zip(flat, spans):
        wide[:, at:at + f.shape[1]] = f
    t = torch.tensor(wide, device=device)
    out = []
    for a, f, at in zip(arrays, flat, spans):
        v = t[:, at:at + f.shape[1]]
        shape = np.shape(a)
        out.append(v[:, 0] if len(shape) == 1 else v.unflatten(1, shape[1:]))
    return out


def port_synth_step(dm, pre, X, bandE, start, end, c1, c2, tr, **kw):
    """The port's transposed frame step on row-layout numpy inputs (as
    `synth_inputs` draws them); returns row-layout numpy (pcm,
    decode_mem, preemph)."""
    from esp32_opus_player_tpu_torch.ops.celt.synthesis_T import (
        celt_synth_step_dual_T)
    pcmT, dmT, pre2 = celt_synth_step_dual_T(
        t32(np.moveaxis(dm, 0, 2)), t32(pre), t32(np.moveaxis(X, 0, 2)),
        t32(bandE), t32(start), t32(end), tuple(map(t32, c1)),
        tuple(map(t32, c2)), torch.as_tensor(tr), **kw)
    return (np.moveaxis(pcmT.numpy(), 2, 0), np.moveaxis(dmT.numpy(), 2, 0),
            pre2.numpy())


def imdct_tdac_inputs(rng, B, LM, flags):
    """Random inputs of K1's fused entry (one channel of one frame), as
    numpy: freq (N, B) int32, each stream's values within +-2^22 or
    +-2^27 (the larger drive the finished samples past SIG_SAT, so the
    clamp is exercised), dcc (2168, B) int32 (decode_mem, its history
    rows included) and tr (B,) bool. flags: "false", "true", "third"
    (every 3rd stream transient) or "random"."""
    N = 120 << LM
    mag = rng.choice(np.array([1 << 22, 1 << 27]), size=B)
    freq = (rng.integers(-(1 << 30), 1 << 30, (N, B)) % (2 * mag)
            - mag).astype(np.int32)
    dcc = rng.integers(-(1 << 28), 1 << 28, (DBS + OV, B)).astype(np.int32)
    tr = dict(false=np.zeros(B, bool), true=np.ones(B, bool),
              third=np.arange(B) % 3 == 2,
              random=rng.integers(0, 2, B).astype(bool))[flags]
    return freq, dcc, tr


def plc_rows(rng, R, CC):
    """Inputs of the CELT pitch conceal for R rows: decode_mem (R, CC,
    2168) int32 Q12 holding five harmonics of a seeded period (90-740
    samples) with noise, preemph (R, CC) int32, the carried pitch (R,)
    int32 (rows 0 and 1: 60 and 800, both clamps of [100, 720]), the
    carried LPC (R, CC, 24) float32 and the first-conceal flags (R,)
    bool (rows 0-1 False, 2-3 True, the rest seeded)."""
    n = np.arange(DBS + OV)
    P = rng.uniform(90, 740, (R, 1, 1, 1))
    h = np.arange(1, 6)[None, None, :, None]
    amp = rng.uniform(200, 3000, (R, CC, 5, 1)) / h
    ph = rng.uniform(0, 6, (R, CC, 5, 1))
    sig = (amp * np.sin(2 * np.pi * h * n / P + ph)).sum(2)
    sig += rng.normal(0, 100, sig.shape)
    pitch = rng.integers(100, 721, R)
    pitch[:2] = (60, 800)
    first = rng.random(R) < 0.5
    first[:4] = (False, False, True, True)
    return (np.round(sig * 4096).astype(np.int32),
            rng.integers(-2 ** 22, 2 ** 22, (R, CC)).astype(np.int32),
            pitch.astype(np.int32),
            rng.normal(0, 0.3, (R, CC, 24)).astype(np.float32), first)


def plc_lane(device, CC, R, seed, cap=2048):
    """A lane of cap columns for P1 whose R lost rows (every cap // R-th
    column, in a seeded order) hold plc_rows' inputs and whose other
    columns hold random state: ([dmT, pre, pitch, lpc], pcmT zeros, rows,
    first), all on `device`."""
    rng = np.random.default_rng(seed)
    dm, pre, pitch, lpc, first = plc_rows(rng, R, CC)
    cols = rng.permutation(np.arange(R) * (cap // R))
    st = [rng.integers(-2 ** 28, 2 ** 28, (CC, DBS + OV, cap)).astype(
              np.int32),
          rng.integers(-2 ** 22, 2 ** 22, (cap, CC)).astype(np.int32),
          rng.integers(100, 721, cap).astype(np.int32),
          rng.normal(0, 0.3, (cap, CC, 24)).astype(np.float32)]
    st[0][:, :, cols] = dm.transpose(1, 2, 0)
    for t, v in zip(st[1:], (pre, pitch, lpc)):
        t[cols] = v
    return ([torch.as_tensor(a, device=device) for a in st],
            torch.zeros((CC, 960, cap), dtype=torch.int16, device=device),
            torch.as_tensor(cols, device=device),
            torch.as_tensor(first, device=device))


def plc_run(fn, st, pcmT, rows, first):
    """fn (P1 or its plain version) on copies of a lane's state and PCM;
    returns (state list, pcmT), the device's work finished."""
    st = [t.clone() for t in st]
    pcmT = pcmT.clone()
    fn(*st, pcmT, rows, first)
    if pcmT.is_cuda:
        torch.cuda.synchronize()
    return st, pcmT


def scalar_matches_golden(name: str, ch: int, range_comparable: bool):
    """The port's scalar OpusDecoder over every packet of a fixture on the
    CPU, as tests/test_bitexact_all.py drives the JAX one: the PCM after
    the pre-skip bit-equal to tests/golden (mono duplicated to the
    golden's two channels), and each packet's final range equal to the
    reference's where that test compares them."""
    import json
    import pathlib
    from esp32_opus_player_tpu_torch.host import opusfile
    from esp32_opus_player_tpu_torch.models.opus_decoder import OpusDecoder
    tests = pathlib.Path(__file__).resolve().parent
    pre = json.loads((tests / "fixtures" / "manifest.json").read_text())[
        name]["pre_skip"]
    ranges = json.loads((tests / "golden" / f"{name}.ranges.json")
                        .read_text())
    gold = np.fromfile(tests / "golden" / f"{name}.pcm",
                       dtype=np.int16).reshape(-1, 2)
    s = opusfile.open_file(tests / "fixtures" / f"{name}.opus")
    dec = OpusDecoder(ch, compat_ref=True, device="cpu")
    out, n_range_ok = [], 0
    for j, job in enumerate(s.jobs):
        out.append(dec.decode(job.data))
        n_range_ok += dec.final_range == ranges[j]["final_range"]
    mine = np.concatenate(out)[pre:]
    if ch == 1:
        mine = np.repeat(mine, 2, axis=1)
    n = min(len(mine), len(gold))
    assert n > 0
    assert_equal(mine[:n], gold[:n], name)
    if range_comparable:
        assert n_range_ok == len(s.jobs), \
            f"{name}: only {n_range_ok}/{len(s.jobs)} final ranges match"
