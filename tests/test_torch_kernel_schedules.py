"""The independence claims the H100 schedules of K2, K7 and K8 rest on,
and the identity K3's product rests on, held on the CPU, bit for bit
(tolerance 0: int32 fixed point).

K2 (csrc/celt_comb.cu) lets the lanes of a warp take the consecutive
samples of a chunk whose length depends on the stream's lags. That gives
the reference's bits only if the comb's result does not depend on the
chunk length as long as it is at most min(T) - 2: the plain version is
run with chunks of 1 (the reference's own sample walk), 5, 13 and, for
lags >= 34, 32, and each is held to the JAX package (the Pallas kernel in
interpret mode for the short frames, its XLA chunk walk for the long).

K7 (csrc/silk_core.cu) runs a subframe in three phases: every
rewhitening position from the inputs alone, the LTP recurrence in chunks
of min(32, lag - 2) samples whose taps are all read before any is
written, and the LPC recurrence in transposed form (running sums P[j]
rebuilt from the gain-adjusted state at each subframe, split Q16
products, the saturating add by signs). `_core_by_phases` below is that
schedule in numpy, step for step, and is held to the plain version
`silk_core_ref` and to the JAX package's XLA core frame on the same
inputs, with LPC states over the whole int32 range, where every sum
wraps, and rows at the lag edges 2 fs and 18 fs.

K8 (csrc/silk_plc.cu) conceals a frame in three phases: the rewhitening
FIR of the last lag0 + 2 history positions from the inputs alone, the
LTP recurrence of the whole frame in chunks of min(32, L - 2) samples
(L each subframe's own lag) whose taps are all read before any is
written, and the LPC recurrence in transposed form with its running
sums built once from the incoming state. `_plc_by_phases` is that
schedule in numpy and is held to the JAX package's Pallas kernel in
interpret mode and to its XLA conceal frame, on all four (fs, nb, order)
sets, with lags at 2 fs, at 18 fs, random and rising across the
subframes, and LPC states over the whole int32 range.

K3 (csrc/celt_deemph.cu) takes its Q15 product as one high-word
multiply; `test_deemph_product_is_a_high_word` holds that identity over
the int32 range.

K6 (csrc/silk_up2.cu) does a whole IIR-FIR resampler call in one launch:
two threads per stream walk the even and the odd allpass chain over the
whole block (the state carries from chunk to chunk), each product one
high-word multiply, into one buffer U = [sFIR[:8], up]; then the FIR
outputs of chunk c read U from 2 c batchSize on, at the output indices
that restart per chunk, the 8-tap sum taken modulo 2^32.
`_up2_fir_by_schedule` is that schedule in numpy and is held to the JAX
package's resample_batch for 8, 12 and 16 kHz into 48 kHz, 20 and 10 ms
blocks, the state carried over two frames; a changed chunking is shown
to change the output count or bits.

K9 (csrc/silk_cng.cu) walks only the rows whose mask is on, one thread
each, the LPC in transposed form with its running sums built once from
the incoming state, and copies the other rows and their states.
`_cng_by_schedule` is that in numpy and is held to the Pallas kernel in
interpret mode and to jax_plc.cng_add at orders 10 and 16.

P1 (csrc/celt_plc.cu) is float32 and sums in orders of its own: every
energy and correlation of the pitch search's 2x pass and of the LPC fit
by a warp (lane l takes terms l, l + 32, ... with fmaf, then a fixed
xor-shuffle tree), the 4x correlations and the scans' first window
energies a thread each (even and odd terms apart, then added), Levinson
in registers in the plain version's order, the IIR a warp's 32 samples
at a time (lane j: the step's inputs through the impulse response plus
the 24 outputs before the step through their responses), and the
deemphasis as 32 lanes of 30 samples whose end memories meet in a
shuffle scan.
`_p1_by_schedule` is that kernel in numpy float32, and is held to the
plain version (ops/celt/torch_plc.py) and to the JAX package's
celt_plc_core at P1's bounds (T equal on every row; PCM within 16 LSB,
decode_mem and preemph within 16 LSB in Q12, LPC within 5 % of a
channel's largest coefficient) on tests/test_torch_celt_plc.py's seeded
rows; a scan that drops the lanes' carried memories is shown to break
the PCM bound."""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from esp32_opus_player_tpu.ops.celt import jax_plc
from esp32_opus_player_tpu.ops.celt import jax_synthesis as js
from esp32_opus_player_tpu.ops.silk import jax_core as sjc
from esp32_opus_player_tpu.ops.silk import jax_plc as sjp
from esp32_opus_player_tpu.ops.silk.pallas_core import (
    cng_add_pallas, silk_plc_conceal_pallas)
from esp32_opus_player_tpu.ops.celt.pallas_comb import (
    comb_filter_step_T as jax_comb_step_T)
from esp32_opus_player_tpu_torch.ops.celt import comb, torch_plc
from esp32_opus_player_tpu_torch.ops.tables.celt_tables import window120
from esp32_opus_player_tpu_torch.ops.silk import torch_core as tc
from esp32_opus_player_tpu_torch.ops.silk.core_kernel import silk_core_ref

from torch_port_util import (DBS, OV, assert_equal, comb_params, plc_rows,
                             silk_core_inputs, silk_plc_inputs, t32)

SILK_SETS = [(16, 4, 16), (12, 4, 16), (8, 4, 10), (16, 2, 16)]


# ---- K2: the comb's result does not depend on the chunk length ----------

def _comb_case(N, low):
    """Seeded inputs: 8 streams; rows 0 and 1 at the smallest lag, row 0 a
    no-op, row 1 unchanged params, row 2 with g1 = 0 (comb_params), row 3
    a no-op in region 2 only."""
    rng = np.random.default_rng(1000 + N + low)
    buf = rng.integers(-(1 << 24), 1 << 24, (DBS + OV, 8)).astype(np.int32)
    c1, c2 = comb_params(rng, 8, low), comb_params(rng, 8, low)
    c2[2][3] = c2[3][3] = 0
    return buf, c1, c2


@functools.lru_cache(maxsize=None)
def _jax_comb(N, low):
    """The JAX package's answer: the Pallas kernel in interpret mode
    (N <= 240: it unrolls every chunk), else the XLA chunk walk, both at
    the TPU's chunk of 13."""
    buf, c1, c2 = _comb_case(N, low)
    j1, j2 = (tuple(jnp.asarray(v) for v in c) for c in (c1, c2))
    start = DBS - N
    if N <= 240:
        return np.asarray(jax_comb_step_T(jnp.asarray(buf), start, N, j1,
                                          j2, chunk=13, interpret=True))
    row = js.comb_filter_batch(jnp.asarray(buf.T), start, 120, *j1, chunk=13)
    row = js.comb_filter_batch(row, start + 120, N - 120, *j2, chunk=13)
    return np.asarray(row).T


@pytest.mark.parametrize("N", [120, 240, 480, 960])
@pytest.mark.parametrize("chunk,low", [(1, 15), (5, 15), (13, 15), (32, 34)])
def test_comb_bits_do_not_depend_on_chunk(monkeypatch, N, chunk, low):
    buf, c1, c2 = _comb_case(N, low)
    monkeypatch.setattr(comb, "_CHUNK", chunk)
    got = comb.comb_filter_step_T_ref(t32(buf), DBS - N, N,
                                      tuple(map(t32, c1)),
                                      tuple(map(t32, c2)))
    assert_equal(got, _jax_comb(N, low), f"chunk {chunk}")
    # rows the call must leave bit for bit: the no-op stream, and past
    # region 1's crossfade nothing of the no-op region 2
    assert_equal(got[:, 0], buf[:, 0], "no-op stream")
    assert_equal(got[DBS - N + 120:, 3], buf[DBS - N + 120:, 3],
                 "no-op region 2")


# ---- K7: the kernel's schedule, phase by phase ---------------------------

def _w32(x):
    return ((np.asarray(x, np.int64) + (1 << 31)) % (1 << 32)) - (1 << 31)


def _smulwb(a, b):
    return _w32(_w32((a >> 16) * b) + (_w32((a & 0xFFFF) * b) >> 16))


def _smulww(a, b):
    return _w32((a * b) >> 16)


def _rshift_round(a, s):
    return ((a >> (s - 1)) + 1) >> 1


def _sat16(a):
    return np.clip(a, -32768, 32767)


def _add_sat(a, b):
    """Saturating add by the signs of the wrapped sum (the kernel's)."""
    i32 = np.iinfo(np.int32)
    s = _w32(a + b)
    over = ((a ^ s) & (b ^ s)) < 0
    return np.where(over, np.where(a < 0, i32.min, i32.max), s)


def _lpc_transposed(x, state, a, order):
    """The LPC recurrence over x (B, n) as K7 and K8 run it: running sums
    P[j] built from the state (B, 16, oldest first), then per sample the
    newest tap, the clips and the sign-trick saturating add. Returns the
    outputs (B, n)."""
    i32 = np.iinfo(np.int32)
    B, n = x.shape
    P = np.zeros((B, order), np.int64)
    for i in range(order):
        u = state[:, 15 - i]
        for j in range(order - i):
            P[:, j] = _w32(P[:, j] + _smulwb(u, a[:, j + i]))
    v = np.zeros((B, n), np.int64)
    for i in range(n):
        pred = _w32((order >> 1) + P[:, 0])
        v[:, i] = _add_sat(x[:, i],
                           np.clip(pred, i32.min >> 4, i32.max >> 4) << 4)
        P = np.concatenate([P[:, 1:], np.zeros((B, 1), np.int64)], axis=1)
        P = _w32(P + _smulwb(v[:, i, None], a))
    return v


def _core_by_phases(ob, sLPC0, exc, A, Bq, gains, inv, lag, voiced, rw, adj,
                    match, *, fs, nb, order):
    """decode_core as K7 schedules it, int64 numpy with explicit wraps."""
    (ob, sLPC0, exc, A, Bq, gains, inv, lag, adj) = (
        np.asarray(a, np.int64) for a in (ob, sLPC0, exc, A, Bq, gains, inv,
                                          lag, adj))
    B = exc.shape[0]
    subfr, ltp_mem, W = 5 * fs, 20 * fs, 18 * fs + 4
    frame = nb * subfr
    sl = np.zeros((B, ltp_mem + frame), np.int64)      # LTP state
    wk = ob.copy()                                     # outBuf window
    ex = exc.copy()                                    # exc, then LPC input
    vh = np.concatenate([sLPC0, np.zeros((B, frame), np.int64)], axis=1)
    lag = np.clip(lag, 3, 18 * fs)

    def scaled(c):
        return _sat16(_rshift_round(
            _smulww(vh[:, 16 + c], gains[:, c // subfr] >> 6), 8))

    for k in range(nb):
        a = A[:, k >> 1, :order]
        win_end = ltp_mem + k * subfr
        if k == 2:
            c = np.arange(2 * subfr)
            wk[:, ltp_mem + c] = scaled(c)
        # phase 1: every position of the last lag + 2 from the inputs alone
        for s in range(B):
            if not rw[s, k] and (not voiced[s, k] or match[s, k]):
                continue
            n_pos = min(W, lag[s, k] + 2)
            p = np.arange(win_end - n_pos, win_end)
            if rw[s, k]:
                acc = sum(_w32(wk[s, p - 1 - t] * a[s, t])
                          for t in range(order))
                out = _w32((wk[s, p] << 12) - acc)
                sl[s, p] = _smulwb(inv[s, k], _sat16(_rshift_round(out, 12)))
            else:
                sl[s, p] = _smulww(adj[s, k], sl[s, p])
        # phase 2: the LTP recurrence, a chunk of min(32, lag - 2) samples
        # at a time, every tap of the chunk read before any is written
        for s in range(B):
            ch = min(32, lag[s, k] - 2)
            for c0 in range(0, subfr, ch):
                i = np.arange(c0, min(c0 + ch, subfr))
                g = win_end + i
                pred = np.full(len(i), 2, np.int64)
                for t in range(5):
                    pred = _w32(pred + _smulwb(sl[s, g - lag[s, k] + 2 - t],
                                               Bq[s, k, t]))
                r = _w32(ex[s, k * subfr + i] + _w32(pred << 1))
                sl[s, g] = _w32(r << 1)
                if voiced[s, k]:
                    ex[s, k * subfr + i] = r
        # phase 3: the LPC recurrence in transposed form, its running sums
        # rebuilt here from the gain-adjusted state
        at = 16 + k * subfr
        state = vh[:, at - 16:at]
        state = np.where(match[:, k, None], state,
                         _smulww(adj[:, k, None], state))
        vh[:, at:at + subfr] = _lpc_transposed(
            ex[:, k * subfr:(k + 1) * subfr], state, a, order)
    return scaled(np.arange(frame)), vh[:, frame:frame + 16]


@functools.lru_cache(maxsize=None)
def _core_case(fs, nb, order, seed):
    """Seeded inputs and the schedule's answer: 24 streams, LPC states
    over the whole int32 range; row 0 at lag 2 fs, row 9 at 18 fs; with
    `seed` the coefficients fill int16, so every sum wraps."""
    rng = np.random.default_rng(fs * 10 + nb + seed)
    args = list(silk_core_inputs(rng, 24, fs, nb))
    args[1] = rng.integers(-2 ** 31, 2 ** 31, (24, 16)).astype(np.int32)
    args[7][9] = 18 * fs
    if seed:
        args[3] = rng.integers(-(1 << 15), 1 << 15, (24, 2, 16)).astype(
            np.int32)
    return args, _core_by_phases(*args, fs=fs, nb=nb, order=order)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("fs,nb,order", SILK_SETS)
def test_core_by_phases_matches_plain(fs, nb, order, seed):
    args, got = _core_case(fs, nb, order, seed)
    want = silk_core_ref(*(torch.as_tensor(a) for a in args), fs_khz=fs,
                         nb_subfr=nb, order=order)
    assert_equal(got[0], want[0].numpy(), "xq")
    assert_equal(got[1], want[1].numpy(), "sLPC")


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("fs,nb,order", SILK_SETS)
def test_core_by_phases_matches_jax(fs, nb, order, seed):
    args, got = _core_case(fs, nb, order, seed)
    want = sjc.silk_core_frame_xla(*map(jnp.asarray, args), fs_khz=fs,
                                   nb_subfr=nb, order=order)
    assert_equal(got[0], np.asarray(want[0]), "xq")
    assert_equal(got[1], np.asarray(want[1]), "sLPC")


def test_core_schedule_needs_its_chunk_bound(monkeypatch):
    """The check has teeth: a chunk one sample longer than lag - 2 reads a
    tap that is not finished, and the schedule's bits change."""
    args, good = _core_case(8, 4, 10, 0)
    real_min = min
    monkeypatch.setitem(_core_by_phases.__globals__, "min",
                        lambda *a: real_min(*a) + (a[0] == 32))
    bad = _core_by_phases(*args, fs=8, nb=4, order=10)
    assert not np.array_equal(bad[0], good[0])


# ---- K8: the conceal kernel's schedule, phase by phase -------------------

PLC_SETS = [(16, 4, 16), (12, 4, 10), (8, 4, 10), (16, 2, 16)]
PLC_LAGS = [None, "2fs", "18fs", "drift"]


def _plc_by_phases(ob, sLPC0, rand, A, B4, lag4, inv, pg, *, fs, nb, order,
                   slack=0):
    """conceal as K8 schedules it, int64 numpy with explicit wraps; slack
    lengthens every LTP chunk past its bound (the negative case)."""
    (ob, sLPC0, rand, A, B4, lag4, inv, pg) = (
        np.asarray(a, np.int64) for a in (ob, sLPC0, rand, A, B4, lag4, inv,
                                          pg))
    B = ob.shape[0]
    subfr, lm, W = 5 * fs, 20 * fs, 18 * fs + 2
    frame = nb * subfr
    lo = lm - W
    lag = np.clip(lag4[:, :nb], 2 * fs, 18 * fs)
    # the LTP state over [lm - W, lm + frame): rand staged in its frame
    # part, the positions below lm - (lag0 + 2) zeroed, the rest unset
    st = np.full((B, W + frame), 0x5A5A5A5A, np.int64)
    st[:, W:] = rand[:, :frame]
    a = A[:, :order]
    for s in range(B):
        first = lm - (lag[s, 0] + 2)
        st[s, :first - lo] = 0
        # phase 1: every rewhitened position from the outBuf inputs alone
        p = np.arange(first, lm)
        acc = sum(_w32(ob[s, p - 1 - t] * a[s, t]) for t in range(order))
        out = _w32((ob[s, p] << 12) - acc)
        st[s, p - lo] = _smulwb(inv[s], _sat16(_rshift_round(out, 12)))
        # phase 2: the LTP of every subframe, a chunk of min(32, L - 2)
        # samples at a time, every tap of the chunk read before any is
        # written; a sample's rand is its own word until then
        for k in range(nb):
            L = lag[s, k]
            ch = min(32, L - 2 + slack)
            for c0 in range(0, subfr, ch):
                g = lm + k * subfr + np.arange(c0, min(c0 + ch, subfr)) - lo
                pred = np.full(len(g), 2, np.int64)
                for t in range(5):
                    pred = _w32(pred + _smulwb(st[s, g - L + 2 - t],
                                               B4[s, k, t]))
                st[s, g] = _w32(_w32(pred + st[s, g]) << 2)
    # phase 3: the LPC over the frame, transposed, its running sums built
    # once from the incoming state
    v = _lpc_transposed(st[:, W:], sLPC0, a, order)
    xq = _sat16(_rshift_round(_smulww(v, pg[:, None]), 8))
    return xq, v[:, frame - 16:]


@functools.lru_cache(maxsize=None)
def _plc_case(fs, nb, order, lags):
    """Seeded inputs (10 streams; rows 0-4 with LPC states over the whole
    int32 range, where sums wrap and outputs clip) and the schedule's
    answer."""
    rng = np.random.default_rng(fs * 100 + nb * 10 + order
                                + PLC_LAGS.index(lags))
    args = list(silk_plc_inputs(rng, 10, fs, nb, order, lags))
    args[1][:5] = rng.integers(-2 ** 31, 2 ** 31, (5, 16))
    return args, _plc_by_phases(*args, fs=fs, nb=nb, order=order)


@pytest.mark.parametrize("lags", PLC_LAGS)
@pytest.mark.parametrize("fs,nb,order", PLC_SETS)
def test_plc_by_phases_matches_pallas(fs, nb, order, lags):
    args, got = _plc_case(fs, nb, order, lags)
    pargs = list(args)               # the TPU kernel takes nb rows
    pargs[4], pargs[5] = args[4][:, :nb], args[5][:, :nb]
    want = silk_plc_conceal_pallas(*map(jnp.asarray, pargs), fs_khz=fs,
                                   nb_subfr=nb, order=order, interpret=True)
    assert_equal(got[0], np.asarray(want[0]), "xq")
    assert_equal(got[1], np.asarray(want[1]), "sLPC")


@pytest.mark.parametrize("lags", PLC_LAGS)
@pytest.mark.parametrize("fs,nb,order", PLC_SETS)
def test_plc_by_phases_matches_jax(fs, nb, order, lags):
    args, got = _plc_case(fs, nb, order, lags)
    want = sjp.silk_plc_conceal_frame(*map(jnp.asarray, args), fs_khz=fs,
                                      nb_subfr=nb, order=order)
    assert_equal(got[0], np.asarray(want[0]), "xq")
    assert_equal(got[1], np.asarray(want[1]), "sLPC")


def test_plc_schedule_needs_its_chunk_bound():
    """The check has teeth: with every lag at 2 fs, a chunk one sample
    longer than L - 2 reads a tap that is not finished (its rand), and
    the schedule's bits change."""
    args, good = _plc_case(16, 4, 16, "2fs")
    bad = _plc_by_phases(*args, fs=16, nb=4, order=16, slack=1)
    assert not np.array_equal(bad[0], good[0])


# ---- K3: the deemphasis product as one high-word multiply ----------------

def _mulhi(v, c):
    """The high word of the 64-bit product of two int32 (CUDA __mulhi)."""
    return (np.asarray(v, np.int64) * np.asarray(c, np.int64)) >> 32


def test_deemph_product_is_a_high_word():
    """K3 takes smul(t, 27853) = (t * 27853) >> 15 as __mulhi(t, 27853 <<
    17 read as int32) + t, wrapped: equal for t over the whole int32 range
    (edges, every power of two and its neighbours, a random sample)."""
    rng = np.random.default_rng(3)
    p2 = np.array([1 << k for k in range(31)], np.int64)
    t = np.concatenate([[0, -1, 2 ** 31 - 1, -2 ** 31], p2, p2 - 1, -p2,
                        -p2 - 1, rng.integers(-2 ** 31, 2 ** 31, 200000)])
    want = (t * 27853) >> 15
    c = _w32(27853 << 17)
    assert c < 0
    assert_equal(_w32(_mulhi(t, c) + t), want, "smul")


# ---- K6: the up2 allpass walk and the IIR-FIR epilogue -------------------

UP2_COEFS = [(1746, 14986, -26453), (6854, 25769, -9994)]
FIR_12 = np.asarray(tc._FRAC_FIR_12, np.int64)
# a phase's 8 taps as the kernel's table holds them
FIR_TAPS = np.stack([np.concatenate([FIR_12[t], FIR_12[11 - t][::-1]])
                     for t in range(12)])


def test_up2_products_are_high_words():
    """K6 takes smulwb(y, c) as __mulhi(y, c << 16): equal for y over the
    whole int32 range and each of the six allpass coefficients (|c| <
    2^15)."""
    rng = np.random.default_rng(6)
    p2 = np.array([1 << k for k in range(31)], np.int64)
    y = np.concatenate([[0, -1, 2 ** 31 - 1, -2 ** 31], p2, p2 - 1, -p2,
                        -p2 - 1, rng.integers(-2 ** 31, 2 ** 31, 200000)])
    for c in (c for cs in UP2_COEFS for c in cs):
        assert_equal(_mulhi(y, _w32(c << 16)), _smulwb(y, c), f"c {c}")


def _fir_plan(n, batch, inv):
    """The fused entry's plan, as silk_up2_fir computes it: outputs per
    full chunk, and in all."""
    count = lambda n_in: -(-(n_in << 17) // inv)
    full, last = divmod(n, batch)
    if last == 0 and full > 0:
        full, last = full - 1, batch
    return count(batch), full * count(batch) + count(last)


def _up2_fir_by_schedule(sIIR, sFIR, x, batch, inv):
    """One iir_fir call as K6's fused entry schedules it, int64 numpy
    with explicit wraps: (out, sIIR', sFIR')."""
    sIIR, sFIR, x = (np.asarray(a, np.int64) for a in (sIIR, sFIR, x))
    B, n = x.shape
    U = np.full((B, 8 + 2 * n), 0x5A5A5A5A, np.int64)
    U[:, :8] = sFIR[:, :8]
    s_out = np.empty((B, 6), np.int64)
    # phase 1: each chain walks the whole block alone
    for p, cs in enumerate(UP2_COEFS):
        h0, h1, h2 = (_w32(c << 16) for c in cs)
        S0, S1, S2 = (sIIR[:, 3 * p + j] for j in range(3))
        for t in range(n):
            in32 = _w32(x[:, t] << 10)
            X = _mulhi(_w32(in32 - S0), h0)
            out1, S0 = _w32(S0 + X), _w32(in32 + X)
            X = _mulhi(_w32(out1 - S1), h1)
            out2, S1 = _w32(S1 + X), _w32(out1 + X)
            Y = _w32(out2 - S2)
            X = _w32(Y + _mulhi(Y, h2))
            o, S2 = _w32(S2 + X), _w32(out2 + X)
            U[:, 8 + 2 * t + p] = _sat16(_rshift_round(o, 10))
        s_out[:, 3 * p:3 * p + 3] = np.stack([S0, S1, S2], 1)
    # phase 2: chunk c's outputs from U[2 c batch:], indices restarting
    m_full, n_out = _fir_plan(n, batch, inv)
    out = np.empty((B, n_out), np.int64)
    for c, j0 in enumerate(range(0, n_out, m_full)):
        idx = np.arange(min(m_full, n_out - j0), dtype=np.int64) * inv
        base = 2 * c * batch + (idx >> 16)
        taps = U[:, base[:, None] + np.arange(8)].astype(np.uint32)
        cf = FIR_TAPS[((idx & 0xFFFF) * 12) >> 16].astype(np.uint32)
        acc = (taps * cf[None]).sum(-1, dtype=np.uint32).astype(np.int32)
        out[:, j0:j0 + len(idx)] = _sat16(_rshift_round(
            acc.astype(np.int64), 15))
    f_out = np.concatenate([U[:, 2 * n:2 * n + 8], sFIR[:, 8:]], 1)
    return out, s_out, f_out


def _resample_by_schedule(sIIR, sFIR, delay_buf, inp, *, fs_in_khz,
                          fs_out_khz, in_len):
    """resample_batch's two calls and delay buffer around the fused
    schedule (kind iir_fir)."""
    spec = sjc._resampler_spec(fs_in_khz, fs_out_khz)
    assert spec["kind"] == "iir_fir"
    delay, fs = spec["delay"], fs_in_khz
    n_samples = fs - delay
    db = np.array(delay_buf, np.int64)
    db[:, delay:delay + n_samples] = inp[:, :n_samples]
    kw = dict(batch=spec["batch_size"], inv=spec["inv_ratio"])
    o1, sIIR, sFIR = _up2_fir_by_schedule(sIIR, sFIR, db[:, :fs], **kw)
    o2, sIIR, sFIR = _up2_fir_by_schedule(
        sIIR, sFIR, inp[:, n_samples:n_samples + in_len - fs], **kw)
    delay_buf = np.array(delay_buf, np.int64)
    delay_buf[:, :delay] = inp[:, in_len - delay:in_len]
    return np.concatenate([o1, o2], 1), sIIR, sFIR, delay_buf


@pytest.mark.parametrize("ms", [20, 10])
@pytest.mark.parametrize("fs", [8, 12, 16])
def test_up2_fir_schedule_matches_jax(fs, ms):
    """Two frames through the fused schedule against
    jax_core.resample_batch at 48 kHz out, each frame's state carried
    into the next: the first block of fs samples, then 19 fs (two
    chunks) or 9 fs (one). sIIR over the whole int32 range, sFIR in
    rows 0-2 too."""
    rng = np.random.default_rng(fs * 10 + ms)
    B, n = 6, ms * fs
    state = [rng.integers(-2 ** 31, 2 ** 31, (B, 6)),
             rng.integers(-32768, 32768, (B, 8)),
             rng.integers(-32768, 32768, (B, fs))]
    state[1][:3] = rng.integers(-2 ** 31, 2 ** 31, (3, 8))
    state = [a.astype(np.int32) for a in state]
    j_state = [jnp.asarray(a) for a in state]
    kw = dict(fs_in_khz=fs, fs_out_khz=48, in_len=n)
    for frame in range(2):
        inp = rng.integers(-32768, 32768, (B, n)).astype(np.int32)
        got, *state = _resample_by_schedule(*state, inp, **kw)
        want, *j_state = sjc.resample_batch(*j_state, jnp.asarray(inp),
                                            **kw)
        assert_equal(got, np.asarray(want), f"frame {frame} out")
        for name, g, w in zip(("sIIR", "sFIR", "delay"), state, j_state):
            assert_equal(g, np.asarray(w), f"frame {frame} {name}")


@pytest.mark.parametrize("n,batch,fs_out", [(3, 2, 48), (1, 160, 48),
                                            (31, 10, 24), (160, 160, 48),
                                            (161, 80, 16)])
def test_up2_fir_schedule_matches_plain(n, batch, fs_out):
    """The schedule against the port's plain version (the chunk loop
    over up2_hq_scan) at chunkings the pools do not give: a short last
    chunk, a block of one sample, a block of exactly one chunk, a 16 kHz input
    to 24 and 16 kHz; sFIR wider than 8 (its columns past 8 kept)."""
    rng = np.random.default_rng(n + batch)
    inv = tc._resampler_spec(16, fs_out)["inv_ratio"] if fs_out != 16 \
        else 1 << 15
    args = (rng.integers(-2 ** 31, 2 ** 31, (5, 6)),
            rng.integers(-32768, 32768, (5, 10)),
            rng.integers(-32768, 32768, (5, n)))
    want = tc.iir_fir_chunks(*map(t32, args), batch_size=batch,
                             inv_ratio=inv)
    got = _up2_fir_by_schedule(*args, batch, inv)
    for name, g, w in zip(("out", "sIIR", "sFIR"), got, want):
        assert_equal(g, w, name)


def test_up2_fir_schedule_follows_the_chunking():
    """The check has teeth: the output indices restart per chunk, so a
    changed chunking changes the count (16 to 24 kHz, 31 samples in one
    chunk or in chunks of 7: 47 against 49 outputs) or, where the phases
    drift (an inv_ratio of 40000), the bits at the same count (304
    samples in one chunk or in 160 + 144: 997 outputs). Each chunking
    equals the plain chunk loop's. (At the decoder's ratios into 48 kHz
    the phases drift by less than a bin over the pools' blocks, so their
    chunking changes neither.)"""
    rng = np.random.default_rng(7)
    sIIR = rng.integers(-2 ** 31, 2 ** 31, (4, 6))
    sFIR = rng.integers(-32768, 32768, (4, 8))
    x = rng.integers(-32768, 32768, (4, 304))
    inv24 = tc._resampler_spec(16, 24)["inv_ratio"]
    outs = {}
    for n, inv, batch in ((31, inv24, 31), (31, inv24, 7), (304, 40000, 304),
                          (304, 40000, 160)):
        outs[n, batch] = _up2_fir_by_schedule(sIIR, sFIR, x[:, :n], batch,
                                              inv)[0]
        want = tc.iir_fir_chunks(t32(sIIR), t32(sFIR), t32(x[:, :n]),
                                 batch_size=batch, inv_ratio=inv)[0]
        assert_equal(outs[n, batch], want, f"n {n}, batch {batch}")
    assert outs[31, 31].shape[1] == 47 and outs[31, 7].shape[1] == 49
    assert outs[304, 304].shape == outs[304, 160].shape == (4, 997)
    assert not np.array_equal(outs[304, 304], outs[304, 160])


# ---- K9: comfort noise, the mask-on rows walked --------------------------

CNG_CASES = [(320, 16), (160, 16), (240, 10), (160, 10)]
CNG_MASKS = ["off", "on", "tenth", "random"]


def _cng_by_schedule(xq, exc, A, gain, st0, mask, *, frame, order):
    """cng_add as K9 schedules it: a tile of 16 rows walks only if its
    ballot has a bit set, and then only the rows whose bit is set, the
    LPC transposed over their excitation; the other rows' frames and
    states are copied."""
    xq, exc, A, gain, st0 = (np.asarray(a, np.int64)
                             for a in (xq, exc, A, gain, st0))
    mask = np.asarray(mask, bool)
    out, st = xq[:, :frame].copy(), st0.copy()
    for b0 in range(0, len(mask), 16):
        on = np.flatnonzero(mask[b0:b0 + 16]) + b0
        if len(on) == 0:
            continue
        v = _lpc_transposed(exc[on, :frame], st0[on], A[on, :order], order)
        noise = _sat16(_rshift_round(_smulww(v, gain[on, None]), 8))
        out[on] = _sat16(_w32(xq[on, :frame] + noise))
        st[on] = v[:, frame - 16:]
    return out, st


@functools.lru_cache(maxsize=None)
def _cng_case(frame, order, masks):
    """Seeded inputs (20 rows, two tiles of 16: the second ragged; states
    over the whole int32 range) and the schedule's answer."""
    rng = np.random.default_rng(frame + order + CNG_MASKS.index(masks))
    B = 20
    mask = dict(off=np.zeros(B, bool), on=np.ones(B, bool),
                tenth=np.arange(B) % 10 == 3,
                random=rng.integers(0, 2, B).astype(bool))[masks]
    args = (rng.integers(-32768, 32768, (B, frame)).astype(np.int32),
            rng.integers(-(1 << 16), 1 << 16, (B, frame)).astype(np.int32),
            rng.integers(-(1 << 12), 1 << 12, (B, 16)).astype(np.int32),
            rng.integers(1 << 8, 1 << 14, B).astype(np.int32),
            rng.integers(-2 ** 31, 2 ** 31, (B, 16)).astype(np.int32), mask)
    return args, _cng_by_schedule(*args, frame=frame, order=order)


@pytest.mark.parametrize("masks", CNG_MASKS)
@pytest.mark.parametrize("frame,order", CNG_CASES)
def test_cng_schedule_matches_pallas(frame, order, masks):
    args, got = _cng_case(frame, order, masks)
    want = cng_add_pallas(*map(jnp.asarray, args), frame=frame, order=order,
                          interpret=True)
    assert_equal(got[0], np.asarray(want[0]), "xq")
    assert_equal(got[1], np.asarray(want[1]), "state")


@pytest.mark.parametrize("masks", CNG_MASKS)
@pytest.mark.parametrize("frame,order", CNG_CASES)
def test_cng_schedule_matches_jax(frame, order, masks):
    args, got = _cng_case(frame, order, masks)
    want = sjp.cng_add(*map(jnp.asarray, args), frame=frame, order=order)
    assert_equal(got[0], np.asarray(want[0]), "xq")
    assert_equal(got[1], np.asarray(want[1]), "state")


# ---- P1: the float32 conceal in the kernel's summation orders ------------

F32 = np.float32
PLC_WIN = np.asarray(window120, F32) / F32(32768.0)
PLC_PRE = F32(27853.0 / 32768.0)


def _fma(a, b, c):
    """fmaf: the product and the sum rounded once (float64 holds the
    float32 product exactly)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(F32)


def _p1_warp_dot(a, b):
    """A warp's dot product over the last axis: lane l accumulates terms
    l, l + 32, ... in order with fmaf, then the lanes meet in the xor
    tree (offsets 16, 8, 4, 2, 1)."""
    n = a.shape[-1]
    pad = [(0, 0)] * (a.ndim - 1) + [(0, -n % 32)]
    a = np.pad(a, pad).reshape(*a.shape[:-1], -1, 32)
    b = np.pad(b, pad).reshape(a.shape)
    acc = np.zeros(a.shape[:-2] + (32,), F32)
    for k in range(a.shape[-2]):
        acc = _fma(a[..., k, :], b[..., k, :], acc)
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[..., lanes ^ off]
    return acc[..., 0]


def _p1_lag_window(k):
    t = F32(0.008) * F32(k)
    return F32(1.0) - t * t


def _p1_levinson(ac, p):
    """_celt_lpc over rows (R, p + 1), each product and sum on its own."""
    R = ac.shape[0]
    lpc = np.zeros((R, p), F32)
    error = ac[:, 0].copy()
    done = ac[:, 0] == 0
    for i in range(p):
        rr = ac[:, i + 1].copy()
        for j in range(i):
            rr = rr + lpc[:, j] * ac[:, i - j]
        r = -rr / np.where(error != 0, error, F32(1.0))
        new = lpc.copy()
        new[:, i] = r
        for j in range((i + 1) >> 1):
            t1, t2 = lpc[:, j].copy(), new[:, i - 1 - j].copy()
            new[:, j] = t1 + r * t2
            new[:, i - 1 - j] = t2 + r * t1
        lpc = np.where(done[:, None], lpc, new)
        error = np.where(done, error, error - r * r * error)
        done = done | (error < F32(0.001) * ac[:, 0])
    return lpc


def _p1_best_pitch(xc, y2, Syy, length, max_pitch):
    """find_p1_best_pitch over rows, in lag order."""
    R = xc.shape[0]
    bn0, bn1 = np.full(R, -1, F32), np.full(R, -1, F32)
    bd0, bd1 = np.zeros(R, F32), np.zeros(R, F32)
    bp0, bp1 = np.zeros(R, int), np.ones(R, int)
    for i in range(max_pitch):
        x16 = xc[:, i] * F32(1e-12)
        num = x16 * x16
        c1 = (xc[:, i] > 0) & (num * bd1 > bn1 * Syy)
        c0 = c1 & (num * bd0 > bn0 * Syy)
        bn1 = np.where(c0, bn0, np.where(c1, num, bn1))
        bd1 = np.where(c0, bd0, np.where(c1, Syy, bd1))
        bp1 = np.where(c0, bp0, np.where(c1, i, bp1))
        bn0 = np.where(c0, num, bn0)
        bd0 = np.where(c0, Syy, bd0)
        bp0 = np.where(c0, i, bp0)
        Syy = np.maximum(F32(1.0), Syy + y2[:, i + length] - y2[:, i])
    return bp0, bp1


def _p1_pitch(buf, CC):
    """celt_plc_pitch_search as P1 schedules it; buf (R, CC, 2168)."""
    R = buf.shape[0]
    rows = np.arange(R)
    x = buf[:, 0, :DBS] + buf[:, 1, :DBS] if CC == 2 else buf[:, 0, :DBS]
    x_lp = np.empty((R, 1024), F32)
    x_lp[:, 0] = F32(0.25) * x[:, 1] + F32(0.5) * x[:, 0]
    x_lp[:, 1:] = (F32(0.25) * (x[:, 1:2046:2] + x[:, 3:2048:2])
                   + F32(0.5) * x[:, 2:2047:2])
    ac = np.stack([_p1_warp_dot(x_lp[:, :1024 - k], x_lp[:, k:])
                   for k in range(5)], 1)
    ac[:, 0] *= F32(1.0001)
    for k in range(1, 5):
        ac[:, k] *= _p1_lag_window(k)
    l4 = _p1_levinson(ac, 4)
    g = F32(0.9)
    for k in range(4):
        l4[:, k] = l4[:, k] * g
        g = g * F32(0.9)
    c1 = F32(0.8)
    fir = [l4[:, 0] + F32(0.8), l4[:, 1] + c1 * l4[:, 0],
           l4[:, 2] + c1 * l4[:, 1], l4[:, 3] + c1 * l4[:, 2], c1 * l4[:, 3]]
    xw = x_lp.copy()
    for k in range(5):
        past = np.concatenate([np.zeros((R, k + 1), F32),
                               x_lp[:, :1023 - k]], 1)
        xw = xw + fir[k][:, None] * past
    x4 = xw[:, ::2]

    def square_sum(v):
        """The scans' first window energy, a thread's: four accumulators
        over i mod 4, then (0 + 1) + (2 + 3)."""
        acc = [np.zeros(R, F32) for _ in range(4)]
        for n in range(v.shape[1]):
            acc[n % 4] = _fma(v[:, n], v[:, n], acc[n % 4])
        return (acc[0] + acc[1]) + (acc[2] + acc[3])

    # 4x: a thread a lag, even and odd terms apart
    xc = np.zeros((R, 311), F32)
    for q in range(155):
        acc0, acc1 = np.zeros(R, F32), np.zeros(R, F32)
        for n in range(0, 332, 2):
            acc0 = _fma(x4[:, 180 + n], x4[:, q + n], acc0)
            acc1 = _fma(x4[:, 181 + n], x4[:, q + n + 1], acc1)
        xc[:, q] = acc0 + acc1
    b0, b1 = _p1_best_pitch(xc, x4 * x4, F32(1.0) + square_sum(x4[:, :332]),
                            332, 155)
    # 2x: the lags within +-2 of the doubled candidates, warp sums
    xc2 = np.zeros((R, 311), F32)
    syy = square_sum(xw[:, :664])
    for q in range(10):
        lag = np.where(q < 5, 2 * b0, 2 * b1) - 2 + q % 5
        ok = (lag >= 0) & (lag < 310) & (
            (q < 5) | (lag < 2 * b0 - 2) | (lag > 2 * b0 + 2))
        lagc = np.clip(lag, 0, 309)
        win_y = xw[rows[:, None], lagc[:, None] + np.arange(664)]
        v = _p1_warp_dot(xw[:, 360:1024], win_y)
        xc2[rows[ok], lagc[ok]] = np.maximum(F32(-1.0), v[ok])
    p, _ = _p1_best_pitch(xc2, xw * xw, F32(1.0) + syy, 664, 310)
    a, b = xc2[rows, np.maximum(p - 1, 0)], xc2[rows, p]
    c = xc2[rows, np.minimum(p + 1, 309)]
    off = np.where(c - a > F32(0.7) * (b - a), 1,
                   np.where(a - c > F32(0.7) * (b - c), -1, 0))
    off = np.where((p > 0) & (p < 309), off, 0)
    return 720 - (2 * p - off)


def _p1_deemph_scan(x, m0, carry=True):
    """The deemphasis as the kernel's warp runs it: x (R, 960), m0 (R,);
    lane l walks samples [30 l, 30 l + 30) from a zero memory, the lanes'
    end memories meet in a shuffle scan (m_l = kPre^30 m_{l-1} + own),
    then each lane walks again from the memory before it. Returns (t
    (R, 960), the memory after the last sample)."""
    R = x.shape[0]
    xl = x.reshape(R, 32, 30)
    m = np.zeros((R, 32), F32)
    for u in range(30):
        m = PLC_PRE * (xl[:, :, u] + m)
    A = F32(1.0)
    for _ in range(30):
        A = PLC_PRE * A
    m[:, 0] = _fma(A, m0, m[:, 0])
    ad = A
    for d in (1, 2, 4, 8, 16):
        up = np.concatenate([np.zeros((R, d), F32), m[:, :-d]], 1)
        m = np.where(np.arange(32) >= d, _fma(ad, up, m), m)
        ad = ad * ad
    mi = np.concatenate([m0[:, None], m[:, :-1]], 1)
    if not carry:
        mi = np.where(np.arange(32) == 0, mi, F32(0.0))
    t = np.empty_like(xl)
    for u in range(30):
        t[:, :, u] = xl[:, :, u] + mi
        mi = PLC_PRE * t[:, :, u]
    return t.reshape(R, 960), mi[:, 31]


def _p1_iir(x, a, hist):
    """The IIR y[t] = x[t] - sum_k a_k y[t - 1 - k] over x (R, 1080) as the
    kernel's warp steps it, 32 samples a step: h, the first 32 impulse-
    response samples (transposed form, fmaf); G[j, k] = sum_{t <= min(j,
    23 - k)} h[j - t] (-a[t + k]), the response j samples into a step to
    the k-th state (the output k + 1 samples before it); lane j's output
    (z0 + z1) + (p0 + p1), z the step's inputs through h (even and odd m
    apart), p the 24 outputs before the step through G[j] (even and odd k
    apart): z sums h[j - i] x[t0 + i] over the step's inputs i = 0..31 in
    order (h is 0 before its start, x past its end). hist (R, 24): the
    history's last 24 samples, oldest first."""
    R, n = x.shape
    st = [np.zeros(R, F32) for _ in range(24)]
    h = np.empty((R, 32), F32)
    for m in range(32):
        yn = F32(1.0 if m == 0 else 0.0) + st[0]
        h[:, m] = yn
        st = [_fma(-a[:, k], yn, st[k + 1]) for k in range(23)] + [
            -a[:, 23] * yn]
    G = np.zeros((R, 32, 24), F32)
    for j in range(32):
        for k in range(24):
            for t in range(min(j, 23 - k) + 1):
                G[:, j, k] = _fma(h[:, j - t], -a[:, t + k], G[:, j, k])
    y = np.concatenate([hist, np.zeros((R, n), F32)], 1)     # y[24 + t]
    hpad = np.concatenate([np.zeros((R, 32), F32), h], 1)
    xpad = np.concatenate([x, np.zeros((R, 32), F32)], 1)
    lanes = np.arange(32)
    for t0 in range(0, n, 32):
        z = [np.zeros((R, 32), F32), np.zeros((R, 32), F32)]
        for i in range(32):
            z[i % 2] = _fma(hpad[:, 32 + lanes - i], xpad[:, t0 + i, None],
                            z[i % 2])
        p = [np.zeros((R, 32), F32), np.zeros((R, 32), F32)]
        for k in range(24):
            p[k % 2] = _fma(G[:, :, k], y[:, 24 + t0 - 1 - k][:, None],
                            p[k % 2])
        out = (z[0] + z[1]) + (p[0] + p[1])
        w = min(32, n - t0)
        y[:, 24 + t0:24 + t0 + w] = out[:, :w]
    return y[:, 24:]


def _p1_by_schedule(dm, pre, pitch, lpc, first, CC, carry=True):
    """celt_plc_core as P1 schedules it, numpy float32; the arguments and
    results are celt_plc_core's. (A repeated conceal's random carried LPC
    may make its IIR overflow; the energy clamp then silences the row, as
    in the kernel and the plain version.)"""
    with np.errstate(over="ignore", invalid="ignore"):
        return _p1_rows(dm, pre, pitch, lpc, first, CC, carry)


def _p1_rows(dm, pre, pitch, lpc, first, CC, carry):
    R = dm.shape[0]
    rows = np.arange(R)
    buf = dm.astype(F32) / F32(4096.0)
    T = np.where(first, _p1_pitch(buf, CC), pitch)
    T = np.clip(T, 100, 720)
    fade = np.where(first, F32(1.0), F32(0.8))
    exc_len = np.minimum(2 * T, 1024)
    dl = exc_len >> 1
    i_mp, i_el = np.arange(1024), np.arange(1080)
    pcm = np.empty((R, 960, CC), np.int16)
    dm2, pre2, lpc2 = np.empty_like(dm), np.empty_like(pre), lpc.copy()
    for c in range(CC):
        exc = buf[:, c, 1024:2048]
        w = exc.copy()
        w[:, :120] *= PLC_WIN
        w[:, 904:] *= PLC_WIN[::-1]
        ac = np.stack([_p1_warp_dot(w[:, :1024 - k], w[:, k:])
                       for k in range(25)], 1)
        ac[:, 0] *= F32(1.0001)
        for k in range(1, 25):
            ac[:, k] *= _p1_lag_window(k)
        a = np.where(first[:, None], _p1_levinson(ac, 24), lpc[:, c])
        lpc2[:, c] = a
        wh = exc.copy()
        for j in range(24):
            wh = wh + a[:, j:j + 1] * buf[:, c, 1023 - j:2047 - j]
        exc_w = np.where(i_mp >= 1024 - exc_len[:, None], wh, exc)
        in1 = i_mp >= 1024 - dl[:, None]
        in2 = (i_mp >= 1024 - exc_len[:, None]) & ~in1
        e1 = np.where(in1, exc_w, F32(0.0))
        e2 = np.where(in2, exc_w, F32(0.0))
        E1 = F32(1.0) + _p1_warp_dot(e1, e1)
        E2 = F32(1.0) + _p1_warp_dot(e2, e2)
        decay = np.sqrt(np.minimum(E1, E2) / E2)
        att, pw = [], decay
        for _ in range(11):
            att.append(fade * pw)
            pw = pw * decay
        att = np.stack(att, 1)
        jmod, wraps = i_el % T[:, None], i_el // T[:, None]
        src = buf[rows[:, None], c, 2048 - T[:, None] + jmod]
        S1 = _p1_warp_dot(src, src) / F32(1024.0)
        x = (att[rows[:, None], wraps]
             * exc_w[rows[:, None], 1024 - T[:, None] + jmod])
        syn = _p1_iir(x, a, buf[:, c, 2024:2048])
        S2 = _p1_warp_dot(syn, syn) / F32(1024.0)
        ratio = np.sqrt((S1 / F32(2.0) + F32(1.0))
                        / (S2 / F32(2.0) + F32(1.0)))
        g = np.concatenate([F32(1.0) - PLC_WIN[None, :]
                            * (F32(1.0) - ratio[:, None]),
                            np.repeat(ratio[:, None], 960, 1)], 1)
        syn = np.where((S1 < S2)[:, None], syn * g, syn)
        syn = np.where((S1 > F32(0.25) * S2)[:, None], syn, F32(0.0))
        h = PLC_WIN[:60] * syn[:, 1079:1019:-1] + PLC_WIN[60:][::-1] \
            * syn[:, 960:1020]
        b2 = np.concatenate([buf[:, c, 960:2048], syn[:, :960], h,
                             buf[:, c, 2108:]], 1)
        dm2[:, c] = np.rint(np.clip(b2, -524288.0, 524287.0)
                            * F32(4096.0)).astype(np.int32)
        t, m = _p1_deemph_scan(syn[:, :960], pre[:, c].astype(F32)
                            / F32(4096.0), carry)
        pcm[:, :, c] = np.clip(np.rint(t), -32768, 32767)
        pre2[:, c] = np.rint(m * F32(4096.0)).astype(np.int32)
    return pcm, dm2, pre2, T.astype(np.int32), lpc2


def _p1_err(got, want):
    """The measured distances of P1's bounds; T must be equal."""
    pcm, dm, pre, T, lpc = (np.asarray(v) for v in got)
    rp, rdm, rpre, rT, rlpc = (np.asarray(v) for v in want)
    assert_equal(T, rT, "T")
    d = lambda x, y: int(np.abs(x.astype(np.int64) - y).max())
    return dict(pcm=d(pcm, rp), dm=d(dm, rdm), pre=d(pre, rpre),
                lpc=float((np.abs(lpc - rlpc).max(2)
                           / np.maximum(1.0, np.abs(rlpc).max(2))).max()))


@functools.lru_cache(maxsize=None)
def _p1_case(CC):
    """tests/test_torch_celt_plc.py's seeded rows (8, first and repeated
    conceals, both pitch clamps) and the schedule's answer."""
    args = plc_rows(np.random.default_rng(7 + CC), 8, CC)
    return args, _p1_by_schedule(*args, CC)


@pytest.mark.parametrize("against", ["plain", "jax"])
@pytest.mark.parametrize("CC", [1, 2])
def test_p1_by_schedule_within_bounds(CC, against):
    args, got = _p1_case(CC)
    if against == "plain":
        want = torch_plc.celt_plc_core(*map(torch.tensor, args), CC=CC)
    else:
        want = jax_plc.celt_plc_core(*args, CC=CC)
    err = _p1_err(got, want)
    print(f"P1 schedule against {against}, CC {CC}: {err}")
    assert err["pcm"] <= 16 and err["dm"] <= 16 * 4096, err
    assert err["pre"] <= 16 * 4096 and err["lpc"] <= 0.05, err


def test_p1_deemph_scan_needs_its_carry():
    """The check has teeth: lanes that start from a zero memory instead of
    the scanned one put the PCM far outside its bound."""
    args, _ = _p1_case(1)
    bad = _p1_by_schedule(*args, 1, carry=False)
    want = torch_plc.celt_plc_core(*map(torch.tensor, args), CC=1)
    assert _p1_err(bad, want)["pcm"] > 16
