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
the int32 range."""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from esp32_opus_player_tpu.ops.celt import jax_synthesis as js
from esp32_opus_player_tpu.ops.silk import jax_core as sjc
from esp32_opus_player_tpu.ops.silk import jax_plc as sjp
from esp32_opus_player_tpu.ops.silk.pallas_core import (
    silk_plc_conceal_pallas)
from esp32_opus_player_tpu.ops.celt.pallas_comb import (
    comb_filter_step_T as jax_comb_step_T)
from esp32_opus_player_tpu_torch.ops.celt import comb
from esp32_opus_player_tpu_torch.ops.silk.core_kernel import silk_core_ref

from torch_port_util import (DBS, OV, assert_equal, comb_params,
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
