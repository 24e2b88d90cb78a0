"""The two independence claims the H100 schedules of K2 and K7 rest on,
held on the CPU, bit for bit (tolerance 0: int32 fixed point).

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
wraps, and rows at the lag edges 2 fs and 18 fs."""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from esp32_opus_player_tpu.ops.celt import jax_synthesis as js
from esp32_opus_player_tpu.ops.silk import jax_core as sjc
from esp32_opus_player_tpu.ops.celt.pallas_comb import (
    comb_filter_step_T as jax_comb_step_T)
from esp32_opus_player_tpu_torch.ops.celt import comb
from esp32_opus_player_tpu_torch.ops.silk.core_kernel import silk_core_ref

from torch_port_util import (DBS, OV, assert_equal, comb_params,
                             silk_core_inputs, t32)

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


def _core_by_phases(ob, sLPC0, exc, A, Bq, gains, inv, lag, voiced, rw, adj,
                    match, *, fs, nb, order):
    """decode_core as K7 schedules it, int64 numpy with explicit wraps."""
    (ob, sLPC0, exc, A, Bq, gains, inv, lag, adj) = (
        np.asarray(a, np.int64) for a in (ob, sLPC0, exc, A, Bq, gains, inv,
                                          lag, adj))
    B = exc.shape[0]
    subfr, ltp_mem, W = 5 * fs, 20 * fs, 18 * fs + 4
    frame = nb * subfr
    i32 = np.iinfo(np.int32)
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
        # phase 3: the LPC recurrence in transposed form: P[j] is what the
        # outputs so far add to the prediction j samples on, rebuilt here
        # from the gain-adjusted state
        P = np.zeros((B, order), np.int64)
        at = 16 + k * subfr
        for i in range(order):
            u = vh[:, at - 1 - i]
            u = np.where(match[:, k], u, _smulww(adj[:, k], u))
            for j in range(order - i):
                P[:, j] = _w32(P[:, j] + _smulwb(u, a[:, j + i]))
        for i in range(subfr):
            pred = _w32((order >> 1) + P[:, 0])
            v = _add_sat(ex[:, k * subfr + i],
                         np.clip(pred, i32.min >> 4, i32.max >> 4) << 4)
            P = np.concatenate([P[:, 1:], np.zeros((B, 1), np.int64)], axis=1)
            P = _w32(P + _smulwb(v[:, None], a))
            vh[:, at + i] = v
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
