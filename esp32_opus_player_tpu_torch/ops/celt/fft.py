"""The CELT iMDCT core (kernel K1) and its plain torch twin.

`fft_blocks(freq_T, shift, Bblk)` computes what
esp32_opus_player_tpu/ops/celt/pallas_fft.py::fft_blocks_pallas computes:
for each of Bblk interleaved MDCT blocks, the pre-rotation (static
bitrev∘interleave gather + Q15 twiddles), the mixed-radix 2/3/4/5 kiss
FFT and the post-rotation, in the transposed layout (FFT index on rows,
streams on columns). On a CUDA tensor it launches csrc/celt_fft.cu; on a
CPU tensor it runs `fft_blocks_ref`, the port of the XLA path it replaced
(jax_synthesis.opus_fft_batch with imdct_prerotate/imdct_postrotate),
written over the same static plan. Both are bit-exact to the reference
(clt_mdct_backward src/celt.cpp:3204-3280, opus_fft_impl :2997).

`celt_imdct_tdac_T(freq_T, dcc, tr, LM=)` is K1's second entry, the one
the CELT frame step runs: one channel's whole frame iMDCT, each stream by
its own block structure (`tr`), with the post-rotate interleave, the TDAC
mirror, the clamp and the decode_mem stores as the kernel's epilogue, in
place in `dcc`. Its plain version `celt_imdct_tdac_T_ref` is the JAX
step's composition (jax_synthesis_T.celt_synth_step_dual_T:221-233):
both block structures through `celt_imdct_frame_T`, a per-stream select,
the clamp and the two row stores.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..tables.celt_tables import (fft_bitrev60, fft_bitrev120,
                                  fft_bitrev240, fft_bitrev480,
                                  fft_twiddles48000_960)
from .torch_synthesis import (DECODE_BUFFER_SIZE, I32, OVERLAP,
                              SHORT_MDCT_SIZE, SIG_SAT, TRIG as _TRIG,
                              WINDOW, const, imdct_tdac, smul)

_TW = np.asarray(fft_twiddles48000_960, dtype=np.int32)   # (480, 2) r, i


class FFTState:
    """One kiss-FFT plan (esp32_opus_player_tpu/ops/celt/synthesis.py
    FFTState): size, downshift, (radix, m) stages, bit-reversal."""

    def __init__(self, nfft, shift, factors, bitrev):
        self.nfft = nfft
        self.shift = shift
        self.factors = factors
        self.bitrev = bitrev.astype(np.int64)


FFT_STATES = {
    0: FFTState(480, -1, [(5, 96), (3, 32), (4, 8), (2, 4), (4, 1)],
                fft_bitrev480),
    1: FFTState(240, 1, [(5, 48), (3, 16), (4, 4), (4, 1)], fft_bitrev240),
    2: FFTState(120, 2, [(5, 24), (3, 8), (2, 4), (4, 1)], fft_bitrev120),
    3: FFTState(60, 3, [(5, 12), (3, 4), (4, 1)], fft_bitrev60),
}


@functools.lru_cache(maxsize=None)
def _plan(shift: int, Bblk: int):
    """Static gather indices + twiddles for one (shift, Bblk) variant
    (copied from pallas_fft._plan). Each stage is (p, m, fs): radix p,
    m butterflies per group, twiddle stride fs; stage twiddle q of
    butterfly j is _TW[q * j * fs], read so by the twin and the
    kernel."""
    st = FFT_STATES[shift]
    nfft = st.nfft                      # == N4
    N = 1920 >> shift
    N2, N4 = N >> 1, N >> 2
    assert N4 == nfft
    trig_off = sum(1920 >> s for s in range(1, shift + 1))
    sh = st.shift if st.shift > 0 else 0

    rev = np.asarray(st.bitrev, dtype=np.int64)
    inv = np.empty_like(rev)
    inv[rev] = np.arange(N4)
    idx = np.arange(N4)

    # input gather (freq row per kernel row) and pre-rotation twiddles,
    # both already in bitrev order (kernel row j <- pre-rotate index
    # inv[j] of block b)
    i1g = np.empty(Bblk * N4, dtype=np.int64)
    i2g = np.empty(Bblk * N4, dtype=np.int64)
    stride = Bblk
    for b in range(Bblk):
        i1 = b + 2 * stride * idx
        i2 = b + stride * (N2 - 1) - 2 * stride * idx
        i1g[b * N4:(b + 1) * N4] = i1[inv]
        i2g[b * N4:(b + 1) * N4] = i2[inv]
    pre = np.stack([_TRIG[trig_off + idx], _TRIG[trig_off + N4 + idx]],
                   axis=1)[inv]                     # (N4, 2)
    pre = np.tile(pre, (Bblk, 1)).astype(np.int32)  # (rows, 2)
    post = np.stack([_TRIG[trig_off + idx], _TRIG[trig_off + N4 + idx]],
                    axis=1).astype(np.int32)        # (N4, 2)
    post = np.tile(post, (Bblk, 1))

    # stage descriptors, processed lvl = L-1 .. 0
    factors = st.factors
    L = len(factors)
    fstride = [1]
    for lvl in range(L):
        fstride.append(fstride[lvl] * factors[lvl][0])
    stages = []
    for lvl in range(L - 1, -1, -1):
        p, m = factors[lvl]
        assert (p == 2 and m == 4) or (p == 4) or (p in (3, 5) and m > 1)
        stages.append((p, m, fstride[lvl] << sh))
    rows = Bblk * N4
    return dict(rows=rows, nfft=nfft, N2=N2, N4=N4, i1g=i1g, i2g=i2g,
                pre=pre, post=post, stages=stages)


@functools.lru_cache(maxsize=None)
def _plan_tensors(shift: int, Bblk: int, device: torch.device):
    """The plan's tables on `device`, built once per device."""
    plan = _plan(shift, Bblk)
    return dict(
        i1g=const(plan["i1g"], device),
        i2g=const(plan["i2g"], device),
        pre=const(plan["pre"], device),
        post=const(plan["post"], device),
        tw_table=const(_TW, device),
        stages=np.asarray(plan["stages"], dtype=np.int32).reshape(-1, 3),
    )


# ---------------------------------------------------------------------
# plain torch twin (one kiss stage = one strided view of the work rows)
# ---------------------------------------------------------------------

def _cmul(ar, ai, br, bi):
    return smul(ar, br) - smul(ai, bi), smul(ar, bi) + smul(ai, br)


def _stage_b2(r, i_, n):
    # kf_bfly2 (src/celt.cpp:2545): groups of 8 = (p=2, m=4) with the
    # fixed sqrt(1/2) twiddle 23170
    tw = 23170
    R = r.reshape(n // 8, 8, -1)
    I = i_.reshape(n // 8, 8, -1)
    f0r, f0i = R[:, 0:4], I[:, 0:4]
    f2r, f2i = R[:, 4:8], I[:, 4:8]
    t1r = smul(f2r[:, 1:2] + f2i[:, 1:2], tw)
    t1i = smul(f2i[:, 1:2] - f2r[:, 1:2], tw)
    t3r = smul(f2i[:, 3:4] - f2r[:, 3:4], tw)
    t3i = smul(-(f2i[:, 3:4] + f2r[:, 3:4]), tw)
    tr = torch.cat([f2r[:, 0:1], t1r, f2i[:, 2:3], t3r], dim=1)
    ti = torch.cat([f2i[:, 0:1], t1i, -f2r[:, 2:3], t3i], dim=1)
    nr = torch.cat([f0r + tr, f0r - tr], dim=1)
    ni = torch.cat([f0i + ti, f0i - ti], dim=1)
    return nr.reshape(n, -1), ni.reshape(n, -1)


def _stage_b4m1(r, i_, n):
    R = r.reshape(n // 4, 4, -1)
    I = i_.reshape(n // 4, 4, -1)
    s0r = R[:, 0] - R[:, 2]
    s0i = I[:, 0] - I[:, 2]
    f0r = R[:, 0] + R[:, 2]
    f0i = I[:, 0] + I[:, 2]
    s1r = R[:, 1] + R[:, 3]
    s1i = I[:, 1] + I[:, 3]
    d1r = R[:, 1] - R[:, 3]
    d1i = I[:, 1] - I[:, 3]
    nr = torch.stack([f0r + s1r, s0r + d1i, f0r - s1r, s0r - d1i], dim=1)
    ni = torch.stack([f0i + s1i, s0i - d1r, f0i - s1i, s0i + d1r], dim=1)
    return nr.reshape(n, -1), ni.reshape(n, -1)


def _twiddle(tw, q, m):
    """Twiddle q of the stage's m butterflies: tw is (tw_table, fs)."""
    table, fs = tw
    w = table[torch.arange(m, device=table.device) * (q * fs)]
    return w[:, 0].reshape(1, m, 1), w[:, 1].reshape(1, m, 1)


def _stage_b4(r, i_, n, m, tw):
    R = r.reshape(n // (4 * m), 4, m, -1)
    I = i_.reshape(n // (4 * m), 4, m, -1)
    s0r, s0i = _cmul(R[:, 1], I[:, 1], *_twiddle(tw, 1, m))
    s1r, s1i = _cmul(R[:, 2], I[:, 2], *_twiddle(tw, 2, m))
    s2r, s2i = _cmul(R[:, 3], I[:, 3], *_twiddle(tw, 3, m))
    s5r = R[:, 0] - s1r
    s5i = I[:, 0] - s1i
    f0r = R[:, 0] + s1r
    f0i = I[:, 0] + s1i
    s3r = s0r + s2r
    s3i = s0i + s2i
    s4r = s0r - s2r
    s4i = s0i - s2i
    nr = torch.stack([f0r + s3r, s5r + s4i, f0r - s3r, s5r - s4i], dim=1)
    ni = torch.stack([f0i + s3i, s5i - s4r, f0i - s3i, s5i + s4r], dim=1)
    return nr.reshape(n, -1), ni.reshape(n, -1)


def _stage_b3(r, i_, n, m, tw):
    epi3i = -28378
    R = r.reshape(n // (3 * m), 3, m, -1)
    I = i_.reshape(n // (3 * m), 3, m, -1)
    s1r, s1i = _cmul(R[:, 1], I[:, 1], *_twiddle(tw, 1, m))
    s2r, s2i = _cmul(R[:, 2], I[:, 2], *_twiddle(tw, 2, m))
    s3r = s1r + s2r
    s3i = s1i + s2i
    s0r = s1r - s2r
    s0i = s1i - s2i
    f1r = R[:, 0] - (s3r >> 1)
    f1i = I[:, 0] - (s3i >> 1)
    s0r = smul(s0r, epi3i)
    s0i = smul(s0i, epi3i)
    nr = torch.stack([R[:, 0] + s3r, f1r - s0i, f1r + s0i], dim=1)
    ni = torch.stack([I[:, 0] + s3i, f1i + s0r, f1i - s0r], dim=1)
    return nr.reshape(n, -1), ni.reshape(n, -1)


def _stage_b5(r, i_, n, m, tw):
    yar, yai = 10126, -31164
    ybr, ybi = -26510, -19261
    R = r.reshape(n // (5 * m), 5, m, -1)
    I = i_.reshape(n // (5 * m), 5, m, -1)
    s0r, s0i = R[:, 0], I[:, 0]
    s1r, s1i = _cmul(R[:, 1], I[:, 1], *_twiddle(tw, 1, m))
    s2r, s2i = _cmul(R[:, 2], I[:, 2], *_twiddle(tw, 2, m))
    s3r, s3i = _cmul(R[:, 3], I[:, 3], *_twiddle(tw, 3, m))
    s4r, s4i = _cmul(R[:, 4], I[:, 4], *_twiddle(tw, 4, m))
    s7r, s7i = s1r + s4r, s1i + s4i
    s10r, s10i = s1r - s4r, s1i - s4i
    s8r, s8i = s2r + s3r, s2i + s3i
    s9r, s9i = s2r - s3r, s2i - s3i
    o0r = s0r + (s7r + s8r)
    o0i = s0i + (s7i + s8i)
    s5r = s0r + (smul(s7r, yar) + smul(s8r, ybr))
    s5i = s0i + (smul(s7i, yar) + smul(s8i, ybr))
    s6r = smul(s10i, yai) + smul(s9i, ybi)
    s6i = -(smul(s10r, yai) + smul(s9r, ybi))
    s11r = s0r + (smul(s7r, ybr) + smul(s8r, yar))
    s11i = s0i + (smul(s7i, ybr) + smul(s8i, yar))
    s12r = smul(s9i, yai) - smul(s10i, ybi)
    s12i = smul(s10r, ybi) - smul(s9r, yai)
    nr = torch.stack([o0r, s5r - s6r, s11r + s12r, s11r - s12r, s5r + s6r],
                     dim=1)
    ni = torch.stack([o0i, s5i - s6i, s11i + s12i, s11i - s12i, s5i + s6i],
                     dim=1)
    return nr.reshape(n, -1), ni.reshape(n, -1)


def fft_blocks_ref(freq_T, shift: int, Bblk: int):
    """Plain torch twin of K1. freq_T: (N_freq, B) int32. Returns (yr,
    yi), each (Bblk*N4, B) int32: post-rotated FFT outputs per block
    (block b in rows [b*N4, (b+1)*N4))."""
    plan = _plan(shift, Bblk)
    t = _plan_tensors(shift, Bblk, freq_T.device)
    n = plan["rows"]
    xp1 = freq_T.index_select(0, t["i1g"])
    xp2 = freq_T.index_select(0, t["i2g"])
    t0, t1 = t["pre"][:, 0:1], t["pre"][:, 1:2]
    yr = smul(xp2, t0) + smul(xp1, t1)
    yi = smul(xp1, t0) - smul(xp2, t1)
    r, i_ = yi, yr          # rbuf <- yi, ibuf <- yr (prerotate swap)
    for p, m, fs in plan["stages"]:
        tw = (t["tw_table"], fs)
        if p == 2:
            r, i_ = _stage_b2(r, i_, n)
        elif m == 1:
            r, i_ = _stage_b4m1(r, i_, n)
        elif p == 4:
            r, i_ = _stage_b4(r, i_, n, m, tw)
        elif p == 3:
            r, i_ = _stage_b3(r, i_, n, m, tw)
        else:
            r, i_ = _stage_b5(r, i_, n, m, tw)
    re, im = i_, r
    p0, p1 = t["post"][:, 0:1], t["post"][:, 1:2]
    return smul(re, p0) + smul(im, p1), smul(re, p1) - smul(im, p0)


# ---------------------------------------------------------------------
# kernel K1
# ---------------------------------------------------------------------

def fft_blocks(freq_T, shift: int, Bblk: int):
    """K1's bare entry: (yr, yi) as fft_blocks_ref, one plan for every
    stream. CPU tensors take the twin; CUDA tensors launch
    csrc/celt_fft.cu (never the twin). No pool calls it: the frame step
    runs the fused entry, celt_imdct_tdac_T."""
    if freq_T.device.type == "cpu":
        return fft_blocks_ref(freq_T, shift, Bblk)
    from .. import _build
    if freq_T.device.type != "cuda":
        raise ValueError(f"fft_blocks: unsupported device {freq_T.device}")
    if freq_T.dtype != I32 or freq_T.dim() != 2:
        raise ValueError("fft_blocks: freq_T must be a 2-D int32 tensor")
    plan = _plan(shift, Bblk)
    if freq_T.shape[0] < Bblk * plan["N2"]:
        raise ValueError("fft_blocks: freq_T has too few rows for the plan")
    freq_T = freq_T.contiguous()
    B = freq_T.shape[1]
    t = _plan_tensors(shift, Bblk, freq_T.device)
    yr = torch.empty((plan["rows"], B), dtype=I32, device=freq_T.device)
    yi = torch.empty_like(yr)
    st = t["stages"]
    with torch.cuda.device(freq_T.device):
        err = _build.lib().celt_fft_blocks(
            freq_T.data_ptr(), B, yr.data_ptr(), yi.data_ptr(),
            t["i1g"].data_ptr(), t["i2g"].data_ptr(),
            t["pre"].data_ptr(), t["post"].data_ptr(),
            t["tw_table"].data_ptr(), plan["rows"], plan["nfft"], len(st),
            st.ctypes.data_as(ctypes.c_void_p),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "celt_fft_blocks")
    fft_blocks.launches += 1
    return yr, yi


fft_blocks.launches = 0


# ---------------------------------------------------------------------
# kernel K1, fused entry: one frame's iMDCT + TDAC, in place
# ---------------------------------------------------------------------

def _variant(LM: int, transient: bool):
    """(Bblk, samples a block, shift) of one block structure."""
    N = SHORT_MDCT_SIZE << LM
    if transient:
        return 1 << LM, SHORT_MDCT_SIZE, 3
    return 1, N, 3 - LM


def celt_imdct_frame_T(freq_T, hist_T, LM: int, transient: bool,
                       fft=fft_blocks_ref):
    """Full-frame iMDCT of one block structure, transposed: freq_T (N,
    B), hist_T (OVERLAP/2, B) previous unwindowed tail. Returns (N +
    OVERLAP/2, B) = N finished samples + the new tail (src/celt.cpp:2057
    block loop). fft: the FFT core, (freq_T, shift, Bblk) -> (yr, yi):
    the plain one, or K1's bare entry for the chain the fused entry
    replaced (chip_smoke.py times it)."""
    Bblk, NB, shift = _variant(LM, transient)
    N4 = FFT_STATES[shift].nfft
    B = freq_T.shape[1]
    yr, yi = fft(freq_T, shift, Bblk)
    # out[2i] = yr[i]; out[N2-1-2i] = yi[i] (post-rotate interleave)
    out = torch.stack([yr.reshape(Bblk, N4, B),
                       yi.reshape(Bblk, N4, B).flip(1)],
                      dim=2).reshape(Bblk, 2 * N4, B)
    parts = []
    cur_hist = hist_T
    for b in range(Bblk):
        region = imdct_tdac(cur_hist, out[b])
        parts.append(region[:NB])
        cur_hist = region[NB:NB + OVERLAP // 2]
    parts.append(cur_hist)
    return torch.cat(parts, dim=0)


def celt_imdct_tdac_T_ref(freq_T, dcc, tr, *, LM: int, fft=fft_blocks_ref):
    """Plain version of the fused entry (pure torch with the default fft):
    both block structures run for every stream and each stream keeps its
    own (`tr` (B,) bool, the transient flag); dcc[DBS-N:DBS] gets the N
    finished samples clamped to +-SIG_SAT and dcc[DBS:DBS+60] the new
    tail, in place. dcc: (DBS + OVERLAP, B) int32, one channel of the
    rolled decode_mem; its rows DBS-N .. DBS-N+59 are the history. Returns
    dcc."""
    N = SHORT_MDCT_SIZE << LM
    DBS = DECODE_BUFFER_SIZE
    hist = dcc[DBS - N:DBS - N + OVERLAP // 2]
    regions = [celt_imdct_frame_T(freq_T, hist, LM, t, fft=fft)
               for t in (False, True)]
    region = torch.where(tr[None, :], regions[1], regions[0])
    dcc[DBS - N:DBS] = region[:N].clamp(-SIG_SAT, SIG_SAT)
    dcc[DBS:DBS + OVERLAP // 2] = region[N:]
    return dcc


_MAX_STAGES = 6


@functools.lru_cache(maxsize=None)
def _tdac_tables(LM: int, device: torch.device):
    """The fused entry's tables on `device` (built once per device): the
    twiddles, the window, the gather rows as (i1g, i2g) pairs and the
    pre/post twiddles of both block structures, and, in host memory,
    both plans' (nstage, stages) as the kernel reads them."""
    tabs, stages = [], []
    for transient in (False, True):
        Bblk, _, shift = _variant(LM, transient)
        t = _plan_tensors(shift, Bblk, device)
        plan = _plan(shift, Bblk)
        gather = np.stack([plan["i1g"], plan["i2g"]], axis=1)
        tabs += [const(gather, device), t["pre"], t["post"]]
        st = np.zeros((_MAX_STAGES, 3), dtype=np.int32)
        st[:len(plan["stages"])] = plan["stages"]
        stages += [len(plan["stages"]), *st.ravel()]
    ptrs = (ctypes.c_void_p * 6)(*[x.data_ptr() for x in tabs])
    return dict(tw=t["tw_table"], window=const(WINDOW, device),
                tabs=tabs, ptrs=ptrs,
                stages=np.asarray(stages, dtype=np.int32))


def celt_imdct_tdac_T(freq_T, dcc, tr, *, LM: int):
    """K1's fused entry: dcc updated in place as by
    celt_imdct_tdac_T_ref; returns dcc. CPU tensors take the plain
    version; CUDA tensors launch csrc/celt_fft.cu's imdct_tdac kernel
    (never the plain version), one launch a call, each operand read where
    it lies: freq_T and dcc may be row slices of wider tensors whose
    columns are packed."""
    if freq_T.device.type == "cpu":
        return celt_imdct_tdac_T_ref(freq_T, dcc, tr, LM=LM)
    from .. import _build
    if freq_T.device.type != "cuda":
        raise ValueError(f"celt_imdct_tdac_T: unsupported device "
                         f"{freq_T.device}")
    N = SHORT_MDCT_SIZE << LM
    B = dcc.shape[-1] if dcc.dim() == 2 else -1
    if (freq_T.dtype != I32 or dcc.dtype != I32 or freq_T.dim() != 2
            or dcc.dim() != 2 or freq_T.shape[0] < N or freq_T.shape[1] != B
            or dcc.shape[0] < DECODE_BUFFER_SIZE + OVERLAP // 2
            or tuple(tr.shape) != (B,) or tr.dtype != torch.bool):
        raise ValueError("celt_imdct_tdac_T: freq_T (N, B) and dcc (2168, "
                         "B) int32, tr (B,) bool")
    if dcc.stride(1) != 1:
        raise ValueError("celt_imdct_tdac_T: dcc must have packed columns "
                         "(it is updated in place)")
    if freq_T.stride(1) != 1:
        freq_T = freq_T.contiguous()
    tr = tr.contiguous()
    t = _tdac_tables(LM, freq_T.device)
    with torch.cuda.device(freq_T.device):
        err = _build.lib().celt_imdct_tdac(
            freq_T.data_ptr(), freq_T.stride(0), dcc.data_ptr(),
            dcc.stride(0), tr.data_ptr(), B, N, DECODE_BUFFER_SIZE - N,
            t["tw"].data_ptr(), t["window"].data_ptr(), t["ptrs"],
            t["stages"].ctypes.data_as(ctypes.c_void_p),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "celt_imdct_tdac")
    celt_imdct_tdac_T.launches += 1
    return dcc


celt_imdct_tdac_T.launches = 0
