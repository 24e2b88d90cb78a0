"""The hand-written CUDA kernels against their plain torch twins on an
NVIDIA card, bit for bit, at the main path's width (B = 2048 streams;
K1's fused entry, K2, K3, K6, K7, K8 and K9 also at widths that leave
their tiles ragged), P1 (the float32 CELT pitch conceal) at its float
bounds and bit-identical to itself whatever the rows beside a row,
and the port's pool on the card against tests/golden or the CPU. Needs a card;
without one every test skips. Run on the card from the repository root:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(--noconftest: tests/conftest.py imports JAX, which this file needs
not.)"""
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_util import DBS, OV, comb_params, plc_lane, plc_run, t32

pytestmark = pytest.mark.cuda

B = 2048
ROOT = pathlib.Path(__file__).resolve().parent
# (shift, Bblk) of the 7 iMDCT plans
PLANS = [(0, 1), (3, 8), (1, 1), (3, 4), (2, 1), (3, 2), (3, 1)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _device_kernels(setup: str) -> list:
    """The device kernels one `call()` makes, as torch.profiler sees
    them, in a fresh interpreter: `setup` (Python, with `t` this module
    and `dev` the card) defines `call`. A profiling session that follows
    other sessions and the pool tests in one process saw no device
    events on the H100, so each such check gets a process of its own."""
    code = "\n".join([
        "import json, sys, torch",
        f"sys.path[:0] = [{str(ROOT.parent)!r}, {str(ROOT)!r}]",
        "import test_torch_cuda as t",
        "from torch.profiler import ProfilerActivity, profile",
        "dev = torch.device('cuda')",
        setup,
        "call()                     # build, shared-memory attribute",
        "torch.cuda.synchronize()",
        "acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]",
        "with profile(activities=acts) as prof:",
        "    call()",
        "    torch.cuda.synchronize()",
        "cuda = torch.autograd.DeviceType.CUDA",
        "print(json.dumps([e.name for e in prof.events()",
        "                  if e.device_type == cuda]))"])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("shift,Bblk", PLANS)
def test_fft_kernel_matches_twin(dev, shift, Bblk):
    from esp32_opus_player_tpu_torch.ops.celt.fft import (fft_blocks,
                                                          fft_blocks_ref)
    rng = np.random.default_rng(shift * 10 + Bblk)
    freq = t32(rng.integers(-(1 << 24), 1 << 24, (960, B)), dev)
    n = fft_blocks.launches
    got = fft_blocks(freq, shift, Bblk)
    assert fft_blocks.launches == n + 1
    want = fft_blocks_ref(freq, shift, Bblk)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("flags", ["false", "true", "third", "random"])
@pytest.mark.parametrize("rows", [1, 9, 2047, B])
@pytest.mark.parametrize("LM", [3, 2, 1, 0])
def test_imdct_tdac_kernel_matches_plain(dev, LM, rows, flags):
    """K1's fused entry against its plain version, in place in decode_mem,
    at widths around its 8-stream tile, with flags mixed in a tile; at
    2047 rows the spectrum is a row slice of a wider tensor."""
    from esp32_opus_player_tpu_torch.ops.celt.fft import (
        celt_imdct_tdac_T, celt_imdct_tdac_T_ref)
    from torch_port_util import imdct_tdac_inputs
    rng = np.random.default_rng(1000 * LM + rows)
    freq, dcc, tr = imdct_tdac_inputs(rng, rows, LM, flags)
    f = t32(freq, dev)
    if rows == 2047:
        wide = torch.zeros((f.shape[0] + 9, rows), dtype=torch.int32,
                           device=dev)
        wide[4:4 + f.shape[0]] = f
        f = wide[4:4 + f.shape[0]]
    tr = torch.as_tensor(tr, device=dev)
    n = celt_imdct_tdac_T.launches
    got = celt_imdct_tdac_T(f, t32(dcc, dev), tr, LM=LM)
    assert celt_imdct_tdac_T.launches == n + 1
    want = celt_imdct_tdac_T_ref(f, t32(dcc, dev), tr, LM=LM)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_imdct_tdac_is_one_launch(dev):
    """One fused call is one device kernel: no copy, no cast, no cat."""
    names = _device_kernels(
        "import numpy as np\n"
        "from esp32_opus_player_tpu_torch.ops.celt.fft import "
        "celt_imdct_tdac_T\n"
        "from torch_port_util import imdct_tdac_inputs\n"
        "f, d, tr = imdct_tdac_inputs(np.random.default_rng(5), t.B, 3, "
        "'random')\n"
        "f, d, tr = t.t32(f, dev), t.t32(d, dev), torch.as_tensor(tr, "
        "device=dev)\n"
        "call = lambda: celt_imdct_tdac_T(f, d, tr, LM=3)")
    assert len(names) == 1 and "imdct_tdac_kernel" in names[0], names


@pytest.mark.parametrize("C,CC", [(1, 1), (2, 2), (2, 1)])
def test_celt_step_launches_fused_imdct(dev, C, CC):
    """One CELT frame step launches K1's fused entry once per channel and
    the bare fft_blocks not at all, and equals the step on the CPU."""
    from esp32_opus_player_tpu_torch.ops.celt.fft import (celt_imdct_tdac_T,
                                                          fft_blocks)
    from esp32_opus_player_tpu_torch.ops.celt.synthesis_T import (
        celt_synth_step_dual_T)
    from torch_port_util import port_synth_step, synth_inputs
    ins = synth_inputs(np.random.default_rng(C + 3 * CC), 37, C, CC, 3)
    dm, pre, X, bandE, start, end, c1, c2, tr = ins
    n1, n0 = celt_imdct_tdac_T.launches, fft_blocks.launches
    pcmT, dmT, pre2 = celt_synth_step_dual_T(
        t32(np.moveaxis(dm, 0, 2), dev), t32(pre, dev),
        t32(np.moveaxis(X, 0, 2), dev), t32(bandE, dev), t32(start, dev),
        t32(end, dev), tuple(t32(v, dev) for v in c1),
        tuple(t32(v, dev) for v in c2), torch.as_tensor(tr, device=dev),
        LM=3, C=C, CC=CC)
    assert (celt_imdct_tdac_T.launches - n1, fft_blocks.launches - n0) == \
        (CC, 0)
    pcm, dm2, pre_c = port_synth_step(*ins, LM=3, C=C, CC=CC)
    assert np.array_equal(np.moveaxis(pcmT.cpu().numpy(), 2, 0), pcm)
    assert np.array_equal(np.moveaxis(dmT.cpu().numpy(), 2, 0), dm2)
    assert np.array_equal(pre2.cpu().numpy(), pre_c)


# widths on both sides of K2's 8-stream tile and of K7's block of streams
WIDTHS = [1, 7, 129, 2047, B]


def _comb_check(dev, rows, N, lags=None):
    from esp32_opus_player_tpu_torch.ops.celt.comb import (
        comb_filter_step_T, comb_filter_step_T_ref)
    rng = np.random.default_rng(N + rows)
    buf = t32(rng.integers(-(1 << 26), 1 << 26, (DBS + OV, rows)), dev)
    combs = []
    for _ in range(2):
        c = comb_params(rng, rows)
        if lags is not None:
            c[0][:] = c[1][:] = lags
        combs.append(tuple(t32(v, dev) for v in c))
    want = comb_filter_step_T_ref(buf.clone(), DBS - N, N, *combs)
    n = comb_filter_step_T.launches
    got = comb_filter_step_T(buf, DBS - N, N, *combs)
    assert comb_filter_step_T.launches == n + 1
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("N", [120, 240, 480, 960])
@pytest.mark.parametrize("rows", WIDTHS)
def test_comb_kernel_matches_twin(dev, rows, N):
    """K2 at ragged widths and every frame size, lags random in 15..1024
    with the edge rows of comb_params."""
    _comb_check(dev, rows, N)


@pytest.mark.parametrize("lags", [15, 1024])
@pytest.mark.parametrize("rows,N", [(129, 960), (B, 120)])
def test_comb_kernel_lag_edges(dev, rows, N, lags):
    """K2 with every lag at the shortest (chunks of 13) or the longest."""
    _comb_check(dev, rows, N, lags)


# widths on both sides of K8's blocks of 16 streams and K3's of 8 columns
ROWS16 = [1, 15, 17, 2047, B]
ROWS8 = [1, 7, 9, 15, 17, 2047, B]


@pytest.mark.parametrize("downsample", [1, 2, 3, 4, 6])
@pytest.mark.parametrize("rows", ROWS8)
@pytest.mark.parametrize("CC", [1, 2])
def test_deemph_kernel_matches_twin(dev, CC, rows, downsample):
    """K3 at ragged widths and every downsample factor, on a strided view
    of decode_mem as on the path."""
    from esp32_opus_player_tpu_torch.ops.celt.deemph import (
        deemphasis_T, deemphasis_T_ref)
    rng = np.random.default_rng(CC * 7 + downsample + rows)
    dm = t32(rng.integers(-(1 << 28), 1 << 28, (CC, DBS + OV, rows)), dev)
    mem = t32(rng.integers(-(1 << 20), 1 << 20, (rows, CC)), dev)
    syn = dm[:, DBS - 960:DBS]          # a strided view, as on the path
    n = deemphasis_T.launches
    got = deemphasis_T(syn, mem, downsample)
    assert deemphasis_T.launches == n + 1
    want = deemphasis_T_ref(syn, mem, downsample)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("N", [960, 480, 240, 120])
def test_comb_deemph_kernel_matches_twin(dev, N):
    """K4: one launch against K2's twin then K3's."""
    from esp32_opus_player_tpu_torch.ops.celt.comb import (
        comb_deemph_step_T, comb_deemph_step_T_ref)
    rng = np.random.default_rng(N + 1)
    buf = t32(rng.integers(-(1 << 26), 1 << 26, (DBS + OV, B)), dev)
    c1 = tuple(t32(v, dev) for v in comb_params(rng, B))
    c2 = tuple(t32(v, dev) for v in comb_params(rng, B))
    mem = t32(rng.integers(-(1 << 20), 1 << 20, B), dev)
    want = comb_deemph_step_T_ref(buf.clone(), DBS - N, N, c1, c2, mem)
    n = comb_deemph_step_T.launches
    got = comb_deemph_step_T(buf, DBS - N, N, c1, c2, mem)
    assert comb_deemph_step_T.launches == n + 1
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("case", ["random", "lag 15", "lag 1024", "no-op",
                                  "ragged"])
@pytest.mark.parametrize("N", [960, 480, 240, 120])
def test_comb_deemph_kernel_matches_k2_then_k3(dev, N, case):
    """K4 against the K2 kernel then the K3 kernel on the same inputs, bit
    for bit: random lags, every lag at 15 or at 1024, streams 16..31 (a
    whole block of K4's tile, two of K2's) no-ops in both regions, and a
    ragged width."""
    from esp32_opus_player_tpu_torch.ops.celt.comb import (
        comb_deemph_step_T, comb_filter_step_T)
    from esp32_opus_player_tpu_torch.ops.celt.deemph import deemphasis_T
    rows = 2047 if case == "ragged" else B
    rng = np.random.default_rng(N + len(case))
    buf = t32(rng.integers(-(1 << 26), 1 << 26, (DBS + OV, rows)), dev)
    combs = []
    for _ in range(2):
        c = comb_params(rng, rows)
        if case.startswith("lag"):
            c[0][:] = c[1][:] = int(case.split()[1])
        if case == "no-op":
            c[2][16:32] = c[3][16:32] = 0
        combs.append(tuple(t32(v, dev) for v in c))
    mem = t32(rng.integers(-(1 << 20), 1 << 20, rows), dev)
    b2 = comb_filter_step_T(buf.clone(), DBS - N, N, *combs)
    pcm, mem2 = deemphasis_T(b2[None, DBS - N:DBS], mem[:, None])
    got = comb_deemph_step_T(buf, DBS - N, N, *combs, mem)
    torch.cuda.synchronize()
    assert torch.equal(got[0], b2) and torch.equal(got[1], pcm[0])
    assert torch.equal(got[2], mem2[:, 0])


def _golden(name):
    return np.fromfile(ROOT / "golden" / f"{name}.pcm",
                       dtype=np.int16).reshape(-1, 2)


@pytest.mark.parametrize("channels,K", [(1, 3), (2, 1)])
def test_pool_on_card_matches_golden(dev, channels, K):
    from esp32_opus_player_tpu_torch.models.stream_pool import StreamPool
    kind = "mono" if channels == 1 else "stereo"
    names = [f"celt_fb_{kind}_20ms", f"celt_fb_{kind}_drums_20ms"] * 2
    pool = StreamPool([ROOT / "fixtures" / f"{n}.opus" for n in names],
                      channels=channels, superstep_k=K, device=dev)
    for name, out in zip(names, pool.run()):
        if channels == 1:
            out = np.repeat(out, 2, axis=1)
        gold = _golden(name)
        n = min(len(out), len(gold))
        assert n > 90000 and np.array_equal(out[:n], gold[:n]), name


def test_pool_loss_card_matches_cpu(dev):
    from esp32_opus_player_tpu_torch.models.stream_pool import StreamPool
    src = [ROOT / "fixtures" / "celt_fb_mono_20ms.opus"] * 3
    loss = lambda i, k: (i + k) % 7 == 0
    outs = [StreamPool(src, superstep_k=3, device=d).run(loss=loss)
            for d in (dev, "cpu")]
    for a, b in zip(*outs):
        assert np.array_equal(a, b)


# ---- mono SILK: K5-K7 and the pool --------------------------------------

SILK_SETS = [(16, 4, 16), (12, 4, 16), (8, 4, 10), (16, 2, 16)]


@pytest.mark.parametrize("sliced", [False, True])
@pytest.mark.parametrize("rows", WIDTHS)
@pytest.mark.parametrize("fs,nb,order", SILK_SETS)
def test_silk_core_kernel_matches_plain(dev, fs, nb, order, rows, sliced):
    """K7 at ragged widths; sliced: outBuf and exc as column slices of
    wider tensors (rows strided, starts not 16-byte aligned), as the
    pool hands them over."""
    from esp32_opus_player_tpu_torch.ops.silk.core_kernel import (
        silk_core, silk_core_ref)
    from torch_port_util import silk_core_inputs
    rng = np.random.default_rng(fs * 10 + nb + rows)
    args = [torch.as_tensor(a, device=dev)
            for a in silk_core_inputs(rng, rows, fs, nb)]
    if sliced:
        for i, off in ((0, 3), (2, 5)):
            wide = torch.zeros((rows, args[i].shape[1] + 9),
                               dtype=torch.int32, device=dev)
            wide[:, off:off + args[i].shape[1]] = args[i]
            args[i] = wide[:, off:off + args[i].shape[1]]
    kw = dict(fs_khz=fs, nb_subfr=nb, order=order)
    n = silk_core.launches
    got = silk_core(*args, **kw)
    assert silk_core.launches == n + 1
    want = silk_core_ref(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("lag_fs", [2, 18])
def test_silk_core_kernel_lag_edges(dev, lag_fs):
    """K7 with every lag at 2 fs (the chunk walk's edge) and at 18 fs."""
    from esp32_opus_player_tpu_torch.ops.silk.core_kernel import (
        silk_core, silk_core_ref)
    from torch_port_util import silk_core_inputs
    args = silk_core_inputs(np.random.default_rng(lag_fs), 257, 16, 4)
    args[7][:] = lag_fs * 16
    args = tuple(torch.as_tensor(a, device=dev) for a in args)
    kw = dict(fs_khz=16, nb_subfr=4, order=16)
    got, want = silk_core(*args, **kw), silk_core_ref(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("n", [160, 16, 144, 1])
def test_up2_kernel_matches_plain(dev, n):
    """Any n; states over the whole int32 range, so the wrapping sums
    are exercised."""
    from esp32_opus_player_tpu_torch.ops.silk.torch_core import up2_hq_scan
    from esp32_opus_player_tpu_torch.ops.silk.up2_hq import up2_hq
    rng = np.random.default_rng(n)
    x = t32(rng.integers(-32768, 32768, (B, n)), dev)
    S = t32(rng.integers(-2 ** 31, 2 ** 31, (B, 6)), dev)
    got, want = up2_hq(S, x), up2_hq_scan(S, x)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("rows", [B, 16, 1, 2047])
@pytest.mark.parametrize("fs", [8, 12, 16])
def test_up2_fir_kernel_matches_plain(dev, fs, rows):
    """K6's fused entry over one frame's two iir_fir calls (fs samples,
    then 19 fs in chunks of 10 fs and 9 fs), the state of the first
    carried into the second, against its plain version (the chunk loop
    over up2_hq_scan), at 48 kHz out; the blocks misaligned column slices
    of one wider tensor, sIIR over the whole int32 range."""
    from esp32_opus_player_tpu_torch.ops.silk import torch_core as tc
    from esp32_opus_player_tpu_torch.ops.silk.up2_hq import up2_fir
    rng = np.random.default_rng(fs * 10 + rows)
    spec = tc._resampler_spec(fs, 48)
    kw = dict(batch_size=spec["batch_size"], inv_ratio=spec["inv_ratio"])
    wide = t32(rng.integers(-32768, 32768, (rows, 20 * fs + 7)), dev)
    got = want = (t32(rng.integers(-2 ** 31, 2 ** 31, (rows, 6)), dev),
                  t32(rng.integers(-32768, 32768, (rows, 8)), dev))
    for lo, hi in ((3, 3 + fs), (3 + fs, 3 + 20 * fs)):
        n = up2_fir.launches
        g = up2_fir(*got[-2:], wide[:, lo:hi], **kw)
        assert up2_fir.launches == n + 1
        w = tc.iir_fir_chunks(*want[-2:], wide[:, lo:hi], **kw)
        torch.cuda.synchronize()
        for a, b, name in zip(g, w, ("out", "sIIR", "sFIR")):
            assert a.shape == b.shape and torch.equal(a, b), (lo, name)
        got, want = g, w


def test_up2_fir_is_one_launch(dev):
    """One fused call on a misaligned column slice is one device kernel:
    no copy, no cast, no cat (torch.profiler's device events)."""
    names = _device_kernels(
        "import numpy as np\n"
        "from esp32_opus_player_tpu_torch.ops.silk import torch_core as tc\n"
        "from esp32_opus_player_tpu_torch.ops.silk.up2_hq import up2_fir\n"
        "rng = np.random.default_rng(3)\n"
        "spec = tc._resampler_spec(16, 48)\n"
        "x = t.t32(rng.integers(-32768, 32768, (t.B, 309)), dev)[:, 5:]\n"
        "S = t.t32(rng.integers(-2 ** 31, 2 ** 31, (t.B, 6)), dev)\n"
        "F = t.t32(rng.integers(-32768, 32768, (t.B, 8)), dev)\n"
        "call = lambda: up2_fir(S, F, x, batch_size=spec['batch_size'], "
        "inv_ratio=spec['inv_ratio'])")
    assert len(names) == 1 and "up2_kernel" in names[0], names


@pytest.mark.parametrize("order", [16, 10])
def test_lpc_kernel_matches_plain(dev, order):
    from esp32_opus_player_tpu_torch.ops.silk.lpc_synth import (
        lpc_synth, lpc_synth_ref)
    rng = np.random.default_rng(order)
    pres = t32(rng.integers(-(1 << 24), 1 << 24, (64, 80)), dev)
    A = t32(rng.integers(-(1 << 16), 1 << 16, (64, order)), dev)
    s0 = t32(rng.integers(-2 ** 31, 2 ** 31, (64, 16)), dev)
    got = lpc_synth(pres, A, s0, order=order)
    want = lpc_synth_ref(pres, A, s0, order=order)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("B,n,order,alim", [
    (16, 80, 16, 1 << 12), (16, 40, 10, 1 << 12), (17, 60, 10, 1 << 15),
    (2048, 320, 16, 1 << 12), (5, 700, 16, 1 << 12), (3, 7, 16, 1 << 12),
    (33, 16, 10, 1 << 20), (1, 0, 16, 1 << 12)])
def test_lpc_kernel_shapes(dev, B, n, order, alim):
    """K5 at ragged widths, rows longer than its staging chunk (320) and
    shorter than the state (16), and with coefficients at both ends of 16
    bits and beyond 16 bits, each product through the hi/lo split."""
    from esp32_opus_player_tpu_torch.ops.silk.lpc_synth import (
        lpc_synth, lpc_synth_ref)
    rng = np.random.default_rng(B * 1000 + n)
    pres = t32(rng.integers(-(1 << 24), 1 << 24, (B, n)), dev)
    a = rng.integers(-alim, alim, (B, order))
    a[0, 0], a[-1, -1] = -alim, alim - 1
    A = t32(a, dev)
    s0 = t32(rng.integers(-(1 << 30), 1 << 30, (B, 16)), dev)
    got = lpc_synth(pres, A, s0, order=order)
    want = lpc_synth_ref(pres, A, s0, order=order)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("rows", [128, 127, 16, 1])
def test_silk_core_dispatch(dev, rows):
    """Every CUDA bucket takes one K7 launch, whatever its width (the JAX
    package's 128-row gate is a TPU lane-tile rule); K5 is not launched."""
    from esp32_opus_player_tpu_torch.ops.silk import torch_core as tc
    from esp32_opus_player_tpu_torch.ops.silk.core_kernel import silk_core
    from esp32_opus_player_tpu_torch.ops.silk.lpc_synth import lpc_synth
    from torch_port_util import silk_core_inputs
    args = tuple(torch.as_tensor(a, device=dev) for a in silk_core_inputs(
        np.random.default_rng(rows), rows, 16, 4))
    n7, n5 = silk_core.launches, lpc_synth.launches
    tc.silk_core_frame(*args, fs_khz=16, nb_subfr=4, order=16)
    assert (silk_core.launches - n7, lpc_synth.launches - n5) == (1, 0)


@pytest.mark.parametrize("names,n,K", [
    (("silk_wb_mono_20ms", "silk_wb_fec_mono_20ms"), 256, 8),
    (("silk_nb_mono_20ms", "silk_mb_mono_20ms", "silk_wb_mono_20ms"), 12,
     3)])
def test_silk_pool_on_card_matches_golden(dev, names, n, K):
    from esp32_opus_player_tpu_torch.models.stream_pool import StreamPool
    src = [ROOT / "fixtures" / f"{names[i % len(names)]}.opus"
           for i in range(n)]
    outs = StreamPool(src, superstep_k=K, device=dev).run()
    for i, out in enumerate(outs):
        gold = _golden(names[i % len(names)])
        assert len(out) > 90000, i
        assert np.array_equal(np.repeat(out, 2, axis=1), gold[:len(out)]), i


# ---- lossy mono SILK: K8, K9 and the concealing pool --------------------

PLC_SETS = [(16, 4, 16), (12, 4, 10), (8, 4, 10), (16, 2, 16)]


def _plc_args(dev, rows, fs, nb, order, lags=None, sliced=True):
    from torch_port_util import column_slices, silk_plc_inputs
    rng = np.random.default_rng(fs * 10 + nb + rows)
    args = silk_plc_inputs(rng, rows, fs, nb, order, lags)
    if sliced:
        return column_slices(args, dev)
    return [t32(a, dev) for a in args]


@pytest.mark.parametrize("sliced", [False, True])
@pytest.mark.parametrize("rows", ROWS16)
@pytest.mark.parametrize("fs,nb,order", PLC_SETS)
def test_plc_conceal_kernel_matches_plain(dev, fs, nb, order, rows, sliced):
    """K8 at widths on both sides of its 16-stream block (it runs at
    every bucket size), rows 0 and 1 at the lag edges 2 fs and 18 fs;
    sliced: every operand a column slice of one wider tensor at an odd
    offset, as the pool hands them over."""
    from esp32_opus_player_tpu_torch.ops.silk.plc_kernel import (
        silk_plc_conceal)
    from esp32_opus_player_tpu_torch.ops.silk.torch_plc import (
        silk_plc_conceal_frame_xla)
    args = _plc_args(dev, rows, fs, nb, order, sliced=sliced)
    kw = dict(fs_khz=fs, nb_subfr=nb, order=order)
    n = silk_plc_conceal.launches
    got = silk_plc_conceal(*args, **kw)
    assert silk_plc_conceal.launches == n + 1
    want = silk_plc_conceal_frame_xla(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("lags", ["2fs", "18fs", "drift"])
@pytest.mark.parametrize("fs,nb,order", PLC_SETS)
def test_plc_conceal_kernel_lag_edges(dev, fs, nb, order, lags):
    """K8 with every lag at 2 fs (the shortest chunks), at 18 fs, or
    rising across the subframes (a chunk length per subframe)."""
    from esp32_opus_player_tpu_torch.ops.silk.plc_kernel import (
        silk_plc_conceal)
    from esp32_opus_player_tpu_torch.ops.silk.torch_plc import (
        silk_plc_conceal_frame_xla)
    args = _plc_args(dev, 257, fs, nb, order, lags)
    kw = dict(fs_khz=fs, nb_subfr=nb, order=order)
    got = silk_plc_conceal(*args, **kw)
    want = silk_plc_conceal_frame_xla(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_plc_conceal_is_one_launch(dev):
    """One call on misaligned column slices is one device kernel: no
    copy, no cast, no scratch fill (torch.profiler's device events)."""
    names = _device_kernels(
        "from esp32_opus_player_tpu_torch.ops.silk.plc_kernel import "
        "silk_plc_conceal\n"
        "args = t._plc_args(dev, t.B, 16, 4, 16)\n"
        "call = lambda: silk_plc_conceal(*args, fs_khz=16, nb_subfr=4, "
        "order=16)")
    assert len(names) == 1 and "plc_conceal_kernel" in names[0], names


@pytest.mark.parametrize("frame,order", [(320, 16), (240, 10), (160, 10),
                                         (160, 16)])
def test_cng_kernel_matches_plain(dev, frame, order):
    """K9 with a mask of both values, the state over the whole int32
    range, and the inputs as strided views (as the lossy frame hands
    them over)."""
    from esp32_opus_player_tpu_torch.ops.silk.cng_kernel import cng_add
    from esp32_opus_player_tpu_torch.ops.silk.torch_plc import cng_add_xla
    rng = np.random.default_rng(frame + order)
    both = t32(rng.integers(-(1 << 16), 1 << 16, (B, 2 * frame)), dev)
    xq = both[:, :frame].clamp(-32768, 32767)
    exc = both[:, frame:]
    A = t32(rng.integers(-(1 << 12), 1 << 12, (B, 16)), dev)
    gain = t32(rng.integers(1 << 8, 1 << 14, B), dev)
    st0 = t32(rng.integers(-2 ** 31, 2 ** 31, (B, 16)), dev)
    mask = torch.as_tensor(rng.integers(0, 2, B).astype(bool), device=dev)
    n = cng_add.launches
    got = cng_add(xq, exc, A, gain, st0, mask, frame=frame, order=order)
    assert cng_add.launches == n + 1
    want = cng_add_xla(xq, exc, A, gain, st0, mask, frame=frame,
                       order=order)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("kw,fec", [
    (dict(compat_ref=False, rfc_plc=True), False),
    (dict(compat_ref=False, rfc_plc=True), True),
    (dict(compat_ref=True), True)])
def test_lossy_silk_pool_card_matches_cpu(dev, kw, fec):
    """The concealing pool (a 10th of the rows lost on every step) on the
    card, kernels K8 and K9 launched, against the same pool on the CPU."""
    from esp32_opus_player_tpu_torch.models.stream_pool import StreamPool
    from esp32_opus_player_tpu_torch.ops.silk.cng_kernel import cng_add
    from esp32_opus_player_tpu_torch.ops.silk.plc_kernel import (
        silk_plc_conceal)
    names = ("silk_wb_mono_20ms", "silk_wb_fec_mono_20ms",
             "silk_nb_mono_20ms")
    src = [ROOT / "fixtures" / f"{names[i % 3]}.opus" for i in range(30)]
    loss = lambda i, k: i % 10 == k % 10
    n8, n9 = silk_plc_conceal.launches, cng_add.launches
    card = StreamPool(src, superstep_k=4, device=dev, **kw).run(loss=loss,
                                                                fec=fec)
    used = (silk_plc_conceal.launches - n8, cng_add.launches - n9)
    assert (min(used) > 0) == ("rfc_plc" in kw), used
    cpu = StreamPool(src, superstep_k=4, device="cpu", **kw).run(loss=loss,
                                                                 fec=fec)
    for i, (a, b) in enumerate(zip(card, cpu)):
        assert np.array_equal(a, b), i


def _cng_args(dev, rows, frame, masks):
    """K9's operands as the lossy frame passes them: xq, exc, A, gain
    and the state column slices of one wider (staging-shaped) tensor at
    odd offsets, the state over the whole int32 range; the mask a bool
    tensor: all off, all on or every 10th row on."""
    from torch_port_util import column_slices
    rng = np.random.default_rng(frame + rows)
    args = [rng.integers(-32768, 32768, (rows, frame)),
            rng.integers(-(1 << 16), 1 << 16, (rows, frame)),
            rng.integers(-(1 << 12), 1 << 12, (rows, 16)),
            rng.integers(1 << 8, 1 << 14, rows),
            rng.integers(-2 ** 31, 2 ** 31, (rows, 16))]
    mask = dict(off=np.zeros(rows, bool), on=np.ones(rows, bool),
                tenth=np.arange(rows) % 10 == 3)[masks]
    return column_slices(args, dev) + [torch.as_tensor(mask, device=dev)]


@pytest.mark.parametrize("masks", ["off", "on", "tenth"])
@pytest.mark.parametrize("rows", [1, 15, 17, 2047])
@pytest.mark.parametrize("frame,order", [(320, 16), (160, 10)])
def test_cng_kernel_sliced(dev, frame, order, rows, masks):
    """K9 at widths on both sides of its 16-stream block, its operands
    column slices of one staging-shaped tensor, with no row, every row
    and every 10th row masked on."""
    from esp32_opus_player_tpu_torch.ops.silk.cng_kernel import cng_add
    from esp32_opus_player_tpu_torch.ops.silk.torch_plc import cng_add_xla
    args = _cng_args(dev, rows, frame, masks)
    n = cng_add.launches
    got = cng_add(*args, frame=frame, order=order)
    assert cng_add.launches == n + 1
    want = cng_add_xla(*args, frame=frame, order=order)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_cng_is_one_launch(dev):
    """One call on column slices and a bool mask is one device kernel:
    no copy, no cast (torch.profiler's device events)."""
    names = _device_kernels(
        "from esp32_opus_player_tpu_torch.ops.silk.cng_kernel import "
        "cng_add\n"
        "args = t._cng_args(dev, t.B, 320, 'tenth')\n"
        "call = lambda: cng_add(*args, frame=320, order=16)")
    assert len(names) == 1 and "cng_kernel" in names[0], names


# P1, the CELT pitch conceal: float32, so held to its plain version at the
# bounds of tests/test_torch_celt_plc.py (T equal; PCM, decode_mem and
# preemph within 16 LSB; LPC within 5 % of a channel's largest
# coefficient), and bit-identical to itself whatever the rows beside a row
PLC_PCM, PLC_Q12, PLC_LPC = 16, 16 * 4096, 0.05


@pytest.mark.parametrize("R", [205, 103, 7])
@pytest.mark.parametrize("CC", [1, 2])
def test_plc_kernel_matches_plain(dev, CC, R):
    from esp32_opus_player_tpu_torch.ops.celt.plc_kernel import (
        celt_plc_T, celt_plc_T_ref)
    st, pcmT, rows, first = plc_lane(dev, CC, R, 10 * CC + R)
    n = celt_plc_T.launches
    (dm, pre, pitch, lpc), pcm = plc_run(celt_plc_T, st, pcmT, rows, first)
    assert celt_plc_T.launches == n + 1
    (rdm, rpre, rpitch, rlpc), rpcm = plc_run(celt_plc_T_ref, st, pcmT,
                                               rows, first)
    assert torch.equal(pitch, rpitch)
    # the clamps: rows 0 and 1 repeat a conceal with pitch 60 and 800
    assert pitch[rows[:2]].tolist() == [100, 720]
    err = lambda a, b: int((a.long() - b.long()).abs().max())
    assert err(pcm, rpcm) <= PLC_PCM and err(dm, rdm) <= PLC_Q12
    assert err(pre, rpre) <= PLC_Q12
    rel = ((lpc - rlpc).abs().amax(2)
           / rlpc.abs().amax(2).clamp_min(1.0)).max()
    assert float(rel) <= PLC_LPC
    keep = torch.ones(B, dtype=torch.bool, device=dev)
    keep[rows] = False
    assert torch.equal(dm[:, :, keep], st[0][:, :, keep])
    assert torch.equal(lpc[keep], st[3][keep]) and not pcm[:, :, keep].any()


@pytest.mark.parametrize("CC", [1, 2])
def test_plc_kernel_repeated_conceals(dev, CC):
    """A lane whose rows all repeat a conceal (no pitch search, no LPC
    fit: the carried pitch and LPC), against the plain version."""
    from esp32_opus_player_tpu_torch.ops.celt.plc_kernel import (
        celt_plc_T, celt_plc_T_ref)
    st, pcmT, rows, first = plc_lane(dev, CC, 205, 30 + CC)
    first = torch.zeros_like(first)
    (dm, pre, pitch, lpc), pcm = plc_run(celt_plc_T, st, pcmT, rows, first)
    (rdm, rpre, rpitch, rlpc), rpcm = plc_run(celt_plc_T_ref, st, pcmT,
                                               rows, first)
    assert torch.equal(pitch, rpitch) and torch.equal(lpc, rlpc)
    err = lambda a, b: int((a.long() - b.long()).abs().max())
    assert err(pcm, rpcm) <= PLC_PCM and err(dm, rdm) <= PLC_Q12
    assert err(pre, rpre) <= PLC_Q12


@pytest.mark.parametrize("CC", [1, 2])
def test_plc_kernel_row_independent(dev, CC):
    """A row concealed alone gives the bits it gives among 205 rows."""
    from esp32_opus_player_tpu_torch.ops.celt.plc_kernel import celt_plc_T
    st, pcmT, rows, first = plc_lane(dev, CC, 205, 77 + CC)
    (dm, pre, pitch, lpc), pcm = plc_run(celt_plc_T, st, pcmT, rows, first)
    for j in (0, 2, 3, 100, 204):
        (dm1, pre1, pitch1, lpc1), pcm1 = plc_run(
            celt_plc_T, st, pcmT, rows[j:j + 1].clone(),
            first[j:j + 1].clone())
        r = int(rows[j])
        assert torch.equal(dm1[:, :, r], dm[:, :, r])
        assert torch.equal(pcm1[:, :, r], pcm[:, :, r])
        assert torch.equal(pre1[r], pre[r]) and pitch1[r] == pitch[r]
        assert torch.equal(lpc1[r], lpc[r])


def test_plc_is_one_launch(dev):
    names = _device_kernels(
        "st, pcm, rows, first = t.plc_lane(dev, 1, 205, 5)\n"
        "from esp32_opus_player_tpu_torch.ops.celt.plc_kernel import "
        "celt_plc_T\n"
        "call = lambda: celt_plc_T(*st, pcm, rows, first)")
    assert len(names) == 1 and "plc_kernel" in names[0], names


@pytest.mark.parametrize("channels", [1, 2])
def test_lossy_celt_pool_card_matches_cpu(dev, channels):
    """The concealing CELT pool (a 10th of the rows lost on every step,
    and 8-frame bursts that reach the noise branch) on the card, P1
    launched, against the same pool on the CPU: bit-equal before a
    stream's first conceal, then each frame bit-equal, or within 16 LSB
    at SNR >= 40 dB, or within 1 LSB on a quiet frame: one whose CPU
    twin's RMS is below 100, the level under which one LSB of float32
    rounding on every sample is already above -40 dB."""
    from esp32_opus_player_tpu_torch.models.stream_pool import StreamPool
    from esp32_opus_player_tpu_torch.ops.celt.plc_kernel import celt_plc_T
    kind = "mono" if channels == 1 else "stereo"
    src = [ROOT / "fixtures" / f"celt_fb_{kind}{d}_20ms.opus"
           for d in ("", "_drums")] * 10
    loss = lambda i, k: i % 10 == k % 10 or (i % 7 == 3 and 30 <= k < 38)
    n = celt_plc_T.launches
    kw = dict(channels=channels, superstep_k=16, compat_ref=False,
              rfc_plc=True)
    card = StreamPool(src, device=dev, **kw).run(loss=loss)
    assert celt_plc_T.launches > n
    cpu = StreamPool(src, device="cpu", **kw).run(loss=loss)
    for i, (a, b) in enumerate(zip(card, cpu)):
        assert a.shape == b.shape, i
        first = min(k for k in range(100) if loss(i, k))
        for k in range(len(a) // 960):
            fa, fb = a[960 * k:960 * (k + 1)], b[960 * k:960 * (k + 1)]
            if np.array_equal(fa, fb):
                continue
            assert k >= first - 1, (i, k)
            e = fa.astype(np.float64) - fb
            snr = 10 * np.log10((np.sum(fb.astype(np.float64) ** 2) + 1)
                                / (np.sum(e ** 2) + 1))
            err = np.abs(e).max()
            rms = np.sqrt(np.mean(fb.astype(np.float64) ** 2))
            assert err <= PLC_PCM, (i, k, err, snr)
            assert snr >= 40.0 or (err <= 1 and rms < 100.0), (
                i, k, err, snr, rms, np.count_nonzero(e))
            if snr < 40.0:
                print(f"quiet frame: stream {i} frame {k}: max |card - "
                      f"CPU| {err:.0f} LSB, {np.count_nonzero(e)} of 960 "
                      f"samples differ, SNR {snr:.2f} dB, twin RMS "
                      f"{rms:.2f}")


@pytest.mark.parametrize("ms", [10, 20])
@pytest.mark.parametrize("fs", [8, 12, 16])
@pytest.mark.parametrize("rows", [1, 9, 1023, 2048])
def test_stereo_kernel_matches_plain(dev, rows, fs, ms):
    """S1 (the stereo unmix) bit-equal to its plain version at ragged
    widths, every rate and both frame sizes, the frame a misaligned slice
    and the predictors a column slice of staging-like rows, predictors at
    the Q13 and int16 extremes and one row with a zero delta; one launch
    a call."""
    from esp32_opus_player_tpu_torch.ops.silk.stereo_kernel import (
        ms_to_lr, ms_to_lr_ref)
    rng = np.random.default_rng(rows * 100 + fs * 10 + ms)
    frame = ms * fs
    i16 = lambda *sh: rng.integers(-32768, 32768, sh)
    prev = rng.integers(-13732, 13733, (rows, 2))
    pred = rng.integers(-13732, 13733, (rows, 2))
    edge = [(13732, -13732), (-13732, 13732), (32767, -32768),
            (-32768, 32767)]
    for r in range(min(rows, 4)):
        prev[r], pred[r] = edge[r], edge[3 - r]
    if rows > 5:
        pred[5] = prev[5]
    wide = t32(i16(rows, 2, frame + 5), dev)
    stg = torch.zeros((rows, 2, 7), dtype=torch.int32, device=dev)
    stg[:, 0, 2:4] = t32(pred, dev)
    args = (t32(i16(rows, 2), dev), t32(i16(rows, 2), dev), t32(prev, dev),
            wide[:, :, 3:3 + frame], stg[:, 0, 2:4])
    n = ms_to_lr.launches
    got = ms_to_lr(*args, fs_khz=fs, frame=frame)
    assert ms_to_lr.launches == n + 1
    want = ms_to_lr_ref(*args, fs_khz=fs, frame=frame)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("names,channels,compat,loss", [
    (("silk_wb_stereo_20ms", "silk_nb_stereo_20ms"), 2, True, None),
    (("silk_nb_stereo_40ms", "silk_wb_stereo_60ms",
      "silk_wb_fec_stereo_10ms"), 2, False, None),
    (("silk_wb_mono_10ms", "silk_wb_mono_60ms"), 1, False, None),
    (("hybrid_swb_mono_20ms",), 1, True, None),
    (("hybrid_fb_stereo_10ms",), 2, False, None),
    (("silk_wb_fec_stereo_20ms", "silk_wb_fec_stereo_10ms"), 2, False,
     "plc"),
    (("hybrid_swb_fec_mono_20ms", "hybrid_fb_mono_10ms"), 1, False, "plc"),
    (("silk_wb_fec_stereo_20ms",), 2, True, "compat"),
    (("hybrid_fb_stereo_20ms",), 2, True, "compat")])
def test_stereo_and_hybrid_pools_card_match_cpu(dev, names, channels,
                                                compat, loss):
    """The stereo SILK, multi-frame mono SILK and hybrid pools on the card
    (K7 on the channel rows, S1, K6's fused entry, K1-K3 for hybrid; K8
    and K9 when concealing) bit-equal to the same pool on the CPU, with
    bursts, a tenth lost and FEC in RFC mode (rfc_plc), and every 5th
    packet lost in compat mode."""
    from esp32_opus_player_tpu_torch.models.stream_pool import StreamPool
    src = [str(ROOT / "fixtures" / f"{n}.opus") for n in names] * 3
    kw = dict(channels=channels, compat_ref=compat, superstep_k=4,
              rfc_plc=loss == "plc")
    lossf = None if loss is None else (
        (lambda i, k: k % 5 == 4) if loss == "compat" else
        (lambda i, k: i % 3 == k % 10 or 20 <= k < 24))
    runs = [StreamPool(src, device=d, **kw).run(loss=lossf,
                                                fec=loss == "plc")
            for d in (dev, "cpu")]
    for i, (a, b) in enumerate(zip(*runs)):
        assert len(a) > 20000 and np.array_equal(a, b), i
