"""Time variants of a hand-written kernel on one CUDA card: the committed
source against copies of csrc/ with a launch-shape constant changed or a
phase cut out, each built into its own library and timed in turns.

Run from the repository root on a machine with one CUDA card:

    python3 tools/kernel_variants.py [k1] [k3] [k4] [k5] [k6] [k8] [k9] [p1] \
        [--rounds 3]

A variant is a list of (text, replacement) edits to one source file;
each text must occur in it (tests/test_torch_kernel_variants.py holds
them to the committed sources). A phase is cut by making its loop run
zero times or its branch never taken, so the kernel still writes its
outputs (no longer the right values) and nvcc keeps the other phases.
Each variant is timed as chip_smoke.py times a kernel (one wrapper call
captured in a CUDA graph, replayed between CUDA events), at the path's
shape: K1's fused entry at LM 3, B 2048, with no stream, a seeded half
or every stream transient (its history rows restored before each
variant's bits are taken); K3 at CC 1, B 2048; K4 at N 960, 480, 240 and
120, B 2048; K5 at (B, n, order) (16, 40, 10), (16, 60, 10), (16, 80,
16), (16, 320, 16) and (2048, 320, 16); K6 as its bare entry (B 2048,
n 160) and as its fused one
(WB, B 2048, the 304-sample block as a column slice); K8 at WB (16, 4,
16), B 2048, and K9 at B 2048, frame 320, order 16, every 10th row on,
their operands column slices as the pool passes them; P1 at 205 rows of
a 2048-column lane, CC 1 all first conceals and chip_smoke.py's two
seeded lanes (CC 1 and 2, about half first), and at 132 rows (one an
SM). A call that updates its inputs in place has them restored before
each variant is timed. The variants run in turns, round by round, the
order reversed every other round. Prints one JSON line per kernel: the
card, each variant's device ms per round (per call, where a kernel has
several), and whether its outputs equal the committed source's bit for
bit (a cut phase changes them; a launch shape or a layout must not).
"""
import argparse
import json
import pathlib
import re
import shutil
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]

# file, then variant name -> edits (text, replacement); every occurrence
# of a text is replaced
VARIANTS = {
    "k1": ("celt_fft.cu", {
        "as committed": [],
        "no FFT stages": [("for (int st = 0; st < a.nstage[pl]; ++st) {",
                           "for (int st = a.nstage[pl]; st < a.nstage[pl]; "
                           "++st) {")],
        "no pre/post rotation": [
            ("for (int j = lane; j < rows; j += 32) {",
             "for (int j = rows + lane; j < rows; j += 32) {")],
        "no spectrum staging": [("for (int base = tid; base < n;",
                                 "for (int base = n + tid; base < n;")],
        "no epilogue": [("for (int r = tid / S; r < N + kHalfOverlap;",
                         "for (int r = N + kHalfOverlap + tid / S; "
                         "r < N + kHalfOverlap;")],
        "radix-4 m=1 by words": [("if constexpr (S == 1) {",
                                  "if constexpr (S == 0) {")],
        "4 streams a block": [("kTdacStreams = 8;", "kTdacStreams = 4;")],
        "16 streams a block": [("kTdacStreams = 8;", "kTdacStreams = 16;")],
    }),
    "k3": ("celt_deemph.cu", {
        "as committed": [],
        "product by IMAD.WIDE and a shift": [
            ("m = wadd(__mulhi(tmp, kPreemphHi), tmp);",
             "m = smul(tmp, kPreemph);")],
        "no walk": [("      if (tid < ns) {\n        // one sample",
                     "      if (false) {\n        // one sample")],
        "no write-out": [("if (c < ns) out[", "if (false) out[")],
        "no row staging": [("if (c < ns)\n        __pipeline_memcpy_async",
                            "if (false)\n        __pipeline_memcpy_async")],
        "walk only": [("if (c < ns) out[", "if (false) out["),
                      ("if (c < ns)\n        __pipeline_memcpy_async",
                       "if (false)\n        __pipeline_memcpy_async")],
        "none of the three": [
            ("      if (tid < ns) {\n        // one sample",
             "      if (false) {\n        // one sample"),
            ("if (c < ns) out[", "if (false) out["),
            ("if (c < ns)\n        __pipeline_memcpy_async",
             "if (false)\n        __pipeline_memcpy_async")],
        "1 piece": [("kPieces = 4;", "kPieces = 1;")],
        "8 pieces": [("kPieces = 4;", "kPieces = 8;")],
        "4 columns": [("kCols = 8;", "kCols = 4;")],
        "16 columns": [("kCols = 8;", "kCols = 16;")],
        "128 threads": [("kThreads = 256;", "kThreads = 128;")],
    }),
    "k6": ("silk_up2.cu", {
        "as committed": [],
        "smulwb products": [
            ("__mulhi(wsub(in32, S0), h0)",
             "smulwb(wsub(in32, S0), h0 >> 16)"),
            ("__mulhi(wsub(out1, S1), h1)",
             "smulwb(wsub(out1, S1), h1 >> 16)"),
            ("__mulhi(Y, h2)", "smulwb(Y, h2 >> 16)")],
        "loads after the stores": [("for (; t + 4 <= n; t += 4) {",
                                    "for (; t + 4 <= 0; t += 4) {")],
        "no walk": [("  if (warp < 4 && lane < (S >> 1) && s < ns) {",
                     "  if (false) {")],
        "no FIR": [("for (int k = lane; k < m; k += 32)",
                    "for (int k = m + lane; k < m; k += 32)")],
        "no row staging": [("    stage_row(", "    if (false) stage_row(")],
        "16 streams, 256 threads": [("kThreads = 512;", "kThreads = 256;")],
        "8 streams, 256 threads": [("kThreads = 512;", "kThreads = 256;"),
                                   ("kStreams = 16;", "kStreams = 8;")],
    }),
    "k8": ("silk_plc.cu", {
        "as committed": [],
        "no LPC walk": [("  if (tid < ns) {\n    int32_t a[ORDER];",
                         "  if (false) {\n    int32_t a[ORDER];")],
        "no FIR": [("for (int p = first + lane; p < lm; p += 32)",
                    "for (int p = lm + lane; p < lm; p += 32)")],
        "no LTP": [("for (int c0 = 0; c0 < subfr; c0 += ch)",
                    "for (int c0 = subfr; c0 < subfr; c0 += ch)")],
        "no row staging": [("    stage_row(", "    if (false) stage_row(")],
        "none of the four": [
            ("  if (tid < ns) {\n    int32_t a[ORDER];",
             "  if (false) {\n    int32_t a[ORDER];"),
            ("for (int p = first + lane; p < lm; p += 32)",
             "for (int p = lm + lane; p < lm; p += 32)"),
            ("for (int c0 = 0; c0 < subfr; c0 += ch)",
             "for (int c0 = subfr; c0 < subfr; c0 += ch)"),
            ("    stage_row(", "    if (false) stage_row(")],
        "16 streams, 256 threads": [("kThreads = 512;", "kThreads = 256;")],
        "8 streams, 256 threads": [("kThreads = 512;", "kThreads = 256;"),
                                   ("kStreams = 16;", "kStreams = 8;")],
    }),
    "p1": ("celt_plc.cu", {
        "as committed": [],
        "no pitch search": [("  if (first) {\n    float* x_lp = s.a[0];",
                             "  if (false) {\n    float* x_lp = s.a[0];")],
        "no top-2 scans": [
            ("  for (; i0 + kGroup <= n; i0 += kGroup) {\n"
             "    float cn[kGroup], cs[kGroup];",
             "  for (; i0 + kGroup <= 0; i0 += kGroup) {\n"
             "    float cn[kGroup], cs[kGroup];"),
            ("for (int i = i0; i < n; ++i) step(i, num[i], syy[i]);",
             "for (int i = n; i < n; ++i) step(i, num[i], syy[i]);")],
        "no Syy chains": [
            ("  for (; i0 + kGroup <= n; i0 += kGroup) {\n"
             "    float ci[kGroup], co[kGroup];",
             "  for (; i0 + kGroup <= 0; i0 += kGroup) {\n"
             "    float ci[kGroup], co[kGroup];"),
            ("  for (int i = i0; i < n; ++i) {\n    out[i] = Syy;",
             "  for (int i = n; i < n; ++i) {\n    out[i] = Syy;")],
        "no LPC fit": [("  if (first) {\n    for (int k = tid;",
                        "  if (false) {\n    for (int k = tid;")],
        "no IIR": [("for (int t0 = 0; t0 < kElen; t0 += kBlk) {",
                    "for (int t0 = kElen; t0 < kElen; t0 += kBlk) {")],
        "no deemphasis": [("  if (chan >= 0) {\n    // t = x + m",
                           "  if (false) {\n    // t = x + m")],
        "no staging": [("? dm[((long long)c * kL + j) * cap + row] : 0;",
                        "? (int32_t)((j * 2654435761u) >> 8) : 0;")],
        "no decode_mem stores": [
            ("col[(long long)r * cap] = q12(",
             "if (row < 0) col[(long long)r * cap] = q12("),
            ("col[(long long)(kDBS - kN + i) * cap] = q12(v);",
             "if (row < 0) col[(long long)(kDBS - kN + i) * cap] = q12(v);")],
        "128 threads": [("kThreads = 256;", "kThreads = 128;")],
        "512 threads": [("kThreads = 256;", "kThreads = 512;")],
    }),
    "k4": ("celt_comb.cuh", {
        "as committed": [],
        "no comb walk": [
            ("    comb_region_tile(x, n1, p1, ftab, lane);",
             "    if (false) comb_region_tile(x, n1, p1, ftab, lane);"),
            ("if (N > n1) comb_region_tile(x + n1,",
             "if (false) comb_region_tile(x + n1,")],
        "no deemphasis walk": [("if (lane < S && b0 + lane < B)",
                                "if (false)")],
        "no row staging": [
            ("  if (mine)\n    for (int r = r0; r < n_rows; r += kRowsPerPass)",
             "  if (false)\n    for (int r = r0; r < n_rows; "
             "r += kRowsPerPass)")],
        "no write-back": [("} else if (mine && hist > 0) {",
                           "} else if (false) {"),
                          ("    if (mine)\n      for (int r = r0; r < N;",
                           "    if (false)\n      for (int r = r0; r < N;")],
        "8 streams a block": [("kDeemphStreams = 16;",
                               "kDeemphStreams = 8;")],
        "4 streams a block": [("kDeemphStreams = 16;",
                               "kDeemphStreams = 4;")],
    }),
    "k5": ("silk_lpc.cu", {
        "as committed": [],
        "no walk": [("    if (walker) walk<ORDER>(",
                     "    if (false) walk<ORDER>(")],
        "the walk's input from a register": [
            ("xn[j] = x[min(i + 4 + j, len - 1)];", "xn[j] = i + j;")],
        "no staging": [("      stage_row(tile + s * w, pres",
                        "      if (false) stage_row(tile + s * w, pres")],
        "no write-back": [("for (int k = lane; k < len; k += 32) y[k] =",
                           "for (int k = len + lane; k < len; k += 32) "
                           "y[k] =")],
        "8 streams a block": [("kStreams = 16;", "kStreams = 8;")],
        "32 streams a block": [("kStreams = 16;", "kStreams = 32;")],
        "64 threads": [("kThreads = 128;", "kThreads = 64;")],
        "256 threads": [("kThreads = 128;", "kThreads = 256;")],
    }),
    "k9": ("silk_cng.cu", {
        "as committed": [],
        "loads after the stores": [("for (; i + 4 <= frame; i += 4) {",
                                    "for (; i + 4 <= 0; i += 4) {")],
        "no walk": [("  if (tid < ns && (on >> tid & 1)) {",
                     "  if (false) {")],
        "no row staging": [("    stage_row(", "    if (false) stage_row(")],
        "no mask-off copy": [("for (int c0 = lane; c0 < frame; c0 += 128)",
                              "for (int c0 = frame; c0 < frame; c0 += 128)")],
        "256 threads": [("kThreads = 512;", "kThreads = 256;")],
        "8 streams": [("kStreams = 16;", "kStreams = 8;")],
    }),
}


# (B, n, order) of K5's timed calls
K5_SHAPES = [(16, 40, 10), (16, 60, 10), (16, 80, 16), (16, 320, 16),
             (2048, 320, 16)]


def build_variant(name: str, src: str, edits, work: pathlib.Path):
    """The package's csrc/ copied with the edits applied to src, built
    and loaded."""
    from esp32_opus_player_tpu_torch.ops import _build
    slug = re.sub(r"[^a-z0-9]+", "_", f"{src} {name}".lower())
    csrc = work / slug / "csrc"
    shutil.copytree(_build._PKG / "csrc", csrc)
    text = (csrc / src).read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"variant {name!r}: {old!r} not in {src}")
        text = text.replace(old, new)
    (csrc / src).write_text(text)
    _build.CSRC, _build.BUILD_DIR = csrc, work / slug / "build"
    _build._lib = None
    return _build.lib()


def cases(dev):
    """kernel -> {call: one wrapper call at the path's shape}."""
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_port_util import (DBS, OV, column_slices, comb_params,
                                 imdct_tdac_inputs, plc_lane,
                                 silk_plc_inputs)
    from esp32_opus_player_tpu_torch.ops.celt.comb import comb_deemph_step_T
    from esp32_opus_player_tpu_torch.ops.celt.plc_kernel import celt_plc_T
    from esp32_opus_player_tpu_torch.ops.celt.deemph import deemphasis_T
    from esp32_opus_player_tpu_torch.ops.celt.fft import celt_imdct_tdac_T
    from esp32_opus_player_tpu_torch.ops.silk.cng_kernel import cng_add
    from esp32_opus_player_tpu_torch.ops.silk.lpc_synth import lpc_synth
    from esp32_opus_player_tpu_torch.ops.silk.plc_kernel import (
        silk_plc_conceal)
    from esp32_opus_player_tpu_torch.ops.silk.torch_core import (
        _resampler_spec)
    from esp32_opus_player_tpu_torch.ops.silk.up2_hq import up2_fir, up2_hq
    rng = np.random.default_rng(5)

    def i32(lo, hi, shape):
        return torch.as_tensor(rng.integers(lo, hi, shape),
                               dtype=torch.int32, device=dev)

    dm = torch.as_tensor(rng.integers(-(1 << 28), 1 << 28, (1, DBS + OV,
                                                            2048)),
                         dtype=torch.int32, device=dev)
    mem = torch.as_tensor(rng.integers(-(1 << 20), 1 << 20, (2048, 1)),
                          dtype=torch.int32, device=dev)
    syn = dm[:, DBS - 960:DBS]
    plc = column_slices(silk_plc_inputs(rng, 2048, 16, 4, 16), dev)
    kw = dict(fs_khz=16, nb_subfr=4, order=16)
    x160, S = i32(-32768, 32768, (2048, 160)), i32(-2 ** 31, 2 ** 31,
                                                   (2048, 6))
    x304 = i32(-32768, 32768, (2048, 311))[:, 7:]
    F = i32(-32768, 32768, (2048, 8))
    spec = _resampler_spec(16, 48)
    fir = dict(batch_size=spec["batch_size"], inv_ratio=spec["inv_ratio"])
    cng = column_slices([rng.integers(-32768, 32768, (2048, 320)),
                         rng.integers(-(1 << 16), 1 << 16, (2048, 320)),
                         rng.integers(-(1 << 12), 1 << 12, (2048, 16)),
                         rng.integers(1 << 8, 1 << 14, 2048),
                         rng.integers(-2 ** 31, 2 ** 31, (2048, 16))], dev)
    cng.append(torch.arange(2048, device=dev) % 10 == 3)
    k1 = {}
    for flags in ("false", "random", "true"):
        f, d, tr = imdct_tdac_inputs(rng, 2048, 3, flags)
        f, d = (torch.as_tensor(a, device=dev) for a in (f, d))
        tr = torch.as_tensor(tr, device=dev)
        work = d.clone()
        k1[flags] = (lambda f=f, w=work, tr=tr: [celt_imdct_tdac_T(f, w, tr,
                                                                  LM=3)],
                     lambda d=d, w=work: w.copy_(d))
    # P1: 205 rows of a 2048-column lane (a tenth, as the pools lose),
    # CC 1 all first conceals (the mono pool's kind), and chip_smoke.py's
    # two seeded lanes (about half the rows first); and 132 rows, one an
    # SM; each call conceals in place, so reset restores the lane before
    # the bits are taken
    p1 = {}
    for name, CC, R, seed, all_first in (
            ("cc1 first", 1, 205, 78, True), ("cc1 seeded", 1, 205, 78, False),
            ("cc2 seeded", 2, 205, 79, False),
            ("cc1 first, 132 rows", 1, 132, 78, True)):
        st, pcm, rows, first = plc_lane(dev, CC, R, seed)
        if all_first:
            first = torch.ones_like(first)
        work = [t.clone() for t in (*st, pcm)]
        p1[name] = (lambda w=work, r=rows, f=first: (
                        celt_plc_T(*w, r, f), w)[1],
                    lambda w=work, s=(*st, pcm): [a.copy_(b) for a, b
                                                  in zip(w, s)])
    # K4 at every frame size, B 2048, in place on its rows (reset)
    k4 = {}
    for N in (960, 480, 240, 120):
        c1, c2 = ([torch.as_tensor(v, device=dev)
                   for v in comb_params(rng, 2048)] for _ in range(2))
        buf = i32(-(1 << 26), 1 << 26, (DBS + OV, 2048))
        memk = i32(-(1 << 20), 1 << 20, 2048)
        work = buf.clone()
        k4[f"N {N}"] = (lambda w=work, N=N, c1=c1, c2=c2, m=memk: list(
                            comb_deemph_step_T(w, DBS - N, N, c1, c2, m)),
                        lambda w=work, b=buf: w.copy_(b))
    # K5 at the 48-stream pool's three 16-row bucket shapes, the JAX
    # conceal frame's (16, 320, 16) and a wide (2048, 320, 16)
    k5 = {}
    for Bs, n, order in K5_SHAPES:
        args = (i32(-(1 << 24), 1 << 24, (Bs, n)),
                i32(-(1 << 12), 1 << 12, (Bs, order)),
                i32(-(1 << 24), 1 << 24, (Bs, 16)))
        k5[f"B {Bs}, n {n}, order {order}"] = (
            lambda a=args, o=order: list(lpc_synth(*a, order=o)))
    return {"k1": k1, "p1": p1, "k4": k4, "k5": k5,
            "k3": {"": lambda: deemphasis_T(syn, mem)},
            "k6": {"bare": lambda: up2_hq(S, x160),
                   "fused": lambda: up2_fir(S, F, x304, **fir)},
            "k8": {"": lambda: silk_plc_conceal(*plc, **kw)},
            "k9": {"": lambda: cng_add(*cng, frame=320, order=16)}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernels", nargs="*", help="k1, k3, k4, k5, k6, k8, k9, "
                    "p1 (default all)")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    args.kernels = args.kernels or list(VARIANTS)
    if not set(args.kernels) <= set(VARIANTS):
        ap.error(f"kernels are {', '.join(VARIANTS)}")
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from chip_smoke import device_ms, nvidia_smi
    from esp32_opus_player_tpu_torch.ops import _build
    card = nvidia_smi("name,power.limit")
    calls = cases(torch.device("cuda"))
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        for k in args.kernels:
            src, variants = VARIANTS[k]
            libs = {name: build_variant(name, src, edits, pathlib.Path(tmp))
                    for name, edits in variants.items()}
            outs, ms = {}, {name: {c: [] for c in calls[k]}
                            for name in variants}
            # a call is fn, or (fn, reset) for one that updates its
            # inputs in place: reset restores them before the bits
            fns = {c: v if isinstance(v, tuple) else (v, None)
                   for c, v in calls[k].items()}
            for name, lib in libs.items():
                _build._lib = lib
                outs[name] = []
                for c, (fn, reset) in fns.items():
                    if reset is not None:
                        reset()
                    try:
                        outs[name] += [t.clone() for t in fn()]
                    except RuntimeError as e:
                        raise SystemExit(f"{k} {name!r} {c!r}: {e}")
            torch.cuda.synchronize()
            for r in range(args.rounds):
                order = list(libs) if r % 2 == 0 else list(libs)[::-1]
                for name in order:
                    _build._lib = libs[name]
                    for c, (fn, reset) in fns.items():
                        if reset is not None:
                            reset()
                        ms[name][c].append(device_ms(fn, 20))
            # one call: variant -> ms per round, as before
            if list(calls[k]) == [""]:
                ms = {name: v[""] for name, v in ms.items()}
            same = {name: all(torch.equal(a, b) for a, b in
                              zip(o, outs["as committed"]))
                    for name, o in outs.items()}
            print(json.dumps({"card": card, "kernel": k, "ms": ms,
                              "same_bits": same}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
