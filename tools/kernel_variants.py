"""Time variants of a hand-written kernel on one CUDA card: the committed
source against copies of csrc/ with a launch-shape constant changed or a
phase cut out, each built into its own library and timed in turns.

Run from the repository root on a machine with one CUDA card:

    python3 tools/kernel_variants.py [k3] [k8] [--rounds 3]

A variant is a list of (text, replacement) edits to one source file;
each text must occur in it. A phase is cut by making its loop run zero
times or its branch never taken, so the kernel still writes its outputs
(no longer the right values) and nvcc keeps the other phases. Each
variant is timed as chip_smoke.py times a kernel (one wrapper call
captured in a CUDA graph, replayed between CUDA events), at the path's
shape: K3 at CC 1, B 2048; K8 at WB (16, 4, 16), B 2048, its operands
column slices as the pool passes them. The variants run in turns, round
by round, the order reversed every other round. Prints one JSON line per
kernel: the card, each variant's device ms per round, and whether its
outputs equal the committed source's bit for bit (a cut phase changes
them; a launch shape or a layout must not).
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
}


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
    """kernel -> one wrapper call at the path's shape."""
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_port_util import DBS, OV, column_slices, silk_plc_inputs
    from esp32_opus_player_tpu_torch.ops.celt.deemph import deemphasis_T
    from esp32_opus_player_tpu_torch.ops.silk.plc_kernel import (
        silk_plc_conceal)
    rng = np.random.default_rng(5)
    dm = torch.as_tensor(rng.integers(-(1 << 28), 1 << 28, (1, DBS + OV,
                                                            2048)),
                         dtype=torch.int32, device=dev)
    mem = torch.as_tensor(rng.integers(-(1 << 20), 1 << 20, (2048, 1)),
                          dtype=torch.int32, device=dev)
    syn = dm[:, DBS - 960:DBS]
    plc = column_slices(silk_plc_inputs(rng, 2048, 16, 4, 16), dev)
    kw = dict(fs_khz=16, nb_subfr=4, order=16)
    return {"k3": lambda: deemphasis_T(syn, mem),
            "k8": lambda: silk_plc_conceal(*plc, **kw)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernels", nargs="*", help="k3, k8 (default both)")
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
            outs, ms = {}, {name: [] for name in variants}
            for name, lib in libs.items():
                _build._lib = lib
                outs[name] = [t.clone() for t in calls[k]()]
            torch.cuda.synchronize()
            for r in range(args.rounds):
                order = list(libs) if r % 2 == 0 else list(libs)[::-1]
                for name in order:
                    _build._lib = libs[name]
                    ms[name].append(device_ms(calls[k], 20))
            same = {name: all(torch.equal(a, b) for a, b in
                              zip(o, outs["as committed"]))
                    for name, o in outs.items()}
            print(json.dumps({"card": card, "kernel": k, "ms": ms,
                              "same_bits": same}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
