"""Build the hand-written CUDA kernels (csrc/*.cu) and bind them.

The sources compile with nvcc into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), which ctypes
loads. The build runs at first use, into build/<hash of the sources>/
inside this package; a later process with the same sources loads the
library that is there. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

from ..utils import spans

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# flags of one source beside the common ones: P1 is float32 and keeps
# every product and sum rounded on its own, as its plain version's torch
# operations are (csrc/celt_plc.cu says why)
SOURCE_FLAGS = {"celt_plc.cu": ["-fmad=false"]}

_lock = threading.Lock()
_lib = None
# what `nvcc -Xptxas -v` printed for the last build in this process
# (registers, shared memory and spills per kernel); empty when the
# library was already built
ptxas_log = ""


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def library_path() -> pathlib.Path:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    return BUILD_DIR / h.hexdigest()[:16] / "libotpu_kernels.so"


def build() -> pathlib.Path:
    """Compile csrc/*.cu into the hashed build directory (if absent): one
    nvcc per source, all started together, then one link."""
    global ptxas_log
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = out.parent / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-c", "-Xcompiler",
               "-fPIC", "-Xptxas", "-v", *SOURCE_FLAGS.get(src.name, []),
               "-o", str(obj), str(src)]
        jobs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True)))
    logs, failed = [], []
    for obj, proc in jobs:
        logs.append(proc.communicate()[0])
        if proc.returncode != 0:
            failed.append(logs[-1])
    tmp = out.with_suffix(f".{tag}")
    if not failed:
        res = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                              *[str(o) for o, _ in jobs]],
                             capture_output=True, text=True)
        if res.returncode != 0:
            failed.append(res.stdout + res.stderr)
    for obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    ptxas_log = "".join(logs)
    os.replace(tmp, out)
    return out


def lib():
    """The loaded kernel library, built on first call (a `load.cuda`
    span, its `compiled` 1 where it was built)."""
    global _lib
    with _lock:
        if _lib is None:
            rec = spans.recorder()
            sp = rec.open("load.cuda")
            compiled = not library_path().exists()
            try:
                _lib = _bind(ctypes.CDLL(str(build())))
            finally:
                rec.close(sp, None, (float(compiled),))
            if compiled:
                rec.count("load.cuda.compiled")
        return _lib


def _bind(so):
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    so.celt_fft_blocks.restype = i
    so.celt_fft_blocks.argtypes = [p, i, p, p, p, p, p, p, p, i, i, i, p, p]
    so.celt_imdct_tdac.restype = i
    so.celt_imdct_tdac.argtypes = [p, ll, p, ll, p, i, i, i, p, p, p, p, p]
    so.celt_comb_step.restype = i
    so.celt_comb_step.argtypes = [p, i, i, i, p, p, p, p, p]
    so.celt_deemph.restype = i
    so.celt_deemph.argtypes = [p, ll, i, i, i, p, p, p, i, p]
    so.silk_lpc_synth.restype = i
    so.silk_lpc_synth.argtypes = [p, i, i, p, i, p, p, p, p]
    so.silk_up2_hq.restype = i
    so.silk_up2_hq.argtypes = [p, i, i, ll, p, p, p, p]
    so.silk_up2_fir.restype = i
    so.silk_up2_fir.argtypes = [p, ll, p, ll, p, ll, i, i, i, i, i, p, i, p,
                                p, p]
    so.silk_core.restype = i
    so.silk_core.argtypes = [p, p, ll, p, p, p, i, i, i, i, p]
    so.silk_plc.restype = i
    so.silk_plc.argtypes = [p, p, ll, p, p, i, i, i, i, p]
    so.silk_cng.restype = i
    so.silk_cng.argtypes = [p, p, p, p, i, i, i, p]
    so.celt_comb_deemph.restype = i
    so.celt_comb_deemph.argtypes = [p, i, i, i, p, p, p, p, p, p, p, p]
    so.celt_plc.restype = i
    so.celt_plc.argtypes = [p, ll, i, p, p, p, p, p, p, i, p]
    so.silk_ms_to_lr.restype = i
    so.silk_ms_to_lr.argtypes = [p, p, p, p, p, i, i, i, p]
    so.otpu_cuda_error_string.restype = ctypes.c_char_p
    so.otpu_cuda_error_string.argtypes = [i]
    return so


def check(err: int, what: str) -> None:
    """Raise if a launch entry returned a CUDA error code."""
    if err != 0:
        msg = lib().otpu_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
