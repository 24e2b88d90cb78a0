"""The port stands alone: a fresh interpreter runs the entry's step and
decodes a CELT and a SILK fixture through it, a SILK fixture with lost
packets (concealment and in-band FEC) and a CELT one with lost packets
(both conceal branches), a fixture through the port's decode_file (the
scalar route) bit-equal to tests/golden, a stereo SILK and a stereo
hybrid fixture through the pool's lanes bit-equal to tests/golden and a
stereo SILK one with lost packets, the bench module imported,
with neither JAX nor the JAX package loaded, and no source
file of the port (nor chip_smoke.py, nor the port's tools) imports
either. A native host library that fails to load raises at parse time."""
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "esp32_opus_player_tpu_torch"

_PROBE = """
import sys
from esp32_opus_player_tpu_torch.models.stream_pool import StreamPool
from esp32_opus_player_tpu_torch.utils import state
from esp32_opus_player_tpu_torch import bench, entry
fn, args = entry.entry(device="cpu")
assert fn(*args)[0].shape == (8, 1, 960)
for src in sys.argv[1:]:
    pool = StreamPool([src], channels=1, device="cpu")
    for _ in range(3):
        pool.step()
    out = pool.collected()[0]
    assert out.shape[1] == 1 and len(out) > 960, (src, out.shape)
lossy = StreamPool([sys.argv[-1]], compat_ref=False, rfc_plc=True,
                   superstep_k=2, device="cpu")
while lossy.positions[0] < 7:
    k = int(lossy.positions[0])
    lossy.step(lost={0} if k in (2, 3, 5) else None,
               fec={0} if k == 5 else None)
out = lossy.collected()[0]
assert len(out) > 6 * 960 - 400 and out[3 * 960:4 * 960].any(), out.shape
celt = StreamPool([sys.argv[1]], compat_ref=False, rfc_plc=True,
                  superstep_k=2, device="cpu")
while celt.positions[0] < 12:
    k = int(celt.positions[0])
    celt.step(lost={0} if k in (3, 6, 7, 8, 9, 10, 11) else None)
out = celt.collected()[0]
assert len(out) == 12 * 960 - 312 and out[-960:].any(), out.shape
import numpy as np
from esp32_opus_player_tpu_torch import DecoderConfig, decode_file
pcm = decode_file(sys.argv[2], DecoderConfig(channels=1, compat_ref=True,
                                             device="cpu"))
gold = np.fromfile(sys.argv[2].replace("fixtures", "golden").replace(
    ".opus", ".pcm"), dtype=np.int16).reshape(-1, 2)
assert np.array_equal(np.repeat(pcm, 2, axis=1), gold)
fix = sys.argv[2].rsplit("/", 1)[0]
for name in ("silk_wb_stereo_20ms", "hybrid_fb_stereo_20ms"):
    pool = StreamPool([f"{fix}/{name}.opus"], channels=2, superstep_k=4,
                      device="cpu")
    assert pool.path[0][0] in ("silk2", "hybrid2"), pool.path
    for _ in range(8):
        pool.step()
    out = pool.collected()[0]
    gold = np.fromfile(f"{fix}/../golden/{name}.pcm",
                       dtype=np.int16).reshape(-1, 2)
    assert len(out) == 8 * 960 - 312 and np.array_equal(
        out, gold[:len(out)]), name
stereo = StreamPool([f"{fix}/silk_wb_fec_stereo_20ms.opus"], channels=2,
                    compat_ref=False, rfc_plc=True, superstep_k=2,
                    device="cpu")
while stereo.positions[0] < 7:
    k = int(stereo.positions[0])
    stereo.step(lost={0} if k in (2, 3, 5) else None,
                fec={0} if k == 5 else None)
out = stereo.collected()[0]
assert len(out) > 6 * 960 - 400 and out[3 * 960:4 * 960].any(), out.shape
print(sorted(m for m in sys.modules if m.startswith("jax")
             or m.split(".")[0] == "esp32_opus_player_tpu"))
"""


def test_port_decodes_without_importing_jax():
    srcs = [ROOT / "tests" / "fixtures" / f"{n}.opus"
            for n in ("celt_fb_mono_20ms", "silk_wb_mono_20ms",
                      "silk_wb_fec_mono_20ms")]
    res = subprocess.run([sys.executable, "-c", _PROBE, *map(str, srcs)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]", res.stdout


def test_port_sources_never_import_jax():
    jax = re.compile(r"^\s*(import jax|from jax)\b", re.M)
    jax_pkg = re.compile(
        r"^\s*(import|from)\s+esp32_opus_player_tpu(\.|\s|$)", re.M)
    files = list(PKG.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tools" / "profile_torch_pool.py",
        ROOT / "tools" / "kernel_variants.py"]
    assert len(files) > 25
    names = {p.name for p in files}
    assert {"torch_plc.py", "plc_kernel.py", "cng_kernel.py",
            "batch_silk.py", "comb.py", "batch_celt.py", "row_synthesis.py",
            "bench.py", "entry.py", "fixed_point.py", "math.py",
            "pvq.py", "range_decoder.py", "bands.py", "synthesis.py",
            "plc_ref.py", "celt_decoder.py", "macros.py", "decode.py",
            "nlsf.py", "core.py", "plc.py", "stereo.py", "resampler.py",
            "silk_decoder.py", "opus_decoder.py", "ms_decoder.py",
            "api.py", "device.py", "stereo_kernel.py", "silk_pool.py",
            "host_groups.py"} <= names
    assert (PKG / "ops" / "celt" / "torch_plc.py") in files
    assert (PKG / "api.py") in files
    for p in files:
        text = p.read_text()
        assert not jax.search(text), p
        assert not jax_pkg.search(text), p


def test_failed_native_load_raises_at_parse_time(monkeypatch):
    """The page scanner does not hide a native library that fails to
    build or load behind a Python fallback: parsing raises the error."""
    import pytest
    from esp32_opus_player_tpu_torch.host import native, opusfile

    def broken():
        raise OSError("no native library")

    monkeypatch.setattr(native, "load", broken)
    data = (ROOT / "tests" / "fixtures" / "silk_wb_mono_20ms.opus"
            ).read_bytes()
    with pytest.raises(OSError, match="no native library"):
        opusfile.parse_stream(data)
