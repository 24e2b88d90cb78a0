"""The port stands alone: a fresh interpreter decodes a CELT and a SILK
fixture through it with neither JAX nor the JAX package loaded, and no
source file of the port (nor chip_smoke.py, nor the port's profiler)
imports either."""
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
for src in sys.argv[1:]:
    pool = StreamPool([src], channels=1, device="cpu")
    for _ in range(3):
        pool.step()
    out = pool.collected()[0]
    assert out.shape[1] == 1 and len(out) > 960, (src, out.shape)
print(sorted(m for m in sys.modules if m.startswith("jax")
             or m.split(".")[0] == "esp32_opus_player_tpu"))
"""


def test_port_decodes_without_importing_jax():
    srcs = [ROOT / "tests" / "fixtures" / f"{n}.opus"
            for n in ("celt_fb_mono_20ms", "silk_wb_mono_20ms")]
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
        ROOT / "chip_smoke.py", ROOT / "tools" / "profile_torch_pool.py"]
    assert len(files) > 20
    for p in files:
        text = p.read_text()
        assert not jax.search(text), p
        assert not jax_pkg.search(text), p
