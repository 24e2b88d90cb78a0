"""The port never imports JAX: a fresh interpreter imports it and
decodes three frames with JAX absent from sys.modules, and no source
file of the package imports it."""
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
pool = StreamPool([sys.argv[1]], channels=1)
for _ in range(3):
    pool.step()
out = pool.collected()[0]
assert out.shape[1] == 1 and len(out) > 2 * 960, out.shape
print(sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")))
"""


def test_port_decodes_without_importing_jax():
    src = ROOT / "tests" / "fixtures" / "celt_fb_mono_20ms.opus"
    res = subprocess.run([sys.executable, "-c", _PROBE, str(src)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]", res.stdout


def test_port_sources_never_import_jax():
    pat = re.compile(r"^\s*(import jax|from jax)\b", re.M)
    files = list(PKG.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tools" / "profile_torch_pool.py"]
    for p in files:
        assert not pat.search(p.read_text()), p
    # the smoke drives the port only through the port's own entry points
    jax_pkg = re.compile(
        r"^\s*(import|from)\s+esp32_opus_player_tpu(\.|\s|$)", re.M)
    assert not jax_pkg.search((ROOT / "chip_smoke.py").read_text())
