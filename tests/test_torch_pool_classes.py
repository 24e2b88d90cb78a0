"""The port's StreamPool classifies every fixture as the JAX pool does, at
channels 1 and 2, in compat and RFC mode (the JAX pool with
ms_batch=False, whose multistream rows are ("ms",) as the port's), so no
stream that the JAX pool batches reaches the port's scalar route; the
CELT tuple alone differs by design (the port keys a CELT lane by (LM,
coded channels), the JAX pool by frame size). Then code-3 SILK packets
(two 20 ms frames a packet, muxed from a fixture's packets with
tools/oggmux.py), mono and stereo, which the JAX pool batches in RFC
mode two device frames a packet: the port's lane bit-equal to both
decode_files."""
import sys

import pytest

from esp32_opus_player_tpu import DecoderConfig as JaxConfig
from esp32_opus_player_tpu import decode_file as jax_decode_file
from esp32_opus_player_tpu.models.stream_pool import StreamPool as JaxPool
from esp32_opus_player_tpu_torch import DecoderConfig, decode_file
from esp32_opus_player_tpu_torch.host import opusfile
from esp32_opus_player_tpu_torch.models.stream_pool import StreamPool

from conftest import FIXTURES, ROOT
from torch_port_util import assert_equal

sys.path.insert(0, str(ROOT.parent / "tools"))
import oggmux  # noqa: E402

NAMES = sorted(p.stem for p in FIXTURES.glob("*.opus"))


def _as_jax(path):
    """The port's class in the JAX pool's form."""
    if path[0] == "celt":
        return ("celt", 120 << path[1], path[3])
    return path


@pytest.mark.parametrize("compat", [True, False])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("name", NAMES)
def test_class_equals_the_jax_pools(name, channels, compat):
    src = (FIXTURES / f"{name}.opus").read_bytes()
    want = JaxPool([src], channels=channels, compat_ref=compat,
                   ms_batch=False).path[0]
    got = StreamPool([src], channels=channels, compat_ref=compat,
                     device="cpu").path[0]
    assert _as_jax(got) == want


def _code3(name, n):
    """Pairs of a 20 ms SILK stream's packets as code-3 VBR packets of two
    frames each (RFC 6716 3.2.5)."""
    s = opusfile.parse_stream((FIXTURES / f"{name}.opus").read_bytes())
    pk = [j.data for j in s.jobs[:2 * n]]
    out = []
    for a, b in zip(pk[::2], pk[1::2]):
        d0, d1 = a[1:], b[1:]
        L = len(d0)
        size = bytes([L]) if L < 252 else bytes(
            [252 + (L & 3), (L - 252 - (L & 3)) >> 2])
        out.append(bytes([a[0] | 3, 0x80 | 2]) + size + d0 + d1)
    return oggmux.mux(out, [1920] * len(out), channels=s.head.channel_count,
                      pre_skip=s.head.pre_skip)


@pytest.mark.parametrize("name,channels,kind", [
    ("silk_wb_mono_20ms", 1, "silk"), ("silk_wb_stereo_20ms", 2, "silk2")])
def test_code3_silk_lane_matches_decode_files(name, channels, kind, tmp_path):
    src = _code3(name, 25)
    pool = StreamPool([src] * 2, channels=channels, compat_ref=False,
                      superstep_k=3, device="cpu")
    assert pool.path[0] == (kind, 16, 2, 20, 20)
    path = tmp_path / "code3.opus"
    path.write_bytes(src)
    ref = decode_file(str(path), DecoderConfig(channels=channels,
                                               compat_ref=False,
                                               device="cpu"))
    assert_equal(ref, jax_decode_file(str(path), JaxConfig(
        channels=channels, compat_ref=False)), "the two decode_files")
    for out in pool.run():
        assert len(out) > 40000
        assert_equal(out, ref, name)
