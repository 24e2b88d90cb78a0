"""tools/kernel_variants.py builds copies of the port's csrc/ with text
edits (a launch-shape constant changed, a phase cut out) and times them
on a card. An edit whose text no longer occurs in its source would stop
the tool there; each one is held here to the committed source, so a
rewritten kernel takes its variants along. Needs no nvcc and no card."""
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import kernel_variants  # noqa: E402

CSRC = ROOT / "esp32_opus_player_tpu_torch" / "csrc"
CASES = [(k, name) for k, (_, variants) in kernel_variants.VARIANTS.items()
         for name in variants]


@pytest.mark.parametrize("kernel,variant", CASES)
def test_variant_edits_occur_in_source(kernel, variant):
    src, variants = kernel_variants.VARIANTS[kernel]
    text = (CSRC / src).read_text()
    edits = variants[variant]
    assert variant == "as committed" or edits, "a variant changes nothing"
    for old, new in edits:
        assert old in text, f"{kernel} {variant!r}: {old!r} not in {src}"
        assert new != old
