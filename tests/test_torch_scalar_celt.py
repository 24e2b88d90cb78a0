"""The port's scalar decoder (models/opus_decoder.py, the scalar route)
on the CELT fixtures of tests/test_bitexact_all.py and the mode-switching
one, on the CPU: every sample bit-equal to tests/golden and each
packet's final range equal to the reference's where that test compares
them. tests/test_torch_scalar_silk.py has the SILK and hybrid fixtures."""
import pytest

from test_bitexact_all import FIXTURES
from torch_port_util import scalar_matches_golden

CASES = [f for f in FIXTURES if f[0].startswith(("celt", "modeswitch"))]


def test_cases_cover_the_celt_fixtures():
    assert len(CASES) == 7


@pytest.mark.parametrize("name,ch,range_comparable", CASES)
def test_scalar_decoder_matches_golden(name, ch, range_comparable):
    scalar_matches_golden(name, ch, range_comparable)
