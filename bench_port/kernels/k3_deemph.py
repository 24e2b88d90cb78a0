"""K3 (csrc/celt_deemph.cu, deemph_kernel): the deemphasis of a CELT frame
step, CC channels of B rows: N int32 samples and the filter memory read,
N int16 samples and the memory written; a product, a sum and a rounding
shift a sample (the recurrence's chain is not charged)."""

NAME = "K3_deemph"
MATCH = r"\bdeemph_kernel\b"
KIND = "int32"


def work(s):
    N, rows = 120 << s["LM"], s["B"] * s["CC"]
    return rows * (6.0 * N + 8), rows * 3.0 * N
