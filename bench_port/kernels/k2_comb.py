"""K2 (csrc/celt_comb.cu, comb_tile_kernel<false>): the comb postfilter
of one channel of a CELT frame step, B rows, in place. What a row costs
depends on its frame's postfilter (a row whose two gains are 0 does
nothing), which the trace does not show: counted at the floor every row
pays, its 12 parameters read."""

NAME = "K2_comb"
MATCH = r"\bcomb_tile_kernel<false>"
KIND = "int32"


def work(s):
    return s["B"] * 12 * 4.0, 0.0
