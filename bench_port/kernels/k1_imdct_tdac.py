"""K1's fused entry (csrc/celt_fft.cu, imdct_tdac_kernel): one channel of
a CELT frame step, B rows: the inverse MDCT of N = 120 << LM bins, its
TDAC mirror and the decode_mem stores.

Bytes: the spectrum's N int32 and the 60 history samples read, the
transient flag (1 byte), N + 60 int32 written. Operations: the pre- and
post-rotation (a complex product each, 4 products and 2 sums, per FFT
point), the FFT at 5 log2(n) per point for the shorter of the frame's
two block structures (2^LM blocks of n = N / 2^(LM+1) points), and the
mirror over the 120-sample overlap (2 products and a sum a sample)."""
import math

NAME = "K1_imdct_tdac"
MATCH = r"\bimdct_tdac_kernel\b"
KIND = "int32"


def work(s):
    N, B = 120 << s["LM"], s["B"]
    pts = N // 2
    n_short = pts >> s["LM"]
    ops = pts * (12 + 5 * math.log2(n_short)) + 3 * 120
    return B * (8.0 * (N + 60) + 1), B * ops
