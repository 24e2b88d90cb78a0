"""Opus range (entropy) decoder — host-side, sequential per stream.

Semantics match the reference entropy layer (reference: src/celt.cpp:2627-2792,
src/celt.h:244-250, ec_tell at src/celt.h:420-422; RFC 6716 §4.1). This is the
single shared coder state that both SILK and CELT consume within one frame;
CELT additionally reads raw bits backwards from the end of the packet
(ec_dec_bits / ec_read_byte_from_end).

This pure-Python class is the semantic model; the batched C++ entropy engine
(host/native) reproduces it byte-for-byte and is the production path.

The port's copy of esp32_opus_player_tpu/host/range_decoder.py (numpy
and Python ints; nothing of the JAX package is imported).
"""
from __future__ import annotations

EC_SYM_BITS = 8
EC_CODE_BITS = 32
EC_SYM_MAX = (1 << EC_SYM_BITS) - 1
EC_CODE_TOP = 1 << (EC_CODE_BITS - 1)
EC_CODE_BOT = EC_CODE_TOP >> EC_SYM_BITS
EC_CODE_EXTRA = (EC_CODE_BITS - 2) % EC_SYM_BITS + 1  # 7
EC_WINDOW_SIZE = 32
EC_UINT_BITS = 8
BITRES = 3

_M32 = 0xFFFFFFFF


def ec_ilog(x: int) -> int:
    """Index of the highest set bit, plus one (EC_ILOG; 0 undefined)."""
    return x.bit_length()


class RangeDecoder:
    __slots__ = ("buf", "storage", "offs", "end_offs", "end_window",
                 "nend_bits", "nbits_total", "val", "rng", "rem", "error",
                 "ext")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.storage = len(buf)
        self.end_offs = 0
        self.end_window = 0
        self.nend_bits = 0
        self.nbits_total = (EC_CODE_BITS + 1
                            - ((EC_CODE_BITS - EC_CODE_EXTRA)
                               // EC_SYM_BITS) * EC_SYM_BITS)
        self.offs = 0
        self.rng = 1 << EC_CODE_EXTRA
        self.rem = self._read_byte()
        self.val = self.rng - 1 - (self.rem >> (EC_SYM_BITS - EC_CODE_EXTRA))
        self.error = 0
        self._normalize()

    # -- byte sources -----------------------------------------------------
    def _read_byte(self) -> int:
        if self.offs < self.storage:
            b = self.buf[self.offs]
            self.offs += 1
            return b
        return 0

    def _read_byte_from_end(self) -> int:
        if self.end_offs < self.storage:
            self.end_offs += 1
            return self.buf[self.storage - self.end_offs]
        return 0

    def _normalize(self) -> None:
        while self.rng <= EC_CODE_BOT:
            self.nbits_total += EC_SYM_BITS
            self.rng = (self.rng << EC_SYM_BITS) & _M32
            sym = self.rem
            self.rem = self._read_byte()
            sym = ((sym << EC_SYM_BITS) | self.rem) >> (
                EC_SYM_BITS - EC_CODE_EXTRA)
            self.val = (((self.val << EC_SYM_BITS)
                         + (EC_SYM_MAX & ~sym & 0xFF)) & (EC_CODE_TOP - 1))

    # -- core decode ------------------------------------------------------
    def decode(self, ft: int) -> int:
        self.ext = self.rng // ft
        s = self.val // self.ext
        return ft - min(s + 1, ft)

    def decode_bin(self, bits: int) -> int:
        self.ext = self.rng >> bits
        s = self.val // self.ext
        return (1 << bits) - min(s + 1, 1 << bits)

    def update(self, fl: int, fh: int, ft: int) -> None:
        s = (self.ext * (ft - fh)) & _M32
        self.val = (self.val - s) & _M32
        if fl > 0:
            self.rng = (self.ext * (fh - fl)) & _M32
        else:
            self.rng = (self.rng - s) & _M32
        self._normalize()

    def dec_bit_logp(self, logp: int) -> int:
        r = self.rng
        d = self.val
        s = r >> logp
        ret = 1 if d < s else 0
        if not ret:
            self.val = d - s
        self.rng = s if ret else r - s
        self._normalize()
        return ret

    def dec_icdf(self, icdf, ftb: int) -> int:
        d = self.val
        s = self.rng
        r = s >> ftb
        ret = -1
        while True:
            ret += 1
            t = s
            s = r * int(icdf[ret])
            if d >= s:
                break
        self.val = d - s
        self.rng = t - s
        self._normalize()
        return ret

    def dec_uint(self, ft: int) -> int:
        assert ft > 1
        ft -= 1
        ftb = ec_ilog(ft)
        if ftb > EC_UINT_BITS:
            ftb -= EC_UINT_BITS
            ftsmall = (ft >> ftb) + 1
            s = self.decode(ftsmall)
            self.update(s, s + 1, ftsmall)
            t = (s << ftb) | self.dec_bits(ftb)
            if t <= ft:
                return t
            self.error = 1
            return ft
        else:
            ft += 1
            s = self.decode(ft)
            self.update(s, s + 1, ft)
            return s

    def dec_bits(self, bits: int) -> int:
        window = self.end_window
        available = self.nend_bits
        if available < bits:
            while True:
                window |= self._read_byte_from_end() << available
                available += EC_SYM_BITS
                if available > EC_WINDOW_SIZE - EC_SYM_BITS:
                    break
        ret = window & ((1 << bits) - 1)
        window >>= bits
        available -= bits
        self.end_window = window
        self.nend_bits = available
        self.nbits_total += bits
        return ret

    # -- position queries -------------------------------------------------
    def tell(self) -> int:
        return self.nbits_total - ec_ilog(self.rng)

    def tell_frac(self) -> int:
        correction = (35733, 38967, 42495, 46340, 50535, 55109, 60097, 65535)
        nbits = self.nbits_total << BITRES
        ell = ec_ilog(self.rng)
        r = self.rng >> (ell - 16)
        b = (r >> 12) - 8
        if r > correction[b]:
            b += 1
        ell = (ell << 3) + b
        return nbits - ell

    def export_state(self):
        """Serialize the coder state for handoff to the native engine
        (hybrid frames: SILK symbols consumed here, CELT continues in C++).
        Layout matches celt_host_decode_resume."""
        return [self.offs, self.end_offs, self.end_window, self.nend_bits,
                self.nbits_total, self.val & 0xFFFFFFFF,
                self.rng & 0xFFFFFFFF, self.rem, self.error]

    @property
    def range_final(self) -> int:
        """OPUS_GET_FINAL_RANGE conformance value (rng after last symbol)."""
        return self.rng


# Laplace decoder for CELT coarse energy
# (reference src/celt.cpp:3041-3083).
LAPLACE_LOG_MINP = 0
LAPLACE_MINP = 1 << LAPLACE_LOG_MINP
LAPLACE_NMIN = 16


def _laplace_get_freq1(fs0: int, decay: int) -> int:
    ft = 32768 - LAPLACE_MINP * (2 * LAPLACE_NMIN) - fs0
    return (ft * (16384 - decay)) >> 15


def laplace_decode(dec: RangeDecoder, fs: int, decay: int) -> int:
    val = 0
    fm = dec.decode_bin(15)
    fl = 0
    if fm >= fs:
        val += 1
        fl = fs
        fs = _laplace_get_freq1(fs, decay) + LAPLACE_MINP
        while fs > LAPLACE_MINP and fm >= fl + 2 * fs:
            fs *= 2
            fl += fs
            fs = ((fs - 2 * LAPLACE_MINP) * decay) >> 15
            fs += LAPLACE_MINP
            val += 1
        if fs <= LAPLACE_MINP:
            di = (fm - fl) >> (LAPLACE_LOG_MINP + 1)
            val += di
            fl += 2 * di * LAPLACE_MINP
        if fm < fl + fs:
            val = -val
        else:
            fl += fs
    dec.update(fl, min(fl + fs, 32768), 32768)
    return val
