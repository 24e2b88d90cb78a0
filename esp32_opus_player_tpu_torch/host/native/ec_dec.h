// Shared Opus range decoder for the native host engines (C++ twin of
// host/range_decoder.py; reference src/celt.cpp:2627-2792).
#pragma once
#include <cstdint>
#include <algorithm>

namespace opus_ec {

typedef int32_t i32;
typedef uint32_t u32;
constexpr int EC_BITRES = 3;

static inline int ec_ilog(u32 x) { return x ? 32 - __builtin_clz(x) : 0; }

struct EcDec {
    const unsigned char* buf;
    u32 storage, offs, end_offs, end_window;
    int nend_bits, nbits_total;
    u32 val, rng, ext;
    int rem, error;

    int read_byte() { return offs < storage ? buf[offs++] : 0; }
    int read_byte_from_end() {
        return end_offs < storage ? buf[storage - ++end_offs] : 0;
    }
    void normalize() {
        while (rng <= (1u << 23)) {
            nbits_total += 8;
            rng <<= 8;
            int sym = rem;
            rem = read_byte();
            sym = (sym << 8 | rem) >> 1;
            val = ((val << 8) + (255 & ~sym)) & ((1u << 31) - 1);
        }
    }
    void init(const unsigned char* b, u32 len) {
        buf = b; storage = len;
        end_offs = 0; end_window = 0; nend_bits = 0;
        nbits_total = 33 - 24;
        offs = 0; rng = 128;
        rem = read_byte();
        val = rng - 1 - (rem >> 1);
        error = 0;
        normalize();
    }
    u32 decode(u32 ft) {
        ext = rng / ft;
        u32 s = val / ext;
        return ft - std::min(s + 1, ft);
    }
    u32 decode_bin(unsigned bits) {
        ext = rng >> bits;
        u32 s = val / ext;
        return (1u << bits) - std::min(s + 1, (u32)1 << bits);
    }
    void update(u32 fl, u32 fh, u32 ft) {
        u32 s = ext * (ft - fh);
        val -= s;
        rng = fl > 0 ? ext * (fh - fl) : rng - s;
        normalize();
    }
    int bit_logp(unsigned logp) {
        u32 r = rng, d = val, s = r >> logp;
        int ret = d < s;
        if (!ret) val = d - s;
        rng = ret ? s : r - s;
        normalize();
        return ret;
    }
    int icdf(const unsigned char* tab, unsigned ftb) {
        u32 s = rng, d = val, r = s >> ftb, t;
        int ret = -1;
        do { t = s; s = r * tab[++ret]; } while (d < s);
        val = d - s;
        rng = t - s;
        normalize();
        return ret;
    }
    u32 dec_bits(unsigned bits) {
        u32 window = end_window;
        int available = nend_bits;
        if ((unsigned)available < bits) {
            do {
                window |= (u32)read_byte_from_end() << available;
                available += 8;
            } while (available <= 32 - 8);
        }
        u32 ret = window & ((1u << bits) - 1);
        window >>= bits;
        available -= bits;
        end_window = window;
        nend_bits = available;
        nbits_total += bits;
        return ret;
    }
    u32 dec_uint(u32 ft) {
        ft--;
        int ftb = ec_ilog(ft);
        if (ftb > 8) {
            ftb -= 8;
            u32 ft2 = (ft >> ftb) + 1;
            u32 s = decode(ft2);
            update(s, s + 1, ft2);
            u32 t = (s << ftb) | dec_bits(ftb);
            if (t <= ft) return t;
            error = 1;
            return ft;
        }
        ft++;
        u32 s = decode(ft);
        update(s, s + 1, ft);
        return s;
    }
    int tell() const { return nbits_total - ec_ilog(rng); }
    u32 tell_frac() const {
        static const u32 corr[8] = {35733, 38967, 42495, 46340,
                                    50535, 55109, 60097, 65535};
        u32 nbits = (u32)nbits_total << EC_BITRES;
        int l = ec_ilog(rng);
        u32 r = rng >> (l - 16);
        int b = (int)(r >> 12) - 8;
        b += r > corr[b];
        l = (l << 3) + b;
        return nbits - l;
    }
};


}  // namespace opus_ec
