// Native host entropy engine: the complete CELT symbol phase
// (range decoder -> energy -> allocation -> PVQ band decode ->
// anti-collapse) for one frame, producing the dense-phase inputs consumed
// by the batched device kernels (ops/celt/jax_synthesis.py).
//
// This is a C++ re-expression of the framework's own Python host phase
// (esp32_opus_player_tpu/ops/celt/{bands,pvq,math}.py and
// host/range_decoder.py), which is itself verified bit-exact against the
// reference decoder. Semantics follow the reference entropy layer
// (reference src/celt.cpp; RFC 6716 §4) including fixed-point rounding.
//
// Built as a shared library (make -C .), loaded via ctypes
// (host/native/__init__.py). ~100x faster than the Python symbol walk;
// this is the per-stream sequential work that feeds the TPU batch.

#include <cstdint>
#include <cstring>
#include <algorithm>

#include "celt_tables.h"

namespace {

typedef int32_t i32;
typedef int16_t i16;
typedef uint32_t u32;

constexpr int NB_EBANDS = 21;
constexpr int BITRES = 3;
constexpr int DB_SHIFT = 10;
constexpr int MAX_FINE_BITS = 8;
constexpr int FINE_OFFSET = 21;
constexpr int QTHETA_OFFSET = 4;
constexpr int QTHETA_OFFSET_TWOPHASE = 16;
constexpr int ALLOC_STEPS = 6;
constexpr int LOG_MAX_PSEUDO = 6;
constexpr int NORM_SCALING = 16384;
constexpr int SPREAD_NORMAL = 2;
constexpr int SPREAD_AGGRESSIVE = 3;
constexpr int BETA_INTRA = 4915;
constexpr int SHORT_MDCT = 120;
constexpr int MINUS_28DB = -(28 << DB_SHIFT);
constexpr int COMBFILTER_MINPERIOD = 15;

// ------------------------------------------------------------------ fixp
static inline i32 SHR32(i32 a, int s) { return a >> s; }
static inline i32 SHL32(i32 a, int s) { return (i32)((u32)a << s); }
static inline i32 PSHR32(i32 a, int s) { return SHR32(a + (SHL32(1, s) >> 1), s); }
static inline i32 VSHR32(i32 a, int s) { return s > 0 ? SHR32(a, s) : SHL32(a, -s); }
static inline i16 EXTRACT16(i32 x) { return (i16)x; }
static inline i32 MULT16_16(i32 a, i32 b) { return (i32)((i16)a) * (i32)((i16)b); }
static inline i32 MAC16_16(i32 c, i32 a, i32 b) { return c + MULT16_16(a, b); }
static inline i32 MULT16_16_Q15(i32 a, i32 b) { return MULT16_16(a, b) >> 15; }
static inline i32 MULT16_16_P15(i32 a, i32 b) { return (16384 + MULT16_16(a, b)) >> 15; }
static inline i32 MULT16_32_Q15(i32 a, i32 b) { return (i32)(((int64_t)(i16)a * b) >> 15); }
static inline i32 MULT32_32_Q31(i32 a, i32 b) { return (i32)(((int64_t)a * b) >> 31); }
static inline i32 FRAC_MUL16(i32 a, i32 b) { return (16384 + (i32)((i16)a) * (i16)b) >> 15; }
static inline i16 ADD16(i32 a, i32 b) { return (i16)((i16)a + (i16)b); }
static inline i16 SUB16(i32 a, i32 b) { return (i16)a - (i16)b; }
static inline i16 SHL16(i32 a, int s) { return (i16)((uint16_t)a << s); }
static inline int ec_ilog(u32 x) { return x ? 32 - __builtin_clz(x) : 0; }
static inline int celt_ilog2(i32 x) { return ec_ilog((u32)x) - 1; }
static inline u32 celt_udiv(u32 n, u32 d) { return n / d; }
static inline i32 celt_sudiv(i32 n, i32 d) { return n / d; }
static inline i32 SAT16(i32 x) { return x > 32767 ? 32767 : x < -32768 ? -32768 : x; }

static inline u32 isqrt32(u32 val) {
    u32 g = 0;
    int bshift = (ec_ilog(val) - 1) >> 1;
    u32 b = 1u << bshift;
    do {
        u32 t = ((g << 1) + b) << bshift;
        if (t <= val) { g += b; val -= t; }
        b >>= 1;
        bshift--;
    } while (bshift >= 0);
    return g;
}

static inline i16 celt_rsqrt_norm(i32 x) {
    i16 n = (i16)(x - 32768);
    i16 r = ADD16(23557, MULT16_16_Q15(n, ADD16(-13490, MULT16_16_Q15(n, 6713))));
    i16 r2 = MULT16_16_Q15(r, r);
    i16 y = SHL16(SUB16(ADD16(MULT16_16_Q15(r2, n), r2), 16384), 1);
    return ADD16(r, MULT16_16_Q15(r, MULT16_16_Q15(y, SUB16(MULT16_16_Q15(y, 12288), 16384))));
}

static inline i32 celt_sqrt(i32 x) {
    static const i16 C[5] = {23175, 11561, -3011, 1699, -664};
    if (x == 0) return 0;
    if (x >= 1073741824) return 32767;
    int k = (celt_ilog2(x) >> 1) - 7;
    x = VSHR32(x, 2 * k);
    i16 n = (i16)(x - 32768);
    i32 rt = ADD16(C[0], MULT16_16_Q15(n, ADD16(C[1], MULT16_16_Q15(
        n, ADD16(C[2], MULT16_16_Q15(n, ADD16(C[3], MULT16_16_Q15(n, C[4]))))))));
    return VSHR32(rt, 7 - k);
}

static inline i16 celt_cos_pi_2(i16 x) {
    i16 x2 = MULT16_16_P15(x, x);
    return ADD16(1, std::min((i32)32766, (i32)((32767 - x2) + MULT16_16_P15(
        x2, -7651 + MULT16_16_P15(x2, 8277 + MULT16_16_P15(-626, x2))))));
}

static inline i16 celt_cos_norm(i32 x) {
    x &= 0x1FFFF;
    if (x > 1 << 16) x = (1 << 17) - x;
    if (x & 0x7FFF) {
        if (x < 1 << 15) return celt_cos_pi_2((i16)x);
        return (i16)-celt_cos_pi_2((i16)(65536 - x));
    }
    if (x & 0xFFFF) return 0;
    if (x & 0x1FFFF) return -32767;
    return 32767;
}

static inline i32 celt_rcp(i32 x) {
    int i = celt_ilog2(x);
    i16 n = (i16)(VSHR32(x, i - 15) - 32768);
    i16 r = ADD16(30840, MULT16_16_Q15(-15420, n));
    r = SUB16(r, MULT16_16_Q15(r, ADD16(MULT16_16_Q15(r, n), ADD16(r, -32768))));
    r = SUB16(r, ADD16(1, MULT16_16_Q15(r, ADD16(MULT16_16_Q15(r, n), ADD16(r, -32768)))));
    return VSHR32((i32)r, i - 16);
}

static inline i32 celt_div(i32 a, i32 b) { return MULT32_32_Q31(a, celt_rcp(b)); }

static inline i32 celt_exp2_frac(i16 x) {
    i16 frac = SHL16(x, 4);
    return ADD16(16383, MULT16_16_Q15(frac, ADD16(22804, MULT16_16_Q15(
        frac, ADD16(14819, MULT16_16_Q15(10204, frac))))));
}

static inline i32 celt_exp2(i16 x) {
    int integer = (i16)x >> 10;
    if (integer > 14) return 0x7f000000;
    if (integer < -15) return 0;
    i32 frac = celt_exp2_frac((i16)(x - SHL16(integer, 10)));
    return VSHR32(frac, -integer - 2);
}

static inline u32 celt_lcg_rand(u32 seed) { return 1664525u * seed + 1013904223u; }

static inline i16 bitexact_cos(i16 x) {
    i32 tmp = (4096 + (i32)x * x) >> 13;
    i16 x2 = (i16)tmp;
    x2 = (i16)((32767 - x2) + FRAC_MUL16(x2, -7651 + FRAC_MUL16(x2, 8277 + FRAC_MUL16(-626, x2))));
    return (i16)(1 + x2);
}

static inline i32 bitexact_log2tan(i32 isin, i32 icos) {
    int lc = ec_ilog((u32)icos);
    int ls = ec_ilog((u32)isin);
    icos = SHL32(icos, 15 - lc);
    isin = SHL32(isin, 15 - ls);
    return (ls - lc) * (1 << 11)
        + FRAC_MUL16(isin, FRAC_MUL16(isin, -2597) + 7932)
        - FRAC_MUL16(icos, FRAC_MUL16(icos, -2597) + 7932);
}

#include "ec_dec.h"
using opus_ec::EcDec;

static int laplace_decode(EcDec& ec, u32 fs, i32 decay) {
    int val = 0;
    u32 fl = 0;
    u32 fm = ec.decode_bin(15);
    if (fm >= fs) {
        val++;
        fl = fs;
        fs = (u32)(((32768 - 2 * 16 - (i32)fs) * (16384 - decay)) >> 15) + 1;
        while (fs > 1 && fm >= fl + 2 * fs) {
            fs *= 2;
            fl += fs;
            fs = (u32)((((i32)fs - 2) * decay) >> 15) + 1;
            val++;
        }
        if (fs <= 1) {
            int di = (int)((fm - fl) >> 1);
            val += di;
            fl += 2 * di;
        }
        if (fm < fl + fs) val = -val;
        else fl += fs;
    }
    ec.update(fl, std::min(fl + fs, (u32)32768), 32768);
    return val;
}

// ------------------------------------------------------------------ pvq
static inline u32 pvq_u(int n, int k) {
    int lo = std::min(n, k), hi = std::max(n, k);
    return CELT_PVQ_U_DATA[row_idx[lo] + hi];
}
static inline u32 pvq_v(int n, int k) { return pvq_u(n, k) + pvq_u(n, k + 1); }

static i32 cwrsi(int n, int k, u32 i, int* y) {
    i32 yy = 0;
    while (n > 2) {
        if (k >= n) {
            const unsigned int* row = &CELT_PVQ_U_DATA[row_idx[n]];
            u32 p = row[k + 1];
            int s = i >= p ? -1 : 0;
            if (s) i -= p;
            int k0 = k;
            u32 q = row[n];
            if (q > i) {
                k = n;
                do p = pvq_u(--k, n); while (p > i);
            } else {
                for (p = row[k]; p > i; p = row[k]) k--;
            }
            i -= p;
            i32 v = (k0 - k + s) ^ s;
            *y++ = v;
            yy = MAC16_16(yy, v, v);
        } else {
            u32 p = pvq_u(k, n);
            u32 q = pvq_u(k + 1, n);
            if (p <= i && i < q) {
                i -= p;
                *y++ = 0;
            } else {
                int s = i >= q ? -1 : 0;
                if (s) i -= q;
                int k0 = k;
                do p = pvq_u(--k, n); while (p > i);
                i -= p;
                i32 v = (k0 - k + s) ^ s;
                *y++ = v;
                yy = MAC16_16(yy, v, v);
            }
        }
        n--;
    }
    u32 p = 2 * k + 1;
    int s = i >= p ? -1 : 0;
    if (s) i -= p;
    int k0 = k;
    k = (i + 1) >> 1;
    if (k) i -= 2 * k - 1;
    i32 v = (k0 - k + s) ^ s;
    *y++ = v;
    yy = MAC16_16(yy, v, v);
    s = -(i32)i;
    v = (k + s) ^ s;
    *y = v;
    yy = MAC16_16(yy, v, v);
    return yy;
}

static void exp_rotation1(i16* X, int len, int stride, i16 c, i16 s) {
    i16 ms = -s;
    i16* Xptr = X;
    for (int i = 0; i < len - stride; i++) {
        i16 x1 = Xptr[0], x2 = Xptr[stride];
        Xptr[stride] = EXTRACT16(PSHR32(MAC16_16(MULT16_16(c, x2), s, x1), 15));
        *Xptr++ = EXTRACT16(PSHR32(MAC16_16(MULT16_16(c, x1), ms, x2), 15));
    }
    Xptr = &X[len - 2 * stride - 1];
    for (int i = len - 2 * stride - 1; i >= 0; i--) {
        i16 x1 = Xptr[0], x2 = Xptr[stride];
        Xptr[stride] = EXTRACT16(PSHR32(MAC16_16(MULT16_16(c, x2), s, x1), 15));
        *Xptr-- = EXTRACT16(PSHR32(MAC16_16(MULT16_16(c, x1), ms, x2), 15));
    }
}

static void exp_rotation(i16* X, int len, int dir, int stride, int K, int spread) {
    static const int SPREAD_FACTOR[3] = {15, 10, 5};
    if (2 * K >= len || spread == 0) return;
    int factor = SPREAD_FACTOR[spread - 1];
    i16 gain = (i16)celt_div(MULT16_16(32767, len), len + factor * K);
    i16 theta = (i16)(MULT16_16_Q15(gain, gain) >> 1);
    i16 c = celt_cos_norm(theta);
    i16 s = celt_cos_norm(32767 - theta);
    int stride2 = 0;
    if (len >= 8 * stride) {
        stride2 = 1;
        while ((stride2 * stride2 + stride2) * stride + (stride >> 2) < len) stride2++;
    }
    len = celt_udiv(len, stride);
    for (int i = 0; i < stride; i++) {
        if (dir < 0) {
            if (stride2) exp_rotation1(X + i * len, len, stride2, s, c);
            exp_rotation1(X + i * len, len, 1, c, s);
        } else {
            exp_rotation1(X + i * len, len, 1, c, (i16)-s);
            if (stride2) exp_rotation1(X + i * len, len, stride2, s, (i16)-c);
        }
    }
}

static void normalise_residual(const int* iy, i16* X, int N, i32 Ryy, i16 gain) {
    int k = celt_ilog2(Ryy) >> 1;
    i32 t = VSHR32(Ryy, 2 * (k - 7));
    i16 g = (i16)MULT16_16_P15(celt_rsqrt_norm(t), gain);
    for (int i = 0; i < N; i++)
        X[i] = EXTRACT16(PSHR32(MULT16_16(g, iy[i]), k + 1));
}

static u32 extract_collapse_mask(const int* iy, int N, int B) {
    if (B <= 1) return 1;
    int N0 = celt_udiv(N, B);
    u32 mask = 0;
    for (int i = 0; i < B; i++) {
        u32 tmp = 0;
        for (int j = 0; j < N0; j++) tmp |= (u32)iy[i * N0 + j];
        mask |= (u32)(tmp != 0) << i;
    }
    return mask;
}

static i32 celt_inner_prod(const i16* x, const i16* y, int N) {
    i32 xy = 0;
    for (int i = 0; i < N; i++) xy = MAC16_16(xy, x[i], y[i]);
    return xy;
}

static void renormalise_vector(i16* X, int N, i16 gain) {
    i32 E = 1 + celt_inner_prod(X, X, N);
    int k = celt_ilog2(E) >> 1;
    i32 t = VSHR32(E, 2 * (k - 7));
    i16 g = (i16)MULT16_16_P15(celt_rsqrt_norm(t), gain);
    for (int i = 0; i < N; i++)
        X[i] = EXTRACT16(PSHR32(MULT16_16(g, X[i]), k + 1));
}

static u32 alg_unquant(EcDec& ec, i16* X, int N, int K, int spread, int B, i16 gain) {
    int iy[208];
    i32 Ryy = cwrsi(N, K, ec.dec_uint(pvq_v(N, K)), iy);
    normalise_residual(iy, X, N, Ryy, gain);
    exp_rotation(X, N, -1, B, K, spread);
    return extract_collapse_mask(iy, N, B);
}

// ------------------------------------------------------------------ bands
struct BandCtx {
    EcDec* ec;
    int i, intensity, spread, tf_change;
    i32 remaining_bits;
    u32 seed;
    int disable_inv, avoid_split_noise;
};

static inline int bits2pulses(int band, int LM, int bits) {
    LM++;
    const unsigned char* cache = cache_bits50 + cache_index50[LM * NB_EBANDS + band];
    int lo = 0, hi = cache[0];
    bits--;
    for (int i = 0; i < LOG_MAX_PSEUDO; i++) {
        int mid = (lo + hi + 1) >> 1;
        if ((int)cache[mid] >= bits) hi = mid;
        else lo = mid;
    }
    if (bits - (lo == 0 ? -1 : (int)cache[lo]) <= (int)cache[hi] - bits) return lo;
    return hi;
}

static inline int pulses2bits(int band, int LM, int pulses) {
    LM++;
    const unsigned char* cache = cache_bits50 + cache_index50[LM * NB_EBANDS + band];
    return pulses == 0 ? 0 : cache[pulses] + 1;
}

static inline int get_pulses(int i) {
    return i < 8 ? i : (8 + (i & 7)) << ((i >> 3) - 1);
}

static int compute_qn(int N, int b, int offset, int pulse_cap, int stereo) {
    static const i16 exp2_table8[8] = {16384, 17866, 19483, 21247, 23170, 25267, 27554, 30048};
    int N2 = 2 * N - 1;
    if (stereo && N == 2) N2--;
    int qb = celt_sudiv(b + N2 * offset, N2);
    qb = std::min(b - pulse_cap - (4 << BITRES), qb);
    qb = std::min(8 << BITRES, qb);
    int qn;
    if (qb < (1 << BITRES >> 1)) qn = 1;
    else {
        qn = exp2_table8[qb & 0x7] >> (14 - (qb >> BITRES));
        qn = (qn + 1) >> 1 << 1;
    }
    return qn;
}

struct SplitCtx { int inv, imid, iside, delta, itheta, qalloc; };

static void compute_theta(BandCtx& ctx, SplitCtx& sctx, int N, int* b, int B,
                          int B0, int LM, int stereo, int* fill) {
    EcDec& ec = *ctx.ec;
    int i = ctx.i;
    int inv = 0, itheta = 0;
    int pulse_cap = logN400[i] + LM * (1 << BITRES);
    int offset = (pulse_cap >> 1) - (stereo && N == 2 ? QTHETA_OFFSET_TWOPHASE : QTHETA_OFFSET);
    int qn = compute_qn(N, *b, offset, pulse_cap, stereo);
    if (stereo && i >= ctx.intensity) qn = 1;
    int tell = ec.tell_frac();
    if (qn != 1) {
        if (stereo && N > 2) {
            int p0 = 3;
            int x0 = qn / 2;
            u32 ft = (u32)(p0 * (x0 + 1) + x0);
            u32 fs = ec.decode(ft);
            int x = fs < (u32)((x0 + 1) * p0) ? (int)(fs / p0)
                                              : x0 + 1 + (int)(fs - (x0 + 1) * p0);
            ec.update(x <= x0 ? p0 * x : (x - 1 - x0) + (x0 + 1) * p0,
                      x <= x0 ? p0 * (x + 1) : (x - x0) + (x0 + 1) * p0, ft);
            itheta = x;
        } else if (B0 > 1 || stereo) {
            itheta = ec.dec_uint(qn + 1);
        } else {
            int ft = ((qn >> 1) + 1) * ((qn >> 1) + 1);
            int fm = (int)ec.decode(ft);
            int fs, fl;
            if (fm < ((qn >> 1) * ((qn >> 1) + 1) >> 1)) {
                itheta = (int)((isqrt32(8 * (u32)fm + 1) - 1) >> 1);
                fs = itheta + 1;
                fl = itheta * (itheta + 1) >> 1;
            } else {
                itheta = (int)((2 * (qn + 1) - isqrt32(8 * (u32)(ft - fm - 1) + 1)) >> 1);
                fs = qn + 1 - itheta;
                fl = ft - ((qn + 1 - itheta) * (qn + 2 - itheta) >> 1);
            }
            ec.update(fl, fl + fs, ft);
        }
        itheta = celt_udiv((u32)itheta * 16384, qn);
    } else if (stereo) {
        if (*b > 2 << BITRES && ctx.remaining_bits > 2 << BITRES)
            inv = ec.bit_logp(2);
        if (ctx.disable_inv) inv = 0;
        itheta = 0;
    }
    int qalloc = ec.tell_frac() - tell;
    *b -= qalloc;
    int imid, iside, delta;
    if (itheta == 0) {
        imid = 32767; iside = 0;
        *fill &= (1 << B) - 1;
        delta = -16384;
    } else if (itheta == 16384) {
        imid = 0; iside = 32767;
        *fill &= ((1 << B) - 1) << B;
        delta = 16384;
    } else {
        imid = bitexact_cos((i16)itheta);
        iside = bitexact_cos((i16)(16384 - itheta));
        delta = FRAC_MUL16((N - 1) << 7, bitexact_log2tan(iside, imid));
    }
    sctx.inv = inv; sctx.imid = imid; sctx.iside = iside;
    sctx.delta = delta; sctx.itheta = itheta; sctx.qalloc = qalloc;
}

static void haar1(i16* X, int N0, int stride) {
    N0 >>= 1;
    for (int i = 0; i < stride; i++)
        for (int j = 0; j < N0; j++) {
            i32 tmp1 = MULT16_16(23170, X[stride * 2 * j + i]);
            i32 tmp2 = MULT16_16(23170, X[stride * (2 * j + 1) + i]);
            X[stride * 2 * j + i] = EXTRACT16(PSHR32(tmp1 + tmp2, 15));
            X[stride * (2 * j + 1) + i] = EXTRACT16(PSHR32(tmp1 - tmp2, 15));
        }
}

static void deinterleave_hadamard(i16* X, int N0, int stride, int hadamard) {
    i16 tmp[352];
    int N = N0 * stride;
    if (hadamard) {
        const int* ordery = (const int*)ordery_table + stride - 2;
        for (int i = 0; i < stride; i++)
            for (int j = 0; j < N0; j++)
                tmp[ordery[i] * N0 + j] = X[j * stride + i];
    } else {
        for (int i = 0; i < stride; i++)
            for (int j = 0; j < N0; j++)
                tmp[i * N0 + j] = X[j * stride + i];
    }
    memcpy(X, tmp, N * sizeof(i16));
}

static void interleave_hadamard(i16* X, int N0, int stride, int hadamard) {
    i16 tmp[352];
    int N = N0 * stride;
    if (hadamard) {
        const int* ordery = (const int*)ordery_table + stride - 2;
        for (int i = 0; i < stride; i++)
            for (int j = 0; j < N0; j++)
                tmp[j * stride + i] = X[ordery[i] * N0 + j];
    } else {
        for (int i = 0; i < stride; i++)
            for (int j = 0; j < N0; j++)
                tmp[j * stride + i] = X[i * N0 + j];
    }
    memcpy(X, tmp, N * sizeof(i16));
}

static void stereo_merge(i16* X, i16* Y, i16 mid, int N) {
    i32 xp = 0, side = 0;
    for (int j = 0; j < N; j++) {
        xp = MAC16_16(xp, Y[j], X[j]);
        side = MAC16_16(side, Y[j], Y[j]);
    }
    xp = MULT16_32_Q15(mid, xp);
    i16 mid2 = (i16)((i16)mid >> 1);
    i32 El = MULT16_16(mid2, mid2) + side - 2 * xp;
    i32 Er = MULT16_16(mid2, mid2) + side + 2 * xp;
    if (Er < 161061 || El < 161061) {
        memcpy(Y, X, N * sizeof(i16));
        return;
    }
    int kl = celt_ilog2(El) >> 1;
    int kr = celt_ilog2(Er) >> 1;
    i32 t = VSHR32(El, (kl - 7) << 1);
    i16 lgain = celt_rsqrt_norm(t);
    t = VSHR32(Er, (kr - 7) << 1);
    i16 rgain = celt_rsqrt_norm(t);
    if (kl < 7) kl = 7;
    if (kr < 7) kr = 7;
    for (int j = 0; j < N; j++) {
        i16 l = (i16)MULT16_16_P15(mid, X[j]);
        i16 r = Y[j];
        X[j] = EXTRACT16(PSHR32(MULT16_16(lgain, SUB16(l, r)), kl + 1));
        Y[j] = EXTRACT16(PSHR32(MULT16_16(rgain, ADD16(l, r)), kr + 1));
    }
}

static const unsigned char BIT_INTERLEAVE[16] = {0, 1, 1, 1, 2, 3, 3, 3, 2, 3, 3, 3, 2, 3, 3, 3};
static const unsigned char BIT_DEINTERLEAVE[16] = {0x00, 0x03, 0x0C, 0x0F, 0x30, 0x33, 0x3C, 0x3F,
                                                   0xC0, 0xC3, 0xCC, 0xCF, 0xF0, 0xF3, 0xFC, 0xFF};

static u32 quant_band(BandCtx& ctx, i16* X, int N, int b, int B, i16* lowband,
                      int LM, i16* lowband_out, i16 gain, i16* lowband_scratch, int fill);

static u32 quant_band_n1(BandCtx& ctx, i16* X, i16* Y, int b, i16* lowband_out) {
    i16* x = X;
    int stereo = Y != nullptr;
    int c = 0;
    do {
        int sign = 0;
        if (ctx.remaining_bits >= 1 << BITRES) {
            sign = ctx.ec->dec_bits(1);
            ctx.remaining_bits -= 1 << BITRES;
            b -= 1 << BITRES;
        }
        x[0] = sign ? -NORM_SCALING : NORM_SCALING;
        x = Y;
    } while (++c < 1 + stereo);
    if (lowband_out) lowband_out[0] = (i16)((i16)X[0] >> 4);
    (void)b;
    return 1;
}

static u32 quant_partition(BandCtx& ctx, i16* X, int N, int b, int B,
                           i16* lowband, int LM, i16 gain, int fill) {
    int i = ctx.i;
    int spread = ctx.spread;
    int B0 = B;
    u32 cm = 0;
    const unsigned char* cache = cache_bits50 + cache_index50[(LM + 1) * NB_EBANDS + i];
    if (LM != -1 && b > (int)cache[cache[0]] + 12 && N > 2) {
        N >>= 1;
        i16* Y = X + N;
        LM -= 1;
        if (B == 1) fill = (fill & 1) | (fill << 1);
        B = (B + 1) >> 1;
        SplitCtx sctx;
        compute_theta(ctx, sctx, N, &b, B, B0, LM, 0, &fill);
        int imid = sctx.imid, iside = sctx.iside;
        int delta = sctx.delta, itheta = sctx.itheta, qalloc = sctx.qalloc;
        i16 mid = (i16)imid, side = (i16)iside;
        if (B0 > 1 && (itheta & 0x3fff)) {
            if (itheta > 8192) delta -= delta >> (4 - LM);
            else delta = std::min(0, delta + (N << BITRES >> (5 - LM)));
        }
        int mbits = std::max(0, std::min(b, (b - delta) / 2));
        int sbits = b - mbits;
        ctx.remaining_bits -= qalloc;
        i16* next_lowband2 = lowband ? lowband + N : nullptr;
        i32 rebalance = ctx.remaining_bits;
        if (mbits >= sbits) {
            cm = quant_partition(ctx, X, N, mbits, B, lowband, LM,
                                 (i16)MULT16_16_P15(gain, mid), fill);
            rebalance = mbits - (rebalance - ctx.remaining_bits);
            if (rebalance > 3 << BITRES && itheta != 0)
                sbits += rebalance - (3 << BITRES);
            cm |= quant_partition(ctx, Y, N, sbits, B, next_lowband2, LM,
                                  (i16)MULT16_16_P15(gain, side), fill >> B) << (B0 >> 1);
        } else {
            cm = quant_partition(ctx, Y, N, sbits, B, next_lowband2, LM,
                                 (i16)MULT16_16_P15(gain, side), fill >> B) << (B0 >> 1);
            rebalance = sbits - (rebalance - ctx.remaining_bits);
            if (rebalance > 3 << BITRES && itheta != 16384)
                mbits += rebalance - (3 << BITRES);
            cm |= quant_partition(ctx, X, N, mbits, B, lowband, LM,
                                  (i16)MULT16_16_P15(gain, mid), fill);
        }
    } else {
        int q = bits2pulses(i, LM, b);
        int curr_bits = pulses2bits(i, LM, q);
        ctx.remaining_bits -= curr_bits;
        while (ctx.remaining_bits < 0 && q > 0) {
            ctx.remaining_bits += curr_bits;
            q--;
            curr_bits = pulses2bits(i, LM, q);
            ctx.remaining_bits -= curr_bits;
        }
        if (q != 0) {
            int K = get_pulses(q);
            cm = alg_unquant(*ctx.ec, X, N, K, spread, B, gain);
        } else {
            u32 cm_mask = (1u << B) - 1;
            fill &= cm_mask;
            if (!fill) {
                memset(X, 0, N * sizeof(i16));
            } else {
                if (lowband == nullptr) {
                    for (int j = 0; j < N; j++) {
                        ctx.seed = celt_lcg_rand(ctx.seed);
                        X[j] = (i16)((i32)ctx.seed >> 20);
                    }
                    cm = cm_mask;
                } else {
                    for (int j = 0; j < N; j++) {
                        ctx.seed = celt_lcg_rand(ctx.seed);
                        i16 tmp = (ctx.seed & 0x8000) ? 4 : -4;
                        X[j] = (i16)(lowband[j] + tmp);
                    }
                    cm = (u32)fill;
                }
                renormalise_vector(X, N, gain);
            }
        }
    }
    return cm;
}

static u32 quant_band(BandCtx& ctx, i16* X, int N, int b, int B, i16* lowband,
                      int LM, i16* lowband_out, i16 gain, i16* lowband_scratch,
                      int fill) {
    int N0 = N;
    int N_B = N;
    int B0 = B;
    int time_divide = 0, recombine = 0;
    int longBlocks = B0 == 1;
    int tf_change = ctx.tf_change;
    u32 cm;

    N_B = celt_udiv(N_B, B);
    if (N == 1) return quant_band_n1(ctx, X, nullptr, b, lowband_out);
    if (tf_change > 0) recombine = tf_change;
    if (lowband_scratch && lowband &&
        (recombine || ((N_B & 1) == 0 && tf_change < 0) || B0 > 1)) {
        memcpy(lowband_scratch, lowband, N * sizeof(i16));
        lowband = lowband_scratch;
    }
    for (int k = 0; k < recombine; k++) {
        if (lowband) haar1(lowband, N >> k, 1 << k);
        fill = BIT_INTERLEAVE[fill & 0xF] | BIT_INTERLEAVE[fill >> 4] << 2;
    }
    B >>= recombine;
    N_B <<= recombine;
    while ((N_B & 1) == 0 && tf_change < 0) {
        if (lowband) haar1(lowband, N_B, B);
        fill |= fill << B;
        B <<= 1;
        N_B >>= 1;
        time_divide++;
        tf_change++;
    }
    B0 = B;
    int N_B0 = N_B;
    if (B0 > 1 && lowband)
        deinterleave_hadamard(lowband, N_B >> recombine, B0 << recombine, longBlocks);

    cm = quant_partition(ctx, X, N, b, B, lowband, LM, gain, fill);

    if (B0 > 1)
        interleave_hadamard(X, N_B >> recombine, B0 << recombine, longBlocks);
    N_B = N_B0;
    B = B0;
    for (int k = 0; k < time_divide; k++) {
        B >>= 1;
        N_B <<= 1;
        cm |= cm >> B;
        haar1(X, N_B, B);
    }
    for (int k = 0; k < recombine; k++) {
        cm = BIT_DEINTERLEAVE[cm];
        haar1(X, N0 >> k, 1 << k);
    }
    B <<= recombine;
    if (lowband_out) {
        i16 n = (i16)celt_sqrt(SHL32(N0, 22));
        for (int j = 0; j < N0; j++)
            lowband_out[j] = (i16)MULT16_16_Q15(n, X[j]);
    }
    cm &= (1u << B) - 1;
    return cm;
}

static u32 quant_band_stereo(BandCtx& ctx, i16* X, i16* Y, int N, int b, int B,
                             i16* lowband, int LM, i16* lowband_out,
                             i16* lowband_scratch, int fill) {
    u32 cm = 0;
    if (N == 1) return quant_band_n1(ctx, X, Y, b, lowband_out);
    int orig_fill = fill;
    SplitCtx sctx;
    compute_theta(ctx, sctx, N, &b, B, B, LM, 1, &fill);
    int inv = sctx.inv, imid = sctx.imid, iside = sctx.iside;
    int delta = sctx.delta, itheta = sctx.itheta, qalloc = sctx.qalloc;
    i16 mid = (i16)imid, side = (i16)iside;
    if (N == 2) {
        int mbits = b, sbits = 0;
        if (itheta != 0 && itheta != 16384) sbits = 1 << BITRES;
        mbits -= sbits;
        int c = itheta > 8192;
        ctx.remaining_bits -= qalloc + sbits;
        i16* x2 = c ? Y : X;
        i16* y2 = c ? X : Y;
        int sign = 0;
        if (sbits) sign = ctx.ec->dec_bits(1);
        sign = 1 - 2 * sign;
        cm = quant_band(ctx, x2, N, mbits, B, lowband, LM, lowband_out, 32767,
                        lowband_scratch, orig_fill);
        y2[0] = (i16)(-sign * x2[1]);
        y2[1] = (i16)(sign * x2[0]);
        X[0] = (i16)MULT16_16_Q15(mid, X[0]);
        X[1] = (i16)MULT16_16_Q15(mid, X[1]);
        Y[0] = (i16)MULT16_16_Q15(side, Y[0]);
        Y[1] = (i16)MULT16_16_Q15(side, Y[1]);
        i16 tmp = X[0];
        X[0] = SUB16(tmp, Y[0]);
        Y[0] = ADD16(tmp, Y[0]);
        tmp = X[1];
        X[1] = SUB16(tmp, Y[1]);
        Y[1] = ADD16(tmp, Y[1]);
    } else {
        int mbits = std::max(0, std::min(b, (b - delta) / 2));
        int sbits = b - mbits;
        ctx.remaining_bits -= qalloc;
        i32 rebalance = ctx.remaining_bits;
        if (mbits >= sbits) {
            cm = quant_band(ctx, X, N, mbits, B, lowband, LM, lowband_out,
                            32767, lowband_scratch, fill);
            rebalance = mbits - (rebalance - ctx.remaining_bits);
            if (rebalance > 3 << BITRES && itheta != 0)
                sbits += rebalance - (3 << BITRES);
            cm |= quant_band(ctx, Y, N, sbits, B, nullptr, LM, nullptr, side,
                             nullptr, fill >> B);
        } else {
            cm = quant_band(ctx, Y, N, sbits, B, nullptr, LM, nullptr, side,
                            nullptr, fill >> B);
            rebalance = sbits - (rebalance - ctx.remaining_bits);
            if (rebalance > 3 << BITRES && itheta != 16384)
                mbits += rebalance - (3 << BITRES);
            cm |= quant_band(ctx, X, N, mbits, B, lowband, LM, lowband_out,
                             32767, lowband_scratch, fill);
        }
    }
    if (N != 2) stereo_merge(X, Y, mid, N);
    if (inv) {
        for (int j = 0; j < N; j++) Y[j] = (i16)-Y[j];
    }
    return cm;
}

// --------------------------------------------------------- energy + alloc
static void unquant_coarse_energy(EcDec& ec, int start, int end, i16* oldEBands,
                                  int intra, int C, int LM) {
    const unsigned char* prob = e_prob_model + (LM * 2 + intra) * 42;
    i32 coef, beta;
    if (intra) { coef = 0; beta = BETA_INTRA; }
    else { beta = beta_coef[LM]; coef = pred_coef[LM]; }
    int budget = (int)ec.storage * 8;
    i32 prev[2] = {0, 0};
    for (int i = start; i < end; i++) {
        for (int c = 0; c < C; c++) {
            int tell = ec.tell();
            int qi;
            if (budget - tell >= 15) {
                int pi = 2 * std::min(i, 20);
                qi = laplace_decode(ec, (u32)prob[pi] << 7, (i32)prob[pi + 1] << 6);
            } else if (budget - tell >= 2) {
                qi = ec.icdf(small_energy_icdf, 2);
                qi = (qi >> 1) ^ -(qi & 1);
            } else if (budget - tell >= 1) {
                qi = -ec.bit_logp(1);
            } else qi = -1;
            i32 q = SHL32(qi, DB_SHIFT);
            i32 old = std::max(-(9 << DB_SHIFT), (i32)oldEBands[i + c * NB_EBANDS]);
            i32 tmp = PSHR32(MULT16_16(coef, old), 8) + prev[c] + SHL32(q, 7);
            tmp = std::max(-(28 << (DB_SHIFT + 7)), tmp);
            oldEBands[i + c * NB_EBANDS] = (i16)PSHR32(tmp, 7);
            prev[c] = prev[c] + SHL32(q, 7) - MULT16_16(beta, PSHR32(q, 8));
        }
    }
}

static void unquant_fine_energy(EcDec& ec, int start, int end, i16* oldEBands,
                                const int* fine_quant, int C) {
    for (int i = start; i < end; i++) {
        if (fine_quant[i] <= 0) continue;
        for (int c = 0; c < C; c++) {
            int q2 = (int)ec.dec_bits(fine_quant[i]);
            i16 offset = SUB16(SHR32(SHL32(q2, DB_SHIFT) + 512, fine_quant[i]), 512);
            oldEBands[i + c * NB_EBANDS] += offset;
        }
    }
}

static void unquant_energy_finalise(EcDec& ec, int start, int end, i16* oldEBands,
                                    const int* fine_quant, const int* fine_priority,
                                    int bits_left, int C) {
    for (int prio = 0; prio < 2; prio++) {
        for (int i = start; i < end && bits_left >= C; i++) {
            if (fine_quant[i] >= MAX_FINE_BITS || fine_priority[i] != prio) continue;
            for (int c = 0; c < C; c++) {
                int q2 = (int)ec.dec_bits(1);
                i16 offset = (i16)((SHL16(q2, DB_SHIFT) - 512) >> (fine_quant[i] + 1));
                oldEBands[i + c * NB_EBANDS] += offset;
                bits_left--;
            }
        }
    }
}

static void tf_decode(EcDec& ec, int start, int end, int isTransient,
                      int* tf_res, int LM) {
    u32 budget = ec.storage * 8;
    u32 tell = ec.tell();
    int logp = isTransient ? 2 : 4;
    int tf_select_rsv = LM > 0 && tell + logp + 1 <= budget;
    budget -= tf_select_rsv;
    int tf_changed = 0, curr = 0;
    for (int i = start; i < end; i++) {
        if (tell + logp <= budget) {
            curr ^= ec.bit_logp(logp);
            tell = ec.tell();
            tf_changed |= curr;
        }
        tf_res[i] = curr;
        logp = isTransient ? 4 : 5;
    }
    int tf_select = 0;
    const signed char* tst = (const signed char*)tf_select_table;
    if (tf_select_rsv &&
        tst[LM * 8 + 4 * isTransient + 0 + tf_changed] !=
        tst[LM * 8 + 4 * isTransient + 2 + tf_changed])
        tf_select = ec.bit_logp(1);
    for (int i = start; i < end; i++)
        tf_res[i] = tst[LM * 8 + 4 * isTransient + 2 * tf_select + tf_res[i]];
}

static int interp_bits2pulses(EcDec& ec, int start, int end, int skip_start,
                              const int* bits1, const int* bits2, const int* thresh,
                              const int* cap, int total, i32* balance_out, int skip_rsv,
                              int* intensity, int intensity_rsv, int* dual_stereo,
                              int dual_stereo_rsv, int* bits, int* ebits,
                              int* fine_priority, int C, int LM) {
    int alloc_floor = C << BITRES;
    int stereo = C > 1;
    int logM = LM << BITRES;
    int lo = 0, hi = 1 << ALLOC_STEPS;
    for (int it = 0; it < ALLOC_STEPS; it++) {
        int mid = (lo + hi) >> 1;
        i32 psum = 0;
        int done = 0;
        for (int j = end; j-- > start;) {
            int tmp = bits1[j] + (mid * bits2[j] >> ALLOC_STEPS);
            if (tmp >= thresh[j] || done) {
                done = 1;
                psum += std::min(tmp, cap[j]);
            } else if (tmp >= alloc_floor) psum += alloc_floor;
        }
        if (psum > total) hi = mid;
        else lo = mid;
    }
    i32 psum = 0;
    int done = 0;
    for (int j = end; j-- > start;) {
        int tmp = bits1[j] + (lo * bits2[j] >> ALLOC_STEPS);
        if (tmp < thresh[j] && !done) {
            tmp = tmp >= alloc_floor ? alloc_floor : 0;
        } else done = 1;
        tmp = std::min(tmp, cap[j]);
        bits[j] = tmp;
        psum += tmp;
    }
    int codedBands;
    for (codedBands = end;; codedBands--) {
        int j = codedBands - 1;
        if (j <= skip_start) {
            total += skip_rsv;
            break;
        }
        i32 left = total - psum;
        int percoeff = celt_udiv(left, eband5ms[codedBands] - eband5ms[start]);
        left -= (eband5ms[codedBands] - eband5ms[start]) * percoeff;
        i32 rem = std::max(left - (eband5ms[j] - eband5ms[start]), 0);
        int band_width = eband5ms[codedBands] - eband5ms[j];
        i32 band_bits = bits[j] + percoeff * band_width + rem;
        if (band_bits >= std::max(thresh[j], alloc_floor + (1 << BITRES))) {
            if (ec.bit_logp(1)) break;
            psum += 1 << BITRES;
            band_bits -= 1 << BITRES;
        }
        psum -= bits[j] + intensity_rsv;
        if (intensity_rsv > 0) intensity_rsv = LOG2_FRAC_TABLE[j - start];
        psum += intensity_rsv;
        if (band_bits >= alloc_floor) {
            psum += alloc_floor;
            bits[j] = alloc_floor;
        } else bits[j] = 0;
    }
    if (intensity_rsv > 0)
        *intensity = start + (int)ec.dec_uint(codedBands + 1 - start);
    else *intensity = 0;
    if (*intensity <= start) {
        total += dual_stereo_rsv;
        dual_stereo_rsv = 0;
    }
    if (dual_stereo_rsv > 0) *dual_stereo = ec.bit_logp(1);
    else *dual_stereo = 0;

    i32 left = total - psum;
    int percoeff = celt_udiv(left, eband5ms[codedBands] - eband5ms[start]);
    left -= (eband5ms[codedBands] - eband5ms[start]) * percoeff;
    for (int j = start; j < codedBands; j++)
        bits[j] += percoeff * (eband5ms[j + 1] - eband5ms[j]);
    for (int j = start; j < codedBands; j++) {
        int tmp = std::min(left, (i32)(eband5ms[j + 1] - eband5ms[j]));
        bits[j] += tmp;
        left -= tmp;
    }
    i32 balance = 0;
    int j;
    for (j = start; j < codedBands; j++) {
        int N0 = eband5ms[j + 1] - eband5ms[j];
        int N = N0 << LM;
        i32 bit = bits[j] + balance;
        i32 excess = 0;
        if (N > 1) {
            excess = std::max(bit - cap[j], (i32)0);
            bits[j] = bit - excess;
            int den = C * N + ((C == 2 && N > 2 && !*dual_stereo && j < *intensity) ? 1 : 0);
            int NClogN = den * (logN400[j] + logM);
            int offset = (NClogN >> 1) - den * FINE_OFFSET;
            if (N == 2) offset += den << BITRES >> 2;
            if (bits[j] + offset < den * 2 << BITRES) offset += NClogN >> 2;
            else if (bits[j] + offset < den * 3 << BITRES) offset += NClogN >> 3;
            ebits[j] = std::max(0, bits[j] + offset + (den << (BITRES - 1)));
            ebits[j] = celt_udiv(ebits[j], den) >> BITRES;
            if (C * ebits[j] > (bits[j] >> BITRES)) ebits[j] = bits[j] >> stereo >> BITRES;
            ebits[j] = std::min(ebits[j], MAX_FINE_BITS);
            fine_priority[j] = ebits[j] * (den << BITRES) >= bits[j] + offset;
            bits[j] -= C * ebits[j] << BITRES;
        } else {
            excess = std::max((i32)0, bit - (C << BITRES));
            bits[j] = bit - excess;
            ebits[j] = 0;
            fine_priority[j] = 1;
        }
        if (excess > 0) {
            int extra_fine = std::min(excess >> (stereo + BITRES),
                                      (i32)(MAX_FINE_BITS - ebits[j]));
            ebits[j] += extra_fine;
            i32 extra_bits = (i32)extra_fine * C << BITRES;
            fine_priority[j] = extra_bits >= excess - balance;
            excess -= extra_bits;
        }
        balance = excess;
    }
    *balance_out = balance;
    for (; j < end; j++) {
        ebits[j] = bits[j] >> stereo >> BITRES;
        bits[j] = 0;
        fine_priority[j] = ebits[j] < 1;
    }
    return codedBands;
}

static int clt_compute_allocation(EcDec& ec, int start, int end, const int* offsets,
                                  const int* cap, int alloc_trim, int* intensity,
                                  int* dual_stereo, i32 total, i32* balance, int* pulses,
                                  int* ebits, int* fine_priority, int C, int LM) {
    total = std::max(total, (i32)0);
    int skip_start = start;
    int skip_rsv = total >= 1 << BITRES ? 1 << BITRES : 0;
    total -= skip_rsv;
    int intensity_rsv = 0, dual_stereo_rsv = 0;
    if (C == 2) {
        intensity_rsv = LOG2_FRAC_TABLE[end - start];
        if (intensity_rsv > total) intensity_rsv = 0;
        else {
            total -= intensity_rsv;
            dual_stereo_rsv = total >= 1 << BITRES ? 1 << BITRES : 0;
            total -= dual_stereo_rsv;
        }
    }
    int thresh[NB_EBANDS], trim_offset[NB_EBANDS];
    int bits1[NB_EBANDS], bits2[NB_EBANDS];
    for (int j = start; j < end; j++) {
        thresh[j] = std::max(C << BITRES,
                             (3 * (eband5ms[j + 1] - eband5ms[j]) << LM << BITRES) >> 4);
        trim_offset[j] = C * (eband5ms[j + 1] - eband5ms[j]) * (alloc_trim - 5 - LM) *
                         (end - j - 1) * (1 << (LM + BITRES)) >> 6;
        if ((eband5ms[j + 1] - eband5ms[j]) << LM == 1)
            trim_offset[j] -= C << BITRES;
    }
    int lo = 1, hi = 11 - 1;
    do {
        int done = 0;
        i32 psum = 0;
        int mid = (lo + hi) >> 1;
        for (int j = end; j-- > start;) {
            int N = eband5ms[j + 1] - eband5ms[j];
            i32 bitsj = (i32)C * N * band_allocation[mid * NB_EBANDS + j] << LM >> 2;
            if (bitsj > 0) bitsj = std::max((i32)0, bitsj + trim_offset[j]);
            bitsj += offsets[j];
            if (bitsj >= thresh[j] || done) {
                done = 1;
                psum += std::min(bitsj, (i32)cap[j]);
            } else if (bitsj >= C << BITRES) psum += C << BITRES;
        }
        if (psum > total) hi = mid - 1;
        else lo = mid + 1;
    } while (lo <= hi);
    hi = lo--;
    for (int j = start; j < end; j++) {
        int N = eband5ms[j + 1] - eband5ms[j];
        i32 bits1j = (i32)C * N * band_allocation[lo * NB_EBANDS + j] << LM >> 2;
        i32 bits2j = hi >= 11 ? cap[j]
                              : (i32)C * N * band_allocation[hi * NB_EBANDS + j] << LM >> 2;
        if (bits1j > 0) bits1j = std::max((i32)0, bits1j + trim_offset[j]);
        if (bits2j > 0) bits2j = std::max((i32)0, bits2j + trim_offset[j]);
        if (lo > 0) bits1j += offsets[j];
        bits2j += offsets[j];
        if (offsets[j] > 0) skip_start = j;
        bits2j = std::max((i32)0, bits2j - bits1j);
        bits1[j] = bits1j;
        bits2[j] = bits2j;
    }
    return interp_bits2pulses(ec, start, end, skip_start, bits1, bits2, thresh, cap,
                              total, balance, skip_rsv, intensity, intensity_rsv,
                              dual_stereo, dual_stereo_rsv, pulses, ebits,
                              fine_priority, C, LM);
}

static void special_hybrid_folding(i16* norm, i16* norm2, int start, int M,
                                   int dual_stereo) {
    int n1 = M * (eband5ms[start + 1] - eband5ms[start]);
    int n2 = M * (eband5ms[start + 2] - eband5ms[start + 1]);
    memcpy(&norm[n1], &norm[2 * n1 - n2], (n2 - n1) * sizeof(i16));
    if (dual_stereo)
        memcpy(&norm2[n1], &norm2[2 * n1 - n2], (n2 - n1) * sizeof(i16));
}

static void quant_all_bands(EcDec& ec, int start, int end, i16* X_, i16* Y_,
                            unsigned char* collapse_masks, const int* pulses,
                            int shortBlocks, int spread, int dual_stereo,
                            int intensity, const int* tf_res, i32 total_bits,
                            i32 balance, int LM, int codedBands, u32* seed,
                            int disable_inv) {
    int C = Y_ ? 2 : 1;
    int M = 1 << LM;
    int B = shortBlocks ? M : 1;
    int norm_offset = M * eband5ms[start];
    i16 norm_buf[2 * (8 * 78)];
    i16* norm = norm_buf;
    i16* norm2 = norm + M * eband5ms[NB_EBANDS - 1] - norm_offset;
    i16* lowband_scratch = X_ + M * eband5ms[NB_EBANDS - 1];
    int lowband_offset = 0;
    int update_lowband = 1;
    BandCtx ctx;
    ctx.ec = &ec;
    ctx.intensity = intensity;
    ctx.spread = spread;
    ctx.seed = *seed;
    ctx.disable_inv = disable_inv;
    ctx.avoid_split_noise = B > 1;
    for (int i = start; i < end; i++) {
        ctx.i = i;
        int last = i == end - 1;
        i16* X = X_ + M * eband5ms[i];
        i16* Y = Y_ ? Y_ + M * eband5ms[i] : nullptr;
        int N = M * eband5ms[i + 1] - M * eband5ms[i];
        i32 tell = ec.tell_frac();
        if (i != start) balance -= tell;
        i32 remaining_bits = total_bits - tell - 1;
        ctx.remaining_bits = remaining_bits;
        i32 b;
        if (i <= codedBands - 1) {
            i32 curr_balance = celt_sudiv(balance, std::min(3, codedBands - i));
            b = std::max((i32)0, std::min((i32)16383,
                std::min(remaining_bits + 1, (i32)pulses[i] + curr_balance)));
        } else b = 0;
        if ((M * eband5ms[i] - N >= M * eband5ms[start] || i == start + 1) &&
            (update_lowband || lowband_offset == 0))
            lowband_offset = i;
        if (i == start + 1)
            special_hybrid_folding(norm, norm2, start, M, dual_stereo);
        ctx.tf_change = tf_res[i];
        i16* cur_scratch = last ? nullptr : lowband_scratch;
        int effective_lowband = -1;
        u32 x_cm, y_cm;
        if (lowband_offset != 0 &&
            (spread != SPREAD_AGGRESSIVE || B > 1 || ctx.tf_change < 0)) {
            effective_lowband = std::max(0, M * eband5ms[lowband_offset] - norm_offset - N);
            int fold_start = lowband_offset;
            while (M * eband5ms[--fold_start] > effective_lowband + norm_offset);
            int fold_end = lowband_offset - 1;
            while (++fold_end < i &&
                   M * eband5ms[fold_end] < effective_lowband + norm_offset + N);
            x_cm = y_cm = 0;
            int fold_i = fold_start;
            do {
                x_cm |= collapse_masks[fold_i * C + 0];
                y_cm |= collapse_masks[fold_i * C + C - 1];
            } while (++fold_i < fold_end);
        } else {
            x_cm = y_cm = (1u << B) - 1;
        }
        if (dual_stereo && i == intensity) {
            dual_stereo = 0;
            for (int j = 0; j < M * eband5ms[i] - norm_offset; j++)
                norm[j] = (i16)(((i32)norm[j] + norm2[j]) >> 1);
        }
        if (dual_stereo) {
            x_cm = quant_band(ctx, X, N, b / 2, B,
                              effective_lowband != -1 ? norm + effective_lowband : nullptr,
                              LM, last ? nullptr : norm + M * eband5ms[i] - norm_offset,
                              32767, cur_scratch, x_cm);
            y_cm = quant_band(ctx, Y, N, b / 2, B,
                              effective_lowband != -1 ? norm2 + effective_lowband : nullptr,
                              LM, last ? nullptr : norm2 + M * eband5ms[i] - norm_offset,
                              32767, cur_scratch, y_cm);
        } else {
            if (Y) {
                x_cm = quant_band_stereo(ctx, X, Y, N, b, B,
                                         effective_lowband != -1 ? norm + effective_lowband : nullptr,
                                         LM, last ? nullptr : norm + M * eband5ms[i] - norm_offset,
                                         cur_scratch, x_cm | y_cm);
            } else {
                x_cm = quant_band(ctx, X, N, b, B,
                                  effective_lowband != -1 ? norm + effective_lowband : nullptr,
                                  LM, last ? nullptr : norm + M * eband5ms[i] - norm_offset,
                                  32767, cur_scratch, x_cm | y_cm);
            }
            y_cm = x_cm;
        }
        collapse_masks[i * C + 0] = (unsigned char)x_cm;
        collapse_masks[i * C + C - 1] = (unsigned char)y_cm;
        balance += pulses[i] + tell;
        update_lowband = b > (N << BITRES);
        ctx.avoid_split_noise = 0;
    }
    *seed = ctx.seed;
}

static void anti_collapse(i16* X_, const unsigned char* collapse_masks, int LM, int C,
                          int size, int start, int end, const i16* logE,
                          const i16* prev1logE, const i16* prev2logE,
                          const int* pulses, u32 seed) {
    for (int i = start; i < end; i++) {
        int N0 = eband5ms[i + 1] - eband5ms[i];
        int depth = celt_udiv(1 + pulses[i], eband5ms[i + 1] - eband5ms[i]) >> LM;
        i32 thresh32 = SHR32(celt_exp2((i16)(-SHL16(depth, 10 - BITRES))), 1);
        i32 thresh = MULT16_32_Q15(16384, std::min((i32)32767, thresh32));
        int t = N0 << LM;
        int shift = celt_ilog2(t) >> 1;
        t = SHL32(t, (7 - shift) << 1);
        i16 sqrt_1 = celt_rsqrt_norm(t);
        for (int c = 0; c < C; c++) {
            i16 prev1 = prev1logE[c * NB_EBANDS + i];
            i16 prev2 = prev2logE[c * NB_EBANDS + i];
            if (C == 1) {
                prev1 = std::max(prev1, prev1logE[NB_EBANDS + i]);
                prev2 = std::max(prev2, prev2logE[NB_EBANDS + i]);
            }
            i32 Ediff = (i32)logE[c * NB_EBANDS + i] - std::min(prev1, prev2);
            Ediff = std::max((i32)0, Ediff);
            i16 r;
            if (Ediff < 16384) {
                i32 r32 = SHR32(celt_exp2((i16)-Ediff), 1);
                r = (i16)(2 * std::min((i32)16383, r32));
            } else r = 0;
            if (LM == 3) r = (i16)((MULT16_16(23170, std::min((i32)23169, (i32)r))) >> 14);
            r = (i16)((i16)std::min(thresh, (i32)r) >> 1);
            r = (i16)(MULT16_16_Q15(sqrt_1, r) >> shift);
            i16* X = X_ + c * size + (eband5ms[i] << LM);
            int renorm = 0;
            for (int k = 0; k < 1 << LM; k++) {
                if (!(collapse_masks[i * C + c] & (1 << k))) {
                    for (int j = 0; j < N0; j++) {
                        seed = celt_lcg_rand(seed);
                        X[(j << LM) + k] = (seed & 0x8000) ? r : (i16)-r;
                    }
                    renorm = 1;
                }
            }
            if (renorm) renormalise_vector(X, N0 << LM, 32767);
        }
    }
}

}  // namespace

// ------------------------------------------------------------------ ABI
extern "C" {

struct CeltHostState {
    i16 oldBandE[2 * NB_EBANDS];
    i16 oldLogE[2 * NB_EBANDS];
    i16 oldLogE2[2 * NB_EBANDS];
    i16 backgroundLogE[2 * NB_EBANDS];
    u32 rng;
    i32 pf_period, pf_period_old, pf_gain, pf_gain_old, pf_tapset, pf_tapset_old;
    i32 loss_count, error;
};

// Symbol phase of celt_decode_with_ec (reference src/celt.cpp:2162): runs
// everything up to and including anti-collapse and the energy/postfilter
// bookkeeping; outputs X, bandE and comb-filter params for the device.
// out_params layout: [silence, isTransient, LM,
//                     comb1: T0,T1,g0,g1,t0,t1, comb2: T0,T1,g0,g1,t0,t1,
//                     end_effective, tell, rng]
int celt_host_decode_impl(const unsigned char* data, int len,
                          int frame_size, int CC, int C, int start, int end,
                          int disable_inv, CeltHostState* st, i16* X_out,
                          i16* bandE_out, i32* out_params,
                          const i32* ec_in) {
    EcDec ec;
    ec.init(data, (u32)len);
    if (ec_in) {
        // resume a range decoder mid-packet (hybrid: SILK symbols already
        // consumed on the host) — state layout matches RangeDecoder fields
        ec.offs = (u32)ec_in[0];
        ec.end_offs = (u32)ec_in[1];
        ec.end_window = (u32)ec_in[2];
        ec.nend_bits = ec_in[3];
        ec.nbits_total = ec_in[4];
        ec.val = (u32)ec_in[5];
        ec.rng = (u32)ec_in[6];
        ec.rem = ec_in[7];
        ec.error = ec_in[8];
    }

    int LM = 0;
    while (LM <= 3) {
        if (SHORT_MDCT << LM == frame_size) break;
        LM++;
    }
    if (LM > 3) return -1;
    int M = 1 << LM;
    if ((u32)len > 1275 || len <= 1) return -1;
    int N = M * SHORT_MDCT;
    int effEnd = std::min(end, NB_EBANDS);

    i16* oldBandE = st->oldBandE;
    i16* oldLogE = st->oldLogE;
    i16* oldLogE2 = st->oldLogE2;
    i16* backgroundLogE = st->backgroundLogE;

    if (C == 1) {
        for (int i = 0; i < NB_EBANDS; i++)
            oldBandE[i] = std::max(oldBandE[i], oldBandE[NB_EBANDS + i]);
    }
    i32 total_bits = len * 8;
    int tell = ec.tell();
    int silence;
    if (tell >= total_bits) silence = 1;
    else if (tell == 1) silence = ec.bit_logp(15);
    else silence = 0;
    if (silence) {
        tell = len * 8;
        ec.nbits_total += tell - ec.tell();
    }
    int pf_pitch = 0, pf_gain = 0, pf_tapset = 0;
    if (start == 0 && tell + 16 <= total_bits) {
        if (ec.bit_logp(1)) {
            int octave = (int)ec.dec_uint(6);
            pf_pitch = (16 << octave) + (int)ec.dec_bits(4 + octave) - 1;
            int qg = (int)ec.dec_bits(3);
            if (ec.tell() + 2 <= total_bits) {
                static const unsigned char tapset_icdf_[3] = {2, 1, 0};
                pf_tapset = ec.icdf(tapset_icdf_, 2);
            }
            pf_gain = 3072 * (qg + 1);
        }
        tell = ec.tell();
    }
    int isTransient = 0;
    if (LM > 0 && tell + 3 <= total_bits) {
        isTransient = ec.bit_logp(3);
        tell = ec.tell();
    }
    int shortBlocks = isTransient ? M : 0;
    int intra_ener = tell + 3 <= total_bits ? ec.bit_logp(3) : 0;
    unquant_coarse_energy(ec, start, end, oldBandE, intra_ener, C, LM);
    int tf_res[NB_EBANDS];
    tf_decode(ec, start, end, isTransient, tf_res, LM);
    tell = ec.tell();
    int spread_decision = SPREAD_NORMAL;
    if (tell + 4 <= total_bits) {
        static const unsigned char spread_icdf_[4] = {25, 23, 2, 0};
        spread_decision = ec.icdf(spread_icdf_, 5);
    }
    int cap[NB_EBANDS];
    for (int i = 0; i < NB_EBANDS; i++) {
        int Nb = (eband5ms[i + 1] - eband5ms[i]) << LM;
        cap[i] = (cache_caps50[NB_EBANDS * (2 * LM + C - 1) + i] + 64) * C * Nb >> 2;
    }
    int offsets[NB_EBANDS] = {0};
    int dynalloc_logp = 6;
    i32 total_bits_frac = total_bits << BITRES;
    i32 tellf = ec.tell_frac();
    for (int i = start; i < end; i++) {
        int width = C * (eband5ms[i + 1] - eband5ms[i]) << LM;
        int quanta = std::min(width << BITRES, std::max(6 << BITRES, width));
        int dynalloc_loop_logp = dynalloc_logp;
        int boost = 0;
        while (tellf + (dynalloc_loop_logp << BITRES) < total_bits_frac &&
               boost < cap[i]) {
            int flag = ec.bit_logp(dynalloc_loop_logp);
            tellf = ec.tell_frac();
            if (!flag) break;
            boost += quanta;
            total_bits_frac -= quanta;
            dynalloc_loop_logp = 1;
        }
        offsets[i] = boost;
        if (boost > 0) dynalloc_logp = std::max(2, dynalloc_logp - 1);
    }
    int alloc_trim = 5;
    if (tellf + (6 << BITRES) <= total_bits_frac) {
        static const unsigned char trim_icdf_[11] = {126, 124, 119, 109, 87, 41, 19, 9, 4, 2, 0};
        alloc_trim = ec.icdf(trim_icdf_, 7);
    }
    i32 bits = ((i32)len * 8 << BITRES) - (i32)ec.tell_frac() - 1;
    int anti_collapse_rsv =
        isTransient && LM >= 2 && bits >= ((LM + 2) << BITRES) ? 1 << BITRES : 0;
    bits -= anti_collapse_rsv;
    int pulses[NB_EBANDS], fine_quant[NB_EBANDS], fine_priority[NB_EBANDS];
    int intensity = 0, dual_stereo = 0;
    i32 balance = 0;
    int codedBands = clt_compute_allocation(ec, start, end, offsets, cap, alloc_trim,
                                            &intensity, &dual_stereo, bits, &balance,
                                            pulses, fine_quant, fine_priority, C, LM);
    unquant_fine_energy(ec, start, end, oldBandE, fine_quant, C);

    unsigned char collapse_masks[2 * NB_EBANDS] = {0};
    memset(X_out, 0, (size_t)C * N * sizeof(i16));
    quant_all_bands(ec, start, end, X_out, C == 2 ? X_out + N : nullptr,
                    collapse_masks, pulses, shortBlocks, spread_decision,
                    dual_stereo, intensity, tf_res,
                    ((i32)len * (8 << BITRES)) - anti_collapse_rsv, balance, LM,
                    codedBands, &st->rng, disable_inv);
    int anti_collapse_on = 0;
    if (anti_collapse_rsv > 0) anti_collapse_on = (int)ec.dec_bits(1);
    unquant_energy_finalise(ec, start, end, oldBandE, fine_quant, fine_priority,
                            len * 8 - ec.tell(), C);
    if (anti_collapse_on)
        anti_collapse(X_out, collapse_masks, LM, C, N, start, end, oldBandE,
                      oldLogE, oldLogE2, pulses, st->rng);
    if (silence) {
        for (int i = 0; i < 2 * NB_EBANDS; i++) oldBandE[i] = MINUS_28DB;
    }

    // postfilter param sets for the device comb filter
    st->pf_period = std::max(st->pf_period, (i32)COMBFILTER_MINPERIOD);
    st->pf_period_old = std::max(st->pf_period_old, (i32)COMBFILTER_MINPERIOD);
    out_params[0] = silence;
    out_params[1] = isTransient;
    out_params[2] = LM;
    out_params[3] = st->pf_period_old;
    out_params[4] = st->pf_period;
    out_params[5] = st->pf_gain_old;
    out_params[6] = st->pf_gain;
    out_params[7] = st->pf_tapset_old;
    out_params[8] = st->pf_tapset;
    out_params[9] = st->pf_period;
    out_params[10] = pf_pitch;
    out_params[11] = st->pf_gain;
    out_params[12] = pf_gain;
    out_params[13] = st->pf_tapset;
    out_params[14] = pf_tapset;
    out_params[15] = silence ? 0 : effEnd;

    // postfilter state rotation (src/celt.cpp:2391-2404)
    st->pf_period_old = st->pf_period;
    st->pf_gain_old = st->pf_gain;
    st->pf_tapset_old = st->pf_tapset;
    st->pf_period = pf_pitch;
    st->pf_gain = pf_gain;
    st->pf_tapset = pf_tapset;
    if (LM != 0) {
        st->pf_period_old = st->pf_period;
        st->pf_gain_old = st->pf_gain;
        st->pf_tapset_old = st->pf_tapset;
    }

    // snapshot for the device phase BEFORE the mono dup (matches the
    // Python host phase; channel-1 energies are unused for mono anyway)
    memcpy(bandE_out, oldBandE, 2 * NB_EBANDS * sizeof(i16));
    if (C == 1)
        memcpy(&oldBandE[NB_EBANDS], oldBandE, NB_EBANDS * sizeof(i16));

    if (!isTransient) {
        memcpy(oldLogE2, oldLogE, 2 * NB_EBANDS * sizeof(i16));
        memcpy(oldLogE, oldBandE, 2 * NB_EBANDS * sizeof(i16));
        i16 max_inc = st->loss_count < 10 ? (i16)M : (i16)(1 << DB_SHIFT);
        for (int i = 0; i < 2 * NB_EBANDS; i++)
            backgroundLogE[i] = std::min((i16)(backgroundLogE[i] + max_inc), oldBandE[i]);
    } else {
        for (int i = 0; i < 2 * NB_EBANDS; i++)
            oldLogE[i] = std::min(oldLogE[i], oldBandE[i]);
    }
    for (int c = 0; c < 2; c++) {
        for (int i = 0; i < start; i++) {
            oldBandE[c * NB_EBANDS + i] = 0;
            oldLogE[c * NB_EBANDS + i] = oldLogE2[c * NB_EBANDS + i] = MINUS_28DB;
        }
        for (int i = end; i < NB_EBANDS; i++) {
            oldBandE[c * NB_EBANDS + i] = 0;
            oldLogE[c * NB_EBANDS + i] = oldLogE2[c * NB_EBANDS + i] = MINUS_28DB;
        }
    }
    st->rng = ec.rng;
    st->loss_count = 0;
    out_params[16] = ec.tell();
    out_params[17] = (i32)ec.rng;
    if (ec.tell() > 8 * len) return -2;
    if (ec.error) st->error = 1;
    return 0;
}

int celt_host_decode(const unsigned char* data, int len, int frame_size,
                     int CC, int C, int start, int end, int disable_inv,
                     CeltHostState* st, i16* X_out, i16* bandE_out,
                     i32* out_params) {
    return celt_host_decode_impl(data, len, frame_size, CC, C, start, end,
                                 disable_inv, st, X_out, bandE_out,
                                 out_params, nullptr);
}

int celt_host_decode_resume(const unsigned char* data, int len,
                            int frame_size, int CC, int C, int start,
                            int end, int disable_inv, CeltHostState* st,
                            i16* X_out, i16* bandE_out, i32* out_params,
                            const i32* ec_in) {
    return celt_host_decode_impl(data, len, frame_size, CC, C, start, end,
                                 disable_inv, st, X_out, bandE_out,
                                 out_params, ec_in);
}

void celt_host_reset(CeltHostState* st) {
    memset(st, 0, sizeof *st);
    for (int i = 0; i < 2 * NB_EBANDS; i++)
        st->oldLogE[i] = st->oldLogE2[i] = MINUS_28DB;
}

}  // extern "C"
