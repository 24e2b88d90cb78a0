// Native host entropy engine: the SILK symbol phase for one mono no-loss
// frame — indices, shell-coded excitation, gain/NLSF/pitch/LTP dequant,
// NLSF->LPC conversion and excitation expansion — producing the same
// per-frame device tensors as models/batch_silk.py::silk_host_frame.
//
// C++ re-expression of the framework's Python host phase
// (ops/silk/{decode,nlsf,macros}.py, models/silk_decoder.py), itself
// verified bit-exact against the reference (reference src/silk.cpp).
// Optionally consumes the hybrid redundancy flag and exports the range
// coder state so the CELT engine can resume on the same packet.

#include <cstdint>
#include <cstring>
#include <algorithm>

#include "ec_dec.h"
#include "silk_tables.h"

namespace {

typedef int32_t i32;
typedef int16_t i16;
typedef int64_t i64;
typedef uint32_t u32;
using opus_ec::EcDec;

constexpr int MAX_LPC_ORDER = 16;
constexpr int MAX_NB_SUBFR = 4;
constexpr int LTP_ORDER = 5;
constexpr int TYPE_VOICED = 2;
constexpr int SHELL_FRAME = 16;
constexpr int SILK_MAX_PULSES = 16;
constexpr int N_RATE_LEVELS = 10;
constexpr int NLSF_QMA = 4;  // NLSF_QUANT_MAX_AMPLITUDE
constexpr i32 I32MAX = 2147483647;
constexpr i32 I32MIN = (i32)0x80000000;

// ---------------------------------------------------------------- macros
static inline i32 SMULWB(i32 a, i32 b) { return (i32)(((i64)a * (i16)b) >> 16); }
static inline i32 SMLAWB(i32 a, i32 b, i32 c) { return (i32)(a + (((i64)b * (i16)c) >> 16)); }
static inline i32 SMULBB(i32 a, i32 b) { return (i32)(i16)a * (i32)(i16)b; }
static inline i32 SMLABB(i32 a, i32 b, i32 c) { return a + SMULBB(b, c); }
static inline i32 SMULWW(i32 a, i32 b) { return (i32)(((i64)a * b) >> 16); }
static inline i32 SMLAWW(i32 a, i32 b, i32 c) { return (i32)(a + (((i64)b * c) >> 16)); }
static inline i32 SMMUL(i32 a, i32 b) { return (i32)(((i64)a * b) >> 32); }
static inline i32 RSHIFT_ROUND(i32 a, int s) {
    return s == 1 ? (a >> 1) + (a & 1) : ((a >> (s - 1)) + 1) >> 1;
}
static inline i64 RSHIFT_ROUND64(i64 a, int s) {
    return s == 1 ? (a >> 1) + (a & 1) : ((a >> (s - 1)) + 1) >> 1;
}
static inline i32 SAT16(i32 x) { return x > 32767 ? 32767 : x < -32768 ? -32768 : x; }
static inline i32 LSHIFT32(i32 a, int s) { return (i32)((u32)a << s); }
static inline i32 LIMIT(i32 a, i32 lo, i32 hi) { return a < lo ? lo : a > hi ? hi : a; }
static inline int CLZ32(i32 x) { return x ? __builtin_clz((u32)x) : 32; }
static inline i32 silk_abs(i32 a) { return a > 0 ? a : -a; }
static inline i32 LSHIFT_SAT32(i32 a, int s) {
    return LSHIFT32(LIMIT(a, I32MIN >> s, I32MAX >> s), s);
}
static inline i32 ADD_SAT16_(i32 a, i32 b) { return (i16)SAT16(a + b); }
static inline i32 silk_RAND(i32 seed) {
    return (i32)(907633515u + (u32)seed * 196314165u);
}
static inline i32 ADD32_ovflw(i32 a, i32 b) { return (i32)((u32)a + (u32)b); }
static inline i32 SUB32_ovflw(i32 a, i32 b) { return (i32)((u32)a - (u32)b); }

static i32 DIV32_varQ(i32 a32, i32 b32, int qres) {
    int a_headrm = CLZ32(silk_abs(a32)) - 1;
    i32 a_nrm = LSHIFT32(a32, a_headrm);
    int b_headrm = CLZ32(silk_abs(b32)) - 1;
    i32 b_nrm = LSHIFT32(b32, b_headrm);
    i32 b_inv = (I32MAX >> 2) / (b_nrm >> 16);
    i32 result = SMULWB(a_nrm, b_inv);
    a_nrm = SUB32_ovflw(a_nrm, (i32)((u32)SMMUL(b_nrm, result) << 3));
    result = SMLAWB(result, a_nrm, b_inv);
    int lshift = 29 + a_headrm - b_headrm - qres;
    if (lshift < 0) return LSHIFT_SAT32(result, -lshift);
    if (lshift < 32) return result >> lshift;
    return 0;
}

static i32 INVERSE32_varQ(i32 b32, int qres) {
    int b_headrm = CLZ32(silk_abs(b32)) - 1;
    i32 b_nrm = LSHIFT32(b32, b_headrm);
    i32 b_inv = (I32MAX >> 2) / (b_nrm >> 16);
    i32 result = LSHIFT32(b_inv, 16);
    i32 err_q32 = LSHIFT32((1 << 29) - SMULWB(b_nrm, b_inv), 3);
    result = SMLAWW(result, err_q32, b_inv);
    int lshift = 61 - b_headrm - qres;
    if (lshift <= 0) return LSHIFT_SAT32(result, -lshift);
    if (lshift < 32) return result >> lshift;
    return 0;
}

static i32 log2lin(i32 in_log_q7) {
    if (in_log_q7 < 0) return 0;
    if (in_log_q7 >= 3967) return I32MAX;
    i32 out = LSHIFT32(1, in_log_q7 >> 7);
    i32 frac = in_log_q7 & 0x7F;
    if (in_log_q7 < 2048)
        out = out + ((out * SMLAWB(frac, SMULBB(frac, 128 - frac), -174)) >> 7);
    else
        out = out + (out >> 7) * SMLAWB(frac, SMULBB(frac, 128 - frac), -174);
    return out;
}

// ---------------------------------------------------------------- NLSF
struct NlsfCb {
    int nVectors, order;
    i32 quantStepSize_Q16;
    const unsigned char* cb1;
    const short* wght;
    const unsigned char* cb1_icdf;
    const unsigned char* pred;
    const unsigned char* ec_sel;
    const unsigned char* ec_icdf;
    const short* delta_min;
};

static const NlsfCb CB_NB_MB = {32, 10, 11796, silk_NLSF_CB1_NB_MB_Q8,
                                silk_NLSF_CB1_Wght_Q9, silk_NLSF_CB1_iCDF_NB_MB,
                                silk_NLSF_PRED_NB_MB_Q8, silk_NLSF_CB2_SELECT_NB_MB,
                                silk_NLSF_CB2_iCDF_NB_MB,
                                silk_NLSF_DELTA_MIN_NB_MB_Q15};
static const NlsfCb CB_WB = {32, 16, 9830, silk_NLSF_CB1_WB_Q8,
                             silk_NLSF_CB1_WB_Wght_Q9, silk_NLSF_CB1_iCDF_WB,
                             silk_NLSF_PRED_WB_Q8, silk_NLSF_CB2_SELECT_WB,
                             silk_NLSF_CB2_iCDF_WB, silk_NLSF_DELTA_MIN_WB_Q15};

static void nlsf_unpack(const NlsfCb& cb, int idx, int* ec_ix, int* pred_q8) {
    const unsigned char* sel = cb.ec_sel + idx * cb.order / 2;
    for (int i = 0; i < cb.order; i += 2) {
        int entry = *sel++;
        ec_ix[i] = ((entry >> 1) & 7) * (2 * NLSF_QMA + 1);
        pred_q8[i] = cb.pred[i + (entry & 1) * (cb.order - 1)];
        ec_ix[i + 1] = ((entry >> 5) & 7) * (2 * NLSF_QMA + 1);
        pred_q8[i + 1] = cb.pred[i + ((entry >> 4) & 1) * (cb.order - 1) + 1];
    }
}

static void nlsf_stabilize(i32* nlsf, const short* dmin, int L) {
    for (int loops = 0; loops < 20; loops++) {
        i32 min_diff = nlsf[0] - dmin[0];
        int I = 0;
        for (int i = 1; i < L; i++) {
            i32 d = nlsf[i] - (nlsf[i - 1] + dmin[i]);
            if (d < min_diff) { min_diff = d; I = i; }
        }
        i32 d = (1 << 15) - (nlsf[L - 1] + dmin[L]);
        if (d < min_diff) { min_diff = d; I = L; }
        if (min_diff >= 0) return;
        if (I == 0) nlsf[0] = dmin[0];
        else if (I == L) nlsf[L - 1] = (1 << 15) - dmin[L];
        else {
            i32 min_c = 0;
            for (int k = 0; k < I; k++) min_c += dmin[k];
            min_c += dmin[I] >> 1;
            i32 max_c = 1 << 15;
            for (int k = L; k > I; k--) max_c -= dmin[k];
            max_c -= dmin[I] >> 1;
            i32 c = (i16)LIMIT(RSHIFT_ROUND(nlsf[I - 1] + nlsf[I], 1),
                               min_c, max_c);
            nlsf[I - 1] = c - (dmin[I] >> 1);
            nlsf[I] = nlsf[I - 1] + dmin[I];
        }
    }
    std::sort(nlsf, nlsf + L);
    nlsf[0] = std::max(nlsf[0], (i32)dmin[0]);
    for (int i = 1; i < L; i++)
        nlsf[i] = std::max(nlsf[i], (i32)ADD_SAT16_(nlsf[i - 1], dmin[i]));
    nlsf[L - 1] = std::min(nlsf[L - 1], (i32)((1 << 15) - dmin[L]));
    for (int i = L - 2; i >= 0; i--)
        nlsf[i] = std::min(nlsf[i], nlsf[i + 1] - dmin[i + 1]);
}

static void nlsf_decode(EcDec& ec, const NlsfCb& cb, const int* idxs,
                        i32* nlsf_q15) {
    int ec_ix[MAX_LPC_ORDER], pred_q8[MAX_LPC_ORDER];
    nlsf_unpack(cb, idxs[0], ec_ix, pred_q8);
    i32 res_q10[MAX_LPC_ORDER];
    i32 out_q10 = 0;
    for (int i = cb.order - 1; i >= 0; i--) {
        i32 pred_q10 = SMULBB(out_q10, pred_q8[i]) >> 8;
        out_q10 = LSHIFT32(idxs[i + 1], 10);
        if (out_q10 > 0) out_q10 -= 102;       // NLSF_QUANT_LEVEL_ADJ Q10
        else if (out_q10 < 0) out_q10 += 102;
        out_q10 = SMLAWB(pred_q10, out_q10, cb.quantStepSize_Q16);
        res_q10[i] = out_q10;
    }
    int base = idxs[0] * cb.order;
    for (int i = 0; i < cb.order; i++) {
        i32 tmp = LSHIFT32(res_q10[i], 14) / cb.wght[base + i]
                  + ((i32)cb.cb1[base + i] << 7);
        nlsf_q15[i] = LIMIT(tmp, 0, 32767);
    }
    nlsf_stabilize(nlsf_q15, cb.delta_min, cb.order);
}

static void bwexpander_32(i32* ar, int d, i32 chirp_q16) {
    i32 cm1 = chirp_q16 - 65536;
    for (int i = 0; i < d - 1; i++) {
        ar[i] = SMULWW(chirp_q16, ar[i]);
        chirp_q16 += RSHIFT_ROUND(chirp_q16 * cm1, 16);
    }
    ar[d - 1] = SMULWW(chirp_q16, ar[d - 1]);
}

static void bwexpander16(i32* ar, int d, i32 chirp_q16) {
    i32 cm1 = chirp_q16 - 65536;
    for (int i = 0; i < d - 1; i++) {
        ar[i] = (i16)RSHIFT_ROUND(chirp_q16 * ar[i], 16);
        chirp_q16 += RSHIFT_ROUND(chirp_q16 * cm1, 16);
    }
    ar[d - 1] = (i16)RSHIFT_ROUND(chirp_q16 * ar[d - 1], 16);
}

static void lpc_fit(i32* a_qin, i32* a_qout, int qout, int qin, int d) {
    int it;
    i32 maxabs = 0;
    for (it = 0; it < 10; it++) {
        maxabs = 0;
        int idx = 0;
        for (int k = 0; k < d; k++) {
            i32 v = silk_abs(a_qin[k]);
            if (v > maxabs) { maxabs = v; idx = k; }
        }
        maxabs = RSHIFT_ROUND(maxabs, qin - qout);
        if (maxabs > 32767) {
            maxabs = std::min(maxabs, (i32)163838);
            i32 chirp = 65470 - (LSHIFT32(maxabs - 32767, 14)
                                 / ((maxabs * (idx + 1)) >> 2));
            bwexpander_32(a_qin, d, chirp);
        } else break;
    }
    if (it == 10) {
        for (int k = 0; k < d; k++) {
            a_qout[k] = SAT16(RSHIFT_ROUND(a_qin[k], qin - qout));
            a_qin[k] = LSHIFT32(a_qout[k], qin - qout);
        }
    } else {
        for (int k = 0; k < d; k++)
            a_qout[k] = (i16)RSHIFT_ROUND(a_qin[k], qin - qout);
    }
}

static i32 mul32_frac_q(i32 a, i32 b, int q) {
    return (i32)RSHIFT_ROUND64((i64)a * b, q);
}

static i32 SUB_SAT32(i32 a, i32 b) {
    i64 r = (i64)a - b;
    return r > I32MAX ? I32MAX : r < I32MIN ? I32MIN : (i32)r;
}

static int lpc_inverse_pred_gain(const i32* a_q12, int order) {
    constexpr i32 A_LIMIT = 16773022;
    i32 A[MAX_LPC_ORDER];
    i32 dc = 0;
    for (int k = 0; k < order; k++) {
        dc += a_q12[k];
        A[k] = LSHIFT32(a_q12[k], 12);
    }
    if (dc >= 4096) return 0;
    i32 invGain = 1 << 30;
    for (int k = order - 1; k > 0; k--) {
        if (A[k] > A_LIMIT || A[k] < -A_LIMIT) return 0;
        i32 rc = -LSHIFT32(A[k], 7);
        i32 rc_mult1 = (1 << 30) - SMMUL(rc, rc);
        invGain = LSHIFT32(SMMUL(invGain, rc_mult1), 2);
        if (invGain < 107374) return 0;
        int mult2q = 32 - CLZ32(silk_abs(rc_mult1));
        i32 rc_mult2 = INVERSE32_varQ(rc_mult1, mult2q + 30);
        for (int n = 0; n < (k + 1) >> 1; n++) {
            i32 t1 = A[n], t2 = A[k - n - 1];
            i64 v = RSHIFT_ROUND64(
                (i64)SUB_SAT32(t1, mul32_frac_q(t2, rc, 31)) * rc_mult2,
                mult2q);
            if (v > I32MAX || v < I32MIN) return 0;
            A[n] = (i32)v;
            v = RSHIFT_ROUND64(
                (i64)SUB_SAT32(t2, mul32_frac_q(t1, rc, 31)) * rc_mult2,
                mult2q);
            if (v > I32MAX || v < I32MIN) return 0;
            A[k - n - 1] = (i32)v;
        }
    }
    if (A[0] > A_LIMIT || A[0] < -A_LIMIT) return 0;
    i32 rc = -LSHIFT32(A[0], 7);
    i32 rc_mult1 = (1 << 30) - SMMUL(rc, rc);
    invGain = LSHIFT32(SMMUL(invGain, rc_mult1), 2);
    if (invGain < 107374) return 0;
    return invGain;
}

static const unsigned char ORD16[16] = {0, 15, 8, 7, 4, 11, 12, 3, 2, 13, 10, 5, 6, 9, 14, 1};
static const unsigned char ORD10[10] = {0, 9, 6, 3, 4, 5, 8, 1, 2, 7};

static void nlsf2a_find_poly(i32* out, const i32* cLSF, int off, int dd) {
    out[0] = 1 << 16;
    out[1] = -cLSF[off];
    for (int k = 1; k < dd; k++) {
        i32 ftmp = cLSF[off + 2 * k];
        out[k + 1] = (i32)(LSHIFT32(out[k - 1], 1)
                           - (i32)RSHIFT_ROUND64((i64)ftmp * out[k], 16));
        for (int n = k; n > 1; n--)
            out[n] = (i32)(out[n] + out[n - 2]
                           - (i32)RSHIFT_ROUND64((i64)ftmp * out[n - 1], 16));
        out[1] -= ftmp;
    }
}

static void nlsf2a(const i32* nlsf_q15, int d, i32* a_q12) {
    const unsigned char* ordering = d == 16 ? ORD16 : ORD10;
    i32 cos_lsf[MAX_LPC_ORDER];
    for (int k = 0; k < d; k++) {
        int f_int = nlsf_q15[k] >> 8;
        int f_frac = nlsf_q15[k] - (f_int << 8);
        i32 cos_val = silk_LSFCosTab_FIX_Q12[f_int];
        i32 delta = silk_LSFCosTab_FIX_Q12[f_int + 1] - cos_val;
        cos_lsf[ordering[k]] = RSHIFT_ROUND(LSHIFT32(cos_val, 8)
                                            + delta * f_frac, 4);
    }
    int dd = d >> 1;
    i32 P[MAX_LPC_ORDER / 2 + 1], Q[MAX_LPC_ORDER / 2 + 1];
    nlsf2a_find_poly(P, cos_lsf, 0, dd);
    nlsf2a_find_poly(Q, cos_lsf, 1, dd);
    i32 a32[MAX_LPC_ORDER];
    for (int k = 0; k < dd; k++) {
        i32 Ptmp = P[k + 1] + P[k];
        i32 Qtmp = Q[k + 1] - Q[k];
        a32[k] = -Qtmp - Ptmp;
        a32[d - k - 1] = Qtmp - Ptmp;
    }
    lpc_fit(a32, a_q12, 12, 17, d);
    for (int i = 0; lpc_inverse_pred_gain(a_q12, d) == 0 && i < 16; i++) {
        bwexpander_32(a32, d, 65536 - LSHIFT32(2, i));
        for (int k = 0; k < d; k++)
            a_q12[k] = (i16)RSHIFT_ROUND(a32[k], 5);
    }
}

// ---------------------------------------------------------------- decode
}  // namespace

extern "C" {

struct SilkHostState {
    i32 fs_kHz, nb_subfr, frame_length, subfr_length, LPC_order;
    i32 prevNLSF_Q15[MAX_LPC_ORDER];
    i32 LastGainIndex, prev_gain_Q16;
    i32 ec_prevSignalType, ec_prevLagIndex;
    i32 first_frame_after_reset, lagPrev, prevSignalType;
    i32 nFramesPerPacket;
    i32 VAD_flags[3], LBRR_flag, LBRR_flags[3];
};

void silk_host_reset(SilkHostState* st) {
    memset(st, 0, sizeof *st);
    st->first_frame_after_reset = 1;
    st->prev_gain_Q16 = 65536;
}

}  // extern "C"

namespace {

struct Indices {
    int signalType, quantOffsetType;
    int GainsIndices[MAX_NB_SUBFR];
    int NLSFIndices[MAX_LPC_ORDER + 1];
    int NLSFInterpCoef_Q2;
    int lagIndex, contourIndex, PERIndex;
    int LTPIndex[MAX_NB_SUBFR];
    int LTP_scaleIndex, Seed;
};

static void set_fs(SilkHostState* st, int fs_khz, int nb_subfr) {
    st->subfr_length = 5 * fs_khz;
    int frame_length = nb_subfr * st->subfr_length;
    if (st->fs_kHz != fs_khz || frame_length != st->frame_length) {
        if (st->fs_kHz != fs_khz) {
            st->LPC_order = (fs_khz == 8 || fs_khz == 12) ? 10 : 16;
            st->first_frame_after_reset = 1;
            st->lagPrev = 100;
            st->LastGainIndex = 10;
            st->prevSignalType = 0;
        }
        st->fs_kHz = fs_khz;
        st->frame_length = frame_length;
    }
    st->nb_subfr = nb_subfr;
}

static void decode_indices(EcDec& ec, SilkHostState* st, Indices& ind,
                           int frame_index, int decode_lbrr, int cond) {
    const NlsfCb& cb = st->LPC_order == 16 ? CB_WB : CB_NB_MB;
    int ix;
    if (decode_lbrr || st->VAD_flags[frame_index])
        ix = ec.icdf(silk_type_offset_VAD_iCDF, 8) + 2;
    else
        ix = ec.icdf(silk_type_offset_no_VAD_iCDF, 8);
    ind.signalType = ix >> 1;
    ind.quantOffsetType = ix & 1;

    if (cond == 2) {  // CODE_CONDITIONALLY
        ind.GainsIndices[0] = ec.icdf(silk_delta_gain_iCDF, 8);
    } else {
        ind.GainsIndices[0] =
            ec.icdf(silk_gain_iCDF + ind.signalType * 8, 8) << 3;
        ind.GainsIndices[0] += ec.icdf(silk_uniform8_iCDF, 8);
    }
    for (int i = 1; i < st->nb_subfr; i++)
        ind.GainsIndices[i] = ec.icdf(silk_delta_gain_iCDF, 8);

    ind.NLSFIndices[0] = ec.icdf(
        cb.cb1_icdf + (ind.signalType >> 1) * cb.nVectors, 8);
    int ec_ix[MAX_LPC_ORDER], pred_q8[MAX_LPC_ORDER];
    nlsf_unpack(cb, ind.NLSFIndices[0], ec_ix, pred_q8);
    for (int i = 0; i < cb.order; i++) {
        int v = ec.icdf(cb.ec_icdf + ec_ix[i], 8);
        if (v == 0) v -= ec.icdf(silk_NLSF_EXT_iCDF, 8);
        else if (v == 2 * NLSF_QMA) v += ec.icdf(silk_NLSF_EXT_iCDF, 8);
        ind.NLSFIndices[i + 1] = v - NLSF_QMA;
    }

    if (st->nb_subfr == MAX_NB_SUBFR)
        ind.NLSFInterpCoef_Q2 = ec.icdf(silk_NLSF_interpolation_factor_iCDF, 8);
    else
        ind.NLSFInterpCoef_Q2 = 4;

    if (ind.signalType == TYPE_VOICED) {
        int decode_abs = 1;
        if (cond == 2 && st->ec_prevSignalType == TYPE_VOICED) {
            int delta = ec.icdf(silk_pitch_delta_iCDF, 8);
            if (delta > 0) {
                ind.lagIndex = (i16)(st->ec_prevLagIndex + delta - 9);
                decode_abs = 0;
            }
        }
        if (decode_abs) {
            const unsigned char* low_icdf =
                st->fs_kHz == 16 ? silk_uniform8_iCDF
                : st->fs_kHz == 12 ? silk_uniform6_iCDF : silk_uniform4_iCDF;
            int lag = ec.icdf(silk_pitch_lag_iCDF, 8) * (st->fs_kHz >> 1);
            lag += ec.icdf(low_icdf, 8);
            ind.lagIndex = (i16)lag;
        }
        st->ec_prevLagIndex = ind.lagIndex;
        const unsigned char* contour =
            st->fs_kHz == 8
                ? (st->nb_subfr == 4 ? silk_pitch_contour_NB_iCDF
                                     : silk_pitch_contour_10_ms_NB_iCDF)
                : (st->nb_subfr == 4 ? silk_pitch_contour_iCDF
                                     : silk_pitch_contour_10_ms_iCDF);
        ind.contourIndex = ec.icdf(contour, 8);
        ind.PERIndex = ec.icdf(silk_LTP_per_index_iCDF, 8);
        const unsigned char* gain_icdfs[3] = {
            silk_LTP_gain_iCDF_0, silk_LTP_gain_iCDF_1, silk_LTP_gain_iCDF_2};
        for (int k = 0; k < st->nb_subfr; k++)
            ind.LTPIndex[k] = ec.icdf(gain_icdfs[ind.PERIndex], 8);
        if (cond == 0)
            ind.LTP_scaleIndex = ec.icdf(silk_LTPscale_iCDF, 8);
        else
            ind.LTP_scaleIndex = 0;
    } else {
        ind.lagIndex = 0;
        ind.contourIndex = 0;
        ind.PERIndex = 0;
        ind.LTP_scaleIndex = 0;
    }
    st->ec_prevSignalType = ind.signalType;
    ind.Seed = ec.icdf(silk_uniform4_iCDF, 8);
}

static void decode_split(EcDec& ec, int* c1, int* c2, int p,
                         const unsigned char* table) {
    if (p > 0) {
        *c1 = ec.icdf(table + silk_shell_code_table_offsets[p], 8);
        *c2 = p - *c1;
    } else {
        *c1 = 0;
        *c2 = 0;
    }
}

static void shell_decoder(EcDec& ec, int* p0, int p4) {
    int p3[2], p2[4], p1[8];
    decode_split(ec, &p3[0], &p3[1], p4, silk_shell_code_table3);
    decode_split(ec, &p2[0], &p2[1], p3[0], silk_shell_code_table2);
    decode_split(ec, &p1[0], &p1[1], p2[0], silk_shell_code_table1);
    decode_split(ec, &p0[0], &p0[1], p1[0], silk_shell_code_table0);
    decode_split(ec, &p0[2], &p0[3], p1[1], silk_shell_code_table0);
    decode_split(ec, &p1[2], &p1[3], p2[1], silk_shell_code_table1);
    decode_split(ec, &p0[4], &p0[5], p1[2], silk_shell_code_table0);
    decode_split(ec, &p0[6], &p0[7], p1[3], silk_shell_code_table0);
    decode_split(ec, &p2[2], &p2[3], p3[1], silk_shell_code_table2);
    decode_split(ec, &p1[4], &p1[5], p2[2], silk_shell_code_table1);
    decode_split(ec, &p0[8], &p0[9], p1[4], silk_shell_code_table0);
    decode_split(ec, &p0[10], &p0[11], p1[5], silk_shell_code_table0);
    decode_split(ec, &p1[6], &p1[7], p2[3], silk_shell_code_table1);
    decode_split(ec, &p0[12], &p0[13], p1[6], silk_shell_code_table0);
    decode_split(ec, &p0[14], &p0[15], p1[7], silk_shell_code_table0);
}

static void decode_pulses(EcDec& ec, int* pulses, int signal_type,
                          int quant_offset_type, int frame_length) {
    int rate_level = ec.icdf(
        silk_rate_levels_iCDF + (signal_type >> 1) * 9, 8);
    int niter = frame_length >> 4;
    if (niter * SHELL_FRAME < frame_length) niter++;
    int sum_pulses[20], n_lshifts[20];
    for (int i = 0; i < niter; i++) {
        n_lshifts[i] = 0;
        sum_pulses[i] = ec.icdf(
            silk_pulses_per_block_iCDF + rate_level * 18, 8);
        while (sum_pulses[i] == SILK_MAX_PULSES + 1) {
            n_lshifts[i]++;
            sum_pulses[i] = ec.icdf(
                silk_pulses_per_block_iCDF + (N_RATE_LEVELS - 1) * 18
                + (n_lshifts[i] == 10 ? 1 : 0), 8);
        }
    }
    for (int i = 0; i < niter; i++) {
        if (sum_pulses[i] > 0)
            shell_decoder(ec, pulses + i * SHELL_FRAME, sum_pulses[i]);
        else
            memset(pulses + i * SHELL_FRAME, 0, SHELL_FRAME * sizeof(int));
    }
    for (int i = 0; i < niter; i++) {
        if (n_lshifts[i] > 0) {
            int nls = n_lshifts[i];
            for (int k = 0; k < SHELL_FRAME; k++) {
                int q = pulses[i * SHELL_FRAME + k];
                for (int j = 0; j < nls; j++)
                    q = (q << 1) + ec.icdf(silk_lsb_iCDF, 8);
                pulses[i * SHELL_FRAME + k] = q;
            }
            sum_pulses[i] |= nls << 5;
        }
    }
    // signs
    int base = 7 * (quant_offset_type + (signal_type << 1));
    int n_blocks = (frame_length + SHELL_FRAME / 2) >> 4;
    for (int i = 0; i < n_blocks; i++) {
        int p = sum_pulses[i];
        if (p > 0) {
            unsigned char icdf2[2] = {
                silk_sign_iCDF[base + std::min(p & 0x1F, 6)], 0};
            for (int j = 0; j < SHELL_FRAME; j++) {
                if (pulses[i * SHELL_FRAME + j] > 0)
                    pulses[i * SHELL_FRAME + j] *=
                        2 * ec.icdf(icdf2, 8) - 1;
            }
        }
    }
}

static void gains_dequant(i32* gains_q16, const int* ind, i32* prev_ind,
                          int conditional, int nb_subfr) {
    for (int k = 0; k < nb_subfr; k++) {
        if (k == 0 && !conditional) {
            *prev_ind = std::max((i32)ind[k], *prev_ind - 16);
        } else {
            int ind_tmp = ind[k] - 4;           // MIN_DELTA_GAIN_QUANT
            i32 dst = 2 * 36 - 64 + *prev_ind;  // double step threshold
            if (ind_tmp > dst) *prev_ind += (ind_tmp << 1) - dst;
            else *prev_ind += ind_tmp;
        }
        *prev_ind = LIMIT(*prev_ind, 0, 63);
        gains_q16[k] = log2lin(
            std::min(SMULWB(1907825, *prev_ind) + 2090, (i32)3967));
    }
}

static void decode_pitch(int lag_index, int contour_index, i32* pitch_lags,
                         int fs_khz, int nb_subfr) {
    const signed char* cb;
    int cbk_size;
    if (fs_khz == 8) {
        if (nb_subfr == 4) { cb = (const signed char*)silk_CB_lags_stage2; cbk_size = 11; }
        else { cb = (const signed char*)silk_CB_lags_stage2_10_ms; cbk_size = 3; }
    } else {
        if (nb_subfr == 4) { cb = (const signed char*)silk_CB_lags_stage3; cbk_size = 34; }
        else { cb = (const signed char*)silk_CB_lags_stage3_10_ms; cbk_size = 12; }
    }
    int min_lag = 2 * fs_khz;
    int max_lag = 18 * fs_khz;
    int lag = min_lag + lag_index;
    for (int k = 0; k < nb_subfr; k++)
        pitch_lags[k] = LIMIT(lag + cb[k * cbk_size + contour_index],
                              min_lag, max_lag);
}

// Decode one SILK frame's symbols (normal or LBRR) into the device
// tensors — the shared back half of the normal/packet/FEC entry points.
// cond: 0 = CODE_INDEPENDENTLY (first frame), 2 = CODE_CONDITIONALLY
// (frames 1-2 of 40/60 ms packets).
static int frame_to_params(EcDec& ec, SilkHostState* st, int decode_lbrr,
                           int frame_index, int cond,
                           i32* exc_out, i32* A_out, i32* B_out,
                           i32* gains_out, i32* inv_out, i32* lag_out,
                           i32* flags_out, i32* adj_out, i32* misc_out) {
    Indices ind;
    decode_indices(ec, st, ind, frame_index, decode_lbrr, cond);
    int pulses[320 + 16];
    decode_pulses(ec, pulses, ind.signalType, ind.quantOffsetType,
                  st->frame_length);

    // ---- parameters ----
    i32 gains_q16[MAX_NB_SUBFR];
    gains_dequant(gains_q16, ind.GainsIndices, &st->LastGainIndex,
                  cond == 2, st->nb_subfr);

    const NlsfCb& cb = st->LPC_order == 16 ? CB_WB : CB_NB_MB;
    i32 nlsf[MAX_LPC_ORDER];
    nlsf_decode(ec, cb, ind.NLSFIndices, nlsf);
    // NOTE: nlsf_decode does not consume ec symbols; indices already read
    i32 pred1[MAX_LPC_ORDER], pred0[MAX_LPC_ORDER];
    nlsf2a(nlsf, st->LPC_order, pred1);
    if (st->first_frame_after_reset) ind.NLSFInterpCoef_Q2 = 4;
    if (ind.NLSFInterpCoef_Q2 < 4) {
        i32 nlsf0[MAX_LPC_ORDER];
        for (int i = 0; i < st->LPC_order; i++)
            nlsf0[i] = (i16)(st->prevNLSF_Q15[i]
                             + ((ind.NLSFInterpCoef_Q2
                                 * (nlsf[i] - st->prevNLSF_Q15[i])) >> 2));
        nlsf2a(nlsf0, st->LPC_order, pred0);
    } else {
        memcpy(pred0, pred1, st->LPC_order * sizeof(i32));
    }
    for (int i = 0; i < st->LPC_order; i++) st->prevNLSF_Q15[i] = nlsf[i];

    i32 pitchL[MAX_NB_SUBFR] = {0, 0, 0, 0};
    i32 ltp_coef[MAX_NB_SUBFR * LTP_ORDER] = {0};
    i32 ltp_scale_q14 = 0;
    int per_index = ind.PERIndex;
    if (ind.signalType == TYPE_VOICED) {
        decode_pitch(ind.lagIndex, ind.contourIndex, pitchL, st->fs_kHz,
                     st->nb_subfr);
        const signed char* vq[3] = {
            (const signed char*)silk_LTP_gain_vq_0,
            (const signed char*)silk_LTP_gain_vq_1,
            (const signed char*)silk_LTP_gain_vq_2};
        for (int k = 0; k < st->nb_subfr; k++)
            for (int i = 0; i < LTP_ORDER; i++)
                ltp_coef[k * LTP_ORDER + i] =
                    (i32)vq[per_index][ind.LTPIndex[k] * LTP_ORDER + i] << 7;
        ltp_scale_q14 = silk_LTPScales_table_Q14[ind.LTP_scaleIndex];
    }

    // ---- excitation expansion ----
    i32 offset_q10 = silk_Quantization_Offsets_Q10[
        (ind.signalType >> 1) * 2 + ind.quantOffsetType];
    i32 seed = ind.Seed;
    for (int i = 0; i < st->frame_length; i++) {
        seed = silk_RAND(seed);
        i32 e = LSHIFT32(pulses[i], 14);
        if (e > 0) e -= 80 << 4;
        else if (e < 0) e += 80 << 4;
        e += offset_q10 << 4;
        if (seed < 0) e = -e;
        exc_out[i] = e;
        seed = ADD32_ovflw(seed, pulses[i]);
    }

    // ---- device param assembly (matches batch_silk.silk_host_frame) ----
    int voiced = ind.signalType == TYPE_VOICED;
    int interp = ind.NLSFInterpCoef_Q2 < 4;
    memset(A_out, 0, 2 * MAX_LPC_ORDER * sizeof(i32));
    for (int i = 0; i < st->LPC_order; i++) {
        A_out[i] = pred0[i];
        A_out[MAX_LPC_ORDER + i] = pred1[i];
    }
    for (int k = 0; k < st->nb_subfr; k++) {
        for (int i = 0; i < LTP_ORDER; i++)
            B_out[k * LTP_ORDER + i] = ltp_coef[k * LTP_ORDER + i];
        i32 g = gains_q16[k];
        gains_out[k] = g;
        i32 inv = INVERSE32_varQ(g, 47);
        flags_out[k] = voiced;
        lag_out[k] = voiced ? pitchL[k] : 15;
        int rw = voiced && (k == 0 || (k == 2 && interp));
        flags_out[4 + k] = rw;
        if (rw && k == 0)
            inv = LSHIFT32(SMULWB(inv, ltp_scale_q14), 2);
        inv_out[k] = inv;
        if (g != st->prev_gain_Q16) {
            adj_out[k] = DIV32_varQ(st->prev_gain_Q16, g, 16);
            flags_out[8 + k] = 0;
        } else {
            adj_out[k] = 1 << 16;
            flags_out[8 + k] = 1;
        }
        st->prev_gain_Q16 = g;
    }

    st->prevSignalType = ind.signalType;
    st->first_frame_after_reset = 0;
    st->lagPrev = voiced ? pitchL[st->nb_subfr - 1] : 0;

    misc_out[0] = ind.signalType;
    misc_out[1] = interp;
    misc_out[2] = ind.Seed;
    misc_out[3] = st->lagPrev;
    misc_out[4] = ltp_scale_q14;   // PLC-state tracking (silk_PLC_update)
    misc_out[5] = st->VAD_flags[frame_index];
    misc_out[6] = (i32)ec.rng;     // OPUS_GET_FINAL_RANGE conformance probe
    misc_out[7] = ec.tell();
    for (int i = 0; i < MAX_LPC_ORDER; i++)   // per-frame NLSF for the
        misc_out[8 + i] = st->prevNLSF_Q15[i];  // CNG smoothing mirror
    return 0;
}

static void stereo_decode_pred(EcDec& ec, i32* pred) {
    // silk_stereo_decode_pred (:592)
    int n = ec.icdf(silk_stereo_pred_joint_iCDF, 8);
    int ix[2][3];
    ix[0][2] = n / 5;
    ix[1][2] = n - 5 * ix[0][2];
    for (int ch = 0; ch < 2; ch++) {
        ix[ch][0] = ec.icdf(silk_uniform3_iCDF, 8);
        ix[ch][1] = ec.icdf(silk_uniform5_iCDF, 8);
    }
    for (int ch = 0; ch < 2; ch++) {
        ix[ch][0] += 3 * ix[ch][2];
        i32 low = silk_stereo_pred_quant_Q13[ix[ch][0]];
        i32 step = SMULWB(
            (i32)silk_stereo_pred_quant_Q13[ix[ch][0] + 1] - low, 6554);
        pred[ch] = SMLABB(low, step, 2 * ix[ch][1] + 1);
    }
    pred[0] -= pred[1];
}

}  // namespace

extern "C" {

// One STEREO no-loss single-frame SILK packet (silk_Decode :1481 with
// nChannelsInternal=2; payload_ms 10 -> nb_subfr 2, else 20 ms ->
// nb_subfr 4): per-channel VAD/LBRR headers, LBRR payload skip
// (stereo symbols included), stereo predictor + mid-only flag, side
// re-entry reset bookkeeping, then the mid frame and (when present) the
// side frame. hybrid=1 also consumes the redundancy flag and exports the
// range-coder state for the CELT engine.
//
// info[8] out = {has_side, side_reset, new_decode_only_middle,
// pred0_Q13, pred1_Q13, 0, 0, 0}. Side outputs valid iff has_side.
int silk_host_stereo_c(const unsigned char* data, int len, int fs_khz,
                       int payload_ms, int prev_dom, int hybrid,
                       SilkHostState* st0, SilkHostState* st1,
                       i32* m_exc, i32* m_A, i32* m_B, i32* m_gains,
                       i32* m_inv, i32* m_lag, i32* m_flags, i32* m_adj,
                       i32* m_misc,
                       i32* s_exc, i32* s_A, i32* s_B, i32* s_gains,
                       i32* s_inv, i32* s_lag, i32* s_flags, i32* s_adj,
                       i32* s_misc, i32* ec_out, i32* info) {
    EcDec ec;
    ec.init(data, (u32)len);
    int nb_subfr = payload_ms == 10 ? 2 : 4;
    SilkHostState* sts[2] = {st0, st1};
    for (int n = 0; n < 2; n++) {
        sts[n]->nFramesPerPacket = 1;
        set_fs(sts[n], fs_khz, nb_subfr);
        sts[n]->VAD_flags[0] = ec.bit_logp(1);
        sts[n]->LBRR_flag = ec.bit_logp(1);
    }
    for (int n = 0; n < 2; n++) {
        memset(sts[n]->LBRR_flags, 0, sizeof sts[n]->LBRR_flags);
        if (sts[n]->LBRR_flag) sts[n]->LBRR_flags[0] = 1;
    }
    // skip LBRR payloads, stereo symbols included (:1590)
    for (int n = 0; n < 2; n++) {
        if (sts[n]->LBRR_flags[0]) {
            if (n == 0) {
                i32 dummy[2];
                stereo_decode_pred(ec, dummy);
                if (!st1->LBRR_flags[0])
                    ec.icdf(silk_stereo_only_code_mid_iCDF, 8);
            }
            Indices ind;
            int pulses_tmp[320 + 16];
            decode_indices(ec, sts[n], ind, 0, 1, 0);
            decode_pulses(ec, pulses_tmp, ind.signalType,
                          ind.quantOffsetType, sts[n]->frame_length);
        }
    }

    i32 pred[2];
    stereo_decode_pred(ec, pred);
    int dom = 0;
    if (st1->VAD_flags[0] == 0)
        dom = ec.icdf(silk_stereo_only_code_mid_iCDF, 8);
    int side_reset = (dom == 0 && prev_dom == 1);
    if (side_reset) {   // (:378) side re-entry partial reset (host half;
        st1->lagPrev = 100;              // outBuf/sLPC zeroing is device)
        st1->LastGainIndex = 10;
        st1->prevSignalType = 0;
        st1->first_frame_after_reset = 1;
    }
    int has_side = dom == 0;

    int ret = frame_to_params(ec, st0, 0, 0, 0, m_exc, m_A, m_B, m_gains,
                              m_inv, m_lag, m_flags, m_adj, m_misc);
    if (ret != 0) return ret;
    if (has_side) {
        ret = frame_to_params(ec, st1, 0, 0, 0, s_exc, s_A, s_B, s_gains,
                              s_inv, s_lag, s_flags, s_adj, s_misc);
        if (ret != 0) return ret;
    }
    if (hybrid) {
        if (ec.tell() + 37 <= 8 * len) ec.bit_logp(12);
    }
    ec_out[0] = (i32)ec.offs;
    ec_out[1] = (i32)ec.end_offs;
    ec_out[2] = (i32)ec.end_window;
    ec_out[3] = ec.nend_bits;
    ec_out[4] = ec.nbits_total;
    ec_out[5] = (i32)ec.val;
    ec_out[6] = (i32)ec.rng;
    ec_out[7] = ec.rem;
    ec_out[8] = ec.error;
    info[0] = has_side;
    info[1] = side_reset;
    info[2] = dom;
    info[3] = pred[0];
    info[4] = pred[1];
    return 0;
}

// One mono no-loss SILK frame: consumes the packet's SILK symbols
// (header flags on first frame), emits the device tensors for
// ops/silk/jax_core.py::silk_core_frame, and (optionally, hybrid=1) reads
// the hybrid redundancy flag and exports the ec state for the CELT engine.
//
// Outputs: exc[frame], A[2*16], B[4*5], gains[4], inv[4], lag[4],
// flags[12] (voiced[4], rewhiten[4], match[4]), adj[4], ec_out[9],
// misc[24] = {signalType, interp<4, seed, lagPrev, LTP_scale_Q14,
// VAD_flag, 0, 0, NLSF_Q15[16]}.
int silk_host_frame_c(const unsigned char* data, int len, int fs_khz,
                      int payload_ms, int hybrid, SilkHostState* st,
                      i32* exc_out, i32* A_out, i32* B_out, i32* gains_out,
                      i32* inv_out, i32* lag_out, i32* flags_out,
                      i32* adj_out, i32* ec_out, i32* misc_out) {
    EcDec ec;
    ec.init(data, (u32)len);

    int n_frames = payload_ms <= 20 ? 1 : payload_ms / 20;
    int nb_subfr = payload_ms == 10 ? 2 : 4;
    if (n_frames != 1) return -3;   // multi-frame packets: scalar fallback
    st->nFramesPerPacket = 1;
    set_fs(st, fs_khz, nb_subfr);

    // header: VAD + LBRR flags (first frame of each packet)
    for (int i = 0; i < st->nFramesPerPacket; i++)
        st->VAD_flags[i] = ec.bit_logp(1);
    st->LBRR_flag = ec.bit_logp(1);
    memset(st->LBRR_flags, 0, sizeof st->LBRR_flags);
    if (st->LBRR_flag) st->LBRR_flags[0] = 1;
    // skip LBRR payload (normal decode path)
    if (st->LBRR_flags[0]) {
        Indices ind;
        int pulses_tmp[320 + 16];
        decode_indices(ec, st, ind, 0, 1, 0);
        decode_pulses(ec, pulses_tmp, ind.signalType, ind.quantOffsetType,
                      st->frame_length);
    }

    int ret = frame_to_params(ec, st, 0, 0, 0, exc_out, A_out, B_out,
                              gains_out, inv_out, lag_out, flags_out,
                              adj_out, misc_out);
    if (ret != 0) return ret;

    if (hybrid) {
        if (ec.tell() + 37 <= 8 * len) ec.bit_logp(12);
    }
    ec_out[0] = (i32)ec.offs;
    ec_out[1] = (i32)ec.end_offs;
    ec_out[2] = (i32)ec.end_window;
    ec_out[3] = ec.nend_bits;
    ec_out[4] = ec.nbits_total;
    ec_out[5] = (i32)ec.val;
    ec_out[6] = (i32)ec.rng;
    ec_out[7] = ec.rem;
    ec_out[8] = ec.error;
    return 0;
}

// In-band FEC: decode the LBRR copy of this packet's (lost) predecessor
// frame (silk_Decode lostFlag=2, reference src/silk.cpp:1682). Returns
// -4 when the packet carries no LBRR for frame 0 — the caller falls back
// to the loss path. State mutations match a scalar decode_fec call, so a
// subsequent normal decode of the SAME packet continues bit-exactly.
int silk_host_frame_fec_c(const unsigned char* data, int len, int fs_khz,
                          int payload_ms, SilkHostState* st,
                          i32* exc_out, i32* A_out, i32* B_out,
                          i32* gains_out, i32* inv_out, i32* lag_out,
                          i32* flags_out, i32* adj_out, i32* misc_out) {
    EcDec ec;
    ec.init(data, (u32)len);

    int n_frames = payload_ms <= 20 ? 1 : payload_ms / 20;
    int nb_subfr = payload_ms == 10 ? 2 : 4;
    if (n_frames != 1) return -3;
    st->nFramesPerPacket = 1;
    set_fs(st, fs_khz, nb_subfr);

    for (int i = 0; i < st->nFramesPerPacket; i++)
        st->VAD_flags[i] = ec.bit_logp(1);
    st->LBRR_flag = ec.bit_logp(1);
    memset(st->LBRR_flags, 0, sizeof st->LBRR_flags);
    if (st->LBRR_flag) st->LBRR_flags[0] = 1;
    if (!st->LBRR_flags[0]) return -4;  // no usable FEC in this packet

    return frame_to_params(ec, st, 1, 0, 0, exc_out, A_out, B_out,
                           gains_out, inv_out, lag_out, flags_out, adj_out,
                           misc_out);
}

// Stereo in-band FEC: decode the LBRR copies of one lost stereo frame
// (payload_ms 10 or 20; 10 ms packets carry one nb_subfr=2 LBRR copy)
// (silk_Decode lostFlag=FLAG_DECODE_LBRR, nChannelsInternal=2,
// src/silk.cpp:1565-1690). Returns 0 on success; -4 = no mid LBRR in
// this packet (fall back to concealment); -5 = the side channel is
// required (previous frame had side) but carries no LBRR — a mixed
// LBRR+conceal frame, left to the concealment path. info out:
// {has_side, side_reset, new_decode_only_middle, pred0, pred1}.
int silk_host_stereo_fec_c(const unsigned char* data, int len,
                           int fs_khz, int payload_ms, int prev_dom,
                           SilkHostState* st0, SilkHostState* st1,
                           i32* m_exc, i32* m_A, i32* m_B, i32* m_gains,
                           i32* m_inv, i32* m_lag, i32* m_flags,
                           i32* m_adj, i32* m_misc,
                           i32* s_exc, i32* s_A, i32* s_B, i32* s_gains,
                           i32* s_inv, i32* s_lag, i32* s_flags,
                           i32* s_adj, i32* s_misc, i32* info) {
    EcDec ec;
    ec.init(data, (u32)len);
    int nb_subfr = payload_ms == 10 ? 2 : 4;
    SilkHostState* sts[2] = {st0, st1};
    for (int n = 0; n < 2; n++) {
        sts[n]->nFramesPerPacket = 1;
        set_fs(sts[n], fs_khz, nb_subfr);
        sts[n]->VAD_flags[0] = ec.bit_logp(1);
        sts[n]->LBRR_flag = ec.bit_logp(1);
    }
    for (int n = 0; n < 2; n++) {
        memset(sts[n]->LBRR_flags, 0, sizeof sts[n]->LBRR_flags);
        if (sts[n]->LBRR_flag) sts[n]->LBRR_flags[0] = 1;
    }
    if (!st0->LBRR_flags[0]) {
        if (!st1->LBRR_flags[0]) return -4;
        // no mid copy but a side one: the mid conceals, the side decodes
        // its copy (no predictors, not mid-only: a side the previous
        // frame lacked comes back, :378); info[6] says so
        int reset = prev_dom == 1;
        if (reset) {
            st1->lagPrev = 100;
            st1->LastGainIndex = 10;
            st1->prevSignalType = 0;
            st1->first_frame_after_reset = 1;
        }
        int r = frame_to_params(ec, st1, 1, 0, 0, s_exc, s_A, s_B, s_gains,
                                s_inv, s_lag, s_flags, s_adj, s_misc);
        if (r != 0) return r;
        for (int i = 0; i < 8; i++) info[i] = 0;
        info[0] = 1;
        info[1] = reset;
        info[6] = 1;
        return 0;
    }
    // stereo pred + mid-only come from the LBRR section itself
    // (the :1619 walk at lostFlag==FLAG_DECODE_LBRR)
    i32 pred[2];
    stereo_decode_pred(ec, pred);
    int dom = 0;
    if (st1->LBRR_flags[0] == 0)
        dom = ec.icdf(silk_stereo_only_code_mid_iCDF, 8);
    int has_side = (!prev_dom) || st1->LBRR_flags[0] == 1;
    // a side the previous frame had but this LBRR copy lacks is
    // concealed (silk_decode_frame's PLC branch at lostFlag ==
    // FLAG_DECODE_LBRR): its symbols are not read, info[5] says so
    int side_conceal = has_side && !st1->LBRR_flags[0];
    int side_reset = (dom == 0 && prev_dom == 1);
    if (side_reset) {
        st1->lagPrev = 100;
        st1->LastGainIndex = 10;
        st1->prevSignalType = 0;
        st1->first_frame_after_reset = 1;
    }
    int ret = frame_to_params(ec, st0, 1, 0, 0, m_exc, m_A, m_B,
                              m_gains, m_inv, m_lag, m_flags, m_adj,
                              m_misc);
    if (ret != 0) return ret;
    if (has_side && !side_conceal) {
        ret = frame_to_params(ec, st1, 1, 0, 0, s_exc, s_A, s_B,
                              s_gains, s_inv, s_lag, s_flags, s_adj,
                              s_misc);
        if (ret != 0) return ret;
    }
    info[0] = has_side && !side_conceal;
    info[1] = side_reset;
    info[2] = dom;
    info[3] = pred[0];
    info[4] = pred[1];
    info[5] = side_conceal;
    return 0;
}

// One STEREO no-loss SILK packet of n_frames = payload_ms/20 frames
// (silk_Decode :1481 with nChannelsInternal=2, nFramesPerPacket 1-3):
// header flags for both channels, interleaved LBRR skip walk, then per
// frame the stereo predictors + mid-only decision + per-channel frame
// decode with the right conditional coding (mid: f==0 ? INDEP : COND;
// side: f==0 ? INDEP : prev_dom ? INDEP_NO_LTP : COND — the per-FRAME
// updated prev_decode_only_middle, silk_Decode :399-409). The :378 side
// re-entry partial reset applies per frame. Output arrays hold
// n_frames consecutive frames per channel (same strides as
// silk_host_packet_c); info holds n_frames rows of
// {has_side, side_reset, dom, pred0, pred1, 0, 0, 0}; ec_out the final
// coder state (rng -> OPUS_GET_FINAL_RANGE).
int silk_host_stereo_packet_c(const unsigned char* data, int len,
                              int fs_khz, int payload_ms, int prev_dom,
                              SilkHostState* st0, SilkHostState* st1,
                              i32* m_exc, i32* m_A, i32* m_B,
                              i32* m_gains, i32* m_inv, i32* m_lag,
                              i32* m_flags, i32* m_adj, i32* m_misc,
                              i32* s_exc, i32* s_A, i32* s_B,
                              i32* s_gains, i32* s_inv, i32* s_lag,
                              i32* s_flags, i32* s_adj, i32* s_misc,
                              i32* ec_out, i32* info) {
    EcDec ec;
    ec.init(data, (u32)len);
    if (payload_ms % 20 != 0 || payload_ms < 20 || payload_ms > 60)
        return -3;
    int n_frames = payload_ms / 20;
    SilkHostState* sts[2] = {st0, st1};
    for (int n = 0; n < 2; n++) {
        sts[n]->nFramesPerPacket = n_frames;
        set_fs(sts[n], fs_khz, 4);
        for (int i = 0; i < n_frames; i++)
            sts[n]->VAD_flags[i] = ec.bit_logp(1);
        sts[n]->LBRR_flag = ec.bit_logp(1);
    }
    for (int n = 0; n < 2; n++) {
        SilkHostState* st = sts[n];
        memset(st->LBRR_flags, 0, sizeof st->LBRR_flags);
        if (st->LBRR_flag) {
            if (n_frames == 1) {
                st->LBRR_flags[0] = 1;
            } else {
                int sym = ec.icdf(n_frames == 2 ? silk_LBRR_flags_2_iCDF
                                                : silk_LBRR_flags_3_iCDF,
                                  8) + 1;
                for (int i = 0; i < n_frames; i++)
                    st->LBRR_flags[i] = (sym >> i) & 1;
            }
        }
    }
    // skip LBRR payloads: frames outer, channels inner (:1590)
    for (int i = 0; i < n_frames; i++) {
        for (int n = 0; n < 2; n++) {
            SilkHostState* st = sts[n];
            if (!st->LBRR_flags[i]) continue;
            if (n == 0) {
                i32 dummy[2];
                stereo_decode_pred(ec, dummy);
                if (!st1->LBRR_flags[i])
                    ec.icdf(silk_stereo_only_code_mid_iCDF, 8);
            }
            int cond = (i > 0 && st->LBRR_flags[i - 1]) ? 2 : 0;
            Indices ind;
            int pulses_tmp[320 + 16];
            decode_indices(ec, st, ind, i, 1, cond);
            decode_pulses(ec, pulses_tmp, ind.signalType,
                          ind.quantOffsetType, st->frame_length);
        }
    }

    int fl = st0->frame_length;
    int dom_prev = prev_dom;
    for (int f = 0; f < n_frames; f++) {
        i32 pred[2];
        stereo_decode_pred(ec, pred);
        int dom = 0;
        if (st1->VAD_flags[f] == 0)
            dom = ec.icdf(silk_stereo_only_code_mid_iCDF, 8);
        int side_reset = (dom == 0 && dom_prev == 1);
        if (side_reset) {   // (:378) host half; outBuf/sLPC on device
            st1->lagPrev = 100;
            st1->LastGainIndex = 10;
            st1->prevSignalType = 0;
            st1->first_frame_after_reset = 1;
        }
        int has_side = dom == 0;
        int ret = frame_to_params(
            ec, st0, 0, f, f == 0 ? 0 : 2, m_exc + f * fl,
            m_A + f * 2 * MAX_LPC_ORDER, m_B + f * MAX_NB_SUBFR * 5,
            m_gains + f * 4, m_inv + f * 4, m_lag + f * 4,
            m_flags + f * 12, m_adj + f * 4, m_misc + f * 24);
        if (ret != 0) return ret;
        if (has_side) {
            int conds = f == 0 ? 0 : (dom_prev ? 1 : 2);
            ret = frame_to_params(
                ec, st1, 0, f, conds, s_exc + f * fl,
                s_A + f * 2 * MAX_LPC_ORDER, s_B + f * MAX_NB_SUBFR * 5,
                s_gains + f * 4, s_inv + f * 4, s_lag + f * 4,
                s_flags + f * 12, s_adj + f * 4, s_misc + f * 24);
            if (ret != 0) return ret;
        }
        i32* inf = info + f * 8;
        inf[0] = has_side;
        inf[1] = side_reset;
        inf[2] = dom;
        inf[3] = pred[0];
        inf[4] = pred[1];
        dom_prev = dom;
    }
    ec_out[0] = (i32)ec.offs;
    ec_out[1] = (i32)ec.end_offs;
    ec_out[2] = (i32)ec.end_window;
    ec_out[3] = ec.nend_bits;
    ec_out[4] = ec.nbits_total;
    ec_out[5] = (i32)ec.val;
    ec_out[6] = (i32)ec.rng;
    ec_out[7] = ec.rem;
    ec_out[8] = ec.error;
    return 0;
}

// One mono no-loss SILK packet of n_frames = payload_ms/20 frames
// (silk_Decode :1481 with nFramesPerPacket 1-3): header flags once,
// LBRR payloads skipped, then each frame decoded with the right
// conditional coding. Output arrays hold n_frames consecutive frames'
// tensors (exc: n*frame_length, A: n*2*16, B: n*4*5, 4-vectors: n*4,
// flags: n*12, misc: n*24).
int silk_host_packet_c(const unsigned char* data, int len, int fs_khz,
                       int payload_ms, SilkHostState* st,
                       i32* exc_out, i32* A_out, i32* B_out, i32* gains_out,
                       i32* inv_out, i32* lag_out, i32* flags_out,
                       i32* adj_out, i32* misc_out) {
    EcDec ec;
    ec.init(data, (u32)len);

    if (payload_ms % 20 != 0 || payload_ms < 20 || payload_ms > 60)
        return -3;
    int n_frames = payload_ms / 20;
    st->nFramesPerPacket = n_frames;
    set_fs(st, fs_khz, 4);

    for (int i = 0; i < n_frames; i++)
        st->VAD_flags[i] = ec.bit_logp(1);
    st->LBRR_flag = ec.bit_logp(1);
    memset(st->LBRR_flags, 0, sizeof st->LBRR_flags);
    if (st->LBRR_flag) {
        if (n_frames == 1) {
            st->LBRR_flags[0] = 1;
        } else {
            int sym = ec.icdf(n_frames == 2 ? silk_LBRR_flags_2_iCDF
                                            : silk_LBRR_flags_3_iCDF, 8) + 1;
            for (int i = 0; i < n_frames; i++)
                st->LBRR_flags[i] = (sym >> i) & 1;
        }
    }
    // skip LBRR payloads (normal decode path, src/silk.cpp:1590)
    for (int i = 0; i < n_frames; i++) {
        if (st->LBRR_flags[i]) {
            int cond = (i > 0 && st->LBRR_flags[i - 1]) ? 2 : 0;
            Indices ind;
            int pulses_tmp[320 + 16];
            decode_indices(ec, st, ind, i, 1, cond);
            decode_pulses(ec, pulses_tmp, ind.signalType,
                          ind.quantOffsetType, st->frame_length);
        }
    }

    int fl = st->frame_length;
    for (int f = 0; f < n_frames; f++) {
        int cond = f == 0 ? 0 : 2;
        int ret = frame_to_params(
            ec, st, 0, f, cond, exc_out + f * fl,
            A_out + f * 2 * MAX_LPC_ORDER, B_out + f * MAX_NB_SUBFR * 5,
            gains_out + f * 4, inv_out + f * 4, lag_out + f * 4,
            flags_out + f * 12, adj_out + f * 4, misc_out + f * 24);
        if (ret != 0) return ret;
    }
    return 0;
}

}  // extern "C"

// ===================================================================
// PLC/CNG tracker: the native port of models/batch_silk.py's
// NativePlcTracker + conceal prep (reference silk_PLC src/silk.cpp:
// 2871-3185, silk_CNG :1305-1432). rfc_plc pools previously ran this
// ~0.6 ms/stream of scalar python per lost frame and ~30 us/stream of
// good-frame bookkeeping per decoded frame — at 10% loss over
// thousands of streams that Python dominated the loss configs. The
// struct layout mirrors host/native/__init__.py::PlcTrackerState.

struct PlcTrackerC {
    i32 fs_kHz, nb_subfr, subfr_length, frame_length, ltp_mem_length,
        LPC_order;
    i32 lossCnt, prevSignalType, ind_signalType;
    i32 first_frame_after_reset, lagPrev, LastGainIndex;
    i32 cng_smth_Gain_Q16, cng_rand_seed, cng_fs_kHz;
    i32 plc_pitchL_Q8, plc_last_frame_lost, plc_rand_seed,
        plc_randScale_Q14;
    i32 plc_conc_energy, plc_conc_energy_shift, plc_prevLTP_scale_Q14;
    i32 plc_fs_kHz, plc_subfr_length, plc_nb_subfr;
    i32 plc_prevGain_Q16[2];
    i32 plc_LTPCoef_Q14[5];
    i32 plc_prevLPC_Q12[MAX_LPC_ORDER];
    i32 prevNLSF_Q15[MAX_LPC_ORDER];
    i32 cng_smth_NLSF_Q15[MAX_LPC_ORDER];
    i32 cng_synth_state[MAX_LPC_ORDER];
    i32 exc_Q14[320];
    i32 cng_exc_buf_Q14[320];
};

namespace plc {

constexpr i32 HARM_ATT_Q15[2] = {32440, 31130};
constexpr i32 RAND_ATT_V_Q15[2] = {31130, 26214};
constexpr i32 RAND_ATT_UV_Q15[2] = {32440, 29491};
constexpr i32 V_PITCH_GAIN_START_MIN_Q14 = 11469;
constexpr i32 V_PITCH_GAIN_START_MAX_Q14 = 15565;
constexpr i32 PITCH_DRIFT_FAC_Q16 = 655;
constexpr i32 BWE_COEF_Q16 = 64881;
constexpr i32 BWE_AFTER_LOSS_Q16 = 63570;
constexpr i32 CNG_GAIN_SMTH_Q16 = 4634;
constexpr i32 CNG_NLSF_SMTH_Q16 = 16348;
constexpr int TYPE_NO_VOICE_ACTIVITY = 0;

static inline i32 SMULTT(i32 a, i32 b) {
    return (i32)((u32)(a >> 16) * (u32)(b >> 16));
}
static inline i32 ROR32(i32 a, int rot) {
    u32 x = (u32)a;
    if (rot == 0) return (i32)x;
    if (rot < 0) { int s = -rot; return (i32)((x << s) | (x >> (32 - s))); }
    return (i32)((x << (32 - rot)) | (x >> rot));
}
static inline i32 SQRT_APPROX(i32 x) {
    if (x <= 0) return 0;
    int lz = CLZ32(x);
    i32 frac_q7 = ROR32(x, 24 - lz) & 0x7F;
    i32 y = (lz & 1) ? 32768 : 46214;
    y >>= (lz >> 1);
    return SMLAWB(y, y, SMULBB(213, frac_q7));
}

// silk_sum_sqr_shift (src/silk.cpp:3839)
static void sum_sqr_shift(const i32* x, int length, i32* energy,
                          i32* shift) {
    int shft = 31 - CLZ32(length);
    i32 nrg = length;
    int i = 0;
    for (; i < length - 1; i += 2) {
        i32 t = SMULBB(x[i], x[i]);
        t = (i32)((u32)t + (u32)SMULBB(x[i + 1], x[i + 1]));
        nrg = (i32)((u32)nrg + ((u32)t >> shft));
    }
    if (i < length)
        nrg = (i32)((u32)nrg + ((u32)SMULBB(x[i], x[i]) >> shft));
    shft = std::max(0, shft + 3 - CLZ32(nrg));
    nrg = 0;
    for (i = 0; i < length - 1; i += 2) {
        i32 t = SMULBB(x[i], x[i]);
        t = (i32)((u32)t + (u32)SMULBB(x[i + 1], x[i + 1]));
        nrg = (i32)((u32)nrg + ((u32)t >> shft));
    }
    if (i < length)
        nrg = (i32)((u32)nrg + ((u32)SMULBB(x[i], x[i]) >> shft));
    *energy = nrg;
    *shift = shft;
}

static void plc_reset(PlcTrackerC* t) {           // silk_PLC_Reset :2862
    t->plc_pitchL_Q8 = LSHIFT32(t->frame_length, 7);
    t->plc_prevGain_Q16[0] = 1 << 16;
    t->plc_prevGain_Q16[1] = 1 << 16;
    t->plc_subfr_length = 20;
    t->plc_nb_subfr = 2;
}

static void cng_reset(PlcTrackerC* t) {           // silk_CNG_Reset :1327
    i32 step = 32767 / (t->LPC_order + 1);
    i32 acc = 0;
    for (int i = 0; i < MAX_LPC_ORDER; i++) t->cng_smth_NLSF_Q15[i] = 0;
    for (int i = 0; i < t->LPC_order; i++) {
        acc += step;
        t->cng_smth_NLSF_Q15[i] = acc;
    }
    t->cng_smth_Gain_Q16 = 0;
    t->cng_rand_seed = 3176576;
}

// silk_PLC_update (:2895). ctrl arrays: gains[4] Q16, B[4*5] Q14,
// lag[4], A1[order] (second-half PredCoef), ltp_scale Q14.
static void update(PlcTrackerC* t, const i32* gains, const i32* B,
                   const i32* lag, const i32* A1, i32 ltp_scale) {
    t->prevSignalType = t->ind_signalType;
    i32 ltp_gain_q14 = 0;
    if (t->ind_signalType == TYPE_VOICED) {
        for (int j = 0; j * t->subfr_length < lag[t->nb_subfr - 1];
             j++) {
            if (j == t->nb_subfr) break;
            i32 temp = 0;
            for (int i = 0; i < LTP_ORDER; i++)
                temp += B[(t->nb_subfr - 1 - j) * LTP_ORDER + i];
            if (temp > ltp_gain_q14) {
                ltp_gain_q14 = temp;
                for (int i = 0; i < LTP_ORDER; i++)
                    t->plc_LTPCoef_Q14[i] =
                        B[(t->nb_subfr - 1 - j) * LTP_ORDER + i];
                t->plc_pitchL_Q8 = LSHIFT32(lag[t->nb_subfr - 1 - j], 8);
            }
        }
        for (int i = 0; i < LTP_ORDER; i++) t->plc_LTPCoef_Q14[i] = 0;
        t->plc_LTPCoef_Q14[LTP_ORDER / 2] = ltp_gain_q14;
        if (ltp_gain_q14 < V_PITCH_GAIN_START_MIN_Q14) {
            i32 sc = LSHIFT32(V_PITCH_GAIN_START_MIN_Q14, 10)
                / std::max(ltp_gain_q14, (i32)1);
            for (int i = 0; i < LTP_ORDER; i++)
                t->plc_LTPCoef_Q14[i] =
                    SMULBB(t->plc_LTPCoef_Q14[i], sc) >> 10;
        } else if (ltp_gain_q14 > V_PITCH_GAIN_START_MAX_Q14) {
            i32 sc = LSHIFT32(V_PITCH_GAIN_START_MAX_Q14, 14)
                / std::max(ltp_gain_q14, (i32)1);
            for (int i = 0; i < LTP_ORDER; i++)
                t->plc_LTPCoef_Q14[i] =
                    SMULBB(t->plc_LTPCoef_Q14[i], sc) >> 14;
        }
    } else {
        t->plc_pitchL_Q8 = LSHIFT32(SMULBB(t->fs_kHz, 18), 8);
        for (int i = 0; i < LTP_ORDER; i++) t->plc_LTPCoef_Q14[i] = 0;
    }
    for (int i = 0; i < t->LPC_order; i++)
        t->plc_prevLPC_Q12[i] = A1[i];
    t->plc_prevLTP_scale_Q14 = ltp_scale;
    t->plc_prevGain_Q16[0] = gains[t->nb_subfr - 2];
    t->plc_prevGain_Q16[1] = gains[t->nb_subfr - 1];
    t->plc_subfr_length = t->subfr_length;
    t->plc_nb_subfr = t->nb_subfr;
}

// silk_PLC_energy (:2957)
static void energy(PlcTrackerC* t, const i32 prev_gain_q10[2],
                   i32* e1, i32* s1, i32* e2, i32* s2) {
    int sl = t->subfr_length;
    i32 buf[2 * 120];
    for (int k = 0; k < 2; k++)
        for (int i = 0; i < sl; i++)
            buf[k * sl + i] = SAT16(SMULWW(
                t->exc_Q14[i + (k + t->nb_subfr - 2) * sl],
                prev_gain_q10[k]) >> 8);
    sum_sqr_shift(buf, sl, e1, s1);
    sum_sqr_shift(buf + sl, sl, e2, s2);
}

}  // namespace plc

extern "C" {

// Batched NLSF->LPC and prediction-gain helpers for the PLC/CNG host
// prep (silk_NLSF2A src/silk.cpp:642, silk_LPC_inverse_pred_gain
// :2359): the python conceal-prep path spends ~70% of its time in the
// scalar-python versions of these two; one call here converts a whole
// lost-set's worth in microseconds.
void silk_nlsf2a_batch_c(const i32* nlsf_q15 /* (n, MAX_LPC_ORDER) */,
                         int n, int order,
                         i32* a_q12_out /* (n, MAX_LPC_ORDER) */) {
    for (int i = 0; i < n; i++) {
        nlsf2a(nlsf_q15 + (size_t)i * MAX_LPC_ORDER, order,
               a_q12_out + (size_t)i * MAX_LPC_ORDER);
        for (int k = order; k < MAX_LPC_ORDER; k++)
            a_q12_out[(size_t)i * MAX_LPC_ORDER + k] = 0;
    }
}

void silk_lpc_inv_pred_gain_batch_c(const i32* a_q12, int n, int order,
                                    i32* gain_out /* (n,) */) {
    for (int i = 0; i < n; i++)
        gain_out[i] = lpc_inverse_pred_gain(
            a_q12 + (size_t)i * MAX_LPC_ORDER, order);
}

// apply_plc_transition + good-frame tracker ingest for one decoded
// frame (silk_decode_parameters :858 post-loss BWE, silk_decode_core
// :1871 voiced->unvoiced handoff, silk_PLC_update :2895, silk_CNG
// :1342 good branch). A/B/gains/inv/lag/flags are row pointers into
// the group buffers and are MUTATED for the post-loss transition
// exactly like the python path. misc: the 24-col row (signalType @0,
// lagPrev @3, LTP_scale @4, NLSF_Q15 @8..23). exc: frame_length.
void plc_trk_good_c(PlcTrackerC* t, i32* A, i32* B, i32* gains,
                    i32* inv, i32* lag, i32* flags, const i32* exc,
                    const i32* misc) {
    int order = t->LPC_order;
    i32 signal_type = misc[0];
    i32 lag_prev = misc[3];
    i32 ltp_scale = misc[4];
    const i32* nlsf = misc + 8;
    if (t->lossCnt) {
        for (int half = 0; half < 2; half++) {
            i32 a[MAX_LPC_ORDER];
            for (int k = 0; k < order; k++)
                a[k] = A[half * MAX_LPC_ORDER + k];
            bwexpander16(a, order, plc::BWE_AFTER_LOSS_Q16);
            for (int k = 0; k < order; k++)
                A[half * MAX_LPC_ORDER + k] = a[k];
        }
        if (t->prevSignalType == TYPE_VOICED
                && signal_type != TYPE_VOICED) {
            for (int k = 0; k < 2; k++) {
                for (int i = 0; i < LTP_ORDER; i++)
                    B[k * LTP_ORDER + i] = i == 2 ? 4096 : 0;
                flags[k] = 1;                       // voiced[k]
                lag[k] = t->lagPrev;
            }
            flags[4] = 1;                           // rewhiten[0]
            i32 iv = INVERSE32_varQ(gains[0], 47);
            inv[0] = LSHIFT32(SMULWB(iv, ltp_scale), 2);
        }
    }
    t->ind_signalType = signal_type;
    for (int i = 0; i < t->frame_length; i++) t->exc_Q14[i] = exc[i];
    if (t->fs_kHz != t->plc_fs_kHz) {
        plc::plc_reset(t);
        t->plc_fs_kHz = t->fs_kHz;
    }
    plc::update(t, gains, B, lag, A + MAX_LPC_ORDER, ltp_scale);
    t->lossCnt = 0;
    for (int i = 0; i < order; i++) t->prevNLSF_Q15[i] = nlsf[i];
    if (t->fs_kHz != t->cng_fs_kHz
            || t->prevSignalType == plc::TYPE_NO_VOICE_ACTIVITY) {
        // silk_CNG good-branch body (:1342)
        if (t->fs_kHz != t->cng_fs_kHz) {
            plc::cng_reset(t);
            t->cng_fs_kHz = t->fs_kHz;
        }
        if (t->prevSignalType == plc::TYPE_NO_VOICE_ACTIVITY) {
            for (int i = 0; i < order; i++)
                t->cng_smth_NLSF_Q15[i] += SMULWB(
                    t->prevNLSF_Q15[i] - t->cng_smth_NLSF_Q15[i],
                    plc::CNG_NLSF_SMTH_Q16);
            i32 max_gain = 0;
            int subfr = 0;
            for (int i = 0; i < t->nb_subfr; i++)
                if (gains[i] > max_gain) {
                    max_gain = gains[i];
                    subfr = i;
                }
            int sl = t->subfr_length;
            memmove(t->cng_exc_buf_Q14 + sl, t->cng_exc_buf_Q14,
                    (size_t)(t->nb_subfr - 1) * sl * sizeof(i32));
            memcpy(t->cng_exc_buf_Q14, t->exc_Q14 + subfr * sl,
                   (size_t)sl * sizeof(i32));
            for (int i = 0; i < t->nb_subfr; i++)
                t->cng_smth_Gain_Q16 += SMULWB(
                    gains[i] - t->cng_smth_Gain_Q16,
                    plc::CNG_GAIN_SMTH_Q16);
        }
    }
    for (int i = 0; i < MAX_LPC_ORDER; i++) t->cng_synth_state[i] = 0;
    t->prevSignalType = t->ind_signalType;
    t->first_frame_after_reset = 0;
    t->lagPrev = lag_prev;
}

// Batched good-frame ingest over selected group rows (the rfc_plc
// post-pass, stream_pool._rfc_silk_post): trks[j] handles buffer row
// rows[j]. frame_len = samples per device frame.
void plc_trk_good_batch_c(PlcTrackerC** trks, const i32* rows, int n,
                          i32* A, i32* B, i32* gains, i32* inv,
                          i32* lag, i32* flags, i32* exc, i32* misc,
                          int frame_len) {
    for (int j = 0; j < n; j++) {
        i32 r = rows[j];
        plc_trk_good_c(trks[j], A + (size_t)r * 2 * MAX_LPC_ORDER,
                       B + (size_t)r * MAX_NB_SUBFR * LTP_ORDER,
                       gains + (size_t)r * 4, inv + (size_t)r * 4,
                       lag + (size_t)r * 4, flags + (size_t)r * 12,
                       exc + (size_t)r * frame_len,
                       misc + (size_t)r * 24);
    }
}

// Conceal prep for one lost 20 (or 10) ms frame: the host half of
// silk_PLC_conceal (:2973) + silk_CNG (:1342 loss branch) — the
// rand-seed walk, per-subframe LTP decay and pitch drift, bandwidth
// expansion of the previous LPC, CNG excitation/gain. Mutates the
// tracker exactly like a scalar concealed frame and emits the device
// kernel inputs. scalars out: [inv_gain_q30, prev_gain_q10,
// cng_gain_q10, cng_first].
void plc_trk_conceal_prep_c(PlcTrackerC* t, i32* rand_q12, i32* A_out,
                            i32* B4, i32* lag4, i32* cng_exc,
                            i32* cng_a, i32* scalars) {
    int nb = t->nb_subfr, subfr = t->subfr_length, order = t->LPC_order;
    if (t->fs_kHz != t->plc_fs_kHz) {
        plc::plc_reset(t);
        t->plc_fs_kHz = t->fs_kHz;
    }
    t->ind_signalType = t->prevSignalType;
    i32 prev_gain_q10[2] = {t->plc_prevGain_Q16[0] >> 6,
                            t->plc_prevGain_Q16[1] >> 6};
    if (t->first_frame_after_reset)
        for (int i = 0; i < MAX_LPC_ORDER; i++) t->plc_prevLPC_Q12[i] = 0;
    i32 e1, s1, e2, s2;
    plc::energy(t, prev_gain_q10, &e1, &s1, &e2, &s2);
    int rand_off = ((e1 >> s2) < (e2 >> s1))
        ? std::max(0, (t->plc_nb_subfr - 1) * t->plc_subfr_length - 128)
        : std::max(0, t->plc_nb_subfr * t->plc_subfr_length - 128);
    i32 B[LTP_ORDER];
    for (int i = 0; i < LTP_ORDER; i++) B[i] = t->plc_LTPCoef_Q14[i];
    i32 rand_scale_q14 = t->plc_randScale_Q14;
    i32 harm = plc::HARM_ATT_Q15[std::min(1, t->lossCnt)];
    i32 rand_gain = (t->prevSignalType == TYPE_VOICED)
        ? plc::RAND_ATT_V_Q15[std::min(1, t->lossCnt)]
        : plc::RAND_ATT_UV_Q15[std::min(1, t->lossCnt)];
    bwexpander16(t->plc_prevLPC_Q12, order, plc::BWE_COEF_Q16);
    for (int i = 0; i < MAX_LPC_ORDER; i++)
        A_out[i] = i < order ? t->plc_prevLPC_Q12[i] : 0;
    if (t->lossCnt == 0) {
        rand_scale_q14 = 1 << 14;
        if (t->prevSignalType == TYPE_VOICED) {
            for (int i = 0; i < LTP_ORDER; i++) rand_scale_q14 -= B[i];
            rand_scale_q14 = std::max((i32)3277, rand_scale_q14);
            rand_scale_q14 = (i16)(SMULBB(
                rand_scale_q14, t->plc_prevLTP_scale_Q14) >> 14);
        } else {
            i32 ig = lpc_inverse_pred_gain(t->plc_prevLPC_Q12, order);
            i32 dn = std::min((i32)((1 << 30) >> 3), ig);
            dn = std::max((i32)((1 << 30) >> 8), dn);
            dn = LSHIFT32(dn, 3);
            rand_gain = SMULWB(dn, rand_gain) >> 14;
        }
    }
    i32 seed = t->plc_rand_seed;
    i32 lag = RSHIFT_ROUND(t->plc_pitchL_Q8, 8);
    for (int k = 0; k < nb; k++) {
        for (int i = 0; i < LTP_ORDER; i++) B4[k * LTP_ORDER + i] = B[i];
        lag4[k] = lag;
        for (int i = 0; i < subfr; i++) {
            seed = silk_RAND(seed);
            int idx2 = (seed >> 25) & 127;
            rand_q12[k * subfr + i] = (i32)(((i64)t->exc_Q14[
                rand_off + idx2] * (i16)rand_scale_q14) >> 16);
        }
        for (int i = 0; i < LTP_ORDER; i++)
            B[i] = SMULBB(harm, B[i]) >> 15;
        if (t->ind_signalType != plc::TYPE_NO_VOICE_ACTIVITY)
            rand_scale_q14 = SMULBB(rand_scale_q14, rand_gain) >> 15;
        t->plc_pitchL_Q8 = SMLAWB(t->plc_pitchL_Q8, t->plc_pitchL_Q8,
                                  plc::PITCH_DRIFT_FAC_Q16);
        t->plc_pitchL_Q8 = std::min(
            t->plc_pitchL_Q8, LSHIFT32(SMULBB(18, t->fs_kHz), 8));
        lag = RSHIFT_ROUND(t->plc_pitchL_Q8, 8);
    }
    i32 inv_gain = std::min(INVERSE32_varQ(t->plc_prevGain_Q16[1], 46),
                            (i32)(I32MAX >> 1));
    t->plc_rand_seed = seed;
    t->plc_randScale_Q14 = rand_scale_q14;
    for (int i = 0; i < LTP_ORDER; i++) t->plc_LTPCoef_Q14[i] = B[i];
    t->lagPrev = lag;
    if (t->fs_kHz != t->cng_fs_kHz) {
        plc::cng_reset(t);
        t->cng_fs_kHz = t->fs_kHz;
    }
    i32 first_loss = t->lossCnt == 0;
    i32 gain_q16 = SMULWW(t->plc_randScale_Q14, t->plc_prevGain_Q16[1]);
    if (gain_q16 >= (1 << 21) || t->cng_smth_Gain_Q16 > (1 << 23)) {
        gain_q16 = plc::SMULTT(gain_q16, gain_q16);
        gain_q16 = (i32)((u32)plc::SMULTT(t->cng_smth_Gain_Q16,
                                          t->cng_smth_Gain_Q16)
                         - (u32)LSHIFT32(gain_q16, 5));
        gain_q16 = LSHIFT32(plc::SQRT_APPROX(gain_q16), 16);
    } else {
        gain_q16 = SMULWW(gain_q16, gain_q16);
        gain_q16 = (i32)((u32)SMULWW(t->cng_smth_Gain_Q16,
                                     t->cng_smth_Gain_Q16)
                         - (u32)LSHIFT32(gain_q16, 5));
        gain_q16 = LSHIFT32(plc::SQRT_APPROX(gain_q16), 8);
    }
    i32 gain_q10 = gain_q16 >> 6;
    i32 mask = 255;
    while (mask > t->frame_length) mask >>= 1;
    i32 cs = t->cng_rand_seed;
    for (int i = 0; i < t->frame_length; i++) {
        cs = silk_RAND(cs);
        cng_exc[i] = t->cng_exc_buf_Q14[(cs >> 24) & mask];
    }
    t->cng_rand_seed = cs;
    nlsf2a(t->cng_smth_NLSF_Q15, order, cng_a);
    for (int i = order; i < MAX_LPC_ORDER; i++) cng_a[i] = 0;
    t->lossCnt += 1;
    t->plc_last_frame_lost = 1;
    t->LastGainIndex = 10;
    scalars[0] = inv_gain;
    scalars[1] = prev_gain_q10[1];
    scalars[2] = gain_q10;
    scalars[3] = first_loss;
}

}  // extern "C"
