"""CELT band decoding: energy envelope, bit allocation, and the recursive
band quantization tree (the symbol-heavy host phase of a CELT frame).

Mirrors the reference band layer (reference src/celt.cpp):
  unquant_coarse/fine/finalise energy :3613-3700, tf_decode :2128,
  init_caps :911, clt_compute_allocation :3523, interp_bits2pulses :3298,
  bits2pulses/pulses2bits inlines src/celt.h:537-569,
  compute_qn/compute_theta :1202-1378, quant_band(_n1/_stereo) :1382-1752,
  quant_partition :1422, quant_all_bands :1754-1924,
  haar1/hadamard/stereo helpers :1010-1200.

Everything here consumes range-decoder symbols interleaved with band math,
so it is inherently sequential per stream: this is the host half of the
host/device split (SURVEY.md §7.1). The output is the normalized spectrum X
(int16 Q14 per channel) plus collapse masks — the inputs to the dense device
phase in ops/celt/synthesis.py.

The port's copy of esp32_opus_player_tpu/ops/celt/bands.py (numpy and
Python ints; nothing of the JAX package is imported).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..fixed_point import (ADD16, MAC16_16, MULT16_16, MULT16_16_P15,
                           MULT16_16_Q15, MULT16_16_16, PSHR32, SHL16, SHR16,
                           SHR32, SUB16, VSHR32, celt_sudiv, celt_udiv, s16,
                           s32)
from ...host.range_decoder import RangeDecoder, laplace_decode
from ..tables.celt_tables import (LOG2_FRAC_TABLE, band_allocation, beta_coef,
                                  cache_bits50, cache_caps50, cache_index50,
                                  e_prob_model, eband5ms, eMeans, logN400,
                                  ordery_table, small_energy_icdf,
                                  tf_select_table)
from .math import (DB_SHIFT, bitexact_cos, bitexact_log2tan, celt_ilog2,
                   celt_lcg_rand, celt_sqrt, isqrt32)
from . import pvq

BITRES = 3
NB_EBANDS = 21
EFF_EBANDS = 21
MAX_PSEUDO = 40
LOG_MAX_PSEUDO = 6
MAX_FINE_BITS = 8
FINE_OFFSET = 21
QTHETA_OFFSET = 4
QTHETA_OFFSET_TWOPHASE = 16
ALLOC_STEPS = 6
NORM_SCALING = 16384
SPREAD_AGGRESSIVE = 3
BETA_INTRA = 4915
PRED_COEF = (29440, 26112, 21248, 16384)

_EBANDS = [int(x) for x in eband5ms]
_CACHE_INDEX = [int(x) for x in cache_index50]
_CACHE_BITS = [int(x) for x in cache_bits50]
_ALLOC = band_allocation.astype(np.int64)
_LOGN = [int(x) for x in logN400]
_ORDERY = [int(x) for x in ordery_table]


# ---------------------------------------------------------------------------
# energy envelope
# ---------------------------------------------------------------------------

def unquant_coarse_energy(dec: RangeDecoder, start: int, end: int,
                          oldEBands, intra: int, C: int, LM: int) -> None:
    """Laplace-coded coarse band energies (src/celt.cpp:3613)."""
    prob_model = e_prob_model[LM][intra]
    if intra:
        coef = 0
        beta = BETA_INTRA
    else:
        beta = int(beta_coef[LM])
        coef = PRED_COEF[LM]
    budget = dec.storage * 8
    prev = [0, 0]
    for i in range(start, end):
        for c in range(C):
            tell = dec.tell()
            if budget - tell >= 15:
                pi = 2 * min(i, 20)
                qi = laplace_decode(dec, int(prob_model[pi]) << 7,
                                    int(prob_model[pi + 1]) << 6)
            elif budget - tell >= 2:
                qi = dec.dec_icdf(small_energy_icdf, 2)
                qi = (qi >> 1) ^ -(qi & 1)
            elif budget - tell >= 1:
                qi = -dec.dec_bit_logp(1)
            else:
                qi = -1
            q = s32(qi << DB_SHIFT)
            old = max(-(9 << DB_SHIFT), int(oldEBands[i + c * NB_EBANDS]))
            tmp = PSHR32(MULT16_16(coef, old), 8) + prev[c] + s32(q << 7)
            tmp = max(-(28 << (DB_SHIFT + 7)), tmp)
            oldEBands[i + c * NB_EBANDS] = s16(PSHR32(tmp, 7))
            prev[c] = prev[c] + s32(q << 7) - MULT16_16(beta, PSHR32(q, 8))


def unquant_fine_energy(dec: RangeDecoder, start: int, end: int, oldEBands,
                        fine_quant, C: int) -> None:
    for i in range(start, end):
        if fine_quant[i] <= 0:
            continue
        for c in range(C):
            q2 = dec.dec_bits(fine_quant[i])
            offset = SUB16(SHR32(s32(q2 << DB_SHIFT) + 512, fine_quant[i]),
                           512)
            oldEBands[i + c * NB_EBANDS] = s16(
                int(oldEBands[i + c * NB_EBANDS]) + offset)


def unquant_energy_finalise(dec: RangeDecoder, start: int, end: int,
                            oldEBands, fine_quant, fine_priority,
                            bits_left: int, C: int) -> None:
    for prio in range(2):
        i = start
        while i < end and bits_left >= C:
            if fine_quant[i] >= MAX_FINE_BITS or fine_priority[i] != prio:
                i += 1
                continue
            for c in range(C):
                q2 = dec.dec_bits(1)
                offset = SHR16(SHL16(q2, DB_SHIFT) - 512, fine_quant[i] + 1)
                oldEBands[i + c * NB_EBANDS] = s16(
                    int(oldEBands[i + c * NB_EBANDS]) + offset)
                bits_left -= 1
            i += 1


# ---------------------------------------------------------------------------
# time-frequency resolution
# ---------------------------------------------------------------------------

def tf_decode(dec: RangeDecoder, start: int, end: int, isTransient: int,
              tf_res, LM: int) -> None:
    """(src/celt.cpp:2128)"""
    budget = dec.storage * 8
    tell = dec.tell()
    logp = 2 if isTransient else 4
    tf_select_rsv = 1 if (LM > 0 and tell + logp + 1 <= budget) else 0
    budget -= tf_select_rsv
    tf_changed = curr = 0
    for i in range(start, end):
        if tell + logp <= budget:
            curr ^= dec.dec_bit_logp(logp)
            tell = dec.tell()
            tf_changed |= curr
        tf_res[i] = curr
        logp = 4 if isTransient else 5
    tf_select = 0
    if tf_select_rsv and \
            tf_select_table[LM][4 * isTransient + 0 + tf_changed] != \
            tf_select_table[LM][4 * isTransient + 2 + tf_changed]:
        tf_select = dec.dec_bit_logp(1)
    for i in range(start, end):
        tf_res[i] = int(tf_select_table[LM][4 * isTransient + 2 * tf_select
                                            + tf_res[i]])


# ---------------------------------------------------------------------------
# bit allocation
# ---------------------------------------------------------------------------

def init_caps(LM: int, C: int):
    cap = [0] * NB_EBANDS
    for i in range(NB_EBANDS):
        N = (_EBANDS[i + 1] - _EBANDS[i]) << LM
        cap[i] = (int(cache_caps50[NB_EBANDS * (2 * LM + C - 1) + i])
                  + 64) * C * N >> 2
    return cap


def bits2pulses(band: int, LM: int, bits: int) -> int:
    LM += 1
    cache = _CACHE_INDEX[LM * NB_EBANDS + band]
    lo = 0
    hi = _CACHE_BITS[cache]
    bits -= 1
    for _ in range(LOG_MAX_PSEUDO):
        mid = (lo + hi + 1) >> 1
        if _CACHE_BITS[cache + mid] >= bits:
            hi = mid
        else:
            lo = mid
    if bits - (-1 if lo == 0 else _CACHE_BITS[cache + lo]) <= \
            _CACHE_BITS[cache + hi] - bits:
        return lo
    return hi


def pulses2bits(band: int, LM: int, pulses: int) -> int:
    LM += 1
    cache = _CACHE_INDEX[LM * NB_EBANDS + band]
    return 0 if pulses == 0 else _CACHE_BITS[cache + pulses] + 1


def get_pulses(i: int) -> int:
    return i if i < 8 else (8 + (i & 7)) << ((i >> 3) - 1)


def interp_bits2pulses(dec: RangeDecoder, start, end, skip_start, bits1,
                       bits2, thresh, cap, total, skip_rsv, intensity_rsv,
                       dual_stereo_rsv, bits, ebits, fine_priority, C, LM):
    """(src/celt.cpp:3298) — decode side only."""
    alloc_floor = C << BITRES
    stereo = 1 if C > 1 else 0
    logM = LM << BITRES
    lo = 0
    hi = 1 << ALLOC_STEPS
    for _ in range(ALLOC_STEPS):
        mid = (lo + hi) >> 1
        psum = 0
        done = 0
        for j in range(end - 1, start - 1, -1):
            tmp = bits1[j] + (mid * bits2[j] >> ALLOC_STEPS)
            if tmp >= thresh[j] or done:
                done = 1
                psum += min(tmp, cap[j])
            elif tmp >= alloc_floor:
                psum += alloc_floor
        if psum > total:
            hi = mid
        else:
            lo = mid
    psum = 0
    done = 0
    for j in range(end - 1, start - 1, -1):
        tmp = bits1[j] + (lo * bits2[j] >> ALLOC_STEPS)
        if tmp < thresh[j] and not done:
            tmp = alloc_floor if tmp >= alloc_floor else 0
        else:
            done = 1
        tmp = min(tmp, cap[j])
        bits[j] = tmp
        psum += tmp

    codedBands = end
    while True:
        j = codedBands - 1
        if j <= skip_start:
            total += skip_rsv
            break
        left = total - psum
        percoeff = celt_udiv(left, _EBANDS[codedBands] - _EBANDS[start])
        left -= (_EBANDS[codedBands] - _EBANDS[start]) * percoeff
        rem = max(left - (_EBANDS[j] - _EBANDS[start]), 0)
        band_width = _EBANDS[codedBands] - _EBANDS[j]
        band_bits = bits[j] + percoeff * band_width + rem
        if band_bits >= max(thresh[j], alloc_floor + (1 << BITRES)):
            if dec.dec_bit_logp(1):
                break
            psum += 1 << BITRES
            band_bits -= 1 << BITRES
        psum -= bits[j] + intensity_rsv
        if intensity_rsv > 0:
            intensity_rsv = int(LOG2_FRAC_TABLE[j - start])
        psum += intensity_rsv
        if band_bits >= alloc_floor:
            psum += alloc_floor
            bits[j] = alloc_floor
        else:
            bits[j] = 0
        codedBands -= 1

    assert codedBands > start
    if intensity_rsv > 0:
        intensity = start + dec.dec_uint(codedBands + 1 - start)
    else:
        intensity = 0
    if intensity <= start:
        total += dual_stereo_rsv
        dual_stereo_rsv = 0
    if dual_stereo_rsv > 0:
        dual_stereo = dec.dec_bit_logp(1)
    else:
        dual_stereo = 0

    left = total - psum
    percoeff = celt_udiv(left, _EBANDS[codedBands] - _EBANDS[start])
    left -= (_EBANDS[codedBands] - _EBANDS[start]) * percoeff
    for j in range(start, codedBands):
        bits[j] += percoeff * (_EBANDS[j + 1] - _EBANDS[j])
    for j in range(start, codedBands):
        tmp = min(left, _EBANDS[j + 1] - _EBANDS[j])
        bits[j] += tmp
        left -= tmp

    balance = 0
    for j in range(start, codedBands):
        N0 = _EBANDS[j + 1] - _EBANDS[j]
        N = N0 << LM
        bit = bits[j] + balance
        if N > 1:
            excess = max(bit - cap[j], 0)
            bits[j] = bit - excess
            den = C * N + (1 if (C == 2 and N > 2 and not dual_stereo
                                 and j < intensity) else 0)
            NClogN = den * (_LOGN[j] + logM)
            offset = (NClogN >> 1) - den * FINE_OFFSET
            if N == 2:
                offset += den << BITRES >> 2
            if bits[j] + offset < den * 2 << BITRES:
                offset += NClogN >> 2
            elif bits[j] + offset < den * 3 << BITRES:
                offset += NClogN >> 3
            ebits[j] = max(0, bits[j] + offset + (den << (BITRES - 1)))
            ebits[j] = celt_udiv(ebits[j], den) >> BITRES
            if C * ebits[j] > (bits[j] >> BITRES):
                ebits[j] = bits[j] >> stereo >> BITRES
            ebits[j] = min(ebits[j], MAX_FINE_BITS)
            fine_priority[j] = 1 if ebits[j] * (den << BITRES) >= \
                bits[j] + offset else 0
            bits[j] -= C * ebits[j] << BITRES
        else:
            excess = max(0, bit - (C << BITRES))
            bits[j] = bit - excess
            ebits[j] = 0
            fine_priority[j] = 1
        if excess > 0:
            extra_fine = min(excess >> (stereo + BITRES),
                             MAX_FINE_BITS - ebits[j])
            ebits[j] += extra_fine
            extra_bits = extra_fine * C << BITRES
            fine_priority[j] = 1 if extra_bits >= excess - balance else 0
            excess -= extra_bits
        balance = excess

    for j in range(codedBands, end):
        ebits[j] = bits[j] >> stereo >> BITRES
        bits[j] = 0
        fine_priority[j] = 1 if ebits[j] < 1 else 0

    return codedBands, intensity, dual_stereo, balance


def clt_compute_allocation(dec: RangeDecoder, start, end, offsets, cap,
                           alloc_trim, total, C, LM):
    """(src/celt.cpp:3523) — decode side."""
    total = max(total, 0)
    skip_start = start
    skip_rsv = (1 << BITRES) if total >= (1 << BITRES) else 0
    total -= skip_rsv
    intensity_rsv = dual_stereo_rsv = 0
    if C == 2:
        intensity_rsv = int(LOG2_FRAC_TABLE[end - start])
        if intensity_rsv > total:
            intensity_rsv = 0
        else:
            total -= intensity_rsv
            dual_stereo_rsv = (1 << BITRES) if total >= (1 << BITRES) else 0
            total -= dual_stereo_rsv

    thresh = [0] * NB_EBANDS
    trim_offset = [0] * NB_EBANDS
    bits1 = [0] * NB_EBANDS
    bits2 = [0] * NB_EBANDS
    for j in range(start, end):
        thresh[j] = max(C << BITRES,
                        (3 * (_EBANDS[j + 1] - _EBANDS[j]) << LM
                         << BITRES) >> 4)
        trim_offset[j] = (C * (_EBANDS[j + 1] - _EBANDS[j])
                          * (alloc_trim - 5 - LM) * (end - j - 1)
                          * (1 << (LM + BITRES))) >> 6
        if (_EBANDS[j + 1] - _EBANDS[j]) << LM == 1:
            trim_offset[j] -= C << BITRES

    lo = 1
    hi = 11 - 1
    while lo <= hi:
        done = 0
        psum = 0
        mid = (lo + hi) >> 1
        for j in range(end - 1, start - 1, -1):
            N = _EBANDS[j + 1] - _EBANDS[j]
            bitsj = int(C * N * _ALLOC[mid * NB_EBANDS + j]) << LM >> 2
            if bitsj > 0:
                bitsj = max(0, bitsj + trim_offset[j])
            bitsj += offsets[j]
            if bitsj >= thresh[j] or done:
                done = 1
                psum += min(bitsj, cap[j])
            elif bitsj >= C << BITRES:
                psum += C << BITRES
        if psum > total:
            hi = mid - 1
        else:
            lo = mid + 1
    hi = lo
    lo -= 1
    for j in range(start, end):
        N = _EBANDS[j + 1] - _EBANDS[j]
        bits1j = int(C * N * _ALLOC[lo * NB_EBANDS + j]) << LM >> 2
        bits2j = cap[j] if hi >= 11 else \
            int(C * N * _ALLOC[hi * NB_EBANDS + j]) << LM >> 2
        if bits1j > 0:
            bits1j = max(0, bits1j + trim_offset[j])
        if bits2j > 0:
            bits2j = max(0, bits2j + trim_offset[j])
        if lo > 0:
            bits1j += offsets[j]
        bits2j += offsets[j]
        if offsets[j] > 0:
            skip_start = j
        bits2j = max(0, bits2j - bits1j)
        bits1[j] = bits1j
        bits2[j] = bits2j

    pulses = [0] * NB_EBANDS
    ebits = [0] * NB_EBANDS
    fine_priority = [0] * NB_EBANDS
    codedBands, intensity, dual_stereo, balance = interp_bits2pulses(
        dec, start, end, skip_start, bits1, bits2, thresh, cap, total,
        skip_rsv, intensity_rsv, dual_stereo_rsv, pulses, ebits,
        fine_priority, C, LM)
    return (codedBands, intensity, dual_stereo, balance, pulses, ebits,
            fine_priority)


# ---------------------------------------------------------------------------
# band-shape helpers
# ---------------------------------------------------------------------------

def haar1(X, off: int, N0: int, stride: int) -> None:
    N0 >>= 1
    for i in range(stride):
        for j in range(N0):
            a = off + stride * 2 * j + i
            b = off + stride * (2 * j + 1) + i
            tmp1 = MULT16_16(23170, int(X[a]))
            tmp2 = MULT16_16(23170, int(X[b]))
            X[a] = s16(PSHR32(tmp1 + tmp2, 15))
            X[b] = s16(PSHR32(tmp1 - tmp2, 15))


def deinterleave_hadamard(X, off: int, N0: int, stride: int,
                          hadamard: int) -> None:
    N = N0 * stride
    tmp = np.empty(N, dtype=X.dtype)
    if hadamard:
        ordery = _ORDERY[stride - 2:]
        for i in range(stride):
            for j in range(N0):
                tmp[ordery[i] * N0 + j] = X[off + j * stride + i]
    else:
        for i in range(stride):
            for j in range(N0):
                tmp[i * N0 + j] = X[off + j * stride + i]
    X[off:off + N] = tmp


def interleave_hadamard(X, off: int, N0: int, stride: int,
                        hadamard: int) -> None:
    N = N0 * stride
    tmp = np.empty(N, dtype=X.dtype)
    if hadamard:
        ordery = _ORDERY[stride - 2:]
        for i in range(stride):
            for j in range(N0):
                tmp[j * stride + i] = X[off + ordery[i] * N0 + j]
    else:
        for i in range(stride):
            for j in range(N0):
                tmp[j * stride + i] = X[off + i * N0 + j]
    X[off:off + N] = tmp


def stereo_merge(X, Y, xoff: int, yoff: int, mid: int, N: int) -> None:
    from ..fixed_point import MULT16_32_Q15
    xp, side = pvq.dual_inner_prod(Y[yoff:yoff + N], X[xoff:xoff + N],
                                   Y[yoff:yoff + N], N)
    xp = MULT16_32_Q15(mid, xp)
    mid2 = SHR16(mid, 1)
    El = MULT16_16(mid2, mid2) + side - 2 * xp
    Er = MULT16_16(mid2, mid2) + side + 2 * xp
    if Er < 161061 or El < 161061:  # QCONST32(6e-4f, 28)
        Y[yoff:yoff + N] = X[xoff:xoff + N]
        return
    kl = celt_ilog2(El) >> 1
    kr = celt_ilog2(Er) >> 1
    from .math import celt_rsqrt_norm
    t = VSHR32(El, (kl - 7) << 1)
    lgain = celt_rsqrt_norm(t)
    t = VSHR32(Er, (kr - 7) << 1)
    rgain = celt_rsqrt_norm(t)
    if kl < 7:
        kl = 7
    if kr < 7:
        kr = 7
    for j in range(N):
        l = MULT16_16_P15(mid, int(X[xoff + j]))
        r = int(Y[yoff + j])
        X[xoff + j] = s16(PSHR32(MULT16_16(lgain, SUB16(l, r)), kl + 1))
        Y[yoff + j] = s16(PSHR32(MULT16_16(rgain, ADD16(l, r)), kr + 1))


def special_hybrid_folding(norm, norm2, start: int, M: int,
                           dual_stereo: int) -> None:
    n1 = M * (_EBANDS[start + 1] - _EBANDS[start])
    n2 = M * (_EBANDS[start + 2] - _EBANDS[start + 1])
    norm[n1:n2] = norm[2 * n1 - n2:n1]
    if dual_stereo:
        norm2[n1:n2] = norm2[2 * n1 - n2:n1]


# ---------------------------------------------------------------------------
# the recursive band quantizer
# ---------------------------------------------------------------------------

@dataclass
class BandCtx:
    dec: RangeDecoder = None
    i: int = 0
    intensity: int = 0
    spread: int = 0
    tf_change: int = 0
    remaining_bits: int = 0
    seed: int = 0
    disable_inv: int = 0
    resynth: int = 1
    avoid_split_noise: int = 0
    theta_round: int = 0


def compute_qn(N: int, b: int, offset: int, pulse_cap: int,
               stereo: int) -> int:
    exp2_table8 = (16384, 17866, 19483, 21247, 23170, 25267, 27554, 30048)
    N2 = 2 * N - 1
    if stereo and N == 2:
        N2 -= 1
    qb = celt_sudiv(b + N2 * offset, N2)
    qb = min(b - pulse_cap - (4 << BITRES), qb)
    qb = min(8 << BITRES, qb)
    if qb < (1 << BITRES >> 1):
        qn = 1
    else:
        qn = exp2_table8[qb & 0x7] >> (14 - (qb >> BITRES))
        qn = (qn + 1) >> 1 << 1
    assert qn <= 256
    return qn


def compute_theta(ctx: BandCtx, N: int, b: int, B: int, B0: int, LM: int,
                  stereo: int, fill: int):
    """(src/celt.cpp:1241). Returns (b, fill, inv, imid, iside, delta,
    itheta, qalloc)."""
    dec = ctx.dec
    i = ctx.i
    intensity = ctx.intensity
    inv = 0
    itheta = 0

    pulse_cap = _LOGN[i] + LM * (1 << BITRES)
    offset = (pulse_cap >> 1) - (QTHETA_OFFSET_TWOPHASE
                                 if stereo and N == 2 else QTHETA_OFFSET)
    qn = compute_qn(N, b, offset, pulse_cap, stereo)
    if stereo and i >= intensity:
        qn = 1
    tell = dec.tell_frac()
    if qn != 1:
        if stereo and N > 2:
            p0 = 3
            x0 = qn // 2
            ft = p0 * (x0 + 1) + x0
            fs = dec.decode(ft)
            if fs < (x0 + 1) * p0:
                x = fs // p0
            else:
                x = x0 + 1 + (fs - (x0 + 1) * p0)
            dec.update(p0 * x if x <= x0 else (x - 1 - x0) + (x0 + 1) * p0,
                       p0 * (x + 1) if x <= x0 else (x - x0) + (x0 + 1) * p0,
                       ft)
            itheta = x
        elif B0 > 1 or stereo:
            itheta = dec.dec_uint(qn + 1)
        else:
            ft = ((qn >> 1) + 1) * ((qn >> 1) + 1)
            fm = dec.decode(ft)
            if fm < ((qn >> 1) * ((qn >> 1) + 1) >> 1):
                itheta = (isqrt32(8 * fm + 1) - 1) >> 1
                fs = itheta + 1
                fl = itheta * (itheta + 1) >> 1
            else:
                itheta = (2 * (qn + 1) - isqrt32(8 * (ft - fm - 1) + 1)) >> 1
                fs = qn + 1 - itheta
                fl = ft - ((qn + 1 - itheta) * (qn + 2 - itheta) >> 1)
            dec.update(fl, fl + fs, ft)
        assert itheta >= 0
        itheta = celt_udiv(itheta * 16384, qn)
    elif stereo:
        if b > 2 << BITRES and ctx.remaining_bits > 2 << BITRES:
            inv = dec.dec_bit_logp(2)
        else:
            inv = 0
        if ctx.disable_inv:
            inv = 0
        itheta = 0
    qalloc = dec.tell_frac() - tell
    b -= qalloc

    if itheta == 0:
        imid = 32767
        iside = 0
        fill &= (1 << B) - 1
        delta = -16384
    elif itheta == 16384:
        imid = 0
        iside = 32767
        fill &= ((1 << B) - 1) << B
        delta = 16384
    else:
        imid = bitexact_cos(itheta)
        iside = bitexact_cos(16384 - itheta)
        delta = FRAC_MUL16_((N - 1) << 7, bitexact_log2tan(iside, imid))
    return b, fill, inv, imid, iside, delta, itheta, qalloc


def FRAC_MUL16_(a: int, b: int) -> int:
    from ..fixed_point import FRAC_MUL16
    return FRAC_MUL16(a, b)


def quant_band_n1(ctx: BandCtx, X, xoff, Y, yoff, b: int,
                  lowband_out) -> int:
    """(src/celt.cpp:1358)"""
    dec = ctx.dec
    stereo = Y is not None
    bufs = [(X, xoff)] + ([(Y, yoff)] if stereo else [])
    for buf, off in bufs:
        sign = 0
        if ctx.remaining_bits >= 1 << BITRES:
            sign = dec.dec_bits(1)
            ctx.remaining_bits -= 1 << BITRES
            b -= 1 << BITRES
        if ctx.resynth:
            buf[off] = -NORM_SCALING if sign else NORM_SCALING
    if lowband_out is not None:
        arr, off = lowband_out
        arr[off] = SHR16(int(X[xoff]), 4)
    return 1


def quant_partition(ctx: BandCtx, X, xoff: int, N: int, b: int, B: int,
                    lowband, LM: int, gain: int, fill: int) -> int:
    """(src/celt.cpp:1422). lowband is (array, offset) or None."""
    dec = ctx.dec
    i = ctx.i
    spread = ctx.spread
    B0 = B
    cm = 0

    cache = _CACHE_INDEX[(LM + 1) * NB_EBANDS + i]
    if LM != -1 and b > _CACHE_BITS[cache + _CACHE_BITS[cache]] + 12 \
            and N > 2:
        N >>= 1
        yoff = xoff + N
        LM -= 1
        if B == 1:
            fill = (fill & 1) | (fill << 1)
        B = (B + 1) >> 1

        b, fill, _inv, imid, iside, delta, itheta, qalloc = compute_theta(
            ctx, N, b, B, B0, LM, 0, fill)
        mid = imid
        side = iside
        if B0 > 1 and (itheta & 0x3FFF):
            if itheta > 8192:
                delta -= delta >> (4 - LM)
            else:
                delta = min(0, delta + (N << BITRES >> (5 - LM)))
        mbits = max(0, min(b, celt_sudiv(b - delta, 2)))
        sbits = b - mbits
        ctx.remaining_bits -= qalloc

        next_lowband2 = None
        if lowband is not None:
            next_lowband2 = (lowband[0], lowband[1] + N)

        rebalance = ctx.remaining_bits
        if mbits >= sbits:
            cm = quant_partition(ctx, X, xoff, N, mbits, B, lowband, LM,
                                 MULT16_16_P15(gain, mid), fill)
            rebalance = mbits - (rebalance - ctx.remaining_bits)
            if rebalance > 3 << BITRES and itheta != 0:
                sbits += rebalance - (3 << BITRES)
            cm |= quant_partition(ctx, X, yoff, N, sbits, B, next_lowband2,
                                  LM, MULT16_16_P15(gain, side),
                                  fill >> B) << (B0 >> 1)
        else:
            cm = quant_partition(ctx, X, yoff, N, sbits, B, next_lowband2,
                                 LM, MULT16_16_P15(gain, side),
                                 fill >> B) << (B0 >> 1)
            rebalance = sbits - (rebalance - ctx.remaining_bits)
            if rebalance > 3 << BITRES and itheta != 16384:
                mbits += rebalance - (3 << BITRES)
            cm |= quant_partition(ctx, X, xoff, N, mbits, B, lowband, LM,
                                  MULT16_16_P15(gain, mid), fill)
    else:
        q = bits2pulses(i, LM, b)
        curr_bits = pulses2bits(i, LM, q)
        ctx.remaining_bits -= curr_bits
        while ctx.remaining_bits < 0 and q > 0:
            ctx.remaining_bits += curr_bits
            q -= 1
            curr_bits = pulses2bits(i, LM, q)
            ctx.remaining_bits -= curr_bits

        if q != 0:
            K = get_pulses(q)
            cm = pvq.alg_unquant(dec, X[xoff:xoff + N], N, K, spread, B,
                                 gain)
        else:
            if ctx.resynth:
                cm_mask = (1 << B) - 1
                fill &= cm_mask
                if not fill:
                    X[xoff:xoff + N] = 0
                else:
                    if lowband is None:
                        for j in range(N):
                            ctx.seed = celt_lcg_rand(ctx.seed)
                            X[xoff + j] = s16(s32(ctx.seed) >> 20)
                        cm = cm_mask
                    else:
                        lb, lboff = lowband
                        for j in range(N):
                            ctx.seed = celt_lcg_rand(ctx.seed)
                            tmp = 4  # QCONST16(1/256., 10)
                            tmp = tmp if (ctx.seed & 0x8000) else -tmp
                            X[xoff + j] = s16(int(lb[lboff + j]) + tmp)
                        cm = fill
                    pvq.renormalise_vector(X[xoff:xoff + N], N, gain)
    return cm


_BIT_INTERLEAVE = (0, 1, 1, 1, 2, 3, 3, 3, 2, 3, 3, 3, 2, 3, 3, 3)
_BIT_DEINTERLEAVE = (0x00, 0x03, 0x0C, 0x0F, 0x30, 0x33, 0x3C, 0x3F,
                     0xC0, 0xC3, 0xCC, 0xCF, 0xF0, 0xF3, 0xFC, 0xFF)


def quant_band(ctx: BandCtx, X, xoff: int, N: int, b: int, B: int, lowband,
               LM: int, lowband_out, gain: int, lowband_scratch,
               fill: int) -> int:
    """(src/celt.cpp:1526). lowband/lowband_out/lowband_scratch are
    (array, offset) tuples or None."""
    N0 = N
    N_B = N
    B0 = B
    time_divide = 0
    recombine = 0
    longBlocks = 1 if B0 == 1 else 0
    tf_change = ctx.tf_change

    N_B = celt_udiv(N_B, B)

    if N == 1:
        return quant_band_n1(ctx, X, xoff, None, 0, b, lowband_out)

    if tf_change > 0:
        recombine = tf_change

    if lowband_scratch is not None and lowband is not None and \
            (recombine or ((N_B & 1) == 0 and tf_change < 0) or B0 > 1):
        ls, lsoff = lowband_scratch
        lb, lboff = lowband
        ls[lsoff:lsoff + N] = lb[lboff:lboff + N]
        lowband = (ls, lsoff)

    lb = lowband
    for k in range(recombine):
        if lb is not None:
            haar1(lb[0], lb[1], N >> k, 1 << k)
        fill = _BIT_INTERLEAVE[fill & 0xF] | \
            (_BIT_INTERLEAVE[fill >> 4] << 2)
    B >>= recombine
    N_B <<= recombine

    while (N_B & 1) == 0 and tf_change < 0:
        if lb is not None:
            haar1(lb[0], lb[1], N_B, B)
        fill |= fill << B
        B <<= 1
        N_B >>= 1
        time_divide += 1
        tf_change += 1
    B0 = B
    N_B0 = N_B

    if B0 > 1 and lb is not None:
        deinterleave_hadamard(lb[0], lb[1], N_B >> recombine,
                              B0 << recombine, longBlocks)

    cm = quant_partition(ctx, X, xoff, N, b, B, lb, LM, gain, fill)

    if ctx.resynth:
        if B0 > 1:
            interleave_hadamard(X, xoff, N_B >> recombine, B0 << recombine,
                                longBlocks)
        N_B = N_B0
        B = B0
        for _ in range(time_divide):
            B >>= 1
            N_B <<= 1
            cm |= cm >> B
            haar1(X, xoff, N_B, B)
        for k in range(recombine):
            cm = _BIT_DEINTERLEAVE[cm]
            haar1(X, xoff, N0 >> k, 1 << k)
        B <<= recombine

        if lowband_out is not None:
            n = celt_sqrt(s32(N0 << 22))
            lo, looff = lowband_out
            for j in range(N0):
                lo[looff + j] = MULT16_16_Q15(n, int(X[xoff + j]))
        cm &= (1 << B) - 1
    return cm


def quant_band_stereo(ctx: BandCtx, X, xoff: int, Y, yoff: int, N: int,
                      b: int, B: int, lowband, LM: int, lowband_out,
                      lowband_scratch, fill: int) -> int:
    """(src/celt.cpp:1632)"""
    dec = ctx.dec
    cm = 0
    if N == 1:
        return quant_band_n1(ctx, X, xoff, Y, yoff, b, lowband_out)

    orig_fill = fill
    b, fill, inv, imid, iside, delta, itheta, qalloc = compute_theta(
        ctx, N, b, B, B, LM, 1, fill)
    mid = imid
    side = iside

    if N == 2:
        mbits = b
        sbits = 0
        if itheta != 0 and itheta != 16384:
            sbits = 1 << BITRES
        mbits -= sbits
        c = 1 if itheta > 8192 else 0
        ctx.remaining_bits -= qalloc + sbits

        if c:
            x2, x2off, y2, y2off = Y, yoff, X, xoff
        else:
            x2, x2off, y2, y2off = X, xoff, Y, yoff
        sign = 0
        if sbits:
            sign = dec.dec_bits(1)
        sign = 1 - 2 * sign
        cm = quant_band(ctx, x2, x2off, N, mbits, B, lowband, LM,
                        lowband_out, 32767, lowband_scratch, orig_fill)
        y2[y2off] = -sign * int(x2[x2off + 1])
        y2[y2off + 1] = sign * int(x2[x2off])
        if ctx.resynth:
            X[xoff] = MULT16_16_Q15(mid, int(X[xoff]))
            X[xoff + 1] = MULT16_16_Q15(mid, int(X[xoff + 1]))
            Y[yoff] = MULT16_16_Q15(side, int(Y[yoff]))
            Y[yoff + 1] = MULT16_16_Q15(side, int(Y[yoff + 1]))
            tmp = int(X[xoff])
            X[xoff] = SUB16(tmp, int(Y[yoff]))
            Y[yoff] = ADD16(tmp, int(Y[yoff]))
            tmp = int(X[xoff + 1])
            X[xoff + 1] = SUB16(tmp, int(Y[yoff + 1]))
            Y[yoff + 1] = ADD16(tmp, int(Y[yoff + 1]))
    else:
        mbits = max(0, min(b, celt_sudiv(b - delta, 2)))
        sbits = b - mbits
        ctx.remaining_bits -= qalloc
        rebalance = ctx.remaining_bits
        if mbits >= sbits:
            cm = quant_band(ctx, X, xoff, N, mbits, B, lowband, LM,
                            lowband_out, 32767, lowband_scratch, fill)
            rebalance = mbits - (rebalance - ctx.remaining_bits)
            if rebalance > 3 << BITRES and itheta != 0:
                sbits += rebalance - (3 << BITRES)
            cm |= quant_band(ctx, Y, yoff, N, sbits, B, None, LM, None,
                             side, None, fill >> B)
        else:
            cm = quant_band(ctx, Y, yoff, N, sbits, B, None, LM, None,
                            side, None, fill >> B)
            rebalance = sbits - (rebalance - ctx.remaining_bits)
            if rebalance > 3 << BITRES and itheta != 16384:
                mbits += rebalance - (3 << BITRES)
            cm |= quant_band(ctx, X, xoff, N, mbits, B, lowband, LM,
                             lowband_out, 32767, lowband_scratch, fill)
    if ctx.resynth:
        if N != 2:
            stereo_merge(X, Y, xoff, yoff, mid, N)
        if inv:
            for j in range(N):
                Y[yoff + j] = -int(Y[yoff + j])
    return cm


def quant_all_bands(dec: RangeDecoder, start: int, end: int, X_, C: int,
                    collapse_masks, pulses, shortBlocks: int, spread: int,
                    dual_stereo: int, intensity: int, tf_res,
                    total_bits: int, balance: int, LM: int,
                    codedBands: int, seed: int, disable_inv: int) -> int:
    """(src/celt.cpp:1754). X_ is the full C*N frame buffer (1-D numpy array
    holding int16-range Q14 values); channel 1 lives at offset N like the
    reference (Y_ = X_ + N). Returns the updated noise seed."""
    M = 1 << LM
    N_frame = M * 120  # shortMdctSize: channel-1 offset within X_ (Y_=X_+N)
    B = M if shortBlocks else 1
    norm_offset = M * _EBANDS[start]
    norm_total = M * _EBANDS[NB_EBANDS - 1] - norm_offset
    _norm = np.zeros(C * norm_total, dtype=np.int64)
    norm = _norm
    norm2_off = norm_total

    # decode uses the tail of X_ as scratch (src/celt.cpp:1795)
    lowband_scratch = (X_, M * _EBANDS[NB_EBANDS - 1])

    lowband_offset = 0
    update_lowband = 1
    ctx = BandCtx(dec=dec, intensity=intensity, spread=spread, seed=seed,
                  disable_inv=disable_inv, resynth=1,
                  avoid_split_noise=1 if B > 1 else 0)
    for i in range(start, end):
        ctx.i = i
        last = 1 if i == end - 1 else 0
        xoff = M * _EBANDS[i]
        yoff = N_frame + M * _EBANDS[i]
        N = M * _EBANDS[i + 1] - M * _EBANDS[i]
        tell = dec.tell_frac()

        if i != start:
            balance -= tell
        remaining_bits = total_bits - tell - 1
        ctx.remaining_bits = remaining_bits
        if i <= codedBands - 1:
            curr_balance = celt_sudiv(balance, min(3, codedBands - i))
            b = max(0, min(16383, min(remaining_bits + 1,
                                      pulses[i] + curr_balance)))
        else:
            b = 0

        if (M * _EBANDS[i] - N >= M * _EBANDS[start] or i == start + 1) and \
                (update_lowband or lowband_offset == 0):
            lowband_offset = i
        if i == start + 1:
            special_hybrid_folding(
                norm, norm[norm2_off:] if C == 2 else None, start, M,
                dual_stereo)

        tf_change = tf_res[i]
        ctx.tf_change = tf_change
        X = X_
        Y = X_ if C == 2 else None
        cur_scratch = lowband_scratch
        if i >= EFF_EBANDS:  # dead for the single 48k mode (effEBands == 21)
            X = norm
            xoff = yoff = 0
            Y = norm if C == 2 else None
            cur_scratch = None
        if last:
            cur_scratch = None

        if lowband_offset != 0 and (spread != SPREAD_AGGRESSIVE or B > 1
                                    or tf_change < 0):
            effective_lowband = max(0, M * _EBANDS[lowband_offset]
                                    - norm_offset - N)
            # do-while semantics: always step once, keep stepping while true
            fold_start = lowband_offset - 1
            while M * _EBANDS[fold_start] > effective_lowband + norm_offset:
                fold_start -= 1
            fold_end = lowband_offset
            while fold_end < i and M * _EBANDS[fold_end] < \
                    effective_lowband + norm_offset + N:
                fold_end += 1
            x_cm = y_cm = 0
            for fold_i in range(fold_start, fold_end):
                x_cm |= int(collapse_masks[fold_i * C + 0])
                y_cm |= int(collapse_masks[fold_i * C + C - 1])
        else:
            effective_lowband = -1
            x_cm = y_cm = (1 << B) - 1

        if dual_stereo and i == intensity:
            dual_stereo = 0
            for j in range(M * _EBANDS[i] - norm_offset):
                norm[j] = (int(norm[j]) + int(norm[norm2_off + j])) >> 1

        if dual_stereo:
            lb = (norm, effective_lowband) if effective_lowband != -1 \
                else None
            lb2 = (norm, norm2_off + effective_lowband) \
                if effective_lowband != -1 else None
            lo1 = None if last else (norm, M * _EBANDS[i] - norm_offset)
            lo2 = None if last else (norm,
                                     norm2_off + M * _EBANDS[i]
                                     - norm_offset)
            x_cm = quant_band(ctx, X, xoff, N, b // 2, B, lb, LM, lo1,
                              32767, cur_scratch, x_cm)
            y_cm = quant_band(ctx, Y, yoff, N, b // 2, B, lb2, LM, lo2,
                              32767, cur_scratch, y_cm)
        else:
            lb = (norm, effective_lowband) if effective_lowband != -1 \
                else None
            lo1 = None if last else (norm, M * _EBANDS[i] - norm_offset)
            if Y is not None:
                ctx.theta_round = 0
                x_cm = quant_band_stereo(ctx, X, xoff, Y, yoff, N, b, B,
                                         lb, LM, lo1, cur_scratch,
                                         x_cm | y_cm)
            else:
                x_cm = quant_band(ctx, X, xoff, N, b, B, lb, LM, lo1,
                                  32767, cur_scratch, x_cm | y_cm)
            y_cm = x_cm
        collapse_masks[i * C + 0] = x_cm & 0xFF
        collapse_masks[i * C + C - 1] = y_cm & 0xFF
        balance += pulses[i] + tell
        update_lowband = 1 if b > (N << BITRES) else 0
        ctx.avoid_split_noise = 0
    return ctx.seed
