// PCM routing of a CELT lane's window frame (models/stream_pool.py::
// _CeltLane.cut): the card hands each frame back transposed, (CC, N, n)
// int16 with the streams contiguous, and the pool hands every stream its
// own chunk, (samples, CC) with the channels interleaved. Stream s's
// sample t of channel c sits n int16 after its sample t - 1, so a copy a
// stream at a time reads one cache line a sample (4 KB apart at n 2048,
// every line of a stream in the same L1 set).
//
// pcm_cut_T cuts the frame in one pass instead: 8 consecutive streams at
// a time, in blocks of 8 samples read along the stream axis (a 16-byte
// load a channel and sample) and written along the sample axis (one
// store a stream), tiles of TILE_GROUPS x 8 streams by TILE_BLOCKS x 8
// samples. Rows that are not 8 consecutive streams, and the samples of a
// row outside its group's common whole blocks, go a sample at a time.
// The tile is one block (8 samples) deep: tiles of 256-2048 streams by 8
// samples cut a 2048-stream stereo frame in 6.3-7.1 ms on an H100
// machine's host CPU, tiles 16-64 samples deep in 10.3-16.0 ms (PERF.md,
// section 6).

#include <algorithm>
#include <cstdint>

#ifdef __AVX2__
#include <immintrin.h>
#endif

using i16 = int16_t;
using i32 = int32_t;
using i64 = int64_t;

namespace {

constexpr int TILE_GROUPS = 64;   // groups of 8 streams a tile
constexpr int TILE_BLOCKS = 1;    // blocks of 8 samples a tile

// stream s's samples [a, b) into dst, dst[0] being sample `lo`
template <int CC>
void row_scalar(const i16* f, i64 cs, i64 n, i64 s, int a, int b, int lo,
                i16* dst) {
    for (int t = a; t < b; t++)
        for (int c = 0; c < CC; c++)
            dst[(t - lo) * CC + c] = f[c * cs + t * n + s];
}

#ifdef __AVX2__
// an 8 x 8 transpose of 32-bit lanes
inline void transpose8x8(__m256i r[8]) {
    __m256i a[8], b[8];
    for (int k = 0; k < 8; k += 2) {
        a[k] = _mm256_unpacklo_epi32(r[k], r[k + 1]);
        a[k + 1] = _mm256_unpackhi_epi32(r[k], r[k + 1]);
    }
    for (int k = 0; k < 8; k += 4) {
        b[k] = _mm256_unpacklo_epi64(a[k], a[k + 2]);
        b[k + 1] = _mm256_unpackhi_epi64(a[k], a[k + 2]);
        b[k + 2] = _mm256_unpacklo_epi64(a[k + 1], a[k + 3]);
        b[k + 3] = _mm256_unpackhi_epi64(a[k + 1], a[k + 3]);
    }
    for (int k = 0; k < 4; k++) {
        r[k] = _mm256_permute2x128_si256(b[k], b[k + 4], 0x20);
        r[k + 4] = _mm256_permute2x128_si256(b[k], b[k + 4], 0x31);
    }
}

// 8 samples of the 8 streams at src (the first stream's first sample,
// channel 0) into dst[k], stream k's first of them
template <int CC>
inline void block8(const i16* src, i64 n, i64 cs, i16* const* dst);

template <>
inline void block8<2>(const i16* src, i64 n, i64 cs, i16* const* dst) {
    // a sample's L and R side by side as one 32-bit lane a stream
    __m256i r[8];
    for (int k = 0; k < 8; k++) {
        const i16* p = src + k * n;
        __m128i L = _mm_loadu_si128((const __m128i*)p);
        __m128i R = _mm_loadu_si128((const __m128i*)(p + cs));
        r[k] = _mm256_set_m128i(_mm_unpackhi_epi16(L, R),
                                _mm_unpacklo_epi16(L, R));
    }
    transpose8x8(r);
    for (int k = 0; k < 8; k++)
        _mm256_storeu_si256((__m256i*)dst[k], r[k]);
}

template <>
inline void block8<1>(const i16* src, i64 n, i64, i16* const* dst) {
    __m128i r[8], a[8], b[8];
    for (int k = 0; k < 8; k++)
        r[k] = _mm_loadu_si128((const __m128i*)(src + k * n));
    for (int k = 0; k < 8; k += 2) {
        a[k] = _mm_unpacklo_epi16(r[k], r[k + 1]);
        a[k + 1] = _mm_unpackhi_epi16(r[k], r[k + 1]);
    }
    for (int k = 0; k < 8; k += 4) {
        b[k] = _mm_unpacklo_epi32(a[k], a[k + 2]);
        b[k + 1] = _mm_unpackhi_epi32(a[k], a[k + 2]);
        b[k + 2] = _mm_unpacklo_epi32(a[k + 1], a[k + 3]);
        b[k + 3] = _mm_unpackhi_epi32(a[k + 1], a[k + 3]);
    }
    for (int k = 0; k < 4; k++) {
        r[2 * k] = _mm_unpacklo_epi64(b[k], b[k + 4]);
        r[2 * k + 1] = _mm_unpackhi_epi64(b[k], b[k + 4]);
    }
    for (int k = 0; k < 8; k++)
        _mm_storeu_si128((__m128i*)dst[k], r[k]);
}
#else
template <int CC>
inline void block8(const i16* src, i64 n, i64 cs, i16* const* dst) {
    for (int k = 0; k < 8; k++)
        for (int u = 0; u < 8; u++)
            for (int c = 0; c < CC; c++)
                dst[k][u * CC + c] = src[c * cs + u * n + k];
}
#endif

// tile i: rows [g0, g1) = [8 * TILE_GROUPS * i, ...) of the m
template <int CC>
void cut_tile(const i16* f, int N, i64 n, const i64* sel, const i32* lo,
              const i32* te, const i64* off, i16* out, int m, int i) {
    const i64 cs = (i64)N * n;
    const int g0 = 8 * TILE_GROUPS * i;
    const int g1 = std::min(m, g0 + 8 * TILE_GROUPS);
    // group q's whole blocks, [A[q], A[q] + 8 * nb[q]); the rest of its
    // rows a sample at a time
    int A[TILE_GROUPS], nb[TILE_GROUPS], most = 0;
    for (int g = g0, q = 0; g < g1; g += 8, q++) {
        int rows = std::min(8, g1 - g), a = 0, b = N;
        bool run = rows == 8;
        for (int k = 1; run && k < 8; k++)
            run = sel[g + k] == sel[g] + k;
        for (int k = 0; k < rows; k++) {
            a = std::max(a, lo[g + k]);
            b = std::min(b, N - te[g + k]);
        }
        nb[q] = run && b > a ? (b - a) / 8 : 0;
        A[q] = a;
        most = std::max(most, nb[q]);
        for (int r = g; r < g + rows; r++) {
            int l = lo[r], h = N - te[r];
            i16* dst = out + off[r] * CC;
            if (nb[q] == 0) {
                row_scalar<CC>(f, cs, n, sel[r], l, h, l, dst);
                continue;
            }
            row_scalar<CC>(f, cs, n, sel[r], l, A[q], l, dst);
            row_scalar<CC>(f, cs, n, sel[r], A[q] + 8 * nb[q], h, l, dst);
        }
    }
    for (int k0 = 0; k0 < most; k0 += TILE_BLOCKS) {
        for (int g = g0, q = 0; g < g1; g += 8, q++) {
            int k1 = std::min(nb[q], k0 + TILE_BLOCKS);
            if (k0 >= k1)
                continue;
            // row r's sample t sits at out + (off[r] + t - lo[r]) * CC
            int t = A[q] + 8 * k0;
            i16* dst[8];
            for (int k = 0; k < 8; k++)
                dst[k] = out + (off[g + k] + t - lo[g + k]) * CC;
            const i16* src = f + t * n + sel[g];
            for (int blk = k0; blk < k1; blk++) {
                block8<CC>(src, n, cs, dst);
                src += 8 * n;
                for (int k = 0; k < 8; k++)
                    dst[k] += 8 * CC;
            }
        }
    }
}

}  // namespace

extern "C" {

// Cut rows sel[0..m) of one transposed frame (CC, N, n) int16 (CC 1 or
// 2, C-contiguous): row j's samples [lo[j], N - te[j]) of stream sel[j],
// channels interleaved, one row after another into out. off[j] is where
// row j starts in out and off[m] the total, in samples of CC int16 each;
// a row with lo[j] + te[j] >= N is empty. lo and te are >= 0 and sel's
// streams lie in [0, n): the caller checks. Returns off[m].
i64 pcm_cut_T(const i16* frame, int CC, int N, int n, const i64* sel,
              const i32* lo, const i32* te, int m, i16* out, i64* off) {
    i64 o = 0;
    for (int j = 0; j < m; j++) {
        off[j] = o;
        o += std::max(0, N - te[j] - lo[j]);
    }
    off[m] = o;
    for (int i = 0; 8 * TILE_GROUPS * i < m; i++) {
        if (CC == 1)
            cut_tile<1>(frame, N, n, sel, lo, te, off, out, m, i);
        else
            cut_tile<2>(frame, N, n, sel, lo, te, off, out, m, i);
    }
    return o;
}

}  // extern "C"
