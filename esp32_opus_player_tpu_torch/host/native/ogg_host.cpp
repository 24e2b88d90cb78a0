// Native Ogg page scanner: capture-pattern sync + slice-by-8 CRC32 +
// header field extraction for a whole buffer in ONE call — the live
// ingest path for a 10k-stream farm (the pure-Python per-byte CRC loop
// tops out around 2 MB/s; this does GB/s-class scanning).
//
// Behavior mirrors the reference page sync (reference src/ogg.cpp):
//   * scan for "OggS" (ogg_sync_pageseek, :839-923)
//   * version must be 0; CRC over the page with a zeroed crc field,
//     poly 0x04c11db7 unreflected (crc_lookup, :26-265, generation
//     :439-458) — mismatch drops ONE byte and rescans, counting skips
//   * an incomplete page at the buffer tail stops the scan so a
//     streaming caller can append more bytes
#include <cstdint>
#include <cstring>

using u8 = uint8_t;
using u32 = uint32_t;
using i32 = int32_t;
using i64 = int64_t;

namespace {

u32 crc_tab[8][256];
bool crc_init_done = false;

void crc_init() {
    if (crc_init_done) return;
    for (u32 i = 0; i < 256; i++) {
        u32 r = i << 24;
        for (int k = 0; k < 8; k++)
            r = (r & 0x80000000u) ? (r << 1) ^ 0x04c11db7u : (r << 1);
        crc_tab[0][i] = r;
    }
    // slice-by-8 derived tables: tab[n][b] = shift tab[n-1][b] one byte
    for (int n = 1; n < 8; n++)
        for (u32 i = 0; i < 256; i++)
            crc_tab[n][i] = (crc_tab[n - 1][i] << 8)
                ^ crc_tab[0][crc_tab[n - 1][i] >> 24];
    crc_init_done = true;
}

inline u32 crc_update(u32 crc, const u8* p, i64 n) {
    while (n >= 8) {
        crc ^= (u32)p[0] << 24 | (u32)p[1] << 16 | (u32)p[2] << 8 | p[3];
        crc = crc_tab[7][crc >> 24] ^ crc_tab[6][(crc >> 16) & 0xff]
            ^ crc_tab[5][(crc >> 8) & 0xff] ^ crc_tab[4][crc & 0xff]
            ^ crc_tab[3][p[4]] ^ crc_tab[2][p[5]]
            ^ crc_tab[1][p[6]] ^ crc_tab[0][p[7]];
        p += 8;
        n -= 8;
    }
    while (n-- > 0)
        crc = (crc << 8) ^ crc_tab[0][(crc >> 24) ^ *p++];
    return crc;
}

inline u32 rd32(const u8* p) {
    return (u32)p[0] | (u32)p[1] << 8 | (u32)p[2] << 16 | (u32)p[3] << 24;
}

}  // namespace

extern "C" {

// CRC32 of a raw buffer (exposed for tests / page regeneration).
u32 ogg_crc32_c(const u8* data, i64 len) {
    crc_init();
    return crc_update(0, data, len);
}

// Scan buf[0:len) for complete, CRC-valid Ogg pages.
// Per page i the outputs receive:
//   offs[i]   byte offset of the page start
//   hdr[i]    header length (27 + nsegs)
//   body[i]   body length
//   gps[i]    granule position (int64)
//   serial[i] serialno; pageno[i]; flags[i] header-type byte
// Returns the number of pages found (<= max_pages). *consumed is set to
// the offset where scanning stopped (start of an incomplete page, or
// len); *skipped counts garbage bytes dropped.
i32 ogg_page_scan(const u8* buf, i64 len, i64* offs, i32* hdr, i32* body,
                  i64* gps, i32* serial, i32* pageno, i32* flags,
                  i32 max_pages, i64* consumed, i64* skipped) {
    crc_init();
    i64 pos = 0;
    i64 skip = 0;
    i32 n = 0;
    while (n < max_pages) {
        // find the capture pattern
        const u8* hit = (const u8*)memchr(buf + pos, 'O', (size_t)(len - pos));
        while (hit) {
            i64 off = hit - buf;
            if (off + 4 > len) { hit = nullptr; break; }
            if (hit[1] == 'g' && hit[2] == 'g' && hit[3] == 'S') break;
            hit = (const u8*)memchr(hit + 1, 'O', (size_t)(len - off - 1));
        }
        if (!hit) {
            // no capture: drop everything except a possible partial
            // pattern in the last 3 bytes
            i64 keep = len >= 3 ? 3 : len;
            if (len - keep > pos) {
                skip += (len - keep) - pos;
                pos = len - keep;
            }
            break;
        }
        i64 off = hit - buf;
        skip += off - pos;
        pos = off;
        if (pos + 27 > len) break;              // incomplete header
        const u8* h = buf + pos;
        i32 nsegs = h[26];
        i64 hlen = 27 + nsegs;
        if (pos + hlen > len) break;            // incomplete lacing
        i64 blen = 0;
        for (i32 k = 0; k < nsegs; k++) blen += h[27 + k];
        if (pos + hlen + blen > len) break;     // incomplete body
        // version + CRC check (crc field zeroed during computation)
        u32 want = rd32(h + 22);
        u32 crc = crc_update(0, h, 22);
        static const u8 z4[4] = {0, 0, 0, 0};
        crc = crc_update(crc, z4, 4);
        crc = crc_update(crc, h + 26, hlen - 26 + blen);
        if (h[4] != 0 || crc != want) {
            pos += 1;                            // bad page: drop one byte
            skip += 1;
            continue;
        }
        offs[n] = pos;
        hdr[n] = (i32)hlen;
        body[n] = (i32)blen;
        gps[n] = (i64)rd32(h + 6) | ((i64)(i32)rd32(h + 10) << 32);
        serial[n] = (i32)rd32(h + 14);
        pageno[n] = (i32)rd32(h + 18);
        flags[n] = h[5];
        n++;
        pos += hlen + blen;
    }
    *consumed = pos;
    *skipped = skip;
    return n;
}

}  // extern "C"
