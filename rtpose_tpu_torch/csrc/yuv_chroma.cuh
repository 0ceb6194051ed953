// What the tiled colour kernels of swscale's general path share
// (yuv420p10_to_bgr.cu, yuv420_full_chroma_to_bgr.cu, yuv_planar_to_bgr.cu):
// the output rules of a pixel pair (yuv2bgr24_X / yuv2bgr24_1 and the C
// tables) and of a full-chroma pixel (yuv2rgb_write_full), and the chroma
// rows a tile's taps reach, staged into shared memory by cp.async in
// 16-byte windows and filtered horizontally from there.
#pragma once

#include <stdint.h>

#include "yuv_rule.cuh"
#include "yuv_tile.cuh"

// the C tables (yuv2rgb_X_c's bgr24): the value at luma index k, and the
// move of chroma index c through coefficient q
__device__ __forceinline__ int table_bgr(int k, const YuvRule& r) {
    return sat8((k * r.cy + r.y_base + 0x8000) >> 16);
}

__device__ __forceinline__ int table_term(int c, int q) {
    c = c < 0 ? 0 : (c > 255 ? 255 : c);
    return ((c * q) >> 16) - (q >> 9);
}

// a pixel pair (luma y0, y1 in the 15-bit intermediate) from its chroma
// sums: above the last two rows (simd) the MMX rule, su and sv the
// chroma + 1024 (yuv2bgr24_X: 4 + the high halves of the vertical sum,
// lift 4; yuv2bgr24_1: C15 >> 4, lift 0); on them the C tables, su and sv
// (1 << 18) + the sums
__device__ __forceinline__ void general_pair(int y0, int y1, bool simd,
                                             int lift, int su, int sv,
                                             const YuvRule& rule,
                                             uint32_t& w0, uint32_t& w1) {
    if (simd) {
        su -= 1024;
        sv -= 1024;
        const int b = (su * rule.ub) >> 16;
        const int g = ((su * rule.ug) >> 16) + ((sv * rule.vg) >> 16);
        const int r = (sv * rule.vr) >> 16;
        const int l0 = ((lift + (y0 >> 4) - rule.y_offset) * rule.luma) >> 16;
        const int l1 = ((lift + (y1 >> 4) - rule.y_offset) * rule.luma) >> 16;
        w0 = bgr_word(sat8(l0 + b), sat8(l0 + g), sat8(l0 + r));
        w1 = bgr_word(sat8(l1 + b), sat8(l1 + g), sat8(l1 + r));
        return;
    }
    const int ui = su >> 19, vi = sv >> 19;
    const int b = table_term(ui, rule.bu);
    const int g = table_term(ui, rule.gu) + table_term(vi, rule.gv);
    const int r = table_term(vi, rule.rv);
    const int l0 = ((y0 << 12) + (1 << 18)) >> 19;
    const int l1 = ((y1 << 12) + (1 << 18)) >> 19;
    w0 = bgr_word(table_bgr(l0 + b, rule), table_bgr(l0 + g, rule),
                  table_bgr(l0 + r, rule));
    w1 = bgr_word(table_bgr(l1 + b, rule), table_bgr(l1 + g, rule),
                  table_bgr(l1 + r, rule));
}

// v clipped to [0, 2^30) (av_clip_uintp2(v, 30)), then its top eight bits
__device__ __forceinline__ int full_out(int v) {
    return (v < 0 ? 0 : (v > (1 << 30) - 1 ? (1 << 30) - 1 : v)) >> 22;
}

// a pixel from its 15-bit luma and its chroma sums (yuv2rgb_write_full):
// 32-bit unsigned arithmetic read back as int, so a bright pixel of
// strong chroma wraps to 0 as in swscale
__device__ __forceinline__ uint32_t full_pixel(int y15, int su, int sv,
                                               const YuvRule& rule) {
    // Y = ((1 << 9) + (Y15 << 12)) >> 10: the low ten bits of Y15 << 12
    // are 0, so the rounding term drops out
    const int yy = y15 << 2;
    const uint32_t l = (uint32_t)((yy - (rule.y_offset << 6)) * rule.luma
                                  + (1 << 21));
    const uint32_t U = (uint32_t)(su >> 10), V = (uint32_t)(sv >> 10);
    return bgr_word(full_out((int)(l + U * (uint32_t)rule.ub)),
                    full_out((int)(l + V * (uint32_t)rule.vg
                                   + U * (uint32_t)rule.ug)),
                    full_out((int)(l + V * (uint32_t)rule.vr)));
}

// the 16 bytes at the 16-byte-aligned w into shared memory at dst: one
// asynchronous copy (cp.async, no registers on the way) where they lie
// inside [lo, hi), else the bytes that do, one at a time (zero elsewhere)
__device__ __forceinline__ void stage_window(uint4* dst, const uint8_t* w,
                                             const uint8_t* lo,
                                             const uint8_t* hi) {
    if (w >= lo && w + 16 <= hi) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                     :: "r"((uint32_t)__cvta_generic_to_shared(dst)),
                        "l"(w)
                     : "memory");
        return;
    }
    uint32_t b[4] = {0, 0, 0, 0};
#pragma unroll
    for (int k = 0; k < 16; ++k)
        if (w + k >= lo && w + k < hi)
            b[k >> 2] |= (uint32_t)w[k] << (8 * (k & 3));
    *dst = make_uint4(b[0], b[1], b[2], b[3]);
}

// Stage chroma rows [first, first + rows) of U and V (bases ub, vb, the
// plane's bytes [base, base + plane_bytes)), samples [xa, xa + span) of
// S bytes each, into `staged`: row r of plane p from the 16-byte window
// that holds its sample xa on, ROW_WINDOWS windows a row at staged + (p *
// ROWS + r) * ROW_WINDOWS, all copies in flight together; then wait for
// this thread's copies (the caller synchronises the block)
template <int S, int ROWS, int ROW_WINDOWS, int THREADS>
__device__ __forceinline__ void stage_rows(uint4* staged, const uint8_t* ub,
                                           const uint8_t* vb, int c_pitch,
                                           int first, int rows, int xa,
                                           int span, size_t plane_bytes) {
    constexpr int STAGED = 2 * ROWS * ROW_WINDOWS;
    constexpr int ITERS = (STAGED + THREADS - 1) / THREADS;
#pragma unroll
    for (int i = 0; i < ITERS; ++i) {
        const int j = threadIdx.x + i * THREADS;
        const int p = j / (ROWS * ROW_WINDOWS), r = j / ROW_WINDOWS % ROWS;
        if (j < STAGED && r < rows) {
            const uint8_t* base = p ? vb : ub;
            const uint8_t* at =
                base + ((size_t)(first + r) * c_pitch + xa) * S;
            const uint8_t* w = reinterpret_cast<const uint8_t*>(
                (uintptr_t)at & ~(uintptr_t)15) + 16 * (j % ROW_WINDOWS);
            if (w < at + span * S)
                stage_window(staged + j, w, base, base + plane_bytes);
        }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// sample xa of staged row r of plane p (base its plane, as staged)
template <int S, int ROWS, int ROW_WINDOWS>
__device__ __forceinline__ const uint8_t* staged_row(const uint4* staged,
                                                     const uint8_t* base,
                                                     int c_pitch, int first,
                                                     int r, int p, int xa) {
    const uintptr_t at = (uintptr_t)base
                         + ((size_t)(first + r) * c_pitch + xa) * S;
    return reinterpret_cast<const uint8_t*>(staged)
           + 16 * (p * ROWS + r) * ROW_WINDOWS + (int)(at & 15);
}

// swscale's horizontal filter into the 15-bit intermediate on staged
// samples s of S bytes: min(sum_k s[k] * taps[k] >> shift, 32767), over
// the first hsize of MAXH taps
template <int S, int MAXH>
__device__ __forceinline__ int filter_staged(const uint8_t* s,
                                             const int* taps, int hsize,
                                             int shift) {
    int h = 0;
#pragma unroll
    for (int k = 0; k < MAXH; ++k) {
        if (k < hsize) {
            const int c = S == 1
                ? (int)s[k]
                : (int)reinterpret_cast<const uint16_t*>(s)[k];
            h += c * taps[k];
        }
    }
    return min(h >> shift, 32767);
}

// word c of row r of a tile's filtered chroma at every source column:
// 16-byte groups of the second 32 columns of a straight tile swapped in
// pairs, so that the eight threads of a source row read eight banks
// groups apart
template <bool QUARTER>
__device__ __forceinline__ int chroma_slot(int r, int c) {
    constexpr int PITCH = (QUARTER ? TILE_ROWS : TILE_COLS) + 4;
    return r * PITCH + (QUARTER ? c : c ^ ((c >> 5 & 1) << 2));
}

// The general path's output of a thread's PIXELS pixels of one source row
// (PIXELS / 2 pairs, luma in the words `luma`, samples of type T) from a
// tile's filtered chroma of pixel pairs (rows PITCH words apart, cu and cv
// at its row's first tap row and its first pair): the vertical sum its
// row's rule needs once a pair over the first vsize of MAXV taps (simd,
// above the last two rows: 4 + the high halves; else (1 << 18) + the
// sums), then the pair's words into px
template <typename T, int PITCH, int MAXV, int PIXELS>
__device__ __forceinline__ void general_pairs(const int* cu, const int* cv,
                                              bool simd, const int* taps,
                                              int vsize,
                                              const uint32_t* luma,
                                              int yshift,
                                              const YuvRule& rule,
                                              uint32_t* px) {
#pragma unroll
    for (int q = 0; q < PIXELS / 2; ++q) {
        int su, sv;
        if (simd) {
            su = sv = 4;
#pragma unroll
            for (int t = 0; t < MAXV; ++t) {
                if (t < vsize) {
                    su += (cu[t * PITCH + q] * taps[t]) >> 16;
                    sv += (cv[t * PITCH + q] * taps[t]) >> 16;
                }
            }
        } else {
            su = sv = 1 << 18;
#pragma unroll
            for (int t = 0; t < MAXV; ++t) {
                if (t < vsize) {
                    su += cu[t * PITCH + q] * taps[t];
                    sv += cv[t * PITCH + q] * taps[t];
                }
            }
        }
        general_pair(sample_of<T>(luma, 2 * q) << yshift,
                     sample_of<T>(luma, 2 * q + 1) << yshift, simd, 4, su,
                     sv, rule, px[2 * q], px[2 * q + 1]);
    }
}

// The full-chroma output of a thread's PIXELS pixels of one source row
// (luma in the words `luma`, samples of type T) from a tile's filtered
// chroma at every source column (chroma_slot; cu and cv the planes, r its
// row's first tap row, col its first column): the vertical sums at full
// precision over the first vsize of MAXV taps, four pixels at a time with
// 16-byte reads, then yuv2rgb_write_full into px
template <typename T, bool QUARTER, int MAXV, int PIXELS>
__device__ __forceinline__ void full_pixels(const int* cu, const int* cv,
                                            int r, int col, const int* taps,
                                            int vsize, const uint32_t* luma,
                                            int yshift, const YuvRule& rule,
                                            uint32_t* px) {
#pragma unroll
    for (int h = 0; h < PIXELS; h += 4) {
        int su[4], sv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) su[q] = sv[q] = (1 << 9) - (128 << 19);
#pragma unroll
        for (int t = 0; t < MAXV; ++t) {
            if (t < vsize) {
                const int at = chroma_slot<QUARTER>(r + t, col + h);
                const int4 a = *reinterpret_cast<const int4*>(cu + at);
                const int4 b = *reinterpret_cast<const int4*>(cv + at);
                su[0] += a.x * taps[t];
                su[1] += a.y * taps[t];
                su[2] += a.z * taps[t];
                su[3] += a.w * taps[t];
                sv[0] += b.x * taps[t];
                sv[1] += b.y * taps[t];
                sv[2] += b.z * taps[t];
                sv[3] += b.w * taps[t];
            }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
            px[h + q] = full_pixel(sample_of<T>(luma, h + q) << yshift,
                                   su[q], sv[q], rule);
    }
}
