// The chroma formats other than 4:2:0 (4:2:2, 4:4:0, 4:4:4 and 4:0:0), and
// 4:2:0 of 12 bits, to 8-bit BGR with a quarter turn, hand-written for
// Hopper: the card's counterpart of what cv2.VideoCapture does with a
// decoded frame of a camera's intra format (H.264 High 4:2:2, HEVC RExt),
// a screen recorder's VP9 profile 1 / 3, monochrome HEVC or HEVC Main 12.
// Planes Y, U and V of 8-bit (uint8) or 10- / 12-bit (uint16) samples,
// each with its own row pitch.
//
// Replaces no TPU kernel.  The JAX demo reads video through cv2
// (rtpose_tpu/demo/video_demo.py:19-27), whose swscale converts each
// decoded frame; the port decodes on the host (native/avcodec.py) and
// converts here.  Four entries, one a path of swscale's
// (ops/kernels.py frame_route), each equal to its plain version in
// ops/kernels.py and, through it, to libswscale and cv2 5.0's frames at
// every pixel of random fields at each format, depth, size parity,
// chroma location and (matrix, range) tried (tests/test_torch_chroma_
// formats.py); D is the depth (8, 10 or 12), Y15 = Y << (15 - D) the
// luma in swscale's 15-bit intermediate (an identity filter):
//
// - rtpose_yuv422_to_bgr: 8-bit 4:2:2 of an even height, swscale's
//   unscaled yuv422p -> bgr24; yuv420_to_bgr.cu's rule with each luma
//   row its own chroma row (chroma by nearest sample, of the pixel pair),
//   in that kernel's tile (yuv_unscaled.cuh, chroma row sy where 4:2:0
//   reads sy >> 1).
// - rtpose_yuv_planar_general_to_bgr: the scaling path at SWS_BICUBIC at
//   an even width, chroma shared by each pixel pair (2c, 2c + 1):
//   1. each chroma row filtered horizontally to the pairs,
//      C15[r][c] = min(sum_k C[r][hpos[c] + k] * htap[c][k] >> (D - 1),
//      32767), with swscale's 14-bit taps (4:2:2 and 4:2:0: one, or four
//      bicubic ones where the chroma location shifts it; 4:4:0: its 2x
//      bicubic down-filter, eight taps);
//   2. each output row sy takes vsize chroma rows vpos[sy] + t with 12-bit
//      taps vtap[sy][t] (4:4:0 and 4:2:0: 2x bicubic up; 4:2:2: one tap
//      of 4096, its own row);
//   3. rows above the last two through swscale's MMX output:
//        vsize > 1 (yuv2bgr24_X):
//          U' = 4 + sum_t ((C15 vtap) >> 16) - 1024,
//          y' = ((4 + (Y15 >> 4) - y_offset) * luma) >> 16;
//        vsize 1 (yuv2bgr24_1): U' = (C15 >> 4) - 1024,
//          y' = (((Y15 >> 4) - y_offset) * luma) >> 16;
//      V' the same, then B, G and R as in yuv420_to_bgr.cu on y', U', V'
//      with the rule's 16-bit coefficients; the last two rows through the
//      C tables (yuv2rgb_X_c, or yuv2rgb_1_c, which gives the same at one
//      tap): Yi = ((Y15 << 12) + (1 << 18)) >> 19, Ui = ((1 << 18) +
//      sum_t C15 vtap) >> 19, T(k) = sat((k cy + y_base + 0x8000) >> 16),
//      D(c, q) = ((sat(c) q) >> 16) - (q >> 9), B = T(Yi + D(Ui, bu)),
//      G = T(Yi + D(Ui, gu) + D(Vi, gv)), R = T(Yi + D(Vi, rv)).
// - rtpose_yuv_planar_full_chroma_to_bgr: the scaling path with full
//   internal horizontal chroma, which swscale forces at an odd width and
//   for chroma it does not subsample (4:4:4): each chroma row filtered to
//   every column as in 1. (4:4:4, 4:4:0: one tap, the sample itself),
//   the vertical taps as in 2., then yuv2rgb_write_full at every pixel:
//     U = ((1 << 9) - (128 << 19) + sum_t C15 vtap) >> 10, V the same,
//     Y' = ((Y15 << 2) - (y_offset << 6)) * luma + (1 << 21),
//     R = Y' + V vr, G = Y' + V vg + U ug, B = Y' + U ub
//   in 32-bit unsigned arithmetic read back as int (a bright pixel of
//   strong chroma wraps to 0, as in swscale), each clipped to [0, 2^30)
//   and >> 22.
// - rtpose_gray_to_bgr: 4:0:0, which cv2 5.0's swscale graph takes as full
//   range: B = G = R = min((Y15 + 64) >> 7, 255) (swscale's palette copy
//   at 8 bits; at 10 and 12 the full-chroma output of neutral chroma).
//
// The taps are swscale's initFilter's, made on the host (ops/kernels.py
// sws_filter, general_filters) and passed in; none of the sums above
// leaves 32 bits but the full-chroma output's, which wraps as swscale's.
// The turn is cv2's cv::rotate: output (i, j) reads source (H-1-j, i) at
// 90 (clockwise), (H-1-i, W-1-j) at 180 and (j, W-1-i) at 270.
//
// What bounds it on this card: bytes, each plane read once and the BGR
// written once (at 3.35 TB/s):
//   general entry, 10-bit 4:2:2: 480x640 2.15 MB (0.64 us), 1080x1920
//   14.52 MB (4.33 us), 2160x3840 58.06 MB (17.33 us); 8-bit 4:4:0
//   1080x1920 10.37 MB (3.10 us); 12-bit 4:2:0 2160x3840 49.77 MB
//   (14.86 us);
//   full-chroma entry, 8-bit 4:4:4: 480x640 1.84 MB (0.55 us), 1080x1920
//   12.44 MB (3.71 us), 2160x3840 49.77 MB (14.86 us); 10-bit 4:2:2
//   1080x1919 14.51 MB (4.33 us);
//   4:2:2 (unscaled): 480x640 1.54 MB (0.46 us), 1080x1920 10.37 MB
//   (3.09 us), 2160x3840 41.47 MB (12.38 us);
//   gray: 10-bit 480x640 1.54 MB (0.46 us), 8-bit 1080x1920 8.29 MB
//   (2.48 us), 8-bit 2160x3840 33.18 MB (9.90 us).
//
// Every entry converts in yuv_tile.cuh's tiles, as the 4:2:0 kernels do:
// a block of 256 threads owns 32 x 64 pixels of the output (32 source
// rows x 64 columns, 64 x 32 turned); a thread owns eight pixels of one
// source row, their luma in one 16-byte (8-bit: 8-byte) load; their BGR
// words go into a shared tile in the output's orientation (8,320 bytes)
// and out with 16-byte stores (store_tile), the same at every turn.  The
// 4:2:2 entry is the unscaled 4:2:0 kernel's tile (yuv_unscaled.cuh),
// each plane's four chroma samples of a thread in one 4-byte load; the
// gray entry a pure stream, each word B = G = R of one sample.  The
// general and full-chroma entries share the scaling 4:2:0 kernels' output
// rules, chroma staging and vertical sums (yuv420p10_to_bgr.cu,
// yuv420_full_chroma_to_bgr.cu, yuv_chroma.cuh), each a template on its
// tap class, (most horizontal, most vertical taps), the least class that
// holds the frame's taps, so that each instantiation keeps only the
// registers and buffers its formats need:
// - (1, 1), 4:4:4 at full chroma: nothing to filter, a pure stream: the
//   thread's eight U and eight V samples in one load each (where the
//   table reads them in a line, as it does at 4:4:4; else a load a
//   sample), converted in registers;
// - (4, 1), 4:2:2 (general; at full chroma odd widths): a chroma row
//   feeds its one source row, so no filtered sample is shared, but
//   neighbouring pairs' taps share samples: the tile's chroma rows staged
//   into shared memory by cp.async in 16-byte windows (the samples its
//   taps reach, at most PLANAR_SPAN_H4 a row), each column's (pair's)
//   first sample and taps in a table the block loads once, and each
//   thread filters its own four pairs (eight columns) from its row there;
// - (4, 4), (8, 4), (1, 4): more vertical taps (4:4:0, 12-bit 4:2:0; at
//   full chroma 4:4:0 and 12-bit 4:2:0 of odd widths): the chroma rows the
//   tile's taps reach (PLANAR_VROWS, turned PLANAR_VROWS_TURNED) staged
//   likewise into the BGR tile's bytes, each filtered horizontally once a
//   tile into shared memory (a thread one column of several rows, its
//   taps in registers: eight at 4:4:0's down-filter), then the vertical
//   sums a pair (general) or a pixel (full chroma, 16-byte reads free of
//   bank conflicts) in registers.
// So each plane byte is read from device memory once and each chroma
// sample filtered once.  A table that reaches past the buffers traps
// (tests/test_torch_planar_tiles.py holds swscale's taps to them at every
// format, depth, size and chroma location); the entries refuse tap counts
// above their classes'.  ptxas: 32-48 registers, no spills; shared
// memory a block 8,320 bytes at (1, 1), 13,056-17,152 at (4, 1), at more
// vertical taps 13,216-13,600 on the general path and 18,688-19,200 at
// full chroma; the 4:2:2 and gray entries 30-32 registers and 8,320
// bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "yuv_rule.cuh"
#include "yuv_tile.cuh"
#include "yuv_chroma.cuh"
#include "yuv_unscaled.cuh"

#define PLANAR_THREADS 256
// a tiled thread's pixels, of one source row
#define PLANAR_PIXELS (TILE_ROWS * TILE_COLS / PLANAR_THREADS)
// horizontal taps a column (a pixel pair on the general path, a pixel at
// full chroma) at most: 8 on the general path (4:4:0's 2x down-filter), 4
// where its vertical filter has one tap (4:2:2) and at full chroma
#define PLANAR_GENERAL_MAX_HTAPS 8
#define PLANAR_ONE_ROW_MAX_HTAPS 4
#define PLANAR_FULL_MAX_HTAPS 4
// vertical taps a row at most
#define PLANAR_MAX_VTAPS 4
// chroma rows that TILE_ROWS source rows (turned: TILE_COLS) reach at
// most where the vertical filter has more than one tap (2x up)
#define PLANAR_VROWS 20
#define PLANAR_VROWS_TURNED 36
// chroma samples of a row that a tile's TILE_COLS source columns (turned:
// TILE_ROWS) reach at most, by the class's horizontal taps: one (4:4:4 and
// 4:4:0 at full chroma), four (2x up at full chroma; the pairs of 4:2:2
// and 4:2:0) and eight (the pairs of 4:4:0)
#define PLANAR_SPAN_H1 64
#define PLANAR_SPAN_H1_TURNED 32
#define PLANAR_SPAN_H4 36
#define PLANAR_SPAN_H4_TURNED 20
#define PLANAR_SPAN_H8 70
#define PLANAR_SPAN_H8_TURNED 38

// 8-bit 4:2:2: the unscaled 4:2:0 kernel's tile, each luma row its own
// chroma row
UNSCALED_KERNEL(yuv422_to_bgr_kernel, 0)

// A block's tile of the general path (FULL false: chroma shared by each
// pixel pair) or of full chroma.  T: the sample type, uint8_t (8-bit) or
// uint16_t (10- and 12-bit, `depth`); QUARTER: rotation is 90 or 270;
// (MAXH, MAXV): the tap class, the most taps a column and a row.
template <typename T, bool QUARTER, bool FULL, int MAXH, int MAXV>
__device__ __forceinline__ void planar_tile(
        const T* __restrict__ y, const T* __restrict__ u,
        const T* __restrict__ v, int y_pitch, int c_pitch, int height,
        int width, int depth, int rotation, const int* __restrict__ hpos,
        const int* __restrict__ htap, int hsize,
        const int* __restrict__ vpos, const int* __restrict__ vtap,
        int vsize, YuvRule rule, uint8_t* __restrict__ out) {
    constexpr int S = sizeof(T);
    constexpr int N = PLANAR_PIXELS;
    constexpr int SCOLS = QUARTER ? TILE_ROWS : TILE_COLS;  // source columns
    constexpr int SROWS = QUARTER ? TILE_COLS : TILE_ROWS;  // source rows
    // the horizontal filter's outputs: a tile's and a thread's (its
    // columns, or its pairs)
    constexpr int CCOLS = FULL ? SCOLS : SCOLS / 2;
    constexpr int COLS = FULL ? N : N / 2;
    // one tap each way (4:4:4): each thread reads its own samples
    constexpr bool DIRECT = MAXV == 1 && MAXH == 1;
    // chroma rows staged: each source row its own at one vertical tap
    constexpr int ROWS = MAXV == 1 ? SROWS
                         : QUARTER ? PLANAR_VROWS_TURNED : PLANAR_VROWS;
    constexpr int SPAN =
        MAXH == 1 ? (QUARTER ? PLANAR_SPAN_H1_TURNED : PLANAR_SPAN_H1)
        : MAXH == 4 ? (QUARTER ? PLANAR_SPAN_H4_TURNED : PLANAR_SPAN_H4)
                    : (QUARTER ? PLANAR_SPAN_H8_TURNED : PLANAR_SPAN_H8);
    // 16-byte windows a staged row: its span from any byte of a window
    constexpr int ROW_WINDOWS = (15 + SPAN * S + 15) / 16;
    static_assert(DIRECT || 2 * ROWS * ROW_WINDOWS * 16
                                <= BGR_TILE_WORDS * 4, "staged chroma");
    // the filtered chroma, at more than one vertical tap: a pair's rows
    // padded by a word, full chroma's by four (chroma_slot)
    constexpr int PITCH = FULL ? SCOLS + 4 : CCOLS + 1;
    __shared__ __align__(16) int chroma[2][MAXV == 1 ? 4 : ROWS * PITCH];
    __shared__ __align__(16) uint32_t bgr[BGR_TILE_WORDS];
    // hScale8To15's >> 7 and hScale16To15's >> (D - 1); luma to 15 bits
    const int cshift = S == 1 ? 7 : depth - 1;
    const int yshift = S == 1 ? 7 : 15 - depth;
    const TileMap m = tile_map<QUARTER>(height, width, rotation);
    const int tid = threadIdx.x;

    // this thread's pixels: source row r0 + sr, tile columns col..; their
    // luma and the row's vertical taps first, under the chroma's latency
    constexpr int ROW_THREADS = SCOLS / N;
    const int sr = tid / ROW_THREADS;
    const int col = N * (tid % ROW_THREADS);
    const bool mine = sr < m.th && col < m.tw;
    const int n = min(N, m.tw - col);
    const int sy = m.r0 + sr;
    uint32_t luma[S * N / 4];
    int vp = 0, taps[MAXV];
    if (mine) {
        load_bytes<S * N>(
            reinterpret_cast<const uint8_t*>(y + (size_t)sy * y_pitch + m.c0
                                             + col), S * n, luma);
        vp = vpos[sy];
#pragma unroll
        for (int t = 0; t < MAXV; ++t)
            taps[t] = t < vsize ? vtap[sy * vsize + t] : 0;
    }
    uint32_t px[N];

    if constexpr (DIRECT) {
        // 4:4:4: nothing to filter, a pure stream: the thread's columns'
        // samples in one load a plane where the table reads them in a line
        // (as at 4:4:4 it does), else a load a sample
        if (mine) {
            const int x0 = m.c0 + col;
            const int hp0 = hpos[x0];
            bool line = true;
            int ht[N];
#pragma unroll
            for (int k = 0; k < N; ++k) {
                line = line && (k >= n || hpos[x0 + k] == hp0 + k);
                ht[k] = k < n ? htap[x0 + k] : 0;
            }
            const T* ur = u + (size_t)vp * c_pitch;
            const T* vr = v + (size_t)vp * c_pitch;
            int cu[N], cv[N];
            if (line) {
                uint32_t wu[S * N / 4], wv[S * N / 4];
                load_bytes<S * N>(reinterpret_cast<const uint8_t*>(ur + hp0),
                                  S * n, wu);
                load_bytes<S * N>(reinterpret_cast<const uint8_t*>(vr + hp0),
                                  S * n, wv);
#pragma unroll
                for (int k = 0; k < N; ++k) {
                    cu[k] = sample_of<T>(wu, k);
                    cv[k] = sample_of<T>(wv, k);
                }
            } else {
#pragma unroll
                for (int k = 0; k < N; ++k) {
                    cu[k] = k < n ? (int)ur[hpos[x0 + k]] : 0;
                    cv[k] = k < n ? (int)vr[hpos[x0 + k]] : 0;
                }
            }
#pragma unroll
            for (int k = 0; k < N; ++k) {
                const int u15 = min((cu[k] * ht[k]) >> cshift, 32767);
                const int v15 = min((cv[k] * ht[k]) >> cshift, 32767);
                px[k] = full_pixel(sample_of<T>(luma, k) << yshift,
                                   (1 << 9) - (128 << 19) + u15 * taps[0],
                                   (1 << 9) - (128 << 19) + v15 * taps[0],
                                   rule);
            }
        }
    } else {
        // the chroma rows and samples the tile's taps reach (vpos and hpos
        // rise with the row and the column), from the filter's first
        // output of the tile (a column, or a pair) and its outputs inside
        // the picture
        const int c0 = FULL ? m.c0 : m.c0 >> 1;
        const int cn = FULL ? m.tw : m.tw >> 1;
        const int first = vpos[m.r0];
        const int rows = vpos[m.r0 + m.th - 1] + vsize - first;
        const int xa = hpos[c0];
        const int span = hpos[c0 + cn - 1] + hsize - xa;
        if (rows > ROWS || span > SPAN) __trap();   // tables past the tile
        const uint8_t* ub = reinterpret_cast<const uint8_t*>(u);
        const uint8_t* vb = reinterpret_cast<const uint8_t*>(v);
        // the planes' bytes: up to the last row the taps reach
        const size_t plane_bytes =
            (size_t)(vpos[height - 1] + vsize) * c_pitch * S;

        if constexpr (MAXV == 1) {
            // 4:2:2 (pairs; at full chroma 2x up): a chroma row feeds its
            // one source row, so no filtered sample is shared; the rows
            // staged beside the BGR tile, each thread filters its own
            // columns (pairs) from its row, each one's first sample and
            // taps from a table the block loads once (a thread's j-th
            // columns side by side, so that a row's threads read it free
            // of bank conflicts)
            static_assert(MAXH == 4, "one vertical tap: four taps a column");
            __shared__ __align__(16) uint4 rows_in[2 * ROWS * ROW_WINDOWS];
            __shared__ __align__(16) int4 col_taps[CCOLS];
            __shared__ int col_off[CCOLS];
            if (tid < CCOLS) {
                // (columns past the picture: no taps, the row's first
                // sample)
                const int x = c0 + tid;
                int t[MAXH];
#pragma unroll
                for (int k = 0; k < MAXH; ++k)
                    t[k] = tid < cn && k < hsize ? htap[x * hsize + k] : 0;
                const int slot = tid % COLS * (CCOLS / COLS) + tid / COLS;
                col_taps[slot] = make_int4(t[0], t[1], t[2], t[3]);
                col_off[slot] = tid < cn ? (hpos[x] - xa) * S : 0;
            }
            stage_rows<S, ROWS, ROW_WINDOWS, PLANAR_THREADS>(
                rows_in, ub, vb, c_pitch, first, rows, xa, span,
                plane_bytes);
            __syncthreads();
            if (mine) {
                const uint8_t* su = staged_row<S, ROWS, ROW_WINDOWS>(
                    rows_in, ub, c_pitch, first, vp - first, 0, xa);
                const uint8_t* sv = staged_row<S, ROWS, ROW_WINDOWS>(
                    rows_in, vb, c_pitch, first, vp - first, 1, xa);
                const bool simd = sy < height - 2;
#pragma unroll
                for (int j = 0; j < COLS; ++j) {
                    // (columns past the picture: words never stored)
                    const int slot = j * (CCOLS / COLS) + col / N;
                    const int4 t4 = col_taps[slot];
                    const int ht[MAXH] = {t4.x, t4.y, t4.z, t4.w};
                    const int off = col_off[slot];
                    const int u15 = filter_staged<S, MAXH>(su + off, ht,
                                                           hsize, cshift);
                    const int v15 = filter_staged<S, MAXH>(sv + off, ht,
                                                           hsize, cshift);
                    if constexpr (FULL) {
                        px[j] = full_pixel(
                            sample_of<T>(luma, j) << yshift,
                            (1 << 9) - (128 << 19) + u15 * taps[0],
                            (1 << 9) - (128 << 19) + v15 * taps[0], rule);
                    } else {
                        // yuv2bgr24_1 above the last two rows
                        general_pair(
                            sample_of<T>(luma, 2 * j) << yshift,
                            sample_of<T>(luma, 2 * j + 1) << yshift, simd, 0,
                            simd ? u15 >> 4 : (1 << 18) + u15 * taps[0],
                            simd ? v15 >> 4 : (1 << 18) + v15 * taps[0],
                            rule, px[2 * j], px[2 * j + 1]);
                    }
                }
            }
        } else {
            // more vertical taps: the rows staged in the BGR tile's bytes,
            // each filtered horizontally once to the tile's columns
            // (pairs), a thread one of them for several rows
            uint4* staged = reinterpret_cast<uint4*>(bgr);
            constexpr int GROUPS = PLANAR_THREADS / CCOLS;
            constexpr int ITEMS = (ROWS + GROUPS - 1) / GROUPS;
            const int cc = tid % CCOLS, row0 = tid / CCOLS;
            const bool filters = cc < cn;
            int off = 0, ht[MAXH];
#pragma unroll
            for (int k = 0; k < MAXH; ++k)
                ht[k] = filters && k < hsize ? htap[(c0 + cc) * hsize + k]
                                             : 0;
            if (filters) off = (hpos[c0 + cc] - xa) * S;
            stage_rows<S, ROWS, ROW_WINDOWS, PLANAR_THREADS>(
                staged, ub, vb, c_pitch, first, rows, xa, span,
                plane_bytes);
            __syncthreads();
            if (filters) {
#pragma unroll
                for (int i = 0; i < ITEMS; ++i) {
                    const int r = row0 + i * GROUPS;
                    if (r < rows) {
#pragma unroll
                        for (int p = 0; p < 2; ++p) {
                            const uint8_t* s =
                                staged_row<S, ROWS, ROW_WINDOWS>(
                                    staged, p ? vb : ub, c_pitch, first, r,
                                    p, xa) + off;
                            chroma[p][FULL ? chroma_slot<QUARTER>(r, cc)
                                           : r * PITCH + cc] =
                                filter_staged<S, MAXH>(s, ht, hsize, cshift);
                        }
                    }
                }
            }
            __syncthreads();
            // the vertical sums, then the pixels (columns past the
            // picture: words never stored)
            if (mine) {
                if constexpr (FULL) {
                    full_pixels<T, QUARTER, MAXV, N>(
                        chroma[0], chroma[1], vp - first, col, taps, vsize,
                        luma, yshift, rule, px);
                } else {
                    const int at = (vp - first) * PITCH + (col >> 1);
                    general_pairs<T, PITCH, MAXV, N>(
                        chroma[0] + at, chroma[1] + at, sy < height - 2,
                        taps, vsize, luma, yshift, rule, px);
                }
            }
        }
    }
    if (mine) put_pixels<N>(bgr, m, sr, col, n, px);
    __syncthreads();
    store_tile<PLANAR_THREADS>(bgr, m, out);
}

// The kernels of each entry, named as its wrapper in ops/kernels.py (a
// profiler's record then names the route)
#define PLANAR_KERNEL(NAME, FULL)                                            \
    template <typename T, bool QUARTER, int MAXH, int MAXV>                  \
    __global__ void __launch_bounds__(PLANAR_THREADS) NAME(                  \
            const T* __restrict__ y, const T* __restrict__ u,                \
            const T* __restrict__ v, int y_pitch, int c_pitch, int height,   \
            int width, int depth, int rotation,                              \
            const int* __restrict__ hpos, const int* __restrict__ htap,      \
            int hsize, const int* __restrict__ vpos,                         \
            const int* __restrict__ vtap, int vsize, YuvRule rule,           \
            uint8_t* __restrict__ out) {                                     \
        planar_tile<T, QUARTER, FULL, MAXH, MAXV>(                           \
            y, u, v, y_pitch, c_pitch, height, width, depth, rotation, hpos, \
            htap, hsize, vpos, vtap, vsize, rule, out);                      \
    }
PLANAR_KERNEL(yuv_planar_general_to_bgr_tiled, false)
PLANAR_KERNEL(yuv_planar_full_chroma_to_bgr_tiled, true)

// 4:0:0, a pure stream through the same tile: a thread's eight samples
// in one load (8 bytes at 8 bits, 16 above), B = G = R = min((Y15 + 64)
// >> 7, 255) (Y itself at 8 bits) as one word.  T: the sample type,
// uint8_t (8-bit) or uint16_t (10- and 12-bit, `depth`); QUARTER:
// rotation is 90 or 270.
template <typename T, bool QUARTER>
__global__ void __launch_bounds__(PLANAR_THREADS) gray_to_bgr_kernel(
        const T* __restrict__ y, int y_pitch, int height, int width,
        int depth, int rotation, uint8_t* __restrict__ out) {
    constexpr int S = sizeof(T);
    constexpr int N = PLANAR_PIXELS;
    __shared__ uint32_t bgr[BGR_TILE_WORDS];
    const TileMap m = tile_map<QUARTER>(height, width, rotation);
    // this thread's pixels: source row r0 + sr, tile columns col..
    constexpr int ROW_THREADS = (QUARTER ? TILE_ROWS : TILE_COLS) / N;
    const int sr = threadIdx.x / ROW_THREADS;
    const int col = N * (threadIdx.x % ROW_THREADS);
    if (sr < m.th && col < m.tw) {
        const int n = min(N, m.tw - col);
        uint32_t luma[S * N / 4];
        load_bytes<S * N>(
            reinterpret_cast<const uint8_t*>(
                y + (size_t)(m.r0 + sr) * y_pitch + m.c0 + col), S * n,
            luma);
        uint32_t px[N];
#pragma unroll
        for (int k = 0; k < N; ++k) {
            int g = sample_of<T>(luma, k);
            if constexpr (S == 2)
                g = min(((g << (15 - depth)) + 64) >> 7, 255);
            px[k] = (uint32_t)g * 0x010101u;
        }
        put_pixels<N>(bgr, m, sr, col, n, px);
    }
    __syncthreads();
    store_tile<PLANAR_THREADS>(bgr, m, out);
}

static bool planar_bad(int height, int width, int y_pitch, int rotation,
                       int depth) {
    return height <= 0 || width <= 0 || y_pitch < width
           || (depth != 8 && depth != 10 && depth != 12)
           || (rotation != 0 && rotation != 90 && rotation != 180
               && rotation != 270);
}

extern "C" int rtpose_yuv422_to_bgr(const void* y, const void* u,
                                    const void* v, int y_pitch, int c_pitch,
                                    int height, int width, int rotation,
                                    YuvRule rule, void* out, void* stream) {
    if (planar_bad(height, width, y_pitch, rotation, 8)
            || c_pitch < (width + 1) / 2)
        return (int)cudaErrorInvalidValue;
    const auto kernel = rotation == 90 || rotation == 270
                        ? yuv422_to_bgr_kernel<true>
                        : yuv422_to_bgr_kernel<false>;
    kernel<<<tile_grid(height, width, rotation), YUV_THREADS, 0,
             (cudaStream_t)stream>>>(
        (const uint8_t*)y, (const uint8_t*)u, (const uint8_t*)v, y_pitch,
        c_pitch, height, width, rotation, rule, (uint8_t*)out);
    return (int)cudaGetLastError();
}

template <typename T>
using PlanarKernel = void (*)(const T*, const T*, const T*, int, int, int,
                              int, int, int, const int*, const int*, int,
                              const int*, const int*, int, YuvRule,
                              uint8_t*);

// the kernel of the least tap class that holds hsize and vsize taps, or
// none where no class does
template <typename T, bool Q>
static PlanarKernel<T> planar_kernel(bool full, int hsize, int vsize) {
    if (hsize < 1 || vsize < 1 || vsize > PLANAR_MAX_VTAPS) return nullptr;
    const bool one = vsize == 1;
    if (full) {
        if (hsize == 1)
            return one ? yuv_planar_full_chroma_to_bgr_tiled<T, Q, 1, 1>
                       : yuv_planar_full_chroma_to_bgr_tiled<T, Q, 1, 4>;
        if (hsize > PLANAR_FULL_MAX_HTAPS) return nullptr;
        return one ? yuv_planar_full_chroma_to_bgr_tiled<T, Q, 4, 1>
                   : yuv_planar_full_chroma_to_bgr_tiled<T, Q, 4, 4>;
    }
    if (one)
        return hsize <= PLANAR_ONE_ROW_MAX_HTAPS
                   ? yuv_planar_general_to_bgr_tiled<T, Q, 4, 1> : nullptr;
    if (hsize <= 4) return yuv_planar_general_to_bgr_tiled<T, Q, 4, 4>;
    return hsize <= PLANAR_GENERAL_MAX_HTAPS
               ? yuv_planar_general_to_bgr_tiled<T, Q, 8, 4> : nullptr;
}

template <typename T>
static int launch_planar(bool full, const void* y, const void* u,
                         const void* v, int y_pitch, int c_pitch, int height,
                         int width, int depth, int rotation, const void* hpos,
                         const void* htap, int hsize, const void* vpos,
                         const void* vtap, int vsize, YuvRule rule,
                         void* out, cudaStream_t stream) {
    const bool quarter = rotation == 90 || rotation == 270;
    const PlanarKernel<T> kernel =
        quarter ? planar_kernel<T, true>(full, hsize, vsize)
                : planar_kernel<T, false>(full, hsize, vsize);
    if (!kernel) return (int)cudaErrorInvalidValue;
    kernel<<<tile_grid(height, width, rotation), PLANAR_THREADS, 0,
             stream>>>(
        (const T*)y, (const T*)u, (const T*)v, y_pitch, c_pitch, height,
        width, depth, rotation, (const int*)hpos, (const int*)htap, hsize,
        (const int*)vpos, (const int*)vtap, vsize, rule, (uint8_t*)out);
    return (int)cudaGetLastError();
}

static int planar_entry(bool full, const void* y, const void* u,
                        const void* v, int y_pitch, int c_pitch, int height,
                        int width, int depth, int rotation, const void* hpos,
                        const void* htap, int hsize, const void* vpos,
                        const void* vtap, int vsize, YuvRule rule, void* out,
                        void* stream) {
    if (planar_bad(height, width, y_pitch, rotation, depth) || c_pitch <= 0
            || (!full && width % 2))
        return (int)cudaErrorInvalidValue;
    return depth == 8
        ? launch_planar<uint8_t>(full, y, u, v, y_pitch, c_pitch, height,
                                 width, depth, rotation, hpos, htap, hsize,
                                 vpos, vtap, vsize, rule, out,
                                 (cudaStream_t)stream)
        : launch_planar<uint16_t>(full, y, u, v, y_pitch, c_pitch, height,
                                  width, depth, rotation, hpos, htap, hsize,
                                  vpos, vtap, vsize, rule, out,
                                  (cudaStream_t)stream);
}

extern "C" int rtpose_yuv_planar_general_to_bgr(
        const void* y, const void* u, const void* v, int y_pitch,
        int c_pitch, int height, int width, int depth, int rotation,
        const void* hpos, const void* htap, int hsize, const void* vpos,
        const void* vtap, int vsize, YuvRule rule, void* out, void* stream) {
    return planar_entry(false, y, u, v, y_pitch, c_pitch, height, width,
                        depth, rotation, hpos, htap, hsize, vpos, vtap,
                        vsize, rule, out, stream);
}

extern "C" int rtpose_yuv_planar_full_chroma_to_bgr(
        const void* y, const void* u, const void* v, int y_pitch,
        int c_pitch, int height, int width, int depth, int rotation,
        const void* hpos, const void* htap, int hsize, const void* vpos,
        const void* vtap, int vsize, YuvRule rule, void* out, void* stream) {
    return planar_entry(true, y, u, v, y_pitch, c_pitch, height, width,
                        depth, rotation, hpos, htap, hsize, vpos, vtap,
                        vsize, rule, out, stream);
}

template <typename T>
static void launch_gray(const void* y, int y_pitch, int height, int width,
                        int depth, int rotation, void* out,
                        cudaStream_t stream) {
    const auto kernel = rotation == 90 || rotation == 270
                        ? gray_to_bgr_kernel<T, true>
                        : gray_to_bgr_kernel<T, false>;
    kernel<<<tile_grid(height, width, rotation), PLANAR_THREADS, 0,
             stream>>>((const T*)y, y_pitch, height, width, depth, rotation,
                       (uint8_t*)out);
}

extern "C" int rtpose_gray_to_bgr(const void* y, int y_pitch, int height,
                                  int width, int depth, int rotation,
                                  void* out, void* stream) {
    if (planar_bad(height, width, y_pitch, rotation, depth))
        return (int)cudaErrorInvalidValue;
    if (depth == 8)
        launch_gray<uint8_t>(y, y_pitch, height, width, depth, rotation, out,
                             (cudaStream_t)stream);
    else
        launch_gray<uint16_t>(y, y_pitch, height, width, depth, rotation,
                              out, (cudaStream_t)stream);
    return (int)cudaGetLastError();
}
