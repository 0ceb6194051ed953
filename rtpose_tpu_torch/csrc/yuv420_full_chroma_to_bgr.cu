// swscale's general (scaling) path from 4:2:0 to 8-bit BGR with full
// internal horizontal chroma, with a quarter turn, hand-written for
// Hopper at two sample depths (8-bit yuv420p and 10-bit yuv420p10le: Y, U
// and V planes, each with its own row pitch): the card's counterpart of
// what cv2.VideoCapture does with a decoded frame of an odd width (a
// 10-bit one, or an 8-bit one whose height is odd too).
//
// Replaces no TPU kernel.  The JAX demo reads video through cv2
// (rtpose_tpu/demo/video_demo.py:19-27).  At an odd RGB output width
// swscale forces SWS_FULL_CHR_H_INT ("Forcing full internal H chroma due
// to odd output size"): it filters the chroma up to the full width and
// converts each pixel with its own chroma through the C template
// yuv2rgb_full_X_c (libswscale/output.c, yuv2rgb_write_full), on every
// row.  The rule below was found against the wheel's libswscale (legacy
// sws_scale with cv2's settings, tests/test_torch_colour.py), equal to it
// at every pixel of random and saturated fields at each size, chroma
// location and (matrix, range) tried; D is the depth (8 or 10):
//
// 1. Into swscale's 15-bit intermediate: luma Y15 = Y << (15 - D) (an
//    identity filter); each chroma row filtered horizontally from its
//    (width + 1) / 2 samples up to `width`,
//    C15[r][x] = min(sum_k C[r][hpos[x] + k] * htap[x][k] >> (D - 1),
//    32767), with swscale's 14-bit bicubic taps (B 0, C 0.6) at its
//    chrXInc and the frame's chroma location, hsize of them (four at most).
// 2. Each output row sy takes vsize chroma rows vpos[sy] + t with 12-bit
//    taps vtap[sy][t], at full precision:
//      U = ((1 << 9) - (128 << 19) + sum_t C15 * vtap) >> 10, V the same;
//      Y = ((1 << 9) + (Y15 << 12)) >> 10 (the one-tap luma filter).
//    The taps are swscale's initFilter's, made on the host
//    (ops/kernels.py sws_filter) and passed in.
// 3. Output (yuv2rgb_write_full):
//      Y' = (Y - (y_offset << 6)) * luma + (1 << 21),
//      R = Y' + V vr, G = Y' + V vg + U ug, B = Y' + U ub
//    in 32-bit unsigned arithmetic read back as int (so a bright pixel
//    of strong chroma can wrap negative: swscale gives it 0, and so does
//    this kernel), each clipped to [0, 2^30) and >> 22.  No dither.
//
// The turn is cv2's cv::rotate, as in yuv420_to_bgr.cu.
//
// What bounds it on this card: bytes.  A 479x639 8-bit frame reads 0.46 MB
// of planes and writes 0.92 MB of BGR, 1.38 MB in all: 0.41 us at
// 3.35 TB/s; a 480x639 10-bit frame 1.84 MB (0.55 us).
//
// A thread a pixel would filter each chroma sample horizontally up to 16
// times, read 32 source rows a warp under a quarter turn and write BGR a
// byte at a time (PERF.md has its times).  Here
// (yuv_tile.cuh) a block of 256 threads owns 32 x 64 pixels of the output
// (32 source rows x 64 columns, 64 x 32 turned) and
// - stages the chroma samples its taps reach, rows [vpos[r0], vpos[r_last]
//   + vsize) by columns [hpos[c0], hpos[c_last] + hsize), from U and V
//   into shared memory in 16-byte windows, each by cp.async (no register
//   on the way), all of them in flight together (single bytes only where
//   a window would leave its plane);
// - filters each staged chroma row horizontally once to every source
//   column of the tile, a thread one column of FC_ITEMS rows, its taps in
//   registers, clamped at 32767 into FC_CHROMA_WORDS words a plane (20
//   rows of 64 columns, or 40 of 32 turned: 32 or 64 source rows reach at
//   most 20 or 36 chroma rows, a tile's 64 or 32 columns at most FC_SPAN
//   or FC_SPAN_TURNED samples, tests/test_torch_yuv_tiles.py; a table
//   past them traps);
// - gives a thread eight pixels of one source row: their luma in one
//   16-byte (10-bit) or 8-byte (8-bit) load issued first, the row's
//   vertical taps in registers, the filtered chroma read with 16-byte
//   loads free of bank conflicts (chroma_slot), the vertical sums and the
//   output in registers, four pixels at a time;
// - puts the BGR words into a shared tile in the output's orientation and
//   writes its 32 rows of 192 bytes with 16-byte stores (store_tile).
// So each plane byte is read from device memory once, each chroma sample
// filtered once a source column, and the stores are the same at every
// turn.  Shared memory a block: 11,520 bytes of filtered chroma, 8,320 of
// BGR (the staged samples, at most 5,120 bytes, lie in the BGR tile
// before it is written).  ptxas: 40-48 registers, no spills.

#include <cuda_runtime.h>
#include <stdint.h>

#include "yuv_rule.cuh"
#include "yuv_tile.cuh"
#include "yuv_chroma.cuh"

#define FC_THREADS 256
// a thread's pixels, of one source row
#define FC_PIXELS (TILE_ROWS * TILE_COLS / FC_THREADS)
// taps a column and a row at most: swscale's bicubic at 2x has four
#define FC_MAX_TAPS 4
// filtered chroma samples a plane a tile holds: as many rows as the
// tile's vertical taps reach, at most (see above), of its source
// columns, a thread FC_ITEMS of them
#define FC_CHROMA_WORDS 1280
#define FC_ITEMS (FC_CHROMA_WORDS / FC_THREADS)
// each row padded by four words: 16-byte reads, and a turned tile's
// neighbouring rows in other banks (chroma_slot)
#define FC_CHROMA_SLOTS (FC_CHROMA_WORDS + 4 * FC_CHROMA_WORDS / TILE_ROWS)
// chroma samples of a row that TILE_COLS source columns reach, at most
// (hpos of the last + hsize - hpos of the first), and TILE_ROWS columns
#define FC_SPAN 36
#define FC_SPAN_TURNED 20

// A block's tile.  T: the sample type, uint8_t (8-bit) or uint16_t
// (10-bit); QUARTER: rotation is 90 or 270
template <typename T, bool QUARTER>
__device__ __forceinline__ void full_chroma_tile(
        const T* __restrict__ y, const T* __restrict__ u,
        const T* __restrict__ v, int y_pitch, int c_pitch, int height,
        int width, int rotation, const int* __restrict__ hpos,
        const int* __restrict__ htap, int hsize,
        const int* __restrict__ vpos, const int* __restrict__ vtap,
        int vsize, YuvRule rule, uint8_t* __restrict__ out) {
    constexpr int S = sizeof(T);
    constexpr int DEPTH = S == 1 ? 8 : 10;
    constexpr int SCOLS = QUARTER ? TILE_ROWS : TILE_COLS;  // source columns
    constexpr int ROWS = FC_CHROMA_WORDS / SCOLS;    // chroma rows held
    constexpr int SPAN = QUARTER ? FC_SPAN_TURNED : FC_SPAN;
    // 16-byte windows a staged row: its span from any byte of a window
    constexpr int ROW_WINDOWS = (15 + SPAN * S + 15) / 16;
    static_assert(ROWS * (SCOLS + 4) <= FC_CHROMA_SLOTS, "chroma rows");
    static_assert(2 * ROWS * ROW_WINDOWS * 16 <= BGR_TILE_WORDS * 4,
                  "staged chroma");
    __shared__ __align__(16) int chroma[2][FC_CHROMA_SLOTS];
    __shared__ __align__(16) uint32_t bgr[BGR_TILE_WORDS];
    uint4* staged = reinterpret_cast<uint4*>(bgr);
    const TileMap m = tile_map<QUARTER>(height, width, rotation);
    const int tid = threadIdx.x;

    // this thread's pixels: source row r0 + sr, tile columns col..; their
    // luma and the row's vertical taps first, under the chroma's latency
    constexpr int ROW_THREADS = SCOLS / FC_PIXELS;
    const int sr = tid / ROW_THREADS;
    const int col = FC_PIXELS * (tid % ROW_THREADS);
    const bool mine = sr < m.th && col < m.tw;
    const int sy = m.r0 + sr;
    uint32_t luma[S * FC_PIXELS / 4];
    int vp = 0, taps[FC_MAX_TAPS];
    if (mine) {
        load_bytes<S * FC_PIXELS>(
            reinterpret_cast<const uint8_t*>(y + (size_t)sy * y_pitch + m.c0
                                             + col),
            S * min(FC_PIXELS, m.tw - col), luma);
        vp = vpos[sy];
#pragma unroll
        for (int t = 0; t < FC_MAX_TAPS; ++t)
            taps[t] = t < vsize ? vtap[sy * vsize + t] : 0;
    }
    // this thread's source column of the horizontal stage and its taps
    const int cc = tid % SCOLS, row0 = tid / SCOLS;
    const bool filters = cc < m.tw;
    int hp = 0, ht[FC_MAX_TAPS];
    if (filters) {
        const int x = m.c0 + cc;
        hp = hpos[x];
#pragma unroll
        for (int k = 0; k < FC_MAX_TAPS; ++k)
            ht[k] = k < hsize ? htap[x * hsize + k] : 0;
    }

    // the chroma rows and columns the tile's taps reach (vpos and hpos
    // rise with the row and the column)
    const int first = vpos[m.r0];
    const int rows = vpos[m.r0 + m.th - 1] + vsize - first;
    const int xa = hpos[m.c0];
    const int span = hpos[m.c0 + m.tw - 1] + hsize - xa;
    if (rows > ROWS || span > SPAN) __trap();   // tables past the tile

    // staged: the rows' samples from the 16-byte windows that hold them,
    // all copies in flight together
    const uint8_t* ub = reinterpret_cast<const uint8_t*>(u);
    const uint8_t* vb = reinterpret_cast<const uint8_t*>(v);
    const size_t plane_bytes = (size_t)((height + 1) / 2) * c_pitch * S;
    stage_rows<S, ROWS, ROW_WINDOWS, FC_THREADS>(staged, ub, vb, c_pitch,
                                                 first, rows, xa, span,
                                                 plane_bytes);
    __syncthreads();

    // each staged row filtered horizontally once to the tile's columns:
    // C15 = min(sum_k C[hpos + k] * htap[k] >> (D - 1), 32767) (written
    // out here: through yuv_chroma.cuh's filter_staged the 10-bit turned
    // kernel takes 48 registers, not 40, and runs slower)
    if (filters) {
        const uint8_t* bytes = reinterpret_cast<const uint8_t*>(staged);
#pragma unroll
        for (int i = 0; i < FC_ITEMS; ++i) {
            const int r = row0 + i * (FC_THREADS / SCOLS);
            if (r < rows) {
#pragma unroll
                for (int p = 0; p < 2; ++p) {
                    const uintptr_t at = (uintptr_t)(p ? vb : ub)
                        + ((size_t)(first + r) * c_pitch + xa) * S;
                    const uint8_t* s = bytes
                        + 16 * (p * ROWS + r) * ROW_WINDOWS + (int)(at & 15)
                        + (hp - xa) * S;
                    int h = 0;
#pragma unroll
                    for (int k = 0; k < FC_MAX_TAPS; ++k) {
                        if (k < hsize) {
                            const int c = S == 1
                                ? (int)s[k]
                                : (int)reinterpret_cast<const uint16_t*>(s)[k];
                            h += c * ht[k];
                        }
                    }
                    chroma[p][chroma_slot<QUARTER>(r, cc)] =
                        min(h >> (DEPTH - 1), 32767);
                }
            }
        }
    }
    __syncthreads();

    // the vertical sums at full precision, then each pixel, four at a
    // time (columns past the picture: words never stored)
    if (mine) {
        uint32_t px[FC_PIXELS];
        full_pixels<T, QUARTER, FC_MAX_TAPS, FC_PIXELS>(
            chroma[0], chroma[1], vp - first, col, taps, vsize, luma,
            15 - DEPTH, rule, px);
        put_pixels<FC_PIXELS>(bgr, m, sr, col, min(FC_PIXELS, m.tw - col),
                              px);
    }
    __syncthreads();
    store_tile<FC_THREADS>(bgr, m, out);
}

// The kernel of each depth and orientation, named as its wrapper in
// ops/kernels.py (a profiler's record then names the route)
template <typename T, bool QUARTER>
__global__ void __launch_bounds__(FC_THREADS)
yuv420_full_chroma_to_bgr_kernel(
        const T* __restrict__ y, const T* __restrict__ u,
        const T* __restrict__ v, int y_pitch, int c_pitch, int height,
        int width, int rotation, const int* __restrict__ hpos,
        const int* __restrict__ htap, int hsize,
        const int* __restrict__ vpos, const int* __restrict__ vtap,
        int vsize, YuvRule rule, uint8_t* __restrict__ out) {
    full_chroma_tile<T, QUARTER>(y, u, v, y_pitch, c_pitch, height, width,
                                 rotation, hpos, htap, hsize, vpos, vtap,
                                 vsize, rule, out);
}

template <typename T>
static void launch_full_chroma(dim3 grid, bool quarter, const void* y,
                               const void* u, const void* v, int y_pitch,
                               int c_pitch, int height, int width,
                               int rotation, const void* hpos,
                               const void* htap, int hsize, const void* vpos,
                               const void* vtap, int vsize, YuvRule rule,
                               void* out, cudaStream_t stream) {
    const auto kernel = quarter ? yuv420_full_chroma_to_bgr_kernel<T, true>
                                : yuv420_full_chroma_to_bgr_kernel<T, false>;
    kernel<<<grid, FC_THREADS, 0, stream>>>(
        (const T*)y, (const T*)u, (const T*)v, y_pitch, c_pitch, height,
        width, rotation, (const int*)hpos, (const int*)htap, hsize,
        (const int*)vpos, (const int*)vtap, vsize, rule, (uint8_t*)out);
}

extern "C" int rtpose_yuv420_full_chroma_to_bgr(
        const void* y, const void* u, const void* v, int y_pitch,
        int c_pitch, int height, int width, int depth, int rotation,
        const void* hpos, const void* htap, int hsize, const void* vpos,
        const void* vtap, int vsize, YuvRule rule, void* out, void* stream) {
    if (height <= 2 || width <= 0 || y_pitch < width
            || c_pitch < (width + 1) / 2 || (depth != 8 && depth != 10)
            || hsize < 1 || hsize > FC_MAX_TAPS || vsize < 1
            || vsize > FC_MAX_TAPS
            || (rotation != 0 && rotation != 90 && rotation != 180
                && rotation != 270))
        return (int)cudaErrorInvalidValue;
    const dim3 grid = tile_grid(height, width, rotation);
    const bool quarter = rotation == 90 || rotation == 270;
    if (depth == 8)
        launch_full_chroma<uint8_t>(grid, quarter, y, u, v, y_pitch, c_pitch,
                                    height, width, rotation, hpos, htap,
                                    hsize, vpos, vtap, vsize, rule, out,
                                    (cudaStream_t)stream);
    else
        launch_full_chroma<uint16_t>(grid, quarter, y, u, v, y_pitch,
                                     c_pitch, height, width, rotation, hpos,
                                     htap, hsize, vpos, vtap, vsize, rule,
                                     out, (cudaStream_t)stream);
    return (int)cudaGetLastError();
}
