// swscale's general (scaling) path from 4:2:0 to 8-bit BGR with a quarter
// turn, chroma shared by each pixel pair, hand-written for Hopper at two
// sample depths: 10-bit (yuv420p10le: Y, U and V planes of 16-bit samples
// below 1024, each with its own row pitch; rtpose_yuv420p10_to_bgr) and
// 8-bit (yuv420p; rtpose_yuv420_general_to_bgr).  The card's counterpart
// of what cv2.VideoCapture does with a decoded HEVC Main 10, H.264 High
// 10 or VP9 profile 2 frame, and with an 8-bit frame of an odd height.
//
// Replaces no TPU kernel.  The JAX demo reads video through cv2
// (rtpose_tpu/demo/video_demo.py:19-27).  swscale has no unscaled path
// from yuv420p10le to bgr24, and takes its unscaled yuv420p -> bgr24
// (yuv420_to_bgr.cu) only at an even output height, so these frames go
// through its general path at SWS_BICUBIC, the source chroma placed by
// the frame's chroma location; the port decodes on the host
// (native/avcodec.py) and converts here.  An odd width takes swscale's
// full-chroma output instead (yuv420_full_chroma_to_bgr.cu).  The rule
// below was found against cv2 5.0's frames of 10-bit PCM streams and
// swscale itself (tests/test_torch_colour.py), equal to them at every
// pixel of random fields at each size, chroma location and (matrix,
// range) tried; D is the depth (8 or 10):
//
// 1. Into swscale's 15-bit intermediate: luma Y15 = Y << (15 - D) (an
//    identity filter); each chroma row filtered horizontally,
//    C15[r][c] = min(sum_k C[r][hpos[c] + k] * htap[c][k] >> (D - 1),
//    32767) (hScale8To15's >> 7, hScale16To15's >> 9), with 14-bit taps
//    (hsize of them: one, 16384, where the chroma sits at the centre of
//    its pixel pair; four bicubic ones, B 0 and C 0.6, where it sits
//    left, as H.264 and HEVC place it).
// 2. Each output row sy takes vsize chroma rows vpos[sy] + t with 12-bit
//    bicubic taps vtap[sy][t] (2x upsampling; rows past the edges folded
//    onto the edge taps).  The taps are swscale's initFilter's, made on
//    the host (ops/kernels.py sws_filter) and passed in.
// 3. Output, one chroma value for each pixel pair (2c, 2c + 1):
//    - rows above the last two (swscale's MMX yuv2bgr24_X, whose
//      vertical filter keeps the high half of each product):
//        U' = 4 + sum_t ((C15 * vtap) >> 16) - 1024, the same for V;
//        y' = ((4 + (Y15 >> 4) - y_offset) * luma) >> 16
//      (Y15 >> 4 is 8 Y at 8 bits, 2 Y at 10), then B, G and R as in the
//      8-bit kernel (yuv420_to_bgr.cu) on y', U' and V' with the rule's
//      16-bit coefficients;
//    - the last two rows (swscale leaves its MMX filter there and takes
//      the C yuv2rgb_X template with its tables):
//        Yi = ((Y15 << 12) + (1 << 18)) >> 19 (Y at 8 bits, (Y + 2) >> 2
//        at 10),
//        Ui = ((1 << 18) + sum_t C15 * vtap) >> 19, the same for Vi,
//        T(k) = sat((k * cy + y_base + 0x8000) >> 16),
//        D(c, q) = ((sat(c) * q) >> 16) - (q >> 9),
//        B = T(Yi + D(Ui, bu)), G = T(Yi + D(Ui, gu) + D(Vi, gv)),
//        R = T(Yi + D(Vi, rv)).
//    No dither, none of the 16-bit sums wraps.  The width is even and the
//    taps are more than two (at least 9 rows): ops/kernels.py refuses
//    other sizes.
//
// The turn is cv2's cv::rotate, as in yuv420_to_bgr.cu.
//
// What bounds it on this card: bytes.  A 480x640 10-bit frame reads
// 0.92 MB of planes and writes 0.92 MB of BGR, 1.84 MB in all: 0.55 us at
// 3.35 TB/s; 1080x1920 12.44 MB (3.71 us), 2160x3840 49.77 MB (14.86 us).
// An 8-bit frame reads half the planes: 479x640 1.38 MB (0.41 us),
// 1079x1920 9.32 MB (2.78 us).
//
// A thread a pixel would filter each chroma sample horizontally about 16
// times (once for each tap of the 2 x 2 x vsize pixels that read it), and
// under a quarter turn a warp would read 32 source rows with no line in
// common.  Here (yuv_tile.cuh) a block of 256 threads owns 32 x 64 pixels
// of the output (32 source rows x 64 columns, 64 x 32 turned) and
// - filters each chroma sample the tile's taps reach horizontally once:
//   a thread one chroma column of four chroma rows, its taps in
//   registers, the rows [vpos[r0], vpos[r_last] + vsize) of U and V read
//   along the row with all a thread's loads in flight together, into
//   shared memory (P10_CHROMA_WORDS a plane: 32 rows of 32 columns, or 64
//   of 16 turned; 32 or 64 source rows reach at most 20 or 36 chroma rows
//   at any height, tests/test_torch_yuv_tiles.py);
// - gives a thread eight pixels of one source row: their luma in one
//   16-byte (10-bit) or 8-byte (8-bit) load issued first (single bytes
//   where the row start is off the alignment), the vertical sum its
//   row's rule needs once a chroma column (the MMX high halves + 4 above
//   the last two rows, the C tables' (1 << 18) + sum on them), shared by
//   the pixel pair, and the pixels converted in registers;
// - puts the BGR words into a shared tile in the output's orientation and
//   writes its 32 rows of 192 bytes with 16-byte stores (store_tile).
// So each plane byte is read from device memory once and each chroma
// sample filtered once, and the stores are the same at every turn.
// Shared memory a block: 8,704 bytes of filtered chroma, 8,320 of BGR.

#include <cuda_runtime.h>
#include <stdint.h>

#include "yuv_rule.cuh"
#include "yuv_tile.cuh"
#include "yuv_chroma.cuh"

#define P10_THREADS 256
// a thread's pixels, of one source row
#define P10_PIXELS (TILE_ROWS * TILE_COLS / P10_THREADS)
// taps a column and a row at most: swscale's bicubic at 2x has one or
// four a column and four a row (tests/test_torch_yuv_tiles.py)
#define P10_MAX_TAPS 4
// filtered chroma samples a plane a tile holds: as many rows as the
// tile's vertical taps reach, at most (see above), of its chroma
// columns, a thread P10_ITEMS of them; each row padded by a word
#define P10_CHROMA_WORDS 1024
#define P10_ITEMS (P10_CHROMA_WORDS / P10_THREADS)
#define P10_CHROMA_SLOTS \
    (P10_CHROMA_WORDS + P10_CHROMA_WORDS / (TILE_ROWS / 2))

// A block's tile.  T: the sample type, uint8_t (8-bit) or uint16_t
// (10-bit); QUARTER: rotation is 90 or 270
template <typename T, bool QUARTER>
__device__ __forceinline__ void general_tile(
        const T* __restrict__ y, const T* __restrict__ u,
        const T* __restrict__ v, int y_pitch, int c_pitch,
        int height, int width, int rotation,
        const int* __restrict__ hpos, const int* __restrict__ htap,
        int hsize, const int* __restrict__ vpos,
        const int* __restrict__ vtap, int vsize, YuvRule rule,
        uint8_t* __restrict__ out) {
    __shared__ int chroma[2][P10_CHROMA_SLOTS];
    __shared__ uint32_t bgr[BGR_TILE_WORDS];
    constexpr int DEPTH = sizeof(T) == 1 ? 8 : 10;
    const TileMap m = tile_map<QUARTER>(height, width, rotation);
    const int tid = threadIdx.x;

    // this thread's pixels: source row r0 + sr, tile columns col..; their
    // luma and the row's vertical taps first, under the chroma's latency
    constexpr int ROW_THREADS = (QUARTER ? TILE_ROWS : TILE_COLS) / P10_PIXELS;
    const int sr = tid / ROW_THREADS;
    const int col = P10_PIXELS * (tid % ROW_THREADS);
    const bool mine = sr < m.th && col < m.tw;
    const int sy = m.r0 + sr;
    uint32_t luma[sizeof(T) * P10_PIXELS / 4];
    int vp = 0, taps[P10_MAX_TAPS];
    if (mine) {
        load_bytes<sizeof(T) * P10_PIXELS>(
            reinterpret_cast<const uint8_t*>(y + (size_t)sy * y_pitch + m.c0
                                             + col),
            sizeof(T) * min(P10_PIXELS, m.tw - col), luma);
        vp = vpos[sy];
#pragma unroll
        for (int t = 0; t < P10_MAX_TAPS; ++t)
            taps[t] = t < vsize ? vtap[sy * vsize + t] : 0;
    }

    // the chroma rows the tile's taps reach (vpos rises with the row),
    // filtered horizontally once each: a thread one chroma column of
    // P10_ITEMS rows, all their loads in flight together
    constexpr int CCOLS = (QUARTER ? TILE_ROWS : TILE_COLS) / 2;
    constexpr int PITCH = CCOLS + 1;
    const int first = vpos[m.r0];
    const int rows = min(vpos[m.r0 + m.th - 1] + vsize - first,
                         P10_CHROMA_WORDS / CCOLS);
    const int cc = tid % CCOLS, row0 = tid / CCOLS;
    if (cc < (m.tw >> 1)) {
        const int c = (m.c0 >> 1) + cc;
        const int x0 = hpos[c];
        int ht[P10_MAX_TAPS];
#pragma unroll
        for (int k = 0; k < P10_MAX_TAPS; ++k)
            ht[k] = k < hsize ? htap[c * hsize + k] : 0;
        int uh[P10_ITEMS], vh[P10_ITEMS];
#pragma unroll
        for (int i = 0; i < P10_ITEMS; ++i) {
            const int r = min(row0 + i * (P10_THREADS / CCOLS), rows - 1);
            const size_t at = (size_t)(first + r) * c_pitch + x0;
            uh[i] = vh[i] = 0;
#pragma unroll
            for (int k = 0; k < P10_MAX_TAPS; ++k) {
                if (k < hsize) {
                    uh[i] += (int)u[at + k] * ht[k];
                    vh[i] += (int)v[at + k] * ht[k];
                }
            }
        }
#pragma unroll
        for (int i = 0; i < P10_ITEMS; ++i) {
            const int r = row0 + i * (P10_THREADS / CCOLS);
            if (r < rows) {
                chroma[0][r * PITCH + cc] = min(uh[i] >> (DEPTH - 1), 32767);
                chroma[1][r * PITCH + cc] = min(vh[i] >> (DEPTH - 1), 32767);
            }
        }
    }
    __syncthreads();

    // the vertical sums once per (row, chroma column), the one its row's
    // rule needs, then its pixel pair
    if (mine) {
        const bool simd = sy < height - 2;
        uint32_t px[P10_PIXELS];
        // (columns past the picture: words never stored)
        const int at = (vp - first) * PITCH + (col >> 1);
        general_pairs<T, PITCH, P10_MAX_TAPS, P10_PIXELS>(
            chroma[0] + at, chroma[1] + at, simd, taps, vsize, luma,
            15 - DEPTH, rule, px);
        put_pixels<P10_PIXELS>(bgr, m, sr, col, min(P10_PIXELS, m.tw - col),
                               px);
    }
    __syncthreads();
    store_tile<P10_THREADS>(bgr, m, out);
}

// The kernel of each depth, named as its wrapper in ops/kernels.py (a
// profiler's record then names the route)
#define GENERAL_KERNEL(NAME, T)                                              \
    template <bool QUARTER>                                                  \
    __global__ void __launch_bounds__(P10_THREADS) NAME(                     \
            const T* __restrict__ y, const T* __restrict__ u,                \
            const T* __restrict__ v, int y_pitch, int c_pitch, int height,   \
            int width, int rotation, const int* __restrict__ hpos,           \
            const int* __restrict__ htap, int hsize,                         \
            const int* __restrict__ vpos, const int* __restrict__ vtap,      \
            int vsize, YuvRule rule, uint8_t* __restrict__ out) {            \
        general_tile<T, QUARTER>(y, u, v, y_pitch, c_pitch, height, width,   \
                                 rotation, hpos, htap, hsize, vpos, vtap,    \
                                 vsize, rule, out);                          \
    }
GENERAL_KERNEL(yuv420p10_to_bgr_kernel, uint16_t)
GENERAL_KERNEL(yuv420_general_to_bgr_kernel, uint8_t)

template <typename T>
using GeneralKernel = void (*)(const T*, const T*, const T*, int, int, int,
                               int, int, const int*, const int*, int,
                               const int*, const int*, int, YuvRule,
                               uint8_t*);

template <typename T>
static int launch_general(GeneralKernel<T> straight, GeneralKernel<T> turned,
                          const void* y, const void* u, const void* v,
                          int y_pitch, int c_pitch, int height, int width,
                          int rotation, const void* hpos, const void* htap,
                          int hsize, const void* vpos, const void* vtap,
                          int vsize, YuvRule rule, void* out, void* stream) {
    if (height <= 2 || width <= 0 || (width & 1) || y_pitch < width
            || c_pitch < width / 2 || hsize < 1 || hsize > P10_MAX_TAPS
            || vsize < 1 || vsize > P10_MAX_TAPS
            || (rotation != 0 && rotation != 90 && rotation != 180
                && rotation != 270))
        return (int)cudaErrorInvalidValue;
    const dim3 grid = tile_grid(height, width, rotation);
    const auto kernel = rotation == 90 || rotation == 270 ? turned : straight;
    kernel<<<grid, P10_THREADS, 0, (cudaStream_t)stream>>>(
        (const T*)y, (const T*)u, (const T*)v, y_pitch, c_pitch, height,
        width, rotation, (const int*)hpos, (const int*)htap, hsize,
        (const int*)vpos, (const int*)vtap, vsize, rule, (uint8_t*)out);
    return (int)cudaGetLastError();
}

extern "C" int rtpose_yuv420p10_to_bgr(
        const void* y, const void* u, const void* v, int y_pitch,
        int c_pitch, int height, int width, int rotation, const void* hpos,
        const void* htap, int hsize, const void* vpos, const void* vtap,
        int vsize, YuvRule rule, void* out, void* stream) {
    return launch_general<uint16_t>(
        yuv420p10_to_bgr_kernel<false>, yuv420p10_to_bgr_kernel<true>, y, u,
        v, y_pitch, c_pitch, height, width, rotation, hpos, htap, hsize, vpos,
        vtap, vsize, rule, out, stream);
}

extern "C" int rtpose_yuv420_general_to_bgr(
        const void* y, const void* u, const void* v, int y_pitch,
        int c_pitch, int height, int width, int rotation, const void* hpos,
        const void* htap, int hsize, const void* vpos, const void* vtap,
        int vsize, YuvRule rule, void* out, void* stream) {
    return launch_general<uint8_t>(
        yuv420_general_to_bgr_kernel<false>,
        yuv420_general_to_bgr_kernel<true>, y, u, v, y_pitch, c_pitch, height,
        width, rotation, hpos, htap, hsize, vpos, vtap, vsize, rule, out,
        stream);
}
