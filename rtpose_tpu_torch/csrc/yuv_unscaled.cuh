// swscale's unscaled yuv420p / yuv422p -> bgr24 in the tiles of
// yuv_tile.cuh, shared by the 4:2:0 kernel (yuv420_to_bgr.cu) and the
// 4:2:2 one (yuv_planar_to_bgr.cu), which differ only in the chroma row
// a luma row reads: sy >> 1 at 4:2:0, sy itself at 4:2:2.  The rule is
// yuv420_to_bgr.cu's (its header states it and its bounds).
//
// A block of 256 threads owns 32 x 64 pixels of the output (32 source
// rows x 64 columns, 64 x 32 turned).  A thread takes eight pixels of one
// source row: their luma in one 8-byte load and each chroma plane's four
// samples in one 4-byte load (single bytes where a row start is off, or
// at the ragged edge; the chroma of each pixel by its own index, so odd
// sizes stay right), the chroma terms once a pair, the pixels converted
// in registers.  It puts the BGR words into a shared tile in the output's
// orientation (8,320 bytes), and the block writes the tile's 32 rows of
// 192 bytes with 16-byte stores.  So each plane byte is read from device
// memory once, and the stores are the same at every turn.
#pragma once

#include <stdint.h>

#include "yuv_rule.cuh"
#include "yuv_tile.cuh"

#define YUV_THREADS 256
// a thread's pixels, of one source row
#define YUV_PIXELS (TILE_ROWS * TILE_COLS / YUV_THREADS)

// QUARTER: rotation is 90 or 270; CROW: the chroma row of source row sy
// is sy >> CROW (1 at 4:2:0, 0 at 4:2:2)
template <bool QUARTER, int CROW>
__device__ __forceinline__ void unscaled_tile(
        const uint8_t* __restrict__ y, const uint8_t* __restrict__ u,
        const uint8_t* __restrict__ v, int y_pitch, int c_pitch, int height,
        int width, int rotation, YuvRule rule,
        uint8_t* __restrict__ out) {
    __shared__ uint32_t bgr[BGR_TILE_WORDS];
    const TileMap m = tile_map<QUARTER>(height, width, rotation);
    // this thread's pixels: source row r0 + sr, tile columns col..
    constexpr int ROW_THREADS = (QUARTER ? TILE_ROWS : TILE_COLS) / YUV_PIXELS;
    const int sr = threadIdx.x / ROW_THREADS;
    const int col = YUV_PIXELS * (threadIdx.x % ROW_THREADS);
    if (sr < m.th && col < m.tw) {
        const int sy = m.r0 + sr, n = min(YUV_PIXELS, m.tw - col);
        uint32_t yw[YUV_PIXELS / 4], uw[(YUV_PIXELS / 2 + 3) / 4],
                 vw[(YUV_PIXELS / 2 + 3) / 4];
        load_bytes<YUV_PIXELS>(y + (size_t)sy * y_pitch + m.c0 + col, n, yw);
        const size_t c = (size_t)(sy >> CROW) * c_pitch
                         + ((m.c0 + col) >> 1);
        load_bytes<YUV_PIXELS / 2>(u + c, (n + 1) >> 1, uw);
        load_bytes<YUV_PIXELS / 2>(v + c, (n + 1) >> 1, vw);
        uint32_t px[YUV_PIXELS];
#pragma unroll
        for (int q = 0; q < YUV_PIXELS / 2; ++q) {
            const int u8 = 8 * (byte_of(uw, q) - 128);
            const int v8 = 8 * (byte_of(vw, q) - 128);
            const int b = (u8 * rule.ub) >> 16;
            const int g = ((u8 * rule.ug) >> 16) + ((v8 * rule.vg) >> 16);
            const int r = (v8 * rule.vr) >> 16;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int yy = ((8 * byte_of(yw, 2 * q + e) - rule.y_offset)
                                * rule.luma) >> 16;
                px[2 * q + e] = bgr_word(sat8(yy + b), sat8(yy + g),
                                         sat8(yy + r));
            }
        }
        put_pixels<YUV_PIXELS>(bgr, m, sr, col, n, px);
    }
    __syncthreads();
    store_tile<YUV_THREADS>(bgr, m, out);
}

// The kernel of each unscaled entry, named as its wrapper in
// ops/kernels.py (a profiler's record then names the route)
#define UNSCALED_KERNEL(NAME, CROW)                                          \
    template <bool QUARTER>                                                  \
    __global__ void __launch_bounds__(YUV_THREADS) NAME(                     \
            const uint8_t* __restrict__ y, const uint8_t* __restrict__ u,    \
            const uint8_t* __restrict__ v, int y_pitch, int c_pitch,         \
            int height, int width, int rotation, YuvRule rule,               \
            uint8_t* __restrict__ out) {                                     \
        unscaled_tile<QUARTER, CROW>(y, u, v, y_pitch, c_pitch, height,      \
                                     width, rotation, rule, out);            \
    }
