// 4:2:0 (I420: Y, U and V planes, each with its own row pitch) to BGR with
// a quarter turn, hand-written for Hopper: the card's counterpart of the
// conversion cv2.VideoCapture runs on every frame it decodes.
//
// Replaces no TPU kernel.  The JAX demo reads video through cv2
// (rtpose_tpu/demo/video_demo.py:19-27), whose FFmpeg backend converts each
// decoded yuv420p frame with swscale's unscaled yuv420p -> bgr24 and then
// turns it by the stream's rotation (CAP_PROP_ORIENTATION_AUTO).  The port
// decodes on the host (native/avcodec.py: the card's NVDEC refuses every
// call on the machine it runs on) and converts here.
//
// The arithmetic is swscale's 16-bit SIMD path (its unscaled yuv420p ->
// bgr24) as cv2 5.0's frames show it, found by decoding I_PCM frames of
// every (Y, U, V) and equal to them at all 2^24 triples of each (matrix,
// range) pair and at every width tried; chroma by nearest sample (the one
// of the pixel's 2x2 block), and
//   y' = ((8 Y - o) * cy) >> 16
//   B  = sat(y' + ((8 (U - 128) * ub) >> 16))
//   G  = sat(y' + ((8 (U - 128) * ug) >> 16) + ((8 (V - 128) * vg) >> 16))
//   R  = sat(y' + ((8 (V - 128) * vr) >> 16))
// with >> an arithmetic shift (pmulhw keeps the high half of the product)
// and sat a clamp to [0, 255].  The constants come with each call (the
// rule struct: ops/kernels.py yuv_rule derives them as swscale's
// ff_yuv2rgb_c_init_tables does from the stream's matrix and range).
// Limited range: o = 128, cy = 9539 (255/219 in 1/8192); full range
// (yuvj420p, or a stream whose VUI / container says so): o = 0, cy = 8192,
// so y' = Y, and each chroma coefficient is the limited one's times
// 224/255.  (cy, ub, ug, vg, vr) by matrix, limited | full:
//   BT.601 (2, 5, 6)  9539 16525 -3209 -6660 13075 | 8192 14516 -2819 -5850 11485
//   BT.709 (1)        9539 17305 -1747 -4366 14686 | 8192 15201 -1534 -3835 12901
//   FCC (4)           9539 16600 -3095 -6639 13056 | 8192 14582 -2719 -5831 11469
//   SMPTE 240M (7)    9539 17029 -2113 -4445 14697 | 8192 14959 -1856 -3904 12911
//   BT.2020 NCL (9)   9539 17545 -1535 -5328 13752 | 8192 15412 -1348 -4680 12080
//
// The turn is cv2's cv::rotate: output (i, j) reads
// source (H-1-j, i) at 90 (clockwise), (H-1-i, W-1-j) at 180 and
// (j, W-1-i) at 270.
//
// What bounds it on this card: bytes.  A 480x640 frame reads 0.46 MB of
// planes and writes 0.92 MB of BGR, 1.38 MB in all: 0.41 us at 3.35 TB/s;
// 1080x1920 9.33 MB (2.79 us).
//
// A thread a few output pixels would, under a quarter turn, read 32
// source rows a warp and write BGR a byte at a time.  Here (yuv_tile.cuh)
// a block of 256 threads owns 32 x 64 pixels of the output (32 source
// rows x 64 columns, 64 x 32 turned).  A thread takes eight pixels of one
// source row: their luma in one 8-byte load and each chroma plane's four
// samples in one 4-byte load (single bytes where a row start is off, or
// at the ragged edge; the chroma of each pixel by its own index, so odd
// sizes stay right), the chroma terms once a pair, the pixels converted
// in registers.  It puts the BGR words into a shared tile in the output's
// orientation (8,320 bytes), and the block writes the tile's 32 rows of
// 192 bytes with 16-byte stores.  So each plane byte is read from device
// memory once, and the stores are the same at every turn.

#include <cuda_runtime.h>
#include <stdint.h>

#include "yuv_rule.cuh"
#include "yuv_tile.cuh"

#define YUV_THREADS 256
// a thread's pixels, of one source row
#define YUV_PIXELS (TILE_ROWS * TILE_COLS / YUV_THREADS)

// QUARTER: rotation is 90 or 270
template <bool QUARTER>
__global__ void __launch_bounds__(YUV_THREADS) yuv420_to_bgr_kernel(
        const uint8_t* __restrict__ y, const uint8_t* __restrict__ u,
        const uint8_t* __restrict__ v, int y_pitch, int c_pitch, int height,
        int width, int rotation, YuvRule rule, uint8_t* __restrict__ out) {
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
        const size_t c = (size_t)(sy >> 1) * c_pitch + ((m.c0 + col) >> 1);
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

extern "C" int rtpose_yuv420_to_bgr(const void* y, const void* u,
                                    const void* v, int y_pitch, int c_pitch,
                                    int height, int width, int rotation,
                                    YuvRule rule, void* out, void* stream) {
    if (height <= 0 || width <= 0 || y_pitch < width
            || c_pitch < (width + 1) / 2
            || (rotation != 0 && rotation != 90 && rotation != 180
                && rotation != 270))
        return (int)cudaErrorInvalidValue;
    const dim3 grid = tile_grid(height, width, rotation);
    const auto kernel = rotation == 90 || rotation == 270
                        ? yuv420_to_bgr_kernel<true>
                        : yuv420_to_bgr_kernel<false>;
    kernel<<<grid, YUV_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)y, (const uint8_t*)u, (const uint8_t*)v, y_pitch,
        c_pitch, height, width, rotation, rule, (uint8_t*)out);
    return (int)cudaGetLastError();
}
