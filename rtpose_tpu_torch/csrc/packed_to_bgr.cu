// Packed RGB (bgr0, bgra: 4 bytes a pixel; bgr24, rgb24: 3) to BGR with a
// quarter turn, hand-written for Hopper: the card's counterpart of what
// cv2.VideoCapture does with a decoded frame of the lossless codecs that
// archive lab recordings and datasets (HuffYUV's bgr0, FFV1's bgra, as
// cv2's own VideoWriter writes them) and of raw RGB video.
//
// Replaces no TPU kernel.  The JAX demo reads video through cv2
// (rtpose_tpu/demo/video_demo.py:19-24), whose swscale converts each
// decoded frame; the port decodes on the host (native/avcodec.py) and
// converts here.  swscale's unscaled packed-to-packed conversion to bgr24
// is a byte shuffle, exact at every size: rgb32to24 for bgr0 and bgra
// (the fourth byte dropped), a copy for bgr24, the first and third bytes
// swapped for rgb24.  It equals its plain version in ops/kernels.py
// (packed_to_bgr_plain) and, through it, libswscale and cv2 5.0's frames
// (tests/test_torch_cv2_writer.py).  The turn is cv2's cv::rotate: output
// (i, j) reads source (H-1-j, i) at 90 (clockwise), (H-1-i, W-1-j) at 180
// and (j, W-1-i) at 270.
//
// What bounds it on this card: bytes, the frame read once and the BGR
// written once, (4 + 3) or (3 + 3) bytes a pixel at 3.35 TB/s: 480x640
// bgr0 2.15 MB (0.64 us), 1080x1920 bgr0 14.52 MB (4.33 us), bgr24
// 12.44 MB (3.71 us).
//
// It converts in the tiles of yuv_tile.cuh, as the colour kernels do: a
// block of 256 threads owns 32 x 64 pixels of the output (32 source rows
// x 64 columns, 64 x 32 turned); a thread owns eight pixels of one source
// row, their 32 bytes in two 16-byte loads (bgr0 / bgra) or their 24 in
// three 8-byte loads (bgr24 / rgb24; single bytes where a row start is
// off the alignment, or at the ragged edge), and puts their BGR words
// into a shared tile in the output's orientation (8,320 bytes), which the
// block writes with 16-byte stores (store_tile), the same at every turn.
// So each source byte is read from device memory once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "yuv_tile.cuh"

#define PACKED_THREADS 256
// a thread's pixels, of one source row
#define PACKED_PIXELS (TILE_ROWS * TILE_COLS / PACKED_THREADS)

// BPP: bytes a source pixel (3 or 4); SWAP: the pixel holds R, G, B (not
// B, G, R); QUARTER: rotation is 90 or 270
template <int BPP, bool SWAP, bool QUARTER>
__global__ void __launch_bounds__(PACKED_THREADS) packed_to_bgr_kernel(
        const uint8_t* __restrict__ src, int pitch, int height, int width,
        int rotation, uint8_t* __restrict__ out) {
    constexpr int N = PACKED_PIXELS;
    // the loads of a thread's N pixels: LOADS of LOAD bytes
    constexpr int LOAD = BPP == 4 ? 16 : 8;
    constexpr int LOADS = BPP * N / LOAD;
    __shared__ uint32_t bgr[BGR_TILE_WORDS];
    const TileMap m = tile_map<QUARTER>(height, width, rotation);
    // this thread's pixels: source row r0 + sr, tile columns col..
    constexpr int ROW_THREADS = (QUARTER ? TILE_ROWS : TILE_COLS) / N;
    const int sr = threadIdx.x / ROW_THREADS;
    const int col = N * (threadIdx.x % ROW_THREADS);
    if (sr < m.th && col < m.tw) {
        const int n = min(N, m.tw - col);
        const uint8_t* p = src + (size_t)(m.r0 + sr) * pitch
                           + (size_t)BPP * (m.c0 + col);
        uint32_t w[BPP * N / 4];
#pragma unroll
        for (int k = 0; k < LOADS; ++k)
            load_bytes<LOAD>(p + k * LOAD, min(LOAD, BPP * n - k * LOAD),
                             w + k * (LOAD / 4));
        uint32_t px[N];
#pragma unroll
        for (int k = 0; k < N; ++k) {
            const int c0 = byte_of(w, BPP * k);
            const int c1 = byte_of(w, BPP * k + 1);
            const int c2 = byte_of(w, BPP * k + 2);
            px[k] = SWAP ? bgr_word(c2, c1, c0) : bgr_word(c0, c1, c2);
        }
        put_pixels<N>(bgr, m, sr, col, n, px);
    }
    __syncthreads();
    store_tile<PACKED_THREADS>(bgr, m, out);
}

template <int BPP, bool SWAP>
static void launch_packed(const void* src, int pitch, int height, int width,
                          int rotation, void* out, cudaStream_t stream) {
    const auto kernel = rotation == 90 || rotation == 270
                        ? packed_to_bgr_kernel<BPP, SWAP, true>
                        : packed_to_bgr_kernel<BPP, SWAP, false>;
    kernel<<<tile_grid(height, width, rotation), PACKED_THREADS, 0,
             stream>>>((const uint8_t*)src, pitch, height, width, rotation,
                       (uint8_t*)out);
}

// bpp 4 (bgr0, bgra; swap 0) or 3 (bgr24 swap 0, rgb24 swap 1)
extern "C" int rtpose_packed_to_bgr(const void* src, int pitch, int height,
                                    int width, int bpp, int swap,
                                    int rotation, void* out, void* stream) {
    if (height <= 0 || width <= 0 || (bpp != 3 && bpp != 4)
            || (swap && bpp != 3) || pitch < bpp * width
            || (rotation != 0 && rotation != 90 && rotation != 180
                && rotation != 270))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    if (bpp == 4)
        launch_packed<4, false>(src, pitch, height, width, rotation, out, s);
    else if (swap)
        launch_packed<3, true>(src, pitch, height, width, rotation, out, s);
    else
        launch_packed<3, false>(src, pitch, height, width, rotation, out, s);
    return (int)cudaGetLastError();
}
