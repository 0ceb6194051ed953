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
// source rows a warp and write BGR a byte at a time.  Here it converts in
// the tiles of yuv_tile.cuh (yuv_unscaled.cuh, which the 4:2:2 kernel
// shares, says how): each plane byte is read from device memory once,
// and the stores are the same at every turn.

#include <cuda_runtime.h>
#include <stdint.h>

#include "yuv_rule.cuh"
#include "yuv_tile.cuh"
#include "yuv_unscaled.cuh"

UNSCALED_KERNEL(yuv420_to_bgr_kernel, 1)

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
