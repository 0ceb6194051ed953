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
// This first design is a thread an output pixel, in output order (a row
// of the turned output a grid row): each thread reads its luma sample and
// the vsize x hsize chroma samples of each plane its taps reach (through
// the caches: its neighbours read the same ones), filters them and writes
// its three bytes.  It filters each chroma sample horizontally up to 16
// times and writes bytes, not words; the shared-memory tiles of
// yuv420p10_to_bgr.cu are the way to a faster one.

#include <cuda_runtime.h>
#include <stdint.h>

#include "yuv_rule.cuh"

#define FC_THREADS 256
// taps a column and a row at most: swscale's bicubic at 2x has four
#define FC_MAX_TAPS 4

// v clipped to [0, 2^30) (av_clip_uintp2(v, 30)), then its top eight bits
__device__ __forceinline__ uint8_t full_out(int v) {
    return (uint8_t)((v < 0 ? 0 : (v > (1 << 30) - 1 ? (1 << 30) - 1 : v))
                     >> 22);
}

// T: the sample type, uint8_t (8-bit) or uint16_t (10-bit); named as its
// wrapper in ops/kernels.py (a profiler's record then names the route)
template <typename T>
__global__ void __launch_bounds__(FC_THREADS)
yuv420_full_chroma_to_bgr_kernel(
        const T* __restrict__ y, const T* __restrict__ u,
        const T* __restrict__ v, int y_pitch, int c_pitch, int height,
        int width, int rotation, const int* __restrict__ hpos,
        const int* __restrict__ htap, int hsize,
        const int* __restrict__ vpos, const int* __restrict__ vtap,
        int vsize, YuvRule rule, uint8_t* __restrict__ out) {
    constexpr int DEPTH = sizeof(T) == 1 ? 8 : 10;
    const bool quarter = rotation == 90 || rotation == 270;
    const int out_w = quarter ? height : width;
    const int i = blockIdx.y, j = blockIdx.x * FC_THREADS + threadIdx.x;
    if (j >= out_w) return;
    int sy, sx;          // cv::rotate: output (i, j) reads source (sy, sx)
    if (rotation == 90) {
        sy = height - 1 - j; sx = i;
    } else if (rotation == 180) {
        sy = height - 1 - i; sx = width - 1 - j;
    } else if (rotation == 270) {
        sy = j; sx = width - 1 - i;
    } else {
        sy = i; sx = j;
    }
    const int y15 = (int)y[(size_t)sy * y_pitch + sx] << (15 - DEPTH);
    const int x0 = hpos[sx], r0 = vpos[sy];
    int su = (1 << 9) - (128 << 19), sv = su;
#pragma unroll
    for (int t = 0; t < FC_MAX_TAPS; ++t) {
        if (t < vsize) {
            const size_t row = (size_t)(r0 + t) * c_pitch + x0;
            int hu = 0, hv = 0;
#pragma unroll
            for (int k = 0; k < FC_MAX_TAPS; ++k) {
                if (k < hsize) {
                    const int tap = htap[sx * hsize + k];
                    hu += (int)u[row + k] * tap;
                    hv += (int)v[row + k] * tap;
                }
            }
            const int tap = vtap[sy * vsize + t];
            su += min(hu >> (DEPTH - 1), 32767) * tap;
            sv += min(hv >> (DEPTH - 1), 32767) * tap;
        }
    }
    su >>= 10;
    sv >>= 10;
    const int yy = ((1 << 9) + (y15 << 12)) >> 10;
    const uint32_t l = (uint32_t)((yy - (rule.y_offset << 6)) * rule.luma
                                  + (1 << 21));
    const uint32_t U = (uint32_t)su, V = (uint32_t)sv;
    uint8_t* px = out + 3 * ((size_t)i * out_w + j);
    px[0] = full_out((int)(l + U * (uint32_t)rule.ub));
    px[1] = full_out((int)(l + V * (uint32_t)rule.vg
                           + U * (uint32_t)rule.ug));
    px[2] = full_out((int)(l + V * (uint32_t)rule.vr));
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
    const bool quarter = rotation == 90 || rotation == 270;
    const int out_w = quarter ? height : width;
    const dim3 grid((out_w + FC_THREADS - 1) / FC_THREADS,
                    quarter ? width : height);
    if (depth == 8)
        yuv420_full_chroma_to_bgr_kernel<uint8_t>
            <<<grid, FC_THREADS, 0, (cudaStream_t)stream>>>(
                (const uint8_t*)y, (const uint8_t*)u, (const uint8_t*)v,
                y_pitch, c_pitch, height, width, rotation, (const int*)hpos,
                (const int*)htap, hsize, (const int*)vpos, (const int*)vtap,
                vsize, rule, (uint8_t*)out);
    else
        yuv420_full_chroma_to_bgr_kernel<uint16_t>
            <<<grid, FC_THREADS, 0, (cudaStream_t)stream>>>(
                (const uint16_t*)y, (const uint16_t*)u, (const uint16_t*)v,
                y_pitch, c_pitch, height, width, rotation, (const int*)hpos,
                (const int*)htap, hsize, (const int*)vpos, (const int*)vtap,
                vsize, rule, (uint8_t*)out);
    return (int)cudaGetLastError();
}
