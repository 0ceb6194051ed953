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
//   row its own chroma row (chroma by nearest sample, of the pixel pair).
// - rtpose_yuv_planar_general_to_bgr: the scaling path at SWS_BICUBIC at
//   an even width, chroma shared by each pixel pair (2c, 2c + 1):
//   1. each chroma row filtered horizontally to the pairs,
//      C15[r][c] = min(sum_k C[r][hpos[c] + k] * htap[c][k] >> (D - 1),
//      32767), with swscale's 14-bit taps (4:2:2 and 4:2:0: one, or four
//      bicubic ones where the chroma location shifts it; 4:4:0: its 2x
//      bicubic down-filter, eight or twelve taps);
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
// written once: a 480x640 10-bit 4:2:2 frame 1.23 MB of planes and 0.92
// MB of BGR, 2.15 MB in all: 0.64 us at 3.35 TB/s; 1080x1920 10-bit 4:2:2
// 14.5 MB (4.33 us); 1080x1920 8-bit 4:4:4 12.4 MB (3.71 us); 1080x1920
// gray 8.3 MB (2.48 us).
//
// This is the simple form: a thread a pixel pair (general) or a pixel
// (the others), reading the planes directly through the cache; under a
// quarter turn its warp writes 32 output rows.  A tiled form in
// yuv_tile.cuh's manner is later work (PERF.md has its times).

#include <cuda_runtime.h>
#include <stdint.h>

#include "yuv_rule.cuh"

#define PLANAR_THREADS 256

// the byte offset of source pixel (r, c)'s BGR in the turned output
__device__ __forceinline__ size_t planar_out(int r, int c, int h, int w,
                                             int rotation) {
    int row = r, col = c, ow = w;
    if (rotation == 90) {
        row = c;
        col = h - 1 - r;
        ow = h;
    } else if (rotation == 180) {
        row = h - 1 - r;
        col = w - 1 - c;
    } else if (rotation == 270) {
        row = w - 1 - c;
        col = r;
        ow = h;
    }
    return 3 * ((size_t)row * ow + col);
}

__device__ __forceinline__ void planar_put(uint8_t* out, size_t at, int b,
                                           int g, int r) {
    out[at] = (uint8_t)b;
    out[at + 1] = (uint8_t)g;
    out[at + 2] = (uint8_t)r;
}

// swscale's horizontal filter of chroma row `row` at output column `x`,
// into the 15-bit intermediate
template <typename T>
__device__ __forceinline__ int planar_hfilter(
        const T* __restrict__ plane, int pitch, int row, int x,
        const int* __restrict__ hpos, const int* __restrict__ htap,
        int hsize, int shift) {
    const T* p = plane + (size_t)row * pitch + hpos[x];
    const int* t = htap + (size_t)x * hsize;
    int acc = 0;
    for (int k = 0; k < hsize; ++k) acc += (int)p[k] * t[k];
    acc >>= shift;
    return acc < 32767 ? acc : 32767;
}

__device__ __forceinline__ int planar_table(int k, const YuvRule& r) {
    return sat8((k * r.cy + r.y_base + 0x8000) >> 16);
}

__device__ __forceinline__ int planar_term(int c, int q) {
    c = c < 0 ? 0 : (c > 255 ? 255 : c);
    return ((c * q) >> 16) - (q >> 9);
}

__device__ __forceinline__ int planar_full_out(int v) {
    return (v < 0 ? 0 : (v > (1 << 30) - 1 ? (1 << 30) - 1 : v)) >> 22;
}

__global__ void __launch_bounds__(PLANAR_THREADS) yuv422_to_bgr_kernel(
        const uint8_t* __restrict__ y, const uint8_t* __restrict__ u,
        const uint8_t* __restrict__ v, int y_pitch, int c_pitch, int height,
        int width, int rotation, YuvRule rule, uint8_t* __restrict__ out) {
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (size_t)height * width) return;
    const int r = (int)(i / width), c = (int)(i % width);
    const size_t at = (size_t)r * c_pitch + (c >> 1);
    const int u8 = 8 * ((int)u[at] - 128), v8 = 8 * ((int)v[at] - 128);
    const int l = ((8 * (int)y[(size_t)r * y_pitch + c] - rule.y_offset)
                   * rule.luma) >> 16;
    planar_put(out, planar_out(r, c, height, width, rotation),
               sat8(l + ((u8 * rule.ub) >> 16)),
               sat8(l + ((u8 * rule.ug) >> 16) + ((v8 * rule.vg) >> 16)),
               sat8(l + ((v8 * rule.vr) >> 16)));
}

// a thread a pixel pair (2c, 2c + 1) of source row r
template <typename T>
__global__ void __launch_bounds__(PLANAR_THREADS)
yuv_planar_general_to_bgr_kernel(
        const T* __restrict__ y, const T* __restrict__ u,
        const T* __restrict__ v, int y_pitch, int c_pitch, int height,
        int width, int depth, int rotation, const int* __restrict__ hpos,
        const int* __restrict__ htap, int hsize,
        const int* __restrict__ vpos, const int* __restrict__ vtap,
        int vsize, YuvRule rule, uint8_t* __restrict__ out) {
    const int pairs = width >> 1;
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (size_t)height * pairs) return;
    const int r = (int)(i / pairs), c = (int)(i % pairs);
    const int shift = depth - 1;
    // the MMX sums (high halves) and the C sums, over the vertical taps
    int su = 0, sv = 0, cu = 1 << 18, cv = 1 << 18;
    int u15 = 0, v15 = 0;
    for (int t = 0; t < vsize; ++t) {
        const int row = vpos[r] + t, tap = vtap[(size_t)r * vsize + t];
        u15 = planar_hfilter(u, c_pitch, row, c, hpos, htap, hsize, shift);
        v15 = planar_hfilter(v, c_pitch, row, c, hpos, htap, hsize, shift);
        su += (u15 * tap) >> 16;
        sv += (v15 * tap) >> 16;
        cu += u15 * tap;
        cv += v15 * tap;
    }
    const T* yr = y + (size_t)r * y_pitch + 2 * c;
    const int y15[2] = {(int)yr[0] << (15 - depth),
                        (int)yr[1] << (15 - depth)};
    if (r < height - 2) {
        const bool one = vsize == 1;
        const int uu = (one ? u15 >> 4 : 4 + su) - 1024;
        const int vv = (one ? v15 >> 4 : 4 + sv) - 1024;
        const int b = (uu * rule.ub) >> 16;
        const int g = ((uu * rule.ug) >> 16) + ((vv * rule.vg) >> 16);
        const int rr = (vv * rule.vr) >> 16;
        for (int e = 0; e < 2; ++e) {
            const int l = (((one ? 0 : 4) + (y15[e] >> 4) - rule.y_offset)
                           * rule.luma) >> 16;
            planar_put(out, planar_out(r, 2 * c + e, height, width, rotation),
                       sat8(l + b), sat8(l + g), sat8(l + rr));
        }
        return;
    }
    const int ui = cu >> 19, vi = cv >> 19;
    const int b = planar_term(ui, rule.bu);
    const int g = planar_term(ui, rule.gu) + planar_term(vi, rule.gv);
    const int rr = planar_term(vi, rule.rv);
    for (int e = 0; e < 2; ++e) {
        const int l = ((y15[e] << 12) + (1 << 18)) >> 19;
        planar_put(out, planar_out(r, 2 * c + e, height, width, rotation),
                   planar_table(l + b, rule), planar_table(l + g, rule),
                   planar_table(l + rr, rule));
    }
}

// a thread a pixel (c, r)
template <typename T>
__global__ void __launch_bounds__(PLANAR_THREADS)
yuv_planar_full_chroma_to_bgr_kernel(
        const T* __restrict__ y, const T* __restrict__ u,
        const T* __restrict__ v, int y_pitch, int c_pitch, int height,
        int width, int depth, int rotation, const int* __restrict__ hpos,
        const int* __restrict__ htap, int hsize,
        const int* __restrict__ vpos, const int* __restrict__ vtap,
        int vsize, YuvRule rule, uint8_t* __restrict__ out) {
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (size_t)height * width) return;
    const int r = (int)(i / width), c = (int)(i % width);
    const int shift = depth - 1;
    int su = (1 << 9) - (128 << 19), sv = su;
    for (int t = 0; t < vsize; ++t) {
        const int row = vpos[r] + t, tap = vtap[(size_t)r * vsize + t];
        su += planar_hfilter(u, c_pitch, row, c, hpos, htap, hsize, shift)
              * tap;
        sv += planar_hfilter(v, c_pitch, row, c, hpos, htap, hsize, shift)
              * tap;
    }
    const uint32_t U = (uint32_t)(su >> 10), V = (uint32_t)(sv >> 10);
    const int y15 = (int)y[(size_t)r * y_pitch + c] << (15 - depth);
    const uint32_t l = (uint32_t)((y15 << 2) - (rule.y_offset << 6))
                       * (uint32_t)rule.luma + (1u << 21);
    planar_put(out, planar_out(r, c, height, width, rotation),
               planar_full_out((int)(l + U * (uint32_t)rule.ub)),
               planar_full_out((int)(l + V * (uint32_t)rule.vg
                                     + U * (uint32_t)rule.ug)),
               planar_full_out((int)(l + V * (uint32_t)rule.vr)));
}

template <typename T>
__global__ void __launch_bounds__(PLANAR_THREADS) gray_to_bgr_kernel(
        const T* __restrict__ y, int y_pitch, int height, int width,
        int depth, int rotation, uint8_t* __restrict__ out) {
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (size_t)height * width) return;
    const int r = (int)(i / width), c = (int)(i % width);
    const int g = (((int)y[(size_t)r * y_pitch + c] << (15 - depth)) + 64)
                  >> 7;
    const int s = g < 255 ? g : 255;
    planar_put(out, planar_out(r, c, height, width, rotation), s, s, s);
}

static bool planar_bad(int height, int width, int y_pitch, int rotation,
                       int depth) {
    return height <= 0 || width <= 0 || y_pitch < width
           || (depth != 8 && depth != 10 && depth != 12)
           || (rotation != 0 && rotation != 90 && rotation != 180
               && rotation != 270);
}

static unsigned planar_blocks(size_t items) {
    return (unsigned)((items + PLANAR_THREADS - 1) / PLANAR_THREADS);
}

extern "C" int rtpose_yuv422_to_bgr(const void* y, const void* u,
                                    const void* v, int y_pitch, int c_pitch,
                                    int height, int width, int rotation,
                                    YuvRule rule, void* out, void* stream) {
    if (planar_bad(height, width, y_pitch, rotation, 8)
            || c_pitch < (width + 1) / 2)
        return (int)cudaErrorInvalidValue;
    yuv422_to_bgr_kernel<<<planar_blocks((size_t)height * width),
                           PLANAR_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)y, (const uint8_t*)u, (const uint8_t*)v, y_pitch,
        c_pitch, height, width, rotation, rule, (uint8_t*)out);
    return (int)cudaGetLastError();
}

template <typename T>
static void launch_planar(bool full, size_t items, cudaStream_t stream,
                          const void* y, const void* u, const void* v,
                          int y_pitch, int c_pitch, int height, int width,
                          int depth, int rotation, const void* hpos,
                          const void* htap, int hsize, const void* vpos,
                          const void* vtap, int vsize, YuvRule rule,
                          void* out) {
    const auto kernel = full ? yuv_planar_full_chroma_to_bgr_kernel<T>
                             : yuv_planar_general_to_bgr_kernel<T>;
    kernel<<<planar_blocks(items), PLANAR_THREADS, 0, stream>>>(
        (const T*)y, (const T*)u, (const T*)v, y_pitch, c_pitch, height,
        width, depth, rotation, (const int*)hpos, (const int*)htap, hsize,
        (const int*)vpos, (const int*)vtap, vsize, rule, (uint8_t*)out);
}

static int planar_entry(bool full, const void* y, const void* u,
                        const void* v, int y_pitch, int c_pitch, int height,
                        int width, int depth, int rotation, const void* hpos,
                        const void* htap, int hsize, const void* vpos,
                        const void* vtap, int vsize, YuvRule rule, void* out,
                        void* stream) {
    if (planar_bad(height, width, y_pitch, rotation, depth) || c_pitch <= 0
            || hsize <= 0 || vsize <= 0 || (!full && width % 2))
        return (int)cudaErrorInvalidValue;
    const size_t items = (size_t)height * (full ? width : width / 2);
    if (depth == 8)
        launch_planar<uint8_t>(full, items, (cudaStream_t)stream, y, u, v,
                               y_pitch, c_pitch, height, width, depth,
                               rotation, hpos, htap, hsize, vpos, vtap,
                               vsize, rule, out);
    else
        launch_planar<uint16_t>(full, items, (cudaStream_t)stream, y, u, v,
                                y_pitch, c_pitch, height, width, depth,
                                rotation, hpos, htap, hsize, vpos, vtap,
                                vsize, rule, out);
    return (int)cudaGetLastError();
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

extern "C" int rtpose_gray_to_bgr(const void* y, int y_pitch, int height,
                                  int width, int depth, int rotation,
                                  void* out, void* stream) {
    if (planar_bad(height, width, y_pitch, rotation, depth))
        return (int)cudaErrorInvalidValue;
    const unsigned blocks = planar_blocks((size_t)height * width);
    if (depth == 8)
        gray_to_bgr_kernel<uint8_t><<<blocks, PLANAR_THREADS, 0,
                                      (cudaStream_t)stream>>>(
            (const uint8_t*)y, y_pitch, height, width, depth, rotation,
            (uint8_t*)out);
    else
        gray_to_bgr_kernel<uint16_t><<<blocks, PLANAR_THREADS, 0,
                                       (cudaStream_t)stream>>>(
            (const uint16_t*)y, y_pitch, height, width, depth, rotation,
            (uint8_t*)out);
    return (int)cudaGetLastError();
}
