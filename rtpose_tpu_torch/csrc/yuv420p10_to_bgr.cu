// 10-bit 4:2:0 (yuv420p10le: Y, U and V planes of 16-bit samples below
// 1024, each with its own row pitch) to 8-bit BGR with a quarter turn,
// hand-written for Hopper: the card's counterpart of what cv2.VideoCapture
// does with a decoded HEVC Main 10, H.264 High 10 or VP9 profile 2 frame.
//
// Replaces no TPU kernel.  The JAX demo reads video through cv2
// (rtpose_tpu/demo/video_demo.py:19-27).  swscale has no unscaled path
// from yuv420p10le to bgr24, so cv2 5.0's frame goes through its general
// (scaling) path at SWS_BICUBIC, the source chroma placed by the frame's
// chroma location; the port decodes on the host (native/avcodec.py) and
// converts here.  The rule below was found against cv2 5.0's frames of
// 10-bit PCM streams and swscale itself (tests/test_torch_colour.py),
// equal to them at every pixel of random fields at each size, chroma
// location and (matrix, range) tried:
//
// 1. Into swscale's 15-bit intermediate: luma Y15 = Y << 5 (an identity
//    filter, 16384 >> 9); each chroma row filtered horizontally,
//    C15[r][c] = min(sum_k C[r][hpos[c] + k] * htap[c][k] >> 9, 32767),
//    with 14-bit taps (hsize of them: one, 16384, where the chroma sits
//    at the centre of its pixel pair; four bicubic ones, B 0 and C 0.6,
//    where it sits left, as H.264 and HEVC place it).
// 2. Each output row sy takes vsize chroma rows vpos[sy] + t with 12-bit
//    bicubic taps vtap[sy][t] (2x upsampling; rows past the edges folded
//    onto the edge taps).  The taps are swscale's initFilter's, made on
//    the host (ops/kernels.py sws_filter) and passed in.
// 3. Output, one chroma value for each pixel pair (2c, 2c + 1):
//    - rows above the last two (swscale's MMX yuv2bgr24_X, whose
//      vertical filter keeps the high half of each product):
//        U' = 4 + sum_t ((C15 * vtap) >> 16) - 1024, the same for V;
//        y' = ((4 + 2 Y - y_offset) * luma) >> 16,
//      then B, G and R as in the 8-bit kernel (yuv420_to_bgr.cu) on y',
//      U' and V' with the rule's 16-bit coefficients;
//    - the last two rows (swscale leaves its MMX filter there and takes
//      the C yuv2rgb_X template with its tables):
//        Yi = ((Y << 17) + (1 << 18)) >> 19 (that is (Y + 2) >> 2),
//        Ui = ((1 << 18) + sum_t C15 * vtap) >> 19, the same for Vi,
//        T(k) = sat((k * cy + y_base + 0x8000) >> 16),
//        D(c, q) = ((sat(c) * q) >> 16) - (q >> 9),
//        B = T(Yi + D(Ui, bu)), G = T(Yi + D(Ui, gu) + D(Vi, gv)),
//        R = T(Yi + D(Vi, rv)).
//    No dither, none of the 16-bit sums wraps.  The width is even (an
//    odd one takes swscale's full-chroma output, not this rule) and the
//    taps are more than two (at least 9 rows): ops/kernels.py refuses
//    other sizes.
//
// The turn is in the write index, cv2's cv::rotate, as in
// yuv420_to_bgr.cu.
//
// What bounds it on this card: bytes.  A 480x640 frame reads 0.92 MB of
// planes and writes 0.92 MB of BGR, 1.84 MB in all: 0.55 us at 3.35 TB/s.
// A thread takes one output pixel and reads the chroma taps it needs
// (hsize x vsize samples a plane, from L1 and L2); a simple kernel, not
// yet tuned to share the filtered chroma between the pixels of a block.

#include <cuda_runtime.h>
#include <stdint.h>

#include "yuv_rule.cuh"

#define P10_BLOCK_X 32
#define P10_BLOCK_Y 8
#define P10_MAX_TAPS 8

__device__ __forceinline__ int table_bgr(int k, const YuvRule& r) {
    return sat8((k * r.cy + r.y_base + 0x8000) >> 16);
}

__device__ __forceinline__ int table_term(int c, int q) {
    c = c < 0 ? 0 : (c > 255 ? 255 : c);
    return ((c * q) >> 16) - (q >> 9);
}

__global__ void yuv420p10_to_bgr_kernel(
        const uint16_t* __restrict__ y, const uint16_t* __restrict__ u,
        const uint16_t* __restrict__ v, int y_pitch, int c_pitch,
        int height, int width, int rotation,
        const int* __restrict__ hpos, const int* __restrict__ htap,
        int hsize, const int* __restrict__ vpos,
        const int* __restrict__ vtap, int vsize, YuvRule rule,
        uint8_t* __restrict__ out) {
    const bool quarter = rotation == 90 || rotation == 270;
    const int out_h = quarter ? width : height;
    const int out_w = quarter ? height : width;
    const int i = blockIdx.y * P10_BLOCK_Y + threadIdx.y;
    const int j = blockIdx.x * P10_BLOCK_X + threadIdx.x;
    if (i >= out_h || j >= out_w) return;
    int sy, sx;
    if (rotation == 90) {
        sy = height - 1 - j; sx = i;
    } else if (rotation == 180) {
        sy = height - 1 - i; sx = width - 1 - j;
    } else if (rotation == 270) {
        sy = j; sx = width - 1 - i;
    } else {
        sy = i; sx = j;
    }
    const int c = sx >> 1;
    const int* ht = htap + c * hsize;
    const int col0 = hpos[c];
    int u_simd = 4, v_simd = 4;
    int u_c = 1 << 18, v_c = 1 << 18;
    for (int t = 0; t < vsize; ++t) {
        const int row = (vpos[sy] + t) * c_pitch + col0;
        const int tap = vtap[sy * vsize + t];
        int uh = 0, vh = 0;
        for (int k = 0; k < hsize; ++k) {
            uh += (int)u[row + k] * ht[k];
            vh += (int)v[row + k] * ht[k];
        }
        uh = min(uh >> 9, 32767);
        vh = min(vh >> 9, 32767);
        u_simd += (uh * tap) >> 16;
        v_simd += (vh * tap) >> 16;
        u_c += uh * tap;
        v_c += vh * tap;
    }
    const int luma = (int)y[sy * y_pitch + sx];
    uint8_t* px = out + 3 * (i * out_w + j);
    if (sy < height - 2) {
        const int yy = ((4 + 2 * luma - rule.y_offset) * rule.luma) >> 16;
        const int su = u_simd - 1024, sv = v_simd - 1024;
        px[0] = sat8(yy + ((su * rule.ub) >> 16));
        px[1] = sat8(yy + ((su * rule.ug) >> 16) + ((sv * rule.vg) >> 16));
        px[2] = sat8(yy + ((sv * rule.vr) >> 16));
    } else {
        const int yi = ((luma << 17) + (1 << 18)) >> 19;
        const int ui = u_c >> 19, vi = v_c >> 19;
        px[0] = table_bgr(yi + table_term(ui, rule.bu), rule);
        px[1] = table_bgr(yi + table_term(ui, rule.gu)
                          + table_term(vi, rule.gv), rule);
        px[2] = table_bgr(yi + table_term(vi, rule.rv), rule);
    }
}

extern "C" int rtpose_yuv420p10_to_bgr(
        const void* y, const void* u, const void* v, int y_pitch,
        int c_pitch, int height, int width, int rotation, const void* hpos,
        const void* htap, int hsize, const void* vpos, const void* vtap,
        int vsize, YuvRule rule, void* out, void* stream) {
    if (height <= 2 || width <= 0 || (width & 1) || y_pitch < width
            || c_pitch < width / 2 || hsize < 1 || hsize > P10_MAX_TAPS
            || vsize < 1 || vsize > P10_MAX_TAPS
            || (rotation != 0 && rotation != 90 && rotation != 180
                && rotation != 270))
        return (int)cudaErrorInvalidValue;
    const bool quarter = rotation == 90 || rotation == 270;
    const int out_h = quarter ? width : height;
    const int out_w = quarter ? height : width;
    const dim3 block(P10_BLOCK_X, P10_BLOCK_Y);
    const dim3 grid((out_w + P10_BLOCK_X - 1) / P10_BLOCK_X,
                    (out_h + P10_BLOCK_Y - 1) / P10_BLOCK_Y);
    yuv420p10_to_bgr_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const uint16_t*)y, (const uint16_t*)u, (const uint16_t*)v, y_pitch,
        c_pitch, height, width, rotation, (const int*)hpos, (const int*)htap,
        hsize, (const int*)vpos, (const int*)vtap, vsize, rule,
        (uint8_t*)out);
    return (int)cudaGetLastError();
}
