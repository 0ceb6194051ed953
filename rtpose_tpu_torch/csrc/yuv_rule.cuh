// The constants of swscale's YUV -> RGB conversion for one (matrix,
// range), passed to the conversion kernels by value: the fields, in order,
// of ops/kernels.py YuvRule (yuv_rule derives them as swscale's
// ff_yuv2rgb_c_init_tables does; contrast and saturation 1, brightness 0).
#pragma once

struct YuvRule {
    int matrix;     // H.273 matrix_coefficients
    int full;       // full range
    // the 16-bit SIMD paths: y' = ((8 Y - y_offset) * luma) >> 16, the
    // chroma terms ((8 (C - 128)) * coefficient) >> 16
    int luma, ub, ug, vg, vr, y_offset;
    // the table path (yuv2rgb_X_c's bgr24 tables): the value at luma index
    // k is sat((k * cy + y_base + 0x8000) >> 16), a chroma index c moves it
    // by ((c * coefficient) >> 16) - (coefficient >> 9)
    int cy, y_base, bu, gu, gv, rv;
};

__device__ __forceinline__ unsigned char sat8(int v) {
    return (unsigned char)(v < 0 ? 0 : (v > 255 ? 255 : v));
}
