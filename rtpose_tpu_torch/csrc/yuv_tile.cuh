// The tile the video-colour kernels (yuv_unscaled.cuh, yuv420p10_to_bgr.cu,
// yuv420_full_chroma_to_bgr.cu, yuv_planar_to_bgr.cu) convert in and
// write out: a block owns TILE_ROWS x TILE_COLS pixels of the output,
// turned by cv2's cv::rotate
// (output (i, j) is source (H-1-j, i) at 90, (H-1-i, W-1-j) at 180 and
// (j, W-1-i) at 270), so TILE_ROWS x TILE_COLS source pixels at 0 and 180
// and TILE_COLS x TILE_ROWS at 90 and 270.  It puts each pixel's BGR as
// one word (B | G << 8 | R << 16) into a shared-memory tile in the
// output's orientation, then writes the tile's output rows, 3 x TILE_COLS
// bytes each, with 16-byte stores, each row's ragged ends with the widest
// aligned stores that fit.  So the stores are the same at every turn, and
// the turn costs a transposition in shared memory only.
#pragma once

#include <stdint.h>

#define TILE_ROWS 32
#define TILE_COLS 64
// words of a row of the BGR tile: padded by one against bank conflicts
#define BGR_PITCH (TILE_COLS + 1)
#define BGR_TILE_WORDS (TILE_ROWS * BGR_PITCH)

// where this block's tile lies in the source and in the turned output
struct TileMap {
    int r0, c0;       // its first source row and column
    int th, tw;       // its source rows and columns inside the picture
    int i0, j0;       // its first output row and column
    int rows, cols;   // its output rows and columns
    int step;         // tile_slot(sr, sc + 1) - tile_slot(sr, sc)
    int out_w;        // pixels a row of the output
    int rotation;
};

// the grid of tiles over a height x width picture turned by `rotation`
inline dim3 tile_grid(int height, int width, int rotation) {
    const bool quarter = rotation == 90 || rotation == 270;
    const int rows = quarter ? TILE_COLS : TILE_ROWS;
    const int cols = quarter ? TILE_ROWS : TILE_COLS;
    return dim3((width + cols - 1) / cols, (height + rows - 1) / rows);
}

// QUARTER: rotation is 90 or 270
template <bool QUARTER>
__device__ __forceinline__ TileMap tile_map(int height, int width,
                                            int rotation) {
    TileMap m;
    constexpr int rows = QUARTER ? TILE_COLS : TILE_ROWS;  // source
    constexpr int cols = QUARTER ? TILE_ROWS : TILE_COLS;
    m.r0 = blockIdx.y * rows;
    m.c0 = blockIdx.x * cols;
    m.th = min(rows, height - m.r0);
    m.tw = min(cols, width - m.c0);
    m.rotation = rotation;
    if (rotation == 90) {
        m.i0 = m.c0; m.j0 = height - m.r0 - m.th; m.step = BGR_PITCH;
    } else if (rotation == 180) {
        m.i0 = height - m.r0 - m.th; m.j0 = width - m.c0 - m.tw;
        m.step = -1;
    } else if (rotation == 270) {
        m.i0 = width - m.c0 - m.tw; m.j0 = m.r0; m.step = -BGR_PITCH;
    } else {
        m.i0 = m.r0; m.j0 = m.c0; m.step = 1;
    }
    m.rows = QUARTER ? m.tw : m.th;
    m.cols = QUARTER ? m.th : m.tw;
    m.out_w = QUARTER ? height : width;
    return m;
}

// the BGR tile's word of source pixel (r0 + sr, c0 + sc)
__device__ __forceinline__ int tile_slot(const TileMap& m, int sr, int sc) {
    if (m.rotation == 90) return sc * BGR_PITCH + m.th - 1 - sr;
    if (m.rotation == 180) return (m.th - 1 - sr) * BGR_PITCH + m.tw - 1 - sc;
    if (m.rotation == 270) return (m.tw - 1 - sc) * BGR_PITCH + sr;
    return sr * BGR_PITCH + sc;
}

__device__ __forceinline__ uint32_t bgr_word(int b, int g, int r) {
    return (uint32_t)b | ((uint32_t)g << 8) | ((uint32_t)r << 16);
}

// a thread's pixel words px, the first n of N inside the picture, of
// source row r0 + sr from column c0 + col, into the BGR tile
template <int N>
__device__ __forceinline__ void put_pixels(uint32_t* bgr, const TileMap& m,
                                           int sr, int col, int n,
                                           const uint32_t* px) {
    uint32_t* at = bgr + tile_slot(m, sr, col);
    if (n == N) {
#pragma unroll
        for (int k = 0; k < N; ++k) at[k * m.step] = px[k];
    } else {
#pragma unroll
        for (int k = 0; k < N; ++k)
            if (k < n) at[k * m.step] = px[k];
    }
}

// n (at most N: 4, 8 or 16) bytes from p into words w: one N-byte load
// where p is N-byte aligned and n is N, else single bytes (a row start off
// the alignment, a ragged edge)
template <int N>
__device__ __forceinline__ void load_bytes(const uint8_t* p, int n,
                                           uint32_t* w) {
    if (n == N && ((uintptr_t)p & (N - 1)) == 0) {
        if constexpr (N == 16) {
            const uint4 v = *reinterpret_cast<const uint4*>(p);
            w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
        } else if constexpr (N == 8) {
            const uint2 v = *reinterpret_cast<const uint2*>(p);
            w[0] = v.x; w[1] = v.y;
        } else {
            w[0] = *reinterpret_cast<const uint32_t*>(p);
        }
        return;
    }
#pragma unroll
    for (int k = 0; k < (N + 3) / 4; ++k) w[k] = 0;
#pragma unroll
    for (int k = 0; k < N; ++k)
        if (k < n) w[k >> 2] |= (uint32_t)p[k] << (8 * (k & 3));
}

// byte k of the words w
__device__ __forceinline__ int byte_of(const uint32_t* w, int k) {
    return (w[k >> 2] >> (8 * (k & 3))) & 255;
}

// sample k of a row's samples of type T (uint8_t or uint16_t) held in the
// words w
template <typename T>
__device__ __forceinline__ int sample_of(const uint32_t* w, int k) {
    if constexpr (sizeof(T) == 1) return byte_of(w, k);
    return (w[k >> 1] >> (16 * (k & 1))) & 0xffff;
}

// sixteen bytes of an output row from the six pixel words that hold them,
// the first byte at byte `phase` (0-2) of w[0]
__device__ __forceinline__ uint4 bgr_stream16(const uint32_t* w, int phase) {
    if (phase == 0)
        return make_uint4(__byte_perm(w[0], w[1], 0x4210),
                          __byte_perm(w[1], w[2], 0x5421),
                          __byte_perm(w[2], w[3], 0x6542),
                          __byte_perm(w[4], w[5], 0x4210));
    if (phase == 1)
        return make_uint4(__byte_perm(w[0], w[1], 0x5421),
                          __byte_perm(w[1], w[2], 0x6542),
                          __byte_perm(w[3], w[4], 0x4210),
                          __byte_perm(w[4], w[5], 0x5421));
    return make_uint4(__byte_perm(w[0], w[1], 0x6542),
                      __byte_perm(w[2], w[3], 0x4210),
                      __byte_perm(w[3], w[4], 0x5421),
                      __byte_perm(w[4], w[5], 0x6542));
}

// bytes [lo, hi) of the 16 bytes v at the 16-byte-aligned address at,
// each by the widest aligned store that the range holds
__device__ __forceinline__ void store_part(uint8_t* at, uint4 v, int lo,
                                           int hi) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int a = 0; a < 16; ++a) {
        const bool in8 = lo <= (a & ~7) && (a & ~7) + 8 <= hi;
        const bool in4 = lo <= (a & ~3) && (a & ~3) + 4 <= hi;
        const bool in2 = lo <= (a & ~1) && (a & ~1) + 2 <= hi;
        if (a % 8 == 0 && in8) {
            *reinterpret_cast<uint2*>(at + a) = make_uint2(w[a / 4],
                                                           w[a / 4 + 1]);
        } else if (a % 4 == 0 && in4 && !in8) {
            *reinterpret_cast<uint32_t*>(at + a) = w[a / 4];
        } else if (a % 2 == 0 && in2 && !in4) {
            *reinterpret_cast<uint16_t*>(at + a) =
                (uint16_t)(w[a / 4] >> (8 * (a % 4)));
        } else if (lo <= a && a < hi && !in2) {
            at[a] = (uint8_t)(w[a / 4] >> (8 * (a % 4)));
        }
    }
}

// Write the BGR tile `px` to its place in `out`: first every 16-byte-
// aligned window that lies inside an output row of the tile (a row holds
// at most WINDOWS), a 16-byte store each; then each row's ragged head and
// tail, the bytes before its first aligned window and after its last.
#define WINDOWS (3 * TILE_COLS / 16)

template <int THREADS>
__device__ __forceinline__ void store_tile(const uint32_t* px,
                                           const TileMap& m, uint8_t* out) {
    const int n = 3 * m.cols;               // bytes of a row of the tile
    for (int k = threadIdx.x; k < m.rows * WINDOWS; k += THREADS) {
        const int li = k / WINDOWS;
        uint8_t* row = out + 3 * ((size_t)(m.i0 + li) * m.out_w + m.j0);
        const int s = (int)(-(uintptr_t)row & 15) + 16 * (k - li * WINDOWS);
        if (s + 16 <= n) {
            const uint32_t* at = px + li * BGR_PITCH + s / 3;
            uint32_t w[6];
#pragma unroll
            for (int q = 0; q < 6; ++q) w[q] = at[q];
            *reinterpret_cast<uint4*>(row + s) = bgr_stream16(w, s % 3);
        }
    }
    for (int k = threadIdx.x; k < 2 * m.rows; k += THREADS) {
        const int li = k >> 1;
        uint8_t* row = out + 3 * ((size_t)(m.i0 + li) * m.out_w + m.j0);
        const int head = (int)(-(uintptr_t)row & 15);
        // the window's first byte from the row's, and its bytes to store
        int s, lo, hi;
        if ((k & 1) == 0) {
            s = head - 16; lo = 16 - head; hi = min(16, n - s);
        } else {
            s = n > head ? head + (n - head) / 16 * 16 : n;
            lo = 0; hi = n - s;
        }
        if (lo >= hi) continue;
        const int p = (s + 15) / 3 - 5;     // floor(s / 3): s >= -15
        uint32_t w[6];
#pragma unroll
        for (int q = 0; q < 6; ++q)
            w[q] = px[li * BGR_PITCH + min(max(p + q, 0), m.cols - 1)];
        store_part(row + s, bgr_stream16(w, s - 3 * p), lo, hi);
    }
}
