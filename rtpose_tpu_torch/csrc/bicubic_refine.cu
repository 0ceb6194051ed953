// Sub-pixel peak refinement, hand-written for Hopper.
//
// Replaces the TPU Pallas kernel rtpose_tpu/ops/pallas_kernels.py
// bicubic_refine (K3) with the XLA work around it in ops/peaks.py: the
// host-side patch gather (_gather_patch), the coordinate epilogue of
// _refine_pallas (:310-314) and the validity mask of nms (:365-367).  Per
// peak: take the 5 x 5 heat window around it clipped to the map (extent
// 3..5 per axis), upsample it by `factor` with cv2 INTER_CUBIC (A = -0.75,
// border replicate) as up = My * patch * Mx^T with the interpolation
// matrices of ops/peaks.py _interp_matrices, take the row-major first
// argmax (my, mx) of the valid (ph * f, pw * f) region and the value
// there, and write the refined peak
//   yf = (py + 0.5) * f - 0.5 + (my - ((py - y_min + 0.5) * f - 0.5))
// (xf alike) and its score, or zeros where the slot is not a valid peak.
// With `gaussian_filt` the upsampled patch is first blurred (sigma 3, scipy
// 'reflect' at the true patch edge) as up = By * up * Bx^T with the
// separable blur matrices of ops/peaks.py _blur_matrices, and the argmax
// and score come from the blurred patch (the JAX package serves this mode
// through _refine_onehot, peaks.py:249-257; the reference's
// bool_gaussian_filt, paf_to_pose.py:121-122).
//
// What bounds it on this card: per valid peak 40 * 5 * 5 + 40 * 40 * 5 =
// 9,000 multiply-adds and 25 heat reads; at 8 images x 18 parts x 32 slots
// with ~1 slot in 10 a peak that is ~0.1 us of fp32 issue.  It is bound by
// the launch and by the latency of the window gather.  The blur adds
// 2 * 40^3 = 128,000 multiply-adds per valid peak.
//
// Default design (refine_warp_kernel): one warp per peak slot, several
// warps per block, no shared memory and no barrier.  A warp whose slot is
// not a valid peak writes zeros and leaves (a warp-uniform branch), so
// empty slots cost next to nothing.  After the slot's indices, everything
// the warp reads comes in one round of loads: lanes 0-24 the clipped
// window, which every lane then takes by shuffles, and each lane its rows
// (lane and lane + 32) of My and Mx.  Each lane keeps tmp = My * patch for
// its rows of the upsample in registers and walks the columns, taking each
// column's Mx row by shuffles from the lane that holds it, so the scan
// touches no memory; it keeps the first maximum of its cells, and a
// warp-shuffle argmax finishes, ties going to the lower flat index.  Lane
// 0 writes the epilogue.  Products and sums are separately rounded (the
// library is built with -fmad=false) in the order of the plain version.
//
// The blurred mode (refine_blur_kernel).  What bounds it: operations.  The
// blur is a banded filter: 844 of a 40 x 40 blur matrix's 1,600 weights are
// not zero, so the two blurs need 2 * 40 * 844 = 67,520 multiply-adds per
// full peak (128,000 as dense products), each a multiply and an add
// because nothing may be contracted; with the upsample, at the retry's
// 5,184 peaks, that is 12 us of an H100's fp32 rate (67 TFLOP/s).  The
// first version (one block per slot) took 41 times that: every block
// fetched both blur matrices again, both products took each operand from
// shared memory for one multiply-add, Bx was read at a stride of 40 words
// (an 8-way bank conflict), the 15 of 40 taps outside the band were
// multiplied too, and 4,000 empty blocks were launched beside the working
// ones.
// Design: persistent blocks, one per multiprocessor, its slots taken at a
// stride of the grid so that every block sees the same mix of full and
// empty list positions.  A block zeroes its empty slots, lists the others
// in shared memory, stages the three extents' interpolation and blur
// matrices once (blur rows at an odd stride, so a warp's eight tile rows
// fall on different banks), and its warps, up to 14 in 227 KB, each take
// the next listed peak until none is left.  A warp keeps the peak's
// upsample and By * up in its own two shared tiles and needs no block
// barrier.  Each lane owns a 5 x 10 register tile of By * up and a 10 x 5
// tile of (By * up) * Bx^T (32 lanes cover 40 x 40), so 15 shared reads
// feed 50 multiply-adds.  The taps of a tile run over the band of its
// rows only, ascending, and only tiles inside the peak's (ph f, pw f)
// region are computed; what is left out are products with exact zeros of
// the blur matrix, which leave a sum as it is.  The last product is never
// stored: each lane scans its tile for the argmax, ties to the lower flat
// index, and a shuffle reduction finishes.

#include <cuda_runtime.h>
#include <math_constants.h>

#define WIN 2
#define PATCH 5
#define WARPS 4            // peaks per block of the warp kernel
#define ROWS_PER_LANE 2    // upsampled rows per lane: PATCH * factor <= 64
#define COLS 4             // upsampled columns scored per step of the scan
#define TILE_A 5           // the blurred refine's register tiles: TILE_A x
#define TILE_B 10          // TILE_B, then TILE_B x TILE_A
#define BLUR_MAX_WARPS 14  // peaks in flight per block
#define BLUR_MAX_SMEM (227 * 1024)

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// The refined peak from the argmax cell `best` of the n x n upsample.
__device__ __forceinline__ void write_peak(float* xf, float* yf, float* score,
                                           int q, int cy, int cx, int y_min,
                                           int x_min, int best, float best_v,
                                           int n, int factor) {
  const float f = (float)factor;
  const float oy = (float)(cy - y_min) + 0.5f;
  const float ox = (float)(cx - x_min) + 0.5f;
  yf[q] = ((float)cy + 0.5f) * f - 0.5f +
          ((float)(best / n) - (oy * f - 0.5f));
  xf[q] = ((float)cx + 0.5f) * f - 0.5f +
          ((float)(best % n) - (ox * f - 0.5f));
  score[q] = best_v;
}

// heat:  (n_maps, H, W) fp32 (n_maps = B * 18)
// py/px: (n_maps, K) int32 integer peak coordinates on the map
// valid: (n_maps, K) bool, the slots that hold a peak
// mats:  (3, PATCH * f, PATCH) fp32 interpolation matrices (extent 3, 4, 5)
// xf/yf/score: (n_maps, K) fp32 refined peak, zeros where not valid
__global__ void refine_warp_kernel(const float* __restrict__ heat,
                                   const int* __restrict__ py,
                                   const int* __restrict__ px,
                                   const bool* __restrict__ valid,
                                   const float* __restrict__ mats,
                                   float* __restrict__ xf,
                                   float* __restrict__ yf,
                                   float* __restrict__ score, int n_peaks,
                                   int K, int H, int W, int factor) {
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (q >= n_peaks) return;  // warp-uniform
  const bool ok = valid[q];
  const int cy = __ldg(py + q);
  const int cx = __ldg(px + q);
  if (!ok) {                 // warp-uniform
    if (lane == 0) xf[q] = yf[q] = score[q] = 0.0f;
    return;
  }
  const int y_min = max(0, cy - WIN);
  const int x_min = max(0, cx - WIN);
  const int ph = min(H - 1, cy + WIN) - y_min + 1;
  const int pw = min(W - 1, cx + WIN) - x_min + 1;
  const float* hm = heat + (size_t)(q / K) * H * W;
  const int n = PATCH * factor;
  const int vh = ph * factor, vw = pw * factor;
  const float* my_mat = mats + (size_t)(ph - 3) * n * PATCH;
  const float* mx_mat = mats + (size_t)(pw - 3) * n * PATCH;

  // one round of loads: the window (lanes 0-24), and this lane's rows
  // of My and of Mx (upsampled index lane and lane + 32)
  float mine = 0.0f;
  if (lane < PATCH * PATCH) {
    const int r = lane / PATCH, c = lane % PATCH;
    if (r < ph && c < pw) mine = __ldg(hm + (y_min + r) * W + x_min + c);
  }
  float my_row[ROWS_PER_LANE][PATCH], mx_row[ROWS_PER_LANE][PATCH];
#pragma unroll
  for (int j = 0; j < ROWS_PER_LANE; ++j) {
    const int i = lane + 32 * j;
#pragma unroll
    for (int c = 0; c < PATCH; ++c) {
      my_row[j][c] = i < n ? __ldg(my_mat + i * PATCH + c) : 0.0f;
      mx_row[j][c] = i < n ? __ldg(mx_mat + i * PATCH + c) : 0.0f;
    }
  }
  float patch[PATCH * PATCH];
#pragma unroll
  for (int i = 0; i < PATCH * PATCH; ++i)
    patch[i] = __shfl_sync(0xffffffffu, mine, i);

  // tmp = My * patch for this lane's rows, in registers
  float tmp[ROWS_PER_LANE][PATCH];
#pragma unroll
  for (int j = 0; j < ROWS_PER_LANE; ++j)
#pragma unroll
    for (int c = 0; c < PATCH; ++c) {
      float acc = 0.0f;
#pragma unroll
      for (int r = 0; r < PATCH; ++r)
        acc += my_row[j][r] * patch[r * PATCH + c];
      tmp[j][c] = acc;
    }

  // the columns in chunks of COLS, each column's Mx row shuffled from
  // the lane that holds it; each lane scores its rows there and keeps the
  // first maximum.  A chunk's shuffles and dot products are independent,
  // so they overlap; columns past the valid region score nothing.
  float best_v = -CUDART_INF_F;
  int best_i = 0x7fffffff;
  for (int col0 = 0; col0 < vw; col0 += COLS) {
    const int j = col0 >> 5;  // warp-uniform: 32 is a multiple of COLS
    float m[COLS][PATCH];
#pragma unroll
    for (int k = 0; k < COLS; ++k)
#pragma unroll
      for (int c = 0; c < PATCH; ++c)
        m[k][c] = __shfl_sync(0xffffffffu, j ? mx_row[1][c] : mx_row[0][c],
                              (col0 + k) & 31);
#pragma unroll
    for (int r = 0; r < ROWS_PER_LANE; ++r) {
      const int row = lane + 32 * r;
      if (row >= vh) continue;
      float v[COLS];
#pragma unroll
      for (int k = 0; k < COLS; ++k) {
        v[k] = 0.0f;
#pragma unroll
        for (int c = 0; c < PATCH; ++c) v[k] += tmp[r][c] * m[k][c];
      }
#pragma unroll
      for (int k = 0; k < COLS; ++k)
        if (col0 + k < vw && better(v[k], row * n + col0 + k, best_v, best_i)) {
          best_v = v[k];
          best_i = row * n + col0 + k;
        }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, best_v, off);
    const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
    if (better(ov, oi, best_v, best_i)) {
      best_v = ov;
      best_i = oi;
    }
  }
  if (lane == 0)
    write_peak(xf, yf, score, q, cy, cx, y_min, x_min, best_i, best_v, n,
               factor);
}

// One peak of the blurred refine, by one warp.  `up` and `bu` are the
// warp's own tiles of n10 rows at a stride of `su` floats; s_mats and s_blur
// the block's staged matrices (n10 rows per extent, zero past n; the blur's
// rows at a stride of `sb`).  Three passes over register tiles, a
// __syncwarp() after each: up = My * patch * Mx^T (rows below vh), then
// bu = By * up on TILE_A x TILE_B tiles, then (bu * Bx^T) on TILE_B x
// TILE_A tiles, scanned for the argmax as it is computed.  A tile's taps
// run over the union of its rows' (or columns') bands, ascending; the
// extra taps multiply zeros of the blur matrix, as the dense sum does.
// FACTOR is the upsampling factor where it is known when compiling (the
// served x8: every stride and tile count a constant, every shared address
// a base and an immediate), or 0 for the `factor` argument.
template <int FACTOR>
__device__ __forceinline__ void blur_peak(
    int q, const float* __restrict__ heat, const int* __restrict__ py,
    const int* __restrict__ px, const float* s_mats, const float* s_blur,
    float* up, float* bu, float* __restrict__ xf, float* __restrict__ yf,
    float* __restrict__ score, int K, int H, int W, int factor, int radius) {
  if (FACTOR) factor = FACTOR;
  const int n = PATCH * factor;
  const int n10 = (n + TILE_B - 1) / TILE_B * TILE_B;
  const int sb = n | 1, su = n10 + 2;
  const int lane = threadIdx.x & 31;
  const int cy = __ldg(py + q);
  const int cx = __ldg(px + q);
  const int y_min = max(0, cy - WIN);
  const int x_min = max(0, cx - WIN);
  const int ph = min(H - 1, cy + WIN) - y_min + 1;
  const int pw = min(W - 1, cx + WIN) - x_min + 1;
  const int vh = ph * factor, vw = pw * factor;
  const float* hm = heat + (size_t)(q / K) * H * W;
  const float* my_mat = s_mats + (ph - 3) * n10 * PATCH;
  const float* mx_mat = s_mats + (pw - 3) * n10 * PATCH;
  const float* by_mat = s_blur + (ph - 3) * n10 * sb;
  const float* bx_mat = s_blur + (pw - 3) * n10 * sb;

  float mine = 0.0f;
  if (lane < PATCH * PATCH) {
    const int r = lane / PATCH, c = lane % PATCH;
    if (r < ph && c < pw) mine = __ldg(hm + (y_min + r) * W + x_min + c);
  }
  float patch[PATCH * PATCH];
#pragma unroll
  for (int i = 0; i < PATCH * PATCH; ++i)
    patch[i] = __shfl_sync(0xffffffffu, mine, i);

  // up = (My * patch) * Mx^T: rows below vh, every column (Mx is zero
  // past vw)
  const int tiles_a = n / TILE_A, tiles_b = n10 / TILE_B;
  for (int t = lane; t < tiles_a * tiles_b; t += 32) {
    const int i0 = (t / tiles_b) * TILE_A, j0 = (t % tiles_b) * TILE_B;
    if (i0 >= vh) continue;
    float tmp[TILE_A][PATCH];
#pragma unroll
    for (int a = 0; a < TILE_A; ++a)
#pragma unroll
      for (int c = 0; c < PATCH; ++c) {
        float acc = 0.0f;
#pragma unroll
        for (int r = 0; r < PATCH; ++r)
          acc += my_mat[(i0 + a) * PATCH + r] * patch[r * PATCH + c];
        tmp[a][c] = acc;
      }
#pragma unroll
    for (int m = 0; m < TILE_B; m += 2) {
      float w[2][PATCH];
#pragma unroll
      for (int c = 0; c < PATCH; ++c) {
        w[0][c] = mx_mat[(j0 + m) * PATCH + c];
        w[1][c] = mx_mat[(j0 + m + 1) * PATCH + c];
      }
#pragma unroll
      for (int a = 0; a < TILE_A; ++a) {
        float v0 = 0.0f, v1 = 0.0f;
#pragma unroll
        for (int c = 0; c < PATCH; ++c) {
          v0 += tmp[a][c] * w[0][c];
          v1 += tmp[a][c] * w[1][c];
        }
        *reinterpret_cast<float2*>(up + (i0 + a) * su + j0 + m) =
            make_float2(v0, v1);
      }
    }
  }
  __syncwarp();

  // bu = By * up: TILE_A rows x TILE_B columns per lane
  for (int t = lane; t < tiles_a * tiles_b; t += 32) {
    const int i0 = (t / tiles_b) * TILE_A, j0 = (t % tiles_b) * TILE_B;
    if (i0 >= vh || j0 >= vw) continue;
    const int k_end = min(vh, i0 + TILE_A + radius);
    float acc[TILE_A][TILE_B];
#pragma unroll
    for (int a = 0; a < TILE_A; ++a)
#pragma unroll
      for (int m = 0; m < TILE_B; ++m) acc[a][m] = 0.0f;
    for (int k = max(0, i0 - radius); k < k_end; ++k) {
      float bw[TILE_A];
      float2 u[TILE_B / 2];
#pragma unroll
      for (int a = 0; a < TILE_A; ++a) bw[a] = by_mat[(i0 + a) * sb + k];
#pragma unroll
      for (int m = 0; m < TILE_B / 2; ++m)
        u[m] = *reinterpret_cast<const float2*>(up + k * su + j0 + 2 * m);
#pragma unroll
      for (int a = 0; a < TILE_A; ++a)
#pragma unroll
        for (int m = 0; m < TILE_B / 2; ++m) {
          acc[a][2 * m] += bw[a] * u[m].x;
          acc[a][2 * m + 1] += bw[a] * u[m].y;
        }
    }
#pragma unroll
    for (int a = 0; a < TILE_A; ++a)
#pragma unroll
      for (int m = 0; m < TILE_B; m += 2)
        *reinterpret_cast<float2*>(bu + (i0 + a) * su + j0 + m) =
            make_float2(acc[a][m], acc[a][m + 1]);
  }
  __syncwarp();

  // (bu * Bx^T) on TILE_B rows x TILE_A columns per lane, and its argmax
  // over the valid region; ties go to the lower flat index
  float best_v = -CUDART_INF_F;
  int best_i = 0x7fffffff;
  for (int t = lane; t < tiles_a * tiles_b; t += 32) {
    const int i0 = (t / tiles_a) * TILE_B, j0 = (t % tiles_a) * TILE_A;
    if (i0 >= vh || j0 >= vw) continue;
    const int c_end = min(vw, j0 + TILE_A + radius);
    float acc[TILE_B][TILE_A];
#pragma unroll
    for (int a = 0; a < TILE_B; ++a)
#pragma unroll
      for (int m = 0; m < TILE_A; ++m) acc[a][m] = 0.0f;
    for (int c = max(0, j0 - radius); c < c_end; ++c) {
      float row[TILE_B], bw[TILE_A];
#pragma unroll
      for (int a = 0; a < TILE_B; ++a) row[a] = bu[(i0 + a) * su + c];
#pragma unroll
      for (int m = 0; m < TILE_A; ++m) bw[m] = bx_mat[(j0 + m) * sb + c];
#pragma unroll
      for (int a = 0; a < TILE_B; ++a)
#pragma unroll
        for (int m = 0; m < TILE_A; ++m) acc[a][m] += row[a] * bw[m];
    }
#pragma unroll
    for (int a = 0; a < TILE_B; ++a)
#pragma unroll
      for (int m = 0; m < TILE_A; ++m) {
        const int i = i0 + a, j = j0 + m;
        if (i < vh && j < vw && better(acc[a][m], i * n + j, best_v, best_i)) {
          best_v = acc[a][m];
          best_i = i * n + j;
        }
      }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, best_v, off);
    const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
    if (better(ov, oi, best_v, best_i)) {
      best_v = ov;
      best_i = oi;
    }
  }
  if (lane == 0)
    write_peak(xf, yf, score, q, cy, cx, y_min, x_min, best_i, best_v, n,
               factor);
  __syncwarp();  // before the warp's next peak overwrites its tiles
}

// The blurred refine; arguments as refine_warp_kernel's, plus
// blur: (3, PATCH * f, PATCH * f) fp32 blur matrices, zero outside
// |row - col| <= radius and outside each extent.
// Dynamic shared memory, with n = PATCH * f, n10 = n rounded up to TILE_B,
// sb = n | 1 and su = n10 + 2: s_mats[3 * n10 * PATCH], s_blur[3 * n10 * sb],
// then per warp up[n10 * su] and bu[n10 * su].
template <int FACTOR>
__global__ void __launch_bounds__(BLUR_MAX_WARPS * 32, 1)
    refine_blur_kernel(const float* __restrict__ heat,
                       const int* __restrict__ py, const int* __restrict__ px,
                       const bool* __restrict__ valid,
                       const float* __restrict__ mats,
                       const float* __restrict__ blur, float* __restrict__ xf,
                       float* __restrict__ yf, float* __restrict__ score,
                       int n_peaks, int K, int H, int W, int factor,
                       int radius) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int todo[BLUR_MAX_WARPS * 32];
  __shared__ int n_todo, next;
  if (FACTOR) factor = FACTOR;
  const int n = PATCH * factor;
  const int n10 = (n + TILE_B - 1) / TILE_B * TILE_B;
  const int sb = n | 1, su = n10 + 2;
  float* s_mats = smem;
  float* s_blur = s_mats + 3 * n10 * PATCH;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  float* up = s_blur + 3 * n10 * sb + (size_t)warp * 2 * n10 * su;
  float* bu = up + n10 * su;

  // this block's slots: blockIdx.x, + gridDim.x, ...
  const int mine = (n_peaks - (int)blockIdx.x + (int)gridDim.x - 1) /
                   (int)gridDim.x;
  bool staged = false;
  if (tid == 0) n_todo = next = 0;
  __syncthreads();
  for (int base = 0; base < mine; base += nthreads) {
    // zero the empty slots, list the others
    const int q = (int)blockIdx.x + (base + tid) * (int)gridDim.x;
    const bool ok = base + tid < mine && valid[q];
    if (base + tid < mine && !ok) xf[q] = yf[q] = score[q] = 0.0f;
    const unsigned votes = __ballot_sync(0xffffffffu, ok);
    int at = 0;
    if (lane == 0 && votes) at = atomicAdd(&n_todo, __popc(votes));
    at = __shfl_sync(0xffffffffu, at, 0);
    if (ok) todo[at + __popc(votes & ((1u << lane) - 1))] = q;
    __syncthreads();
    const int count = n_todo;
    if (count && !staged) {  // block-uniform
      for (int i = tid; i < 3 * n10 * PATCH; i += nthreads) {
        const int e = i / (n10 * PATCH), rem = i % (n10 * PATCH);
        s_mats[i] = rem < n * PATCH ? __ldg(mats + e * n * PATCH + rem) : 0.0f;
      }
      for (int i = tid; i < 3 * n10 * sb; i += nthreads) {
        const int e = i / (n10 * sb), rem = i % (n10 * sb);
        const int row = rem / sb, col = rem % sb;
        s_blur[i] = row < n && col < n
                        ? __ldg(blur + ((size_t)e * n + row) * n + col)
                        : 0.0f;
      }
      staged = true;
      __syncthreads();
    }
    // each warp takes the next listed peak until none is left
    for (;;) {
      int e = 0;
      if (lane == 0) e = atomicAdd(&next, 1);
      e = __shfl_sync(0xffffffffu, e, 0);
      if (e >= count) break;
      blur_peak<FACTOR>(todo[e], heat, py, px, s_mats, s_blur, up, bu, xf, yf,
                        score, K, H, W, factor, radius);
    }
    __syncthreads();
    if (tid == 0) n_todo = next = 0;
    __syncthreads();
  }
}

extern "C" {

int rtpose_refine_peaks(const float* heat, const int* py, const int* px,
                        const bool* valid, const float* mats,
                        const float* blur, float* xf, float* yf, float* score,
                        int n_peaks, int K, int H, int W, int factor,
                        int gaussian_filt, int blur_radius, void* stream) {
  if (n_peaks == 0) return 0;
  const int n = PATCH * factor;
  if (gaussian_filt) {
    // one block per multiprocessor, as many warps as its shared memory
    // holds tiles for
    static int sm_count[64];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    int sms = dev < 64 ? sm_count[dev] : 0;
    if (sms == 0) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err != cudaSuccess) return (int)err;
      if (dev < 64) sm_count[dev] = sms;
    }
    const int n10 = (n + TILE_B - 1) / TILE_B * TILE_B;
    const int sb = n | 1, su = n10 + 2;
    const size_t shared = sizeof(float) * (3 * n10 * PATCH + 3 * n10 * sb);
    const size_t per_warp = sizeof(float) * 2 * n10 * su;
    const size_t room = BLUR_MAX_SMEM - sizeof(int) * (BLUR_MAX_WARPS * 32 + 2);
    if (shared + per_warp > room) return (int)cudaErrorInvalidValue;
    size_t warps = (room - shared) / per_warp;
    if (warps > BLUR_MAX_WARPS) warps = BLUR_MAX_WARPS;
    const size_t smem = shared + warps * per_warp;
    const auto kernel =
        factor == 8 ? refine_blur_kernel<8> : refine_blur_kernel<0>;
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    kernel<<<n_peaks < sms ? n_peaks : sms, (int)warps * 32, smem,
             (cudaStream_t)stream>>>(heat, py, px, valid, mats, blur, xf, yf,
                                     score, n_peaks, K, H, W, factor,
                                     blur_radius);
  } else {
    if (n > 32 * ROWS_PER_LANE) return (int)cudaErrorInvalidValue;
    refine_warp_kernel<<<(n_peaks + WARPS - 1) / WARPS, WARPS * 32, 0,
                         (cudaStream_t)stream>>>(
        heat, py, px, valid, mats, xf, yf, score, n_peaks, K, H, W, factor);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
