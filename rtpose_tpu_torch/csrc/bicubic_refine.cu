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
// 0 writes the epilogue.  The blurred mode (refine_blur_kernel) is one
// block per peak: the 40 x 40 upsample is staged in shared memory, then
// By * up, and each thread scans a strided set of the cells of
// (By * up) * Bx^T.  Products and sums are separately
// rounded (the library is built with -fmad=false) in the order of the
// plain version.

#include <cuda_runtime.h>
#include <math_constants.h>

#define WIN 2
#define PATCH 5
#define WARPS 4            // peaks per block of the warp kernel
#define ROWS_PER_LANE 2    // upsampled rows per lane: PATCH * factor <= 64
#define COLS 4             // upsampled columns scored per step of the scan
#define BLUR_THREADS 128

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

// The blurred refine; arguments as refine_warp_kernel's, plus
// blur: (3, PATCH * f, PATCH * f) fp32 blur matrices.
__global__ void refine_blur_kernel(const float* __restrict__ heat,
                                   const int* __restrict__ py,
                                   const int* __restrict__ px,
                                   const bool* __restrict__ valid,
                                   const float* __restrict__ mats,
                                   const float* __restrict__ blur,
                                   float* __restrict__ xf,
                                   float* __restrict__ yf,
                                   float* __restrict__ score, int K, int H,
                                   int W, int factor) {
  extern __shared__ float smem[];
  const int n = PATCH * factor;
  float* patch = smem;                    // PATCH * PATCH
  float* my_mat = patch + PATCH * PATCH;  // n * PATCH
  float* mx_mat = my_mat + n * PATCH;     // n * PATCH
  float* tmp = mx_mat + n * PATCH;        // n * PATCH  (My * patch)
  float* up = tmp + n * PATCH;            // n * n
  float* by_up = up + n * n;              // n * n      (By * up)
  float* by_mat = by_up + n * n;          // n * n
  float* bx_mat = by_mat + n * n;         // n * n
  __shared__ float red_v[BLUR_THREADS / 32];
  __shared__ int red_i[BLUR_THREADS / 32];

  const int q = blockIdx.x;               // peak slot
  const int tid = threadIdx.x;
  if (!valid[q]) {                        // block-uniform
    if (tid == 0) xf[q] = yf[q] = score[q] = 0.0f;
    return;
  }
  const int cy = py[q];
  const int cx = px[q];
  const int y_min = max(0, cy - WIN);
  const int x_min = max(0, cx - WIN);
  const int ph = min(H - 1, cy + WIN) - y_min + 1;
  const int pw = min(W - 1, cx + WIN) - x_min + 1;
  const float* hm = heat + (size_t)(q / K) * H * W;

  if (tid < PATCH * PATCH) {
    const int r = tid / PATCH, c = tid % PATCH;
    patch[tid] = (r < ph && c < pw) ? __ldg(hm + (y_min + r) * W + x_min + c)
                                    : 0.0f;
  }
  for (int i = tid; i < n * PATCH; i += blockDim.x) {
    my_mat[i] = __ldg(mats + (size_t)(ph - 3) * n * PATCH + i);
    mx_mat[i] = __ldg(mats + (size_t)(pw - 3) * n * PATCH + i);
  }
  __syncthreads();
  for (int i = tid; i < n * PATCH; i += blockDim.x) {
    const int row = i / PATCH, col = i % PATCH;
    float acc = 0.0f;
#pragma unroll
    for (int r = 0; r < PATCH; ++r)
      acc += my_mat[row * PATCH + r] * patch[r * PATCH + col];
    tmp[i] = acc;
  }
  __syncthreads();
  for (int i = tid; i < n * n; i += blockDim.x) {
    const int row = i / n, col = i % n;
    float v = 0.0f;
#pragma unroll
    for (int c = 0; c < PATCH; ++c)
      v += tmp[row * PATCH + c] * mx_mat[col * PATCH + c];
    up[i] = v;
    by_mat[i] = __ldg(blur + (size_t)(ph - 3) * n * n + i);
    bx_mat[i] = __ldg(blur + (size_t)(pw - 3) * n * n + i);
  }
  __syncthreads();
  for (int i = tid; i < n * n; i += blockDim.x) {
    const int row = i / n, col = i % n;
    float v = 0.0f;
    for (int r = 0; r < n; ++r) v += by_mat[row * n + r] * up[r * n + col];
    by_up[i] = v;
  }
  __syncthreads();

  const int vh = ph * factor, vw = pw * factor;
  float best_v = -CUDART_INF_F;
  int best_i = 0x7fffffff;
  for (int i = tid; i < n * n; i += blockDim.x) {
    const int row = i / n, col = i % n;
    if (row >= vh || col >= vw) continue;
    float v = 0.0f;
    for (int c = 0; c < n; ++c) v += by_up[row * n + c] * bx_mat[col * n + c];
    if (v > best_v) {  // strict: cells come in increasing flat order
      best_v = v;
      best_i = i;
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
  if ((tid & 31) == 0) {
    red_v[tid >> 5] = best_v;
    red_i[tid >> 5] = best_i;
  }
  __syncthreads();
  if (tid == 0) {
    for (int wi = 1; wi < BLUR_THREADS / 32; ++wi)
      if (better(red_v[wi], red_i[wi], best_v, best_i)) {
        best_v = red_v[wi];
        best_i = red_i[wi];
      }
    write_peak(xf, yf, score, q, cy, cx, y_min, x_min, best_i, best_v, n,
               factor);
  }
}

extern "C" {

int rtpose_refine_peaks(const float* heat, const int* py, const int* px,
                        const bool* valid, const float* mats,
                        const float* blur, float* xf, float* yf, float* score,
                        int n_peaks, int K, int H, int W, int factor,
                        int gaussian_filt, void* stream) {
  if (n_peaks == 0) return 0;
  const int n = PATCH * factor;
  if (gaussian_filt) {
    const size_t smem = sizeof(float) * (PATCH * PATCH + 3 * PATCH * n +
                                         4 * n * n);
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    refine_blur_kernel<<<n_peaks, BLUR_THREADS, smem,
                         (cudaStream_t)stream>>>(
        heat, py, px, valid, mats, blur, xf, yf, score, K, H, W, factor);
  } else {
    if (n > 32 * ROWS_PER_LANE) return (int)cudaErrorInvalidValue;
    refine_warp_kernel<<<(n_peaks + WARPS - 1) / WARPS, WARPS * 32, 0,
                         (cudaStream_t)stream>>>(
        heat, py, px, valid, mats, xf, yf, score, n_peaks, K, H, W, factor);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
