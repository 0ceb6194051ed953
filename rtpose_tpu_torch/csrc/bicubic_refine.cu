// Sub-pixel peak refinement, hand-written for Hopper.
//
// Replaces the TPU Pallas kernel rtpose_tpu/ops/pallas_kernels.py
// bicubic_refine (K3, with its host-side patch gather ops/peaks.py
// _gather_patch / _refine_pallas).  Per peak: take the 5 x 5 heat window
// around it clipped to the map (extent 3..5 per axis), upsample it by
// `factor` with cv2 INTER_CUBIC (A = -0.75, border replicate) as
// up = My * patch * Mx^T with the precomputed interpolation matrices of
// ops/peaks.py _interp_matrices, and return the row-major first argmax of
// the valid (ph * f, pw * f) region and the value there.
//
// What bounds it on this card: per peak 5 * 40 * 5 + 40 * 40 * 5 = 9,000
// multiply-adds and 25 scattered heat reads; at 8 images x 18 parts x 32
// peaks that is 41 MFLOP, nothing for the card.  It is bound by latency:
// the dependent gather of the window and the block-wide argmax.
//
// Design: one block per peak.  The block gathers its own window from the
// (B, 18, H, W) heat (gathers are cheap here; the TPU version had the
// host gather every patch first), stages patch, My, Mx and My * patch in
// shared memory, and each thread scans a strided set of the 40 x 40 cells
// in increasing flat order keeping the first maximum.  A warp-shuffle then
// a shared-memory reduction combine (value, index) pairs, ties going to
// the lower flat index, so the result is numpy's argmax on the row-major
// valid region.  Products and sums are separately rounded (the library is
// built with -fmad=false) in the order of the plain version.

#include <cuda_runtime.h>
#include <math_constants.h>

#define WIN 2
#define PATCH 5
#define THREADS 128

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// heat:  (n_maps, H, W) fp32, contiguous (n_maps = B * 18)
// py/px: (n_maps, K) int32 integer peak coordinates on the map
// mats:  (3, PATCH * f, PATCH) fp32 interpolation matrices (extent 3, 4, 5)
// my/mx: (n_maps, K) int32 argmax row / column in the upsampled patch
// score: (n_maps, K) fp32 value at the argmax
__global__ void bicubic_refine_kernel(const float* __restrict__ heat,
                                      const int* __restrict__ py,
                                      const int* __restrict__ px,
                                      const float* __restrict__ mats,
                                      int* __restrict__ out_my,
                                      int* __restrict__ out_mx,
                                      float* __restrict__ out_score,
                                      int K, int H, int W, int factor) {
  extern __shared__ float smem[];
  const int n = PATCH * factor;
  float* patch = smem;                    // PATCH * PATCH
  float* my_mat = patch + PATCH * PATCH;  // n * PATCH
  float* mx_mat = my_mat + n * PATCH;     // n * PATCH
  float* tmp = mx_mat + n * PATCH;        // n * PATCH  (My * patch)
  __shared__ float red_v[THREADS / 32];
  __shared__ int red_i[THREADS / 32];

  const int q = blockIdx.x;               // peak index
  const int map = q / K;
  const int cy = py[q];
  const int cx = px[q];
  const int y_min = max(0, cy - WIN);
  const int x_min = max(0, cx - WIN);
  const int ph = min(H - 1, cy + WIN) - y_min + 1;
  const int pw = min(W - 1, cx + WIN) - x_min + 1;
  const float* hm = heat + (size_t)map * H * W;
  const int tid = threadIdx.x;

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

  const int vh = ph * factor, vw = pw * factor;
  float best_v = -CUDART_INF_F;
  int best_i = 0x7fffffff;
  for (int i = tid; i < n * n; i += blockDim.x) {
    const int row = i / n, col = i % n;
    if (row >= vh || col >= vw) continue;
    float v = 0.0f;
#pragma unroll
    for (int c = 0; c < PATCH; ++c)
      v += tmp[row * PATCH + c] * mx_mat[col * PATCH + c];
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
    for (int wi = 1; wi < THREADS / 32; ++wi)
      if (better(red_v[wi], red_i[wi], best_v, best_i)) {
        best_v = red_v[wi];
        best_i = red_i[wi];
      }
    out_my[q] = best_i / n;
    out_mx[q] = best_i % n;
    out_score[q] = best_v;
  }
}

extern "C" {

int rtpose_bicubic_refine(const float* heat, const int* py, const int* px,
                          const float* mats, int* my, int* mx, float* score,
                          int n_peaks, int K, int H, int W, int factor,
                          void* stream) {
  if (n_peaks == 0) return 0;
  const size_t smem =
      sizeof(float) * (PATCH * PATCH + 3 * PATCH * PATCH * factor);
  bicubic_refine_kernel<<<n_peaks, THREADS, smem, (cudaStream_t)stream>>>(
      heat, py, px, mats, my, mx, score, K, H, W, factor);
  return (int)cudaGetLastError();
}

}  // extern "C"
