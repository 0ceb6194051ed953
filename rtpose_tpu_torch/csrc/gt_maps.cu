// Ground-truth heatmap and PAF synthesis for training, hand-written for
// Hopper.
//
// Replaces the TPU Pallas kernel rtpose_tpu/ops/pallas_gt.py gt_maps_pallas
// (K4, body _gt_kernel).  Per image and grid cell, over the image's first n
// persons (n = 1 + index of the last visible one):
//   heat[part] += exp(-expo), expo = d2 * (1 / (2 sigma^2)), where
//     expo <= ln 100 and the part is visible; d2 is the squared distance
//     from the cell's pixel centre (g * stride + stride / 2 - 0.5);
//   for each limb, inside the mask |(gx - ax) uy - (gy - ay) ux| <
//     limb_width, inside the rounded box [mnx, mxx) x [mny, mxy) and valid:
//     pafx += ux, pafy += uy, cnt += 1.
// Then the parts clip at 1, the background is max(1 - max over parts, 0),
// and the PAF is averaged by max(cnt, 1).  The per-person limb scalars
// (ax, ay, ux, uy, valid, box) come in precomputed by data/gt.py with the
// exact expressions of pallas_gt.py:152-171.
//
// What bounds it on this card: nothing much.  At the flagship batch (72
// images, 46 x 46 grid) the outputs are 72 * 2116 * 57 * 4 B = 35 MB, a
// few microseconds of HBM bandwidth, and the work is about 30 flops and one
// expf per (cell, row, person) over a handful of persons.  The TPU
// version's one-hot column select, lane-padded grid and transposed planes
// existed for the TPU's layout rules and are not ported.
//
// Design: one thread per (image, cell, row of 19); row r is part r for the
// heat (r < 18) and limb r for the PAF.  Each thread loops over the image's
// n persons in order, keeping its four sums in registers, so every sum is
// taken in the reference's person order.  A block covers CELLS cells; the
// row-18 thread of each cell takes the background from the unclipped part
// sums its neighbours left in shared memory.  Outputs are written straight
// into the (B, gy, gx, 19) and (B, gy, gx, 38) layouts (PAF channels 2l and
// 2l+1).  The library is built with -fmad=false: contracting d2 or the
// perpendicular distance into an FMA would move cells across the < and <=
// tests.  expf (not __expf) keeps the heat within 1e-6 of the reference.

#include <cuda_runtime.h>

#define NUM_PARTS 18
#define NUM_ROWS 19       // 18 parts + background (heat), 19 limbs (PAF)
#define LIMB_FIELDS 9     // ax, ay, ux, uy, valid, mnx, mxx, mny, mxy
#define CELLS 16          // grid cells per block: 16 * 19 = 304 threads
#define LN100 4.6052f     // gaussian support cutoff (reference heatmap.py:30)

// kp:     (B, N, 18, 3) fp32 [x, y, v] keypoints in input pixels
// limbs:  (B, N, 19, 9) fp32 limb scalars in grid units
// n_pers: (B,) int32 persons to visit per image
// heat:   (B, grid_y, grid_x, 19) fp32 out; paf: (B, grid_y, grid_x, 38)
__global__ void gt_maps_kernel(const float* __restrict__ kp,
                               const float* __restrict__ limbs,
                               const int* __restrict__ n_pers,
                               float* __restrict__ heat,
                               float* __restrict__ paf, int N, int grid_y,
                               int grid_x, float stride, float start,
                               float inv2s, float limb_width) {
  __shared__ float part_sum[CELLS][NUM_ROWS];
  const int b = blockIdx.y;
  const int area = grid_y * grid_x;
  const int row = threadIdx.x % NUM_ROWS;
  const int local = threadIdx.x / NUM_ROWS;
  const int cell = blockIdx.x * CELLS + local;
  const bool inside = cell < area;
  const float gx = (float)(cell % grid_x);
  const float gy = (float)(cell / grid_x);
  const float xx = gx * stride + start;     // pixel centre of the cell
  const float yy = gy * stride + start;

  float h = 0.0f, sx = 0.0f, sy = 0.0f, cnt = 0.0f;
  const int n = inside ? n_pers[b] : 0;
  for (int p = 0; p < n; ++p) {
    const size_t person = (size_t)b * N + p;
    if (row < NUM_PARTS) {
      const float* k = kp + (person * NUM_PARTS + row) * 3;
      const float dx = xx - __ldg(k);
      const float dy = yy - __ldg(k + 1);
      const float expo = (dx * dx + dy * dy) * inv2s;
      if (expo <= LN100 && __ldg(k + 2) > 0.5f) h += expf(-expo);
    }
    const float* l = limbs + (person * NUM_ROWS + row) * LIMB_FIELDS;
    const float ux = __ldg(l + 2), uy = __ldg(l + 3);
    const float perp = fabsf((gx - __ldg(l)) * uy - (gy - __ldg(l + 1)) * ux);
    if (perp < limb_width && gx >= __ldg(l + 5) && gx < __ldg(l + 6) &&
        gy >= __ldg(l + 7) && gy < __ldg(l + 8) && __ldg(l + 4) > 0.5f) {
      sx += ux;
      sy += uy;
      cnt += 1.0f;
    }
  }
  part_sum[local][row] = h;   // row 18 holds the zero of the pad row
  __syncthreads();
  if (!inside) return;

  float* hout = heat + ((size_t)b * area + cell) * NUM_ROWS;
  if (row < NUM_PARTS) {
    hout[row] = fminf(h, 1.0f);
  } else {
    float m = 0.0f;           // max over the unclipped parts and the pad row
    for (int r = 0; r < NUM_PARTS; ++r) m = fmaxf(m, part_sum[local][r]);
    hout[NUM_PARTS] = fmaxf(1.0f - m, 0.0f);
  }
  const float div = fmaxf(cnt, 1.0f);
  float* pout = paf + ((size_t)b * area + cell) * (2 * NUM_ROWS) + 2 * row;
  pout[0] = sx / div;
  pout[1] = sy / div;
}

extern "C" {

int rtpose_gt_maps(const float* kp, const float* limbs, const int* n_pers,
                   float* heat, float* paf, int B, int N, int grid_y,
                   int grid_x, float stride, float start, float inv2s,
                   float limb_width, void* stream) {
  const int area = grid_y * grid_x;
  if (B == 0 || area == 0) return 0;
  const dim3 grid((area + CELLS - 1) / CELLS, B);
  gt_maps_kernel<<<grid, CELLS * NUM_ROWS, 0, (cudaStream_t)stream>>>(
      kp, limbs, n_pers, heat, paf, N, grid_y, grid_x, stride, start, inv2s,
      limb_width);
  return (int)cudaGetLastError();
}

}  // extern "C"
