// PAF line-integral sampling for candidate limbs, hand-written for Hopper.
//
// Replaces the two TPU Pallas kernels of rtpose_tpu/ops/pallas_kernels.py:
//   K1 paf_sample_scores_fused (all 19 pairs in one grid step, K <= 32)
//   K2 paf_sample_scores       (one grid step per pair, the K = 64 retry)
// Both compute, for every (pair, candidate a->b), ten samples at
// int(a + s * step + 0.5) (C++ truncation), read the nearest-x8-upsampled
// PAF at (y / 8, x / 8) clipped to the map, dot the (x, y) PAF vector with
// the limb's unit vector, and return the number of samples above 0.05 and
// the sequential fp32 sum over s = 0..9.
//
// What bounds it on this card: nothing compute-side.  At K = 32 and a
// batch of 8 it is 8 x 19 x 1024 threads, 20 scattered 4-byte reads each
// from a 46 x 46 x 38 fp32 map (320 KB per image, L2-resident) plus 24
// coalesced bytes of geometry.  It is latency-bound on the dependent
// gathers and on launch overhead.
//
// Design: one thread per (image, pair, candidate); the thread keeps its
// count and sum in registers and reads the (B, h, w, 38) PAF directly
// through the read-only cache.  The TPU kernel's transposed planes and
// one-hot matmuls existed only because the TPU has no fast gather; they
// are gone.  The pair -> PAF channel table is a __constant__ copy of
// rtpose_tpu/ops/grouping.py _PAIR_CHX/_PAIR_CHY (the wrapper checks the
// compiled-in table against the skeleton when it loads the library).
//
// Rounding follows the JAX reference exactly: the sample coordinate is
// (ax + s * step) + 0.5 and the sample score ux * px + uy * py, each with
// separately rounded multiplies and adds (__fmul_rn / __fadd_rn, so no
// FMA contraction can move a sample across an integer cell boundary).

#include <cuda_runtime.h>

#define NUM_PAIRS 19
#define STEP_PAF 10
#define PAF_CHANNELS 38
#define THRESH_VECTOR_SCORE 0.05f

#define PAIR_CHX_INIT {12, 20, 14, 16, 22, 24, 0, 2, 4, 6, 8, 10, 28, 30, \
                       34, 32, 36, 18, 26}
#define PAIR_CHY_INIT {13, 21, 15, 17, 23, 25, 1, 3, 5, 7, 9, 11, 29, 31, \
                       35, 33, 37, 19, 27}

__constant__ int c_pair_chx[NUM_PAIRS] = PAIR_CHX_INIT;
__constant__ int c_pair_chy[NUM_PAIRS] = PAIR_CHY_INIT;
static const int h_pair_chx[NUM_PAIRS] = PAIR_CHX_INIT;
static const int h_pair_chy[NUM_PAIRS] = PAIR_CHY_INIT;

// paf:  (B, h, w, 38) fp32, contiguous
// geo:  (B, 19, 6, C) fp32 rows [ax, ay, step_x, step_y, ux, uy]
// cnt:  (B, 19, C) int32;  ssum: (B, 19, C) fp32
__global__ void paf_sample_kernel(const float* __restrict__ paf,
                                  const float* __restrict__ geo,
                                  int* __restrict__ cnt,
                                  float* __restrict__ ssum,
                                  int h, int w, int C, int factor) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int p = blockIdx.y;
  const int b = blockIdx.z;
  if (c >= C) return;
  const size_t row = (size_t)b * NUM_PAIRS + p;
  const float* g = geo + row * 6 * C + c;
  const float ax = __ldg(g);
  const float ay = __ldg(g + C);
  const float step_x = __ldg(g + 2 * (size_t)C);
  const float step_y = __ldg(g + 3 * (size_t)C);
  const float ux = __ldg(g + 4 * (size_t)C);
  const float uy = __ldg(g + 5 * (size_t)C);
  const float* img = paf + (size_t)b * h * w * PAF_CHANNELS;
  const int chx = c_pair_chx[p];
  const int chy = c_pair_chy[p];

  int n = 0;
  float acc = 0.0f;
#pragma unroll
  for (int s = 0; s < STEP_PAF; ++s) {
    const float sf = (float)s;
    const int lx = (int)__fadd_rn(__fadd_rn(ax, __fmul_rn(sf, step_x)), 0.5f);
    const int ly = (int)__fadd_rn(__fadd_rn(ay, __fmul_rn(sf, step_y)), 0.5f);
    // C division truncates where the reference floors; they differ only
    // for negative coordinates, which the clip sends to 0 either way
    const int gx = min(max(lx / factor, 0), w - 1);
    const int gy = min(max(ly / factor, 0), h - 1);
    const float* cell = img + ((size_t)gy * w + gx) * PAF_CHANNELS;
    const float sc = __fadd_rn(__fmul_rn(ux, __ldg(cell + chx)),
                               __fmul_rn(uy, __ldg(cell + chy)));
    n += sc > THRESH_VECTOR_SCORE;
    acc = __fadd_rn(acc, sc);
  }
  cnt[row * C + c] = n;
  ssum[row * C + c] = acc;
}

extern "C" {

// Copies the compiled-in pair -> channel table out for the wrapper's check.
int rtpose_paf_pair_channels(int* chx, int* chy) {
  for (int i = 0; i < NUM_PAIRS; ++i) {
    chx[i] = h_pair_chx[i];
    chy[i] = h_pair_chy[i];
  }
  return NUM_PAIRS;
}

int rtpose_paf_sample(const float* paf, const float* geo, int* cnt,
                      float* ssum, int batch, int h, int w, int C,
                      int factor, void* stream) {
  const int threads = 128;
  dim3 grid((C + threads - 1) / threads, NUM_PAIRS, batch);
  paf_sample_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      paf, geo, cnt, ssum, h, w, C, factor);
  return (int)cudaGetLastError();
}

}  // extern "C"
