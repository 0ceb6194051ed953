// Connection scoring of every candidate limb, hand-written for Hopper.
//
// Replaces the two TPU Pallas kernels of rtpose_tpu/ops/pallas_kernels.py
//   K1 paf_sample_scores_fused (all 19 pairs in one grid step, K <= 32)
//   K2 paf_sample_scores       (one grid step per pair, the K = 64 retry)
// together with the XLA work around them in rtpose_tpu/ops/grouping.py
// score_connections: the candidate geometry before them (:120-159) and
// the criterion and validity after them (:221-225).  For every candidate
// from peak ia of a pair's part A to peak ib of its part B:
//   d = b - a, norm = |d|, u = d / max(norm, 1e-12) (0 where norm = 0),
//   ten samples at int(a + s * (d / 10) + 0.5) (C++ truncation) of the
//   nearest-x8-upsampled PAF at (y / 8, x / 8) clipped to the map, each
//   dotted with u; cnt = samples above 0.05, ssum their sequential sum;
//   crit2 = ssum / 10 + min(0, 0.5 * h_up / max(norm, 1e-12) - 1);
//   valid = va & vb & norm >= 1e-12 & cnt > thresh & crit2 > 0.
// Every candidate gets its crit2, valid or not, as the JAX function
// returns them all.
//
// What bounds it on this card: memory, and barely.  At K = 32 and a batch
// of 8 maps of 46 x 62 it reads the 3.47 MB PAF and writes 0.78 MB of
// scores and flags, 1.3 us at 3.35 TB/s; its ~126 flops per candidate are
// a fifth of that.  In practice it is bound by the latency of the
// dependent PAF gathers (L2-resident, 0.43 MB per image) and by the
// launch.
//
// Design: one warp per (image, pair, ia) row, lanes over ib (two passes
// of 32 at K = 64), so the A-side peak, its validity and the pair's
// channels are warp-uniform and the B-side peaks and the outputs are
// coalesced.  Each thread keeps its count and sum in registers and reads
// the (B, h, w, 38) PAF directly through the read-only cache, so it takes
// any map size.  Nothing between the peaks and the scores goes through
// device memory.  The pair tables are __constant__ copies of
// rtpose_tpu/ops/grouping.py _PAIR_A/_PAIR_B/_PAIR_CHX/_PAIR_CHY; the
// wrapper checks them against the skeleton when it loads the library.
//
// Rounding follows the JAX reference exactly: every product, sum,
// quotient and root is rounded on its own (__fmul_rn, __fadd_rn,
// __fdiv_rn, __fsqrt_rn; the library is built with -fmad=false) in JAX's
// order, so no FMA or reciprocal can move a sample across a cell edge.

#include <cuda_runtime.h>

#define NUM_PAIRS 19
#define NUM_PARTS 18
#define STEP_PAF 10
#define PAF_CHANNELS 38
#define THRESH_VECTOR_SCORE 0.05f
#define WARPS 8

#define PAIR_A_INIT {1, 1, 2, 3, 5, 6, 1, 8, 9, 1, 11, 12, 1, 0, 14, 0, 15, \
                     2, 5}
#define PAIR_B_INIT {2, 5, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 0, 14, 16, 15, \
                     17, 16, 17}
#define PAIR_CHX_INIT {12, 20, 14, 16, 22, 24, 0, 2, 4, 6, 8, 10, 28, 30, \
                       34, 32, 36, 18, 26}
#define PAIR_CHY_INIT {13, 21, 15, 17, 23, 25, 1, 3, 5, 7, 9, 11, 29, 31, \
                       35, 33, 37, 19, 27}

__constant__ int c_pair_a[NUM_PAIRS] = PAIR_A_INIT;
__constant__ int c_pair_b[NUM_PAIRS] = PAIR_B_INIT;
__constant__ int c_pair_chx[NUM_PAIRS] = PAIR_CHX_INIT;
__constant__ int c_pair_chy[NUM_PAIRS] = PAIR_CHY_INIT;
static const int h_pair_a[NUM_PAIRS] = PAIR_A_INIT;
static const int h_pair_b[NUM_PAIRS] = PAIR_B_INIT;
static const int h_pair_chx[NUM_PAIRS] = PAIR_CHX_INIT;
static const int h_pair_chy[NUM_PAIRS] = PAIR_CHY_INIT;

// paf:    (B, h, w, 38) fp32
// peak_x, peak_y: (B, 18, K) int32 upsampled-frame peak coordinates
// peak_valid:     (B, 18, K) bool
// crit2:  (B, 19, K, K) fp32;  valid: (B, 19, K, K) bool
// FACTOR: the upsampling factor where it is known when compiling (the
// served x8 turns 20 integer divisions per candidate into shifts), or 0
// for the `factor` argument
template <int FACTOR>
__global__ void connection_scores_kernel(const float* __restrict__ paf,
                                         const int* __restrict__ peak_x,
                                         const int* __restrict__ peak_y,
                                         const bool* __restrict__ peak_valid,
                                         float* __restrict__ crit2,
                                         bool* __restrict__ valid,
                                         int n_rows, int K, int h, int w,
                                         int factor, float half_h_up,
                                         int thresh_cnt) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);  // (b, p, ia)
  if (row >= n_rows) return;  // warp-uniform
  const int ia = row % K;
  const int p = (row / K) % NUM_PAIRS;
  const int b = row / (K * NUM_PAIRS);
  const size_t peaks = (size_t)b * NUM_PARTS * K;
  const size_t ka = peaks + (size_t)c_pair_a[p] * K + ia;
  const size_t kb = peaks + (size_t)c_pair_b[p] * K;
  const float ax = (float)__ldg(peak_x + ka);
  const float ay = (float)__ldg(peak_y + ka);
  const bool va = peak_valid[ka];
  const float* img = paf + (size_t)b * h * w * PAF_CHANNELS;
  const int chx = c_pair_chx[p];
  const int chy = c_pair_chy[p];

  for (int ib = lane; ib < K; ib += 32) {
    const float bx = (float)__ldg(peak_x + kb + ib);
    const float by = (float)__ldg(peak_y + kb + ib);
    const bool vb = peak_valid[kb + ib];
    const float dx = __fsub_rn(bx, ax);
    const float dy = __fsub_rn(by, ay);
    const float norm =
        __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
    const bool nz = norm >= 1e-12f;
    const float safe = fmaxf(norm, 1e-12f);
    const float ux = nz ? __fdiv_rn(dx, safe) : 0.0f;
    const float uy = nz ? __fdiv_rn(dy, safe) : 0.0f;
    // the step first, the reference's exact expression
    // (pafprocess.cpp:223-229)
    const float step_x = __fdiv_rn(dx, (float)STEP_PAF);
    const float step_y = __fdiv_rn(dy, (float)STEP_PAF);

    int n = 0;
    float acc = 0.0f;
#pragma unroll
    for (int s = 0; s < STEP_PAF; ++s) {
      const float sf = (float)s;
      const int lx =
          (int)__fadd_rn(__fadd_rn(ax, __fmul_rn(sf, step_x)), 0.5f);
      const int ly =
          (int)__fadd_rn(__fadd_rn(ay, __fmul_rn(sf, step_y)), 0.5f);
      // C division truncates where the reference floors; they differ only
      // for negative coordinates, which the clip sends to 0 either way
      const int f = FACTOR ? FACTOR : factor;
      const int gx = min(max(lx / f, 0), w - 1);
      const int gy = min(max(ly / f, 0), h - 1);
      const float* cell = img + ((size_t)gy * w + gx) * PAF_CHANNELS;
      const float sc = __fadd_rn(__fmul_rn(ux, __ldg(cell + chx)),
                                 __fmul_rn(uy, __ldg(cell + chy)));
      n += sc > THRESH_VECTOR_SCORE;
      acc = __fadd_rn(acc, sc);
    }
    const float mean = __fdiv_rn(acc, (float)STEP_PAF);
    const float penalty = __fsub_rn(__fdiv_rn(half_h_up, safe), 1.0f);
    const float c2 = __fadd_rn(mean, fminf(penalty, 0.0f));
    const size_t o = (size_t)row * K + ib;
    crit2[o] = c2;
    valid[o] = va && vb && nz && n > thresh_cnt && c2 > 0.0f;
  }
}

extern "C" {

// Copies the compiled-in pair tables out for the wrapper's check.
int rtpose_pair_tables(int* part_a, int* part_b, int* chx, int* chy) {
  for (int i = 0; i < NUM_PAIRS; ++i) {
    part_a[i] = h_pair_a[i];
    part_b[i] = h_pair_b[i];
    chx[i] = h_pair_chx[i];
    chy[i] = h_pair_chy[i];
  }
  return NUM_PAIRS;
}

int rtpose_connection_scores(const float* paf, const int* peak_x,
                             const int* peak_y, const bool* peak_valid,
                             float* crit2, bool* valid, int batch, int K,
                             int h, int w, int factor, float half_h_up,
                             int thresh_cnt, void* stream) {
  const int n_rows = batch * NUM_PAIRS * K;
  if (n_rows == 0) return 0;
  const int blocks = (n_rows + WARPS - 1) / WARPS;
  if (factor == 8)
    connection_scores_kernel<8><<<blocks, WARPS * 32, 0,
                                  (cudaStream_t)stream>>>(
        paf, peak_x, peak_y, peak_valid, crit2, valid, n_rows, K, h, w,
        factor, half_h_up, thresh_cnt);
  else
    connection_scores_kernel<0><<<blocks, WARPS * 32, 0,
                                  (cudaStream_t)stream>>>(
        paf, peak_x, peak_y, peak_valid, crit2, valid, n_rows, K, h, w,
        factor, half_h_up, thresh_cnt);
  return (int)cudaGetLastError();
}

}  // extern "C"
