// Greedy matching and person assembly of the decode, hand-written for
// Hopper: one block per image, from the sorted candidate lists to People.
//
// Replaces no Pallas kernel: the JAX package runs these stages as two
// lax.scans inside its compiled decode, rtpose_tpu/ops/grouping.py
//   greedy_connections (:228-284), a scan over the top-C candidates of
//     every pair: accept (ia, ib) when neither end is used yet;
//   assemble_people (:287-430), the compaction of the accepted
//     connections into one (pair, slot)-ordered list of at most M, then a
//     scan over it that grows, extends and merges the Pp subset rows
//     (reference pafprocess.cpp:127-191), then the epilogue that turns
//     the rows into People;
// with the placement and compaction between them.  In: every pair's
// candidates sorted by score, descending and stable (a torch.sort, as JAX
// leaves lax.top_k outside its scan), invalid ones -inf, and the peaks.
// Out: every People field, and the truncation flag from all four sources
// (peaks, candidates, connections, people).
//
// What bounds it on this card: neither bytes nor operations but a serial
// chain.  Every greedy step depends on the used sets the step before it
// left, and every assembly step on the rows the step before it wrote: up
// to C + M dependent steps per image (256 + 160 at the default caps, 1024
// + 608 at the retry's), a few hundred nanoseconds each at best.  Images
// are independent, and so are pairs during the greedy scan.
//
// Design: one block of 4 warps per image.
//  - Greedy: the block stages the next 32 candidates of all 19 pairs into
//    shared memory (scores and (ia, ib), the division done while staging,
//    global reads coalesced along each pair's row); then lane p of warp 0
//    scans pair p's chunk, its used-a / used-b sets two 64-bit masks in
//    registers, and appends what it accepts to pair p's list.  Chunks
//    repeat until every pair has met its first -inf (valid candidates
//    sort first) or C; in practice one chunk at the default caps.
//  - Compaction: none is materialised.  The assembly walks the 19 lists
//    in pair order and stops after M entries; the total of the 19 counts
//    above M is the connection overflow.
//  - Assembly: warp 0 runs the chain over the Pp x 20 fp32 rows in shared
//    memory (row stride 21 words, so lanes on rows hit distinct banks).
//    Each lane tests rows lane, lane + 32, ...; per 32 rows a ballot is
//    `match`, its popcount adds to `found`, and the first and second set
//    bits in row order are s1 and s2 (row 0 where none, as jnp.argmax of
//    an all-false mask).  Lanes 0-19 then read r1 and r2 column by column
//    (the membership test is a ballot) and write the one changed row, and
//    the killed row of a merge, in the same columns.
//  - Epilogue, the whole block: validity, score, coordinates and part
//    scores of every row.
//
// Rounding follows the JAX scan bit for bit: its one-hot blends add exact
// zeros, so a select gives the same values; sums keep JAX's association
// (a new row's column 18 is (s1p + s2p) + cscore, an extension adds
// r1[18] + (s2p + cscore), a merge r1 + (r2 + 1) on the body and r1[18] +
// (r2[18] + cscore)); the person score is the IEEE quotient ssum /
// max(count, 1).  The subset holds 1-based peak ids as fp32, compared as
// floats (`do_set` tests r1[p2] != k2).

#include <cuda_runtime.h>
#include <math_constants.h>

#define NUM_PAIRS 19
#define NUM_PARTS 18
#define NUM_SEED_PAIRS 18
#define COLS 20          // 18 part ids, score sum, part count
#define ROW_STRIDE 21    // odd: rows on lanes hit distinct banks
#define MAX_K 128        // peaks per part: two 64-bit used-set words
#define MAX_PEOPLE 256   // subset rows: 8 per lane
#define CHUNK 32         // candidates of each pair staged at a time
#define THREADS 128

#define GP_PAIR_A_INIT {1, 1, 2, 3, 5, 6, 1, 8, 9, 1, 11, 12, 1, 0, 14, 0, \
                        15, 2, 5}
#define GP_PAIR_B_INIT {2, 5, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 0, 14, 16, \
                        15, 17, 16, 17}

__constant__ int g_pair_a[NUM_PAIRS] = GP_PAIR_A_INIT;
__constant__ int g_pair_b[NUM_PAIRS] = GP_PAIR_B_INIT;
static const int h_gp_pair_a[NUM_PAIRS] = GP_PAIR_A_INIT;
static const int h_gp_pair_b[NUM_PAIRS] = GP_PAIR_B_INIT;

__device__ __forceinline__ bool test_bit(unsigned long long lo,
                                         unsigned long long hi, int i) {
  return i < 64 ? (lo >> i) & 1ull : (hi >> (i - 64)) & 1ull;
}

__device__ __forceinline__ void set_bit(unsigned long long& lo,
                                        unsigned long long& hi, int i) {
  if (i < 64)
    lo |= 1ull << i;
  else
    hi |= 1ull << (i - 64);
}

// sorted_scores: (B, 19, KK) fp32, descending, -inf for invalid candidates
// sorted_idx:    (B, 19, KK) int64 flat candidate index ia * K + ib
// peak_x, peak_y: (B, 18, K) int32; peak_score: (B, 18, K) fp32
// peak_truncated: (B,) bool
// coords (B, P, 18, 2) int32, part_score (B, P, 18) fp32, score (B, P)
// fp32, valid (B, P) bool, truncated (B,) bool; P = n_people
__global__ void __launch_bounds__(THREADS)
group_people_kernel(const float* __restrict__ sorted_scores,
                    const long long* __restrict__ sorted_idx,
                    const int* __restrict__ peak_x,
                    const int* __restrict__ peak_y,
                    const float* __restrict__ peak_score,
                    const bool* __restrict__ peak_truncated,
                    int* __restrict__ coords, float* __restrict__ part_score,
                    float* __restrict__ score, bool* __restrict__ valid,
                    bool* __restrict__ truncated, int K, int KK, int C,
                    int M, int n_people, float min_part_cnt,
                    float min_human_score) {
  __shared__ float st_score[CHUNK][NUM_PAIRS];
  __shared__ int st_ab[CHUNK][NUM_PAIRS];          // ia | ib << 16
  __shared__ unsigned char acc_ia[NUM_PAIRS][MAX_K];
  __shared__ unsigned char acc_ib[NUM_PAIRS][MAX_K];
  __shared__ float acc_score[NUM_PAIRS][MAX_K];
  __shared__ int n_acc[NUM_PAIRS];
  __shared__ float subset[MAX_PEOPLE * ROW_STRIDE];
  __shared__ int flags;   // bit 0 candidate, 1 connection, 2 people overflow

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const unsigned FULL = 0xffffffffu;
  const size_t row0 = (size_t)b * NUM_PAIRS * KK;
  const float* pscore = peak_score + (size_t)b * NUM_PARTS * K;

  for (int i = tid; i < n_people * COLS; i += THREADS) {
    const int c = i % COLS;
    subset[(i / COLS) * ROW_STRIDE + c] = c == COLS - 1 ? 0.0f : -1.0f;
  }
  if (tid == 0) flags = 0;
  __syncthreads();

  // --- greedy 1-1 matching, pair p on lane p of warp 0 ---------------------
  unsigned long long used_a0 = 0, used_a1 = 0, used_b0 = 0, used_b1 = 0;
  int n = 0;
  bool open = warp == 0 && lane < NUM_PAIRS;
  for (int base = 0; base < C; base += CHUNK) {
    const int len = min(CHUNK, C - base);
    for (int i = tid; i < NUM_PAIRS * CHUNK; i += THREADS) {
      const int p = i / CHUNK, j = i % CHUNK;
      if (j < len) {
        const size_t at = row0 + (size_t)p * KK + base + j;
        const long long id = sorted_idx[at];
        const int ia = (int)(id / K);
        st_score[j][p] = sorted_scores[at];
        st_ab[j][p] = ia | ((int)(id - (long long)ia * K) << 16);
      }
    }
    __syncthreads();
    if (open) {
      for (int j = 0; j < len; ++j) {
        const float s = st_score[j][lane];
        if (s == -CUDART_INF_F) {   // the valid candidates are all behind
          open = false;
          break;
        }
        if (!(fabsf(s) < CUDART_INF_F)) continue;   // JAX's isfinite test
        const int ab = st_ab[j][lane];
        const int ia = ab & 0xffff, ib = ab >> 16;
        if (!test_bit(used_a0, used_a1, ia) &&
            !test_bit(used_b0, used_b1, ib)) {
          set_bit(used_a0, used_a1, ia);
          set_bit(used_b0, used_b1, ib);
          acc_ia[lane][n] = (unsigned char)ia;
          acc_ib[lane][n] = (unsigned char)ib;
          acc_score[lane][n] = s;
          ++n;
        }
      }
    }
    // also keeps the chunk until every lane is past it
    if (!__syncthreads_or(open)) break;
  }
  if (warp == 0 && lane < NUM_PAIRS) {
    n_acc[lane] = n;
    // more valid candidates than the C window: the one at C is valid
    const bool over = C < KK &&
        sorted_scores[row0 + (size_t)lane * KK + C] > -CUDART_INF_F;
    if (over) atomicOr(&flags, 1);
  }
  __syncthreads();

  // --- person assembly over the (pair, slot) list, warp 0 -------------------
  if (warp == 0) {
    int total = 0;
    for (int p = 0; p < NUM_PAIRS; ++p) total += n_acc[p];
    int next_slot = 0;
    bool dropped = false;
    int m = 0;
    for (int p = 0; p < NUM_PAIRS && m < M; ++p) {
      const int p1 = g_pair_a[p], p2 = g_pair_b[p];
      const int cnt = n_acc[p];
      for (int e = 0; e < cnt && m < M; ++e, ++m) {
        const int gid1 = p1 * K + acc_ia[p][e];
        const int gid2 = p2 * K + acc_ib[p][e];
        const float k1 = (float)(gid1 + 1), k2 = (float)(gid2 + 1);
        const float cscore = acc_score[p][e];
        const float s1p = pscore[gid1], s2p = pscore[gid2];
        int found = 0, s1 = -1, s2 = -1;
        for (int r0 = 0; r0 < n_people; r0 += 32) {
          const int r = r0 + lane;
          bool hit = false;
          if (r < n_people) {
            const float* row = subset + r * ROW_STRIDE;
            hit = row[COLS - 1] > 0.0f && (row[p1] == k1 || row[p2] == k2);
          }
          unsigned mask = __ballot_sync(FULL, hit);
          found += __popc(mask);
          if (s1 < 0 && mask) {
            s1 = r0 + __ffs(mask) - 1;
            mask &= mask - 1;
          }
          if (s2 < 0 && mask) s2 = r0 + __ffs(mask) - 1;
        }
        s1 = max(s1, 0);
        s2 = max(s2, 0);
        float* r1 = subset + s1 * ROW_STRIDE;
        float* r2 = subset + s2 * ROW_STRIDE;
        const int c = lane;
        const float r1c = c < COLS ? r1[c] : 0.0f;
        const float r2c = c < COLS ? r2[c] : 0.0f;
        const bool membership = __ballot_sync(
            FULL, c < NUM_PARTS && r1c > 0.0f && r2c > 0.0f) != 0;
        const float r1_p2 = r1[p2];
        const bool seed = p < NUM_SEED_PAIRS;
        const bool can_new = next_slot < n_people;
        const bool b_new = found == 0 && seed && can_new;
        const bool b_ext1 = found == 1;
        const bool b_ext2 = found == 2 && membership;
        const bool b_merge = found == 2 && !membership;
        const bool do_set = b_ext2 || (b_ext1 && r1_p2 != k2);
        __syncwarp();   // every read of this step before any write
        if (c < COLS) {
          if (b_new) {
            float v = -1.0f;
            if (c == p1) v = k1;
            else if (c == p2) v = k2;
            else if (c == 18) v = __fadd_rn(__fadd_rn(s1p, s2p), cscore);
            else if (c == 19) v = 2.0f;
            subset[next_slot * ROW_STRIDE + c] = v;
          } else if (do_set) {
            float v = r1c;
            if (c == p2) v = k2;
            else if (c == 18) v = __fadd_rn(r1c, __fadd_rn(s2p, cscore));
            else if (c == 19) v = __fadd_rn(r1c, 1.0f);
            r1[c] = v;
          } else if (b_merge) {
            float v;
            if (c < NUM_PARTS) v = __fadd_rn(r1c, __fadd_rn(r2c, 1.0f));
            else if (c == 18) v = __fadd_rn(r1c, __fadd_rn(r2c, cscore));
            else v = __fadd_rn(r1c, r2c);
            r1[c] = v;
            r2[c] = c == 19 ? 0.0f : -1.0f;
          }
        }
        __syncwarp();   // the writes before the next step's reads
        next_slot += b_new;
        dropped |= found == 0 && seed && !can_new;
      }
    }
    if (lane == 0)
      atomicOr(&flags, (total > M ? 2 : 0) | (dropped ? 4 : 0));
  }
  __syncthreads();

  // --- epilogue: People ----------------------------------------------------
  const int* px = peak_x + (size_t)b * NUM_PARTS * K;
  const int* py = peak_y + (size_t)b * NUM_PARTS * K;
  const int last = NUM_PARTS * K - 1;
  for (int i = tid; i < n_people * NUM_PARTS; i += THREADS) {
    const int r = i / NUM_PARTS, part = i % NUM_PARTS;
    const int cid = __float2int_rz(subset[r * ROW_STRIDE + part]);
    const bool has = cid > 0;
    const int at = min(max(cid - 1, 0), last);
    const size_t o = (size_t)b * n_people * NUM_PARTS + i;
    coords[2 * o] = has ? px[at] : -1;
    coords[2 * o + 1] = has ? py[at] : -1;
    part_score[o] = has ? pscore[at] : 0.0f;
  }
  for (int r = tid; r < n_people; r += THREADS) {
    const float count = subset[r * ROW_STRIDE + 19];
    const float per_part =
        __fdiv_rn(subset[r * ROW_STRIDE + 18], fmaxf(count, 1.0f));
    const size_t o = (size_t)b * n_people + r;
    score[o] = per_part;
    valid[o] = count >= min_part_cnt && per_part >= min_human_score &&
               count > 0.0f;
  }
  if (tid == 0) truncated[b] = peak_truncated[b] || flags != 0;
}

extern "C" {

// Copies the compiled-in pair tables out for the wrapper's check.
int rtpose_group_tables(int* part_a, int* part_b) {
  for (int i = 0; i < NUM_PAIRS; ++i) {
    part_a[i] = h_gp_pair_a[i];
    part_b[i] = h_gp_pair_b[i];
  }
  return NUM_PAIRS;
}

int rtpose_group_people(const float* sorted_scores,
                        const long long* sorted_idx, const int* peak_x,
                        const int* peak_y, const float* peak_score,
                        const bool* peak_truncated, int* coords,
                        float* part_score, float* score, bool* valid,
                        bool* truncated, int batch, int K, int C, int M,
                        int n_people, int min_part_cnt, float min_human_score,
                        void* stream) {
  if (batch == 0) return 0;
  if (K < 0 || K > MAX_K || n_people < 1 || n_people > MAX_PEOPLE ||
      C < 0 || C > K * K || M < 0)
    return (int)cudaErrorInvalidValue;
  group_people_kernel<<<batch, THREADS, 0, (cudaStream_t)stream>>>(
      sorted_scores, sorted_idx, peak_x, peak_y, peak_score, peak_truncated,
      coords, part_score, score, valid, truncated, K, K * K, C, M, n_people,
      (float)min_part_cnt, min_human_score);
  return (int)cudaGetLastError();
}

}  // extern "C"
