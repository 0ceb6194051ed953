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
// chain.  Every assembly step depends on the rows the step before it
// wrote, and every greedy step on the used sets the step before it left:
// per image, the longest pair scan plus up to M assembly steps (117 and
// 601 steps on the scenes chip_smoke.py times at the default and the
// retry caps).  So the design aims at the fewest dependent shared-memory
// round trips per assembly step and no device memory on the chain.
//
// Design: one block of 4 warps per image, all state in dynamic shared
// memory sized from K, Pp and M (above 48 KB at the retry caps).
//  - Greedy: the block stages the next 32 candidates of all 19 pairs into
//    shared memory (scores and (ia, ib), the division done while staging);
//    lane p of warp 0 scans pair p's chunk, its used-a / used-b sets two
//    64-bit masks in registers, and appends what it accepts to pair p's
//    list.  A further chunk is loaded only when some pair's chunk ends in
//    a valid candidate (valid candidates sort first, so a pair whose chunk
//    ends in -inf stops in it), and while the current one is scanned.
//  - The walk: an exclusive prefix over the 19 counts turns the lists into
//    one flat (pair, slot) walk cut at M (the total above M is the
//    connection overflow).  The whole block writes each step's operands
//    into shared memory before the chain: both peak ids, both parts, the
//    seed flag, the connection score and the two sums that do not depend
//    on the rows ((s1p + s2p) + cscore for a new row, s2p + cscore for an
//    extension), from the image's peak scores copied to shared memory.
//  - Assembly, one thread: a row mask per peak id, rowmask[id], Pp bits in
//    Pp/64 64-bit words, holds exactly the rows whose column part(id)
//    holds id + 1.  A step's matching rows are rowmask[gid1] |
//    rowmask[gid2]: `found` is their popcount, s1 the first set bit and s2
//    the last, which is the second when found == 2 (row 0 where none, as
//    jnp.argmax of an all-false mask).  No row scan and no liveness test:
//    a killed row holds no id.  Then r1[p2], r1's sum and count and both
//    rows' 18-bit part masks (the membership test) are read in one round
//    trip, and the step writes what changes: a new row's four columns
//    (the others hold -1 already), an extension's three, a merge's 20 of
//    each row (merges only happen at pairs 17 and 18, whose second part is
//    the only one seen before).  XOR atomics, whose results nobody waits
//    for, keep the masks true: a new row sets two bits; an extension moves
//    bit s1 from the old id at r1[p2] (if any) to k2; a merge moves r2's
//    ids (disjoint from r1's) from bit s2 to bit s1, and kills r2.  The
//    next step's operands are read while this one runs.  So a step is two
//    dependent shared-memory round trips and no barrier, whatever Pp is.
//    On the card a step takes ~450 SM cycles, far above those two round
//    trips: the one thread's stream of dependent instructions sets it
//    (a variant that overlapped the round trips with more instructions
//    was slower; PERF.md).
//  - Epilogue, the whole block: validity, score, coordinates and part
//    scores of every row, from shared memory.
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
#define ROW_STRIDE 21
#define MAX_K 128        // peaks per part: two 64-bit used-set words
#define MAX_PEOPLE 256   // subset rows: four 64-bit row-mask words
#define CHUNK 32         // candidates of each pair staged at a time
#define THREADS 128
#define STAGE_PER_THREAD ((NUM_PAIRS * CHUNK + THREADS - 1) / THREADS)
#define DEFAULT_SMEM_LIMIT 49152
#define MAX_DEVICES 16

#define GP_PAIR_A_INIT {1, 1, 2, 3, 5, 6, 1, 8, 9, 1, 11, 12, 1, 0, 14, 0, \
                        15, 2, 5}
#define GP_PAIR_B_INIT {2, 5, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 0, 14, 16, \
                        15, 17, 16, 17}

__constant__ int g_pair_a[NUM_PAIRS] = GP_PAIR_A_INIT;
__constant__ int g_pair_b[NUM_PAIRS] = GP_PAIR_B_INIT;
static const int h_gp_pair_a[NUM_PAIRS] = GP_PAIR_A_INIT;
static const int h_gp_pair_b[NUM_PAIRS] = GP_PAIR_B_INIT;

// Byte offsets of the block's arrays in dynamic shared memory.
struct SmemLayout {
  size_t rowmask;     // (18K, words) u64: rows holding each peak id
  size_t step;        // (M,) int4: gid1, gid2, p1 | p2 << 8 | seed << 16,
                      //   cscore's bits
  size_t step_sum;    // (M,) float2: (s1p + s2p) + cscore, s2p + cscore
  size_t subset;      // (Pp, ROW_STRIDE) fp32 rows
  size_t part_mask;   // (Pp,) u32: bit c set where column c holds an id
  size_t pscore;      // (18K,) fp32 peak scores
  size_t peak_xy;     // (18K,) int2 peak coordinates
  size_t acc_score;   // (19, K) fp32 accepted connections' scores
  size_t acc_ab;      // (19, K) u16: ia | ib << 8
  size_t st_score;    // (2, CHUNK, 19) fp32 staged candidates
  size_t st_ab;       // (2, CHUNK, 19) int: ia | ib << 16
  size_t total;
};

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

__host__ __device__ inline SmemLayout smem_layout(int K, int n_people, int M,
                                                  int words) {
  SmemLayout s;
  size_t at = 0;
  s.rowmask = at;
  at = align16(at + (size_t)NUM_PARTS * K * words * 8);
  s.step = at;
  at = align16(at + (size_t)M * 16);
  s.step_sum = at;
  at = align16(at + (size_t)M * 8);
  s.subset = at;
  at = align16(at + (size_t)n_people * ROW_STRIDE * 4);
  s.part_mask = at;
  at = align16(at + (size_t)n_people * 4);
  s.pscore = at;
  at = align16(at + (size_t)NUM_PARTS * K * 4);
  s.peak_xy = at;
  at = align16(at + (size_t)NUM_PARTS * K * 8);
  s.acc_score = at;
  at = align16(at + (size_t)NUM_PAIRS * K * 4);
  s.acc_ab = at;
  at = align16(at + (size_t)NUM_PAIRS * K * 2);
  s.st_score = at;
  at = align16(at + (size_t)2 * CHUNK * NUM_PAIRS * 4);
  s.st_ab = at;
  at = align16(at + (size_t)2 * CHUNK * NUM_PAIRS * 4);
  s.total = at;
  return s;
}

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

// Flip bit `row` of peak id `id`'s row mask (its 32-bit half-word).
template <int W>
__device__ __forceinline__ void flip_row(unsigned long long* rowmask, int id,
                                         int row) {
  atomicXor(reinterpret_cast<unsigned*>(rowmask + (size_t)id * W) +
                (row >> 5),
            1u << (row & 31));
}

// Candidates base .. base + 31 of every pair: loads into registers, then
// stores into stage buffer `buf`, apart, so that one chunk's loads fly
// while the chunk before it is scanned.
__device__ __forceinline__ void load_chunk(
    const float* __restrict__ sorted_scores,
    const long long* __restrict__ sorted_idx, size_t row0, int KK, int K,
    int C, int base, int tid, float (&ld_score)[STAGE_PER_THREAD],
    int (&ld_ab)[STAGE_PER_THREAD]) {
#pragma unroll
  for (int u = 0; u < STAGE_PER_THREAD; ++u) {
    const int i = tid + u * THREADS;
    const int p = i / CHUNK, j = i % CHUNK;
    if (i < NUM_PAIRS * CHUNK && base + j < C) {
      const size_t at = row0 + (size_t)p * KK + base + j;
      const int id = (int)sorted_idx[at];
      const int ia = id / K;
      ld_score[u] = sorted_scores[at];
      ld_ab[u] = ia | ((id - ia * K) << 16);
    }
  }
}

__device__ __forceinline__ void store_chunk(
    float* st_score, int* st_ab, int C, int base, int buf, int tid,
    const float (&ld_score)[STAGE_PER_THREAD],
    const int (&ld_ab)[STAGE_PER_THREAD]) {
#pragma unroll
  for (int u = 0; u < STAGE_PER_THREAD; ++u) {
    const int i = tid + u * THREADS;
    const int p = i / CHUNK, j = i % CHUNK;
    if (i < NUM_PAIRS * CHUNK && base + j < C) {
      st_score[(buf * CHUNK + j) * NUM_PAIRS + p] = ld_score[u];
      st_ab[(buf * CHUNK + j) * NUM_PAIRS + p] = ld_ab[u];
    }
  }
}

// sorted_scores: (B, 19, KK) fp32, descending, -inf for invalid candidates
// sorted_idx:    (B, 19, KK) int64 flat candidate index ia * K + ib
// peak_x, peak_y: (B, 18, K) int32; peak_score: (B, 18, K) fp32
// peak_truncated: (B,) bool
// coords (B, P, 18, 2) int32, part_score (B, P, 18) fp32, score (B, P)
// fp32, valid (B, P) bool, truncated (B,) bool; P = n_people
// phase_cycles: null, or (B, 4) int64 that receives each block's SM cycles
// in the greedy scan, the walk's set-up, the assembly chain, the epilogue
template <int W>
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
                    float min_human_score,
                    long long* __restrict__ phase_cycles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const SmemLayout L = smem_layout(K, n_people, M, W);
  unsigned long long* rowmask =
      reinterpret_cast<unsigned long long*>(smem + L.rowmask);
  int4* step_op = reinterpret_cast<int4*>(smem + L.step);
  float2* step_sum = reinterpret_cast<float2*>(smem + L.step_sum);
  float* subset = reinterpret_cast<float*>(smem + L.subset);
  unsigned* part_mask = reinterpret_cast<unsigned*>(smem + L.part_mask);
  float* ps = reinterpret_cast<float*>(smem + L.pscore);
  int2* pxy = reinterpret_cast<int2*>(smem + L.peak_xy);
  float* acc_score = reinterpret_cast<float*>(smem + L.acc_score);
  unsigned short* acc_ab = reinterpret_cast<unsigned short*>(smem + L.acc_ab);
  float* st_score = reinterpret_cast<float*>(smem + L.st_score);
  int* st_ab = reinterpret_cast<int*>(smem + L.st_ab);
  __shared__ int n_acc[NUM_PAIRS];
  __shared__ int offset[NUM_PAIRS];
  __shared__ int n_total;
  __shared__ int flags;   // bit 0 candidate, 1 connection, 2 people overflow

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const unsigned FULL = 0xffffffffu;
  const size_t row0 = (size_t)b * NUM_PAIRS * KK;
  const float* pscore = peak_score + (size_t)b * NUM_PARTS * K;
  const long long t_start = clock64();

  // the candidate at C of each pair (valid: the window overflowed), read
  // now and tested after the scan
  float at_c = -CUDART_INF_F;
  if (warp == 0 && lane < NUM_PAIRS && C < KK)
    at_c = sorted_scores[row0 + (size_t)lane * KK + C];

  float ld_score[STAGE_PER_THREAD];
  int ld_ab[STAGE_PER_THREAD];
  if (C > 0)
    load_chunk(sorted_scores, sorted_idx, row0, KK, K, C, 0, tid, ld_score,
               ld_ab);
  const int* px = peak_x + (size_t)b * NUM_PARTS * K;
  const int* py = peak_y + (size_t)b * NUM_PARTS * K;
#pragma unroll 4
  for (int i = tid; i < NUM_PARTS * K; i += THREADS) {
    ps[i] = pscore[i];
    pxy[i] = make_int2(px[i], py[i]);
  }
  for (int i = tid; i < NUM_PARTS * K * W; i += THREADS) rowmask[i] = 0ull;
  for (int i = tid; i < n_people * COLS; i += THREADS) {
    const int c = i % COLS;
    subset[(i / COLS) * ROW_STRIDE + c] = c == COLS - 1 ? 0.0f : -1.0f;
  }
  for (int i = tid; i < n_people; i += THREADS) part_mask[i] = 0u;
  if (tid == 0) flags = 0;
  if (C > 0) store_chunk(st_score, st_ab, C, 0, 0, tid, ld_score, ld_ab);
  __syncthreads();

  // --- greedy 1-1 matching, pair p on lane p of warp 0 ---------------------
  unsigned long long used_a0 = 0, used_a1 = 0, used_b0 = 0, used_b1 = 0;
  int n = 0;
  bool open = warp == 0 && lane < NUM_PAIRS;
  const int n_chunks = (C + CHUNK - 1) / CHUNK;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int base = ci * CHUNK, buf = ci & 1;
    const int len = min(CHUNK, C - base);
    // a pair goes on past this chunk only if its last candidate is valid
    const float* last = st_score + (buf * CHUNK + len - 1) * NUM_PAIRS;
    const bool more = ci + 1 < n_chunks &&
        __any_sync(FULL, lane < NUM_PAIRS && last[min(lane, NUM_PAIRS - 1)]
                             != -CUDART_INF_F);
    if (more)
      load_chunk(sorted_scores, sorted_idx, row0, KK, K, C, base + CHUNK, tid,
                 ld_score, ld_ab);
    if (open) {
      const float* sc = st_score + buf * CHUNK * NUM_PAIRS + lane;
      const int* ab = st_ab + buf * CHUNK * NUM_PAIRS + lane;
      float s = sc[0];
      int a = ab[0];
      for (int j = 0; j < len; ++j) {
        const int jn = min(j + 1, len - 1);
        const float s_next = sc[jn * NUM_PAIRS];
        const int a_next = ab[jn * NUM_PAIRS];
        if (s == -CUDART_INF_F) {   // the valid candidates are all behind
          open = false;
          break;
        }
        if (fabsf(s) < CUDART_INF_F) {   // JAX's isfinite test
          const int ia = a & 0xffff, ib = a >> 16;
          if (!test_bit(used_a0, used_a1, ia) &&
              !test_bit(used_b0, used_b1, ib)) {
            set_bit(used_a0, used_a1, ia);
            set_bit(used_b0, used_b1, ib);
            acc_score[lane * K + n] = s;
            acc_ab[lane * K + n] = (unsigned short)(ia | (ib << 8));
            ++n;
          }
        }
        s = s_next;
        a = a_next;
      }
    }
    if (!more) break;   // the same on every thread
    store_chunk(st_score, st_ab, C, base + CHUNK, buf ^ 1, tid, ld_score,
                ld_ab);
    __syncthreads();
  }

  // the flat (pair, slot) walk: offsets, total, the two overflow flags
  if (warp == 0) {
    const int v = lane < NUM_PAIRS ? n : 0;
    int incl = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += t;
    }
    const int total = __shfl_sync(FULL, incl, 31);
    const bool over = __any_sync(FULL, at_c > -CUDART_INF_F);
    if (lane < NUM_PAIRS) {
      n_acc[lane] = v;
      offset[lane] = incl - v;
    }
    if (lane == 0) {
      n_total = total;
      flags = (over ? 1 : 0) | (total > M ? 2 : 0);
    }
  }
  __syncthreads();
  const long long t_greedy = clock64();

  // every step's operands, by the whole block
  for (int i = tid; i < NUM_PAIRS * K; i += THREADS) {
    const int p = i / K, e = i - p * K;
    const int m = offset[p] + e;
    if (e < n_acc[p] && m < M) {
      const int ab = acc_ab[i];
      const int p1 = g_pair_a[p], p2 = g_pair_b[p];
      const int gid1 = p1 * K + (ab & 0xff), gid2 = p2 * K + (ab >> 8);
      const float cscore = acc_score[i];
      const float s1p = ps[gid1], s2p = ps[gid2];
      step_op[m] = make_int4(gid1, gid2,
                             p1 | (p2 << 8) | ((p < NUM_SEED_PAIRS) << 16),
                             __float_as_int(cscore));
      step_sum[m] = make_float2(__fadd_rn(__fadd_rn(s1p, s2p), cscore),
                                __fadd_rn(s2p, cscore));
    }
  }
  __syncthreads();
  const long long t_walk = clock64();

  // --- person assembly over the (pair, slot) walk, one thread ------------
  if (tid == 0) {
    const int steps = min(n_total, M);
    int next_slot = 0;
    bool dropped = false;
    int4 op = make_int4(0, 0, 0, 0);
    float2 sums = make_float2(0.0f, 0.0f);
    if (steps > 0) {
      op = step_op[0];
      sums = step_sum[0];
    }
    for (int m = 0; m < steps; ++m) {
      const int mn = min(m + 1, steps - 1);   // the next step's operands
      const int4 op_next = step_op[mn];
      const float2 sums_next = step_sum[mn];
      const int gid1 = op.x, gid2 = op.y;
      const int p1 = op.z & 0xff, p2 = (op.z >> 8) & 0xff;
      const bool seed = (op.z >> 16) != 0;
      const float cscore = __int_as_float(op.w);
      const float k1 = (float)(gid1 + 1), k2 = (float)(gid2 + 1);

      // the rows that hold k1 at p1 or k2 at p2, from the two masks
      unsigned long long word[W];
      int found = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        word[w] = rowmask[gid1 * W + w] | rowmask[gid2 * W + w];
        found += __popcll(word[w]);
      }
      int first = 0, last = 0;
#pragma unroll
      for (int w = W - 1; w >= 0; --w)
        if (word[w]) first = 64 * w + __ffsll((long long)word[w]) - 1;
#pragma unroll
      for (int w = 0; w < W; ++w)
        if (word[w]) last = 64 * w + 63 - __clzll((long long)word[w]);
      const int s1 = first;
      const int s2 = found == 2 ? last : 0;

      float* r1 = subset + s1 * ROW_STRIDE;
      const float r1_p2 = r1[p2], r1_ssum = r1[18], r1_count = r1[19];
      const unsigned pm1 = part_mask[s1], pm2 = part_mask[s2];
      if (found == 0) {
        if (seed && next_slot < n_people) {   // a new row (its columns
          float* row = subset + next_slot * ROW_STRIDE;   // are -1, 0)
          row[p1] = k1;
          row[p2] = k2;
          row[18] = sums.x;
          row[19] = 2.0f;
          flip_row<W>(rowmask, gid1, next_slot);
          flip_row<W>(rowmask, gid2, next_slot);
          part_mask[next_slot] = (1u << p1) | (1u << p2);
          ++next_slot;
        } else if (seed) {
          dropped = true;
        }
      } else if (found == 1 || (found == 2 && (pm1 & pm2) != 0u)) {
        if (found == 2 || r1_p2 != k2) {   // extend row s1 with k2
          r1[p2] = k2;
          r1[18] = __fadd_rn(r1_ssum, sums.y);
          r1[19] = __fadd_rn(r1_count, 1.0f);
          if (r1_p2 != k2) {   // bit s1 moves from the old id (if any) to k2
            if (r1_p2 > 0.0f)
              flip_row<W>(rowmask, __float2int_rz(r1_p2) - 1, s1);
            flip_row<W>(rowmask, gid2, s1);
            part_mask[s1] = pm1 | (1u << p2);
          }
        }
      } else if (found == 2) {   // merge row s2 into row s1, kill row s2
        float* r2 = subset + s2 * ROW_STRIDE;
        const float r2_ssum = r2[18], r2_count = r2[19];
        for (int c = 0; c < NUM_PARTS; ++c) {
          const float a = r1[c], v = r2[c];
          r1[c] = __fadd_rn(a, __fadd_rn(v, 1.0f));
          r2[c] = -1.0f;
          if (v > 0.0f) {   // r2's ids (none of r1's parts) move to row s1
            const int id = __float2int_rz(v) - 1;
            flip_row<W>(rowmask, id, s2);
            flip_row<W>(rowmask, id, s1);
          }
        }
        r1[18] = __fadd_rn(r1_ssum, __fadd_rn(r2_ssum, cscore));
        r1[19] = __fadd_rn(r1_count, r2_count);
        r2[18] = -1.0f;
        r2[19] = 0.0f;
        part_mask[s1] = pm1 | pm2;
        part_mask[s2] = 0u;
      }
      op = op_next;
      sums = sums_next;
    }
    if (dropped) atomicOr(&flags, 4);
  }
  __syncthreads();
  const long long t_chain = clock64();

  // --- epilogue: People ----------------------------------------------------
  const int last_id = NUM_PARTS * K - 1;
  for (int i = tid; i < n_people * NUM_PARTS; i += THREADS) {
    const int r = i / NUM_PARTS, part = i % NUM_PARTS;
    const int cid = __float2int_rz(subset[r * ROW_STRIDE + part]);
    const bool has = cid > 0;
    const int at = min(max(cid - 1, 0), last_id);
    const size_t o = (size_t)b * n_people * NUM_PARTS + i;
    const int2 xy = pxy[at];
    coords[2 * o] = has ? xy.x : -1;
    coords[2 * o + 1] = has ? xy.y : -1;
    part_score[o] = has ? ps[at] : 0.0f;
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
  if (phase_cycles != nullptr) {   // the same on every thread
    __syncthreads();
    if (tid == 0) {
      long long* out = phase_cycles + (size_t)b * 4;
      out[0] = t_greedy - t_start;
      out[1] = t_walk - t_greedy;
      out[2] = t_chain - t_walk;
      out[3] = clock64() - t_chain;
    }
  }
}

template <int W>
static int launch(const float* sorted_scores, const long long* sorted_idx,
                  const int* peak_x, const int* peak_y,
                  const float* peak_score, const bool* peak_truncated,
                  int* coords, float* part_score, float* score, bool* valid,
                  bool* truncated, int batch, int K, int C, int M,
                  int n_people, int min_part_cnt, float min_human_score,
                  long long* phase_cycles, cudaStream_t stream) {
  // above 48 KB a block's shared memory must be asked for, once per
  // device and size
  static int granted[MAX_DEVICES] = {0};
  const size_t bytes = smem_layout(K, n_people, M, W).total;
  if (bytes > DEFAULT_SMEM_LIMIT) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= MAX_DEVICES || (int)bytes > granted[dev]) {
      err = cudaFuncSetAttribute(group_people_kernel<W>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)bytes);
      if (err != cudaSuccess) return (int)err;
      if (dev < MAX_DEVICES) granted[dev] = (int)bytes;
    }
  }
  group_people_kernel<W><<<batch, THREADS, bytes, stream>>>(
      sorted_scores, sorted_idx, peak_x, peak_y, peak_score, peak_truncated,
      coords, part_score, score, valid, truncated, K, K * K, C, M, n_people,
      (float)min_part_cnt, min_human_score, phase_cycles);
  return (int)cudaGetLastError();
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

// The dynamic shared memory a block takes at these sizes, in bytes.
int rtpose_group_smem_bytes(int K, int n_people, int M) {
  if (K < 0 || K > MAX_K || n_people < 1 || n_people > MAX_PEOPLE || M < 0)
    return -1;
  M = M < NUM_PAIRS * K ? M : NUM_PAIRS * K;
  return (int)smem_layout(K, n_people, M, (n_people + 63) / 64).total;
}

int rtpose_group_people(const float* sorted_scores,
                        const long long* sorted_idx, const int* peak_x,
                        const int* peak_y, const float* peak_score,
                        const bool* peak_truncated, int* coords,
                        float* part_score, float* score, bool* valid,
                        bool* truncated, int batch, int K, int C, int M,
                        int n_people, int min_part_cnt, float min_human_score,
                        long long* phase_cycles, void* stream) {
  if (batch == 0) return 0;
  if (K < 0 || K > MAX_K || n_people < 1 || n_people > MAX_PEOPLE ||
      C < 0 || C > K * K || M < 0)
    return (int)cudaErrorInvalidValue;
  M = M < NUM_PAIRS * K ? M : NUM_PAIRS * K;   // the walk never holds more
  const cudaStream_t s = (cudaStream_t)stream;
#define RTPOSE_GROUP_LAUNCH(W)                                               \
  launch<W>(sorted_scores, sorted_idx, peak_x, peak_y, peak_score,          \
            peak_truncated, coords, part_score, score, valid, truncated,    \
            batch, K, C, M, n_people, min_part_cnt, min_human_score,        \
            phase_cycles, s)
  switch ((n_people + 63) / 64) {
    case 1: return RTPOSE_GROUP_LAUNCH(1);
    case 2: return RTPOSE_GROUP_LAUNCH(2);
    case 3: return RTPOSE_GROUP_LAUNCH(3);
    default: return RTPOSE_GROUP_LAUNCH(4);
  }
#undef RTPOSE_GROUP_LAUNCH
}

}  // extern "C"
