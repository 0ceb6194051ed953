// Ground-truth heatmap and PAF synthesis for training, hand-written for
// Hopper: keypoints in, maps out, one launch.
//
// Replaces the TPU Pallas kernel rtpose_tpu/ops/pallas_gt.py gt_maps_pallas
// (K4, body _gt_kernel) together with the XLA precompute before it
// (pallas_gt.py:139-171): the person-loop bound and the per-limb scalars.
// Per image and grid cell, over the image's first n persons (n = 1 + index
// of the last person with a visible part):
//   heat[part] += exp(-expo), expo = d2 * (1 / (2 sigma^2)), where
//     expo <= ln 100 and the part is visible; d2 is the squared distance
//     from the cell's pixel centre (g * stride + stride / 2 - 0.5);
//   for each limb from part a to part b, in grid units (pixels / stride):
//     u = (b - a) / max(|b - a|, 1e-12); inside the mask
//     |(gx - ax) uy - (gy - ay) ux| < limb_width, inside the box
//     [mnx, mxx) x [mny, mxy) = round(min(a, b) - limb_width) ..
//     round(max(a, b) + limb_width) (half to even) and valid (both ends
//     visible, |b - a| > 0): pafx += ux, pafy += uy, cnt += 1.
// Then the parts clip at 1, the background is max(1 - max over parts, 0),
// and the PAF is averaged by max(cnt, 1).
//
// What bounds it on this card: bytes, and they are the outputs.  At the
// flagship batch (72 images, 46 x 46 grid) the two maps are 72 * 2116 *
// 57 * 4 B = 34.7 MB beside 0.5 MB of keypoints, 10.5 us at 3.35 TB/s;
// the arithmetic that survives the culling below is a small fraction of
// that.  The first version of this kernel (one thread per cell and row of
// 19, 16 cells per block) took seven times the bound: every thread fetched
// its 12 scalars per person through dependent loads inside the person loop,
// 133 blocks per image fetched the same scalars again, every cell visited
// every person, a warp straddled cells and rows, and the PAF left as
// 4-byte stores at a stride of 8.  The scalars themselves were a few dozen
// eager PyTorch launches before the kernel.
//
// Design:
// - A block owns TILES_PER_BLOCK tiles of TILE consecutive row-major cells
//   of one image.  It copies the image's (N, 18, 3) keypoints into
//   shared memory once, finds the person bound there, and computes the n
//   persons' limb scalars with the exact expressions of
//   pallas_gt.py:152-171 (IEEE division and root, rintf for the
//   half-to-even round), so nothing but the keypoints is read from device
//   memory and nothing runs before the kernel.
// - Beside each person's part and limb it notes the box of cells the term
//   can touch: the Gaussian's reach sqrt(ln 100 * 2 sigma^2) around the
//   part, rounded outwards to whole cells, and the limb's rounded box.  A
//   term whose box misses the tile is skipped.  Such a term fails the
//   kernel's own tests on every one of the tile's cells, so it is one the
//   loop would not have added, and the sums are the same to the bit.
// - A warp takes one row of 19 (part r for the heat, limb r for the PAF)
//   over the whole tile, each lane CHUNKS cells with their four sums in
//   registers.  Its lanes first test 32 persons' boxes against the tile at
//   once; two ballots give the persons whose part and whose limb can touch
//   it, and the warp visits only those, in ascending order, the
//   reference's order of summation.  A person's scalars are then one
//   broadcast read, and every branch on them is warp-uniform.
// - Results are staged in shared memory in the final (cell, channel)
//   layout; a tile of consecutive cells is one contiguous span of
//   cells * 19 floats of `heat` and one of cells * 38 of `paf`, written as
//   16-byte vectors with scalar stores for an unaligned head or tail (the
//   stage is offset so that it shares the span's alignment).
// What holds it above its bound now (read from timings with phases
// switched off): the
// phases of a block are serial (stage the persons, then per tile the
// sums, the background, the stores, a barrier between each), so the
// stores overlap only with other blocks' work, four to a multiprocessor;
// and the blocks of an image with many persons run longest and finish
// the launch alone.
// The library is built with -fmad=false: contracting d2 or the
// perpendicular distance into an FMA would move cells across the < and <=
// tests.  expf (not __expf) keeps the heat within 1e-6 of the reference.

#include <cuda_runtime.h>
#include <stdint.h>

#define NUM_PARTS 18
#define NUM_ROWS 19       // 18 parts + background (heat), 19 limbs (PAF)
#define KP_FLOATS (NUM_PARTS * 3)
#define LN100 4.6052f     // gaussian support cutoff (reference heatmap.py:30)
#define MAX_SMEM (227 * 1024)
#define MAX_GRID 32766    // cell indices are packed as 16-bit integers
// the launch's shape; of those tried on an H100 at 72 images of 46 x 46
// cells the fastest, and four blocks fit a multiprocessor
#define CHUNKS 4              // cells per lane
#define TILE (32 * CHUNKS)    // cells per staged tile
#define TILES_PER_BLOCK 3
#define THREADS 320           // 10 warps for a tile's 19 rows
// cells added to the Gaussian's reach before it is rounded outwards to whole
// cells: far above the rounding of a cell's distance to the part, which
// is 1e-7 of coordinates below stride * MAX_GRID, under 0.004 cells
#define REACH_MARGIN 0.05f

// limb l runs from part LIMB_A[l] to part LIMB_B[l] (skeleton.LIMBS; the
// wrapper checks these tables against it when it loads the library)
#define LIMB_A_INIT {1, 8, 9, 1, 11, 12, 1, 2, 3, 2, 1, 5, 6, 5, 1, 0, 0, \
                     14, 15}
#define LIMB_B_INIT {8, 9, 10, 11, 12, 13, 2, 3, 4, 14, 5, 6, 7, 15, 0, 14, \
                     15, 16, 17}
__constant__ int c_limb_a[NUM_ROWS] = LIMB_A_INIT;
__constant__ int c_limb_b[NUM_ROWS] = LIMB_B_INIT;
static const int h_limb_a[NUM_ROWS] = LIMB_A_INIT;
static const int h_limb_b[NUM_ROWS] = LIMB_B_INIT;

// A cell index for a box: v clamped to [-1, g] (NaN gives -1; a term with
// a NaN in it passes none of the kernel's tests, so its box may be any).
__device__ __forceinline__ int to_cell(float v, int g) {
  return (int)fminf(fmaxf(v, -1.0f), (float)g);
}

__device__ __forceinline__ int pack2(int lo, int hi) {
  return (lo & 0xffff) | (int)((unsigned)hi << 16);
}
// the range of an invisible part or an invalid limb: it starts past every
// cell, so it overlaps no warp's cells
#define EMPTY_BOX pack2(32767, -32768)
__device__ __forceinline__ int low16(int w) { return (int)(short)(w & 0xffff); }
__device__ __forceinline__ int high16(int w) { return w >> 16; }

// len floats from shared `src` to global `dst`, which share their
// alignment modulo 16 bytes: 16-byte vectors with a scalar head and tail.
__device__ __forceinline__ void store_span(float* __restrict__ dst,
                                           const float* __restrict__ src,
                                           int len, int tid, int nthreads) {
  const int head = min(len, (int)((4 - (((uintptr_t)dst >> 2) & 3)) & 3));
  const int body = (len - head) >> 2;
  const int tail = head + (body << 2);
  if (tid < head) dst[tid] = src[tid];
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  const float4* s4 = reinterpret_cast<const float4*>(src + head);
  for (int i = tid; i < body; i += nthreads) d4[i] = s4[i];
  if (tid < len - tail) dst[tail + tid] = src[tail + tid];
}

// kp:   (B, N, 18, 3) fp32 [x, y, v] keypoints in input pixels
// heat: (B, grid_y, grid_x, 19) fp32 out; paf: (B, grid_y, grid_x, 38)
// Dynamic shared memory, per = 19 N:
//   int4 boxes[per]     part box y0, y1, x0, x1 and limb box, 16-bit each
//   float4 limbs[per]   ax, ay, ux, uy
//   float2 part_xy[per rounded up to even]
//   float2 cell_xy[TILE]  the tile's cells as (gx, gy)
//   float stage[max(54 N, 57 TILE + 8)]  the raw keypoints first, then
//       each tile's heat (19 TILE + 4) and PAF
__global__ void __launch_bounds__(THREADS, 4)
    gt_maps_kernel(const float* __restrict__ kp, float* __restrict__ heat,
                   float* __restrict__ paf, int N, int grid_y, int grid_x,
                   float stride, float start, float inv2s,
                   float limb_width) {
  extern __shared__ int4 smem[];
  __shared__ int n_shared;
  const int per = N * NUM_ROWS;
  int4* boxes = smem;
  float4* limbs = reinterpret_cast<float4*>(boxes + per);
  float2* part_xy = reinterpret_cast<float2*>(limbs + per);
  float2* cell_xy = part_xy + ((per + 1) & ~1);
  float* stage = reinterpret_cast<float*>(cell_xy + TILE);

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const int b = blockIdx.y;
  const int area = grid_y * grid_x;

  // the image's keypoints, and the person bound
  const float* kp_b = kp + (size_t)b * N * KP_FLOATS;
  for (int i = tid; i < N * KP_FLOATS; i += nthreads) stage[i] = __ldg(kp_b + i);
  if (tid == 0) n_shared = 0;
  __syncthreads();
  int last = 0;
  for (int i = tid; i < N * NUM_PARTS; i += nthreads)
    if (stage[i * 3 + 2] > 0.5f) last = max(last, i / NUM_PARTS + 1);
  last = __reduce_max_sync(0xffffffffu, last);
  if (lane == 0 && last > 0) atomicMax(&n_shared, last);
  __syncthreads();
  const int n = n_shared;

  // per person and row: the part, the limb scalars, and their boxes
  const float reach = sqrtf(LN100 / inv2s) / stride + REACH_MARGIN;
  for (int i = tid; i < n * NUM_ROWS; i += nthreads) {
    const int r = i % NUM_ROWS;
    const float* k = stage + (i / NUM_ROWS) * KP_FLOATS;
    int hy = EMPTY_BOX, hx = EMPTY_BOX;
    float2 xy = make_float2(0.0f, 0.0f);
    if (r < NUM_PARTS) {
      xy = make_float2(k[r * 3], k[r * 3 + 1]);
      if (k[r * 3 + 2] > 0.5f) {
        const float cy = (xy.y - start) / stride;
        const float cx = (xy.x - start) / stride;
        hy = pack2(to_cell(floorf(cy - reach), grid_y),
                   to_cell(ceilf(cy + reach), grid_y));
        hx = pack2(to_cell(floorf(cx - reach), grid_x),
                   to_cell(ceilf(cx + reach), grid_x));
      }
    }
    part_xy[i] = xy;
    const float* ka = k + c_limb_a[r] * 3;
    const float* kb = k + c_limb_b[r] * 3;
    const float ax = ka[0] / stride, ay = ka[1] / stride;
    const float bx = kb[0] / stride, by = kb[1] / stride;
    const float vx = bx - ax, vy = by - ay;
    const float norm = sqrtf(vx * vx + vy * vy);
    const float un = fmaxf(norm, 1e-12f);
    const float mnx = rintf(fminf(ax, bx) - limb_width);
    const float mxx = rintf(fmaxf(ax, bx) + limb_width);
    const float mny = rintf(fminf(ay, by) - limb_width);
    const float mxy = rintf(fmaxf(ay, by) + limb_width);
    limbs[i] = make_float4(ax, ay, vx / un, vy / un);
    int ly = EMPTY_BOX, lx = EMPTY_BOX;
    if (ka[2] > 0.5f && kb[2] > 0.5f && norm > 0.0f) {
      // gy >= mny and gy < mxy are gy in [mny, mxy - 1], whole numbers
      // all; clamped a cell wide of the grid they decide the same cells
      ly = pack2(to_cell(mny, grid_y), to_cell(mxy, grid_y) - 1);
      lx = pack2(to_cell(mnx, grid_x), to_cell(mxx, grid_x) - 1);
    }
    boxes[i] = make_int4(hy, hx, ly, lx);
  }
  // (the barrier before the first tile's work also ends the raw keypoints'
  // use of `stage`)

  const int n_tiles = (area + TILE - 1) / TILE;
  const int t_end = min((blockIdx.x + 1) * TILES_PER_BLOCK, n_tiles);
  for (int t = blockIdx.x * TILES_PER_BLOCK; t < t_end; ++t) {
    const int c0 = t * TILE;
    const int cells = min(TILE, area - c0);
    float* hdst = heat + ((size_t)b * area + c0) * NUM_ROWS;
    float* pdst = paf + ((size_t)b * area + c0) * (2 * NUM_ROWS);
    float* hst = stage + (((uintptr_t)hdst >> 2) & 3);
    float* pst = stage + TILE * NUM_ROWS + 4 + (((uintptr_t)pdst >> 2) & 3);
    // the tile's cells: rows y0..y1, and columns x0..x1 when one row
    const int y0 = c0 / grid_x, y1 = (c0 + cells - 1) / grid_x;
    const int x0 = y0 == y1 ? c0 - y0 * grid_x : 0;
    const int x1 = y0 == y1 ? c0 + cells - 1 - y0 * grid_x : grid_x - 1;
    for (int local = tid; local < TILE; local += nthreads) {
      const int cy = (c0 + local) / grid_x;
      cell_xy[local] = make_float2((float)(c0 + local - cy * grid_x),
                                   (float)cy);
    }
    __syncthreads();

    // a warp takes one row of 19 over the whole tile
    for (int r = warp; r < NUM_ROWS; r += nwarps) {
      float gx[CHUNKS], gy[CHUNKS], xx[CHUNKS], yy[CHUNKS];
      float h[CHUNKS], sx[CHUNKS], sy[CHUNKS], cnt[CHUNKS];
#pragma unroll
      for (int k = 0; k < CHUNKS; ++k) {
        const float2 g = cell_xy[k * 32 + lane];
        gx[k] = g.x;
        gy[k] = g.y;
        xx[k] = g.x * stride + start;   // pixel centre of the cell
        yy[k] = g.y * stride + start;
        h[k] = sx[k] = sy[k] = cnt[k] = 0.0f;
      }
      for (int p0 = 0; p0 < n; p0 += 32) {
        // lanes over persons: whose part, whose limb can touch the tile
        bool part_hit = false, limb_hit = false;
        if (p0 + lane < n) {
          const int4 box = boxes[(p0 + lane) * NUM_ROWS + r];
          part_hit = low16(box.x) <= y1 && high16(box.x) >= y0 &&
                     low16(box.y) <= x1 && high16(box.y) >= x0;
          limb_hit = low16(box.z) <= y1 && high16(box.z) >= y0 &&
                     low16(box.w) <= x1 && high16(box.w) >= x0;
        }
        // those persons in order, the reference's order of summation; a
        // box that is not empty belongs to a visible part, a valid limb
        unsigned todo = __ballot_sync(0xffffffffu, part_hit);
        while (todo) {
          const float2 xy = part_xy[(p0 + __ffs(todo) - 1) * NUM_ROWS + r];
          todo &= todo - 1;
#pragma unroll
          for (int k = 0; k < CHUNKS; ++k) {
            const float dx = xx[k] - xy.x;
            const float dy = yy[k] - xy.y;
            const float expo = (dx * dx + dy * dy) * inv2s;
            if (expo <= LN100) h[k] += expf(-expo);
          }
        }
        todo = __ballot_sync(0xffffffffu, limb_hit);
        while (todo) {
          const int i = (p0 + __ffs(todo) - 1) * NUM_ROWS + r;
          todo &= todo - 1;
          const float4 la = limbs[i];
          const int4 box = boxes[i];
          const float mny = (float)low16(box.z), mxy = (float)high16(box.z);
          const float mnx = (float)low16(box.w), mxx = (float)high16(box.w);
#pragma unroll
          for (int k = 0; k < CHUNKS; ++k) {
            const float perp =
                fabsf((gx[k] - la.x) * la.w - (gy[k] - la.y) * la.z);
            if (perp < limb_width && gx[k] >= mnx && gx[k] <= mxx &&
                gy[k] >= mny && gy[k] <= mxy) {
              sx[k] += la.z;
              sy[k] += la.w;
              cnt[k] += 1.0f;
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < CHUNKS; ++k) {
        const int local = k * 32 + lane;
        if (local < cells) {
          if (r < NUM_PARTS) hst[local * NUM_ROWS + r] = fminf(h[k], 1.0f);
          // x / 1 is x: only cells where limbs overlap divide
          const float div = fmaxf(cnt[k], 1.0f);
          *reinterpret_cast<float2*>(pst + local * (2 * NUM_ROWS) + 2 * r) =
              cnt[k] > 1.0f ? make_float2(sx[k] / div, sy[k] / div)
                            : make_float2(sx[k], sy[k]);
        }
      }
    }
    __syncthreads();
    // the background from the clipped parts: 1 - min(m, 1) and 1 - m agree
    // wherever either is above 0
    for (int local = tid; local < cells; local += nthreads) {
      float m = 0.0f;
      for (int r = 0; r < NUM_PARTS; ++r)
        m = fmaxf(m, hst[local * NUM_ROWS + r]);
      hst[local * NUM_ROWS + NUM_PARTS] = fmaxf(1.0f - m, 0.0f);
    }
    __syncthreads();
    store_span(hdst, hst, cells * NUM_ROWS, tid, nthreads);
    store_span(pdst, pst, cells * 2 * NUM_ROWS, tid, nthreads);
    __syncthreads();  // before the next tile overwrites the stage
  }
}

extern "C" {

// Copies the compiled-in limb tables out for the wrapper's check.
int rtpose_limb_tables(int* part_a, int* part_b) {
  for (int i = 0; i < NUM_ROWS; ++i) {
    part_a[i] = h_limb_a[i];
    part_b[i] = h_limb_b[i];
  }
  return NUM_ROWS;
}

int rtpose_gt_maps(const float* kp, float* heat, float* paf, int B, int N,
                   int grid_y, int grid_x, float stride, float start,
                   float inv2s, float limb_width, void* stream) {
  if (B == 0 || grid_y * grid_x == 0) return 0;
  if (grid_y > MAX_GRID || grid_x > MAX_GRID || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)heat | (uintptr_t)paf) & 15)
    return (int)cudaErrorMisalignedAddress;
  const size_t per = (size_t)N * NUM_ROWS;
  const size_t raw = (size_t)N * KP_FLOATS;
  const size_t tile = (size_t)TILE * 3 * NUM_ROWS + 8;
  const size_t smem = per * 32 + ((per + 1) & ~(size_t)1) * 8 + TILE * 8 +
                      (raw > tile ? raw : tile) * 4;
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gt_maps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_tiles = (grid_y * grid_x + TILE - 1) / TILE;
  const dim3 grid((n_tiles + TILES_PER_BLOCK - 1) / TILES_PER_BLOCK, B);
  gt_maps_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      kp, heat, paf, N, grid_y, grid_x, stride, start, inv2s, limb_width);
  return (int)cudaGetLastError();
}

}  // extern "C"
