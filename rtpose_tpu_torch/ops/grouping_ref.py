"""Host-side reference grouping: the parity oracle (a copy of
rtpose_tpu/ops/grouping_ref.py, so the port imports nothing of the JAX
package; tests/test_torch_isolation.py holds it equal to the original).

One change: the 5x5 patch upsample of :func:`nms` is cv2 INTER_CUBIC as
two products with the cv2-parity bicubic matrices of ``ops/resize.py``
instead of ``cv2.resize``, which the machine with the card does not have.

A from-scratch numpy implementation of the reference post-processing
pipeline with bit-matching semantics:

- peak NMS with 5x5-patch bicubic sub-pixel refinement
  (reference lib/utils/paf_to_pose.py:25-145)
- PAF line-integral connection scoring, greedy 1-1 assignment and
  person assembly exactly as the production C++ module
  (reference lib/pafprocess/pafprocess.cpp:22-194, constants
  pafprocess.h:6-13)

The port's decode (``ops/decode.py``) is held against this module on the
card by ``python -m rtpose_tpu_torch.selftest``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..skeleton import (GROUP_PAIRS, GROUP_PAIRS_NET, NUM_GROUP_PAIRS,
                        NUM_PARTS, NUM_SEED_PAIRS)
from .resize import resize_matrix

# Branch-hit counters for the assembly stage, so differential tests can
# prove a fuzz corpus actually exercised the C++ quirk branches
# (found==2 merge, the '>0' cid-0 membership blindness) rather than
# trivially passing on easy scenes.  Reset with reset_branch_stats().
BRANCH_STATS = {"found0_new": 0, "found1": 0, "found2_merge": 0,
                "found2_else": 0, "found3plus_dropped": 0,
                "cid0_invisible_merge": 0}


def reset_branch_stats() -> None:
    for k in BRANCH_STATS:
        BRANCH_STATS[k] = 0


# Constants of the C++ grouping stage (reference pafprocess.h:6-13).
THRESH_VECTOR_SCORE = 0.05
THRESH_VECTOR_CNT1 = 6
THRESH_PART_CNT = 4
THRESH_HUMAN_SCORE = 0.3
STEP_PAF = 10


# ---------------------------------------------------------------------------
# Peak finding / NMS
# ---------------------------------------------------------------------------

def find_peaks(thresh: float, img: np.ndarray) -> np.ndarray:
    """Local maxima under a 4-connected footprint above `thresh`.

    Returns (N, 2) [x, y] rows in row-major (y, then x) order.
    Reference lib/utils/paf_to_pose.py:25-38.
    """
    from scipy.ndimage import maximum_filter
    footprint = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], dtype=bool)
    peaks_binary = ((maximum_filter(img, footprint=footprint) == img)
                    & (img > thresh))
    return np.array(np.nonzero(peaks_binary)[::-1]).T


def compute_resized_coords(coords, resize_factor):
    """Pixel-center convention: (c + 0.5) * f - 0.5.

    Reference lib/utils/paf_to_pose.py:41-64.
    """
    return (np.array(coords, dtype=float) + 0.5) * resize_factor - 0.5


def _upsample_cubic(patch: np.ndarray, factor: int) -> np.ndarray:
    """cv2.resize(patch, None, fx=factor, fy=factor, INTER_CUBIC) of a
    float32 patch, as My @ patch @ Mx^T in float64, rounded to float32."""
    h, w = patch.shape
    my = resize_matrix(h, h * factor).astype(np.float64)
    mx = resize_matrix(w, w * factor).astype(np.float64)
    return (my @ patch.astype(np.float64) @ mx.T).astype(np.float32)


def nms(heatmaps: np.ndarray, upsamp_factor: float, thresh: float,
        refine: bool = True, gaussian_filt: bool = False,
        num_parts: int = NUM_PARTS) -> List[np.ndarray]:
    """Per-joint peak lists with sub-pixel refinement.

    heatmaps: (H, W, >=num_parts) low-res maps.
    Returns a list of num_parts arrays, each (K_j, 4): [x, y, score, id]
    with x/y in upsampled-image coordinates and ids global across joints.
    Reference lib/utils/paf_to_pose.py:67-145.
    """
    win_size = 2
    out: List[np.ndarray] = []
    cnt = 0
    for joint in range(num_parts):
        map_orig = heatmaps[:, :, joint]
        coords = find_peaks(thresh, map_orig)
        peaks = np.zeros((len(coords), 4))
        for i, peak in enumerate(coords):
            if refine:
                x_min, y_min = np.maximum(0, peak - win_size)
                x_max, y_max = np.minimum(
                    np.array(map_orig.T.shape) - 1, peak + win_size)
                patch = map_orig[y_min:y_max + 1, x_min:x_max + 1]
                patch_up = _upsample_cubic(patch, upsamp_factor)
                if gaussian_filt:
                    from scipy.ndimage import gaussian_filter
                    patch_up = gaussian_filter(patch_up, sigma=3)
                loc_max = np.unravel_index(patch_up.argmax(), patch_up.shape)
                patch_center = compute_resized_coords(
                    peak[::-1] - [y_min, x_min], upsamp_factor)
                refined = loc_max - patch_center          # (dy, dx)
                score = patch_up[loc_max]
            else:
                refined = np.array([0.0, 0.0])
                score = map_orig[tuple(peak[::-1])]
            xy = compute_resized_coords(peak, upsamp_factor) + refined[::-1]
            peaks[i] = (xy[0], xy[1], score, cnt)
            cnt += 1
        out.append(peaks)
    return out


def joint_list_from_peaks(peaks_per_part: List[np.ndarray]) -> np.ndarray:
    """Flatten per-part peak lists to (N, 5) [x, y, score, id, part]."""
    rows = [tuple(p) + (part,) for part, peaks in enumerate(peaks_per_part)
            for p in peaks]
    if not rows:
        return np.zeros((0, 5), dtype=np.float32)
    return np.array(rows, dtype=np.float32)


# ---------------------------------------------------------------------------
# Connection scoring + assembly (C++ pafprocess semantics)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GroupResult:
    """subset rows (P, 20): 18 part cids, [18]=score sum, [19]=part count.
    peaks: (N, 4) int x, int y, score, part — in peak-id order."""
    subset: np.ndarray
    peak_x: np.ndarray
    peak_y: np.ndarray
    peak_score: np.ndarray
    peak_part: np.ndarray

    @property
    def num_humans(self) -> int:
        return len(self.subset)


def pair_candidates(pair_id: int, a_ids, b_ids, peak_x, peak_y,
                    h_up: float, paf_up: np.ndarray) -> list:
    """The valid candidate connections of pair `pair_id` between the peaks
    `a_ids` and `b_ids` (ids into peak_x / peak_y, upsampled pixels):
    [(criterion2, index into a_ids, index into b_ids)] in enumeration
    order (reference pafprocess.cpp:47-95)."""
    ch_x, ch_y = GROUP_PAIRS_NET[pair_id]
    cands = []  # (score, idx_a, idx_b)
    f32 = np.float32
    for ia, ca in enumerate(a_ids):
        for ib, cb in enumerate(b_ids):
            # float32 arithmetic throughout, matching the C++ module
            # (and the on-device float32 kernel).
            dx = f32(peak_x[cb] - peak_x[ca])
            dy = f32(peak_y[cb] - peak_y[ca])
            norm = f32(np.sqrt(dx * dx + dy * dy))
            if norm < 1e-12:
                continue
            ux, uy = f32(dx / norm), f32(dy / norm)
            # 10 samples at rounded integer coords
            # (reference pafprocess.cpp:220-241).
            scores = f32(0.0)
            crit1 = 0
            # precomputed step, then s * step — the reference's exact
            # expression (pafprocess.cpp:223-229), not (s*dx)/10
            step_x = f32(dx / STEP_PAF)
            step_y = f32(dy / STEP_PAF)
            for s in range(STEP_PAF):
                lx = int(peak_x[ca] + f32(s) * step_x + 0.5)
                ly = int(peak_y[ca] + f32(s) * step_y + 0.5)
                sc = f32(ux * paf_up[ly, lx, ch_x]
                         + uy * paf_up[ly, lx, ch_y])
                scores = f32(scores + sc)
                if sc > THRESH_VECTOR_SCORE:
                    crit1 += 1
            crit2 = f32(scores / STEP_PAF
                        + min(0.0, 0.5 * h_up / float(norm) - 1.0))
            if crit1 > THRESH_VECTOR_CNT1 and crit2 > 0:
                cands.append((crit2, ia, ib))
    return cands


def group_peaks(joint_list: np.ndarray, heat_up_shape: Tuple[int, int],
                paf_up: np.ndarray) -> GroupResult:
    """Greedy bottom-up assembly (reference pafprocess.cpp:22-194).

    joint_list: (N, 5) float32 [x, y, score, id, part] with x/y in
        upsampled-image coordinates (floats; truncated to int here exactly
        like the C++ Peak struct).
    heat_up_shape: (H_up, W_up) of the upsampled heatmap (criterion2 uses H).
    paf_up: (H_up, W_up, 38) nearest-upsampled PAF.
    """
    n = joint_list.shape[0]
    # Bucket peaks by part, preserving order; C++ truncates float -> int.
    px = joint_list[:, 0].astype(np.int64)
    py = joint_list[:, 1].astype(np.int64)
    pscore = joint_list[:, 2].astype(np.float32)
    ppart = joint_list[:, 4].astype(np.int64)
    by_part: List[List[int]] = [[] for _ in range(NUM_PARTS)]
    for i in range(n):
        by_part[ppart[i]].append(i)
    # Re-id peaks in part-bucket order (== input order when the input is
    # already part-sorted, as NMS emits; reference pafprocess.cpp:24-43).
    order = [i for part in range(NUM_PARTS) for i in by_part[part]]
    remap = np.empty(max(n, 1), dtype=np.int64)
    for new_id, old in enumerate(order):
        remap[old] = new_id
    peak_x = px[order]
    peak_y = py[order]
    peak_score = pscore[order]
    peak_part = ppart[order]
    bucket = [[remap[i] for i in by_part[part]] for part in range(NUM_PARTS)]

    h_up = float(heat_up_shape[0])
    connections_all: List[np.ndarray] = []
    for pair_id in range(NUM_GROUP_PAIRS):
        a_ids = bucket[GROUP_PAIRS[pair_id][0]]
        b_ids = bucket[GROUP_PAIRS[pair_id][1]]
        cands = pair_candidates(pair_id, a_ids, b_ids, peak_x, peak_y, h_up,
                                paf_up)
        # stable sort desc by score (reference pafprocess.cpp:97)
        cands.sort(key=lambda t: -t[0])
        used_a: set = set()
        used_b: set = set()
        conns = []  # (cid1, cid2, score)
        for score, ia, ib in cands:
            if ia in used_a or ib in used_b:
                continue
            used_a.add(ia)
            used_b.add(ib)
            conns.append((a_ids[ia], b_ids[ib], score))
        connections_all.append(np.array(conns, dtype=np.float64)
                               if conns else np.zeros((0, 3)))

    # Person assembly (reference pafprocess.cpp:127-191).
    subset: List[np.ndarray] = []
    for pair_id in range(NUM_GROUP_PAIRS):
        part1, part2 = GROUP_PAIRS[pair_id]
        for cid1, cid2, score in connections_all[pair_id]:
            found_rows = []
            for si, row in enumerate(subset):
                if row[part1] == cid1 or row[part2] == cid2:
                    found_rows.append(si)
            found = len(found_rows)
            if found >= 3:
                BRANCH_STATS["found3plus_dropped"] += 1
            if found == 1:
                BRANCH_STATS["found1"] += 1
                row = subset[found_rows[0]]
                if row[part2] != cid2:
                    row[part2] = cid2
                    row[19] += 1
                    row[18] += peak_score[int(cid2)] + score
            elif found == 2:
                # exactly two (reference pafprocess.cpp:161 'else if
                # (found == 2)'): a connection matching 3+ rows is dropped
                s1, s2 = found_rows[0], found_rows[1]
                r1, r2 = subset[s1], subset[s2]
                # NOTE '> 0' (not >= 0): C++ quirk kept for parity — a joint
                # held with cid 0 is invisible to the membership test
                # (reference pafprocess.cpp:153-158).
                membership = any(r1[j] > 0 and r2[j] > 0
                                 for j in range(NUM_PARTS))
                if not membership:
                    BRANCH_STATS["found2_merge"] += 1
                    if any((r1[j] == 0 and r2[j] >= 0)
                           or (r2[j] == 0 and r1[j] >= 0)
                           for j in range(NUM_PARTS)):
                        # a '>= 0' membership test would have blocked this
                        # merge — the cid-0 blindness actually fired
                        BRANCH_STATS["cid0_invisible_merge"] += 1
                    r1[:NUM_PARTS] += r2[:NUM_PARTS] + 1
                    r1[19] += r2[19]
                    r1[18] += r2[18] + score
                    subset.pop(s2)
                else:
                    BRANCH_STATS["found2_else"] += 1
                    r1[part2] = cid2
                    r1[19] += 1
                    r1[18] += peak_score[int(cid2)] + score
            elif found == 0 and pair_id < NUM_SEED_PAIRS:
                BRANCH_STATS["found0_new"] += 1
                row = -np.ones(20)
                row[part1] = cid1
                row[part2] = cid2
                row[19] = 2
                row[18] = (peak_score[int(cid1)] + peak_score[int(cid2)]
                           + score)
                subset.append(row)

    subset = [row for row in subset
              if row[19] >= THRESH_PART_CNT
              and row[18] / row[19] >= THRESH_HUMAN_SCORE]
    return GroupResult(
        subset=np.array(subset) if subset else np.zeros((0, 20)),
        peak_x=peak_x, peak_y=peak_y, peak_score=peak_score,
        peak_part=peak_part)


# ---------------------------------------------------------------------------
# End-to-end: heatmap/paf -> people array
# ---------------------------------------------------------------------------

def upsample_nearest(maps: np.ndarray, factor: int) -> np.ndarray:
    """cv2.INTER_NEAREST x`factor` upsample (reference paf_to_pose.py:382-385).

    cv2 nearest picks src index floor(dst * 1/f) == repeat for integer f.
    """
    return np.repeat(np.repeat(maps, factor, axis=0), factor, axis=1)


def paf_to_people(heatmaps: np.ndarray, pafs: np.ndarray, *,
                  downsample: int = 8, thresh_heatmap: float = 0.1
                  ) -> np.ndarray:
    """Full host pipeline: low-res maps -> (P, 18, 3) people array.

    Output rows: normalized x, y in [0,1) (divided by upsampled map size,
    like reference paf_to_pose.py:390-400) and peak score; missing parts are
    (-1, -1, 0). A trailing (P,) score column is returned via a structured
    tuple — use :func:`people_scores`.
    """
    peaks = nms(heatmaps, upsamp_factor=downsample, thresh=thresh_heatmap)
    joint_list = joint_list_from_peaks(peaks)
    h_up = heatmaps.shape[0] * downsample
    w_up = heatmaps.shape[1] * downsample
    if joint_list.shape[0] == 0:
        return np.zeros((0, NUM_PARTS, 3)), np.zeros((0,))
    paf_up = upsample_nearest(pafs, downsample)
    res = group_peaks(joint_list, (h_up, w_up), paf_up)
    people = np.zeros((res.num_humans, NUM_PARTS, 3))
    people[:, :, :2] = -1.0
    scores = np.zeros((res.num_humans,))
    for hi, row in enumerate(res.subset):
        for part in range(NUM_PARTS):
            cid = int(row[part])
            if cid < 0:
                continue
            people[hi, part, 0] = float(res.peak_x[cid]) / w_up
            people[hi, part, 1] = float(res.peak_y[cid]) / h_up
            people[hi, part, 2] = res.peak_score[cid]
        scores[hi] = row[18] / row[19]
    return people, scores
