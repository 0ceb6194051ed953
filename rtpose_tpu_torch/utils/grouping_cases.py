"""Crafted candidate sets for the greedy matching and person assembly, and
a count of the assembly branches they take.

:func:`candidate_batch` draws scored candidate limbs for a batch of
images whose density rises from sparse to dense across the batch, with
scores on a coarse grid so that exact ties are common.  At the default or
the retry caps such a batch reaches every branch of the JAX scans
(rtpose_tpu/ops/grouping.py:248-407): new rows, extensions that set a part
and ones that find it set, extensions of the first of two rows, merges,
connections dropped for matching three or more rows, a full people table,
and the candidate and connection windows overflowing.  The tests and
``chip_smoke.py`` hold the grouping kernel and its plain version against
each other, and the plain version against JAX, on such batches;
:func:`branch_hits` shows which branches a batch reached.
"""

from __future__ import annotations

from collections import Counter

import numpy as np

from ..skeleton import GROUP_PAIRS, NUM_GROUP_PAIRS, NUM_PARTS, NUM_SEED_PAIRS

BRANCHES = ("new", "extend", "extend_set_already", "extend_two_rows",
            "merge", "found3plus", "people_overflow", "conn_overflow",
            "cand_overflow", "score_ties")


def candidate_batch(seed: int, n_images: int, K: int):
    """Scored candidates and peaks of `n_images` images, numpy:
    scores (B, 19, K, K) fp32 (multiples of 1/16, so ties abound), valid
    (B, 19, K, K) bool, peak x, y (B, 18, K) int32, peak scores (B, 18, K)
    fp32 and peak truncation (B,) bool.  Image b has a random number of
    valid peaks per part (the last image every peak) and candidates of
    both valid ends valid with a probability rising from 1% (b = 0) to 90%
    (the last image); the peaks of image B // 2 are marked truncated."""
    rng = np.random.RandomState(seed)
    B = n_images
    scores = (rng.randint(1, 17, (B, NUM_GROUP_PAIRS, K, K)) / 16.0
              ).astype(np.float32)
    n_peaks = rng.randint(1, K + 1, (B, NUM_PARTS))
    n_peaks[-1] = K                   # the densest image has every peak
    slot = np.arange(K)
    has = slot[None, None, :] < n_peaks[..., None]              # (B, 18, K)
    pa = np.array([p[0] for p in GROUP_PAIRS])
    pb = np.array([p[1] for p in GROUP_PAIRS])
    density = np.geomspace(0.01, 0.9, B)[:, None, None, None]
    valid = ((rng.rand(B, NUM_GROUP_PAIRS, K, K) < density)
             & has[:, pa, :, None] & has[:, pb, None, :])
    peak_x = rng.randint(0, 400, (B, NUM_PARTS, K)).astype(np.int32)
    peak_y = rng.randint(0, 400, (B, NUM_PARTS, K)).astype(np.int32)
    peak_score = rng.uniform(0.1, 1.0, (B, NUM_PARTS, K)).astype(np.float32)
    truncated = np.arange(B) == B // 2
    return scores, valid, peak_x, peak_y, peak_score, truncated


def merge_chain_batch(K: int = 4):
    """Two images whose assembly reads peak ids that a merge moved to
    another row.  Both: row 0 {neck 0, rshoulder 0} (pair 0); row 1
    {lshoulder 2, lelbow 2} (pair 4); row 2 {nose 1, reye 1, rear 1, leye
    1, lear 1} (pairs 13-16); then pair 17 (rshoulder 0, rear 1) merges
    row 2 into row 0.  Image 0's pair 18 (lshoulder 2, lear 1) then finds
    row 1 and, through the moved lear, row 0, and merges again; image 1's
    (lshoulder 3, lear 1) finds only row 0 through it, which holds that
    lear already.  Same numpy tuple as :func:`candidate_batch`."""
    links = {0: (0, 0), 4: (2, 2), 13: (1, 1), 14: (1, 1), 15: (1, 1),
             16: (1, 1), 17: (0, 1)}
    scores = np.zeros((2, NUM_GROUP_PAIRS, K, K), np.float32)
    valid = np.zeros((2, NUM_GROUP_PAIRS, K, K), bool)
    for b, last in enumerate(((2, 1), (3, 1))):
        for pair, (ia, ib) in {**links, 18: last}.items():
            scores[b, pair, ia, ib] = 0.5 + 0.01 * pair
            valid[b, pair, ia, ib] = True
    rng = np.random.RandomState(3)
    peak_x = rng.randint(0, 400, (2, NUM_PARTS, K)).astype(np.int32)
    peak_y = rng.randint(0, 400, (2, NUM_PARTS, K)).astype(np.int32)
    peak_score = rng.uniform(0.1, 1.0, (2, NUM_PARTS, K)).astype(np.float32)
    return scores, valid, peak_x, peak_y, peak_score, np.zeros(2, bool)


def branch_hits(conn_ia, conn_ib, conn_valid, *, max_people: int,
                max_total_conns: int, scores=None, valid=None,
                max_candidates: int = 0) -> Counter:
    """Replays the assembly scan over accepted connections (numpy, (B, 19,
    K) in acceptance order, as ``greedy_connections`` returns them) in
    plain Python, tracking part ids and counts only, and counts the branch
    each connection takes and the images whose connection window
    overflowed.  Given the candidates' `scores` and `valid` (B, 19, K, K),
    also counts the images whose candidate window overflowed and the exact
    score ties among the valid candidates inside it."""
    hits = Counter({name: 0 for name in BRANCHES})
    B, P, K = conn_ia.shape
    M = min(max_total_conns, P * K)
    for b in range(B):
        if scores is not None:
            C = min(max_candidates, K * K)
            for p in range(P):
                s = np.sort(scores[b, p][valid[b, p]])[::-1][:C]
                hits["score_ties"] += int((s[1:] == s[:-1]).sum())
            hits["cand_overflow"] += int((valid[b].reshape(P, -1).sum(-1)
                                          > C).any())
        entries = [(p, int(conn_ia[b, p, s]), int(conn_ib[b, p, s]))
                   for p in range(P) for s in range(K) if conn_valid[b, p, s]]
        hits["conn_overflow"] += int(len(entries) > M)
        rows = np.full((max_people, NUM_PARTS + 1), -1.0)   # ids, count
        rows[:, -1] = 0.0
        next_slot = 0
        for p, ia, ib in entries[:M]:
            p1, p2 = GROUP_PAIRS[p]
            k1, k2 = p1 * K + ia + 1, p2 * K + ib + 1
            found = [r for r in range(max_people) if rows[r, -1] > 0
                     and (rows[r, p1] == k1 or rows[r, p2] == k2)]
            if not found:
                if p >= NUM_SEED_PAIRS:
                    continue
                if next_slot == max_people:
                    hits["people_overflow"] += 1
                    continue
                hits["new"] += 1
                rows[next_slot, p1], rows[next_slot, p2] = k1, k2
                rows[next_slot, -1] = 2.0
                next_slot += 1
            elif len(found) == 1:
                r1 = rows[found[0]]
                if r1[p2] == k2:
                    hits["extend_set_already"] += 1
                else:
                    hits["extend"] += 1
                    r1[p2] = k2
                    r1[-1] += 1.0
            elif len(found) == 2:
                r1, r2 = rows[found[0]], rows[found[1]]
                if ((r1[:NUM_PARTS] > 0) & (r2[:NUM_PARTS] > 0)).any():
                    hits["extend_two_rows"] += 1
                    r1[p2] = k2
                    r1[-1] += 1.0
                else:
                    hits["merge"] += 1
                    r1[:NUM_PARTS] += r2[:NUM_PARTS] + 1.0
                    r1[-1] += r2[-1]
                    r2[:] = -1.0
                    r2[-1] = 0.0
            else:
                hits["found3plus"] += 1
    return hits
