"""PAF grouping: connection scoring, greedy matching, person assembly.

Port of rtpose_tpu/ops/grouping.py, batched over a leading image axis:

- :func:`score_connections`: every (pair, ia, ib) candidate's geometry,
  10-sample PAF line integral, criterion and validity in one CUDA kernel
  (``kernels.connection_scores``);
- a stable sort of every pair's candidates by score (``lax.top_k``'s
  order), left to ``torch.sort`` as JAX leaves ``top_k`` outside its scan;
- greedy 1-1 assignment per limb over the sorted candidates (reference
  pafprocess.cpp:96-124) and the sequential person assembly over the
  compacted connection list (pafprocess.cpp:127-191), both in one CUDA
  kernel, a block per image (``kernels.group_people``).

On the card nothing in the decode is read back to the host.  The plain
version of the grouping kernel is two torch loops, each bounded by one
read-back; :func:`greedy_connections` and :func:`assemble_people` expose
them one at a time.  Peak ids are 1-based (cid = part*K + k + 1) as in the
JAX device path.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .kernels import (assemble_plain, connection_scores, greedy_plain,
                      group_people)
from .peaks import Peaks, top_k_stable

SAMPLING_MODES = ("auto", "pallas", "pallas_fused")


@dataclasses.dataclass
class People:
    """Fixed-shape decoded people, (B, ...) on every field.

    coords: (B, P, 18, 2) int32 x,y in the upsampled frame (-1 if missing)
    part_score: (B, P, 18) float32 (0 if missing)
    score: (B, P) float32 person score (score-sum / part-count)
    valid: (B, P) bool
    truncated: (B,) bool — some fixed-shape cap overflowed
    """
    coords: torch.Tensor
    part_score: torch.Tensor
    score: torch.Tensor
    valid: torch.Tensor
    truncated: torch.Tensor


def score_connections(peaks: Peaks, paf: torch.Tensor, *, factor: int = 8,
                      thresh_vector_cnt: int = 6, sampling: str = "auto"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score all candidates; paf is (B, h, w, 38).

    Returns (scores, valid), both (B, 19, K, K); scores are the
    criterion-2 values of pafprocess.cpp:56-92.  `sampling` accepts the
    JAX names 'pallas' / 'pallas_fused' as aliases: both TPU kernels are
    one CUDA kernel here.
    """
    if sampling not in SAMPLING_MODES:
        raise ValueError(f"sampling must be one of {SAMPLING_MODES}, got "
                         f"{sampling!r}")
    return connection_scores(paf.float().contiguous(), peaks.x, peaks.y,
                             peaks.valid, factor=factor,
                             thresh_vector_cnt=thresh_vector_cnt)


def sorted_candidates(scores: torch.Tensor, valid: torch.Tensor):
    """(B, 19, K, K) scores and validity -> every pair's candidates sorted
    by score, descending and stable (ties to the lower flat index, as
    ``lax.top_k``), invalid ones -inf: (scores, flat indices), each
    (B, 19, K*K)."""
    B, P, Ka, Kb = scores.shape
    flat = torch.where(valid, scores, -torch.inf).reshape(B, P, Ka * Kb)
    return top_k_stable(flat, Ka * Kb)


def greedy_connections(scores: torch.Tensor, valid: torch.Tensor,
                       max_conns: int = 256):
    """Greedy 1-1 assignment per pair over score-sorted candidates (the
    plain version's first loop, ``kernels.greedy_plain``).

    Returns (conn_ia, conn_ib, conn_score, conn_valid), each (B, 19, K) in
    pair-major acceptance order, and `overflow` (B,): a pair had more
    valid candidates than the max_conns window.
    """
    return greedy_plain(*sorted_candidates(scores, valid), scores.shape[2],
                        max_conns)


def assemble_people(conn_ia, conn_ib, conn_score, conn_valid, peaks: Peaks,
                    *, max_people: int = 64, min_part_cnt: int = 4,
                    min_human_score: float = 0.3, max_total_conns: int = 160,
                    extra_truncated=None) -> People:
    """Sequential person assembly (reference pafprocess.cpp:127-191; the
    plain version's second loop, ``kernels.assemble_plain``)."""
    return People(*assemble_plain(
        conn_ia, conn_ib, conn_score, conn_valid, peaks.x, peaks.y,
        peaks.score, peaks.truncated, max_people=max_people,
        min_part_cnt=min_part_cnt, min_human_score=min_human_score,
        max_total_conns=max_total_conns, extra_truncated=extra_truncated))


def group_peaks_device(peaks: Peaks, paf: torch.Tensor, *, factor: int = 8,
                       thresh_vector_cnt: int = 6, max_people: int = 64,
                       min_part_cnt: int = 4, min_human_score: float = 0.3,
                       max_candidates: int = 256, max_total_conns: int = 160,
                       sampling: str = "auto") -> People:
    """peaks + (B, h, w, 38) low-res PAF -> fixed-shape people: the scoring
    kernel, a stable sort of every pair's candidates, then greedy matching
    and assembly in one launch of the grouping kernel.  Nothing is read
    back to the host."""
    scores, valid = score_connections(peaks, paf, factor=factor,
                                      thresh_vector_cnt=thresh_vector_cnt,
                                      sampling=sampling)
    return People(*group_people(
        *sorted_candidates(scores, valid), peaks.x, peaks.y, peaks.score,
        peaks.truncated, max_candidates=max_candidates,
        max_people=max_people, max_total_conns=max_total_conns,
        min_part_cnt=min_part_cnt, min_human_score=min_human_score))
