"""PAF grouping: connection scoring, greedy matching, person assembly.

Port of rtpose_tpu/ops/grouping.py, batched over a leading image axis:

- :func:`score_connections`: every (pair, ia, ib) candidate's geometry,
  10-sample PAF line integral, criterion and validity in one CUDA kernel
  (``kernels.connection_scores``);
- :func:`greedy_connections`: 1-1 assignment per limb over score-sorted
  candidates (reference pafprocess.cpp:96-124);
- :func:`assemble_people`: the sequential person assembly over the
  compacted connection list (pafprocess.cpp:127-191).

The two sequential stages are torch loops over their steps, vectorised
over images and pairs; their bodies read no value back to the host, so a
CUDA run never synchronises inside them.  Peak ids are 1-based
(cid = part*K + k + 1) as in the JAX device path.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..skeleton import NUM_GROUP_PAIRS, NUM_PARTS, NUM_SEED_PAIRS
from .kernels import PAIR_A, PAIR_B, connection_scores
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


def greedy_connections(scores: torch.Tensor, valid: torch.Tensor,
                       max_conns: int = 256):
    """Greedy 1-1 assignment per pair over score-sorted candidates.

    Returns (conn_ia, conn_ib, conn_score, conn_valid), each (B, 19, K) in
    pair-major acceptance order, and `overflow` (B,): a pair had more
    valid candidates than the max_conns window.
    """
    B, P, Ka, Kb = scores.shape
    K = Ka
    dev = scores.device
    flat = torch.where(valid, scores, -torch.inf).reshape(B, P, Ka * Kb)
    C = min(max_conns, Ka * Kb)
    overflow = (valid.reshape(B, P, -1).sum(-1) > C).any(-1)
    top_scores, top_idx = top_k_stable(flat, C)             # (B, 19, C)
    top_ia = torch.div(top_idx, Kb, rounding_mode="floor")
    top_ib = top_idx % Kb
    top_valid = torch.isfinite(top_scores)

    used_a = torch.zeros((B, P, K), dtype=torch.bool, device=dev)
    used_b = torch.zeros((B, P, K), dtype=torch.bool, device=dev)
    # valid candidates sort first, so no step past the longest valid run
    # of any (image, pair) can accept: one read-back of that length bounds
    # the loop, whose body never reads back
    n_steps = int(top_valid.sum(-1).max()) if top_valid.numel() else 0
    accepted = []
    for c in range(n_steps):
        ia = top_ia[..., c:c + 1]
        ib = top_ib[..., c:c + 1]
        ua = used_a.gather(-1, ia)
        ub = used_b.gather(-1, ib)
        ok = top_valid[..., c:c + 1] & ~ua & ~ub
        used_a.scatter_(-1, ia, ua | ok)
        used_b.scatter_(-1, ib, ub | ok)
        accepted.append(ok)
    accepted.append(torch.zeros((B, P, C - n_steps), dtype=torch.bool,
                                device=dev))
    acc = torch.cat(accepted, dim=-1)                        # (B, 19, C)
    # slot of an accepted candidate = number accepted before it; K = drop
    slots = torch.where(acc, acc.long().cumsum(-1) - 1, K)

    def place(values, fill, dtype):
        out = torch.full((B, P, K + 1), fill, dtype=dtype, device=dev)
        out.scatter_(-1, slots, torch.where(acc, values, fill).to(dtype))
        return out[..., :K]

    return (place(top_ia, 0, torch.int64), place(top_ib, 0, torch.int64),
            place(top_scores, 0.0, torch.float32),
            place(acc, False, torch.bool), overflow)


def assemble_people(conn_ia, conn_ib, conn_score, conn_valid, peaks: Peaks,
                    *, max_people: int = 64, min_part_cnt: int = 4,
                    min_human_score: float = 0.3, max_total_conns: int = 160,
                    extra_truncated=None) -> People:
    """Sequential person assembly (reference pafprocess.cpp:127-191).

    Consumes connections in (pair, acceptance-slot) order, one step per
    entry of the compacted list, for all images at once.  Each step is the
    JAX scan body (grouping.py:343-408) with its one-hot blends written as
    selects: the blends add exact zeros, so the values are the same.
    """
    B, P, K = conn_ia.shape
    Pp = max_people
    dev = conn_ia.device
    score_flat = peaks.score.reshape(B, -1)        # (B, 18*K)
    x_flat = peaks.x.reshape(B, -1)
    y_flat = peaks.y.reshape(B, -1)

    part_a = torch.as_tensor(PAIR_A, device=dev)
    part_b = torch.as_tensor(PAIR_B, device=dev)
    gid1 = part_a[:, None] * K + conn_ia           # (B, 19, K) 0-based ids
    gid2 = part_b[:, None] * K + conn_ib
    cid1 = (gid1 + 1).float()
    cid2 = (gid2 + 1).float()
    ps1 = score_flat.gather(1, gid1.reshape(B, -1))
    ps2 = score_flat.gather(1, gid2.reshape(B, -1))

    # compact the (19, K) connections into a length-M list, order kept
    M = min(max_total_conns, P * K)
    flat_valid = conn_valid.reshape(B, -1)
    conn_overflow = flat_valid.sum(-1) > M
    pos = flat_valid.long().cumsum(-1) - 1
    pos = torch.where(flat_valid & (pos < M), pos, M)

    def compact(x, fill):
        x = x.reshape(B, -1)
        out = torch.full((B, M + 1), fill, dtype=x.dtype, device=dev)
        return out.scatter_(1, pos, x)[:, :M]

    pair_of = torch.arange(P, device=dev).repeat_interleave(K).expand(B, -1)
    c_pair = compact(pair_of, NUM_GROUP_PAIRS)
    c_k1 = compact(cid1, 0.0)
    c_k2 = compact(cid2, 0.0)
    c_s12 = compact(ps1, 0.0) + compact(ps2, 0.0)   # s1p + s2p (new rows)
    c_ps2 = compact(ps2, 0.0)
    c_score = compact(conn_score, 0.0)
    c_valid = compact(flat_valid, False)
    pair_c = c_pair.clamp(max=NUM_GROUP_PAIRS - 1)
    c_p1 = part_a[pair_c]                           # (B, M)
    c_p2 = part_b[pair_c]
    c_seed = c_pair < NUM_SEED_PAIRS
    new_s18 = c_s12 + c_score                       # (s1p + s2p) + cscore
    ext_s18 = c_ps2 + c_score                       # s2p + cscore

    subset = torch.full((B, Pp, 20), -1.0, device=dev)
    subset[..., 19] = 0.0                            # count 0 == dead row
    next_slot = torch.zeros((B,), dtype=torch.int64, device=dev)
    dropped = torch.zeros((B,), dtype=torch.bool, device=dev)
    rows = torch.arange(Pp, device=dev)
    cols = torch.arange(20, device=dev)
    dead = torch.full((20,), -1.0, device=dev)
    dead[19] = 0.0
    body = cols < NUM_PARTS
    # entries past an image's valid connections change nothing: loop only
    # as far as the longest valid list of the batch (one read-back)
    n_steps = int(flat_valid.sum(-1).clamp(max=M).max()) if B else 0
    for m in range(n_steps):
        p1 = c_p1[:, m]
        p2 = c_p2[:, m]
        k1 = c_k1[:, m, None]
        k2 = c_k2[:, m, None]
        cvalid = c_valid[:, m]
        col1 = subset.gather(2, p1[:, None, None].expand(B, Pp, 1))[..., 0]
        col2 = subset.gather(2, p2[:, None, None].expand(B, Pp, 1))[..., 0]
        match = (subset[..., 19] > 0) & ((col1 == k1) | (col2 == k2))
        found = match.sum(1)
        # first / second matching row (0 when none, like jnp.argmax)
        first = torch.where(match, rows, Pp).amin(1)
        s1 = torch.where(first < Pp, first, 0)
        second = torch.where(match & (rows != s1[:, None]), rows, Pp).amin(1)
        s2 = torch.where(second < Pp, second, 0)
        r1 = subset.gather(1, s1[:, None, None].expand(B, 1, 20))[:, 0]
        r2 = subset.gather(1, s2[:, None, None].expand(B, 1, 20))[:, 0]
        membership = ((r1[:, :NUM_PARTS] > 0)
                      & (r2[:, :NUM_PARTS] > 0)).any(1)

        can_new = next_slot < Pp
        seed_miss = cvalid & (found == 0) & c_seed[:, m]
        b_new = seed_miss & can_new
        b_ext1 = cvalid & (found == 1)
        b_ext2 = cvalid & (found == 2) & membership
        b_merge = cvalid & (found == 2) & ~membership
        r1_p2 = r1.gather(1, p2[:, None])
        do_set = b_ext2 | (b_ext1 & (r1_p2[:, 0] != k2[:, 0]))

        is_p1 = cols == p1[:, None]                   # (B, 20)
        is_p2 = cols == p2[:, None]
        new_row = torch.where(is_p1, k1, torch.where(is_p2, k2, -1.0))
        new_row[:, 18] = new_s18[:, m]
        new_row[:, 19] = 2.0
        ext_row = torch.where(is_p2, k2, r1)
        ext_row[:, 18] = r1[:, 18] + ext_s18[:, m]
        ext_row[:, 19] = r1[:, 19] + 1.0
        merged = torch.where(body, r1 + (r2 + 1.0), r1)
        merged[:, 18] = r1[:, 18] + (r2[:, 18] + c_score[:, m])
        merged[:, 19] = r1[:, 19] + r2[:, 19]

        # new / extend / merge are exclusive (found == 0 vs >= 1): one
        # row write covers all three, then the merge kills row s2
        target = torch.where(b_new, next_slot.clamp(max=Pp - 1), s1)
        value = torch.where(b_new[:, None], new_row,
                            torch.where(do_set[:, None], ext_row, merged))
        write = (b_new | do_set | b_merge)[:, None] & \
            (rows == target[:, None])
        subset = torch.where(write[..., None], value[:, None, :], subset)
        kill = b_merge[:, None] & (rows == s2[:, None])
        subset = torch.where(kill[..., None], dead, subset)

        next_slot = next_slot + b_new.long()
        dropped = dropped | (seed_miss & ~can_new)

    count = subset[..., 19]
    ssum = subset[..., 18]
    per_part = ssum / count.clamp(min=1.0)
    person_valid = ((count >= min_part_cnt) & (per_part >= min_human_score)
                    & (count > 0))
    cids = subset[..., :NUM_PARTS].to(torch.int32)  # 1-based or -1
    has = cids > 0
    flat_cid = (cids.long() - 1).clamp(0, NUM_PARTS * K - 1).reshape(B, -1)
    xs = x_flat.gather(1, flat_cid).reshape(has.shape)
    ys = y_flat.gather(1, flat_cid).reshape(has.shape)
    coords = torch.stack([torch.where(has, xs, -1), torch.where(has, ys, -1)],
                         dim=-1).to(torch.int32)
    part_score = torch.where(
        has, score_flat.gather(1, flat_cid).reshape(has.shape), 0.0)
    truncated = peaks.truncated | conn_overflow | dropped
    if extra_truncated is not None:
        truncated = truncated | extra_truncated
    return People(coords=coords, part_score=part_score, score=per_part,
                  valid=person_valid, truncated=truncated)


def group_peaks_device(peaks: Peaks, paf: torch.Tensor, *, factor: int = 8,
                       thresh_vector_cnt: int = 6, max_people: int = 64,
                       min_part_cnt: int = 4, min_human_score: float = 0.3,
                       max_candidates: int = 256, max_total_conns: int = 160,
                       sampling: str = "auto") -> People:
    """peaks + (B, h, w, 38) low-res PAF -> fixed-shape people."""
    scores, valid = score_connections(peaks, paf, factor=factor,
                                      thresh_vector_cnt=thresh_vector_cnt,
                                      sampling=sampling)
    *conns, cand_overflow = greedy_connections(scores, valid,
                                               max_conns=max_candidates)
    return assemble_people(*conns, peaks, max_people=max_people,
                           min_part_cnt=min_part_cnt,
                           min_human_score=min_human_score,
                           max_total_conns=max_total_conns,
                           extra_truncated=cand_overflow)
