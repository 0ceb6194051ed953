"""The port's greedy matching and person assembly vs the JAX package's.

``kernels.group_people_plain`` (the plain version of the grouping kernel:
the greedy loop, then the assembly loop) against JAX
``greedy_connections`` + ``assemble_people`` (rtpose_tpu/ops/grouping.py,
two ``lax.scan``s, vmapped over the batch), in fp32 on the same crafted
candidate sets (``utils/grouping_cases.py``) at the default caps and at
``RETRY_CAPS``.  Held equal: ``People.coords/valid/truncated``; scores
within 1e-5 (the same fp32 sums in the same order: 0 expected).  Each test
shows that its batch reached the branches it is there for.

The grouping kernel itself runs only on the card.  Its assembly algorithm
(a flat (pair, slot) walk with precomputed operands, a row mask per peak
id in place of the row scan, a part mask per row for the membership test)
is replayed here by a numpy model of ``csrc/group_people.cu``, checked
step by step against the row scan and at the end against JAX.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rtpose_tpu.ops import grouping as jgrouping
from rtpose_tpu.ops.peaks import Peaks as JaxPeaks
from rtpose_tpu_torch.ops import grouping, kernels
from rtpose_tpu_torch.ops.peaks import Peaks
from rtpose_tpu_torch.utils.grouping_cases import (BRANCHES, branch_hits,
                                                   candidate_batch,
                                                   merge_chain_batch)

ATOL = 1e-5
CAPS = {"default": dict(K=32, max_candidates=256, max_people=64,
                        max_total_conns=160),
        "retry": dict(K=64, max_candidates=1024, max_people=128,
                      max_total_conns=608)}
FIELDS = ("coords", "part_score", "score", "valid", "truncated")


@functools.lru_cache(maxsize=None)
def _jax_grouping(max_candidates, max_people, max_total_conns):
    def one(scores, valid, x, y, score, truncated):
        *conns, over = jgrouping.greedy_connections(scores, valid,
                                                    max_conns=max_candidates)
        zeros = jnp.zeros(x.shape, jnp.float32)
        peaks = JaxPeaks(x=x, y=y, xf=zeros, yf=zeros, score=score,
                         valid=x >= 0, truncated=truncated)
        return jgrouping.assemble_people(
            *conns, peaks, max_people=max_people,
            max_total_conns=max_total_conns, extra_truncated=over)
    return jax.jit(jax.vmap(one))


def _assert_people_equal(got, want):
    for f in ("coords", "valid", "truncated"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    for f in ("score", "part_score"):
        np.testing.assert_allclose(np.asarray(getattr(got, f)),
                                   np.asarray(getattr(want, f)), atol=ATOL,
                                   rtol=0, err_msg=f)


@pytest.mark.parametrize("caps", ["default", "retry"])
def test_group_people_plain_matches_jax(caps):
    caps = dict(CAPS[caps])
    K = caps.pop("K")
    batch = candidate_batch(0, 8, K)
    scores, valid, x, y, pscore, truncated = (torch.from_numpy(a)
                                              for a in batch)
    sorted_ = grouping.sorted_candidates(scores, valid)
    got = grouping.People(*kernels.group_people_plain(
        *sorted_, x, y, pscore, truncated, **caps))
    want = jax.device_get(_jax_grouping(**caps)(*batch))
    _assert_people_equal(got, want)
    # the thin public pieces give the same People
    *conns, over = grouping.greedy_connections(scores, valid,
                                               caps["max_candidates"])
    peaks = Peaks(x=x, y=y, xf=None, yf=None, score=pscore, valid=None,
                  truncated=truncated)
    _assert_people_equal(grouping.assemble_people(
        *conns, peaks, max_people=caps["max_people"],
        max_total_conns=caps["max_total_conns"], extra_truncated=over), want)
    # every branch but found >= 3 fired (greedy 1-1 matching of 1-based
    # ids cannot make three rows match: see test_assemble_found3plus...)
    hits = branch_hits(conns[0].numpy(), conns[1].numpy(),
                       conns[3].numpy(), scores=batch[0], valid=batch[1],
                       **caps)
    assert all(hits[b] > 0 for b in BRANCHES if b != "found3plus"), hits
    assert want.truncated.any() and not want.truncated.all()


def _crafted_connections(K=4):
    """One image's connection lists, not one-to-one, so that a connection
    matches three rows: pair 2 (parts 2-3) makes rows R1 and R2 and a
    two-row extension puts relbow e0 into row R0 as well as R1; pair 3
    (parts 3-4) first extends R2 with rwrist w0, then (e0, w0) matches R0,
    R1 and R2 and is dropped."""
    ia = np.zeros((1, 19, K), np.int64)
    ib = np.zeros((1, 19, K), np.int64)
    ok = np.zeros((1, 19, K), bool)
    conns = {0: [(0, 0)],                     # R0 = {neck n0, rshoulder s0}
             1: [(0, 0)],                     # R0 += lshoulder
             2: [(1, 0), (2, 0), (3, 1),      # R1 new, set already, R2 new
                 (0, 0)],                     # R0 and R1: two-row extend
             3: [(1, 0), (0, 0)]}             # R2 += w0; then found 3
    for pair, items in conns.items():
        for s, (a, b) in enumerate(items):
            ia[0, pair, s], ib[0, pair, s], ok[0, pair, s] = a, b, True
    score = np.where(ok, 0.5, 0.0).astype(np.float32)
    return ia, ib, score, ok


def test_assemble_found3plus_matches_jax():
    K = 4
    ia, ib, score, ok = _crafted_connections(K)
    rng = np.random.RandomState(0)
    x = rng.randint(0, 100, (1, 18, K)).astype(np.int32)
    y = rng.randint(0, 100, (1, 18, K)).astype(np.int32)
    pscore = rng.uniform(0.1, 1, (1, 18, K)).astype(np.float32)
    hits = branch_hits(ia, ib, ok, max_people=8, max_total_conns=19 * K)
    assert hits["found3plus"] == 1 and hits["extend_two_rows"] == 1
    assert hits["extend_set_already"] == 1
    peaks = Peaks(x=torch.from_numpy(x), y=torch.from_numpy(y), xf=None,
                  yf=None, score=torch.from_numpy(pscore), valid=None,
                  truncated=torch.zeros(1, dtype=torch.bool))
    got = grouping.assemble_people(*(torch.from_numpy(a)
                                     for a in (ia, ib, score, ok)),
                                   peaks, max_people=8, min_part_cnt=1,
                                   max_total_conns=19 * K)
    zeros = jnp.zeros((18, K), jnp.float32)
    want = jax.device_get(jgrouping.assemble_people(
        *(jnp.asarray(a[0]) for a in (ia.astype(np.int32),
                                      ib.astype(np.int32), score, ok)),
        JaxPeaks(x=jnp.asarray(x[0]), y=jnp.asarray(y[0]), xf=zeros,
                 yf=zeros, score=jnp.asarray(pscore[0]),
                 valid=jnp.ones((18, K), bool),
                 truncated=jnp.asarray(False)),
        max_people=8, min_part_cnt=1, max_total_conns=19 * K))
    _assert_people_equal(grouping.People(*(getattr(got, f)[0]
                                           for f in FIELDS)), want)
    assert int(want.valid.sum()) == 3


def test_wrapper_takes_the_plain_version_on_cpu():
    batch = candidate_batch(1, 3, 8)
    scores, valid, x, y, pscore, truncated = (torch.from_numpy(a)
                                              for a in batch)
    sorted_ = grouping.sorted_candidates(scores, valid)
    caps = dict(max_candidates=40, max_people=6, max_total_conns=50)
    before = kernels.group_people.launches
    got = kernels.group_people(*sorted_, x, y, pscore, truncated, **caps)
    want = kernels.group_people_plain(*sorted_, x, y, pscore, truncated,
                                      **caps)
    assert kernels.group_people.launches == before
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert got[0].shape == (3, 6, 18, 2) and got[4].shape == (3,)


# ---------------------------------------------------------------------------
# numpy model of the kernel's assembly (csrc/group_people.cu)
# ---------------------------------------------------------------------------

F32 = np.float32


def _mask_assembly(ia, ib, cscore, ok, pscore, *, max_people,
                   max_total_conns, check=True):
    """One image's assembly as the kernel runs it, from its accepted
    connections ((19, K) each, in acceptance order, `ok` a prefix of every
    pair's row) and peak scores (18, K).  Returns (subset (Pp, 20) fp32,
    connection overflow, people overflow, steps).

    The walk: an exclusive prefix over the 19 counts, cut at M, with each
    step's operands and row-free sums computed first.  The rows: a row
    mask per peak id, (18K, ceil(Pp/64)) uint64 words, updated by XOR as
    the kernel's atomics do, and an 18-bit part mask per row.  With
    `check`, after every step each id's mask must equal the set of rows
    holding id + 1, and before it `found` and s1 must equal the row
    scan's, s2 too where found <= 2 (with three or more matches the step
    writes nothing, so s2 is read by nothing; the kernel leaves it 0)."""
    from rtpose_tpu_torch.skeleton import GROUP_PAIRS, NUM_SEED_PAIRS
    P, K = ia.shape
    Pp = max_people
    W = (Pp + 63) // 64
    M = min(max_total_conns, P * K)
    n_acc = ok.sum(1)
    assert all(ok[p, :n].all() for p, n in enumerate(n_acc))
    offset = np.cumsum(n_acc) - n_acc
    ops = []
    for p in range(P):
        p1, p2 = GROUP_PAIRS[p]
        for e in range(n_acc[p]):
            if offset[p] + e < M:
                g1, g2 = p1 * K + ia[p, e], p2 * K + ib[p, e]
                s1p, s2p, cs = pscore.reshape(-1)[[g1, g2]].tolist() + \
                    [cscore[p, e]]
                ops.append((int(g1), int(g2), p1, p2, p < NUM_SEED_PAIRS,
                            F32(cs), F32(F32(F32(s1p) + F32(s2p)) + F32(cs)),
                            F32(F32(s2p) + F32(cs))))
    rowmask = np.zeros((18 * K, W), np.uint64)
    subset = np.full((Pp, 20), -1.0, F32)
    subset[:, 19] = 0.0
    part_mask = np.zeros(Pp, np.int64)
    next_slot, dropped = 0, False

    def flip(pid, row):
        rowmask[pid, row // 64] ^= np.uint64(1 << (row % 64))

    for g1, g2, p1, p2, seed, cs, new18, ext18 in ops:
        k1, k2 = F32(g1 + 1), F32(g2 + 1)
        words = [int(rowmask[g1, w] | rowmask[g2, w]) for w in range(W)]
        found = sum(bin(w).count("1") for w in words)
        bits = [64 * w + i for w in range(W) for i in range(64)
                if words[w] >> i & 1]
        s1 = bits[0] if bits else 0
        s2 = bits[-1] if found == 2 else 0
        if check:
            match = (subset[:, 19] > 0) & ((subset[:, p1] == k1)
                                           | (subset[:, p2] == k2))
            rows = np.nonzero(match)[0]
            assert found == len(rows)
            assert s1 == (rows[0] if len(rows) else 0)
            if found <= 2:
                assert s2 == (rows[1] if len(rows) > 1 else 0)
        r1, r2 = subset[s1].copy(), subset[s2].copy()
        membership = bool(part_mask[s1] & part_mask[s2])
        can_new = next_slot < Pp
        if found == 0 and seed and can_new:
            row = np.full(20, -1.0, F32)
            row[p1], row[p2], row[18], row[19] = k1, k2, new18, 2.0
            subset[next_slot] = row
            flip(g1, next_slot)
            flip(g2, next_slot)
            part_mask[next_slot] = (1 << p1) | (1 << p2)
        elif (found == 1 and r1[p2] != k2) or (found == 2 and membership):
            subset[s1, p2] = k2
            subset[s1, 18] = F32(r1[18] + ext18)
            subset[s1, 19] = F32(r1[19] + F32(1.0))
            if r1[p2] != k2:
                if r1[p2] > 0:
                    flip(int(r1[p2]) - 1, s1)
                flip(g2, s1)
                part_mask[s1] |= 1 << p2
        elif found == 2:                                   # merge
            subset[s1, :18] = r1[:18] + (r2[:18] + F32(1.0))
            subset[s1, 18] = F32(r1[18] + F32(r2[18] + cs))
            subset[s1, 19] = F32(r1[19] + r2[19])
            subset[s2] = -1.0
            subset[s2, 19] = 0.0
            for c in np.nonzero(r2[:18] > 0)[0]:
                flip(int(r2[c]) - 1, s2)
                flip(int(r2[c]) - 1, s1)
            part_mask[s1] |= part_mask[s2]
            part_mask[s2] = 0
        next_slot += found == 0 and seed and can_new
        dropped |= found == 0 and seed and not can_new
        if check:
            want = np.zeros((18 * K, Pp), bool)
            r, c = np.nonzero(subset[:, :18] > 0)
            want[subset[r, c].astype(np.int64) - 1, r] = True
            got = np.unpackbits(rowmask.view(np.uint8), axis=1,
                                bitorder="little")[:, :Pp].astype(bool)
            assert np.array_equal(got, want)
            held = np.array([sum(1 << int(c) for c in np.nonzero(row > 0)[0])
                             for row in subset[:, :18]])
            assert np.array_equal(part_mask, held)
    return subset, int(n_acc.sum()) > M, dropped, len(ops)


def _mask_people(conns, x, y, pscore, truncated, *, max_people,
                 max_total_conns, min_part_cnt=4, min_human_score=0.3):
    """People fields of the numpy model over a batch: conns = (ia, ib,
    score, ok), each (B, 19, K), numpy."""
    out = {f: [] for f in FIELDS}
    steps = []
    for b in range(x.shape[0]):
        subset, conn_over, dropped, n = _mask_assembly(
            *(c[b] for c in conns), pscore[b], max_people=max_people,
            max_total_conns=max_total_conns)
        steps.append(n)
        count, ssum = subset[:, 19], subset[:, 18]
        per_part = (ssum / np.maximum(count, F32(1.0))).astype(F32)
        cid = subset[:, :18].astype(np.int32)
        has = cid > 0
        at = np.clip(cid - 1, 0, x[b].size - 1)
        out["coords"].append(np.stack(
            [np.where(has, x[b].reshape(-1)[at], -1),
             np.where(has, y[b].reshape(-1)[at], -1)], -1).astype(np.int32))
        out["part_score"].append(np.where(has, pscore[b].reshape(-1)[at],
                                          F32(0.0)))
        out["score"].append(per_part)
        out["valid"].append((count >= min_part_cnt)
                            & (per_part >= min_human_score) & (count > 0))
        out["truncated"].append(bool(truncated[b]) or conn_over or dropped)
    return grouping.People(**{f: np.stack(v) for f, v in out.items()}), steps


@pytest.mark.parametrize("case", ["crafted-default", "crafted-retry",
                                  "merge-chain", "found3plus"])
def test_row_mask_assembly_model_matches_jax(case):
    """The kernel's assembly, as the numpy model above, on the crafted
    candidate batches at both caps and on the batch whose last pair reads
    ids a merge moved (through the port's greedy matching), and on the
    connection list whose last entry matches three rows: every step's
    masks and matches agree with the row scan, and the People with
    JAX's."""
    if case == "found3plus":
        K = 4
        conns = _crafted_connections(K)
        rng = np.random.RandomState(0)
        x = rng.randint(0, 100, (1, 18, K)).astype(np.int32)
        y = rng.randint(0, 100, (1, 18, K)).astype(np.int32)
        pscore = rng.uniform(0.1, 1, (1, 18, K)).astype(np.float32)
        caps = dict(max_people=8, max_total_conns=19 * K, min_part_cnt=1)
        got, steps = _mask_people((conns[0], conns[1], conns[2], conns[3]),
                                  x, y, pscore, np.zeros(1, bool), **caps)
        zeros = jnp.zeros((18, K), jnp.float32)
        want = jax.device_get(jgrouping.assemble_people(
            *(jnp.asarray(a[0]) for a in (conns[0].astype(np.int32),
                                          conns[1].astype(np.int32),
                                          conns[2], conns[3])),
            JaxPeaks(x=jnp.asarray(x[0]), y=jnp.asarray(y[0]), xf=zeros,
                     yf=zeros, score=jnp.asarray(pscore[0]),
                     valid=jnp.ones((18, K), bool),
                     truncated=jnp.asarray(False)), **caps))
        want = grouping.People(*(np.asarray(getattr(want, f))[None]
                                 for f in FIELDS))
        assert steps == [int(conns[3].sum())]
    else:
        caps = dict(CAPS["default" if case == "merge-chain"
                         else case.split("-")[1]])
        K = caps.pop("K")
        batch = (merge_chain_batch() if case == "merge-chain"
                 else candidate_batch(0, 8, K))
        scores, valid, x, y, pscore, truncated = batch
        *conns, over = grouping.greedy_connections(
            torch.from_numpy(scores), torch.from_numpy(valid),
            caps["max_candidates"])
        got, steps = _mask_people(
            [c.numpy() for c in conns], x, y, pscore,
            truncated | over.numpy(), max_people=caps["max_people"],
            max_total_conns=caps["max_total_conns"])
        want = jax.device_get(_jax_grouping(**caps)(*batch))
        if case == "merge-chain":
            hits = branch_hits(*(c.numpy() for c in (conns[0], conns[1],
                                                     conns[3])), **caps)
            assert steps == [8, 8] and hits["merge"] == 3 \
                and hits["extend_set_already"] == 1, hits
            assert want.valid.sum(1).tolist() == [1, 1]
            _assert_people_equal(grouping.People(*kernels.group_people_plain(
                *grouping.sorted_candidates(*(torch.from_numpy(a)
                                              for a in batch[:2])),
                *(torch.from_numpy(a) for a in batch[2:]), **caps)), want)
        else:
            assert max(steps) == caps["max_total_conns"] and min(steps) > 0
    _assert_people_equal(got, want)
