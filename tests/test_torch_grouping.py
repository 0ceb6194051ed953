"""The port's greedy matching and person assembly vs the JAX package's.

``kernels.group_people_plain`` (the plain version of the grouping kernel:
the greedy loop, then the assembly loop) against JAX
``greedy_connections`` + ``assemble_people`` (rtpose_tpu/ops/grouping.py,
two ``lax.scan``s, vmapped over the batch), in fp32 on the same crafted
candidate sets (``utils/grouping_cases.py``) at the default caps and at
``RETRY_CAPS``.  Held equal: ``People.coords/valid/truncated``; scores
within 1e-5 (the same fp32 sums in the same order: 0 expected).  Each test
shows that its batch reached the branches it is there for.
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
                                                   candidate_batch)

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
