"""The port's decode (NMS + refine, scoring, greedy matching, assembly) vs
the JAX package's, on rendered scenes (tests/util_synth.py).

The JAX side runs its Pallas kernels in interpret mode (refine through
``nms(use_pallas=True)``, sampling ``'pallas_fused'``).  Held equal:
``Peaks.x/y/valid/truncated`` and ``People.coords/valid/truncated``;
float fields within atol 1e-5.  Also the self-test's CPU run
(``python -m rtpose_tpu_torch.selftest --device cpu``) and its exit code
on a failure.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rtpose_tpu.ops import decode as jdecode
from rtpose_tpu.ops import grouping as jgrouping
from rtpose_tpu.ops import peaks as jpeaks
from rtpose_tpu_torch.ops import decode, grouping, grouping_ref, kernels, peaks
from rtpose_tpu_torch.skeleton import GROUP_PAIRS

from util_synth import grid_people, render_maps, synth_example

ATOL = 1e-5
# caps from tests/test_truncation_retry.py: a crowded scene overflows
# TIGHT and fits RAISED
TIGHT = dict(max_peaks=16, max_candidates=64, max_total_conns=32,
             max_people=64)
RAISED = dict(max_peaks=16, max_candidates=512, max_total_conns=304,
              max_people=64)


def _assert_people_equal(got, want):
    for f in ("coords", "valid", "truncated"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    for f in ("score", "part_score"):
        np.testing.assert_allclose(np.asarray(getattr(got, f)),
                                   np.asarray(getattr(want, f)), atol=ATOL,
                                   err_msg=f)


def _jax_decode(heat, paf, sampling="pallas_fused", **caps):
    return jax.device_get(jdecode.decode_poses(
        jnp.asarray(heat), jnp.asarray(paf), sampling=sampling, **caps))


def _assert_lists_equal(got, want):
    """people_to_numpy lists: same people and parts, same coordinates,
    scores within ATOL."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a["parts"].keys() == b["parts"].keys()
        assert abs(a["score"] - b["score"]) <= ATOL
        for part, (x, y, sc) in a["parts"].items():
            assert (x, y) == b["parts"][part][:2]
            assert abs(sc - b["parts"][part][2]) <= ATOL


@pytest.mark.parametrize("seed,n_people", [(0, 1), (1, 3), (2, 5), (7, 4)])
def test_nms_matches_jax(seed, n_people):
    _, heat, _ = synth_example(seed=seed, n_people=n_people)
    want = jpeaks.nms(jnp.asarray(heat), use_pallas=True,
                      pallas_interpret=True)
    got = peaks.nms(torch.from_numpy(heat)[None])
    assert int(got.valid.sum()) > 10
    for f in ("x", "y", "valid", "truncated"):
        np.testing.assert_array_equal(getattr(got, f)[0].numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    for f in ("xf", "yf", "score"):
        np.testing.assert_allclose(getattr(got, f)[0].numpy(),
                                   np.asarray(getattr(want, f)), atol=ATOL,
                                   err_msg=f)


def test_nms_truncates_like_jax():
    rng = np.random.RandomState(3)
    heat, _ = render_maps(grid_people(3, 4, 46, 46, rng), 46, 46)
    for k in (8, 16):
        want = jpeaks.nms(jnp.asarray(heat), max_peaks=k)
        got = peaks.nms(torch.from_numpy(heat)[None], max_peaks=k)
        assert bool(got.truncated[0]) == bool(want.truncated) == (k == 8)
        np.testing.assert_array_equal(got.x[0].numpy(), np.asarray(want.x))


@pytest.mark.parametrize("seed,n_people", [(0, 1), (1, 3), (7, 4)])
def test_nms_gaussian_filt_matches_jax(seed, n_people):
    """The blurred refine (the reference's optional sigma=3 smoothing)
    against the JAX package's ``_refine_onehot`` path: integer
    coordinates equal, scores within 1e-5."""
    _, heat, _ = synth_example(seed=seed, n_people=n_people)
    want = jpeaks.nms(jnp.asarray(heat), gaussian_filt=True)
    got = peaks.nms(torch.from_numpy(heat)[None], gaussian_filt=True)
    plain = peaks.nms(torch.from_numpy(heat)[None])
    assert int(got.valid.sum()) > 10
    assert not torch.equal(got.score, plain.score)     # the blur acted
    for f in ("x", "y", "valid", "truncated"):
        np.testing.assert_array_equal(getattr(got, f)[0].numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    for f in ("xf", "yf", "score"):
        np.testing.assert_allclose(getattr(got, f)[0].numpy(),
                                   np.asarray(getattr(want, f)), atol=ATOL,
                                   rtol=0, err_msg=f)


@pytest.mark.parametrize("seed,H,W", [(0, 12, 12), (2, 7, 30)])
def test_refine_gaussian_filt_matches_onehot(seed, H, W):
    """Random maps and peaks at every border (clipped 3- and 4-wide
    windows, whose blur reflects at the true window edge); slots that
    hold no peak come back as zeros, as ``nms`` masks them."""
    rng = np.random.RandomState(seed)
    P, K = 18, 8
    heat = rng.rand(P, H, W).astype(np.float32)
    py = rng.randint(0, H, (P, K)).astype(np.int32)
    px = rng.randint(0, W, (P, K)).astype(np.int32)
    py[:, :4] = [0, H - 1, 1, H - 2]
    px[:, :4] = [0, W - 1, W - 2, 1]
    valid = rng.rand(P, K) < 0.75
    valid[:, :4] = True
    want = [np.where(valid, np.asarray(a), 0) for a in jpeaks._refine_onehot(
        jnp.asarray(heat), jnp.asarray(py), jnp.asarray(px), 8,
        gaussian_filt=True)]
    got = [a[0].numpy() for a in peaks.refine_peaks(
        torch.from_numpy(heat)[None], torch.from_numpy(py)[None],
        torch.from_numpy(px)[None], torch.from_numpy(valid)[None],
        gaussian_filt=True)]
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.astype(np.int32), w.astype(np.int32))
    np.testing.assert_allclose(got[2], want[2], atol=ATOL, rtol=0)
    assert (~valid).any() and not any(g[~valid].any() for g in got)


@pytest.mark.parametrize("seed,n_people", [(0, 1), (1, 3), (3, 5), (4, 6)])
def test_decode_poses_matches_jax(seed, n_people):
    _, heat, paf = synth_example(seed=seed, n_people=n_people)
    want = _jax_decode(heat, paf)
    got = decode.people_to_host(decode.decode_poses(
        torch.from_numpy(heat), torch.from_numpy(paf)))
    assert int(got.valid.sum()) == n_people
    _assert_people_equal(got, want)
    _assert_lists_equal(decode.people_to_numpy(got, 368, 368),
                        jdecode.people_to_numpy(want, 368, 368))


def test_decode_batch_matches_per_image_jax():
    scenes = [synth_example(seed=10 + i, n_people=1 + i)[1:]
              for i in range(3)]
    heat = torch.from_numpy(np.stack([h for h, _ in scenes]))
    paf = torch.from_numpy(np.stack([p for _, p in scenes]))
    got = decode.people_to_host(decode.decode_poses_batch(heat, paf))
    for i, (h, p) in enumerate(scenes):
        _assert_people_equal(decode.people_row(got, i), _jax_decode(h, p))


def test_crowded_scene_truncates_then_matches_at_raised_caps():
    """JAX decodes with 'gather' sampling here: it selects the same PAF
    cells as the Pallas kernels (held against them in
    tests/test_torch_kernels.py) and compiles in a tenth of the time."""
    rng = np.random.RandomState(0)
    people = grid_people(3, 4, 46, 46, rng)
    heat, paf = render_maps(people, 46, 46)
    paf = paf + rng.normal(0, 1e-4, paf.shape).astype(np.float32)
    h, p = torch.from_numpy(heat), torch.from_numpy(paf)
    tight = decode.people_to_host(decode.decode_poses(h, p, **TIGHT))
    want_tight = _jax_decode(heat, paf, "gather", **TIGHT)
    assert bool(tight.truncated) and bool(want_tight.truncated)
    _assert_people_equal(tight, want_tight)
    raised = decode.people_to_host(decode.decode_poses(h, p, **RAISED))
    assert not bool(raised.truncated)
    assert int(raised.valid.sum()) == len(people)
    _assert_people_equal(raised, _jax_decode(heat, paf, "gather", **RAISED))


def test_scoring_on_cell_boundaries_matches_eager_jax_and_oracle(
        monkeypatch):
    """Integer peaks whose PAF samples land exactly on x8 cell boundaries
    (``ax + s * (dx / 10) + 0.5`` an exact multiple of 8 in fp32, so the
    division's last bit picks the cell): the port's ``score_connections``
    equals eager JAX ``score_connections`` (``jax.disable_jit()``) bit for
    bit, validity and crit2, and the host oracle ``ops/grouping_ref.py``
    through the people it assembles from them (it keeps no per-candidate
    output): with its thresholds off, every row's peaks equal and scores
    within 1e-6 (the oracle sums them in fp64).

    Random integer peaks, K=32, a 46x62 N(0, 0.5^2) PAF, seed 1 (ROADMAP
    §3, F1).  Not asserted, the jitted-JAX gap: under ``jax.jit`` XLA
    divides by the literal 10 as a product with fl(0.1), so the jitted
    decode samples other cells: 444 of 194,560 sample cells differ, and
    27 of 19,456 crit2 values move by more than 1e-4 (ROADMAP §3, F1, on
    the CPU)."""
    K, H, W = 32, 46, 62
    rng = np.random.RandomState(1)
    paf = rng.normal(0, 0.5, (H, W, 38)).astype(np.float32)
    x = rng.randint(0, W * 8, (18, K)).astype(np.int32)
    y = rng.randint(0, H * 8, (18, K)).astype(np.int32)
    pscore = rng.uniform(0.1, 1.0, (18, K)).astype(np.float32)
    # the samples that sit on a cell boundary, in the fp32 of every side
    pa = [a for a, _ in GROUP_PAIRS]
    pb = [b for _, b in GROUP_PAIRS]
    on_edge = 0
    for c in (x, y):
        a = c[pa].astype(np.float32)[:, :, None]
        step = (c[pb].astype(np.float32)[:, None, :] - a) / np.float32(10)
        for s in range(10):
            at = a + np.float32(s) * step + np.float32(0.5)
            on_edge += int((at % 8 == 0).sum())
    assert on_edge > 1000

    valid = np.ones((18, K), bool)
    got_s, got_v = grouping.score_connections(
        peaks.Peaks(x=torch.from_numpy(x)[None], y=torch.from_numpy(y)[None],
                    xf=None, yf=None, score=torch.from_numpy(pscore)[None],
                    valid=torch.from_numpy(valid)[None], truncated=None),
        torch.from_numpy(paf)[None])
    jp = jpeaks.Peaks(x=jnp.asarray(x), y=jnp.asarray(y),
                      xf=jnp.zeros((18, K)), yf=jnp.zeros((18, K)),
                      score=jnp.asarray(pscore), valid=jnp.asarray(valid),
                      truncated=jnp.asarray(False))
    with jax.disable_jit():
        want_s, want_v = jax.device_get(jgrouping.score_connections(
            jp, jnp.asarray(paf), sampling="onehot"))
    np.testing.assert_array_equal(got_v[0].numpy(), want_v)
    np.testing.assert_array_equal(got_s[0].numpy().view(np.uint32),
                                  np.asarray(want_s).view(np.uint32))
    assert 1000 < int(want_v.sum()) < 19 * K * K

    monkeypatch.setattr(grouping_ref, "THRESH_PART_CNT", 0)
    monkeypatch.setattr(grouping_ref, "THRESH_HUMAN_SCORE", -np.inf)
    joints = np.array([(x[p, k], y[p, k], pscore[p, k], p * K + k, p)
                       for p in range(18) for k in range(K)], np.float64)
    res = grouping_ref.group_peaks(joints, (H * 8, W * 8),
                                   grouping_ref.upsample_nearest(paf, 8))
    coords, _, score, ok, truncated = (t[0].numpy() for t in
                                       kernels.group_people_plain(
        *grouping.sorted_candidates(got_s, got_v),
        *(torch.from_numpy(a)[None] for a in (x, y, pscore)),
        torch.zeros(1, dtype=torch.bool), max_candidates=K * K,
        max_people=256, max_total_conns=19 * K, min_part_cnt=0,
        min_human_score=-np.inf))
    assert not truncated and res.num_humans == int(ok.sum()) > 50
    want_xy = np.full((res.num_humans, 18, 2), -1)
    for i, row in enumerate(res.subset):
        for part in np.nonzero(row[:18] >= 0)[0]:
            want_xy[i, part] = (res.peak_x[int(row[part])],
                                res.peak_y[int(row[part])])
    np.testing.assert_array_equal(coords[ok], want_xy)
    np.testing.assert_allclose(score[ok], res.subset[:, 18]
                               / res.subset[:, 19], rtol=0, atol=1e-6)


def test_people_to_host_keeps_types():
    _, heat, paf = synth_example(seed=2, n_people=2)
    dev = decode.decode_poses_batch(torch.from_numpy(heat)[None],
                                    torch.from_numpy(paf)[None])
    host = decode.people_to_host(dev)
    assert host.coords.dtype == np.int32 and host.valid.dtype == bool
    assert host.truncated.shape == (1,)
    np.testing.assert_array_equal(host.coords, dev.coords.numpy())
    np.testing.assert_array_equal(host.score, dev.score.numpy())


def test_selftest_passes_on_the_cpu(capsys):
    """``python -m rtpose_tpu_torch.selftest --device cpu``: the decode
    against the host oracle, GT synthesis against its oracle and the flip
    algebra, through the kernels' plain versions."""
    from rtpose_tpu_torch import selftest
    with pytest.raises(SystemExit) as done:
        selftest.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert done.value.code == 0, out
    for line in ("decode parity over 6 scenes: OK",
                 "GT synthesis host/device equivalence: OK",
                 "flip-TTA algebra: OK"):
        assert line in out


def test_selftest_exits_1_when_the_decode_differs(monkeypatch, capsys):
    """A decode that moves one part by a pixel fails the parity check and
    the run."""
    from rtpose_tpu_torch import selftest
    from rtpose_tpu_torch.ops import decode as tdecode
    real = tdecode.people_to_numpy

    def shifted(people, w_up, h_up):
        out = real(people, w_up, h_up)
        if out:
            part, (x, y, s) = next(iter(out[0]["parts"].items()))
            out[0]["parts"][part] = (x + 1.0 / w_up, y, s)
        return out

    monkeypatch.setattr(tdecode, "people_to_numpy", shifted)
    with pytest.raises(SystemExit) as done:
        selftest.main(["--device", "cpu"])
    assert done.value.code == 1
    assert "decode parity over 6 scenes: FAIL" in capsys.readouterr().out
