"""The port's decode kernels vs the JAX package's Pallas kernels.

On the CPU each wrapper of rtpose_tpu_torch/ops/kernels.py runs its plain
PyTorch version; here that version is held against the Pallas kernel it
replaces, run in interpret mode as tests/test_pallas_kernels.py runs it:

- PAF line-integral sampling vs ``score_connections`` with
  ``sampling='pallas_fused'`` (K=32) and ``'pallas'`` (K=64): candidate
  validity equal, criterion scores within atol 1e-5 (the accumulation-order
  class that rtpose_tpu/ops/grouping.py:83-89 accepts between backends);
- bicubic refine vs ``_refine_pallas`` and the mask of ``nms``: integer
  x, y equal, xf / yf / score within atol 1e-5, zeros on invalid slots.

The scoring kernel fuses the candidate geometry, the line integral and
the criterion; its plain version is their composition, held here bit for
bit against the three parts and against JAX's rounding of each value.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rtpose_tpu.ops import grouping as jgrouping
from rtpose_tpu.ops import peaks as jpeaks
from rtpose_tpu_torch.ops import kernels
from rtpose_tpu_torch.ops.grouping import score_connections
from rtpose_tpu_torch.ops.kernels import candidate_geometry, criterion
from rtpose_tpu_torch.ops.peaks import Peaks

from util_synth import grid_people, render_maps, synth_example

ATOL = 1e-5


def _torch_peaks(jp) -> Peaks:
    """JAX Peaks of one image -> the port's Peaks with a batch axis."""
    return Peaks(*(torch.from_numpy(np.array(getattr(jp, f)))[None]
                   for f in ("x", "y", "xf", "yf", "score", "valid",
                             "truncated")))


def _scene(kind, seed):
    if kind == "grid":
        rng = np.random.RandomState(seed)
        heat, paf = render_maps(grid_people(3, 4, 46, 46, rng), 46, 46)
        return heat, paf + rng.normal(0, 1e-4, paf.shape).astype(np.float32)
    _, heat, paf = synth_example(seed=seed, n_people=1 + seed % 5)
    return heat, paf


@pytest.mark.parametrize("K,sampling,kind,seed", [
    (32, "pallas_fused", "synth", 0), (32, "pallas_fused", "synth", 5),
    (32, "pallas_fused", "grid", 1), (64, "pallas", "grid", 2),
])
def test_paf_sampling_matches_pallas(K, sampling, kind, seed):
    heat, paf = _scene(kind, seed)
    jp = jpeaks.nms(jnp.asarray(heat), max_peaks=K)
    want_s, want_v = (np.asarray(a) for a in jgrouping.score_connections(
        jp, jnp.asarray(paf), sampling=sampling))
    got_s, got_v = score_connections(_torch_peaks(jp),
                                     torch.from_numpy(paf)[None],
                                     sampling=sampling)
    assert got_s.shape == (1, 19, K, K)
    assert want_v.sum() > 10
    np.testing.assert_array_equal(got_v[0].numpy(), want_v)
    np.testing.assert_allclose(got_s[0].numpy(), want_s, atol=ATOL)


def test_paf_sampling_counts_match_reference_loop():
    """cnt / ssum of a few candidates against the reference's C++ loop
    (pafprocess.cpp:220-238) written out in numpy float32."""
    heat, paf = _scene("synth", 3)
    jp = jpeaks.nms(jnp.asarray(heat))
    tp = _torch_peaks(jp)
    geo, _, ok = candidate_geometry(tp.x, tp.y, tp.valid)
    cnt, ssum = kernels.paf_sample_scores_plain(torch.from_numpy(paf)[None],
                                                geo)
    f32 = np.float32
    chx, chy = kernels.PAIR_CHX, kernels.PAIR_CHY
    picks = np.argwhere(ok[0].reshape(19, -1).numpy())[::7][:40]
    assert len(picks) > 10
    g = geo[0].numpy()
    for p, c in picks:
        ax, ay, sx, sy, ux, uy = g[p, :, c]
        n, acc = 0, f32(0)
        for s in range(10):
            lx = int(f32(f32(ax + f32(s) * sx) + f32(0.5)))
            ly = int(f32(f32(ay + f32(s) * sy) + f32(0.5)))
            gx = min(max(lx // 8, 0), 45)
            gy = min(max(ly // 8, 0), 45)
            sc = f32(ux * paf[gy, gx, chx[p]]) + f32(uy * paf[gy, gx, chy[p]])
            n += sc > 0.05
            acc = f32(acc + sc)
        assert int(cnt[0, p, c]) == n
        assert float(ssum[0, p, c]) == float(acc)


@pytest.mark.parametrize("K", [8, 32, 64])
def test_connection_scores_plain_is_the_composition(K):
    """The wrapper's CPU route (the plain version) equals candidate
    geometry -> PAF line integral -> criterion bit for bit."""
    heat, paf = _scene("grid", K)
    tp = _torch_peaks(jpeaks.nms(jnp.asarray(heat), max_peaks=K))
    pafb = torch.from_numpy(paf)[None]
    got_s, got_v = kernels.connection_scores(pafb, tp.x, tp.y, tp.valid,
                                             thresh_vector_cnt=5)
    geo, norm, ok = candidate_geometry(tp.x, tp.y, tp.valid)
    cnt, ssum = kernels.paf_sample_scores_plain(pafb, geo)
    want_s, want_v = criterion(cnt, ssum, norm, ok, h_up=46 * 8,
                               thresh_vector_cnt=5)
    assert got_s.shape == got_v.shape == (1, 19, K, K)
    assert int(got_v.sum()) > 10
    assert torch.equal(got_s, want_s) and torch.equal(got_v, want_v)


def test_candidate_geometry_and_criterion_round_as_jax():
    """Every quotient and root rounded once, in JAX's order: the limb
    length is the correctly rounded root, the unit vector and the step
    true fp32 divisions, the penalty 184 / norm divided, not multiplied by
    a reciprocal (numpy float32 does each correctly rounded)."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randint(0, 368, (2, 18, 16)).astype(np.int32))
    y = torch.from_numpy(rng.randint(0, 368, (2, 18, 16)).astype(np.int32))
    valid = torch.ones((2, 18, 16), dtype=torch.bool)
    geo, norm, ok = candidate_geometry(x, y, valid)
    f32 = np.float32
    pa, pb = kernels.PAIR_A, kernels.PAIR_B
    ax, ay = x.numpy()[:, pa].astype(f32), y.numpy()[:, pa].astype(f32)
    dx = x.numpy()[:, pb, None, :].astype(f32) - ax[..., None]
    dy = y.numpy()[:, pb, None, :].astype(f32) - ay[..., None]
    want_norm = np.sqrt(dx * dx + dy * dy)
    safe = np.maximum(want_norm, f32(1e-12))
    np.testing.assert_array_equal(norm.numpy(), want_norm)
    g = geo.numpy().reshape(2, 19, 6, 16, 16)
    np.testing.assert_array_equal(g[:, :, 2], dx / f32(10))
    np.testing.assert_array_equal(g[:, :, 5],
                                  np.where(want_norm > 0, dy / safe, 0))
    ssum = torch.from_numpy(rng.rand(2, 19, 256).astype(f32))
    cnt = torch.full((2, 19, 256), 9, dtype=torch.int32)
    crit2, _ = criterion(cnt, ssum, norm, ok, h_up=368)
    want = (ssum.numpy().reshape(norm.shape) / f32(10)
            + np.minimum(f32(0), f32(184) / safe - f32(1)))
    np.testing.assert_array_equal(crit2.numpy(), want)


@pytest.mark.parametrize("seed,H,W", [(0, 12, 12), (1, 46, 46), (2, 7, 30)])
def test_refine_matches_pallas(seed, H, W):
    """The refine with its epilogue and mask vs ``_refine_pallas`` masked
    as ``nms`` masks it: equal where a slot holds a peak, zeros where not,
    at every border."""
    rng = np.random.RandomState(seed)
    P, K = 18, 8
    heat = rng.rand(P, H, W).astype(np.float32)
    py = rng.randint(0, H, (P, K)).astype(np.int32)
    px = rng.randint(0, W, (P, K)).astype(np.int32)
    py[:, :4] = [0, H - 1, 0, H - 1]      # clipped windows at every border
    px[:, :4] = [0, 0, W - 1, W - 1]
    valid = rng.rand(P, K) < 0.75
    valid[:, :4] = True
    want = [np.where(valid, np.asarray(a), 0) for a in jpeaks._refine_pallas(
        jnp.asarray(heat), jnp.asarray(py), jnp.asarray(px), 8,
        interpret=True)]
    got = [a[0].numpy() for a in kernels.bicubic_refine(
        torch.from_numpy(heat)[None], torch.from_numpy(py)[None],
        torch.from_numpy(px)[None], torch.from_numpy(valid)[None])]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.astype(np.int32), w.astype(np.int32))
    assert (~valid).any()
    for g in got:
        assert not g[~valid].any()


def test_refine_ties_go_to_lowest_flat_index():
    """An all-zero window: every upsampled cell ties (at +0 or -0), so the
    first row-major cell wins, as numpy's argmax on the valid region: the
    refined peak is the window's top-left corner, (5 - 2) * 8 = 24."""
    heat = torch.zeros((1, 18, 10, 10))
    py = torch.full((1, 18, 1), 5, dtype=torch.int32)
    valid = torch.ones((1, 18, 1), dtype=torch.bool)
    xf, yf, score = kernels.bicubic_refine(heat, py, py, valid)
    assert torch.equal(xf, torch.full_like(xf, 24.0))
    assert torch.equal(yf, torch.full_like(yf, 24.0))
    assert float(score.abs().max()) == 0.0


@pytest.mark.parametrize("factor", [4, 8])
def test_blur_matrices_are_banded(factor):
    """What the blurred kernel relies on when it sums over the band only:
    every blur matrix is zero where |row - col| exceeds the radius (the
    reflection folds back inside the band) and outside its extent, and
    the radius is the JAX package's int(4 * 3 + 0.5)."""
    mats = kernels.blur_matrices(factor)
    n = kernels.PATCH * factor
    assert mats.shape == (3, n, n) and kernels.BLUR_RADIUS == 12
    np.testing.assert_array_equal(mats, jpeaks._blur_matrices(factor))
    row, col = np.mgrid[0:n, 0:n]
    assert not mats[:, np.abs(row - col) > kernels.BLUR_RADIUS].any()
    for p, extent in enumerate((3, 4, 5)):
        size = extent * factor
        assert not mats[p, size:].any() and not mats[p, :, size:].any()
        np.testing.assert_allclose(mats[p, :size].sum(axis=1), 1.0,
                                   atol=1e-6)
        reach = min(kernels.BLUR_RADIUS, size - 1)
        assert mats[p, 0, reach] > 0 and mats[p, size - 1, size - 1 - reach] > 0


@pytest.mark.parametrize("seed,H,W", [(0, 12, 12), (2, 7, 30)])
def test_refine_gaussian_filt_matches_jax(seed, H, W):
    """The blurred refine's plain version (dense sums) vs the JAX package's
    blurred ``_refine_onehot`` masked as ``nms`` masks it, at every
    border: integer coordinates equal, scores within 1e-5."""
    rng = np.random.RandomState(seed)
    P, K = 18, 8
    heat = rng.rand(P, H, W).astype(np.float32)
    py = rng.randint(0, H, (P, K)).astype(np.int32)
    px = rng.randint(0, W, (P, K)).astype(np.int32)
    py[:, :4] = [0, H - 1, 0, H - 1]
    px[:, :4] = [0, 0, W - 1, W - 1]
    valid = rng.rand(P, K) < 0.75
    valid[:, :4] = True
    want = [np.where(valid, np.asarray(a), 0) for a in jpeaks._refine_onehot(
        jnp.asarray(heat), jnp.asarray(py), jnp.asarray(px), 8,
        gaussian_filt=True)]
    got = [a[0].numpy() for a in kernels.bicubic_refine(
        torch.from_numpy(heat)[None], torch.from_numpy(py)[None],
        torch.from_numpy(px)[None], torch.from_numpy(valid)[None],
        gaussian_filt=True)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.astype(np.int32), w.astype(np.int32))


def test_wrappers_reject_other_devices():
    peaks = torch.zeros((1, 18, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.connection_scores(torch.zeros((1, 4, 4, 38), device="meta"),
                                  peaks, peaks, peaks.bool())
