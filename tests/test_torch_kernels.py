"""The port's decode kernels vs the JAX package's Pallas kernels.

On the CPU each wrapper of rtpose_tpu_torch/ops/kernels.py runs its plain
PyTorch version; here that version is held against the Pallas kernel it
replaces, run in interpret mode as tests/test_pallas_kernels.py runs it:

- PAF line-integral sampling vs ``score_connections`` with
  ``sampling='pallas_fused'`` (K=32) and ``'pallas'`` (K=64): candidate
  validity equal, criterion scores within atol 1e-5 (the accumulation-order
  class that rtpose_tpu/ops/grouping.py:83-89 accepts between backends);
- bicubic refine vs ``_refine_pallas``: integer x, y equal, xf / yf /
  score within atol 1e-5.

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
from rtpose_tpu_torch.ops.grouping import candidate_geometry, score_connections
from rtpose_tpu_torch.ops.peaks import Peaks, refine_peaks

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
    geo, _, ok = candidate_geometry(_torch_peaks(jp))
    cnt, ssum = kernels.paf_sample_scores(torch.from_numpy(paf)[None], geo)
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


@pytest.mark.parametrize("seed,H,W", [(0, 12, 12), (1, 46, 46), (2, 7, 30)])
def test_refine_matches_pallas(seed, H, W):
    rng = np.random.RandomState(seed)
    P, K = 18, 8
    heat = rng.rand(P, H, W).astype(np.float32)
    py = rng.randint(0, H, (P, K)).astype(np.int32)
    px = rng.randint(0, W, (P, K)).astype(np.int32)
    py[:, :4] = [0, H - 1, 0, H - 1]      # clipped windows at every border
    px[:, :4] = [0, 0, W - 1, W - 1]
    want = [np.asarray(a) for a in jpeaks._refine_pallas(
        jnp.asarray(heat), jnp.asarray(py), jnp.asarray(px), 8,
        interpret=True)]
    got = [a[0].numpy() for a in refine_peaks(
        torch.from_numpy(heat)[None], torch.from_numpy(py)[None],
        torch.from_numpy(px)[None])]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.astype(np.int32), w.astype(np.int32))


def test_refine_ties_go_to_lowest_flat_index():
    """An all-zero window: every upsampled cell ties (at +0 or -0), so the
    first row-major cell wins, as numpy's argmax on the valid region."""
    heat = torch.zeros((1, 18, 10, 10))
    py = torch.full((1, 18, 1), 5, dtype=torch.int32)
    my, mx, score = kernels.bicubic_refine(heat, py, py)
    assert int(my.abs().max()) == 0 and int(mx.abs().max()) == 0
    assert float(score.abs().max()) == 0.0


def test_wrappers_reject_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.paf_sample_scores(torch.zeros((1, 4, 4, 38), device="meta"),
                                  torch.zeros((1, 19, 6, 4), device="meta"))
