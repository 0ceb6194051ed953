"""The port's ground-truth synthesis vs the JAX package's.

On the CPU ``data.gt.ground_truth_maps_batch`` runs K4's plain version
(``ops.kernels.gt_maps_plain``); here it is held against the Pallas
kernel it replaces, ``gt_maps_pallas`` in interpret mode (atol 1e-6, the
bound tests/test_gt.py holds that kernel to), and against the host oracle
``gt.ground_truth_maps`` (atol 2e-6).  The cases are those of
tests/test_gt.py:109-155: 0, 3 and 8 people, an all-invisible person in
the middle of the padding, and a non-square 28x40 grid; and a 7x9 grid, whose cell
count no tile or vector divides, with persons outside it and an empty
image.  The CUDA kernel takes the keypoints alone and computes the person
bound and the limb scalars itself; its plain version is ``gt_maps_plain``
on ``limb_scalars`` and ``person_bound``, which is what the wrapper runs
on the CPU.  The kernel is held against the plain version on the card by
tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rtpose_tpu.data import gt as jgt
from rtpose_tpu.ops.pallas_gt import gt_maps_pallas
from rtpose_tpu.skeleton import LIMBS
from rtpose_tpu_torch.data import gt
from rtpose_tpu_torch.ops import kernels

PALLAS_ATOL = 1e-6
HOST_ATOL = 2e-6


def _keypoints(seed, n_people, batch=2, slots=16, h=368, w=368):
    rng = np.random.RandomState(seed)
    kps = np.zeros((batch, slots, 18, 3), np.float32)
    for b in range(batch):
        for p in range(n_people):
            kps[b, p, :, 0] = rng.uniform(0, w - 1, 18)
            kps[b, p, :, 1] = rng.uniform(0, h - 1, 18)
            kps[b, p, :, 2] = rng.choice([0, 2], 18, p=[.3, .7])
    if n_people >= 3:
        kps[0, 1] = 0.0      # all-invisible person inside the padding
    return kps


def _port(kps, **kw):
    heat, paf = gt.ground_truth_maps_batch(torch.from_numpy(kps), **kw)
    return heat.numpy(), paf.numpy()


@pytest.mark.parametrize("seed,n_people", [(0, 0), (1, 3), (2, 8)])
def test_gt_matches_pallas_and_host_oracle(seed, n_people):
    kps = _keypoints(seed, n_people)
    heat, paf = _port(kps)
    assert heat.shape == (2, 46, 46, 19) and paf.shape == (2, 46, 46, 38)
    heat_p, paf_p = gt_maps_pallas(kps, grid_y=46, grid_x=46, stride=8,
                                   sigma=7.0, interpret=True)
    np.testing.assert_allclose(heat, np.asarray(heat_p), atol=PALLAS_ATOL,
                               rtol=0)
    np.testing.assert_allclose(paf, np.asarray(paf_p), atol=PALLAS_ATOL,
                               rtol=0)
    for b in range(2):
        heat_h, paf_h = jgt.ground_truth_maps(kps[b])
        np.testing.assert_allclose(heat[b], heat_h, atol=HOST_ATOL, rtol=0)
        np.testing.assert_allclose(paf[b], paf_h, atol=HOST_ATOL, rtol=0)


def test_gt_nonsquare_grid():
    kps = _keypoints(7, 1, batch=1, slots=4, h=200, w=300)
    kps[0, 0, :, 2] = 2.0
    heat, paf = _port(kps, input_y=224, input_x=320)
    assert heat.shape == (1, 28, 40, 19) and paf.shape == (1, 28, 40, 38)
    heat_p, paf_p = gt_maps_pallas(kps, grid_y=28, grid_x=40, stride=8,
                                   sigma=7.0, interpret=True)
    np.testing.assert_allclose(heat, np.asarray(heat_p), atol=PALLAS_ATOL,
                               rtol=0)
    np.testing.assert_allclose(paf, np.asarray(paf_p), atol=PALLAS_ATOL,
                               rtol=0)
    heat_h, paf_h = jgt.ground_truth_maps(kps[0], input_y=224, input_x=320)
    np.testing.assert_allclose(heat[0], heat_h, atol=HOST_ATOL, rtol=0)
    np.testing.assert_allclose(paf[0], paf_h, atol=HOST_ATOL, rtol=0)


def test_gt_unaligned_grid_with_persons_outside_and_an_empty_image():
    """A 7x9 grid (63 cells: no multiple of a warp, a tile or a 16-byte
    vector), persons partly and wholly outside the grid, an image with no
    person: against the Pallas kernel and the host oracle."""
    rng = np.random.RandomState(11)
    kps = np.zeros((3, 6, 18, 3), np.float32)
    for p, (lo, hi) in enumerate([(-0.3, 1.3), (1.2, 2.5), (-2.0, -0.1),
                                  (0.0, 1.0)]):
        kps[0, p, :, 0] = rng.uniform(lo, hi, 18) * 72
        kps[0, p, :, 1] = rng.uniform(lo, hi, 18) * 56
        kps[0, p, :, 2] = rng.choice([0, 2], 18, p=[.2, .8])
    kps[2, 5, :, :2] = rng.uniform(0, 55, (18, 2))   # the last slot only
    kps[2, 5, :, 2] = 2
    heat, paf = _port(kps, input_y=56, input_x=72)
    assert heat.shape == (3, 7, 9, 19) and paf.shape == (3, 7, 9, 38)
    assert heat[0, ..., :18].max() > 0.5 and np.abs(paf[0]).max() > 0.5
    assert not heat[1, ..., :18].any() and not paf[1].any()
    assert (heat[1, ..., 18] == 1.0).all()
    heat_p, paf_p = gt_maps_pallas(kps, grid_y=7, grid_x=9, stride=8,
                                   sigma=7.0, interpret=True)
    np.testing.assert_allclose(heat, np.asarray(heat_p), atol=PALLAS_ATOL,
                               rtol=0)
    np.testing.assert_allclose(paf, np.asarray(paf_p), atol=PALLAS_ATOL,
                               rtol=0)
    for b in range(3):
        heat_h, paf_h = jgt.ground_truth_maps(kps[b], input_y=56, input_x=72)
        np.testing.assert_allclose(heat[b], heat_h, atol=HOST_ATOL, rtol=0)
        np.testing.assert_allclose(paf[b], paf_h, atol=HOST_ATOL, rtol=0)


def test_gt_maps_takes_keypoints_alone():
    """The wrapper on CPU tensors is the plain version on the torch
    precompute, bit for bit, whatever limb width and stride."""
    kps = torch.from_numpy(_keypoints(5, 4, slots=5))
    for kw in (dict(grid_y=46, grid_x=46, stride=8, sigma=7.0),
               dict(grid_y=23, grid_x=31, stride=12, sigma=5.0,
                    limb_width=1.5)):
        got = kernels.gt_maps(kps, **kw)
        want = kernels.gt_maps_plain(
            kps, gt.limb_scalars(kps, kw["stride"],
                                 kw.get("limb_width", 1.0)),
            gt.person_bound(kps), **kw)
        assert float(got[1].abs().max()) > 0.5
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_limb_scalars_equal_the_pallas_precompute():
    """The (ax, ay, ux, uy, valid, box) rows are the expressions of
    pallas_gt.py:152-171, to the bit; the box rounds half to even."""
    kps = _keypoints(3, 5)
    kps[1, 0, 1, :2] = kps[1, 0, 2, :2]          # a zero-length limb
    kps[1, 1, :, :2] = 8.0 * np.arange(18)[:, None] + 4.0 - 1.0  # .5 boxes
    kps[1, 1, :, 2] = 2
    got = gt.limb_scalars(torch.from_numpy(kps), 8).numpy()
    kp = jnp.asarray(kps)
    a = np.array([l[0] for l in LIMBS])
    b = np.array([l[1] for l in LIMBS])
    ax, ay = kp[:, :, a, 0] / 8, kp[:, :, a, 1] / 8
    bx, by = kp[:, :, b, 0] / 8, kp[:, :, b, 1] / 8
    vis = kp[..., 2] > 0.5
    vx, vy = bx - ax, by - ay
    norm = jnp.sqrt(vx * vx + vy * vy)
    un = jnp.maximum(norm, 1e-12)
    want = np.stack([np.asarray(v) for v in (
        ax, ay, vx / un, vy / un,
        (vis[:, :, a] & vis[:, :, b] & (norm > 0)).astype(jnp.float32),
        jnp.round(jnp.minimum(ax, bx) - 1.0),
        jnp.round(jnp.maximum(ax, bx) + 1.0),
        jnp.round(jnp.minimum(ay, by) - 1.0),
        jnp.round(jnp.maximum(ay, by) + 1.0))], axis=-1)
    np.testing.assert_array_equal(got, want)
    assert got[1, 0, 0, 4] == 0.0                 # zero length: not valid


def test_person_bound_skips_trailing_padding_only():
    kps = np.zeros((3, 6, 18, 3), np.float32)
    kps[0, [0, 2, 3], 5, 2] = 2          # row 1 invisible in the middle
    kps[2, 5, 0, 2] = 1                  # only the last slot
    got = gt.person_bound(torch.from_numpy(kps)).tolist()
    assert got == [4, 0, 6]


def test_plain_version_follows_the_kernel_at_the_cutoff():
    """K4 multiplies d2 by 1/(2 sigma^2) (pallas_gt.py:62,82) where the
    XLA scan divides by 2 sigma^2 (gt.py:167).  At sigma 3 the squared
    distance 82.8936 from this keypoint to cell (0, 0) lands just over
    ln 100 by the multiply and just under it by the division: K4 adds no
    term there, the scan ~0.01.  The plain version takes K4's side."""
    kps = np.zeros((1, 1, 18, 3), np.float32)
    kps[0, 0, 0] = (12.604592323303223, 3.5, 2.0)
    heat, _ = _port(kps, input_y=64, input_x=64, sigma=3.0)
    heat_p, _ = gt_maps_pallas(kps, grid_y=8, grid_x=8, stride=8, sigma=3.0,
                               interpret=True)
    assert heat[0, 0, 0, 0] == 0.0 and float(heat_p[0, 0, 0, 0]) == 0.0
    assert heat[0, 0, 1, 0] > 0.5
    np.testing.assert_allclose(heat, np.asarray(heat_p), atol=PALLAS_ATOL,
                               rtol=0)


def test_gt_maps_wrapper_checks_its_inputs():
    kps = torch.zeros((1, 2, 18, 3))
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.gt_maps(kps.to("meta"), grid_y=4, grid_x=4, stride=8,
                        sigma=7.0)
