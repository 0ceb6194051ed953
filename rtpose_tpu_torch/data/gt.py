"""Ground-truth heatmap / PAF synthesis for training (port of
rtpose_tpu/data/gt.py ``ground_truth_maps_batch`` through the Pallas path
of rtpose_tpu/ops/pallas_gt.py).

For CUDA tensors the whole synthesis is the K4 kernel of
``ops/kernels.py`` (``csrc/gt_maps.cu``): keypoints in, maps out, one
launch.  For CPU tensors it is the kernel's plain version, whose
per-person scalars are computed in torch with the exact expressions of
``gt_maps_pallas`` (pallas_gt.py:139-171): the person-loop bound
(``person_bound``) and, per limb, the start point, unit vector, validity
and rounded bounding box (``limb_scalars``).

The host oracle the self-test holds the kernel against,
:func:`put_gaussian_map`, :func:`put_vec_map` and
:func:`ground_truth_maps` (the reference's exact sequential numpy
semantics), is a copy of rtpose_tpu/data/gt.py:34-130;
tests/test_torch_isolation.py holds it equal to the original.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# limb_scalars and person_bound are parts of the kernel's plain version
# and live beside it; they are named here for the callers of this module
from ..ops.kernels import (LIMB_WIDTH, LN100, gt_maps,  # noqa: F401
                           limb_scalars, person_bound)
from ..skeleton import LIMBS, NUM_HEATMAPS, NUM_PAF_CHANNELS, NUM_PARTS


def ground_truth_maps_batch(keypoints: torch.Tensor, *, input_y: int = 368,
                            input_x: int = 368, stride: int = 8,
                            sigma: float = 7.0,
                            limb_width: float = LIMB_WIDTH
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, N, 18, 3) keypoints -> heat (B, gy, gx, 19) and PAF
    (B, gy, gx, 38), fp32, on the keypoints' device.

    Parts with v > 0.5 get a Gaussian (support exp(-d2/2s^2) >= 1/100,
    clipped at 1), limbs with both ends visible a unit-vector field
    averaged over overlaps, and channel 18 is the background
    1 - max(parts) (reference datasets.py:259-308).
    """
    return gt_maps(keypoints.to(torch.float32).contiguous(),
                   grid_y=input_y // stride, grid_x=input_x // stride,
                   stride=stride, sigma=sigma, limb_width=limb_width)


# ---------------------------------------------------------------------------
# numpy host implementation (reference-exact), the self-test's oracle
# ---------------------------------------------------------------------------

def put_gaussian_map(center, accum: np.ndarray, sigma: float,
                     grid_y: int, grid_x: int, stride: int) -> np.ndarray:
    """Add one keypoint gaussian, clamping at 1 (reference heatmap.py:20-36).

    Grid sample i sits at pixel i*stride + stride/2 - 0.5.
    """
    start = stride / 2.0 - 0.5
    xx, yy = np.meshgrid(np.arange(grid_x), np.arange(grid_y))
    xx = xx * stride + start
    yy = yy * stride + start
    d2 = (xx - center[0]) ** 2 + (yy - center[1]) ** 2
    exponent = d2 / 2.0 / sigma / sigma
    g = np.where(exponent <= LN100, np.exp(-exponent), 0.0)
    out = accum + g
    return np.minimum(out, 1.0)


def put_vec_map(center_a, center_b, accum: np.ndarray, count: np.ndarray,
                grid_y: int, grid_x: int, stride: int,
                limb_width: float = LIMB_WIDTH
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Add one limb's unit-vector field with running average over overlaps
    (reference paf.py:18-68; limb_width 1.289 in the hourglass trainer,
    reference train/train_SH.py:77)."""
    a = np.asarray(center_a, float) / stride
    b = np.asarray(center_b, float) / stride
    vec = b - a
    norm = np.linalg.norm(vec)
    if norm == 0.0:
        return accum, count
    u = vec / norm

    min_x = max(int(round(min(a[0], b[0]) - limb_width)), 0)
    max_x = min(int(round(max(a[0], b[0]) + limb_width)), grid_x)
    min_y = max(int(round(min(a[1], b[1]) - limb_width)), 0)
    max_y = min(int(round(max(a[1], b[1]) + limb_width)), grid_y)
    if min_x >= max_x or min_y >= max_y:
        return accum, count

    xs = np.arange(min_x, max_x)
    ys = np.arange(min_y, max_y)
    xx, yy = np.meshgrid(xs, ys)
    ba_x = xx - a[0]
    ba_y = yy - a[1]
    dist = np.abs(ba_x * u[1] - ba_y * u[0])
    mask = dist < limb_width

    vec_map = np.zeros_like(accum)
    vec_map[yy[mask], xx[mask], 0] = u[0]
    vec_map[yy[mask], xx[mask], 1] = u[1]
    covered = (np.abs(vec_map[:, :, 0]) > 0) | (np.abs(vec_map[:, :, 1]) > 0)

    accum = accum * count[:, :, None]
    accum = accum + vec_map
    count = count + covered
    divisor = np.maximum(count, 1)
    accum = accum / divisor[:, :, None]
    return accum, count


def ground_truth_maps(keypoints: np.ndarray, *, input_y: int = 368,
                      input_x: int = 368, stride: int = 8,
                      sigma: float = 7.0, limb_width: float = LIMB_WIDTH
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """(N, 18, 3) keypoints -> heatmaps (gy, gx, 19) + pafs (gy, gx, 38).

    Reference lib/datasets/datasets.py:259-308: parts with v > 0.5 get a
    gaussian; limbs with both ends v > 0.5 get a PAF; background channel is
    1 - max(parts).
    """
    gy, gx = input_y // stride, input_x // stride
    heat = np.zeros((gy, gx, NUM_HEATMAPS))
    paf = np.zeros((gy, gx, NUM_PAF_CHANNELS))
    keypoints = np.asarray(keypoints, float)

    for part in range(NUM_PARTS):
        for person in keypoints:
            if person[part, 2] > 0.5:
                heat[:, :, part] = put_gaussian_map(
                    person[part, :2], heat[:, :, part], sigma, gy, gx,
                    stride)
    for li, (a, b) in enumerate(LIMBS):
        count = np.zeros((gy, gx), dtype=np.uint32)
        for person in keypoints:
            if person[a, 2] > 0.5 and person[b, 2] > 0.5:
                paf[:, :, 2 * li:2 * li + 2], count = put_vec_map(
                    person[a, :2], person[b, :2],
                    paf[:, :, 2 * li:2 * li + 2], count, gy, gx, stride,
                    limb_width)
    heat[:, :, NUM_PARTS] = np.maximum(
        1.0 - heat[:, :, :NUM_PARTS].max(axis=2), 0.0)
    return heat, paf
