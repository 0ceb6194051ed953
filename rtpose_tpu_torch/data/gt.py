"""Ground-truth heatmap / PAF synthesis for training (port of
rtpose_tpu/data/gt.py ``ground_truth_maps_batch`` through the Pallas path
of rtpose_tpu/ops/pallas_gt.py).

The per-person scalars are computed here in torch with the exact
expressions of ``gt_maps_pallas`` (pallas_gt.py:139-171): the person-loop
bound and, per limb, the start point, unit vector, validity and rounded
bounding box.  The per-cell work runs in the K4 kernel of
``ops/kernels.py`` (``csrc/gt_maps.cu``) for CUDA tensors and in its plain
version for CPU tensors.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops.kernels import gt_maps
from ..skeleton import LIMBS

LIMB_WIDTH = 1.0        # PAF half width in grid units (reference paf.py:22)
LIMB_A = np.array([l[0] for l in LIMBS])
LIMB_B = np.array([l[1] for l in LIMBS])


def person_bound(keypoints: torch.Tensor) -> torch.Tensor:
    """(B, N, 18, 3) -> (B,) int32: 1 + index of the last person with a
    visible part (0 for none), robust to invisible rows in the middle of
    the padding (pallas_gt.py:141-145)."""
    B, N = keypoints.shape[:2]
    dev = keypoints.device
    if N == 0:
        return torch.zeros(B, dtype=torch.int32, device=dev)
    any_v = (keypoints[..., 2] > 0.5).any(dim=-1)                 # (B, N)
    slots = torch.arange(1, N + 1, device=dev)
    return torch.where(any_v, slots, 0).amax(dim=-1).to(torch.int32)


def limb_scalars(keypoints: torch.Tensor, stride: int,
                 limb_width: float = LIMB_WIDTH) -> torch.Tensor:
    """(B, N, 18, 3) keypoints -> (B, N, 19, 9) limb scalars [ax, ay, ux,
    uy, valid, mnx, mxx, mny, mxy] in grid units (pallas_gt.py:152-171).

    ``torch.round`` rounds half to even, as ``jnp.round`` does.
    """
    kp = keypoints
    vis = kp[..., 2] > 0.5
    a = torch.as_tensor(LIMB_A, device=kp.device)
    b = torch.as_tensor(LIMB_B, device=kp.device)
    ax = kp[:, :, a, 0] / stride                                  # (B, N, 19)
    ay = kp[:, :, a, 1] / stride
    bx = kp[:, :, b, 0] / stride
    by = kp[:, :, b, 1] / stride
    both = vis[:, :, a] & vis[:, :, b]
    vx = bx - ax
    vy = by - ay
    # the correctly rounded root of jnp.sqrt and CUDA's sqrtf: torch's CPU
    # sqrt (MKL's vector library) is an ulp off for about 1 value in 200,
    # and an ulp in (ux, uy) can move a cell across the limb-width test
    norm = (vx * vx + vy * vy).double().sqrt().float()
    lv = (both & (norm > 0)).to(torch.float32)
    un = norm.clamp(min=1e-12)
    ux = vx / un
    uy = vy / un
    mnx = torch.round(torch.minimum(ax, bx) - limb_width)
    mxx = torch.round(torch.maximum(ax, bx) + limb_width)
    mny = torch.round(torch.minimum(ay, by) - limb_width)
    mxy = torch.round(torch.maximum(ay, by) + limb_width)
    return torch.stack([ax, ay, ux, uy, lv, mnx, mxx, mny, mxy],
                       dim=-1).contiguous()


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
    kp = keypoints.to(torch.float32).contiguous()
    return gt_maps(kp, limb_scalars(kp, stride, limb_width),
                   person_bound(kp), grid_y=input_y // stride,
                   grid_x=input_x // stride, stride=stride, sigma=sigma,
                   limb_width=limb_width)
