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
"""

from __future__ import annotations

from typing import Tuple

import torch

# limb_scalars and person_bound are parts of the kernel's plain version
# and live beside it; they are named here for the callers of this module
from ..ops.kernels import (LIMB_WIDTH, gt_maps, limb_scalars,  # noqa: F401
                           person_bound)


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
