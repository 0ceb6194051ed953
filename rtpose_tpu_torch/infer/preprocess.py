"""Resize geometry and on-device pixel normalization (port of
rtpose_tpu/infer/preprocess.py:29-49, 152-171).

:func:`scale_pad_geometry` and the ImageNet constants are copies of the
JAX package's numpy helpers, so the port imports nothing of that package.
"""

from __future__ import annotations

from typing import Tuple

import torch

_VGG_MEAN = (0.485, 0.456, 0.406)
_VGG_STD = (0.229, 0.224, 0.225)
_SSD_MEAN = (104.0, 117.0, 123.0)


def scale_pad_geometry(h: int, w: int, dest_size: int, factor: int = 8
                       ) -> Tuple[float, int, int, int, int]:
    """The reference crop_with_factor's shape arithmetic: (scale,
    resized_h, resized_w, padded_h, padded_w) for a frame whose short side
    is scaled to `dest_size` and then zero-padded to multiples of `factor`
    (cv2's dsize rounds half to even, like python's round)."""
    scale = float(dest_size) / min(h, w)
    rh, rw = int(round(h * scale)), int(round(w * scale))
    return scale, rh, rw, rh + (-rh % factor), rw + (-rw % factor)


def normalize_device(images_u8: torch.Tensor, mode: str) -> torch.Tensor:
    """uint8 (or raw-valued float) BGR ``(..., H, W, 3)`` frames -> fp32
    network input, on the frames' device.  Modes as the reference's
    preprocessing.py: 'rtpose', 'vgg', 'inception', 'ssd', or
    'none'/None for the raw values."""
    x = images_u8.float()
    dev = x.device
    if mode == "rtpose":
        return x / 256.0 - 0.5
    if mode == "vgg":
        rgb = x.flip(-1) / 255.0
        return ((rgb - torch.tensor(_VGG_MEAN, device=dev))
                / torch.tensor(_VGG_STD, device=dev))
    if mode == "inception":
        return x.flip(-1) / 128.0 - 1.0
    if mode == "ssd":
        rgb = x.flip(-1) - torch.tensor(_SSD_MEAN, device=dev)
        return rgb.flip(-1)
    if mode in (None, "none"):
        return x
    raise ValueError(f"unknown normalization mode {mode}")
