"""Resize geometry, the host resize and on-device pixel normalization
(port of rtpose_tpu/infer/preprocess.py:29-66, 152-171).

:func:`factor_closest`, :func:`scale_pad_geometry`,
:func:`crop_with_factor` and the ImageNet constants are copies of the JAX
package's numpy helpers, so the port imports nothing of that package;
``crop_with_factor`` resizes with ``data/cv2exact.py`` ``resize_linear``,
which equals the original's ``cv2.resize`` to the bit.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

from ..data.cv2exact import resize_linear

IMAGENET_MEAN = (0.485, 0.456, 0.406)   # RGB, as the training loader's
IMAGENET_STD = (0.229, 0.224, 0.225)
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


def factor_closest(num: float, factor: int, is_ceil: bool = True) -> int:
    fn = math.ceil if is_ceil else math.floor
    return int(fn(float(num) / factor)) * factor


def crop_with_factor(im: np.ndarray, dest_size: int, factor: int = 8,
                     is_ceil: bool = True
                     ) -> Tuple[np.ndarray, float, Tuple[int, int, int]]:
    """Scale shortest side to dest_size and zero-pad to factor multiples.

    Returns (padded image, scale, real (unpadded) shape).
    """
    im_scale = float(dest_size) / np.min(im.shape[0:2])
    im = resize_linear(im, im_scale)
    h, w, c = im.shape
    new_h = factor_closest(h, factor, is_ceil)
    new_w = factor_closest(w, factor, is_ceil)
    im_padded = np.zeros((new_h, new_w, c), dtype=im.dtype)
    im_padded[0:h, 0:w, :] = im
    return im_padded, im_scale, im.shape


@functools.lru_cache(maxsize=None)
def constants_on(device: torch.device, values) -> torch.Tensor:
    """A constant on `device` (a vector, or 0-d from a float), copied there
    once (a copy per call would make the host wait for it)."""
    return torch.tensor(values, device=device)


def normalize_device(images_u8: torch.Tensor, mode: str) -> torch.Tensor:
    """uint8 (or raw-valued float) BGR ``(..., H, W, 3)`` frames -> fp32
    network input, on the frames' device.  Modes as the reference's
    preprocessing.py: 'rtpose', 'vgg', 'inception', 'ssd', or
    'none'/None for the raw values.  Every divisor is a tensor on the
    frames' device: CUDA turns a division by a Python number into a
    product with its reciprocal, which rounds some values an ulp away from
    the CPU's (and the JAX package's host numpy) division."""
    x = images_u8.float()
    dev = x.device
    if mode == "rtpose":
        return x / constants_on(dev, 256.0) - 0.5
    if mode == "vgg":
        rgb = x.flip(-1) / constants_on(dev, 255.0)
        return ((rgb - constants_on(dev, IMAGENET_MEAN))
                / constants_on(dev, IMAGENET_STD))
    if mode == "inception":
        return x.flip(-1) / constants_on(dev, 128.0) - 1.0
    if mode == "ssd":
        rgb = x.flip(-1) - constants_on(dev, _SSD_MEAN)
        return rgb.flip(-1)
    if mode in (None, "none"):
        return x
    raise ValueError(f"unknown normalization mode {mode}")
