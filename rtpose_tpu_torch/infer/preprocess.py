"""Resize geometry, the host resize, the host and on-device pixel
normalizations and their inverses (port of rtpose_tpu/infer/preprocess.py).

:func:`factor_closest`, :func:`scale_pad_geometry`,
:func:`crop_with_factor`, :func:`letterbox`, :func:`pad_to_bucket`, the
four host normalizations, :func:`preprocess`, the four inverses,
:func:`inverse_preprocess` and the ImageNet constants are copies of the
JAX package's numpy helpers, so the port imports nothing of that
package; ``crop_with_factor`` and ``letterbox`` resize with
``data/cv2exact.py`` ``resize_linear`` / ``resize_linear_to``, which
equal the original's ``cv2.resize`` to the bit.  Images are BGR uint8
(cv2 convention) on input, like the reference.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

from ..data.cv2exact import resize_linear, resize_linear_to

IMAGENET_MEAN = (0.485, 0.456, 0.406)   # RGB, as the training loader's
IMAGENET_STD = (0.229, 0.224, 0.225)
_SSD_MEAN = (104.0, 117.0, 123.0)
_VGG_MEAN = np.array(IMAGENET_MEAN, dtype=np.float32)
_VGG_STD = np.array(IMAGENET_STD, dtype=np.float32)


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


def letterbox(im: np.ndarray, target: int
              ) -> Tuple[np.ndarray, float, Tuple[int, int]]:
    """Aspect-preserving resize into a target square with gray padding
    (the reference's unused `resize` helper, im_transform.py:5-24).

    Returns (square image, scale, (dx, dy) top-left offset of content).
    """
    h, w = im.shape[:2]
    scale = target / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    resized = resize_linear_to(im, nw, nh)
    out = np.full((target, target) + im.shape[2:], 128, dtype=im.dtype)
    dy = (target - nh) // 2
    dx = (target - nw) // 2
    out[dy:dy + nh, dx:dx + nw] = resized
    return out, scale, (dx, dy)


def pad_to_bucket(im: np.ndarray, bucket_multiple: int = 64
                  ) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Zero-pad H/W up to the next multiple of `bucket_multiple`.

    Coarser than the model stride so a run sees a small set of shapes
    across an eval instead of one shape per aspect ratio.
    """
    h, w = im.shape[:2]
    bh = factor_closest(h, bucket_multiple)
    bw = factor_closest(w, bucket_multiple)
    out = np.zeros((bh, bw) + im.shape[2:], dtype=im.dtype)
    out[:h, :w] = im
    return out, (h, w)


# --- host pixel normalization modes (HWC float32 out) ---------------------

def rtpose_preprocess(image: np.ndarray) -> np.ndarray:
    """x/256 - 0.5, stays BGR (for caffe-converted weights).

    Reference lib/datasets/preprocessing.py:16-21 (minus the CHW transpose).
    """
    return image.astype(np.float32) / 256.0 - 0.5


def vgg_preprocess(image: np.ndarray) -> np.ndarray:
    """BGR->RGB, /255, ImageNet mean/std (for weights trained in-repo).

    Reference lib/datasets/preprocessing.py:32-43.
    """
    rgb = image[:, :, ::-1].astype(np.float32) / 255.0
    return (rgb - _VGG_MEAN) / _VGG_STD


def inception_preprocess(image: np.ndarray) -> np.ndarray:
    """BGR->RGB, x/128 - 1. Reference preprocessing.py:46-52."""
    return image[:, :, ::-1].astype(np.float32) / 128.0 - 1.0


def ssd_preprocess(image: np.ndarray) -> np.ndarray:
    """Mean-subtract (104,117,123) channel-flip dance.

    Reference preprocessing.py:77-86: BGR->RGB, subtract (104,117,123),
    then flip back to BGR order.
    """
    rgb = image[:, :, ::-1].astype(np.float32)
    rgb -= np.array([104.0, 117.0, 123.0], dtype=np.float32)
    return rgb[:, :, ::-1]


_MODES = {
    "rtpose": rtpose_preprocess,
    "vgg": vgg_preprocess,
    "inception": inception_preprocess,
    "ssd": ssd_preprocess,
}


def preprocess(image: np.ndarray, mode: str) -> np.ndarray:
    """Dispatch by mode name (reference preprocessing.py:89-98)."""
    if mode not in _MODES:
        return image
    return _MODES[mode](image)


def inverse_vgg_preprocess(image_hwc: np.ndarray) -> np.ndarray:
    rgb = image_hwc * _VGG_STD + _VGG_MEAN
    return (rgb[:, :, ::-1] * 255.0)


def inverse_rtpose_preprocess(image_hwc: np.ndarray) -> np.ndarray:
    return ((image_hwc + 0.5) * 256.0).astype(np.uint8)


def inverse_inception_preprocess(image_hwc: np.ndarray) -> np.ndarray:
    """(x + 1) * 128, RGB->BGR, uint8 (reference preprocessing.py:67-75)."""
    img = (image_hwc.astype(np.float32) + 1.0) * 128.0
    return img[:, :, ::-1].astype(np.uint8)


def inverse_ssd_preprocess(image_hwc: np.ndarray) -> np.ndarray:
    """Exact inverse of ssd_preprocess (the reference has no ssd inverse;
    added to complete the mode table)."""
    rgb = image_hwc[:, :, ::-1].astype(np.float32)
    rgb = rgb + np.array([104.0, 117.0, 123.0], dtype=np.float32)
    return rgb[:, :, ::-1]


_INVERSES = {
    "rtpose": inverse_rtpose_preprocess,
    "vgg": inverse_vgg_preprocess,
    "inception": inverse_inception_preprocess,
    "ssd": inverse_ssd_preprocess,
}


def inverse_preprocess(image_hwc: np.ndarray, mode: str) -> np.ndarray:
    """Dispatch the inverse of :func:`preprocess` by mode name."""
    if mode not in _INVERSES:
        raise ValueError(f"unknown normalization mode {mode}")
    return _INVERSES[mode](image_hwc)


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
