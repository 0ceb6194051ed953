"""Read an image file as ``cv2.imread(path, cv2.IMREAD_COLOR)`` does, and
decode image bytes as ``cv2.imdecode`` does, without cv2.

The JAX package's eval harness reads every frame with ``cv2.imread``
(``rtpose_tpu/evalx/harness.py`` ``_imread_checked``); the port reads with
Pillow, the decoder of the JAX package's training data path
(``rtpose_tpu/data/dataset.py``), and gives the same frame:

- ``(H, W, 3)`` uint8 in BGR order;
- the EXIF orientation applied (cv2 rotates a tagged JPEG; Pillow reads
  the stored pixels unless told to, so :func:`read_bgr` transposes);
- a grayscale image as three equal channels, an alpha channel dropped;
- ``FileNotFoundError`` for a missing file, ``IOError`` for one that
  cannot be decoded; :func:`decode_bgr` returns None for bytes that are
  not an image, as ``cv2.imdecode`` does (the HTTP service answers them
  with 400).

Pillow and cv2 both decode JPEG with libjpeg-turbo's default settings
(the accurate integer IDCT, fancy chroma upsampling), so their pixels are
equal: tests/test_torch_imread.py holds :func:`read_bgr` against
``cv2.imread`` pixel for pixel on 4:2:0, 4:4:4, grayscale, progressive and
EXIF-rotated JPEGs, and ``chip_smoke.py`` holds it on the card's machine
against cv2's pixels of the committed fixtures (``data/fixtures``).

The decode runs on the host and releases the GIL, so the eval harness's
read-ahead thread overlaps it with the card's work.  Without Pillow the
reader raises; there is no other route.
"""

from __future__ import annotations

import io
import os
from typing import Optional

import numpy as np


def _pillow():
    try:
        from PIL import Image, ImageOps
    except ImportError as e:
        raise ImportError(
            "rtpose_tpu_torch.data.imread reads images with Pillow (PIL), "
            "which is not installed") from e
    return Image, ImageOps


def _bgr(source) -> np.ndarray:
    """Pillow's decode of `source` (a path or a binary file) as ``(H, W,
    3)`` uint8 BGR, EXIF orientation applied; Pillow's errors for data it
    cannot identify or decode pass through."""
    Image, ImageOps = _pillow()
    with Image.open(source) as im:
        rgb = np.asarray(ImageOps.exif_transpose(im).convert("RGB"))
    return np.ascontiguousarray(rgb[..., ::-1])


_UNDECODABLE = (OSError, SyntaxError, ValueError)


def read_bgr(path: str) -> np.ndarray:
    """The image at `path` as ``(H, W, 3)`` uint8 BGR, EXIF orientation
    applied: ``cv2.imread(path, cv2.IMREAD_COLOR)``'s frame."""
    _pillow()
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    try:
        return _bgr(path)
    except _UNDECODABLE as e:
        raise IOError(f"could not decode image {path}") from e


def decode_bgr(data: bytes) -> Optional[np.ndarray]:
    """Encoded image bytes as ``(H, W, 3)`` uint8 BGR, EXIF orientation
    applied, or None where they are not an image:
    ``cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)``'s
    frame (cv2's ``imdecode`` applies the orientation as ``imread``
    does)."""
    try:
        return _bgr(io.BytesIO(data))
    except _UNDECODABLE:
        return None
