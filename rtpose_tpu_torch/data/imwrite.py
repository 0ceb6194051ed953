"""Write an image file as ``cv2.imwrite(path, img)`` does, without cv2.

The format follows the file's extension, as in cv2: ``.png`` and ``.bmp``
are lossless, ``.jpg`` / ``.jpeg`` are JPEG at cv2's defaults (quality
95, 4:2:0 chroma subsampling, baseline, not optimised).  Pillow encodes
JPEG with libjpeg-turbo, as cv2 does, but its default quality is 75, so
the settings are passed explicitly; tests/test_torch_frontends.py holds
the decoded pixels of :func:`write_bgr`'s files equal to those of
``cv2.imwrite``'s files of the same array.  :func:`encode_bgr` gives the
same bytes without a file (``cv2.imencode``), as the webcam demo's view
sends them.
"""

from __future__ import annotations

import io
import os
from typing import Optional

import numpy as np

# cv2's JPEG defaults, in Pillow's words (subsampling 2 is 4:2:0)
JPEG_OPTIONS = dict(quality=95, subsampling=2, optimize=False,
                    progressive=False)
# extension -> (Pillow format, save options)
_FORMATS = {".png": ("PNG", {}), ".bmp": ("BMP", {}),
            ".jpg": ("JPEG", JPEG_OPTIONS), ".jpeg": ("JPEG", JPEG_OPTIONS)}


def encode_bgr(img: np.ndarray, ext: str = ".jpg",
               quality: Optional[int] = None) -> bytes:
    """The bytes of `img`, ``(H, W, 3)`` uint8 BGR or ``(H, W)`` uint8
    gray, in the format of the file extension `ext` (``cv2.imencode``);
    `quality` is a JPEG's (``cv2.IMWRITE_JPEG_QUALITY``, default cv2's 95)
    and is refused for another format.  Raises ValueError for an
    extension without a writer or another array layout."""
    from PIL import Image

    ext = ext.lower()
    if ext not in _FORMATS:
        raise ValueError(f"no image writer for {ext!r} "
                         f"(known: {', '.join(sorted(_FORMATS))})")
    if img.dtype != np.uint8 or not (
            img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"writes (H, W, 3) BGR or (H, W) gray uint8 "
                         f"images, got {img.dtype} {img.shape}")
    pixels = img if img.ndim == 2 else img[..., ::-1]
    fmt, options = _FORMATS[ext]
    if quality is not None:
        if fmt != "JPEG":
            raise ValueError(f"a quality is a JPEG's, not {fmt}'s")
        options = {**options, "quality": int(quality)}
    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(pixels)).save(buf, fmt, **options)
    return buf.getvalue()


def write_bgr(path: str, img: np.ndarray,
              quality: Optional[int] = None) -> None:
    """Write `img` to `path` in the format of its extension: the bytes of
    :func:`encode_bgr`.  Raises ValueError, naming `path`, where
    :func:`encode_bgr` refuses the extension, the quality or the array."""
    try:
        data = encode_bgr(img, os.path.splitext(path)[1], quality)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    with open(path, "wb") as f:
        f.write(data)
