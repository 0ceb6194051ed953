"""Two cv2 image ops on uint8 frames, reproduced without cv2 to the bit.

- :func:`resize_linear` is ``cv2.resize(im, None, fx=s, fy=s)``
  (INTER_LINEAR) of a uint8 (H, W, C) frame: the host resize of the JAX
  package's ``crop_with_factor`` (``infer/preprocess.py``);
  :func:`resize_linear_to` is ``cv2.resize(im, (w, h))``, a scale of
  its own on each axis (``letterbox``, the scene renderer's background).
- :func:`warp_affine_cubic` is ``cv2.warpAffine(img, M, (w, h),
  flags=INTER_CUBIC, borderMode=BORDER_CONSTANT, borderValue=(v,) * C)``
  of a uint8 (H, W, C) image, and :func:`get_rotation_matrix_2d` is
  ``cv2.getRotationMatrix2D``: the rotation of ``RandomRotate``.

Both are integer or IEEE fp32 arithmetic in numpy with every rounding
step of cv2 5.0 written out, so they give the same bits on any host;
``tests/test_torch_cv2exact.py`` holds them against cv2, difference 0.

The resize is cv2's fixed-point path: source coordinates
``(d + 0.5) / s - 0.5`` in fp32 (``s`` per axis), 11-bit
coefficients, an integer horizontal pass, then the vertical pass as
cv2's SIMD body rounds it,
``(((b0 * (S0 >> 4)) >> 16) + ((b1 * (S1 >> 4)) >> 16) + 2) >> 2``.
Columns clamp their coordinate at the edges (coefficient 1 on the edge
pixel); rows do not: a row above the first or below the last samples the
edge row twice with the unclamped coefficients.  An unchanged size is a
copy; a scale of exactly 1/2 on both axes is cv2's INTER_AREA fast path:
2x2 means, ``(sum + 2) >> 2`` inside, and the round-half-even mean of the
pixels that exist on a last odd row or column.

The warp is cv2's fp32 path: the inverted matrix in double, cast to fp32;
per pixel ``sx = m0 * x + (m1 * y + m2)`` in fp32; Keys weights
(A = -0.75) of the fraction, ``c0 = A x (x - 1)^2``, ``c3 = A x^2 (1 -
x)``, ``c1 = fma(fma(A + 2, x, -(A + 3)), x^2, 1)``, ``c2 = 1 - c0 - c1 -
c3``; each row of four taps summed by fused multiply-adds, the rows
likewise; taps outside the image read the border value; the result
rounded half to even and saturated.
"""

from __future__ import annotations

import math
import sys
from typing import Sequence, Tuple

import numpy as np

_F32 = np.float32
_ONE = _F32(1.0)
_A = _F32(-0.75)


# ---------------------------------------------------------------------------
# resize (INTER_LINEAR, uint8)
# ---------------------------------------------------------------------------

def _linear_taps(dst: int, src: int, scale: float, clamp: bool):
    """Per output index: the two source indices and their 11-bit
    coefficients.  `clamp` pins coordinates past an edge to that edge with
    coefficient 0 on the second tap (cv2 does it for columns only)."""
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
         ).astype(_F32)
    s = np.floor(f)
    f = f - s
    s = s.astype(np.int64)
    if clamp:
        out = (s < 0) | (s >= src - 1)
        f[out] = 0
        s = np.clip(s, 0, src - 1)
    c0 = np.rint((_ONE - f) * _F32(2048)).astype(np.int32)
    c1 = np.rint(f * _F32(2048)).astype(np.int32)
    return (np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), c0, c1)


def _resize_half(im: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """cv2's INTER_AREA fast path at exactly 1/2."""
    h, w, c = im.shape
    hh, ww = min(h, 2 * dh), min(w, 2 * dw)
    total = np.zeros((2 * dh, 2 * dw, c), np.int32)
    total[:hh, :ww] = im[:hh, :ww]
    count = np.zeros((2 * dh, 2 * dw, 1), np.int32)
    count[:hh, :ww] = 1
    total = total.reshape(dh, 2, dw, 2, c).sum((1, 3))
    count = count.reshape(dh, 2, dw, 2, 1).sum((1, 3))
    mean = np.rint(total.astype(_F32) / np.maximum(count, 1).astype(_F32))
    return np.where(count == 4, (total + 2) >> 2, mean).astype(np.uint8)


def resize_linear(im: np.ndarray, scale: float) -> np.ndarray:
    """``cv2.resize(im, None, fx=scale, fy=scale)`` of a uint8 (H, W, C)
    frame, to the bit."""
    _check_frame(im)
    h, w = im.shape[:2]
    # cv2's dsize rounds half to even (cvRound), like np.rint
    dh, dw = int(np.rint(h * scale)), int(np.rint(w * scale))
    if dh < 1 or dw < 1:
        raise ValueError(f"scale {scale} leaves no pixel of a {h}x{w} frame")
    return _resize(im, dh, dw, 1.0 / scale, 1.0 / scale)


def resize_linear_to(im: np.ndarray, width: int, height: int
                     ) -> np.ndarray:
    """``cv2.resize(im, (width, height))`` of a uint8 (H, W, C) or (H, W)
    frame, to the bit: each axis at its own inverse scale, cv2's
    ``1 / (width / W)`` and ``1 / (height / H)`` in double.  As cv2, a
    one-channel frame comes back (height, width)."""
    gray = im.ndim == 2 or (im.ndim == 3 and im.shape[2] == 1)
    frame = im.reshape(im.shape[:2] + (1,)) if gray else im
    _check_frame(frame)
    h, w = frame.shape[:2]
    if width < 1 or height < 1:
        raise ValueError(f"no pixel in a {width}x{height} destination")
    out = _resize(frame, int(height), int(width), 1.0 / (width / w),
                  1.0 / (height / h))
    return out[..., 0] if gray else out


def _check_frame(im: np.ndarray) -> None:
    if im.dtype != np.uint8 or im.ndim != 3:
        raise ValueError(f"resize_linear takes a uint8 (H, W, C) frame, "
                         f"got {im.dtype} {im.shape}")


def _resize(im: np.ndarray, dh: int, dw: int, inv_x: float, inv_y: float
            ) -> np.ndarray:
    """cv2's INTER_LINEAR resize of `im` to (dh, dw) at the inverse scales
    `inv_x`, `inv_y` (source pixels per destination pixel)."""
    h, w = im.shape[:2]
    if (dh, dw) == (h, w):
        return im.copy()
    # cv2 takes its INTER_AREA fast path when both inverse scales are 2
    if all(abs(inv - round(inv)) < sys.float_info.epsilon
           and round(inv) == 2 for inv in (inv_x, inv_y)):
        return _resize_half(im, dh, dw)
    x0, x1, a0, a1 = _linear_taps(dw, w, inv_x, clamp=True)
    y0, y1, b0, b1 = _linear_taps(dh, h, inv_y, clamp=False)
    c = im.shape[2]
    # rows as flat (W * C) vectors: each output column's channels gather
    # together, and every step below runs in place
    cols0 = (x0[:, None] * c + np.arange(c)).ravel()
    cols1 = (x1[:, None] * c + np.arange(c)).ravel()
    rows, inverse = np.unique(np.concatenate([y0, y1]), return_inverse=True)
    src = im.reshape(h, w * c)[rows]
    horiz = np.take(src, cols0, axis=1).astype(np.int32)
    horiz *= np.repeat(a0, c)
    tap = np.take(src, cols1, axis=1).astype(np.int32)
    tap *= np.repeat(a1, c)
    horiz += tap
    horiz >>= 4
    out = np.take(horiz, inverse[:dh], axis=0)
    out *= b0[:, None]
    out >>= 16
    tap = np.take(horiz, inverse[dh:], axis=0)
    tap *= b1[:, None]
    tap >>= 16
    out += tap
    out += 2
    out >>= 2
    np.clip(out, 0, 255, out=out)
    return out.astype(np.uint8).reshape(dh, dw, c)


# ---------------------------------------------------------------------------
# warpAffine (INTER_CUBIC, BORDER_CONSTANT, uint8)
# ---------------------------------------------------------------------------

def get_rotation_matrix_2d(center: Tuple[float, float], angle: float,
                           scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: (2, 3) float64; the centre is a
    ``Point2f``, the angle in degrees (positive is counter-clockwise)."""
    cx, cy = float(_F32(center[0])), float(_F32(center[1]))
    rad = angle * (math.pi / 180)
    alpha = math.cos(rad) * scale
    beta = math.sin(rad) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _fma(a, b, c) -> np.ndarray:
    """fp32 fused multiply-add, rounded once: ``a * b`` of two fp32 values
    is exact in float64, so rounding the float64 sum to fp32 is right
    except where that sum is an fp32 midpoint (its low 29 mantissa bits
    are 1 << 28) and the exact sum is not: TwoSum's error then says on
    which side of the midpoint the exact sum lies."""
    p = np.multiply(a, b, dtype=np.float64)
    s = p + c
    r = s.astype(_F32)
    mid = (s.view(np.uint64) & _LOW29) == _HALF29
    if mid.any():
        pm, sm = p[mid], s[mid]
        cm = np.broadcast_to(np.asarray(c, np.float64), s.shape)[mid]
        bv = sm - pm
        err = (pm - (sm - bv)) + (cm - bv)
        rm = r[mid]
        above = rm.astype(np.float64) > sm
        up = np.where(above, rm, np.nextafter(rm, _F32(np.inf)))
        down = np.where(above, np.nextafter(rm, _F32(-np.inf)), rm)
        r[mid] = np.where(err > 0, up, np.where(err < 0, down, rm))
    return r


_LOW29 = np.uint64((1 << 29) - 1)
_HALF29 = np.uint64(1 << 28)


def _cubic_weights(x: np.ndarray):
    """Keys weights of the taps (-1, 0, 1, 2) at fp32 fraction `x`."""
    x2 = x * x
    c0 = ((x - _ONE) * (x - _ONE) * x) * _A
    c3 = (x2 * (_ONE - x)) * _A
    c1 = _fma(_fma(_A + _F32(2), x, -(_A + _F32(3))), x2, _ONE)
    c2 = _ONE - c0 - c1 - c3
    return c0, c1, c2, c3


def _invert_affine(m: np.ndarray) -> np.ndarray:
    """cv2's inverse of a forward (2, 3) map, in double (imgwarp.cpp)."""
    m = np.asarray(m, np.float64).reshape(6).copy()
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[4] = a11, a22
    m[1] *= -d
    m[3] *= -d
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m


def warp_affine_cubic(img: np.ndarray, m: np.ndarray,
                      dsize: Tuple[int, int],
                      border_value: Sequence[float] = (128, 128, 128)
                      ) -> np.ndarray:
    """``cv2.warpAffine(img, m, dsize, flags=cv2.INTER_CUBIC,
    borderMode=cv2.BORDER_CONSTANT, borderValue=border_value)`` of a uint8
    (H, W, C) image; `dsize` is (width, height)."""
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f"warp_affine_cubic takes a uint8 (H, W, C) "
                         f"image, got {img.dtype} {img.shape}")
    nw, nh = int(dsize[0]), int(dsize[1])
    h, w, c = img.shape
    mi = _invert_affine(m).astype(_F32)
    # a border of constant pixels wide enough that every tap of a clamped
    # coordinate reads it: 4 taps from floor - 1, floor clamped to
    # [-4, size + 3]
    pad = 6
    canvas = np.empty((h + 2 * pad, w + 2 * pad, c), _F32)
    canvas[...] = np.asarray(border_value, _F32)[:c]
    canvas[pad:pad + h, pad:pad + w] = img
    pixels = canvas.reshape(-1, c)
    out = np.empty((nh, nw, c), np.uint8)
    xs = np.arange(nw, dtype=_F32)[None, :]
    for y0 in range(0, nh, _ROWS):      # row blocks that stay in cache
        ys = np.arange(y0, min(nh, y0 + _ROWS), dtype=_F32)[:, None]
        sx = mi[0] * xs + (mi[1] * ys + mi[2])
        sy = mi[3] * xs + (mi[4] * ys + mi[5])
        fl_x, fl_y = np.floor(sx), np.floor(sy)
        wx = [k[..., None] for k in _cubic_weights(sx - fl_x)]
        wy = [k[..., None] for k in _cubic_weights(sy - fl_y)]
        ix = np.clip(fl_x, -4, w + 3).astype(np.int64) + (pad - 1)
        iy = np.clip(fl_y, -4, h + 3).astype(np.int64) + (pad - 1)
        corner = iy * canvas.shape[1] + ix
        acc = None
        for i in range(4):
            row = None
            for j in range(4):
                v = np.take(pixels, corner + (i * canvas.shape[1] + j),
                            axis=0)
                row = wx[j] * v if row is None else _fma(wx[j], v, row)
            acc = wy[0] * row if acc is None else _fma(wy[i], row, acc)
        out[y0:y0 + _ROWS] = np.clip(np.rint(acc), 0, 255)
    return out


_ROWS = 32
