"""Skeleton rendering (port of rtpose_tpu/utils/draw.py; reference
lib/utils/common.py:227-251 draw_humans), without cv2.

The JAX package draws with ``cv2.circle(img, c, 3, color, thickness=3,
lineType=8)`` at parts and ``cv2.line(img, a, b, color, 3)`` along the
render pairs, and its scene renderer (scripts/hw_train_synth.py) fills
``cv2.circle(img, c, 5, color, -1)``.  :func:`cv_circle` and
:func:`cv_line` give OpenCV's pixels for those calls (8-connected,
thickness above 1, or a filled circle): a thick line is a
filled convex quad, its outline traced by OpenCV's fixed-point line walk,
plus a filled midpoint circle at each end; a thick circle is the polygon
OpenCV's ``ellipse2Poly`` gives, drawn as such thick lines.  Every step
keeps OpenCV's 16.16 fixed point, its rounding (``cvRound``, half to
even) and its clipping at the frame's edges, so
tests/test_torch_frontends.py holds :func:`draw_people` equal to the JAX
package's, pixel for pixel.  :func:`put_text` is the webcam demo's FPS
overlay, ``cv2.putText`` in cv2 5.0's pixels (tests/test_torch_webcam.py).
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..skeleton import PART_COLORS, RENDER_PAIRS

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
Color = Sequence[int]


def _round(v: float) -> int:
    """cvRound: to the nearest integer, halves to even."""
    return int(round(v))


def _tdiv(a: int, b: int) -> int:
    """C's integer division (towards zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _hline(img: np.ndarray, y: int, x1: int, x2: int, color) -> None:
    h, w = img.shape[:2]
    if 0 <= y < h:
        x1, x2 = max(x1, 0), min(x2, w - 1)
        if x1 <= x2:
            img[y, x1:x2 + 1] = color


def _fill_circle(img, cx: int, cy: int, radius: int, color) -> None:
    """OpenCV's ``Circle`` with ``fill``: the midpoint walk, a span per
    row."""
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        for y in (cy - dy, cy + dy):
            _hline(img, y, cx - dx, cx + dx, color)
        for y in (cy - dx, cy + dx):
            _hline(img, y, cx - dy, cx + dy, color)
        dy += 1
        err += plus
        plus += 2
        mask = -1 if err > 0 else 0
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's ``clipLine`` on a (w, h) frame -> the clipped points, or
    None where the line misses it."""
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return x1, y1, x2, y2


def _put(img, x: int, y: int, color) -> None:
    h, w = img.shape[:2]
    if 0 <= x < w and 0 <= y < h:
        img[y, x] = color


def _line2(img, p1: Tuple[int, int], p2: Tuple[int, int], color) -> None:
    """OpenCV's ``Line2``: an 8-connected line between 16.16 fixed-point
    points, one pixel per step of the longer axis."""
    h, w = img.shape[:2]
    clipped = _clip_line(w << XY_SHIFT, h << XY_SHIFT, *p1, *p2)
    if clipped is None:
        return
    x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    if abs(dx) > abs(dy):
        if dx < 0:        # walk left to right
            x1, y1, x2, y2 = x2, y2, x1, y1
        y_step = _tdiv((y2 - y1) << XY_SHIFT, abs(dx) | 1)
        count = (x2 - x1) >> XY_SHIFT
        x_step = None
    else:
        if dy < 0:        # walk top to bottom
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step = _tdiv((x2 - x1) << XY_SHIFT, abs(dy) | 1)
        count = (y2 - y1) >> XY_SHIFT
    half = XY_ONE >> 1
    x1 += half
    y1 += half
    _put(img, (x2 + half) >> XY_SHIFT, (y2 + half) >> XY_SHIFT, color)
    if x_step is None:
        x = x1 >> XY_SHIFT
        for _ in range(count + 1):
            _put(img, x, y1 >> XY_SHIFT, color)
            x += 1
            y1 += y_step
    else:
        y = y1 >> XY_SHIFT
        for _ in range(count + 1):
            _put(img, x1 >> XY_SHIFT, y, color)
            x1 += x_step
            y += 1


def _fill_convex_poly(img, v: List[Tuple[int, int]], color) -> None:
    """OpenCV's ``FillConvexPoly`` for 16.16 fixed-point vertices and
    8-connected drawing: the outline by :func:`_line2`, then one span a
    row between the two edges walking down from the top vertex."""
    h, w = img.shape[:2]
    npts = len(v)
    delta = XY_ONE >> 1
    xs_all = [p[0] for p in v]
    ys_all = [p[1] for p in v]
    imin = min(range(npts), key=lambda i: (ys_all[i], i))
    p0 = v[-1]
    for p in v:
        _line2(img, p0, p, color)
        p0 = p
    xmin = (min(xs_all) + delta) >> XY_SHIFT
    xmax = (max(xs_all) + delta) >> XY_SHIFT
    ymin = (min(ys_all) + delta) >> XY_SHIFT
    ymax = (max(ys_all) + delta) >> XY_SHIFT
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    # per edge: [idx, di, x, dx, ye]
    edge = [[imin, 1, -XY_ONE, 0, ymin], [imin, npts - 1, -XY_ONE, 0, ymin]]
    edges = npts
    y = ymin
    while True:
        for e in edge:
            if y >= e[4]:
                idx0, di = e[0], e[1]
                idx = idx0 + di
                if idx >= npts:
                    idx -= npts
                while True:
                    edges -= 1
                    if edges < 0:
                        break
                    ty = (v[idx][1] + delta) >> XY_SHIFT
                    if ty > y:
                        xs, xe = v[idx0][0], v[idx][0]
                        e[4] = ty
                        e[3] = _tdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        e[2] = xs
                        e[0] = idx
                        break
                    idx0 = idx
                    idx += di
                    if idx >= npts:
                        idx -= npts
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0][2] > edge[1][2] else (0, 1)
            x1 = (edge[left][2] + delta) >> XY_SHIFT
            x2 = (edge[right][2] + delta) >> XY_SHIFT
            if x2 >= 0 and x1 < w:
                _hline(img, y, x1, x2, color)
        edge[0][2] += edge[0][3]
        edge[1][2] += edge[1][3]
        y += 1
        if y > ymax:
            break


def _thick_line(img, p0, p1, color, thickness: int, flags: int) -> None:
    """OpenCV's ``ThickLine`` (thickness > 1, 8-connected) between 16.16
    fixed-point points: a quad of half-width (thickness + odd) / 2, and a
    filled circle at p0 (flags & 1) and at p1 (flags & 2)."""
    dx = (p0[0] - p1[0]) / XY_ONE
    dy = (p1[1] - p0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    thickness <<= XY_SHIFT - 1
    if abs(r) > 2.220446049250313e-16:
        r = (thickness + odd * XY_ONE * 0.5) / math.sqrt(r)
        dpx, dpy = _round(dy * r), _round(dx * r)
        _fill_convex_poly(img, [(p0[0] + dpx, p0[1] + dpy),
                                (p0[0] - dpx, p0[1] - dpy),
                                (p1[0] - dpx, p1[1] - dpy),
                                (p1[0] + dpx, p1[1] + dpy)], color)
    half = XY_ONE >> 1
    radius = (thickness + half) >> XY_SHIFT
    for i, p in enumerate((p0, p1)):
        if flags & (i + 1):
            _fill_circle(img, (p[0] + half) >> XY_SHIFT,
                         (p[1] + half) >> XY_SHIFT, radius, color)


def _check(img: np.ndarray, thickness: int, filled_ok: bool = False
           ) -> None:
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"draws on (H, W, 3) uint8 images, got "
                         f"{img.dtype} {img.shape}")
    if thickness < 2 and not (filled_ok and thickness < 0):
        raise ValueError("only thick (thickness > 1) lines and circles "
                         "and filled (thickness < 0) circles, the ones the "
                         "demos and the scene renderer draw, are "
                         "implemented")


def cv_line(img: np.ndarray, pt1, pt2, color: Color,
            thickness: int) -> None:
    """``cv2.line(img, pt1, pt2, color, thickness)`` (8-connected, integer
    points), in place.  OpenCV first clips the line to the frame grown by
    `thickness` on every side, so the quad of a line that leaves the
    frame is spanned from the clipped ends."""
    _check(img, thickness)
    h, w = img.shape[:2]
    m = thickness
    clipped = _clip_line(w + 2 * m, h + 2 * m, int(pt1[0]) + m,
                         int(pt1[1]) + m, int(pt2[0]) + m, int(pt2[1]) + m)
    if clipped is None:
        return
    x1, y1, x2, y2 = (v - m for v in clipped)
    _thick_line(img, (x1 << XY_SHIFT, y1 << XY_SHIFT),
                (x2 << XY_SHIFT, y2 << XY_SHIFT),
                np.asarray(color, np.uint8), thickness, 3)


# sin of whole degrees 0..450 as OpenCV's float table holds them
def _sin_table(deg: int) -> float:
    return float(np.float32(f"{math.sin(math.radians(deg)):.7f}"))


def cv_circle(img: np.ndarray, center, radius: int, color: Color,
              thickness: int) -> None:
    """``cv2.circle(img, center, radius, color, thickness, lineType=8)``
    with thickness > 1, in place: OpenCV's ``EllipseEx`` over the
    polygon of ``ellipse2Poly`` (a vertex every 90, 30, 18 or 5 degrees
    by radius), drawn as an open polyline of thick lines.  A negative
    thickness (``cv2.FILLED``) is OpenCV's ``Circle`` with ``fill``: the
    midpoint circle that also caps a thick line, a span a row."""
    _check(img, thickness, filled_ok=True)
    if thickness < 0:
        _fill_circle(img, int(center[0]), int(center[1]), abs(int(radius)),
                     np.asarray(color, np.uint8))
        return
    cx, cy = int(center[0]) << XY_SHIFT, int(center[1]) << XY_SHIFT
    axis = abs(int(radius)) << XY_SHIFT
    step = (axis + (XY_ONE >> 1)) >> XY_SHIFT
    step = 90 if step < 3 else 30 if step < 10 else 18 if step < 15 else 5
    pts: List[Tuple[int, int]] = []
    for deg in range(0, 360 + step, step):
        deg = min(deg, 360)
        vx = cx + axis * _sin_table(450 - deg)
        vy = cy + axis * _sin_table(deg)
        px = _round(vx / XY_ONE) << XY_SHIFT
        py = _round(vy / XY_ONE) << XY_SHIFT
        pt = (px + _round(vx - px), py + _round(vy - py))
        if not pts or pt != pts[-1]:
            pts.append(pt)
    if len(pts) == 1:
        pts = [(cx, cy)] * 2
    color = np.asarray(color, np.uint8)
    flags = 3
    for a, b in zip(pts[:-1], pts[1:]):
        _thick_line(img, a, b, color, thickness, flags)
        flags = 2


def draw_people(image_bgr: np.ndarray, people: List[Dict[str, Any]],
                meta: Optional[dict] = None, *, radius: int = 3,
                thickness: int = 3) -> np.ndarray:
    """Draw circles at parts + limb lines on a copy of the image.

    `people` uses normalized coordinates over the padded upsampled frame;
    `meta['scale']`/`meta['upsampled']` (from PosePipeline.run) map them to
    original-image pixels; without meta, coordinates are scaled by the image
    size directly.
    """
    img = image_bgr.copy()
    h, w = img.shape[:2]
    if meta is not None:
        h_up, w_up = meta["upsampled"]
        scale = meta["scale"]
        sx = w_up / scale
        sy = h_up / scale
    else:
        sx, sy = w, h

    for person in people:
        centers = {}
        for part, (xn, yn, _score) in person["parts"].items():
            center = (int(xn * sx + 0.5), int(yn * sy + 0.5))
            centers[part] = center
            cv_circle(img, center, radius, PART_COLORS[part % 18],
                      thickness)
        for pi, (a, b) in enumerate(RENDER_PAIRS):
            if a not in centers or b not in centers:
                continue
            cv_line(img, centers[a], centers[b], PART_COLORS[pi % 18],
                    thickness)
    return img


@functools.lru_cache(maxsize=1)
def _glyphs():
    from .text_glyphs import load_table
    table = load_table()
    return ({chr(c): i for i, c in enumerate(table["chars"])},
            table["alpha"].astype(np.int64)[..., None],
            tuple(int(v) for v in table["corner"]),
            tuple(int(v) for v in table["advance"]))


def put_text(img: np.ndarray, text: str, org, color: Color,
             thickness: int = 2) -> None:
    """``cv2.putText(img, text, org, cv2.FONT_HERSHEY_SIMPLEX, 1.0, color,
    thickness)`` (``LINE_8``, the origin at the baseline's left end), in
    place, in cv2 5.0's pixels, for the characters of the webcam demo's
    FPS overlay: the digits, ".", " ", "F", "P" and "S" at thickness 2.
    Each glyph is cv2's coverage mask from ``utils/text_glyphs.npz``,
    blended at its whole-pixel place and clipped at the frame's edges,
    as cv2 blends it.  Raises ValueError for another character or
    thickness, or another image layout."""
    index, alpha, (dy, dx), advance = _glyphs()
    _check(img, 2)
    if thickness != 2:
        raise ValueError(f"put_text draws thickness 2 (the table's), not "
                         f"{thickness}")
    unknown = sorted(set(text) - set(index))
    if unknown:
        raise ValueError(f"put_text has no glyph for {unknown} (it draws "
                         f"{''.join(sorted(index))!r})")
    h, w = img.shape[:2]
    gh, gw = alpha.shape[1:3]
    col = np.asarray(color, np.int64)
    x = int(org[0])
    y0 = int(org[1]) + dy
    ya, yb = max(y0, 0), min(y0 + gh, h)
    for ch in text:
        i = index[ch]
        x0 = x + dx
        xa, xb = max(x0, 0), min(x0 + gw, w)
        if ya < yb and xa < xb:
            a = alpha[i, ya - y0:yb - y0, xa - x0:xb - x0]
            region = img[ya:yb, xa:xb]
            region[:] = (col * a + region * (255 - a) + 127) // 255
        x += advance[i]
