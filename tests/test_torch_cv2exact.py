"""``data/cv2exact.py`` against cv2 (which the tests may import and the
port may not): the host resize equals ``cv2.resize(im, None, fx=s,
fy=s)`` (INTER_LINEAR) and the warp equals ``cv2.warpAffine`` (INTER_CUBIC,
BORDER_CONSTANT) on uint8 frames, difference 0, on shapes that
hypothesis draws: upscales, downscales, exactly 1/2 (cv2's INTER_AREA
fast path), exactly 1 (a copy), odd sizes, and rotations within +-40
degrees plus 0 and +-90."""

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from rtpose_tpu_torch.data.cv2exact import (get_rotation_matrix_2d,
                                            resize_linear, warp_affine_cubic)

SETTINGS = settings(max_examples=60, deadline=None, derandomize=True,
                    database=None)


def _frame(seed, h, w, c=3):
    return np.random.RandomState(seed).randint(0, 256, (h, w, c), np.uint8)


@pytest.mark.parametrize("h,w,dest", [(480, 640, 368), (427, 640, 368),
                                      (375, 500, 368), (240, 320, 368),
                                      (100, 130, 368), (200, 900, 368),
                                      (736, 1000, 368), (368, 500, 368),
                                      (101, 77, 56), (1, 7, 3)])
def test_crop_with_factor_scales_equal_cv2(h, w, dest):
    """The scales of the eval and the demos: a short side to 368 (COCO
    frames down, small frames up, exactly 1/2 and 1), and tiny ones."""
    im = _frame(h * w, h, w)
    s = float(dest) / min(h, w)
    np.testing.assert_array_equal(resize_linear(im, s),
                                  cv2.resize(im, None, fx=s, fy=s))


@SETTINGS
@given(h=st.integers(1, 160), w=st.integers(1, 160),
       kind=st.sampled_from(["short_side", "half", "one", "any"]),
       dest=st.integers(4, 400), s=st.floats(0.1, 4.0),
       seed=st.integers(0, 2**16))
def test_resize_linear_equals_cv2(h, w, kind, dest, s, seed):
    scale = {"short_side": float(dest) / min(h, w), "half": 0.5, "one": 1.0,
             "any": s}[kind]
    if round(h * scale) < 1 or round(w * scale) < 1:
        return
    im = _frame(seed, h, w)
    np.testing.assert_array_equal(resize_linear(im, scale),
                                  cv2.resize(im, None, fx=scale, fy=scale))


def _rotate_both(img, degree):
    """RandomRotate's geometry (rtpose_tpu/data/transforms.py:221-234) with
    cv2's and the port's functions."""
    h, w = img.shape[:2]
    cx, cy = w // 2, h // 2
    m = cv2.getRotationMatrix2D((cx, cy), -degree, 1.0)
    np.testing.assert_array_equal(get_rotation_matrix_2d((cx, cy), -degree,
                                                         1.0), m)
    cos, sin = abs(m[0, 0]), abs(m[0, 1])
    nw, nh = int(h * sin + w * cos), int(h * cos + w * sin)
    m[0, 2] += nw / 2 - cx
    m[1, 2] += nh / 2 - cy
    want = cv2.warpAffine(img, m, (nw, nh), flags=cv2.INTER_CUBIC,
                          borderMode=cv2.BORDER_CONSTANT,
                          borderValue=(128, 128, 128))
    return warp_affine_cubic(img, m, (nw, nh)), want


@pytest.mark.parametrize("degree", [0.0, 40.0, -40.0, 90.0, -90.0, 12.5])
def test_rotation_equals_cv2_at_fixed_angles(degree):
    got, want = _rotate_both(_frame(7, 61, 83), degree)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@SETTINGS
@given(h=st.integers(1, 120), w=st.integers(1, 120),
       degree=st.floats(-40.0, 40.0), seed=st.integers(0, 2**16))
def test_rotation_equals_cv2(h, w, degree, seed):
    got, want = _rotate_both(_frame(seed, h, w), degree)
    np.testing.assert_array_equal(got, want)


@SETTINGS
@given(seed=st.integers(0, 2**16), border=st.integers(0, 255))
def test_general_affine_equals_cv2(seed, border):
    """Any affine map (scale, shear, translation), any constant border."""
    rng = np.random.RandomState(seed)
    img = _frame(seed, int(rng.randint(3, 50)), int(rng.randint(3, 50)))
    m = np.array([[rng.uniform(0.5, 1.5), rng.uniform(-0.5, 0.5),
                   rng.uniform(-10, 10)],
                  [rng.uniform(-0.5, 0.5), rng.uniform(0.5, 1.5),
                   rng.uniform(-10, 10)]])
    size = (int(rng.randint(1, 60)), int(rng.randint(1, 60)))
    want = cv2.warpAffine(img, m, size, flags=cv2.INTER_CUBIC,
                          borderMode=cv2.BORDER_CONSTANT,
                          borderValue=(border,) * 3)
    np.testing.assert_array_equal(
        warp_affine_cubic(img, m, size, border_value=(border,) * 3), want)


def test_rejects_what_cv2_would_not_be_asked():
    with pytest.raises(ValueError, match="uint8"):
        resize_linear(np.zeros((4, 4, 3), np.float32), 2.0)
    with pytest.raises(ValueError, match="no pixel"):
        resize_linear(np.zeros((4, 4, 3), np.uint8), 0.01)
    with pytest.raises(ValueError, match="uint8"):
        warp_affine_cubic(np.zeros((4, 4), np.uint8), np.eye(2, 3), (4, 4))
