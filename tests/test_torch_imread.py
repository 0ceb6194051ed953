"""The port's image reader against ``cv2.imread(path, IMREAD_COLOR)``, the
JAX eval harness's reader: pixel for pixel (tolerance 0) on JPEGs written
here (4:2:0 with odd sides, 4:4:4, grayscale, progressive, EXIF
orientations 3, 6 and 8) and on a PNG; the committed fixtures against the
cv2 pixels stored beside them; the errors of a missing, a corrupt and an
unreadable file; and no silent route when Pillow is missing."""

import os
import sys

import cv2
import numpy as np
import pytest

from rtpose_tpu_torch.data import imread_fixtures as fx
from rtpose_tpu_torch.data.imread import read_bgr


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    return fx.write_fixtures(str(tmp_path_factory.mktemp("imread")))


@pytest.mark.parametrize("name", list(fx.FIXTURES))
def test_read_bgr_equals_cv2_imread(written, name):
    got = read_bgr(written[name])
    want = cv2.imread(written[name], cv2.IMREAD_COLOR)
    assert got.dtype == np.uint8 and got.flags["C_CONTIGUOUS"]
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_orientation_and_gray_cases_are_real(written):
    """The fixtures reach the cases: orientations 6 and 8 transpose the
    stored frame and 3 rotates it; the grayscale file has one channel."""
    from PIL import Image
    stored = {n: np.asarray(Image.open(p)) for n, p in written.items()}
    h, w = fx.HEIGHT, fx.WIDTH
    assert stored["exif6"].shape[:2] == (h, w)
    assert read_bgr(written["exif6"]).shape == read_bgr(
        written["exif8"]).shape == (w, h, 3)
    np.testing.assert_array_equal(
        read_bgr(written["exif3"]),
        np.ascontiguousarray(stored["exif3"][::-1, ::-1, ::-1]))
    assert stored["gray"].ndim == 2
    g = read_bgr(written["gray"])
    assert (g == g[..., :1]).all()
    with Image.open(written["progressive"]) as im:
        assert im.info.get("progressive") or im.info.get("progression")


def test_committed_fixtures_equal_their_cv2_pixels():
    """The files chip_smoke.py reads on the card's machine, and the cv2
    pixels it holds them against, are cv2's reading of those files."""
    pixels = np.load(fx.CV2_PIXELS)
    assert sorted(pixels.files) == sorted(fx.FIXTURES)
    for name in fx.FIXTURES:
        path = fx.fixture_path(name)
        np.testing.assert_array_equal(cv2.imread(path), pixels[name])
        np.testing.assert_array_equal(read_bgr(path), pixels[name])
    total = sum(os.path.getsize(os.path.join(fx.FIXTURE_DIR, f))
                for f in os.listdir(fx.FIXTURE_DIR))
    assert total < 300 * 1024


def test_png_equals_cv2_imread(tmp_path):
    img = fx.render_scene(9)
    path = str(tmp_path / "x.png")
    cv2.imwrite(path, img)
    np.testing.assert_array_equal(read_bgr(path), cv2.imread(path))


def test_missing_and_corrupt_files_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        read_bgr(str(tmp_path / "missing.jpg"))
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"not an image" * 10)
    assert cv2.imread(str(bad)) is None
    with pytest.raises(IOError, match="could not decode"):
        read_bgr(str(bad))
    with pytest.raises(IOError, match="could not decode"):
        read_bgr(str(tmp_path))          # a directory


def test_without_pillow_the_reader_raises(monkeypatch, written):
    for name in [m for m in sys.modules if m == "PIL" or
                 m.startswith("PIL.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        read_bgr(written["s420"])
