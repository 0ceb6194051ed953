"""The reader's fixture JPEGs: small rendered scenes, one for each case
whose decode ``cv2.imread`` and :func:`.imread.read_bgr` must agree on.

- ``s420``: colour, 4:2:0 chroma (COCO's common case), odd sides, so the
  chroma upsampling meets the ragged edge;
- ``s444``: colour, 4:4:4;
- ``gray``: one channel (COCO has some), read as three equal channels;
- ``progressive``: a progressive JPEG;
- ``exif3``, ``exif6``, ``exif8``: EXIF orientations 3 (180 degrees), 6
  and 8 (90 degrees either way: the frame comes out transposed).

    python -m rtpose_tpu_torch.data.imread_fixtures

writes them into ``data/fixtures/`` with Pillow and stores cv2's pixels of
each beside them (``cv2_pixels.npz``, compressed), which ``chip_smoke.py``
holds the reader against on a machine without cv2.  Running it needs cv2;
importing this module needs neither.
"""

from __future__ import annotations

import os

import numpy as np

FIXTURE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "fixtures")
CV2_PIXELS = os.path.join(FIXTURE_DIR, "cv2_pixels.npz")
HEIGHT, WIDTH = 45, 61        # odd sides: a ragged 4:2:0 chroma edge

# name -> Pillow save options (all quality 90)
FIXTURES = {
    "s420": dict(subsampling=2),
    "s444": dict(subsampling=0),
    "gray": dict(mode="L"),
    "progressive": dict(subsampling=2, progressive=True),
    "exif3": dict(subsampling=2, orientation=3),
    "exif6": dict(subsampling=2, orientation=6),
    "exif8": dict(subsampling=2, orientation=8),
}


def render_scene(seed: int, h: int = HEIGHT, w: int = WIDTH) -> np.ndarray:
    """(h, w, 3) uint8 RGB: colour gradients, two saturated boxes (sharp
    chroma edges) and a noisy patch, all from `seed`."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([xx / w * 255, yy / h * 255,
                    (xx + yy) / (h + w) * 255], -1)
    for _ in range(2):
        y0, x0 = rng.randint(0, h // 2), rng.randint(0, w // 2)
        img[y0:y0 + h // 3, x0:x0 + w // 3] = rng.randint(0, 256, 3)
    y0, x0 = rng.randint(0, h - 8), rng.randint(0, w - 8)
    img[y0:y0 + 8, x0:x0 + 8] = rng.randint(0, 256, (8, 8, 3))
    return img.astype(np.uint8)


def fixture_path(name: str, directory: str = FIXTURE_DIR) -> str:
    return os.path.join(directory, f"{name}.jpg")


def write_fixtures(directory: str = FIXTURE_DIR) -> dict:
    """Write every fixture JPEG into `directory` -> {name: path}."""
    from PIL import Image

    os.makedirs(directory, exist_ok=True)
    out = {}
    for seed, (name, opts) in enumerate(FIXTURES.items()):
        opts = dict(opts)
        im = Image.fromarray(render_scene(seed))
        if opts.pop("mode", None) == "L":
            im = im.convert("L")
        orientation = opts.pop("orientation", None)
        if orientation is not None:
            exif = Image.Exif()
            exif[0x0112] = orientation
            opts["exif"] = exif.tobytes()
        out[name] = fixture_path(name, directory)
        im.save(out[name], quality=90, **opts)
    return out


def main() -> int:
    import cv2

    paths = write_fixtures()
    pixels = {name: cv2.imread(path, cv2.IMREAD_COLOR)
              for name, path in paths.items()}
    np.savez_compressed(CV2_PIXELS, **pixels)
    for name, img in pixels.items():
        print(name, img.shape, os.path.getsize(paths[name]), "bytes")
    print("cv2", cv2.__version__, "->", CV2_PIXELS,
          os.path.getsize(CV2_PIXELS), "bytes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
