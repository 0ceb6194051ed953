"""The glyph table of :func:`.draw.put_text`: cv2's pixels of the
characters an FPS overlay prints, in ``cv2.putText``'s
``FONT_HERSHEY_SIMPLEX`` at scale 1.0 and thickness 2.

cv2 5.0 draws that font with its own outline renderer: each glyph is an
8-bit coverage (alpha) mask, the same at every whole-pixel origin, laid
at whole-pixel advances with no kerning, and blended into the frame glyph
after glyph as ``(color * a + pixel * (255 - a) + 127) // 255``.  So a
text is fixed by one mask and one advance per character, which this table
holds: ``alpha`` (n, H, W), every glyph on one box whose top-left corner
lies at ``corner`` (dy, dx) from the text's origin, ``advance`` (n,) in
pixels, and ``chars``, the characters as code points.

    python -m rtpose_tpu_torch.utils.text_glyphs

writes the table (``text_glyphs.npz``, beside this file) from cv2's
drawing of each character alone; tests/test_torch_webcam.py makes it
again and holds it equal, and holds ``put_text`` equal to
``cv2.putText``.  Running it needs cv2; importing this module needs
neither.
"""

from __future__ import annotations

import os

import numpy as np

TABLE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "text_glyphs.npz")
CHARS = "0123456789. FPS"
THICKNESS = 2
# where each character is drawn alone: an origin far from every edge
_CANVAS, _ORIGIN = 96, 48


def make_table() -> dict:
    """The table from the installed cv2: each character drawn alone in
    white on black (its alpha, since ``(255 * a + 127) // 255 == a``),
    the box that holds every glyph, and each advance: the shift of a
    "1" drawn after the character (``cv2.getTextSize`` rounds the
    advances otherwise: 8 for ".", which steps 7)."""
    import cv2

    def drawn(text):
        img = np.zeros((_CANVAS, _CANVAS, 3), np.uint8)
        cv2.putText(img, text, (_ORIGIN, _ORIGIN), cv2.FONT_HERSHEY_SIMPLEX,
                    1.0, (255, 255, 255), THICKNESS)
        if not ((img == img[..., :1]).all() and img[0].max() == 0
                and img[-1].max() == 0 and img[:, 0].max() == 0
                and img[:, -1].max() == 0):
            raise RuntimeError(f"cv2 {cv2.__version__} drew {text!r} in "
                               f"colour or beyond its canvas")
        return img[..., 0].astype(np.int64)

    masks = [drawn(ch) for ch in CHARS]
    one = masks[CHARS.index("1")]
    advance = []
    for ch, mask in zip(CHARS, masks):
        pair = drawn(ch + "1")
        steps = [d for d in range(_CANVAS - _ORIGIN)
                 if (pair == (255 * np.roll(one, d, 1) + mask
                              * (255 - np.roll(one, d, 1)) + 127)
                     // 255).all()]
        if len(steps) != 1:
            raise RuntimeError(f"cv2 {cv2.__version__}: {ch!r}1 is not "
                               f"{ch!r} and 1 blended at one step: {steps}")
        advance.append(steps[0])
    ink = np.nonzero(np.any(masks, axis=0))
    y0, y1 = ink[0].min(), ink[0].max() + 1
    x0, x1 = ink[1].min(), ink[1].max() + 1
    return {"alpha": np.stack([m[y0:y1, x0:x1] for m in masks]
                              ).astype(np.uint8),
            "corner": np.array([y0 - _ORIGIN, x0 - _ORIGIN], np.int64),
            "advance": np.array(advance, np.int64),
            "chars": np.array([ord(c) for c in CHARS], np.int64),
            "cv2_version": np.array(cv2.__version__)}


def load_table() -> dict:
    with np.load(TABLE) as z:
        return {k: z[k] for k in z.files}


def main() -> None:
    np.savez_compressed(TABLE, **make_table())
    print(f"wrote {TABLE}")


if __name__ == "__main__":
    main()
