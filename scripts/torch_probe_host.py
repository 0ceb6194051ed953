"""Probe the host side of the port on a machine: Pillow's bundled
libjpeg, the native loader's build against it, its pixels against
Pillow's, and the cv2-free resize and warp (their time, and their pixels
against cv2 where cv2 is installed; the port itself never imports cv2).

    python3 scripts/torch_probe_host.py

Prints one line a finding and a last ``SUMMARY`` JSON line.
"""

import io
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import PIL
    import PIL.Image
    from PIL import ImageEnhance

    from rtpose_tpu_torch.data.cv2exact import (get_rotation_matrix_2d,
                                                resize_linear,
                                                warp_affine_cubic)
    from rtpose_tpu_torch.native import imgpipe

    out = {"python": sys.version.split()[0], "pillow": PIL.__version__,
           "nproc": len(os.sched_getaffinity(0))}
    out["libjpeg"] = str(imgpipe.pillow_libjpeg())
    t0 = time.perf_counter()
    out["imgpipe"] = os.path.relpath(imgpipe.loaded_library(), ROOT)
    out["build_s"] = round(time.perf_counter() - t0, 2)
    print(f"native loader: {out['imgpipe']} over {out['libjpeg']} "
          f"({out['build_s']} s)", flush=True)

    rng = np.random.default_rng(0)
    arr = (rng.random((120, 160, 3)) * 255).astype(np.uint8)
    buf = io.BytesIO()
    PIL.Image.fromarray(arr).save(buf, "jpeg", quality=92)
    jpg = buf.getvalue()
    pil = PIL.Image.open(io.BytesIO(jpg)).convert("RGB")
    again = io.BytesIO()
    pil.save(again, "jpeg", quality=50)
    cases = {
        "decode": ({}, pil),
        "brightness": (dict(brightness=1.08),
                       ImageEnhance.Brightness(pil).enhance(1.08)),
        "recompress": (dict(jpeg_quality=50),
                       PIL.Image.open(again).convert("RGB")),
        "resample": (dict(resize_wh=(117, 93)),
                     pil.resize((117, 93), PIL.Image.BICUBIC)),
    }
    pipe = imgpipe.ImgPipe(2)
    for name, (kw, want) in cases.items():
        want = np.asarray(want)
        got = np.zeros_like(want)
        pipe.submit(jpg, out_u8=got, content_xywh=(0, 0, got.shape[1],
                                                   got.shape[0]), **kw)
        pipe.wait()
        out[f"{name}_equals_pil"] = bool((got == want).all())
    print(f"native pixels == Pillow's: "
          f"{ {k: v for k, v in out.items() if k.endswith('_pil')} }",
          flush=True)

    frame = rng.integers(0, 256, (480, 640, 3), np.uint8)
    t0 = time.perf_counter()
    for _ in range(20):
        resized = resize_linear(frame, 368 / 480)
    out["resize_ms"] = round((time.perf_counter() - t0) * 1e3 / 20, 2)
    m = get_rotation_matrix_2d((320, 240), -30.0, 1.0)
    t0 = time.perf_counter()
    for _ in range(3):
        warped = warp_affine_cubic(frame, m, (700, 600))
    out["warp_ms"] = round((time.perf_counter() - t0) * 1e3 / 3, 1)
    print(f"resize 480x640 -> 368x491: {out['resize_ms']} ms; warp 480x640 "
          f"-> 700x600: {out['warp_ms']} ms (one thread)", flush=True)
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        out["cv2"] = cv2.__version__
        out["resize_equals_cv2"] = bool((resized == cv2.resize(
            frame, None, fx=368 / 480, fy=368 / 480)).all())
        out["warp_equals_cv2"] = bool((warped == cv2.warpAffine(
            frame, m, (700, 600), flags=cv2.INTER_CUBIC,
            borderMode=cv2.BORDER_CONSTANT,
            borderValue=(128, 128, 128))).all())
        print(f"cv2 {out['cv2']}: resize equal {out['resize_equals_cv2']}, "
              f"warp equal {out['warp_equals_cv2']}", flush=True)
    print("SUMMARY", json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
