"""COCO-val2017-scale eval rehearsal of the PyTorch port, with nothing
downloaded (the port's counterpart of scripts/cocoval_rehearsal.py).

Writes a synthetic set with val2017's shape profile (the reference's
headline eval runs 5,000 images across dozens of padded-shape buckets,
reference evaluate/coco_eval.py:245-283): ``VAL2017_SHAPES``,
``PEOPLE_COUNTS`` and ``sample_shape`` are the JAX script's, and the
scenes are drawn by scripts/torch_train_synth.py's ``render_scene`` from
the same random stream, so ``annotations.json`` equals the JAX script's
for the same seed (the JPEG bytes may differ: Pillow encodes at cv2's
settings, ``data/imwrite.py``).  The rehearsal itself is the eval CLI
on that set, as in COCO_RUNBOOK.md:

    python3 scripts/torch_cocoval_rehearsal.py --n 5000
    python3 -m rtpose_tpu_torch.evalx \\
        --image-dir rtpose_tpu_torch/build/cocoval_synth/images \\
        --ann rtpose_tpu_torch/build/cocoval_synth/annotations.json \\
        --preprocess vgg --batch 16 [--pad-to 64]

``--eval`` runs that CLI's ``main()`` in this process after writing
(``--weight``, ``--stages``, ``--input-size``, ``--pad-to``,
``--device`` passed on; seeded weights without ``--weight``) and prints
one ``SUMMARY`` JSON line: the eval's stats (``pipeline_s``,
``evaluator_s``, ``n_buckets``, ``images``, retries) beside the bucket
count ``scale_pad_geometry`` gives for the set, and on the card the
kernels' launches.  ``--out`` defaults to
the git-ignored ``rtpose_tpu_torch/build/cocoval_synth``.
"""

import argparse
import contextlib
import io
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from torch_train_synth import (person_to_coco_annotation,  # noqa: E402
                               render_scene)

# val2017's shape profile: dominated by max-side-640 landscape frames
# (4:3 and 3:2), a portrait minority, a handful of squares/odd sizes.
# (w, h, weight) — weights approximate the real histogram closely enough
# to reproduce its bucket structure after scale_pad_geometry.
VAL2017_SHAPES = [
    (640, 480, 0.26), (640, 427, 0.18), (640, 426, 0.05), (640, 425, 0.03),
    (480, 640, 0.08), (427, 640, 0.09), (426, 640, 0.02), (425, 640, 0.01),
    (640, 428, 0.02), (428, 640, 0.01), (640, 424, 0.01), (424, 640, 0.01),
    (500, 375, 0.035), (375, 500, 0.015), (500, 333, 0.02), (333, 500, 0.01),
    (640, 360, 0.02), (360, 640, 0.01), (640, 512, 0.02), (512, 640, 0.01),
    (612, 612, 0.015), (640, 640, 0.01), (500, 500, 0.005),
    (640, 478, 0.01), (478, 640, 0.005), (640, 457, 0.01), (457, 640, 0.005),
    (577, 640, 0.005), (640, 577, 0.01), (320, 240, 0.005), (240, 320, 0.005),
    # long tail of one-off resolutions (val2017 has ~100 unique shapes)
    ("odd", "odd", 0.05),
]

# people-per-image profile: val2017 person images average ~2.7 annotated
# people with a crowded tail (up to dozens); capped at the renderer's 32
PEOPLE_COUNTS = [1, 2, 3, 4, 5, 6, 8, 10, 13, 16, 20]
PEOPLE_WEIGHTS = [.32, .24, .14, .09, .06, .05, .04, .03, .015, .01, .005]


def sample_shape(rng):
    weights = np.array([w for _, _, w in VAL2017_SHAPES])
    idx = rng.choice(len(VAL2017_SHAPES), p=weights / weights.sum())
    w, h, _ = VAL2017_SHAPES[idx]
    if w == "odd":
        w = int(rng.randint(200, 641))
        h = int(rng.randint(150, 641))
    return int(w), int(h)


def write_set(out_dir, n_images, seed=0, jpeg_quality=95):
    from rtpose_tpu_torch.data.imwrite import write_bgr

    img_dir = os.path.join(out_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    images, annotations = [], []
    ann_id = 1
    t0 = time.perf_counter()
    for img_id in range(1, n_images + 1):
        w, h = sample_shape(rng)
        n_people = int(rng.choice(PEOPLE_COUNTS,
                                  p=np.array(PEOPLE_WEIGHTS)
                                  / sum(PEOPLE_WEIGHTS)))
        img, kps = render_scene(rng, n_people=n_people, height=h, width=w)
        fname = f"{img_id:012d}.jpg"
        write_bgr(os.path.join(img_dir, fname), img, quality=jpeg_quality)
        images.append({"id": img_id, "file_name": fname,
                       "height": h, "width": w})
        for person in kps:
            ann = person_to_coco_annotation(person, img_id, ann_id)
            if ann is None:
                continue
            annotations.append(ann)
            ann_id += 1
        if img_id % 500 == 0:
            print(f"rendered {img_id}/{n_images} "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
    ann_file = os.path.join(out_dir, "annotations.json")
    with open(ann_file, "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": 1, "name": "person"}]}, f)
    print(f"wrote {n_images} images / {len(annotations)} annotations "
          f"to {out_dir} in {time.perf_counter() - t0:.0f}s")
    return img_dir, ann_file


def expected_buckets(ann_file, input_size, pad_factor):
    """The number of padded-shape buckets ``scale_pad_geometry`` gives
    the set's images (the eval harness's key)."""
    from rtpose_tpu_torch.infer.preprocess import scale_pad_geometry

    with open(ann_file) as f:
        images = json.load(f)["images"]
    return len({scale_pad_geometry(im["height"], im["width"], input_size,
                                   pad_factor)[3:] for im in images})


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=os.path.join(
        ROOT, "rtpose_tpu_torch", "build", "cocoval_synth"))
    ap.add_argument("--n", type=int, default=5000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reuse", action="store_true",
                    help="keep a set already written under --out with "
                         "the same --n and --seed")
    ap.add_argument("--eval", action="store_true",
                    help="then run the eval CLI's main() on the set")
    ap.add_argument("--weight", default=None)
    ap.add_argument("--stages", type=int, default=6)
    ap.add_argument("--input-size", type=int, default=368)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--pad-to", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    stamp_file = os.path.join(args.out, "stamp.json")
    stamp = {"n": args.n, "seed": args.seed}
    ann_file = os.path.join(args.out, "annotations.json")
    img_dir = os.path.join(args.out, "images")
    have = None
    if args.reuse and os.path.isfile(stamp_file):
        with open(stamp_file) as f:
            have = json.load(f)
    t0 = time.perf_counter()
    if have == stamp and os.path.isfile(ann_file):
        print(f"reusing the set under {args.out}", flush=True)
    else:
        img_dir, ann_file = write_set(args.out, args.n, seed=args.seed)
        with open(stamp_file, "w") as f:
            json.dump(stamp, f)
    write_s = time.perf_counter() - t0
    if not args.eval:
        return None

    import torch

    from rtpose_tpu_torch.evalx.__main__ import main as evalx_main
    from rtpose_tpu_torch.ops import kernels

    sys.argv = ["evalx", "--image-dir", img_dir, "--ann", ann_file,
                "--preprocess", "vgg", "--batch", str(args.batch),
                "--stages", str(args.stages), "--input-size",
                str(args.input_size), "--pad-to", str(args.pad_to),
                "--device", args.device]
    if args.weight:
        sys.argv += ["--weight", args.weight]
    kernels.reset_launch_counts()
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        stats = evalx_main()
    wall = time.perf_counter() - t1
    summary = {"set_images": args.n, "write_s": round(write_s, 1),
               "eval_wall_s": round(wall, 2),
               "img_per_s": round(args.n / wall, 2),
               "pad_to": args.pad_to,
               "expected_buckets": expected_buckets(
                   ann_file, args.input_size, args.pad_to or 8),
               "weight": args.weight or "seeded",
               **{k: (round(float(v), 4) if isinstance(v, float) else v)
                  for k, v in stats.items()}}
    if torch.device(args.device).type == "cuda":
        summary["card"] = torch.cuda.get_device_name(0)
        summary["launches"] = kernels.launch_counts()
    print("SUMMARY", json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
