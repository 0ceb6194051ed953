#!/usr/bin/env python3
"""The training ``Loader``'s start at COCO train2017's annotation size,
with nothing downloaded.

Writes a ``person_keypoints`` file at train2017's counts (by default
118,287 images; 262,465 person annotations, 149,813 of them with
keypoints, on 56,599 images; every annotation with a segmentation polygon
of 20-50 points, as COCO's carry them) whose images all name a few
640x480 JPEGs written by ``utils/synth_coco.py``.  Then measures, in the
process that runs it:

- the parsed file (``CocoJson``) and the ``CocoKeypoints`` over it: build
  seconds, pickled bytes and pickling seconds (a forkserver worker is
  sent its dataset pickled), and this process's RSS;
- one epoch's start of the flagship's ``Loader`` (batch 72, 368 px, W
  worker processes): seconds to the first batch and to W batches, and
  each worker's RSS and anonymous RSS after them, for the dataset as it
  is (twice) and, between the two, for one that also carries the parsed
  file; after an epoch of one image that starts the forkserver.

Prints one JSON line (``SCALE {...}``).  The work directory is the
git-ignored ``rtpose_tpu_torch/build/loader_scale``.

    python3 scripts/torch_loader_scale.py
    python3 scripts/torch_loader_scale.py --images 2000 --workers 2
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# person_keypoints_train2017.json
TRAIN2017 = dict(images=118287, annotations=262465, labelled=149813,
                 labelled_images=56599, person_images=64115)
JPEGS = 8


def write_annotations(path: str, files, images: int, annotations: int,
                      labelled: int, labelled_images: int,
                      person_images: int, seed: int = 0) -> None:
    """A COCO ``person_keypoints`` file at the given counts: `labelled`
    annotations with keypoints spread over the first `labelled_images`
    images (at least one each), the rest without keypoints (1 in 100 of
    them crowds) over the first `person_images`; image ``i`` names
    ``files[i % len(files)]``."""
    rng = np.random.default_rng(seed)
    owners = np.concatenate([
        np.arange(labelled_images),
        rng.integers(0, labelled_images, labelled - labelled_images),
        rng.integers(0, person_images, annotations - labelled)])
    anns = []
    for k, owner in enumerate(owners):
        x, y = rng.uniform(0, 480), rng.uniform(0, 320)
        w, h = rng.uniform(20, 160), rng.uniform(40, 160)
        pts = rng.integers(20, 51)
        seg = np.stack([rng.uniform(x, x + w, pts),
                        rng.uniform(y, y + h, pts)], 1).round(2)
        kp = np.zeros((17, 3), int)
        if k < labelled:
            seen = rng.random(17) < 0.6
            seen[rng.integers(17)] = True
            kp[seen] = np.stack([rng.integers(int(x), int(x + w) + 1, 17),
                                 rng.integers(int(y), int(y + h) + 1, 17),
                                 np.full(17, 2)], 1)[seen]
        anns.append({
            "segmentation": [seg.reshape(-1).tolist()],
            "num_keypoints": int((kp[:, 2] > 0).sum()),
            "area": round(w * h * 0.6, 4),
            "iscrowd": int(k >= labelled and k % 100 == 0),
            "keypoints": kp.reshape(-1).tolist(),
            "image_id": int(owner) + 1,
            "bbox": [round(v, 2) for v in (x, y, w, h)],
            "category_id": 1, "id": k + 1})
    imgs = [{"license": 1, "file_name": files[i % len(files)],
             "coco_url": "", "height": 480, "width": 640,
             "date_captured": "2013-11-14 16:28:13", "flickr_url": "",
             "id": i + 1} for i in range(images)]
    with open(path, "w") as f:
        json.dump({"images": imgs, "annotations": anns,
                   "categories": [{"id": 1, "name": "person",
                                   "supercategory": "person"}]}, f)


class CarryingJson:
    """A dataset that also holds the parsed annotation file, as a
    ``CocoKeypoints`` that kept its ``CocoJson`` would."""

    def __init__(self, dataset, coco):
        self.dataset, self.coco = dataset, coco

    def __len__(self):
        return len(self.dataset)

    def get(self, index, rng):
        return self.dataset.get(index, rng)


def memory_mb(pid: int):
    """(RSS, anonymous RSS) MB of process `pid`, from /proc status; the
    anonymous part holds what the process unpickled, and the pages it
    shares with the forkserver as copy-on-write."""
    with open(f"/proc/{pid}/status") as f:
        kb = {line.split(":")[0]: int(line.split()[1])
              for line in f if line.rstrip().endswith("kB")}
    anon = kb.get("RssAnon")
    return (round(kb["VmRSS"] / 1024, 1),
            None if anon is None else round(anon / 1024, 1))


def grandchildren():
    """This process's children's children: the forkserver's workers."""
    parent = {}
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open(f"/proc/{d}/stat") as f:
                    parent[int(d)] = int(f.read().rsplit(")", 1)[1].split()[1])
            except OSError:
                continue
    kids = {p for p, pp in parent.items() if pp == os.getpid()}
    return sorted(p for p, pp in parent.items() if pp in kids)


def epoch_start(dataset, workers: int, batch: int):
    """Seconds to the first batch and to `workers` batches of a new
    Loader epoch, and its workers' (RSS, anonymous RSS) MB."""
    from rtpose_tpu_torch.data.dataset import Loader

    t0 = time.perf_counter()
    it = iter(Loader(dataset, batch, num_workers=workers, seed=0))
    next(it)
    first = time.perf_counter() - t0
    for _ in range(workers - 1):
        next(it)
    whole = time.perf_counter() - t0
    mem = [memory_mb(p) for p in grandchildren()]
    del it
    return {"first_batch_s": round(first, 3),
            "w_batches_s": round(whole, 3),
            "workers_rss_mb": [m[0] for m in mem],
            "workers_anon_mb": [m[1] for m in mem]}


def main() -> None:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--images", type=int, default=TRAIN2017["images"],
                    help="fewer images cut every count in proportion")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--batch", type=int, default=72)
    args = ap.parse_args()
    scale = min(1.0, args.images / TRAIN2017["images"])
    counts = {k: max(1, round(v * scale)) for k, v in TRAIN2017.items()}

    from rtpose_tpu_torch.data.coco_json import CocoJson
    from rtpose_tpu_torch.data.dataset import CocoKeypoints
    from rtpose_tpu_torch.utils.synth_coco import (training_frames,
                                                   write_synth_coco)

    work = os.path.join(ROOT, "rtpose_tpu_torch", "build", "loader_scale")
    shutil.rmtree(work, ignore_errors=True)
    img_dir, _ = write_synth_coco(work, training_frames(
        np.random.RandomState(0), [(480, 640)] * JPEGS))
    ann = os.path.join(work, "train.json")
    t0 = time.perf_counter()
    write_annotations(ann, sorted(os.listdir(img_dir)), **counts)
    out = {"counts": counts, "file_mb": round(os.path.getsize(ann) / 2**20, 1),
           "write_s": round(time.perf_counter() - t0, 1),
           "nproc": len(os.sched_getaffinity(0)), "workers": args.workers}

    def timed(fn):
        t = time.perf_counter()
        val = fn()
        return val, round(time.perf_counter() - t, 3)

    coco, out["cocojson_build_s"] = timed(lambda: CocoJson(ann))
    ds, out["dataset_build_s"] = timed(
        lambda: CocoKeypoints(img_dir, ann, input_size=368))
    out["dataset_images"] = len(ds)
    for name, obj in (("cocojson", coco), ("dataset", ds)):
        blob, out[f"{name}_pickle_s"] = timed(lambda: pickle.dumps(obj, -1))
        out[f"{name}_pickle_mb"] = round(len(blob) / 2**20, 1)
        del blob
    out["main_rss_mb"] = memory_mb(os.getpid())[0]
    # the process's first epoch also starts the forkserver
    out["first_epoch_1_worker_1_image_s"] = epoch_start(ds, 1, 1)[
        "first_batch_s"]
    out["loader"] = [epoch_start(ds, args.workers, args.batch)]
    out["loader_carrying_json"] = epoch_start(CarryingJson(ds, coco),
                                              args.workers, args.batch)
    out["loader"].append(epoch_start(ds, args.workers, args.batch))
    try:
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        out["card"] = None
    shutil.rmtree(work, ignore_errors=True)
    print("SCALE", json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
