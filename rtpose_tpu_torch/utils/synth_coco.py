"""Synthetic COCO keypoint sets and an oracle "model" for closed-loop eval
checks without COCO data or trained weights.

Random weights find no peaks, so every results list would be empty and a
comparison of results passes for nothing.  Instead :class:`OracleMaps`
answers each frame with the ground-truth maps of the people annotated in
it (the host GT oracle ``data.gt.ground_truth_maps``), keyed by the shape
of the network input it is given, so the eval must find those people and
score a high AP.  Frames whose inputs share a padded shape share their
people.  :func:`write_synth_coco` writes the JPEGs (Pillow) and the
``person_keypoints`` JSON.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, Sequence, Tuple

import numpy as np
import torch

from ..data.gt import ground_truth_maps
from ..data.imread_fixtures import render_scene
from ..infer.preprocess import scale_pad_geometry
from ..models.common import ModelOutput
from ..skeleton import NUM_PARTS, ORDER_COCO
from .synth import _TEMPLATE

Shape = Tuple[int, int]


def spread_people(rng, n: int, h: int, w: int) -> np.ndarray:
    """(n, 18, 3) upright people side by side inside an (h, w) frame, pixel
    coordinates, every part visible (v = 2)."""
    kps = np.zeros((n, NUM_PARTS, 3))
    s = min(h * 0.8, w / n * 0.8)
    for i in range(n):
        cx, cy = (i + 0.5) / n * w, h / 2
        for part, (tx, ty) in _TEMPLATE.items():
            kps[i, part] = (cx + (tx - 0.5) * s + rng.normal(0, 1),
                            cy + (ty - 0.5) * s + rng.normal(0, 1), 2)
    np.clip(kps[..., 0], 0, w - 1, out=kps[..., 0])
    np.clip(kps[..., 1], 0, h - 1, out=kps[..., 1])
    return kps


def coco_annotation(ann_id: int, image_id: int, person: np.ndarray) -> dict:
    """One (18, 3) person as a COCO ``person_keypoints`` annotation."""
    coco_kp = np.zeros((17, 3))
    for slot, part in enumerate(ORDER_COCO):
        coco_kp[slot] = (person[part, 0], person[part, 1], 2)
    xs, ys = coco_kp[:, 0], coco_kp[:, 1]
    w, h = float(xs.max() - xs.min()), float(ys.max() - ys.min())
    return {"id": ann_id, "image_id": image_id, "category_id": 1,
            "keypoints": [float(v) for v in coco_kp.reshape(-1)],
            "num_keypoints": 17, "area": w * h, "iscrowd": 0,
            "bbox": [float(xs.min()), float(ys.min()), w, h]}


def write_synth_coco(root: str, frames: Iterable[Tuple[int, int, np.ndarray]],
                     seed: int = 0) -> Tuple[str, str]:
    """Write one JPEG per ``(h, w, people)`` of `frames` (a rendered scene
    drawn from `seed` and the image id; people (n, 18, 3) in pixel
    coordinates) under ``root/images`` and their annotations as
    ``root/person_keypoints.json`` -> (image dir, annotation file)."""
    from PIL import Image

    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    images, annotations = [], []
    for img_id, (h, w, people) in enumerate(frames, start=1):
        name = f"{img_id:012d}.jpg"
        Image.fromarray(render_scene(seed + img_id, h, w)).save(
            os.path.join(img_dir, name), quality=90)
        images.append({"id": img_id, "file_name": name, "height": h,
                       "width": w})
        annotations += [coco_annotation(img_id * 100 + i, img_id, p)
                        for i, p in enumerate(people)]
    ann_file = os.path.join(root, "person_keypoints.json")
    with open(ann_file, "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": 1, "name": "person"}]}, f)
    return img_dir, ann_file


def oracle_maps(scenes: Dict[Shape, np.ndarray], input_size: int, *,
                pad_factor: int = 8, scales: Sequence[float] = (1.0,)
                ) -> Dict[Shape, Tuple[np.ndarray, np.ndarray]]:
    """Ground-truth maps of each raw frame shape's people (`scenes`: (h, w)
    -> (n, 18, 3) pixel keypoints) at every network input the pipeline
    gives that frame: {padded input (ph, pw): (heat, paf)}, fp32, at
    stride 8 with the training recipe's sigma 7, and 1e-5 noise that
    breaks the plateaus' ties.  Each scale's input is the
    frame scaled to a short side of ``max(pad_factor, round(input_size *
    s))`` (the pipelines' multi-scale sizes); its people are scaled with
    it.  Frames whose inputs share a padded shape must share people."""
    out: Dict[Shape, Tuple[np.ndarray, np.ndarray]] = {}
    for (h, w), people in scenes.items():
        for s in scales:
            size = max(pad_factor, int(round(input_size * s)))
            scale, _, _, ph, pw = scale_pad_geometry(h, w, size, pad_factor)
            kps = people.copy()
            kps[..., :2] = (kps[..., :2] + 0.5) * scale - 0.5
            heat, paf = ground_truth_maps(kps, input_y=ph, input_x=pw)
            rng = np.random.RandomState(ph * 100003 + pw)
            heat = heat + rng.normal(0, 1e-5, heat.shape)
            maps = (heat.astype(np.float32), paf.astype(np.float32))
            if (ph, pw) in out:
                if not all(np.array_equal(a, b)
                           for a, b in zip(out[(ph, pw)], maps)):
                    raise ValueError(f"frames with input {(ph, pw)} hold "
                                     f"different people")
            out[(ph, pw)] = maps
    return out


class OracleMaps(torch.nn.Module):
    """A stand-in for the network: each ``(B, ph, pw, 3)`` input batch is
    answered with the maps stored for ``(ph, pw)``, for every frame, as
    one stage (``ModelOutput`` layout)."""

    def __init__(self, maps: Dict[Shape, Tuple[np.ndarray, np.ndarray]]):
        super().__init__()
        self.shapes = sorted(maps)
        for (ph, pw), (heat, paf) in maps.items():
            self.register_buffer(f"heat_{ph}x{pw}", torch.from_numpy(heat))
            self.register_buffer(f"paf_{ph}x{pw}", torch.from_numpy(paf))

    def forward(self, x: torch.Tensor) -> ModelOutput:
        b, ph, pw = x.shape[0], x.shape[1], x.shape[2]
        if (ph, pw) not in self.shapes:
            raise KeyError(f"no oracle maps for input {(ph, pw)}")
        heat = getattr(self, f"heat_{ph}x{pw}")
        paf = getattr(self, f"paf_{ph}x{pw}")
        return ModelOutput(
            pafs=paf.expand(1, b, *paf.shape).contiguous(),
            heatmaps=heat.expand(1, b, *heat.shape).contiguous())


def compare_results(got, want) -> Tuple[float, float]:
    """Two COCO results lists of the same images -> (largest keypoint
    difference in px, largest score difference), people paired in their
    order per image.  Raises ValueError when an image's count of results
    differs."""
    def by_image(results):
        out: Dict[int, list] = {}
        for r in results:
            out.setdefault(r["image_id"], []).append(r)
        return out

    g, w = by_image(got), by_image(want)
    counts = {i: (len(g.get(i, [])), len(w.get(i, [])))
              for i in set(g) | set(w)}
    bad = {i: c for i, c in counts.items() if c[0] != c[1]}
    if bad:
        raise ValueError(f"results per image differ (got, want): {bad}")
    kp_err = score_err = 0.0
    for i in g:
        for a, b in zip(g[i], w[i]):
            kp_err = max(kp_err, float(np.abs(np.subtract(
                a["keypoints"], b["keypoints"])).max()))
            score_err = max(score_err, abs(a["score"] - b["score"]))
    return kp_err, score_err
