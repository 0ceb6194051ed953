"""Minimal COCO keypoint annotation reader (no pycocotools dependency).

A copy of ``rtpose_tpu/data/coco_json.py`` (json and collections only),
kept here so the port imports nothing of the JAX package;
tests/test_torch_isolation.py holds its code equal to the original's.
Covers the API surface the reference uses from pycocotools.coco.COCO
(reference lib/datasets/datasets.py:113-127, evaluate/coco_eval.py:250-252):
image ids for the person category, annotation lookup by image, image
metadata.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Any, Dict, List, Optional


class CocoJson:
    def __init__(self, ann_file: str):
        with open(ann_file) as f:
            data = json.load(f)
        self.dataset = data
        self.images: Dict[int, dict] = {im["id"]: im
                                        for im in data.get("images", [])}
        self.cats: Dict[int, dict] = {c["id"]: c
                                      for c in data.get("categories", [])}
        self.anns: Dict[int, dict] = {}
        self._img_to_anns: Dict[int, List[dict]] = defaultdict(list)
        for ann in data.get("annotations", []):
            self.anns[ann["id"]] = ann
            self._img_to_anns[ann["image_id"]].append(ann)

    def cat_ids(self, name: Optional[str] = None) -> List[int]:
        if name is None:
            return sorted(self.cats)
        return [cid for cid, c in self.cats.items() if c.get("name") == name]

    def img_ids(self, cat_ids: Optional[List[int]] = None) -> List[int]:
        if not cat_ids:
            return sorted(self.images)
        wanted = set(cat_ids)
        ids = {a["image_id"] for a in self.anns.values()
               if a.get("category_id") in wanted}
        return sorted(ids)

    def annotations(self, image_id: int,
                    cat_ids: Optional[List[int]] = None) -> List[dict]:
        anns = self._img_to_anns.get(image_id, [])
        if cat_ids:
            wanted = set(cat_ids)
            anns = [a for a in anns if a.get("category_id") in wanted]
        return anns

    def image_info(self, image_id: int) -> dict:
        return self.images[image_id]

    def ids_with_keypoints(self, cat_ids: Optional[List[int]] = None
                           ) -> List[int]:
        """Image ids having at least one labeled keypoint (reference
        datasets.py:140-154)."""
        out = []
        for img_id in self.img_ids(cat_ids or self.cat_ids("person")):
            for ann in self.annotations(img_id, cat_ids):
                kps = ann.get("keypoints") or []
                if any(v > 0 for v in kps[2::3]):
                    out.append(img_id)
                    break
        return out
