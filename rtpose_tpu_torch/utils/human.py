"""Pose data model: Human / BodyPart (a copy of rtpose_tpu/utils/human.py,
reference lib/utils/common.py:27-278), kept here so the port imports
nothing of the JAX package; tests/test_torch_isolation.py holds its code
equal to the original's.

The decode emits fixed-shape arrays (``ops.grouping.People``); this
module is the user-facing object view plus the derived boxes the
reference exposes (face box, upper-body box, which are dead or broken
code paths upstream, common.py:69-147; implemented working here).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from ..skeleton import PART_NAMES


@dataclasses.dataclass
class BodyPart:
    part_idx: int
    x: float          # normalized [0, 1)
    y: float
    score: float

    @property
    def name(self) -> str:
        return PART_NAMES[self.part_idx]

    def __repr__(self):
        return (f"BodyPart({self.name} x={self.x:.3f} y={self.y:.3f} "
                f"score={self.score:.2f})")


@dataclasses.dataclass
class Human:
    body_parts: Dict[int, BodyPart]
    score: float = 0.0

    @classmethod
    def from_dict(cls, person: dict) -> "Human":
        parts = {p: BodyPart(p, x, y, s)
                 for p, (x, y, s) in person["parts"].items()}
        return cls(body_parts=parts, score=person["score"])

    def part_count(self) -> int:
        return len(self.body_parts)

    def get_max_score(self) -> float:
        return max((bp.score for bp in self.body_parts.values()),
                   default=0.0)

    def bounding_box(self, img_w: int, img_h: int
                     ) -> Optional[Tuple[int, int, int, int]]:
        """(x, y, w, h) of all detected parts in pixels."""
        if not self.body_parts:
            return None
        xs = [bp.x * img_w for bp in self.body_parts.values()]
        ys = [bp.y * img_h for bp in self.body_parts.values()]
        x0, x1 = min(xs), max(xs)
        y0, y1 = min(ys), max(ys)
        return int(x0), int(y0), int(x1 - x0), int(y1 - y0)

    def get_face_box(self, img_w: int, img_h: int,
                     mode: int = 0) -> Optional[dict]:
        """Face box from nose/eyes/ears (working version of the reference's
        broken common.py:69-147)."""
        face_parts = [bp for i, bp in self.body_parts.items()
                      if i in (0, 14, 15, 16, 17)]
        if len(face_parts) < 2:
            return None
        xs = [bp.x * img_w for bp in face_parts]
        ys = [bp.y * img_h for bp in face_parts]
        cx = sum(xs) / len(xs)
        cy = sum(ys) / len(ys)
        size = max(max(xs) - min(xs), max(ys) - min(ys)) * 2.0
        size = max(size, 1.0)
        return {"x": cx, "y": cy, "w": size, "h": size}

    def get_upper_body_box(self, img_w: int, img_h: int
                           ) -> Optional[dict]:
        """Box over head + torso parts (nose..hips)."""
        idxs = (0, 1, 2, 5, 8, 11, 14, 15, 16, 17)
        parts = [bp for i, bp in self.body_parts.items() if i in idxs]
        if len(parts) < 3:
            return None
        xs = [bp.x * img_w for bp in parts]
        ys = [bp.y * img_h for bp in parts]
        x0, x1 = min(xs), max(xs)
        y0, y1 = min(ys), max(ys)
        return {"x": (x0 + x1) / 2, "y": (y0 + y1) / 2,
                "w": x1 - x0, "h": y1 - y0}


def humans_from_people(people_list) -> list:
    return [Human.from_dict(p) for p in people_list]
