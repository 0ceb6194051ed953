"""Skeleton tables of the 18-part rtpose body model that serving, the
training loader and the COCO evaluation need, and ``CocoPart``, the enum
view of the part names.

A copy of the serving and COCO-17 subset of ``rtpose_tpu/skeleton.py``,
kept here so the port imports nothing of the JAX package;
tests/test_torch_isolation.py checks every name against the original.
"""

import enum

import numpy as np

PART_NAMES = (
    "nose", "neck", "right_shoulder", "right_elbow", "right_wrist",
    "left_shoulder", "left_elbow", "left_wrist", "right_hip", "right_knee",
    "right_ankle", "left_hip", "left_knee", "left_ankle", "right_eye",
    "left_eye", "right_ear", "left_ear",
)
NUM_PARTS = len(PART_NAMES)          # 18
NUM_HEATMAPS = NUM_PARTS + 1         # +1 background channel
BACKGROUND_CHANNEL = NUM_PARTS

_IDX = {name: i for i, name in enumerate(PART_NAMES)}

# enum view of the parts and the background channel (reference
# lib/utils/common.py:5-24)
CocoPart = enum.IntEnum(
    "CocoPart", {**{n: i for i, n in enumerate(PART_NAMES)},
                 "background": len(PART_NAMES)})


def _mirror_name(name: str) -> str:
    for a, b in (("left_", "right_"), ("right_", "left_")):
        if name.startswith(a):
            return b + name[len(a):]
    return name


# part index -> mirrored part index
FLIP_PART = tuple(_IDX[_mirror_name(n)] for n in PART_NAMES)

# limbs in PAF-channel order: limb i occupies PAF channels (2i, 2i+1)
LIMBS = tuple((_IDX[a], _IDX[b]) for a, b in (
    ("neck", "right_hip"), ("right_hip", "right_knee"),
    ("right_knee", "right_ankle"), ("neck", "left_hip"),
    ("left_hip", "left_knee"), ("left_knee", "left_ankle"),
    ("neck", "right_shoulder"), ("right_shoulder", "right_elbow"),
    ("right_elbow", "right_wrist"), ("right_shoulder", "right_eye"),
    ("neck", "left_shoulder"), ("left_shoulder", "left_elbow"),
    ("left_elbow", "left_wrist"), ("left_shoulder", "left_eye"),
    ("neck", "nose"), ("nose", "right_eye"), ("nose", "left_eye"),
    ("right_eye", "right_ear"), ("left_eye", "left_ear"),
))
NUM_LIMBS = len(LIMBS)               # 19
NUM_PAF_CHANNELS = 2 * NUM_LIMBS     # 38

# the order in which the assembler walks limbs (reference pafprocess.h)
GROUP_PAIRS = (
    (1, 2), (1, 5), (2, 3), (3, 4), (5, 6), (6, 7), (1, 8), (8, 9), (9, 10),
    (1, 11), (11, 12), (12, 13), (1, 0), (0, 14), (14, 16), (0, 15), (15, 17),
    (2, 16), (5, 17),
)
NUM_GROUP_PAIRS = len(GROUP_PAIRS)   # 19

# grouping pair -> (x, y) PAF channels
GROUP_PAIRS_NET = (
    (12, 13), (20, 21), (14, 15), (16, 17), (22, 23), (24, 25), (0, 1),
    (2, 3), (4, 5), (6, 7), (8, 9), (10, 11), (28, 29), (30, 31), (34, 35),
    (32, 33), (36, 37), (18, 19), (26, 27),
)

# pairs that may create a new person during assembly
NUM_SEED_PAIRS = 18

# heatmap channel c of the flipped image corresponds to channel FLIP_HEAT[c]
FLIP_HEAT = FLIP_PART + (BACKGROUND_CHANNEL,)


def _derive_flip_paf() -> tuple:
    limb_of = {frozenset(limb): i for i, limb in enumerate(LIMBS)}
    table = []
    for a, b in LIMBS:
        j = limb_of[frozenset((FLIP_PART[a], FLIP_PART[b]))]
        table.extend((2 * j, 2 * j + 1))
    return tuple(table)


FLIP_PAF = _derive_flip_paf()

# ---------------------------------------------------------------------------
# COCO-17 interchange.
# COCO annotation keypoint order (val2017 "person_keypoints" category).
# ---------------------------------------------------------------------------
COCO_PART_NAMES = (
    "nose", "left_eye", "right_eye", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip",
    "left_knee", "right_knee", "left_ankle", "right_ankle",
)

# COCO-17 slot -> our 18-part index (reference evaluate/coco_eval.py:52)
ORDER_COCO = tuple(_IDX[n] for n in COCO_PART_NAMES)

# (COCO-17 + synthesized neck at slot 17) -> our 18-part order
# (reference lib/datasets/datasets.py:241-242)
COCO_TO_OURS = tuple(
    (tuple(COCO_PART_NAMES) + ("neck",)).index(n) for n in PART_NAMES
)

# Per-keypoint OKS sigmas in COCO-17 order (pycocotools defaults).
COCO_SIGMAS = np.array([
    .026, .025, .025, .035, .035, .079, .079, .072, .072,
    .062, .062, .107, .107, .087, .087, .089, .089,
], dtype=np.float64)

# ---------------------------------------------------------------------------
# Rendering (reference lib/utils/common.py:276-284): drop the two
# shoulder-ear pairs when drawing.
# ---------------------------------------------------------------------------
RENDER_PAIRS = GROUP_PAIRS[:17]
PART_COLORS = (
    (255, 0, 0), (255, 85, 0), (255, 170, 0), (255, 255, 0), (170, 255, 0),
    (85, 255, 0), (0, 255, 0), (0, 255, 85), (0, 255, 170), (0, 255, 255),
    (0, 170, 255), (0, 85, 255), (0, 0, 255), (85, 0, 255), (170, 0, 255),
    (255, 0, 255), (255, 0, 170), (255, 0, 85),
)
