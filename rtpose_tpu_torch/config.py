"""Typed configuration (a copy of rtpose_tpu/config.py, which the port may
not import; tests/test_torch_train.py holds the two equal).

One dataclass tree in place of the reference's yacs tree
(lib/config/default.py:10-137).  YAML or JSON experiment overlays
(experiments/vgg19_368x368_sgd.yaml) load through :func:`load_config`;
``yaml`` is imported only for a file that is not JSON.  Field comments
that name the TPU describe the JAX package's defaults; the port reads the
same fields (``model.dtype`` "bfloat16" is the compute type on the card).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


@dataclass
class ModelConfig:
    name: str = "vgg19"            # model family (see rtpose_tpu_torch.models.get_model)
    num_keypoints: int = 18
    num_limbs: int = 19
    downsample: int = 8            # output stride (reference MODEL.DOWNSAMPLE)
    num_stages: int = 6            # refinement stages for the CPM-style heads
    dtype: str = "bfloat16"        # compute dtype on TPU ("float32" for parity tests)
    param_dtype: str = "float32"
    init_scheme: str = "reference"  # "reference" = N(0,.01) (pairs with a
                                    # pretrained trunk, rtpose_vgg.py:200-206);
                                    # "scratch" = He re-init for from-scratch
                                    # training (models.common.he_reinit)


@dataclass
class DatasetConfig:
    root: str = ""
    train_image_dir: str = ""
    train_annotations: List[str] = field(default_factory=list)
    val_image_dir: str = ""
    val_annotations: str = ""
    image_size: int = 368          # square train crop / eval short side
    scale_min: float = 0.5         # RescaleRelative range (reference train_VGG19.py:127)
    scale_max: float = 1.0
    hflip_prob: float = 0.5
    rotate_degrees: float = 0.0    # 40.0 enables RandomRotate (reference transforms.py:403)
    sigma: float = 7.0             # GT heatmap gaussian sigma (reference datasets.py:285)
    limb_width: float = 1.0        # GT PAF half-width in grid units (reference paf.py:22)


@dataclass
class TrainConfig:
    batch_size: int = 72           # global batch (reference train_VGG19.py:37)
    lr: float = 1.0                # SGD lr (reference train_VGG19.py:39)
    momentum: float = 0.9
    weight_decay: float = 0.000
    nesterov: bool = True
    epochs: int = 140
    freeze_base_epochs: int = 5    # two-phase schedule (reference train_VGG19.py:305-330)
    lr_factor: float = 0.8         # ReduceLROnPlateau (reference train_VGG19.py:332)
    lr_patience: int = 5
    lr_cooldown: int = 3
    clip_grad_norm: float = 0.0    # >0: optax.clip_by_global_norm before SGD
                                   # (from-scratch runs; reference has none)
    grad_accum_steps: int = 1      # working version of the reference's unused STRIDE_APPLY
    masked_loss: bool = False      # crowd-region masked MSE (reference train_SH.py:80-126)
    checkpoint_dir: str = "checkpoints"
    resume: bool = False
    keep_checkpoints: int = 3
    checkpoint_every_steps: int = 0  # >0: mid-epoch elastic checkpoints
    seed: int = 0
    print_freq: int = 20
    data_workers: int = 8
    data_loader: str = "pil"       # "pil" (any transform pipeline) |
                                   # "native" (C++ imgpipe pool, default aug
                                   # family only, uint8 wire format — 4x
                                   # fewer H2D bytes, GIL-free scaling)


@dataclass
class TestConfig:
    thresh_heatmap: float = 0.1    # NMS peak threshold (reference default.py:126)
    thresh_paf: float = 0.05       # per-sample PAF score threshold (reference default.py:127)
    num_intermed_pts: int = 10     # samples along candidate limb (reference default.py:128)
    flip: bool = True              # left/right flip TTA (README.md:26 — needed for 0.653)
    scales: Tuple[float, ...] = (1.0,)  # multi-scale TTA factors
    max_peaks_per_part: int = 32   # fixed K for on-device grouping
    max_people: int = 64           # fixed person rows for on-device assembly
    # person filters (reference pafprocess.h:9-10)
    min_part_cnt: int = 4
    min_human_score: float = 0.3
    # greedy connection vote threshold (reference pafprocess.h:8)
    thresh_vector_cnt: int = 6


@dataclass
class ParallelConfig:
    data_axis: str = "data"        # mesh axis for batch sharding
    model_axis: str = "model"      # reserved for tensor parallelism
    num_data: int = -1             # -1 = all visible devices
    num_model: int = 1


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    test: TestConfig = field(default_factory=TestConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, default=list)


def _apply_tree(obj: Any, tree: Dict[str, Any], path: str = "") -> None:
    for key, value in tree.items():
        k = key.lower()
        if not hasattr(obj, k):
            raise KeyError(f"unknown config key: {path}{key}")
        cur = getattr(obj, k)
        if dataclasses.is_dataclass(cur) and isinstance(value, dict):
            _apply_tree(cur, value, path=f"{path}{key}.")
        else:
            if isinstance(cur, tuple) and isinstance(value, list):
                value = tuple(value)
            setattr(obj, k, value)


def apply_overrides(cfg: Config, overrides: Dict[str, Any]) -> Config:
    """Apply a (possibly nested) dict of overrides in place; returns cfg."""
    _apply_tree(cfg, overrides)
    return cfg


def apply_dotlist(cfg: Config, dotlist: List[str]) -> Config:
    """Apply 'a.b.c=value' CLI-style overrides (the yacs opts analogue)."""
    for item in dotlist:
        key, _, raw = item.partition("=")
        node: Any = cfg
        parts = key.strip().lower().split(".")
        for p in parts[:-1]:
            node = getattr(node, p)
        cur = getattr(node, parts[-1])
        try:
            value = json.loads(raw)
        except (json.JSONDecodeError, TypeError):
            # yacs-style Python literals (True/False/None) are not JSON;
            # accept them rather than silently assigning the truthy STRING
            # "False" to a bool field
            literals = {"True": True, "False": False, "None": None}
            value = literals.get(raw.strip(), raw)
        if isinstance(cur, tuple) and isinstance(value, list):
            value = tuple(value)
        # type-check against the existing field: a malformed value must
        # fail loudly, not silently replace an int/float/bool with a str
        if (cur is not None and value is not None
                and not isinstance(cur, str) and isinstance(value, str)):
            raise SystemExit(
                f"--set {key}: cannot parse {raw!r} as "
                f"{type(cur).__name__} (current value {cur!r})")
        if isinstance(cur, bool) and not isinstance(value, bool):
            raise SystemExit(
                f"--set {key}: expected a boolean, got {raw!r}")
        if isinstance(cur, float) and isinstance(value, int):
            value = float(value)
        setattr(node, parts[-1], value)
    return cfg


def load_config(path: Optional[str] = None,
                overrides: Optional[Dict[str, Any]] = None) -> Config:
    """Build a Config, optionally overlaying a YAML/JSON experiment file."""
    cfg = Config()
    if path:
        with open(path) as f:
            text = f.read()
        try:
            tree = json.loads(text)
        except json.JSONDecodeError:
            import yaml  # lazy: only needed for yaml experiment files
            tree = yaml.safe_load(text)
        apply_overrides(cfg, tree)
    if overrides:
        apply_overrides(cfg, overrides)
    return cfg
