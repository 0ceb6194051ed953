"""LR scheduling and phase control (port of rtpose_tpu/train/schedule.py).

- ReduceLROnPlateau (reference train/train_VGG19.py:332: factor 0.8,
  patience 5, cooldown 3, threshold 1e-4 rel, driven by val loss);
- the two-phase freeze: the pretrained backbone convs are frozen for the
  first N epochs, then released (reference train_VGG19.py:305-330).  In
  the port the freeze is a set of parameter names whose gradients the
  trainer zeroes.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Set


@dataclasses.dataclass
class ReduceLROnPlateau:
    lr: float
    factor: float = 0.8
    patience: int = 5
    cooldown: int = 3
    min_lr: float = 1e-8
    threshold: float = 1e-4
    threshold_mode: str = "rel"
    best: float = float("inf")
    num_bad: int = 0
    cooldown_left: int = 0

    def _improved(self, metric: float) -> bool:
        # torch semantics (threshold=1e-4, threshold_mode='rel'):
        # micro-improvements do not reset the bad-epoch counter
        if self.threshold_mode == "rel":
            return metric < self.best * (1.0 - self.threshold)
        return metric < self.best - self.threshold

    def step(self, metric: float) -> float:
        """Feed a validation metric (lower is better); returns the lr.

        torch's order of operations: the cooldown decrements every epoch
        and suppresses bad-epoch counting while it lasts.
        """
        if self._improved(metric):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.cooldown_left > 0:
            self.cooldown_left -= 1
            self.num_bad = 0
        if self.num_bad > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.num_bad = 0
            self.cooldown_left = self.cooldown
        return self.lr

    def state_dict(self) -> dict:
        return dataclasses.asdict(self)

    def load_state_dict(self, d: dict) -> None:
        for k, v in d.items():
            setattr(self, k, v)


def freeze_mask(param_names: Iterable[str], frozen_modules: Iterable[str],
                *, frozen: bool) -> Set[str]:
    """Names of the parameters whose gradients are zeroed in phase 1.

    frozen_modules: module names (``VGG19RTPose.pretrained_conv_names()``);
    every parameter under one of them is frozen while `frozen` is True.
    """
    if not frozen:
        return set()
    prefixes = tuple(f"{m}." for m in frozen_modules)
    return {n for n in param_names if n.startswith(prefixes)}
