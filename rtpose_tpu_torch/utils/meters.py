"""Metrics: running averages, step timing and JSONL logging
(``AverageMeter``, ``StepTimer`` and ``MetricLogger`` copied from
rtpose_tpu/utils/meters.py, which the port may not import).

The reference's observability is stdout AverageMeter prints
(train/train_VGG19.py:222-229,280-295) and tensorboardX scalars in the alt
trainers (train_SH.py:54,305).  Here: the same meters, a JSONL metric log,
and a tensorboardX mirror when that package is importable.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class AverageMeter:
    """Running average (reference train/train_VGG19.py:280-295)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = self.sum = self.count = 0.0

    def update(self, val, n=1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class StepTimer:
    """Data-time / step-time split, like the reference's batch_time /
    data_time meters."""

    def __init__(self):
        self.data = AverageMeter()
        self.step = AverageMeter()
        self._tic = time.time()

    def data_loaded(self):
        now = time.time()
        self.data.update(now - self._tic)
        self._tic = now

    def step_done(self):
        now = time.time()
        self.step.update(now - self._tic)
        self._tic = now


class MetricLogger:
    """Append-only JSONL metrics + optional tensorboardX mirror."""

    def __init__(self, log_dir: Optional[str] = None,
                 tensorboard: bool = False):
        self.log_dir = log_dir
        self._f = None
        self._tb = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._f = open(os.path.join(log_dir, "metrics.jsonl"), "a")
            if tensorboard:
                try:
                    from tensorboardX import SummaryWriter
                    self._tb = SummaryWriter(log_dir)
                except ImportError:
                    pass

    def log(self, step: int, metrics: Dict[str, float],
            prefix: str = "") -> None:
        rec = {"step": step, "time": time.time()}
        rec.update({(prefix + k): float(v) for k, v in metrics.items()})
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        if self._tb:
            for k, v in metrics.items():
                self._tb.add_scalar(prefix + k, float(v), step)

    def close(self):
        if self._f:
            self._f.close()
        if self._tb:
            self._tb.close()
