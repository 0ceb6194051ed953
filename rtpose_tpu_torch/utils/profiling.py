"""Profiling / tracing helpers (port of rtpose_tpu/utils/profiling.py).

The reference has no profiler integration (SURVEY.md §5, wall-clock
meters only).  Here: ``torch.profiler`` traces of the host and the card,
written as Chrome traces (open in Perfetto or ``chrome://tracing``),
named ranges inside them, and a wall-clock section timer that waits for
the card at each section's end, so a section's time holds its device
work.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional, Union

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the enclosed block with ``torch.profiler`` (host, and the
    card where CUDA is available) and write it to
    ``<log_dir>/trace.json`` (Chrome trace format).  Yields the
    profiler, whose ``key_averages()`` sum the time by op and kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named range inside a trace (a row of its own on the timeline)."""
    return torch.profiler.record_function(name)


class SectionTimer:
    """Host-side named section timing with summary().  With a CUDA
    `device`, each section ends with ``torch.cuda.synchronize(device)``,
    so its time holds the work it enqueued on the card."""

    def __init__(self, device: Optional[Union[str, torch.device]] = None):
        self.device = None if device is None else torch.device(device)
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device is not None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {"total_s": tot, "count": self.counts[name],
                   "mean_ms": 1000.0 * tot / self.counts[name]}
            for name, tot in self.totals.items()
        }
