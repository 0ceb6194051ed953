"""Checkpoints with resume and best tracking (port of
rtpose_tpu/train/checkpoint.py, on ``torch.save`` in place of orbax).

Layout under the directory, as in the JAX package: ``step_{:08d}.pt`` (the
trainer's state dict) beside ``step_{:08d}.meta.json``, and ``best.json``
naming the best step.  Epoch-end and mid-epoch saves share the global-step
namespace.  Every file is written to a temporary name and moved into place
with ``os.replace``, and the ``.meta.json`` goes last, so a checkpoint
that a crash cut short is never listed.  Garbage collection keeps the
newest `keep` steps and never deletes the best one.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import torch


def _atomic_write(path: str, write) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _write_json(path: str, obj: Dict[str, Any]) -> None:
    def write(tmp):
        with open(tmp, "w") as f:
            json.dump(obj, f)
    _atomic_write(path, write)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def save(self, state: Dict[str, Any], *, step: int, is_best: bool = False,
             meta: Optional[Dict[str, Any]] = None) -> str:
        """Write `state` (``Trainer.state_dict()``) as checkpoint `step`."""
        path = self._path(step)
        _atomic_write(path + ".pt", lambda tmp: torch.save(state, tmp))
        _write_json(path + ".meta.json", meta or {})
        if is_best:
            _write_json(os.path.join(self.directory, "best.json"),
                        {"step": step, **(meta or {})})
        self._gc()
        return path

    def _steps(self) -> List[int]:
        return sorted(int(name[len("step_"):-len(".meta.json")])
                      for name in os.listdir(self.directory)
                      if name.startswith("step_")
                      and name.endswith(".meta.json"))

    def _gc(self) -> None:
        best_step = self.best_step()
        for s in self._steps()[:-self.keep]:
            if s == best_step:
                continue
            for suffix in (".meta.json", ".pt"):   # unlist first
                p = self._path(s) + suffix
                if os.path.exists(p):
                    os.remove(p)

    def best_step(self) -> Optional[int]:
        best = os.path.join(self.directory, "best.json")
        if os.path.exists(best):
            with open(best) as f:
                return json.load(f).get("step")
        return None

    def restore(self, step: int, map_location: Any = "cpu"
                ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """(state, meta) of checkpoint `step`; tensors on `map_location`."""
        path = self._path(step)
        state = torch.load(path + ".pt", map_location=map_location,
                           weights_only=True)
        with open(path + ".meta.json") as f:
            meta = json.load(f)
        return state, meta

    def restore_latest(self, map_location: Any = "cpu"):
        steps = self._steps()
        if not steps:
            return None
        return self.restore(steps[-1], map_location)

    def restore_best(self, map_location: Any = "cpu"):
        step = self.best_step()
        if step is None:
            return self.restore_latest(map_location)
        return self.restore(step, map_location)


def best_model_state(directory: str) -> Dict[str, torch.Tensor]:
    """The model weights (``state["model"]``) of the best step under
    `directory`, or of the latest where no best is recorded, on the CPU.

    A directory of the JAX package's orbax checkpoints is not read here:
    export it to a reference-layout ``.pth`` with
    ``scripts/export_jax_checkpoint.py`` and load that file instead."""
    if not os.path.isdir(directory):
        raise FileNotFoundError(f"no checkpoint directory {directory}")
    mgr = CheckpointManager(directory)
    step = mgr.best_step()
    if step is None:
        steps = mgr._steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {directory}")
        step = steps[-1]
    path = mgr._path(step)
    if not os.path.exists(path + ".pt"):
        if os.path.isdir(path) or os.path.exists(path + ".npz"):
            raise ValueError(
                f"{path} is a JAX package (orbax) checkpoint, which the port "
                f"does not read: export it to a .pth with "
                f"scripts/export_jax_checkpoint.py and pass that file "
                f"(torch_weights, --weight)")
        raise FileNotFoundError(path + ".pt")
    state, _meta = mgr.restore(step)
    return state["model"]
