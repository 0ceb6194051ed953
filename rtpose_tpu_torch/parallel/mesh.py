"""The ``data`` x ``model`` mesh (port of rtpose_tpu/parallel/mesh.py).

The JAX package lays its devices out as a ``jax.sharding.Mesh`` and lets
XLA place the collectives.  Here a mesh is one of two things:

- over a process group (training): one rank per position, rank ``i`` at
  (``i // num_model``, ``i % num_model``), as ``mesh.py:30-33`` reshapes
  the device list.  The ranks of one model group see the same rows; the
  ``data`` group of a rank is the ranks with its model index, over which
  gradients and BatchNorm statistics are reduced, and its ``model`` group
  the ranks with its data index, over which a sharded convolution's
  channels are gathered.
- in one process without a process group (serving): a list of devices,
  one model replica each, over which ``PosePipeline(mesh=)`` splits a
  batch.  A device may repeat (two replicas on one card).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .distributed import rank_and_world

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(eq=False)
class Mesh:
    num_data: int
    num_model: int = 1
    data_index: int = 0
    model_index: int = 0
    data_group: Any = None     # ProcessGroup over the data axis, or None
    model_group: Any = None    # ProcessGroup over the model axis, or None
    devices: Tuple[torch.device, ...] = ()   # serving: one per data shard

    @property
    def size(self) -> int:
        return self.num_data * self.num_model

    @property
    def distributed(self) -> bool:
        """Whether the mesh spans the ranks of a process group."""
        return self.data_group is not None


def local_devices(device="cuda") -> List[torch.device]:
    """Every visible card for a CUDA `device`, else `device` alone."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def _group(ranks: List[int], world: int):
    return dist.group.WORLD if len(ranks) == world else dist.new_group(ranks)


def make_mesh(num_data: int = -1, num_model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over the process group when one is up (every rank calls this,
    with the same arguments: it creates the groups), else over `devices`
    (default :func:`local_devices`).  ``num_data=-1`` takes every position
    the other axis leaves."""
    rank, world = rank_and_world()
    if dist.is_available() and dist.is_initialized():
        if devices is not None:
            raise ValueError("a mesh over a process group places one rank "
                             "at each position; `devices` is for a "
                             "serving mesh in one process")
        if num_data == -1:
            num_data = world // num_model
        if num_data * num_model != world:
            raise ValueError(f"a {num_data} x {num_model} mesh needs "
                             f"{num_data * num_model} ranks; the process "
                             f"group has {world}")
        data_groups = [_group([d * num_model + m for d in range(num_data)],
                              world) for m in range(num_model)]
        model_groups = [_group([d * num_model + m for m in range(num_model)],
                               world) for d in range(num_data)]
        d, m = divmod(rank, num_model)
        return Mesh(num_data, num_model, d, m, data_groups[m],
                    model_groups[d])
    if num_model != 1:
        raise ValueError("tensor parallelism runs one process per position: "
                         "start the ranks (torchrun) and join the process "
                         "group (distributed.init_from_env) first")
    devices = [torch.device(x) for x in (
        local_devices() if devices is None else devices)]
    if num_data == -1:
        num_data = len(devices)
    if not 0 < num_data <= len(devices):
        raise ValueError(f"num_data={num_data} with {len(devices)} devices")
    return Mesh(num_data, 1, devices=tuple(devices[:num_data]))


@torch.no_grad()
def replicate(mesh: Optional[Mesh], module: torch.nn.Module
              ) -> torch.nn.Module:
    """Rank 0's parameters and buffers on every rank (a broadcast over the
    process group; nothing without one)."""
    if mesh is not None and mesh.distributed:
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t.data, src=0)
    return module
