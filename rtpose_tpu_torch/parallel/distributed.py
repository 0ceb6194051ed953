"""Work split across processes (port of rtpose_tpu/parallel/distributed.py).

The JAX package runs one process per host and lets ``jax.sharding`` place
the global batch; here a process is a rank of a ``torch.distributed``
process group, one per card:

- training: each rank of the ``data`` axis trains on its rows of the
  global batch (:func:`rank_rows`, the counterpart of
  ``global_batch_from_local``; the loaders draw them with ``rank`` /
  ``world``), and ``train/trainer.py`` all-reduces the gradients;
- evaluation: image ids split per process (:func:`host_shard`), each
  process writes ``results.rank{i}.json`` and rank 0 merges them
  (:func:`merge_result_files`, ``evalx/harness.py`` ``run_eval_sharded``).

:func:`init_from_env` joins the process group that ``torchrun`` describes
in the environment; :func:`spawn` starts ranks on this machine itself (the
tests, ``scripts/torch_multihost_check.py`` and ``chip_smoke.py``).
"""

from __future__ import annotations

import datetime
import json
import os
import queue
import socket
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, TypeVar, Union

import torch
import torch.distributed as dist

from ..device import resolve_device

T = TypeVar("T")

# how long a rank waits for the others to join, or at a collective
PROCESS_GROUP_TIMEOUT_S = 300


def rank_and_world():
    """(this process's rank, the world size); (0, 1) without a process
    group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_shard(items: Sequence[T], process_index: int = None,
               process_count: int = None) -> List[T]:
    """Deterministic contiguous split of a work list across processes."""
    rank, world = rank_and_world()
    pi = rank if process_index is None else process_index
    pc = world if process_count is None else process_count
    n = len(items)
    per = -(-n // pc)
    return list(items[pi * per:(pi + 1) * per])


def merge_result_files(paths: Sequence[str]) -> list:
    """Merge per-process eval results-json files (each process writes
    results.rank{i}.json for its host_shard; rank 0 merges and scores)."""
    merged: list = []
    for p in paths:
        with open(p) as f:
            merged.extend(json.load(f))
    return merged


def sync_hosts(name: str = "barrier") -> None:
    """Barrier across every process (a no-op in one process).  `name` is
    kept for the JAX package's call sites; the barrier does not use it."""
    if rank_and_world()[1] > 1:
        dist.barrier()


def rank_rows(batch, mesh):
    """This rank's rows of a global batch: rows ``[i*B/n, (i+1)*B/n)`` for
    data index ``i`` of ``n`` (the JAX mesh's contiguous split over
    ``data``).  `batch` is an array or tensor, or a dict of them with the
    batch on the leading axis.  A batch that ``n`` does not divide is
    refused, as the JAX mesh refuses it: the gradient all-reduce takes the
    mean of equal shards."""
    if isinstance(batch, dict):
        return {k: rank_rows(v, mesh) for k, v in batch.items()}
    n = mesh.num_data
    if len(batch) % n:
        raise ValueError(f"a global batch of {len(batch)} does not split "
                         f"over {n} data-parallel ranks")
    per = len(batch) // n
    return batch[mesh.data_index * per:(mesh.data_index + 1) * per]


def init_from_env(device: Union[str, torch.device] = "cuda",
                  backend: Optional[str] = None) -> torch.device:
    """Join the process group ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and
    return this rank's device: card ``LOCAL_RANK`` for a CUDA `device`
    (NCCL), the CPU otherwise (gloo).  Without those variables it joins
    nothing and returns `device`."""
    dev = resolve_device(device)
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return dev
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", 0))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            backend or ("nccl" if dev.type == "cuda" else "gloo"),
            init_method="env://",
            timeout=datetime.timedelta(seconds=PROCESS_GROUP_TIMEOUT_S))
    return dev


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _host(x):
    """Tensors -> numpy (a rank's result crosses a pipe by value)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v) for v in x)
    return x


def _rank_main(fn, rank, world, port, backend, args, results):
    try:
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=PROCESS_GROUP_TIMEOUT_S))
        out = _host(fn(rank, world, *args))
        dist.barrier()
        dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 - the parent raises it
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def spawn(fn: Callable[..., Any], world: int, args: Sequence = (), *,
          backend: str = "gloo", timeout: float = 600.0) -> List[Any]:
    """Run ``fn(rank, world, *args)`` in `world` fresh processes joined in
    a `backend` process group on localhost, and return each rank's result
    (tensors as numpy), in rank order.  `fn` must be importable by name.
    Raises if a rank raises, dies, or the ranks take longer than
    `timeout` seconds; every process is ended before this returns."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, port, backend, tuple(args),
                               results))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue.Empty:
                dead = [(i, p.exitcode) for i, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and i not in got]
                if dead:
                    raise RuntimeError(f"rank(s) died without a result: "
                                       f"(rank, exit code) {dead}")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks took more than "
                                       f"{timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{out}")
            got[rank] = out
    finally:
        for p in procs:
            p.join(timeout=60)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        results.join_thread()
    return [got[r] for r in range(world)]

