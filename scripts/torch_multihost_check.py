"""Data- and tensor-parallel training of the port over real processes,
against one process (the port's counterpart of
``scripts/multihost_cpu_check.py``).

    python scripts/torch_multihost_check.py [--nprocs 2] [--num-model 1]

Starts `--nprocs` ranks joined in a gloo process group on localhost
(``rtpose_tpu_torch.parallel.distributed.spawn``), each on the CPU, and
runs:

- `--steps` train steps of a small VGG19 (``--stages``, ``--size`` px,
  fp32) through ``Trainer(mesh=make_mesh(nprocs // num_model,
  num_model))``, each rank on its rows of the global batch (``rank_rows``);
  the logs and the gathered parameters against one process that trains on
  the whole batch from the same weights;
- three barriers (``sync_hosts``);
- eval results: each rank writes ``results.rank{i}.json`` for its
  ``host_shard`` of the image ids, rank 0 merges them
  (``merge_result_files``) and scores them; the stats against one
  process's.

Prints one JSON line (``ok``, the largest loss and parameter
differences) and exits 1 on a failure.  The functions here are also the
multi-process helpers of ``tests/test_torch_parallel.py`` and
``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

LOSS_ATOL = 1e-6      # DP / TP against one process (fp32, the JAX test's)
PARAM_ATOL = 1e-5


def make_cfg(name: str = "vgg19", stages: int = 1, size: int = 64,
             dtype: str = "float32", **train):
    """The JAX TP test's configuration (tests/test_tensor_parallel.py:
    1 stage, 64 px, fp32, lr 0.05, no freeze), with `train` overrides."""
    from rtpose_tpu_torch.config import Config
    cfg = Config()
    cfg.model.name = name
    cfg.model.num_stages = stages
    cfg.model.dtype = dtype
    cfg.dataset.image_size = size
    cfg.train.lr = 0.05
    cfg.train.freeze_base_epochs = 0
    cfg.train.print_freq = 1000
    for k, v in train.items():
        setattr(cfg.train, k, v)
    return cfg


def make_batches(n_steps: int, batch: int = 8, size: int = 64,
                 seed: int = 0, stride: int = 8):
    """The JAX TP test's batches: uniform images, one person of 18
    visible keypoints an image, an all-ones mask."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_steps):
        images = rng.rand(batch, size, size, 3).astype(np.float32)
        kps = np.zeros((batch, 4, 18, 3), np.float32)
        kps[:, 0, :, 0] = rng.uniform(5, size - 5, (batch, 18))
        kps[:, 0, :, 1] = rng.uniform(5, size - 5, (batch, 18))
        kps[:, 0, :, 2] = 2
        mask = np.ones((batch, size // stride, size // stride, 1),
                       np.float32)
        out.append({"image": images, "keypoints": kps, "mask": mask})
    return out


def train_run(cfg, batches, *, mesh=None, device="cpu", state_dict=None,
              release_at=None):
    """Train on `batches` (global batches; each rank takes its rows) ->
    {"logs": per step, "state": the full model state dict, "sharded":
    names, "buffers": BatchNorm running statistics}.  `release_at`: the
    step before which the frozen trunk is released (epoch 1)."""
    import torch

    from rtpose_tpu_torch.parallel.distributed import rank_rows
    from rtpose_tpu_torch.train.trainer import Trainer
    tr = Trainer(cfg, device=device, mesh=mesh, state_dict=state_dict)
    logs = []
    for i, b in enumerate(batches):
        if release_at is not None and i == release_at:
            tr.epoch = 1
            tr.maybe_release_backbone()
        rows = rank_rows(b, mesh) if mesh is not None else b
        logs.append(tr.train_step(rows["image"], rows["keypoints"],
                                  rows.get("mask")))
    state = {k: v.detach().cpu().clone()
             for k, v in tr.model_state_dict().items()}
    return {"logs": logs, "state": state, "sharded": list(tr.sharded),
            "buffers": {k: v for k, v in state.items()
                        if k.endswith(("running_mean", "running_var"))},
            "trainer": tr}


def dp_worker(rank: int, world: int, spec: dict):
    """One rank of a :func:`train_run` over a ``world // num_model`` x
    ``num_model`` mesh; rank 0 returns the gathered state too."""
    import torch

    from rtpose_tpu_torch.parallel.mesh import make_mesh
    torch.set_num_threads(spec.get("threads", 1))
    # fp32 parity: cuDNN convolves fp32 in TF32 by default
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(world // spec.get("num_model", 1),
                     spec.get("num_model", 1))
    out = train_run(make_cfg(**spec["cfg"]), spec["batches"], mesh=mesh,
                    device=spec.get("device", "cpu"),
                    state_dict=spec.get("state_dict"),
                    release_at=spec.get("release_at"))
    out.pop("trainer")
    if rank:
        out.pop("state")
    return out


def max_diffs(a: dict, b: dict):
    """(largest loss difference, largest parameter difference) of two
    :func:`train_run` results."""
    loss = max(abs(x["loss"] - y["loss"]) for x, y in zip(a["logs"],
                                                          b["logs"]))
    param = max(float(np.max(np.abs(np.asarray(a["state"][k], np.float64)
                                    - np.asarray(b["state"][k],
                                                 np.float64))))
                for k in a["state"])
    return loss, param


def synth_results(seed: int = 7, n_images: int = 13):
    """(ground truth by image, detections by image, image ids): the JAX
    multi-process eval test's jittered keypoints."""
    rng = np.random.RandomState(seed)
    img_ids = list(range(1, n_images + 1))
    gts, dts = {}, {}
    ann_id = 1
    for img in img_ids:
        gts[img], dts[img] = [], []
        for _ in range(rng.randint(1, 4)):
            kps = np.zeros((17, 3))
            kps[:, 0] = rng.uniform(50, 300, 17)
            kps[:, 1] = rng.uniform(50, 300, 17)
            kps[:, 2] = 2
            gts[img].append({
                "id": ann_id, "image_id": img, "category_id": 1,
                "keypoints": [float(v) for v in kps.reshape(-1)],
                "num_keypoints": 17, "area": 5000.0, "iscrowd": 0,
                "bbox": [float(kps[:, 0].min()), float(kps[:, 1].min()),
                         50.0, 50.0]})
            ann_id += 1
            jit = kps.copy()
            jit[:, :2] += rng.normal(0, 4, (17, 2))
            dts[img].append({
                "image_id": img, "category_id": 1,
                "keypoints": [float(v) for v in jit.reshape(-1)],
                "score": float(rng.uniform(0.3, 1.0))})
    return gts, dts, img_ids


def eval_merge_worker(rank: int, world: int, out_dir: str):
    """Each rank writes its host_shard's detections; rank 0 merges and
    scores them.  Three barriers."""
    from rtpose_tpu_torch.evalx.cocoeval import evaluate_keypoints
    from rtpose_tpu_torch.parallel.distributed import (host_shard,
                                                       merge_result_files,
                                                       sync_hosts)
    gts, dts, img_ids = synth_results()
    sync_hosts("start")
    mine = host_shard(img_ids)
    with open(os.path.join(out_dir, f"results.rank{rank}.json"), "w") as f:
        json.dump([d for i in mine for d in dts[i]], f)
    sync_hosts("results-written")
    stats = None
    if rank == 0:
        merged = merge_result_files([
            os.path.join(out_dir, f"results.rank{r}.json")
            for r in range(world)])
        by_image = {}
        for r in merged:
            by_image.setdefault(r["image_id"], []).append(r)
        stats = evaluate_keypoints({i: list(gts[i]) for i in img_ids},
                                   by_image, img_ids)
    sync_hosts("merged")
    return {"ids": mine, "stats": stats}


def single_eval_stats():
    from rtpose_tpu_torch.evalx.cocoeval import evaluate_keypoints
    gts, dts, img_ids = synth_results()
    return evaluate_keypoints({i: list(gts[i]) for i in img_ids},
                              {i: [dict(d) for d in dts[i]]
                               for i in img_ids}, img_ids)


def check(nprocs: int = 2, num_model: int = 1, steps: int = 1,
          stages: int = 1, size: int = 64, batch: int = 8) -> dict:
    """The whole check -> its summary (``ok`` and the numbers)."""
    import torch

    from rtpose_tpu_torch.parallel.distributed import spawn
    torch.set_num_threads(min(torch.get_num_threads(), 4))
    cfg = dict(stages=stages, size=size)
    batches = make_batches(steps, batch, size)
    t0 = time.perf_counter()
    ranks = spawn(dp_worker, nprocs, (dict(cfg=cfg, batches=batches,
                                           num_model=num_model),))
    dp_s = time.perf_counter() - t0
    single = train_run(make_cfg(**cfg), batches)
    loss_diff, param_diff = max_diffs(ranks[0], single)
    with tempfile.TemporaryDirectory() as out_dir:
        merged = spawn(eval_merge_worker, nprocs, (out_dir,))
    ref = single_eval_stats()
    eval_equal = merged[0]["stats"] == ref
    ids = sorted(i for r in merged for i in r["ids"])
    ok = (loss_diff <= LOSS_ATOL and param_diff <= PARAM_ATOL
          and eval_equal and ids == list(range(1, 14))
          and all(r["logs"] == ranks[0]["logs"] for r in ranks))
    return {"ok": bool(ok), "nprocs": nprocs, "num_model": num_model,
            "losses": [lg["loss"] for lg in ranks[0]["logs"]],
            "single_losses": [lg["loss"] for lg in single["logs"]],
            "max_loss_diff": loss_diff, "max_param_diff": param_diff,
            "sharded": ranks[0]["sharded"], "eval_equal": eval_equal,
            "eval_ids": [r["ids"] for r in merged], "dp_seconds": dp_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--num-model", type=int, default=1)
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--stages", type=int, default=1)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args(argv)
    out = check(args.nprocs, args.num_model, args.steps, args.stages,
                args.size, args.batch)
    print(json.dumps(out), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
