"""Rank programs for tests/test_torch_parallel.py, run in processes that
``rtpose_tpu_torch.parallel.distributed.spawn`` starts.  Nothing here
imports JAX: each rank imports only this module, the port and
scripts/torch_multihost_check.py.

``runs_worker`` runs a list of jobs in one set of ranks (starting ranks
costs seconds); a job is a dict with ``kind``:

- ``"train"``: ``torch_multihost_check.dp_worker``'s spec, plus optional
  ``mutant`` ("per_rank_bn": BatchNorm keeps each rank's statistics;
  "summing_gather": the column-parallel gather's backward sums the model
  ranks' gradients, as ``torch.distributed.nn.functional.all_gather``'s
  does), ``roundtrip`` (``state_dict`` gathered, loaded into a fresh
  sharded trainer, and one more step on both) and ``outputs`` (the
  trained model's train-mode forward of the rank's rows of the last
  batch, after the state is taken);
- ``"eval_merge"``: ``torch_multihost_check.eval_merge_worker``;
- ``"eval_sharded"``: ``evalx.harness.run_eval_sharded`` of an oracle
  pipeline over a synthetic COCO set;
- ``"unequal_rows"``: a train step where rank r gets ``rows[r]`` rows ->
  the error every rank raised;
- ``"train_cli"``: ``python -m rtpose_tpu_torch.train``'s ``main()`` with
  ``argv`` (the ranks' process group is up, so it trains over a mesh).
"""

import io
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import torch_multihost_check as mh  # noqa: E402


def _summing_gather_backward(ctx, grad):
    import torch.distributed as dist
    grad = grad.contiguous().clone()
    dist.all_reduce(grad, group=ctx.group)
    return (grad.narrow(1, ctx.rank * ctx.width, ctx.width).contiguous(),
            None, None, None)


def _train(rank, world, job):
    from rtpose_tpu_torch.parallel import sharding
    from rtpose_tpu_torch.parallel.distributed import rank_rows
    from rtpose_tpu_torch.parallel.mesh import make_mesh
    from rtpose_tpu_torch.train import trainer as trainer_mod
    saved = (trainer_mod.set_data_group,
             sharding._GatherFromModel.__dict__["backward"])
    if job.get("mutant") == "per_rank_bn":
        trainer_mod.set_data_group = lambda model, group: None
    if job.get("mutant") == "summing_gather":
        sharding._GatherFromModel.backward = staticmethod(
            _summing_gather_backward)
    try:
        sd = job.get("state_dict")
        if sd is not None:
            sd = {k: torch.as_tensor(v) for k, v in sd.items()}
        num_model = job.get("num_model", 1)
        mesh = make_mesh(world // num_model, num_model)
        out = mh.train_run(mh.make_cfg(**job["cfg"]), job["batches"],
                           mesh=mesh, state_dict=sd,
                           release_at=job.get("release_at"))
        tr = out.pop("trainer")
        if job.get("outputs"):
            rows = rank_rows(job["batches"][-1], mesh)
            tr.model.train()
            with torch.no_grad():
                o = tr.model(torch.as_tensor(rows["image"]))
            out["outputs"] = {"pafs": o.pafs, "heatmaps": o.heatmaps}
        if job.get("roundtrip"):
            fresh = trainer_mod.Trainer(mh.make_cfg(**job["cfg"]),
                                        device="cpu", mesh=make_mesh(
                                            world // num_model, num_model))
            buf = io.BytesIO()        # as a checkpoint file holds it
            torch.save(tr.state_dict(), buf)
            buf.seek(0)
            fresh.load_state_dict(torch.load(buf))
            b = rank_rows(job["batches"][-1], mesh)
            logs = [t.train_step(b["image"], b["keypoints"], b["mask"])
                    for t in (tr, fresh)]
            states = [t.model_state_dict() for t in (tr, fresh)]
            out["roundtrip"] = {
                "losses": [lg["loss"] for lg in logs],
                "max_param_diff": max(
                    float((states[0][k] - states[1][k]).abs().max())
                    for k in states[0])}
    finally:
        trainer_mod.set_data_group, sharding._GatherFromModel.backward = \
            saved
    if rank:
        out.pop("state")
    return out


def _eval_sharded(rank, world, job):
    from rtpose_tpu_torch.evalx.harness import run_eval_sharded
    from rtpose_tpu_torch.infer.pipeline import PosePipeline
    from rtpose_tpu_torch.utils.synth_coco import OracleMaps, oracle_maps
    pipe = PosePipeline(OracleMaps(oracle_maps(job["scenes"],
                                               job["size"])),
                        device="cpu", input_size=job["size"], flip=False)
    return run_eval_sharded(job["img_dir"], job["ann"], pipe,
                            job["results_dir"],
                            batch_size=job.get("batch_size", 0))


def _unequal_rows(rank, world, job):
    from rtpose_tpu_torch.parallel.mesh import make_mesh
    from rtpose_tpu_torch.train.trainer import Trainer
    tr = Trainer(mh.make_cfg(), device="cpu", mesh=make_mesh(world, 1))
    b = mh.make_batches(1)[0]
    n = job["rows"][rank]
    try:
        tr.train_step(b["image"][:n], b["keypoints"][:n], b["mask"][:n])
    except ValueError as e:
        return str(e)
    return None


def train_cli(argv):
    """The train CLI's main() on `argv` -> each epoch's train and val
    losses per step, and the trainer's step and epoch."""
    from rtpose_tpu_torch.train.__main__ import main
    saved = sys.argv
    sys.argv = ["train"] + list(argv)
    try:
        trainer, history = main()
    finally:
        sys.argv = saved
    return {"step": trainer.step, "epoch": trainer.epoch,
            "train_loss": [h["train"]["loss"] for h in history],
            "val_loss": [h["val"]["loss"] for h in history],
            "mesh": None if trainer.mesh is None else
            [trainer.mesh.num_data, trainer.mesh.num_model]}


def runs_worker(rank, world, jobs):
    torch.set_num_threads(1)
    out = []
    for job in jobs:
        if job["kind"] == "train":
            out.append(_train(rank, world, job))
        elif job["kind"] == "eval_merge":
            out.append(mh.eval_merge_worker(rank, world, job["out_dir"]))
        elif job["kind"] == "eval_sharded":
            out.append(_eval_sharded(rank, world, job))
        elif job["kind"] == "unequal_rows":
            out.append(_unequal_rows(rank, world, job))
        elif job["kind"] == "train_cli":
            out.append(train_cli(job["argv"]))
        else:
            raise ValueError(job["kind"])
    return out


def as_numpy_state(sd):
    return {k: np.asarray(v) for k, v in sd.items()}
