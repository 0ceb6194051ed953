"""The full training schedule of the PyTorch port on learnable synthetic
scenes, with a crash and a restore in the middle (the port's counterpart
of scripts/hw_train_synth.py).

Renders people as coloured skeletons on textured backgrounds: the JAX
script's scenes pixel for pixel, without cv2 (``data/cv2exact.py``
``resize_linear_to`` for the background, ``utils/draw.py`` ``cv_line``
and the filled ``cv_circle`` for the skeletons).  A pool of batches is
rendered once and kept on the card (24 x 72 x 368 x 368 x 3 fp32 is
2.81 GB), then ``Trainer.run_epoch`` runs the schedule over it: the
freeze phase and the backbone's release, ``ReduceLROnPlateau`` on the
val loss (its lr written into the optimizer after every step of the
plateau), mid-epoch checkpoints every 40 steps through
``CheckpointManager``, and at ``--restore-at-epoch`` a simulated crash:
a new ``Trainer`` restores the latest checkpoint (model, momentum, lr,
plateau, epoch, best val) and the run goes on.

    python3 scripts/torch_train_synth.py --steps-per-epoch 100 --epochs 6
    python3 scripts/torch_train_synth.py --device cpu --size 64 \\
        --stages 1 --batch 4 --steps-per-epoch 3 --epochs 3 \\
        --pool-batches 2 --restore-at-epoch 2

Prints an ``EPOCH`` JSON line per epoch (appended to
``<out>/loss_log.jsonl``), ``DONE``, then one ``SUMMARY`` JSON line (the
records, the restore, and on the card the ground-truth kernel's
launches against the steps).  ``--out`` defaults to the git-ignored
``rtpose_tpu_torch/build/torch_train_synth``.  The scene renderer and the
set writers below are what the other workflow scripts draw their sets
with, as the JAX scripts import hw_train_synth.
"""

import argparse
import json
import os
import shutil
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def render_scene(rng, size=368, n_people=3, height=None, width=None):
    """Coloured-skeleton scene (BGR uint8) + padded (32, 18, 3) keypoints,
    equal pixel for pixel to scripts/hw_train_synth.py's.

    height/width override ``size`` for non-square scenes (the COCO-val
    dress-rehearsal set samples real val2017 resolutions)."""
    from rtpose_tpu_torch.data.cv2exact import resize_linear_to
    from rtpose_tpu_torch.skeleton import LIMBS, NUM_PARTS
    from rtpose_tpu_torch.utils.draw import cv_circle, cv_line
    from rtpose_tpu_torch.utils.synth import random_people

    h = height or size
    w = width or size
    img = (rng.rand(max(1, h // 8), max(1, w // 8), 3) * 80
           + 60).astype(np.uint8)
    img = resize_linear_to(img, w, h)
    people = random_people(rng, n_people, h, w,
                           scale_range=(0.25, 0.6))
    part_colors = [(int(37 * p % 255), int(91 * p % 255), 255 - 13 * p % 255)
                   for p in range(NUM_PARTS)]
    for person in people:
        for a, b in LIMBS:
            pa = tuple(int(v) for v in person[a])
            pb = tuple(int(v) for v in person[b])
            cv_line(img, pa, pb, (230, 230, 230), 3)
        for part in range(NUM_PARTS):
            px, py = (int(v) for v in person[part])
            cv_circle(img, (px, py), 5, part_colors[part], -1)
    kps = np.zeros((32, 18, 3), np.float32)
    n = min(len(people), 32)
    kps[:n, :, :2] = people[:n]
    kps[:n, :, 2] = 2
    return img, kps


def person_to_coco_annotation(person, img_id, ann_id):
    """Rendered 18-part pose -> COCO 17-kp person annotation dict (the
    inverse of evalx.harness.person_to_coco_keypoints' part order), or
    None when the pose has no visible parts."""
    from rtpose_tpu_torch.skeleton import ORDER_COCO

    if not person[:, 2].any():
        return None
    coco_kp = np.zeros((17, 3))
    for slot, part in enumerate(ORDER_COCO):
        coco_kp[slot] = (person[part, 0], person[part, 1], 2)
    xs, ys = coco_kp[:, 0], coco_kp[:, 1]
    return {
        "id": ann_id, "image_id": img_id, "category_id": 1,
        "keypoints": [float(v) for v in coco_kp.reshape(-1)],
        "num_keypoints": 17, "iscrowd": 0,
        "area": float((xs.max() - xs.min()) * (ys.max() - ys.min())),
        "bbox": [float(xs.min()), float(ys.min()),
                 float(xs.max() - xs.min()),
                 float(ys.max() - ys.min())],
    }


def write_coco_eval_set(out_dir, seed, n_images, size, max_people, *,
                        img_subdir="images", ann_name="annotations.json",
                        ext="png", jpeg_quality=92):
    """Render a scene set: images + COCO keypoint json (the JAX package's
    scripts/hw_train_to_eval.py ``write_coco_eval_set``).  Defaults give
    the lossless held-out eval set; ext="jpg" gives an on-disk JPEG
    training set."""
    from rtpose_tpu_torch.data.imwrite import write_bgr

    img_dir = os.path.join(out_dir, img_subdir)
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    images, annotations = [], []
    ann_id = 1
    for img_id in range(1, n_images + 1):
        img, kps = render_scene(rng, size,
                                n_people=1 + rng.randint(max_people))
        fname = f"synth_{img_id:04d}.{ext}"
        write_bgr(os.path.join(img_dir, fname), img,
                  quality=jpeg_quality if ext == "jpg" else None)
        images.append({"id": img_id, "file_name": fname,
                       "height": size, "width": size})
        for person in kps:
            ann = person_to_coco_annotation(person, img_id, ann_id)
            if ann is None:
                continue
            annotations.append(ann)
            ann_id += 1
    ann_file = os.path.join(out_dir, ann_name)
    with open(ann_file, "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": 1, "name": "person"}]}, f)
    return img_dir, ann_file


def write_train_set(out_dir, seed, n_images, size, max_people, quality=92):
    """Scenes as JPEGs + COCO keypoint json, the contract CocoKeypoints
    reads (scripts/hw_train_native_loader.py ``write_train_set``)."""
    return write_coco_eval_set(out_dir, seed, n_images, size, max_people,
                               img_subdir="train", ann_name="train.json",
                               ext="jpg", jpeg_quality=quality)


def make_batches(seed, n_batches, batch, size, device=None):
    """`n_batches` batches of scenes with 1-4 people, images as
    ``/255 - 0.5`` (the JAX script's; none of the pipeline's modes), each
    batch moved to `device` as it is made."""
    import torch

    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        imgs = np.zeros((batch, size, size, 3), np.float32)
        kps = np.zeros((batch, 32, 18, 3), np.float32)
        for i in range(batch):
            img, kp = render_scene(rng, size, n_people=1 + rng.randint(4))
            imgs[i] = img.astype(np.float32) / 255.0 - 0.5
            kps[i] = kp
        out.append({"image": torch.from_numpy(imgs).to(device),
                    "keypoints": torch.from_numpy(kps).to(device)})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=72)
    ap.add_argument("--size", type=int, default=368)
    ap.add_argument("--stages", type=int, default=6)
    ap.add_argument("--steps-per-epoch", type=int, default=100)
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--pool-batches", type=int, default=24)
    ap.add_argument("--restore-at-epoch", type=int, default=3,
                    help="simulate a crash: fresh Trainer restores from "
                         "the latest mid-epoch checkpoint here")
    ap.add_argument("--lr", type=float, default=0.2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(
        ROOT, "rtpose_tpu_torch", "build", "torch_train_synth"))
    args = ap.parse_args(argv)

    import torch

    from rtpose_tpu_torch.config import Config
    from rtpose_tpu_torch.device import resolve_device
    from rtpose_tpu_torch.ops import kernels
    from rtpose_tpu_torch.train.checkpoint import CheckpointManager
    from rtpose_tpu_torch.train.trainer import Trainer

    device = resolve_device(args.device)
    shutil.rmtree(args.out, ignore_errors=True)
    os.makedirs(args.out)

    def cfg():
        c = Config()
        c.model.num_stages = args.stages
        # bf16 on the card as the JAX script; fp32 on the CPU, whose bf16
        # convolutions are slow
        c.model.dtype = "bfloat16" if device.type == "cuda" else "float32"
        c.dataset.image_size = args.size
        c.train.lr = args.lr
        c.train.freeze_base_epochs = 1
        c.train.lr_patience = 1
        c.train.lr_cooldown = 0
        c.train.lr_factor = 0.7
        c.train.checkpoint_every_steps = 40
        c.train.print_freq = 20
        c.train.checkpoint_dir = args.out
        return c

    def last_checkpoint_step():
        return max((int(n[len("step_"):-len(".meta.json")])
                    for n in os.listdir(args.out)
                    if n.startswith("step_") and n.endswith(".meta.json")),
                   default=None)

    print("rendering synthetic pool on the device...", flush=True)
    t_render = time.perf_counter()
    pool = make_batches(0, args.pool_batches, args.batch, args.size, device)
    val = make_batches(999, 2, args.batch, args.size, device)
    render_s = time.perf_counter() - t_render

    tr = Trainer(cfg(), device=device)
    mgr = CheckpointManager(args.out, keep=3)
    kernels.reset_launch_counts()
    t_start = time.time()
    restored_marker = None
    records = []
    train_steps = val_steps = 0
    for epoch in range(args.epochs):
        if epoch == args.restore_at_epoch:
            # ---- simulated crash + restore -------------------------------
            print(f"=== simulating crash at epoch {epoch}: new Trainer, "
                  f"restore latest checkpoint ===", flush=True)
            last = last_checkpoint_step()
            tr = Trainer(cfg(), device=device)
            restored = mgr.restore_latest(device)
            if restored is None:
                raise RuntimeError(f"no checkpoint under {args.out} to "
                                   f"restore at epoch {epoch}")
            tr.restore(restored)
            restored_marker = {"epoch": epoch, "restored_step": tr.step,
                               "last_checkpoint_step": last,
                               "meta_epoch": restored[1].get("epoch"),
                               "lr": tr.lr}
            print(f"restored at step {tr.step}", flush=True)

        tr.maybe_release_backbone()
        steps = args.steps_per_epoch
        batches = [pool[i % len(pool)] for i in range(steps)]
        logs = tr.run_epoch(batches, train=True, ckpt=mgr)
        val_logs = tr.run_epoch(val, train=False)
        train_steps += steps
        val_steps += len(val)
        # the plateau's lr into the optimizer (the JAX script writes it
        # into its TrainState), or the next epoch trains at a stale rate
        lr = tr.plateau.step(val_logs["loss"])
        tr.lr = lr
        is_best = val_logs["loss"] < tr.best_val
        tr.best_val = min(tr.best_val, val_logs["loss"])
        tr.epoch += 1
        mgr.save(tr.state_dict(), step=tr.step, is_best=is_best,
                 meta={"epoch": tr.epoch, "best_val": tr.best_val,
                       "plateau": tr.plateau.state_dict(),
                       "val_loss": val_logs["loss"]})
        rec = {"epoch": tr.epoch, "step": tr.step,
               "train_loss": logs["loss"], "val_loss": val_logs["loss"],
               "lr": lr, "wall_s": round(time.time() - t_start, 1),
               "frozen": tr.epoch <= 1}
        if restored_marker and restored_marker["epoch"] == epoch:
            rec["restored"] = restored_marker
        records.append(rec)
        with open(os.path.join(args.out, "loss_log.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")
        print("EPOCH", json.dumps(rec), flush=True)
    print("DONE", flush=True)
    summary = {"epochs": records, "restored": restored_marker,
               "train_steps": train_steps, "val_steps": val_steps,
               "render_s": round(render_s, 1), "device": str(device)}
    if device.type == "cuda":
        summary["launches"] = kernels.launch_counts()
        summary["card"] = torch.cuda.get_device_name(device)
    print("SUMMARY", json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
