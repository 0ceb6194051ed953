"""Close the train -> eval loop of the PyTorch port on the card, with
nothing downloaded (the port's counterpart of scripts/hw_train_to_eval.py).

Renders learnable skeleton scenes (grey limb strokes and part-coloured
disks on a smooth textured background, drawn with Pillow's ImageDraw, so
the scenes are not pixel-equal to the JAX script's cv2 ones), writes the
training and val sets as JPEGs with COCO ``person_keypoints`` JSON and a
held-out set as PNGs, trains a family (``--model``, VGG19 by default)
from them through ``CocoKeypoints``, the worker-process ``Loader`` and
``Trainer.fit`` (the reference's augmentation without the flip: a
flipped synthetic scene swaps the part colours' sides, which no model
can learn), then serves the best checkpoint through ``load_pipeline``
(``--thresh-heatmap``) and scores it with ``run_eval_batched``, ranked
by person score, and once more from the same detections at the
reference's fixed score.  Training normalises RGB by the ImageNet mean
and std, so the eval serves with preprocess mode 'vgg'; the script
checks on one held-out frame that the two give the same tensor.

Each family trains with the JAX script's recipe: hourglass with the
reference's train_SH one (stride 4, sigma 4.416, limb width 1.289,
crowd-masked loss; ``--size`` divisible by 64), the others at the
stride-8 defaults (``--size`` divisible by 8).

    python3 scripts/torch_train_to_eval.py --size 184 --stages 2 \\
        --steps 6000
    python3 scripts/torch_train_to_eval.py --model hourglass --size 256 \\
        --stages 8 --steps 1200
    python3 scripts/torch_train_to_eval.py --device cpu --size 64 \\
        --stages 1 --steps 4 --batch 4 --train-images 16 --eval-images 4

Prints one ``SUMMARY`` JSON line (AP, steps, wall seconds, the loader's
data-wait share) and writes it to ``<out>/summary.json``; ``--out``
defaults to the git-ignored ``rtpose_tpu_torch/build/torch_train_eval``
(checkpoints under ``ckpt/``, the held-out set under ``heldout/``).
"""

import argparse
import contextlib
import io
import json
import math
import os
import shutil
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SCALE_RANGE = (0.8, 1.2)    # RescaleRelative's range for the scenes


def render_scene(rng, size, n_people, max_slots=32):
    """A (size, size) RGB scene of `n_people` skeletons and their (32, 18,
    3) keypoints (v = 2): the JAX script's scene (hw_train_synth.py:29)
    drawn with Pillow in place of cv2."""
    from PIL import Image, ImageDraw

    from rtpose_tpu_torch.skeleton import LIMBS, NUM_PARTS
    from rtpose_tpu_torch.utils.synth import random_people

    cells = max(1, size // 8)
    noise = (rng.rand(cells, cells, 3) * 80 + 60).astype(np.uint8)
    img = Image.fromarray(noise).resize((size, size), Image.BILINEAR)
    draw = ImageDraw.Draw(img)
    people = random_people(rng, n_people, size, size,
                           scale_range=(0.25, 0.6))
    colours = [(int(37 * p % 255), int(91 * p % 255), 255 - 13 * p % 255)
               for p in range(NUM_PARTS)]
    for person in people:
        for a, b in LIMBS:
            draw.line([tuple(int(v) for v in person[a]),
                       tuple(int(v) for v in person[b])],
                      fill=(230, 230, 230), width=3)
        for part in range(NUM_PARTS):
            x, y = (int(v) for v in person[part])
            draw.ellipse([x - 5, y - 5, x + 5, y + 5], fill=colours[part])
    kps = np.zeros((max_slots, NUM_PARTS, 3), np.float32)
    n = min(len(people), max_slots)
    kps[:n, :, :2] = people[:n]
    kps[:n, :, 2] = 2
    return np.asarray(img), kps


def write_set(root, seed, n_images, size, max_people, ext):
    """`n_images` rendered scenes under ``root/images`` (``ext`` "jpg" or
    "png") and their annotations -> (image dir, annotation file)."""
    from PIL import Image

    from rtpose_tpu_torch.utils.synth_coco import coco_annotation

    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    images, annotations = [], []
    for img_id in range(1, n_images + 1):
        img, kps = render_scene(rng, size, 1 + rng.randint(max_people))
        name = f"synth_{img_id:05d}.{ext}"
        Image.fromarray(img).save(os.path.join(img_dir, name),
                                  **({"quality": 92} if ext == "jpg" else {}))
        images.append({"id": img_id, "file_name": name, "height": size,
                       "width": size})
        annotations += [coco_annotation(len(annotations) + 1, img_id, p)
                        for p in kps if p[:, 2].any()]
    ann_file = os.path.join(root, "annotations.json")
    with open(ann_file, "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": 1, "name": "person"}]}, f)
    return img_dir, ann_file


def same_input(png: str, device: str) -> float:
    """Training's normalisation of a frame (Pillow RGB, ImageNet mean and
    std) against serving's (``read_bgr`` then ``normalize_device`` in
    mode 'vgg') -> the largest difference."""
    import PIL.Image
    import torch

    from rtpose_tpu_torch.data.imread import read_bgr
    from rtpose_tpu_torch.data.transforms import image_to_tensor
    from rtpose_tpu_torch.infer.preprocess import normalize_device

    with open(png, "rb") as f:
        train = image_to_tensor(PIL.Image.open(f).convert("RGB"))
    serve = normalize_device(torch.from_numpy(read_bgr(png)).to(device),
                             "vgg").cpu().numpy()
    return float(np.abs(train - serve).max())


def apply_recipe(cfg, model: str, size: int) -> None:
    """The family's training recipe into `cfg`, or SystemExit for a size
    it cannot take (scripts/hw_train_to_eval.py:134-182)."""
    from rtpose_tpu_torch.models import FAMILIES

    cfg.model.name = model
    if model == "hourglass":
        # the reference's second trainer recipe (train_SH.py:76-77,267):
        # output stride 4, sigma 4.416, limb width 1.289, crowd-masked loss
        if size % 64:
            raise SystemExit(
                f"--model hourglass needs --size divisible by 64 "
                f"(stride-4 stem x depth-4 exact pool/upsample halvings); "
                f"got {size} — use e.g. 256 (train_SH.py's size)")
        cfg.model.downsample = 4
        cfg.dataset.sigma = 4.416
        cfg.dataset.limb_width = 1.289
        cfg.train.masked_loss = True
    elif model in FAMILIES:
        # shufflenet_v2 (train_ShuffleNetV2.py: stride 8, sigma 7, plain
        # MSE), the atrous families, mobilenet and openpose_v2: the
        # stride-8 defaults of Config; single-stage families ignore
        # --stages
        if size % 8:
            raise SystemExit(
                f"--model {model} needs --size divisible by 8 "
                f"(stride-8 trunk); got {size}")
    else:
        raise SystemExit(f"--model {model}: unknown model family; known: "
                         f"{', '.join(FAMILIES)}")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", default="vgg19",
                    help="vgg19 | hourglass | shufflenet_v2 | mobilenet | "
                         "openpose_v2 | atrous_resnet50 | atrous_cpm | "
                         "atrous_cpm_shared (hourglass trains with the "
                         "train_SH recipe: stride 4, sigma 4.416, limb "
                         "width 1.289, masked loss; the others with the "
                         "stride-8 defaults)")
    ap.add_argument("--batch", type=int, default=48)
    ap.add_argument("--size", type=int, default=184)
    ap.add_argument("--stages", type=int, default=2)
    ap.add_argument("--steps", type=int, default=3000,
                    help="at least this many steps, in whole epochs")
    ap.add_argument("--train-images", type=int, default=3072)
    ap.add_argument("--val-images", type=int, default=96)
    ap.add_argument("--eval-images", type=int, default=64)
    ap.add_argument("--max-people", type=int, default=4)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--clip", type=float, default=1.0)
    ap.add_argument("--lr-drop-at", type=float, default=0.5,
                    help="fraction of the epochs after which the lr is cut "
                         "10x (the JAX script's two-phase schedule)")
    ap.add_argument("--thresh-heatmap", type=float, default=0.1)
    ap.add_argument("--workers", type=int, default=None,
                    help="loader worker processes (default: the cores)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(
        ROOT, "rtpose_tpu_torch", "build", "torch_train_eval"),
                    help="work directory: the written sets, checkpoints, "
                         "results and summary.json")
    args = ap.parse_args(argv)
    if args.steps < 1:
        raise SystemExit("--steps must be >= 1")

    import torch

    from rtpose_tpu_torch.config import Config
    from rtpose_tpu_torch.data import transforms as T
    from rtpose_tpu_torch.data.coco_json import CocoJson
    from rtpose_tpu_torch.data.dataset import CocoKeypoints, Loader
    from rtpose_tpu_torch.evalx.harness import eval_results, run_eval_batched
    from rtpose_tpu_torch.infer.pipeline import load_pipeline
    from rtpose_tpu_torch.ops import kernels
    from rtpose_tpu_torch.train.trainer import Trainer

    cfg = Config()
    apply_recipe(cfg, args.model, args.size)

    workers = (args.workers if args.workers is not None
               else len(os.sched_getaffinity(0)))
    shutil.rmtree(args.out, ignore_errors=True)
    t_start = time.time()
    train_dir, train_ann = write_set(os.path.join(args.out, "train"), 0,
                                     args.train_images, args.size,
                                     args.max_people, "jpg")
    val_dir, val_ann = write_set(os.path.join(args.out, "val"), 1,
                                 args.val_images, args.size,
                                 args.max_people, "jpg")
    eval_dir, eval_ann = write_set(os.path.join(args.out, "heldout"), 999,
                                   args.eval_images, args.size,
                                   args.max_people, "png")
    write_s = time.time() - t_start
    print(f"wrote {args.train_images} + {args.val_images} JPEGs and "
          f"{args.eval_images} PNGs in {write_s:.1f} s", flush=True)
    diff = same_input(os.path.join(eval_dir, sorted(os.listdir(eval_dir))[0]),
                      args.device)
    if diff != 0.0:
        raise SystemExit(f"training and serving normalise a frame "
                         f"differently: max diff {diff}")

    cfg.model.num_stages = args.stages
    cfg.model.dtype = "bfloat16"
    cfg.model.init_scheme = "scratch"      # no pretrained trunk
    cfg.dataset.image_size = args.size
    cfg.train.batch_size = args.batch
    cfg.train.lr = args.lr
    cfg.train.clip_grad_norm = args.clip
    cfg.train.freeze_base_epochs = 0       # random init: nothing to protect
    cfg.train.lr_patience = 10 ** 9        # the two-phase schedule instead
    cfg.train.print_freq = 10 ** 9
    cfg.train.keep_checkpoints = 1
    cfg.train.checkpoint_dir = os.path.join(args.out, "ckpt")

    grid = dict(stride=cfg.model.downsample, sigma=cfg.dataset.sigma)
    train_ds = CocoKeypoints(
        train_dir, train_ann, input_size=args.size,
        preprocess=T.train_pipeline(args.size, SCALE_RANGE, hflip_prob=0.0),
        **grid)
    val_ds = CocoKeypoints(
        val_dir, val_ann, input_size=args.size,
        preprocess=T.Compose([T.RescaleRelative(1.0), T.Crop(args.size),
                              T.CenterPad(args.size)]), **grid)
    pin = torch.device(args.device).type == "cuda"
    train_loader = Loader(train_ds, args.batch, num_workers=workers,
                          seed=0, pin_memory=pin)
    val_loader = Loader(val_ds, args.batch, shuffle=False,
                        num_workers=workers, deterministic=True,
                        drop_last=False, pin_memory=pin)
    per_epoch = len(train_loader)
    if per_epoch < 1:
        raise SystemExit("--train-images gives no full batch")
    epochs = math.ceil(args.steps / per_epoch)
    drop = max(1, round(epochs * args.lr_drop_at))

    trainer = Trainer(cfg, device=args.device)
    kernels.reset_launch_counts()
    history = []
    t_train = time.time()
    for phase_epochs, lr in ((drop, args.lr), (epochs - drop, args.lr * 0.1)):
        trainer.lr = trainer.plateau.lr = lr
        if phase_epochs:
            history += trainer.fit(train_loader, val_loader,
                                   epochs=phase_epochs)
    train_s = time.time() - t_train
    # every epoch's worker start included
    wait_share = (sum(sum(h["train"]["data_s"]) for h in history)
                  / sum(sum(h["train"]["step_s"]) for h in history))
    print(f"trained {trainer.step} steps ({epochs} epochs of {per_epoch}) "
          f"in {train_s:.1f} s; data-wait share {wait_share:.3f}",
          flush=True)

    # the best checkpoint served and scored, then the same detections at
    # the reference's fixed score 1.0 (no second forward)
    pipe = load_pipeline(cfg.train.checkpoint_dir, device=args.device,
                         model_name=args.model, num_stages=args.stages,
                         input_size=args.size, preprocess_mode="vgg",
                         flip=True, thresh_heatmap=args.thresh_heatmap,
                         downsample=cfg.model.downsample,
                         pad_factor=64 if args.model == "hourglass" else 0)
    results_path = os.path.join(args.out, "results_person.json")
    with contextlib.redirect_stdout(io.StringIO()):
        stats = run_eval_batched(eval_dir, eval_ann, pipe, batch_size=16,
                                 score_mode="person",
                                 results_path=results_path)
    with open(results_path) as f:
        results = json.load(f)
    coco = CocoJson(eval_ann)
    parity = eval_results([{**r, "score": 1.0} for r in results], coco,
                          coco.img_ids(coco.cat_ids("person")))
    with open(os.path.join(cfg.train.checkpoint_dir, "best.json")) as f:
        best = json.load(f)
    summary = {
        "model": args.model, "steps": trainer.step, "epochs": epochs,
        "batch": args.batch,
        "size": args.size, "stages": args.stages,
        "train_images": args.train_images, "eval_images": args.eval_images,
        "loader_workers": workers, "data_wait_share": round(wait_share, 4),
        "best_step": best["step"], "best_val_loss": best.get("best_val"),
        "write_s": round(write_s, 1), "train_s": round(train_s, 1),
        "wall_s": round(time.time() - t_start, 1),
        "normalisation_max_diff": diff,
        "AP_parity_score": round(float(parity["AP"]), 4),
        **{k: round(float(v), 4) for k, v in stats.items()
           if isinstance(v, (int, float))}}
    if torch.cuda.is_available() and pin:
        summary["device"] = torch.cuda.get_device_name(0)
        summary["launches"] = kernels.launch_counts()
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print("SUMMARY", json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
