"""Training CLI of the port (port of rtpose_tpu/train/__main__.py;
reference train/train_VGG19.py entry).

    python -m rtpose_tpu_torch.train --config experiments/vgg19_368x368_sgd.yaml \\
        --set dataset.train_image_dir=/data/coco/train2017 ...

Trains any model family (``model.name``; e.g.
``experiments/shufflenet_v2_368x368.yaml``, or
``experiments/hourglass_256x256.yaml`` with ``--set
dataset.rotate_degrees=0`` until ``RandomRotate`` is ported) on the card
(``--device cuda``, the default); ``--device cpu`` for tests.  Batches
come from :class:`~rtpose_tpu_torch.data.dataset.Loader`
with ``train.data_workers`` worker processes.
"""

from __future__ import annotations

import argparse


def main():
    """Train as the flags say -> (the ``Trainer``, ``Trainer.fit``'s
    per-epoch logs)."""
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config", default=None,
                        help="yaml/json experiment overlay")
    parser.add_argument("--set", nargs="*", default=[],
                        help="dot.path=value overrides")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--vgg-weights", default=None,
                        help="torchvision vgg19 .pth for backbone init "
                             "(reference use_vgg)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu for tests)")
    args = parser.parse_args()

    from ..config import apply_dotlist, load_config
    cfg = load_config(args.config)
    apply_dotlist(cfg, args.set)
    if cfg.train.data_loader not in ("pil", "native"):
        raise SystemExit(
            f"unknown train.data_loader={cfg.train.data_loader!r} "
            f"(expected 'pil' or 'native')")
    if cfg.train.data_loader == "native":
        raise SystemExit(
            "train.data_loader=native is not ported yet: the C++ loader "
            "waits for its JPEG decoder route, ROADMAP.md queue 1 item 9; "
            "use the pil loader")
    if cfg.dataset.rotate_degrees:
        raise SystemExit(
            "dataset.rotate_degrees needs RandomRotate, which is not ported "
            "yet (its cv2-free warpAffine, ROADMAP.md queue 1 item 10); "
            "train with --set dataset.rotate_degrees=0")
    if args.vgg_weights and cfg.model.name != "vgg19":
        raise SystemExit(
            f"--vgg-weights initialises the VGG19 trunk; model.name is "
            f"{cfg.model.name!r}")
    if not cfg.dataset.train_annotations:
        raise SystemExit("dataset.train_annotations is empty — need at "
                         "least one annotation file")

    from ..data import transforms as T
    from ..data.dataset import CocoKeypoints, ConcatKeypoints, Loader
    from .trainer import Trainer

    # the reference trains on a ConcatDataset over ALL annotation files
    # (reference train/train_VGG19.py:50-60); one CocoKeypoints per file,
    # concatenated into a single map-style dataset
    train_parts = [
        CocoKeypoints(
            image_dir=cfg.dataset.train_image_dir,
            ann_file=ann,
            preprocess=T.train_pipeline(
                cfg.dataset.image_size,
                (cfg.dataset.scale_min, cfg.dataset.scale_max),
                cfg.dataset.hflip_prob),
            input_size=cfg.dataset.image_size,
            stride=cfg.model.downsample, sigma=cfg.dataset.sigma)
        for ann in cfg.dataset.train_annotations]
    train_ds = (train_parts[0] if len(train_parts) == 1
                else ConcatKeypoints(train_parts))
    val_ds = CocoKeypoints(
        image_dir=cfg.dataset.val_image_dir,
        ann_file=cfg.dataset.val_annotations,
        preprocess=T.Compose([T.RescaleRelative(1.0),
                              T.Crop(cfg.dataset.image_size),
                              T.CenterPad(cfg.dataset.image_size)]),
        input_size=cfg.dataset.image_size,
        stride=cfg.model.downsample, sigma=cfg.dataset.sigma)

    trainer = Trainer(cfg, device=args.device)
    pin = trainer.device.type == "cuda"
    train_loader = Loader(train_ds, cfg.train.batch_size,
                          num_workers=cfg.train.data_workers,
                          seed=cfg.train.seed, pin_memory=pin)
    # deterministic: same crops/jitter every epoch so the plateau/best
    # tracking follows the model, not per-epoch aug noise; no drop_last
    # so val sets smaller than a batch still evaluate
    val_loader = Loader(val_ds, cfg.train.batch_size, shuffle=False,
                        num_workers=cfg.train.data_workers,
                        deterministic=True, drop_last=False, pin_memory=pin)

    if args.vgg_weights:
        from ..models.convert import (import_vgg19_imagenet,
                                      load_torch_checkpoint)
        import_vgg19_imagenet(load_torch_checkpoint(args.vgg_weights),
                              trainer.model)
        print("initialized backbone from ImageNet vgg19 weights")

    history = trainer.fit(train_loader, val_loader, epochs=args.epochs)
    return trainer, history


if __name__ == "__main__":
    main()
