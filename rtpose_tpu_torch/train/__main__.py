"""Training CLI of the port (port of rtpose_tpu/train/__main__.py;
reference train/train_VGG19.py entry).

    python -m rtpose_tpu_torch.train --config experiments/vgg19_368x368_sgd.yaml \\
        --set dataset.train_image_dir=/data/coco/train2017 ...

Trains any model family (``model.name``; e.g.
``experiments/shufflenet_v2_368x368.yaml``, or
``experiments/hourglass_256x256.yaml``, which rotates by up to 40
degrees) on the card (``--device cuda``, the default); ``--device cpu``
for tests.  Batches come from
:class:`~rtpose_tpu_torch.data.dataset.Loader` with
``train.data_workers`` worker processes (``train.data_loader=pil``, the
default), or from :class:`~rtpose_tpu_torch.data.native_loader.NativeLoader`
with ``train.data_workers`` C++ threads (``train.data_loader=native``:
uint8 canvases, normalized on the card; no rotation).

Under ``torchrun`` each process is one rank of the JAX package's mesh
trainer (rtpose_tpu/train/__main__.py:105-119)::

    torchrun --nproc-per-node 8 -m rtpose_tpu_torch.train \
        --config experiments/vgg19_368x368_sgd.yaml --set ...

It joins the process group (NCCL on the cards, gloo with ``--device
cpu``), builds the ``cfg.parallel.num_data`` x ``cfg.parallel.num_model``
mesh over the ranks, and draws its rows of each global batch
(``train.batch_size``); ``--vgg-weights`` is loaded by every rank and
rank 0's copy is broadcast.  Rank 0 writes the checkpoints.
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
    if cfg.train.data_loader == "native" and cfg.dataset.rotate_degrees:
        raise SystemExit(
            "train.data_loader=native does not support "
            "dataset.rotate_degrees — use the pil loader")
    if args.vgg_weights and cfg.model.name != "vgg19":
        raise SystemExit(
            f"--vgg-weights initialises the VGG19 trunk; model.name is "
            f"{cfg.model.name!r}")
    if not cfg.dataset.train_annotations:
        raise SystemExit("dataset.train_annotations is empty — need at "
                         "least one annotation file")

    from ..data import transforms as T
    from ..data.dataset import CocoKeypoints, ConcatKeypoints, Loader
    from ..parallel.distributed import init_from_env, rank_and_world
    from ..parallel.mesh import make_mesh
    from .trainer import Trainer

    device = init_from_env(args.device)
    mesh = None
    if rank_and_world()[1] > 1:
        mesh = make_mesh(cfg.parallel.num_data, cfg.parallel.num_model)
    rows = dict(rank=mesh.data_index, world=mesh.num_data) if mesh else {}

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
                cfg.dataset.hflip_prob, cfg.dataset.rotate_degrees),
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

    init_fn = None
    if args.vgg_weights:
        from ..models.convert import (import_vgg19_imagenet,
                                      load_torch_checkpoint)
        vgg = load_torch_checkpoint(args.vgg_weights)

        def init_fn(model):
            import_vgg19_imagenet(vgg, model)
            if rank_and_world()[0] == 0:
                print("initialized backbone from ImageNet vgg19 weights")

    # the weights are broadcast from rank 0 (Trainer: parallel.replicate)
    trainer = Trainer(cfg, device=device, **{
        k: v for k, v in (("mesh", mesh), ("init_fn", init_fn))
        if v is not None})
    pin = trainer.device.type == "cuda"
    if cfg.train.data_loader == "native":
        # the C++ imgpipe pool and uint8 canvases; the trainer normalizes
        # them inside their content windows on the card
        from ..data.native_loader import NativeLoader
        train_loader = NativeLoader(
            train_ds, cfg.train.batch_size, shuffle=True,
            threads=cfg.train.data_workers, seed=cfg.train.seed,
            uint8_output=True, pin_memory=pin,
            aug_kwargs=dict(
                square_edge=cfg.dataset.image_size,
                scale_range=(cfg.dataset.scale_min, cfg.dataset.scale_max),
                hflip_prob=cfg.dataset.hflip_prob), **rows)
        # val: photometrics/flip/scale sampling off; crop offsets for
        # oversized images still sample, so deterministic=True pins them
        # to the same values every epoch and drop_last=False keeps sets
        # smaller than a batch evaluable
        val_loader = NativeLoader(
            val_ds, cfg.train.batch_size, shuffle=False,
            threads=cfg.train.data_workers, uint8_output=True,
            deterministic=True, drop_last=False, pin_memory=pin,
            aug_kwargs=dict(
                square_edge=cfg.dataset.image_size,
                scale_range=1.0, hflip_prob=0.0, color_jitter=0.0,
                jpeg_prob=0.0, grayscale_prob=0.0), **rows)
    else:
        train_loader = Loader(train_ds, cfg.train.batch_size,
                              num_workers=cfg.train.data_workers,
                              seed=cfg.train.seed, pin_memory=pin, **rows)
        # deterministic: same crops/jitter every epoch so the plateau/best
        # tracking follows the model, not per-epoch aug noise; no
        # drop_last so val sets smaller than a batch still evaluate
        val_loader = Loader(val_ds, cfg.train.batch_size, shuffle=False,
                            num_workers=cfg.train.data_workers,
                            deterministic=True, drop_last=False,
                            pin_memory=pin, **rows)

    history = trainer.fit(train_loader, val_loader, epochs=args.epochs)
    return trainer, history


if __name__ == "__main__":
    main()
