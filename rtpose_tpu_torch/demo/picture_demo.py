"""Single-image demo (port of rtpose_tpu/demo/picture_demo.py; reference
demo/picture_demo.py), and the pipeline construction the port's CLIs
share.

    python -m rtpose_tpu_torch.demo.picture_demo --image ski.jpg \
        --weight pose_model.pth --preprocess rtpose --output result.png

Runs on the card (``--device cuda``, the default); ``--device cpu`` for
tests.  The picture is read with ``data.imread.read_bgr``, drawn with
``utils.draw.draw_people`` and written with ``data.imwrite.write_bgr``
(cv2's pixels, without cv2).
"""

from __future__ import annotations

import argparse


def build_pipeline(args):
    """A :class:`..infer.pipeline.PosePipeline` from parsed CLI args.

    ``--weight`` is a reference ``.pth``/``.ckpt`` file or a directory of
    the port's training checkpoints (best step; a JAX package checkpoint
    comes as a ``.pth`` through ``scripts/export_jax_checkpoint.py``).
    ``--fp32`` builds the model in fp32 and turns TF32 off for cuDNN
    convolutions and matmuls, process-wide: cuDNN convolves fp32 in TF32
    by default.  ``--device-resize`` has no effect: the port always
    resizes on the card.  Any family of ``models.get_model``: hourglass
    serves at stride 4 (rtpose_tpu/demo/picture_demo.py:26-32), the
    others at stride 8; the pipeline pads each family's inputs to the
    multiple it needs (hourglass 64)."""
    import os

    import torch

    from ..infer.pipeline import load_pipeline
    from ..models import FAMILIES

    if args.model not in FAMILIES:
        raise SystemExit(f"--model {args.model}: unknown model family; "
                         f"known: {', '.join(FAMILIES)}")
    if args.fp32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    is_ckpt_dir = bool(args.weight) and os.path.isdir(args.weight)
    pipe = load_pipeline(
        checkpoint_dir=args.weight if is_ckpt_dir else None,
        torch_weights=None if is_ckpt_dir else args.weight,
        device=getattr(args, "device", "cuda"),
        model_name=args.model, num_stages=args.stages,
        input_size=args.input_size, preprocess_mode=args.preprocess,
        flip=args.flip,
        dtype=torch.float32 if args.fp32 else torch.bfloat16,
        downsample=getattr(args, "downsample", 0) or (
            4 if args.model == "hourglass" else 8),
        pad_factor=getattr(args, "pad_to", 0),
        gaussian_filt=getattr(args, "gaussian_filt", False))
    if args.weight:
        print(f"loaded weights from {args.weight}")
    return pipe


FP32_HELP = ("fp32 model with TF32 off (cuDNN convolves fp32 in TF32 by "
             "default, about three decimal digits); the default is bf16")


def add_common_args(parser):
    parser.add_argument("--model", default="vgg19",
                        help="model family: vgg19, mobilenet, hourglass, "
                             "shufflenet_v2, openpose_v2, atrous_resnet50, "
                             "atrous_cpm, atrous_cpm_shared")
    parser.add_argument("--weight", default=None,
                        help="reference .pth/.ckpt, or a directory of the "
                             "port's training checkpoints (best step)")
    parser.add_argument("--preprocess", default="rtpose",
                        choices=["rtpose", "vgg", "inception", "ssd"])
    parser.add_argument("--input-size", type=int, default=368)
    parser.add_argument("--stages", type=int, default=6,
                        help="refinement stages / stacks")
    parser.add_argument("--flip", action="store_true",
                        help="left/right flip TTA")
    parser.add_argument("--gaussian-filt", action="store_true",
                        help="sigma=3 smoothing of the NMS refine patch "
                             "(reference bool_gaussian_filt, default off)")
    parser.add_argument("--fp32", action="store_true", help=FP32_HELP)
    parser.add_argument("--device-resize", action="store_true",
                        help="accepted for the JAX CLI's sake; no effect: "
                             "the port always resizes on the card")
    parser.add_argument("--downsample", type=int, default=0,
                        help="model output stride (0 = by model family: "
                             "4 for hourglass, 8 otherwise)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu for tests)")


def main():
    from ..data.imread import read_bgr
    from ..data.imwrite import write_bgr
    from ..utils.draw import draw_people
    from ..utils.human import humans_from_people

    parser = argparse.ArgumentParser(description=__doc__)
    add_common_args(parser)
    parser.add_argument("--image", required=True)
    parser.add_argument("--output", default="result.png")
    args = parser.parse_args()

    pipe = build_pipeline(args)
    img = read_bgr(args.image)
    people, heat, paf, meta = pipe.run(img)
    humans = humans_from_people(people)
    print(f"found {len(humans)} people")
    for h in humans:
        print(f"  score={h.score:.2f} parts={sorted(h.body_parts)}")
    out = draw_people(img, people, meta)
    write_bgr(args.output, out)
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
