r"""COCO evaluation CLI of the port (port of rtpose_tpu/evalx/__main__.py;
reference evaluate/evaluation.py).

    python -m rtpose_tpu_torch.evalx --image-dir /data/coco/val2017 \
        --ann /data/coco/annotations/person_keypoints_val2017.json \
        --weight ckpt.pth --preprocess vgg --flip --batch 8

Runs on the card (``--device cuda``, the default); ``--device cpu`` for
tests.  ``--data-parallel`` splits each batch over every visible card.
Prints the stats JSON, then ``mAP (OKS .50:.95) = ...``.  Several
processes (one per host) split the image ids with
``harness.run_eval_sharded``.
"""

from __future__ import annotations

import argparse
import json

from ..demo.picture_demo import FP32_HELP


def main():
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--image-dir", required=True)
    parser.add_argument("--ann", required=True)
    parser.add_argument("--weight", default=None,
                        help="reference .pth/.ckpt, or a directory of the "
                             "port's training checkpoints (best step); a "
                             "JAX package checkpoint: export it with "
                             "scripts/export_jax_checkpoint.py")
    parser.add_argument("--model", default="vgg19",
                        help="model family: vgg19, mobilenet, hourglass, "
                             "shufflenet_v2, openpose_v2, atrous_resnet50, "
                             "atrous_cpm, atrous_cpm_shared")
    parser.add_argument("--preprocess", default="vgg")
    parser.add_argument("--input-size", type=int, default=368)
    parser.add_argument("--stages", type=int, default=6,
                        help="refinement stages / stacks")
    parser.add_argument("--downsample", type=int, default=0,
                        help="model output stride (0 = by model family: "
                             "4 for hourglass, 8 otherwise)")
    parser.add_argument("--batch", type=int, default=0,
                        help=">0: batched bucketed eval "
                             "(harness.run_eval_batched)")
    parser.add_argument("--pad-to", type=int, default=0, metavar="N",
                        help="pad eval shapes up to multiples of N px "
                             "(e.g. 64): fewer shape buckets; the extra "
                             "zero border perturbs edge activations "
                             "slightly. 0 = exact stride-8 pads")
    parser.add_argument("--data-parallel", action="store_true",
                        help="shard eval batches over every visible card "
                             "(a model replica each, PosePipeline mesh "
                             "serving); implies --batch, 4 frames a card "
                             "by default")
    parser.add_argument("--gaussian-filt", action="store_true",
                        help="sigma=3 NMS refine smoothing (reference "
                             "bool_gaussian_filt, default off)")
    parser.add_argument("--multiscale", default=None, metavar="S1,S2,...",
                        help="comma-separated TTA scale factors (e.g. "
                             "0.5,1.0,1.5,2.0): multi-scale eval; "
                             "composes with --batch and --data-parallel "
                             "(each stacked chunk splits over the cards)")
    parser.add_argument("--flip", action="store_true", default=True)
    parser.add_argument("--no-flip", dest="flip", action="store_false")
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--score-mode", choices=("parity", "person"),
                        default="parity",
                        help="'parity': fixed detection score 1.0 like the "
                             "reference (coco_eval.py:151); 'person': rank "
                             "detections by assembled person score "
                             "(strictly better mAP, breaks results-JSON "
                             "parity)")
    parser.add_argument("--vis-dir", default=None,
                        help="write each frame with its people drawn here, "
                             "under its file_name")
    parser.add_argument("--results", default=None,
                        help="write results json here")
    parser.add_argument("--fp32", action="store_true", help=FP32_HELP)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu for tests)")
    args = parser.parse_args()

    scales = None
    if args.multiscale:
        try:
            scales = tuple(float(s) for s in args.multiscale.split(","))
        except ValueError:
            raise SystemExit(f"--multiscale: could not parse "
                             f"{args.multiscale!r} as comma-separated "
                             f"floats")
        if not scales or any(s <= 0 for s in scales):
            raise SystemExit("--multiscale needs positive scale factors")

    mesh = None
    if args.data_parallel:
        from ..parallel.mesh import local_devices, make_mesh
        mesh = make_mesh(devices=local_devices(args.device))
        args.batch = args.batch or 4 * mesh.num_data

    from ..demo.picture_demo import build_pipeline
    pipe = build_pipeline(args, mesh=mesh)

    if args.batch:
        from .harness import run_eval_batched
        stats = run_eval_batched(args.image_dir, args.ann, pipe,
                                 batch_size=args.batch,
                                 vis_dir=args.vis_dir, limit=args.limit,
                                 score_mode=args.score_mode,
                                 results_path=args.results,
                                 scales=scales)
    else:
        from .harness import run_eval
        stats = run_eval(args.image_dir, args.ann, pipe,
                         vis_dir=args.vis_dir, limit=args.limit,
                         score_mode=args.score_mode,
                         results_path=args.results, scales=scales)
    print(json.dumps(stats, indent=2))
    print(f"mAP (OKS .50:.95) = {stats['AP']:.4f}")
    return stats


if __name__ == "__main__":
    main()
