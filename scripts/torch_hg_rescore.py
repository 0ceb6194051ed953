"""Re-evaluate a trained hourglass checkpoint with person-score ranking
(the port's counterpart of scripts/hg_rescore.py).

The hourglass chain's parity score (a fixed detection score of 1.0, as
the reference) gives COCOeval no ranking to suppress soft heatmaps'
phantom partial people.  This runs the same checkpoint's eval with
``score_mode="person"`` (one forward a frame) and recomputes the parity
AP from the same detections, to split the plateau into the ranking
artifact and the backbone.

    python3 scripts/torch_hg_rescore.py \\
        --ckpt rtpose_tpu_torch/build/torch_train_eval
    python3 scripts/torch_hg_rescore.py --device cpu --stages 1 \\
        --size 64 --ckpt <torch_train_to_eval --out>

``--ckpt`` is the work directory of ``scripts/torch_train_to_eval.py
--model hourglass``: its checkpoints under ``ckpt/``, its held-out set
under ``heldout/``.  Prints one ``SUMMARY`` JSON line (on the card with
the kernels' launches).
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ckpt", default=os.path.join(
        ROOT, "rtpose_tpu_torch", "build", "torch_train_eval"))
    ap.add_argument("--stages", type=int, default=8)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from rtpose_tpu_torch.data.coco_json import CocoJson
    from rtpose_tpu_torch.evalx.harness import eval_results, run_eval_batched
    from rtpose_tpu_torch.infer.pipeline import load_pipeline
    from rtpose_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    pipe = load_pipeline(os.path.join(args.ckpt, "ckpt"),
                         device=args.device, model_name="hourglass",
                         num_stages=args.stages, input_size=args.size,
                         preprocess_mode="vgg", flip=True, downsample=4,
                         pad_factor=64)
    img_dir = os.path.join(args.ckpt, "heldout", "images")
    ann_file = os.path.join(args.ckpt, "heldout", "annotations.json")
    results_path = os.path.join(args.ckpt, "results_person_rescore.json")
    stats = run_eval_batched(img_dir, ann_file, pipe, batch_size=16,
                             score_mode="person",
                             results_path=results_path)
    with open(results_path) as f:
        results = json.load(f)
    coco = CocoJson(ann_file)
    parity = eval_results([{**r, "score": 1.0} for r in results], coco,
                          coco.img_ids(coco.cat_ids("person")))
    out = {"AP_person": round(float(stats["AP"]), 4),
           "AP50_person": round(float(stats["AP50"]), 4),
           "AP75_person": round(float(stats["AP75"]), 4),
           "AR_person": round(float(stats["AR"]), 4),
           "AP_parity": round(float(parity["AP"]), 4),
           "AP50_parity": round(float(parity["AP50"]), 4)}
    if pipe.device.type == "cuda":
        out["launches"] = kernels.launch_counts()
    print("SUMMARY", json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
