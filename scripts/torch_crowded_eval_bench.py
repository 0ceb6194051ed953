"""Crowded-heavy eval throughput of the PyTorch port: retry on overflow
against raised caps from the start (the port's counterpart of
scripts/crowded_eval_bench.py).

The truncation retry decodes overflowing frames again, from their maps
on the card, in one extra batched decode per collect
(``PosePipeline._collect``).  On crowd-dense data that extra decode runs
on most collects; a pipeline built with the raised caps from the start
avoids it, but then every frame pays the bigger decode (K=64 scoring,
max_candidates 256 -> 1024, max_total_conns 160 -> 608).  This measures
both at three crowd densities of rendered scenes (scripts/
torch_train_synth.py's ``write_coco_eval_set``) through
``run_eval_batched``: a warm-up pass, then the median of ``--trials``
timed passes (host-clock numbers spread; keep the trials).

    python3 scripts/torch_crowded_eval_bench.py \\
        --ckpt rtpose_tpu_torch/build/torch_train_eval/ckpt
    python3 scripts/torch_crowded_eval_bench.py --device cpu --stages 1 \\
        --size 64 --n 8 --batch 4 --sets light,heavy --trials 1 \\
        --ckpt <dir>

``--ckpt``: a directory of the port's training checkpoints (its best
step) or a ``.pth``.  Prints a JSON row per (config, set): img/s,
retried and truncated frames, AP (and a ``SUMMARY`` line of them with,
on the card, the kernels' launches); writes them to ``<out>/results.json``
and each arm's detections to ``<out>/detections_<config>_<set>.json``;
then the comparison table.  ``--out`` defaults to the git-ignored
``rtpose_tpu_torch/build/crowded_bench``.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from torch_train_synth import write_coco_eval_set  # noqa: E402

# three densities on the same canvas: light (~no overflow), soak-like
# (the soak's 1..8 uniform mix), heavy (every frame crowd-dense)
DENSITIES = {"light": 3, "soak-like": 8, "heavy": 14}


def configs():
    """Arm name -> the pipeline's cap keywords."""
    from rtpose_tpu_torch.infer.pipeline import RETRY_CAPS

    return {
        "default+retry": dict(),                   # retries fire on overflow
        # every frame runs the big decode; auto_retry off so a frame that
        # overflows even these caps can't fire an identical-caps decode
        # and bias the arm whose point is avoiding retry decodes
        "raised-caps": dict(**RETRY_CAPS, auto_retry=False),
    }


def write_sets(out, n, size, names):
    """The density sets `names` -> {name: (image dir, annotation file)}."""
    return {name: write_coco_eval_set(
                os.path.join(out, name), seed=1000 + si, n_images=n,
                size=size, max_people=DENSITIES[name])
            for si, name in enumerate(DENSITIES) if name in names}


def bench(sets, make_pipeline, batch, trials, out):
    """Each arm of :func:`configs` over each set -> rows; the last trial's
    detections of each (arm, set) go to ``<out>/detections_*.json``."""
    from rtpose_tpu_torch.evalx.harness import run_eval_batched

    rows = []
    for cfg_name, caps in configs().items():
        pipe = make_pipeline(**caps)
        for set_name, (img_dir, ann) in sets.items():
            with open(ann) as f:
                n = len(json.load(f)["images"])
            # the warm-up pass builds the kernels and cuDNN's plans (and
            # the retry arm's raised-caps decode)
            run_eval_batched(img_dir, ann, pipe, batch_size=batch,
                             limit=2 * batch)
            detections = os.path.join(
                out, f"detections_{cfg_name}_{set_name}.json")
            times = []
            for _ in range(trials):
                t0 = time.perf_counter()
                stats = run_eval_batched(img_dir, ann, pipe,
                                         batch_size=batch,
                                         results_path=detections)
                times.append(time.perf_counter() - t0)
            wall = sorted(times)[len(times) // 2]
            row = {"config": cfg_name, "set": set_name, "images": n,
                   "pipeline_s": stats["pipeline_s"],
                   "img_per_s": round(n / wall, 2),
                   "wall_s": round(wall, 2),
                   "trials_s": [round(t, 2) for t in sorted(times)],
                   "n_retried": stats["frames_retried"],
                   "n_truncated": stats["frames_truncated"],
                   "AP": round(stats["AP"], 4)}
            rows.append(row)
            print(json.dumps(row), flush=True)
        del pipe
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ckpt", required=True,
                    help="checkpoint directory (torch_train_to_eval's "
                         "<out>/ckpt) or a .pth")
    ap.add_argument("--stages", type=int, default=2)
    ap.add_argument("--size", type=int, default=184)
    ap.add_argument("--n", type=int, default=160)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--sets", default=",".join(DENSITIES),
                    help="comma-separated densities: light, soak-like, "
                         "heavy")
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(
        ROOT, "rtpose_tpu_torch", "build", "crowded_bench"))
    args = ap.parse_args(argv)
    names = args.sets.split(",")
    unknown = set(names) - set(DENSITIES)
    if unknown:
        raise SystemExit(f"--sets: unknown {sorted(unknown)}; known: "
                         f"{', '.join(DENSITIES)}")

    import torch

    from rtpose_tpu_torch.infer.pipeline import load_pipeline
    from rtpose_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    sets = write_sets(args.out, args.n, args.size, names)
    is_dir = os.path.isdir(args.ckpt)

    def make_pipeline(**caps):
        return load_pipeline(
            checkpoint_dir=args.ckpt if is_dir else None,
            torch_weights=None if is_dir else args.ckpt,
            device=args.device, num_stages=args.stages,
            input_size=args.size, preprocess_mode="vgg", flip=True, **caps)

    rows = bench(sets, make_pipeline, args.batch, args.trials, args.out)
    out_json = os.path.join(args.out, "results.json")
    with open(out_json, "w") as f:
        json.dump(rows, f, indent=1)
    print(f"wrote {out_json}")

    # the decision quantity: at each density, which config is faster?
    print("\nconfig comparison (img/s):")
    for set_name in sets:
        a = next(r for r in rows if r["set"] == set_name
                 and r["config"] == "default+retry")
        b = next(r for r in rows if r["set"] == set_name
                 and r["config"] == "raised-caps")
        frac = a["n_retried"] / a["images"]
        winner = ("default+retry" if a["img_per_s"] >= b["img_per_s"]
                  else "raised-caps")
        print(f"  {set_name:10s} retry-frac {frac:4.0%}  "
              f"default+retry {a['img_per_s']:6.2f}  "
              f"raised-caps {b['img_per_s']:6.2f}  winner: {winner}")
    summary = {"rows": rows}
    if torch.device(args.device).type == "cuda":
        summary["card"] = torch.cuda.get_device_name(0)
        summary["launches"] = kernels.launch_counts()
    print("SUMMARY", json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
