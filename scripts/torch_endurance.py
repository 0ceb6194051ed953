"""Training endurance run of the PyTorch port: the flagship trained for a
wall-clock budget from JPEGs through the native loader (the port's
counterpart of scripts/hw_endurance.py).

Trains VGG19 (6 stages, 368 px, bf16, batch 72 by default) fed by
``NativeLoader(uint8_output=True)`` (uint8 canvases in pinned memory,
normalised in their content windows on the card) through
``Trainer.train_step``, checkpoints every ``--ckpt-every`` steps through
``CheckpointManager`` (``--keep`` live), and logs a JSON line per
window of ``--log-every`` steps: step time, loss, host RSS, the card's
allocated and reserved memory (a growing caching allocator or pinned
pool is this card's form of a leak), live checkpoints.  At the end it
checkpoints and writes a summary: step-time percentiles, the ratio of
the last 10 windows' step time to the first 10, RSS and card memory at
start, end and peak.

Crash and restore come from outside: kill -9 this process and launch it
again with the same ``--out``; it resumes from the newest checkpoint
(``resumed_from``).  It starts fresh only where ``restore_latest`` finds
no checkpoint; a checkpoint it cannot read is an error, never a fresh
start.

    python3 scripts/torch_endurance.py --hours 3
    python3 scripts/torch_endurance.py --device cpu --hours 0.002 \\
        --size 64 --stages 1 --batch 4 --images 16 --threads 2 \\
        --ckpt-every 4 --log-every 2

The training set (the scene renderer's JPEGs at quality 92, as
scripts/hw_train_native_loader.py's ``write_train_set``) is written
under ``--out`` (default the git-ignored
``rtpose_tpu_torch/build/torch_endurance``) and reused by a later launch
with the same ``--images`` and ``--size``.  Prints a JSON line per
window (appended to ``<out>/soak.jsonl``), then one ``SUMMARY`` line
(also ``<out>/summary_<step>.json``).
"""

import argparse
import itertools
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from torch_train_synth import write_train_set  # noqa: E402


def rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return -1.0


def percentile(values, q):
    """The q-th percentile of `values`, None for no values."""
    return round(float(np.percentile(values, q)), 4) if len(values) \
        else None


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--hours", type=float, default=3.0)
    ap.add_argument("--out", default=os.path.join(
        ROOT, "rtpose_tpu_torch", "build", "torch_endurance"))
    ap.add_argument("--images", type=int, default=512)
    ap.add_argument("--size", type=int, default=368)
    ap.add_argument("--batch", type=int, default=72)
    ap.add_argument("--stages", type=int, default=6)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--ckpt-every", type=int, default=1000)
    ap.add_argument("--keep", type=int, default=3)
    ap.add_argument("--log-every", type=int, default=25,
                    help="steps per window")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from rtpose_tpu_torch.config import Config
    from rtpose_tpu_torch.data.dataset import CocoKeypoints
    from rtpose_tpu_torch.data.native_loader import NativeLoader
    from rtpose_tpu_torch.device import resolve_device
    from rtpose_tpu_torch.ops import kernels
    from rtpose_tpu_torch.train.checkpoint import CheckpointManager
    from rtpose_tpu_torch.train.trainer import Trainer

    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    os.makedirs(args.out, exist_ok=True)
    img_dir = os.path.join(args.out, "train")
    ann_file = os.path.join(args.out, "train.json")
    stamp_file = os.path.join(args.out, "train.stamp.json")
    stamp = {"images": args.images, "size": args.size}
    have = None
    if os.path.isfile(stamp_file):
        with open(stamp_file) as f:
            have = json.load(f)
    if (have == stamp and os.path.isfile(ann_file) and os.path.isdir(img_dir)
            and len(os.listdir(img_dir)) == args.images):
        print("reusing rendered JPEG training set", flush=True)
    else:
        print("rendering JPEG training set...", flush=True)
        img_dir, ann_file = write_train_set(args.out, 0, args.images,
                                            args.size, max_people=4)
        with open(stamp_file, "w") as f:
            json.dump(stamp, f)

    cfg = Config()
    cfg.model.num_stages = args.stages
    cfg.model.dtype = "bfloat16" if on_card else "float32"
    cfg.model.init_scheme = "scratch"
    cfg.dataset.image_size = args.size
    cfg.train.batch_size = args.batch
    cfg.train.lr = 0.05
    cfg.train.clip_grad_norm = 1.0
    cfg.train.freeze_base_epochs = 0
    cfg.train.print_freq = 10 ** 9

    ds = CocoKeypoints(img_dir, ann_file, input_size=args.size)
    loader = NativeLoader(ds, batch_size=args.batch, shuffle=True,
                          threads=args.threads, seed=0, prefetch=4,
                          uint8_output=True, pin_memory=on_card)
    tr = Trainer(cfg, device=device)
    mgr = CheckpointManager(os.path.join(args.out, "ckpt"), keep=args.keep)

    def live_checkpoints():
        return sorted(int(n[len("step_"):-len(".meta.json")])
                      for n in os.listdir(mgr.directory)
                      if n.startswith("step_") and n.endswith(".meta.json"))

    global_step = 0
    resumed_from = None
    # fresh only where there is no checkpoint: one that does not load
    # raises here rather than being trained over
    restored = mgr.restore_latest(device)
    if restored is None:
        print("fresh start (no checkpoint found)", flush=True)
    else:
        tr.restore(restored)
        global_step = int(restored[1].get("step", tr.step))
        resumed_from = global_step
        print(f"resumed_from step {global_step}", flush=True)

    def batches():
        for _ in itertools.count():
            yield from loader

    def step(b):
        return tr.train_step(b["image"], b["keypoints"], b["mask"],
                             b["valid_xywh"])

    def card_mb(fn):
        return round(fn(device) / 2 ** 20, 1) if on_card else None

    it = batches()
    t_c = time.perf_counter()
    logs = step(next(it))
    print(f"first step in {time.perf_counter() - t_c:.1f}s; soaking...",
          flush=True)
    kernels.reset_launch_counts()

    rss_start = rss_max = rss_mb()
    reserved_start = reserved_max = card_mb(torch.cuda.memory_reserved)
    window_step_s = []
    deadline = time.time() + args.hours * 3600
    t_run0 = time.perf_counter()
    steps_run = 0
    while time.time() < deadline:
        t_w = time.perf_counter()
        for _ in range(args.log_every):
            logs = step(next(it))
            steps_run += 1
            global_step += 1
            if args.ckpt_every and global_step % args.ckpt_every == 0:
                mgr.save(tr.state_dict(), step=global_step,
                         meta={"step": global_step, "loss": logs["loss"]})
        step_s = (time.perf_counter() - t_w) / args.log_every
        window_step_s.append(step_s)
        rss = rss_mb()
        rss_max = max(rss_max, rss)
        reserved = card_mb(torch.cuda.memory_reserved)
        if on_card:
            reserved_max = max(reserved_max, reserved)
        rec = {"t": round(time.perf_counter() - t_run0, 1),
               "step": global_step, "loss": round(logs["loss"], 5),
               "step_s": round(step_s, 4), "rss_mb": round(rss, 1),
               "card_allocated_mb": card_mb(torch.cuda.memory_allocated),
               "card_reserved_mb": reserved,
               "ckpts": len(live_checkpoints())}
        with open(os.path.join(args.out, "soak.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps(rec), flush=True)
    it.close()

    mgr.save(tr.state_dict(), step=global_step,
             meta={"step": global_step, "loss": logs["loss"]})
    wall = time.perf_counter() - t_run0
    ws = np.array(window_step_s)
    summary = {
        "stop_reason": "deadline",
        "resumed_from": resumed_from,
        "steps_this_run": steps_run,
        "global_step": global_step,
        "wall_s": round(wall, 1),
        "img_per_s": round(steps_run * args.batch / wall, 1),
        "final_loss": round(logs["loss"], 5),
        "step_s_p50": percentile(ws, 50),
        "step_s_p99": percentile(ws, 99),
        "step_s_last10_over_first10": round(
            float(ws[-10:].mean() / ws[:10].mean()), 4) if len(ws) >= 20
            else None,
        "windows": len(ws),
        "rss_start_mb": round(rss_start, 1),
        "rss_end_mb": round(rss_mb(), 1),
        "rss_max_mb": round(rss_max, 1),
        "card_reserved_start_mb": reserved_start,
        "card_reserved_end_mb": card_mb(torch.cuda.memory_reserved),
        "card_reserved_max_mb": reserved_max,
        "card_allocated_end_mb": card_mb(torch.cuda.memory_allocated),
        "ckpt_every": args.ckpt_every, "keep": args.keep,
        "live_ckpts": live_checkpoints(),
    }
    if on_card:
        summary["card"] = torch.cuda.get_device_name(device)
        summary["launches"] = kernels.launch_counts()
    with open(os.path.join(args.out, f"summary_{global_step}.json"),
              "w") as f:
        json.dump(summary, f, indent=1)
    print("SUMMARY", json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
