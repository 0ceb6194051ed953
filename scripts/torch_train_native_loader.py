"""Train the port through the native loader from JPEGs on disk and measure
the loop (the port's counterpart of scripts/hw_train_native_loader.py).

Writes a rendered training set as JPEGs with COCO ``person_keypoints``
JSON (``utils/synth_coco.py``, COCO's commonest frame sizes), trains VGG19
through ``data/native_loader.py`` ``NativeLoader`` (uint8 canvases in
pinned memory, normalised inside their content windows on the card) and
``Trainer.run_epoch`` for ``--steps`` steps, then reads the loader alone
over the same set.  Prints one ``SUMMARY`` JSON line: steady img/s
after the first step, the data-wait share (the time the step loop waits
for its batch over the loop's time), the loader alone in img/s, and the
process's CPU seconds over wall seconds (the loader's threads, the
coordinator and the step loop together), beside nproc.

    python3 scripts/torch_train_native_loader.py --steps 300
    python3 scripts/torch_train_native_loader.py --device cpu --size 64 \\
        --stages 1 --batch 4 --steps 4 --images 16 --threads 2

``--out`` defaults to the git-ignored ``rtpose_tpu_torch/build/
torch_native_loader``; the set is written anew on every run.
"""

import argparse
import contextlib
import io
import itertools
import json
import os
import shutil
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPES = ((480, 640), (640, 480), (427, 640))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--images", type=int, default=512)
    ap.add_argument("--size", type=int, default=368)
    ap.add_argument("--batch", type=int, default=72)
    ap.add_argument("--stages", type=int, default=6)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--threads", type=int, default=0,
                    help="C++ threads (0: nproc)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(
        ROOT, "rtpose_tpu_torch", "build", "torch_native_loader"))
    args = ap.parse_args()

    import torch

    from rtpose_tpu_torch.config import Config
    from rtpose_tpu_torch.data.dataset import CocoKeypoints
    from rtpose_tpu_torch.data.native_loader import NativeLoader
    from rtpose_tpu_torch.native import imgpipe
    from rtpose_tpu_torch.train.trainer import Trainer
    from rtpose_tpu_torch.utils.synth_coco import (training_frames,
                                                   write_synth_coco)

    nproc = len(os.sched_getaffinity(0))
    threads = args.threads or nproc
    shutil.rmtree(args.out, ignore_errors=True)
    t0 = time.perf_counter()
    rng = np.random.RandomState(0)
    img_dir, ann = write_synth_coco(os.path.join(args.out, "train"),
                                    training_frames(rng, [
                                        SHAPES[i % 3]
                                        for i in range(args.images)]))
    print(f"wrote {args.images} JPEGs in {time.perf_counter() - t0:.1f} s; "
          f"imgpipe {imgpipe.loaded_library()} over "
          f"{imgpipe.pillow_libjpeg()}", flush=True)

    cfg = Config()
    cfg.model.num_stages = args.stages
    cfg.model.dtype = "bfloat16" if args.device != "cpu" else "float32"
    cfg.dataset.image_size = args.size
    cfg.train.freeze_base_epochs = 0
    cfg.train.batch_size = args.batch
    trainer = Trainer(cfg, device=args.device)
    on_card = trainer.device.type == "cuda"
    ds = CocoKeypoints(img_dir, ann, input_size=args.size)

    def loader(seed):
        return NativeLoader(ds, args.batch, threads=threads, seed=seed,
                            uint8_output=True, pin_memory=on_card)

    def endless():
        for epoch in itertools.count():
            yield from loader(epoch)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    sync()
    cpu0, t0 = time.process_time(), time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        logs = trainer.run_epoch(itertools.islice(endless(), args.steps),
                                 log_every=10 ** 9)
    sync()
    wall = time.perf_counter() - t0
    cpu = time.process_time() - cpu0
    steady = sum(logs["step_s"][1:])
    summary = {
        "steps": args.steps, "batch": args.batch, "size": args.size,
        "stages": args.stages, "threads": threads, "nproc": nproc,
        "device": str(trainer.device),
        "mean_loss": logs["loss"],
        "wall_s": round(wall, 2),
        "train_img_per_s": round((args.steps - 1) * args.batch / steady, 1)
        if args.steps > 1 else None,
        "data_wait_share": round(sum(logs["data_s"][1:]) / steady, 3)
        if args.steps > 1 else None,
        "process_cpu_share": round(cpu / wall, 2),
    }
    n, t1 = 0, time.perf_counter()
    for b in loader(10 ** 6):
        n += b["image"].shape[0]
    summary["loader_only_img_per_s"] = round(n / (time.perf_counter() - t1),
                                             1)
    if on_card:
        import subprocess
        summary["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print("SUMMARY", json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
