"""Split the batched eval's cost per stage, on the card (the port's
counterpart of scripts/eval_breakdown.py).

Times each stage of the eval on the set's largest padded-shape bucket,
batch after batch: reading (``data/imread.py`` ``read_bgr``), host prep
(the pipeline's ``_prep`` under its resize mode, and the stack), the
upload of the stacked batch with a card sync, the submit (upload,
forward and decode enqueued), the wait in collect (``people_to_host``)
and the host conversion (``people_to_numpy``, ``append_result``).  The
card runs asynchronously: the only explicit sync is the one after the
upload, where the JAX script forces one, so no stage takes another's
card time.

    python3 scripts/torch_eval_breakdown.py \\
        --image-dir rtpose_tpu_torch/build/cocoval_synth/images \\
        --ann rtpose_tpu_torch/build/cocoval_synth/annotations.json \\
        --weight rtpose_tpu_torch/build/torch_train_eval/ckpt \\
        --stages 2 --batches 6
    python3 scripts/torch_eval_breakdown.py --device cpu --stages 1 \\
        --batch 2 --batches 2 --image-dir <dir> --ann <json> --weight <dir>

``--weight``: a directory of the port's training checkpoints or a
``.pth``.  Prints the JAX script's JSON (ms per image by stage), then
the same as one ``SUMMARY`` line with, on the card, its name and the
kernels' launches.
"""

import argparse
import json
import os
import sys
import time
from collections import defaultdict

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--image-dir", required=True)
    ap.add_argument("--ann", required=True)
    ap.add_argument("--weight", required=True)
    ap.add_argument("--stages", type=int, default=2)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--batches", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from rtpose_tpu_torch.data.coco_json import CocoJson
    from rtpose_tpu_torch.data.imread import read_bgr
    from rtpose_tpu_torch.evalx.harness import append_result
    from rtpose_tpu_torch.infer.pipeline import load_pipeline
    from rtpose_tpu_torch.infer.preprocess import scale_pad_geometry
    from rtpose_tpu_torch.ops import kernels
    from rtpose_tpu_torch.ops.decode import (people_row, people_to_host,
                                             people_to_numpy)

    is_dir = os.path.isdir(args.weight)
    pipe = load_pipeline(checkpoint_dir=args.weight if is_dir else None,
                         torch_weights=None if is_dir else args.weight,
                         device=args.device, model_name="vgg19",
                         num_stages=args.stages, preprocess_mode="vgg",
                         flip=True)
    on_card = pipe.device.type == "cuda"
    kernels.reset_launch_counts()

    coco = CocoJson(args.ann)
    ids = coco.img_ids(coco.cat_ids("person"))
    # the most common padded shape, so every batch runs one shape
    buckets = defaultdict(list)
    for img_id in ids:
        info = coco.image_info(img_id)
        _, _, _, ph, pw = scale_pad_geometry(
            info["height"], info["width"], pipe.input_size, pipe.pad_factor)
        buckets[(ph, pw)].append(img_id)
    shape, bucket_ids = max(buckets.items(), key=lambda kv: len(kv[1]))
    need = args.batch * (args.batches + 1)
    bucket_ids = bucket_ids[:need]
    print(f"bucket {shape}: timing {args.batches} batches of {args.batch}")

    t = defaultdict(float)

    def batches():
        for i in range(0, len(bucket_ids), args.batch):
            chunk = bucket_ids[i:i + args.batch]
            if len(chunk) < args.batch:
                return
            yield chunk

    first = True
    n_batches = 0
    t_all0 = time.perf_counter()
    for chunk in batches():
        t0 = time.perf_counter()
        frames = [read_bgr(os.path.join(
            args.image_dir, coco.image_info(i)["file_name"])) for i in chunk]
        t1 = time.perf_counter()
        ims, metas = zip(*(pipe._prep(im) for im in frames))
        stacked = torch.from_numpy(np.stack(ims))
        t2 = time.perf_counter()
        if on_card:     # as the pipeline uploads: pinned, asynchronous
            stacked.pin_memory().to(pipe.device, non_blocking=True)
            torch.cuda.synchronize()     # the sync point of the upload
        t3 = time.perf_counter()
        if first:
            tc0 = time.perf_counter()
            ticket = pipe._submit_stacked(list(ims), list(metas))
            people_to_host(ticket[1])        # kernels' build + first run
            print(f"build+first run: {time.perf_counter() - tc0:.1f}s")
            first = False
            continue
        ticket = pipe._submit_stacked(list(ims), list(metas))
        t4 = time.perf_counter()
        people_host = people_to_host(ticket[1])
        t5 = time.perf_counter()
        h_up = ticket[2].shape[1] * pipe.downsample
        w_up = ticket[2].shape[2] * pipe.downsample
        outputs = []
        for k, img_id in enumerate(chunk):
            people = people_to_numpy(people_row(people_host, k), w_up, h_up)
            append_result(img_id, people, (w_up, h_up), outputs,
                          score_mode="person")
        t6 = time.perf_counter()
        t["imread"] += t1 - t0
        t["host_prep"] += t2 - t1
        t["h2d_sync"] += t3 - t2
        t["dispatch"] += t4 - t3
        t["collect_wait"] += t5 - t4
        t["host_convert"] += t6 - t5
        n_batches += 1
    wall = time.perf_counter() - t_all0
    if not n_batches:
        raise SystemExit(f"bucket {shape} holds {len(bucket_ids)} images: "
                         f"no timed batch of {args.batch} after the first")

    per_img = {k: round(v / n_batches / args.batch * 1000, 2)
               for k, v in t.items()}
    out = {"shape": list(shape), "batch": args.batch,
           "batches": n_batches, "ms_per_image": per_img,
           "serial_ms_per_image": round(sum(per_img.values()), 2),
           "wall_s": round(wall, 2)}
    print(json.dumps(out, indent=1))
    if on_card:
        out["card"] = torch.cuda.get_device_name(pipe.device)
        out["launches"] = kernels.launch_counts()
    print("SUMMARY", json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
