#!/usr/bin/env python3
"""Time the port's decode stages and its grouping kernel on one CUDA card,
for one checkout of the repository, so that two checkouts can be compared
in turns within one run (parent, change, change, parent):

    for t in PARENT CHANGE CHANGE PARENT; do
        python3 scripts/torch_decode_turns.py --root $t --label $t
    done

Imports the package and ``chip_smoke.py`` of ``--root`` (its scenes and
timing helpers) and builds that checkout's kernels.  Prints one JSON line:
the card's name and power limit; per caps (default K=32 on 8 rendered
46x62 scenes, ``RETRY_CAPS`` on 8 crowded 92x92 scenes of 36 people, as
``chip_smoke.py`` phase 7) the host-clock ms per batch of the decode and
of its stages, each over 10 synchronised calls; and the grouping kernel's
device ms per launch from the profiler (200 launches) on the inputs of
``chip_smoke.py`` phase 4c (K=32 rendered, ``RETRY_CAPS`` on 30-person
crowded scenes); and the host-clock ms of ``PosePipeline.run`` (the
flagship, seeded weights, one 480x640 frame: upload, forward, decode and
the readback of the people and both maps), each of 50 calls after a
warm-up, as their median and mean.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True,
                    help="checkout whose package and chip_smoke.py to time")
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_decode_turns: needs a CUDA card")
    import chip_smoke as cs
    from rtpose_tpu_torch.infer.pipeline import RETRY_CAPS
    from rtpose_tpu_torch.ops import _build, kernels
    from rtpose_tpu_torch.ops.decode import decode_poses_batch
    from rtpose_tpu_torch.ops.grouping import (score_connections,
                                               sorted_candidates)
    from rtpose_tpu_torch.ops.peaks import nms
    for mod in (cs, kernels):
        if not os.path.abspath(mod.__file__).startswith(root):
            raise SystemExit(f"{mod.__name__} came from {mod.__file__}, "
                             f"not from {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    _build.load()
    dev = torch.device("cuda", 0)
    default_caps = dict(max_peaks=32, max_candidates=256, max_total_conns=160,
                        max_people=64)

    def timed(fn, iters=10):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / iters, out

    out = {"label": args.label, "card": smi}
    maps = {"default": cs.scenes(8, 46, 62, grid=None, seed0=0),
            "retry": cs.scenes(8, 92, 92, grid=(6, 6), seed0=100)}
    with torch.inference_mode():
        for name, caps in (("default", default_caps), ("retry", RETRY_CAPS)):
            hh, pp = (torch.from_numpy(a).to(dev) for a in maps[name])
            gk = {k: v for k, v in caps.items() if k != "max_peaks"}
            row = {}
            row["decode"], _ = timed(lambda: decode_poses_batch(hh, pp,
                                                                **caps))
            row["nms_refine"], pk = timed(
                lambda: nms(hh, max_peaks=caps["max_peaks"]))
            row["scoring"], (s, v) = timed(lambda: score_connections(pk, pp))
            row["sort"], srt = timed(lambda: sorted_candidates(s, v))
            row["group_people"], _ = timed(lambda: kernels.group_people(
                *srt, pk.x, pk.y, pk.score, pk.truncated, **gk))
            out[f"decode_ms_{name}"] = row

    # the grouping kernel alone, the inputs of chip_smoke.py phase 4c
    crowd = cs.scenes(8, 92, 92, grid=(5, 6), seed0=200)
    for name, (h, p), caps in (("default", maps["default"], default_caps),
                               ("retry", crowd, RETRY_CAPS)):
        heat = torch.from_numpy(h).to(dev)
        pk = nms(heat, max_peaks=caps["max_peaks"])
        s, v = score_connections(pk, torch.from_numpy(p).to(dev))
        gargs = (*sorted_candidates(s, v), pk.x, pk.y, pk.score,
                 pk.truncated)
        gk = {k: v for k, v in caps.items() if k != "max_peaks"}
        _, _, chain = cs.group_work(gargs, **gk)
        ms, src = cs.device_ms(lambda: kernels.group_people(*gargs, **gk),
                               "group_people_kernel")
        out[f"group_people_{name}"] = dict(device_ms=ms, source=src,
                                           chain_steps=chain,
                                           ns_per_step=ms * 1e6 / chain)
    # single-frame run, as the per-image eval calls it
    from rtpose_tpu_torch.infer.pipeline import load_pipeline
    pipe = load_pipeline(device=dev, seed=0)
    frame = np.random.RandomState(0).randint(0, 256, (480, 640, 3),
                                             np.uint8)
    pipe.run(frame)
    times = []
    for _ in range(50):
        t0 = time.perf_counter()
        pipe.run(frame)
        times.append((time.perf_counter() - t0) * 1e3)
    out["run_ms"] = dict(median=float(np.median(times)),
                         mean=float(np.mean(times)))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
