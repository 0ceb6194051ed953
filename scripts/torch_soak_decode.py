"""Decode soak of the PyTorch port: the card's decode against the host
oracle over many random scenes (the port's counterpart of
scripts/soak_decode.py).

Decodes rendered 46x46 scenes (``utils/synth.py`` ``synth_example``) in
batches through ``ops/decode.py`` ``decode_poses_batch`` (NMS and the
refine kernel, the scoring kernel, the grouping kernel) and holds each
scene against the numpy oracle ``ops/grouping_ref.py`` ``paf_to_people``:
the people count, then each person's parts within half an upsampled
pixel.  A scene that overflowed a decode cap (``truncated``) and lost
people is decoded again at ``RETRY_CAPS`` (the scoring kernel at K=64),
where its count must match.  Each part difference is printed with the
smallest gap between the criteria of two candidates of one limb pair in
that scene that compete for one peak (``min_gap``): a near tie orders the
greedy matching by rounding or enumeration order, so a difference at a
wide gap in a scene that no cap truncated is a fault (a truncated scene
whose count happens to match may have lost candidates to a cap).

    python3 scripts/torch_soak_decode.py [--scenes 300] [--people-max 8]
    python3 scripts/torch_soak_decode.py --scenes 100 --people-max 20
    python3 scripts/torch_soak_decode.py --device cpu --scenes 24

Prints the JAX script's tally line, then one ``SUMMARY`` JSON line (the
counts, each part difference's scene, gap and truncation, seconds, and
on the card the kernels' launches).  Exits 1 on a people-count mismatch or on an
overflow that the raised caps do not fix.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

H = W = 46
FACTOR = 8


def make_scenes(n_scenes: int, people_max: int):
    """Scene `seed` holds ``1 + seed % people_max`` people -> [(heat,
    paf)]."""
    from rtpose_tpu_torch.utils.synth import synth_example

    return [synth_example(seed=seed, n_people=1 + seed % people_max,
                          h=H, w=W)[1:] for seed in range(n_scenes)]


def decode_scenes(scenes, device, **caps):
    """One batch of scenes through ``decode_poses_batch`` -> (people lists
    as ``people_to_numpy`` gives them, truncated flags)."""
    import torch

    from rtpose_tpu_torch.ops.decode import (decode_poses_batch,
                                             people_row, people_to_host,
                                             people_to_numpy)

    hb = torch.from_numpy(np.stack([s[0] for s in scenes])).to(device)
    pb = torch.from_numpy(np.stack([s[1] for s in scenes])).to(device)
    host = people_to_host(decode_poses_batch(hb, pb, **caps))
    return ([people_to_numpy(people_row(host, i), W * FACTOR, H * FACTOR)
             for i in range(len(scenes))],
            [bool(t) for t in host.truncated])


def compare(host_people, dev_people):
    """None when the decode equals the oracle's (P, 18, 3) people, else
    "count" or "part" (parts matched within half an upsampled pixel)."""
    if len(dev_people) != len(host_people):
        return "count"
    hs = sorted(
        sorted((j, row[j][0], row[j][1]) for j in range(row.shape[0])
               if row[j][0] >= 0)
        for row in host_people)
    ds = sorted(
        sorted((j, p["parts"][j][0], p["parts"][j][1])
               for j in sorted(p["parts"]))
        for p in dev_people)
    for hp, dp in zip(hs, ds):
        if len(hp) != len(dp) or any(
                a[0] != b[0]
                or abs(a[1] - b[1]) * W * FACTOR > 0.51
                or abs(a[2] - b[2]) * H * FACTOR > 0.51
                for a, b in zip(hp, dp)):
            return "part"
    return None


def criterion_gap(heat, paf):
    """The smallest difference between the criteria of two valid
    candidates of one limb pair that compete for a peak (share an end),
    the only ties that can reorder the greedy matching; None without two
    such candidates."""
    from rtpose_tpu_torch.ops import grouping_ref as G

    joints = G.joint_list_from_peaks(G.nms(heat, FACTOR, 0.1))
    if not len(joints):
        return None
    px = joints[:, 0].astype(np.int64)
    py = joints[:, 1].astype(np.int64)
    part = joints[:, 4].astype(np.int64)
    paf_up = G.upsample_nearest(paf, FACTOR)
    gap = None
    for pair_id, (pa, pb) in enumerate(G.GROUP_PAIRS):
        cands = G.pair_candidates(
            pair_id, np.nonzero(part == pa)[0], np.nonzero(part == pb)[0],
            px, py, float(heat.shape[0] * FACTOR), paf_up)
        for end in (1, 2):          # candidates sharing their a / b peak
            by_peak = {}
            for c in cands:
                by_peak.setdefault(c[end], []).append(float(c[0]))
            for crit in by_peak.values():
                if len(crit) > 1:
                    g = float(np.diff(sorted(crit)).min())
                    gap = g if gap is None else min(gap, g)
    return gap


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scenes", type=int, default=300)
    ap.add_argument("--people-max", type=int, default=8)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from rtpose_tpu_torch.device import resolve_device
    from rtpose_tpu_torch.infer.pipeline import RETRY_CAPS
    from rtpose_tpu_torch.ops import grouping_ref as G
    from rtpose_tpu_torch.ops import kernels

    device = resolve_device(args.device)
    scenes = make_scenes(args.scenes, args.people_max)
    kernels.reset_launch_counts()

    count_mismatch = 0
    part_diffs = []        # (scene, smallest criterion gap)
    overflow_scenes = []   # truncated scenes whose counts differ: the
                           # fixed-cap signal, re-decoded at raised caps
    people_total = 0
    t0 = time.perf_counter()
    for start in range(0, len(scenes), args.batch):
        chunk = scenes[start:start + args.batch]
        dev_people, trunc = decode_scenes(chunk, device)
        for i, (heat, paf) in enumerate(chunk):
            host_people, _ = G.paf_to_people(heat, paf)   # (P, 18, 3)
            people_total += len(host_people)
            diff = compare(host_people, dev_people[i])
            if diff == "count":
                if trunc[i]:
                    overflow_scenes.append(start + i)
                    print(f"scene {start + i}: host {len(host_people)} vs "
                          f"device {len(dev_people[i])} people "
                          f"(truncated=True -> cap-overflow class, "
                          f"re-checked below)")
                else:
                    count_mismatch += 1
                    print(f"scene {start + i}: host {len(host_people)} vs "
                          f"device {len(dev_people[i])} people")
            elif diff == "part":
                gap = criterion_gap(heat, paf)
                part_diffs.append({"scene": start + i, "min_gap": gap,
                                   "truncated": trunc[i]})
                print(f"scene {start + i}: part-level mismatch "
                      f"(smallest criterion gap {gap!r}, "
                      f"truncated={trunc[i]})")
    # the truncation signal's contract is 'raise the caps and re-run': the
    # counts must then match the unbounded host oracle
    overflow_fixed = overflow_unfixed = 0
    if overflow_scenes:
        redo = [scenes[s] for s in overflow_scenes]
        dev_people, trunc = decode_scenes(redo, device, **RETRY_CAPS)
        for (heat, paf), sid, people, tr in zip(redo, overflow_scenes,
                                                dev_people, trunc):
            n_host = len(G.paf_to_people(heat, paf)[0])
            if len(people) == n_host:
                overflow_fixed += 1
            else:
                overflow_unfixed += 1
                print(f"scene {sid}: STILL {len(people)} vs {n_host} "
                      f"people at raised caps (truncated={tr})")
    dt = time.perf_counter() - t0
    print(f"{args.scenes} scenes, {people_total} people: "
          f"{count_mismatch} people-count mismatches (real-bug class), "
          f"{len(part_diffs)} part-membership diffs (near-tie class), "
          f"{len(overflow_scenes)} cap-overflows "
          f"({overflow_fixed} match at raised caps, "
          f"{overflow_unfixed} still differ) ({dt:.1f}s)")
    summary = {"scenes": args.scenes, "people_max": args.people_max,
               "people": people_total, "count_mismatch": count_mismatch,
               "part_diffs": part_diffs, "overflows": len(overflow_scenes),
               "overflow_fixed": overflow_fixed,
               "overflow_unfixed": overflow_unfixed, "seconds": dt,
               "device": str(device)}
    if device.type == "cuda":
        summary["launches"] = kernels.launch_counts()
    print("SUMMARY", json.dumps(summary), flush=True)
    if count_mismatch or overflow_unfixed:
        sys.exit(1)
    return summary


if __name__ == "__main__":
    main()
