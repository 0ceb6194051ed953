"""On-device self-test of the port: correctness and speed sanity in one
command (port of rtpose_tpu/selftest.py).

    python -m rtpose_tpu_torch.selftest [--fps] [--device cuda|cpu]

Runs on the card by default (``--device cpu`` runs the kernels' plain
versions):
1. the decode on the device (the grouping kernel on the card) vs the host
   oracle ``ops.grouping_ref.paf_to_people`` on rendered scenes;
2. GT synthesis on the device (the K4 kernel on the card) vs the host
   oracle ``data.gt.ground_truth_maps``;
3. the flip-TTA algebra round trip;
4. with ``--fps``: the flagship single-frame serving latency, printed
   beside the card's name and power limit.
Exits 1 when a check fails.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import numpy as np
import torch

from .device import resolve_device


def _synth(seed, n_people, h=46, w=46):
    from .utils.synth import synth_example
    return synth_example(seed=seed, n_people=n_people, h=h, w=w)


def _match_people(dev_people, host_people, w_up, h_up):
    """Optimal one-to-one device->host person matching by mean part
    distance (pixels). Returns host index per device person, or None if
    no injective matching with all-finite distances exists (a real
    parity break). Exact (exhaustive over assignments) — person counts
    here are <= ~8, and greedy nearest-first can both return a
    non-injective mapping (argmin over an all-inf masked row lands on a
    taken column) and miss valid matchings that exist."""
    nd, nh = len(dev_people), len(host_people)
    if nd != nh:
        return None
    dist = np.full((nd, nh), np.inf)
    for i, person in enumerate(dev_people):
        for j, hp in enumerate(host_people):
            ds = [np.hypot((xn - hp[part][0]) * w_up,
                           (yn - hp[part][1]) * h_up)
                  for part, (xn, yn, _) in person["parts"].items()
                  if hp[part][0] >= 0]
            if ds:
                dist[i, j] = float(np.mean(ds))

    # branch-and-bound over injective assignments: rows in order, prune
    # on running cost; exact minimum, fast for the small counts here
    best = {"cost": np.inf, "order": None}

    def assign(i, taken, cost):
        if cost >= best["cost"]:
            return
        if i == nd:
            best["cost"], best["order"] = cost, list(taken)
            return
        for j in np.argsort(dist[i]):
            j = int(j)
            if j in taken or not np.isfinite(dist[i, j]):
                continue
            taken.append(j)
            assign(i + 1, taken, cost + dist[i, j])
            taken.pop()

    assign(0, [], 0.0)
    return best["order"]


def check_decode_parity(device: torch.device, n_scenes: int = 6) -> bool:
    """The device decode of rendered scenes vs the host oracle: the same
    people (matched by mean part distance, as emission order is
    tie-sensitive), each part within 0.05 px and its score within 1e-3."""
    from .ops import grouping_ref as G
    from .ops.decode import decode_poses, people_to_numpy

    ok = True
    for seed in range(n_scenes):
        _, heat, paf = _synth(seed, 1 + seed % 5)
        w_up, h_up = heat.shape[1] * 8, heat.shape[0] * 8
        host_people, _ = G.paf_to_people(heat, paf)
        dev = decode_poses(torch.from_numpy(heat).to(device),
                           torch.from_numpy(paf).to(device))
        dev_people = people_to_numpy(dev, w_up, h_up)
        if len(dev_people) != len(host_people):
            print(f"  scene {seed}: people count mismatch "
                  f"(host {len(host_people)} vs device {len(dev_people)})")
            ok = False
            continue
        order = _match_people(dev_people, host_people, w_up, h_up)
        if order is None:
            print(f"  scene {seed}: no one-to-one person matching")
            ok = False
            continue
        for pi, person in enumerate(dev_people):
            hp = host_people[order[pi]]   # (18, 3): normalized x, y, score
            for part, (xn, yn, score) in person["parts"].items():
                hx, hy, hs = hp[part]
                if hx < 0:
                    print(f"  scene {seed} person {pi}: part {part} "
                          f"missing on host")
                    ok = False
                    continue
                if (abs((xn - hx) * w_up) > 0.05
                        or abs((yn - hy) * h_up) > 0.05
                        or abs(score - hs) > 1e-3):
                    print(f"  scene {seed} person {pi} part {part}: "
                          f"device ({xn * w_up:.3f},{yn * h_up:.3f},"
                          f"{score:.4f}) vs host ({hx * w_up:.3f},"
                          f"{hy * h_up:.3f},{hs:.4f})")
                    ok = False
    print(f"decode parity over {n_scenes} scenes: {'OK' if ok else 'FAIL'}")
    return ok


def check_gt_equivalence(device: torch.device) -> bool:
    """GT synthesis on the device (``ground_truth_maps_batch``, the K4
    kernel on the card) vs the host oracle, atol 2e-6."""
    from .data.gt import ground_truth_maps, ground_truth_maps_batch

    rng = np.random.RandomState(0)
    kps = np.zeros((3, 18, 3))
    kps[:, :, 0] = rng.uniform(10, 350, (3, 18))
    kps[:, :, 1] = rng.uniform(10, 350, (3, 18))
    kps[:, :, 2] = 2
    h1, p1 = ground_truth_maps(kps)
    h2, p2 = ground_truth_maps_batch(
        torch.from_numpy(kps[None].astype(np.float32)).to(device))
    ok = (np.allclose(h2[0].cpu().numpy(), h1, atol=2e-6)
          and np.allclose(p2[0].cpu().numpy(), p1, atol=2e-6))
    print(f"GT synthesis host/device equivalence: {'OK' if ok else 'FAIL'}")
    return ok


def check_flip_algebra(device: torch.device) -> bool:
    from .infer.pipeline import average_flip
    from .skeleton import FLIP_HEAT, FLIP_PAF, NUM_LIMBS

    rng = np.random.RandomState(0)
    heat = rng.rand(12, 16, 19).astype(np.float32)
    paf = rng.rand(12, 16, 38).astype(np.float32)
    neg = np.ones(2 * NUM_LIMBS, np.float32)
    neg[0::2] = -1
    heat_f = heat[:, ::-1, :][:, :, np.array(FLIP_HEAT)]
    paf_f = (paf * neg)[:, ::-1, :][:, :, np.array(FLIP_PAF)]
    h, p = average_flip(*(torch.from_numpy(np.ascontiguousarray(a))
                          .to(device) for a in (heat, heat_f, paf, paf_f)))
    ok = (np.allclose(h.cpu().numpy(), heat, atol=1e-6)
          and np.allclose(p.cpu().numpy(), paf, atol=1e-6))
    print(f"flip-TTA algebra: {'OK' if ok else 'FAIL'}")
    return ok


def card_name(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi reports them, or the
    device's name where there is no card."""
    if device.type != "cuda":
        return f"{device} (no card)"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader",
                          f"--id={device.index or 0}"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip()


def measure_fps(device: torch.device, iters: int = 20) -> float:
    """Flagship single-frame serving latency: VGG19, 6 stages, 368x368,
    bf16, seeded weights; forward + decode chained `iters` times with one
    readback at the end.  Returns ms per frame."""
    from .models import get_model
    from .ops.decode import decode_poses_batch, people_to_host

    model = get_model("vgg19", num_stages=6, dtype=torch.bfloat16,
                      generator=torch.Generator().manual_seed(0))
    model = model.to(device=device, dtype=torch.bfloat16).eval()
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    x = torch.zeros((1, 368, 368, 3), device=device)

    @torch.inference_mode()
    def serve():
        out = model(x)
        return decode_poses_batch(out.heatmap, out.paf)

    people_to_host(serve())                 # warm-up
    t0 = time.perf_counter()
    people = None
    for _ in range(iters):
        people = serve()
    people_to_host(people)                  # one draining readback
    ms = (time.perf_counter() - t0) * 1e3 / iters
    print(f"serving latency (single-frame chained, one readback): "
          f"{ms:.2f} ms/frame ({1e3 / ms:.0f} FPS) [{card_name(device)}]")
    return ms


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--fps", action="store_true",
                        help="also measure flagship serving latency")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    print(f"device: {device} [{card_name(device)}]")
    ok = all([check_decode_parity(device), check_gt_equivalence(device),
              check_flip_algebra(device)])
    if args.fps:
        measure_fps(device)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
