#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rtpose_tpu_torch) on one NVIDIA
Hopper card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from rtpose_tpu_torch/csrc, holds
each against its plain PyTorch version on the card, decodes rendered
scenes on the card and on the CPU, then drives the serving path (VGG19,
6 stages, 368 px, flip TTA, bf16, seeded random weights) through
``load_pipeline`` / ``run`` / ``run_batch`` and checks that both kernels
were launched by it.  Prints timings beside the card's name and power
limit, a JSON line of per-kernel results, and as the last line
``{"ok": true, "device": {...}}``.  Any failed check raises, so the exit
code is not 0.  Needs one CUDA card of compute capability 9.0; imports
nothing of JAX or of the JAX package (rtpose_tpu).
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SSUM_TOL = 1e-5        # PAF sample sums, kernel vs plain (same fp32 ops)
SCORE_TOL = 1e-5       # refine scores and people scores
FWD_REL_TOL = 2e-4     # fp32 forward card vs CPU, relative to max |CPU|


def log(*args) -> None:
    print(*args, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() in ms over `iters` calls (after warm-up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def paired_ms(kernel_fn, plain_fn, iters: int):
    """Times in turns (plain, kernel, kernel, plain) -> (kernel, plain)."""
    p1 = cuda_ms(plain_fn, iters)
    k1 = cuda_ms(kernel_fn, iters)
    k2 = cuda_ms(kernel_fn, iters)
    p2 = cuda_ms(plain_fn, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


# Rendered scenes: a copy of tests/util_synth.py (which imports the JAX
# package's skeleton) on the port's skeleton tables.
_TEMPLATE = {
    0: (0.50, 0.10), 1: (0.50, 0.22), 2: (0.38, 0.24), 3: (0.34, 0.40),
    4: (0.32, 0.55), 5: (0.62, 0.24), 6: (0.66, 0.40), 7: (0.68, 0.55),
    8: (0.42, 0.52), 9: (0.42, 0.72), 10: (0.42, 0.92), 11: (0.58, 0.52),
    12: (0.58, 0.72), 13: (0.58, 0.92), 14: (0.46, 0.07), 15: (0.54, 0.07),
    16: (0.42, 0.09), 17: (0.58, 0.09),
}


def _person(cx, cy, s, rng, jitter):
    return np.array([(cx + (tx - 0.5) * s, cy + (ty - 0.5) * s)
                     + rng.normal(0, jitter * s, 2)
                     for tx, ty in _TEMPLATE.values()])


def render_maps(people, h, w, sigma=1.5, limb_width=1.0):
    """(h, w, 19) Gaussian part heatmaps and (h, w, 38) unit-vector PAFs."""
    from rtpose_tpu_torch.skeleton import LIMBS, NUM_PARTS
    heat = np.zeros((h, w, NUM_PARTS + 1), np.float32)
    paf = np.zeros((h, w, 2 * len(LIMBS)), np.float32)
    count = np.zeros((h, w, len(LIMBS)), np.int32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    inside = lambda x, y: 0 <= x < w and 0 <= y < h   # noqa: E731
    for person in people:
        for part in range(NUM_PARTS):
            px, py = person[part]
            if inside(px, py):
                d2 = (xx - px) ** 2 + (yy - py) ** 2
                g = np.exp(-d2 / (2 * sigma * sigma)) * (d2 < (4 * sigma) ** 2)
                heat[:, :, part] = np.maximum(heat[:, :, part], g)
        for li, (a, b) in enumerate(LIMBS):
            (ax, ay), (bx, by) = person[a], person[b]
            norm = np.hypot(bx - ax, by - ay)
            if not (inside(ax, ay) and inside(bx, by)) or norm < 1e-6:
                continue
            u = ((bx - ax) / norm, (by - ay) / norm)
            along = (xx - ax) * u[0] + (yy - ay) * u[1]
            perp = np.abs((xx - ax) * u[1] - (yy - ay) * u[0])
            mask = (perp <= limb_width) & (along >= -1) & (along <= norm + 1)
            prev = count[:, :, li]
            for k in (0, 1):
                paf[:, :, 2 * li + k] = np.where(
                    mask, (paf[:, :, 2 * li + k] * prev + u[k]) / (prev + 1),
                    paf[:, :, 2 * li + k])
            count[:, :, li] = prev + mask
    heat[:, :, NUM_PARTS] = np.maximum(1.0 - heat[:, :, :-1].max(axis=2), 0)
    return heat, paf


def scenes(n_frames: int, h: int, w: int, grid, seed0: int):
    """(B, h, w, 19) heatmaps and (B, h, w, 38) PAFs of random people, or
    of a (rows, cols) grid of people, with PAF noise that breaks ties."""
    heats, pafs = [], []
    for i in range(n_frames):
        rng = np.random.RandomState(seed0 + i)
        if grid:
            rows, cols = grid
            ch, cw = (h - 4.0) / rows, (w - 4.0) / cols
            people = [_person(2 + (c + 0.5) * cw, 2 + (r + 0.5) * ch,
                              0.9 * min(ch, cw), rng, 0.005)
                      for r in range(rows) for c in range(cols)]
        else:
            people = []
            for _ in range(1 + i % 6):
                s = rng.uniform(0.35, 0.8) * min(h, w)
                cx, cy = rng.uniform(0.2 * w, 0.8 * w), rng.uniform(0.2 * h,
                                                                    0.8 * h)
                people.append(_person(cx, cy, s, rng, 0.01))
        heat, paf = render_maps(people, h, w)
        heats.append(heat)
        pafs.append(paf + rng.normal(0, 1e-4, paf.shape).astype(np.float32))
    return np.stack(heats), np.stack(pafs)


def people_equal(a, b, what: str) -> None:
    for f in ("coords", "valid", "truncated"):
        check(np.array_equal(getattr(a, f), getattr(b, f)),
              f"{what}: People.{f} differ")
    for f in ("score", "part_score"):
        err = float(np.abs(getattr(a, f) - getattr(b, f)).max(initial=0))
        check(err <= SCORE_TOL, f"{what}: People.{f} max err {err}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA card")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs compute capability 9.0 "
                         f"(Hopper), found {cap}")
    sys.path.insert(0, ROOT)
    from rtpose_tpu_torch.infer.pipeline import RETRY_CAPS, load_pipeline
    from rtpose_tpu_torch.infer.preprocess import normalize_device
    from rtpose_tpu_torch.models import get_model
    from rtpose_tpu_torch.ops import _build, kernels
    from rtpose_tpu_torch.ops.decode import decode_poses_batch, people_to_host
    from rtpose_tpu_torch.ops.grouping import (assemble_people,
                                               candidate_geometry, criterion,
                                               greedy_connections,
                                               score_connections)
    from rtpose_tpu_torch.ops.peaks import nms, peak_candidates

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # 2. kernel build
    built = _build.load()
    log(f"kernel build: {built.seconds:.1f} s -> "
        f"{os.path.relpath(built.path, ROOT)}")
    for line in built.log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("  ptxas:", line.strip())

    results = {}

    # 3. PAF sampling kernel vs plain: K=32 at the serving shape (8 frames
    # of 480x640 -> 46x62 maps) and K=64 (the retry) on crowded 92x92
    # scenes of 36 people, more than 32 peaks per part
    heat32, paf32 = scenes(8, 46, 62, grid=None, seed0=0)
    heat64, paf64 = scenes(8, 92, 92, grid=(6, 6), seed0=100)
    for K, heat_np, paf_np in ((32, heat32, paf32), (64, heat64, paf64)):
        heat = torch.from_numpy(heat_np).to(dev)
        paf = torch.from_numpy(paf_np).to(dev)
        peaks = nms(heat, max_peaks=K)
        geo, norm, ok = candidate_geometry(peaks)
        cnt_k, ssum_k = kernels.paf_sample_scores(paf, geo)
        cnt_p, ssum_p = kernels.paf_sample_scores_plain(paf, geo)
        torch.cuda.synchronize()
        h_up = paf.shape[1] * 8
        _, valid_k = criterion(cnt_k, ssum_k, norm, ok, h_up=h_up)
        _, valid_p = criterion(cnt_p, ssum_p, norm, ok, h_up=h_up)
        err = float((ssum_k - ssum_p).abs().max())
        check(torch.equal(cnt_k, cnt_p), f"paf K={K}: cnt differ")
        check(torch.equal(valid_k, valid_p), f"paf K={K}: valid differ")
        check(err <= SSUM_TOL, f"paf K={K}: ssum max err {err}")
        ms, plain_ms = paired_ms(
            lambda: kernels.paf_sample_scores(paf, geo),
            lambda: kernels.paf_sample_scores_plain(paf, geo), 50)
        log(f"paf_sample K={K} B=8 map {paf.shape[1]}x{paf.shape[2]}: "
            f"cnt/valid equal, ssum max err {err:.3g}; kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms ({int(valid_k.sum())} valid "
            f"candidates) [{smi}]")
        if K == 32:
            results["paf_sample_scores"] = dict(max_abs_err=err, ms=ms,
                                                plain_ms=plain_ms)

        # 4. refine kernel vs plain on the same scenes
        hb = heat[..., :18].permute(0, 3, 1, 2).contiguous()
        _, py, px, valid, _ = peak_candidates(hb, thresh=0.1, max_peaks=K)
        my_k, mx_k, sc_k = kernels.bicubic_refine(hb, py, px)
        my_p, mx_p, sc_p = kernels.bicubic_refine_plain(hb, py, px)
        torch.cuda.synchronize()
        check(torch.equal(my_k, my_p.to(torch.int32))
              and torch.equal(mx_k, mx_p.to(torch.int32)),
              f"refine K={K}: coordinates differ")
        err = float((sc_k - sc_p).abs().max())
        check(err <= SCORE_TOL, f"refine K={K}: score max err {err}")
        ms, plain_ms = paired_ms(
            lambda: kernels.bicubic_refine(hb, py, px),
            lambda: kernels.bicubic_refine_plain(hb, py, px), 50)
        log(f"bicubic_refine K={K} B=8 ({int(valid.sum())} valid of "
            f"{valid.numel()} peaks): coordinates equal, score max err "
            f"{err:.3g}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms [{smi}]")
        if K == 32:
            results["bicubic_refine"] = dict(max_abs_err=err, ms=ms,
                                             plain_ms=plain_ms)

    # 5. decode on the card vs the same maps decoded on the CPU
    h32, p32 = torch.from_numpy(heat32), torch.from_numpy(paf32)
    got = people_to_host(decode_poses_batch(h32.to(dev), p32.to(dev)))
    want = people_to_host(decode_poses_batch(h32, p32))
    people_equal(got, want, "decode K=32")
    log(f"decode_poses_batch: card == CPU on 8 rendered scenes "
        f"({int(got.valid.sum())} people)")

    # 30 people: 570 connections overflow the default 160 but fit the
    # 608 of RETRY_CAPS (36 people, 684 connections, would not)
    pipe = load_pipeline(device="cuda", model_name="vgg19", num_stages=6,
                         input_size=368, flip=True, seed=0)
    h30, p30 = (torch.from_numpy(a) for a in scenes(8, 92, 92, grid=(5, 6),
                                                     seed0=200))
    first = decode_poses_batch(h30.to(dev), p30.to(dev))
    check(bool(first.truncated.all()),
          "crowded scenes should overflow the default caps")
    metas = [{} for _ in range(len(h30))]
    people, metas = pipe.run_batch_collect(
        ("async", first, h30.to(dev), p30.to(dev), metas))
    want = people_to_host(decode_poses_batch(h30, p30, **RETRY_CAPS))
    check(all(m.get("retried") and not m["truncated"] for m in metas),
          "retry at RETRY_CAPS did not resolve the crowded scenes")
    check([len(p) for p in people] == [int(v.sum()) for v in want.valid],
          "retried people differ from the CPU decode at RETRY_CAPS")
    got = people_to_host(decode_poses_batch(h30.to(dev), p30.to(dev),
                                            **RETRY_CAPS))
    people_equal(got, want, "decode at RETRY_CAPS")
    log(f"crowded 5x6 grid scenes: truncated at the default caps, "
        f"retried at RETRY_CAPS -> {[len(p) for p in people]} people, "
        f"card == CPU")

    # 6. serving main path: one frame, then 8 frames of mixed sizes
    rng = np.random.RandomState(0)
    frame = rng.randint(0, 256, (480, 640, 3), np.uint8)
    batch = ([rng.randint(0, 256, (480, 640, 3), np.uint8) for _ in range(4)]
             + [rng.randint(0, 256, (368, 368, 3), np.uint8)
                for _ in range(2)]
             + [rng.randint(0, 256, (240, 320, 3), np.uint8)
                for _ in range(2)])
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    people1, heat1, paf1, meta1 = pipe.run(frame)
    people8, metas8 = pipe.run_batch(batch)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    check(heat1.shape == (46, 62, 19) and paf1.shape == (46, 62, 38),
          f"map shapes {heat1.shape} {paf1.shape}")
    check(bool(np.isfinite(heat1).all() and np.isfinite(paf1).all()),
          "non-finite maps")
    check(len(people8) == 8 and [m["padded_shape"] for m in metas8[-2:]]
          == [(368, 496, 3)] * 2, "run_batch results")
    for name, n in counts.items():
        check(n > 0, f"{name} was not launched by the serving path")
    log(f"serving: run -> maps {heat1.shape}/{paf1.shape} finite, "
        f"{len(people1)} people; run_batch(8 mixed) -> "
        f"{[len(p) for p in people8]} people; launches {counts}")

    # fp32 forward on the card (TF32 off) vs the CPU, same seeded weights
    # drawn at He scale (N(0, 0.01) shrinks the 6-stage output ~1e10-fold)
    ref = get_model("vgg19", num_stages=6, dtype=torch.float32).eval()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for m in ref.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.normal_(0.0, (2.0 / m.weight[0].numel()) ** 0.5,
                                 generator=gen)
    gpu = copy.deepcopy(ref).to(dev)
    x = normalize_device(torch.from_numpy(frame[:368, :368][None].copy()),
                         "vgg")
    with torch.inference_mode():
        want = ref(x)
        got = gpu(x.to(dev))
    for name in ("pafs", "heatmaps"):
        w_, g_ = getattr(want, name), getattr(got, name).cpu()
        rel = float((g_ - w_).abs().max() / w_.abs().max())
        check(rel <= FWD_REL_TOL, f"fp32 forward {name}: rel err {rel}")
        log(f"fp32 forward card vs CPU, 6 stages 368x368: {name} max err "
            f"{rel:.3g} of max |CPU| (bound {FWD_REL_TOL})")

    # 7. timings at batch 8 (368x496 padded frames, bf16, flip TTA)
    frames8 = [rng.randint(0, 256, (480, 640, 3), np.uint8)
               for _ in range(8)]
    h64, p64 = torch.from_numpy(heat64), torch.from_numpy(paf64)
    with torch.inference_mode():
        inp = normalize_device(torch.zeros((16, 368, 496, 3), device=dev),
                               "vgg")
        fwd_ms = cuda_ms(lambda: pipe.model(inp), 10)
    log(f"forward bf16 6 stages, 16 images (8 frames + flips) 368x496: "
        f"{fwd_ms:.2f} ms/batch = {fwd_ms / 8:.3f} ms/frame [{smi}]")

    def timed(fn, iters=10):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / iters, out

    hd, pd = h32.to(dev), p32.to(dev)
    with torch.inference_mode():
        for caps_name, caps, (hh, pp) in (
                ("default caps (K=32)", {}, (hd, pd)),
                ("RETRY_CAPS (K=64)", RETRY_CAPS,
                 (h64.to(dev), p64.to(dev)))):
            dec_ms, _ = timed(lambda: decode_poses_batch(hh, pp, **caps))
            k = caps.get("max_peaks", 32)
            nms_ms, pk = timed(lambda: nms(hh, max_peaks=k))
            sc_ms, (s, v) = timed(lambda: score_connections(pk, pp))
            gr_ms, conns = timed(lambda: greedy_connections(
                s, v, max_conns=caps.get("max_candidates", 256)))
            as_ms, _ = timed(lambda: assemble_people(
                *conns[:4], pk, max_people=caps.get("max_people", 64),
                max_total_conns=caps.get("max_total_conns", 160)))
            share = (gr_ms + as_ms) / (nms_ms + sc_ms + gr_ms + as_ms)
            log(f"decode {caps_name}, batch 8 map {hh.shape[1]}x"
                f"{hh.shape[2]}: {dec_ms:.2f} ms/batch = {dec_ms / 8:.3f} "
                f"ms/frame; nms+refine {nms_ms:.2f}, scoring {sc_ms:.2f}, "
                f"greedy loop {gr_ms:.2f}, assembly loop {as_ms:.2f} ms "
                f"(torch loops {100 * share:.0f}% of the stages) [{smi}]")

    e2e_ms, _ = timed(lambda: pipe.run_batch(frames8), iters=5)
    log(f"e2e run_batch 8 frames 480x640 -> 368x496, flip TTA, bf16: "
        f"{e2e_ms:.1f} ms/batch = {8e3 / e2e_ms:.1f} frames/s [{smi}]")

    sources = {   # kernel -> (source, the TPU kernel it replaces, and K2)
        "paf_sample_scores": ("rtpose_tpu_torch/csrc/paf_sample.cu",
                              "rtpose_tpu/ops/pallas_kernels.py:214",
                              "rtpose_tpu/ops/pallas_kernels.py:172"),
        "bicubic_refine": ("rtpose_tpu_torch/csrc/bicubic_refine.cu",
                           "rtpose_tpu/ops/pallas_kernels.py:258", None),
    }
    rows = [dict(name=name, route="cuda", source=src, replaces=rep,
                 launches=counts[name], **results[name],
                 **({"also_replaces": also} if also else {}))
            for name, (src, rep, also) in sources.items()]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
