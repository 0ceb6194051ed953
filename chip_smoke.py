#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rtpose_tpu_torch) on one NVIDIA
Hopper card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from rtpose_tpu_torch/csrc, holds
each against its plain PyTorch version on the card (the grouping kernel
also on crafted candidate batches that reach every branch of the
assembly, on a batch that reads peak ids a merge moved, and at its limits
of 128 peaks per part and 256 people), checks that the normalisation
rounds on the card as on the CPU, times each kernel (device time per
launch from the profiler, the wrapper's host time per call, the bound
from the bytes and operations of this run's inputs; for the grouping
kernel also its chain bound and each phase's cycles), counts the device
kernels of the two decode stages
and of the ground-truth stage that hold them (one each, no copy), decodes
rendered scenes on the card and on the CPU, plain and with
``gaussian_filt``, runs the decode and ``run_batch_submit`` with
synchronising calls made errors (no host read inside the decode), runs
the self-test's checks, then drives the paths of the port through the
entry points a user calls:

- serving (VGG19, 6 stages, 368 px, flip TTA, bf16, seeded random
  weights) through ``load_pipeline`` / ``run`` / ``run_batch``, and once
  more with ``gaussian_filt=True``, first decode and retry, which must
  reach the blurred refine kernel;
- multi-scale TTA (scales 0.5, 1, 1.5, 2) through ``run_multiscale`` /
  ``run_multiscale_batch`` on the same pipeline, with the device memory
  it takes per frame and pixel;
- the COCO eval path: the image reader against cv2's pixels of the
  committed fixture JPEGs (``rtpose_tpu_torch/data/fixtures``); the
  harness with an oracle stub for the network (each input answered with
  the ground-truth maps of its frame's people) through ``run_eval`` and
  ``run_eval_batched``, card against CPU; then the flagship through the
  eval CLI's ``main()`` on 80 written JPEGs of COCO's commonest sizes,
  batched, multi-scale and per image, with images/s, the pipeline and
  evaluator split, read ms per image and sub-batches per bucket;
- training (the same model, batch 72, bf16, freeze phase on, seeded He
  weights) through ``Trainer.run_epoch`` on rendered scenes: the loss
  falls, the frozen convs stay and then move, a NaN batch is skipped, and
  a trainer restored from a checkpoint takes the next step bit-equal;
- training from files: JPEGs of COCO's commonest sizes with crowd and
  unlabelled regions through the train CLI's ``main()`` on the flagship
  experiment for one epoch (finite losses, a checkpoint that restores,
  one K4 launch a step), then the loader alone (same seed same batches,
  1 worker process == in-process, K4 on a loader batch == plain), with
  nproc, the loader's img/s at 1 and W worker processes, one process's
  time by stage, and the train img/s it feeds with each step's data-wait
  share;
- the model zoo, every other family at its published width (openpose_v2,
  mobilenet, shufflenet_v2, atrous_resnet50, atrous_cpm(_shared) at
  368 px; hourglass, 8 stacks, at 256 px, stride 4, pad 64): 8 rendered
  frames through ``run_batch`` (flip, bf16, seeded weights; the decode on
  the card equals the CPU's on the same maps), one fp32 forward card vs
  CPU, one multi-scale chunk with its bytes per frame and pixel, and
  3 train steps and a val step through ``Trainer`` (BatchNorm statistics
  move in train mode and stay in eval mode, K4 equal to plain on the
  batch, a checkpoint that restores bit-equal), with forward, run_batch,
  decode and train times and peak memory; before it, K1 (K=32), K2
  (K=64), K3 (plain and blurred), the grouping kernel and K4 on
  hourglass's factor-4 / stride-4 shapes against their plain versions,
  timed with their bounds, and a stride-4 pipeline's own retry;
- the front-ends, on the flagship through the entry points a user calls:
  the HTTP service (``demo/serve_http.py``) answering rendered 480x640
  JPEGs one at a time (p50/p99 latency) and from 8 clients at once
  (requests/s, p50/p99, the mean micro-batch), and over rendered maps
  card against CPU, a crowded frame retried through K2; the video demo
  on a 64-frame Motion-JPEG AVI (frames/s; the output rereads); the
  picture demo; the eval CLI's ``--vis-dir`` (one drawing a frame);

and checks that each path launched its kernels.  Also holds one fp32
train step on the card against the CPU.  Prints timings beside the card's
name and power limit, a JSON line of per-kernel results, and as the last
line ``{"ok": true, "device": {...}}``.  Any failed check raises, so the
exit code is not 0.  Needs one CUDA card of compute capability 9.0;
imports nothing of JAX or of the JAX package (rtpose_tpu).
"""

from __future__ import annotations

import copy
import functools
import json
import math
import os
import shutil
import subprocess
import sys
import time
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SCORE_TOL = 1e-5       # connection, refine and people scores, kernel
                       # vs plain (the same fp32 ops: 0 expected)
FWD_REL_TOL = 2e-4     # fp32 forward card vs CPU, relative to max |CPU|
GT_TOL = 1e-6          # ground-truth maps, K4 vs plain
STEP_LOSS_RTOL = 1e-4  # fp32 train step card vs CPU: the loss
STEP_UPD_TOL = 1e-2    # ... and each tensor's update, L2 error over L2
                       # norm: cuDNN and oneDNN sum the gradients in
                       # other orders, which grows through the backward
                       # pass (3.3e-4 seen in the stage-4 to 6 convs)
TRAIN_BATCH = 72       # experiments/vgg19_368x368_sgd.yaml
SERVING_KERNELS = ("connection_scores", "bicubic_refine", "group_people")
MS_SCALES = (0.5, 1.0, 1.5, 2.0)
# the card's peaks, for the bounds: H100 SXM at 700 W (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# the least time of one dependent shared-memory round trip, in SM cycles:
# a load's latency (~30 cycles on Hopper) with nothing else on the chain;
# a chain of dependent steps takes at least that many a step
SMEM_ROUND_TRIP_CYCLES = 30
# fp32 operations per scored candidate, counted from
# csrc/connection_scores.cu: d and |d| 6, u and the step 4, ten samples
# of 11 (two coordinates 6, the dot 3, compare and sum 2), criterion 6
SCORE_FLOPS = 126
# per grid cell and visited person, from csrc/gt_maps.cu: 18 parts of 9
# (distance 5, scale, cutoff, exp, sum), 19 limbs of 14 (perpendicular
# distance 6, box 5, three sums); per cell the clip, background and mean 75
GT_FLOPS_CELL_PERSON = 428
GT_FLOPS_CELL = 75
SLOTS = 32             # person slots per image (MAX_PEOPLE_PER_IMAGE)
READ_TOL = 0           # the reader (Pillow) vs cv2's pixels: both decode
                       # with libjpeg-turbo's defaults, so exactly equal
RESULT_KP_TOL = 1e-4   # eval results card vs CPU: keypoints, px
# the flagship eval's COCO set: (h, w) and images of each; 640x480,
# 480x640 and 640x427 are COCO val2017's commonest sizes, and 640x478
# frames share 640x480's bucket, so its chunks split into sub-batches
EVAL_SHAPES = (((480, 640), 24), ((640, 480), 24), ((427, 640), 24),
               ((478, 640), 8))
EVAL_MS_SCALES = "0.5,1,1.5,2"
EVAL_STAGES = 6
# training from files: COCO's commonest frame sizes (h, w); enough JPEGs
# that 4 batches of 72 hold people, and ~72 for val; the loader-only and
# loader-fed runs read the train set FED_ROUNDS times over
TRAIN_SHAPES = ((480, 640), (640, 480), (427, 640))
TRAIN_FILES, VAL_FILES = 336, 81
FED_ROUNDS = 6


def log(*args) -> None:
    print(*args, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def descendants() -> list:
    """(pid, command line) of every process this one started, directly or
    not, that is still running, from /proc."""
    children = {}
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                stat = f.read()
        except OSError:   # ended meanwhile
            continue
        ppid = int(stat[stat.rfind(")") + 2:].split()[1])
        children.setdefault(ppid, []).append(int(pid))
    found, todo = [], [os.getpid()]
    while todo:
        for pid in children.get(todo.pop(), []):
            todo.append(pid)
            try:
                with open(f"/proc/{pid}/cmdline") as f:
                    found.append((pid, f.read().replace("\0", " ")[:120]))
            except OSError:
                pass
    return found


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


def device_events(fn, iters: int) -> dict:
    """torch.profiler's device events over `iters` calls of fn (after a
    warm-up call): {name: (count, self device time in us, summed)}.  A
    session now and then comes back with no device event at all (seen on
    an H100, on a stage that launches a kernel every call); such a session
    is taken again, twice at most."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    events = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = {e.key: (e.count, e.self_device_time_total)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA}
        if events:
            break
    return events


def device_ms(fn, kernel: str, iters: int = 200):
    """Device time per launch of the CUDA kernel whose name holds
    `kernel`, in ms: its own self device time over the launches the
    profiler recorded in `iters` calls (it may miss one), or, where the
    profiler shows no device time, the median of CUDA events around
    single calls.  Returns (ms, source)."""
    import torch
    hits = [(n, us) for key, (n, us) in device_events(fn, iters).items()
            if kernel in key]
    count = sum(n for n, _ in hits)
    if count and sum(us for _, us in hits) > 0:
        check(count <= iters, f"profiler saw {count} launches of {kernel} "
              f"in {iters} calls")
        return sum(us for _, us in hits) / count / 1e3, "profiler"
    times = []
    for _ in range(50):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), "events"


def host_ms(fn, calls: int = 1000) -> float:
    """Host time per call of fn in ms: `calls` calls with no synchronise
    between them, then one."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / calls


def bound(n_bytes: float, n_flops: float):
    """The least time the card could take for work that moves `n_bytes`
    and does `n_flops` fp32 operations -> (ms, what bounds it)."""
    t_mem, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / FP32_FLOPS_PER_S
    return max(t_mem, t_ops) * 1e3, "bytes" if t_mem >= t_ops else \
        "operations"


def scores_work(paf, K: int):
    """(bytes, flops) of connection_scores: the PAF and the peaks read
    once, the (B, 19, K, K) scores and flags written once."""
    B = paf.shape[0]
    cand = B * 19 * K * K
    return (paf.numel() * 4 + B * 18 * K * 9 + cand * 5,
            SCORE_FLOPS * cand)


def refine_work(heat, py, px, valid, blur: bool, factor: int = 8):
    """(bytes, flops) of bicubic_refine on this run's peaks: only the
    slots that hold a peak are refined, each on its clipped window's
    (ph * f, pw * f) region; every slot's indices are read and its three
    outputs written.  The blur is a banded filter: its two products are
    counted over the non-zero taps of the extent's blur matrix (at most 25
    a row), not over its dense rows."""
    import torch
    from rtpose_tpu_torch.ops.kernels import blur_matrices
    H, W = heat.shape[-2:]
    y_min, x_min = (py - 2).clamp(min=0), (px - 2).clamp(min=0)
    eh = ((py + 2).clamp(max=H - 1) - y_min + 1)[valid].long()   # 3, 4 or 5
    ew = ((px + 2).clamp(max=W - 1) - x_min + 1)[valid].long()
    vh, vw = (eh * factor).double(), (ew * factor).double()
    mac = vh * 25 + vh * vw * 5              # My * patch, then * Mx^T
    mats = 3 * 5 * factor * 5 * 4
    if blur:
        taps = torch.as_tensor((blur_matrices(factor) != 0).sum((1, 2)),
                               dtype=torch.float64, device=eh.device)
        # By * up: each row's taps for every column; then * Bx^T likewise
        mac = mac + taps[eh - 3] * vw + vh * taps[ew - 3]
        mats += 3 * (5 * factor) ** 2 * 4
    slots = py.numel()
    n_bytes = int(valid.sum()) * 25 * 4 + slots * (4 + 4 + 1 + 12) + mats
    return n_bytes, float((2 * mac + vh * vw).sum())


def gt_work(kps, n_pers, gy: int, gx: int):
    """(bytes, flops) of the ground-truth synthesis: the keypoints read
    once, (B, gy, gx, 19) + (B, gy, gx, 38) written once; the operations
    of the persons that this batch's images visit (`n_pers`)."""
    B = kps.shape[0]
    cells = gy * gx
    n_bytes = kps.numel() * 4 + B * cells * 57 * 4
    return n_bytes, (GT_FLOPS_CELL_PERSON * int(n_pers.sum())
                     + GT_FLOPS_CELL * B) * cells


def group_work(args, max_candidates: int, max_people: int,
               max_total_conns: int):
    """(bytes, flops, chain) of group_people on this run's candidates: each
    pair's sorted candidates read up to its first invalid one (or C), the
    candidate at C once where C < K*K (the overflow test), the peaks once,
    the People written once; the operations of the assembly steps this
    data takes (each ORs two peak ids' row masks, ceil(Pp / 64) words, and
    writes at most 20 columns), of the greedy steps (4 each) and of the
    epilogue.  `chain`
    is the longest serial chain of one image: its longest pair scan plus
    its assembly steps, the dependent steps that bound the kernel."""
    import torch
    from rtpose_tpu_torch.ops.kernels import greedy_plain
    ss, si, x, y, ps, tr = args
    B, P, KK = ss.shape
    K = x.shape[-1]
    C = min(max_candidates, KK)
    M = min(max_total_conns, P * K)
    n_valid = (ss[..., :C] > -torch.inf).sum(-1)               # (B, 19)
    scanned = torch.where(n_valid < C, n_valid + 1, n_valid)
    conns = greedy_plain(ss, si, K, max_candidates)
    steps = conns[3].sum((1, 2)).clamp(max=M)                 # (B,)
    chain = int((scanned.amax(-1) + steps).max())
    n_bytes = (int(scanned.sum()) * 12 + (B * P * 4 if C < KK else 0)
               + x.numel() * 12 + B + B * max_people * (18 * 12 + 5) + B)
    n_flops = (int(steps.sum()) * (2 * -(-max_people // 64) + 20)
               + int(scanned.sum()) * 4 + B * max_people * 5)
    return n_bytes, float(n_flops), chain


def sm_clock_under_load(fn, seconds: float = 1.0) -> float:
    """The SM clock in MHz that nvidia-smi reads (every 100 ms) while fn
    runs back to back for about `seconds`: the median of its samples."""
    import torch
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate()
    samples = [float(v) for v in out.split() if v.strip()]
    check(bool(samples), "nvidia-smi read no SM clock")
    return float(np.median(samples))


def device_work(fn, calls: int = 20):
    """(kernels, copies and fills, kernel names) that one call of fn puts
    on the device, as the profiler reads them over `calls` calls (so one
    event the profiler misses does not change the count)."""
    events = device_events(fn, calls)
    kern = sorted(k for k in events if not k.startswith(("Memcpy", "Memset")))
    other = sorted(k for k in events if k.startswith(("Memcpy", "Memset")))
    count = lambda names: round(  # noqa: E731
        sum(events[k][0] for k in names) / calls)
    return count(kern), count(other), kern


def _person(cx, cy, s, rng, jitter):
    from rtpose_tpu_torch.utils.synth import _TEMPLATE
    return np.array([(cx + (tx - 0.5) * s, cy + (ty - 0.5) * s)
                     + rng.normal(0, jitter * s, 2)
                     for tx, ty in _TEMPLATE.values()])


def scenes(n_frames: int, h: int, w: int, grid, seed0: int):
    """(B, h, w, 19) heatmaps and (B, h, w, 38) PAFs of random people, or
    of a (rows, cols) grid of people, with PAF noise that breaks ties
    (rendered by the port's copy of tests/util_synth.py)."""
    from rtpose_tpu_torch.utils.synth import render_maps
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


def train_batch(n: int, size: int, seed: int):
    """A training batch of rendered scenes: uint8 RGB images of people
    drawn as part disks and limb strokes on noise, their (n, SLOTS, 18, 3)
    keypoints, and full content windows.  Image i holds i % 9 persons
    (so 0 to 8, and some images none); images with 8 leave slot 1
    all-invisible in the middle of the padding."""
    from rtpose_tpu_torch.skeleton import LIMBS, NUM_PARTS
    rng = np.random.RandomState(seed)
    images = rng.randint(40, 120, (n, size, size, 3)).astype(np.uint8)
    kps = np.zeros((n, SLOTS, NUM_PARTS, 3), np.float32)
    colours = [(37 * p % 255, 91 * p % 255, 255 - 13 * p % 255)
               for p in range(NUM_PARTS)]

    def paint(img, x, y, r, colour):
        xi, yi = int(round(x)), int(round(y))
        img[max(yi - r, 0):max(yi + r + 1, 0),
            max(xi - r, 0):max(xi + r + 1, 0)] = colour

    for b in range(n):
        count = b % 9
        for p in range(count):
            slot = p + 1 if count == 8 and p >= 1 else p
            s = rng.uniform(0.3, 0.7) * size
            person = _person(rng.uniform(0.3, 0.7) * size,
                             rng.uniform(0.3, 0.7) * size, s, rng, 0.01)
            vis = rng.rand(NUM_PARTS) < 0.85
            kps[b, slot, :, :2] = person
            kps[b, slot, :, 2] = 2.0 * vis
            for a, c in LIMBS:
                if vis[a] and vis[c]:
                    for t in np.linspace(0.0, 1.0, 24):
                        paint(images[b], *(person[a] + t * (person[c]
                                                            - person[a])),
                              1, (230, 230, 230))
            for part in np.nonzero(vis)[0]:
                paint(images[b], *person[part], 4, colours[part])
    window = np.tile(np.array([0, 0, size, size], np.int32), (n, 1))
    return {"image": images, "keypoints": kps, "valid_xywh": window}


def edge_keypoints(gy: int, gx: int, slots: int = SLOTS, seed: int = 0):
    """(4, slots, 18, 3) keypoints that press on K4's culling, for a
    (gy, gx) grid at stride 8: image 0 persons on the grid's border cells
    and corners; image 1 every slot full, half of the persons wholly
    outside the grid, some far outside; image 2 empty; image 3 only the
    last two slots: parts at the Gaussian's cutoff distance from a cell
    centre, to either side of it by ulps, and limbs that cross the whole
    grid or have no length."""
    rng = np.random.RandomState(seed)
    h, w = 8.0 * gy, 8.0 * gx
    kps = np.zeros((4, slots, 18, 3), np.float32)
    border = [(3.5, 3.5), (w - 4.5, 3.5), (3.5, h - 4.5), (w - 4.5, h - 4.5),
              (0.0, 0.0), (w - 1, h - 1), (-0.5, h / 2), (w / 2, h - 0.5)]
    for p, (x, y) in enumerate(border[:slots]):
        kps[0, p, :, 0] = x + rng.uniform(-1, 1, 18) * (p % 2)
        kps[0, p, :, 1] = y + rng.uniform(-1, 1, 18) * (p % 2)
        kps[0, p, :, 2] = 2
    for p in range(slots):
        lo, hi = ((-0.2, 1.2), (-3.0, -1.1), (1.1, 3.0), (-1e4, 1e4))[p % 4]
        kps[1, p, :, 0] = rng.uniform(lo, hi, 18) * w
        kps[1, p, :, 1] = rng.uniform(lo, hi, 18) * h
        kps[1, p, :, 2] = rng.choice([0, 2], 18, p=[.2, .8])
    reach = np.float32(np.sqrt(np.float64(np.float32(4.6052)) * 2 * 49.0))
    cx, cy = 8.0 * (gx // 2) + 3.5, 8.0 * (gy // 2) + 3.5
    for part in range(18):
        d = reach + np.float32((part - 9) * 2e-6 * reach)
        ang = (0.0, np.pi / 2, np.pi, np.pi / 4)[part % 4]
        kps[3, slots - 1, part] = (cx + d * np.cos(ang),
                                   cy + d * np.sin(ang), 2)
    kps[3, slots - 2, :, 0] = np.where(np.arange(18) % 2, -5.0, w + 5.0)
    kps[3, slots - 2, :, 1] = np.linspace(-5.0, h + 5.0, 18)
    kps[3, slots - 2, 8:11, :2] = (w / 2, h / 2)
    kps[3, slots - 2, :, 2] = 2
    return kps


def people_equal(a, b, what: str) -> float:
    """Check two People equal (scores within SCORE_TOL); -> the largest
    score difference."""
    for f in ("coords", "valid", "truncated"):
        check(np.array_equal(getattr(a, f), getattr(b, f)),
              f"{what}: People.{f} differ")
    worst = 0.0
    for f in ("score", "part_score"):
        err = float(np.abs(getattr(a, f) - getattr(b, f)).max(initial=0))
        check(err <= SCORE_TOL, f"{what}: People.{f} max err {err}")
        worst = max(worst, err)
    return worst


def eval_phase(dev, smi: str) -> dict:
    """The COCO eval path on the card: the reader against cv2's pixels of
    the committed fixtures; the oracle-stub eval (``utils/synth_coco.py``)
    through ``run_eval`` and ``run_eval_batched`` card vs CPU; ``run``'s one
    wait for the card; then the flagship through the CLI's ``main()``,
    batched, multi-scale and per image (with ``--vis-dir``: one drawing a
    frame), each counted from 0 -> {run label: launch counts}."""
    import contextlib
    import io
    from collections import defaultdict

    import PIL
    import torch
    from rtpose_tpu_torch.data import imread_fixtures as fx
    from rtpose_tpu_torch.data.imread import read_bgr
    from rtpose_tpu_torch.demo import picture_demo
    from rtpose_tpu_torch.evalx import __main__ as evalx_cli
    from rtpose_tpu_torch.evalx.harness import run_eval, run_eval_batched
    from rtpose_tpu_torch.infer.pipeline import PosePipeline
    from rtpose_tpu_torch.infer.preprocess import scale_pad_geometry
    from rtpose_tpu_torch.ops import kernels
    from rtpose_tpu_torch.utils.synth_coco import (OracleMaps,
                                                   compare_results,
                                                   oracle_maps,
                                                   spread_people,
                                                   write_synth_coco)

    # the reader (route a, Pillow) on the fixture JPEGs: 4:2:0 with odd
    # sides, 4:4:4, grayscale, progressive, EXIF orientations 3, 6 and 8
    pixels = np.load(fx.CV2_PIXELS)
    worst, means = 0, []
    for name in fx.FIXTURES:
        got, want = read_bgr(fx.fixture_path(name)), pixels[name]
        check(got.shape == want.shape and got.dtype == np.uint8,
              f"reader: {name} read as {got.shape}, cv2 {want.shape}")
        diff = np.abs(got.astype(np.int16) - want)
        worst, means = max(worst, int(diff.max())), means + [diff.mean()]
    check(worst <= READ_TOL, f"reader vs cv2's pixels: max diff {worst}")
    log(f"reader (Pillow {PIL.__version__}) on {len(fx.FIXTURES)} fixture "
        f"JPEGs ({', '.join(fx.FIXTURES)}) vs cv2's pixels: shapes equal, "
        f"max diff {worst}, mean {float(np.mean(means))!r}")

    work = os.path.join(ROOT, "rtpose_tpu_torch", "build", "chip_smoke_eval")
    shutil.rmtree(work, ignore_errors=True)
    try:
        # oracle stub, card vs CPU: frames of short side 368 (scale 1);
        # 368x490 and 368x496 share a bucket and their people
        rng = np.random.RandomState(0)
        scenes = {(368, 496): spread_people(rng, 2, 368, 496),
                  (496, 368): spread_people(rng, 1, 496, 368),
                  (368, 552): spread_people(rng, 3, 368, 552)}
        scenes[(368, 490)] = scenes[(368, 496)]
        shapes = list(scenes) * 6
        img_dir, ann = write_synth_coco(
            os.path.join(work, "oracle"),
            [(h, w, scenes[(h, w)]) for h, w in shapes])
        maps = oracle_maps(scenes, 368)
        runs = {}
        for side in ("cpu", "card"):
            opipe = PosePipeline(OracleMaps(maps), device=(
                dev if side == "card" else "cpu"), input_size=368,
                flip=False)
            for name, fn, kw in (("run_eval", run_eval, {}),
                                 ("run_eval_batched", run_eval_batched,
                                  dict(batch_size=8))):
                path = os.path.join(work, f"{side}_{name}.json")
                with contextlib.redirect_stdout(io.StringIO()):
                    stats = fn(img_dir, ann, opipe, results_path=path, **kw)
                with open(path) as f:
                    runs[side, name] = (stats, json.load(f))
        for name in ("run_eval", "run_eval_batched"):
            (s_card, r_card), (s_cpu, r_cpu) = (runs["card", name],
                                                runs["cpu", name])
            kp_err, score_err = compare_results(r_card, r_cpu)
            check(len(r_card) == 6 * 8 and kp_err <= RESULT_KP_TOL
                  and score_err <= SCORE_TOL,
                  f"oracle {name}: {len(r_card)} results, card vs CPU "
                  f"keypoints {kp_err}, scores {score_err}")
            check(s_cpu["AP"] > 0.9 and s_card["AP"] >= s_cpu["AP"],
                  f"oracle {name}: AP card {s_card['AP']} CPU {s_cpu['AP']}")
            log(f"oracle-stub eval {name} ({len(shapes)} frames of "
                f"{len(scenes)} raw shapes, {len(r_card)} people): card == "
                f"CPU (keypoints max diff {kp_err:.3g} px, scores "
                f"{score_err:.3g}); AP card {s_card['AP']!r}, CPU "
                f"{s_cpu['AP']!r}")

        # run: one wait for the people and both maps
        frame = np.zeros((368, 496, 3), np.uint8)
        opipe.run(frame)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                opipe.run(frame)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        check(syncs == 1, f"run synchronised {syncs} times: "
              f"{[str(w.message) for w in caught]}")
        log("run: one synchronising call (people and both maps read back "
            "together)")
        del opipe

        # the flagship through the CLI: seeded random weights, so no
        # people, but every batch runs the forward and the decode kernels
        frames = [shape for shape, n in EVAL_SHAPES for _ in range(n)]
        order = [frames[i] for i in
                 np.random.RandomState(1).permutation(len(frames))]
        rng = np.random.RandomState(2)
        img_dir, ann = write_synth_coco(
            os.path.join(work, "flagship"),
            [(h, w, spread_people(rng, 1 + i % 2, h, w))
             for i, (h, w) in enumerate(order)])
        names = sorted(os.listdir(img_dir))
        for name in names:           # page the files in
            read_bgr(os.path.join(img_dir, name))
        t0 = time.perf_counter()
        for name in names:
            read_bgr(os.path.join(img_dir, name))
        read_ms = (time.perf_counter() - t0) * 1e3 / len(names)

        subs = defaultdict(lambda: [0, 0])   # bucket -> chunks, sub-batches
        build_s = []

        def spied(orig):
            def submit(self, frames, *args):
                ticket = orig(self, frames, *args)
                key = scale_pad_geometry(*frames[0].shape[:2],
                                         self.input_size,
                                         self.pad_factor)[3:5]
                subs[key][0] += 1
                subs[key][1] += (len(ticket[2]) if ticket[0] == "multi"
                                 else 1)
                return ticket
            return submit

        def timed_build(args):
            t = time.perf_counter()
            pipe = build(args)
            torch.cuda.synchronize()
            build_s.append(time.perf_counter() - t)
            return pipe

        build = picture_demo.build_pipeline
        submits = (PosePipeline.run_batch_submit,
                   PosePipeline.run_multiscale_batch_submit)
        base = ["evalx", "--image-dir", img_dir, "--ann", ann,
                "--preprocess", "vgg", "--input-size", "368", "--stages",
                str(EVAL_STAGES), "--device", str(dev)]
        counts, lines = {}, []
        argv = sys.argv
        try:
            picture_demo.build_pipeline = timed_build
            PosePipeline.run_batch_submit = spied(submits[0])
            PosePipeline.run_multiscale_batch_submit = spied(submits[1])
            vis_dir = os.path.join(work, "vis")
            for label, extra in (
                    ("batch8", ["--batch", "8"]),
                    ("batch8_multiscale",
                     ["--batch", "8", "--multiscale", EVAL_MS_SCALES]),
                    ("per_image", ["--vis-dir", vis_dir])):
                sys.argv = base + extra
                subs.clear()
                torch.cuda.synchronize()
                kernels.reset_launch_counts()
                t0 = time.perf_counter()
                out = io.StringIO()
                with contextlib.redirect_stdout(out):
                    stats = evalx_cli.main()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts[label] = kernels.launch_counts()
                text = out.getvalue()
                check(f"mAP (OKS .50:.95) = {stats['AP']:.4f}" in text
                      and math.isfinite(stats["AP"]),
                      f"evalx {label}: no mAP line")
                check(all(counts[label][k] > 0 for k in SERVING_KERNELS)
                      and counts[label]["gt_maps"] == 0,
                      f"evalx {label} did not run through the serving "
                      f"kernels: {counts[label]}")
                if "--vis-dir" in extra:
                    drawn = sorted(os.listdir(vis_dir))
                    check(drawn == names and all(
                        read_bgr(os.path.join(vis_dir, n)).shape
                        == read_bgr(os.path.join(img_dir, n)).shape
                        for n in names),
                        f"evalx {label} --vis-dir wrote {len(drawn)} "
                        f"drawings for {len(names)} frames")
                    lines.append(f"evalx {label} --vis-dir: one drawing "
                                 f"a frame ({len(drawn)})")
                eval_s = wall - build_s[-1]
                split = (f"pipeline_s {stats['pipeline_s']!r}, evaluator_s "
                         f"{stats['evaluator_s']!r}, "
                         if "pipeline_s" in stats else "")
                lines.append(
                    f"evalx {label}: {len(names)} images in {eval_s:.3f} s "
                    f"after a {build_s[-1]:.3f} s build = "
                    f"{len(names) / eval_s:.2f} images/s; {split}"
                    f"mAP {stats['AP']!r}; chunks and sub-batches per "
                    f"bucket {dict((k, tuple(v)) for k, v in subs.items())}"
                    f"; launches {counts[label]}")
        finally:
            sys.argv = argv
            picture_demo.build_pipeline = build
            PosePipeline.run_batch_submit = submits[0]
            PosePipeline.run_multiscale_batch_submit = submits[1]
        for line in lines:
            log(line)
        log(f"eval: flagship VGG19 {EVAL_STAGES} stages 368 px flip bf16, "
            f"seeded "
            f"weights, {len(names)} JPEGs of "
            f"{[f'{w}x{h}' for (h, w), _ in EVAL_SHAPES]}; read "
            f"{read_ms:.3f} ms/image (Pillow, one thread) [{smi}]")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return counts


def train_files_phase(dev, smi: str, step_ms: float) -> int:
    """Training from files: JPEGs of COCO's commonest sizes with 0-8
    people, crowd regions and unlabelled people
    (``utils/synth_coco.py``), through the training CLI's ``main()`` on
    the flagship experiment for one epoch, then the loader on its own:
    same seed same batches, 1 worker == in-process, K4 on a loader batch
    == plain, and the loader's img/s at 1 and W worker processes, alone
    and feeding the trainer -> the CLI run's gt_maps launches."""
    import contextlib
    import io
    import itertools

    import PIL.Image
    import torch
    from rtpose_tpu_torch.data import transforms as T
    from rtpose_tpu_torch.data.dataset import (CocoKeypoints,
                                               ConcatKeypoints, Loader,
                                               stop_worker_processes)
    from rtpose_tpu_torch.ops import kernels
    from rtpose_tpu_torch.train import __main__ as train_cli
    from rtpose_tpu_torch.train.checkpoint import CheckpointManager
    from rtpose_tpu_torch.train.trainer import Trainer
    from rtpose_tpu_torch.utils.synth_coco import (training_frames,
                                                   write_synth_coco)

    nproc = len(os.sched_getaffinity(0))
    workers = min(8, nproc)
    work = os.path.join(ROOT, "rtpose_tpu_torch", "build", "chip_smoke_train")
    shutil.rmtree(work, ignore_errors=True)

    def shares(logs):
        """Each step's data-wait share, from ``run_epoch``'s logs."""
        return [round(d / s, 3) for d, s in zip(logs["data_s"],
                                                logs["step_s"])]

    try:
        t0 = time.perf_counter()
        rng = np.random.RandomState(3)
        shapes = [TRAIN_SHAPES[i % 3] for i in range(TRAIN_FILES)]
        train_dir, train_ann = write_synth_coco(
            os.path.join(work, "train"), training_frames(rng, shapes))
        val_dir, val_ann = write_synth_coco(
            os.path.join(work, "val"),
            training_frames(rng, shapes[:VAL_FILES]), seed=TRAIN_FILES)
        ckpt_dir = os.path.join(work, "ckpt")
        log(f"training from files: wrote {TRAIN_FILES} + {VAL_FILES} JPEGs "
            f"of {[f'{w}x{h}' for h, w in TRAIN_SHAPES]} in "
            f"{time.perf_counter() - t0:.1f} s")

        # the flagship through the CLI, one epoch
        sets = [f'dataset.train_image_dir="{train_dir}"',
                f'dataset.train_annotations=["{train_ann}"]',
                f'dataset.val_image_dir="{val_dir}"',
                f'dataset.val_annotations="{val_ann}"',
                f'train.checkpoint_dir="{ckpt_dir}"',
                f"train.data_workers={workers}"]
        config = os.path.join(ROOT, "experiments", "vgg19_368x368_sgd.yaml")
        argv = sys.argv
        sys.argv = ["train", "--config", config, "--epochs", "1",
                    "--device", str(dev), "--set", *sets]
        out = io.StringIO()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                trainer, history = train_cli.main()
            torch.cuda.synchronize()
        finally:
            sys.argv = argv
        cli_s = time.perf_counter() - t0
        cli_counts = kernels.launch_counts()
        cfg = trainer.cfg
        check((cfg.model.name, cfg.model.num_stages, cfg.dataset.image_size,
               cfg.model.dtype, cfg.train.batch_size) ==
              ("vgg19", 6, 368, "bfloat16", TRAIN_BATCH), "flagship config")
        (epoch_logs,) = history
        steps = len(epoch_logs["train"]["step_s"])
        val_steps = len(epoch_logs["val"]["step_s"])
        check(steps == 4 and trainer.step == steps,
              f"CLI epoch took {trainer.step} steps over {steps} batches")
        check(cli_counts["gt_maps"] == steps + val_steps,
              f"gt_maps launched {cli_counts['gt_maps']} times for "
              f"{steps} train and {val_steps} val steps")
        mgr = CheckpointManager(ckpt_dir)
        state, meta = mgr.restore_latest(dev)
        check(math.isfinite(meta["train_loss"])
              and math.isfinite(meta["val_loss"]),
              f"CLI losses: train {meta['train_loss']}, val "
              f"{meta['val_loss']}")
        fresh = Trainer(cfg, device=dev)
        fresh.restore((state, meta))
        restored = all(torch.equal(a, b) for a, b in zip(
            fresh.model.state_dict().values(),
            trainer.model.state_dict().values()))
        check(restored and fresh.step == trainer.step,
              "the CLI's checkpoint did not restore")
        del fresh, state
        log(f"train CLI, flagship (VGG19 6 stages 368 px bf16 batch "
            f"{TRAIN_BATCH}) from JPEGs, 1 epoch, {workers} worker "
            f"processes: {steps} steps + {val_steps} val in "
            f"{cli_s:.2f} s (model build and worker start included); "
            f"train loss {meta['train_loss']!r}, val loss "
            f"{meta['val_loss']!r}; its checkpoint restores bit-equal; launches {cli_counts}; data-wait share "
            f"per step {shares(epoch_logs['train'])}, wait s "
            f"{[round(w, 3) for w in epoch_logs['train']['data_s']]} "
            f"[{smi}]")

        # the loader alone: same seed same batches; 1 worker == in-process
        size = cfg.dataset.image_size
        grid = size // cfg.model.downsample
        train_ds = CocoKeypoints(train_dir, train_ann, input_size=size)
        check(len(train_ds) >= 4 * TRAIN_BATCH, f"{len(train_ds)} images")

        def first(loader, n):
            out, t = [], [time.perf_counter()]
            for batch in loader:
                out.append(batch)
                t.append(time.perf_counter())
                if len(out) == n:
                    break
            return out, t

        runs = [first(Loader(train_ds, TRAIN_BATCH, num_workers=workers,
                             seed=5), 4)[0] for _ in range(2)]
        same = all(torch.equal(a[k], b[k]) for a, b in zip(*runs)
                   for k in a)
        check(len(runs[0]) == 4 and same,
              f"two {workers}-worker runs with one seed differ")
        one, t_one = first(Loader(train_ds, TRAIN_BATCH, num_workers=1,
                                  seed=5), 2)
        zero, t_zero = first(Loader(train_ds, TRAIN_BATCH, num_workers=0,
                                    seed=5), 1)
        check(all(torch.equal(one[0][k], zero[0][k]) for k in one[0]),
              "1 worker process != num_workers=0")
        one_ips = TRAIN_BATCH / (t_one[2] - t_one[1])
        zero_ips = TRAIN_BATCH / (t_zero[1] - t_zero[0])

        # K4 on a loader batch vs its plain version (not counted: the
        # CLI's counts are read above)
        kps = runs[0][0]["keypoints"].to(dev)
        heat, paf = kernels.gt_maps(kps, grid_y=grid, grid_x=grid,
                                    stride=8, sigma=7.0)
        heat_p, paf_p = kernels.gt_maps_plain(
            kps, kernels.limb_scalars(kps, 8), kernels.person_bound(kps),
            grid_y=grid, grid_x=grid, stride=8, sigma=7.0)
        k4_err = max(float((heat - heat_p).abs().max()),
                     float((paf - paf_p).abs().max()))
        check(k4_err == 0.0, f"K4 on a loader batch: max err {k4_err}")
        n_kp = int((kps[..., 2] > 0).sum())
        del runs, one, zero, kps, heat, paf, heat_p, paf_p

        # where one worker's time goes: get()'s stages on 24 images
        spent, n_get = {}, 24
        srng = np.random.default_rng(0)

        def stage(name, fn, *a):
            t = time.perf_counter()
            out = fn(*a)
            spent[name] = spent.get(name, 0.0) + time.perf_counter() - t
            return out

        for i in range(n_get):
            _, path, kp17, corners = stage("annotations", train_ds.raw_sample,
                                           i)
            image = stage("read+decode", lambda p: PIL.Image.open(p).convert(
                "RGB"), path)
            sample = T.Sample.new(image, np.concatenate([kp17, corners]))
            for tr in train_ds.preprocess.transforms:
                name = type(getattr(tr, "transform", tr)).__name__
                sample = stage(name, tr, sample, srng)
            arr = stage("to_tensor+mask", lambda s: T.mask_valid_area(
                T.image_to_tensor(s.image), s.meta["valid_area"]), sample)
            stage("keypoints+loss mask", train_ds.finalize_keypoints,
                  sample.keypoints, len(kp17))
        del arr
        get_ms = {k: round(v * 1e3 / n_get, 2) for k, v in spent.items()}

        # throughput: the loader alone at W workers, then feeding the
        # trainer, over the train set read FED_ROUNDS times
        many = ConcatKeypoints([train_ds] * FED_ROUNDS)
        # whole rounds of the workers: after the first, each round takes
        # one batch's time at W processes
        n_batches = len(many) // TRAIN_BATCH // workers * workers
        check(n_batches >= 2 * workers, f"{n_batches} batches: too few")
        batches, t_w = first(Loader(many, TRAIN_BATCH, num_workers=workers,
                                    seed=6, pin_memory=True), n_batches)
        del batches
        w_ips = (n_batches - workers) * TRAIN_BATCH / (t_w[-1]
                                                       - t_w[workers])
        w_all_ips = n_batches * TRAIN_BATCH / (t_w[-1] - t_w[0])
        fed = Loader(many, TRAIN_BATCH, num_workers=workers, seed=7,
                     pin_memory=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            fed_logs = trainer.run_epoch(itertools.islice(fed, n_batches))
        torch.cuda.synchronize()
        fed_s = time.perf_counter() - t0
        steady_s = sum(fed_logs["step_s"][workers:])
        fed_ips = (n_batches - workers) * TRAIN_BATCH / steady_s
        wait_share = sum(fed_logs["data_s"][workers:]) / steady_s
        del trainer
        torch.cuda.empty_cache()
        log(f"loader: nproc {nproc}; {TRAIN_BATCH}-image batches from "
            f"{[f'{w}x{h}' for h, w in TRAIN_SHAPES]} JPEGs: in-process "
            f"{zero_ips:.1f} img/s, 1 worker process {one_ips:.1f} img/s "
            f"({1e3 / one_ips:.2f} ms/img), {workers} worker processes "
            f"{w_ips:.1f} img/s after the first round ({w_all_ips:.1f} "
            f"over all {n_batches} batches, worker start included); same "
            f"seed same batches ({workers} workers, twice), 1 worker == "
            f"in-process; K4 on a loader batch ({n_kp} visible keypoints) "
            f"== plain, max err {k4_err}; one process's ms per image by "
            f"stage: {get_ms} ({sum(get_ms.values()):.2f} in all) [{smi}]")
        log(f"train fed by the loader ({workers} worker processes, pinned "
            f"batches), flagship bf16 batch {TRAIN_BATCH}: {n_batches} steps "
            f"in {fed_s:.2f} s; after the first round {fed_ips:.1f} img/s, "
            f"data-wait share {wait_share:.3f}; in memory (phase 9) "
            f"{TRAIN_BATCH * 1e3 / step_ms:.1f} img/s; data-wait share per "
            f"step {shares(fed_logs)} [{smi}]")
    finally:
        shutil.rmtree(work, ignore_errors=True)
        # the forkserver and the resource tracker outlive the loaders
        stop_worker_processes()
    return cli_counts["gt_maps"]



# the model zoo: every family but the flagship, at its published width
# (openpose_v2 4 PAF + 2 heat stages, shufflenet_v2 width 1.0):
# (family, stages, input px, output stride, pad_factor, train batch).
# Train batches: hourglass 32 (experiments/hourglass_256x256.yaml),
# shufflenet_v2 64 (its yaml), the others the flagship yaml's 72
ZOO = (("openpose_v2", 6, 368, 8, 0, 72),
       ("mobilenet", 6, 368, 8, 0, 72),
       ("shufflenet_v2", 1, 368, 8, 0, 64),
       ("atrous_resnet50", 1, 368, 8, 0, 72),
       ("atrous_cpm", 5, 368, 8, 0, 72),
       ("atrous_cpm_shared", 5, 368, 8, 0, 72),
       ("hourglass", 8, 256, 4, 64, 32))
# the families whose eval-mode forward keeps its scale at He init (the
# residual ones, whose running statistics do not rescale their sums, keep
# their own init for the fp32 card-vs-CPU forward)
ZOO_HE = ("openpose_v2", "mobilenet", "shufflenet_v2", "atrous_cpm",
          "atrous_cpm_shared")
ZOO_KERNELS = ("connection_scores", "bicubic_refine", "group_people",
               "gt_maps")


def rendered_maps_model(heat, paf):
    """A module that stands in for a network: it answers every batch with
    the same rendered maps, stage-stacked."""
    import torch

    from rtpose_tpu_torch.models.common import ModelOutput

    class RenderedMaps(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.register_buffer("heat", heat)
            self.register_buffer("paf", paf)

        def forward(self, x):
            n = x.shape[0]
            return ModelOutput(pafs=self.paf[None, :n],
                               heatmaps=self.heat[None, :n])

    return RenderedMaps()


def hourglass_kernels(dev, smi: str) -> dict:
    """The serving and training kernels on hourglass's shapes: 8 rendered
    scenes on 64x64 maps (256 px frames at stride 4) and a crowded 5x6 grid
    at RETRY_CAPS, K1 (K=32) and K2 (K=64) at factor 4, K3 plain and
    blurred at factor 4, the grouping kernel on their candidates, and K4
    at stride 4 on the 64x64 grid at the hourglass batch of 32; each held
    equal to its plain version, timed in turns with its plain version
    (CUDA events around back-to-back calls), with its device time per
    launch (profiler), its wrapper's host time per call and its bound.
    Then a pipeline at stride 4 and pad 64 whose "model"
    answers with the crowded maps truncates and retries by itself, K2
    included."""
    import torch

    from rtpose_tpu_torch.infer.pipeline import RETRY_CAPS, PosePipeline
    from rtpose_tpu_torch.ops import kernels
    from rtpose_tpu_torch.ops.decode import decode_poses_batch, people_to_host
    from rtpose_tpu_torch.ops.grouping import (score_connections,
                                               sorted_candidates)
    from rtpose_tpu_torch.ops.peaks import nms, peak_candidates

    out = {}
    heat_np, paf_np = scenes(8, 64, 64, grid=None, seed0=300)
    hc_np, pc_np = scenes(8, 64, 64, grid=(5, 6), seed0=400)
    default_caps = dict(max_peaks=32, max_candidates=256, max_total_conns=160,
                        max_people=64)
    for K, caps, (hn, pn) in ((32, default_caps, (heat_np, paf_np)),
                              (64, RETRY_CAPS, (hc_np, pc_np))):
        heat = torch.from_numpy(hn).to(dev)
        paf = torch.from_numpy(pn).to(dev)
        peaks = nms(heat, factor=4, max_peaks=K)
        pk = (peaks.x, peaks.y, peaks.valid)
        got = kernels.connection_scores(paf, *pk, factor=4)
        want = kernels.connection_scores_plain(paf, *pk, factor=4)
        check(int(got[1].sum()) > 0 and torch.equal(got[0], want[0])
              and torch.equal(got[1], want[1]),
              f"connection_scores at factor 4, K={K}, differs from plain")
        ms, plain_ms = paired_ms(
            lambda: kernels.connection_scores(paf, *pk, factor=4),
            lambda: kernels.connection_scores_plain(paf, *pk, factor=4), 50)
        b_ms, b_by = bound(*scores_work(paf, K))
        fn = functools.partial(kernels.connection_scores, paf, *pk, factor=4)
        out[f"connection_scores_K{K}"] = dict(
            max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
            device_ms=device_ms(fn, "connection_scores_kernel")[0],
            host_ms=host_ms(fn), bound_ms=b_ms, bound_by=b_by)
        # the grouping kernel on these candidates
        s, v = score_connections(peaks, paf, factor=4)
        args = (*sorted_candidates(s, v), peaks.x, peaks.y, peaks.score,
                peaks.truncated)
        gk = {k: val for k, val in caps.items() if k != "max_peaks"}
        g_got = kernels.group_people(*args, **gk)
        g_want = kernels.group_people_plain(*args, **gk)
        check(all(torch.equal(a, b) for a, b in zip(g_got, g_want)),
              f"group_people on the factor-4 candidates (K={K}) differs "
              f"from plain")
        g_ms, g_plain = paired_ms(
            lambda: kernels.group_people(*args, **gk),
            lambda: kernels.group_people_plain(*args, **gk), 10)
        fn = functools.partial(kernels.group_people, *args, **gk)
        g_dev = device_ms(fn, "group_people_kernel")[0]
        # its bound, as at factor 8: the bytes it needs, and its serial
        # chain at one shared-memory round trip a step at the SM clock
        # read under its load
        n_bytes, n_flops, chain = group_work(args, **gk)
        b_ms, b_by = bound(n_bytes, n_flops)
        sm_mhz = sm_clock_under_load(fn)
        chain_ms = chain * SMEM_ROUND_TRIP_CYCLES / sm_mhz / 1e3
        out[f"group_people_K{K}"] = dict(
            max_abs_err=0.0, ms=g_ms, plain_ms=g_plain, device_ms=g_dev,
            host_ms=host_ms(fn), chain_steps=chain,
            ns_per_step=g_dev * 1e6 / chain, bytes_bound_ms=b_ms,
            chain_bound_ms=chain_ms, sm_clock_mhz=sm_mhz,
            bound_ms=max(b_ms, chain_ms),
            bound_by="chain" if chain_ms > b_ms else b_by)
        hb = heat[..., :18].permute(0, 3, 1, 2).contiguous()
        _, py, px, valid, _ = peak_candidates(hb, thresh=0.1, max_peaks=K)
        rf = (hb, py, px, valid)
        for blur, tag in ((False, ""), (True, "gaussian_filt_")):
            r_got = kernels.bicubic_refine(*rf, factor=4, gaussian_filt=blur)
            r_want = kernels.bicubic_refine_plain(*rf, factor=4,
                                                  gaussian_filt=blur)
            check(all(torch.equal(a, b) for a, b in zip(r_got, r_want)),
                  f"bicubic_refine {tag}at factor 4, K={K}, differs from "
                  f"plain")
            r_ms, r_plain = paired_ms(
                lambda: kernels.bicubic_refine(*rf, factor=4,
                                               gaussian_filt=blur),
                lambda: kernels.bicubic_refine_plain(*rf, factor=4,
                                                     gaussian_filt=blur),
                20 if blur else 50)
            b_ms, b_by = bound(*refine_work(*rf, blur, factor=4))
            fn = functools.partial(kernels.bicubic_refine, *rf, factor=4,
                                   gaussian_filt=blur)
            kname = "refine_blur_kernel" if blur else "refine_warp_kernel"
            out[f"bicubic_refine_{tag}K{K}"] = dict(
                max_abs_err=0.0, ms=r_ms, plain_ms=r_plain,
                device_ms=device_ms(fn, kname)[0], host_ms=host_ms(fn),
                bound_ms=b_ms, bound_by=b_by, valid=int(valid.sum()))
    # K4 at stride 4: the hourglass batch of 32 on the 64x64 grid
    kps = torch.from_numpy(train_batch(32, 256, seed=5)["keypoints"]).to(dev)
    gt_args = dict(grid_y=64, grid_x=64, stride=4, sigma=4.416,
                   limb_width=1.289)
    limbs = kernels.limb_scalars(kps, 4, 1.289)
    n_pers = kernels.person_bound(kps)
    k_heat, k_paf = kernels.gt_maps(kps, **gt_args)
    p_heat, p_paf = kernels.gt_maps_plain(kps, limbs, n_pers, **gt_args)
    check(torch.equal(k_heat, p_heat) and torch.equal(k_paf, p_paf),
          "gt_maps at stride 4 on the 64x64 grid differs from plain")
    ms, plain_ms = paired_ms(
        lambda: kernels.gt_maps(kps, **gt_args),
        lambda: kernels.gt_maps_plain(kps, limbs, n_pers, **gt_args), 20)
    b_ms, b_by = bound(*gt_work(kps, n_pers, 64, 64))
    fn = functools.partial(kernels.gt_maps, kps, **gt_args)
    out["gt_maps_stride4"] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
        device_ms=device_ms(fn, "gt_maps_kernel")[0], host_ms=host_ms(fn),
        bound_ms=b_ms, bound_by=b_by)
    # the retry through a pipeline at stride 4 and pad 64
    hc, pc = torch.from_numpy(hc_np[:2]), torch.from_numpy(pc_np[:2])
    crowd = PosePipeline(rendered_maps_model(hc, pc), device=dev,
                         input_size=256, downsample=4, pad_factor=64,
                         flip=False)
    blank = [np.zeros((256, 256, 3), np.uint8)] * 2
    kernels.reset_launch_counts()
    people, metas = crowd.run_batch(blank)
    torch.cuda.synchronize()
    retry_counts = kernels.launch_counts()
    want = people_to_host(decode_poses_batch(hc, pc, factor=4, **RETRY_CAPS))
    check(all(m.get("retried") and not m["truncated"] for m in metas)
          and [len(p) for p in people] == [int(v.sum()) for v in want.valid],
          f"the stride-4 pipeline did not retry the crowded scenes to the "
          f"CPU decode at RETRY_CAPS: {[m.get('retried') for m in metas]}")
    check(retry_counts["connection_scores"] == 2,
          f"first decode and retry should each launch connection_scores "
          f"(K=32, then K=64): {retry_counts}")
    out["retry_launches"] = retry_counts
    rows = {k: {kk: (round(vv, 5) if isinstance(vv, float) else vv)
                for kk, vv in v.items()} for k, v in out.items()
            if k != "retry_launches"}
    log(f"hourglass shapes (64x64 maps, factor and stride 4): K1 K=32, K2 "
        f"K=64, K3 plain and blurred, grouping and K4 (batch 32) equal to "
        f"their plain versions (error 0); the stride-4 pipeline retried "
        f"the crowded scenes -> {[len(p) for p in people]} people, "
        f"launches {retry_counts}; {json.dumps(rows)} [{smi}]")
    return out


def zoo_phase(dev, smi: str):
    """Every other family through the port's entry points (see ZOO):
    serving through ``run_batch`` (8 rendered-scene frames, flip, bf16,
    seeded weights; the decode on the card equals the CPU's on the same
    maps; K1, K3 and the grouping kernel launched), one fp32 forward card
    vs CPU, one multi-scale chunk with its bytes per frame and pixel
    against the family's cap, and training through ``Trainer`` (3 steps
    and a val step, bf16; BatchNorm statistics move in train mode and
    stay in eval mode; K4 launched and equal to plain on the batch; a
    checkpoint that restores bit-equal) -> (launches per kernel per
    family, the per-family numbers, the hourglass kernel rows)."""
    import torch

    from rtpose_tpu_torch.config import Config
    from rtpose_tpu_torch.infer.pipeline import (MS_BYTES_PER_PIXEL,
                                                 MS_SCALES, load_pipeline)
    from rtpose_tpu_torch.infer.preprocess import normalize_device
    from rtpose_tpu_torch.models import get_model
    from rtpose_tpu_torch.models.common import he_reinit
    from rtpose_tpu_torch.ops import kernels
    from rtpose_tpu_torch.ops.decode import decode_poses_batch, people_to_host
    from rtpose_tpu_torch.train.checkpoint import CheckpointManager
    from rtpose_tpu_torch.train.trainer import Trainer

    hg_rows = hourglass_kernels(dev, smi)
    launches = {k: {} for k in ZOO_KERNELS}
    numbers = {}

    def wall_ms(fn, iters):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / iters

    for name, stages, px, stride, pad, train_bs in ZOO:
        t_family = time.perf_counter()
        # -- serving -------------------------------------------------------
        pipe = load_pipeline(device=dev, model_name=name, num_stages=stages,
                             input_size=px, flip=True, seed=0,
                             downsample=stride, pad_factor=pad)
        rendered = train_batch(8, px, seed=40)["image"]
        frames = [np.ascontiguousarray(im[..., ::-1]) for im in rendered]
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        people, metas = pipe.run_batch(frames)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        for k in SERVING_KERNELS:
            check(counts[k] > 0, f"{name}: run_batch did not launch {k}")
            launches[k][name] = counts[k]
        check(counts["gt_maps"] == 0, f"{name}: serving launched gt_maps")
        g = px // stride
        check(len(people) == 8 and all(m["padded_shape"][:2] ==
                                       (px + (-px % (pad or stride)),) * 2
                                       for m in metas),
              f"{name}: run_batch results")
        ticket = pipe.run_batch_submit(frames)
        got = people_to_host(ticket[1])
        want = people_to_host(decode_poses_batch(
            ticket[2].cpu(), ticket[3].cpu(), factor=stride))
        check(tuple(ticket[2].shape) == (8, g, g, 19)
              and bool(torch.isfinite(ticket[2]).all())
              and bool(torch.isfinite(ticket[3]).all()),
              f"{name}: maps {tuple(ticket[2].shape)} not finite or not "
              f"at stride {stride}")
        people_equal(got, want, f"{name}: decode card vs CPU")
        x = normalize_device(torch.from_numpy(np.stack(frames)).to(dev),
                             "vgg")
        with torch.inference_mode():
            fwd_ms = cuda_ms(lambda: pipe.model(x), 5)
            # where the forward's time goes: the host's enqueue against
            # the device kernels it launches
            fwd_host_ms = host_ms(lambda: pipe.model(x), 5)
            events = device_events(lambda: pipe.model(x), 3)
            heat8, paf8 = ticket[2], ticket[3]
            dec_ms = wall_ms(lambda: people_to_host(decode_poses_batch(
                heat8, paf8, factor=stride)), 10)
        run_ms = wall_ms(lambda: pipe.run_batch(frames), 5)
        # -- multi-scale: one chunk of the 8 frames --------------------------
        _, _, max_px = pipe._scale_sizes(px, px, MS_SCALES)
        cap = pipe.ms_chunk_cap(max_px)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_bytes = torch.cuda.memory_allocated()
        ms_ticket = pipe.run_multiscale_batch_submit(frames, MS_SCALES)
        torch.cuda.synchronize()
        ms_cost = ((torch.cuda.max_memory_allocated() - base_bytes)
                   / (8 * max_px))
        ms_people = people_to_host(ms_ticket[1])
        ms_want = people_to_host(decode_poses_batch(
            ms_ticket[2].cpu(), ms_ticket[3].cpu(), factor=stride))
        people_equal(ms_people, ms_want, f"{name}: multi-scale decode")
        check(ms_cost <= MS_BYTES_PER_PIXEL,
              f"{name}: a multi-scale chunk took {ms_cost:.1f} bytes per "
              f"frame and pixel, more than MS_BYTES_PER_PIXEL "
              f"{MS_BYTES_PER_PIXEL}")
        del ms_ticket, ticket, pipe, x
        # -- one fp32 forward, card vs CPU -----------------------------------
        ref = get_model(name, num_stages=stages).eval()
        if name in ZOO_HE:
            he_reinit(ref, torch.Generator().manual_seed(1))
        card = copy.deepcopy(ref).to(dev)
        x1 = normalize_device(torch.from_numpy(frames[0][None].copy()), "vgg")
        with torch.inference_mode():
            w_out, g_out = ref(x1), card(x1.to(dev))
        fwd_rel = 0.0
        for field in ("pafs", "heatmaps"):
            w_, g_ = getattr(w_out, field), getattr(g_out, field).cpu()
            scale = float(w_.abs().max())
            check(scale > 0 and math.isfinite(scale),
                  f"{name}: fp32 CPU forward {field} max {scale}")
            fwd_rel = max(fwd_rel, float((g_ - w_).abs().max()) / scale)
        check(fwd_rel <= FWD_REL_TOL,
              f"{name}: fp32 forward card vs CPU rel err {fwd_rel}")
        del ref, card, w_out, g_out
        # -- training --------------------------------------------------------
        cfg = Config()
        cfg.model.name, cfg.model.num_stages = name, stages
        cfg.model.downsample, cfg.dataset.image_size = stride, px
        cfg.train.batch_size, cfg.train.freeze_base_epochs = train_bs, 0
        cfg.train.lr = 2e-4 if name == "hourglass" else 1e-3
        if name == "hourglass":         # experiments/hourglass_256x256.yaml
            cfg.dataset.sigma, cfg.dataset.limb_width = 4.416, 1.289
            cfg.dataset.rotate_degrees = 0.0
            cfg.train.masked_loss = True
        tb = train_batch(train_bs, px, seed=7)
        mask = np.ones((train_bs, g, g, 1), np.float32)
        mask[1::2, : g // 4] = 0.0          # a crowd band on half the batch
        step_args = (tb["image"], tb["keypoints"], mask, tb["valid_xywh"])
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        trainer = Trainer(cfg, device=dev)

        def bn_stats(tr):
            return [b.detach().clone() for n, b in
                    tr.model.named_buffers() if n.endswith("running_var")]

        stats0 = bn_stats(trainer)
        kernels.reset_launch_counts()
        losses = [trainer.train_step(*step_args)["loss"]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += [trainer.train_step(*step_args)["loss"] for _ in range(2)]
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / 2
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        stats1 = bn_stats(trainer)
        val = trainer.eval_step(*step_args)
        stats2 = bn_stats(trainer)
        torch.cuda.synchronize()
        t_counts = kernels.launch_counts()
        launches["gt_maps"][name] = t_counts["gt_maps"]
        check(all(math.isfinite(v) for v in losses + [val["loss"]]),
              f"{name}: training losses {losses}, val {val['loss']}")
        check(t_counts["gt_maps"] == 4,
              f"{name}: 3 train steps and a val step should launch gt_maps "
              f"4 times: {t_counts}")
        if stats0:
            check(all(not torch.equal(a, b) for a, b in zip(stats0, stats1)),
                  f"{name}: BatchNorm statistics did not move in train mode")
            check(all(torch.equal(a, b) for a, b in zip(stats1, stats2)),
                  f"{name}: BatchNorm statistics moved in eval mode")
        kps = torch.from_numpy(tb["keypoints"]).to(dev)
        gt_args = dict(grid_y=g, grid_x=g, stride=stride,
                       sigma=cfg.dataset.sigma,
                       limb_width=cfg.dataset.limb_width)
        k_maps = kernels.gt_maps(kps, **gt_args)
        p_maps = kernels.gt_maps_plain(
            kps, kernels.limb_scalars(kps, stride, cfg.dataset.limb_width),
            kernels.person_bound(kps), **gt_args)
        check(all(torch.equal(a, b) for a, b in zip(k_maps, p_maps)),
              f"{name}: gt_maps on the training batch differs from plain")
        ckpt_dir = os.path.join(ROOT, "checkpoints", f"chip_smoke_{name}")
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        ckpt = CheckpointManager(ckpt_dir, keep=1)
        ckpt.save(trainer.state_dict(), step=trainer.step,
                  meta={"epoch": 0})
        fresh = Trainer(cfg, device=dev)
        fresh.restore(ckpt.restore_latest(dev))
        shutil.rmtree(ckpt_dir)
        a_sd, b_sd = trainer.model.state_dict(), fresh.model.state_dict()
        check(a_sd.keys() == b_sd.keys()
              and all(torch.equal(a_sd[k], b_sd[k]) for k in a_sd),
              f"{name}: the restored model differs")
        next_losses = (trainer.train_step(*step_args)["loss"],
                       fresh.train_step(*step_args)["loss"])
        check(next_losses[0] == next_losses[1],
              f"{name}: restored trainer's next loss {next_losses}")
        del trainer, fresh, a_sd, b_sd, kps, k_maps, p_maps
        torch.cuda.empty_cache()
        numbers[name] = dict(
            forward_ms_per_8=fwd_ms, forward_host_ms=fwd_host_ms,
            forward_kernels=sum(n for n, _ in events.values()) / 3,
            forward_device_ms=sum(us for _, us in events.values()) / 3e3,
            run_batch_ms_per_8=run_ms,
            decode_ms_per_8=dec_ms, train_ms_per_step=step_ms,
            train_img_per_s=train_bs * 1e3 / step_ms, train_batch=train_bs,
            peak_gib=peak_gib, ms_bytes_per_frame_pixel=ms_cost,
            ms_chunk_cap=cap,
            fp32_forward_rel_err=fwd_rel, losses=losses + [val["loss"]],
            serving_launches={k: counts[k] for k in SERVING_KERNELS},
            seconds=time.perf_counter() - t_family)
        log(f"zoo {name} ({px} px, stride {stride}, bf16): forward "
            f"{fwd_ms:.2f} ms per 8 frames (flip off; host enqueue "
            f"{fwd_host_ms:.2f} ms, {numbers[name]['forward_kernels']:.0f} "
            f"device kernels summing "
            f"{numbers[name]['forward_device_ms']:.2f} ms); run_batch "
            f"{run_ms:.2f} ms per 8 frames (flip); decode {dec_ms:.3f} ms "
            f"per 8; card == CPU decode ({int(got.valid.sum())} people); "
            f"fp32 forward card vs CPU rel err {fwd_rel:.3g}; multi-scale "
            f"{ms_cost:.1f} bytes per frame and pixel (MS_BYTES_PER_PIXEL "
            f"{MS_BYTES_PER_PIXEL}, chunk cap {cap}); train batch "
            f"{train_bs}: {step_ms:.1f} ms/step = "
            f"{train_bs * 1e3 / step_ms:.1f} img/s, peak {peak_gib:.2f} GiB, "
            f"losses {[round(v, 5) for v in losses]} val "
            f"{val['loss']:.5f}; launches serving "
            f"{numbers[name]['serving_launches']} training gt_maps "
            f"{t_counts['gt_maps']}; {numbers[name]['seconds']:.1f} s "
            f"[{smi}]")
    return launches, numbers, hg_rows


HTTP_FRAMES = 32       # distinct rendered 480x640 JPEGs posted to the service
HTTP_BURST = 128       # requests of the concurrency-8 run
HTTP_CLIENTS = 8
VIDEO_FRAMES = 64
FRONTEND_SHAPES = ((480, 640), (640, 480), (427, 640))
# the flagship as the front-ends' CLIs take it (bf16, seeded weights)
FRONTEND_FLAGS = ["--stages", "6", "--input-size", "368", "--flip"]


def percentile_ms(seconds, q: float) -> float:
    return float(np.percentile(np.asarray(seconds) * 1e3, q))


def frontends_phase(dev, smi: str):
    """The front-ends through the entry points a user calls, on the
    flagship (VGG19, 6 stages, 368 px, flip, bf16, seeded weights, built
    by ``picture_demo.build_pipeline`` from the CLI's flags):

    - the HTTP service (``demo.serve_http.serve`` in a thread) answering
      rendered 480x640 JPEGs: 32 requests one at a time (p50/p99
      latency), then 128 from 8 client threads, a 5 ms window and groups
      of at most 16 (requests/s, p50/p99, the mean group ``run_batch``
      received);
    - the service over maps rendered per input shape (people on COCO's
      three commonest frame sizes, and a crowded 30-person scene that
      overflows the default caps and is decoded again at ``RETRY_CAPS``,
      through K2), card against a CPU service on the same bytes: the same
      JSON, one request at a time and as one mixed-shape group;
    - the video demo's ``main()`` on a 64-frame 480x640 Motion-JPEG AVI
      written by ``demo.video_io`` at --batch 8 (frames/s; the output
      rereads as 64 frames of 480x640);
    - the picture demo's ``main()`` on one JPEG, which writes a PNG.

    -> ({"http": launch counts, "video": launch counts}, numbers)."""
    import argparse
    import contextlib
    import http.client
    import io
    import threading

    import torch
    from PIL import Image
    from rtpose_tpu_torch.data.imread import read_bgr
    from rtpose_tpu_torch.data.imread_fixtures import render_scene
    from rtpose_tpu_torch.demo import picture_demo, serve_http, video_demo
    from rtpose_tpu_torch.demo.video_io import VideoWriter, open_video
    from rtpose_tpu_torch.infer.pipeline import PosePipeline
    from rtpose_tpu_torch.infer.preprocess import scale_pad_geometry
    from rtpose_tpu_torch.ops import kernels
    from rtpose_tpu_torch.utils.synth_coco import OracleMaps

    flagship = FRONTEND_FLAGS + ["--device", str(dev)]

    def jpeg(rgb) -> bytes:
        buf = io.BytesIO()
        Image.fromarray(rgb).save(buf, "JPEG", quality=95)
        return buf.getvalue()

    class Server:
        """``serve`` in a thread; ``post`` times one request from the
        client's side, ``burst`` posts from `clients` threads at once."""

        def __init__(self, pipe, **kwargs):
            with contextlib.redirect_stdout(io.StringIO()):
                self.server = serve_http.serve(pipe, host="127.0.0.1",
                                               port=0, **kwargs)
            self.port = self.server.server_address[1]
            self.thread = threading.Thread(target=self.server.serve_forever,
                                           daemon=True)
            self.thread.start()

        def post(self, body):
            t = time.perf_counter()
            conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                              timeout=300)
            try:
                conn.request("POST", "/pose", body=body)
                resp = conn.getresponse()
                status, payload = resp.status, json.loads(resp.read())
            finally:
                conn.close()
            return status, payload, time.perf_counter() - t

        def burst(self, bodies, clients: int):
            out = [None] * len(bodies)
            lock = threading.Lock()
            todo = iter(range(len(bodies)))

            def client():
                while True:
                    with lock:
                        i = next(todo, None)
                    if i is None:
                        return
                    out[i] = self.post(bodies[i])

            threads = [threading.Thread(target=client)
                       for _ in range(clients)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            check(not any(t.is_alive() for t in threads),
                  "an HTTP client is still waiting for its answer")
            return out

        def close(self):
            self.server.shutdown()
            self.server.server_close()
            self.thread.join(timeout=30)

    def answered(results, what):
        bad = [(s, p) for s, p, _ in results if s != 200]
        check(not bad, f"{what}: {len(bad)} requests failed, e.g. "
                       f"{bad[:2]}")

    work = os.path.join(ROOT, "rtpose_tpu_torch", "build",
                        "chip_smoke_frontends")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    argv = sys.argv
    numbers = {"device": smi}
    try:
        # the flagship service
        parser = argparse.ArgumentParser()
        picture_demo.add_common_args(parser)
        with contextlib.redirect_stdout(io.StringIO()):
            pipe = picture_demo.build_pipeline(parser.parse_args(flagship))
        bodies = [jpeg(render_scene(300 + i, 480, 640))
                  for i in range(HTTP_FRAMES)]
        groups = []             # (frames, seconds) of each run_batch
        run_batch = pipe.run_batch

        def timed_run_batch(frames):
            t = time.perf_counter()
            out = run_batch(frames)
            groups.append((len(frames), time.perf_counter() - t))
            return out

        pipe.run_batch = timed_run_batch
        srv = Server(pipe, max_batch=16, batch_window_ms=5.0)
        try:
            # warm-up: cuDNN's first call at each batch size the groups take
            answered([srv.post(b) for b in bodies[:4]], "warm-up")
            answered(srv.burst(bodies * 2, HTTP_CLIENTS), "warm-up burst")
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            groups.clear()
            seq = [srv.post(b) for b in bodies]
            t0 = time.perf_counter()
            burst_groups = len(groups)
            burst = srv.burst([bodies[i % HTTP_FRAMES]
                               for i in range(HTTP_BURST)], HTTP_CLIENTS)
            burst_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            flagship_counts = kernels.launch_counts()
        finally:
            srv.close()
            del pipe.run_batch
        answered(seq + burst, "flagship HTTP")
        check(all(p["size"] == [480, 640] and not p["truncated"]
                  for _, p, _ in seq + burst), "flagship HTTP answers")
        burst_sizes = [n for n, _ in groups[burst_groups:]]
        burst_busy = [t for _, t in groups[burst_groups:]]
        numbers["http"] = {
            "concurrency_1": {
                "requests": len(seq),
                "p50_ms": percentile_ms([t for *_, t in seq], 50),
                "p99_ms": percentile_ms([t for *_, t in seq], 99),
                "requests_per_s": len(seq) / sum(t for *_, t in seq)},
            f"concurrency_{HTTP_CLIENTS}": {
                "requests": len(burst), "batch_window_ms": 5.0,
                "max_batch": 16,
                "requests_per_s": len(burst) / burst_s,
                "p50_ms": percentile_ms([t for *_, t in burst], 50),
                "p99_ms": percentile_ms([t for *_, t in burst], 99),
                "groups": len(burst_sizes),
                "mean_group": float(np.mean(burst_sizes)),
                "max_group": max(burst_sizes),
                "run_batch_ms_mean": 1e3 * float(np.mean(burst_busy)),
                # the dispatcher thread's share of the run in run_batch
                "dispatcher_busy_share": sum(burst_busy) / burst_s}}
        del pipe

        # card against CPU on rendered maps: each input shape answered
        # with its own maps; 368x368 frames with a crowded 5x6 grid that
        # overflows the default caps (570 connections > 160)
        maps, frames = {}, []
        for i, (h, w) in enumerate(FRONTEND_SHAPES):
            ph, pw = scale_pad_geometry(h, w, 368, 8)[3:5]
            heat, paf = scenes(i + 2, ph // 8, pw // 8, None, 400 + i)
            maps[(ph, pw)] = (heat[-1], paf[-1])
            frames.append(jpeg(render_scene(400 + i, h, w)))
        heat, paf = scenes(1, 92, 92, (5, 6), 500)
        maps[(368, 368)] = (heat[0], paf[0])
        frames.append(jpeg(render_scene(500, 368, 368)))
        servers = {d: Server(PosePipeline(OracleMaps(maps), device=d,
                                          input_size=368, flip=False),
                             max_batch=8, batch_window_ms=50.0)
                   for d in (dev, "cpu")}
        try:
            kernels.reset_launch_counts()
            card = [servers[dev].post(b) for b in frames[:-1]]
            torch.cuda.synchronize()
            plain = kernels.launch_counts()
            crowded = servers[dev].post(frames[-1])
            torch.cuda.synchronize()
            retry = {k: v - plain[k]
                     for k, v in kernels.launch_counts().items()}
            card.append(crowded)
            group = servers[dev].burst(frames, len(frames))
            torch.cuda.synchronize()
            rendered_counts = kernels.launch_counts()
            cpu = [servers["cpu"].post(b) for b in frames]
        finally:
            for s in servers.values():
                s.close()
        answered(card + group + cpu, "rendered HTTP")
        check(all(retry[k] == 2 for k in SERVING_KERNELS),
              f"the crowded request did not retry through the kernels "
              f"(K2 at K=64): {retry}")
        kp_err = score_err = 0.0
        people = []
        for (_, got, _), (_, again, _), (_, want, _) in zip(card, group,
                                                          cpu):
            for answer in (got, again):
                check(answer["size"] == want["size"]
                      and answer["truncated"] == want["truncated"]
                      and len(answer["people"]) == len(want["people"]),
                      f"HTTP card vs CPU: {answer['size']} "
                      f"{len(answer['people'])} people, CPU "
                      f"{len(want['people'])}")
                for a, b in zip(answer["people"], want["people"]):
                    check(a["parts"].keys() == b["parts"].keys(),
                          "HTTP card vs CPU: part names differ")
                    score_err = max(score_err, abs(a["score"] - b["score"]))
                    for name, (x, y, sc) in a["parts"].items():
                        bx, by, bs = b["parts"][name]
                        kp_err = max(kp_err, abs(x - bx), abs(y - by))
                        score_err = max(score_err, abs(sc - bs))
            people.append(len(want["people"]))
        check(kp_err <= RESULT_KP_TOL and score_err <= SCORE_TOL,
              f"HTTP card vs CPU: keypoints {kp_err} px, scores "
              f"{score_err}")
        check(min(people) > 0 and people[-1] == 30 and not cpu[-1][1][
            "truncated"], f"rendered HTTP people {people}")
        numbers["http"]["card_vs_cpu"] = {
            "frames": len(frames), "people": people,
            "max_kp_err_px": kp_err, "max_score_err": score_err,
            "crowded_retry_launches": retry}
        http_counts = {k: flagship_counts[k] + rendered_counts[k]
                       for k in flagship_counts}

        # the video demo: a 64-frame Motion-JPEG AVI at --batch 8
        video = os.path.join(work, "in.avi")
        out = os.path.join(work, "out.avi")
        writer = VideoWriter(video, 20.0, (640, 480))
        for i in range(VIDEO_FRAMES):
            writer.write(np.ascontiguousarray(
                render_scene(600 + i, 480, 640)[..., ::-1]))
        writer.release()
        sys.argv = ["video_demo", "--video", video, "--output", out,
                    "--batch", "8"] + flagship
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with contextlib.redirect_stdout(io.StringIO()) as text:
            n, video_s = video_demo.main()
        torch.cuda.synchronize()
        video_counts = kernels.launch_counts()
        check(f"processed {VIDEO_FRAMES} frames" in text.getvalue(),
              f"video demo: {text.getvalue()!r}")
        cap = open_video(out)
        reread = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            reread.append(frame.shape)
        cap.release()
        check(n == VIDEO_FRAMES and reread == [(480, 640, 3)] * VIDEO_FRAMES,
              f"video output rereads as {len(reread)} frames of "
              f"{set(reread)}")
        numbers["video"] = {"frames": n, "seconds": video_s,
                            "frames_per_s": n / video_s, "batch": 8}

        # the picture demo
        image, png = os.path.join(work, "in.jpg"), os.path.join(work,
                                                               "out.png")
        Image.fromarray(render_scene(700, 480, 640)).save(image, quality=95)
        sys.argv = ["picture_demo", "--image", image, "--output",
                    png] + flagship
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as text:
            picture_demo.main()
        picture_s = time.perf_counter() - t0
        check("found" in text.getvalue() and os.path.exists(png)
              and read_bgr(png).shape == (480, 640, 3),
              f"picture demo: {text.getvalue()!r}")
        numbers["picture"] = {"seconds_with_build": picture_s}
    finally:
        sys.argv = argv
        shutil.rmtree(work, ignore_errors=True)
    for name, counts in (("HTTP", http_counts), ("video", video_counts)):
        check(all(counts[k] > 0 for k in SERVING_KERNELS)
              and counts["gt_maps"] == 0,
              f"the {name} front-end did not run through the serving "
              f"kernels: {counts}")
    h1 = numbers["http"]["concurrency_1"]
    h8 = numbers["http"][f"concurrency_{HTTP_CLIENTS}"]
    log(f"HTTP: concurrency 1, {h1['requests']} requests: p50 "
        f"{h1['p50_ms']:.2f} ms, p99 {h1['p99_ms']:.2f} ms; concurrency "
        f"{HTTP_CLIENTS}, {h8['requests']} requests: {h8['requests_per_s']:.2f}"
        f" requests/s, p50 {h8['p50_ms']:.2f} ms, p99 {h8['p99_ms']:.2f} ms, "
        f"mean group {h8['mean_group']:.2f} (max {h8['max_group']}, "
        f"{h8['groups']} groups, run_batch {h8['run_batch_ms_mean']:.2f} ms "
        f"a group, dispatcher busy {h8['dispatcher_busy_share']:.3f}); "
        f"launches {http_counts} [{smi}]")
    log(f"HTTP card == CPU on rendered maps: people {people}, keypoints "
        f"{kp_err} px, scores {score_err}; the crowded frame's retry "
        f"launches {retry}")
    log(f"video demo: {n} frames 480x640 at --batch 8 in {video_s:.3f} s = "
        f"{n / video_s:.2f} frames/s; launches {video_counts} [{smi}]")
    log(f"picture demo: wrote a PNG in {picture_s:.3f} s (build included)")
    return {"http": http_counts, "video": video_counts}, numbers


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
    from rtpose_tpu_torch import selftest
    from rtpose_tpu_torch.infer.pipeline import (MS_BYTES_PER_PIXEL,
                                                 RETRY_CAPS, PosePipeline,
                                                 load_pipeline)
    from rtpose_tpu_torch.infer.preprocess import normalize_device
    from rtpose_tpu_torch.models import get_model
    from rtpose_tpu_torch.models.common import ModelOutput
    from rtpose_tpu_torch.ops import _build, kernels
    from rtpose_tpu_torch.ops.decode import decode_poses_batch, people_to_host
    from rtpose_tpu_torch.ops.grouping import (score_connections,
                                               sorted_candidates)
    from rtpose_tpu_torch.ops.peaks import nms, peak_candidates
    from rtpose_tpu_torch.utils.grouping_cases import (BRANCHES, branch_hits,
                                                       candidate_batch,
                                                       merge_chain_batch)

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

    # 3. fused scoring kernel (geometry, PAF line integral, criterion) vs
    # plain: K=32 at the serving shape (8 frames of 480x640 -> 46x62 maps)
    # and K=64 (the retry) on crowded 92x92 scenes of 36 people, more than
    # 32 peaks per part
    heat32, paf32 = scenes(8, 46, 62, grid=None, seed0=0)
    heat64, paf64 = scenes(8, 92, 92, grid=(6, 6), seed0=100)
    inputs = {}
    for K, heat_np, paf_np in ((32, heat32, paf32), (64, heat64, paf64)):
        heat = torch.from_numpy(heat_np).to(dev)
        paf = torch.from_numpy(paf_np).to(dev)
        peaks = nms(heat, max_peaks=K)
        pk = (peaks.x, peaks.y, peaks.valid)
        crit_k, valid_k = kernels.connection_scores(paf, *pk)
        crit_p, valid_p = kernels.connection_scores_plain(paf, *pk)
        torch.cuda.synchronize()
        err = float((crit_k - crit_p).abs().max())
        check(torch.equal(valid_k, valid_p), f"scores K={K}: valid differ")
        check(err <= SCORE_TOL, f"scores K={K}: crit2 max err {err}")
        ms, plain_ms = paired_ms(
            lambda: kernels.connection_scores(paf, *pk),
            lambda: kernels.connection_scores_plain(paf, *pk), 50)
        log(f"connection_scores K={K} B=8 map {paf.shape[1]}x{paf.shape[2]}"
            f": valid equal ({int(valid_k.sum())} of {valid_k.numel()}), "
            f"crit2 max err {err:.3g}; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms (back to back) [{smi}]")
        if K == 32:
            results["connection_scores"] = dict(max_abs_err=err, ms=ms,
                                                plain_ms=plain_ms)
            # the kernel's path for a factor other than the served x8
            c4, v4 = kernels.connection_scores(paf, *pk, factor=4)
            c4_p, v4_p = kernels.connection_scores_plain(paf, *pk, factor=4)
            check(torch.equal(v4, v4_p) and torch.equal(c4, c4_p),
                  "scores at factor 4 differ from plain")

        # 4. refine kernel vs plain on the same scenes, plain and blurred
        hb = heat[..., :18].permute(0, 3, 1, 2).contiguous()
        _, py, px, valid, _ = peak_candidates(hb, thresh=0.1, max_peaks=K)
        rf = (hb, py, px, valid)
        inputs[K] = dict(paf=paf, peaks=peaks, refine=rf)
        for blur, tag in ((False, ""), (True, "gaussian_filt_")):
            xf, yf, sc = kernels.bicubic_refine(*rf, gaussian_filt=blur)
            xf_p, yf_p, sc_p = kernels.bicubic_refine_plain(
                *rf, gaussian_filt=blur)
            torch.cuda.synchronize()
            check(torch.equal(xf, xf_p) and torch.equal(yf, yf_p),
                  f"refine {tag}K={K}: coordinates differ")
            err = float((sc - sc_p).abs().max())
            check(err <= SCORE_TOL, f"refine {tag}K={K}: score max err {err}")
            check(not any(t[~valid].any() for t in (xf, yf, sc)),
                  f"refine {tag}K={K}: an empty slot is not zero")
            ms, plain_ms = paired_ms(
                lambda: kernels.bicubic_refine(*rf, gaussian_filt=blur),
                lambda: kernels.bicubic_refine_plain(*rf, gaussian_filt=blur),
                20 if blur else 50)
            log(f"bicubic_refine {tag}K={K} B=8 ({int(valid.sum())} valid "
                f"of {valid.numel()} slots): coordinates equal, empty slots "
                f"zero, score max err {err:.3g}; kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms (back to back) [{smi}]")
            if K == 32:
                results.setdefault("bicubic_refine", {}).update({
                    f"{tag}max_abs_err": err, f"{tag}ms": ms,
                    f"{tag}plain_ms": plain_ms})

    # 4b. ground-truth synthesis kernel (K4: keypoints in, maps out) vs
    # its plain version (the torch limb scalars and person bound, then the
    # dense person loop).  At the training shape, 72 images, 32 person
    # slots, 46x46 grid; then persons on the edges, outside the grid and
    # at the Gaussian's cutoff, an empty image and a full one (n = 32), on
    # that grid and on 28x40 and 7x9, whose spans no vector divides
    from rtpose_tpu_torch.data.gt import ground_truth_maps_batch
    from rtpose_tpu_torch.ops.kernels import limb_scalars, person_bound

    def gt_plain(k, gy, gx):
        return kernels.gt_maps_plain(k, limb_scalars(k, 8), person_bound(k),
                                     grid_y=gy, grid_x=gx, stride=8,
                                     sigma=7.0)

    kps = torch.from_numpy(train_batch(TRAIN_BATCH, 368, seed=1)
                           ["keypoints"]).to(dev)
    n_pers = person_bound(kps)
    gt_args = dict(grid_y=46, grid_x=46, stride=8, sigma=7.0)
    heat_k, paf_k = kernels.gt_maps(kps, **gt_args)
    heat_p, paf_p = gt_plain(kps, 46, 46)
    torch.cuda.synchronize()
    err = max(float((heat_k - heat_p).abs().max()),
              float((paf_k - paf_p).abs().max()))
    check(heat_k.shape == (TRAIN_BATCH, 46, 46, 19)
          and paf_k.shape == (TRAIN_BATCH, 46, 46, 38), "gt_maps shapes")
    check(err <= GT_TOL, f"gt_maps: max err {err} vs plain")
    ms, plain_ms = paired_ms(lambda: kernels.gt_maps(kps, **gt_args),
                             lambda: gt_plain(kps, 46, 46), 20)
    results["gt_maps"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    log(f"gt_maps B={TRAIN_BATCH} N={SLOTS} 46x46 ({int(n_pers.sum())} "
        f"person slots visited, persons per image {n_pers.min().item()}-"
        f"{n_pers.max().item()}): max err {err:.3g}; kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms (back to back) [{smi}]")
    for gy, gx in ((46, 46), (28, 40), (7, 9)):
        edge = torch.from_numpy(edge_keypoints(gy, gx)).to(dev)
        bound_n = person_bound(edge).tolist()
        check(bound_n == [8, SLOTS, 0, SLOTS], f"edge batch bounds {bound_n}")
        got = kernels.gt_maps(edge, grid_y=gy, grid_x=gx, stride=8,
                              sigma=7.0)
        want = gt_plain(edge, gy, gx)
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        check(err == 0.0, f"gt_maps {gy}x{gx} edge batch: max err {err}")
        check(float(got[0][2, ..., :18].abs().max()) == 0.0
              and float(got[0][2, ..., 18].min()) == 1.0
              and float(got[1][2].abs().max()) == 0.0,
              f"gt_maps {gy}x{gx}: the empty image is not background")
        log(f"gt_maps {gy}x{gx} edge batch (border, full with persons "
            f"outside, empty, cutoff): max err {err:.3g}, "
            f"{int((got[0][..., :18] > 0).sum())} heat and "
            f"{int((got[1] != 0).sum())} PAF values set")

    # 4d. the grouping kernel (greedy matching and assembly, a block per
    # image) vs its plain version (the two torch loops): every People field
    # equal, error 0, on the rendered scenes at K=32, the crowded 5x6 grid
    # scenes (30 people on 92x92 maps) at RETRY_CAPS and at the default
    # caps (where they overflow), on crafted candidate batches at both caps
    # that reach every branch of the assembly but found >= 3 (which greedy
    # 1-1 matching of 1-based ids cannot produce), on a batch that reads
    # peak ids a merge moved to another row, and at the kernel's limits
    # (K = 128, 256 rows: dynamic shared memory above 48 KB)
    default_caps = dict(max_peaks=32, max_candidates=256, max_total_conns=160,
                        max_people=64)
    limit_caps = dict(max_candidates=4096, max_people=256,
                      max_total_conns=19 * 128)
    h30np, p30np = scenes(8, 92, 92, grid=(5, 6), seed0=200)

    def from_maps(heat_np, paf_np, caps):
        heat = torch.from_numpy(heat_np).to(dev)
        peaks = nms(heat, max_peaks=caps["max_peaks"])
        s, v = score_connections(peaks, torch.from_numpy(paf_np).to(dev))
        return (*sorted_candidates(s, v), peaks.x, peaks.y, peaks.score,
                peaks.truncated)

    def crafted(batch):
        sc, va, *rest = (torch.from_numpy(a).to(dev) for a in batch)
        return (*sorted_candidates(sc, va), *rest)

    group_cases = {
        "K=32 rendered 46x62": (from_maps(heat32, paf32, default_caps),
                                default_caps),
        "RETRY_CAPS crowded 5x6": (from_maps(h30np, p30np, RETRY_CAPS),
                                   RETRY_CAPS),
        "default caps crowded 5x6": (from_maps(h30np, p30np, default_caps),
                                     default_caps),
        "crafted K=32": (crafted(candidate_batch(0, 8, 32)), default_caps),
        "crafted K=64": (crafted(candidate_batch(0, 8, 64)), RETRY_CAPS),
        "merge chain K=4": (crafted(merge_chain_batch()), default_caps),
        "limits K=128 Pp=256": (crafted(candidate_batch(2, 4, 128)),
                                limit_caps)}
    group_err = 0.0
    for label, (args, caps) in group_cases.items():
        gk = {k: v for k, v in caps.items() if k != "max_peaks"}
        got = kernels.group_people(*args, **gk)
        want = kernels.group_people_plain(*args, **gk)
        torch.cuda.synchronize()
        for f, g, w in zip(("coords", "part_score", "score", "valid",
                            "truncated"), got, want):
            err = float((g.double() - w.double()).abs().max())
            check(torch.equal(g, w), f"group_people {label}: {f} differs "
                  f"from plain (max err {err})")
            group_err = max(group_err, err)
        conns = kernels.greedy_plain(args[0], args[1], args[2].shape[-1],
                                     gk["max_candidates"])
        hits = branch_hits(*(c.cpu().numpy() for c in (conns[0], conns[1],
                                                        conns[3])),
                           max_people=gk["max_people"],
                           max_total_conns=gk["max_total_conns"])
        C = min(gk["max_candidates"], args[0].shape[-1])
        hits["cand_overflow"] = int((args[0][..., C] > -torch.inf).any(-1)
                                    .sum()) if C < args[0].shape[-1] else 0
        hits["score_ties"] = int((args[0][..., 1:C] == args[0][..., :C - 1])
                                 .logical_and(args[0][..., 1:C] > -torch.inf)
                                 .sum())
        if label.startswith("crafted"):
            check(all(hits[b] > 0 for b in BRANCHES if b != "found3plus")
                  and bool(got[4].any()) and not bool(got[4].all()),
                  f"group_people {label}: a branch was not reached {hits}")
        if label.startswith("merge"):
            check(hits["merge"] == 3 and hits["extend_set_already"] == 1,
                  f"group_people {label}: not the merges it was built for "
                  f"{hits}")
        smem = kernels.group_smem_bytes(args[2].shape[-1], gk["max_people"],
                                        gk["max_total_conns"])
        if label.startswith("limits"):
            check(smem > 48 * 1024 and int(got[3].sum()) > 100,
                  f"group_people {label}: {smem} bytes of shared memory, "
                  f"{int(got[3].sum())} people")
        log(f"group_people {label}: every People field equal to plain "
            f"({int(got[3].sum())} people, truncated "
            f"{int(got[4].sum())} of {len(got[4])}; {smem} bytes of shared "
            f"memory a block); branches {dict(hits)}")
    k32_args = group_cases["K=32 rendered 46x62"][0]
    retry_args = group_cases["RETRY_CAPS crowded 5x6"][0]
    gk32 = {k: v for k, v in default_caps.items() if k != "max_peaks"}
    gk_retry = {k: v for k, v in RETRY_CAPS.items() if k != "max_peaks"}
    for tag, args, gk in (("", k32_args, gk32),
                          ("retry_", retry_args, gk_retry)):
        ms, plain_ms = paired_ms(
            lambda: kernels.group_people(*args, **gk),
            lambda: kernels.group_people_plain(*args, **gk),
            50 if tag == "" else 3)
        results.setdefault("group_people", {}).update({
            f"{tag}ms": ms, f"{tag}plain_ms": plain_ms})
        log(f"group_people {tag or 'K=32 '}B=8: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms (back to back) [{smi}]")
    results["group_people"]["max_abs_err"] = group_err

    # 4e. the normalisation rounds on the card as on the CPU: every uint8
    # value in every channel, each mode, bit for bit
    every = torch.from_numpy(((np.arange(256)[:, None] + 85 * np.arange(3))
                              % 256).astype(np.uint8)[None])
    for mode in ("rtpose", "vgg", "inception", "ssd"):
        check(torch.equal(normalize_device(every.to(dev), mode).cpu()
                          .view(torch.int32),
                          normalize_device(every, mode).view(torch.int32)),
              f"normalize_device {mode}: the card rounds differently")
    log("normalize_device: card == CPU bit for bit on every uint8 value, "
        "all four modes")

    # 4c. each kernel's device time per launch (profiler), its wrapper's
    # host time per call and its bound, at the main path's shapes; then
    # the device work of the two decode stages that hold K1 and K3
    from rtpose_tpu_torch.ops.peaks import refine_peaks
    cases = []
    for K in (32, 64):
        i = inputs[K]
        p = i["peaks"]
        cases.append((f"connection_scores K={K}", "connection_scores_kernel",
                      functools.partial(kernels.connection_scores, i["paf"],
                                        p.x, p.y, p.valid),
                      scores_work(i["paf"], K)))
        for blur, kname in ((False, "refine_warp_kernel"),
                            (True, "refine_blur_kernel")):
            cases.append((f"bicubic_refine {'gaussian_filt ' * blur}K={K}",
                          kname, functools.partial(kernels.bicubic_refine,
                                                   *i["refine"],
                                                   gaussian_filt=blur),
                          refine_work(*i["refine"], blur)))
    cases.append((f"gt_maps B={TRAIN_BATCH}", "gt_maps_kernel",
                  functools.partial(kernels.gt_maps, kps, **gt_args),
                  gt_work(kps, n_pers, 46, 46)))
    chains = {}
    for label, args, gk in (("group_people K=32", k32_args, gk32),
                            ("group_people RETRY_CAPS", retry_args,
                             gk_retry)):
        n_bytes, n_flops, chains[label] = group_work(args, **gk)
        cases.append((label, "group_people_kernel",
                      functools.partial(kernels.group_people, *args, **gk),
                      (n_bytes, n_flops)))
    # the grouping kernel is bound by its serial chain: its chain bound is
    # the chain's steps at one dependent shared-memory round trip each, at
    # the SM clock nvidia-smi reads while it runs
    sm_mhz = sm_clock_under_load(functools.partial(
        kernels.group_people, *retry_args, **gk_retry))
    log(f"SM clock under the grouping kernel's load: {sm_mhz:.0f} MHz "
        f"[{smi}]")
    timing = {}
    for label, kname, fn, (n_bytes, n_flops) in cases:
        d_ms, src = device_ms(fn, kname)
        h_ms = host_ms(fn)
        b_ms, b_by = bound(n_bytes, n_flops)
        timing[label] = dict(device_ms=d_ms, host_ms=h_ms, bound_ms=b_ms,
                             bound_by=b_by)
        if label in chains:
            chain_ms = chains[label] * SMEM_ROUND_TRIP_CYCLES / sm_mhz / 1e3
            timing[label].update(
                chain_steps=chains[label],
                ns_per_step=d_ms * 1e6 / chains[label],
                bytes_bound_ms=b_ms, chain_bound_ms=chain_ms,
                sm_clock_mhz=sm_mhz,
                chain_cycles_per_step=SMEM_ROUND_TRIP_CYCLES)
            if chain_ms > b_ms:
                b_ms, b_by = chain_ms, "chain"
                timing[label].update(bound_ms=b_ms, bound_by=b_by)
            # each block's SM cycles in its four phases, one launch
            args, gk = ((k32_args, gk32) if label.endswith("K=32")
                        else (retry_args, gk_retry))
            phases = torch.zeros((args[0].shape[0], 4), dtype=torch.int64,
                                 device=dev)
            kernels.group_people(*args, **gk, phase_cycles=phases)
            worst = phases.max(0).values.tolist()
            timing[label]["phase_us"] = dict(zip(
                ("greedy", "walk", "chain", "epilogue"),
                (c / sm_mhz for c in worst)))
            log(f"  {label}: serial chain {chains[label]} steps (longest "
                f"pair scan + assembly steps of one image), "
                f"{d_ms * 1e6 / chains[label]:.1f} ns per step; chain bound "
                f"{chain_ms * 1e3:.3f} us ({SMEM_ROUND_TRIP_CYCLES} cycles a "
                f"step at {sm_mhz:.0f} MHz), bytes bound {n_bytes / 1e6:.3f} "
                f"MB; the slowest block's cycles: greedy {worst[0]}, walk "
                f"set-up {worst[1]}, assembly chain {worst[2]}, epilogue "
                f"{worst[3]} (= {sum(worst) / sm_mhz:.2f} us)")
        log(f"time {label}: device {d_ms:.5f} ms/launch ({src}), wrapper "
            f"host {h_ms:.5f} ms/call; bound {b_ms:.5f} ms by {b_by} "
            f"({n_bytes / 1e6:.3f} MB, {n_flops / 1e6:.2f} MFLOP), "
            f"{100 * b_ms / d_ms:.1f}% of it [{smi}]")
    for name, key, tag in (
            ("connection_scores", "connection_scores K=32", ""),
            ("bicubic_refine", "bicubic_refine K=32", ""),
            ("bicubic_refine", "bicubic_refine gaussian_filt K=32",
             "gaussian_filt_"),
            ("gt_maps", f"gt_maps B={TRAIN_BATCH}", ""),
            ("group_people", "group_people K=32", ""),
            ("group_people", "group_people RETRY_CAPS", "retry_")):
        results[name].update({tag + k: v for k, v in timing[key].items()})
    for K in (32, 64):
        i = inputs[K]
        for stage, fn in (
                ("score_connections", functools.partial(
                    score_connections, i["peaks"], i["paf"])),
                ("refine_peaks", functools.partial(refine_peaks,
                                                   *i["refine"]))):
            n_kern, n_other, names = device_work(fn)
            log(f"device work of {stage} K={K}: {n_kern} kernels, "
                f"{n_other} copies/fills ({', '.join(names)})")
            check(n_kern == 1 and n_other == 0,
                  f"{stage} K={K} put {n_kern} kernels and {n_other} "
                  f"copies on the card, not its one kernel")

    # the ground-truth stage as the trainer calls it: one kernel, no copy,
    # and its host time per call (per train step)
    gt_stage = functools.partial(ground_truth_maps_batch, kps)
    n_kern, n_other, names = device_work(gt_stage)
    gt_host_ms = host_ms(gt_stage)
    log(f"device work of ground_truth_maps_batch B={TRAIN_BATCH}: {n_kern} "
        f"kernels, {n_other} copies/fills ({', '.join(names)}); host "
        f"{gt_host_ms:.5f} ms/call [{smi}]")
    check(n_kern == 1 and n_other == 0,
          f"ground_truth_maps_batch put {n_kern} kernels and {n_other} "
          f"copies on the card, not its one kernel")

    # 5. decode on the card vs the same maps decoded on the CPU, with the
    # plain and the blurred refine
    h32, p32 = torch.from_numpy(heat32), torch.from_numpy(paf32)
    for mode in ({}, {"gaussian_filt": True}):
        got = people_to_host(decode_poses_batch(h32.to(dev), p32.to(dev),
                                                **mode))
        want = people_to_host(decode_poses_batch(h32, p32, **mode))
        err = people_equal(got, want, f"decode K=32 {mode}")
        log(f"decode_poses_batch {mode or ''}: card == CPU on 8 rendered "
            f"scenes ({int(got.valid.sum())} people, score max err "
            f"{err:.3g})")

    # 30 people: 570 connections overflow the default 160 but fit the
    # 608 of RETRY_CAPS (36 people, 684 connections, would not)
    pipe = load_pipeline(device="cuda", model_name="vgg19", num_stages=6,
                         input_size=368, flip=True, seed=0)
    h30, p30 = torch.from_numpy(h30np), torch.from_numpy(p30np)
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
    err = people_equal(got, want, "decode at RETRY_CAPS")
    log(f"crowded 5x6 grid scenes: truncated at the default caps, "
        f"retried at RETRY_CAPS -> {[len(p) for p in people]} people, "
        f"card == CPU (score max err {err:.3g})")

    # the same through the entry points of a pipeline built with
    # gaussian_filt=True.  The seeded random weights find no people, so
    # here a module that answers every frame with the rendered crowded
    # maps stands in for the network (2 scenes): run and run_batch
    # truncate at the default caps and retry by themselves, first decode
    # and retry through the blurred kernel
    class RenderedMaps(torch.nn.Module):
        def __init__(self, heat, paf):
            super().__init__()
            self.register_buffer("heat", heat)
            self.register_buffer("paf", paf)

        def forward(self, x):
            n = x.shape[0]
            return ModelOutput(pafs=self.paf[None, :n],
                               heatmaps=self.heat[None, :n])

    crowd_pipe = PosePipeline(RenderedMaps(h30[:2], p30[:2]), device="cuda",
                              input_size=736, flip=False, gaussian_filt=True)
    blank = [np.zeros((736, 736, 3), np.uint8)] * 2
    kernels.reset_launch_counts()
    alone, _, _, meta = crowd_pipe.run(blank[0])
    people, metas = crowd_pipe.run_batch(blank)
    blurred = kernels.launch_counts()
    hb, pb = h30[:2].to(dev), p30[:2].to(dev)
    want = people_to_host(decode_poses_batch(h30[:2], p30[:2],
                                             gaussian_filt=True,
                                             **RETRY_CAPS))
    got = people_to_host(decode_poses_batch(hb, pb, gaussian_filt=True,
                                            **RETRY_CAPS))
    err = people_equal(got, want, "blurred decode at RETRY_CAPS")
    check(all(m.get("retried") and not m["truncated"]
              for m in [meta] + metas)
          and [len(p) for p in [alone] + people]
          == [int(want.valid[i].sum()) for i in (0, 0, 1)],
          "the blurred retry did not resolve the crowded scenes")
    check(blurred["bicubic_refine_gaussian_filt"]
          == blurred["bicubic_refine"] == 4,
          f"run and run_batch, first decode and retry, should launch the "
          f"blurred kernel 4 times and no other refine: {blurred}")
    log(f"gaussian_filt pipeline on 2 crowded scenes, run and run_batch: "
        f"first decode and retry through the blurred kernel -> "
        f"{[len(p) for p in [alone] + people]} people, card == CPU (score "
        f"max err {err:.3g})")
    # multi-scale TTA through the same pipeline: its "model" answers every
    # scale with the same 92x92 maps, whose bicubic resize to the 92x92
    # base grid is exact, so the averaged maps are the rendered ones and
    # the people those of their retry decode
    ms_alone, _, _, ms_meta = crowd_pipe.run_multiscale(blank[0], (0.5, 1.0))
    ms_people, ms_metas = crowd_pipe.run_multiscale_batch(blank, (0.5, 1.0))
    check(all(m.get("retried") and not m["truncated"]
              for m in [ms_meta] + ms_metas)
          and [len(p) for p in [ms_alone] + ms_people]
          == [int(want.valid[i].sum()) for i in (0, 0, 1)],
          "multi-scale TTA on the crowded scenes did not retry to the "
          "single-scale people")
    log(f"multi-scale TTA (0.5, 1) on the 2 crowded scenes: retried -> "
        f"{[len(p) for p in [ms_alone] + ms_people]} people, as the "
        f"single-scale decode")
    del crowd_pipe

    # 6. serving main path: one frame, then 8 frames of mixed sizes, with
    # their launches read before anything else runs; then, counted from 0
    # again, the gaussian_filt pipeline on one frame and 2 frames
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
    for name in SERVING_KERNELS:
        check(counts[name] > 0, f"{name} was not launched by the serving "
              f"path")
    check(counts["gt_maps"] == 0, "the serving path launched gt_maps")
    check(counts["bicubic_refine_gaussian_filt"] == 0,
          "the default serving path took the blurred refine")
    log(f"serving: run -> maps {heat1.shape}/{paf1.shape} finite, "
        f"{len(people1)} people; run_batch(8 mixed) -> "
        f"{[len(p) for p in people8]} people; launches {counts}")

    blur_pipe = load_pipeline(device="cuda", model_name="vgg19", num_stages=6,
                              input_size=368, flip=True, seed=0,
                              gaussian_filt=True)
    kernels.reset_launch_counts()
    people1b, heat1b, _, _ = blur_pipe.run(frame)
    people2b, _ = blur_pipe.run_batch(batch[:2])
    torch.cuda.synchronize()
    blur_counts = kernels.launch_counts()
    check(blur_counts["bicubic_refine_gaussian_filt"]
          == blur_counts["bicubic_refine"] >= 2
          and blur_counts["connection_scores"] >= 2
          and blur_counts["gt_maps"] == 0,
          f"the gaussian_filt pipeline did not run through the blurred "
          f"kernel alone: {blur_counts}")
    check(heat1b.shape == heat1.shape and bool(np.isfinite(heat1b).all())
          and len(people2b) == 2, "gaussian_filt pipeline results")
    log(f"serving with gaussian_filt: run and run_batch(2) -> "
        f"{len(people1b)}, {[len(p) for p in people2b]} people; launches "
        f"{blur_counts}")
    del blur_pipe

    # 6b. multi-scale TTA on the flagship, scales (0.5, 1, 1.5, 2): one
    # frame and 8 frames, counted from 0; the people of the averaged maps
    # on the card equal their decode on the CPU; the device memory a chunk
    # takes per frame and pixel of its largest scaled input, and the
    # chunk cap that the card's free memory gives
    frames8 = [rng.randint(0, 256, (480, 640, 3), np.uint8)
               for _ in range(8)]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    ms_people1, ms_heat1, _, ms_meta1 = pipe.run_multiscale(frame, MS_SCALES)
    ms_people8, ms_metas8 = pipe.run_multiscale_batch(frames8, MS_SCALES)
    torch.cuda.synchronize()
    ms_counts = kernels.launch_counts()
    check(ms_heat1.shape == heat1.shape and bool(np.isfinite(ms_heat1).all())
          and len(ms_people8) == 8
          and ms_metas8[0]["upsampled"] == ms_meta1["upsampled"]
          == (368, 496), "multi-scale results")
    check(all(ms_counts[k] > 0 for k in SERVING_KERNELS)
          and ms_counts["gt_maps"] == 0,
          f"multi-scale TTA did not run through the serving kernels: "
          f"{ms_counts}")
    _, _, max_px = pipe._scale_sizes(480, 640, MS_SCALES)
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    ticket = pipe.run_multiscale_batch_submit(frames8, MS_SCALES)
    torch.cuda.synchronize()
    ms_cost = (torch.cuda.max_memory_allocated() - base_bytes) / (8 * max_px)
    got = people_to_host(ticket[1])
    want = people_to_host(decode_poses_batch(ticket[2].cpu(),
                                             ticket[3].cpu()))
    err = people_equal(got, want, "multi-scale decode card vs CPU")
    cap = pipe.ms_chunk_cap(max_px)
    free, total = torch.cuda.mem_get_info()
    log(f"multi-scale TTA {MS_SCALES}, flagship bf16, 480x640 frames (base "
        f"grid 46x62, largest scaled input {max_px} px): run -> "
        f"{len(ms_people1)} people; run_multiscale_batch(8) -> "
        f"{[len(p) for p in ms_people8]} people; card == CPU on the averaged "
        f"maps ({int(got.valid.sum())} people, score max err {err:.3g}); "
        f"launches {ms_counts}; device memory {ms_cost:.1f} bytes per frame "
        f"and pixel (MS_BYTES_PER_PIXEL {MS_BYTES_PER_PIXEL}), chunk cap "
        f"{cap} frames at {free / 2 ** 30:.1f} of {total / 2 ** 30:.1f} GiB "
        f"free [{smi}]")
    check(ms_cost <= MS_BYTES_PER_PIXEL,
          f"a multi-scale chunk took {ms_cost:.1f} bytes per frame and "
          f"pixel, more than MS_BYTES_PER_PIXEL {MS_BYTES_PER_PIXEL}")
    del ticket

    # 6c. no host read inside the decode: decode_poses_batch at both caps
    # and run_batch_submit of 8 frames, with every synchronising call an
    # error (after one warm-up call, which copies each path's tables to
    # the card once); then the ticket is collected
    hd, pd = h32.to(dev), p32.to(dev)
    h30d, p30d = h30.to(dev), p30.to(dev)
    pipe.run_batch_collect(pipe.run_batch_submit(frames8))
    decode_poses_batch(h30d, p30d, **RETRY_CAPS)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        ticket = pipe.run_batch_submit(frames8)
        submit_ms = (time.perf_counter() - t0) * 1e3
        unsynced = (decode_poses_batch(hd, pd),
                    decode_poses_batch(h30d, p30d, **RETRY_CAPS))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    people8s, _ = pipe.run_batch_collect(ticket)
    collect_ms = (time.perf_counter() - t0) * 1e3
    people_equal(people_to_host(unsynced[1]),
                 people_to_host(decode_poses_batch(h30, p30, **RETRY_CAPS)),
                 "the unsynchronised decode at RETRY_CAPS")
    check(len(people8s) == 8, "run_batch_submit ticket")
    log(f"no synchronising call in run_batch_submit (8 frames) and in "
        f"decode_poses_batch at both caps; run_batch_submit returned after "
        f"{submit_ms:.2f} ms, the collected people after {collect_ms:.2f} "
        f"ms [{smi}]")

    # 6d. the self-test's checks on the card (decode vs the host oracle,
    # K4 vs the host GT oracle, the flip algebra) and its flagship
    # single-frame latency
    check(all([selftest.check_decode_parity(dev),
               selftest.check_gt_equivalence(dev),
               selftest.check_flip_algebra(dev)]), "the self-test failed")
    selftest_ms = selftest.measure_fps(dev)

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

    # 6e. the COCO eval path (reader, harness, CLI) on the card
    eval_counts = eval_phase(dev, smi)

    # 7. timings at batch 8 (368x496 padded frames, bf16, flip TTA)
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

    with torch.inference_mode():
        for caps_name, caps, (hh, pp) in (
                ("default caps (K=32)", default_caps, (hd, pd)),
                ("RETRY_CAPS (K=64)", RETRY_CAPS,
                 (h64.to(dev), p64.to(dev)))):
            gk = {k: v for k, v in caps.items() if k != "max_peaks"}
            dec_ms, _ = timed(lambda: decode_poses_batch(hh, pp, **caps))
            nms_ms, pk = timed(lambda: nms(hh, max_peaks=caps["max_peaks"]))
            sc_ms, (s, v) = timed(lambda: score_connections(pk, pp))
            so_ms, srt = timed(lambda: sorted_candidates(s, v))
            gp_ms, _ = timed(lambda: kernels.group_people(
                *srt, pk.x, pk.y, pk.score, pk.truncated, **gk))
            log(f"decode {caps_name}, batch 8 map {hh.shape[1]}x"
                f"{hh.shape[2]}: {dec_ms:.3f} ms/batch = {dec_ms / 8:.4f} "
                f"ms/frame; nms+refine {nms_ms:.3f}, scoring {sc_ms:.3f}, "
                f"sort {so_ms:.3f}, group_people {gp_ms:.3f} ms [{smi}]")

    e2e_ms, _ = timed(lambda: pipe.run_batch(frames8), iters=5)
    log(f"e2e run_batch 8 frames 480x640 -> 368x496, flip TTA, bf16: "
        f"{e2e_ms:.1f} ms/batch = {8e3 / e2e_ms:.1f} frames/s [{smi}]")
    # the submit/collect overlap: host time until run_batch_submit returns
    # and until the collected people, five times from an idle card
    spans = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ticket = pipe.run_batch_submit(frames8)
        t1 = time.perf_counter()
        pipe.run_batch_collect(ticket)
        spans.append(((t1 - t0) * 1e3, (time.perf_counter() - t0) * 1e3))
    log(f"run_batch_submit 8 frames: returns after "
        f"{[round(a, 2) for a, _ in spans]} ms, people collected after "
        f"{[round(b, 2) for _, b in spans]} ms (forward {fwd_ms:.2f} ms) "
        f"[{smi}]")
    # where run_batch's host time goes: torch.profiler over 3 batches, the
    # device's busy time against the wall clock (both under the
    # profiler's own overhead) and the host ops of most self time
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    pipe.run_batch(frames8)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            pipe.run_batch(frames8)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 3
    averages = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in averages
                  if e.device_type == DeviceType.CUDA) / 3e3
    host = sorted((e for e in averages if e.device_type == DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    log(f"run_batch 8 frames under the profiler: {wall_ms:.2f} ms/batch "
        f"wall, device busy {busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.0f}"
        f"%); host self time per batch, largest: "
        + ", ".join(f"{e.key} {e.self_cpu_time_total / 3e3:.2f} ms "
                    f"({e.count // 3})" for e in host[:10]) + f" [{smi}]")
    ms1_ms, _ = timed(lambda: pipe.run_multiscale(frame, MS_SCALES), iters=3)
    ms8_ms, _ = timed(lambda: pipe.run_multiscale_batch(frames8, MS_SCALES),
                      iters=3)
    log(f"multi-scale TTA {MS_SCALES}, flip, bf16, 480x640 frames: "
        f"run_multiscale {ms1_ms:.2f} ms/frame; run_multiscale_batch(8) "
        f"{ms8_ms:.2f} ms/batch = {ms8_ms / 8:.3f} ms/frame [{smi}]")

    # 8. training main path: the flagship VGG19 (6 stages, 368 px, bf16,
    # batch 72, freeze phase on) from seeded He weights with the
    # from-scratch recipe's clip (experiments/vgg19_368x368_scratch.yaml),
    # on one fixed batch of rendered scenes, through Trainer.run_epoch;
    # uint8 images with their content windows.  lr 0.02, not the recipe's
    # 0.1: on one fixed batch 0.1 spikes (0.22 -> 5.1 at step 6 on an H100)
    # and 0.02 falls step after step
    from rtpose_tpu_torch.config import Config
    from rtpose_tpu_torch.train.checkpoint import CheckpointManager
    from rtpose_tpu_torch.train.trainer import Trainer
    del pipe
    cfg = Config()
    cfg.model.init_scheme = "scratch"
    cfg.train.lr, cfg.train.clip_grad_norm = 0.02, 1.0
    check((cfg.model.name, cfg.model.num_stages, cfg.dataset.image_size,
           cfg.model.dtype, cfg.train.batch_size) ==
          ("vgg19", 6, 368, "bfloat16", TRAIN_BATCH)
          and cfg.train.freeze_base_epochs > 0, "flagship config")
    batch = train_batch(TRAIN_BATCH, 368, seed=2)
    trainer = Trainer(cfg, device=dev)
    w0 = trainer.params["model0.0.weight"].detach().clone()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    losses = [trainer.run_epoch([batch])["loss"] for _ in range(8)]
    frozen_kept = torch.equal(trainer.params["model0.0.weight"], w0)
    trainer.epoch = cfg.train.freeze_base_epochs
    trainer.maybe_release_backbone()
    losses += [trainer.run_epoch([batch])["loss"] for _ in range(2)]
    released_moved = not torch.equal(trainer.params["model0.0.weight"], w0)

    def snapshot(tr):
        return ([p.detach().clone() for p in tr.params.values()]
                + [st["momentum_buffer"].clone()
                   for st in tr.optimizer.state.values()])

    before = snapshot(trainer)
    nan_logs = trainer.run_epoch([{
        "image": np.full((TRAIN_BATCH, 368, 368, 3), np.nan, np.float32),
        "keypoints": batch["keypoints"]}])
    nan_kept = all(torch.equal(a, b)
                   for a, b in zip(before, snapshot(trainer)))
    del before
    ckpt_dir = os.path.join(ROOT, "checkpoints", "chip_smoke")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt = CheckpointManager(ckpt_dir, keep=1)
    ckpt.save(trainer.state_dict(), step=trainer.step,
              meta={"epoch": trainer.epoch})
    fresh = Trainer(cfg, device=dev)
    fresh.restore(ckpt.restore_latest(dev))
    shutil.rmtree(ckpt_dir)
    step_args = (batch["image"], batch["keypoints"], None,
                 batch["valid_xywh"])
    resumed = (trainer.train_step(*step_args)["loss"],
               fresh.train_step(*step_args)["loss"])
    torch.cuda.synchronize()
    train_counts = kernels.launch_counts()
    del fresh
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"training loss did not fall: {losses}")
    check(frozen_kept, "model0.0.weight moved during the freeze")
    check(released_moved, "model0.0.weight did not move after the release")
    check(nan_logs["skipped_nonfinite"] == 1.0 and nan_kept,
          "the NaN batch changed parameters or momentum")
    check(resumed[0] == resumed[1], f"restored trainer's next loss "
          f"{resumed[1]!r} != {resumed[0]!r}")
    check(train_counts["gt_maps"] > 0, "train_step did not launch gt_maps")
    log(f"training bf16 6 stages 368x368 batch {TRAIN_BATCH}: losses "
        f"{[round(x, 6) for x in losses]} (8 frozen, 2 released); "
        f"model0.0 kept in the freeze, moved after; NaN batch skipped, "
        f"params and momentum bit-identical; restored trainer's next loss "
        f"bit-equal ({resumed[0]!r}); launches {train_counts}")

    # 9. train step timing at the flagship batch (freeze released)
    torch.cuda.reset_peak_memory_stats()
    step_ms, _ = timed(lambda: trainer.train_step(*step_args), iters=5)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"train step bf16 6 stages 368x368 batch {TRAIN_BATCH} (GT on the "
        f"card, one host readback): {step_ms:.1f} ms/step = "
        f"{TRAIN_BATCH * 1e3 / step_ms:.1f} img/s; peak memory "
        f"{peak_gib:.2f} GiB; gt_maps {results['gt_maps']['ms']:.4f} ms of "
        f"it [{smi}]")
    del trainer
    torch.cuda.empty_cache()

    # 9b. training from files: the train CLI, the loader's processes
    cli_gt_launches = train_files_phase(dev, smi, step_ms)

    # 10. one fp32 train step (TF32 off) on the card vs the CPU, batch 2
    # at 368 px, from the same seeded weights
    cfg32 = copy.deepcopy(cfg)
    cfg32.model.dtype = "float32"
    small = train_batch(2, 368, seed=3)
    args32 = (small["image"], small["keypoints"], None, small["valid_xywh"])
    sides = {}
    for name, device in (("cpu", "cpu"), ("card", dev)):
        tr = Trainer(cfg32, device=device)
        p0 = {k: v.detach().cpu().clone() for k, v in tr.params.items()}
        loss = tr.train_step(*args32)["loss"]
        sides[name] = (loss, {k: v.detach().cpu() - p0[k]
                              for k, v in tr.params.items()})
        del tr
    (l_cpu, d_cpu), (l_card, d_card) = sides["cpu"], sides["card"]
    rel = abs(l_card - l_cpu) / abs(l_cpu)
    upd, worst = 0.0, None
    for k, d in d_cpu.items():
        norm = float(d.norm())
        err = float((d_card[k] - d).norm())
        check(norm > 0 or err == 0, f"fp32 step: {k} moved on one side")
        if norm and err / norm > upd:
            upd, worst = err / norm, k
    check(rel <= STEP_LOSS_RTOL, f"fp32 train step loss rel err {rel}")
    check(upd <= STEP_UPD_TOL, f"fp32 train step update rel err {upd}")
    log(f"fp32 train step card vs CPU, 6 stages 368x368 batch 2: loss "
        f"{l_card!r} vs {l_cpu!r} (rel {rel:.3g}, bound {STEP_LOSS_RTOL}); "
        f"updates: L2 error over L2 norm at most {upd:.3g} per tensor "
        f"(at {worst}; bound {STEP_UPD_TOL})")

    # 11. the model zoo: every other family served, multi-scale, fp32
    # card vs CPU, trained; and the kernels on hourglass's factor-4 and
    # stride-4 shapes
    zoo_launches, zoo_numbers, hg_rows = zoo_phase(dev, smi)

    # 12. the front-ends: the HTTP service (latency at concurrency 1,
    # requests/s at 8, card == CPU on rendered maps with a crowded retry),
    # the video and picture demos, each counted from 0
    frontend_launches, frontend_numbers = frontends_phase(dev, smi)

    sources = {   # kernel -> (source, the TPU kernel it replaces, and K2)
        "connection_scores": ("rtpose_tpu_torch/csrc/connection_scores.cu",
                              "rtpose_tpu/ops/pallas_kernels.py:214",
                              "rtpose_tpu/ops/pallas_kernels.py:172"),
        "bicubic_refine": ("rtpose_tpu_torch/csrc/bicubic_refine.cu",
                           "rtpose_tpu/ops/pallas_kernels.py:258", None),
        "gt_maps": ("rtpose_tpu_torch/csrc/gt_maps.cu",
                    "rtpose_tpu/ops/pallas_gt.py:130", None),
    }
    launches = {**{k: counts[k] for k in SERVING_KERNELS},
                "gt_maps": train_counts["gt_maps"]}
    results["bicubic_refine"]["gaussian_filt_launches"] = \
        blur_counts["bicubic_refine_gaussian_filt"]
    results["gt_maps"]["stage_host_ms"] = gt_host_ms
    results["gt_maps"]["train_cli_launches"] = cli_gt_launches
    # library_ms: no single PyTorch call computes any of them (K1's
    # truncated int(a + s * step + 0.5) // 8 cells are not grid_sample's;
    # K3 is a gather, a bicubic upsample with cv2's border and an argmax;
    # K4 a masked scatter-sum)
    hourglass = {   # kernel -> its rows on hourglass's shapes
        "connection_scores": {k: hg_rows[f"connection_scores_K{k}"]
                              for k in (32, 64)},
        "bicubic_refine": {"plain": hg_rows["bicubic_refine_K32"],
                           "gaussian_filt": hg_rows[
                               "bicubic_refine_gaussian_filt_K32"]},
        "gt_maps": hg_rows["gt_maps_stride4"]}
    rows = [dict(name=name, route="cuda", source=src, replaces=rep,
                 launches=launches[name],
                 eval_launches={k: c[name] for k, c in eval_counts.items()},
                 zoo_launches=zoo_launches[name],
                 http_launches=frontend_launches["http"][name],
                 video_launches=frontend_launches["video"][name],
                 **results[name], library_ms=None,
                 hourglass_factor4=hourglass[name],
                 **({"also_replaces": also} if also else {}))
            for name, (src, rep, also) in sources.items()]
    # the grouping kernel replaces no TPU kernel but the two lax.scans of
    # the JAX decode: its row stands on a line of its own.  library_ms:
    # no PyTorch call computes greedy 1-1 matching or the assembly
    group_row = dict(
        name="group_people", route="cuda",
        source="rtpose_tpu_torch/csrc/group_people.cu",
        replaces="rtpose_tpu/ops/grouping.py:228",
        also_replaces="rtpose_tpu/ops/grouping.py:287",
        replaces_kind="lax.scan (greedy_connections, assemble_people); "
                      "no Pallas kernel",
        launches=counts["group_people"],
        multiscale_launches=ms_counts["group_people"],
        eval_launches={k: c["group_people"] for k, c in eval_counts.items()},
        zoo_launches=zoo_launches["group_people"],
        http_launches=frontend_launches["http"]["group_people"],
        video_launches=frontend_launches["video"]["group_people"],
        hourglass_factor4={k: hg_rows[f"group_people_K{k}"]
                           for k in (32, 64)},
        **results["group_people"], library_ms=None,
        selftest_latency_ms=selftest_ms)
    left = descendants()
    check(not left, f"processes still running: {left}")
    print(json.dumps({"zoo": zoo_numbers}), flush=True)
    print(json.dumps({"frontends": frontend_numbers}), flush=True)
    print(json.dumps({"kernels_beyond_tpu": [group_row]}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
