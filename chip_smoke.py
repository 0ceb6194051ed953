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
- the native training loader (phase 9c): the C++ pool built from the
  repository against Pillow's libjpeg, the train CLI with
  ``train.data_loader=native`` on phase 9b's JPEGs (K4 once a step), K4
  on a native uint8 batch == plain, the loader's img/s with 1 and nproc
  threads, alone and feeding the trainer, beside phase 9b's PIL loader;
  the hourglass experiment from JPEGs with rotation (phase 9d, K4 at
  stride 4); the flagship served under each resize mode (host, "auto",
  card; phase 7b), ms per frame;
- the parallel paths (phase 13): the flagship's training step over a
  world-1 NCCL process group against no mesh; two gloo ranks on this card
  (each building the kernels cold, at once): DP2 against one process in
  fp32, at the flagship batch in bf16 (K4 once a step a rank, equal to
  plain), atrous_cpm's BatchNorm statistics under DP2, DP1 x TP2 against
  one process with the gathered checkpoint served unsharded, and the
  eval split by ``host_shard`` and merged on rank 0; sharded serving on
  two replicas on this card (K1, K3 and G once a shard, the unsharded
  pipeline's people); the eval CLI's ``--data-parallel``;
- the workflow scripts (phase 14), each a process of its own through
  its CLI: the decode soak on 300 scenes and on 100 crowded ones (no
  count mismatch, every overflow fixed at ``RETRY_CAPS``), the training
  schedule at full width with a crash and restore (the restored step is
  the last checkpoint's; K4 once a step), the endurance run at full
  width killed with SIGKILL and resumed from its newest checkpoint, the
  val2017-profile rehearsal of 400 images through the eval CLI (every
  image through the pipeline, ``scale_pad_geometry``'s bucket count),
  the eval breakdown, the crowded bench's two arms, and hourglass's
  train -> eval chain with its rescore; each kernel row carries
  ``workflow_launches``, the launches the scripts report;
- the webcam demo (phase 15): ``run_webcam`` on the flagship as its CLI
  builds it, over ``demo/camera.py``'s V4L2 read path on scripted devices
  (60 rendered 480x640 frames in YUYV, then 60 in Motion-JPEG) into the
  browser view while a client reads the stream and sends quit (frames/s,
  p50/p99 ms a frame, K1, K3 and G once a frame); a real ``/dev/video*``
  where there is one, else ``open_camera``'s error naming it; the drawn
  frames of 8 oracle-map frames on the card equal to the CPU's; the YUYV
  conversion and the FPS text against the machine's cv2; each kernel row
  carries ``webcam_launches``;
- the video files (phase 16): the route probe (NVDEC's caps, the OpenCV
  wheel's libavcodec); libavcodec's planes of an I_PCM H.264 MP4
  (``demo/scripted_video.py``) equal to the written ones, and
  ``open_video``'s frames on the card their plain conversion at all four
  rotation tags; the conversion kernel (``csrc/yuv420_to_bgr.cu``)
  against its plain version at four turns, error 0, timed with its
  bound; an ``mp4v`` MP4 and an XVID AVI of this machine's cv2 read with
  cv2's frame count and frames; the flagship video demo on a 64-frame
  480x640 H.264 MP4 (frames/s, read ms a frame split into demux, decode
  and convert; K1, K3 and G once a batch, the conversion once a frame);
  the probe's ``vp9`` decoder, ``mpeg4`` encoder, swscale and library
  versions; the committed VP9 WebM, its superframe variant and this
  machine's cv2's MPEG-4 (and, where it has libvpx, VP9) Matroska files
  read equal to its cv2; I_PCM H.264 in Matroska (known and unknown
  sizes) and B-frame H.264 MP4s (with and without the reorder hint) in
  cv2's order with the known pixels; the XVID writer's packets against
  cv2's on 16 rendered 480x640 frames, its ms a frame (swscale, encode)
  beside the Motion-JPEG writer's; the flagship video demo on a 64-frame
  480x640 MPEG-4 MKV writing XVID (frames/s, read and write ms a frame,
  K1, K3 and G once a batch, the conversion once a frame); MPEG-TS,
  fragmented MP4 and edit lists against cv2 and the demo on a 64-frame
  MPEG-2 TS; the probe's ``hevc`` decoder and parser and its AV1 check,
  libavcodec's planes of PCM HEVC equal to the written ones, HEVC in
  MP4 / MKV / TS / M2TS (reordered, cropped), cv2's ``.mpg`` / ``.vob``
  and H.264 / HEVC program streams with and without a map equal to its
  cv2, and the demo on a 64-frame 480x640 PCM HEVC MP4;
  an open without libavcodec or without a card raises; each kernel row
  carries ``video_file_launches`` (the HEVC demo's), and the
  conversion's row stands beside the grouping kernel's;

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
        img_dir, ann, names = flagship_eval_set(os.path.join(work,
                                                             "flagship"))
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

        def timed_build(args, **kwargs):
            t = time.perf_counter()
            pipe = build(args, **kwargs)
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
        pil = dict(loader_1_ips=round(one_ips, 1),
                   loader_w_ips=round(w_ips, 1), fed_ips=round(fed_ips, 1),
                   fed_wait_share=round(wait_share, 3), workers=workers)
        stop_worker_processes()
        # 9c. the same JPEGs through the native loader
        native = native_loader_phase(dev, smi, (train_dir, train_ann),
                                     (val_dir, val_ann), step_ms, pil)
    finally:
        shutil.rmtree(work, ignore_errors=True)
        # the forkserver and the resource tracker outlive the loaders
        stop_worker_processes()
    return cli_counts["gt_maps"], native



def native_loader_phase(dev, smi: str, train, val, step_ms: float,
                        pil: dict) -> dict:
    """Training from the same JPEGs through ``train.data_loader=native``:
    the C++ pool's build and its libjpeg (Pillow's), the train CLI's
    ``main()`` for one epoch (K4 once a train and a val step), K4 on a
    native uint8 batch == plain after ``normalize_window`` (card == CPU),
    and the loader's img/s with 1 and nproc threads, alone and feeding
    the trainer, beside phase 9b's PIL loader -> numbers."""
    import contextlib
    import io
    import itertools

    import torch
    from rtpose_tpu_torch.data.dataset import CocoKeypoints, ConcatKeypoints
    from rtpose_tpu_torch.data.native_loader import NativeLoader
    from rtpose_tpu_torch.native import imgpipe
    from rtpose_tpu_torch.ops import kernels
    from rtpose_tpu_torch.train import __main__ as train_cli
    from rtpose_tpu_torch.train.checkpoint import CheckpointManager
    from rtpose_tpu_torch.train.trainer import normalize_window

    nproc = len(os.sched_getaffinity(0))
    (train_dir, train_ann), (val_dir, val_ann) = train, val
    t0 = time.perf_counter()
    lib = imgpipe.loaded_library()
    build_s = time.perf_counter() - t0
    libjpeg = imgpipe.pillow_libjpeg()
    log(f"native loader: decoder route a, libjpeg-turbo from Pillow's wheel "
        f"{libjpeg}; imgpipe built and loaded in {build_s:.2f} s -> "
        f"{os.path.relpath(lib, ROOT)}")

    # the flagship through the CLI with the native loader, one epoch
    ckpt_dir = os.path.join(os.path.dirname(train_dir), "ckpt_native")
    sets = [f'dataset.train_image_dir="{train_dir}"',
            f'dataset.train_annotations=["{train_ann}"]',
            f'dataset.val_image_dir="{val_dir}"',
            f'dataset.val_annotations="{val_ann}"',
            f'train.checkpoint_dir="{ckpt_dir}"',
            f"train.data_workers={nproc}", 'train.data_loader="native"']
    argv = sys.argv
    sys.argv = ["train", "--config",
                os.path.join(ROOT, "experiments", "vgg19_368x368_sgd.yaml"),
                "--epochs", "1", "--device", str(dev), "--set", *sets]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            trainer, history = train_cli.main()
        torch.cuda.synchronize()
    finally:
        sys.argv = argv
    cli_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    (logs,) = history
    steps, val_steps = len(logs["train"]["step_s"]), len(logs["val"]["step_s"])
    check(steps == 4 and trainer.step == steps,
          f"native CLI epoch took {trainer.step} steps")
    check(counts["gt_maps"] == steps + val_steps,
          f"native CLI: gt_maps launched {counts['gt_maps']} times for "
          f"{steps} train and {val_steps} val steps")
    _, meta = CheckpointManager(ckpt_dir).restore_latest(dev)
    check(math.isfinite(meta["train_loss"]) and math.isfinite(
        meta["val_loss"]), f"native CLI losses {meta}")
    waits = [round(d / t, 3) for d, t in zip(logs["train"]["data_s"],
                                             logs["train"]["step_s"])]
    log(f"train CLI with train.data_loader=native, flagship (VGG19 6 stages "
        f"368 px bf16 batch {TRAIN_BATCH}), {nproc} threads: {steps} steps "
        f"+ {val_steps} val in {cli_s:.2f} s (model build included); train "
        f"loss {meta['train_loss']!r}, val loss {meta['val_loss']!r}; "
        f"launches {counts}; data-wait share per step {waits} [{smi}]")

    # K4 on a native uint8 batch, and normalize_window card == CPU
    size = trainer.cfg.dataset.image_size
    grid = size // trainer.cfg.model.downsample
    train_ds = CocoKeypoints(train_dir, train_ann, input_size=size)
    batch = next(iter(NativeLoader(train_ds, TRAIN_BATCH, threads=nproc,
                                   seed=5, uint8_output=True,
                                   pin_memory=True)))
    check(batch["image"].is_pinned() and batch["image"].dtype == torch.uint8,
          "native batches are pinned uint8 canvases")
    norm_card = normalize_window(batch["image"].to(dev),
                                 batch["valid_xywh"].to(dev))
    norm_cpu = normalize_window(batch["image"], batch["valid_xywh"])
    norm_err = float((norm_card.cpu() - norm_cpu).abs().max())
    kps = batch["keypoints"].to(dev)
    heat, paf = kernels.gt_maps(kps, grid_y=grid, grid_x=grid, stride=8,
                                sigma=7.0)
    heat_p, paf_p = kernels.gt_maps_plain(
        kps, kernels.limb_scalars(kps, 8), kernels.person_bound(kps),
        grid_y=grid, grid_x=grid, stride=8, sigma=7.0)
    k4_err = max(float((heat - heat_p).abs().max()),
                 float((paf - paf_p).abs().max()))
    check(k4_err == 0.0 and norm_err == 0.0,
          f"native batch: K4 max err {k4_err}, normalize_window card vs "
          f"CPU {norm_err}")
    del batch, kps, heat, paf, heat_p, paf_p, norm_card, norm_cpu

    # img/s: 1 and nproc threads alone, nproc feeding the trainer
    many = ConcatKeypoints([train_ds] * FED_ROUNDS)
    n_batches = len(many) // TRAIN_BATCH

    def alone(threads, n):
        loader = NativeLoader(many, TRAIN_BATCH, threads=threads, seed=6,
                              uint8_output=True, pin_memory=True)
        t, seen = [time.perf_counter()], 0
        for _ in itertools.islice(loader, n):
            t.append(time.perf_counter())
            seen += 1
        # steady: after the first batch (prefetch fills behind it)
        return (seen - 1) * TRAIN_BATCH / (t[-1] - t[1])

    one_ips = alone(1, 3)
    all_ips = alone(nproc, n_batches)
    fed = NativeLoader(many, TRAIN_BATCH, threads=nproc, seed=7,
                       uint8_output=True, pin_memory=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        fed_logs = trainer.run_epoch(itertools.islice(fed, n_batches))
    torch.cuda.synchronize()
    fed_s = time.perf_counter() - t0
    steady = sum(fed_logs["step_s"][1:])
    fed_ips = (n_batches - 1) * TRAIN_BATCH / steady
    wait_share = sum(fed_logs["data_s"][1:]) / steady
    cpu = os.times()
    del trainer
    torch.cuda.empty_cache()
    numbers = dict(nproc=nproc, loader_1_thread_ips=round(one_ips, 1),
                   loader_nproc_ips=round(all_ips, 1),
                   fed_ips=round(fed_ips, 1),
                   fed_wait_share=round(wait_share, 3),
                   in_memory_ips=round(TRAIN_BATCH * 1e3 / step_ms, 1),
                   cli_gt_launches=counts["gt_maps"], k4_err=k4_err,
                   library=os.path.relpath(lib, ROOT), libjpeg=str(libjpeg),
                   pil=pil)
    log(f"native loader: nproc {nproc}; {TRAIN_BATCH}-image uint8 batches "
        f"from the same JPEGs: 1 thread {one_ips:.1f} img/s "
        f"({1e3 / one_ips:.2f} ms/img), {nproc} threads {all_ips:.1f} "
        f"img/s; feeding the trainer {fed_ips:.1f} img/s after the first "
        f"step ({n_batches} steps in {fed_s:.2f} s), data-wait share "
        f"{wait_share:.3f}; in memory {numbers['in_memory_ips']} img/s; the "
        f"PIL loader in this call (phase 9b): 1 process {pil['loader_1_ips']}"
        f" img/s, {pil['workers']} processes {pil['loader_w_ips']} img/s, "
        f"fed {pil['fed_ips']} img/s at a data-wait share "
        f"{pil['fed_wait_share']}; K4 on a native batch == plain, "
        f"normalize_window card == CPU; process CPU s so far user "
        f"{cpu.user:.1f} system {cpu.system:.1f} [{smi}]")
    return numbers


def rotated_hourglass_phase(dev, smi: str) -> dict:
    """The hourglass experiment (8 stacks, 256 px, stride 4, rotation up
    to 40 degrees) from JPEGs through the train CLI's ``main()`` with the
    PIL loader: K4 at stride 4 once a train and a val step, finite
    losses -> numbers."""
    import contextlib
    import io

    import torch
    from rtpose_tpu_torch.data.dataset import stop_worker_processes
    from rtpose_tpu_torch.ops import kernels
    from rtpose_tpu_torch.train import __main__ as train_cli
    from rtpose_tpu_torch.train.checkpoint import CheckpointManager
    from rtpose_tpu_torch.utils.synth_coco import (training_frames,
                                                   write_synth_coco)

    nproc = len(os.sched_getaffinity(0))
    work = os.path.join(ROOT, "rtpose_tpu_torch", "build", "chip_smoke_hg")
    shutil.rmtree(work, ignore_errors=True)
    try:
        rng = np.random.RandomState(8)
        shapes = [((240, 320), (320, 240))[i % 2] for i in range(96)]
        train_dir, train_ann = write_synth_coco(
            os.path.join(work, "train"), training_frames(rng, shapes))
        val_dir, val_ann = write_synth_coco(
            os.path.join(work, "val"), training_frames(rng, shapes[:32]),
            seed=96)
        sets = [f'dataset.train_image_dir="{train_dir}"',
                f'dataset.train_annotations=["{train_ann}"]',
                f'dataset.val_image_dir="{val_dir}"',
                f'dataset.val_annotations="{val_ann}"',
                f'train.checkpoint_dir="{os.path.join(work, "ckpt")}"',
                f"train.data_workers={min(8, nproc)}"]
        argv = sys.argv
        sys.argv = ["train", "--config",
                    os.path.join(ROOT, "experiments",
                                 "hourglass_256x256.yaml"),
                    "--epochs", "1", "--device", str(dev), "--set", *sets]
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                trainer, (logs,) = train_cli.main()
            torch.cuda.synchronize()
        finally:
            sys.argv = argv
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        cfg = trainer.cfg
        check((cfg.model.name, cfg.model.num_stages, cfg.model.downsample,
               cfg.dataset.image_size, cfg.dataset.rotate_degrees) ==
              ("hourglass", 8, 4, 256, 40.0), "hourglass experiment config")
        steps, val_steps = (len(logs["train"]["step_s"]),
                            len(logs["val"]["step_s"]))
        check(steps >= 2 and counts["gt_maps"] == steps + val_steps,
              f"rotated hourglass: {steps} steps, gt_maps {counts}")
        _, meta = CheckpointManager(os.path.join(work, "ckpt")
                                    ).restore_latest(dev)
        check(math.isfinite(meta["train_loss"])
              and math.isfinite(meta["val_loss"]),
              f"rotated hourglass losses {meta}")
        del trainer
        torch.cuda.empty_cache()
        log(f"hourglass experiment from 96 + 32 JPEGs (240x320, 320x240), "
            f"rotation up to 40 degrees, PIL loader with {min(8, nproc)} "
            f"processes: {steps} steps + {val_steps} val at batch "
            f"{cfg.train.batch_size} in {wall:.2f} s (build and worker start "
            f"included); K4 at stride 4 (64x64 grid) launched "
            f"{counts['gt_maps']} times; train loss {meta['train_loss']!r}, "
            f"val loss {meta['val_loss']!r}; data-wait s per step "
            f"{[round(d, 3) for d in logs['train']['data_s']]} [{smi}]")
        return dict(steps=steps, val_steps=val_steps,
                    gt_launches=counts["gt_maps"], wall_s=round(wall, 2))
    finally:
        shutil.rmtree(work, ignore_errors=True)
        stop_worker_processes()


def resize_modes_phase(dev, smi: str, model) -> dict:
    """The flagship served under each resize mode on the same weights:
    ``run_batch`` of 8 COCO-sized (480x640, shrinking) and 8 small
    (240x320, growing) rendered frames, ms per frame, host resize alone,
    and the people of the modes that take the same path equal -> numbers
    per mode and frame size."""
    import torch
    from rtpose_tpu_torch.data.imread_fixtures import render_scene
    from rtpose_tpu_torch.infer.pipeline import PosePipeline
    from rtpose_tpu_torch.infer.preprocess import crop_with_factor
    from rtpose_tpu_torch.ops import kernels

    sets = {"480x640": [np.ascontiguousarray(render_scene(i, 480, 640)[
                ..., ::-1]) for i in range(8)],
            "240x320": [np.ascontiguousarray(render_scene(10 + i, 240, 320)[
                ..., ::-1]) for i in range(8)]}
    t0 = time.perf_counter()
    for frame in sets["480x640"] * 2:
        crop_with_factor(frame, 368)
    host_ms = (time.perf_counter() - t0) * 1e3 / 16
    out, people = {}, {}
    for mode in (False, "auto", True):
        pipe = PosePipeline(model, device=dev, input_size=368, flip=True,
                            device_resize=mode)
        for label, frames in sets.items():
            pipe.run_batch(frames)                     # warm-up
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            for _ in range(3):
                got, metas = pipe.run_batch(frames)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / (3 * len(frames))
            counts = kernels.launch_counts()
            check(all(counts[k] == 3 for k in SERVING_KERNELS),
                  f"resize mode {mode} {label}: launches {counts}")
            out[f"{mode}/{label}"] = round(ms, 3)
            people[mode, label] = [[sorted(person["parts"]) for person in p]
                                   for p in got]
    # "auto" takes the host path for shrinking frames, the card's for
    # growing ones: the same people as that mode
    check(people["auto", "480x640"] == people[False, "480x640"]
          and people["auto", "240x320"] == people[True, "240x320"],
          "auto did not follow the host path for 480x640 and the card's "
          "for 240x320")
    log(f"resize modes, flagship bf16 flip, run_batch of 8, ms per frame: "
        f"{out}; host resize (crop_with_factor) of a 480x640 frame "
        f"{host_ms:.2f} ms [{smi}]")
    return dict(ms_per_frame=out, host_resize_ms=round(host_ms, 2))


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


PAR_FP32_BATCH = 16    # DP2 in fp32 against one process: global batch
PAR_TP_BATCH = 8       # DP1 x TP2 in fp32 against one process
PAR_BN = ("atrous_cpm", 5, 368)   # a BatchNorm family at its published width
PAR_BN_BATCH = 8
PAR_STEPS = 3          # timed steps at the flagship batch (DP1 NCCL, DP2)
PAR_RTOL = {"dp2_fp32": 1e-5, "tp2_fp32": 1e-5, "bn_dp2_fp32": 1e-5}
PAR_PARAM_ATOL, PAR_PARAM_RTOL = 1e-5, 1e-3


def _par_cfg(name="vgg19", stages=6, size=368, dtype="bfloat16"):
    """The flagship's training config as phase 8 runs it (seeded He
    weights, lr 0.02, the scratch recipe's clip), without the freeze so
    that every convolution trains."""
    from rtpose_tpu_torch.config import Config
    cfg = Config()
    cfg.model.name, cfg.model.num_stages = name, stages
    cfg.model.dtype, cfg.dataset.image_size = dtype, size
    cfg.model.init_scheme = "scratch"
    cfg.train.lr, cfg.train.clip_grad_norm = 0.02, 1.0
    cfg.train.freeze_base_epochs = 0
    cfg.train.print_freq = 1000
    return cfg


def _step_args(b):
    return b["image"], b["keypoints"], None, b["valid_xywh"]


def _against_one_process(cfg, batches, dev, mesh, rank, label,
                         keep_state=False):
    """Train `batches` on this rank's rows over `mesh` and, on rank 0, the
    same steps in one process on the whole batches -> numbers (rank 0:
    losses, the worst relative loss error, the worst parameter / buffer
    error beyond atol + rtol * |x|, with `keep_state` the gathered
    state)."""
    import torch
    from rtpose_tpu_torch.parallel.distributed import rank_rows
    from rtpose_tpu_torch.train.trainer import Trainer
    tr = Trainer(cfg, device=dev, mesh=mesh)
    logs, ms = [], []
    for b in batches:
        t0 = time.perf_counter()
        logs.append(tr.train_step(*_step_args(rank_rows(b, mesh))))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    state = tr.model_state_dict()
    out = {"losses": [lg["loss"] for lg in logs], "ms_per_step": ms,
           "sharded_convs": sum(k.endswith(".weight") for k in tr.sharded)}
    del tr
    if rank == 0:
        ref = Trainer(cfg, device=dev)
        want = [ref.train_step(*_step_args(b))["loss"] for b in batches]
        ref_state = ref.model_state_dict()
        out["single_losses"] = want
        out["loss_rel_err"] = max(abs(a - b) / abs(b)
                                  for a, b in zip(out["losses"], want))
        excess = 0.0
        max_err = 0.0
        for k, w in ref_state.items():
            d = (state[k].double() - w.double()).abs()
            max_err = max(max_err, float(d.max()))
            excess = max(excess, float((d - PAR_PARAM_ATOL - PAR_PARAM_RTOL
                                        * w.double().abs()).max()))
        out["param_max_abs_err"] = max_err
        out["param_excess"] = excess      # > 0: outside the tolerance
        out["running_stats_compared"] = sum(
            k.endswith(("running_mean", "running_var")) for k in ref_state)
        if keep_state:
            out["state"] = state
        del ref
    torch.cuda.empty_cache()
    log(f"[rank {rank}] {label}: losses {out['losses']}, ms a step "
        f"{[round(x, 1) for x in ms]}")
    return out


def parallel_ranks(rank: int, world: int, spec: dict) -> dict:
    """One of two ranks over gloo, both on card 0 (phase 13): a cold build
    of the kernels, DP2 fp32 against one process, DP2 bf16 at the
    flagship batch (timed, K4 per rank against its plain version), a
    BatchNorm family under DP2, DP1 x TP2 against one process, and the
    eval split by host_shard (oracle maps) -> this rank's numbers."""
    from pathlib import Path

    import torch
    from rtpose_tpu_torch.evalx.harness import run_eval_sharded
    from rtpose_tpu_torch.infer.pipeline import PosePipeline, load_pipeline
    from rtpose_tpu_torch.models import get_model
    from rtpose_tpu_torch.models.convert import load_strict
    from rtpose_tpu_torch.ops import _build, kernels
    from rtpose_tpu_torch.parallel.distributed import rank_rows
    from rtpose_tpu_torch.parallel.mesh import make_mesh
    from rtpose_tpu_torch.train.trainer import Trainer
    from rtpose_tpu_torch.utils.synth_coco import OracleMaps, oracle_maps
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    out = {"device": str(dev)}
    # both ranks start cold on one new build directory, at once
    _build.BUILD_DIR = Path(spec["cold_dir"])
    torch.distributed.barrier()
    t0 = time.perf_counter()
    built = _build.load()
    out["build"] = {"seconds": built.seconds,
                    "load_s": time.perf_counter() - t0,
                    "library": os.path.relpath(str(built.path), ROOT)}
    # a collective on card tensors: gloo takes them
    probe = torch.full((4,), float(rank + 1), device=dev)
    torch.distributed.all_reduce(probe)
    out["gloo_cuda_all_reduce"] = probe.tolist()
    mesh = make_mesh(world, 1)

    out["dp2_fp32"] = _against_one_process(
        _par_cfg(dtype="float32"),
        [train_batch(PAR_FP32_BATCH, 368, seed=10 + i) for i in range(2)],
        dev, mesh, rank, f"DP2 fp32 global batch {PAR_FP32_BATCH}")

    # the flagship batch in bf16, 36 rows a rank, timed; K4 once a step
    tr = Trainer(_par_cfg(), device=dev, mesh=mesh)
    rows = rank_rows(train_batch(TRAIN_BATCH, 368, seed=2), mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    ms, losses = [], []
    for _ in range(PAR_STEPS):
        t0 = time.perf_counter()
        losses.append(tr.train_step(*_step_args(rows))["loss"])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = kernels.launch_counts()["gt_maps"]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    kps = torch.as_tensor(rows["keypoints"]).to(dev)
    grid = 368 // 8
    heat, paf = kernels.gt_maps(kps, grid_y=grid, grid_x=grid, stride=8,
                                sigma=7.0)
    heat_p, paf_p = kernels.gt_maps_plain(
        kps, kernels.limb_scalars(kps, 8), kernels.person_bound(kps),
        grid_y=grid, grid_x=grid, stride=8, sigma=7.0)
    out["dp2_bf16"] = {
        "rows": len(rows["image"]), "losses": losses, "ms_per_step": ms,
        "gt_maps_launches": launches, "peak_gib": peak,
        "k4_max_abs_err": max(float((heat - heat_p).abs().max()),
                              float((paf - paf_p).abs().max()))}
    del tr, kps, heat, paf, heat_p, paf_p
    torch.cuda.empty_cache()

    name, stages, size = PAR_BN
    bn = _against_one_process(
        _par_cfg(name, stages, size, "float32"),
        [train_batch(PAR_BN_BATCH, size, seed=30 + i) for i in range(2)],
        dev, mesh, rank, f"{name} DP2 fp32 global batch {PAR_BN_BATCH}")
    out["bn_dp2_fp32"] = bn

    # DP1 x TP2: both ranks see every row; the convs param_spec shards
    # are split over the two
    tp = _against_one_process(
        _par_cfg(dtype="float32"),
        [train_batch(PAR_TP_BATCH, 368, seed=20 + i) for i in range(2)],
        dev, make_mesh(1, 2), rank, f"DP1 x TP2 fp32 batch {PAR_TP_BATCH}",
        keep_state=True)
    if rank == 0:
        # the gathered state dict serves unsharded
        model = get_model("vgg19", num_stages=6, dtype=torch.float32)
        load_strict(model, tp.pop("state"))
        pipe = PosePipeline(model, device=dev, input_size=368)
        _, heat, _, _ = pipe.run(np.zeros((480, 640, 3), np.uint8))
        tp["unsharded_pipeline_heat_finite"] = bool(np.isfinite(heat).all())
        del pipe, model
        torch.cuda.empty_cache()
    out["tp2_fp32"] = tp

    ev = spec["eval"]
    pipe = PosePipeline(OracleMaps(oracle_maps(ev["scenes"], 368)),
                        device=dev, input_size=368, flip=False)
    kernels.reset_launch_counts()
    stats = run_eval_sharded(ev["img_dir"], ev["ann"], pipe,
                             ev["results_dir"], batch_size=8)
    torch.cuda.synchronize()
    out["eval"] = {"stats": stats, "launches": kernels.launch_counts()}
    # the flagship over phase 6e's JPEGs, as the eval CLI builds it
    fl = spec["flagship_eval"]
    pipe = load_pipeline(device=dev, seed=0, preprocess_mode="vgg")
    kernels.reset_launch_counts()
    stats = run_eval_sharded(fl["img_dir"], fl["ann"], pipe,
                             fl["results_dir"], batch_size=4)
    torch.cuda.synchronize()
    out["flagship_eval"] = {"stats": stats,
                            "launches": kernels.launch_counts()}
    return out


def flagship_eval_set(root: str):
    """Phase 6e's 80 JPEGs of COCO's commonest sizes (1-2 people each) ->
    (image dir, annotation file, file names)."""
    from rtpose_tpu_torch.utils.synth_coco import (spread_people,
                                                   write_synth_coco)
    frames = [shape for shape, n in EVAL_SHAPES for _ in range(n)]
    order = [frames[i] for i in
             np.random.RandomState(1).permutation(len(frames))]
    rng = np.random.RandomState(2)
    img_dir, ann = write_synth_coco(
        root, [(h, w, spread_people(rng, 1 + i % 2, h, w))
               for i, (h, w) in enumerate(order)])
    return img_dir, ann, sorted(os.listdir(img_dir))


def people_lists_err(got, want):
    """The largest part-coordinate difference (normalised x 368 px) of two
    lists of people lists, paired per frame after sorting; None when the
    frames' people or parts differ."""
    worst = 0.0
    for ps, pr in zip(got, want):
        if len(ps) != len(pr):
            return None
        key = lambda p: sorted(p["parts"].items())  # noqa: E731
        for a, b in zip(sorted(ps, key=key), sorted(pr, key=key)):
            if set(a["parts"]) != set(b["parts"]):
                return None
            for part, (x, y, _) in a["parts"].items():
                bx, by, _ = b["parts"][part]
                worst = max(worst, 368 * abs(x - bx), 368 * abs(y - by))
    return worst if len(got) == len(want) else None


def parallel_phase(dev, smi: str):
    """Phase 13: the parallel paths.  DP world 1 over NCCL against no mesh;
    two gloo ranks on this card (``parallel_ranks``); sharded serving on
    ``["cuda:0", "cuda:0"]`` against the unsharded pipeline; the eval
    CLI's ``--data-parallel`` -> ({kernel: {run: launches}}, numbers)."""
    import contextlib
    import io

    import torch
    import torch.distributed as dist
    from rtpose_tpu_torch.data.dataset import stop_worker_processes
    from rtpose_tpu_torch.evalx import __main__ as evalx_cli
    from rtpose_tpu_torch.evalx.harness import run_eval_batched
    from rtpose_tpu_torch.infer.pipeline import PosePipeline, load_pipeline
    from rtpose_tpu_torch.ops import kernels
    from rtpose_tpu_torch.parallel.distributed import free_port, spawn
    from rtpose_tpu_torch.parallel.mesh import make_mesh
    from rtpose_tpu_torch.train.trainer import Trainer
    from rtpose_tpu_torch.utils.synth_coco import (OracleMaps,
                                                   compare_results,
                                                   oracle_maps,
                                                   spread_people,
                                                   write_synth_coco)
    t_phase = time.perf_counter()
    numbers = {"card": smi}
    launches = {k: {} for k in SERVING_KERNELS + ("gt_maps",)}

    # 13a. DP over NCCL at world 1: the flagship at its batch, bf16,
    # through Trainer(mesh=...) against the same steps without a mesh
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1,
                            device_id=dev)
    try:
        batches = [train_batch(TRAIN_BATCH, 368, seed=40 + i)
                   for i in range(PAR_STEPS)]
        runs = {}
        for label, mesh in (("no_mesh", None), ("nccl_world1", make_mesh())):
            tr = Trainer(_par_cfg(), device=dev, mesh=mesh)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            ms, losses = [], []
            for b in batches:
                t0 = time.perf_counter()
                losses.append(tr.train_step(*_step_args(b))["loss"])
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            runs[label] = {"losses": losses, "ms_per_step": ms,
                           "gt_maps_launches":
                               kernels.launch_counts()["gt_maps"]}
            del tr
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    rel = max(abs(a - b) / abs(b) for a, b in zip(
        runs["nccl_world1"]["losses"], runs["no_mesh"]["losses"]))
    check(rel <= 1e-6, f"DP world 1 over NCCL: losses {runs} (rel {rel})")
    check(runs["nccl_world1"]["gt_maps_launches"] == PAR_STEPS,
          f"DP world 1: K4 launches {runs['nccl_world1']}")
    numbers["dp1_nccl"] = dict(runs, loss_rel_err=rel)
    launches["gt_maps"]["dp1_nccl"] = runs["nccl_world1"]["gt_maps_launches"]
    log(f"DP world 1 over NCCL, flagship bf16 batch {TRAIN_BATCH}: losses "
        f"{runs['nccl_world1']['losses']} vs no mesh "
        f"{runs['no_mesh']['losses']} (rel {rel!r}); ms a step "
        f"{[round(x, 2) for x in runs['nccl_world1']['ms_per_step']]} vs "
        f"{[round(x, 2) for x in runs['no_mesh']['ms_per_step']]} [{smi}]")

    work = os.path.join(ROOT, "rtpose_tpu_torch", "build",
                        "chip_smoke_parallel")
    shutil.rmtree(work, ignore_errors=True)
    try:
        # 13b. two gloo ranks on this card
        rng = np.random.RandomState(0)
        scenes = {(368, 496): spread_people(rng, 2, 368, 496),
                  (496, 368): spread_people(rng, 1, 496, 368)}
        shapes = list(scenes) * 8
        o_dir, o_ann = write_synth_coco(
            os.path.join(work, "oracle"),
            [(h, w, scenes[(h, w)]) for h, w in shapes])
        img_dir, ann, names = flagship_eval_set(os.path.join(work, "evalx"))
        spec = {"cold_dir": os.path.join(work, "cold_build"),
                "eval": {"scenes": scenes, "img_dir": o_dir, "ann": o_ann,
                         "results_dir": os.path.join(work, "results")},
                "flagship_eval": {
                    "img_dir": img_dir, "ann": ann,
                    "results_dir": os.path.join(work, "flagship_results")}}
        t0 = time.perf_counter()
        ranks = spawn(parallel_ranks, 2, (spec,), backend="gloo",
                      timeout=600)
        ranks_s = time.perf_counter() - t0
        r0, r1 = ranks
        for r in ranks:
            check(r["gloo_cuda_all_reduce"] == [3.0] * 4
                  and r["device"] == "cuda:0",
                  f"gloo all_reduce of card tensors: {r}")
        builds = [r["build"] for r in ranks]
        check(all(b["library"] == builds[0]["library"] for b in builds),
              f"cold build: {builds}")
        for key in ("dp2_fp32", "tp2_fp32", "bn_dp2_fp32"):
            check(r0[key]["loss_rel_err"] <= PAR_RTOL[key]
                  and r0[key]["param_excess"] <= 0
                  and r1[key]["losses"] == r0[key]["losses"],
                  f"{key}: {r0[key]}, rank 1 losses {r1[key]['losses']}")
        check(r0["bn_dp2_fp32"]["running_stats_compared"] > 0,
              f"{PAR_BN[0]}: no BatchNorm statistics compared")
        check(r0["tp2_fp32"]["sharded_convs"] > 0
              and r0["tp2_fp32"]["unsharded_pipeline_heat_finite"],
              f"TP2: {r0['tp2_fp32']}")
        for i, r in enumerate(ranks):
            d = r["dp2_bf16"]
            check(d["gt_maps_launches"] == PAR_STEPS
                  and d["k4_max_abs_err"] == 0.0
                  and d["rows"] == TRAIN_BATCH // 2
                  and all(math.isfinite(x) for x in d["losses"]),
                  f"DP2 bf16 rank {i}: {d}")
            launches["gt_maps"][f"dp2_bf16_rank{i}"] = d["gt_maps_launches"]
        check(r1["dp2_bf16"]["losses"] == r0["dp2_bf16"]["losses"],
              "DP2 bf16: the ranks' logs differ")
        # the eval split: rank 0's merge against one process
        opipe = PosePipeline(OracleMaps(oracle_maps(scenes, 368)),
                             device=dev, input_size=368, flip=False)
        single_path = os.path.join(work, "single.json")
        with contextlib.redirect_stdout(io.StringIO()):
            want = run_eval_batched(o_dir, o_ann, opipe, batch_size=8,
                                    results_path=single_path)
        merged = []
        for r in range(2):
            with open(os.path.join(work, "results",
                                   f"results.rank{r}.json")) as f:
                merged.extend(json.load(f))
        with open(single_path) as f:
            single = json.load(f)
        kp_err, score_err = compare_results(merged, single)
        got = r0["eval"]["stats"]
        check(r1["eval"]["stats"] is None and len(single) == 3 * 8
              and kp_err == 0.0 and score_err == 0.0
              and all(got[k] == want[k] for k in ("AP", "AP50", "AR",
                                                  "frames_retried")),
              f"eval over two ranks: {got} vs {want}, keypoints {kp_err}")
        for k in SERVING_KERNELS:
            for i, r in enumerate(ranks):
                launches[k][f"eval_rank{i}"] = r["eval"]["launches"][k]
                check(r["eval"]["launches"][k] > 0,
                      f"eval rank {i}: {r['eval']['launches']}")
        numbers["gloo_2_ranks_on_one_card"] = {
            "note": "a correctness setup: two processes share one card",
            "seconds": ranks_s, "ranks": ranks}
        d0, d1 = r0["dp2_bf16"], r1["dp2_bf16"]
        log(f"two gloo ranks on cuda:0 ({ranks_s:.1f} s): gloo all_reduce "
            f"of card tensors ok; cold build on both ranks at once "
            f"{[round(b['seconds'], 1) for b in builds]} s, one library "
            f"{builds[0]['library']}, both loaded")
        log(f"DP2 fp32 batch {PAR_FP32_BATCH} vs one process: loss rel "
            f"{r0['dp2_fp32']['loss_rel_err']!r}, params max abs err "
            f"{r0['dp2_fp32']['param_max_abs_err']!r}; DP1 x TP2 fp32 "
            f"batch {PAR_TP_BATCH}: {r0['tp2_fp32']['sharded_convs']} "
            f"sharded convs, loss rel {r0['tp2_fp32']['loss_rel_err']!r}, "
            f"params {r0['tp2_fp32']['param_max_abs_err']!r}, the gathered "
            f"state serves unsharded; {PAR_BN[0]} DP2 fp32 batch "
            f"{PAR_BN_BATCH}: loss rel {r0['bn_dp2_fp32']['loss_rel_err']!r}"
            f", params and running statistics max abs err "
            f"{r0['bn_dp2_fp32']['param_max_abs_err']!r}; ms a step (rank "
            f"0, gloo on one card) DP2 "
            f"{[round(x, 1) for x in r0['dp2_fp32']['ms_per_step']]}, TP2 "
            f"{[round(x, 1) for x in r0['tp2_fp32']['ms_per_step']]}, "
            f"{PAR_BN[0]} "
            f"{[round(x, 1) for x in r0['bn_dp2_fp32']['ms_per_step']]} "
            f"[{smi}]")
        log(f"DP2 bf16 batch {TRAIN_BATCH} ({d0['rows']} a rank, gloo, both "
            f"ranks on one card: a correctness setup, not a rate): ms a "
            f"step rank 0 {[round(x, 1) for x in d0['ms_per_step']]}, "
            f"rank 1 {[round(x, 1) for x in d1['ms_per_step']]}; K4 "
            f"{d0['gt_maps_launches']} + {d1['gt_maps_launches']} launches,"
            f" == plain (err {d0['k4_max_abs_err']}); peak "
            f"{d0['peak_gib']:.2f} / {d1['peak_gib']:.2f} GiB [{smi}]")
        log(f"eval over two ranks (host_shard, oracle maps, 16 JPEGs): "
            f"rank 0's merge == one process (AP {got['AP']!r}, "
            f"{len(merged)} results)")

        # 13c. sharded serving on two replicas on this card
        pipe = load_pipeline(device=dev, seed=0)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        pipe_sh = load_pipeline(seed=0, mesh=make_mesh(devices=[dev, dev]))
        torch.cuda.synchronize()
        replicas_gib = (torch.cuda.memory_allocated(dev) - before) / 2 ** 30
        frng = np.random.RandomState(7)
        frames = [frng.randint(0, 256, (480, 640, 3), np.uint8)
                  for _ in range(8)]
        serve = {}
        for label, fn, fs in (
                ("batch8", "run_batch", frames),
                ("ragged5", "run_batch", frames[:5]),
                ("multiscale6", "run_multiscale_batch", frames[:6])):
            args = (fs,) if fn == "run_batch" else (fs, MS_SCALES)
            getattr(pipe_sh, fn)(*args)          # warm
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            got = getattr(pipe_sh, fn)(*args)
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            want = getattr(pipe, fn)(*args)
            # (a shard convolves 4 frames where the unsharded pipeline
            # convolves 8: cuDNN may pick another algorithm, so the people
            # are held to RESULT_KP_TOL px)
            err = people_lists_err(got[0], want[0])
            check(len(got[0]) == len(fs) and err is not None
                  and err <= RESULT_KP_TOL,
                  f"sharded {label}: people differ from unsharded ({err})")
            check(all(counts[k] == 2 for k in SERVING_KERNELS),
                  f"sharded {label}: launches {counts} (one a shard)")
            for k in SERVING_KERNELS:
                launches[k][f"sharded_{label}"] = counts[k]
            serve[label] = {"people": sum(map(len, got[0])),
                            "people_max_err_px": err, "launches": counts}

        def timed_batch(p, n=5):
            p.run_batch(frames)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                p.run_batch(frames)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / n

        torch.cuda.reset_peak_memory_stats()
        ms_sh = timed_batch(pipe_sh)
        peak_sh = torch.cuda.max_memory_allocated() / 2 ** 30
        ms_one = timed_batch(pipe)
        ms_sh2 = timed_batch(pipe_sh)
        # people on maps with people: an oracle in place of the network
        maps = oracle_maps(scenes, 368)
        o_one = PosePipeline(OracleMaps(maps), device=dev, input_size=368,
                             flip=False)
        o_sh = PosePipeline(OracleMaps(maps), input_size=368, flip=False,
                            mesh=make_mesh(devices=[dev, dev]))
        o_frames = [np.zeros(s + (3,), np.uint8) for s in shapes[:8]]
        kernels.reset_launch_counts()
        o_got = o_sh.run_batch(o_frames)
        o_counts = kernels.launch_counts()
        o_want = o_one.run_batch(o_frames)
        check(o_got[0] == o_want[0]
              and [len(p) for p in o_got[0]] == [2, 1] * 4,
              f"sharded oracle people {[len(p) for p in o_got[0]]}")
        serve["oracle_mixed_shapes"] = {"people": sum(map(len, o_got[0])),
                                        "launches": o_counts}
        numbers["sharded_serving"] = dict(
            serve, replicas_gib=replicas_gib, peak_gib=peak_sh,
            ms_per_batch8={"sharded": [ms_sh, ms_sh2], "unsharded": ms_one})
        log(f"sharded serving on [cuda:0, cuda:0], flagship bf16 480x640: "
            f"people == unsharded for 8 frames, a ragged 5 and multi-scale "
            f"on 6, K1/K3/G once a shard ({serve['batch8']['launches']}); "
            f"oracle maps with people, two shapes: {serve['oracle_mixed_shapes']['people']}"
            f" people == unsharded; run_batch(8) {ms_sh:.2f} / {ms_sh2:.2f}"
            f" ms sharded, {ms_one:.2f} unsharded; the sharded pipeline's two "
            f"replicas {replicas_gib:.3f} GiB, peak {peak_sh:.2f} GiB "
            f"[{smi}]")
        del pipe, pipe_sh, o_one, o_sh, opipe
        torch.cuda.empty_cache()

        # 13d. the eval CLI's --data-parallel over phase 6e's JPEGs, and
        # the two ranks' split of them (13b) against the CLI's --batch 4
        base = ["evalx", "--image-dir", img_dir, "--ann", ann,
                "--preprocess", "vgg", "--input-size", "368", "--stages",
                str(EVAL_STAGES), "--device", str(dev)]
        cli, argv = {}, sys.argv
        try:
            for label, extra in (("data_parallel", ["--data-parallel"]),
                                 ("batch4", ["--batch", "4"])):
                path = os.path.join(work, f"{label}.json")
                sys.argv = base + extra + ["--results", path]
                torch.cuda.synchronize()
                kernels.reset_launch_counts()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    stats = evalx_cli.main()
                torch.cuda.synchronize()
                with open(path) as f:
                    cli[label] = {"seconds": time.perf_counter() - t0,
                                  "AP": stats["AP"],
                                  "launches": kernels.launch_counts(),
                                  "results": json.load(f)}
        finally:
            sys.argv = argv
        check(cli["data_parallel"]["results"] == cli["batch4"]["results"],
              "--data-parallel results differ from --batch 4's")
        merged = []
        for r in range(2):
            with open(os.path.join(work, "flagship_results",
                                   f"results.rank{r}.json")) as f:
                merged.extend(json.load(f))
        fl = r0["flagship_eval"]["stats"]
        check(r1["flagship_eval"]["stats"] is None
              and sorted(merged, key=json.dumps)
              == sorted(cli["batch4"]["results"], key=json.dumps)
              and fl["AP"] == cli["batch4"]["AP"],
              f"the flagship eval over two ranks: {fl} vs --batch 4's "
              f"AP {cli['batch4']['AP']}")
        for k in SERVING_KERNELS:
            for i, r in enumerate(ranks):
                launches[k][f"flagship_eval_rank{i}"] = \
                    r["flagship_eval"]["launches"][k]
        dp_counts = cli["data_parallel"]["launches"]
        check(all(dp_counts[k] > 0 for k in SERVING_KERNELS),
              f"--data-parallel launches {dp_counts}")
        for k in SERVING_KERNELS:
            launches[k]["evalx_data_parallel"] = dp_counts[k]
        numbers["evalx_data_parallel"] = {
            label: {k: v for k, v in c.items() if k != "results"}
            for label, c in cli.items()}
        log(f"eval CLI --data-parallel ({torch.cuda.device_count()} card, "
            f"batch 4 a card) on {len(names)} JPEGs: results == --batch 4's "
            f"({len(cli['batch4']['results'])} results), and so is rank "
            f"0's merge of two ranks' host_shard halves; "
            f"{cli['data_parallel']['seconds']:.2f} s vs "
            f"{cli['batch4']['seconds']:.2f} s with the build; launches "
            f"{dp_counts} [{smi}]")
    finally:
        shutil.rmtree(work, ignore_errors=True)
        stop_worker_processes()
    numbers["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 13 (parallel): {numbers['phase_s']:.1f} s")
    return launches, numbers


# phase 14: the workflow scripts, each run as a subprocess through its CLI
WF_DIR = os.path.join(ROOT, "rtpose_tpu_torch", "build", "phase14")
WF_KERNELS = SERVING_KERNELS + ("gt_maps",)


def _script(name: str) -> list:
    return [sys.executable, os.path.join(ROOT, "scripts", name)]


def _summary(out: str, what: str) -> dict:
    """The last ``SUMMARY {...}`` line of a script's output."""
    lines = [ln for ln in out.splitlines() if ln.startswith("SUMMARY ")]
    check(bool(lines), f"{what}: no SUMMARY line")
    return json.loads(lines[-1][len("SUMMARY "):])


def _run(args: list, what: str, timeout: float) -> dict:
    """Run a workflow script to its end -> its SUMMARY; a non-zero exit
    fails the smoke."""
    t0 = time.perf_counter()
    proc = subprocess.run(args, cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        log(proc.stdout[-4000:], proc.stderr[-4000:])
    check(proc.returncode == 0, f"{what}: exit code {proc.returncode}")
    summary = _summary(proc.stdout, what)
    log(f"{what}: {time.perf_counter() - t0:.1f} s")
    return summary


def _started(args: list, what: str) -> subprocess.Popen:
    log(f"{what}: started")
    return subprocess.Popen(args, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finished(proc: subprocess.Popen, what: str, timeout: float) -> dict:
    out, _ = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        log(out[-4000:])
    check(proc.returncode == 0, f"{what}: exit code {proc.returncode}")
    return _summary(out, what)


def _live_steps(directory: str) -> list:
    return sorted(int(n[len("step_"):-len(".meta.json")])
                  for n in os.listdir(directory)
                  if n.startswith("step_") and n.endswith(".meta.json"))


def workflows_phase(dev, smi: str):
    """Phase 14: the workflow scripts through their CLIs, each in a
    process of its own -> ({kernel: launches summed over the scripts},
    numbers).  The decode soak (300 scenes of 1-8 people, 100 crowded of
    up to 20: no count mismatch, every overflow fixed at RETRY_CAPS, and
    overflows in the crowded run); the training schedule at full width
    with a restore (the restored step is the last checkpoint's, K4 once a
    step); the endurance run at full width (a ~40 s launch, a second
    SIGKILLed after its first window, a third that resumes from the
    newest checkpoint written before the kill, live checkpoints <=
    keep); the val2017-profile rehearsal of 400 images through the eval
    CLI (every image through the pipeline, the buckets
    ``scale_pad_geometry`` gives); the eval breakdown on that set; the
    crowded bench's two arms; hourglass's train -> eval chain and its
    rescore.  The soaks and the chain run beside the rest (the soaks
    are host-bound)."""
    started = []

    def start(args, what):
        started.append(_started(args, what))
        return started[-1]

    try:
        return _workflows(smi, start)
    finally:
        # a failed check leaves no script running
        for proc in started:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _workflows(smi: str, start):
    """Phase 14's body; `start` launches a script in the background."""
    import signal

    t_phase = time.perf_counter()
    shutil.rmtree(WF_DIR, ignore_errors=True)
    os.makedirs(WF_DIR)
    numbers = {"card": smi}
    summaries = {}

    # 14a. the decode soaks and hourglass's train -> eval chain (2 stacks,
    # 256 px), beside everything below
    soaks = {"soak": start(_script("torch_soak_decode.py")
                           + ["--scenes", "300"], "soak"),
             "soak_crowded": start(
                 _script("torch_soak_decode.py")
                 + ["--scenes", "100", "--people-max", "20"],
                 "soak (crowded)")}
    chain_dir = os.path.join(WF_DIR, "hourglass_chain")
    chain = start(_script("torch_train_to_eval.py")
                  + ["--model", "hourglass", "--size", "256", "--stages",
                     "2", "--batch", "8", "--steps", "8",
                     "--train-images", "64", "--val-images", "16",
                     "--eval-images", "16", "--workers", "4", "--out",
                     chain_dir], "hourglass chain")

    # 14b. the training schedule at full width: 3 epochs of 8 steps over
    # a pool of 4 batches of 72, the crash and restore at epoch 2
    synth_dir = os.path.join(WF_DIR, "train_synth")
    ts = _run(_script("torch_train_synth.py")
              + ["--epochs", "3", "--steps-per-epoch", "8",
                 "--restore-at-epoch", "2", "--pool-batches", "4",
                 "--out", synth_dir], "train_synth", 600)
    summaries["train_synth"] = ts
    restored = ts["restored"]
    check(restored is not None and restored["restored_step"]
          == restored["last_checkpoint_step"],
          f"train_synth: restored {restored}")
    check(ts["launches"]["gt_maps"] == ts["train_steps"] + ts["val_steps"],
          f"train_synth: K4 {ts['launches']['gt_maps']} launches for "
          f"{ts['train_steps']} + {ts['val_steps']} steps")
    numbers["train_synth"] = {"epochs": ts["epochs"], "restored": restored,
                              "render_s": ts["render_s"]}
    log(f"train_synth: restored at step {restored['restored_step']} "
        f"(last checkpoint {restored['last_checkpoint_step']}), losses "
        f"{[round(r['train_loss'], 5) for r in ts['epochs']]} [{smi}]")

    # 14c. the endurance run at full width: a ~40 s launch; a second one
    # killed after its first window; a third that must resume from the
    # newest checkpoint the second wrote
    end_dir = os.path.join(WF_DIR, "endurance")
    end_args = _script("torch_endurance.py") + [
        "--images", "144", "--ckpt-every", "5", "--log-every", "5",
        "--keep", "3", "--out", end_dir]
    first = _run(end_args + ["--hours", str(40 / 3600)], "endurance 1",
                 300)
    check(first["resumed_from"] is None, f"endurance 1: {first}")
    killed = start(end_args + ["--hours", "1"], "endurance 2")
    window = None
    for line in killed.stdout:
        if line.startswith('{"t"'):
            window = json.loads(line)
            break
    killed.send_signal(signal.SIGKILL)
    killed.communicate(timeout=60)
    check(window is not None, "endurance 2: no window line before its end")
    check(window["step"] > first["global_step"],
          f"endurance 2 did not resume: {window}")
    live = _live_steps(os.path.join(end_dir, "ckpt"))
    check(len(live) <= 3, f"endurance: live checkpoints {live} > keep 3")
    third = _run(end_args + ["--hours", str(10 / 3600)], "endurance 3", 300)
    check(third["resumed_from"] == live[-1],
          f"endurance 3 resumed from {third['resumed_from']}, newest "
          f"checkpoint before the kill {live[-1]}")
    for summ in (first, third):
        check(len(summ["live_ckpts"]) <= 3,
              f"endurance: live checkpoints {summ['live_ckpts']}")
        check(summ["launches"]["gt_maps"] == summ["steps_this_run"],
              f"endurance: K4 {summ['launches']['gt_maps']} launches for "
              f"{summ['steps_this_run']} steps")
    summaries["endurance_1"], summaries["endurance_3"] = first, third
    numbers["endurance"] = {"first": first, "killed_after": window,
                            "live_before_resume": live, "third": third}
    log(f"endurance: {first['steps_this_run']} steps at p50 "
        f"{first['step_s_p50']} s; killed at step {window['step']}; "
        f"resumed from {third['resumed_from']} [{smi}]")

    # 14d. the rehearsal: 400 images of val2017's profile through the eval
    # CLI, the flagship with seeded weights
    cocoval = os.path.join(WF_DIR, "cocoval")
    rh = _run(_script("torch_cocoval_rehearsal.py")
              + ["--n", "400", "--eval", "--batch", "16", "--out", cocoval],
              "rehearsal", 600)
    check(rh["images"] == 400, f"rehearsal: {rh['images']} of 400 images "
                               f"through the pipeline")
    check(rh["n_buckets"] == rh["expected_buckets"],
          f"rehearsal: {rh['n_buckets']} buckets, scale_pad_geometry "
          f"gives {rh['expected_buckets']}")
    numbers["rehearsal"] = rh
    log(f"rehearsal: 400 images, {rh['n_buckets']} buckets, "
        f"{rh['img_per_s']} img/s [{smi}]")

    # 14e. the eval breakdown on that set, the schedule's checkpoint
    bd = _run(_script("torch_eval_breakdown.py")
              + ["--image-dir", os.path.join(cocoval, "images"),
                 "--ann", os.path.join(cocoval, "annotations.json"),
                 "--weight", synth_dir, "--stages", "6", "--batch", "16",
                 "--batches", "4"], "eval breakdown", 300)
    check(bd["batches"] == 4, f"eval breakdown: {bd['batches']} batches")
    summaries["breakdown"] = bd
    numbers["eval_breakdown"] = bd
    log(f"eval breakdown: {bd['ms_per_image']} ms an image [{smi}]")

    # 14f. the crowded bench's two arms on two densities (plumbing: the
    # weights are barely trained; the soak carries the retry)
    cb = _run(_script("torch_crowded_eval_bench.py")
              + ["--ckpt", synth_dir, "--stages", "6", "--size", "184",
                 "--n", "32", "--batch", "16", "--sets", "light,heavy",
                 "--trials", "1", "--out", os.path.join(WF_DIR, "crowded")],
              "crowded bench", 300)
    check(len(cb["rows"]) == 4 and all(r["images"] == 32
                                       for r in cb["rows"]),
          f"crowded bench: {cb['rows']}")
    summaries["crowded"] = cb
    numbers["crowded"] = cb["rows"]

    # 14g. hourglass's chain, then the rescore of its checkpoint
    ch = _finished(chain, "hourglass chain", 600)
    check(ch["model"] == "hourglass" and ch["steps"] == 8,
          f"hourglass chain: {ch}")
    check(ch["launches"]["gt_maps"] >= ch["steps"],
          f"hourglass chain: K4 {ch['launches']['gt_maps']} launches")
    rs = _run(_script("torch_hg_rescore.py")
              + ["--ckpt", chain_dir, "--stages", "2", "--size", "256"],
              "hourglass rescore", 300)
    summaries["hourglass_chain"], summaries["hourglass_rescore"] = ch, rs
    numbers["hourglass"] = {"chain": ch, "rescore": rs}

    for name, proc in soaks.items():
        summ = _finished(proc, name, 900)
        check(summ["count_mismatch"] == 0 and summ["overflow_unfixed"] == 0,
              f"{name}: {summ}")
        summaries[name] = summ
        numbers[name] = summ
        log(f"{name}: {summ['scenes']} scenes, {summ['people']} people, "
            f"{summ['overflows']} overflows (fixed "
            f"{summ['overflow_fixed']}), part diffs "
            f"{[(d['scene'], d['min_gap']) for d in summ['part_diffs']]}, "
            f"{summ['seconds']:.1f} s [{smi}]")
    check(summaries["soak_crowded"]["overflows"] >= 1,
          "soak (crowded): no overflow, the raised caps went unused")

    launches = {k: sum(summ.get("launches", {}).get(k, 0)
                       for summ in summaries.values()) for k in WF_KERNELS}
    for k, n in launches.items():
        check(n > 0, f"workflows: {k} never launched")
    numbers["launches"] = {name: summ.get("launches")
                           for name, summ in summaries.items()}
    shutil.rmtree(WF_DIR)     # ~3 GB of sets and checkpoints
    numbers["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 14 (workflows): {numbers['phase_s']:.1f} s")
    return launches, numbers


# phase 15: the webcam demo over scripted V4L2 devices
WEBCAM_FRAMES = 60     # a format: 60 YUYV frames, then 60 Motion-JPEG ones
WEBCAM_ORACLE_FRAMES = 8
WEBCAM_TEXTS = ("0.0 FPS", "7.1 FPS", "29.9 FPS", "444.4 FPS",
                "12345.6 FPS", "1000000000.0 FPS")


def webcam_phase(dev, smi: str):
    """Phase 15: the webcam demo (``demo/web_demo.py``) on the flagship as
    its CLI builds it (VGG19, 6 stages, 368 px, no flip, bf16, seeded
    weights):

    - ``run_webcam`` over ``demo/camera.py``'s read path on scripted V4L2
      devices (``demo/scripted_camera.py``): 60 rendered 480x640 frames
      (people by scripts/torch_train_synth.py's ``render_scene``) from a
      camera that offers YUYV, then 60 from one that offers only
      Motion-JPEG, into the browser view (``demo/frame_view.py``) while a
      client thread reads ``/stream`` and sends ``/quit`` once the cameras
      are spent: frames, frames/s, p50/p99 ms a frame, the parts the
      client received, and K1, K3 and G once a frame (K2 on a retry);
    - a real ``/dev/video*`` where the machine has one (60 frames), else
      ``open_camera(0)``'s error naming ``/dev/video0``;
    - 8 frames over oracle maps, the drawn frames on the card equal to the
      CPU's bit for bit (a scripted clock, so the FPS text agrees too);
    - ``yuyv_to_bgr`` and ``put_text`` against this machine's cv2.

    -> ({kernel: launches in the timed loop}, numbers)."""
    import argparse
    import contextlib
    import glob
    import http.client
    import io
    import threading

    import torch
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from torch_train_synth import render_scene
    from rtpose_tpu_torch.data.imwrite import encode_bgr
    from rtpose_tpu_torch.demo import camera, picture_demo, web_demo
    from rtpose_tpu_torch.demo.frame_view import FrameView
    from rtpose_tpu_torch.demo.scripted_camera import (ScriptedDevice,
                                                       ScriptedV4L2)
    from rtpose_tpu_torch.infer.pipeline import PosePipeline
    from rtpose_tpu_torch.ops import kernels
    from rtpose_tpu_torch.utils.draw import put_text
    from rtpose_tpu_torch.utils.synth_coco import (OracleMaps, oracle_maps,
                                                   spread_people)

    t_phase = time.perf_counter()
    numbers = {"device": smi}

    class Cameras:
        """The scripted cameras one after the other, as one capture; the
        seconds of each read (the copy out of the device's buffer and the
        conversion to BGR)."""

        def __init__(self, caps):
            self.caps, self.seconds = list(caps), []

        def read(self):
            t = time.perf_counter()
            while self.caps:
                ok, frame = self.caps[0].read()
                if ok:
                    self.seconds.append(time.perf_counter() - t)
                    return ok, frame
                self.caps.pop(0).release()
            return False, None

        def release(self):
            for cap in self.caps:
                cap.release()

    class Timed:
        """`obj` with the seconds of each call of its method `name`."""

        def __init__(self, obj, name):
            self.obj, self.seconds = obj, []
            setattr(self, name, self._timed(getattr(obj, name)))

        def _timed(self, fn):
            def call(*args):
                t = time.perf_counter()
                out = fn(*args)
                self.seconds.append(time.perf_counter() - t)
                return out
            return call

        def close(self):
            self.obj.close()

    class Recording:
        """A view that keeps each frame and asks to quit after `limit`."""

        def __init__(self, limit=None):
            self.shown, self.limit, self.closed = [], limit, False

        def show(self, frame):
            self.shown.append(frame.copy())
            return self.limit is not None and len(self.shown) >= self.limit

        def close(self):
            self.closed = True

    def scripted_clock():
        ticks = iter(100.0 + 0.0371 * np.arange(1, 1000) ** 1.1)
        return lambda: float(next(ticks))

    parser = argparse.ArgumentParser()
    picture_demo.add_common_args(parser)
    with contextlib.redirect_stdout(io.StringIO()):
        pipe = web_demo.build_pipeline(parser.parse_args(
            ["--device", str(dev)]))
    check(pipe.input_size == 368 and not pipe.flip,
          "webcam: the flagship as the CLI builds it")
    frames = [render_scene(np.random.RandomState(1500 + i), 368, 3,
                           height=480, width=640)[0]
              for i in range(2 * WEBCAM_FRAMES)]
    devices = {0: ScriptedDevice(frames[:WEBCAM_FRAMES], offers=("YUYV",)),
               1: ScriptedDevice(frames[WEBCAM_FRAMES:], offers=("MJPG",))}
    for f in frames[:4]:               # cuDNN's first call at this shape
        pipe.run(f)
    syscalls_before = camera.SYSCALLS
    camera.SYSCALLS = ScriptedV4L2(devices)
    try:
        caps = [camera.open_camera(i) for i in (0, 1)]
        check([c.fourcc for c in caps] == ["YUYV", "MJPG"]
              and all((c.width, c.height) == (640, 480) for c in caps),
              f"webcam: scripted cameras opened as "
              f"{[(c.fourcc, c.width, c.height) for c in caps]}")
        view = FrameView("127.0.0.1", 0)
        port = view.server.server_address[1]
        client = {"parts": 0, "quit": None, "error": None}

        def read_stream():
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=60)
                conn.request("GET", "/stream")
                resp = conn.getresponse()
                while True:
                    if resp.readline() != b"--frame\r\n":
                        break
                    size = 0
                    while True:
                        line = resp.readline().strip()
                        if not line:
                            break
                        if line.lower().startswith(b"content-length:"):
                            size = int(line.split(b":")[1])
                    if len(resp.read(size + 2)) != size + 2:
                        break
                    client["parts"] += 1
                    if (client["quit"] is None and devices[1].served
                            == WEBCAM_FRAMES):
                        q = http.client.HTTPConnection("127.0.0.1", port,
                                                       timeout=10)
                        q.request("GET", "/quit")
                        client["quit"] = q.getresponse().status
                        q.close()
                conn.close()
            except OSError as e:       # the view closed under a request
                client["error"] = repr(e)

        reader = threading.Thread(target=read_stream, daemon=True)
        reader.start()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        cams, timed_pipe = Cameras(caps), Timed(pipe, "run")
        timed_view = Timed(view, "show")
        n, times = web_demo.run_webcam(timed_pipe, cams, timed_view)
        loop_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        reader.join(timeout=30)
        check(not reader.is_alive(), "webcam: the stream client still reads")
    finally:
        camera.SYSCALLS = syscalls_before
    check(n == 2 * WEBCAM_FRAMES and not any(d.open or d.streaming
                                             for d in devices.values()),
          f"webcam: {n} frames shown of {2 * WEBCAM_FRAMES}, devices left "
          f"open {[d.open for d in devices.values()]}")
    check(client["parts"] > 0, f"webcam: the stream client got no part "
                               f"({client})")
    encode_s = []
    for _ in range(20):
        t = time.perf_counter()
        encode_bgr(frames[-1], ".jpg")
        encode_s.append(time.perf_counter() - t)
    served = counts["connection_scores"]
    check(all(counts[k] == served >= n for k in SERVING_KERNELS)
          and counts["gt_maps"] == 0,
          f"webcam: K1, K3 and G not once a frame (+1 a retry): {counts}")
    numbers["loop"] = {
        "frames": n, "yuyv_frames": WEBCAM_FRAMES,
        "mjpeg_frames": WEBCAM_FRAMES, "seconds": loop_s,
        "frames_per_s": n / sum(times),
        "p50_ms": percentile_ms(times, 50), "p99_ms": percentile_ms(times, 99),
        "stream_parts_received": client["parts"],
        "quit_status": client["quit"], "client_error": client["error"],
        "ended_on": "quit" if view.quit_requested else "end of frames",
        "retry_launches": served - n,
        # p50 ms of each step of a frame: the capture's read and
        # conversion, PosePipeline.run (host resize, upload, forward,
        # decode, one readback), the view's show (a copy); the rest is
        # draw_people and put_text
        "p50_ms_read": percentile_ms(cams.seconds, 50),
        "p50_ms_yuyv_read": percentile_ms(cams.seconds[:WEBCAM_FRAMES], 50),
        "p50_ms_mjpeg_read": percentile_ms(cams.seconds[WEBCAM_FRAMES:], 50),
        "p50_ms_run": percentile_ms(timed_pipe.seconds, 50),
        "p99_ms_run": percentile_ms(timed_pipe.seconds, 99),
        "p50_ms_show": percentile_ms(timed_view.seconds, 50),
        # the view's JPEG encode of a frame (in the stream's thread)
        "p50_ms_encode": percentile_ms(encode_s, 50)}

    # a real camera, where the machine has one
    videos = sorted(glob.glob("/dev/video*"))
    numbers["dev_video"] = videos
    if videos:
        index = int(videos[0][len("/dev/video"):])
        view = Recording(WEBCAM_FRAMES)
        n_real, real_times = web_demo.run_webcam(
            pipe, camera.open_camera(index), view)
        check(n_real == WEBCAM_FRAMES, f"webcam: {videos[0]} gave {n_real} "
                                       f"frames")
        numbers["real_camera"] = {"device": videos[0], "frames": n_real,
                                  "p50_ms": percentile_ms(real_times, 50)}
    else:
        try:
            camera.open_camera(0).release()
        except RuntimeError as e:
            check("/dev/video0" in str(e), f"webcam: open_camera(0) raised "
                                           f"{e!r}")
            numbers["no_camera_error"] = str(e)
        else:
            check(False, "webcam: open_camera(0) opened without /dev/video0")
    del pipe

    # card == CPU on oracle maps: the drawn frames bit for bit
    rng = np.random.RandomState(15)
    maps = oracle_maps({(480, 640): spread_people(rng, 2, 480, 640)}, 368)
    drawn = {}
    for d in (dev, "cpu"):
        camera.SYSCALLS = ScriptedV4L2({0: ScriptedDevice(
            frames[:WEBCAM_ORACLE_FRAMES], offers=("YUYV",))})
        try:
            view = Recording()
            web_demo.run_webcam(
                PosePipeline(OracleMaps(maps), device=d, input_size=368,
                             flip=False),
                camera.open_camera(0), view, clock=scripted_clock())
        finally:
            camera.SYSCALLS = syscalls_before
        drawn[str(d)] = view.shown
    card, cpu = drawn[str(dev)], drawn["cpu"]
    differ = [i for i, (a, b) in enumerate(zip(card, cpu))
              if not np.array_equal(a, b)]
    check(len(card) == len(cpu) == WEBCAM_ORACLE_FRAMES and not differ,
          f"webcam: card frames differ from the CPU's at {differ}")
    check(all(not np.array_equal(f, g) for f, g in
              zip(card, frames[:WEBCAM_ORACLE_FRAMES])),
          "webcam: a frame came back undrawn")
    numbers["card_vs_cpu"] = {"frames": len(card), "differing_frames": 0}

    # this machine's cv2, where it has one
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        rng = np.random.RandomState(7)
        yuyv_diff = 0
        for w in (2, 34, 640):
            buf = rng.randint(0, 256, (48, w, 2)).astype(np.uint8)
            want = cv2.cvtColor(buf, cv2.COLOR_YUV2BGR_YUYV)
            got = camera.yuyv_to_bgr(buf.tobytes(), 48, w)
            yuyv_diff += int((got != want).any(-1).sum())
        text_diff = {}
        for text in WEBCAM_TEXTS:
            want = rng.randint(0, 256, (48, 320, 3)).astype(np.uint8)
            got = want.copy()
            cv2.putText(want, text, (10, 30), cv2.FONT_HERSHEY_SIMPLEX, 1.0,
                        (0, 255, 0), 2)
            put_text(got, text, (10, 30), (0, 255, 0), 2)
            text_diff[text] = int((got != want).any(-1).sum())
        numbers["cv2"] = {"version": cv2.__version__,
                          "yuyv_differing_pixels": yuyv_diff,
                          "text_differing_pixels": text_diff}
        check(yuyv_diff == 0, f"webcam: yuyv_to_bgr differs from cv2 "
                              f"{cv2.__version__} at {yuyv_diff} pixels")
        # the glyph table is cv2 5's drawing of the font; cv2 4 draws
        # the same font face as Hershey strokes, another picture
        if int(cv2.__version__.split(".")[0]) >= 5:
            check(not any(text_diff.values()),
                  f"webcam: put_text differs from cv2 {cv2.__version__}: "
                  f"{text_diff}")
    numbers["phase_s"] = time.perf_counter() - t_phase
    loop = numbers["loop"]
    log(f"phase 15 (webcam): {n} frames 480x640 ({WEBCAM_FRAMES} YUYV, "
        f"{WEBCAM_FRAMES} Motion-JPEG) through run_webcam at "
        f"{loop['frames_per_s']:.2f} frames/s, p50 {loop['p50_ms']:.2f} ms, "
        f"p99 {loop['p99_ms']:.2f} ms a frame (p50 read "
        f"{loop['p50_ms_read']:.2f}, run {loop['p50_ms_run']:.2f}, show "
        f"{loop['p50_ms_show']:.2f}; the view's encode "
        f"{loop['p50_ms_encode']:.2f}); the stream client got "
        f"{client['parts']} parts, ended on {loop['ended_on']}; launches "
        f"{counts} [{smi}]")
    log(f"webcam: /dev/video* {videos or 'absent'}; card == CPU on "
        f"{len(card)} oracle frames; cv2 {numbers.get('cv2')}; phase "
        f"{numbers['phase_s']:.1f} s")
    return counts, numbers


VIDEO_FILE_FRAMES = 64     # the H.264 MP4 the flagship video demo reads
VIDEO_FILE_SHAPE = (480, 640)
YUV_KERNEL_TOL = 0         # yuv420_to_bgr vs its plain version: integers


def video_files_phase(dev, smi: str):
    """Phase 16: the video reader on the files users hand the JAX demo.

    - the route probe (``scripts/torch_probe_video.py``): NVDEC's caps for
      H.264 and MPEG-4 at 640x480, and the OpenCV wheel's libavcodec;
    - an I_PCM H.264 MP4 of 8 distinct 480x640 pictures (P-skip repeats,
      an IDR every 4, ``demo/scripted_video.py``): libavcodec's planes
      equal the written Y, U and V exactly, and ``open_video`` on the
      card gives the plain conversion of them at every rotation;
    - ``yuv420_to_bgr`` against its plain version at all four rotations
      on a decoded frame's planes, error 0, timed with its bound;
    - an ``mp4v`` MP4 and an XVID AVI written by this machine's cv2:
      ``open_video`` gives cv2's frame count, and the largest pixel
      difference from cv2's frames;
    - the flagship video demo's ``main()`` (VGG19, 6 stages, 368 px,
      flip, bf16) on a 64-frame 480x640 H.264 MP4 at --batch 8:
      frames/s, read ms a frame split into demux, decode and convert, K1,
      K3 and G once a batch and the conversion once a frame; the reader
      alone on a 64-frame cv2 ``mp4v`` MP4 of the same scenes;
    - MPEG-TS (ROADMAP.md item 4b): this machine's cv2 MPEG-2, MPEG-1 and
      MPEG-4 ``.ts`` and MPEG-2 ``.m2ts``; I_PCM H.264 TS of known pixels
      in 188- and 192-byte packets with a frame over two PES and two
      frames in one PES, and with B pictures; fragmented MP4 (a ``moof``
      a sample, and a GOP) and MP4s with a leading empty edit and with two
      media edits (item 4c): frames 0 pixels from cv2's, fps and count
      cv2's;
    - the flagship video demo on a 64-frame MPEG-4 MKV and on a 64-frame
      MPEG-2 TS of cv2's, writing XVID, read ms a frame split into demux,
      parse (TS), decode and convert;
    - HEVC (item 4e) and MPEG program streams (item 4g): the probe's
      ``hevc`` decoder and parser (and what reads AV1, item 4f);
      libavcodec's planes of a PCM HEVC stream (``demo/scripted_video.py``
      ``encode_hevc_pcm``) equal to the written ones; PCM HEVC in MP4
      ``hvc1`` / ``hev1``, Matroska, TS and M2TS, reordered and cropped;
      this machine's cv2's MPEG-4 / MPEG-1 / MPEG-2 ``.mpg`` and MPEG-4
      ``.vob``; I_PCM H.264 and PCM HEVC program streams with and
      without a map: frames 0 pixels from cv2's, fps and count cv2's;
    - the flagship video demo on a 64-frame 480x640 PCM HEVC MP4, writing
      XVID (its launches are the phase's);
    - colour (items 4h, 4i): the probe's colour part (the codec context's
      options, what the decoder settles and how this machine's cv2
      converts each fixture); ``yuv420_to_bgr`` with each (matrix, range)'s
      constants and ``yuv420p10_to_bgr`` against their plain versions at
      four turns on 480x640 planes, error 0, the 10-bit kernel timed with
      its bound; small fixtures that state their colour (H.264 and HEVC
      VUI in MP4, Matroska and TS, ``colr`` / ``Colour`` with and without
      a VUI, the two disagreeing; PCM HEVC Main 10, H.264 High 10, VP9
      profile 2) read on the card: equal to the CPU's frames, and to this
      machine's cv2 where the probe found it converting by the same rule
      (else its largest difference printed); the flagship video demo on a
      64-frame 480x640 PCM HEVC Main 10 MP4 tagged BT.2020 (matrix 9)
      limited range, its launches the 10-bit row's;
    - an open without the library, and one without a card, raise.

    -> ({kernel: launches in the HEVC MP4 demo run}, numbers, the
    conversion's kernel row, the 10-bit conversion's kernel row)."""
    import contextlib
    import io
    import tempfile

    import torch
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from torch_probe_video import colour_fixtures, probe
    from rtpose_tpu_torch.data.imread_fixtures import render_scene
    from rtpose_tpu_torch.demo import mp4, video_demo, video_io
    from rtpose_tpu_torch.demo import scripted_video as sv
    from rtpose_tpu_torch.native import avcodec
    from rtpose_tpu_torch.ops import kernels

    t_phase = time.perf_counter()
    numbers = {"device": smi, "probe": probe()}
    log(f"phase 16 (video files): route probe {json.dumps(numbers['probe'])}")
    found = numbers["probe"]["libavcodec"]
    writer_probe = numbers["probe"]["writer"]
    check(found.get("vp9") == "opens", f"video files: this machine's "
          f"libavcodec gives no vp9 decoder: {found.get('vp9')}")
    check(found.get("mpeg1video") == found.get("mpeg2video")
          == found.get("hevc") == "opens"
          and len(found.get("parsers", {})) == len(avcodec.PARSERS)
          and all(v.endswith("initialises")
                  for v in found["parsers"].values()),
          f"video files: MPEG-1/2 or HEVC decoders or parsers missing: "
          f"{found}")
    log(f"phase 16 (video files): decoders mpeg1video "
        f"{found.get('mpeg1video')}, mpeg2video {found.get('mpeg2video')}, "
        f"hevc {found.get('hevc')}; refused codec av1 {found.get('av1')}; "
        f"parsers {json.dumps(found.get('parsers'))}; AV1 probe "
        f"{json.dumps(numbers['probe'].get('av1'))} [{smi}]")
    check(writer_probe.get("encoder") == "opens"
          and all(writer_probe.get("options", {}).values()),
          f"video files: the XVID writer's mpeg4 encoder, options or "
          f"swscale are missing: {writer_probe}")
    colour_probe = numbers["probe"]["colour"]
    check(colour_probe.get("options") and all(
        colour_probe["options"].values()), f"video files: the codec "
        f"context lacks a colour option the reader sets and reads: "
        f"{colour_probe.get('options')} (libavutil "
        f"{colour_probe.get('avutil_major')})")
    # where this machine's cv2 converts each probe fixture by the port's
    # rule (0 levels apart); the files below are held against cv2 there
    cv2_follows = {name: entry.get("rule") == 0 for name, entry in
                   colour_probe.get("files", {}).items()}
    log(f"phase 16 (video files): colour probe: options "
        f"{json.dumps(colour_probe.get('options'))}, libavutil "
        f"{colour_probe.get('avutil_major')}, cv2 "
        f"{colour_probe.get('cv2')}; cv2 vs the port's rule / BT.601 "
        f"limited, max abs level: "
        + json.dumps({k: [v.get("rule"), v.get("bt601"), v.get("centre"),
                          v.get("nearest8"), v.get("error")]
                      for k, v in colour_probe.get("files", {}).items()})
        + f" [{smi}]")
    h, w = VIDEO_FILE_SHAPE
    work = tempfile.mkdtemp(dir=os.path.join(ROOT, "rtpose_tpu_torch",
                                             "build"))
    argv = sys.argv
    try:
        # libavcodec's planes of the I_PCM stream == the written ones
        pics = sv.yuv_frames(6, h, w, seed=16)
        seq = [pics[0], pics[1], None, pics[2], pics[3], None, pics[4],
               pics[5]]
        shown = []
        for p in seq:
            shown.append(shown[-1] if p is None else p)
        ipcm = os.path.join(work, "ipcm.mp4")
        sv.write_ipcm_mp4(ipcm, seq, key_every=4)
        decoder = avcodec.Decoder("h264")
        got = []
        with open(ipcm, "rb") as f:
            track = mp4.read_track(ipcm, f)
            for data, key in track.packets(f):
                got += [[p[:(h if i == 0 else h // 2),
                           :(width if i == 0 else width // 2)].copy()
                         for i, p in enumerate(planes)]
                        for *planes, width in decoder.decode(data, key)]
            got += [[p[:(h if i == 0 else h // 2),
                       :(width if i == 0 else width // 2)].copy()
                     for i, p in enumerate(planes)]
                    for *planes, width in decoder.flush()]
        decoder.close()
        exact = len(got) == len(seq) and all(
            all(np.array_equal(a, b) for a, b in zip(g, s))
            for g, s in zip(got, shown))
        check(exact, f"video files: libavcodec's planes of the I_PCM MP4 "
                     f"differ from the written ones ({len(got)} pictures "
                     f"of {len(seq)})")
        numbers["ipcm_exact"] = {"pictures": len(got), "equal": exact}

        # open_video on the card at every rotation == the plain conversion
        rotated = {}
        for rot in kernels.ROTATIONS:
            path = os.path.join(work, f"ipcm{rot}.mp4")
            sv.write_ipcm_mp4(path, seq, key_every=4, rotation=rot)
            cap = video_io.open_video(path, device=dev)
            frames = []
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                frames.append(frame)
            cap.release()
            want = [kernels.yuv420_to_bgr_plain(
                *map(torch.from_numpy, s), width=w, rotation=rot).numpy()
                for s in shown]
            rotated[rot] = int(sum(not np.array_equal(a, b)
                                   for a, b in zip(frames, want)))
            check(len(frames) == len(seq) == cap.frame_count
                  and cap.size == ((h, w) if rot % 180 else (w, h))
                  and not rotated[rot],
                  f"video files: rotation {rot}: {len(frames)} frames, size "
                  f"{cap.size}, {rotated[rot]} differ from plain")
        numbers["open_video_rotations_differing_frames"] = rotated

        # the kernel against its plain version, four turns, and its time
        planes = [torch.from_numpy(np.ascontiguousarray(p)).to(dev)
                  for p in pics[0]]
        errs = {}
        for rot in kernels.ROTATIONS:
            k = kernels.yuv420_to_bgr(*planes, width=w, rotation=rot)
            p = kernels.yuv420_to_bgr_plain(*planes, width=w, rotation=rot)
            torch.cuda.synchronize()
            errs[rot] = int((k.int() - p.int()).abs().max())
        check(all(e <= YUV_KERNEL_TOL for e in errs.values()),
              f"yuv420_to_bgr vs plain: max abs err {errs}")
        timing = {}
        for rot in (0, 90):
            def kernel():
                return kernels.yuv420_to_bgr(*planes, width=w, rotation=rot)

            def plain():
                return kernels.yuv420_to_bgr_plain(*planes, width=w,
                                                   rotation=rot)
            ms, plain_ms = paired_ms(kernel, plain, 50)
            dev_ms, source = device_ms(kernel, "yuv420_to_bgr")
            timing[rot] = dict(ms=ms, plain_ms=plain_ms, device_ms=dev_ms,
                               device_ms_source=source,
                               host_ms=host_ms(kernel))
        n_bytes = h * w * 3 // 2 + h * w * 3
        bound_ms, bound_by = bound(n_bytes, 0)
        row = dict(
            name="yuv420_to_bgr", route="cuda",
            source="rtpose_tpu_torch/csrc/yuv420_to_bgr.cu",
            replaces="none: the yuv420p -> bgr24 conversion and turn inside "
                     "cv2.VideoCapture (rtpose_tpu/demo/video_demo.py:19)",
            replaces_kind="cv2/swscale; no Pallas kernel",
            max_abs_err=max(errs.values()), max_abs_err_by_rotation=errs,
            **timing[0], rotation_90=timing[90], bound_ms=bound_ms,
            bound_by=bound_by, bytes=n_bytes, shape=[h, w],
            library_ms=None)
        log(f"yuv420_to_bgr 480x640: equal to plain at rotations {errs}; "
            f"kernel {timing[0]['ms']:.4f} ms (90: {timing[90]['ms']:.4f}), "
            f"device {timing[0]['device_ms']:.4f} ms "
            f"({timing[0]['device_ms_source']}), host "
            f"{timing[0]['host_ms']:.4f} ms a call, plain "
            f"{timing[0]['plain_ms']:.4f} ms; bound {bound_ms:.5f} ms "
            f"({n_bytes} bytes) [{smi}]")

        # the 8-bit kernel with each (matrix, range)'s constants, and the
        # 10-bit kernel, against their plain versions on the CPU, 4 turns
        planes_cpu = [p.cpu() for p in planes]
        pairs = [(m, f) for m in (2, 1, 4, 7, 9) for f in (False, True)]
        colour_errs, p10_errs = {}, {}
        p10_cpu = [torch.from_numpy(np.ascontiguousarray(p))
                   for p in sv.yuv_frames10(1, h, w, seed=19)[0]]
        p10 = [p.to(dev) for p in p10_cpu]
        for m, f in pairs:
            rule = kernels.yuv_rule(m, f)
            for rot in kernels.ROTATIONS:
                k = kernels.yuv420_to_bgr(*planes, width=w, rotation=rot,
                                          rule=rule).cpu()
                p = kernels.yuv420_to_bgr_plain(*planes_cpu, width=w,
                                                rotation=rot, rule=rule)
                colour_errs[f"{m}{'F' if f else 'L'}{rot}"] = int(
                    (k.int() - p.int()).abs().max())
                k = kernels.yuv420p10_to_bgr(*p10, width=w, rotation=rot,
                                             rule=rule).cpu()
                p = kernels.yuv420p10_to_bgr_plain(*p10_cpu, width=w,
                                                   rotation=rot, rule=rule)
                p10_errs[f"{m}{'F' if f else 'L'}{rot}"] = int(
                    (k.int() - p.int()).abs().max())
        check(all(e <= YUV_KERNEL_TOL for e in colour_errs.values())
              and all(e <= YUV_KERNEL_TOL for e in p10_errs.values()),
              f"conversion kernels vs plain, by (matrix, range, turn): "
              f"8-bit {colour_errs}, 10-bit {p10_errs}")
        p10_timing = {}
        rule = kernels.yuv_rule(9, False)
        for rot in (0, 90):
            def kernel():
                return kernels.yuv420p10_to_bgr(*p10, width=w, rotation=rot,
                                                rule=rule)

            def plain():
                return kernels.yuv420p10_to_bgr_plain(*p10, width=w,
                                                      rotation=rot, rule=rule)
            ms, plain_ms = paired_ms(kernel, plain, 20)
            dev_ms, source = device_ms(kernel, "yuv420p10_to_bgr")
            p10_timing[rot] = dict(ms=ms, plain_ms=plain_ms, device_ms=dev_ms,
                                   device_ms_source=source,
                                   host_ms=host_ms(kernel))
        p10_bytes = h * w * 2 * 3 // 2 + h * w * 3
        p10_bound_ms, p10_bound_by = bound(p10_bytes, 0)
        p10_row = dict(
            name="yuv420p10_to_bgr", route="cuda",
            source="rtpose_tpu_torch/csrc/yuv420p10_to_bgr.cu",
            replaces="none: the yuv420p10le -> bgr24 conversion (swscale's "
                     "general path, SWS_BICUBIC) and turn inside "
                     "cv2.VideoCapture (rtpose_tpu/demo/video_demo.py:19)",
            replaces_kind="cv2/swscale; no Pallas kernel",
            max_abs_err=max(p10_errs.values()),
            max_abs_err_by_colour_and_rotation=p10_errs,
            **p10_timing[0], rotation_90=p10_timing[90],
            bound_ms=p10_bound_ms, bound_by=p10_bound_by, bytes=p10_bytes,
            shape=[h, w], rule="BT.2020 limited, chroma left",
            library_ms=None)
        row["max_abs_err_by_colour_and_rotation"] = colour_errs
        log(f"conversion kernels 480x640 == plain for every (matrix, range) "
            f"at four turns: 8-bit max {max(colour_errs.values())}, 10-bit "
            f"max {max(p10_errs.values())}; yuv420p10_to_bgr kernel "
            f"{p10_timing[0]['ms']:.4f} ms (90: {p10_timing[90]['ms']:.4f}), "
            f"device {p10_timing[0]['device_ms']:.4f} ms "
            f"({p10_timing[0]['device_ms_source']}), host "
            f"{p10_timing[0]['host_ms']:.4f} ms a call, plain "
            f"{p10_timing[0]['plain_ms']:.4f} ms; bound "
            f"{p10_bound_ms:.5f} ms ({p10_bytes} bytes) [{smi}]")

        # MPEG-4 Part 2 written by this machine's cv2 (the port has none)
        scenes = [np.ascontiguousarray(render_scene(1600 + i, h, w)[..., ::-1])
                  for i in range(VIDEO_FILE_FRAMES)]
        try:
            import cv2
        except ImportError:
            cv2 = None
        mpeg4 = {}
        if cv2 is not None:
            for name, fourcc in (("mp4v.mp4", "mp4v"), ("xvid.avi", "XVID")):
                path = os.path.join(work, name)
                writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(
                    *fourcc), 20.0, (w, h))
                for frame in scenes[:16]:
                    writer.write(frame)
                writer.release()
                want = []
                cv = cv2.VideoCapture(path)
                count = int(cv.get(cv2.CAP_PROP_FRAME_COUNT))
                while True:
                    ok, frame = cv.read()
                    if not ok:
                        break
                    want.append(frame)
                cv.release()
                cap = video_io.open_video(path, device=dev)
                frames = []
                while True:
                    ok, frame = cap.read()
                    if not ok:
                        break
                    frames.append(frame)
                cap.release()
                diff = max(int(np.abs(a.astype(np.int16) - b).max())
                           for a, b in zip(frames, want))
                mpeg4[name] = {"frames": len(frames), "cv2_frames": len(want),
                               "cv2_frame_count": count,
                               "frame_count": cap.frame_count,
                               "max_pixel_diff_vs_cv2": diff,
                               "cv2": cv2.__version__}
                check(len(frames) == len(want) == count == cap.frame_count
                      == 16, f"video files: {name}: {mpeg4[name]}")
        numbers["mpeg4"] = mpeg4 or "no cv2 on this machine"
        check(cv2 is not None, "video files: no cv2 on this machine")

        def read_all(cap):
            frames = []
            while True:
                ok, frame = cap.read()
                if not ok:
                    return frames
                frames.append(frame)

        def against_cv2(path, count_is_frames=True):
            """open_video on the card against this machine's cv2 (the frame
            count cv2's, and the frames' own where `count_is_frames`)."""
            cv = cv2.VideoCapture(path)
            cv.set(cv2.CAP_PROP_ORIENTATION_AUTO, 1)
            count, fps = (int(cv.get(cv2.CAP_PROP_FRAME_COUNT)),
                          cv.get(cv2.CAP_PROP_FPS))
            want = read_all(cv)
            cv.release()
            cap = video_io.open_video(path, device=dev)
            got = read_all(cap)
            cap.release()
            diff = max((int(np.abs(a.astype(np.int16) - b).max())
                        for a, b in zip(got, want)), default=-1)
            out = {"frames": len(got), "cv2_frames": len(want),
                   "frame_count": cap.frame_count, "cv2_frame_count": count,
                   "fps": cap.fps, "cv2_fps": fps,
                   "max_pixel_diff_vs_cv2": diff}
            check(len(got) == len(want) and count == cap.frame_count
                  and (count == len(got) or not count_is_frames)
                  and fps == cap.fps and diff == 0,
                  f"video files: {os.path.basename(path)} against cv2 "
                  f"{cv2.__version__}: {out}")
            return out, got

        # Matroska / WebM and VP9 against this machine's cv2
        mkv_files = {}
        t0 = time.perf_counter()
        mkv_files["vp9_64x48.webm"], _ = against_cv2(sv.VP9_WEBM)
        superframe = os.path.join(work, "superframe.webm")
        sv.write_vp9_superframe(sv.VP9_WEBM, superframe)
        mkv_files["superframe.webm"], _ = against_cv2(superframe)
        for name, fourcc in (("xvid.mkv", "XVID"), ("vp9.webm", "VP90"),
                             ("vp9.mp4", "VP90")):
            path = os.path.join(work, name)
            try:
                sv.write_cv2_video(path, fourcc, 16, h, w)
            except RuntimeError as e:      # the wheel may lack libvpx
                check(fourcc == "VP90", f"video files: {e}")
                mkv_files[name] = f"not written: {e}"
                continue
            mkv_files[name], _ = against_cv2(path)
        # I_PCM H.264 in Matroska, known and unknown sizes: the planes
        for name, kw in (("ipcm.mkv", {}),
                         ("ipcm_live.mkv", dict(unknown_sizes=True))):
            path = os.path.join(work, name)
            sv.write_ipcm_mkv(path, seq, key_every=4, **kw)
            mkv_files[name], frames = against_cv2(path)
            want = [kernels.yuv420_to_bgr_plain(
                *map(torch.from_numpy, p), width=w).numpy() for p in shown]
            mkv_files[name]["differing_from_written"] = int(sum(
                not np.array_equal(a, b) for a, b in zip(frames, want)))
            check(not mkv_files[name]["differing_from_written"],
                  f"video files: {name}: {mkv_files[name]}")
        # B-frame H.264, with and without the reorder hint: cv2's order
        anchors = sv.yuv_frames(5, h, w, seed=17)
        for name, reorder, step in (("bframes.mp4", 1, 2),
                                    ("bframes_nohint.mp4", None, 1),
                                    ("bframes_nohint.mkv", None, 1)):
            path = os.path.join(work, name)
            bshown = sv.write_bframes(path, anchors, reorder=reorder,
                                      poc_step=step,
                                      container=name.rsplit(".", 1)[1])
            mkv_files[name], frames = against_cv2(path)
            want = [kernels.yuv420_to_bgr_plain(
                *map(torch.from_numpy, p), width=w).numpy() for p in bshown]
            mkv_files[name]["differing_from_known"] = int(sum(
                not np.array_equal(a, b) for a, b in zip(frames, want)))
            check(len(frames) == len(bshown) and not mkv_files[name][
                "differing_from_known"], f"video files: {name}: "
                                         f"{mkv_files[name]}")
        mkv_files["seconds"] = time.perf_counter() - t0
        numbers["matroska_vp9_bframes"] = mkv_files
        log(f"video files: Matroska / VP9 / B-frames against cv2 "
            f"{cv2.__version__}: {json.dumps(mkv_files)} [{smi}]")

        # MPEG-TS, fragmented MP4 and edit lists against this machine's cv2
        t0 = time.perf_counter()
        ts_files = {}
        for name, fourcc in (("mpeg2.ts", "MPG2"), ("mpeg1.ts", "PIM1"),
                             ("mpeg4.ts", "mp4v"), ("mpeg2.m2ts", "MPG2")):
            path = os.path.join(work, name)
            sv.write_cv2_video(path, fourcc, 16, h, w, fps=25.0)
            # libavformat reports MPEG-1 at twice its rate, and so its count
            ts_files[name], _ = against_cv2(path, fourcc != "PIM1")

        def known(name, frames, pictures, table=None):
            table = ts_files if table is None else table
            want = [kernels.yuv420_to_bgr_plain(
                *map(torch.from_numpy, p), width=p[0].shape[1]).numpy()
                for p in pictures]
            table[name]["differing_from_known"] = int(sum(
                not np.array_equal(a, b) for a, b in zip(frames, want))) + \
                abs(len(frames) - len(want))
            check(not table[name]["differing_from_known"],
                  f"video files: {name}: {table[name]}")

        for name, kw in (("ipcm_split.ts", dict(split=(1, 5))),
                         ("ipcm_joined.m2ts", dict(
                             packet_size=192, pes_per_frame=2, split=(4,)))):
            path = os.path.join(work, name)
            sv.write_ipcm_ts(path, seq, key_every=4, **kw)
            ts_files[name], frames = against_cv2(path, "joined" not in name)
            known(name, frames, shown)
        path = os.path.join(work, "bframes.ts")
        bshown = sv.write_bframes_ts(path, anchors, reorder=None, poc_step=1)
        # its last PES (a B picture) ends the tail's span a frame early
        ts_files["bframes.ts"], frames = against_cv2(path, False)
        known("bframes.ts", frames, bshown)
        sps_nal, pps_nal, units, keys = sv.encode_ipcm(seq, key_every=4)
        frame_ms = 40                          # 512 / 12800 s
        for name, data, pictures, is_count in (
                ("fragment_a_sample.mp4", sv.mux_fmp4(
                    sps_nal, pps_nal, units, keys, (w, h)), shown, True),
                ("fragment_a_gop.mp4", sv.mux_fmp4(
                    sps_nal, pps_nal, units, keys, (w, h), fragment="gop",
                    base="implicit", styp=True, sidx=True), shown, True),
                ("edit_leading_empty.mp4", sv.mux_mp4(
                    sps_nal, pps_nal, units, keys, (w, h), edits=[
                        (200, -1, 1.0), (8 * frame_ms, 0, 1.0)]),
                 shown, True),
                ("edit_two_media.mp4", sv.mux_mp4(
                    sps_nal, pps_nal, units, keys, (w, h), edits=[
                        (3 * frame_ms, 0, 1.0),
                        (3 * frame_ms, 5 * 512, 1.0)]),
                 shown[:3] + shown[5:8], False)):
            path = os.path.join(work, name)
            with open(path, "wb") as f:
                f.write(data)
            ts_files[name], frames = against_cv2(path, is_count)
            known(name, frames, pictures)
        ts_files["seconds"] = time.perf_counter() - t0
        numbers["mpegts_fmp4_edits"] = ts_files
        log(f"video files: MPEG-TS / fragmented MP4 / edit lists against "
            f"cv2 {cv2.__version__}: {json.dumps(ts_files)} [{smi}]")

        # HEVC (item 4e) and MPEG program streams (item 4g) against this
        # machine's cv2; libavcodec's planes of PCM HEVC == the written ones
        t0 = time.perf_counter()
        hevc = sv.encode_hevc_pcm(seq, key_every=4)
        decoder, parser = avcodec.Decoder("hevc"), avcodec.Parser("hevc")
        got = []
        for frame in parser.parse(sv.hevc_annexb(hevc)) + parser.flush() \
                + [None]:
            pictures = (decoder.flush() if frame is None
                        else decoder.decode(frame))
            got += [[p[:(h if i == 0 else h // 2),
                       :(width if i == 0 else width // 2)].copy()
                     for i, p in enumerate(planes)]
                    for *planes, width in pictures]
        decoder.close()
        parser.close()
        exact = len(got) == len(seq) and all(
            all(np.array_equal(a, b) for a, b in zip(g, s))
            for g, s in zip(got, shown))
        check(exact, f"video files: libavcodec's planes of the PCM HEVC "
                     f"stream differ from the written ones ({len(got)} "
                     f"pictures of {len(seq)})")
        numbers["hevc_pcm_exact"] = {"pictures": len(got), "equal": exact}
        hevc_files = {}
        reordered = sv.encode_hevc_pcm(sv.yuv_frames(5, h, w, seed=18),
                                       reorder=True)
        cropped = sv.encode_hevc_pcm(sv.yuv_frames(3, h - 6, w - 6, seed=19))
        for name, write, stream, kw in (
                ("hvc1.mp4", sv.write_hevc_mp4, hevc, {}),
                ("hev1.mp4", sv.write_hevc_mp4, hevc, dict(kind="hev1")),
                ("hevc.mkv", sv.write_hevc_mkv, hevc, {}),
                ("hevc.ts", sv.write_hevc_ts, hevc, {}),
                ("hevc.m2ts", sv.write_hevc_ts, hevc, dict(packet_size=192)),
                ("hevc_reordered.mp4", sv.write_hevc_mp4, reordered, {}),
                ("hevc_reordered.ts", sv.write_hevc_ts, reordered, {}),
                ("hevc_cropped.mkv", sv.write_hevc_mkv, cropped, {}),
                ("hevc.mpg", sv.write_hevc_ps, hevc, {}),
                ("hevc_psm.vob", sv.write_hevc_ps, hevc,
                 dict(psm=True, dvd=True))):
            path = os.path.join(work, name)
            write(path, stream, **kw)
            # the reordered TS's last PES (POC 3) ends the tail's span a
            # frame early, as the B-frame TS's does
            hevc_files[name], frames = against_cv2(
                path, name != "hevc_reordered.ts")
            known(name, frames, stream.shown, hevc_files)
        for name, kw in (("h264.mpg", {}),
                         ("h264_psm_mpeg1.mpg", dict(psm=True, mpeg2=False))):
            path = os.path.join(work, name)
            sv.write_ipcm_ps(path, seq, key_every=4, **kw)
            hevc_files[name], frames = against_cv2(path)
            known(name, frames, shown, hevc_files)
        for name, fourcc in (("cv2_mpeg4.mpg", "mp4v"),
                             ("cv2_mpeg1.mpg", "PIM1"),
                             ("cv2_mpeg2.mpg", "MPG2"),
                             ("cv2_mpeg4.vob", "mp4v")):
            path = os.path.join(work, name)
            sv.write_cv2_video(path, fourcc, 16, h, w, fps=25.0)
            # libavformat's duration from the tail counts fewer frames
            # than an MPEG-1/2 program stream holds
            hevc_files[name], _ = against_cv2(path, False)
        hevc_files["seconds"] = time.perf_counter() - t0
        numbers["hevc_program_streams"] = hevc_files
        log(f"video files: HEVC and MPEG program streams against cv2 "
            f"{cv2.__version__}: {json.dumps(hevc_files)} [{smi}]")

        # colour (items 4h, 4i): small fixtures that state their colour,
        # read on the card == on the CPU, == cv2 where it keeps the rule
        t0 = time.perf_counter()
        colour_files = {}
        colour_dir = os.path.join(work, "colour")
        os.makedirs(colour_dir)
        for name, path in colour_fixtures(colour_dir):
            got, plain, want = [], [], []
            for frames, cap in (
                    (got, video_io.open_video(path, device=dev)),
                    (plain, video_io.open_video(path, device="cpu")),
                    (want, cv2.VideoCapture(path))):
                frames += read_all(cap)
                cap.release()
            card_vs_cpu = max((int(np.abs(a.astype(np.int16) - b).max())
                               for a, b in zip(got, plain)), default=-1)
            vs_cv2 = max((int(np.abs(a.astype(np.int16) - b).max())
                          for a, b in zip(got, want)), default=-1)
            follows = cv2_follows.get(name, False)
            colour_files[name] = {"frames": len(got), "cv2_frames": len(want),
                                  "card_vs_cpu": card_vs_cpu,
                                  "max_pixel_diff_vs_cv2": vs_cv2,
                                  "cv2_keeps_the_rule": follows}
            check(len(got) == len(plain) == len(want) > 0
                  and card_vs_cpu == 0 and (vs_cv2 == 0 or not follows),
                  f"video files: colour {name}: {colour_files[name]}")
        colour_files["seconds"] = time.perf_counter() - t0
        numbers["colour_files"] = colour_files
        log(f"video files: colour fixtures on the card against the CPU and "
            f"cv2 {cv2.__version__} (held against cv2 where it keeps the "
            f"rule; otherwise its largest difference): "
            f"{json.dumps(colour_files)} [{smi}]")

        # the XVID writer against this machine's cv2, and beside MJPG
        writer_frames = scenes[:16]
        cv2_path = os.path.join(work, "cv2_xvid.avi")
        writer = cv2.VideoWriter(cv2_path, cv2.VideoWriter_fourcc(*"XVID"),
                                 20.0, (w, h))
        for frame in writer_frames:
            writer.write(frame)
        writer.release()
        xvid = {"cv2": cv2.__version__}
        for fourcc in ("XVID", "MJPG", "XVID"):   # the first XVID warms up
            path = os.path.join(work, f"port_{fourcc}.avi")
            writer = video_io.VideoWriter(path, 20.0, (w, h), fourcc=fourcc)
            t0 = time.perf_counter()
            for frame in writer_frames:
                writer.write(frame)
            writer.release()
            total = time.perf_counter() - t0
            xvid[fourcc] = {"ms_a_frame": total * 1e3 / len(writer_frames),
                            **{f"{k}_ms_a_frame": v * 1e3 / len(writer_frames)
                               for k, v in writer.seconds.items()}}

        def packets(path):
            with open(path, "rb") as f:
                stream = video_io.AviStream(path, f)
                out = []
                for off, size in stream.frames:
                    f.seek(off)
                    out.append(f.read(size))
            return out

        ours = packets(os.path.join(work, "port_XVID.avi"))
        theirs = packets(cv2_path)
        differing = [i for i, (a, b) in enumerate(zip(ours, theirs))
                     if a != b]
        xvid["packets"] = {
            "port": len(ours), "cv2": len(theirs),
            "differing": len(differing) + abs(len(ours) - len(theirs)),
            "differing_bytes": sum(
                sum(x != y for x, y in zip(ours[i], theirs[i]))
                + abs(len(ours[i]) - len(theirs[i])) for i in differing),
            "equal": ours == theirs}
        check(len(ours) == 16 and xvid["packets"]["equal"],
              f"video files: the XVID writer's packets differ from cv2 "
              f"{cv2.__version__}'s: {xvid['packets']}")
        numbers["xvid_writer"] = xvid
        log(f"video files: XVID writer on 16 frames 480x640: packets equal "
            f"to cv2 {cv2.__version__}'s: {xvid['packets']['equal']}; "
            f"{xvid['XVID']['ms_a_frame']:.3f} ms a frame (swscale "
            f"{xvid['XVID']['convert_ms_a_frame']:.3f}, encode "
            f"{xvid['XVID']['encode_ms_a_frame']:.3f}, write "
            f"{xvid['XVID']['write_ms_a_frame']:.3f}); MJPG "
            f"{xvid['MJPG']['ms_a_frame']:.3f} ms a frame [{smi}]")

        # the flagship video demo on a 64-frame H.264 MP4
        video = os.path.join(work, "in.mp4")
        out = os.path.join(work, "out.avi")
        sv.write_ipcm_mp4(video, [sv.bgr_to_yuv420(f) for f in scenes],
                          fps_timescale=(12800, 640))
        readers = []

        def recording_open(path, device="cuda"):
            readers.append(video_io.open_video(path, device=device))
            return readers[-1]

        sys.argv = (["video_demo", "--video", video, "--output", out,
                     "--batch", "8"] + FRONTEND_FLAGS
                    + ["--device", str(dev)])
        video_demo.open_video = recording_open
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with contextlib.redirect_stdout(io.StringIO()) as text:
            n, video_s = video_demo.main()
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        video_demo.open_video = video_io.open_video
        check(f"processed {VIDEO_FILE_FRAMES} frames" in text.getvalue()
              and n == VIDEO_FILE_FRAMES,
              f"video files demo: {text.getvalue()!r}")
        reread = video_io.open_video(out)
        check(reread.frame_count == VIDEO_FILE_FRAMES
              and reread.size == (w, h), f"video files demo output: "
              f"{reread.frame_count} frames of {reread.size}")
        reread.release()
        batches = -(-VIDEO_FILE_FRAMES // 8)
        check(all(counts[k] >= batches for k in SERVING_KERNELS)
              and counts["yuv420_to_bgr"] == VIDEO_FILE_FRAMES
              and counts["gt_maps"] == 0,
              f"video files demo: K1, K3 and G not once a batch or the "
              f"conversion not once a frame: {counts}")
        split = {k: v * 1e3 / n for k, v in readers[0].seconds.items()}
        numbers["demo_mp4"] = {
            "frames": n, "seconds": video_s, "frames_per_s": n / video_s,
            "batch": 8, "input": "I_PCM H.264 MP4 480x640",
            "read_ms_a_frame": split,
            "read_ms_a_frame_total": sum(split.values()),
            "launches": counts}

        writers = []

        def recording_writer(*args, **kw):
            writers.append(video_io.VideoWriter(*args, **kw))
            return writers[-1]

        def flagship_demo(video, codec, what, convert="yuv420_to_bgr"):
            """The flagship video demo on `video`, writing XVID: its
            launches (the conversion `convert` once a frame) and numbers,
            its output against cv2."""
            readers.clear()
            writers.clear()
            sys.argv = (["video_demo", "--video", video, "--output", out,
                         "--batch", "8"] + FRONTEND_FLAGS
                        + ["--device", str(dev)])
            video_demo.open_video = recording_open
            video_demo.VideoWriter = recording_writer
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            with contextlib.redirect_stdout(io.StringIO()) as text:
                n, video_s = video_demo.main()
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            video_demo.open_video = video_io.open_video
            video_demo.VideoWriter = video_io.VideoWriter
            check(f"processed {VIDEO_FILE_FRAMES} frames" in text.getvalue()
                  and n == VIDEO_FILE_FRAMES and readers[0].codec == codec,
                  f"video files {what} demo: {text.getvalue()!r}")
            check(all(counts[k] >= batches for k in SERVING_KERNELS)
                  and counts[convert] == VIDEO_FILE_FRAMES
                  and counts["gt_maps"] == 0,
                  f"video files {what} demo: K1, K3 and G not once a batch "
                  f"or the conversion not once a frame: {counts}")
            output, _ = against_cv2(out)
            check(output["frames"] == VIDEO_FILE_FRAMES and writers[0].fourcc
                  == b"XVID", f"video files {what} demo output: {output}")
            split = {k: v * 1e3 / n for k, v in readers[0].seconds.items()}
            write = {k: v * 1e3 / n for k, v in writers[0].seconds.items()}
            return counts, {
                "frames": n, "seconds": video_s, "frames_per_s": n / video_s,
                "batch": 8, "input": f"{what} 480x640 (cv2 "
                                     f"{cv2.__version__})",
                "output": "XVID AVI", "output_against_cv2": output,
                "read_ms_a_frame": split,
                "read_ms_a_frame_total": sum(split.values()),
                "write_ms_a_frame": write,
                "write_ms_a_frame_total": sum(write.values()),
                "launches": counts}

        # the flagship video demo on a 64-frame MPEG-4 MKV, then on a
        # 64-frame MPEG-2 TS (the demux, libavcodec's parser, the decode),
        # each writing XVID
        video = os.path.join(work, "in.mkv")
        sv.write_cv2_video(video, "XVID", VIDEO_FILE_FRAMES, h, w)
        mkv_counts, numbers["demo"] = flagship_demo(video, "mpeg4",
                                                    "MPEG-4 Part 2 MKV")
        video = os.path.join(work, "in.ts")
        sv.write_cv2_video(video, "MPG2", VIDEO_FILE_FRAMES, h, w, fps=25.0)
        ts_counts, numbers["demo_ts"] = flagship_demo(video, "mpeg2video",
                                                      "MPEG-2 TS")
        # ... and on a 64-frame PCM HEVC MP4 of the same scenes (item 4e)
        video = os.path.join(work, "in_hevc.mp4")
        sv.write_hevc_mp4(video, sv.encode_hevc_pcm(
            [sv.bgr_to_yuv420(f) for f in scenes], key_every=16),
            fps_timescale=(12800, 640))
        counts, numbers["demo_hevc"] = flagship_demo(video, "hevc",
                                                     "PCM HEVC MP4")
        # ... and on a 64-frame PCM HEVC Main 10 MP4 tagged BT.2020 (matrix
        # 9) limited range, a phone's HDR clip's shape (item 4h)
        rng = np.random.RandomState(10)
        video = os.path.join(work, "in_main10.mp4")
        sv.write_hevc_mp4(video, sv.encode_hevc_pcm(
            [tuple((p.astype(np.uint16) << 2)
                   | rng.randint(0, 4, p.shape).astype(np.uint16)
                   for p in sv.bgr_to_yuv420(f)) for f in scenes],
            key_every=16, depth=10, colour=sv.Colour(9)),
            fps_timescale=(12800, 640))
        p10_counts, numbers["demo_main10"] = flagship_demo(
            video, "hevc", "PCM HEVC Main 10 MP4 (BT.2020 limited)",
            convert="yuv420p10_to_bgr")
        check(p10_counts["yuv420_to_bgr"] == 0, f"video files Main 10 demo: "
              f"8-bit conversions launched: {p10_counts}")
        p10_row.update(launches=p10_counts["yuv420p10_to_bgr"],
                       video_file_launches=p10_counts["yuv420p10_to_bgr"])

        # the reader alone on a compressed stream of the same scenes
        if cv2 is not None:
            path = os.path.join(work, "scenes.mp4")
            writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"),
                                     20.0, (w, h))
            for frame in scenes:
                writer.write(frame)
            writer.release()
            cap = video_io.open_video(path, device=dev)
            t0 = time.perf_counter()
            m = 0
            while cap.read()[0]:
                m += 1
            read_s = time.perf_counter() - t0
            cap.release()
            numbers["mp4v_reader"] = {
                "frames": m, "read_ms_a_frame": read_s * 1e3 / m,
                "split_ms_a_frame": {k: v * 1e3 / m
                                     for k, v in cap.seconds.items()}}

        # no quiet fallback: no library, no card
        before = (avcodec._libs, avcodec._library_dirs)
        avcodec._libs, avcodec._library_dirs = None, lambda: []
        try:
            video_io.open_video(video, device=dev)
            raised = None
        except RuntimeError as e:
            raised = str(e)
        finally:
            avcodec._libs, avcodec._library_dirs = before
        check(raised is not None and "libavcodec" in raised,
              f"video files: an open without libavcodec gave {raised!r}")
        available = torch.cuda.is_available
        torch.cuda.is_available = lambda: False
        try:
            video_io.open_video(video)
            no_card = None
        except RuntimeError as e:
            no_card = str(e)
        finally:
            torch.cuda.is_available = available
        check(no_card is not None and "no CUDA card" in no_card,
              f"video files: an open without a card gave {no_card!r}")
        numbers["no_library_error"], numbers["no_card_error"] = raised, no_card
    finally:
        sys.argv = argv
        video_demo.open_video = video_io.open_video
        video_demo.VideoWriter = video_io.VideoWriter
        shutil.rmtree(work, ignore_errors=True)
    numbers["phase_s"] = time.perf_counter() - t_phase
    for key, what in (("demo_mp4", "H.264 MP4"), ("demo", "MPEG-4 MKV"),
                      ("demo_ts", "MPEG-2 TS"), ("demo_hevc", "HEVC MP4"),
                      ("demo_main10", "HEVC Main 10 MP4 (BT.2020)")):
        demo = numbers[key]
        log(f"phase 16 (video files): the flagship video demo on a "
            f"{VIDEO_FILE_FRAMES}-frame 480x640 {what} at --batch 8: "
            f"{demo['frames_per_s']:.2f} frames/s; read "
            f"{demo['read_ms_a_frame_total']:.3f} ms a frame "
            f"({', '.join(f'{k} {v:.3f}' for k, v in demo['read_ms_a_frame'].items())}"
            f"); write "
            f"{demo.get('write_ms_a_frame_total', 'not measured')} ms a "
            f"frame [{smi}]")
    log(f"phase 16: launches in the MKV demo {mkv_counts}, in the TS demo "
        f"{ts_counts}, in the HEVC demo {counts}, in the Main 10 demo "
        f"{p10_counts} [{smi}]")
    log(f"video files: I_PCM planes exact ({numbers['ipcm_exact']}), "
        f"rotations {rotated}; MPEG-4 {json.dumps(numbers['mpeg4'])}; "
        f"mp4v reader {json.dumps(numbers.get('mp4v_reader'))}; phase "
        f"{numbers['phase_s']:.1f} s")
    return counts, numbers, row, p10_row


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
                         input_size=368, flip=True, seed=0, device_resize=True)
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
                              device_resize=True,
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

    # 7b. the resize modes: host, "auto" and card on the same weights
    resize_numbers = resize_modes_phase(dev, smi, pipe.model)

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
    cli_gt_launches, native_numbers = train_files_phase(dev, smi, step_ms)

    # 9d. the hourglass experiment from files, rotated (K4 at stride 4)
    rotated_numbers = rotated_hourglass_phase(dev, smi)

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

    # 13. the parallel paths: DP over NCCL at world 1, two gloo ranks on
    # this card (DP2, a BatchNorm family, DP1 x TP2, the eval split),
    # sharded serving on two replicas, the eval CLI's --data-parallel
    par_launches, par_numbers = parallel_phase(dev, smi)

    # 14. the workflow scripts through their CLIs: the decode soaks, the
    # training schedule with a restore, the endurance run with a kill,
    # the val2017-profile rehearsal, the eval breakdown, the crowded
    # bench, hourglass's chain and rescore
    wf_launches, wf_numbers = workflows_phase(dev, smi)

    # 15. the webcam demo: scripted V4L2 cameras (YUYV, then Motion-JPEG)
    # into the browser view, a real /dev/video* where there is one, card
    # == CPU on oracle maps, the capture and the text against cv2
    webcam_launches, webcam_numbers = webcam_phase(dev, smi)

    # 16. the video files: the route probe, libavcodec's planes of an I_PCM
    # H.264 MP4 exact, the conversion kernels == plain at four turns and
    # every (matrix, range), cv2's MPEG-4 files, TS, HEVC, program streams
    # and colour fixtures against cv2, the flagship video demo on 64-frame
    # H.264 MP4, MPEG-4 MKV, MPEG-2 TS, HEVC MP4 and HEVC Main 10 MP4
    vf_launches, vf_numbers, yuv_row, p10_row = video_files_phase(dev, smi)

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
    results["gt_maps"]["native_cli_launches"] = \
        native_numbers["cli_gt_launches"]
    results["gt_maps"]["rotated_hourglass_launches"] = \
        rotated_numbers["gt_launches"]
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
                 parallel_launches=par_launches[name],
                 workflow_launches=wf_launches[name],
                 webcam_launches=webcam_launches[name],
                 video_file_launches=vf_launches[name],
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
        parallel_launches=par_launches["group_people"],
        workflow_launches=wf_launches["group_people"],
        webcam_launches=webcam_launches["group_people"],
        video_file_launches=vf_launches["group_people"],
        hourglass_factor4={k: hg_rows[f"group_people_K{k}"]
                           for k in (32, 64)},
        **results["group_people"], library_ms=None,
        selftest_latency_ms=selftest_ms)
    left = descendants()
    check(not left, f"processes still running: {left}")
    print(json.dumps({"zoo": zoo_numbers}), flush=True)
    print(json.dumps({"frontends": frontend_numbers}), flush=True)
    print(json.dumps({"parallel": par_numbers}), flush=True)
    print(json.dumps({"workflows": wf_numbers}), flush=True)
    print(json.dumps({"webcam": webcam_numbers}), flush=True)
    print(json.dumps({"video_files": vf_numbers}), flush=True)
    print(json.dumps({"native_loader": native_numbers,
                      "rotated_hourglass": rotated_numbers,
                      "resize_modes": resize_numbers}), flush=True)
    # the colour conversions replace cv2's, no TPU kernel: the grouping
    # kernel's row stands on a line of its own, theirs in the kernels line
    yuv_row.update(launches=vf_launches["yuv420_to_bgr"],
                   video_file_launches=vf_launches["yuv420_to_bgr"])
    print(json.dumps({"kernels_beyond_tpu": [group_row]}), flush=True)
    print(json.dumps({"kernels": rows + [yuv_row, p10_row]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
