"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA card and skips without one.  The file imports
no JAX, so it also runs where JAX is not installed; tests/conftest.py
imports JAX, so run it there without the conftest:

    python -m pytest tests/test_torch_gpu.py -q --noconftest -p no:cacheprovider

Tolerances: candidate validity and refined coordinates equal, scores
within 1e-5, ground-truth maps within 1e-6 (kernel and plain version
round the same fp32 operations in the same order, so they agree to the
bit in practice); the grouping kernel's People equal its plain version's
on every field; the video frames' conversion (integers) equal to its plain
version and to cv2's.
"""

import copy
import json
import math

import numpy as np
import pytest
import torch

from rtpose_tpu_torch.config import Config
from rtpose_tpu_torch.data.gt import ground_truth_maps_batch
from rtpose_tpu_torch.infer.pipeline import RETRY_CAPS
from rtpose_tpu_torch.infer.pipeline import PosePipeline
from rtpose_tpu_torch.infer.preprocess import normalize_device
from rtpose_tpu_torch.models import get_model
from rtpose_tpu_torch.ops import kernels
from rtpose_tpu_torch.ops.decode import decode_poses_batch, people_to_host
from rtpose_tpu_torch.ops.grouping import score_connections, sorted_candidates
from rtpose_tpu_torch.ops.kernels import limb_scalars, person_bound
from rtpose_tpu_torch.ops.peaks import nms, peak_candidates, refine_peaks
from rtpose_tpu_torch.train.trainer import Trainer
from rtpose_tpu_torch.utils.grouping_cases import (candidate_batch,
                                                   merge_chain_batch)

from util_synth import grid_people, render_maps, synth_example

ATOL = 1e-5
GT_ATOL = 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _scenes(kind, n=4, h=46, w=62):
    heats, pafs = [], []
    for seed in range(n):
        if kind == "grid":
            rng = np.random.RandomState(seed)
            heat, paf = render_maps(grid_people(6, 6, 92, 92, rng), 92, 92)
            paf = paf + rng.normal(0, 1e-4, paf.shape).astype(np.float32)
        else:
            _, heat, paf = synth_example(seed=seed, n_people=1 + seed % 5,
                                         h=h, w=w)
        heats.append(heat)
        pafs.append(paf)
    return torch.from_numpy(np.stack(heats)), torch.from_numpy(np.stack(pafs))


def _refine_inputs(cuda, kind, K):
    """(B, 18, H, W) maps, integer peaks and their validity, with empty
    slots in the mix."""
    heat, _ = _scenes(kind)
    hb = heat[..., :18].permute(0, 3, 1, 2).contiguous().to(cuda)
    _, py, px, valid, _ = peak_candidates(hb, thresh=0.1, max_peaks=K)
    assert valid.any() and not valid.all()
    return hb, py, px, valid


@pytest.mark.gpu
@pytest.mark.parametrize("K,kind", [(32, "synth"), (64, "grid")])
def test_paf_kernel_matches_plain(cuda, K, kind):
    """The fused scoring kernel (geometry, line integral, criterion) vs
    its plain version: at K=32 on 46x62 maps, at K=64 on 92x92."""
    heat, paf = (t.to(cuda) for t in _scenes(kind))
    p = nms(heat, max_peaks=K)
    before = kernels.connection_scores.launches
    crit2, valid = kernels.connection_scores(paf, p.x, p.y, p.valid)
    assert kernels.connection_scores.launches == before + 1
    crit2_p, valid_p = kernels.connection_scores_plain(paf, p.x, p.y,
                                                       p.valid)
    assert crit2.shape == (4, 19, K, K) and int(valid.sum()) > 10
    assert torch.equal(valid, valid_p)
    torch.testing.assert_close(crit2, crit2_p, rtol=0, atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("K,kind", [(32, "synth"), (64, "grid")])
def test_refine_kernel_matches_plain(cuda, K, kind):
    hb, py, px, valid = _refine_inputs(cuda, kind, K)
    before = kernels.bicubic_refine.launches
    xf, yf, score = kernels.bicubic_refine(hb, py, px, valid)
    assert kernels.bicubic_refine.launches == before + 1
    xf_p, yf_p, score_p = kernels.bicubic_refine_plain(hb, py, px, valid)
    assert torch.equal(xf, xf_p) and torch.equal(yf, yf_p)
    torch.testing.assert_close(score, score_p, rtol=0, atol=ATOL)
    assert not (xf[~valid].any() or yf[~valid].any() or score[~valid].any())


@pytest.mark.gpu
def test_refine_kernel_ties_go_to_lowest_flat_index(cuda):
    """All-zero windows, at the centre and clipped at the borders: every
    upsampled cell ties, so the first row-major cell wins, the window's
    top-left corner; an empty slot in the mix gives zeros."""
    heat = torch.zeros((1, 18, 10, 12), device=cuda)
    shape = (1, 18, 4)
    py = torch.tensor([5, 0, 9, 0], dtype=torch.int32, device=cuda)
    px = torch.tensor([5, 0, 11, 3], dtype=torch.int32, device=cuda)
    valid = torch.tensor([True, True, True, False], device=cuda)
    args = [t.expand(shape).contiguous() for t in (py, px, valid)]
    xf, yf, score = kernels.bicubic_refine(heat, *args)
    want = torch.tensor([[24.0, 24.0], [0.0, 0.0], [72.0, 56.0], [0.0, 0.0]],
                        device=cuda)
    assert torch.equal(torch.stack([xf, yf], -1)[0], want.expand(18, 4, 2))
    assert float(score.abs().max()) == 0.0
    for got, plain in zip((xf, yf, score),
                          kernels.bicubic_refine_plain(heat, *args)):
        assert torch.equal(got, plain)


def _assert_refine_equals_plain(args, **kw):
    valid = args[3]
    got = kernels.bicubic_refine(*args, **kw)
    want = kernels.bicubic_refine_plain(*args, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=0)
    assert not any(t[~valid].any() for t in got)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("K,kind,factor", [(32, "synth", 8), (64, "grid", 8),
                                           (32, "synth", 4), (32, "synth", 3)])
def test_refine_gaussian_filt_kernel_matches_plain(cuda, K, kind, factor):
    """The blurred refine: coordinates and scores equal to the plain
    version's dense sums (error 0), empty slots zero; x8 at both caps, x4
    (two lanes in three idle) and x3 (a 15-row upsample, half a tile wide
    of its 10-column tiles)."""
    args = _refine_inputs(cuda, kind, K)
    before = kernels.bicubic_refine.launches
    _assert_refine_equals_plain(args, factor=factor, gaussian_filt=True)
    assert kernels.bicubic_refine.launches == before + 1


@pytest.mark.gpu
def test_refine_gaussian_filt_ties_and_borders(cuda):
    """All-zero windows blurred, at the centre and clipped at two borders:
    every cell ties, so the window's top-left corner wins, whatever order
    the lanes' tiles are scanned in; an empty slot gives zeros."""
    heat = torch.zeros((1, 18, 10, 12), device=cuda)
    shape = (1, 18, 4)
    py = torch.tensor([5, 0, 9, 0], dtype=torch.int32, device=cuda)
    px = torch.tensor([5, 0, 11, 3], dtype=torch.int32, device=cuda)
    valid = torch.tensor([True, True, True, False], device=cuda)
    args = [heat] + [t.expand(shape).contiguous() for t in (py, px, valid)]
    xf, yf, score = _assert_refine_equals_plain(args, gaussian_filt=True)
    want = torch.tensor([[24.0, 24.0], [0.0, 0.0], [72.0, 56.0], [0.0, 0.0]],
                        device=cuda)
    assert torch.equal(torch.stack([xf, yf], -1)[0], want.expand(18, 4, 2))
    assert float(score.abs().max()) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("H,W", [(12, 12), (7, 30), (3, 3)])
def test_refine_gaussian_filt_every_extent(cuda, H, W):
    """Random maps with peaks on every border and corner, so windows of
    extent 3, 4 and 5 on either axis meet, with more slots than one block
    lists in a pass."""
    rng = np.random.RandomState(H * W)
    B, P, K = 3, 18, 40
    heat = torch.from_numpy(rng.rand(B, P, H, W).astype(np.float32)).to(cuda)
    py = rng.randint(0, H, (B, P, K)).astype(np.int32)
    px = rng.randint(0, W, (B, P, K)).astype(np.int32)
    py[..., :6] = [0, H - 1, 0, H - 1, 1, H - 2]
    px[..., :6] = [0, 0, W - 1, W - 1, 1, W - 2]
    valid = rng.rand(B, P, K) < 0.7
    args = [heat] + [torch.from_numpy(a).to(cuda) for a in (py, px, valid)]
    _assert_refine_equals_plain(args, gaussian_filt=True)


@pytest.mark.gpu
def test_kernels_take_another_factor(cuda):
    """x4 (the hourglass family's stride): the scoring kernel's generic
    path and a 20-row refine upsample, against the plain versions."""
    heat, paf = (t.to(cuda) for t in _scenes("synth"))
    p = nms(heat, factor=4)
    got = kernels.connection_scores(paf, p.x, p.y, p.valid, factor=4)
    want = kernels.connection_scores_plain(paf, p.x, p.y, p.valid, factor=4)
    assert int(got[1].sum()) > 10
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    hb, py, px, valid = _refine_inputs(cuda, "synth", 32)
    got = kernels.bicubic_refine(hb, py, px, valid, factor=4)
    want = kernels.bicubic_refine_plain(hb, py, px, valid, factor=4)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=ATOL)


def _device_events(fn, calls):
    """The profiler's device events over `calls` calls of fn.  A session
    that comes back with no device event at all (the profiler does that
    now and then) is taken again, twice at most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        if events:
            break
    return events


@pytest.mark.gpu
def test_decode_stages_launch_one_kernel_each(cuda):
    """The profiler sees exactly one device kernel, and no copy, in
    score_connections and in refine_peaks at the default caps."""
    heat, paf = (t.to(cuda) for t in _scenes("synth"))
    p = nms(heat)
    hb, py, px, valid = _refine_inputs(cuda, "synth", 32)
    stages = {"score_connections": lambda: score_connections(p, paf),
              "refine_peaks": lambda: refine_peaks(hb, py, px, valid)}
    calls = 10
    for name, fn in stages.items():
        events = _device_events(fn, calls)
        # the profiler may miss one event of a run
        assert calls - 1 <= sum(e.count for e in events) <= calls, \
            (name, [(e.key, e.count) for e in events])


def _keypoints(batch=8, slots=32, size=368, seed=0):
    """Up to 8 visible persons per image, an image with none, and an
    all-invisible row in the middle of the padding."""
    rng = np.random.RandomState(seed)
    kps = np.zeros((batch, slots, 18, 3), np.float32)
    for b in range(batch):
        for p in range(b % 9):
            kps[b, p, :, :2] = rng.uniform(0, size - 1, (18, 2))
            kps[b, p, :, 2] = rng.choice([0, 2], 18, p=[.3, .7])
    kps[batch - 1, 1] = 0.0
    return torch.from_numpy(kps)


def _edge_keypoints(gy: int, gx: int, slots: int = 32, seed: int = 0):
    """(4, slots, 18, 3) keypoints that press on K4's culling (the smoke
    script holds the kernel on the same batch), for a
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


def _assert_gt_equals_plain(kps, gy, gx):
    before = kernels.gt_maps.launches
    heat, paf = kernels.gt_maps(kps, grid_y=gy, grid_x=gx, stride=8,
                                sigma=7.0)
    assert kernels.gt_maps.launches == before + 1
    heat_p, paf_p = kernels.gt_maps_plain(
        kps, limb_scalars(kps, 8), person_bound(kps), grid_y=gy, grid_x=gx,
        stride=8, sigma=7.0)
    B = kps.shape[0]
    assert heat.shape == (B, gy, gx, 19) and paf.shape == (B, gy, gx, 38)
    torch.testing.assert_close(heat, heat_p, rtol=0, atol=0)
    torch.testing.assert_close(paf, paf_p, rtol=0, atol=0)
    return heat, paf


@pytest.mark.gpu
@pytest.mark.parametrize("grid", [(46, 46), (28, 40), (7, 9)])
def test_gt_kernel_matches_plain(cuda, grid):
    gy, gx = grid
    kps = _keypoints(size=8 * max(gy, gx)).to(cuda)
    heat, paf = _assert_gt_equals_plain(kps, gy, gx)
    assert float(heat[..., :18].max()) > 0.5 and float(paf.abs().max()) > 0.5
    want = ground_truth_maps_batch(kps.cpu(), input_y=8 * gy,
                                   input_x=8 * gx)
    torch.testing.assert_close(heat.cpu(), want[0], rtol=0, atol=GT_ATOL)
    torch.testing.assert_close(paf.cpu(), want[1], rtol=0, atol=GT_ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("grid", [(46, 46), (28, 40), (7, 9)])
@pytest.mark.parametrize("slots", [32, 5])
def test_gt_kernel_culling_is_exact(cuda, grid, slots):
    """An edge batch (persons on the grid's border, outside
    it, at the Gaussian's cutoff, an empty image and a full one): what the
    kernel skips are terms the plain version's dense loop does not add,
    so the maps are equal to the bit.  5 slots give an odd count of
    staged rows."""
    gy, gx = grid
    kps = torch.from_numpy(_edge_keypoints(gy, gx, slots)).to(cuda)
    assert person_bound(kps).tolist() == [min(8, slots), slots, 0, slots]
    heat, paf = _assert_gt_equals_plain(kps, gy, gx)
    assert float(heat[2, ..., :18].abs().max()) == 0.0
    assert float(heat[2, ..., 18].min()) == 1.0
    assert float(paf[3].abs().max()) > 0.5


@pytest.mark.gpu
def test_ground_truth_maps_batch_is_one_kernel(cuda):
    """The profiler sees one device kernel and no copy per call."""
    kps = _keypoints().to(cuda)
    fn = lambda: ground_truth_maps_batch(kps)       # noqa: E731
    calls = 10
    events = _device_events(fn, calls)
    assert calls - 1 <= sum(e.count for e in events) <= calls, \
        [(e.key, e.count) for e in events]
    assert all("gt_maps_kernel" in e.key for e in events)


@pytest.mark.gpu
def test_train_step_on_card_launches_gt_maps(cuda):
    cfg = Config()
    cfg.model.num_stages, cfg.dataset.image_size = 2, 64
    cfg.train.lr = 0.05
    trainer = Trainer(cfg, device=cuda)
    rng = np.random.RandomState(0)
    images = rng.rand(4, 64, 64, 3).astype(np.float32)
    kps = _keypoints(batch=4, slots=4, size=64).numpy()
    kernels.reset_launch_counts()
    losses = [trainer.train_step(images, kps)["loss"] for _ in range(3)]
    assert kernels.launch_counts()["gt_maps"] == 3
    assert all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]


@pytest.mark.gpu
def test_gt_kernel_on_a_loader_batch_matches_plain(cuda, tmp_path):
    """Keypoints from the training loader (augmented, neck added, illegal
    joints removed, people over the crop's edges, 32-slot padding) through
    K4 equal the plain version."""
    from rtpose_tpu_torch.data.dataset import CocoKeypoints, Loader
    from rtpose_tpu_torch.utils.synth_coco import (training_frames,
                                                   write_synth_coco)
    shapes = [(480, 640), (640, 480), (427, 640)] * 4
    img_dir, ann = write_synth_coco(str(tmp_path), training_frames(
        np.random.RandomState(0), shapes))
    loader = Loader(CocoKeypoints(img_dir, ann), 8, num_workers=2, seed=0,
                    pin_memory=True)
    batch = next(iter(loader))
    assert batch["keypoints"].is_pinned()
    assert batch["keypoints"].shape == (8, 32, 18, 3)
    assert int((batch["keypoints"][..., 2] > 0).sum()) > 0
    _assert_gt_equals_plain(batch["keypoints"].to(cuda), 46, 46)


@pytest.mark.gpu
def test_wrappers_raise_instead_of_falling_back(cuda):
    peaks = torch.zeros((1, 18, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.connection_scores(
            torch.zeros((1, 4, 4, 38), dtype=torch.float64, device=cuda),
            peaks, peaks, peaks.bool())
    with pytest.raises(ValueError, match="bool"):
        kernels.connection_scores(torch.zeros((1, 4, 4, 38), device=cuda),
                                  peaks, peaks, peaks)
    heat = torch.zeros((1, 18, 8, 8), device=cuda)
    with pytest.raises(ValueError, match="int32"):
        kernels.bicubic_refine(heat, peaks.long(), peaks, peaks.bool())
    with pytest.raises(ValueError, match="rows"):
        kernels.bicubic_refine(heat, peaks, peaks, peaks.bool(), factor=16)
    kps = torch.zeros((1, 2, 18, 3), device=cuda)
    gt_args = dict(grid_y=4, grid_x=4, stride=8, sigma=7.0)
    with pytest.raises(ValueError, match="float32"):
        kernels.gt_maps(kps.double(), **gt_args)
    with pytest.raises(ValueError, match=r"\(B,N,18,3\)"):
        kernels.gt_maps(kps[:, :, :17].contiguous(), **gt_args)
    with pytest.raises(ValueError, match="cells a side"):
        kernels.gt_maps(kps, grid_y=4, grid_x=40000, stride=8, sigma=7.0)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,caps", [
    ("synth", {}),
    ("grid", dict(max_peaks=64, max_candidates=1024, max_total_conns=608,
                  max_people=128)),
])
def test_decode_on_card_matches_cpu(cuda, kind, caps):
    heat, paf = _scenes(kind)
    want = people_to_host(decode_poses_batch(heat, paf, **caps))
    got = people_to_host(decode_poses_batch(heat.to(cuda), paf.to(cuda),
                                            **caps))
    assert want.valid.sum() > 0
    for f in ("coords", "valid", "truncated"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    for f in ("score", "part_score"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   atol=ATOL)


@pytest.mark.gpu
def test_pipeline_on_card_runs_through_both_kernels(cuda):
    """A 1-stage fp32 pipeline on the card vs the same weights on the CPU:
    maps within 1e-4 of their range, and both kernels launched."""
    model = get_model("vgg19", num_stages=1)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():     # He scale, so activations keep their size
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, math.sqrt(2.0 / fan_in), generator=gen)
    frames = [np.random.RandomState(i).randint(0, 256, (60, 80, 3), np.uint8)
              for i in range(2)]
    cpu = PosePipeline(model, device="cpu", input_size=56)
    _, heat_c, paf_c, _ = cpu.run(frames[0])
    pipe = PosePipeline(copy.deepcopy(model), device="cuda", input_size=56)
    kernels.reset_launch_counts()
    _, heat_g, paf_g, meta = pipe.run(frames[0])
    people, metas = pipe.run_batch(frames)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["connection_scores"] > 0 and counts["bicubic_refine"] > 0
    assert counts["gt_maps"] == 0
    assert heat_g.shape == heat_c.shape == (7, 10, 19)
    for got, want in ((heat_g, heat_c), (paf_g, paf_c)):
        assert np.isfinite(got).all()
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got - want).max()) <= 1e-4 * scale
    assert len(people) == 2 and metas[0]["padded_shape"] == (56, 80, 3)


@pytest.mark.gpu
def test_pipeline_gaussian_filt_reaches_the_blurred_kernel(cuda):
    """PosePipeline(gaussian_filt=True) on the card: the first decode and
    the retry both launch the blurred kernel, and the people equal the
    CPU pipeline's."""
    tight = dict(max_peaks=16, max_candidates=64, max_total_conns=32,
                 max_people=64)
    raised = dict(max_peaks=16, max_candidates=512, max_total_conns=304,
                  max_people=64)
    rng = np.random.RandomState(0)
    heat, paf = render_maps(grid_people(3, 4, 46, 46, rng), 46, 46)
    paf = paf + rng.normal(0, 1e-4, paf.shape).astype(np.float32)
    frames = [np.zeros((368, 368, 3), np.uint8)]
    out = {}
    for device in ("cpu", "cuda"):
        pipe = PosePipeline(get_model("vgg19", num_stages=1), device=device,
                            flip=False, retry_caps=raised,
                            gaussian_filt=True, **tight)
        h = torch.from_numpy(heat)[None].to(pipe.device)
        p = torch.from_numpy(paf)[None].to(pipe.device)
        pipe._infer = lambda frames, h=h, p=p: (decode_poses_batch(
            h, p, gaussian_filt=True, **tight), h, p)
        kernels.reset_launch_counts()
        people, metas = pipe.run_batch(frames)
        counts = kernels.launch_counts()
        assert metas[0].get("retried") and not metas[0]["truncated"]
        out[device] = people[0]
        blurred = counts["bicubic_refine_gaussian_filt"]
        assert blurred == (2 if device == "cuda" else 0)
        assert counts["bicubic_refine"] == blurred
    assert len(out["cuda"]) == len(out["cpu"]) == 12
    for a, b in zip(out["cuda"], out["cpu"]):
        assert a["parts"].keys() == b["parts"].keys()
        for part, (x, y, sc) in a["parts"].items():
            assert (x, y) == b["parts"][part][:2]
            assert abs(sc - b["parts"][part][2]) <= ATOL
    full = PosePipeline(get_model("vgg19", num_stages=1), device="cuda",
                        input_size=56, gaussian_filt=True)
    assert full._retry_kwargs["gaussian_filt"] is True
    assert full._retry_kwargs["max_peaks"] == RETRY_CAPS["max_peaks"]
    kernels.reset_launch_counts()
    full.run(np.random.RandomState(1).randint(0, 256, (60, 80, 3), np.uint8))
    counts = kernels.launch_counts()
    assert counts["bicubic_refine_gaussian_filt"] == \
        counts["bicubic_refine"] >= 1


GROUP_CAPS = {"default": dict(max_candidates=256, max_people=64,
                              max_total_conns=160),
              "retry": dict(max_candidates=1024, max_people=128,
                            max_total_conns=608)}


def _assert_group_equals_plain(args, caps):
    before = kernels.group_people.launches
    got = kernels.group_people(*args, **caps)
    assert kernels.group_people.launches == before + 1
    want = kernels.group_people_plain(*args, **caps)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("caps", ["default", "retry"])
def test_group_kernel_matches_plain_on_crafted_candidates(cuda, caps):
    """Candidate batches that reach every branch of the assembly (but
    found >= 3, which greedy matching cannot produce), the windows
    overflowing and exact score ties (tests/test_torch_grouping.py counts
    them on the CPU): every People field equal."""
    K = 32 if caps == "default" else 64
    scores, valid, *peaks = (torch.from_numpy(a).to(cuda)
                             for a in candidate_batch(0, 8, K))
    got = _assert_group_equals_plain(
        (*sorted_candidates(scores, valid), *peaks), GROUP_CAPS[caps])
    assert got[4].any() and not got[4].all() and got[3].sum() > 20


@pytest.mark.gpu
@pytest.mark.parametrize("kind,caps", [("synth", "default"),
                                       ("grid", "retry"),
                                       ("grid", "default")])
def test_group_kernel_matches_plain_on_scenes(cuda, kind, caps):
    heat, paf = (t.to(cuda) for t in _scenes(kind))
    p = nms(heat, max_peaks=32 if caps == "default" else 64)
    got = _assert_group_equals_plain(
        (*sorted_candidates(*score_connections(p, paf)), p.x, p.y, p.score,
         p.truncated), GROUP_CAPS[caps])
    assert int(got[3].sum()) > 0


@pytest.mark.gpu
def test_decode_launches_each_kernel_once(cuda):
    heat, paf = (t.to(cuda) for t in _scenes("synth"))
    kernels.reset_launch_counts()
    decode_poses_batch(heat, paf)
    counts = kernels.launch_counts()
    assert counts["group_people"] == counts["connection_scores"] == \
        counts["bicubic_refine"] == 1


@pytest.mark.gpu
def test_decode_and_submit_do_not_synchronize(cuda):
    """With every synchronising call an error, the decode at both caps and
    ``run_batch_submit`` run (after a warm-up call that copies each path's
    tables to the card once); the ticket then collects."""
    heat, paf = (t.to(cuda) for t in _scenes("synth"))
    gheat, gpaf = (t.to(cuda) for t in _scenes("grid"))
    pipe = PosePipeline(get_model("vgg19", num_stages=1), device="cuda",
                        input_size=56)
    frames = [np.random.RandomState(i).randint(0, 256, (60, 80, 3),
                                               np.uint8) for i in range(2)]
    pipe.run_batch(frames)
    decode_poses_batch(gheat, gpaf, **RETRY_CAPS)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ticket = pipe.run_batch_submit(frames)
        first = decode_poses_batch(heat, paf)
        retry = decode_poses_batch(gheat, gpaf, **RETRY_CAPS)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    people, metas = pipe.run_batch_collect(ticket)
    assert len(people) == 2 and metas[0]["padded_shape"] == (56, 80, 3)
    for got, (h, p, caps) in ((first, (heat, paf, {})),
                              (retry, (gheat, gpaf, RETRY_CAPS))):
        want = people_to_host(decode_poses_batch(h.cpu(), p.cpu(), **caps))
        got = people_to_host(got)
        assert want.valid.sum() > 0
        for f in ("coords", "valid", "truncated"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


@pytest.mark.gpu
def test_group_kernel_raises_beyond_its_limits(cuda):
    def args(K, B=1):
        ss = torch.full((B, 19, K * K), -torch.inf, device=cuda)
        si = torch.zeros((B, 19, K * K), dtype=torch.int64, device=cuda)
        pk = torch.zeros((B, 18, K), dtype=torch.int32, device=cuda)
        return (ss, si, pk, pk, pk.float(),
                torch.zeros(B, dtype=torch.bool, device=cuda))
    with pytest.raises(ValueError, match="K <= 128"):
        kernels.group_people(*args(129))
    with pytest.raises(ValueError, match="1 to 256 people"):
        kernels.group_people(*args(8), max_people=257)
    ss, si, *rest = args(8)
    with pytest.raises(ValueError, match="int64"):
        kernels.group_people(ss, si.int(), *rest)
    with pytest.raises(ValueError, match="does not match|do not match"):
        kernels.group_people(ss[:, :18].contiguous(), si[:, :18].contiguous(),
                             *rest)
    # at the limits it runs: K = 128, 256 people, nobody found
    got = kernels.group_people(*args(128), max_people=256)
    assert not got[3].any() and not got[4].any()


@pytest.mark.gpu
def test_group_kernel_at_its_limits_with_people(cuda):
    """K = 128 peaks per part and 256 rows, which take the kernel's
    dynamic shared memory above 48 KB: every People field equal."""
    caps = dict(max_candidates=4096, max_people=256,
                max_total_conns=19 * 128)
    assert kernels.group_smem_bytes(128, 256, caps["max_total_conns"]) \
        > 48 * 1024
    scores, valid, *peaks = (torch.from_numpy(a).to(cuda)
                             for a in candidate_batch(2, 4, 128))
    got = _assert_group_equals_plain(
        (*sorted_candidates(scores, valid), *peaks), caps)
    assert got[3].sum() > 100 and got[4].any()


@pytest.mark.gpu
def test_group_kernel_reads_ids_a_merge_moved(cuda):
    """Pair 18 finds a row through a peak id that the merge at pair 17
    moved into it (``utils/grouping_cases.py`` ``merge_chain_batch``):
    every People field equal."""
    scores, valid, *peaks = (torch.from_numpy(a).to(cuda)
                             for a in merge_chain_batch())
    got = _assert_group_equals_plain(
        (*sorted_candidates(scores, valid), *peaks), GROUP_CAPS["default"])
    assert got[3].sum(1).tolist() == [1, 1]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["rtpose", "vgg", "inception", "ssd"])
def test_normalize_device_on_card_equals_cpu(cuda, mode):
    """Every uint8 value in every channel, bit for bit."""
    x = torch.from_numpy(((np.arange(256)[:, None] + 85 * np.arange(3))
                          % 256).astype(np.uint8)[None])
    got = normalize_device(x.to(cuda), mode).cpu()
    want = normalize_device(x, mode)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
def test_selftest_passes_on_the_card(cuda, capsys):
    from rtpose_tpu_torch import selftest
    with pytest.raises(SystemExit) as done:
        selftest.main(["--device", "cuda"])
    assert done.value.code == 0, capsys.readouterr().out


@pytest.mark.gpu
def test_reader_on_the_cards_machine_equals_cv2(cuda):
    """The reader's route (Pillow) on the machine with the card: the
    committed fixture JPEGs read as cv2 read them where they were made,
    pixel for pixel, orientation and shape included."""
    from rtpose_tpu_torch.data import imread_fixtures as fx
    from rtpose_tpu_torch.data.imread import read_bgr
    pixels = np.load(fx.CV2_PIXELS)
    for name in fx.FIXTURES:
        got = read_bgr(fx.fixture_path(name))
        assert got.shape == pixels[name].shape, name
        np.testing.assert_array_equal(got, pixels[name], err_msg=name)


@pytest.mark.gpu
def test_oracle_eval_on_card_equals_cpu(cuda, tmp_path):
    """``run_eval`` and ``run_eval_batched`` (batch 8) with the oracle
    stub on the card give the CPU's results (same counts, keypoints within
    1e-4 px) and at least its AP."""
    from rtpose_tpu_torch.evalx.harness import run_eval, run_eval_batched
    from rtpose_tpu_torch.utils.synth_coco import (OracleMaps,
                                                   compare_results,
                                                   oracle_maps,
                                                   spread_people,
                                                   write_synth_coco)
    rng = np.random.RandomState(0)
    scenes = {(368, 496): spread_people(rng, 2, 368, 496),
              (496, 368): spread_people(rng, 1, 496, 368)}
    scenes[(368, 490)] = scenes[(368, 496)]
    shapes = list(scenes) * 4
    img_dir, ann = write_synth_coco(str(tmp_path),
                                    [(h, w, scenes[(h, w)])
                                     for h, w in shapes])
    maps = oracle_maps(scenes, 368)
    runs = {}
    for dev in ("cpu", "cuda"):
        pipe = PosePipeline(OracleMaps(maps), device=dev, input_size=368,
                            flip=False)
        for name, fn, kw in (("single", run_eval, {}),
                             ("batched", run_eval_batched,
                              dict(batch_size=8))):
            path = str(tmp_path / f"{dev}_{name}.json")
            stats = fn(img_dir, ann, pipe, results_path=path, **kw)
            runs[dev, name] = (stats, json.load(open(path)))
    for name in ("single", "batched"):
        (s_card, r_card), (s_cpu, r_cpu) = runs["cuda", name], \
            runs["cpu", name]
        kp_err, score_err = compare_results(r_card, r_cpu)
        assert len(r_card) == 20 and kp_err <= 1e-4 and score_err <= 1e-5
        assert s_cpu["AP"] > 0.9 and s_card["AP"] >= s_cpu["AP"]


@pytest.mark.gpu
def test_run_reads_the_card_back_once(cuda):
    """``run`` waits for the card once, for the people and both maps
    together (the JAX package's one ``device_get``): one synchronising
    call under ``set_sync_debug_mode("warn")``."""
    import warnings
    pipe = PosePipeline(get_model("vgg19", num_stages=1), device="cuda",
                        input_size=56)
    frame = np.random.RandomState(0).randint(0, 256, (60, 80, 3), np.uint8)
    want = pipe.run(frame)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = pipe.run(frame)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    assert len(syncs) == 1, [str(w.message) for w in caught]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert got[0] == want[0]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["hourglass", "shufflenet_v2"])
def test_zoo_family_run_batch_on_card_equals_cpu(cuda, name):
    """A zoo family's fp32 pipeline on the card vs the CPU on the same
    seeded weights (hourglass at stride 4, pad 64): maps within 1e-4 of
    their range, the decode of the card's maps equal to the CPU's decode
    of the same maps, and the serving kernels launched."""
    stride, pad = (4, 64) if name == "hourglass" else (8, 0)
    kw = dict(model_name=name, num_stages=1, input_size=64,
              dtype=torch.float32, seed=0, downsample=stride,
              pad_factor=pad)
    from rtpose_tpu_torch.infer.pipeline import load_pipeline
    cpu = load_pipeline(device="cpu", **kw)
    card = load_pipeline(device="cuda", **kw)
    frames = [np.random.RandomState(i).randint(0, 256, (60, 80, 3), np.uint8)
              for i in range(2)]
    kernels.reset_launch_counts()
    people, metas = card.run_batch(frames)
    ticket = card.run_batch_submit(frames)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    for k in ("connection_scores", "bicubic_refine", "group_people"):
        assert counts[k] > 0, k
    assert len(people) == 2
    want_people = people_to_host(decode_poses_batch(
        ticket[2].cpu(), ticket[3].cpu(), factor=stride))
    got_people = people_to_host(ticket[1])
    for f in ("coords", "valid", "truncated"):
        np.testing.assert_array_equal(getattr(got_people, f),
                                      getattr(want_people, f))
    for frame in frames:
        _, heat_c, paf_c, _ = cpu.run(frame)
        _, heat_g, paf_g, _ = card.run(frame)
        for got, want in ((heat_g, heat_c), (paf_g, paf_c)):
            scale = max(float(np.abs(want).max()), 1e-30)
            assert float(np.abs(got - want).max()) <= 1e-4 * scale


@pytest.mark.gpu
def test_hourglass_kernels_at_factor_and_stride_4(cuda):
    """Hourglass's shapes: 64x64 maps (256 px at stride 4), K1 at factor
    4 at both caps, K3 plain and blurred at factor 4, K4 at stride 4 on a
    64x64 grid, each equal to its plain version."""
    scenes = [synth_example(seed=s, n_people=1 + s, h=64, w=64)[1:]
              for s in range(4)]
    heat = torch.from_numpy(np.stack([h for h, _ in scenes])).to(cuda)
    paf = torch.from_numpy(np.stack([p for _, p in scenes])).to(cuda)
    for K in (32, 64):
        p = nms(heat, factor=4, max_peaks=K)
        got = kernels.connection_scores(paf, p.x, p.y, p.valid, factor=4)
        want = kernels.connection_scores_plain(paf, p.x, p.y, p.valid,
                                               factor=4)
        assert int(got[1].sum()) > 0
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    hb = heat[..., :18].permute(0, 3, 1, 2).contiguous()
    _, py, px, valid, _ = peak_candidates(hb, thresh=0.1, max_peaks=32)
    for blur in (False, True):
        _assert_refine_equals_plain([hb, py, px, valid], factor=4,
                                    gaussian_filt=blur)
    kps = _keypoints(batch=32, size=256).to(cuda)
    heat_k, paf_k = kernels.gt_maps(kps, grid_y=64, grid_x=64, stride=4,
                                    sigma=4.416, limb_width=1.289)
    heat_p, paf_p = kernels.gt_maps_plain(
        kps, limb_scalars(kps, 4, 1.289), person_bound(kps), grid_y=64,
        grid_x=64, stride=4, sigma=4.416, limb_width=1.289)
    torch.testing.assert_close(heat_k, heat_p, rtol=0, atol=0)
    torch.testing.assert_close(paf_k, paf_p, rtol=0, atol=0)


@pytest.mark.gpu
def test_http_on_card_equals_cpu(cuda):
    """The HTTP service over an oracle-map pipeline on the card answers
    the same JPEG bytes as the CPU service: people, part names, size and
    truncation equal, pixel coordinates within 1e-4, scores within 1e-5;
    the card's requests launch K1, K3 and the grouping kernel."""
    import http.client
    import io
    import threading

    from PIL import Image

    from rtpose_tpu_torch.data.imread_fixtures import render_scene
    from rtpose_tpu_torch.demo.serve_http import serve
    from rtpose_tpu_torch.utils.synth_coco import (OracleMaps, oracle_maps,
                                                   spread_people)
    rng = np.random.RandomState(0)
    scenes = {(368, 496): spread_people(rng, 2, 368, 496),
              (496, 368): spread_people(rng, 1, 496, 368)}
    maps = oracle_maps(scenes, 368)
    bodies = []
    for i, (h, w) in enumerate(scenes):
        buf = io.BytesIO()
        Image.fromarray(render_scene(i, h, w)).save(buf, "JPEG")
        bodies.append(buf.getvalue())
    answers = {}
    for dev in ("cpu", "cuda"):
        server = serve(PosePipeline(OracleMaps(maps), device=dev,
                                    input_size=368, flip=False),
                       host="127.0.0.1", port=0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        kernels.reset_launch_counts()
        try:
            answers[dev] = []
            for body in bodies:
                conn = http.client.HTTPConnection(
                    "127.0.0.1", server.server_address[1], timeout=120)
                conn.request("POST", "/pose", body=body)
                resp = conn.getresponse()
                answers[dev].append((resp.status, json.loads(resp.read())))
                conn.close()
        finally:
            server.shutdown()
            server.server_close()
        counts = kernels.launch_counts()
        for name in ("connection_scores", "bicubic_refine", "group_people"):
            assert (counts[name] > 0) == (dev == "cuda"), (dev, counts)
    for (sg, got), (sc, want) in zip(answers["cuda"], answers["cpu"]):
        assert sg == sc == 200
        assert got["size"] == want["size"]
        assert got["truncated"] == want["truncated"]
        assert len(got["people"]) == len(want["people"]) > 0
        for a, b in zip(got["people"], want["people"]):
            assert abs(a["score"] - b["score"]) <= ATOL
            assert a["parts"].keys() == b["parts"].keys()
            for name, (x, y, s) in a["parts"].items():
                bx, by, bs = b["parts"][name]
                assert abs(x - bx) <= 1e-4 and abs(y - by) <= 1e-4
                assert abs(s - bs) <= ATOL


@pytest.mark.gpu
def test_drawing_on_the_cards_machine_equals_cv2(cuda):
    """``utils.draw`` against the cv2 installed beside the card (another
    version than the CPU tests'): the demos' thick circles and lines,
    inside, on the edge and outside the frame, pixel for pixel."""
    cv2 = pytest.importorskip("cv2")
    from rtpose_tpu_torch.utils.draw import cv_circle, cv_line
    rng = np.random.RandomState(0)
    for trial in range(400):
        h, w = rng.randint(1, 90, 2)
        want = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        got = want.copy()
        p1 = tuple(int(v) for v in rng.randint(-100, 200, 2))
        p2 = tuple(int(v) for v in rng.randint(-100, 200, 2))
        color = tuple(int(v) for v in rng.randint(0, 256, 3))
        if trial % 2:
            cv2.line(want, p1, p2, color, 3)
            cv_line(got, p1, p2, color, 3)
        else:
            cv2.circle(want, p1, 3, color, thickness=3, lineType=8)
            cv_circle(got, p1, 3, color, 3)
        np.testing.assert_array_equal(got, want, err_msg=str(
            (cv2.__version__, trial, (h, w), p1, p2)))


@pytest.mark.gpu
def test_webcam_on_card_equals_cpu(cuda, monkeypatch):
    """The webcam loop over a scripted YUYV camera and an oracle-map
    pipeline, with a scripted clock: the frames drawn on the card equal
    the CPU's bit for bit, and the card's loop launches K1, K3 and the
    grouping kernel once a frame."""
    from rtpose_tpu_torch.data.imread_fixtures import render_scene
    from rtpose_tpu_torch.demo import camera
    from rtpose_tpu_torch.demo.scripted_camera import (ScriptedDevice,
                                                       ScriptedV4L2)
    from rtpose_tpu_torch.demo.web_demo import run_webcam
    from rtpose_tpu_torch.utils.synth_coco import (OracleMaps, oracle_maps,
                                                   spread_people)

    class View:
        def __init__(self):
            self.shown = []

        def show(self, frame):
            self.shown.append(frame.copy())
            return False

        def close(self):
            pass

    rng = np.random.RandomState(0)
    maps = oracle_maps({(240, 320): spread_people(rng, 2, 240, 320)}, 368)
    frames = [render_scene(i, 240, 320) for i in range(5)]
    shown = {}
    for dev in ("cpu", "cuda"):
        monkeypatch.setattr(camera, "SYSCALLS", ScriptedV4L2(
            {0: ScriptedDevice(frames, offers=("YUYV",))}))
        ticks = iter(10.0 + 0.03 * np.arange(10) ** 1.2)
        view = View()
        kernels.reset_launch_counts()
        n, _ = run_webcam(PosePipeline(OracleMaps(maps), device=dev,
                                       input_size=368, flip=False),
                          camera.open_camera(0), view,
                          clock=lambda: float(next(ticks)))
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        assert n == 5
        for name in ("connection_scores", "bicubic_refine", "group_people"):
            assert counts[name] == (5 if dev == "cuda" else 0), (dev, counts)
        shown[dev] = view.shown
    for got, want in zip(shown["cuda"], shown["cpu"]):
        np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
def test_yuyv_on_the_cards_machine_equals_cv2(cuda):
    """``camera.yuyv_to_bgr`` against the cv2 installed beside the card
    (another version than the CPU tests'), bound 0."""
    cv2 = pytest.importorskip("cv2")
    from rtpose_tpu_torch.demo.camera import yuyv_to_bgr
    rng = np.random.RandomState(0)
    for w in (2, 6, 34, 170, 640):
        buf = rng.randint(0, 256, (24, w, 2)).astype(np.uint8)
        np.testing.assert_array_equal(
            yuyv_to_bgr(buf.tobytes(), 24, w),
            cv2.cvtColor(buf, cv2.COLOR_YUV2BGR_YUYV), err_msg=str(w))


@pytest.mark.gpu
def test_text_on_the_cards_machine_equals_cv2(cuda):
    """``draw.put_text`` against the cv2 installed beside the card, bound
    0, where that cv2 draws FONT_HERSHEY_SIMPLEX as cv2 5 does (the glyph
    table is cv2 5's coverage masks); cv2 4 draws the font as one-bit
    Hershey strokes, another picture (4.13: 1,289-4,262 pixels differ on
    the FPS texts, chip_smoke.py phase 15)."""
    cv2 = pytest.importorskip("cv2")
    if int(cv2.__version__.split(".")[0]) < 5:
        pytest.skip(f"cv2 {cv2.__version__} draws FONT_HERSHEY_SIMPLEX as "
                    f"Hershey strokes, not cv2 5's glyphs")
    from rtpose_tpu_torch.utils.draw import put_text
    rng = np.random.RandomState(0)
    for text in ("0.0 FPS", "29.9 FPS", "12345.6 FPS"):
        want = rng.randint(0, 256, (40, 200, 3)).astype(np.uint8)
        got = want.copy()
        cv2.putText(want, text, (10, 30), cv2.FONT_HERSHEY_SIMPLEX, 1.0,
                    (0, 255, 0), 2)
        put_text(got, text, (10, 30), (0, 255, 0), 2)
        np.testing.assert_array_equal(got, want, err_msg=text)

# ---- the parallel paths (rtpose_tpu_torch/parallel) -------------------------

def _multihost():
    import os
    import sys
    scripts = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    import torch_multihost_check
    return torch_multihost_check


@pytest.mark.gpu
def test_dp_world1_nccl_equals_no_mesh(cuda):
    """A world-1 NCCL process group on the card: ``Trainer(mesh=...)``
    all-reduces (a no-op sum, a division by 1) and takes the unsharded
    trainer's steps; K4 once a step."""
    import torch.distributed as dist
    from rtpose_tpu_torch.parallel.distributed import free_port
    from rtpose_tpu_torch.parallel.mesh import make_mesh
    mh = _multihost()
    batches = mh.make_batches(2)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        kernels.reset_launch_counts()
        dp = mh.train_run(mh.make_cfg(), batches, mesh=make_mesh(),
                          device=cuda)
        launches = kernels.launch_counts()["gt_maps"]
    finally:
        dist.destroy_process_group()
    one = mh.train_run(mh.make_cfg(), batches, device=cuda)
    assert [lg["loss"] for lg in dp["logs"]] == \
        [lg["loss"] for lg in one["logs"]]
    assert launches == len(batches)


@pytest.mark.gpu
def test_dp2_gloo_ranks_on_one_card_equal_one_process(cuda):
    """Two gloo ranks, both on cuda:0, against one process on the card."""
    from rtpose_tpu_torch.parallel.distributed import spawn
    mh = _multihost()
    batches = mh.make_batches(2)
    ranks = spawn(mh.dp_worker, 2, (dict(cfg={}, batches=batches,
                                         device="cuda:0"),))
    one = mh.train_run(mh.make_cfg(), batches, device=cuda)
    one["state"] = {k: v.cpu().numpy() for k, v in one["state"].items()}
    loss, param = mh.max_diffs(ranks[0], one)
    assert loss <= 1e-5 * max(lg["loss"] for lg in one["logs"])
    assert param <= mh.PARAM_ATOL


@pytest.mark.gpu
def test_sharded_pipeline_launches_once_a_shard(cuda):
    """PosePipeline on ["cuda:0", "cuda:0"]: a replica a shard, K1, K3 and
    G once a shard, the unsharded pipeline's people."""
    from rtpose_tpu_torch.infer.pipeline import load_pipeline
    from rtpose_tpu_torch.parallel.mesh import make_mesh
    kw = dict(num_stages=1, input_size=56, seed=0, dtype=torch.float32)
    pipe = load_pipeline(device=cuda, **kw)
    pipe_sh = load_pipeline(mesh=make_mesh(devices=[cuda, cuda]), **kw)
    frames = [np.random.RandomState(i).randint(0, 256, (60, 80, 3),
                                               np.uint8) for i in range(5)]
    kernels.reset_launch_counts()
    got = pipe_sh.run_batch(frames)
    counts = kernels.launch_counts()
    assert all(counts[k] == 2 for k in ("connection_scores",
                                        "bicubic_refine", "group_people"))
    want = pipe.run_batch(frames)
    assert [len(p) for p in got[0]] == [len(p) for p in want[0]]


def _workflow_script(name):
    """A workflow script of scripts/ as a module."""
    import importlib
    import os
    import sys
    scripts = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    return importlib.import_module(name)


@pytest.mark.gpu
def test_soak_on_card_matches_the_host_oracle(cuda, capsys):
    """64 scenes of 1-8 people decoded on the card (K1, K3, G) against
    the host oracle: no count mismatch, no overflow left unfixed."""
    soak = _workflow_script("torch_soak_decode")
    summary = soak.main(["--scenes", "64"])
    assert summary["count_mismatch"] == 0
    assert summary["overflow_unfixed"] == 0
    for k in ("connection_scores", "bicubic_refine", "group_people"):
        assert summary["launches"][k] >= 2, k


@pytest.mark.gpu
def test_train_synth_restore_on_card(cuda, tmp_path):
    """The schedule restored at epoch 2 takes up the last checkpoint's
    step, lr and trajectory (bf16 on the card: losses within 1e-2 of an
    uninterrupted run's), with K4 once a step."""
    synth = _workflow_script("torch_train_synth")

    def run(out, restore_at):
        return synth.main(["--size", "64", "--stages", "1", "--batch", "8",
                           "--steps-per-epoch", "4", "--epochs", "3",
                           "--pool-batches", "2", "--restore-at-epoch",
                           str(restore_at), "--out", str(out)])

    restored = run(tmp_path / "restored", 2)
    straight = run(tmp_path / "straight", 99)
    marker = restored["restored"]
    assert marker["restored_step"] == marker["last_checkpoint_step"] == 8
    assert restored["launches"]["gt_maps"] == 3 * 4 + 3 * 2
    for a, b in zip(restored["epochs"], straight["epochs"]):
        assert a["step"] == b["step"] and a["lr"] == b["lr"]
        for k in ("train_loss", "val_loss"):
            assert math.isfinite(a[k])
            assert abs(a[k] - b[k]) <= 1e-2 * abs(b[k]), (k, a, b)


def _planes(h, w, seed, pitch_pad=0):
    """Random 4:2:0 planes on the card, rows `pitch_pad` bytes past the
    picture (a decoder's linesize)."""
    rng = np.random.RandomState(seed)
    ch, cw = (h + 1) // 2, (w + 1) // 2
    return [torch.from_numpy(rng.randint(0, 256, s).astype(np.uint8))
            for s in ((h, w + pitch_pad), (ch, cw + pitch_pad),
                      (ch, cw + pitch_pad))]


@pytest.mark.gpu
@pytest.mark.parametrize("rotation", [0, 90, 180, 270])
@pytest.mark.parametrize("hw,pad", [((480, 640), 0), ((480, 640), 64),
                                    ((50, 70), 10), ((34, 18), 0),
                                    ((7, 5), 3), ((65, 131), 0),
                                    ((33, 129), 5), ((1080, 1920), 0)])
def test_yuv420_kernel_matches_plain(cuda, rotation, hw, pad):
    h, w = hw
    planes = _planes(h, w, seed=h + w + pad, pitch_pad=pad)
    kernels.reset_launch_counts()
    got = kernels.yuv420_to_bgr(*[p.to(cuda) for p in planes], width=w,
                                rotation=rotation)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["yuv420_to_bgr"] == 1
    want = kernels.yuv420_to_bgr_plain(*planes, width=w, rotation=rotation)
    assert got.shape == want.shape and got.is_contiguous()
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("rotation", [0, 90, 180, 270])
@pytest.mark.parametrize("matrix,full", [(2, False), (2, True), (1, False),
                                         (1, True), (4, False), (4, True),
                                         (7, False), (7, True), (9, False),
                                         (9, True)])
def test_yuv420_kernel_matches_plain_for_every_colour(cuda, rotation, matrix,
                                                      full):
    """The 8-bit kernel with each (matrix, range)'s constants."""
    planes = _planes(50, 70, seed=matrix + 10 * full, pitch_pad=10)
    rule = kernels.yuv_rule(matrix, full)
    got = kernels.yuv420_to_bgr(*[p.to(cuda) for p in planes], width=70,
                                rotation=rotation, rule=rule)
    want = kernels.yuv420_to_bgr_plain(*planes, width=70, rotation=rotation,
                                       rule=rule)
    assert torch.equal(got.cpu(), want)


def _planes10(h, w, seed, pitch_pad=0):
    """Random 10-bit 4:2:0 planes (uint16), rows `pitch_pad` samples past
    the picture."""
    rng = np.random.RandomState(seed)
    ch, cw = (h + 1) // 2, w // 2
    return [torch.from_numpy(rng.randint(0, 1024, s).astype(np.uint16))
            for s in ((h, w + pitch_pad), (ch, cw + pitch_pad),
                      (ch, cw + pitch_pad))]


@pytest.mark.gpu
@pytest.mark.parametrize("rotation", [0, 90, 180, 270])
@pytest.mark.parametrize("hw,pad", [((480, 640), 0), ((480, 640), 32),
                                    ((31, 64), 8), ((9, 8), 0),
                                    ((17, 130), 0), ((41, 72), 3),
                                    ((1080, 1920), 0), ((2160, 3840), 0)])
@pytest.mark.parametrize("location", [0, 1, 2, 3, 5])
def test_yuv420p10_kernel_matches_plain(cuda, rotation, hw, pad, location):
    h, w = hw
    planes = _planes10(h, w, seed=h + w + pad + location, pitch_pad=pad)
    kernels.reset_launch_counts()
    for matrix, full in ((2, False), (9, False), (1, True)):
        rule = kernels.yuv_rule(matrix, full)
        got = kernels.yuv420p10_to_bgr(*[p.to(cuda) for p in planes],
                                       width=w, rotation=rotation, rule=rule,
                                       chroma_location=location)
        want = kernels.yuv420p10_to_bgr_plain(
            *planes, width=w, rotation=rotation, rule=rule,
            chroma_location=location)
        assert got.shape == want.shape and got.is_contiguous()
        assert torch.equal(got.cpu(), want)
    assert kernels.launch_counts()["yuv420p10_to_bgr"] == 3


def _at_offset(planes, offset, cuda):
    """The planes on the card, each a contiguous view whose data starts
    `offset` elements into a larger buffer (a base off 16 bytes)."""
    out = []
    for p in planes:
        buf = torch.zeros(p.numel() + offset, dtype=p.dtype, device=cuda)
        view = buf[offset:].view(p.shape)
        view.copy_(p.to(cuda))
        out.append(view)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("rotation", [0, 90, 180, 270])
@pytest.mark.parametrize("hw,pad", [((480, 640), 64), ((50, 70), 10),
                                    ((65, 131), 0)])
@pytest.mark.parametrize("offset", [1, 3, 8])
def test_yuv420_kernel_matches_plain_at_unaligned_bases(cuda, rotation, hw,
                                                        pad, offset):
    """Planes whose base addresses are off 16 bytes: the kernel's narrow
    loads, the same frame."""
    h, w = hw
    planes = _planes(h, w, seed=h + w + offset, pitch_pad=pad)
    got = kernels.yuv420_to_bgr(*_at_offset(planes, offset, cuda), width=w,
                                rotation=rotation)
    want = kernels.yuv420_to_bgr_plain(*planes, width=w, rotation=rotation)
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("rotation", [0, 90, 180, 270])
@pytest.mark.parametrize("hw,pad", [((480, 640), 32), ((41, 72), 3),
                                    ((17, 130), 0)])
@pytest.mark.parametrize("offset", [1, 3, 4])
def test_yuv420p10_kernel_matches_plain_at_unaligned_bases(cuda, rotation,
                                                           hw, pad, offset):
    """10-bit planes whose base addresses are off 16 bytes (2, 6 and 8
    bytes in)."""
    h, w = hw
    planes = _planes10(h, w, seed=h + w + offset, pitch_pad=pad)
    rule = kernels.yuv_rule(9, False)
    got = kernels.yuv420p10_to_bgr(*_at_offset(planes, offset, cuda),
                                   width=w, rotation=rotation, rule=rule)
    want = kernels.yuv420p10_to_bgr_plain(*planes, width=w,
                                          rotation=rotation, rule=rule)
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_main10_video_reads_on_the_card_as_on_the_cpu(cuda, tmp_path):
    """A PCM HEVC Main 10 MP4 (BT.2020 limited) read on the card: one
    10-bit launch a frame, the CPU's frames."""
    from rtpose_tpu_torch.demo import scripted_video as sv
    from rtpose_tpu_torch.demo.video_io import open_video
    path = str(tmp_path / "main10.mp4")
    sv.write_hevc_mp4(path, sv.encode_hevc_pcm(
        sv.yuv_frames10(4, 48, 64), depth=10, colour=sv.Colour(9)),
        rotation=90)
    frames = {}
    for device in ("cpu", cuda):
        kernels.reset_launch_counts()
        cap = open_video(path, device=device)
        frames[str(device)] = [f for ok, f in iter(cap.read, (False, None))]
        cap.release()
    assert kernels.launch_counts()["yuv420p10_to_bgr"] == 4
    assert len(frames["cpu"]) == 4
    for a, b in zip(frames["cpu"], frames[str(cuda)]):
        np.testing.assert_array_equal(a, b)


def _planes_at(depth, h, w, seed, pitch_pad=0):
    """Random `depth`-bit 4:2:0 planes of a height x width picture (uint8
    or uint16; chroma (h + 1) // 2 x (w + 1) // 2), rows `pitch_pad`
    samples past the picture."""
    rng = np.random.RandomState(seed)
    dtype = np.uint8 if depth == 8 else np.uint16
    ch, cw = (h + 1) // 2, (w + 1) // 2
    return [torch.from_numpy(rng.randint(0, 1 << depth, s).astype(dtype))
            for s in ((h, w + pitch_pad), (ch, cw + pitch_pad),
                      (ch, cw + pitch_pad))]


@pytest.mark.gpu
@pytest.mark.parametrize("rotation", [0, 90, 180, 270])
@pytest.mark.parametrize("hw,pad", [((479, 640), 0), ((479, 640), 32),
                                    ((9, 8), 0),
                                    ((31, 64), 8), ((33, 66), 3),
                                    ((63, 130), 0), ((65, 128), 5),
                                    ((95, 34), 1)])
@pytest.mark.parametrize("location", [0, 1, 3])
def test_yuv420_general_kernel_matches_plain(cuda, rotation, hw, pad,
                                            location):
    """The 8-bit general-path kernel (odd heights) at tile edges, padded
    pitches, each turn and chroma location."""
    h, w = hw
    planes = _planes_at(8, h, w, seed=h + w + pad + location, pitch_pad=pad)
    kernels.reset_launch_counts()
    for matrix, full in ((2, False), (9, False), (1, True)):
        rule = kernels.yuv_rule(matrix, full)
        got = kernels.yuv420_general_to_bgr(
            *[p.to(cuda) for p in planes], width=w, rotation=rotation,
            rule=rule, chroma_location=location)
        want = kernels.general_to_bgr_plain(
            *planes, width=w, depth=8, rotation=rotation, rule=rule,
            chroma_location=location)
        assert got.shape == want.shape and got.is_contiguous()
        assert torch.equal(got.cpu(), want)
    assert kernels.launch_counts()["yuv420_general_to_bgr"] == 3


@pytest.mark.gpu
@pytest.mark.parametrize("rotation", [0, 90, 180, 270])
@pytest.mark.parametrize("depth,hw,pad", [
    (8, (479, 639), 0), (8, (479, 639), 33), (8, (9, 9), 0),
    (8, (31, 47), 0), (8, (31, 63), 4), (8, (33, 65), 0), (8, (65, 33), 7),
    (8, (1079, 1919), 0),
    (10, (480, 639), 0), (10, (480, 639), 16), (10, (9, 9), 0),
    (10, (31, 47), 0), (10, (10, 15), 0), (10, (32, 47), 3),
    (10, (64, 129), 0), (10, (95, 31), 5), (10, (1080, 1919), 0),
    (10, (2160, 3839), 0)])
@pytest.mark.parametrize("location", [0, 1, 3])
def test_yuv420_full_chroma_kernel_matches_plain(cuda, rotation, depth, hw,
                                                pad, location):
    """The full-chroma kernel (odd widths) at both depths, ragged tiles,
    HD and 4K, padded pitches, each turn and chroma location (the plain
    version on the card above a megapixel: integer ops, the CPU's
    results)."""
    h, w = hw
    planes = _planes_at(depth, h, w, seed=h + w + pad + location,
                        pitch_pad=pad)
    ref = [p.to(cuda) for p in planes] if h * w > 1 << 20 else planes
    kernels.reset_launch_counts()
    for matrix, full in ((2, False), (9, False), (1, True)):
        rule = kernels.yuv_rule(matrix, full)
        got = kernels.yuv420_full_chroma_to_bgr(
            *[p.to(cuda) for p in planes], width=w, depth=depth,
            rotation=rotation, rule=rule, chroma_location=location)
        want = kernels.full_chroma_to_bgr_plain(
            *ref, width=w, depth=depth, rotation=rotation, rule=rule,
            chroma_location=location)
        assert got.shape == want.shape and got.is_contiguous()
        assert torch.equal(got.cpu(), want.cpu())
    assert kernels.launch_counts()["yuv420_full_chroma_to_bgr"] == 3


def _saturated_planes(depth, h, w, seed):
    """4:2:0 planes of 8x8 blocks (4x4 in chroma) of flat 0 or top
    samples, the top-left block at the top: the horizontal filter's
    overshoot at the blocks' edges reaches its clamp at 32767, and a flat
    bright pixel of strong chroma wraps the 32-bit sums."""
    rng = np.random.RandomState(seed)
    dtype = np.uint8 if depth == 8 else np.uint16
    top = (1 << depth) - 1
    out = []
    for rows, cols, block in ((h, w, 8), ((h + 1) // 2, (w + 1) // 2, 4),
                              ((h + 1) // 2, (w + 1) // 2, 4)):
        coarse = rng.randint(0, 2, (rows // block + 1,
                                    cols // block + 1)) * top
        coarse[0, 0] = top
        vals = np.kron(coarse, np.ones((block, block), np.int64))
        out.append(torch.from_numpy(vals[:rows, :cols].astype(dtype)))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("rotation", [0, 90, 180, 270])
@pytest.mark.parametrize("depth,hw", [(8, (9, 9)), (8, (31, 47)),
                                      (8, (479, 639)), (10, (9, 9)),
                                      (10, (31, 47)), (10, (480, 639))])
def test_yuv420_full_chroma_kernel_wraps_as_plain(cuda, rotation, depth,
                                                  hw):
    """Saturated fields through the full-chroma kernel at every (matrix,
    range): its clamped horizontal sums and 32-bit unsigned output sums
    give the plain version's frame, the wrapped blue of BT.709 limited's
    bright strong-U pixels (0, not 255) included."""
    h, w = hw
    planes = _saturated_planes(depth, h, w, seed=h * w + depth)
    for matrix in (2, 1, 4, 7, 9):
        for full in (False, True):
            rule = kernels.yuv_rule(matrix, full)
            for location in (0, 1):
                got = kernels.yuv420_full_chroma_to_bgr(
                    *[p.to(cuda) for p in planes], width=w, depth=depth,
                    rotation=rotation, rule=rule, chroma_location=location)
                want = kernels.full_chroma_to_bgr_plain(
                    *planes, width=w, depth=depth, rotation=rotation,
                    rule=rule, chroma_location=location)
                assert torch.equal(got.cpu(), want), (matrix, full,
                                                      location)
    plain = kernels.full_chroma_to_bgr_plain(
        *planes, width=w, depth=depth, rule=kernels.yuv_rule(1, False),
        chroma_location=1)
    assert plain[0, 0, 0] == 0      # Y and U at the top: blue wrapped


@pytest.mark.gpu
@pytest.mark.parametrize("rotation", [0, 90, 180, 270])
@pytest.mark.parametrize("depth,hw,pad", [(8, (479, 640), 32),
                                          (8, (33, 66), 3),
                                          (8, (31, 47), 0),
                                          (10, (480, 639), 16),
                                          (10, (41, 65), 3)])
@pytest.mark.parametrize("offset", [1, 3, 8])
def test_general_path_kernels_match_plain_at_unaligned_bases(
        cuda, rotation, depth, hw, pad, offset):
    """Planes whose base addresses are off 16 bytes, through the route
    (the general kernel at an even width, the full-chroma one at an odd
    width)."""
    h, w = hw
    planes = _planes_at(depth, h, w, seed=h + w + offset, pitch_pad=pad)
    rule = kernels.yuv_rule(1, False)
    got = kernels.yuv420_frame_to_bgr(
        *_at_offset(planes, offset, cuda), depth=depth, width=w,
        rotation=rotation, rule=rule, chroma_location=1)
    plain = (kernels.general_to_bgr_plain if w % 2 == 0
             else kernels.full_chroma_to_bgr_plain)
    want = plain(*planes, width=w, depth=depth, rotation=rotation,
                 rule=rule, chroma_location=1)
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("depth,h,w,kernel", [
    (8, 32, 48, "yuv420_to_bgr"), (8, 32, 47, "yuv420_to_bgr"),
    (8, 31, 48, "yuv420_general_to_bgr"),
    (8, 31, 47, "yuv420_full_chroma_to_bgr"),
    (10, 32, 48, "yuv420p10_to_bgr"), (10, 31, 48, "yuv420p10_to_bgr"),
    (10, 32, 47, "yuv420_full_chroma_to_bgr")])
def test_route_launches_one_kernel_on_the_card(cuda, depth, h, w, kernel):
    """A frame on the card launches the one kernel of swscale's path at
    its depth and size, and no other: even-height 8-bit frames and
    even-width 10-bit ones as before."""
    planes = _planes_at(depth, h, w, seed=h * w)
    kernels.reset_launch_counts()
    got = kernels.yuv420_frame_to_bgr(*[p.to(cuda) for p in planes],
                                      depth=depth, width=w,
                                      chroma_location=0)
    counts = kernels.launch_counts()
    assert counts[kernel] == 1 and sum(
        counts[k] for k in ("yuv420_to_bgr", "yuv420p10_to_bgr",
                            "yuv420_general_to_bgr",
                            "yuv420_full_chroma_to_bgr")) == 1, counts
    want = kernels.yuv420_frame_to_bgr(*planes, depth=depth, width=w,
                                       chroma_location=0)
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("name,kernel", [
    ("vp9_31x48.webm", "yuv420_general_to_bgr"),
    ("vp9_479x640.webm", "yuv420_general_to_bgr"),
    ("vp9_31x47.webm", "yuv420_full_chroma_to_bgr"),
    ("vp9p2_31x65.webm", "yuv420_full_chroma_to_bgr")])
def test_odd_size_video_reads_on_the_card_as_on_the_cpu(cuda, name,
                                                        kernel):
    """The committed odd-size VP9 fixtures (an odd-height 8-bit file, an
    odd-width 10-bit one, ...) read on the card: one launch a frame of
    the route's kernel, the CPU's frames."""
    from rtpose_tpu_torch.demo import scripted_video as sv
    from rtpose_tpu_torch.demo.video_io import open_video
    fixture = {f.name: f for f in sv.ODD_SIZE_FIXTURES}[name]
    path = sv.odd_size_path(fixture)
    frames = {}
    for device in ("cpu", cuda):
        kernels.reset_launch_counts()
        cap = open_video(path, device=device)
        frames[str(device)] = [f for ok, f in iter(cap.read, (False, None))]
        cap.release()
    counts = kernels.launch_counts()
    assert counts[kernel] == fixture.frames and counts["yuv420_to_bgr"] == 0
    assert len(frames["cpu"]) == fixture.frames
    for a, b in zip(frames["cpu"], frames[str(cuda)]):
        np.testing.assert_array_equal(a, b)


def _ipcm_sequence(h, w):
    from rtpose_tpu_torch.demo import scripted_video as sv
    pics = sv.yuv_frames(4, h, w, seed=16)
    seq = [pics[0], pics[1], None, pics[2], None, pics[3]]
    shown = []
    for p in seq:
        shown.append(shown[-1] if p is None else p)
    return seq, shown


@pytest.mark.gpu
@pytest.mark.parametrize("rotation", [0, 90, 180, 270])
def test_h264_file_on_card_equals_the_written_pictures(cuda, tmp_path,
                                                       rotation):
    """An I_PCM H.264 MP4 at 480x640: libavcodec's planes are the written
    ones exactly, and open_video's frames on the card are their plain
    conversion, turned by the tag."""
    from rtpose_tpu_torch.demo import mp4
    from rtpose_tpu_torch.demo import scripted_video as sv
    from rtpose_tpu_torch.demo.video_io import open_video
    from rtpose_tpu_torch.native import avcodec
    h, w = 480, 640
    seq, shown = _ipcm_sequence(h, w)
    path = str(tmp_path / "v.mp4")
    sv.write_ipcm_mp4(path, seq, key_every=3, rotation=rotation)
    decoder = avcodec.Decoder("h264")
    got = []
    with open(path, "rb") as f:
        for data, key in mp4.read_track(path, f).packets(f):
            got += [(y[:, :w].copy(), u[:, :w // 2].copy(),
                     v[:, :w // 2].copy())
                    for y, u, v, _ in decoder.decode(data, key)]
    got += [(y[:, :w].copy(), u[:, :w // 2].copy(), v[:, :w // 2].copy())
            for y, u, v, _ in decoder.flush()]
    decoder.close()
    assert len(got) == len(shown)
    for g, s in zip(got, shown):
        for a, b in zip(g, s):
            np.testing.assert_array_equal(a, b)
    kernels.reset_launch_counts()
    cap = open_video(path, device=cuda)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    assert kernels.launch_counts()["yuv420_to_bgr"] == len(shown)
    assert cap.size == ((h, w) if rotation % 180 else (w, h))
    for frame, planes in zip(frames, shown):
        want = kernels.yuv420_to_bgr_plain(*map(torch.from_numpy, planes),
                                           width=w, rotation=rotation)
        np.testing.assert_array_equal(frame, want.numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("name,fourcc", [("v.mp4", "mp4v"),
                                         ("v.avi", "XVID")])
def test_mpeg4_files_of_the_cards_cv2(cuda, tmp_path, name, fourcc):
    """MPEG-4 Part 2 written by the card machine's cv2 (the port has
    none): open_video gives cv2's frame count and cv2's frames (the same
    wheel's libavcodec decodes them; cv2 4.13's swscale converts as cv2
    5.0's, which the conversion matches: no pixel differs on an H100's
    machine)."""
    cv2 = pytest.importorskip("cv2")
    from rtpose_tpu_torch.data.imread_fixtures import render_scene
    from rtpose_tpu_torch.demo.video_io import open_video
    path = str(tmp_path / name)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), 20.0,
                             (640, 480))
    for i in range(12):
        writer.write(np.ascontiguousarray(render_scene(i, 480, 640)))
    writer.release()
    cap = cv2.VideoCapture(path)
    count = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    want = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        want.append(frame)
    ours = open_video(path, device=cuda)
    got = []
    while True:
        ok, frame = ours.read()
        if not ok:
            break
        got.append(frame)
    ours.release()
    assert len(got) == len(want) == count == ours.frame_count == 12
    diff = max(int(np.abs(a.astype(np.int16) - b).max())
               for a, b in zip(got, want))
    print(f"{name}: largest pixel difference from cv2 {cv2.__version__}: "
          f"{diff}")
    assert diff == 0


@pytest.mark.gpu
@pytest.mark.parametrize("name,fourcc", [("v.ts", "MPG2"), ("v1.ts", "PIM1"),
                                         ("v4.ts", "mp4v"),
                                         ("v.m2ts", "MPG2")])
def test_transport_streams_of_the_cards_cv2(cuda, tmp_path, name, fourcc):
    """MPEG-1/2 and MPEG-4 Part 2 in TS / M2TS written by the card
    machine's cv2: open_video on the card gives cv2's frames, fps and
    frame count (MPEG-1 at the doubled rate libavformat reports), one
    conversion launch a frame."""
    cv2 = pytest.importorskip("cv2")
    from rtpose_tpu_torch.demo import scripted_video as sv
    from rtpose_tpu_torch.demo.video_io import open_video
    path = str(tmp_path / name)
    sv.write_cv2_video(path, fourcc, 12, 480, 640, fps=25.0)
    cap = cv2.VideoCapture(path)
    count, fps = int(cap.get(cv2.CAP_PROP_FRAME_COUNT)), cap.get(
        cv2.CAP_PROP_FPS)
    want = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        want.append(frame)
    kernels.reset_launch_counts()
    ours = open_video(path, device=cuda)
    got = []
    while True:
        ok, frame = ours.read()
        if not ok:
            break
        got.append(frame)
    ours.release()
    assert len(got) == len(want) == 12
    assert (ours.frame_count, ours.fps) == (count, fps)
    assert kernels.launch_counts()["yuv420_to_bgr"] == 12
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
def test_hevc_file_on_card_equals_the_written_pictures(cuda, tmp_path):
    """PCM HEVC at 480x640 (P-skip repeats, an IDR every 3): the card
    machine's libavcodec gives the written planes exactly, and open_video
    of the hvc1 MP4 gives their plain conversion, once a frame."""
    from rtpose_tpu_torch.demo import scripted_video as sv
    from rtpose_tpu_torch.demo.video_io import open_video
    from rtpose_tpu_torch.native import avcodec
    h, w = 480, 640
    seq, shown = _ipcm_sequence(h, w)
    stream = sv.encode_hevc_pcm(seq, key_every=3)
    decoder, parser = avcodec.Decoder("hevc"), avcodec.Parser("hevc")
    got = []
    for frame in parser.parse(sv.hevc_annexb(stream)) + parser.flush():
        got += [(y[:, :w].copy(), u[:, :w // 2].copy(),
                 v[:, :w // 2].copy()) for y, u, v, _ in
                decoder.decode(frame)]
    got += [(y[:, :w].copy(), u[:, :w // 2].copy(), v[:, :w // 2].copy())
            for y, u, v, _ in decoder.flush()]
    decoder.close()
    parser.close()
    assert len(got) == len(shown)
    for g, p in zip(got, shown):
        for a, b in zip(g, p):
            np.testing.assert_array_equal(a, b)
    path = str(tmp_path / "v.mp4")
    sv.write_hevc_mp4(path, stream)
    kernels.reset_launch_counts()
    cap = open_video(path, device=cuda)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    assert kernels.launch_counts()["yuv420_to_bgr"] == len(shown)
    assert cap.codec == "hevc" and len(frames) == len(shown)
    for frame, planes in zip(frames, shown):
        want = kernels.yuv420_to_bgr_plain(*map(torch.from_numpy, planes),
                                           width=w)
        np.testing.assert_array_equal(frame, want.numpy())


HEVC_PS_FILES = ["hvc1.mp4", "hev1.mp4", "hevc.mkv", "hevc.ts", "hevc.m2ts",
                 "hevc_reordered.mp4", "hevc_cropped.mkv", "mpeg4.mpg",
                 "mpeg1.mpg", "mpeg2.mpg", "mpeg4.vob", "h264.mpg",
                 "h264_psm.mpg", "hevc.mpg", "hevc_psm.vob"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", HEVC_PS_FILES)
def test_hevc_and_program_streams_of_the_cards_cv2(cuda, tmp_path, name):
    """HEVC in MP4 (hvc1, hev1), Matroska and TS / M2TS, reordered and
    cropped; the card machine's cv2's own .mpg (MPEG-4, MPEG-1, MPEG-2)
    and .vob; I_PCM H.264 and PCM HEVC program streams with and without a
    map: open_video on the card gives that cv2's frames, fps and frame
    count, the conversion once a frame."""
    cv2 = pytest.importorskip("cv2")
    from rtpose_tpu_torch.demo import scripted_video as sv
    from rtpose_tpu_torch.demo.video_io import open_video
    path = str(tmp_path / name)
    stem, ext = name.split(".")
    seq, _ = _ipcm_sequence(96, 128)
    if stem in ("mpeg4", "mpeg1", "mpeg2"):
        sv.write_cv2_video(path, {"mpeg4": "mp4v", "mpeg1": "PIM1",
                                  "mpeg2": "MPG2"}[stem], 12, 96, 128,
                           fps=25.0)
    elif stem.startswith("h264"):
        sv.write_ipcm_ps(path, seq, key_every=3, psm="psm" in stem)
    else:
        if "reordered" in stem:
            stream = sv.encode_hevc_pcm(sv.yuv_frames(7, 96, 128),
                                        reorder=True)
        elif "cropped" in stem:
            stream = sv.encode_hevc_pcm(sv.yuv_frames(4, 90, 60))
        else:
            stream = sv.encode_hevc_pcm(seq, key_every=3)
        if ext == "mp4":
            sv.write_hevc_mp4(path, stream, kind=stem[:4]
                              if stem[:4] in ("hvc1", "hev1") else "hvc1")
        elif ext == "mkv":
            sv.write_hevc_mkv(path, stream)
        elif ext in ("ts", "m2ts"):
            sv.write_hevc_ts(path, stream, packet_size=188 if ext == "ts"
                             else 192)
        else:
            sv.write_hevc_ps(path, stream, psm="psm" in stem,
                             dvd=ext == "vob")
    cap = cv2.VideoCapture(path)
    count, fps = int(cap.get(cv2.CAP_PROP_FRAME_COUNT)), cap.get(
        cv2.CAP_PROP_FPS)
    want = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        want.append(frame)
    kernels.reset_launch_counts()
    ours = open_video(path, device=cuda)
    got = []
    while True:
        ok, frame = ours.read()
        if not ok:
            break
        got.append(frame)
    ours.release()
    assert len(got) == len(want) > 0
    assert (ours.frame_count, ours.fps) == (count, fps)
    assert kernels.launch_counts()["yuv420_to_bgr"] == len(got)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
def test_video_route_probe_and_no_quiet_fallback(cuda, tmp_path,
                                                 monkeypatch):
    """The probe names both routes and the hevc decoder and parser (and
    what reads AV1); without libavcodec an H.264 open raises instead of
    taking another decoder."""
    from rtpose_tpu_torch.demo import scripted_video as sv
    from rtpose_tpu_torch.demo.video_io import open_video
    from rtpose_tpu_torch.native import avcodec
    probe = _workflow_script("torch_probe_video").probe()
    print(json.dumps(probe))
    assert probe["libavcodec"]["h264"] == probe["libavcodec"]["mpeg4"] \
        == probe["libavcodec"]["hevc"] == "opens"
    assert probe["libavcodec"]["parsers"]["hevc"] == "hevc initialises"
    assert "decoders" in probe["av1"]
    assert "library" in probe["nvdec"]
    path = str(tmp_path / "v.mp4")
    sv.write_ipcm_mp4(path, _ipcm_sequence(48, 64)[0])
    monkeypatch.setattr(avcodec, "_libs", None)
    monkeypatch.setattr(avcodec, "_library_dirs", lambda: [])
    with pytest.raises(RuntimeError, match="no libavcodec found"):
        open_video(path, device=cuda)


def _cv2_frames(cv2, path):
    cap = cv2.VideoCapture(path)
    cap.set(cv2.CAP_PROP_ORIENTATION_AUTO, 1)
    count = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return frames, count


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["committed.webm", "superframe.webm",
                                  "xvid.mkv", "ipcm_live.mkv",
                                  "bframes_nohint.mkv"])
def test_matroska_files_on_the_card(cuda, tmp_path, name):
    """Matroska / WebM on the card against the card machine's cv2: the
    committed VP9 WebM (cv2 5.0's), its superframe variant, an MPEG-4 MKV
    of that cv2, I_PCM H.264 with unknown sizes and B-frame H.264 without
    the reorder hint: cv2's frames and count, the conversion once a
    frame."""
    cv2 = pytest.importorskip("cv2")
    from rtpose_tpu_torch.demo import scripted_video as sv
    from rtpose_tpu_torch.demo.video_io import open_video
    path = str(tmp_path / name)
    if name == "committed.webm":
        path = sv.VP9_WEBM
    elif name == "superframe.webm":
        sv.write_vp9_superframe(sv.VP9_WEBM, path)
    elif name == "xvid.mkv":
        sv.write_cv2_video(path, "XVID", 12, 480, 640)
    elif name == "ipcm_live.mkv":
        sv.write_ipcm_mkv(path, _ipcm_sequence(480, 640)[0],
                          unknown_sizes=True)
    else:
        sv.write_bframes(path, sv.yuv_frames(4, 480, 640, seed=2),
                         reorder=None, poc_step=1, container="mkv")
    want, count = _cv2_frames(cv2, path)
    kernels.reset_launch_counts()
    cap = open_video(path, device=cuda)
    got = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        got.append(frame)
    cap.release()
    assert kernels.launch_counts()["yuv420_to_bgr"] == len(got)
    assert len(got) == len(want) == count == cap.frame_count
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
def test_xvid_writer_packets_equal_the_cards_cv2(cuda, tmp_path):
    """The XVID writer's packets for 16 rendered 480x640 frames against
    the card machine's cv2 ``VideoWriter(..., 'XVID')``."""
    cv2 = pytest.importorskip("cv2")
    from rtpose_tpu_torch.data.imread_fixtures import render_scene
    from rtpose_tpu_torch.demo.video_io import AviStream, VideoWriter
    frames = [np.ascontiguousarray(render_scene(i, 480, 640))
              for i in range(16)]
    paths = [str(tmp_path / "cv2.avi"), str(tmp_path / "port.avi")]
    writer = cv2.VideoWriter(paths[0], cv2.VideoWriter_fourcc(*"XVID"),
                             20.0, (640, 480))
    ours = VideoWriter(paths[1], 20.0, (640, 480), fourcc="XVID")
    for f in frames:
        writer.write(f)
        ours.write(f)
    writer.release()
    ours.release()
    packets = []
    for path in paths:
        with open(path, "rb") as f:
            stream = AviStream(path, f)
            packets.append([])
            for off, n in stream.frames:
                f.seek(off)
                packets[-1].append(f.read(n))
    assert len(packets[1]) == 16 and packets[0] == packets[1]


# -- the other chroma formats and 12-bit 4:2:0 (csrc/yuv_planar_to_bgr.cu) --

PLANAR_CASES = [  # (chroma, depth, (h, w), the kernel its route launches)
    ((1, 0), 8, (48, 64), "yuv422_to_bgr"),
    ((1, 0), 8, (480, 639), "yuv422_to_bgr"),
    ((1, 0), 8, (47, 64), "yuv_planar_general_to_bgr"),
    ((1, 0), 10, (480, 640), "yuv_planar_general_to_bgr"),
    ((1, 0), 12, (33, 66), "yuv_planar_general_to_bgr"),
    ((1, 0), 10, (31, 47), "yuv_planar_full_chroma_to_bgr"),
    ((0, 1), 8, (33, 64), "yuv_planar_general_to_bgr"),
    ((0, 1), 12, (48, 63), "yuv_planar_full_chroma_to_bgr"),
    ((0, 0), 8, (9, 8), "yuv_planar_full_chroma_to_bgr"),
    ((0, 0), 10, (65, 131), "yuv_planar_full_chroma_to_bgr"),
    ((1, 1), 12, (480, 640), "yuv_planar_general_to_bgr"),
    ((1, 1), 12, (31, 47), "yuv_planar_full_chroma_to_bgr"),
    # tiles ragged on both edges at every turn, each tap class
    ((1, 0), 10, (65, 66), "yuv_planar_general_to_bgr"),
    ((1, 0), 8, (33, 66), "yuv_planar_general_to_bgr"),
    ((1, 0), 10, (33, 65), "yuv_planar_full_chroma_to_bgr"),
    ((1, 0), 8, (65, 65), "yuv_planar_full_chroma_to_bgr"),
    ((0, 1), 10, (65, 66), "yuv_planar_general_to_bgr"),
    ((0, 1), 8, (33, 65), "yuv_planar_full_chroma_to_bgr"),
    ((0, 0), 8, (33, 66), "yuv_planar_full_chroma_to_bgr"),
    ((0, 0), 12, (65, 65), "yuv_planar_full_chroma_to_bgr"),
    ((1, 1), 12, (65, 66), "yuv_planar_general_to_bgr"),
    ((1, 1), 12, (33, 65), "yuv_planar_full_chroma_to_bgr"),
    ((1, 0), 10, (2160, 3840), "yuv_planar_general_to_bgr"),
    (None, 8, (47, 63), "gray_to_bgr"),
    (None, 10, (480, 640), "gray_to_bgr"),
    (None, 12, (9, 9), "gray_to_bgr"),
    # the unscaled 4:2:2 and gray tiles: ragged on both edges at every
    # turn, and 4K
    ((1, 0), 8, (66, 65), "yuv422_to_bgr"),
    ((1, 0), 8, (34, 129), "yuv422_to_bgr"),
    ((1, 0), 8, (2160, 3840), "yuv422_to_bgr"),
    (None, 8, (65, 66), "gray_to_bgr"),
    (None, 10, (33, 129), "gray_to_bgr"),
    (None, 8, (2160, 3840), "gray_to_bgr")]
PLANAR_KERNELS = ("yuv420_to_bgr", "yuv420p10_to_bgr",
                  "yuv420_general_to_bgr", "yuv420_full_chroma_to_bgr",
                  "yuv422_to_bgr", "yuv_planar_general_to_bgr",
                  "yuv_planar_full_chroma_to_bgr", "gray_to_bgr")


def _format_planes(chroma, depth, h, w, seed, pitch_pad=0):
    """Random planes of the chroma format `chroma` (None: the luma alone),
    rows `pitch_pad` samples past the picture; u and v None for gray."""
    rng = np.random.RandomState(seed)
    dtype = np.uint8 if depth == 8 else np.uint16
    shapes = [(h, w)] + ([] if chroma is None else
                         [kernels.chroma_shape(chroma, h, w)] * 2)
    planes = [torch.from_numpy(rng.randint(0, 1 << depth, (r, c + pitch_pad))
                               .astype(dtype)) for r, c in shapes]
    return planes + [None] * (3 - len(planes))


def _unscaled_plain(y, u, v, *, width, rotation, rule, chroma, **_):
    return kernels.yuv420_to_bgr_plain(y, u, v, width=width,
                                       rotation=rotation, rule=rule,
                                       chroma=chroma)


def _gray_plain(y, u, v, *, width, depth, rotation, **_):
    return kernels.gray_to_bgr_plain(y, width=width, depth=depth,
                                     rotation=rotation)


@pytest.mark.gpu
@pytest.mark.parametrize("rotation", [0, 90, 180, 270])
@pytest.mark.parametrize("case", PLANAR_CASES,
                         ids=[f"{c}-{d}bit-{h}x{w}" for c, d, (h, w), _
                              in PLANAR_CASES])
def test_planar_kernels_match_plain(cuda, rotation, case):
    """Each entry of csrc/yuv_planar_to_bgr.cu against its plain version,
    error 0, at every (matrix, range), chroma locations 0 and 1, on planes
    of an odd pitch whose bases are off 16 bytes, and on aligned ones (the
    plain version on the card above a megapixel: integer ops, the CPU's
    results)."""
    chroma, depth, (h, w), kernel = case
    plain = {"yuv_planar_general_to_bgr": kernels.general_to_bgr_plain,
             "yuv_planar_full_chroma_to_bgr":
                 kernels.full_chroma_to_bgr_plain,
             "yuv422_to_bgr": _unscaled_plain,
             "gray_to_bgr": _gray_plain}[kernel]
    for pad, offset in ((0, 0), (3, 1)):
        planes = _format_planes(chroma, depth, h, w, seed=h * w + pad,
                                pitch_pad=pad)
        on_card = _at_offset([p for p in planes if p is not None], offset,
                             cuda) + [None] * planes.count(None)
        big = h * w > 1 << 20
        for matrix in (1, 2, 4, 7, 9):
            for full in (False, True):
                rule = kernels.yuv_rule(matrix, full)
                for location in (0, 1):
                    kw = dict(depth=depth, width=w, rotation=rotation,
                              rule=rule, chroma_location=location,
                              chroma=chroma)
                    got = kernels.yuv420_frame_to_bgr(*on_card, **kw)
                    want = (plain(*on_card, **kw) if big else
                            kernels.yuv420_frame_to_bgr(*planes, **kw))
                    assert torch.equal(got.cpu(), want.cpu()), (
                        pad, offset, matrix, full, location)


@pytest.mark.gpu
@pytest.mark.parametrize("case", PLANAR_CASES,
                         ids=[f"{c}-{d}bit-{h}x{w}" for c, d, (h, w), _
                              in PLANAR_CASES])
def test_planar_route_launches_one_kernel(cuda, case):
    """A frame of each chroma format on the card launches the one kernel
    of swscale's path, and no other."""
    chroma, depth, (h, w), kernel = case
    planes = _format_planes(chroma, depth, h, w, seed=7)
    kernels.reset_launch_counts()
    kernels.yuv420_frame_to_bgr(*[None if p is None else p.to(cuda)
                                  for p in planes], depth=depth, width=w,
                                chroma=chroma)
    counts = kernels.launch_counts()
    assert counts[kernel] == 1 and sum(
        counts[k] for k in PLANAR_KERNELS) == 1, counts


@pytest.mark.gpu
def test_chroma_fixtures_read_on_the_card_as_on_the_cpu(cuda):
    """The committed VP9 fixtures of profiles 1-3 read on the card: one
    launch a frame, the CPU's frames."""
    from rtpose_tpu_torch.demo import scripted_video as sv
    from rtpose_tpu_torch.demo.video_io import open_video
    for fixture in sv.CHROMA_FIXTURES:
        path = sv.chroma_fixture_path(fixture)
        frames = {}
        for device in ("cpu", cuda):
            kernels.reset_launch_counts()
            cap = open_video(path, device=device)
            frames[str(device)] = [f for ok, f in
                                   iter(cap.read, (False, None))]
            cap.release()
        counts = kernels.launch_counts()
        assert sum(counts[k] for k in PLANAR_KERNELS) == fixture.frames
        assert len(frames["cpu"]) == fixture.frames
        for a, b in zip(frames["cpu"], frames[str(cuda)]):
            np.testing.assert_array_equal(a, b)


PACKED_SIZES = ((480, 640), (479, 639), (1080, 1920), (1, 1), (65, 66),
                (33, 129))


@pytest.mark.gpu
@pytest.mark.parametrize("rotation", [0, 90, 180, 270])
@pytest.mark.parametrize("size", PACKED_SIZES, ids=lambda s: "%dx%d" % s)
@pytest.mark.parametrize("layout", list(kernels.PACKED_BYTES))
def test_packed_kernel_matches_plain(cuda, layout, size, rotation):
    """csrc/packed_to_bgr.cu against its plain version, error 0, on a
    frame of a padded pitch whose base is off 16 bytes and on an aligned
    one: one launch a call."""
    h, w = size
    n = kernels.PACKED_BYTES[layout]
    for pad, offset in ((0, 0), (5, 1)):
        rng = np.random.RandomState(h * w + pad)
        frame = torch.from_numpy(rng.randint(0, 256, (h, n * w + pad))
                                 .astype(np.uint8))
        on_card = _at_offset([frame], offset, cuda)[0]
        kernels.reset_launch_counts()
        got = kernels.packed_to_bgr(on_card, width=w, layout=layout,
                                    rotation=rotation)
        assert kernels.launch_counts()["packed_to_bgr"] == 1
        want = kernels.packed_to_bgr_plain(frame, width=w, layout=layout,
                                           rotation=rotation)
        assert torch.equal(got.cpu(), want), (pad, offset)


@pytest.mark.gpu
@pytest.mark.parametrize("fourcc,container,kernel", [
    ("FFV1", "avi", "packed_to_bgr"), ("HFYU", "mkv", "packed_to_bgr"),
    ("I420", "avi", "yuv420_to_bgr"), ("WMV2", "mkv", "yuv420_to_bgr"),
    ("prores", "mov", "yuv_planar_general_to_bgr")])
def test_cv2_writer_files_read_on_the_card_as_on_the_cpu(cuda, tmp_path,
                                                         fourcc, container,
                                                         kernel):
    """Files of cv2's writer (the machine's cv2) and a ProRes MOV read on
    the card: the CPU's frames, one launch of the route's kernel a
    frame."""
    from rtpose_tpu_torch.demo import scripted_video as sv
    from rtpose_tpu_torch.demo.video_io import open_video
    path = str(tmp_path / f"v.{container}")
    if fourcc == "prores":
        sv.write_prores(path, sv.yuv_frames10(3, 48, 64, chroma=(1, 0)))
    else:
        sv.write_cv2_video(path, fourcc, 3, 48, 64)
    frames = {}
    for device in ("cpu", cuda):
        kernels.reset_launch_counts()
        cap = open_video(path, device=device)
        frames[str(device)] = [f for ok, f in iter(cap.read, (False, None))]
        cap.release()
    counts = kernels.launch_counts()
    assert counts[kernel] == 3 and sum(
        counts[k] for k in (*PLANAR_KERNELS, "packed_to_bgr")) == 3, counts
    assert len(frames["cpu"]) == 3
    for a, b in zip(frames["cpu"], frames[str(cuda)]):
        np.testing.assert_array_equal(a, b)
