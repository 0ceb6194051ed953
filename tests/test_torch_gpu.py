"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA card and skips without one.  The file imports
no JAX, so it also runs where JAX is not installed; tests/conftest.py
imports JAX, so run it there without the conftest:

    python -m pytest tests/test_torch_gpu.py -q --noconftest -p no:cacheprovider

Tolerances: candidate validity and refined coordinates equal, scores
within 1e-5, ground-truth maps within 1e-6 (kernel and plain version
round the same fp32 operations in the same order, so they agree to the
bit in practice).
"""

import copy
import math

import numpy as np
import pytest
import torch

from rtpose_tpu_torch.config import Config
from rtpose_tpu_torch.data.gt import ground_truth_maps_batch, limb_scalars, \
    person_bound
from rtpose_tpu_torch.infer.pipeline import PosePipeline
from rtpose_tpu_torch.models import get_model
from rtpose_tpu_torch.ops import kernels
from rtpose_tpu_torch.ops.decode import decode_poses_batch, people_to_host
from rtpose_tpu_torch.ops.grouping import score_connections
from rtpose_tpu_torch.ops.peaks import nms, peak_candidates, refine_peaks
from rtpose_tpu_torch.train.trainer import Trainer

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


@pytest.mark.gpu
@pytest.mark.parametrize("K,kind", [(32, "synth"), (64, "grid")])
def test_refine_gaussian_filt_kernel_matches_plain(cuda, K, kind):
    hb, py, px, valid = _refine_inputs(cuda, kind, K)
    xf, yf, score = kernels.bicubic_refine(hb, py, px, valid,
                                           gaussian_filt=True)
    xf_p, yf_p, score_p = kernels.bicubic_refine_plain(hb, py, px, valid,
                                                       gaussian_filt=True)
    assert torch.equal(xf, xf_p) and torch.equal(yf, yf_p)
    torch.testing.assert_close(score, score_p, rtol=0, atol=ATOL)


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


@pytest.mark.gpu
def test_decode_stages_launch_one_kernel_each(cuda):
    """The profiler sees exactly one device kernel, and no copy, in
    score_connections and in refine_peaks at the default caps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    heat, paf = (t.to(cuda) for t in _scenes("synth"))
    p = nms(heat)
    hb, py, px, valid = _refine_inputs(cuda, "synth", 32)
    stages = {"score_connections": lambda: score_connections(p, paf),
              "refine_peaks": lambda: refine_peaks(hb, py, px, valid)}
    calls = 10
    for name, fn in stages.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
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


@pytest.mark.gpu
@pytest.mark.parametrize("grid", [(46, 46), (28, 40)])
def test_gt_kernel_matches_plain(cuda, grid):
    gy, gx = grid
    kps = _keypoints(size=8 * max(gy, gx)).to(cuda)
    limbs, n = limb_scalars(kps, 8), person_bound(kps)
    before = kernels.gt_maps.launches
    heat, paf = kernels.gt_maps(kps, limbs, n, grid_y=gy, grid_x=gx,
                                stride=8, sigma=7.0)
    assert kernels.gt_maps.launches == before + 1
    heat_p, paf_p = kernels.gt_maps_plain(kps, limbs, n, grid_y=gy,
                                          grid_x=gx, stride=8, sigma=7.0)
    assert heat.shape == (8, gy, gx, 19) and paf.shape == (8, gy, gx, 38)
    torch.testing.assert_close(heat, heat_p, rtol=0, atol=GT_ATOL)
    torch.testing.assert_close(paf, paf_p, rtol=0, atol=GT_ATOL)
    want = ground_truth_maps_batch(kps.cpu(), input_y=8 * gy,
                                   input_x=8 * gx)
    torch.testing.assert_close(heat.cpu(), want[0], rtol=0, atol=GT_ATOL)


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
    limbs = torch.zeros((1, 2, 19, 9), device=cuda)
    with pytest.raises(ValueError, match="int32"):
        kernels.gt_maps(kps, limbs, torch.zeros(1, device=cuda), grid_y=4,
                        grid_x=4, stride=8, sigma=7.0)
    with pytest.raises(ValueError, match=r"\(B,N,19,9\)"):
        kernels.gt_maps(kps, limbs[:, :1].contiguous(),
                        torch.zeros(1, dtype=torch.int32, device=cuda),
                        grid_y=4, grid_x=4, stride=8, sigma=7.0)


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
