"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA card and skips without one.  The file imports
no JAX, so it also runs where JAX is not installed; tests/conftest.py
imports JAX, so run it there without the conftest:

    python -m pytest tests/test_torch_gpu.py -q --noconftest -p no:cacheprovider

Tolerances: PAF sample counts and refine coordinates equal, sample sums
and scores within 1e-5 (kernel and plain version round the same fp32
operations in the same order, so they agree to the bit in practice).
"""

import copy
import math

import numpy as np
import pytest
import torch

from rtpose_tpu_torch.infer.pipeline import PosePipeline
from rtpose_tpu_torch.models import get_model
from rtpose_tpu_torch.ops import kernels
from rtpose_tpu_torch.ops.decode import decode_poses_batch, people_to_host
from rtpose_tpu_torch.ops.grouping import candidate_geometry
from rtpose_tpu_torch.ops.peaks import nms, peak_candidates

from util_synth import grid_people, render_maps, synth_example

ATOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _scenes(kind, n=4, h=46, w=46):
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


@pytest.mark.gpu
@pytest.mark.parametrize("K,kind", [(32, "synth"), (64, "grid")])
def test_paf_kernel_matches_plain(cuda, K, kind):
    heat, paf = (t.to(cuda) for t in _scenes(kind))
    geo, _, _ = candidate_geometry(nms(heat, max_peaks=K))
    before = kernels.paf_sample_scores.launches
    cnt, ssum = kernels.paf_sample_scores(paf, geo)
    assert kernels.paf_sample_scores.launches == before + 1
    cnt_p, ssum_p = kernels.paf_sample_scores_plain(paf, geo)
    assert torch.equal(cnt, cnt_p)
    torch.testing.assert_close(ssum, ssum_p, rtol=0, atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("K,kind", [(32, "synth"), (64, "grid")])
def test_refine_kernel_matches_plain(cuda, K, kind):
    heat, _ = _scenes(kind)
    hb = heat[..., :18].permute(0, 3, 1, 2).contiguous().to(cuda)
    _, py, px, _, _ = peak_candidates(hb, thresh=0.1, max_peaks=K)
    before = kernels.bicubic_refine.launches
    my, mx, score = kernels.bicubic_refine(hb, py, px)
    assert kernels.bicubic_refine.launches == before + 1
    my_p, mx_p, score_p = kernels.bicubic_refine_plain(hb, py, px)
    assert torch.equal(my, my_p) and torch.equal(mx, mx_p)
    torch.testing.assert_close(score, score_p, rtol=0, atol=ATOL)


@pytest.mark.gpu
def test_wrappers_raise_instead_of_falling_back(cuda):
    geo = torch.zeros((1, 19, 6, 4), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.paf_sample_scores(
            torch.zeros((1, 4, 4, 38), dtype=torch.float64, device=cuda), geo)
    heat = torch.zeros((1, 18, 8, 8), device=cuda)
    peaks = torch.zeros((1, 18, 2), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        kernels.bicubic_refine(heat, peaks, peaks)


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
    assert all(n > 0 for n in kernels.launch_counts().values())
    assert heat_g.shape == heat_c.shape == (7, 10, 19)
    for got, want in ((heat_g, heat_c), (paf_g, paf_c)):
        assert np.isfinite(got).all()
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got - want).max()) <= 1e-4 * scale
    assert len(people) == 2 and metas[0]["padded_shape"] == (56, 80, 3)
