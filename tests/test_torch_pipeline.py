"""The port's serving pipeline vs the JAX package's.

- ``normalize_device`` (every mode), ``resize_bilinear``,
  ``scale_pad_geometry`` and ``average_flip`` against their JAX versions;
- ``PosePipeline.run`` / ``run_batch`` against the JAX ``PosePipeline``
  (with its device resize) on the same converted weights: maps within the
  fp32 model bound of tests/test_vgg19_model.py (atol 2e-4, rtol 1e-3),
  people lists equal;
- the truncation retry, fed precomputed maps as
  tests/test_truncation_retry.py feeds the JAX pipeline.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rtpose_tpu.infer import pipeline as jpipeline
from rtpose_tpu.infer import preprocess as jpre
from rtpose_tpu.models import get_model as jax_get_model
from rtpose_tpu.models.common import he_reinit
from rtpose_tpu.ops import resize as jresize
from rtpose_tpu_torch.infer import pipeline
from rtpose_tpu_torch.infer.preprocess import (normalize_device,
                                               scale_pad_geometry)
from rtpose_tpu_torch.models.convert import state_dict_from_flax
from rtpose_tpu_torch.ops import decode
from rtpose_tpu_torch.ops.resize import resize_bilinear

from util_synth import grid_people, render_maps

MAP_TOL = dict(atol=2e-4, rtol=1e-3)
TIGHT = dict(max_peaks=16, max_candidates=64, max_total_conns=32,
             max_people=64)
RAISED = dict(max_peaks=16, max_candidates=512, max_total_conns=304,
              max_people=64)


@pytest.mark.parametrize("mode", ["rtpose", "vgg", "inception", "ssd",
                                  "none"])
def test_normalize_device_matches_jax(mode):
    x = np.random.RandomState(0).randint(0, 256, (2, 5, 7, 3), np.uint8)
    want = np.asarray(jpre.normalize_device(jnp.asarray(x), mode))
    got = normalize_device(torch.from_numpy(x), mode)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_normalize_device_rejects_unknown_mode():
    with pytest.raises(ValueError, match="unknown"):
        normalize_device(torch.zeros((1, 2, 2, 3)), "caffe")


@pytest.mark.parametrize("src,dst", [((23, 31), (40, 56)),
                                     ((64, 48), (40, 30)), ((9, 9), (9, 9))])
def test_resize_bilinear_matches_jax(src, dst):
    x = np.random.RandomState(1).uniform(0, 255, src + (3,)).astype(
        np.float32)
    want = np.asarray(jresize.resize_bilinear(jnp.asarray(x), dst))
    got = resize_bilinear(torch.from_numpy(x)[None], dst)[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-3)


@pytest.mark.parametrize("h,w", [(480, 640), (368, 368), (240, 320),
                                 (37, 101), (1000, 3)])
def test_scale_pad_geometry_matches_jax(h, w):
    for size, factor in ((368, 8), (56, 8), (256, 64)):
        assert scale_pad_geometry(h, w, size, factor) == \
            jpre.scale_pad_geometry(h, w, size, factor)


def test_average_flip_matches_jax():
    rng = np.random.RandomState(2)
    maps = [rng.rand(5, 6, c).astype(np.float32) for c in (19, 19, 38, 38)]
    want = jpipeline.average_flip(*(jnp.asarray(m) for m in maps))
    got = pipeline.average_flip(*(torch.from_numpy(m) for m in maps))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


# ---------------------------------------------------------------------------
# whole pipeline vs the JAX pipeline, same weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pipes():
    jmodel = jax_get_model("vgg19", num_stages=1, dtype=jnp.float32)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))
    params = he_reinit(params, seed=1)
    jpipe = jpipeline.PosePipeline(jmodel, params, input_size=56, flip=True,
                                   device_resize=True)
    tpipe = pipeline.load_pipeline(
        device="cpu", num_stages=1, input_size=56, dtype=torch.float32,
        flax_params=jax.tree_util.tree_map(np.asarray, params))
    return jpipe, tpipe, params


def _frames():
    rng = np.random.RandomState(3)
    return [rng.randint(0, 256, shape, np.uint8)
            for shape in ((48, 64, 3), (48, 64, 3), (40, 40, 3))]


def _assert_people_lists_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a["parts"].keys() == b["parts"].keys()
        for part, (x, y, s) in a["parts"].items():
            assert (x, y) == b["parts"][part][:2]
            assert abs(s - b["parts"][part][2]) <= 1e-4


def test_run_matches_jax_pipeline(pipes):
    jpipe, tpipe, _ = pipes
    frame = _frames()[0]
    jp, jheat, jpaf, jmeta = jpipe.run(frame)
    tp, theat, tpaf, tmeta = tpipe.run(frame)
    assert theat.shape == jheat.shape == (7, 10, 19)
    assert float(np.abs(jheat).max()) > 1e-2
    np.testing.assert_allclose(theat, jheat, **MAP_TOL)
    np.testing.assert_allclose(tpaf, jpaf, **MAP_TOL)
    for k in ("scale", "real_shape", "padded_shape", "upsampled",
              "truncated"):
        assert tuple(np.atleast_1d(tmeta[k])) == \
            tuple(np.atleast_1d(jmeta[k])), k
    _assert_people_lists_equal(tp, jp)


def test_run_batch_matches_jax_pipeline(pipes):
    jpipe, tpipe, _ = pipes
    frames = _frames()
    jpeople, jmetas = jpipe.run_batch(frames)
    tpeople, tmetas = tpipe.run_batch(frames)
    assert [m["padded_shape"] for m in tmetas] == \
        [tuple(m["padded_shape"]) for m in jmetas]
    for a, b in zip(tpeople, jpeople):
        _assert_people_lists_equal(a, b)
    single, _, _, _ = tpipe.run(frames[2])
    _assert_people_lists_equal(tpeople[2], single)


def test_load_pipeline_weight_sources_agree(pipes, tmp_path):
    _, tpipe, params = pipes
    path = tmp_path / "pose_model.pth"
    torch.save(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params)), path)
    other = pipeline.load_pipeline(device="cpu", num_stages=1, input_size=56,
                                   dtype=torch.float32,
                                   torch_weights=str(path))
    for k, v in tpipe.model.state_dict().items():
        assert torch.equal(other.model.state_dict()[k], v), k
    seeded = pipeline.load_pipeline(device="cpu", num_stages=1, seed=0)
    assert next(seeded.model.parameters()).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="one of"):
        pipeline.load_pipeline(device="cpu", seed=0, torch_weights=str(path))


def test_cuda_device_is_never_replaced_by_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pipeline.load_pipeline(device="cuda", num_stages=1)


# ---------------------------------------------------------------------------
# the truncation retry
# ---------------------------------------------------------------------------

def _maps(rows, cols, seed):
    rng = np.random.RandomState(seed)
    heat, paf = render_maps(grid_people(rows, cols, 46, 46, rng), 46, 46)
    paf = paf + rng.normal(0, 1e-4, paf.shape).astype(np.float32)
    return torch.from_numpy(heat), torch.from_numpy(paf)


def _retry_pipeline(maps, **kwargs):
    """A pipeline whose forward is replaced by precomputed maps, decoded
    at its own tight caps, so the truncation comes from the real decode."""
    pipe = pipeline.PosePipeline(
        pipeline.get_model("vgg19", num_stages=1), device="cpu",
        input_size=368, flip=False, retry_caps=RAISED, **{**TIGHT, **kwargs})
    heat = torch.stack([h for h, _ in maps])
    paf = torch.stack([p for _, p in maps])

    def infer(frames):
        assert frames.shape[0] == len(maps)
        return decode.decode_poses_batch(heat, paf, **TIGHT), heat, paf

    pipe._infer = infer
    return pipe


def test_run_retries_truncated_frame():
    heat, paf = _maps(3, 4, 0)
    pipe = _retry_pipeline([(heat, paf)])
    people, _, _, meta = pipe.run(np.zeros((368, 368, 3), np.uint8))
    assert meta.get("retried") is True and meta["truncated"] is False
    direct = decode.people_to_numpy(
        decode.decode_poses(heat, paf, **RAISED), 368, 368)
    assert len(people) == len(direct) == 12
    assert [p["parts"] for p in people] == [p["parts"] for p in direct]


def test_run_without_auto_retry_keeps_signal():
    pipe = _retry_pipeline([_maps(3, 4, 0)], auto_retry=False)
    _, _, _, meta = pipe.run(np.zeros((368, 368, 3), np.uint8))
    assert "retried" not in meta and meta["truncated"] is True


def test_run_batch_retries_only_truncated_rows(monkeypatch):
    maps = [_maps(3, 4, 0), _maps(1, 1, 1), _maps(3, 4, 2)]
    pipe = _retry_pipeline(maps)
    shapes = []
    real = pipeline.decode_poses_batch

    def spy(heat, paf, **kw):
        shapes.append(tuple(heat.shape))
        return real(heat, paf, **kw)

    monkeypatch.setattr(pipeline, "decode_poses_batch", spy)
    frames = [np.zeros((368, 368, 3), np.uint8) for _ in maps]
    people, metas = pipe.run_batch_collect(pipe.run_batch_submit(frames))
    assert shapes == [(2, 46, 46, 19)]        # frames 0 and 2 only
    assert [bool(m.get("retried")) for m in metas] == [True, False, True]
    assert [m["truncated"] for m in metas] == [False] * 3
    assert [len(p) for p in people] == [12, 1, 12]
    direct = decode.people_to_numpy(
        decode.decode_poses(*maps[2], **RAISED), 368, 368)
    assert [p["parts"] for p in people[2]] == [p["parts"] for p in direct]
