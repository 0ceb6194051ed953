"""The port's three resize modes against the JAX package's.

``PosePipeline(device_resize=False | "auto" | True)``: ``_prep`` ships the
same frame and meta as the JAX ``_prep`` in each mode (the host resize
equal to ``cv2.resize`` to the bit), and ``run``, ``run_batch`` and
``run_multiscale_batch`` give the JAX pipeline's maps within the fp32
model bound of tests/test_vgg19_model.py and its people, on frames that
shrink and frames that grow.  One more test measures the gap that the
host resize closed: the card's resize against the JAX host path on
COCO-shaped frames at 368 px.
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
from rtpose_tpu_torch.data.imread_fixtures import render_scene
from rtpose_tpu_torch.infer import pipeline
from rtpose_tpu_torch.infer.preprocess import crop_with_factor
from rtpose_tpu_torch.ops.resize import resize_bilinear

MAP_TOL = dict(atol=2e-4, rtol=1e-3)
MODES = [False, "auto", True]


@pytest.fixture(scope="module")
def params():
    jmodel = jax_get_model("vgg19", num_stages=1, dtype=jnp.float32)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))
    return jmodel, he_reinit(variables, seed=1)


def _pipes(params, mode, input_size=56, flip=True):
    jmodel, variables = params
    jpipe = jpipeline.PosePipeline(jmodel, variables, input_size=input_size,
                                   flip=flip, device_resize=mode)
    tpipe = pipeline.load_pipeline(
        device="cpu", num_stages=1, input_size=input_size,
        dtype=torch.float32, flip=flip, device_resize=mode,
        flax_params=jax.tree_util.tree_map(np.asarray, variables))
    return jpipe, tpipe


def _frames():
    rng = np.random.RandomState(11)
    # 64x80 and 57x91 shrink to a short side of 56; 40x52 grows
    return [rng.randint(0, 256, shape, np.uint8)
            for shape in ((64, 80, 3), (64, 80, 3), (57, 91, 3),
                          (40, 52, 3))]


def _people_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a["parts"].keys() == b["parts"].keys()
        for part, (x, y, s) in a["parts"].items():
            assert (x, y) == b["parts"][part][:2]
            assert abs(s - b["parts"][part][2]) <= 1e-4


@pytest.mark.parametrize("mode", MODES)
def test_prep_ships_what_jax_ships(params, mode):
    jpipe, tpipe = _pipes(params, mode)
    for frame in _frames():
        jim, jmeta = jpipe._prep(frame)
        tim, tmeta = tpipe._prep(frame)
        assert tim.dtype == np.uint8
        np.testing.assert_array_equal(tim, jim)
        assert tmeta["scale"] == jmeta["scale"]
        assert tuple(tmeta["real_shape"]) == tuple(jmeta["real_shape"])
        assert tuple(tmeta["padded_shape"]) == tuple(jmeta["padded_shape"])
    # the JAX rule: host for a shrinking frame in "auto", raw otherwise
    shrink, grow = _frames()[0], _frames()[3]
    host = {False: True, "auto": True, True: False}[mode]
    assert (tpipe._prep(shrink)[0].shape == (56, 72, 3)) == host
    assert (tpipe._prep(grow)[0].shape == (40, 52, 3)) == bool(mode)


@pytest.mark.parametrize("mode", MODES)
def test_run_and_run_batch_match_jax(params, mode):
    jpipe, tpipe = _pipes(params, mode)
    frames = _frames()
    for frame in (frames[0], frames[3]):
        jp, jheat, jpaf, jmeta = jpipe.run(frame)
        tp, theat, tpaf, tmeta = tpipe.run(frame)
        assert theat.shape == jheat.shape
        assert float(np.abs(jheat).max()) > 1e-2
        np.testing.assert_allclose(theat, jheat, **MAP_TOL)
        np.testing.assert_allclose(tpaf, jpaf, **MAP_TOL)
        assert tuple(tmeta["upsampled"]) == tuple(jmeta["upsampled"])
        _people_equal(tp, jp)
    jpeople, jmetas = jpipe.run_batch(frames)
    tpeople, tmetas = tpipe.run_batch(frames)
    for got, want, gm, wm in zip(tpeople, jpeople, tmetas, jmetas):
        _people_equal(got, want)
        assert tuple(gm["upsampled"]) == tuple(wm["upsampled"])


def test_run_multiscale_batch_matches_jax(params):
    """Multi-scale resizes every scale on the host in every mode, and
    groups frames by their per-scale shapes, as the JAX package does."""
    scales = (1.0, 1.5)
    jpipe, tpipe = _pipes(params, True)
    frames = _frames()
    jpeople, jmetas = jpipe.run_multiscale_batch(frames, scales)
    ticket = tpipe.run_multiscale_batch_submit(frames, scales)
    # (64, 80) twice, (57, 91) and (40, 52): three per-scale shape keys
    assert ticket[0] == "multi" and len(ticket[2]) == 3
    tpeople, tmetas = tpipe.run_batch_collect(ticket)
    for got, want, gm, wm in zip(tpeople, jpeople, tmetas, jmetas):
        _people_equal(got, want)
        assert tuple(gm["upsampled"]) == tuple(wm["upsampled"])
    ims, base, meta = tpipe._prep_scales(frames[2], scales)
    jims, jbase, jmeta = jpipe._prep_scales(frames[2], scales)
    assert tuple(base) == tuple(jbase)
    for a, b in zip(ims, jims):
        np.testing.assert_array_equal(a, b)


def test_ms_chunk_cap_warns_above_the_budget(params, monkeypatch):
    """A frame whose largest scale alone exceeds the budget still runs,
    one frame a chunk (the JAX package's floor), and the warning names
    its scaled size and the budget."""
    _, tpipe = _pipes(params, False)
    monkeypatch.setattr(pipeline, "MS_HOST_MEMORY_BUDGET", 1000)
    with pytest.warns(RuntimeWarning, match=r"ms_chunk_cap.*12345 px.*budget"):
        assert tpipe.ms_chunk_cap(12345) == 1


def test_card_resize_against_the_jax_host_resize_on_coco_frames(params):
    """The gap the host resize closed, measured: on COCO-shaped frames
    scaled to 368 px, the card's fp32 resize (the port's only resize
    before it had ``crop_with_factor``) against the JAX package's
    ``cv2.resize`` path: input pixels, maps and people, on rendered
    scenes.  The card samples each axis at the ratio of the rounded sizes,
    cv2 at the one scale, and keeps fp32 where cv2 rounds to uint8; the
    numbers print for the record."""
    jpipe, _ = _pipes(params, False, input_size=368, flip=False)
    _, tcard = _pipes(params, True, input_size=368, flip=False)
    for i, (h, w) in enumerate(((480, 640), (427, 640), (375, 500))):
        frame = np.ascontiguousarray(render_scene(i, h, w))
        host, scale, real = crop_with_factor(frame, 368)
        np.testing.assert_array_equal(
            host, jpre.crop_with_factor(frame, 368)[0])
        card = resize_bilinear(torch.from_numpy(frame).float()[None],
                               real[:2])[0].numpy()
        px = float(np.abs(card - host[:real[0], :real[1]]).max())
        jp, jheat, jpaf, _ = jpipe.run(frame)
        tp, theat, tpaf, _ = tcard.run(frame)
        heat = float(np.abs(theat - jheat).max())
        paf = float(np.abs(tpaf - jpaf).max())
        same = (len(tp) == len(jp) and all(
            a["parts"].keys() == b["parts"].keys() for a, b in zip(tp, jp)))
        print(f"\n{h}x{w}: input px {px:.4f}, heat {heat:.3g}, "
              f"paf {paf:.3g}, people {len(tp)} / {len(jp)}, "
              f"equal {same}")
        assert px > 0.5 and np.isfinite(heat) and np.isfinite(paf)
