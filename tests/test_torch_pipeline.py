"""The port's serving pipeline vs the JAX package's.

- ``normalize_device`` (every mode), ``resize_bilinear``,
  ``scale_pad_geometry`` and ``average_flip`` against their JAX versions;
- ``PosePipeline.run`` / ``run_batch`` against the JAX ``PosePipeline``
  (with its device resize) on the same converted weights: maps within the
  fp32 model bound of tests/test_vgg19_model.py (atol 2e-4, rtol 1e-3),
  people lists equal;
- the truncation retry, fed precomputed maps as
  tests/test_truncation_retry.py feeds the JAX pipeline;
- ``resize_bicubic`` against cv2 INTER_CUBIC and the JAX function, and
  multi-scale TTA against the JAX package's own functions composed the
  same way (maps within the model bound, people lists equal), batched and
  split into memory-capped chunks.
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
from rtpose_tpu_torch.ops.resize import resize_bicubic, resize_bilinear

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


@pytest.mark.parametrize("mode", ["rtpose", "vgg", "inception", "ssd"])
def test_normalize_device_equals_host_numpy_on_every_value(mode):
    """Every uint8 value in every channel: the port's normalisation equals
    the JAX package's host numpy preprocessing (``vgg_preprocess`` and its
    siblings, which divide exactly) bit for bit."""
    x = ((np.arange(256)[:, None] + 85 * np.arange(3)) % 256).astype(
        np.uint8)[None]                                   # (1, 256, 3)
    want = jpre.preprocess(x, mode)
    got = normalize_device(torch.from_numpy(x), mode).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


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
        flax_params=jax.tree_util.tree_map(np.asarray, params),
        device_resize=True)
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


def test_pad_factor_matches_jax_pipeline(pipes):
    """`pad_factor` 64 (hourglass's multiple) apart from the stride 8: a
    48x80 frame is scaled to 56x93 and padded to 64x128, maps 8x16, as in
    the JAX pipeline with its device resize.  (Frame seed 4 would put a
    PAF sample on a cell boundary, where the jitted JAX decode samples
    another cell than its eager self and the port: ROADMAP §3, F1.)"""
    jpipe, _, params = pipes
    jpad = jpipeline.PosePipeline(jpipe.model, params, input_size=56,
                                  flip=True, device_resize=True,
                                  pad_factor=64)
    tpad = pipeline.load_pipeline(
        device="cpu", num_stages=1, input_size=56, dtype=torch.float32,
        flax_params=jax.tree_util.tree_map(np.asarray, params),
        pad_factor=64, device_resize=True)
    assert tpad.pad_factor == 64 and tpad.downsample == 8
    frame = np.random.RandomState(5).randint(0, 256, (48, 80, 3), np.uint8)
    jp, jheat, jpaf, jmeta = jpad.run(frame)
    tp, theat, tpaf, tmeta = tpad.run(frame)
    assert tmeta["padded_shape"] == tuple(jmeta["padded_shape"]) \
        == (64, 128, 3)
    assert theat.shape == jheat.shape == (8, 16, 19)
    assert float(np.abs(jheat).max()) > 1e-2
    np.testing.assert_allclose(theat, jheat, **MAP_TOL)
    np.testing.assert_allclose(tpaf, jpaf, **MAP_TOL)
    assert tuple(tmeta["upsampled"]) == tuple(jmeta["upsampled"]) \
        == (64, 128)
    _assert_people_lists_equal(tp, jp)
    # the multi-scale geometry pads every scale to the same multiple
    jims, jbase, _ = jpad._prep_scales(frame, (0.5, 1.0, 2.0))
    base_hw, sizes, max_px = tpad._scale_sizes(48, 80, (0.5, 1.0, 2.0))
    assert base_hw == tuple(jbase) == (8, 16) and sizes == [64, 64, 112]
    assert max_px == max(im.shape[0] * im.shape[1] for im in jims) \
        == 128 * 192


@pytest.fixture(scope="module")
def blur_pipes(pipes):
    """The two pipelines again with `gaussian_filt`, on the same weights:
    the JAX one built as `pipes` builds it, the port's through
    ``load_pipeline``'s keyword pass-through."""
    jpipe, _, params = pipes
    jblur = jpipeline.PosePipeline(jpipe.model, params, input_size=56,
                                   flip=True, device_resize=True,
                                   gaussian_filt=True)
    tblur = pipeline.load_pipeline(
        device="cpu", num_stages=1, input_size=56, dtype=torch.float32,
        flax_params=jax.tree_util.tree_map(np.asarray, params),
        gaussian_filt=True, device_resize=True)
    return jblur, tblur


def test_run_with_gaussian_filt_matches_jax_pipeline(pipes, blur_pipes,
                                                     monkeypatch):
    """`gaussian_filt` reaches the decode through ``run`` and
    ``run_batch``: the people equal the JAX pipeline's in the same mode
    (coordinates equal, scores within 1e-4 as above), and every decode of
    the port was asked for the blurred refine."""
    jblur, tblur = blur_pipes
    asked = []
    real = pipeline.decode_poses_batch

    def spy(heat, paf, **kw):
        asked.append(kw.get("gaussian_filt"))
        return real(heat, paf, **kw)

    monkeypatch.setattr(pipeline, "decode_poses_batch", spy)
    frames = _frames()
    jp, jheat, _, jmeta = jblur.run(frames[0])
    tp, theat, _, tmeta = tblur.run(frames[0])
    np.testing.assert_allclose(theat, jheat, **MAP_TOL)
    assert tmeta["truncated"] == bool(jmeta["truncated"])
    _assert_people_lists_equal(tp, jp)
    jpeople, _ = jblur.run_batch(frames)
    tpeople, _ = tblur.run_batch(frames)
    for a, b in zip(tpeople, jpeople):
        _assert_people_lists_equal(a, b)
    assert asked and all(asked)
    # the maps hold peaks, and the blur moves some of them: the mode is
    # not a no-op on these frames
    plain, _, _, _ = pipes[1].run(frames[0])
    assert sum(len(p["parts"]) for p in tp) > 0
    assert [p["parts"] for p in tp] != [p["parts"] for p in plain]


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


@pytest.mark.parametrize("entry", ["load_pipeline", "Trainer"])
def test_entry_points_default_to_the_card(entry):
    """Without `device`, serving and training run on the card: on a host
    without CUDA they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    from rtpose_tpu_torch.config import Config
    from rtpose_tpu_torch.train.trainer import Trainer
    make = {"load_pipeline": lambda: pipeline.load_pipeline(num_stages=1),
            "Trainer": lambda: Trainer(Config())}[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make()


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


def test_retry_decodes_with_gaussian_filt(monkeypatch):
    """The retry keeps the pipeline's refine mode: with `gaussian_filt` the
    truncated frame is decoded again blurred, and equals a direct blurred
    decode at the raised caps; without, neither decode is blurred."""
    heat, paf = _maps(3, 4, 0)
    asked = []
    real = pipeline.decode_poses_batch

    def spy(h, p, **kw):
        asked.append(kw.get("gaussian_filt"))
        return real(h, p, **kw)

    monkeypatch.setattr(pipeline, "decode_poses_batch", spy)
    frame = np.zeros((368, 368, 3), np.uint8)
    for blur in (True, False):
        del asked[:]
        pipe = _retry_pipeline([(heat, paf)], gaussian_filt=blur)
        assert pipe._retry_kwargs["gaussian_filt"] is blur
        people, _, _, meta = pipe.run(frame)
        batch_people, _ = pipe.run_batch([frame])
        assert meta.get("retried") is True and asked == [blur, blur]
        direct = decode.people_to_numpy(
            decode.decode_poses(heat, paf, gaussian_filt=blur, **RAISED),
            368, 368)
        assert len(people) == 12
        assert [p["parts"] for p in people] == [p["parts"] for p in direct]
        assert [p["parts"] for p in batch_people[0]] == \
            [p["parts"] for p in direct]


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


# ---------------------------------------------------------------------------
# bicubic map resize and multi-scale TTA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src,dst", [((23, 29), (46, 58)),
                                     ((69, 46), (46, 31)),
                                     ((10, 10), (17, 13))])
def test_resize_bicubic_matches_cv2_and_jax(src, dst):
    import cv2
    maps = np.random.RandomState(0).rand(src[0], src[1], 7).astype(
        np.float32)
    got = resize_bicubic(torch.from_numpy(maps)[None], dst)[0].numpy()
    np.testing.assert_allclose(got, cv2.resize(
        maps, (dst[1], dst[0]), interpolation=cv2.INTER_CUBIC),
        atol=2e-6, rtol=0)
    np.testing.assert_allclose(got, np.asarray(jresize.resize_bicubic(
        jnp.asarray(maps), dst)), atol=1e-6, rtol=0)


MS_TEST_SCALES = (1.0, 1.5)


def _jax_multiscale(jmodel, params, frame, scales, input_size=56):
    """The JAX package's multi-scale TTA composed from its own functions:
    per scale ``make_infer_fn(device_resize_to=...)`` (resize on the
    device, flip fused), ``resize_bicubic`` to the base grid, the mean,
    one ``decode_poses``."""
    from rtpose_tpu.ops import decode as jdecode
    _, _, _, ph, pw = jpre.scale_pad_geometry(*frame.shape[:2], input_size,
                                              8)
    base = (ph // 8, pw // 8)
    heats, pafs = [], []
    for s in scales:
        fn = jpipeline.make_infer_fn(
            jmodel, flip=True, decode=False,
            device_resize_to=max(8, int(round(input_size * s))))
        _, heat, paf = fn(params, jnp.asarray(frame))
        heats.append(jresize.resize_bicubic(heat, base))
        pafs.append(jresize.resize_bicubic(paf, base))
    heat, paf = sum(heats) / len(heats), sum(pafs) / len(pafs)
    people = jdecode.people_to_numpy(jdecode.decode_poses(heat, paf),
                                     base[1] * 8, base[0] * 8)
    return people, np.asarray(heat), np.asarray(paf), base


def test_run_multiscale_matches_jax_composition(pipes):
    """The port's multi-scale TTA against the JAX package's own
    ``run_multiscale``: every scale resized on the host (the port's
    ``crop_with_factor`` equals cv2's), the same maps within the model
    bound and the same people."""
    jpipe, tpipe, params = pipes
    frame = _frames()[0]
    jp, jheat, jpaf, jmeta = jpipe.run_multiscale(frame, MS_TEST_SCALES)
    base = tuple(jheat.shape[:2])
    tp, theat, tpaf, meta = tpipe.run_multiscale(frame, MS_TEST_SCALES)
    assert theat.shape == jheat.shape == base + (19,)
    assert meta["upsampled"] == tuple(jmeta["upsampled"]) \
        == (base[0] * 8, base[1] * 8)
    np.testing.assert_allclose(theat, jheat, **MAP_TOL)
    np.testing.assert_allclose(tpaf, jpaf, **MAP_TOL)
    assert sum(len(p["parts"]) for p in jp) > 0
    _assert_people_lists_equal(tp, jp)
    # the scales act: the single-scale maps differ
    _, single, _, _ = tpipe.run(frame)
    assert not np.allclose(single, theat, atol=1e-3)
    # resizing each scale on the card instead, as the port did before it
    # had the host resize, gives other maps
    _, cheat, _, _ = _jax_multiscale(jpipe.model, params, frame,
                                     MS_TEST_SCALES)
    assert cheat.shape == theat.shape and not np.array_equal(cheat, theat)


def test_run_multiscale_batch_matches_single_frames(pipes):
    _, tpipe, _ = pipes
    frames = _frames()          # two of one shape, one of another
    people, metas = tpipe.run_multiscale_batch(frames, MS_TEST_SCALES)
    assert len(people) == len(metas) == 3
    for frame, got, meta in zip(frames, people, metas):
        want, _, _, want_meta = tpipe.run_multiscale(frame, MS_TEST_SCALES)
        for k in ("scale", "padded_shape", "upsampled", "truncated"):
            assert meta[k] == want_meta[k], k
        _assert_people_lists_equal(got, want)


def test_multiscale_chunk_cap_splits_a_batch(pipes, monkeypatch):
    """A same-shape batch whose frames do not fit the memory budget runs
    as capped chunks (2, 2, 1) and gives the unsplit results in order."""
    _, tpipe, _ = pipes
    rng = np.random.RandomState(7)
    frames = [rng.randint(0, 256, (48, 64, 3), np.uint8) for _ in range(5)]
    want, want_metas = tpipe.run_multiscale_batch(frames, MS_TEST_SCALES)
    _, _, max_px = tpipe._scale_sizes(48, 64, MS_TEST_SCALES)
    per_frame = max_px * pipeline.MS_BYTES_PER_PIXEL * 2   # fp32, flip
    monkeypatch.setattr(pipeline, "MS_HOST_MEMORY_BUDGET", 2 * per_frame)
    assert tpipe.ms_chunk_cap(max_px) == 2
    ticket = tpipe.run_multiscale_batch_submit(frames, MS_TEST_SCALES)
    assert ticket[0] == "multi"
    assert [len(idxs) for idxs, _ in ticket[2]] == [2, 2, 1]
    people, metas = tpipe.run_batch_collect(ticket)
    assert [m["upsampled"] for m in metas] == \
        [m["upsampled"] for m in want_metas]
    for got, ref in zip(people, want):
        _assert_people_lists_equal(got, ref)
