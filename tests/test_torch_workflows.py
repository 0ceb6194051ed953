"""The port's workflow scripts (scripts/torch_*.py) and the public
functions this slice ported, held against the JAX package on the CPU.

- the scene renderer (``torch_train_synth.render_scene``) against
  scripts/hw_train_synth.py's, pixel for pixel, over square, odd and
  non-multiple-of-8 sizes; the resize size form and the filled circle it
  rests on against cv2;
- the rehearsal set's annotations against scripts/cocoval_rehearsal.py's;
- the decode soak against the JAX package's host oracle;
- the training schedule's restore against an uninterrupted run (rel
  1e-6);
- the crowded bench's two arms on ground-truth maps, image for image;
- the endurance run's resume, its checkpoint retention, a run without a
  window, and a checkpoint that does not load;
- ``infer/preprocess.py``'s host functions, ``StepTimer`` and
  ``register`` against the JAX package's, exactly;
- ``torch_train_to_eval.py``'s family recipes and refusals; the
  hourglass rescore's parity detections against ``run_eval_batched``'s.
"""

import json
import os
import sys

import cv2
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import cocoval_rehearsal as jrehearsal  # noqa: E402
import hw_train_synth as jsynth  # noqa: E402
import torch_cocoval_rehearsal as trehearsal  # noqa: E402
import torch_crowded_eval_bench as tcrowded  # noqa: E402
import torch_endurance as tendurance  # noqa: E402
import torch_hg_rescore as trescore  # noqa: E402
import torch_soak_decode as tsoak  # noqa: E402
import torch_train_synth as tsynth  # noqa: E402
import torch_train_to_eval as tchain  # noqa: E402
from rtpose_tpu.infer import preprocess as jpre  # noqa: E402
from rtpose_tpu.ops import grouping_ref as jgrouping_ref  # noqa: E402
from rtpose_tpu.utils import meters as jmeters  # noqa: E402
from rtpose_tpu_torch.config import Config  # noqa: E402
from rtpose_tpu_torch.data.cv2exact import resize_linear_to  # noqa: E402
from rtpose_tpu_torch.infer import preprocess as tpre  # noqa: E402
from rtpose_tpu_torch.utils import meters as tmeters  # noqa: E402
from rtpose_tpu_torch.utils.draw import cv_circle  # noqa: E402
from util_synth import synth_example  # noqa: E402

REL = 1e-6


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


# ---- the renderer and what it rests on -------------------------------------

def _odd_shapes(n, seed=7):
    """`n` (w, h) sizes from the rehearsal's "odd" branch."""
    rng = np.random.RandomState(seed)
    return [(int(rng.randint(200, 641)), int(rng.randint(150, 641)))
            for _ in range(n)]


@pytest.mark.parametrize("wh,n_people", [
    ((368, 368), 3), ((333, 500), 4), ((500, 333), 1), ((64, 64), 2),
    ((184, 184), 13), ((427, 640), 20), ((7, 9), 1)]
    + [(wh, 5) for wh in _odd_shapes(3)])
def test_render_scene_equals_the_jax_script(wh, n_people):
    w, h = wh
    a, b = np.random.RandomState(w * 1000 + h), \
        np.random.RandomState(w * 1000 + h)
    want_img, want_kps = jsynth.render_scene(a, n_people=n_people, height=h,
                                             width=w)
    got_img, got_kps = tsynth.render_scene(b, n_people=n_people, height=h,
                                           width=w)
    assert got_img.shape == want_img.shape == (h, w, 3)
    np.testing.assert_array_equal(got_img, want_img)
    np.testing.assert_array_equal(got_kps, want_kps)
    assert a.rand() == b.rand()        # the same draws from the stream


@pytest.mark.parametrize("src,dst", [
    ((46, 46), (368, 368)), ((41, 62), (333, 500)), ((62, 41), (500, 333)),
    ((25, 49), (201, 397)), ((80, 18), (641, 150)), ((1, 1), (7, 9)),
    ((480, 640), (240, 320)), ((333, 500), (368, 552)), ((427, 640),
                                                         (128, 192)),
    ((9, 7), (9, 7)), ((100, 60), (37, 211))])
@pytest.mark.parametrize("channels", [3, 1, 0])
def test_resize_size_form_equals_cv2(src, dst, channels):
    rng = np.random.RandomState(sum(src) + sum(dst) + channels)
    shape = src + ((channels,) if channels else ())
    im = rng.randint(0, 256, shape).astype(np.uint8)
    want = cv2.resize(im, (dst[1], dst[0]), interpolation=cv2.INTER_LINEAR)
    got = resize_linear_to(im, dst[1], dst[0])
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_filled_circle_equals_cv2(seed):
    rng = np.random.RandomState(seed)
    for _ in range(50):
        h, w = rng.randint(3, 70, 2)
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        mine = img.copy()
        center = (int(rng.randint(-12, w + 12)), int(rng.randint(-12, h + 12)))
        radius = int(rng.randint(0, 15))
        color = tuple(int(c) for c in rng.randint(0, 256, 3))
        cv2.circle(img, center, radius, color, -1)
        cv_circle(mine, center, radius, color, -1)
        np.testing.assert_array_equal(mine, img)
    with pytest.raises(ValueError):
        cv_circle(mine, (3, 3), 2, (1, 2, 3), 1)


def test_rehearsal_annotations_equal_the_jax_script(tmp_path):
    _, want = jrehearsal.write_set(str(tmp_path / "jax"), 24, seed=3)
    img_dir, got = trehearsal.write_set(str(tmp_path / "port"), 24, seed=3)
    with open(want) as f:
        want_json = json.load(f)
    with open(got) as f:
        got_json = json.load(f)
    assert got_json == want_json
    assert len(got_json["images"]) == 24
    assert sorted(os.listdir(img_dir)) == \
        sorted(im["file_name"] for im in want_json["images"])
    # the bucket count the harness will see is scale_pad_geometry's
    shapes = {(im["height"], im["width"]) for im in want_json["images"]}
    assert trehearsal.expected_buckets(got, 368, 8) == len(
        {jpre.scale_pad_geometry(h, w, 368, 8)[3:] for h, w in shapes})


# ---- the decode soak ------------------------------------------------------

def test_soak_equals_the_jax_oracle(capsys):
    scenes = tsoak.make_scenes(24, 8)
    people, truncated = tsoak.decode_scenes(scenes, torch.device("cpu"))
    assert not any(truncated)
    n_people = 0
    for (heat, paf), got in zip(scenes, people):
        want, _ = jgrouping_ref.paf_to_people(heat, paf)
        assert len(want) >= 1
        assert tsoak.compare(want, got) is None
        n_people += len(want)
    summary = tsoak.main(["--scenes", "24", "--device", "cpu"])
    assert (summary["count_mismatch"], len(summary["part_diffs"])) == (0, 0)
    assert summary["people"] == n_people > 100
    assert "24 scenes" in capsys.readouterr().out


@pytest.mark.parametrize("scene,people_max", [(158, 8), (69, 20)])
def test_soak_part_differences_are_the_jax_decodes(scene, people_max):
    """The soak's part differences (scene 158 of the 1-8 run: an exact
    tie; scene 69 of the crowded run: a truncated decode whose count
    matches) are the JAX package's own: its decode gives the port's
    people there."""
    import jax.numpy as jnp
    from rtpose_tpu.ops.decode import decode_poses_batch, people_to_numpy
    heat, paf = tsoak.make_scenes(scene + 1, people_max)[scene]
    got, truncated = tsoak.decode_scenes([(heat, paf)], torch.device("cpu"))
    want_dev = decode_poses_batch(jnp.asarray(heat[None]),
                                  jnp.asarray(paf[None]))
    row = type(want_dev)(*[np.asarray(getattr(want_dev, f))[0] for f in (
        "coords", "part_score", "score", "valid", "truncated")])
    want = people_to_numpy(row, 46 * 8, 46 * 8)
    assert truncated[0] == bool(row.truncated) == (scene == 69)
    host, _ = jgrouping_ref.paf_to_people(heat, paf)
    assert tsoak.compare(host, got[0]) == "part"

    def parts(people):
        return sorted(sorted((k, round(x, 6), round(y, 6))
                             for k, (x, y, _) in p["parts"].items())
                      for p in people)
    assert parts(got[0]) == parts(want)


def test_soak_gap_sees_competing_ties():
    """The gap is over candidates that share a peak: a scene of two
    parallel people has candidate pairs of equal criteria."""
    _, heat, paf = synth_example(seed=5, n_people=6)
    gap = tsoak.criterion_gap(heat, paf)
    assert gap is not None and gap >= 0.0


# ---- the training schedule ------------------------------------------------

def _synth(out, restore_at):
    return tsynth.main([
        "--device", "cpu", "--size", "64", "--stages", "1", "--batch", "4",
        "--steps-per-epoch", "3", "--epochs", "3", "--pool-batches", "2",
        "--restore-at-epoch", str(restore_at), "--out", str(out)])


def test_train_synth_restore_is_lossless(tmp_path):
    restored = _synth(tmp_path / "restored", 2)
    straight = _synth(tmp_path / "straight", 99)
    marker = restored["restored"]
    assert straight["restored"] is None
    assert marker["restored_step"] == marker["last_checkpoint_step"] == 6
    assert marker["meta_epoch"] == 2
    # the restored optimizer runs at the plateau's lr of the epoch before
    assert marker["lr"] == restored["epochs"][1]["lr"]
    assert [r["step"] for r in restored["epochs"]] == [3, 6, 9]
    assert [r["frozen"] for r in restored["epochs"]] == [True, False, False]
    for a, b in zip(restored["epochs"], straight["epochs"]):
        assert a["step"] == b["step"] and a["lr"] == b["lr"]
        for k in ("train_loss", "val_loss"):
            assert abs(a[k] - b[k]) <= REL * abs(b[k]), (k, a, b)
    with open(tmp_path / "restored" / "loss_log.jsonl") as f:
        assert len(f.read().splitlines()) == 3


def test_train_synth_pool_is_the_jax_scripts():
    """make_batches: the JAX script's scenes and its ``/255 - 0.5``."""
    got = tsynth.make_batches(0, 1, 2, 64)
    want = jsynth.make_batches(0, 1, 2, 64)
    for k in ("image", "keypoints"):
        np.testing.assert_array_equal(got[0][k].numpy(), want[0][k])


# ---- the crowded bench ----------------------------------------------------

class _SceneMaps(torch.nn.Module):
    """Stands in for the network: each input frame is answered with the
    ground-truth maps of the people rendered into it, found by its first
    4x4 pixels."""

    def __init__(self, table):
        super().__init__()
        self.table = table

    @staticmethod
    def key(x):
        return x[:4, :4].contiguous().numpy().tobytes()

    def forward(self, x):
        from rtpose_tpu_torch.models.common import ModelOutput
        heat, paf = zip(*(self.table[self.key(f)] for f in x))
        return ModelOutput(pafs=torch.stack(paf)[None],
                           heatmaps=torch.stack(heat)[None])


def _scene_table(names, n, size):
    """Render the bench's sets again from their seeds -> {first pixels of
    the normalized frame: (heat, paf)}."""
    from rtpose_tpu_torch.data.gt import ground_truth_maps
    table = {}
    for si, name in enumerate(tcrowded.DENSITIES):
        if name not in names:
            continue
        rng = np.random.RandomState(1000 + si)
        for _ in range(n):
            img, kps = tsynth.render_scene(
                rng, size,
                n_people=1 + rng.randint(tcrowded.DENSITIES[name]))
            people = kps[kps[:, 0, 2] > 0]
            heat, paf = ground_truth_maps(people, input_y=size,
                                          input_x=size)
            heat = heat + np.random.RandomState(len(table)).normal(
                0, 1e-5, heat.shape)
            x = tpre.normalize_device(torch.from_numpy(img), "vgg")
            table[_SceneMaps.key(x)] = (torch.from_numpy(heat).float(),
                                        torch.from_numpy(paf).float())
    return table


def test_crowded_bench_arms_agree_image_for_image(tmp_path):
    from rtpose_tpu_torch.infer.pipeline import PosePipeline
    from rtpose_tpu_torch.utils.synth_coco import compare_results
    size, n, names = 368, 6, ["light", "heavy"]
    sets = tcrowded.write_sets(str(tmp_path), n, size, names)
    model = _SceneMaps(_scene_table(names, n, size))

    def make_pipeline(**caps):
        return PosePipeline(model, device="cpu", input_size=size,
                            flip=False, **caps)

    rows = tcrowded.bench(sets, make_pipeline, 4, 1, str(tmp_path))
    by = {(r["config"], r["set"]): r for r in rows}
    assert len(rows) == 4 and all(r["images"] == n for r in rows)
    assert by[("default+retry", "heavy")]["n_retried"] > 0
    assert by[("raised-caps", "heavy")]["n_retried"] == 0
    for name in names:
        results = []
        for arm in ("default+retry", "raised-caps"):
            with open(tmp_path / f"detections_{arm}_{name}.json") as f:
                results.append(json.load(f))
        assert len(results[0]) > 0
        kp_err, score_err = compare_results(*results)
        assert kp_err == 0.0 and score_err <= 1e-6
        assert by[("default+retry", name)]["AP"] == \
            by[("raised-caps", name)]["AP"] > 0.5


# ---- the endurance run ----------------------------------------------------

def _endurance(out, hours):
    return tendurance.main([
        "--device", "cpu", "--hours", str(hours), "--size", "64",
        "--stages", "1", "--batch", "4", "--images", "8", "--threads", "2",
        "--ckpt-every", "2", "--log-every", "2", "--keep", "2",
        "--out", str(out)])


def test_endurance_resumes_keeps_and_refuses_a_bad_checkpoint(tmp_path):
    first = _endurance(tmp_path, 0.0008)
    assert first["resumed_from"] is None and first["windows"] >= 1
    assert first["steps_this_run"] == 2 * first["windows"]
    assert len(first["live_ckpts"]) <= 2
    assert first["live_ckpts"][-1] == first["global_step"]
    # a second launch resumes from the first one's last step; without a
    # window before its deadline its percentiles are null
    second = _endurance(tmp_path, 0)
    assert second["resumed_from"] == first["global_step"]
    assert second["windows"] == 0 and second["steps_this_run"] == 0
    for k in ("step_s_p50", "step_s_p99", "step_s_last10_over_first10"):
        assert second[k] is None
    assert len(second["live_ckpts"]) <= 2
    with open(tmp_path / "soak.jsonl") as f:
        assert len(f.read().splitlines()) == first["windows"]
    # a newest checkpoint that does not load is an error, not a fresh start
    newest = tmp_path / "ckpt" / f"step_{second['global_step']:08d}.pt"
    newest.write_bytes(b"not a checkpoint")
    with pytest.raises(Exception) as err:
        _endurance(tmp_path, 0)
    assert not isinstance(err.value, AssertionError)


# ---- the ported public functions -------------------------------------------

def _frames():
    rng = np.random.RandomState(11)
    return [rng.randint(0, 256, shape).astype(np.uint8)
            for shape in ((61, 83, 3), (480, 640, 3), (333, 500, 3),
                          (50, 50, 3), (37, 11, 1))]


@pytest.mark.parametrize("name", ["rtpose_preprocess", "vgg_preprocess",
                                  "inception_preprocess", "ssd_preprocess"])
def test_host_normalizations_equal_jax(name):
    for im in _frames():
        if im.shape[2] != 3:
            continue
        got, want = getattr(tpre, name)(im), getattr(jpre, name)(im)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["rtpose", "vgg", "inception", "ssd",
                                  "none"])
def test_preprocess_and_its_inverse_equal_jax(mode):
    for im in _frames():
        if im.shape[2] != 3:
            continue
        got, want = tpre.preprocess(im, mode), jpre.preprocess(im, mode)
        np.testing.assert_array_equal(got, want)
        if mode == "none":
            with pytest.raises(ValueError):
                tpre.inverse_preprocess(want, mode)
            continue
        inv = tpre.inverse_preprocess(want, mode)
        ref = jpre.inverse_preprocess(want, mode)
        assert inv.dtype == ref.dtype
        np.testing.assert_array_equal(inv, ref)
        name = f"inverse_{mode}_preprocess"
        np.testing.assert_array_equal(getattr(tpre, name)(want),
                                      getattr(jpre, name)(want))


@pytest.mark.parametrize("target", [368, 101, 64, 640])
def test_letterbox_is_pixel_equal(target):
    for im in _frames():
        src = im if im.shape[2] == 3 else im[..., 0]     # and a gray frame
        got, want = tpre.letterbox(src, target), jpre.letterbox(src, target)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]


@pytest.mark.parametrize("multiple", [64, 8, 7])
def test_pad_to_bucket_equals_jax(multiple):
    for im in _frames():
        got, want = tpre.pad_to_bucket(im, multiple), \
            jpre.pad_to_bucket(im, multiple)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1] and got[0].dtype == want[0].dtype


def test_step_timer_equals_jax(monkeypatch):
    ticks = iter([10.0, 10.5, 11.25, 12.0, 12.125, 13.0] * 2)
    monkeypatch.setattr("time.time", lambda: next(ticks))
    timers = []
    for mod in (tmeters, jmeters):
        t = mod.StepTimer()
        t.data_loaded()
        t.step_done()
        t.data_loaded()
        t.step_done()
        t.data_loaded()
        timers.append(t)
    for a in ("data", "step"):
        got, want = getattr(timers[0], a), getattr(timers[1], a)
        assert (got.sum, got.count, got.avg, got.val) == \
            (want.sum, want.count, want.avg, want.val)
    assert timers[0].data.count == 3 and timers[0].step.avg == 0.4375


def test_register_builds_a_registered_family():
    from rtpose_tpu_torch import models
    calls = []

    @models.register("tiny_test_family")
    def build(*, num_stages=1, dtype=None, generator=None, width=2):
        calls.append((num_stages, dtype, width))
        return torch.nn.Linear(width, 1)

    try:
        got = models.get_model("tiny_test_family", num_stages=3, width=4)
        assert isinstance(got, torch.nn.Linear) and got.in_features == 4
        assert calls == [(3, torch.float32, 4)]
        with pytest.raises(KeyError, match="tiny_test_family"):
            models.get_model("no_such_family")
    finally:
        models._REGISTRY.pop("tiny_test_family")
    with pytest.raises(KeyError):
        models.get_model("tiny_test_family")


# ---- the chain's recipes and the hourglass rescore -------------------------

@pytest.mark.parametrize("model", ["vgg19", "hourglass", "shufflenet_v2",
                                   "mobilenet", "openpose_v2",
                                   "atrous_resnet50", "atrous_cpm",
                                   "atrous_cpm_shared"])
def test_chain_recipes_and_refusals(model):
    cfg = Config()
    size = 256 if model == "hourglass" else 184
    tchain.apply_recipe(cfg, model, size)
    default = Config()
    assert cfg.model.name == model
    if model == "hourglass":
        assert (cfg.model.downsample, cfg.dataset.sigma,
                cfg.dataset.limb_width, cfg.train.masked_loss) == \
            (4, 4.416, 1.289, True)
        bad = 96
    else:
        assert (cfg.model.downsample, cfg.dataset.sigma,
                cfg.dataset.limb_width, cfg.train.masked_loss) == \
            (default.model.downsample, default.dataset.sigma,
             default.dataset.limb_width, default.train.masked_loss)
        bad = 100
    with pytest.raises(SystemExit, match=f"--model {model} needs --size "
                                         f"divisible by"):
        tchain.apply_recipe(Config(), model, bad)


def test_chain_refuses_an_unknown_family():
    with pytest.raises(SystemExit, match="unknown model family"):
        tchain.apply_recipe(Config(), "resnet", 184)


def test_rescore_parity_equals_run_eval_batched(tmp_path):
    from rtpose_tpu_torch.evalx.harness import run_eval_batched
    from rtpose_tpu_torch.infer.pipeline import load_pipeline
    out = tmp_path / "chain"
    chain = tchain.main([
        "--model", "hourglass", "--device", "cpu", "--size", "64",
        "--stages", "1", "--steps", "2", "--batch", "4", "--train-images",
        "8", "--val-images", "4", "--eval-images", "4", "--workers", "1",
        "--thresh-heatmap", "0.05", "--out", str(out)])
    assert chain["model"] == "hourglass" and chain["steps"] == 2
    got = trescore.main(["--ckpt", str(out), "--stages", "1", "--size",
                         "64", "--device", "cpu"])
    pipe = load_pipeline(str(out / "ckpt"), device="cpu",
                         model_name="hourglass", num_stages=1,
                         input_size=64, preprocess_mode="vgg", flip=True,
                         downsample=4, pad_factor=64)
    parity_path = tmp_path / "parity.json"
    stats = run_eval_batched(str(out / "heldout" / "images"),
                             str(out / "heldout" / "annotations.json"),
                             pipe, batch_size=16, score_mode="parity",
                             results_path=str(parity_path))
    assert got["AP_parity"] == round(float(stats["AP"]), 4)
    assert got["AP50_parity"] == round(float(stats["AP50"]), 4)
    with open(out / "results_person_rescore.json") as f:
        person = json.load(f)
    with open(parity_path) as f:
        parity = json.load(f)
    assert len(person) == len(parity) > 0
    assert [{**r, "score": 1.0} for r in person] == parity
