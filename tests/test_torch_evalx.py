"""The port's COCO eval path against the JAX package's.

- ``evalx/cocoeval.py`` (a copy): the same stats as the JAX evaluator on
  tests/test_cocoeval_differential.py's randomised cases, exactly;
- ``run_eval`` and ``run_eval_batched`` (batch 2, ``pad_partial``, a
  coarser pad, multi-scale 0.5,1) with oracle-map stubs in place of the
  network (``utils/synth_coco.py``: each input shape is answered with the
  GT maps of its frame's people), on a synthetic COCO set of three raw
  shapes in two shape buckets, against the JAX harness over
  ``PosePipeline(..., device_resize=True)``: the same number of results
  per image, keypoints within 1e-4 px, scores within 1e-5, the stats
  equal, and AP at least the JAX run's (1.0: the oracle's people are
  found whole);
- mirrors of the JAX harness's producer/consumer and partial-chunk
  tests;
- ``vis_dir``: both harnesses write each frame's drawing under its
  file_name with the JAX harness's pixels (drawing and JPEG writer equal
  to cv2's, bound 0);
- the CLI's ``main()`` (per image, ``--batch``, ``--multiscale``, its
  rejects, ``--pad-to``, ``--vis-dir``, the flag that is not ported);
- ``load_pipeline(checkpoint_dir=...)`` from a port ``Trainer``
  checkpoint, and ``scripts/export_jax_checkpoint.py`` from a JAX
  ``Trainer`` orbax checkpoint: maps equal to the JAX
  ``load_pipeline(checkpoint_dir)`` pipeline's within the fp32 model bound
  of tests/test_vgg19_model.py (atol 2e-4, rtol 1e-3).
"""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rtpose_tpu.evalx import cocoeval as jcocoeval
from rtpose_tpu.evalx import harness as jharness
from rtpose_tpu.infer import pipeline as jpipeline
from rtpose_tpu.models.common import ModelOutput as JModelOutput
from rtpose_tpu_torch.evalx import cocoeval, harness
from rtpose_tpu_torch.infer.pipeline import PosePipeline, load_pipeline
from rtpose_tpu_torch.utils.synth_coco import (OracleMaps, oracle_maps,
                                               spread_people,
                                               write_synth_coco)

from test_cocoeval_differential import STAT_KEYS, _rand_case

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 128                 # input_size: every frame's short side, scale 1
KP_TOL = 1e-4              # results' keypoints, px
SCORE_TOL = 1e-5           # results' scores
MAP_TOL = dict(atol=2e-4, rtol=1e-3)


# ---------------------------------------------------------------------------
# the evaluator copy
# ---------------------------------------------------------------------------

def _copies(gts, dts, img_ids):
    return ({i: [dict(g) for g in gts[i]] for i in img_ids},
            {i: [dict(d) for d in dts[i]] for i in img_ids}, img_ids)


@pytest.mark.parametrize("seeds", [range(0, 40), range(100, 400)])
def test_cocoeval_copy_gives_the_jax_stats(seeds):
    for seed in seeds:
        gts, dts, img_ids = _rand_case(seed)
        got = cocoeval.evaluate_keypoints(*_copies(gts, dts, img_ids))
        want = jcocoeval.evaluate_keypoints(*_copies(gts, dts, img_ids))
        for k in STAT_KEYS:
            assert got[k] == want[k], (seed, k)


# ---------------------------------------------------------------------------
# the harness on oracle maps, port vs JAX
# ---------------------------------------------------------------------------

class JaxOracle:
    """The JAX pipeline's stand-in network: ``apply(params, batch)``
    answers a (n, ph, pw, 3) batch with the maps stored for (ph, pw)."""

    def __init__(self, maps):
        self.maps = {k: (jnp.asarray(h), jnp.asarray(p))
                     for k, (h, p) in maps.items()}

    def apply(self, params, batch):
        n, ph, pw = batch.shape[:3]
        heat, paf = self.maps[(ph, pw)]
        return JModelOutput(pafs=jnp.broadcast_to(paf, (1, n) + paf.shape),
                            heatmaps=jnp.broadcast_to(heat,
                                                      (1, n) + heat.shape))


@pytest.fixture(scope="module")
def synth_set(tmp_path_factory):
    """Seven frames of three raw shapes: 128x160 (one person), 128x170 and
    128x174 (the same two people), in two buckets, (128, 160) and
    (128, 176); the second bucket's chunks of 2 mix two raw shapes."""
    rng = np.random.RandomState(0)
    one = spread_people(rng, 1, 128, 160)
    two = spread_people(rng, 2, 128, 170)
    scenes = {(128, 160): one, (128, 170): two, (128, 174): two}
    order = [(128, 160), (128, 170), (128, 174)] * 2 + [(128, 160)]
    root = str(tmp_path_factory.mktemp("synth_coco"))
    img_dir, ann = write_synth_coco(
        root, [(h, w, scenes[(h, w)]) for h, w in order])
    return img_dir, ann, scenes


CASES = {   # name -> (pad_factor, scales)
    "single": (8, None),
    "pad32": (32, None),
    "multiscale": (8, (0.5, 1.0)),
}


@pytest.fixture(scope="module")
def pipes(synth_set):
    """name -> (JAX pipeline, port pipeline) on the same oracle maps."""
    _, _, scenes = synth_set
    out = {}
    for name, (pad, scales) in CASES.items():
        maps = oracle_maps(scenes, SIZE, pad_factor=pad,
                           scales=scales or (1.0,))
        jpipe = jpipeline.PosePipeline(JaxOracle(maps), {}, input_size=SIZE,
                                       flip=False, device_resize=True,
                                       pad_factor=pad)
        tpipe = PosePipeline(OracleMaps(maps), device="cpu", input_size=SIZE,
                             flip=False, pad_factor=pad, device_resize=True)
        out[name] = (jpipe, tpipe)
    return out


def _results_equal(got_path, want_path):
    got, want = (json.load(open(p)) for p in (got_path, want_path))
    by_image = {}
    for r in want:
        by_image.setdefault(r["image_id"], []).append(r)
    assert sorted(r["image_id"] for r in got) == \
        sorted(r["image_id"] for r in want)
    for r in got:
        # the same people in the same order per image
        w = by_image[r["image_id"]].pop(0)
        assert r["category_id"] == w["category_id"] == 1
        np.testing.assert_allclose(r["keypoints"], w["keypoints"],
                                   atol=KP_TOL, rtol=0)
        assert abs(r["score"] - w["score"]) <= SCORE_TOL
    return len(got)


def _stats_equal(got, want):
    for k in STAT_KEYS + ["frames_retried", "frames_truncated"]:
        assert got[k] == want[k], k
    # the JAX run finds the oracle's people whole: AP 1
    assert want["AP"] == 1.0 and got["AP"] >= want["AP"]


@pytest.mark.parametrize("name", ["single", "multiscale"])
def test_run_eval_matches_jax_harness(synth_set, pipes, tmp_path, name):
    img_dir, ann, _ = synth_set
    jpipe, tpipe = pipes[name]
    scales = CASES[name][1]
    paths = [str(tmp_path / f"{side}.json") for side in ("port", "jax")]
    got = harness.run_eval(img_dir, ann, tpipe, results_path=paths[0],
                           scales=scales, score_mode="person")
    want = jharness.run_eval(img_dir, ann, jpipe, results_path=paths[1],
                             scales=scales, score_mode="person")
    assert _results_equal(*paths) == 11      # 3 x 1 + 4 x 2 people
    _stats_equal(got, want)


@pytest.mark.parametrize("name", ["single", "pad32", "multiscale"])
def test_run_eval_batched_matches_jax_harness(synth_set, pipes, tmp_path,
                                              name):
    img_dir, ann, _ = synth_set
    jpipe, tpipe = pipes[name]
    scales = CASES[name][1]
    paths = [str(tmp_path / f"{side}.json") for side in ("port", "jax")]
    got = harness.run_eval_batched(img_dir, ann, tpipe, batch_size=2,
                                   results_path=paths[0], scales=scales,
                                   score_mode="person")
    want = jharness.run_eval_batched(img_dir, ann, jpipe, batch_size=2,
                                     results_path=paths[1], scales=scales,
                                     score_mode="person")
    assert _results_equal(*paths) == 11
    _stats_equal(got, want)
    for k in ("n_buckets", "images_in_sub_batch_buckets"):
        assert got[k] == want[k], k
    # a pad of 32 keeps 128x160 alone and puts 170 and 174 in (128, 192)
    assert got["n_buckets"] == 2


def test_batched_chunks_split_by_raw_shape(synth_set, pipes):
    """A chunk of the (128, 176) bucket holds a 128x170 and a 128x174
    frame: the port runs them as two sub-batches of one ticket, as the JAX
    pipeline does with its device resize."""
    img_dir, ann, _ = synth_set
    _, tpipe = pipes["single"]
    tickets = []
    orig = tpipe.run_batch_submit
    tpipe.run_batch_submit = lambda frames: tickets.append(
        orig(frames)) or tickets[-1]
    try:
        harness.run_eval_batched(img_dir, ann, tpipe, batch_size=2)
    finally:
        del tpipe.run_batch_submit
    subs = sorted(len(t[2]) if t[0] == "multi" else 1 for t in tickets)
    assert subs == [1, 1, 2, 2]


def test_run_eval_batched_pads_partial_chunks(synth_set, pipes, tmp_path):
    """The remainder chunk is padded to the batch size and the pad frames'
    results are dropped: the results equal the unpadded run's (mirror of
    the JAX harness test)."""
    img_dir, ann, _ = synth_set
    _, tpipe = pipes["single"]
    sizes = []
    orig = tpipe.run_batch_submit
    tpipe.run_batch_submit = lambda frames: (sizes.append(len(frames)),
                                             orig(frames))[1]
    try:
        r_pad, r_exact = str(tmp_path / "pad.json"), str(tmp_path / "ex.json")
        stats = harness.run_eval_batched(img_dir, ann, tpipe, batch_size=4,
                                         results_path=r_pad)
        padded_sizes, sizes[:] = list(sizes), []
        harness.run_eval_batched(img_dir, ann, tpipe, batch_size=4,
                                 results_path=r_exact, pad_partial=False)
    finally:
        del tpipe.run_batch_submit
    assert padded_sizes == [4, 4] and sizes == [4, 3]
    assert stats["frames_retried"] + stats["frames_truncated"] == 0
    assert _results_equal(r_pad, r_exact) == 11


def test_run_eval_batched_consumer_error_unblocks_producer(synth_set, pipes):
    """If the card's side raises mid-eval, the read-ahead thread must not
    stay parked on its full queue (mirror of the JAX harness test)."""
    img_dir, ann, _ = synth_set
    _, tpipe = pipes["single"]

    def boom(frames):
        raise RuntimeError("device fell over")

    tpipe.run_batch_submit = boom
    before = threading.active_count()
    try:
        with pytest.raises(RuntimeError, match="device fell over"):
            harness.run_eval_batched(img_dir, ann, tpipe, batch_size=1)
    finally:
        del tpipe.run_batch_submit
    # the stop event lets the producer drain out within its 1 s put timeout
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.1)
    assert threading.active_count() <= before


@pytest.mark.parametrize("fn", ["run_eval", "run_eval_batched"])
def test_vis_dir_matches_jax_harness(synth_set, pipes, tmp_path, fn):
    """Each frame's drawing is written under its file_name, and its pixels
    are the JAX harness's (cv2 draws and writes there; the drawing and the
    JPEG writer are equal to cv2's, bound 0)."""
    import cv2
    img_dir, ann, _ = synth_set
    jpipe, tpipe = pipes["single"]
    kwargs = {"batch_size": 2} if fn == "run_eval_batched" else {}
    vis = {side: tmp_path / side for side in ("port", "jax")}
    getattr(harness, fn)(img_dir, ann, tpipe, vis_dir=str(vis["port"]),
                         **kwargs)
    getattr(jharness, fn)(img_dir, ann, jpipe, vis_dir=str(vis["jax"]),
                          **kwargs)
    names = sorted(os.listdir(img_dir))
    assert sorted(os.listdir(vis["port"])) == names
    assert sorted(os.listdir(vis["jax"])) == names
    drawn = 0
    for name in names:
        got = cv2.imread(str(vis["port"] / name))
        want = cv2.imread(str(vis["jax"] / name))
        np.testing.assert_array_equal(got, want, err_msg=name)
        drawn += not np.array_equal(
            got, cv2.imread(os.path.join(img_dir, name)))
    assert drawn == len(names)       # every frame has people drawn


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_set(tmp_path_factory):
    """Two 64x48 frames as in tests/test_evalx_cli.py (JPEGs here)."""
    rng = np.random.RandomState(0)
    frames = [(64, 48, spread_people(rng, 1, 64, 48)) for _ in range(2)]
    return write_synth_coco(str(tmp_path_factory.mktemp("evalx_cli")),
                            frames)


CLI = ["--stages", "1", "--input-size", "56", "--fp32", "--no-flip",
       "--device", "cpu"]


def _run_cli(cli_set, extra, monkeypatch, capsys):
    from rtpose_tpu_torch.evalx.__main__ import main
    img_dir, ann = cli_set
    monkeypatch.setattr(sys, "argv", ["evalx", "--image-dir", img_dir,
                                      "--ann", ann] + CLI + extra)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    stats = main()
    out = capsys.readouterr().out
    assert f"mAP (OKS .50:.95) = {stats['AP']:.4f}" in out
    assert json.loads(out[out.index("{"):out.rindex("}") + 1]) == stats
    # --fp32 turned TF32 off
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    return stats, out


@pytest.mark.parametrize("extra", [
    [], ["--batch", "2"], ["--multiscale", "0.75,1.0"],
    ["--multiscale", "0.75,1.0", "--batch", "2"]],
    ids=["per_image", "batch", "multiscale", "multiscale_batch"])
def test_evalx_cli(cli_set, monkeypatch, capsys, extra):
    stats, _ = _run_cli(cli_set, extra, monkeypatch, capsys)
    assert set(stats) >= set(STAT_KEYS)
    assert ("pipeline_s" in stats) == ("--batch" in extra)


@pytest.mark.parametrize("extra", [[], ["--batch", "2"]],
                         ids=["per_image", "batch"])
def test_evalx_cli_vis_dir(cli_set, tmp_path, monkeypatch, capsys, extra):
    """``--vis-dir`` writes one drawing per frame, of the frame's size."""
    import cv2
    img_dir, _ = cli_set
    vis = tmp_path / "vis"
    _run_cli(cli_set, ["--vis-dir", str(vis)] + extra, monkeypatch, capsys)
    names = sorted(os.listdir(img_dir))
    assert sorted(os.listdir(vis)) == names and len(names) == 2
    for name in names:
        assert cv2.imread(str(vis / name)).shape == (64, 48, 3)


def test_evalx_cli_pad_to(cli_set, monkeypatch, capsys):
    stats, out = _run_cli(cli_set, ["--batch", "2", "--pad-to", "64"],
                          monkeypatch, capsys)
    assert stats["n_buckets"] == 1


@pytest.mark.parametrize("extra,msg", [
    (["--multiscale", "0.5,abc"], "comma-separated floats"),
    (["--multiscale", "0.5,-1.0"], "positive"),
    (["--multiscale", "0"], "positive"),
    (["--model", "mobilenet_v2"], "unknown model family"),
])
def test_evalx_cli_rejects(cli_set, monkeypatch, capsys, extra, msg):
    with pytest.raises(SystemExit, match=msg):
        _run_cli(cli_set, extra, monkeypatch, capsys)


def test_evalx_cli_needs_the_card_by_default(cli_set, monkeypatch, capsys):
    """Without ``--device`` the CLI runs on the card, and raises where
    there is none: no move to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    from rtpose_tpu_torch.evalx.__main__ import main
    img_dir, ann = cli_set
    monkeypatch.setattr(sys, "argv", ["evalx", "--image-dir", img_dir,
                                      "--ann", ann, "--stages", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main()


def test_evalx_help_runs():
    import subprocess
    out = subprocess.run([sys.executable, "-m", "rtpose_tpu_torch.evalx",
                          "--help"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--device" in out.stdout and "TF32" in out.stdout


# ---------------------------------------------------------------------------
# weights from checkpoints
# ---------------------------------------------------------------------------

def _port_trainer_checkpoint(directory):
    from rtpose_tpu_torch.config import Config
    from rtpose_tpu_torch.train.checkpoint import CheckpointManager
    from rtpose_tpu_torch.train.trainer import Trainer
    cfg = Config()
    cfg.model.num_stages, cfg.model.dtype = 1, "float32"
    cfg.dataset.image_size = 32
    cfg.train.freeze_base_epochs = 0
    tr = Trainer(cfg, device="cpu")
    init = {k: v.detach().clone() for k, v in tr.model.state_dict().items()}
    rng = np.random.RandomState(0)
    kps = np.zeros((2, 1, 18, 3), np.float32)
    kps[..., :2], kps[..., 2] = rng.uniform(4, 28, (2, 1, 18, 2)), 2.0
    tr.train_step(rng.rand(2, 32, 32, 3).astype(np.float32), kps)
    mgr = CheckpointManager(str(directory))
    mgr.save(tr.state_dict(), step=1, is_best=True, meta={"epoch": 1})
    trained = {k: v.detach().clone() for k, v in tr.model.state_dict().items()}
    tr.train_step(rng.rand(2, 32, 32, 3).astype(np.float32), kps)
    mgr.save(tr.state_dict(), step=2, meta={"epoch": 2})   # not the best
    return init, trained


def test_load_pipeline_from_port_checkpoint(tmp_path):
    init, trained = _port_trainer_checkpoint(tmp_path)
    pipe = load_pipeline(str(tmp_path), device="cpu", num_stages=1,
                         input_size=56, flip=False, dtype=torch.float32)
    loaded = pipe.model.state_dict()
    assert loaded.keys() == trained.keys()
    for k, v in trained.items():
        torch.testing.assert_close(loaded[k], v, rtol=0, atol=0)
    assert any(not torch.equal(init[k], trained[k]) for k in init)
    _, heat, _, _ = pipe.run(np.zeros((60, 80, 3), np.uint8))
    assert heat.shape == (7, 10, 19)


def test_load_pipeline_rejects_two_sources_and_orbax(tmp_path):
    with pytest.raises(ValueError, match="pass one of"):
        load_pipeline(str(tmp_path), torch_weights="pose_model.pth",
                      device="cpu")
    with pytest.raises(ValueError, match="pass one of"):
        load_pipeline(str(tmp_path), seed=1, device="cpu")
    with pytest.raises(FileNotFoundError):
        load_pipeline(str(tmp_path / "none"), device="cpu", num_stages=1)
    # an orbax step directory: named, and pointed at the export script
    (tmp_path / "step_00000001").mkdir()
    (tmp_path / "step_00000001.meta.json").write_text("{}")
    with pytest.raises(ValueError, match="export_jax_checkpoint"):
        load_pipeline(str(tmp_path), device="cpu", num_stages=1)


def test_evalx_cli_port_checkpoint_dir(cli_set, tmp_path, monkeypatch,
                                       capsys):
    _port_trainer_checkpoint(tmp_path)
    _, out = _run_cli(cli_set, ["--weight", str(tmp_path)], monkeypatch,
                      capsys)
    assert f"loaded weights from {tmp_path}" in out


def test_export_jax_checkpoint_round_trip(tmp_path):
    """A JAX Trainer's orbax checkpoint (6 stages: the reference layout),
    exported to a .pth and loaded strictly by the port, gives the maps of
    the JAX ``load_pipeline(checkpoint_dir)`` pipeline, fp32."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        import export_jax_checkpoint
    finally:
        sys.path.remove(os.path.join(ROOT, "scripts"))
    from rtpose_tpu.config import Config
    from rtpose_tpu.models.common import he_reinit
    from rtpose_tpu.train.checkpoint import CheckpointManager
    from rtpose_tpu.train.trainer import Trainer

    cfg = Config()
    cfg.model.num_stages, cfg.model.dtype = 6, "float32"
    cfg.dataset.image_size = 56
    cfg.train.freeze_base_epochs = 0
    tr = Trainer(cfg)
    # He scale: N(0, 0.01) shrinks a 6-stage output to nothing
    state = tr.state.replace(params=he_reinit(
        {"params": tr.state.params}, seed=3)["params"])
    ckpt = tmp_path / "ckpt"
    CheckpointManager(str(ckpt)).save(state, step=1, is_best=True,
                                      meta={"epoch": 1})
    pth = str(tmp_path / "pose_model.pth")
    assert export_jax_checkpoint.main([str(ckpt), pth]) == 0

    frame = np.random.RandomState(0).randint(0, 256, (56, 72, 3), np.uint8)
    jpipe = jpipeline.load_pipeline(str(ckpt), num_stages=6, input_size=56,
                                    flip=False, dtype=jnp.float32)
    _, jheat, jpaf, _ = jpipe.run(frame)
    tpipe = load_pipeline(device="cpu", torch_weights=pth, num_stages=6,
                          input_size=56, flip=False, dtype=torch.float32)
    _, theat, tpaf, _ = tpipe.run(frame)
    assert float(np.abs(jheat).max()) > 1e-2
    np.testing.assert_allclose(theat, jheat, **MAP_TOL)
    np.testing.assert_allclose(tpaf, jpaf, **MAP_TOL)


def test_build_pipeline_from_common_args(monkeypatch):
    """``add_common_args`` + ``build_pipeline``, as the demos will call
    them: the flags reach the pipeline; ``--device-resize`` is accepted
    and changes nothing."""
    import argparse

    from rtpose_tpu_torch.demo.picture_demo import (add_common_args,
                                                    build_pipeline)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    parser = argparse.ArgumentParser()
    add_common_args(parser)
    pipes = [build_pipeline(parser.parse_args(
        ["--device", "cpu", "--stages", "1", "--input-size", "56",
         "--gaussian-filt", "--downsample", "8"] + extra))
        for extra in ([], ["--device-resize"])]
    for pipe in pipes:
        assert pipe.device.type == "cpu" and pipe.input_size == 56
        assert pipe._decode_kwargs["gaussian_filt"]
        assert pipe.preprocess_mode == "rtpose" and not pipe.flip
        assert next(pipe.model.parameters()).dtype == torch.bfloat16
    assert torch.backends.cudnn.allow_tf32        # only --fp32 turns it off
    frame = np.random.RandomState(0).randint(0, 256, (60, 80, 3), np.uint8)
    np.testing.assert_array_equal(pipes[0].run(frame)[1],
                                  pipes[1].run(frame)[1])
