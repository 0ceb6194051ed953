"""The model zoo through the port's decode, pipeline and CLIs, against
the JAX package where it has the same path (the trainer step is in
tests/test_torch_zoo_trainer.py):

- the decode at factor 4 on hourglass-shaped maps (64x64 grids of 256 px
  frames): integer fields equal to the JAX decode's, scores within 1e-5;
- the hourglass pipeline at stride 4 and ``pad_factor`` 64 against the
  JAX pipeline on the same weights: maps within atol 2e-4, rtol 1e-3,
  people equal;
- the train CLI on both zoo experiments and the eval CLI on zoo
  families, on the CPU;
- ``scripts/export_jax_checkpoint.py --model``: a JAX checkpoint of a
  BatchNorm family served by the port with the JAX pipeline's maps;
- atrous_resnet50's inputs padded to multiples of 16.
"""

import json
import math
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rtpose_tpu.config import Config as JConfig
from rtpose_tpu.infer import pipeline as jpipeline
from rtpose_tpu.models import get_model as jax_get_model
from rtpose_tpu.ops import decode as jdecode
from rtpose_tpu.train.trainer import Trainer as JTrainer
from rtpose_tpu_torch.config import load_config
from rtpose_tpu_torch.infer import pipeline
from rtpose_tpu_torch.ops import decode

from test_torch_zoo import seeded_variables
from util_synth import synth_example

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-4
MAP_TOL = dict(atol=2e-4, rtol=1e-3)


@pytest.fixture(autouse=True)
def _few_threads():
    """Two intra-op threads: the suite runs six workers on the machine's
    cores, and small convolutions gain nothing from more."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


# seeds of rendered 64x64 scenes whose PAF samples at factor 4 keep off
# the cell boundaries, where the jitted JAX decode samples another cell
# than the port (ROADMAP.md §3, F1)
FACTOR4_SCENES = [(0, 1), (1, 3), (2, 5)]


@pytest.mark.parametrize("seed,n_people", FACTOR4_SCENES)
def test_decode_at_factor_4_matches_jax(seed, n_people):
    """Hourglass's decode: 64x64 maps (a 256 px frame at stride 4),
    refine and PAF sampling at factor 4."""
    _, heat, paf = synth_example(seed=seed, n_people=n_people, h=64, w=64)
    want = jax.device_get(jdecode.decode_poses(
        jnp.asarray(heat), jnp.asarray(paf), factor=4,
        sampling="pallas_fused"))
    got = decode.people_to_host(decode.decode_poses(
        torch.from_numpy(heat), torch.from_numpy(paf), factor=4))
    assert int(got.valid.sum()) == n_people
    for f in ("coords", "valid", "truncated"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    for f in ("score", "part_score"):
        np.testing.assert_allclose(np.asarray(getattr(got, f)),
                                   np.asarray(getattr(want, f)), atol=1e-5,
                                   rtol=0, err_msg=f)


def test_hourglass_pipeline_matches_jax_at_pad_factor_64():
    """A 60x80 frame scaled to 64x85 and padded to 64x128, the maps at
    stride 4 (16x32), flip TTA, as in the JAX pipeline with its device
    resize, on the same weights."""
    jmodel = jax_get_model("hourglass", num_stages=1, dtype=jnp.float32)
    variables = seeded_variables(jmodel, "hourglass", (64, 64))
    jpipe = jpipeline.PosePipeline(
        jmodel, jax.tree_util.tree_map(jnp.asarray, variables),
        input_size=64, flip=True, device_resize=True, downsample=4,
        pad_factor=64)
    tpipe = pipeline.load_pipeline(
        device="cpu", model_name="hourglass", num_stages=1, input_size=64,
        dtype=torch.float32, flax_params=variables, downsample=4,
        pad_factor=64)
    frame = np.random.RandomState(5).randint(0, 256, (60, 80, 3), np.uint8)
    jp, jheat, jpaf, jmeta = jpipe.run(frame)
    tp, theat, tpaf, tmeta = tpipe.run(frame)
    assert tmeta["padded_shape"] == tuple(jmeta["padded_shape"]) \
        == (64, 128, 3)
    assert theat.shape == jheat.shape == (16, 32, 19)
    assert float(np.abs(jheat).max()) > 1e-2
    np.testing.assert_allclose(theat, jheat, **MAP_TOL)
    np.testing.assert_allclose(tpaf, jpaf, **MAP_TOL)
    assert tuple(tmeta["upsampled"]) == tuple(jmeta["upsampled"]) \
        == (64, 128)
    assert len(tp) == len(jp)
    for a, b in zip(tp, jp):
        assert a["parts"].keys() == b["parts"].keys()
        for part, (x, y, s) in a["parts"].items():
            assert (x, y) == b["parts"][part][:2]
            assert abs(s - b["parts"][part][2]) <= 1e-4


@pytest.fixture(scope="module")
def coco_set(tmp_path_factory):
    from test_torch_data import write_coco
    return write_coco(str(tmp_path_factory.mktemp("zoo_coco")))


@pytest.mark.parametrize("config,sets", [
    ("shufflenet_v2_368x368.yaml", ["train.batch_size=2"]),
    ("hourglass_256x256.yaml", ["dataset.rotate_degrees=0",
                                "model.num_stages=1",
                                "train.batch_size=2"]),
])
def test_train_cli_trains_a_zoo_experiment(coco_set, tmp_path, monkeypatch,
                                           config, sets):
    """The train CLI on a zoo experiment file, cut to 64 px and fp32:
    one epoch, finite losses, a checkpoint of the family's own keys;
    hourglass at stride 4 with the crowd-masked loss."""
    from rtpose_tpu_torch.train.__main__ import main
    img_dir, ann = coco_set
    ckpt = tmp_path / "ckpt"
    monkeypatch.setattr(sys, "argv", [
        "train", "--device", "cpu", "--epochs", "1", "--config",
        os.path.join(ROOT, "experiments", config), "--set",
        f'dataset.train_image_dir="{img_dir}"',
        f"dataset.train_annotations={json.dumps([ann])}",
        f'dataset.val_image_dir="{img_dir}"',
        f'dataset.val_annotations="{ann}"', "dataset.image_size=64",
        'model.dtype="float32"', "train.data_workers=0",
        f'train.checkpoint_dir="{ckpt}"', *sets])
    trainer, history = main()
    cfg = load_config(os.path.join(ROOT, "experiments", config))
    assert trainer.cfg.model.name == cfg.model.name
    assert trainer.cfg.train.masked_loss == cfg.train.masked_loss
    assert math.isfinite(history[0]["train"]["loss"])
    assert math.isfinite(history[0]["val"]["loss"])
    assert os.listdir(ckpt)
    head = "score_paf0.weight" if cfg.model.name == "hourglass" \
        else "paf.weight"
    assert head in trainer.model.state_dict()


@pytest.mark.parametrize("model,extra", [
    ("hourglass", ["--input-size", "64"]),
    ("shufflenet_v2", ["--input-size", "56", "--batch", "2"]),
])
def test_evalx_cli_runs_a_zoo_family(model, extra, monkeypatch, capsys,
                                     tmp_path):
    """The eval CLI with ``--model``: hourglass at stride 4 and pad 64,
    shufflenet_v2 batched; seeded weights, so an AP of whatever they
    find."""
    from rtpose_tpu_torch.evalx.__main__ import main
    from rtpose_tpu_torch.utils.synth_coco import (spread_people,
                                                   write_synth_coco)
    rng = np.random.RandomState(0)
    img_dir, ann = write_synth_coco(
        str(tmp_path), [(64, 48, spread_people(rng, 1, 64, 48))] * 2)
    monkeypatch.setattr(sys, "argv", [
        "evalx", "--image-dir", img_dir, "--ann", ann, "--model", model,
        "--stages", "1", "--fp32", "--no-flip", "--device", "cpu", *extra])
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    stats = main()
    out = capsys.readouterr().out
    assert f"mAP (OKS .50:.95) = {stats['AP']:.4f}" in out
    assert 0.0 <= stats["AP"] <= 1.0 or stats["AP"] == -1.0


def test_export_jax_checkpoint_of_a_zoo_family(tmp_path):
    """``scripts/export_jax_checkpoint.py --model shufflenet_v2``: a JAX
    Trainer's orbax checkpoint (parameters and BatchNorm statistics)
    exported to a .pth in the port's keys and loaded strictly gives the
    maps of the JAX ``load_pipeline(checkpoint_dir)`` pipeline, fp32."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        import export_jax_checkpoint
    finally:
        sys.path.remove(os.path.join(ROOT, "scripts"))
    from rtpose_tpu.train.checkpoint import CheckpointManager

    cfg = JConfig()
    cfg.model.name, cfg.model.dtype = "shufflenet_v2", "float32"
    cfg.dataset.image_size, cfg.train.freeze_base_epochs = 56, 0
    variables = seeded_variables(jax_get_model(
        "shufflenet_v2", dtype=jnp.float32), "shufflenet_v2", (56, 56))
    tr = JTrainer(cfg, params=jax.tree_util.tree_map(jnp.asarray,
                                                     variables))
    ckpt = tmp_path / "ckpt"
    CheckpointManager(str(ckpt)).save(tr.state, step=1, is_best=True,
                                      meta={"epoch": 1})
    pth = str(tmp_path / "shufflenet.pth")
    assert export_jax_checkpoint.main(
        [str(ckpt), pth, "--model", "shufflenet_v2"]) == 0
    frame = np.random.RandomState(0).randint(0, 256, (56, 72, 3), np.uint8)
    jpipe = jpipeline.load_pipeline(str(ckpt), model_name="shufflenet_v2",
                                    input_size=56, flip=False,
                                    dtype=jnp.float32)
    _, jheat, jpaf, _ = jpipe.run(frame)
    tpipe = pipeline.load_pipeline(device="cpu", torch_weights=pth,
                                   model_name="shufflenet_v2", input_size=56,
                                   flip=False, dtype=torch.float32)
    _, theat, tpaf, _ = tpipe.run(frame)
    assert float(np.abs(jheat).max()) > 1e-2
    np.testing.assert_allclose(theat, jheat, **MAP_TOL)
    np.testing.assert_allclose(tpaf, jpaf, **MAP_TOL)


def test_atrous_resnet50_pads_its_stride8_side_even():
    """A 60x80 frame at 56 px is 56x75, padded to 8 that is 56x80 and a
    7x10 stride-8 grid, which layer3's 2x upsample (4x5 -> 8x10) cannot
    meet (the JAX pipeline raises there); the port pads atrous_resnet50's
    inputs to multiples of 16: 64x80, maps 8x10."""
    pipe = pipeline.load_pipeline(device="cpu", model_name="atrous_resnet50",
                                  input_size=56, flip=False,
                                  dtype=torch.float32)
    assert pipe.pad_factor == 16
    frame = np.random.RandomState(1).randint(0, 256, (60, 80, 3), np.uint8)
    _, heat, paf, meta = pipe.run(frame)
    assert meta["padded_shape"] == (64, 80, 3)
    assert heat.shape == (8, 10, 19) and paf.shape == (8, 10, 38)
    # where the stride-8 side is even the two pads agree
    wide = pipeline.load_pipeline(device="cpu", model_name="atrous_resnet50",
                                  input_size=64, flip=False,
                                  dtype=torch.float32)
    assert wide._prep(np.zeros((64, 80, 3), np.uint8))[1]["padded_shape"] \
        == (64, 80, 3)
