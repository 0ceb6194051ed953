"""``python -m rtpose_tpu_torch.train`` on the CPU (``--device cpu``): one
epoch from a synthetic COCO fixture at 64 px with one stage writes a
checkpoint that restores; ``--vgg-weights`` loads the backbone, which the
freeze phase keeps; two annotation files are unioned (as
tests/test_concat_dataset.py holds the JAX CLI); every refusal exits with
``SystemExit`` before anything loads."""

import json
import math
import os
import sys

import numpy as np
import pytest
import torch

from rtpose_tpu_torch.train import trainer as trainer_mod
from rtpose_tpu_torch.train.__main__ import main
from rtpose_tpu_torch.train.checkpoint import CheckpointManager

from test_torch_data import SIZES, write_coco


def _argv(monkeypatch, *sets, extra=()):
    monkeypatch.setattr(sys, "argv", ["train", "--device", "cpu",
                                      "--epochs", "1", *extra,
                                      "--set", *sets])


def _small(img_dir, anns, val_ann, ckpt, workers=0):
    return [f'dataset.train_image_dir="{img_dir}"',
            f"dataset.train_annotations={json.dumps(anns)}",
            f'dataset.val_image_dir="{img_dir}"',
            f'dataset.val_annotations="{val_ann}"',
            "dataset.image_size=64", "model.num_stages=1",
            'model.dtype="float32"', "train.batch_size=2",
            f"train.data_workers={workers}", "train.print_freq=1",
            f'train.checkpoint_dir="{ckpt}"']


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 4))
    yield
    torch.set_num_threads(before)


def test_cli_trains_one_epoch_and_writes_a_checkpoint(tmp_path, monkeypatch):
    img_dir, ann = write_coco(str(tmp_path / "coco"))
    ckpt = tmp_path / "ckpt"
    rng = np.random.RandomState(0)
    vgg, cin = {}, 3
    for i, cout in enumerate((64, 64, 128, 128, 256, 256, 256, 256, 512,
                              512)):
        vgg[f"features.{i}.weight"] = torch.from_numpy(
            rng.normal(0, 0.05, (cout, cin, 3, 3)).astype(np.float32))
        vgg[f"features.{i}.bias"] = torch.zeros(cout)
        cin = cout
    torch.save(vgg, tmp_path / "vgg19.pth")
    _argv(monkeypatch, *_small(img_dir, [ann], ann, ckpt),
          extra=("--vgg-weights", str(tmp_path / "vgg19.pth")))
    trainer, history = main()
    n_train = (len(SIZES) - 1) // 2          # drop_last; one crowd-only image
    assert trainer.step == n_train and trainer.epoch == 1
    (logs,) = history
    assert len(logs["train"]["data_s"]) == len(logs["train"]["step_s"]) \
        == n_train
    assert all(0 <= d <= s for d, s in zip(logs["train"]["data_s"],
                                           logs["train"]["step_s"]))
    state, meta = CheckpointManager(str(ckpt)).restore_latest()
    assert meta["epoch"] == 1 and state["step"] == n_train
    assert math.isfinite(meta["train_loss"]) and math.isfinite(
        meta["val_loss"])
    # the freeze phase (freeze_base_epochs 5) kept the imported backbone
    assert torch.equal(state["model"]["model0.0.weight"],
                       vgg["features.0.weight"])
    assert torch.equal(state["model"]["model0.21.weight"],
                       vgg["features.9.weight"])
    fresh = trainer_mod.Trainer(trainer.cfg, device="cpu")
    fresh.restore(CheckpointManager(str(ckpt)).restore_latest())
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k


def test_cli_unions_all_annotation_files(tmp_path, monkeypatch):
    """Two annotation files feed one epoch through 2 worker processes."""
    img_dir, ann_a = write_coco(str(tmp_path / "a"), SIZES[:3], seed=1)
    _, ann_b = write_coco(str(tmp_path / "b"), SIZES[3:], seed=2, id0=11)
    os.replace(tmp_path / "a" / "ann.json", tmp_path / "ann_a.json")
    for name in os.listdir(tmp_path / "b" / "images"):
        os.replace(tmp_path / "b" / "images" / name,
                   os.path.join(img_dir, name))
    captured = {}

    class _CaptureTrainer:
        def __init__(self, cfg, device):
            self.cfg, self.device = cfg, torch.device(device)

        def fit(self, train_loader, val_loader, epochs=None):
            captured["train"] = train_loader

    monkeypatch.setattr(trainer_mod, "Trainer", _CaptureTrainer)
    ann_a = str(tmp_path / "ann_a.json")
    _argv(monkeypatch, *_small(img_dir, [ann_a, ann_b], ann_a,
                               tmp_path / "ckpt", workers=2))
    main()
    loader = captured["train"]
    assert loader.num_workers == 2 and not loader.pin_memory
    seen = {int(i) for batch in loader for i in batch["image_id"]}
    assert seen & {1, 2} and seen & {11, 12, 13}


@pytest.mark.parametrize("case", ["empty_annotations", "unknown_loader",
                                  "native_with_rotate"])
def test_cli_refusals_exit_before_loading(tmp_path, monkeypatch, case):
    """Each refusal is a SystemExit with its reason; the paths name
    nothing that exists, so loading anything would raise another error.
    The native loader refuses rotation with the JAX CLI's reason."""
    missing = str(tmp_path / "missing.json")
    sets = _small(str(tmp_path / "none"), [missing], missing,
                  tmp_path / "ckpt")
    sets += {"empty_annotations": ["dataset.train_annotations=[]"],
             "unknown_loader": ['train.data_loader="dali"'],
             "native_with_rotate": ['train.data_loader="native"',
                                    "dataset.rotate_degrees=40.0"]}[case]
    _argv(monkeypatch, *sets)
    reason = {"empty_annotations": "empty", "unknown_loader": "unknown",
              "native_with_rotate": "native does not support "
                                    "dataset.rotate_degrees"}[case]
    with pytest.raises(SystemExit, match=reason):
        main()
    assert not os.path.exists(tmp_path / "ckpt")


def test_cli_trains_with_the_native_loader(tmp_path, monkeypatch):
    """train.data_loader=native: uint8 canvases with their content
    windows from the C++ pool, for the train and the deterministic val
    epoch; a checkpoint with finite losses."""
    img_dir, ann = write_coco(str(tmp_path / "coco"))
    captured = {}
    fit = trainer_mod.Trainer.fit

    def capture(self, train_loader, val_loader, **kw):
        captured["loaders"] = (train_loader, val_loader)
        return fit(self, train_loader, val_loader, **kw)

    monkeypatch.setattr(trainer_mod.Trainer, "fit", capture)
    _argv(monkeypatch, *_small(img_dir, [ann], ann, tmp_path / "ckpt",
                               workers=2), 'train.data_loader="native"')
    trainer, (logs,) = main()
    from rtpose_tpu_torch.data.native_loader import NativeLoader
    train_loader, val_loader = captured["loaders"]
    assert isinstance(train_loader, NativeLoader)
    assert train_loader.uint8_output and val_loader.deterministic
    assert not train_loader.pin_memory
    batch = next(iter(train_loader))
    assert batch["image"].dtype == torch.uint8
    assert batch["valid_xywh"].shape == (2, 4)
    assert trainer.step == (len(SIZES) - 1) // 2
    _, meta = CheckpointManager(str(tmp_path / "ckpt")).restore_latest()
    assert math.isfinite(meta["train_loss"]) and math.isfinite(
        meta["val_loss"])


def test_cli_trains_with_rotation(tmp_path, monkeypatch):
    """dataset.rotate_degrees reaches the PIL loader's train pipeline as
    RandomRotate (the JAX CLI's wiring), and the epoch trains."""
    from rtpose_tpu_torch.data import transforms as T
    img_dir, ann = write_coco(str(tmp_path / "coco"))
    captured = {}
    fit = trainer_mod.Trainer.fit

    def capture(self, train_loader, val_loader, **kw):
        captured["train"] = train_loader
        return fit(self, train_loader, val_loader, **kw)

    monkeypatch.setattr(trainer_mod.Trainer, "fit", capture)
    _argv(monkeypatch, *_small(img_dir, [ann], ann, tmp_path / "ckpt"),
          "dataset.rotate_degrees=40.0")
    trainer, (logs,) = main()
    rotations = [t for t in captured["train"].dataset.preprocess.transforms
                 if isinstance(t, T.RandomRotate)]
    assert [r.max_degrees for r in rotations] == [40.0]
    assert trainer.step == (len(SIZES) - 1) // 2
    assert math.isfinite(logs["train"]["loss"])
