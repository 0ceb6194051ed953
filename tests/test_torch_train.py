"""The port's training stack vs the JAX package's, on the CPU.

Small sizes as tests/test_train.py runs them (2 stages, 64 px, batch 8).
Both trainers start from the same parameters: the JAX ``Trainer``'s
initial ones, carried across through ``models.convert``.  Held:

- per-step loss within rel 1e-4 through the freeze, the release, clipping
  and gradient accumulation; parameters after the run within atol 1e-5
  and rtol 1e-3 (the two sides sum convolutions and the global gradient
  norm in other orders, and the JAX side all-reduces over its 8-device
  virtual mesh);
- the frozen convs bit-identical during the freeze, and the non-finite
  guard leaving parameters and momentum bit-identical;
- the loss, the plateau schedule and the config copy against the JAX
  package's; checkpoints as tests/test_train.py holds the JAX ones.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rtpose_tpu import config as jconfig
from rtpose_tpu.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from rtpose_tpu.models.common import ModelOutput as JModelOutput
from rtpose_tpu.models.vgg19 import VGG19RTPose as JVGG19RTPose
from rtpose_tpu.train.loss import stagewise_mse as jstagewise_mse
from rtpose_tpu.train.schedule import ReduceLROnPlateau as JPlateau
from rtpose_tpu.train.trainer import Trainer as JTrainer
from rtpose_tpu_torch import config
from rtpose_tpu_torch.models import get_model
from rtpose_tpu_torch.models.common import ModelOutput, he_reinit
from rtpose_tpu_torch.models.convert import (state_dict_from_flax,
                                             torch_layout_map)
from rtpose_tpu_torch.models.vgg19 import VGG19RTPose
from rtpose_tpu_torch.train.checkpoint import CheckpointManager
from rtpose_tpu_torch.train.loss import stagewise_mse
from rtpose_tpu_torch.train.schedule import ReduceLROnPlateau, freeze_mask
from rtpose_tpu_torch.train.trainer import Trainer, normalize_window
from rtpose_tpu_torch.utils.meters import MetricLogger

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-4
PARAM_ATOL, PARAM_RTOL = 1e-5, 1e-3
SIZE, BATCH = 64, 8


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The CPU step at 8 threads next to five busy test workers spends
    most of its time waiting; 4 threads keep it near a second."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 4))
    yield
    torch.set_num_threads(before)


def _cfg(cls, **train):
    cfg = cls()
    cfg.model.num_stages = 2
    cfg.model.dtype = "float32"
    cfg.model.init_scheme = "scratch"     # He weights: the trunk trains
    cfg.dataset.image_size = SIZE
    cfg.train.lr = 0.01
    cfg.train.freeze_base_epochs = 1
    cfg.train.print_freq = 100
    for k, v in train.items():
        setattr(cfg.train, k, v)
    return cfg


def _batch(rng, batch=BATCH, size=SIZE):
    images = rng.rand(batch, size, size, 3).astype(np.float32)
    kps = np.zeros((batch, 4, 18, 3), np.float32)
    kps[:, 0, :, 0] = rng.uniform(5, size - 5, (batch, 18))
    kps[:, 0, :, 1] = rng.uniform(5, size - 5, (batch, 18))
    kps[:, 0, :, 2] = 2
    kps[:, 1, :9] = kps[:, 0, 9:]          # a second, partial person
    return {"image": images, "keypoints": kps}


def _pair(**train):
    """(JAX Trainer, the port's Trainer) from the same initial weights."""
    jt = JTrainer(_cfg(jconfig.Config, **train))
    sd = state_dict_from_flax(jax.device_get(jt.state.params))
    return jt, Trainer(_cfg(config.Config, **train), device="cpu",
                       state_dict=sd)


def _jax_step(jt, batch):
    mask = np.ones((len(batch["image"]), SIZE // 8, SIZE // 8, 1), np.float32)
    jt.state, logs = jt.train_step(jt.state, jnp.asarray(batch["image"]),
                                   jnp.asarray(batch["keypoints"]),
                                   jnp.asarray(mask))
    return float(logs["loss"])


def _assert_params_close(jt, tt):
    want = state_dict_from_flax(jax.device_get(jt.state.params))
    got = tt.model.state_dict()
    for k, w in want.items():
        torch.testing.assert_close(got[k], w, atol=PARAM_ATOL,
                                   rtol=PARAM_RTOL, msg=k)


# ---- trainer parity --------------------------------------------------------

@pytest.mark.parametrize("phase", ["freeze_release", "clip", "accum"])
def test_trainer_matches_jax(phase):
    rng = np.random.RandomState(["freeze_release", "clip",
                                 "accum"].index(phase))
    train = {"freeze_release": {},
             "clip": dict(freeze_base_epochs=0, clip_grad_norm=0.05),
             "accum": dict(freeze_base_epochs=0, grad_accum_steps=2)}[phase]
    jt, tt = _pair(**train)
    w0 = tt.model.state_dict()["model0.0.weight"].clone()
    for i in range(5 if phase != "accum" else 4):
        if phase == "freeze_release" and i == 3:
            frozen = tt.model.state_dict()["model0.0.weight"]
            assert torch.equal(frozen, w0)       # bit-identical in phase 1
            jt.epoch = tt.epoch = 1
            jt.maybe_release_backbone()
            tt.maybe_release_backbone()
        batch = _batch(rng)
        before = {k: v.clone() for k, v in tt.model.state_dict().items()}
        want = _jax_step(jt, batch)
        got = tt.train_step(batch["image"], batch["keypoints"])
        assert got["skipped_nonfinite"] == 0.0
        assert math.isclose(got["loss"], want, rel_tol=LOSS_RTOL), (i, got,
                                                                    want)
        if phase == "accum" and i % 2 == 0:      # a micro-step: no update
            after = tt.model.state_dict()
            assert all(torch.equal(before[k], after[k]) for k in before)
    _assert_params_close(jt, tt)
    if phase == "freeze_release":
        assert not torch.equal(tt.model.state_dict()["model0.0.weight"], w0)
    if phase == "clip":   # the clip bound was active
        g = torch.autograd.grad(
            tt._loss(*tt._to_device(batch["image"], batch["keypoints"],
                                    None))[0],
            list(tt.params.values()))
        assert float(torch.sqrt(sum((x * x).sum() for x in g))) > 0.05


def test_nonfinite_batch_skips_whole_update():
    """A NaN batch leaves parameters AND momentum bit-identical, and
    training goes on after it (tests/test_train.py:79-113)."""
    tt = Trainer(_cfg(config.Config, freeze_base_epochs=0), device="cpu")
    rng = np.random.RandomState(4)
    good = _batch(rng)
    assert tt.train_step(good["image"], good["keypoints"])[
        "skipped_nonfinite"] == 0.0
    p1 = {k: v.clone() for k, v in tt.model.state_dict().items()}
    m1 = [s["momentum_buffer"].clone() for s in tt.optimizer.state.values()]
    assert m1 and any(float(m.abs().max()) > 0 for m in m1)
    logs = tt.train_step(np.full_like(good["image"], np.nan),
                         good["keypoints"])
    assert logs["skipped_nonfinite"] == 1.0 and math.isnan(logs["loss"])
    assert all(torch.equal(v, p1[k]) for k, v in tt.model.state_dict().items())
    m2 = [s["momentum_buffer"] for s in tt.optimizer.state.values()]
    assert all(torch.equal(a, b) for a, b in zip(m1, m2))
    assert all(p.grad is None for p in tt.params.values())
    logs = tt.train_step(good["image"], good["keypoints"])
    assert math.isfinite(logs["loss"]) and logs["skipped_nonfinite"] == 0.0


def test_uint8_window_batches_normalise_like_jax():
    """The uint8 + content-window wire format (trainer.py:115-132): the
    same expression in numpy float32, exact zeros outside the window."""
    rng = np.random.RandomState(6)
    u8 = rng.randint(0, 256, (3, 16, 20, 3), np.uint8)
    win = np.array([[0, 0, 20, 16], [2, 3, 10, 5], [19, 15, 1, 1]], np.int32)
    got = normalize_window(torch.from_numpy(u8), torch.from_numpy(win))
    want = (u8.astype(np.float32) / np.float32(255.0) - IMAGENET_MEAN) \
        / IMAGENET_STD
    ys, xs = np.mgrid[0:16, 0:20]
    for b, (x0, y0, w, h) in enumerate(win):
        inside = (ys >= y0) & (ys < y0 + h) & (xs >= x0) & (xs < x0 + w)
        want[b] *= inside[..., None]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert int((got[1] != 0).any(-1).sum()) == 50
    tt = Trainer(_cfg(config.Config), device="cpu")
    kps = _batch(rng, batch=3, size=SIZE)["keypoints"]
    u8 = rng.randint(0, 256, (3, SIZE, SIZE, 3), np.uint8)
    win = np.array([[0, 0, SIZE, SIZE]] * 3, np.int32)
    logs = tt.run_epoch([{"image": u8, "keypoints": kps, "valid_xywh": win}])
    assert math.isfinite(logs["loss"])


# ---- loss, schedule, config ------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_stagewise_mse_matches_jax(masked):
    rng = np.random.RandomState(int(masked))
    S, B, h, w = 3, 2, 6, 7
    pafs = rng.randn(S, B, h, w, 38).astype(np.float32)
    heats = rng.randn(S, B, h, w, 19).astype(np.float32)
    heat_gt = rng.rand(B, h, w, 19).astype(np.float32)
    paf_gt = rng.randn(B, h, w, 38).astype(np.float32)
    mask = (rng.rand(B, h, w, 1) > 0.3).astype(np.float32) if masked \
        else None
    t = torch.from_numpy
    total, logs = stagewise_mse(ModelOutput(t(pafs), t(heats)), t(heat_gt),
                                t(paf_gt), *(2 * [None if mask is None
                                                  else t(mask)]))
    jtotal, jlogs = jstagewise_mse(
        JModelOutput(jnp.asarray(pafs), jnp.asarray(heats)),
        jnp.asarray(heat_gt), jnp.asarray(paf_gt),
        *(2 * [None if mask is None else jnp.asarray(mask)]))
    assert sorted(logs) == sorted(jlogs)
    assert len(logs) == 2 * S + 4
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-6)
    for k in logs:
        np.testing.assert_allclose(float(logs[k]), float(jlogs[k]), rtol=1e-6,
                                   err_msg=k)


# metric sequences of tests/test_train.py:116-140 and :235
_PLATEAU_CASES = {
    "drop_then_cooldown": (dict(lr=1.0, factor=0.5, patience=2, cooldown=1),
                           [1.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0]),
    "threshold_rel": (dict(lr=1.0, factor=0.5, patience=1, cooldown=0),
                      [1.0, 0.99999, 0.99998, 0.99997, 0.5]),
    "real_improvement": (dict(lr=1.0, factor=0.5, patience=1, cooldown=0),
                         [1.0, 0.9, 0.8, 0.8, 0.8, 0.8]),
    "cooldown_on_improved": (dict(lr=1.0, factor=0.5, patience=0,
                                  cooldown=2),
                             [1.0, 2.0, 0.5, 0.4, 2.0, 2.0, 0.1]),
}


@pytest.mark.parametrize("case", sorted(_PLATEAU_CASES))
def test_plateau_matches_jax(case):
    kw, metrics = _PLATEAU_CASES[case]
    ours, theirs = ReduceLROnPlateau(**kw), JPlateau(**kw)
    assert [ours.step(m) for m in metrics] == [theirs.step(m)
                                               for m in metrics]
    assert ours.state_dict() == theirs.state_dict()
    again = ReduceLROnPlateau(lr=1.0)
    again.load_state_dict(ours.state_dict())
    assert again == ours


def test_freeze_names_are_the_jax_packages_frozen_paths():
    names = VGG19RTPose.pretrained_conv_names()
    assert names == [f"model0.{i}" for i in (0, 2, 5, 7, 10, 12, 14, 16, 19,
                                             21)]
    paths = dict(torch_layout_map(1))
    assert [paths[n] for n in names] == JVGG19RTPose.pretrained_conv_paths()
    model = get_model("vgg19", num_stages=1)
    params = dict(model.named_parameters())
    frozen = freeze_mask(params, names, frozen=True)
    assert len(frozen) == 20 and "model0.23.weight" not in frozen
    assert freeze_mask(params, names, frozen=False) == set()


@pytest.mark.parametrize("source", ["default", "experiment", "dotlist"])
def test_config_copy_equals_the_jax_package(source):
    if source == "default":
        ours, theirs = config.Config(), jconfig.Config()
    elif source == "experiment":
        path = os.path.join(ROOT, "experiments", "vgg19_368x368_sgd.yaml")
        ours, theirs = config.load_config(path), jconfig.load_config(path)
        assert ours.train.batch_size == 72
    else:
        items = ["train.lr=0.5", "model.num_stages=2", "test.scales=[1,0.5]",
                 "train.resume=True", "model.dtype=float32"]
        ours = config.apply_dotlist(config.Config(), items)
        theirs = jconfig.apply_dotlist(jconfig.Config(), items)
    assert ours.to_dict() == theirs.to_dict()
    assert ours.to_json() == theirs.to_json()


def test_config_loads_json_without_yaml(tmp_path):
    path = tmp_path / "exp.json"
    path.write_text(json.dumps({"train": {"batch_size": 4}}))
    assert config.load_config(str(path)).train.batch_size == 4
    with pytest.raises(KeyError, match="unknown config key"):
        config.apply_overrides(config.Config(), {"train": {"nope": 1}})


# ---- models ----------------------------------------------------------------

def test_he_reinit_keeps_the_heads():
    model = get_model("vgg19", num_stages=2)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    he_reinit(model, torch.Generator().manual_seed(1))
    after = model.state_dict()
    heads = {"model1_1.8.weight", "model1_2.8.weight", "model2_1.12.weight",
             "model2_2.12.weight"}
    for k in before:
        same = torch.equal(before[k], after[k])
        assert same == (k in heads or k.endswith(".bias")), k
    w = after["model0.0.weight"]
    assert abs(float(w.std()) - math.sqrt(2.0 / 27)) < 0.05


def test_remat_gives_the_same_gradients():
    """Recomputed refinement branches change memory, not numbers."""
    x = torch.from_numpy(np.random.RandomState(2).rand(2, 32, 32, 3)
                         .astype(np.float32))
    grads = []
    for remat in (False, True):
        model = get_model("vgg19", num_stages=2, remat=remat,
                          generator=torch.Generator().manual_seed(0))
        out = model(x)
        (out.pafs.square().sum() + out.heatmaps.square().sum()).backward()
        grads.append({k: p.grad for k, p in model.named_parameters()})
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], rtol=1e-5,
                                   atol=0, msg=k)


# ---- checkpoints -----------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    cfg = _cfg(config.Config)
    tt = Trainer(cfg, device="cpu")
    batch = _batch(np.random.RandomState(2))
    tt.run_epoch([batch])
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(tt.state_dict(), step=1, is_best=True, meta={"epoch": 1})
    state, meta = mgr.restore(1)
    assert meta["epoch"] == 1
    fresh = Trainer(cfg, device="cpu")
    fresh.load_state_dict(state)
    for k, v in tt.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k
    assert fresh.frozen == tt.frozen and fresh.step == tt.step == 1
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_restored_trainer_takes_the_same_next_step(tmp_path):
    """Resume is exact: a fresh trainer restored from the latest
    checkpoint takes the next step bit-equal to one that never stopped,
    momentum and the gradient accumulator included."""
    cfg = _cfg(config.Config, freeze_base_epochs=0, grad_accum_steps=2,
               checkpoint_every_steps=3)
    tt = Trainer(cfg, device="cpu")
    rng = np.random.RandomState(8)
    batches = [_batch(rng) for _ in range(5)]
    mgr = CheckpointManager(str(tmp_path), keep=3)
    tt.run_epoch(batches[:3], ckpt=mgr)           # saved after step 3
    assert mgr._steps() == [3] and tt.mini_step == 1
    fresh = Trainer(cfg, device="cpu")
    fresh.restore(mgr.restore_latest())
    for b in batches[3:]:
        want = tt.train_step(b["image"], b["keypoints"])
        got = fresh.train_step(b["image"], b["keypoints"])
        assert got == want
    for k, v in tt.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k


def test_mid_epoch_checkpointing(tmp_path):
    cfg = _cfg(config.Config, checkpoint_every_steps=2)
    tt = Trainer(cfg, device="cpu")
    mgr = CheckpointManager(str(tmp_path), keep=5)
    batch = _batch(np.random.RandomState(3))
    tt.run_epoch([batch] * 4, ckpt=mgr)
    assert mgr._steps() == [2, 4]
    _state, meta = mgr.restore_latest()
    assert meta["mid_epoch"] is True


def test_epoch_and_mid_epoch_checkpoints_share_step_namespace(tmp_path):
    cfg = _cfg(config.Config, freeze_base_epochs=0, checkpoint_every_steps=2,
               epochs=1)
    cfg.train.checkpoint_dir = str(tmp_path)
    tt = Trainer(cfg, device="cpu", log_dir=str(tmp_path / "logs"))
    batch = _batch(np.random.RandomState(5))
    tt.fit([batch] * 3, [batch], epochs=1)
    mgr = CheckpointManager(str(tmp_path))
    assert mgr._steps() == [2, 3]
    state, meta = mgr.restore_latest()
    assert meta["epoch"] == 1 and not meta.get("mid_epoch", False)
    assert state["step"] == 3 and mgr.best_step() == 3
    with open(tmp_path / "logs" / "metrics.jsonl") as f:
        rec = json.loads(f.readline())
    assert rec["step"] == 1 and "train/loss" in rec


def test_garbage_collection_keeps_the_best(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = {"w": torch.zeros(2)}
    for step in range(1, 6):
        mgr.save(state, step=step, is_best=step == 2, meta={"s": step})
    assert mgr._steps() == [2, 4, 5]
    assert mgr.restore_best()[1] == {"s": 2}
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["best.json"] + [f"step_{s:08d}{x}" for s in (2, 4, 5)
                         for x in (".pt", ".meta.json")])


def test_resume_in_fit_restores_epoch_and_plateau(tmp_path):
    cfg = _cfg(config.Config, freeze_base_epochs=0, epochs=1)
    cfg.train.checkpoint_dir = str(tmp_path)
    tt = Trainer(cfg, device="cpu")
    batch = _batch(np.random.RandomState(9))
    tt.fit([batch], [batch], epochs=1)
    cfg.train.resume = True
    again = Trainer(cfg, device="cpu")
    again.fit([batch], [batch], epochs=1)
    assert again.epoch == 2 and again.step == 2
    assert again.plateau.best <= tt.plateau.best


def test_metric_logger_writes_jsonl(tmp_path):
    log = MetricLogger(str(tmp_path), tensorboard=False)
    log.log(3, {"loss": 0.5}, prefix="train/")
    log.close()
    rec = json.loads((tmp_path / "metrics.jsonl").read_text())
    assert rec["step"] == 3 and rec["train/loss"] == 0.5
