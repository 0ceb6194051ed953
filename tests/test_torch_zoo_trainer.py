"""One ``Trainer`` step of the model zoo's BatchNorm families against the
JAX trainer, on the JAX package's own variant configurations
(tests/test_train_variants.py: hourglass with the masked loss at stride
4, atrous_resnet50 and atrous_cpm), from the same weights: the loss
within rel 1e-4 of the JAX trainer's; BatchNorm in train mode in
``train_step`` (the running statistics move) and in eval mode in
``eval_step`` (they stay); a skipped non-finite step leaves them.  A
file of its own, so that the JAX trainer's compiles land on another
worker than the forward tests'.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rtpose_tpu.config import Config as JConfig
from rtpose_tpu.models import get_model as jax_get_model
from rtpose_tpu.train.trainer import Trainer as JTrainer
from rtpose_tpu_torch.config import Config
from rtpose_tpu_torch.models.convert import state_dict_from_flax
from rtpose_tpu_torch.train.trainer import Trainer

from test_torch_zoo import seeded_variables
from test_train_variants import _batch

LOSS_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _few_threads():
    """Two intra-op threads: the suite runs six workers on the machine's
    cores, and small convolutions gain nothing from more."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def _variant_cfgs(name):
    """The JAX package's variant configuration of `name`
    (tests/test_train_variants.py), as a JAX and a port Config."""
    out = []
    for cls in (JConfig, Config):
        cfg = cls()
        cfg.model.name, cfg.model.dtype = name, "float32"
        cfg.dataset.image_size = 64
        cfg.train.freeze_base_epochs, cfg.train.print_freq = 0, 100
        if name == "hourglass":
            cfg.model.num_stages, cfg.model.downsample = 1, 4
            cfg.dataset.sigma, cfg.dataset.limb_width = 4.416, 1.289
            cfg.train.lr, cfg.train.masked_loss = 1e-4, True
        else:
            cfg.model.num_stages = 2
            cfg.train.lr, cfg.train.clip_grad_norm = 1e-3, 1.0
        out.append(cfg)
    return out


def _stats(trainer):
    return {k: v.clone() for k, v in trainer.model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


@pytest.mark.parametrize("name", ["hourglass", "atrous_resnet50",
                                  "atrous_cpm"])
def test_trainer_step_matches_the_jax_trainer(name):
    jcfg, cfg = _variant_cfgs(name)
    variables = seeded_variables(jax_get_model(
        name, num_stages=jcfg.model.num_stages, dtype=jnp.float32), name,
        (64, 64))
    batch = _batch(np.random.RandomState(0), stride=jcfg.model.downsample)
    jt = JTrainer(jcfg, params=jax.tree_util.tree_map(jnp.asarray,
                                                      variables))
    want = float(jt.run_epoch([batch], train=True)["loss"])
    tr = Trainer(cfg, device="cpu",
                 state_dict=state_dict_from_flax(variables, model_name=name))
    assert tr._frozen_modules() == []
    before = _stats(tr)
    logs = tr.train_step(batch["image"], batch["keypoints"], batch["mask"])
    assert abs(logs["loss"] - want) <= LOSS_RTOL * abs(want), \
        (logs["loss"], want)
    assert logs["skipped_nonfinite"] == 0.0
    moved = _stats(tr)
    assert all(not torch.equal(before[k], moved[k]) for k in before)
    # eval mode: the running statistics normalise and stay
    val = tr.eval_step(batch["image"], batch["keypoints"], batch["mask"])
    assert math.isfinite(val["loss"])
    assert all(torch.equal(moved[k], v) for k, v in _stats(tr).items())
    # a non-finite batch is skipped, statistics included
    bad = dict(batch, image=np.full_like(batch["image"], np.nan))
    logs = tr.train_step(bad["image"], bad["keypoints"], bad["mask"])
    assert logs["skipped_nonfinite"] == 1.0
    assert all(torch.equal(moved[k], v) for k, v in _stats(tr).items())


def test_scratch_init_redraws_a_zoo_family():
    """init_scheme "scratch" He-redraws the hidden convs of any family and
    keeps its heads (hourglass: score_paf* / score_ht*)."""
    cfg = _variant_cfgs("hourglass")[1]
    ref = Trainer(cfg, device="cpu").model.state_dict()
    cfg.model.init_scheme = "scratch"
    got = Trainer(cfg, device="cpu").model.state_dict()
    assert torch.equal(got["score_paf0.weight"], ref["score_paf0.weight"])
    assert not torch.equal(got["stem_conv.weight"], ref["stem_conv.weight"])
    assert torch.equal(got["stem_bn.weight"], ref["stem_bn.weight"])
