"""rtpose_tpu_torch models vs the flax VGG19RTPose: weight conversion,
strict loading, and forward parity on the same parameters.

Parameters come from the flax model (He re-initialised so activations keep
their scale through the trunk; the N(0, 0.01) init shrinks outputs to
~1e-10, which would make any tolerance vacuous) and cross over through
``state_dict_from_flax``.  Tolerance of the fp32 forward: atol 2e-4, rtol
1e-3, the bound of tests/test_vgg19_model.py for the same comparison.
"""

import argparse

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rtpose_tpu.models import get_model as jax_get_model
from rtpose_tpu.models.common import he_reinit
from rtpose_tpu.models.import_torch import export_rtpose_state_dict
from rtpose_tpu_torch.models import get_model
from rtpose_tpu_torch.models.convert import (load_reference_convs,
                                             load_torch_checkpoint,
                                             state_dict_from_flax,
                                             torch_layout_map)


def _flax_params(num_stages, seed=0):
    model = jax_get_model("vgg19", num_stages=num_stages, dtype=jnp.float32)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 16, 16, 3)))
    params = he_reinit(params, seed=seed + 1)
    return model, jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def flax6():
    return _flax_params(6)


@pytest.fixture(scope="module")
def flax2():
    return _flax_params(2)


def test_state_dict_from_flax_equals_export(flax6):
    _, params = flax6
    ours = state_dict_from_flax(params)
    ref = export_rtpose_state_dict(params)
    assert list(ours) == list(ref)
    for k, v in ref.items():
        assert tuple(ours[k].shape) == v.shape, k
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)


def test_module_keys_are_reference_layout(flax6):
    model = get_model("vgg19", num_stages=6)
    sd = model.state_dict()
    assert set(sd) == set(export_rtpose_state_dict(flax6[1]))
    assert len(torch_layout_map(6)) * 2 == len(sd)
    assert sum(v.numel() for v in sd.values()) == 52_311_446


def test_strict_load_of_export_and_checkpoints(flax6, tmp_path):
    _, params = flax6
    ref = {k: torch.from_numpy(np.array(v)) for k, v in
           export_rtpose_state_dict(params).items()}
    model = get_model("vgg19", num_stages=6)
    model.load_state_dict(ref, strict=True)
    raw = tmp_path / "pose_model.pth"
    torch.save(ref, raw)
    lightning = tmp_path / "last.ckpt"
    torch.save({"state_dict": {f"model.{k}": v for k, v in ref.items()}},
               lightning)
    for path in (raw, lightning):
        sd = load_torch_checkpoint(str(path))
        fresh = get_model("vgg19", num_stages=6,
                          generator=torch.Generator().manual_seed(3))
        fresh.load_state_dict(sd, strict=True)
        for k, v in fresh.state_dict().items():
            torch.testing.assert_close(v, ref[k], rtol=0, atol=0)


def test_forward_matches_flax_fp32(flax2):
    jmodel, params = flax2
    model = get_model("vgg19", num_stages=2).eval()
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    x = np.random.RandomState(1).rand(2, 40, 48, 3).astype(np.float32)
    want = jmodel.apply(jax.tree_util.tree_map(jnp.asarray, params),
                        jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.pafs.shape == (2, 2, 5, 6, 38)
    assert got.heatmaps.shape == (2, 2, 5, 6, 19)
    assert got.pafs.dtype == torch.float32
    assert float(np.abs(np.asarray(want.heatmaps)).max()) > 1e-2
    np.testing.assert_allclose(got.pafs.numpy(), np.asarray(want.pafs),
                               atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(got.heatmaps.numpy(),
                               np.asarray(want.heatmaps),
                               atol=2e-4, rtol=1e-3)


def test_bf16_compute_returns_fp32_close_to_fp32(flax2):
    """dtype is the compute type (flax semantics): a bf16 model keeps its
    fp32 parameters, returns fp32 maps, and lands within bf16 rounding of
    the fp32 forward (2% of the output range, 8 bf16 mantissa bits
    compounded over 12 convolutions)."""
    _, params = flax2
    sd = state_dict_from_flax(params)
    m32 = get_model("vgg19", num_stages=2).eval()
    m16 = get_model("vgg19", num_stages=2, dtype=torch.bfloat16).eval()
    m32.load_state_dict(sd)
    m16.load_state_dict(sd)
    assert next(m16.parameters()).dtype == torch.float32
    x = torch.from_numpy(
        np.random.RandomState(2).rand(1, 32, 32, 3).astype(np.float32))
    with torch.no_grad():
        a, b = m32(x), m16(x)
    assert b.heatmaps.dtype == torch.float32
    scale = float(a.pafs.abs().max())
    assert float((a.pafs - b.pafs).abs().max()) <= 2e-2 * scale


def test_seeded_init_is_deterministic_and_reference_scaled():
    a = get_model("vgg19", num_stages=1,
                  generator=torch.Generator().manual_seed(7))
    b = get_model("vgg19", num_stages=1,
                  generator=torch.Generator().manual_seed(7))
    c = get_model("vgg19", num_stages=1,
                  generator=torch.Generator().manual_seed(8))
    w = a.model0[0].weight
    assert torch.equal(w, b.model0[0].weight)
    assert not torch.equal(w, c.model0[0].weight)
    assert abs(float(a.model0[2].weight.detach().std()) - 0.01) < 1e-3
    assert float(a.model1_1[8].bias.detach().abs().max()) == 0.0


@pytest.mark.parametrize("name", ["mobilenet_v2", "resnext9000", "vgg16"])
def test_unported_family_raises(name):
    """A family the JAX package does not have is a KeyError, as there."""
    with pytest.raises(KeyError, match="unknown model family"):
        get_model(name)


@pytest.mark.parametrize("name,kwargs,stages", [
    ("mobilenet", {"num_stages": 2}, 2),
    ("hourglass", {"num_stages": 1}, 1),
    ("openpose_v2", {"num_paf_stages": 1, "num_heat_stages": 1}, 1),
])
def test_ported_family_builds(name, kwargs, stages):
    """The three families this test once found unported build and give
    their stages' maps at their stride (hourglass 4, the others 8)."""
    model = get_model(name, **kwargs).eval()
    with torch.no_grad():
        out = model(torch.zeros(1, 64, 64, 3))
    g = 16 if name == "hourglass" else 8
    assert out.pafs.shape == (stages, 1, g, g, 38)
    assert out.heatmaps.shape == (stages, 1, g, g, 19)


def _lightning_checkpoint(path, state_dict):
    """A lightning-shaped checkpoint as the reference's training writes
    it: prefixed weights, a key outside the model, the epoch and an
    ``argparse.Namespace`` of hyper-parameters (which a ``weights_only``
    read refuses)."""
    sd = {f"model.{k}": torch.from_numpy(np.array(v))
          for k, v in state_dict.items()}
    sd["loss.extra"] = torch.ones(3)
    torch.save({"state_dict": sd, "epoch": 3,
                "hyper_parameters": {"args": argparse.Namespace(
                    lr=1e-4, batch_size=8, model="vgg19")}}, path)


def test_lightning_checkpoint_loads_as_in_the_jax_package(flax6, tmp_path,
                                                          capsys):
    """``--weight`` (``load_pipeline(torch_weights=...)``) on a lightning
    checkpoint with a Namespace and an extra key: the port's weights are
    the JAX pipeline's, exactly, and the maps on a seeded 56x56 frame
    agree within the fp32 bound.  Six stages: the JAX import maps all six
    (rtpose_tpu/models/import_torch.py:43), so it cannot load fewer."""
    from rtpose_tpu.infer import pipeline as jpipeline
    from rtpose_tpu_torch.infer import pipeline as tpipeline

    _, params = flax6
    path = str(tmp_path / "epoch=3.ckpt")
    _lightning_checkpoint(path, export_rtpose_state_dict(params))
    jpipe = jpipeline.load_pipeline(torch_weights=path, num_stages=6,
                                    input_size=56, flip=False,
                                    dtype=jnp.float32)
    tpipe = tpipeline.load_pipeline(torch_weights=path, num_stages=6,
                                    input_size=56, flip=False,
                                    dtype=torch.float32, device="cpu")
    assert "1 keys outside the model's convs ignored" in \
        capsys.readouterr().err
    want = export_rtpose_state_dict(jpipe.params)
    got = tpipe.model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    frame = np.random.RandomState(5).randint(0, 256, (56, 56, 3), np.uint8)
    _, jheat, jpaf, _ = jpipe.run(frame)
    _, theat, tpaf, _ = tpipe.run(frame)
    assert float(np.abs(jheat).max()) > 1e-2
    np.testing.assert_allclose(theat, jheat, atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(tpaf, jpaf, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("fault", ["missing", "misshapen"])
def test_lightning_checkpoint_without_a_conv_is_refused(flax2, tmp_path,
                                                        fault):
    """A mapped conv that is missing or of another shape raises
    ValueError naming it (the JAX import raises KeyError for a missing
    one), before any weight is written."""
    from rtpose_tpu_torch.infer import pipeline as tpipeline

    sd = {k: v.numpy() for k, v in state_dict_from_flax(flax2[1]).items()}
    if fault == "missing":
        del sd["model2_2.12.bias"]
    else:
        sd["model2_2.12.bias"] = np.zeros(20, np.float32)
    path = str(tmp_path / "bad.ckpt")
    _lightning_checkpoint(path, sd)
    with pytest.raises(ValueError, match=r"model2_2\.12\.bias"):
        tpipeline.load_pipeline(torch_weights=path, num_stages=2,
                                device="cpu")
    model = get_model("vgg19", num_stages=2,
                      generator=torch.Generator().manual_seed(1))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match=r"model2_2\.12\.bias"):
        load_reference_convs(model, load_torch_checkpoint(path))
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
