"""The port's model zoo vs the flax models: every family other than VGG19
(openpose_v2, mobilenet, shufflenet_v2, atrous_resnet50, atrous_cpm,
atrous_cpm_shared, hourglass) carried across through
``state_dict_from_flax`` and run on the same seeded input.

- fp32 forwards in eval mode: atol 2e-4, rtol 1e-3, the bound of
  tests/test_vgg19_model.py for the same comparison, on an odd and an even
  side (flax's 'SAME' padding of strided convs and pools is asymmetric);
  hourglass on a 64x64 input, its pad_factor;
- BatchNorm in train mode against ``apply(..., train=True,
  mutable=["batch_stats"])``: the outputs at the same bound, the new
  running means and variances at rtol 1e-5, atol 1e-6;
- the shared pieces ('SAME' convs and pools, the bilinear upsample, the
  channel shuffle, initialisers, ``he_reinit``), the registry's errors,
  the strict loader, and the caffe interop (prototxt and npz export,
  pickle import) against the JAX package's.

The flax variable trees come from ``init``'s shapes; their values are
drawn with numpy at He scale (the N(0, 0.01) init shrinks outputs to
where any tolerance is vacuous) and, for the BatchNorm families, running
statistics equal to the batch's own, so that eval mode keeps the
activations' scale.
"""

import pickle

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from rtpose_tpu.models import caffe_interop as jcaffe
from rtpose_tpu.models import get_model as jax_get_model
from rtpose_tpu.models import shufflenet_v2 as jshuffle
from rtpose_tpu.models.atrous import _bilinear_x2
from rtpose_tpu_torch.models import FAMILIES, caffe_interop, get_model
from rtpose_tpu_torch.models import common
from rtpose_tpu_torch.models.atrous import bilinear_x2
from rtpose_tpu_torch.models.convert import load_strict, state_dict_from_flax
from rtpose_tpu_torch.models.shufflenet_v2 import (WIDTH_CONFIGS,
                                                   channel_shuffle)

FWD_TOL = dict(atol=2e-4, rtol=1e-3)


@pytest.fixture(autouse=True)
def _few_threads():
    """Two intra-op threads: the suite runs six workers on the machine's
    cores, and small convolutions gain nothing from more."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)
STAT_TOL = dict(atol=1e-6, rtol=1e-5)

# family -> (get_model kwargs, input (B, H, W)); H odd where the family
# takes any side
CASES = {
    "openpose_v2": (dict(num_paf_stages=2, num_heat_stages=1), (2, 45, 48)),
    "mobilenet": (dict(num_stages=2), (2, 41, 48)),
    "shufflenet_v2": ({}, (2, 41, 48)),
    "atrous_resnet50": ({}, (2, 47, 48)),
    "atrous_cpm": (dict(num_stages=2), (2, 43, 48)),
    "atrous_cpm_shared": (dict(num_stages=2), (2, 43, 48)),
    "hourglass": (dict(num_stages=2), (1, 64, 64)),
}
BN_FAMILIES = [n for n in CASES if n != "openpose_v2"]
RESIDUAL = ("hourglass", "atrous_resnet50")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def seeded_variables(jmodel, name, shape, seed=0):
    """The flax model's variable tree (from ``init``'s shapes, traced with
    ``jax.eval_shape``) filled from a numpy generator: kernels normal with
    std ``gain / sqrt(fan_in)`` (He's gain sqrt(2); 0.5 for the residual
    families, whose residual sums no BatchNorm rescales in eval mode, so
    they stay near their input's scale), biases, BatchNorm scales and
    shifts and running statistics drawn too, so that every mapping is
    exercised."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1,) + shape + (3,)))

    def fill(tree):
        res = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                res[k] = fill(v)
                continue
            shp = tuple(v.shape)
            if k == "kernel":
                gain = 0.5 if name in RESIDUAL else 2 ** 0.5
                arr = rng.randn(*shp) * gain / np.prod(shp[:-1]) ** 0.5
            elif k == "bias":
                arr = rng.randn(*shp) * 0.01
            elif k == "scale":
                arr = rng.uniform(0.5, 1.5, shp)
            elif k == "alpha":
                arr = rng.uniform(0.1, 0.4, shp)
            elif k == "mean":
                arr = rng.randn(*shp) * 0.1
            else:
                arr = rng.uniform(0.5, 2.0, shp)
            res[k] = arr.astype(np.float32)
        return res

    return {coll: fill(dict(tree)) for coll, tree in shapes.items()}


_FAMILY_CACHE = {}


def _family(name):
    """(flax model, variables as numpy, input, port model in eval mode
    loaded with the variables) for a CASES family, built once."""
    if name not in _FAMILY_CACHE:
        kwargs, (b, h, w) = CASES[name]
        jmodel = jax_get_model(name, dtype=jnp.float32, **kwargs)
        x = (np.random.RandomState(0).rand(b, h, w, 3).astype(np.float32)
             - 0.5)
        variables = seeded_variables(jmodel, name, (h, w))
        model = get_model(name, **kwargs).eval()
        load_strict(model, state_dict_from_flax(variables, model_name=name))
        _FAMILY_CACHE[name] = (jmodel, variables, x, model)
    return _FAMILY_CACHE[name]


@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_flax(name):
    jmodel, variables, x, model = _family(name)
    want = jmodel.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    stride = 4 if name == "hourglass" else 8
    _, (b, h, w) = CASES[name]
    gy, gx = -(-h // stride), -(-w // stride)
    if name == "openpose_v2":      # VGG's 2x2 VALID pools floor the side
        gy = h // stride
    for field, ch in (("pafs", 38), ("heatmaps", 19)):
        g, wnt = getattr(got, field), np.asarray(getattr(want, field))
        assert g.dtype == torch.float32
        assert tuple(g.shape) == wnt.shape and wnt.shape[1:] == (b, gy, gx,
                                                                 ch)
        assert float(np.abs(wnt).max()) > 1e-2
        np.testing.assert_allclose(g.numpy(), wnt, **FWD_TOL)


def _assert_train_mode_matches(jmodel, variables, model, x, name):
    """Train-mode forward of the port (loaded with `variables`) against
    flax's with mutable batch_stats: outputs at FWD_TOL, the moved
    running statistics at STAT_TOL."""
    want, mutated = jmodel.apply(variables, jnp.asarray(x), train=True,
                                 mutable=["batch_stats"])
    got = model.train()(torch.from_numpy(x))
    for field in ("pafs", "heatmaps"):
        np.testing.assert_allclose(getattr(got, field).detach().numpy(),
                                   np.asarray(getattr(want, field)),
                                   **FWD_TOL)
    new = state_dict_from_flax({"params": variables["params"],
                                "batch_stats": _np(mutated["batch_stats"])},
                               model_name=name)
    old = state_dict_from_flax(variables, model_name=name)
    own = model.state_dict()
    stats = [k for k in new if k.endswith(("running_mean", "running_var"))]
    assert stats
    for k in stats:
        np.testing.assert_allclose(own[k].numpy(), new[k].numpy(),
                                   err_msg=k, **STAT_TOL)
        assert not torch.equal(own[k], old[k]), f"{k} did not move"
    return want


@pytest.mark.parametrize("name", [n for n in BN_FAMILIES
                                  if n != "hourglass"])
def test_train_mode_batchnorm_matches_flax(name):
    jmodel, variables, x, _ = _family(name)
    model = get_model(name, **CASES[name][0])
    load_strict(model, state_dict_from_flax(variables, model_name=name))
    _assert_train_mode_matches(jmodel, variables, model, x, name)


def test_hourglass_train_mode_matches_flax_per_level():
    """The hourglass in train mode, two levels deep at 32 px (the
    recursion, both chains, the pools and the upsample; 8x8 at the
    deepest level), against flax's Hourglass module at the forward and
    statistics bounds."""
    from rtpose_tpu.models.hourglass import Hourglass as JHourglass
    from rtpose_tpu_torch.models.hourglass import Hourglass

    x = np.random.RandomState(1).randn(2, 32, 32, 64).astype(np.float32)
    jmodel = JHourglass(32, 2, depth=2)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))
    rng = np.random.RandomState(2)
    variables = jax.tree_util.tree_map(
        lambda t: (rng.randn(*t.shape) * 0.2).astype(np.float32), shapes)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: np.abs(a) + 0.5, variables["batch_stats"])
    model = Hourglass(32, 2, depth=2)
    load_strict(model, state_dict_from_flax(variables,
                                            model_name="hourglass"))
    want, mutated = jmodel.apply(variables, jnp.asarray(x), train=True,
                                 mutable=["batch_stats"])
    got = model.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), **FWD_TOL)
    new = state_dict_from_flax({"params": variables["params"],
                                "batch_stats": _np(mutated["batch_stats"])},
                               model_name="hourglass")
    own = model.state_dict()
    for k, v in new.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(own[k].numpy(), v.numpy(),
                                       err_msg=k, **STAT_TOL)


def test_hourglass_train_mode_matches_flax_in_fp64():
    """The whole hourglass in train mode (1 stack, batch 4 at 64 px) is
    ill-conditioned in fp32: its deepest level normalises 4 values a
    channel and flax's one-pass variance (E[x^2] - E[x]^2) cancels, so
    flax's own fp32 forward strays from the fp64 one by ~3e-3.  In fp64
    on both sides (flax under ``jax.enable_x64``) the two agree at the
    forward and statistics bounds."""
    kwargs, shape = dict(num_stages=1), (4, 64, 64)
    x = np.random.RandomState(3).rand(*shape, 3) - 0.5
    with jax.enable_x64(True):
        jmodel = jax_get_model("hourglass", dtype=jnp.float64, **kwargs)
        variables = jax.tree_util.tree_map(
            lambda a: a.astype(np.float64),
            seeded_variables(jmodel, "hourglass", shape[1:]))
        want, mutated = jmodel.apply(variables, jnp.asarray(x), train=True,
                                     mutable=["batch_stats"])
        want, mutated = _np(want), _np(mutated)
    model = get_model("hourglass", dtype=torch.float64, **kwargs).double()
    load_strict(model, {k: v.double() for k, v in state_dict_from_flax(
        variables, model_name="hourglass").items()})
    got = model.train()(torch.from_numpy(x))
    for field in ("pafs", "heatmaps"):
        w = np.asarray(getattr(want, field))     # fp64 inside, fp32 out
        assert float(np.abs(w).max()) > 1e-1
        np.testing.assert_allclose(getattr(got, field).detach().numpy(), w,
                                   **FWD_TOL)
    new = state_dict_from_flax({"params": variables["params"],
                                "batch_stats": mutated["batch_stats"]},
                               model_name="hourglass")
    own = model.state_dict()
    for k, v in new.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(own[k].numpy(), v.numpy(),
                                       err_msg=k, **STAT_TOL)


@pytest.mark.parametrize("name,key", [
    ("openpose_v2", "paf_stage0.m0_0.conv.weight"),
    ("openpose_v2", "backbone.prelu4_2.weight"),
    ("mobilenet", "backbone.ir1_0.dw_bn.running_var"),
    ("mobilenet", "stages.model2_1.12.weight"),
    ("shufflenet_v2", "stage2_unit1.dw_proj.bn.running_mean"),
    ("atrous_resnet50", "trunk.layer2_0.proj_bn.weight"),
    ("atrous_cpm", "stem.ia1.b5_2.conv.weight"),
    ("atrous_cpm_shared", "stage3.conv5.weight"),
    ("hourglass", "hg0.low1_d4.block0.conv2.weight"),
    ("hourglass", "paf_score_0.weight"),
])
def test_state_dict_keys_read_like_flax_paths(name, key):
    kwargs = dict(CASES[name][0])
    assert key in get_model(name, **kwargs).state_dict()


@pytest.mark.parametrize("k,stride,dilation", [(3, 2, 1), (7, 2, 1),
                                               (1, 2, 1), (3, 1, 4),
                                               (5, 1, 1)])
@pytest.mark.parametrize("n", [7, 8])
def test_same_conv_matches_flax(k, stride, dilation, n):
    """'SAME' is asymmetric for a strided conv on an even side (k=3:
    0 before, 1 after; k=7: 2 and 3), as flax pads."""
    rng = np.random.RandomState(n)
    x = rng.randn(2, n, n + 3, 4).astype(np.float32)
    conv = fnn.Conv(5, (k, k), strides=(stride, stride),
                    kernel_dilation=(dilation, dilation), padding="SAME")
    params = {"params": {"kernel": rng.randn(k, k, 4, 5).astype(np.float32),
                         "bias": rng.randn(5).astype(np.float32)}}
    want = np.asarray(conv.apply(params, jnp.asarray(x)))
    port = common.Conv(4, 5, k, stride=stride, dilation=dilation)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(
            params["params"]["kernel"].transpose(3, 2, 0, 1).copy()))
        port.bias.copy_(torch.from_numpy(params["params"]["bias"]))
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-5, rtol=1e-5)


def test_depthwise_conv_layout_matches_flax():
    rng = np.random.RandomState(0)
    x = rng.randn(1, 8, 8, 6).astype(np.float32)
    conv = fnn.Conv(6, (3, 3), strides=(2, 2), padding="SAME",
                    feature_group_count=6, use_bias=False)
    params = {"params": {"kernel": rng.randn(3, 3, 1, 6).astype(np.float32)}}
    shapes = jax.eval_shape(conv.init, jax.random.PRNGKey(0), x)
    assert shapes["params"]["kernel"].shape == (3, 3, 1, 6)
    port = common.Conv(6, 6, 3, stride=2, groups=6, bias=False)
    weight = state_dict_from_flax({"params": {"dw": params["params"]}},
                                  model_name="mobilenet")["dw.weight"]
    with torch.no_grad():
        port.weight.copy_(weight)
    assert tuple(port.weight.shape) == (6, 1, 3, 3)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(conv.apply(params, jnp.asarray(x))),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n", [7, 8, 9])
def test_same_pools_match_flax(n):
    x = np.random.RandomState(n).randn(2, n, n + 1, 3).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    for port, want in (
            (common.max_pool_same(xt, 3, 2),
             fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                          padding="SAME")),
            (common.avg_pool_same(xt, 3, 1),
             fnn.avg_pool(jnp.asarray(x), (3, 3), strides=(1, 1),
                          padding="SAME"))):
        np.testing.assert_allclose(port.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("h,w", [(4, 4), (3, 5), (1, 2)])
def test_bilinear_x2_matches_jax_image_resize(h, w):
    """Half-pixel centres; the edge rows and columns take the edge
    values, as jax.image.resize's renormalised triangle kernel does."""
    x = np.random.RandomState(h).randn(2, h, w, 3).astype(np.float32)
    want = np.asarray(_bilinear_x2(jnp.asarray(x)))
    got = bilinear_x2(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got[:, 0, 0], x[:, 0, 0], atol=1e-6)
    np.testing.assert_allclose(got[:, -1, -1], x[:, -1, -1], atol=1e-6)


def test_channel_shuffle_nchw_is_the_flax_permutation():
    x = torch.arange(8.0).reshape(1, 8, 1, 1)
    assert channel_shuffle(x, 2).ravel().tolist() == [0, 4, 1, 5, 2, 6, 3, 7]
    y = np.random.RandomState(0).randn(2, 3, 4, 12).astype(np.float32)
    want = np.asarray(jshuffle.channel_shuffle(jnp.asarray(y), 2))
    got = channel_shuffle(torch.from_numpy(y).permute(0, 3, 1, 2), 2)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("name", [n for n in FAMILIES if n != "vgg19"])
def test_registry_takes_the_jax_signatures(name):
    """remat is VGG19's alone: anywhere else it is a TypeError, as a
    mistyped option is."""
    with pytest.raises(TypeError):
        get_model(name, remat=True)
    with pytest.raises(TypeError):
        get_model(name, num_stage=2)


def test_registry_stage_arguments():
    def n_params(m):
        return sum(p.numel() for p in m.parameters())

    # single-stage families accept num_stages and ignore it
    for name in ("shufflenet_v2", "atrous_resnet50"):
        assert n_params(get_model(name, num_stages=1)) == \
            n_params(get_model(name, num_stages=6))
    assert get_model("hourglass", num_stages=3).num_stacks == 3
    assert get_model("hourglass", num_stages=3, num_stacks=2).num_stacks == 2
    op = get_model("openpose_v2", num_stages=1, num_paf_stages=3,
                   num_heat_stages=1)
    assert (op.num_paf_stages, op.num_heat_stages) == (3, 1)
    assert get_model("atrous_cpm_shared", num_stages=2).num_stages == 2
    shuf = get_model("shufflenet_v2", width_multiplier=0.5)
    assert shuf.conv5.conv.weight.shape[0] == WIDTH_CONFIGS[0.5][3]


def test_initializers_follow_flax_distributions():
    gen = torch.Generator().manual_seed(3)
    mob = get_model("mobilenet", num_stages=1, generator=gen)
    w = mob.backbone.stem.weight            # lecun truncated normal, 27 in
    assert abs(float(w.std()) - (1 / 27) ** 0.5) < 0.02
    assert float(w.abs().max()) <= 2 * (1 / 27) ** 0.5 / 0.8796 + 1e-6
    assert abs(float(mob.backbone.conv_cpm1.weight.std()) - 0.01) < 1e-3
    shuf = get_model("shufflenet_v2", generator=gen)
    bound = (6.0 / shuf.paf.weight[0].numel()) ** 0.5   # kaiming uniform
    assert float(shuf.paf.weight.abs().max()) <= bound
    assert float(shuf.paf.weight.abs().max()) > 0.9 * bound
    assert float(shuf.paf.bias.abs().max()) == 0.0
    bn = shuf.stage2_unit1.pw1.bn
    assert torch.equal(bn.weight, torch.ones_like(bn.weight))
    assert torch.equal(bn.running_var, torch.ones_like(bn.running_var))
    op = get_model("openpose_v2", num_paf_stages=1, num_heat_stages=1)
    assert torch.equal(op.backbone.prelu4_2.weight,
                       torch.full((512,), 0.25))
    again = get_model("mobilenet", num_stages=1,
                      generator=torch.Generator().manual_seed(3))
    assert torch.equal(again.backbone.stem.weight, w)


@pytest.mark.parametrize("name,heads,hidden", [
    ("hourglass", ["score_paf0.weight", "score_ht0.weight"],
     "hg0.up1_d4.block0.conv1.weight"),
    ("shufflenet_v2", ["paf.weight", "heatmap.weight"],
     "stage1_conv.conv.weight"),
    ("openpose_v2", ["paf_stage0.out.weight", "heat_stage0.out.weight"],
     "paf_stage0.m0_0.conv.weight"),
    ("atrous_resnet50", ["paf_head.out.weight", "heat_head.out.weight"],
     "aspp.branch0.weight"),
    ("atrous_cpm", ["paf_stage2.out.weight"], "neck1.weight"),
    ("mobilenet", ["stages.model1_1.8.weight"], "backbone.ir0_0.dw.weight"),
])
def test_he_reinit_keeps_every_family_head(name, heads, hidden):
    kwargs = {"num_paf_stages": 1, "num_heat_stages": 1} \
        if name == "openpose_v2" else {"num_stages": 1}
    model = get_model(name, **kwargs)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    common.he_reinit(model, torch.Generator().manual_seed(1))
    after = model.state_dict()
    for k in heads:
        assert torch.equal(before[k], after[k]), k
    assert not torch.equal(before[hidden], after[hidden])
    fan_in = after[hidden][0].numel()
    assert abs(float(after[hidden].std()) - (2 / fan_in) ** 0.5) \
        < 0.2 * (2 / fan_in) ** 0.5
    for k, v in after.items():       # biases and BatchNorm untouched
        if k.endswith(("bias", "running_mean", "running_var")) or \
                ".bn" in k or "_bn" in k or "prelu" in k:
            assert torch.equal(before[k], v), k


def test_bf16_batchnorm_family_keeps_fp32_statistics():
    """cast_compute rounds the convs to bf16 and leaves BatchNorm fp32, as
    flax keeps batch_stats and BN parameters; the bf16 forward lands
    within bf16 rounding of the fp32 one: 2% of the output range over
    VGG19's 12 convolutions (tests/test_torch_model.py), grown with the
    square root of the convolutions the rounding compounds through, 50
    here: 4%."""
    _, _, x, model = _family("mobilenet")
    m16 = get_model("mobilenet", num_stages=2, dtype=torch.bfloat16)
    load_strict(m16, model.state_dict())
    common.cast_compute(m16.eval(), torch.bfloat16)
    assert m16.backbone.stem.weight.dtype == torch.bfloat16
    assert m16.backbone.stem_bn.running_var.dtype == torch.float32
    assert m16.backbone.stem_bn.weight.dtype == torch.float32
    with torch.no_grad():
        a, b = model(torch.from_numpy(x)), m16(torch.from_numpy(x))
    assert b.pafs.dtype == torch.float32
    scale = float(a.pafs.abs().max())
    assert float((a.pafs - b.pafs).abs().max()) <= 4e-2 * scale


def test_load_strict_raises_before_writing():
    model = get_model("shufflenet_v2", width_multiplier=0.5)
    sd = {k: v.clone() + 1 for k, v in model.state_dict().items()}
    before = model.stage1_conv.conv.weight.clone()
    sd["paf.weight"] = sd["paf.weight"][:5]
    with pytest.raises(ValueError, match="paf.weight"):
        load_strict(model, sd)
    assert torch.equal(model.stage1_conv.conv.weight, before)
    del sd["paf.weight"]
    with pytest.raises(ValueError, match="missing"):
        load_strict(model, sd)


# ---------------------------------------------------------------------------
# caffe interop
# ---------------------------------------------------------------------------

def test_shufflenet_export_equals_the_jax_package(tmp_path):
    """Same weights and statistics -> the same npz, key for key, and the
    same prototxt."""
    jmodel = jax_get_model("shufflenet_v2", width_multiplier=0.5,
                           dtype=jnp.float32)
    variables = seeded_variables(jmodel, "shufflenet_v2", (64, 64))
    want = jcaffe.export_shufflenet_caffe(str(tmp_path / "jax"), variables,
                                          width_multiplier=0.5, image_hw=64)
    model = get_model("shufflenet_v2", width_multiplier=0.5)
    load_strict(model, state_dict_from_flax(variables,
                                            model_name="shufflenet_v2"))
    got = caffe_interop.export_shufflenet_caffe(
        str(tmp_path / "port"), model, width_multiplier=0.5, image_hw=64)
    assert open(got[0]).read() == open(want[0]).read()
    a, b = np.load(got[1]), np.load(want[1])
    assert sorted(a.files) == sorted(b.files)
    assert "stage1_conv_bn/var" in a.files and "data_bn_scale/bias" in a.files
    for k in b.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def openpose_flax():
    model = jax_get_model("openpose_v2", dtype=jnp.float32)
    return seeded_variables(model, "openpose_v2", (32, 32))


def _synth_pickle(params, rng):
    """A fake openpose.pkl in the reference's entry layout, shaped to the
    flax model, with decoy split/concat entries the loaders skip
    (tests/test_caffe_interop.py's)."""
    root = params["params"]
    entries = [{"name": "data_split", "weights": []}]
    for i, (kind, path) in enumerate(jcaffe.openpose_module_order()):
        leaf = root
        for p in path:
            leaf = leaf[p]
        if kind == "conv":
            hwio = leaf["kernel"].shape
            w = rng.randn(hwio[3], hwio[2], hwio[0], hwio[1]) * 0.01
            b = rng.randn(hwio[3]) * 0.01
            entries.append({"name": f"conv_l{i}",
                            "weights": [w.astype(np.float32),
                                        b.astype(np.float32)]})
        else:
            entries.append({"name": f"prelu_l{i}", "weights": [
                rng.rand(leaf["alpha"].shape[0]).astype(np.float32)]})
        if i == 3:
            entries.append({"name": "prelu_concat_decoy", "weights": []})
    return entries


def test_caffe_pickle_import_matches_the_jax_package(openpose_flax,
                                                     tmp_path):
    entries = _synth_pickle(openpose_flax, np.random.RandomState(0))
    pkl = tmp_path / "openpose.pkl"
    pkl.write_bytes(pickle.dumps(entries))
    want = state_dict_from_flax(
        _np(jcaffe.load_openpose_caffe_pickle(str(pkl), openpose_flax)),
        model_name="openpose_v2")
    model = get_model("openpose_v2")
    caffe_interop.load_openpose_caffe_pickle(str(pkl), model)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_caffe_pickle_mismatch_raises_before_writing(openpose_flax):
    entries = _synth_pickle(openpose_flax, np.random.RandomState(1))
    model = get_model("openpose_v2")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    # the 3x3 of a late stage: every conv before it would be written
    late = [e for e in entries if e["name"].startswith("conv")][-3]
    late["weights"][0] = late["weights"][0][:, :, :1, :1]
    with pytest.raises(ValueError, match="conv shape mismatch"):
        caffe_interop.import_openpose_caffe_pickle(entries, model)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    with pytest.raises(ValueError, match="prelu entries"):
        caffe_interop.import_openpose_caffe_pickle(entries[:40], model)
