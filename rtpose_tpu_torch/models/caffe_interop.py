"""Caffe-side interop of the port (a numpy-only copy of
rtpose_tpu/models/caffe_interop.py, which imports JAX):

- the ShuffleNetV2 deploy-prototxt export and its ``.npz`` of weights
  keyed by caffe layer name, OIHW, with the BatchNorm running statistics
  (:func:`shufflenet_prototxt`, :func:`export_shufflenet_caffe`);
- the OpenPose caffe-pickle import (reference openpose.py:189-209): a
  pickled list of ``{'name': ..., 'weights': [w, b]}`` layer dicts, conv
  entries in module order onto the convs of :class:`~.openpose_v2.
  OpenPoseV2`, prelu entries onto its PReLU slopes
  (:func:`import_openpose_caffe_pickle`).

The prototxt writers are the JAX package's code (its tests hold the two
equal); the weight paths read and write the port's modules.
"""

from __future__ import annotations

import io
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .shufflenet_v2 import WIDTH_CONFIGS

# ---------------------------------------------------------------------------
# prototxt export (ShuffleNetV2 rtpose)
# ---------------------------------------------------------------------------


def _layer(out, type_, name, bottoms, tops, body=""):
    out.write("layer {\n")
    out.write(f'  name: "{name}"\n  type: "{type_}"\n')
    for b in bottoms:
        out.write(f'  bottom: "{b}"\n')
    for t in tops:
        out.write(f'  top: "{t}"\n')
    if body:
        out.write(body)
    out.write("}\n")


def _conv_bn_relu(out, name, bottom, num_output, kernel, stride=1,
                  dilation=1, group=1, relu=True):
    pad = ((kernel - 1) * dilation) // 2
    body = ("  convolution_param {\n"
            f"    num_output: {num_output}\n"
            f"    kernel_size: {kernel}\n"
            f"    stride: {stride}\n"
            f"    pad: {pad}\n")
    if dilation != 1:
        body += f"    dilation: {dilation}\n"
    if group != 1:
        body += f"    group: {group}\n"
    body += "    bias_term: false\n  }\n"
    _layer(out, "Convolution", name, [bottom], [name], body)
    _layer(out, "BatchNorm", f"{name}_bn", [name], [name])
    _layer(out, "Scale", f"{name}_scale", [name], [name],
           "  scale_param { bias_term: true }\n")
    if relu:
        _layer(out, "ReLU", f"{name}_relu", [name], [name])
    return name


def _shuffle_unit(out, name, bottom, in_ch, out_ch, stride=1, dilation=1,
                  downsample=False):
    half = out_ch // 2
    if not downsample and stride == 1:
        _layer(out, "Slice", f"{name}_slice", [bottom],
               [f"{name}_x1", f"{name}_x2"],
               "  slice_param { axis: 1 "
               f"slice_point: {in_ch // 2} }}\n")
        y = _conv_bn_relu(out, f"{name}_pw1", f"{name}_x2", half, 1)
        y = _conv_bn_relu(out, f"{name}_dw", y, half, 3, stride=1,
                          dilation=dilation, group=half, relu=False)
        y = _conv_bn_relu(out, f"{name}_pw2", y, half, 1)
        _layer(out, "Concat", f"{name}_concat", [f"{name}_x1", y],
               [f"{name}_concat"], "  concat_param { axis: 1 }\n")
    else:
        y = _conv_bn_relu(out, f"{name}_pw1", bottom, half, 1)
        y = _conv_bn_relu(out, f"{name}_dw", y, half, 3, stride=stride,
                          dilation=dilation, group=half, relu=False)
        y = _conv_bn_relu(out, f"{name}_pw2", y, half, 1)
        z = _conv_bn_relu(out, f"{name}_dw_proj", bottom, in_ch, 3,
                          stride=stride, dilation=dilation, group=in_ch,
                          relu=False)
        z = _conv_bn_relu(out, f"{name}_pw_proj", z, half, 1)
        _layer(out, "Concat", f"{name}_concat", [z, y],
               [f"{name}_concat"], "  concat_param { axis: 1 }\n")
    _layer(out, "ShuffleChannel", f"{name}_shuffle", [f"{name}_concat"],
           [name], "  shuffle_channel_param { group: 2 }\n")
    return name


def shufflenet_prototxt(width_multiplier: float = 1.0,
                        image_hw: int = 368) -> str:
    """Deploy prototxt mirroring ShuffleNetV2RTPose layer for layer."""
    c1, c2, c3, c5 = WIDTH_CONFIGS[width_multiplier]
    out = io.StringIO()
    out.write(f'name: "rtpose_shufflenet_v2_x{width_multiplier}"\n')
    _layer(out, "Input", "data", [], ["data"],
           "  input_param { shape { dim: 1 dim: 3 "
           f"dim: {image_hw} dim: {image_hw} }} }}\n")
    _layer(out, "BatchNorm", "data_bn", ["data"], ["data_bn"])
    _layer(out, "Scale", "data_bn_scale", ["data_bn"], ["data_bn"],
           "  scale_param { bias_term: true }\n")
    x = _conv_bn_relu(out, "stage1_conv", "data_bn", 24, 3, stride=2)
    _layer(out, "Pooling", "pool1", [x], ["pool1"],
           "  pooling_param { pool: MAX kernel_size: 3 stride: 2 }\n")
    x = "pool1"
    in_ch = 24
    for si, (ch, stride, dil, blocks) in enumerate(
            ((c1, 2, 1, 4), (c2, 1, 1, 8), (c3, 1, 1, 4))):
        x = _shuffle_unit(out, f"stage{si + 2}_unit1", x, in_ch, ch,
                          stride=stride, dilation=dil, downsample=True)
        for b in range(1, blocks):
            x = _shuffle_unit(out, f"stage{si + 2}_unit{b + 1}", x, ch, ch,
                              stride=1, dilation=dil)
        in_ch = ch
    x = _conv_bn_relu(out, "conv5", x, c5, 1)
    _layer(out, "Convolution", "paf", [x], ["paf"],
           "  convolution_param { num_output: 38 kernel_size: 1 }\n")
    _layer(out, "Convolution", "heatmap", [x], ["heatmap"],
           "  convolution_param { num_output: 19 kernel_size: 1 }\n")
    return out.getvalue()




def export_shufflenet_caffe(prefix: str, model=None,
                            width_multiplier: float = 1.0,
                            image_hw: int = 368) -> List[str]:
    """Write <prefix>.prototxt (+ <prefix>.weights.npz when `model`, a
    :class:`~.shufflenet_v2.ShuffleNetV2RTPose` or its state_dict, is
    given) -> the paths written.

    npz keys are caffe layer names, as the JAX package writes them:
    '<conv layer>/weight' (OIHW) [+ '/bias' for the paf / heatmap heads],
    '<conv>_scale/{weight,bias}' for the BatchNorm gamma / beta (caffe
    Scale layers) and '<conv>_bn/{mean,var,scale_factor}' for the
    BatchNorm running statistics (``data_bn`` keeps its name)."""
    paths = [f"{prefix}.prototxt"]
    with open(paths[0], "w") as f:
        f.write(shufflenet_prototxt(width_multiplier, image_hw))
    if model is None:
        return paths
    state = model if isinstance(model, dict) else model.state_dict()
    flat = {}
    for key, tensor in state.items():
        mods, last = key.split(".")[:-1], key.split(".")[-1]
        kind = mods[-1] if mods[-1] in ("conv", "bn") else None
        layer = "_".join(mods[:-1] if kind else mods)
        arr = tensor.detach().cpu().float().numpy()
        if kind == "bn" or layer.endswith("_bn"):
            bn = layer if layer.endswith("_bn") else f"{layer}_bn"
            if last in ("running_mean", "running_var"):
                flat[f"{bn}/{last[len('running_'):]}"] = arr
                # caffe divides the stored blobs by scale_factor on load
                flat.setdefault(f"{bn}/scale_factor",
                                np.ones((1,), np.float32))
            else:          # gamma / beta -> the caffe Scale layer
                flat[f"{layer}_scale/{last}"] = arr
        else:
            flat[f"{layer}/{last}"] = arr
    paths.append(f"{prefix}.weights.npz")
    np.savez(paths[1], **flat)
    return paths


# ---------------------------------------------------------------------------
# caffe-pickle import (OpenPose v2)
# ---------------------------------------------------------------------------

def openpose_module_order(num_paf_stages: int = 4, num_heat_stages: int = 2
                          ) -> List[Tuple[str, str]]:
    """(kind, module name) in the reference's modules() walk
    (openpose.py:202-209): backbone convs and PReLUs in definition order,
    then the PAF stages, then the heat stages."""
    order: List[Tuple[str, str]] = []
    vgg = ["conv1_1", "conv1_2", "conv2_1", "conv2_2",
           "conv3_1", "conv3_2", "conv3_3", "conv3_4",
           "conv4_1", "conv4_2", "conv4_3_CPM", "conv4_4_CPM"]
    prelu_after = {"conv4_2": "prelu4_2", "conv4_3_CPM": "prelu4_3",
                   "conv4_4_CPM": "prelu4_4"}
    for name in vgg:
        order.append(("conv", f"backbone.{name}"))
        if name in prelu_after:
            order.append(("prelu", f"backbone.{prelu_after[name]}"))
    for prefix, n in (("paf_stage", num_paf_stages),
                      ("heat_stage", num_heat_stages)):
        for i in range(n):
            for j in range(5):
                for k in range(3):
                    base = f"{prefix}{i}.m{j}_{k}"
                    order.append(("conv", f"{base}.conv"))
                    order.append(("prelu", f"{base}.prelu"))
            order.append(("conv", f"{prefix}{i}.m6.conv"))
            order.append(("prelu", f"{prefix}{i}.m6.prelu"))
            order.append(("conv", f"{prefix}{i}.out"))
    return order


def import_openpose_caffe_pickle(weights: Sequence[Dict],
                                 model: torch.nn.Module) -> torch.nn.Module:
    """Fill an :class:`~.openpose_v2.OpenPoseV2` from a caffe-pickle layer
    list, in place (reference openpose.py:189-209: conv entries in order
    onto the convs, prelu entries onto the PReLUs; entries named
    ``split`` or ``concat`` are skipped).  Conv weights are OIHW, as the
    port's.  Every shape is checked before anything is written: too few
    entries or a shape mismatch raises ``ValueError``.

    weights: [{'name': str, 'weights': [w, (b)]}, ...]."""
    convs = [d for d in weights
             if "conv" in d["name"] and "split" not in d["name"]
             and "concat" not in d["name"]]
    prelus = [d for d in weights
              if "prelu" in d["name"] and "split" not in d["name"]
              and "concat" not in d["name"]]
    order = openpose_module_order(model.num_paf_stages,
                                  model.num_heat_stages)
    need_c = sum(1 for k, _ in order if k == "conv")
    need_p = len(order) - need_c
    if len(convs) < need_c or len(prelus) < need_p:
        raise ValueError(
            f"caffe pickle has {len(convs)} conv / {len(prelus)} prelu "
            f"entries; the model needs {need_c} / {need_p}")
    modules = dict(model.named_modules())
    ci, pi = iter(convs), iter(prelus)
    writes = []
    for kind, name in order:
        mod = modules[name]
        if kind == "conv":
            d = next(ci)
            w = np.asarray(d["weights"][0], np.float32)
            if tuple(mod.weight.shape) != w.shape:
                raise ValueError(
                    f"conv shape mismatch at {name}: "
                    f"{tuple(mod.weight.shape)} vs {w.shape} "
                    f"(caffe layer {d['name']})")
            writes.append((mod.weight, w))
            writes.append((mod.bias, np.asarray(d["weights"][1],
                                                np.float32)))
        else:
            d = next(pi)
            alpha = np.asarray(d["weights"][0], np.float32).reshape(-1)
            if tuple(mod.weight.shape) != alpha.shape:
                raise ValueError(
                    f"prelu shape mismatch at {name}: "
                    f"{tuple(mod.weight.shape)} vs {alpha.shape}")
            writes.append((mod.weight, alpha))
    with torch.no_grad():
        for dst, src in writes:
            dst.copy_(torch.from_numpy(src).reshape(dst.shape))
    return model


def load_openpose_caffe_pickle(path: str,
                               model: torch.nn.Module) -> torch.nn.Module:
    """Read the reference's openpose.pkl into `model` (in place)."""
    import pickle
    with open(path, "rb") as f:
        weights = pickle.load(f, encoding="latin1")
    return import_openpose_caffe_pickle(weights, model)
