"""Carry weights into the port (port of rtpose_tpu/models/import_torch.py).

- :func:`state_dict_from_flax`: a flax model's variables (``params``
  and, for the BatchNorm families, ``batch_stats``), as numpy, to this
  package's state_dict of the same family (HWIO -> OIHW).  This is how
  the JAX package's parameters cross over for parity checks.
- :func:`load_strict`: a state_dict into a model, every key consumed and
  every shape checked before anything is written.
- :func:`load_torch_checkpoint`: a reference ``pose_model.pth`` (raw
  state_dict) or a lightning checkpoint (``state_dict`` with ``model.``
  key prefix, reference evaluate/evaluation.py:12-18), read as the JAX
  package reads it (rtpose_tpu/models/import_torch.py:127): the user
  names the file and it is unpickled whole, so a lightning checkpoint's
  ``hyper_parameters`` (an ``argparse.Namespace``) load too.
- :func:`load_reference_convs`: the reference-layout convs of such a
  checkpoint into a VGG19 model, every other key ignored
  (``import_rtpose_state_dict``, import_torch.py:57-80); a missing or
  misshapen conv is a ``ValueError`` (the JAX import's ``KeyError`` /
  ``ValueError``).
- :func:`import_vgg19_imagenet`: torchvision's ImageNet ``vgg19`` weights
  into the first 10 backbone convs (the training CLI's ``--vgg-weights``).

The layout map is copied from rtpose_tpu/models/import_torch.py:19-54,
whose package imports jax.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

# Ordered conv-layer names of the reference `rtpose_model` state_dict
# (nn.Sequential indices) and the flax parameter names they map to.
_BLOCK0_SEQ = [0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25]
_BLOCK0_NAMES = ["conv1_1", "conv1_2", "conv2_1", "conv2_2", "conv3_1",
                 "conv3_2", "conv3_3", "conv3_4", "conv4_1", "conv4_2",
                 "conv4_3_CPM", "conv4_4_CPM"]
_STAGE1_SEQ = [0, 2, 4, 6, 8]
_STAGE1_NAMES = ["conv1", "conv2", "conv3", "conv4", "out"]
_STAGET_SEQ = [0, 2, 4, 6, 8, 10, 12]
_STAGET_NAMES = ["conv1", "conv2", "conv3", "conv4", "conv5", "conv6", "out"]


def torch_layout_map(num_stages: int = 6
                     ) -> List[Tuple[str, Tuple[str, ...]]]:
    """(state_dict key prefix, flax param path) for every conv."""
    mapping: List[Tuple[str, Tuple[str, ...]]] = []
    for seq, name in zip(_BLOCK0_SEQ, _BLOCK0_NAMES):
        mapping.append((f"model0.{seq}", ("backbone", name)))
    for t in range(1, num_stages + 1):
        seqs, names = ((_STAGE1_SEQ, _STAGE1_NAMES) if t == 1
                       else (_STAGET_SEQ, _STAGET_NAMES))
        for branch, lname in (("1", "L1"), ("2", "L2")):
            for seq, name in zip(seqs, names):
                mapping.append((f"model{t}_{branch}.{seq}",
                                ("stages", f"stage{t}_{lname}", name)))
    return mapping


def _vgg19_state_dict(root: Mapping) -> "OrderedDict[str, torch.Tensor]":
    num_stages = sum(1 for k in root["stages"] if k.endswith("_L1"))
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for prefix, path in torch_layout_map(num_stages):
        leaf = root
        for p in path:
            leaf = leaf[p]
        kernel = np.asarray(leaf["kernel"], np.float32)       # HWIO
        out[f"{prefix}.weight"] = torch.from_numpy(
            np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))
        out[f"{prefix}.bias"] = torch.from_numpy(
            np.asarray(leaf["bias"], np.float32).copy())
    return out


# flax's auto-named submodules -> the port's attribute names
_AUTO_NAMES = {"Conv_0": "conv", "BatchNorm_0": "bn", "PReLU_0": "prelu"}
# flax leaf -> the port's parameter or buffer
_LEAF_NAMES = {"kernel": "weight", "bias": "bias", "scale": "weight",
               "alpha": "weight", "mean": "running_mean",
               "var": "running_var"}
# CPMStages (mobilenet's ``stages``): flax stage{t}_L{b}/<conv> -> the
# reference layout model{t}_{b}.<Sequential index>
_STAGE1_SEQ_OF = dict(zip(_STAGE1_NAMES, _STAGE1_SEQ))
_STAGET_SEQ_OF = dict(zip(_STAGET_NAMES, _STAGET_SEQ))


def _port_module(mods: List[str]) -> str:
    mods = [_AUTO_NAMES.get(m, m) for m in mods]
    if len(mods) == 3 and mods[0] == "stages" and mods[1].startswith(
            "stage") and mods[1][-3:] in ("_L1", "_L2"):
        t = int(mods[1][len("stage"):-3])
        seq = (_STAGE1_SEQ_OF if t == 1 else _STAGET_SEQ_OF)[mods[2]]
        mods = ["stages", f"model{t}_{mods[1][-1]}", str(seq)]
    return ".".join(mods)


def _leaves(tree: Mapping, path=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def state_dict_from_flax(variables: Mapping, model_name: str = "vgg19"
                         ) -> "OrderedDict[str, torch.Tensor]":
    """flax variables of family `model_name` (numpy leaves; ``params``
    and ``batch_stats``, or a bare ``params`` tree) -> this package's
    state_dict of that family, fp32.

    VGG19 goes to the reference ``rtpose_model`` layout.  Every other
    family's modules carry the flax names, so a flax path maps to the
    same key: flax's auto-named ``Conv_0`` / ``BatchNorm_0`` /
    ``PReLU_0`` are ``conv`` / ``bn`` / ``prelu``; conv kernels go HWIO
    -> OIHW (a depthwise ``(kh, kw, 1, C)`` to ``(C, 1, kh, kw)``);
    BatchNorm ``scale`` / ``bias`` / ``mean`` / ``var`` become ``weight`` /
    ``bias`` / ``running_mean`` / ``running_var``; a PReLU ``alpha`` its
    ``weight``; mobilenet's CPM stages take the reference layout."""
    if "params" in variables:
        collections = [variables["params"], variables.get("batch_stats", {})]
    else:
        collections = [variables]
    if model_name == "vgg19":
        return _vgg19_state_dict(collections[0])
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for tree in collections:
        for path, leaf in _leaves(tree):
            arr = np.asarray(leaf, np.float32)
            if path[-1] == "kernel":
                arr = arr.transpose(3, 2, 0, 1)
            key = f"{_port_module(list(path[:-1]))}.{_LEAF_NAMES[path[-1]]}"
            out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def load_strict(model: torch.nn.Module,
                state_dict: Mapping[str, torch.Tensor]) -> torch.nn.Module:
    """Load `state_dict` into `model`: every key of each must be in the
    other and every shape equal, checked before anything is written
    (``load_state_dict(strict=True)`` writes what fits before it raises).
    Raises ``ValueError`` naming the keys that do not match."""
    own = model.state_dict()
    missing = sorted(set(own) - set(state_dict))
    extra = sorted(set(state_dict) - set(own))
    shapes = [f"{k}: {tuple(state_dict[k].shape)} vs {tuple(v.shape)}"
              for k, v in own.items()
              if k in state_dict and tuple(state_dict[k].shape)
              != tuple(v.shape)]
    if missing or extra or shapes:
        raise ValueError(
            f"state_dict does not fit {type(model).__name__}: missing "
            f"{missing[:8]}{' ...' if len(missing) > 8 else ''}, "
            f"unexpected {extra[:8]}{' ...' if len(extra) > 8 else ''}, "
            f"shapes {shapes[:8]}")
    model.load_state_dict(state_dict, strict=True)
    return model


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Read a reference .pth/.ckpt into a flat CPU state_dict with any
    lightning ``model.`` prefix stripped.  The file is unpickled whole
    (``weights_only=False``), as the JAX package reads it: only open files
    you trust."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {(k[len("model."):] if k.startswith("model.") else k): v
            for k, v in obj.items()}


def load_reference_convs(model: torch.nn.Module,
                         state_dict: Mapping[str, torch.Tensor]) -> int:
    """Load the reference ``rtpose_model`` convs of `state_dict` (keys as
    :func:`load_torch_checkpoint` gives them) into the VGG19 `model`,
    every conv of its :func:`torch_layout_map`, checked before anything
    is written; returns how many keys of `state_dict` lie outside the map
    and were ignored (a lightning checkpoint's loss buffers, an EMA
    copy, ...).  A missing or misshapen conv raises ``ValueError`` naming
    it."""
    own = model.state_dict()
    keys = [f"{prefix}.{kind}" for prefix, _ in
            torch_layout_map(model.num_stages) for kind in ("weight", "bias")]
    missing = [k for k in keys if k not in state_dict]
    if missing:
        raise ValueError(f"the checkpoint lacks {len(missing)} conv tensors "
                         f"of a {model.num_stages}-stage VGG19: "
                         f"{missing[:8]}{' ...' if len(missing) > 8 else ''}")
    pairs = []
    for k in keys:
        src = torch.as_tensor(state_dict[k])
        if tuple(src.shape) != tuple(own[k].shape):
            raise ValueError(f"checkpoint tensor {k}: shape "
                             f"{tuple(src.shape)}, the model wants "
                             f"{tuple(own[k].shape)}")
        pairs.append((own[k], src))
    with torch.no_grad():
        for dst, src in pairs:
            dst.copy_(src)
    return len(set(state_dict) - set(keys))


def import_vgg19_imagenet(vgg_state_dict: Mapping[str, torch.Tensor],
                          model: torch.nn.Module) -> torch.nn.Module:
    """Load the first 10 torchvision-vgg19 convs into `model`'s backbone,
    in place (rtpose_tpu/models/import_torch.py:83-97; reference
    rtpose_vgg.py:244-246): the first 20 tensors of the state dict in key
    order, 10 x (weight, bias), into ``model0.{0,2,...,21}``.  Every shape
    must equal the target's; a short or misshapen state dict raises
    ValueError before anything is written."""
    tensors = list(vgg_state_dict.values())
    if len(tensors) < 20:
        raise ValueError(f"a torchvision vgg19 state dict has at least 20 "
                         f"tensors before its classifier, got {len(tensors)}")
    params = dict(model.named_parameters())
    pairs = []
    for i, (prefix, _) in enumerate(torch_layout_map(1)[:10]):
        for j, kind in enumerate(("weight", "bias")):
            src, dst = tensors[2 * i + j], params[f"{prefix}.{kind}"]
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(
                    f"vgg19 tensor {2 * i + j} ({prefix}.{kind}): shape "
                    f"{tuple(src.shape)}, the model wants "
                    f"{tuple(dst.shape)}")
            pairs.append((dst, src))
    with torch.no_grad():
        for dst, src in pairs:
            dst.copy_(torch.as_tensor(src))
    return model
