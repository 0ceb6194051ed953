"""Carry weights into the port (port of rtpose_tpu/models/import_torch.py).

- :func:`state_dict_from_flax`: a flax VGG19RTPose parameter tree, as
  numpy, to this package's state_dict (HWIO -> OIHW).  This is how the
  JAX package's parameters cross over for parity checks.
- :func:`load_torch_checkpoint`: a reference ``pose_model.pth`` (raw
  state_dict) or a lightning checkpoint (``state_dict`` with ``model.``
  key prefix, reference evaluate/evaluation.py:12-18).
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


def state_dict_from_flax(params: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """flax VGG19RTPose params (numpy leaves; with or without the
    ``params`` root) -> this package's VGG19RTPose state_dict (fp32)."""
    root = params["params"] if "params" in params else params
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


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Read a reference .pth/.ckpt into a flat CPU state_dict with any
    lightning ``model.`` prefix stripped."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {(k[len("model."):] if k.startswith("model.") else k): v
            for k, v in obj.items()}


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
