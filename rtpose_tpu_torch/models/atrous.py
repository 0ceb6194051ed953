"""ResNet50 + ASPP pose model (port of rtpose_tpu/models/atrous.py;
reference lib/network/atrouspose.py).

ResNet50 through layer3 (stride 16) with lateral 1x1 paths merged at
stride 8 (layer3's through a 2x bilinear upsample), a cumulative-add ASPP
block (dilations 1/4/8/16) and two 5-conv heads for PAF / heatmaps.
Single stage.  Also the dilated CPM stage block of the legacy atrous
models (:class:`DilatedStageBlock`, dilations 1, 1, 2, 4, 8).  Module
names are the flax ones: ``trunk.layer2_0.proj_bn``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..skeleton import NUM_HEATMAPS, NUM_PAF_CHANNELS
from .common import (BatchNorm, Conv, ModelOutput, conv_init, max_pool_same,
                     nchw_to_output)


class ResNetBottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1,
                 project: bool = False):
        super().__init__()
        self.conv1 = Conv(cin, planes, 1, bias=False, init="lecun")
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv(planes, planes, 3, stride=stride, bias=False,
                          init="lecun")
        self.bn2 = BatchNorm(planes)
        self.conv3 = Conv(planes, planes * 4, 1, bias=False, init="lecun")
        self.bn3 = BatchNorm(planes * 4)
        self.project = project or cin != planes * 4
        if self.project:
            self.proj = Conv(cin, planes * 4, 1, stride=stride, bias=False,
                             init="lecun")
            self.proj_bn = BatchNorm(planes * 4)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = self.proj_bn(self.proj(x)) if self.project else x
        return F.relu(y + residual)


_LAYERS = ((64, 3, 1), (128, 4, 2), (256, 6, 2))   # (planes, blocks, stride)


class ResNet50Trunk(nn.Module):
    """conv1..layer3 (the standard (3, 4, 6) bottleneck stages) ->
    (layer2 at stride 8, 512 channels; layer3 at stride 16, 1024)."""

    def __init__(self):
        super().__init__()
        self.stem = Conv(3, 64, 7, stride=2, bias=False, init="lecun")
        self.stem_bn = BatchNorm(64)
        cin = 64
        for si, (planes, blocks, stride) in enumerate(_LAYERS):
            for b in range(blocks):
                self.add_module(f"layer{si + 1}_{b}", ResNetBottleneck(
                    cin, planes, stride=stride if b == 0 else 1,
                    project=b == 0))
                cin = planes * 4

    def forward(self, x):
        x = max_pool_same(F.relu(self.stem_bn(self.stem(x))), 3, 2)
        feats = []
        for si, (_, blocks, _) in enumerate(_LAYERS):
            for b in range(blocks):
                x = getattr(self, f"layer{si + 1}_{b}")(x)
            feats.append(x)
        return feats[1], feats[2]


class ASPP(nn.Module):
    """Cumulative-add atrous pyramid (reference atrouspose.py:18-49)."""

    dilations = (1, 4, 8, 16)

    def __init__(self, cin: int):
        super().__init__()
        for i, d in enumerate(self.dilations):
            self.add_module(f"branch{i}", Conv(cin, 128, 3, dilation=d))
            self.add_module(f"branch{i}_bn", BatchNorm(128))
        self.out_bn = BatchNorm(128 * len(self.dilations))

    def forward(self, x):
        adds = []
        for i in range(len(self.dilations)):
            y = getattr(self, f"branch{i}_bn")(getattr(self, f"branch{i}")(x))
            y = F.relu(y)
            adds.append(y if not adds else adds[-1] + y)
        return F.relu(self.out_bn(torch.cat(adds, dim=1)))


class _Head(nn.Module):
    def __init__(self, cin: int, out_channels: int):
        super().__init__()
        for i in range(3):
            self.add_module(f"conv{i}", Conv(cin, 512, 3))
            self.add_module(f"bn{i}", BatchNorm(512))
            cin = 512
        self.conv3 = Conv(512, 512, 1)
        self.out = Conv(512, out_channels, 1)

    def forward(self, x):
        for i in range(3):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        return self.out(F.relu(self.conv3(x)))


def bilinear_x2(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample as ``jax.image.resize(..., "bilinear")``
    computes it (rtpose_tpu/models/atrous.py:128-130): half-pixel centres,
    the edge rows and columns copied, which is ``align_corners=False``
    (the comment there says align_corners=True; its code does not)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)


class AtrousPose(nn.Module):
    """forward: (B, H, W, 3) NHWC images -> :class:`ModelOutput` with one
    stage.  The stride-8 side must be even, so that layer3's 2x upsample
    meets it: PosePipeline pads every input side to a multiple of
    ``pad_multiple`` (the JAX pipeline pads to 8 and fails where the
    stride-8 side is odd, e.g. a 640x427 frame at 368 px)."""

    pad_multiple = 16

    def __init__(self, paf_channels: int = NUM_PAF_CHANNELS,
                 heat_channels: int = NUM_HEATMAPS,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.trunk = ResNet50Trunk()
        self.lateral16 = Conv(1024, 256, 1, bias=False, init="lecun")
        self.lateral16_bn = BatchNorm(256)
        self.lateral8 = Conv(512, 256, 1, bias=False, init="lecun")
        self.lateral8_bn = BatchNorm(256)
        self.aspp = ASPP(512)
        self.paf_head = _Head(512, paf_channels)
        self.heat_head = _Head(512, heat_channels)
        conv_init(self, generator if generator is not None
                  else torch.Generator().manual_seed(0))

    def forward(self, images: torch.Tensor) -> ModelOutput:
        c8, c16 = self.trunk(images.permute(0, 3, 1, 2).to(self.dtype))
        lat16 = bilinear_x2(F.relu(self.lateral16_bn(self.lateral16(c16))))
        lat8 = F.relu(self.lateral8_bn(self.lateral8(c8)))
        feat = self.aspp(F.relu(torch.cat([lat8, lat16], dim=1)))
        return nchw_to_output([self.paf_head(feat)], [self.heat_head(feat)])


class DilatedStageBlock(nn.Module):
    """Legacy atrous CPM stage: five 3x3 convs with dilations 1, 1, 2, 4,
    8, a 1x1 and the 1x1 out (reference lib/network/atrous_model.py:
    78-106)."""

    dilations = (1, 1, 2, 4, 8)

    def __init__(self, cin: int, out_channels: int, features: int = 128):
        super().__init__()
        for i, d in enumerate(self.dilations):
            self.add_module(f"conv{i + 1}", Conv(cin, features, 3,
                                                 dilation=d))
            cin = features
        self.conv6 = Conv(features, features, 1)
        self.out = Conv(features, out_channels, 1)

    def forward(self, x):
        for i in range(len(self.dilations)):
            x = F.relu(getattr(self, f"conv{i + 1}")(x))
        return self.out(F.relu(self.conv6(x)))
