"""Legacy atrous CPM models (port of rtpose_tpu/models/atrous_cpm.py;
reference lib/network/atrous_model.py and atrous_model_share_stages.py).

Inception-v3-style stem (stride 8, 288 channels) + dilated CPM stage
blocks (dilations 1, 1, 2, 4, 8):

- :class:`AtrousCPM`: separate PAF / heatmap stage blocks per stage;
- :class:`AtrousCPMShared`: one stage block emits [paf | heat], split
  afterwards.

Module names are the flax ones (flax's auto-named ``Conv_0`` /
``BatchNorm_0`` inside a ``BasicConv`` are ``conv`` / ``bn``):
``stem.ia1.b5_2.conv.weight``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..skeleton import NUM_HEATMAPS, NUM_PAF_CHANNELS
from .atrous import DilatedStageBlock
from .common import (BatchNorm, Conv, ModelOutput, avg_pool_same, conv_init,
                     max_pool_same, nchw_to_output)


class BasicConv(nn.Module):
    """conv (N(0, 0.01), no bias under BN) -> BN -> ReLU."""

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1,
                 use_bn: bool = True):
        super().__init__()
        self.conv = Conv(cin, cout, k, stride=stride, bias=not use_bn)
        self.bn = BatchNorm(cout) if use_bn else None

    def forward(self, x):
        x = self.conv(x)
        return F.relu(self.bn(x) if self.bn is not None else x)


class InceptionA(nn.Module):
    """Inception-v3 A block (1x1 / 5x5 / double-3x3 / pool branches)."""

    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.b1 = BasicConv(cin, 64, 1)
        self.b5_1 = BasicConv(cin, 48, 1)
        self.b5_2 = BasicConv(48, 64, 5)
        self.b3_1 = BasicConv(cin, 64, 1)
        self.b3_2 = BasicConv(64, 96, 3)
        self.b3_3 = BasicConv(96, 96, 3)
        self.bp = BasicConv(cin, pool_features, 1)
        self.out_channels = 64 + 64 + 96 + pool_features

    def forward(self, x):
        b1 = self.b1(x)
        b5 = self.b5_2(self.b5_1(x))
        b3 = self.b3_3(self.b3_2(self.b3_1(x)))
        bp = self.bp(avg_pool_same(x, 3, 1))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionStem(nn.Module):
    """Inception stem to stride 8 / 288 channels
    (reference atrous_model.py:108-140)."""

    def __init__(self):
        super().__init__()
        self.conv1 = BasicConv(3, 32, 3, stride=2)
        self.conv2 = BasicConv(32, 32, 3)
        self.conv3 = BasicConv(32, 64, 3)
        self.conv4r = BasicConv(64, 80, 1)
        self.conv4 = BasicConv(80, 192, 3)
        self.ia1 = InceptionA(192, 32)
        self.ia2 = InceptionA(self.ia1.out_channels, 64)

    def forward(self, x):
        x = self.conv3(self.conv2(self.conv1(x)))
        x = max_pool_same(x, 3, 2)
        x = self.conv4(self.conv4r(x))
        x = max_pool_same(x, 3, 2)
        return self.ia2(self.ia1(x))


class _AtrousBase(nn.Module):
    """The stem and the 3x3 neck to 128 channels, shared by both
    variants."""

    def __init__(self, num_stages: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.num_stages = num_stages
        self.stem = InceptionStem()
        self.neck1 = Conv(self.stem.ia2.out_channels, 256, 3)
        self.neck2 = Conv(256, 128, 3)

    def features(self, images: torch.Tensor) -> torch.Tensor:
        x = self.stem(images.permute(0, 3, 1, 2).to(self.dtype))
        return F.relu(self.neck2(F.relu(self.neck1(x))))


class AtrousCPM(_AtrousBase):
    """Inception stem + per-branch dilated refinement stages
    (``paf_stage{2..}`` / ``heat_stage{2..}``).  forward: (B, H, W, 3)
    NHWC images -> :class:`ModelOutput`."""

    def __init__(self, num_stages: int = 5,
                 paf_channels: int = NUM_PAF_CHANNELS,
                 heat_channels: int = NUM_HEATMAPS,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__(num_stages, dtype)
        cin = 128
        for s in range(num_stages):
            self.add_module(f"paf_stage{s + 2}",
                            DilatedStageBlock(cin, paf_channels))
            self.add_module(f"heat_stage{s + 2}",
                            DilatedStageBlock(cin, heat_channels))
            cin = paf_channels + heat_channels + 128
        conv_init(self, generator if generator is not None
                  else torch.Generator().manual_seed(0))

    def forward(self, images: torch.Tensor) -> ModelOutput:
        feat = self.features(images)
        pafs, heats = [], []
        x = feat
        for s in range(self.num_stages):
            pafs.append(getattr(self, f"paf_stage{s + 2}")(x))
            heats.append(getattr(self, f"heat_stage{s + 2}")(x))
            x = torch.cat([pafs[-1], heats[-1], feat], dim=1)
        return nchw_to_output(pafs, heats)


class AtrousCPMShared(_AtrousBase):
    """Shared-stage variant: one dilated block per stage
    (``stage{2..}``) emits the concatenated [paf | heat] map (reference
    atrous_model_share_stages.py:83-116, 166-210)."""

    def __init__(self, num_stages: int = 5,
                 paf_channels: int = NUM_PAF_CHANNELS,
                 heat_channels: int = NUM_HEATMAPS,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__(num_stages, dtype)
        self.paf_channels = paf_channels
        both, cin = paf_channels + heat_channels, 128
        for s in range(num_stages):
            self.add_module(f"stage{s + 2}", DilatedStageBlock(cin, both))
            cin = both + 128
        conv_init(self, generator if generator is not None
                  else torch.Generator().manual_seed(0))

    def forward(self, images: torch.Tensor) -> ModelOutput:
        feat = self.features(images)
        pafs, heats = [], []
        x = feat
        for s in range(self.num_stages):
            both = getattr(self, f"stage{s + 2}")(x)
            pafs.append(both[:, :self.paf_channels])
            heats.append(both[:, self.paf_channels:])
            x = torch.cat([both, feat], dim=1)
        return nchw_to_output(pafs, heats)
