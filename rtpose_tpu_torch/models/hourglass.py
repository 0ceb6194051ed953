"""Stacked hourglass PAF model (port of rtpose_tpu/models/hourglass.py;
reference lib/network/rtpose_hourglass.py).

Newell-style hourglass stacks at output stride 4, each stack emitting a
38-channel PAF head and a 19-channel heatmap head, re-injected into the
next stack (reference :92-189); pre-activation bottlenecks (BN-ReLU-Conv
x3, 2x expansion).  The recursive hourglass (depth 4) is unrolled, so
every padded input side must be a multiple of 64 (stem x2, pool x2, four
2x2 VALID pools).  Module names are the flax ones:
``hg0.low1_d4.block0.conv2.weight``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..skeleton import NUM_HEATMAPS, NUM_PAF_CHANNELS
from .common import BatchNorm, Conv, ModelOutput, conv_init, nchw_to_output


class Bottleneck(nn.Module):
    """Pre-activation bottleneck, expansion 2 (reference :9-46)."""

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 project: bool = False):
        super().__init__()
        self.bn1 = BatchNorm(cin)
        self.conv1 = Conv(cin, planes, 1)
        self.bn2 = BatchNorm(planes)
        self.conv2 = Conv(planes, planes, 3, stride=stride)
        self.bn3 = BatchNorm(planes)
        self.conv3 = Conv(planes, planes * 2, 1)
        self.project = project or cin != planes * 2
        if self.project:
            self.proj = Conv(cin, planes * 2, 1, stride=stride)

    def forward(self, x):
        y = self.conv1(F.relu(self.bn1(x)))
        y = self.conv2(F.relu(self.bn2(y)))
        y = self.conv3(F.relu(self.bn3(y)))
        return y + (self.proj(x) if self.project else x)


class ResidualChain(nn.Sequential):
    def __init__(self, cin: int, planes: int, blocks: int):
        super().__init__()
        for i in range(blocks):
            self.add_module(f"block{i}", Bottleneck(cin, planes))
            cin = planes * 2


class Hourglass(nn.Module):
    """Recursive down/up module (reference :49-89), unrolled: level n
    has ``up1_d{n}``, ``low1_d{n}``, ``low3_d{n}`` and, at n = 1,
    ``low2_d1``."""

    def __init__(self, planes: int, blocks: int, depth: int = 4):
        super().__init__()
        self.depth = depth
        ch = planes * 2
        for n in range(depth, 0, -1):
            self.add_module(f"up1_d{n}", ResidualChain(ch, planes, blocks))
            self.add_module(f"low1_d{n}", ResidualChain(ch, planes, blocks))
            if n == 1:
                self.add_module(f"low2_d{n}",
                                ResidualChain(ch, planes, blocks))
            self.add_module(f"low3_d{n}", ResidualChain(ch, planes, blocks))

    def _level(self, n: int, x):
        up1 = getattr(self, f"up1_d{n}")(x)
        low = getattr(self, f"low1_d{n}")(F.max_pool2d(x, 2, 2))
        low = (self._level(n - 1, low) if n > 1
               else getattr(self, f"low2_d{n}")(low))
        low = getattr(self, f"low3_d{n}")(low)
        # nearest 2x, jnp.repeat along both axes (hourglass.py:95)
        return up1 + F.interpolate(low, scale_factor=2, mode="nearest")

    def forward(self, x):
        return self._level(self.depth, x)


class HourglassRTPose(nn.Module):
    """`num_stacks` hourglasses with PAF + heat heads per stack (reference
    :92-189; train_SH uses 8 stacks at input 256, stride 4).  forward:
    (B, H, W, 3) NHWC images, H and W multiples of 64 ->
    :class:`ModelOutput` at stride 4 with one stage per stack."""

    # the multiple every padded input side must have (PosePipeline
    # pads to it): stride 4 and then four 2x2 pools
    pad_multiple = 64

    def __init__(self, num_stacks: int = 8, num_blocks: int = 4,
                 num_feats: int = 128, paf_channels: int = NUM_PAF_CHANNELS,
                 heat_channels: int = NUM_HEATMAPS,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.num_stacks = num_stacks
        ch = num_feats * 2
        self.stem_conv = Conv(3, 64, 7, stride=2)
        self.stem_bn = BatchNorm(64)
        self.layer1 = Bottleneck(64, 64)
        self.layer2 = Bottleneck(128, 64)
        self.layer3 = Bottleneck(128, num_feats)
        for i in range(num_stacks):
            self.add_module(f"hg{i}", Hourglass(num_feats, num_blocks))
            self.add_module(f"res{i}",
                            ResidualChain(ch, num_feats, num_blocks))
            self.add_module(f"fc{i}", Conv(ch, ch, 1))
            self.add_module(f"fc_bn{i}", BatchNorm(ch))
            self.add_module(f"score_paf{i}", Conv(ch, paf_channels, 1))
            self.add_module(f"score_ht{i}", Conv(ch, heat_channels, 1))
            if i < num_stacks - 1:
                self.add_module(f"fc_{i}", Conv(ch, ch, 1))
                self.add_module(f"paf_score_{i}", Conv(paf_channels, ch, 1))
                self.add_module(f"ht_score_{i}", Conv(heat_channels, ch, 1))
        conv_init(self, generator if generator is not None
                  else torch.Generator().manual_seed(0))

    def forward(self, images: torch.Tensor) -> ModelOutput:
        x = self.stem_conv(images.permute(0, 3, 1, 2).to(self.dtype))
        x = self.layer1(F.relu(self.stem_bn(x)))
        x = self.layer3(self.layer2(F.max_pool2d(x, 2, 2)))
        pafs, heats = [], []
        for i in range(self.num_stacks):
            y = getattr(self, f"res{i}")(getattr(self, f"hg{i}")(x))
            y = F.relu(getattr(self, f"fc_bn{i}")(getattr(self, f"fc{i}")(y)))
            paf = getattr(self, f"score_paf{i}")(y)
            heat = getattr(self, f"score_ht{i}")(y)
            pafs.append(paf)
            heats.append(heat)
            if i < self.num_stacks - 1:
                x = (x + getattr(self, f"fc_{i}")(y)
                     + getattr(self, f"paf_score_{i}")(paf)
                     + getattr(self, f"ht_score_{i}")(heat))
        return nchw_to_output(pafs, heats)
