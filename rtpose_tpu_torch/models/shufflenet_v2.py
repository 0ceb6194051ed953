"""ShuffleNetV2 lightweight pose model (port of
rtpose_tpu/models/shufflenet_v2.py; reference
lib/network/rtpose_shufflenetV2.py).

Single stage: an input BatchNorm, the ShuffleNetV2 trunk (channel-split
units + shuffle; stage strides 2, 1, 1 after the stem and pool, so output
stride 8) and 1x1 conv5 -> 1x1 paf / heatmap heads.  Module names are
the flax ones (flax's auto-named ``Conv_0`` / ``BatchNorm_0`` inside a
``ConvBNReLU`` are ``conv`` / ``bn``): ``stage2_unit1.dw_proj.bn``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..skeleton import NUM_HEATMAPS, NUM_PAF_CHANNELS
from .common import (BatchNorm, Conv, ModelOutput, conv_init, max_pool_same,
                     nchw_to_output)

# width multiplier -> (stage2, stage3, stage4, conv5) channels; a copy of
# rtpose_tpu/models/shufflenet_v2.py's table
WIDTH_CONFIGS = {
    0.25: (24, 48, 96, 512),
    0.33: (32, 64, 128, 512),
    0.5: (48, 96, 192, 1024),
    1.0: (116, 232, 464, 1024),
    1.5: (176, 352, 704, 1024),
    2.0: (244, 488, 976, 2048),
}


class ConvBNReLU(nn.Module):
    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1,
                 dilation: int = 1, depthwise: bool = False,
                 relu: bool = True):
        super().__init__()
        self.conv = Conv(cin, cout, k, stride=stride, dilation=dilation,
                         groups=cin if depthwise else 1, bias=False,
                         init="kaiming")
        self.bn = BatchNorm(cout)
        self.relu = relu

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.relu else x


def channel_shuffle(x: torch.Tensor, groups: int = 2) -> torch.Tensor:
    """NCHW channel shuffle: channel ``j * groups + g`` of the output is
    channel ``g * (C / groups) + j`` of the input (``[0, 4, 1, 5, ...]``
    for 8 channels in 2 groups), the permutation of the flax NHWC one."""
    b, c, h, w = x.shape
    x = x.reshape(b, groups, c // groups, h, w).transpose(1, 2)
    return x.reshape(b, c, h, w)


class ShuffleUnit(nn.Module):
    """Channel-split unit (stride 1) or downsampling unit
    (reference :22-63)."""

    def __init__(self, cin: int, cout: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False):
        super().__init__()
        half = cout // 2
        self.split = not downsample and stride == 1
        first = cin - cin // 2 if self.split else cin
        self.pw1 = ConvBNReLU(first, half, 1)
        self.dw = ConvBNReLU(half, half, 3, stride=1 if self.split else stride,
                             dilation=dilation, depthwise=True, relu=False)
        self.pw2 = ConvBNReLU(half, half, 1)
        if not self.split:
            self.dw_proj = ConvBNReLU(cin, cin, 3, stride=stride,
                                      dilation=dilation, depthwise=True,
                                      relu=False)
            self.pw_proj = ConvBNReLU(cin, half, 1)

    def forward(self, x):
        if self.split:
            c = x.shape[1] // 2
            x1, x2 = x[:, :c], x[:, c:]
            y = self.pw2(self.dw(self.pw1(x2)))
            out = torch.cat([x1, y], dim=1)
        else:
            y = self.pw2(self.dw(self.pw1(x)))
            z = self.pw_proj(self.dw_proj(x))
            out = torch.cat([z, y], dim=1)
        return channel_shuffle(out, 2)


_STAGES = ((2, 1, 4), (1, 1, 8), (1, 1, 4))   # (stride, dilation, units)


class ShuffleNetV2RTPose(nn.Module):
    """Trunk stages (4, 8, 4 units) + conv5 + 1x1 heads (reference
    :96-106), output stride 8.  forward: (B, H, W, 3) NHWC images ->
    :class:`ModelOutput` with one stage."""

    def __init__(self, width_multiplier: float = 1.0,
                 paf_channels: int = NUM_PAF_CHANNELS,
                 heat_channels: int = NUM_HEATMAPS,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        c1, c2, c3, c5 = WIDTH_CONFIGS[width_multiplier]
        self.data_bn = BatchNorm(3)
        self.stage1_conv = ConvBNReLU(3, 24, 3, stride=2)
        cin = 24
        for si, (ch, (stride, dil, units)) in enumerate(zip((c1, c2, c3),
                                                           _STAGES)):
            self.add_module(f"stage{si + 2}_unit1", ShuffleUnit(
                cin, ch, stride=stride, dilation=dil, downsample=True))
            for b in range(1, units):
                self.add_module(f"stage{si + 2}_unit{b + 1}", ShuffleUnit(
                    ch, ch, stride=1, dilation=dil))
            cin = ch
        self.conv5 = ConvBNReLU(c3, c5, 1)
        self.paf = Conv(c5, paf_channels, 1, init="kaiming")
        self.heatmap = Conv(c5, heat_channels, 1, init="kaiming")
        conv_init(self, generator if generator is not None
                  else torch.Generator().manual_seed(0))

    def forward(self, images: torch.Tensor) -> ModelOutput:
        x = self.data_bn(images.permute(0, 3, 1, 2).to(self.dtype))
        x = max_pool_same(self.stage1_conv(x), 3, 2)
        for si, (_, _, units) in enumerate(_STAGES):
            for b in range(units):
                x = getattr(self, f"stage{si + 2}_unit{b + 1}")(x)
        x = self.conv5(x)
        return nchw_to_output([self.paf(x)], [self.heatmap(x)])
