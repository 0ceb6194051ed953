"""OpenPose-v2-style model (port of rtpose_tpu/models/openpose_v2.py;
reference lib/network/openpose.py).

VGG19 trunk with PReLU on the CPM neck, then densely connected stage
blocks: five triples of 3x3 PReLU convs with intra-block concat,
sequential PAF stages followed by heatmap stages (reference :64-177),
38 PAF / 19 heatmap channels.  Module names are the flax ones, so
``state_dict`` keys read like the flax paths (flax's auto-named
``Conv_0`` / ``PReLU_0`` inside a ``ConvPReLU`` are ``conv`` /
``prelu``): ``paf_stage0.m0_0.conv.weight``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..skeleton import NUM_HEATMAPS, NUM_PAF_CHANNELS
from .common import Conv, ModelOutput, PReLU, conv_init, nchw_to_output
from .vgg19 import _VGG_BLOCKS


class ConvPReLU(nn.Module):
    def __init__(self, cin: int, cout: int, k: int = 3):
        super().__init__()
        self.conv = Conv(cin, cout, k)
        self.prelu = PReLU(cout)

    def forward(self, x):
        return self.prelu(self.conv(x))


class DenseStageBlock(nn.Module):
    """5 x (three 3x3 convs, concat) + 1x1 + 1x1 out
    (reference openpose.py:64-109)."""

    def __init__(self, cin: int, inner: int, inner_out: int,
                 out_channels: int):
        super().__init__()
        for i in range(5):
            self.add_module(f"m{i}_0", ConvPReLU(cin, inner))
            self.add_module(f"m{i}_1", ConvPReLU(inner, inner))
            self.add_module(f"m{i}_2", ConvPReLU(inner, inner))
            cin = 3 * inner
        self.m6 = ConvPReLU(cin, inner_out, 1)
        self.out = Conv(inner_out, out_channels, 1)

    def forward(self, x):
        for i in range(5):
            a = getattr(self, f"m{i}_0")(x)
            b = getattr(self, f"m{i}_1")(a)
            c = getattr(self, f"m{i}_2")(b)
            x = torch.cat([a, b, c], dim=1)
        return self.out(self.m6(x))


class VGG19PReLUBackbone(nn.Module):
    """VGG19 trunk; PReLU on conv4_2 / conv4_3_CPM / conv4_4_CPM
    (reference openpose.py:13-50)."""

    def __init__(self):
        super().__init__()
        cin = 3
        for b, (feat, n_convs) in enumerate(_VGG_BLOCKS, start=1):
            for c in range(1, n_convs + 1):
                self.add_module(f"conv{b}_{c}", Conv(cin, feat, 3))
                cin = feat
        self.prelu4_2 = PReLU(512)
        self.conv4_3_CPM = Conv(512, 256, 3)
        self.prelu4_3 = PReLU(256)
        self.conv4_4_CPM = Conv(256, 128, 3)
        self.prelu4_4 = PReLU(128)

    def forward(self, x):
        for b, (_, n_convs) in enumerate(_VGG_BLOCKS, start=1):
            for c in range(1, n_convs + 1):
                x = getattr(self, f"conv{b}_{c}")(x)
                x = self.prelu4_2(x) if (b, c) == (4, 2) else F.relu(x)
            if b < len(_VGG_BLOCKS):
                x = F.max_pool2d(x, 2, 2)
        x = self.prelu4_3(self.conv4_3_CPM(x))
        return self.prelu4_4(self.conv4_4_CPM(x))


def _stage_widths(i: int):
    return (96, 256) if i == 0 else (128, 512)


class OpenPoseV2(nn.Module):
    """Sequential PAF stages, then heatmap stages (reference
    openpose.py:111-177).  forward: (B, H, W, 3) NHWC images ->
    :class:`ModelOutput` with max(#PAF, #heat) stages: the last PAF
    repeated behind, the first heatmap repeated in front."""

    def __init__(self, num_paf_stages: int = 4, num_heat_stages: int = 2,
                 paf_channels: int = NUM_PAF_CHANNELS,
                 heat_channels: int = NUM_HEATMAPS,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.num_paf_stages = num_paf_stages
        self.num_heat_stages = num_heat_stages
        self.backbone = VGG19PReLUBackbone()
        cin = 128
        for i in range(num_paf_stages):
            self.add_module(f"paf_stage{i}", DenseStageBlock(
                cin, *_stage_widths(i), paf_channels))
            cin = 128 + paf_channels
        for i in range(num_heat_stages):
            self.add_module(f"heat_stage{i}", DenseStageBlock(
                cin, *_stage_widths(i), heat_channels))
            cin = 128 + heat_channels + paf_channels
        conv_init(self, generator if generator is not None
                  else torch.Generator().manual_seed(0))

    def forward(self, images: torch.Tensor) -> ModelOutput:
        feat = self.backbone(images.permute(0, 3, 1, 2).to(self.dtype))
        pafs, heats = [], []
        x = feat
        for i in range(self.num_paf_stages):
            pafs.append(getattr(self, f"paf_stage{i}")(x))
            x = torch.cat([feat, pafs[-1]], dim=1)
        for i in range(self.num_heat_stages):
            heats.append(getattr(self, f"heat_stage{i}")(x))
            x = torch.cat([feat, heats[-1], pafs[-1]], dim=1)
        # the stage-stacked contract (openpose_v2.py:123-130): PAF is
        # supervised at every PAF stage, heat at every heat stage
        n = max(len(pafs), len(heats))
        pafs = pafs + [pafs[-1]] * (n - len(pafs))
        heats = [heats[0]] * (n - len(heats)) + heats
        return nchw_to_output(pafs, heats)
