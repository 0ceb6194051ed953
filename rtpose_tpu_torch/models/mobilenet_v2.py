"""MobileNetV2 pose model (port of rtpose_tpu/models/mobilenet_v2.py).

The MobileNetV2 trunk (inverted residuals, ReLU6; reference
lib/network/rtpose_mobilenetV2.py) truncated at stride 8, with a CPM neck
to 128 channels, feeds the shared CPM refinement cascade
(:class:`~.common.CPMStages`, the reference's stage layout under
``stages.``).  Module names are the flax ones: ``backbone.ir1_0.dw_bn``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import BatchNorm, CPMStages, Conv, ModelOutput, conv_init

# (expansion t, channels c, repeats n, stride s) — reference
# rtpose_mobilenetV2.py:68-77, truncated after the stride-8 stages
_STAGE8_SETTING = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 96, 3, 1),
)


class InvertedResidual(nn.Module):
    """pw-expand -> dw -> pw-linear with residual
    (reference rtpose_mobilenetV2.py:21-59)."""

    def __init__(self, cin: int, cout: int, stride: int = 1,
                 expand: int = 6):
        super().__init__()
        hidden = int(round(cin * expand))
        self.expand = expand
        self.residual = stride == 1 and cin == cout
        if expand != 1:
            self.pw = Conv(cin, hidden, 1, bias=False, init="lecun")
            self.pw_bn = BatchNorm(hidden)
        self.dw = Conv(hidden, hidden, 3, stride=stride, groups=hidden,
                       bias=False, init="lecun")
        self.dw_bn = BatchNorm(hidden)
        self.pw_linear = Conv(hidden, cout, 1, bias=False, init="lecun")
        self.pw_linear_bn = BatchNorm(cout)

    def forward(self, x):
        y = x
        if self.expand != 1:
            y = F.relu6(self.pw_bn(self.pw(y)))
        y = F.relu6(self.dw_bn(self.dw(y)))
        y = self.pw_linear_bn(self.pw_linear(y))
        return y + x if self.residual else y


class MobileNetV2Backbone(nn.Module):
    """Stride-8 trunk + CPM neck to 128 channels."""

    def __init__(self):
        super().__init__()
        self.stem = Conv(3, 32, 3, stride=2, bias=False, init="lecun")
        self.stem_bn = BatchNorm(32)
        cin = 32
        for si, (t, c, n, s) in enumerate(_STAGE8_SETTING):
            for i in range(n):
                self.add_module(f"ir{si}_{i}", InvertedResidual(
                    cin, c, stride=s if i == 0 else 1, expand=t))
                cin = c
        self.conv_cpm1 = Conv(cin, 256, 3)
        self.conv_cpm2 = Conv(256, 128, 3)

    def forward(self, x):
        x = F.relu6(self.stem_bn(self.stem(x)))
        for si, (_, _, n, _) in enumerate(_STAGE8_SETTING):
            for i in range(n):
                x = getattr(self, f"ir{si}_{i}")(x)
        x = F.relu(self.conv_cpm1(x))
        return F.relu(self.conv_cpm2(x))


class MobileNetRTPose(nn.Module):
    """forward: (B, H, W, 3) NHWC images -> :class:`ModelOutput`."""

    def __init__(self, num_stages: int = 6,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.backbone = MobileNetV2Backbone()
        self.stages = CPMStages(128, num_stages)
        conv_init(self, generator if generator is not None
                  else torch.Generator().manual_seed(0))

    def forward(self, images: torch.Tensor) -> ModelOutput:
        return self.stages(self.backbone(
            images.permute(0, 3, 1, 2).to(self.dtype)))
