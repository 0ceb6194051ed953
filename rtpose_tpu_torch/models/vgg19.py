"""VGG19 rtpose, the flagship model (port of rtpose_tpu/models/vgg19.py;
reference lib/network/rtpose_vgg.py:60-127).

  model0: VGG19 conv1_1..conv4_2 (first 10 convs) + conv4_3_CPM (512->256)
          + conv4_4_CPM (256->128), three 2x2 maxpools -> stride 8, 128 ch
  model1_{1,2}: stage-1 branches (38 PAF / 19 heatmap channels)
  model{2..6}_{1,2}: refinement branches on concat([paf, heat, feat])

Module names and ``nn.Sequential`` indices are the reference's, so its
``pose_model.pth`` loads with ``strict=True``.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn

from .common import CPMStages, Conv, ModelOutput, conv_init  # noqa: F401
from .convert import torch_layout_map

# (features, num_convs) per VGG block before each pool; then the CPM neck.
_VGG_BLOCKS = ((64, 2), (128, 2), (256, 4), (512, 2))


def vgg19_trunk() -> nn.Sequential:
    """``model0``: the VGG19 trunk up to conv4_2 plus the CPM neck."""
    layers, cin = [], 3
    for b, (feat, n_convs) in enumerate(_VGG_BLOCKS, start=1):
        for _ in range(n_convs):
            layers += [Conv(cin, feat, 3), nn.ReLU(inplace=True)]
            cin = feat
        if b < len(_VGG_BLOCKS):
            layers.append(nn.MaxPool2d(2, 2))
    layers += [Conv(512, 256, 3), nn.ReLU(inplace=True),
               Conv(256, 128, 3), nn.ReLU(inplace=True)]
    return nn.Sequential(*layers)


class VGG19RTPose(CPMStages):
    """VGG19 backbone + `num_stages`-stage CPM cascade.

    forward: (B, H, W, 3) NHWC images -> :class:`ModelOutput`.
    """

    def __init__(self, num_stages: int = 6, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 remat: bool = False):
        super().__init__(128, num_stages, trunk=vgg19_trunk(), remat=remat)
        self.dtype = dtype
        conv_init(self, generator if generator is not None
                  else torch.Generator().manual_seed(0))

    def forward(self, images: torch.Tensor) -> ModelOutput:
        x = images.permute(0, 3, 1, 2).to(self.dtype)
        return super().forward(self.model0(x))

    @staticmethod
    def pretrained_conv_names() -> List[str]:
        """Module names of the 10 ImageNet-pretrained VGG convs, frozen
        during the first training phase (reference train_VGG19.py:305-320):
        the JAX package's ``pretrained_conv_paths`` through the layout
        map, ``model0.{0,2,5,7,10,12,14,16,19,21}``."""
        vgg = {f"conv{b}_{c}" for b, (_, n) in enumerate(_VGG_BLOCKS, 1)
               for c in range(1, n + 1)}
        return [prefix for prefix, path in torch_layout_map(1)
                if path[0] == "backbone" and path[1] in vgg]
