"""Shared building blocks of the port's models (port of
rtpose_tpu/models/common.py).

Public layouts follow the JAX package: images come in NHWC and
``ModelOutput.pafs`` / ``ModelOutput.heatmaps`` stack every refinement
stage along a leading axis, ``(S, B, H/8, W/8, C)`` in fp32.  Inside, the
convolutions run NCHW (or ``channels_last`` when the caller converts the
module), as PyTorch's kernels expect.

``dtype`` is the compute type, as flax's ``dtype`` is: inputs and weights
are cast to it for every convolution and stage outputs come back fp32.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..skeleton import NUM_HEATMAPS, NUM_PAF_CHANNELS


@dataclasses.dataclass
class ModelOutput:
    """Stage-stacked model outputs.

    pafs:     (num_stages, B, H/8, W/8, 38) fp32
    heatmaps: (num_stages, B, H/8, W/8, 19) fp32
    """
    pafs: torch.Tensor
    heatmaps: torch.Tensor

    @property
    def paf(self) -> torch.Tensor:
        return self.pafs[-1]

    @property
    def heatmap(self) -> torch.Tensor:
        return self.heatmaps[-1]


class Conv(nn.Conv2d):
    """``nn.Conv2d`` with 'SAME' padding whose weights follow the input's
    dtype (flax's compute-dtype cast), state_dict-compatible with
    ``nn.Conv2d``.  Initialised by :func:`conv_init`, not by PyTorch's
    default (which would draw 50M numbers only to overwrite them)."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__(cin, cout, k, padding=k // 2)

    def reset_parameters(self) -> None:
        pass

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                        padding=self.padding)


@torch.no_grad()
def conv_init(module: nn.Module, generator: torch.Generator) -> None:
    """N(0, 0.01) weights and zero biases for every conv of `module`, in
    module order (reference rtpose_vgg.py:200-206)."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            m.weight.normal_(0.0, 0.01, generator=generator)
            m.bias.zero_()


@torch.no_grad()
def he_reinit(module: nn.Module, generator: torch.Generator) -> None:
    """Re-draw every hidden conv weight He-normal (std sqrt(2 / fan_in)),
    in module order (port of rtpose_tpu/models/common.py:65-112).

    The reference's N(0, 0.01) init pairs with the ImageNet-pretrained
    trunk; from scratch, activations decay through the 10-conv trunk and
    the network cannot train (``cfg.model.init_scheme = "scratch"``).  The
    output head of every stage branch keeps its reference init, so the
    first predictions sit near the background and the loss starts small;
    biases are left as they are.
    """
    heads = {id(m[-1]) for m in module.modules()
             if isinstance(m, (CPMStage1, CPMStageT))}
    for m in module.modules():
        if isinstance(m, nn.Conv2d) and id(m) not in heads:
            fan_in = m.weight[0].numel()
            m.weight.normal_(0.0, (2.0 / fan_in) ** 0.5, generator=generator)


def _branch(layers: List[nn.Module]) -> List[nn.Module]:
    """Interleave ReLUs after every conv but the last (the reference's
    nn.Sequential indices: convs at even positions)."""
    out: List[nn.Module] = []
    for i, layer in enumerate(layers):
        out.append(layer)
        if i + 1 < len(layers):
            out.append(nn.ReLU(inplace=True))
    return out


class CPMStage1(nn.Sequential):
    """First prediction branch: 3x(3x3,128) + (1x1,512) + (1x1,out).
    Reference lib/network/rtpose_vgg.py:95-105."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(*_branch([
            Conv(in_channels, 128, 3), Conv(128, 128, 3), Conv(128, 128, 3),
            Conv(128, 512, 1), Conv(512, out_channels, 1)]))


class CPMStageT(nn.Sequential):
    """Refinement branch: 5x(7x7,128) + (1x1,128) + (1x1,out).
    Reference lib/network/rtpose_vgg.py:108-127."""

    def __init__(self, in_channels: int, out_channels: int):
        convs = [Conv(in_channels, 128, 7)]
        convs += [Conv(128, 128, 7) for _ in range(4)]
        convs += [Conv(128, 128, 1), Conv(128, out_channels, 1)]
        super().__init__(*_branch(convs))


class CPMStages(nn.Module):
    """The multi-stage PAF/heatmap refinement cascade.

    Stage 1 runs on the backbone features; stages 2..T on
    concat([paf, heat, features]) (reference rtpose_vgg.py:158-198).
    Submodules are ``model{t}_1`` (PAF) and ``model{t}_2`` (heatmaps), the
    reference's state_dict names; a backbone family passes its trunk,
    registered first as ``model0``, and runs it before :meth:`forward`.
    `remat` recomputes each refinement branch in the backward pass
    (``torch.utils.checkpoint``, the JAX package's ``nn.remat``), trading
    step time for activation memory.
    """

    def __init__(self, feat_channels: int, num_stages: int = 6,
                 paf_channels: int = NUM_PAF_CHANNELS,
                 heat_channels: int = NUM_HEATMAPS,
                 trunk: Optional[nn.Module] = None, remat: bool = False):
        super().__init__()
        if trunk is not None:
            self.model0 = trunk
        self.num_stages = num_stages
        self.remat = remat
        cat = paf_channels + heat_channels + feat_channels
        for t in range(1, num_stages + 1):
            mk, cin = (CPMStage1, feat_channels) if t == 1 else (CPMStageT,
                                                                 cat)
            self.add_module(f"model{t}_1", mk(cin, paf_channels))
            self.add_module(f"model{t}_2", mk(cin, heat_channels))

    def forward(self, features: torch.Tensor) -> ModelOutput:
        """features: (B, C, h, w) in the compute dtype."""
        pafs, heats = [], []
        x = features
        for t in range(1, self.num_stages + 1):
            if t > 1:
                x = torch.cat([pafs[-1], heats[-1], features], dim=1)
            for branch, out in ((f"model{t}_1", pafs), (f"model{t}_2", heats)):
                fn = getattr(self, branch)
                if self.remat and t > 1 and torch.is_grad_enabled():
                    out.append(checkpoint(fn, x, use_reentrant=False))
                else:
                    out.append(fn(x))

        def stack(maps):   # NCHW stages -> (S, B, h, w, C) fp32
            return torch.stack(maps).permute(0, 1, 3, 4, 2).float()

        return ModelOutput(pafs=stack(pafs), heatmaps=stack(heats))
