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


def same_pads(n: int, k: int, stride: int = 1, dilation: int = 1):
    """flax/XLA 'SAME' padding of a side of `n` for a window of `k` taps,
    as (before, after): ``total = max((ceil(n/s) - 1)*s + k_eff - n, 0)``,
    ``total // 2`` before and the rest after.  With stride 2 it is
    asymmetric (k=3 on an even side: 0 before, 1 after)."""
    k_eff = (k - 1) * dilation + 1
    total = max((-(-n // stride) - 1) * stride + k_eff - n, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, stride: int, dilation: int = 1,
              value: float = 0.0):
    """Pad an NCHW tensor for a 'SAME' window -> (x, the symmetric
    padding left for the op to apply, or 0 once `x` is padded here)."""
    (t, b), (l, r) = (same_pads(n, k, stride, dilation)
                      for n in x.shape[-2:])
    if t == b and l == r and value == 0.0:
        return x, (t, l)
    return F.pad(x, (l, r, t, b), value=value), 0


class Conv(nn.Conv2d):
    """``nn.Conv2d`` with flax's 'SAME' padding (asymmetric where flax's
    is, for strided convolutions) whose weights follow the input's dtype
    (flax's compute-dtype cast), state_dict-compatible with
    ``nn.Conv2d``.  `init` names the flax initializer :func:`conv_init`
    draws the weights from: ``"normal"`` N(0, 0.01) (the JAX package's
    ``conv_init``), ``"lecun"`` flax's default truncated ``lecun_normal``,
    ``"kaiming"`` flax's ``kaiming_uniform``; biases start at 0.
    PyTorch's own initialisation is skipped (it would draw millions of
    numbers only to overwrite them)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 dilation: int = 1, groups: int = 1, bias: bool = True,
                 init: str = "normal"):
        super().__init__(cin, cout, k, stride=stride,
                         padding=((k - 1) * dilation) // 2,
                         dilation=dilation, groups=groups, bias=bias)
        self.init = init

    def reset_parameters(self) -> None:
        pass

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s, d = self.kernel_size[0], self.stride[0], self.dilation[0]
        x, pad = _pad_same(x, k, s, d)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), bias, s, pad, d,
                        self.groups)


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm`` (momentum 0.99, epsilon 1e-5) over NCHW.

    Train mode normalises with the batch's statistics and moves the
    running ones by ``0.99 * old + 0.01 * batch``, with the *biased*
    batch variance as flax keeps it (``nn.BatchNorm2d`` keeps the
    unbiased one, and moves by 0.1); eval mode normalises with the
    running statistics.  Statistics, scale and bias stay fp32 in a bf16
    model and the reduction runs in fp32 (flax's
    ``force_float32_reductions``); the output has the input's dtype.
    Keys: ``weight`` (flax ``scale``), ``bias``, ``running_mean``,
    ``running_var``."""

    momentum = 0.99
    eps = 1e-5

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        # momentum 1 leaves the batch's mean and unbiased variance in the
        # scratch buffers; the running update is flax's, on the biased one
        mean = torch.zeros_like(self.running_mean)
        var = torch.ones_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0,
                         self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            keep = self.momentum
            self.running_mean.mul_(keep).add_(mean, alpha=1.0 - keep)
            self.running_var.mul_(keep).add_(
                var, alpha=(1.0 - keep) * (n - 1) / n)
        return y


class PReLU(nn.Module):
    """Per-channel PReLU with slopes initialised to 0.25 (the ``PReLU`` of
    rtpose_tpu/models/openpose_v2.py); the slope is cast to the input's
    dtype, as flax casts ``alpha``."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.prelu(x, self.weight.to(x.dtype))


def max_pool_same(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """``nn.max_pool(..., padding="SAME")``: -inf padding, flax's split."""
    x, pad = _pad_same(x, k, stride, value=float("-inf"))
    return F.max_pool2d(x, k, stride, pad)


def avg_pool_same(x: torch.Tensor, k: int, stride: int = 1) -> torch.Tensor:
    """``nn.avg_pool(..., padding="SAME")``: zero padding counted in the
    mean, as flax counts it."""
    x, pad = _pad_same(x, k, stride)
    return F.avg_pool2d(x, k, stride, pad, count_include_pad=True)


def nchw_to_output(pafs: List[torch.Tensor],
                   heats: List[torch.Tensor]) -> ModelOutput:
    """Per-stage NCHW maps -> :class:`ModelOutput`, (S, B, h, w, C) fp32."""
    def stack(maps):
        return torch.stack([m.float() for m in maps]).permute(0, 1, 3, 4, 2)

    return ModelOutput(pafs=stack(pafs), heatmaps=stack(heats))


@torch.no_grad()
def conv_init(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every conv of `module`, in module order, from its flax
    initializer (:class:`Conv` ``init``; N(0, 0.01) is reference
    rtpose_vgg.py:200-206); biases start at 0."""
    for m in module.modules():
        if not isinstance(m, nn.Conv2d):
            continue
        kind = getattr(m, "init", "normal")
        fan_in = m.weight[0].numel()
        if kind == "normal":
            m.weight.normal_(0.0, 0.01, generator=generator)
        elif kind == "lecun":
            # flax's variance_scaling(1, fan_in, truncated_normal): a
            # normal cut at +-2 std has 0.8796 of the uncut one's std
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
        elif kind == "kaiming":
            bound = (6.0 / fan_in) ** 0.5
            m.weight.uniform_(-bound, bound, generator=generator)
        else:
            raise ValueError(f"unknown conv init {kind!r}")
        if m.bias is not None:
            m.bias.zero_()


# per-family prediction-head module names (rtpose_tpu/models/common.py:
# 87-97): CPM stages and the dense and dilated blocks name theirs "out",
# hourglass "score_paf{i}" / "score_ht{i}", shufflenet "paf" / "heatmap"
HEAD_NAMES = ("out", "paf", "heatmap")
HEAD_PREFIXES = ("score_paf", "score_ht")


@torch.no_grad()
def he_reinit(module: nn.Module, generator: torch.Generator) -> None:
    """Re-draw every hidden conv weight He-normal (std sqrt(2 / fan_in)),
    in module order (port of rtpose_tpu/models/common.py:65-112).

    The reference's N(0, 0.01) init pairs with the ImageNet-pretrained
    trunk; from scratch, activations decay through the 10-conv trunk and
    the network cannot train (``cfg.model.init_scheme = "scratch"``).  The
    output heads of every family keep their reference init (the last conv
    of a VGG19 stage branch, and the modules :data:`HEAD_NAMES` and
    :data:`HEAD_PREFIXES` name), so the first predictions sit near the
    background and the loss starts small; biases and BatchNorm parameters
    are left as they are.
    """
    heads = {id(m[-1]) for m in module.modules()
             if isinstance(m, (CPMStage1, CPMStageT))}
    for name, m in module.named_modules():
        if not isinstance(m, nn.Conv2d) or id(m) in heads:
            continue
        if any(p in HEAD_NAMES or p.startswith(HEAD_PREFIXES)
               for p in name.split(".")):
            continue
        fan_in = m.weight[0].numel()
        m.weight.normal_(0.0, (2.0 / fan_in) ** 0.5, generator=generator)


def cast_compute(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Store the weights of every module but :class:`BatchNorm` in the
    compute type, in place: the rounding flax applies to its fp32
    parameters on every call, paid once.  BatchNorm keeps its fp32
    scale, bias and statistics, as flax does."""
    for m in model.modules():
        if not isinstance(m, BatchNorm):
            for p in m.parameters(recurse=False):
                p.data = p.data.to(dtype)
    return model


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

        return nchw_to_output(pafs, heats)
