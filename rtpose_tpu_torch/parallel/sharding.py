"""Tensor parallelism: the JAX package's rule, and the convolution it
shards (port of rtpose_tpu/parallel/sharding.py).

With ``num_model > 1`` the JAX package stores a conv kernel whose output
channels ``O`` divide by ``num_model`` and number at least
``min_features`` channel-sharded over the ``model`` axis, and XLA's GSPMD
places the collectives.  Here :func:`shard_module` keeps each such conv's
rows ``[r*O/m, (r+1)*O/m)`` (dimension 0 of torch's OIHW weight, and its
bias) on model rank ``r`` and makes it column-parallel, Megatron's
recipe:

- its input goes through an identity whose backward all-reduces (sums)
  the gradient over the model group: each rank's local conv sees only its
  output channels' share of the input gradient;
- the local conv;
- an all-gather of the output channels over the model group, whose
  backward takes the rank's own slice: the compute after it is
  replicated, so every rank holds the same whole gradient.  (The backward
  of ``torch.distributed.nn.functional.all_gather`` sums the ranks'
  gradients, which would scale them by ``num_model``.)

A grouped conv (depthwise) shards whole groups and takes its groups'
input channels.  Other parameters stay replicated: the JAX rule also
stores a BatchNorm scale of 128 or more channels sharded, which changes
where it lives and not what is computed.  :func:`full_state_dict`
gathers a sharded model into the unsharded one's state dict, and
:func:`shard_state_dict` cuts a full one to this rank's.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import torch
import torch.distributed as dist
import torch.nn as nn

from .mesh import MODEL_AXIS


def param_spec(shape, num_model: int, min_features: int = 128) -> tuple:
    """The sharding of one parameter of `shape` (torch layout): a conv
    weight (O, I, kH, kW) with O divisible by `num_model` and at least
    `min_features` -> ``(MODEL_AXIS, None, None, None)``; a vector of such
    a length (a bias) -> ``(MODEL_AXIS,)``; everything else replicated,
    ``()``.  The JAX rule on the HWIO kernel's last axis."""
    shape = tuple(shape)
    if num_model <= 1 or not shape:
        return ()
    features = shape[0]
    if features % num_model != 0 or features < min_features:
        return ()
    if len(shape) == 4:
        return (MODEL_AXIS, None, None, None)
    if len(shape) == 1:
        return (MODEL_AXIS,)
    return ()


# ---- collectives inside autograd -------------------------------------------

class _AllReduceSum(torch.autograd.Function):
    """Sum over `group`; the gradient of every rank's copy of the sum is
    summed back into each addend."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the ranks of `group`, differentiable."""
    return _AllReduceSum.apply(x, group)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward all-reduces over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    """All-gather along the channels (dim 1); the backward keeps the rank's
    own slice of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.group, ctx.rank, ctx.width = group, rank, x.shape[1]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, 1)

    @staticmethod
    def backward(ctx, grad):
        return (grad.narrow(1, ctx.rank * ctx.width, ctx.width).contiguous(),
                None, None, None)


class ColumnParallel:
    """Mixed into a sharded conv's class by :func:`shard_module`."""

    tp_group = None
    tp_rank = 0
    tp_size = 1
    tp_in = 0          # a grouped conv's input channels on this rank

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _CopyToModel.apply(x, self.tp_group)
        if self.tp_in:
            x = x.narrow(1, self.tp_rank * self.tp_in, self.tp_in)
        y = super().forward(x)
        return _GatherFromModel.apply(y, self.tp_group, self.tp_rank,
                                      self.tp_size)


_CLASSES: Dict[type, type] = {}


def _column_parallel(cls: type) -> type:
    if cls not in _CLASSES:
        _CLASSES[cls] = type(f"ColumnParallel{cls.__name__}",
                             (ColumnParallel, cls), {})
    return _CLASSES[cls]


@torch.no_grad()
def shard_module(model: nn.Module, mesh, min_features: int = 128
                 ) -> List[str]:
    """Make every conv of `model` that :func:`param_spec` shards
    column-parallel over ``mesh.model_group``, keeping this rank's output
    channels.  Returns the names of the sharded parameters (state_dict
    keys keep their names; their shapes are the rank's)."""
    m, r = mesh.num_model, mesh.model_index
    names: List[str] = []
    if m <= 1:
        return names
    for name, mod in model.named_modules():
        if not isinstance(mod, nn.Conv2d) or isinstance(mod, ColumnParallel):
            continue
        if not param_spec(mod.weight.shape, m, min_features):
            continue
        if mod.groups > 1 and mod.groups % m:
            continue          # its groups do not split over the ranks
        per = mod.out_channels // m
        mod.weight = nn.Parameter(mod.weight[r * per:(r + 1) * per].clone())
        names.append(f"{name}.weight")
        if mod.bias is not None:
            mod.bias = nn.Parameter(mod.bias[r * per:(r + 1) * per].clone())
            names.append(f"{name}.bias")
        if mod.groups > 1:
            mod.tp_in = mod.in_channels // m
            mod.in_channels //= m
            mod.groups //= m
        mod.out_channels = per
        mod.tp_group, mod.tp_rank, mod.tp_size = mesh.model_group, r, m
        mod.__class__ = _column_parallel(type(mod))
    return names


def gather_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """The whole tensor of which every model rank holds rows of dim 0."""
    parts = [torch.empty_like(t) for _ in range(mesh.num_model)]
    dist.all_gather(parts, t.contiguous(), group=mesh.model_group)
    return torch.cat(parts)


def own_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """This model rank's rows of dim 0 of a whole tensor."""
    per = t.shape[0] // mesh.num_model
    return t[mesh.model_index * per:(mesh.model_index + 1) * per].clone()


def full_state_dict(model: nn.Module, sharded: List[str], mesh
                    ) -> Dict[str, torch.Tensor]:
    """`model`'s state dict with every sharded parameter gathered: the
    unsharded model's, loadable by ``load_strict`` and the pipeline.  A
    collective: every rank of the model group calls it."""
    sd = model.state_dict()
    for k in sharded:
        sd[k] = gather_rows(sd[k], mesh)
    return sd


def shard_state_dict(state: Mapping[str, torch.Tensor], sharded: List[str],
                     mesh) -> Dict[str, torch.Tensor]:
    """A full state dict cut to this rank's rows of each sharded entry."""
    out = dict(state)
    for k in sharded:
        out[k] = own_rows(state[k], mesh)
    return out
