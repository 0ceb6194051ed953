"""Model registry of the port.  Only the flagship VGG19 family is ported;
the other families of rtpose_tpu.models are queued in ROADMAP.md."""

from __future__ import annotations

from typing import Optional

import torch

from .common import ModelOutput  # noqa: F401
from .vgg19 import VGG19RTPose


def get_model(name: str = "vgg19", *, num_stages: int = 6,
              dtype: torch.dtype = torch.float32,
              generator: Optional[torch.Generator] = None,
              remat: bool = False) -> VGG19RTPose:
    """Build a model by family name, on the CPU, with N(0, 0.01) weights
    drawn from `generator` (seed 0 when None); `remat` recomputes the
    refinement branches in the backward pass."""
    if name != "vgg19":
        raise NotImplementedError(
            f"model family {name!r} is not ported to rtpose_tpu_torch yet; "
            f"only 'vgg19' is (see ROADMAP.md, queue 1)")
    return VGG19RTPose(num_stages=num_stages, dtype=dtype,
                       generator=generator, remat=remat)
