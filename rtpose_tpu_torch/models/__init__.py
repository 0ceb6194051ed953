"""Model registry of the port (port of rtpose_tpu/models/__init__.py):
``get_model(name)`` builds any of the seven families behind one contract,
NHWC images in, :class:`ModelOutput` out."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .common import ModelOutput  # noqa: F401

FAMILIES = ("vgg19", "mobilenet", "hourglass", "shufflenet_v2",
            "openpose_v2", "atrous_resnet50", "atrous_cpm",
            "atrous_cpm_shared")


def get_model(name: str = "vgg19", *, num_stages: int = 6,
              dtype: torch.dtype = torch.float32,
              generator: Optional[torch.Generator] = None, **kwargs):
    """Build a model by family name, on the CPU, with weights drawn from
    `generator` (seed 0 when None) by each family's flax initializers.

    The builders have the JAX package's explicit signatures
    (rtpose_tpu/models/__init__.py:43-100), so an option a family does not
    take is a ``TypeError`` (``remat`` is VGG19's alone); ``num_stages``
    is hourglass's stack count, and shufflenet_v2 and atrous_resnet50
    (single-stage by construction) and openpose_v2 (staged by
    ``num_paf_stages`` / ``num_heat_stages``) accept and ignore it.  An
    unknown name is a ``KeyError``."""
    builder = _builder(name)
    if builder is None:
        raise KeyError(f"unknown model family '{name}'; "
                       f"known: {sorted(FAMILIES)}")
    return builder(num_stages=num_stages, dtype=dtype, generator=generator,
                   **kwargs)


def _builder(name: str) -> Optional[Callable]:
    # imports on demand keep `import rtpose_tpu_torch.models` light
    if name == "vgg19":
        from .vgg19 import VGG19RTPose

        def build(*, num_stages=6, dtype=None, generator=None, remat=False):
            return VGG19RTPose(num_stages=num_stages, dtype=dtype,
                               generator=generator, remat=remat)
    elif name == "mobilenet":
        from .mobilenet_v2 import MobileNetRTPose

        def build(*, num_stages=6, dtype=None, generator=None):
            return MobileNetRTPose(num_stages=num_stages, dtype=dtype,
                                   generator=generator)
    elif name == "hourglass":
        from .hourglass import HourglassRTPose

        def build(*, num_stages=8, dtype=None, generator=None,
                  num_stacks=None):
            return HourglassRTPose(
                num_stacks=num_stacks if num_stacks is not None
                else num_stages, dtype=dtype, generator=generator)
    elif name == "shufflenet_v2":
        from .shufflenet_v2 import ShuffleNetV2RTPose

        def build(*, num_stages=1, dtype=None, generator=None,
                  width_multiplier=1.0):
            return ShuffleNetV2RTPose(width_multiplier=width_multiplier,
                                      dtype=dtype, generator=generator)
    elif name == "openpose_v2":
        from .openpose_v2 import OpenPoseV2

        def build(*, num_stages=6, dtype=None, generator=None,
                  num_paf_stages=4, num_heat_stages=2):
            return OpenPoseV2(num_paf_stages=num_paf_stages,
                              num_heat_stages=num_heat_stages, dtype=dtype,
                              generator=generator)
    elif name == "atrous_resnet50":
        from .atrous import AtrousPose

        def build(*, num_stages=1, dtype=None, generator=None):
            return AtrousPose(dtype=dtype, generator=generator)
    elif name in ("atrous_cpm", "atrous_cpm_shared"):
        from .atrous_cpm import AtrousCPM, AtrousCPMShared
        cls = AtrousCPM if name == "atrous_cpm" else AtrousCPMShared

        def build(*, num_stages=5, dtype=None, generator=None):
            return cls(num_stages=num_stages, dtype=dtype,
                       generator=generator)
    else:
        return None
    return build
