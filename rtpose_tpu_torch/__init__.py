"""rtpose_tpu_torch: the PyTorch/CUDA port of rtpose_tpu.

The serving slice of the JAX package rebuilt on PyTorch for an NVIDIA
Hopper card: the VGG19 6-stage CPM forward with flip TTA, the on-device
decode (peak NMS + bicubic refine, PAF line-integral scoring, greedy
matching, person assembly) and the crowded-frame retry.  The two decode
kernels that the JAX package wrote in Pallas for the TPU are hand-written
CUDA here (``csrc/``); every kernel keeps a plain PyTorch version that
CPU tensors take.

Layouts at the public functions follow the JAX package (NHWC maps,
stage-stacked model outputs) so the two can be compared array for array.
Nothing here imports jax, flax or cv2.
"""

__version__ = "0.1.0"

from . import skeleton  # noqa: F401
from .device import resolve_device  # noqa: F401
