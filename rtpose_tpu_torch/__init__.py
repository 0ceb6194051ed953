"""rtpose_tpu_torch: the PyTorch/CUDA port of rtpose_tpu.

The JAX package rebuilt on PyTorch for an NVIDIA Hopper card:

- serving: the VGG19 6-stage CPM forward with flip TTA, the on-device
  decode (peak NMS + bicubic refine, PAF line-integral scoring, greedy
  matching and person assembly in one kernel), the crowded-frame retry,
  multi-scale TTA and the self-test (``python -m
  rtpose_tpu_torch.selftest``);
- training: the single-card train step (ground-truth synthesis on the
  device, stage-wise MSE, nesterov SGD with the two-phase freeze, the
  non-finite guard), the plateau schedule and checkpoints.

Every kernel that the JAX package wrote in Pallas for the TPU is
hand-written CUDA here (``csrc/``), and so is the decode's grouping,
which the JAX package runs as two ``lax.scan``s; each keeps a plain
PyTorch version that CPU tensors take.  Layouts at the public functions
follow the JAX package (NHWC maps, stage-stacked model outputs) so the
two can be compared array for array.  Nothing here imports jax, flax or
cv2.
"""

__version__ = "0.2.0"

import torch as _torch

# MKL's vector math library (torch's CPU sqrt, exp, ...) initialises its
# dispatch lazily, and that initialisation races when its first call comes
# from several OpenMP threads at once: in about 1 process of 10 the first
# multi-threaded torch.sqrt or torch.exp returns thousands of values
# ~1e-4 off in the chunks of the worker threads (tests/test_torch_numerics.py).
# One call on this thread initialises it before any parallel call can.
_torch.exp(_torch.zeros(16))

from . import skeleton  # noqa: F401,E402
from .device import resolve_device  # noqa: F401,E402
