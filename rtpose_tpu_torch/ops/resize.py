"""Map resizes with cv2 parity (port of rtpose_tpu/ops/resize.py):
INTER_LINEAR for the input frames, INTER_CUBIC for the multi-scale maps.

For a fixed (src, dst) pair either interpolation is a dense linear map per
axis, so the 2-D resize is two matrix products.  The matrices are built in
numpy (copied from the JAX package, whose module imports jax), copied to
each device once, and the products run in fp32 through ``torch.matmul``
with TF32 off, as JAX runs them at ``Precision.HIGHEST``.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Tuple

import numpy as np
import torch

from .kernels import _cubic_weights


@functools.lru_cache(maxsize=None)
def resize_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) interpolation matrix of cv2 INTER_CUBIC for one axis:
    output i samples (i + 0.5) * src/dst - 0.5 with 4 taps (A = -0.75) and
    border replication."""
    i = np.arange(dst)
    srcf = (i + 0.5) * (src / dst) - 0.5
    f = np.floor(srcf).astype(np.int64)
    t = srcf - f
    w = _cubic_weights(t)                      # (dst, 4)
    out = np.zeros((dst, src), dtype=np.float32)
    for k in range(4):
        r = np.clip(f - 1 + k, 0, src - 1)     # border replication
        np.add.at(out, (i, r), w[:, k])
    return out


@functools.lru_cache(maxsize=None)
def resize_matrix_linear(src: int, dst: int) -> np.ndarray:
    """(dst, src) interpolation matrix of cv2 INTER_LINEAR for one axis:
    output i samples (i + 0.5) * src/dst - 0.5 with 2 taps and border
    replication (no antialiasing, even when shrinking)."""
    i = np.arange(dst)
    srcf = (i + 0.5) * (src / dst) - 0.5
    f = np.floor(srcf).astype(np.int64)
    t = (srcf - f).astype(np.float32)
    out = np.zeros((dst, src), dtype=np.float32)
    for k, wk in ((0, 1.0 - t), (1, t)):
        r = np.clip(f + k, 0, src - 1)
        np.add.at(out, (i, r), wk)
    return out


@functools.lru_cache(maxsize=None)
def _matrices_on(device: torch.device, cubic: bool, src_hw: Tuple[int, int],
                 dst_hw: Tuple[int, int]):
    make = resize_matrix if cubic else resize_matrix_linear
    return tuple(torch.as_tensor(make(s, d), device=device)
                 for s, d in zip(src_hw, dst_hw))


@contextlib.contextmanager
def _full_fp32_matmul():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _resize(maps: torch.Tensor, dst_hw: Tuple[int, int], cubic: bool
            ) -> torch.Tensor:
    my, mx = _matrices_on(maps.device, cubic, tuple(maps.shape[-3:-1]),
                          tuple(dst_hw))
    *lead, h, w, c = maps.shape
    with _full_fp32_matmul():
        out = torch.matmul(my, maps.reshape(*lead, h, w * c))
        return torch.matmul(mx, out.reshape(*lead, dst_hw[0], w, c))


def resize_bilinear(maps: torch.Tensor, dst_hw: Tuple[int, int]
                    ) -> torch.Tensor:
    """(..., H, W, C) fp32 maps -> (..., dst_h, dst_w, C), cv2
    INTER_LINEAR parity."""
    return _resize(maps, dst_hw, cubic=False)


def resize_bicubic(maps: torch.Tensor, dst_hw: Tuple[int, int]
                   ) -> torch.Tensor:
    """(..., H, W, C) fp32 maps -> (..., dst_h, dst_w, C), cv2
    INTER_CUBIC parity (rtpose_tpu/ops/resize.py:72-84)."""
    return _resize(maps, dst_hw, cubic=True)
