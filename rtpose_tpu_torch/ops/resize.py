"""Bilinear map resize with cv2 INTER_LINEAR parity (port of
rtpose_tpu/ops/resize.py:41-69).

For a fixed (src, dst) pair cv2's INTER_LINEAR is a dense linear map per
axis, so the 2-D resize is two matrix products.  The matrices are built in
numpy (copied from the JAX package, whose module imports jax) and the
products run in fp32 through ``torch.matmul``.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


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


def resize_bilinear(maps: torch.Tensor, dst_hw: Tuple[int, int]
                    ) -> torch.Tensor:
    """(..., H, W, C) fp32 maps -> (..., dst_h, dst_w, C)."""
    dev = maps.device
    my = torch.as_tensor(resize_matrix_linear(maps.shape[-3], dst_hw[0]),
                         device=dev)
    mx = torch.as_tensor(resize_matrix_linear(maps.shape[-2], dst_hw[1]),
                         device=dev)
    out = torch.einsum("ys,...swc->...ywc", my, maps)
    return torch.einsum("xw,...ywc->...yxc", mx, out)
