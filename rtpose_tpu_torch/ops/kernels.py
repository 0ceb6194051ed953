"""Wrappers of the hand-written CUDA decode kernels and their plain versions.

Two kernels carry the decode's hot work (sources in ``csrc/``):

- :func:`paf_sample_scores` (``csrc/paf_sample.cu``) replaces the TPU
  kernels ``paf_sample_scores_fused`` and ``paf_sample_scores`` of
  ``rtpose_tpu/ops/pallas_kernels.py``;
- :func:`bicubic_refine` (``csrc/bicubic_refine.cu``) replaces
  ``bicubic_refine`` of the same file.

A wrapper given CPU tensors runs the plain PyTorch version beside it; given
CUDA tensors it launches the kernel or raises.  There is no fallback from
one to the other.  ``<wrapper>.launches`` counts kernel launches (and only
those), so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from ..skeleton import GROUP_PAIRS_NET, NUM_GROUP_PAIRS

STEP_PAF = 10
THRESH_VECTOR_SCORE = 0.05
PATCH = 5          # 5x5 refine window, reference paf_to_pose.py:100
WIN = PATCH // 2

PAIR_CHX = np.array([c[0] for c in GROUP_PAIRS_NET], dtype=np.int64)
PAIR_CHY = np.array([c[1] for c in GROUP_PAIRS_NET], dtype=np.int64)


# ---------------------------------------------------------------------------
# bicubic interpolation matrices (copied from rtpose_tpu/ops/peaks.py:61-96,
# which imports jax at module level)
# ---------------------------------------------------------------------------

def _cubic_weights(t: np.ndarray) -> np.ndarray:
    """cv2 bicubic (A=-0.75) weights for taps (-1, 0, 1, 2) at fraction t."""
    A = -0.75
    w0 = ((A * (t + 1) - 5 * A) * (t + 1) + 8 * A) * (t + 1) - 4 * A
    w1 = ((A + 2) * t - (A + 3)) * t * t + 1
    tt = 1 - t
    w2 = ((A + 2) * tt - (A + 3)) * tt * tt + 1
    w3 = 1.0 - w0 - w1 - w2
    return np.stack([w0, w1, w2, w3], axis=-1)


@functools.lru_cache(maxsize=None)
def interp_matrices(factor: int) -> np.ndarray:
    """(3, PATCH*factor, PATCH) upsampling matrices for extents 3/4/5.

    Output index i samples source coordinate (i + 0.5)/factor - 0.5 with
    4 bicubic taps clamped to [0, n-1] (cv2 border replication); rows
    i >= n*factor are zero (masked downstream).
    """
    out = np.zeros((3, PATCH * factor, PATCH), dtype=np.float32)
    i = np.arange(PATCH * factor)
    src = (i + 0.5) / factor - 0.5
    f = np.floor(src).astype(np.int64)
    w = _cubic_weights(src - f)
    for p, n in enumerate((3, 4, 5)):
        for k in range(4):
            r = np.clip(f - 1 + k, 0, n - 1)
            np.add.at(out[p], (i, r), w[:, k])
        out[p, n * factor:, :] = 0.0
    return out


@functools.lru_cache(maxsize=None)
def _interp_matrices_on(device: torch.device, factor: int) -> torch.Tensor:
    return torch.as_tensor(interp_matrices(factor), device=device)


# ---------------------------------------------------------------------------
# launching
# ---------------------------------------------------------------------------

def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous() \
            or t.device != device:
        raise ValueError(
            f"{name}: expected a contiguous {ndim}-d {dtype} tensor on "
            f"{device}, got {tuple(t.shape)} {t.dtype} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


def _launch(fn_name: str, device: torch.device, *args) -> None:
    from . import _build
    lib = _build.load().lib
    if fn_name == "rtpose_paf_sample":
        _check_pair_table(lib)
    with torch.cuda.device(device):
        err = getattr(lib, fn_name)(*args, _stream(device))
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {err} at launch")


@functools.lru_cache(maxsize=None)
def _check_pair_table(lib) -> None:
    chx = (ctypes.c_int * NUM_GROUP_PAIRS)()
    chy = (ctypes.c_int * NUM_GROUP_PAIRS)()
    n = lib.rtpose_paf_pair_channels(chx, chy)
    if n != NUM_GROUP_PAIRS or list(chx) != PAIR_CHX.tolist() \
            or list(chy) != PAIR_CHY.tolist():
        raise RuntimeError("csrc/paf_sample.cu pair->channel table differs "
                           "from skeleton.GROUP_PAIRS_NET")


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


# ---------------------------------------------------------------------------
# PAF line-integral sampling (K1 + K2)
# ---------------------------------------------------------------------------

def paf_sample_scores_plain(paf: torch.Tensor, geo: torch.Tensor, *,
                            factor: int = 8
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`paf_sample_scores` (a gather)."""
    B, h, w, ch = paf.shape
    C = geo.shape[-1]
    ax, ay, step_x, step_y, ux, uy = geo.unbind(2)          # (B, 19, C)
    dev = paf.device
    chx = torch.as_tensor(PAIR_CHX, device=dev)[None, :, None]
    chy = torch.as_tensor(PAIR_CHY, device=dev)[None, :, None]
    base = torch.arange(B, device=dev)[:, None, None] * (h * w * ch)
    flat = paf.reshape(-1)
    cnt = torch.zeros((B, NUM_GROUP_PAIRS, C), dtype=torch.int32, device=dev)
    ssum = torch.zeros((B, NUM_GROUP_PAIRS, C), dtype=torch.float32,
                       device=dev)
    for s in range(STEP_PAF):
        sf = float(s)
        lx = (ax + sf * step_x + 0.5).to(torch.int32)
        ly = (ay + sf * step_y + 0.5).to(torch.int32)
        gx = torch.div(lx, factor, rounding_mode="floor").clamp(0, w - 1)
        gy = torch.div(ly, factor, rounding_mode="floor").clamp(0, h - 1)
        cell = base + (gy.long() * w + gx.long()) * ch
        sc = ux * flat[cell + chx] + uy * flat[cell + chy]
        cnt += (sc > THRESH_VECTOR_SCORE).to(torch.int32)
        ssum = ssum + sc
    return cnt, ssum


def paf_sample_scores(paf: torch.Tensor, geo: torch.Tensor, *,
                      factor: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """10-sample PAF line integral of every candidate limb.

    paf: (B, h, w, 38) fp32 low-res PAF.
    geo: (B, 19, 6, C) fp32 rows [ax, ay, step_x, step_y, ux, uy] per
        candidate (C = K*K), in upsampled-frame coordinates.
    Returns (cnt int32, ssum fp32), each (B, 19, C): the number of samples
    above THRESH_VECTOR_SCORE and their sequential fp32 sum.
    """
    if _route(paf) == "cpu":
        return paf_sample_scores_plain(paf, geo, factor=factor)
    B, h, w, ch = paf.shape
    C = geo.shape[-1]
    dev = paf.device
    _check("paf", paf, torch.float32, 4, dev)
    _check("geo", geo, torch.float32, 4, dev)
    if ch != 38 or tuple(geo.shape[:3]) != (B, NUM_GROUP_PAIRS, 6):
        raise ValueError(f"paf_sample_scores: paf {tuple(paf.shape)} / geo "
                         f"{tuple(geo.shape)} do not match (B,h,w,38) / "
                         f"(B,19,6,C)")
    cnt = torch.empty((B, NUM_GROUP_PAIRS, C), dtype=torch.int32, device=dev)
    ssum = torch.empty((B, NUM_GROUP_PAIRS, C), dtype=torch.float32,
                       device=dev)
    if B * C:
        _launch("rtpose_paf_sample", dev, _ptr(paf), _ptr(geo), _ptr(cnt),
                _ptr(ssum), B, h, w, C, factor)
        paf_sample_scores.launches += 1
    return cnt, ssum


paf_sample_scores.launches = 0


# ---------------------------------------------------------------------------
# bicubic sub-pixel refine (K3)
# ---------------------------------------------------------------------------

def window_origin(py: torch.Tensor, px: torch.Tensor, H: int, W: int):
    """Top-left corner and extents of each peak's clipped 5x5 window."""
    y_min = (py - WIN).clamp(min=0)
    x_min = (px - WIN).clamp(min=0)
    ph = (py + WIN).clamp(max=H - 1) - y_min + 1
    pw = (px + WIN).clamp(max=W - 1) - x_min + 1
    return y_min, x_min, ph, pw


def bicubic_refine_plain(heat: torch.Tensor, py: torch.Tensor,
                         px: torch.Tensor, *, factor: int = 8
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`bicubic_refine`: the per-peak
    ``_refine`` of rtpose_tpu/ops/peaks.py:154-201, batched."""
    B, P, H, W = heat.shape
    K = py.shape[-1]
    dev = heat.device
    y_min, x_min, ph, pw = window_origin(py.long(), px.long(), H, W)
    r = torch.arange(PATCH, device=dev)
    rows = (y_min[..., None] + r).clamp(0, H - 1)           # (B, P, K, 5)
    cols = (x_min[..., None] + r).clamp(0, W - 1)
    maps = torch.arange(B * P, device=dev).reshape(B, P, 1, 1, 1)
    idx = (maps * H + rows[..., :, None]) * W + cols[..., None, :]
    patch = heat.reshape(-1)[idx]                           # (B, P, K, 5, 5)
    inside = (r[:, None] < ph[..., None, None]) & \
        (r[None, :] < pw[..., None, None])
    patch = torch.where(inside, patch, 0.0)

    mats = _interp_matrices_on(dev, factor)                 # (3, n, 5)
    my_mat = mats[ph - 3]                                   # (B, P, K, n, 5)
    mx_mat = mats[pw - 3]
    # up = My @ patch @ Mx^T as sequential sums of separately rounded
    # products, the kernel's order: a matmul's own order would break
    # exact ties between neighbouring cells differently
    tmp = my_mat[..., 0:1] * patch[..., 0:1, :]             # (.., n, 5)
    for r in range(1, PATCH):
        tmp = tmp + my_mat[..., r:r + 1] * patch[..., r:r + 1, :]
    up = tmp[..., 0:1] * mx_mat[..., None, :, 0]            # (.., n, n)
    for c in range(1, PATCH):
        up = up + tmp[..., c:c + 1] * mx_mat[..., None, :, c]
    n = PATCH * factor
    i = torch.arange(n, device=dev)
    valid = (i[:, None] < (ph * factor)[..., None, None]) & \
        (i[None, :] < (pw * factor)[..., None, None])
    masked = torch.where(valid, up, -torch.inf).reshape(B, P, K, n * n)
    score = masked.amax(dim=-1)
    # first (lowest row-major) index of the maximum, as numpy's argmax
    cells = torch.arange(n * n, dtype=torch.int32, device=dev)
    flat = torch.where(masked == score[..., None], cells, n * n).amin(dim=-1)
    return flat // n, flat % n, score


def bicubic_refine(heat: torch.Tensor, py: torch.Tensor, px: torch.Tensor,
                   *, factor: int = 8
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sub-pixel refine of every peak.

    heat: (B, P, H, W) fp32 maps; py, px: (B, P, K) int32 peak cells.
    Returns (my, mx, score): the row-major first argmax (int32) of each
    peak's x`factor` bicubic-upsampled clipped 5x5 window and the value
    there (fp32), each (B, P, K).
    """
    if _route(heat) == "cpu":
        return bicubic_refine_plain(heat, py, px, factor=factor)
    B, P, H, W = heat.shape
    K = py.shape[-1]
    dev = heat.device
    _check("heat", heat, torch.float32, 4, dev)
    _check("py", py, torch.int32, 3, dev)
    _check("px", px, torch.int32, 3, dev)
    if H < 3 or W < 3 or tuple(py.shape) != (B, P, K) \
            or tuple(px.shape) != (B, P, K):
        raise ValueError(f"bicubic_refine: heat {tuple(heat.shape)} needs "
                         f"H, W >= 3 and peaks of shape (B, P, K), got "
                         f"{tuple(py.shape)} / {tuple(px.shape)}")
    mats = _interp_matrices_on(dev, factor)
    my = torch.empty((B, P, K), dtype=torch.int32, device=dev)
    mx = torch.empty((B, P, K), dtype=torch.int32, device=dev)
    score = torch.empty((B, P, K), dtype=torch.float32, device=dev)
    if B * P * K:
        _launch("rtpose_bicubic_refine", dev, _ptr(heat), _ptr(py), _ptr(px),
                _ptr(mats), _ptr(my), _ptr(mx), _ptr(score), B * P * K, K, H,
                W, factor)
        bicubic_refine.launches += 1
    return my, mx, score


bicubic_refine.launches = 0


def reset_launch_counts() -> None:
    paf_sample_scores.launches = 0
    bicubic_refine.launches = 0


def launch_counts() -> dict:
    return {"paf_sample_scores": paf_sample_scores.launches,
            "bicubic_refine": bicubic_refine.launches}
