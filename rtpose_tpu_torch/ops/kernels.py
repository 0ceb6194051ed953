"""Wrappers of the hand-written CUDA kernels and their plain versions.

Three kernels carry the decode and one the training step's ground truth
(sources in ``csrc/``):

- :func:`connection_scores` (``csrc/connection_scores.cu``) replaces the
  TPU kernels ``paf_sample_scores_fused`` and ``paf_sample_scores`` of
  ``rtpose_tpu/ops/pallas_kernels.py`` together with the candidate
  geometry and the criterion around them: peaks in, scores and validity
  of every candidate limb out;
- :func:`bicubic_refine` (``csrc/bicubic_refine.cu``) replaces
  ``bicubic_refine`` of the same file with the patch gather, coordinate
  epilogue and validity mask around it, and with ``gaussian_filt`` also
  serves the blurred refine that the JAX package runs as
  ``_refine_onehot`` (``rtpose_tpu/ops/peaks.py``);
- :func:`group_people` (``csrc/group_people.cu``) replaces no Pallas
  kernel but the two ``lax.scan``s of ``rtpose_tpu/ops/grouping.py``,
  ``greedy_connections`` and ``assemble_people``, with the compaction
  between them: sorted candidates in, People out, one block per image;
- :func:`gt_maps` (``csrc/gt_maps.cu``) replaces ``gt_maps_pallas`` of
  ``rtpose_tpu/ops/pallas_gt.py`` with the precompute before its
  ``pallas_call``: keypoints in, both maps out, one launch;
- :func:`yuv420_to_bgr` (``csrc/yuv420_to_bgr.cu``) replaces no TPU
  kernel but the colour conversion inside ``cv2.VideoCapture`` (swscale's
  yuv420p -> bgr24 with the stream's matrix and range, then the stream's
  rotation): a decoded video frame's planes in, BGR out, for the video
  reader; :func:`yuv420p10_to_bgr` (``csrc/yuv420p10_to_bgr.cu``) the
  same for 10-bit frames (swscale's yuv420p10le -> bgr24, its scaling
  path with the chroma filtered), :func:`yuv420_general_to_bgr` (the
  same source at 8 bits) for 8-bit frames of an odd height, and
  :func:`yuv420_full_chroma_to_bgr`
  (``csrc/yuv420_full_chroma_to_bgr.cu``) for frames of an odd width
  (swscale's full-chroma output); ``csrc/yuv_planar_to_bgr.cu`` the
  other chroma formats and 12-bit 4:2:0: :func:`yuv422_to_bgr` (8-bit
  4:2:2 of an even height, unscaled), :func:`yuv_planar_general_to_bgr`
  and :func:`yuv_planar_full_chroma_to_bgr` (4:2:2, 4:4:0, 4:4:4 and
  12-bit 4:2:0 on swscale's scaling path) and :func:`gray_to_bgr`
  (4:0:0); :func:`packed_to_bgr` (``csrc/packed_to_bgr.cu``) packed RGB
  (HuffYUV's bgr0, FFV1's bgra, raw bgr24 / rgb24: swscale's byte
  shuffle); :func:`yuv420_frame_to_bgr` picks the one swscale's path at
  the frame's format, chroma format, depth and size calls for
  (:func:`frame_route`).

A wrapper given CPU tensors runs the plain PyTorch version beside it; given
CUDA tensors it launches the kernel or raises.  There is no fallback from
one to the other.  ``<wrapper>.launches`` counts kernel launches (and only
those), so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..native.avcodec import PACKED_FORMATS as PACKED_BYTES
from ..skeleton import (GROUP_PAIRS, GROUP_PAIRS_NET, LIMBS,
                        NUM_GROUP_PAIRS, NUM_LIMBS, NUM_PARTS,
                        NUM_SEED_PAIRS)

STEP_PAF = 10
THRESH_VECTOR_SCORE = 0.05
PATCH = 5          # 5x5 refine window, reference paf_to_pose.py:100
WIN = PATCH // 2
LN100 = 4.6052     # gaussian support cutoff (reference heatmap.py:30)
LIMB_FIELDS = 9    # ax, ay, ux, uy, valid, mnx, mxx, mny, mxy
LIMB_WIDTH = 1.0   # PAF half width in grid units (reference paf.py:22)
MAX_WARP_UPSAMPLE = 64   # the warp refine's rows: 2 per lane
BLUR_SIGMA = 3.0         # the blurred refine (reference paf_to_pose.py:121)
BLUR_TRUNCATE = 4.0      # scipy.ndimage.gaussian_filter's default
BLUR_RADIUS = int(BLUR_TRUNCATE * BLUR_SIGMA + 0.5)   # taps each side: 12
MAX_GT_GRID = 32766      # K4 packs cell indices as 16-bit integers

PAIR_A = np.array([p[0] for p in GROUP_PAIRS], dtype=np.int64)
PAIR_B = np.array([p[1] for p in GROUP_PAIRS], dtype=np.int64)
PAIR_CHX = np.array([c[0] for c in GROUP_PAIRS_NET], dtype=np.int64)
PAIR_CHY = np.array([c[1] for c in GROUP_PAIRS_NET], dtype=np.int64)
LIMB_A = np.array([l[0] for l in LIMBS], dtype=np.int64)
LIMB_B = np.array([l[1] for l in LIMBS], dtype=np.int64)


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
def blur_matrices(factor: int, sigma: float = BLUR_SIGMA,
                  truncate: float = BLUR_TRUNCATE) -> np.ndarray:
    """(3, PATCH*factor, PATCH*factor) separable Gaussian blur matrices
    (copied from rtpose_tpu/ops/peaks.py:99-127).

    B[p] acts on an upsampled patch of extent n = (p+3)*factor as
    scipy.ndimage.gaussian_filter(..., sigma, mode='reflect') along one
    axis; rows and columns >= n are zero, so the invalid region neither
    leaks in nor out.  The reflection folds back inside the band, so
    B[p][i, j] is also zero wherever |i - j| exceeds the radius
    int(truncate * sigma + 0.5): the blurred kernel sums over that band
    only.
    """
    r = int(truncate * sigma + 0.5)
    k = np.arange(-r, r + 1, dtype=np.float64)
    w = np.exp(-0.5 * (k / sigma) ** 2)
    w /= w.sum()
    size = PATCH * factor
    out = np.zeros((3, size, size), dtype=np.float32)
    for p, e in enumerate((3, 4, 5)):
        n = e * factor
        idx = np.arange(n)[:, None] + k[None, :].astype(np.int64)
        # scipy 'reflect' (a a b c | period-2n sawtooth): -1 -> 0, n -> n-1
        idx = np.mod(idx, 2 * n)
        idx = np.where(idx >= n, 2 * n - 1 - idx, idx)
        for j in range(2 * r + 1):
            np.add.at(out[p], (np.arange(n), idx[:, j]), w[j])
    return out


@functools.lru_cache(maxsize=None)
def _interp_matrices_on(device: torch.device, factor: int) -> torch.Tensor:
    return torch.as_tensor(interp_matrices(factor), device=device)


@functools.lru_cache(maxsize=None)
def _blur_matrices_on(device: torch.device, factor: int) -> torch.Tensor:
    return torch.as_tensor(blur_matrices(factor), device=device)


@functools.lru_cache(maxsize=None)
def pair_tables_on(device: torch.device) -> Tuple[torch.Tensor, ...]:
    """PAIR_A, PAIR_B, PAIR_CHX, PAIR_CHY as int64 tensors on `device`,
    copied there once."""
    return tuple(torch.as_tensor(t, device=device)
                 for t in (PAIR_A, PAIR_B, PAIR_CHX, PAIR_CHY))


# ---------------------------------------------------------------------------
# launching
# ---------------------------------------------------------------------------

def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous() \
            or t.device != device:
        raise ValueError(
            f"{name}: expected a contiguous {ndim}-d {dtype} tensor on "
            f"{device}, got {tuple(t.shape)} {t.dtype} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


_lib = None   # the loaded kernel library, its tables checked


def _library():
    """The kernel library, built and checked at the first call only (no
    lock is taken after it)."""
    global _lib
    if _lib is None:
        from . import _build
        lib = _build.load().lib
        _check_tables(lib)
        _lib = lib
    return _lib


def _launch(fn_name: str, device: torch.device, *args) -> None:
    """Call the library's entry `fn_name` with `args` (tensor pointers as
    ints) and the current stream of `device`; raise on its CUDA error."""
    fn = getattr(_library(), fn_name)
    # the raw handle, as PyTorch's generated kernels take it: building a
    # torch.cuda.Stream object per call costs microseconds of host time
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    if device.index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {err} at launch")


def _check_tables(lib) -> None:
    """The skeleton tables compiled into the sources against skeleton.py."""
    for entry, want, what in (
            ("rtpose_pair_tables", (PAIR_A, PAIR_B, PAIR_CHX, PAIR_CHY),
             "csrc/connection_scores.cu pair tables differ from "
             "skeleton.GROUP_PAIRS / GROUP_PAIRS_NET"),
            ("rtpose_limb_tables", (LIMB_A, LIMB_B),
             "csrc/gt_maps.cu limb tables differ from skeleton.LIMBS"),
            ("rtpose_group_tables", (PAIR_A, PAIR_B),
             "csrc/group_people.cu pair tables differ from "
             "skeleton.GROUP_PAIRS")):
        tables = [(ctypes.c_int * len(want[0]))() for _ in want]
        n = getattr(lib, entry)(*tables)
        if n != len(want[0]) or any(list(t) != w.tolist()
                                    for t, w in zip(tables, want)):
            raise RuntimeError(what)


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d, correctly rounded on every device: CUDA computes a tensor
    divided by a Python number as a product with its reciprocal, which
    is an ulp off for some values; a 0-d tensor divisor is a division."""
    return x / x.new_full((), d)


# ---------------------------------------------------------------------------
# connection scoring: candidate geometry, PAF line integral, criterion
# (K1 + K2 with the XLA work around them)
# ---------------------------------------------------------------------------

def candidate_geometry(peak_x: torch.Tensor, peak_y: torch.Tensor,
                       peak_valid: torch.Tensor):
    """Per-candidate sampling geometry of every (pair, ia, ib), from the
    (B, 18, K) peak coordinates and validity.

    Returns (geo, norm, ok): geo (B, 19, 6, K*K) fp32 rows [ax, ay,
    step_x, step_y, ux, uy] in upsampled-frame coordinates, the limb
    lengths (B, 19, K, K) and `ok`, both ends valid and apart.  Each value
    is rounded as JAX rounds it (rtpose_tpu/ops/grouping.py:120-159).
    """
    B, _, K = peak_x.shape
    dev = peak_x.device
    pa, pb = pair_tables_on(dev)[:2]
    ax = peak_x[:, pa].float()                   # (B, 19, K)
    ay = peak_y[:, pa].float()
    bx = peak_x[:, pb].float()
    by = peak_y[:, pb].float()

    dx = bx[:, :, None, :] - ax[:, :, :, None]   # (B, 19, Ka, Kb)
    dy = by[:, :, None, :] - ay[:, :, :, None]
    # torch's CPU sqrt is an ulp off the correctly rounded root for about
    # 1 value in 200; the fp64 root of the exact fp32 sum rounds exactly
    norm = torch.sqrt((dx * dx + dy * dy).double()).float()
    nz = norm >= 1e-12
    safe = norm.clamp(min=1e-12)
    ux = torch.where(nz, dx / safe, 0.0)
    uy = torch.where(nz, dy / safe, 0.0)
    # int(ax + s * (dx / 10) + 0.5): the step first, the reference's
    # exact expression (pafprocess.cpp:223-229)
    step_x = true_div(dx, STEP_PAF)
    step_y = true_div(dy, STEP_PAF)
    C = K * K
    geo = torch.stack([ax[..., None].expand_as(dx).reshape(B, -1, C),
                       ay[..., None].expand_as(dy).reshape(B, -1, C),
                       step_x.reshape(B, -1, C), step_y.reshape(B, -1, C),
                       ux.reshape(B, -1, C), uy.reshape(B, -1, C)], dim=2)
    ok = peak_valid[:, pa, :, None] & peak_valid[:, pb, None, :] & nz
    return geo.contiguous(), norm, ok


def criterion(cnt: torch.Tensor, ssum: torch.Tensor, norm: torch.Tensor,
              ok: torch.Tensor, *, h_up: int, thresh_vector_cnt: int = 6
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample counts and sums (B, 19, K*K) -> (criterion-2 scores, valid),
    (B, 19, K, K): the mean sample score plus the reference's penalty on
    limbs longer than half the map (pafprocess.cpp:84-92)."""
    cnt = cnt.reshape(norm.shape)
    mean = true_div(ssum.reshape(norm.shape), STEP_PAF)
    half = norm.new_full((), 0.5 * h_up)
    crit2 = mean + (half / norm.clamp(min=1e-12) - 1.0).clamp(max=0.0)
    valid = ok & (cnt > thresh_vector_cnt) & (crit2 > 0)
    return crit2, valid


def paf_sample_scores_plain(paf: torch.Tensor, geo: torch.Tensor, *,
                            factor: int = 8
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """10-sample PAF line integral of every candidate limb (a gather).

    paf: (B, h, w, 38) fp32 low-res PAF.
    geo: (B, 19, 6, C) rows of :func:`candidate_geometry`.
    Returns (cnt int32, ssum fp32), each (B, 19, C): the number of samples
    above THRESH_VECTOR_SCORE and their sequential fp32 sum.
    """
    B, h, w, ch = paf.shape
    C = geo.shape[-1]
    ax, ay, step_x, step_y, ux, uy = geo.unbind(2)          # (B, 19, C)
    dev = paf.device
    chx, chy = (t[None, :, None] for t in pair_tables_on(dev)[2:])
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


def connection_scores_plain(paf: torch.Tensor, peak_x: torch.Tensor,
                            peak_y: torch.Tensor, peak_valid: torch.Tensor,
                            *, factor: int = 8, thresh_vector_cnt: int = 6
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`connection_scores`: the candidate
    geometry, the PAF line integral and the criterion, one after the
    other."""
    geo, norm, ok = candidate_geometry(peak_x, peak_y, peak_valid)
    cnt, ssum = paf_sample_scores_plain(paf, geo, factor=factor)
    return criterion(cnt, ssum, norm, ok, h_up=paf.shape[1] * factor,
                     thresh_vector_cnt=thresh_vector_cnt)


def connection_scores(paf: torch.Tensor, peak_x: torch.Tensor,
                      peak_y: torch.Tensor, peak_valid: torch.Tensor, *,
                      factor: int = 8, thresh_vector_cnt: int = 6
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Criterion-2 score and validity of every candidate limb.

    paf: (B, h, w, 38) fp32 low-res PAF.
    peak_x, peak_y: (B, 18, K) int32 peaks in the upsampled frame;
    peak_valid: (B, 18, K) bool.
    Returns (crit2 fp32, valid bool), each (B, 19, K, K) over (pair, ia,
    ib): the mean of ten PAF samples along the limb from peak ia of the
    pair's part A to peak ib of its part B, plus the penalty on limbs
    longer than half the map, and whether the limb is a candidate (both
    peaks valid and apart, more than `thresh_vector_cnt` samples above
    THRESH_VECTOR_SCORE, crit2 > 0).
    """
    if _route(paf) == "cpu":
        return connection_scores_plain(paf, peak_x, peak_y, peak_valid,
                                       factor=factor,
                                       thresh_vector_cnt=thresh_vector_cnt)
    B, h, w, ch = paf.shape
    K = peak_x.shape[-1]
    dev = paf.device
    _check("paf", paf, torch.float32, 4, dev)
    _check("peak_x", peak_x, torch.int32, 3, dev)
    _check("peak_y", peak_y, torch.int32, 3, dev)
    _check("peak_valid", peak_valid, torch.bool, 3, dev)
    if ch != 38 or tuple(peak_x.shape) != (B, NUM_PARTS, K) \
            or peak_y.shape != peak_x.shape \
            or peak_valid.shape != peak_x.shape:
        raise ValueError(f"connection_scores: paf {tuple(paf.shape)}, peaks "
                         f"{tuple(peak_x.shape)} / {tuple(peak_y.shape)} / "
                         f"{tuple(peak_valid.shape)} do not match "
                         f"(B,h,w,38) and (B,18,K)")
    crit2 = torch.empty((B, NUM_GROUP_PAIRS, K, K), dtype=torch.float32,
                        device=dev)
    valid = torch.empty((B, NUM_GROUP_PAIRS, K, K), dtype=torch.bool,
                        device=dev)
    if B * K:
        _launch("rtpose_connection_scores", dev, paf.data_ptr(),
                peak_x.data_ptr(), peak_y.data_ptr(), peak_valid.data_ptr(),
                crit2.data_ptr(), valid.data_ptr(), B, K, h, w, factor,
                0.5 * h * factor, thresh_vector_cnt)
        connection_scores.launches += 1
    return crit2, valid


connection_scores.launches = 0


# ---------------------------------------------------------------------------
# bicubic sub-pixel refine (K3 with the XLA work around it)
# ---------------------------------------------------------------------------

def window_origin(py: torch.Tensor, px: torch.Tensor, H: int, W: int):
    """Top-left corner and extents of each peak's clipped 5x5 window."""
    y_min = (py - WIN).clamp(min=0)
    x_min = (px - WIN).clamp(min=0)
    ph = (py + WIN).clamp(max=H - 1) - y_min + 1
    pw = (px + WIN).clamp(max=W - 1) - x_min + 1
    return y_min, x_min, ph, pw


def bicubic_refine_plain(heat: torch.Tensor, py: torch.Tensor,
                         px: torch.Tensor, valid: torch.Tensor, *,
                         factor: int = 8, gaussian_filt: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`bicubic_refine`: the per-peak
    ``_refine`` of rtpose_tpu/ops/peaks.py:154-201, batched, with
    `gaussian_filt` the blur of ``_refine_onehot`` (:249-257), then the
    coordinate epilogue and the validity mask, in the kernel's order."""
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
    if gaussian_filt:
        # up = By @ up @ Bx^T, summed term by term in the kernel's order
        blur = _blur_matrices_on(dev, factor)               # (3, n, n)
        by_mat = blur[ph - 3]                               # (B, P, K, n, n)
        bx_mat = blur[pw - 3]
        by_up = by_mat[..., 0:1] * up[..., 0:1, :]
        for r in range(1, n):
            by_up = by_up + by_mat[..., r:r + 1] * up[..., r:r + 1, :]
        up = by_up[..., 0:1] * bx_mat[..., None, :, 0]
        for c in range(1, n):
            up = up + by_up[..., c:c + 1] * bx_mat[..., None, :, c]
    i = torch.arange(n, device=dev)
    region = (i[:, None] < (ph * factor)[..., None, None]) & \
        (i[None, :] < (pw * factor)[..., None, None])
    masked = torch.where(region, up, -torch.inf).reshape(B, P, K, n * n)
    score = masked.amax(dim=-1)
    # first (lowest row-major) index of the maximum, as numpy's argmax
    cells = torch.arange(n * n, dtype=torch.int32, device=dev)
    flat = torch.where(masked == score[..., None], cells, n * n).amin(dim=-1)
    my, mx = flat // n, flat % n
    cy = (py - y_min + 0.5) * factor - 0.5
    cx = (px - x_min + 0.5) * factor - 0.5
    yf = (py + 0.5) * factor - 0.5 + (my - cy)
    xf = (px + 0.5) * factor - 0.5 + (mx - cx)
    return (torch.where(valid, xf, 0.0), torch.where(valid, yf, 0.0),
            torch.where(valid, score, 0.0))


def bicubic_refine(heat: torch.Tensor, py: torch.Tensor, px: torch.Tensor,
                   valid: torch.Tensor, *, factor: int = 8,
                   gaussian_filt: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sub-pixel refine of every peak.

    heat: (B, P, H, W) fp32 maps; py, px: (B, P, K) int32 peak cells;
    valid: (B, P, K) bool, the slots that hold a peak.
    Returns (xf, yf, score), each (B, P, K) fp32: the refined peak in the
    x`factor` upsampled frame, at the row-major first argmax of its
    bicubic-upsampled clipped 5x5 window, and the value there; zeros where
    `valid` is False.  With `gaussian_filt` the upsampled window is
    blurred (sigma 3, reflect) before the argmax.
    """
    if _route(heat) == "cpu":
        return bicubic_refine_plain(heat, py, px, valid, factor=factor,
                                    gaussian_filt=gaussian_filt)
    B, P, H, W = heat.shape
    K = py.shape[-1]
    dev = heat.device
    _check("heat", heat, torch.float32, 4, dev)
    _check("py", py, torch.int32, 3, dev)
    _check("px", px, torch.int32, 3, dev)
    _check("valid", valid, torch.bool, 3, dev)
    if H < 3 or W < 3 or tuple(py.shape) != (B, P, K) \
            or px.shape != py.shape or valid.shape != py.shape:
        raise ValueError(f"bicubic_refine: heat {tuple(heat.shape)} needs "
                         f"H, W >= 3 and peaks of shape (B, P, K), got "
                         f"{tuple(py.shape)} / {tuple(px.shape)} / "
                         f"{tuple(valid.shape)}")
    if not gaussian_filt and PATCH * factor > MAX_WARP_UPSAMPLE:
        raise ValueError(f"bicubic_refine: factor {factor} upsamples the "
                         f"window past {MAX_WARP_UPSAMPLE} rows")
    mats = _interp_matrices_on(dev, factor)
    blur = _blur_matrices_on(dev, factor).data_ptr() if gaussian_filt else 0
    xf, yf, score = torch.empty((3, B, P, K), dtype=torch.float32,
                                device=dev).unbind(0)
    if B * P * K:
        _launch("rtpose_refine_peaks", dev, heat.data_ptr(), py.data_ptr(),
                px.data_ptr(), valid.data_ptr(), mats.data_ptr(), blur,
                xf.data_ptr(), yf.data_ptr(), score.data_ptr(), B * P * K, K,
                H, W, factor, int(gaussian_filt), BLUR_RADIUS)
        bicubic_refine.launches += 1
        bicubic_refine.gaussian_filt_launches += int(gaussian_filt)
    return xf, yf, score


bicubic_refine.launches = 0
bicubic_refine.gaussian_filt_launches = 0   # those of them in the blurred mode


# ---------------------------------------------------------------------------
# ground-truth heatmaps and PAFs (K4)
# ---------------------------------------------------------------------------

def _gt_constants(stride: float, sigma: float):
    """Cell-centre offset and 1/(2 sigma^2), rounded to fp32 as the JAX
    kernel's Python scalars are."""
    start = float(np.float32(stride / 2.0 - 0.5))
    inv2s = float(np.float32(1.0 / (2.0 * sigma * sigma)))
    return start, inv2s


def person_bound(keypoints: torch.Tensor) -> torch.Tensor:
    """(B, N, 18, 3) -> (B,) int32: 1 + index of the last person with a
    visible part (0 for none), robust to invisible rows in the middle of
    the padding (pallas_gt.py:141-145)."""
    B, N = keypoints.shape[:2]
    dev = keypoints.device
    if N == 0:
        return torch.zeros(B, dtype=torch.int32, device=dev)
    any_v = (keypoints[..., 2] > 0.5).any(dim=-1)                 # (B, N)
    slots = torch.arange(1, N + 1, device=dev)
    return torch.where(any_v, slots, 0).amax(dim=-1).to(torch.int32)


def limb_scalars(keypoints: torch.Tensor, stride: int,
                 limb_width: float = LIMB_WIDTH) -> torch.Tensor:
    """(B, N, 18, 3) keypoints -> (B, N, 19, 9) limb scalars [ax, ay, ux,
    uy, valid, mnx, mxx, mny, mxy] in grid units (pallas_gt.py:152-171).

    ``torch.round`` rounds half to even, as ``jnp.round`` does.
    """
    kp = keypoints
    vis = kp[..., 2] > 0.5
    a = torch.as_tensor(LIMB_A, device=kp.device)
    b = torch.as_tensor(LIMB_B, device=kp.device)
    ax = true_div(kp[:, :, a, 0], stride)                        # (B, N, 19)
    ay = true_div(kp[:, :, a, 1], stride)
    bx = true_div(kp[:, :, b, 0], stride)
    by = true_div(kp[:, :, b, 1], stride)
    both = vis[:, :, a] & vis[:, :, b]
    vx = bx - ax
    vy = by - ay
    # the correctly rounded root of jnp.sqrt and CUDA's sqrtf: torch's CPU
    # sqrt (MKL's vector library) is an ulp off for about 1 value in 200,
    # and an ulp in (ux, uy) can move a cell across the limb-width test
    norm = (vx * vx + vy * vy).double().sqrt().float()
    lv = (both & (norm > 0)).to(torch.float32)
    un = norm.clamp(min=1e-12)
    ux = vx / un
    uy = vy / un
    mnx = torch.round(torch.minimum(ax, bx) - limb_width)
    mxx = torch.round(torch.maximum(ax, bx) + limb_width)
    mny = torch.round(torch.minimum(ay, by) - limb_width)
    mxy = torch.round(torch.maximum(ay, by) + limb_width)
    return torch.stack([ax, ay, ux, uy, lv, mnx, mxx, mny, mxy],
                       dim=-1).contiguous()


def gt_maps_plain(keypoints: torch.Tensor, limbs: torch.Tensor,
                  n_persons: torch.Tensor, *, grid_y: int, grid_x: int,
                  stride: float, sigma: float,
                  limb_width: float = LIMB_WIDTH
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`gt_maps` after :func:`limb_scalars`
    and :func:`person_bound`: a loop over the N person slots, each term
    computed and summed in the kernel's order."""
    B, N = keypoints.shape[:2]
    dev = keypoints.device
    f32 = torch.float32
    start, inv2s = _gt_constants(stride, sigma)
    gx = torch.arange(grid_x, dtype=f32, device=dev)[None, None, None, :]
    gy = torch.arange(grid_y, dtype=f32, device=dev)[None, None, :, None]
    xx = gx * float(stride) + start
    yy = gy * float(stride) + start
    ln100 = float(np.float32(LN100))
    lw = float(np.float32(limb_width))
    heat = torch.zeros((B, NUM_PARTS, grid_y, grid_x), dtype=f32, device=dev)
    sx = torch.zeros((B, NUM_LIMBS, grid_y, grid_x), dtype=f32, device=dev)
    sy = torch.zeros_like(sx)
    cnt = torch.zeros_like(sx)
    for p in range(N):
        active = (n_persons > p)[:, None, None, None]
        kx, ky, kv = (keypoints[:, p, :, i, None, None] for i in range(3))
        dx = xx - kx
        dy = yy - ky
        expo = (dx * dx + dy * dy) * inv2s
        heat = heat + torch.where(active & (expo <= ln100) & (kv > 0.5),
                                  torch.exp(-expo), 0.0)
        ax, ay, ux, uy, lv, mnx, mxx, mny, mxy = (
            limbs[:, p, :, i, None, None] for i in range(LIMB_FIELDS))
        perp = ((gx - ax) * uy - (gy - ay) * ux).abs()
        m = (active & (perp < lw) & (gx >= mnx) & (gx < mxx) & (gy >= mny)
             & (gy < mxy) & (lv > 0.5))
        sx = sx + torch.where(m, ux, 0.0)
        sy = sy + torch.where(m, uy, 0.0)
        cnt = cnt + m.to(f32)
    bg = (1.0 - heat.amax(dim=1).clamp(min=0.0)).clamp(min=0.0)
    heat = torch.cat([heat.clamp(max=1.0), bg[:, None]], dim=1)
    div = cnt.clamp(min=1.0)
    paf = torch.stack([sx / div, sy / div], dim=2).reshape(
        B, 2 * NUM_LIMBS, grid_y, grid_x)
    return heat.permute(0, 2, 3, 1).contiguous(), \
        paf.permute(0, 2, 3, 1).contiguous()


def gt_maps(keypoints: torch.Tensor, *, grid_y: int, grid_x: int,
            stride: float, sigma: float, limb_width: float = LIMB_WIDTH
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ground-truth part heatmaps and PAFs of a batch.

    keypoints: (B, N, 18, 3) fp32 [x, y, v] in input pixels.
    Returns heat (B, grid_y, grid_x, 19) and PAF (B, grid_y, grid_x, 38),
    fp32: Gaussian parts clipped at 1 plus the background, and unit
    vectors averaged over overlapping limbs (channels 2l, 2l+1), over the
    image's persons up to the last one with a visible part.  On the card
    the person bound and the limb scalars are computed inside the kernel;
    the plain version takes them from :func:`person_bound` and
    :func:`limb_scalars`.
    """
    if _route(keypoints) == "cpu":
        return gt_maps_plain(keypoints, limb_scalars(keypoints, stride,
                                                     limb_width),
                             person_bound(keypoints), grid_y=grid_y,
                             grid_x=grid_x, stride=stride, sigma=sigma,
                             limb_width=limb_width)
    dev = keypoints.device
    _check("keypoints", keypoints, torch.float32, 4, dev)
    B, N = keypoints.shape[:2]
    if tuple(keypoints.shape[2:]) != (NUM_PARTS, 3):
        raise ValueError(f"gt_maps: keypoints {tuple(keypoints.shape)} do "
                         f"not match (B,N,18,3)")
    if max(grid_y, grid_x) > MAX_GT_GRID:
        raise ValueError(f"gt_maps: a {grid_y}x{grid_x} grid is past "
                         f"{MAX_GT_GRID} cells a side")
    start, inv2s = _gt_constants(stride, sigma)
    heat = torch.empty((B, grid_y, grid_x, NUM_LIMBS), dtype=torch.float32,
                       device=dev)
    paf = torch.empty((B, grid_y, grid_x, 2 * NUM_LIMBS),
                      dtype=torch.float32, device=dev)
    if B * grid_y * grid_x:
        _launch("rtpose_gt_maps", dev, keypoints.data_ptr(), heat.data_ptr(),
                paf.data_ptr(), B, N, grid_y, grid_x, float(stride), start,
                inv2s, float(limb_width))
        gt_maps.launches += 1
    return heat, paf


gt_maps.launches = 0


# ---------------------------------------------------------------------------
# greedy matching and person assembly (the two lax.scans of the JAX decode)
# ---------------------------------------------------------------------------

def greedy_plain(sorted_scores: torch.Tensor, sorted_idx: torch.Tensor,
                 K: int, max_conns: int):
    """Greedy 1-1 assignment per pair over the stably sorted candidates
    (B, 19, K*K), invalid ones -inf: the scan of JAX
    ``greedy_connections`` (grouping.py:248-284) as a torch loop over the
    top-C steps, vectorised over images and pairs.

    Returns (conn_ia, conn_ib, conn_score, conn_valid), each (B, 19, K) in
    pair-major acceptance order, and `overflow` (B,): a pair had more
    valid candidates than the C window.
    """
    B, P, KK = sorted_scores.shape
    dev = sorted_scores.device
    C = min(max_conns, KK)
    if C < KK:   # valid candidates sort first: the one at C is valid
        overflow = (sorted_scores[..., C] > -torch.inf).any(-1)
    else:
        overflow = torch.zeros((B,), dtype=torch.bool, device=dev)
    top_scores = sorted_scores[..., :C]
    top_idx = sorted_idx[..., :C]
    top_ia = torch.div(top_idx, K, rounding_mode="floor")
    top_ib = top_idx % K
    top_valid = torch.isfinite(top_scores)

    used_a = torch.zeros((B, P, K), dtype=torch.bool, device=dev)
    used_b = torch.zeros((B, P, K), dtype=torch.bool, device=dev)
    # valid candidates sort first, so no step past the longest valid run
    # of any (image, pair) can accept: one read-back of that length bounds
    # the loop, whose body never reads back
    n_steps = int((top_scores > -torch.inf).sum(-1).max()) \
        if top_scores.numel() else 0
    accepted = []
    for c in range(n_steps):
        ia = top_ia[..., c:c + 1]
        ib = top_ib[..., c:c + 1]
        ua = used_a.gather(-1, ia)
        ub = used_b.gather(-1, ib)
        ok = top_valid[..., c:c + 1] & ~ua & ~ub
        used_a.scatter_(-1, ia, ua | ok)
        used_b.scatter_(-1, ib, ub | ok)
        accepted.append(ok)
    accepted.append(torch.zeros((B, P, C - n_steps), dtype=torch.bool,
                                device=dev))
    acc = torch.cat(accepted, dim=-1)                        # (B, 19, C)
    # slot of an accepted candidate = number accepted before it; K = drop
    slots = torch.where(acc, acc.long().cumsum(-1) - 1, K)

    def place(values, fill, dtype):
        out = torch.full((B, P, K + 1), fill, dtype=dtype, device=dev)
        out.scatter_(-1, slots, torch.where(acc, values, fill).to(dtype))
        return out[..., :K]

    return (place(top_ia, 0, torch.int64), place(top_ib, 0, torch.int64),
            place(top_scores, 0.0, torch.float32),
            place(acc, False, torch.bool), overflow)


def assemble_plain(conn_ia, conn_ib, conn_score, conn_valid,
                   peak_x: torch.Tensor, peak_y: torch.Tensor,
                   peak_score: torch.Tensor, peak_truncated: torch.Tensor, *,
                   max_people: int = 64, min_part_cnt: int = 4,
                   min_human_score: float = 0.3, max_total_conns: int = 160,
                   extra_truncated=None):
    """Sequential person assembly (reference pafprocess.cpp:127-191), the
    scan of JAX ``assemble_people`` (grouping.py:343-430) as a torch loop.

    Consumes connections in (pair, acceptance-slot) order, one step per
    entry of the compacted list, for all images at once.  Each step is the
    JAX scan body with its one-hot blends written as selects: the blends
    add exact zeros, so the values are the same.  Returns the People
    fields (coords, part_score, score, valid, truncated).
    """
    B, P, K = conn_ia.shape
    Pp = max_people
    dev = conn_ia.device
    score_flat = peak_score.reshape(B, -1)         # (B, 18*K)
    x_flat = peak_x.reshape(B, -1)
    y_flat = peak_y.reshape(B, -1)

    part_a, part_b = pair_tables_on(dev)[:2]
    gid1 = part_a[:, None] * K + conn_ia           # (B, 19, K) 0-based ids
    gid2 = part_b[:, None] * K + conn_ib
    cid1 = (gid1 + 1).float()
    cid2 = (gid2 + 1).float()
    ps1 = score_flat.gather(1, gid1.reshape(B, -1))
    ps2 = score_flat.gather(1, gid2.reshape(B, -1))

    # compact the (19, K) connections into a length-M list, order kept
    M = min(max_total_conns, P * K)
    flat_valid = conn_valid.reshape(B, -1)
    conn_overflow = flat_valid.sum(-1) > M
    pos = flat_valid.long().cumsum(-1) - 1
    pos = torch.where(flat_valid & (pos < M), pos, M)

    def compact(x, fill):
        x = x.reshape(B, -1)
        out = torch.full((B, M + 1), fill, dtype=x.dtype, device=dev)
        return out.scatter_(1, pos, x)[:, :M]

    pair_of = torch.arange(P, device=dev).repeat_interleave(K).expand(B, -1)
    c_pair = compact(pair_of, NUM_GROUP_PAIRS)
    c_k1 = compact(cid1, 0.0)
    c_k2 = compact(cid2, 0.0)
    c_s12 = compact(ps1, 0.0) + compact(ps2, 0.0)   # s1p + s2p (new rows)
    c_ps2 = compact(ps2, 0.0)
    c_score = compact(conn_score, 0.0)
    c_valid = compact(flat_valid, False)
    pair_c = c_pair.clamp(max=NUM_GROUP_PAIRS - 1)
    c_p1 = part_a[pair_c]                           # (B, M)
    c_p2 = part_b[pair_c]
    c_seed = c_pair < NUM_SEED_PAIRS
    new_s18 = c_s12 + c_score                       # (s1p + s2p) + cscore
    ext_s18 = c_ps2 + c_score                       # s2p + cscore

    subset = torch.full((B, Pp, 20), -1.0, device=dev)
    subset[..., 19] = 0.0                            # count 0 == dead row
    next_slot = torch.zeros((B,), dtype=torch.int64, device=dev)
    dropped = torch.zeros((B,), dtype=torch.bool, device=dev)
    rows = torch.arange(Pp, device=dev)
    cols = torch.arange(20, device=dev)
    dead = torch.full((20,), -1.0, device=dev)
    dead[19] = 0.0
    body = cols < NUM_PARTS
    # entries past an image's valid connections change nothing: loop only
    # as far as the longest valid list of the batch (one read-back)
    n_steps = int(flat_valid.sum(-1).clamp(max=M).max()) if B else 0
    for m in range(n_steps):
        p1 = c_p1[:, m]
        p2 = c_p2[:, m]
        k1 = c_k1[:, m, None]
        k2 = c_k2[:, m, None]
        cvalid = c_valid[:, m]
        col1 = subset.gather(2, p1[:, None, None].expand(B, Pp, 1))[..., 0]
        col2 = subset.gather(2, p2[:, None, None].expand(B, Pp, 1))[..., 0]
        match = (subset[..., 19] > 0) & ((col1 == k1) | (col2 == k2))
        found = match.sum(1)
        # first / second matching row (0 when none, like jnp.argmax)
        first = torch.where(match, rows, Pp).amin(1)
        s1 = torch.where(first < Pp, first, 0)
        second = torch.where(match & (rows != s1[:, None]), rows, Pp).amin(1)
        s2 = torch.where(second < Pp, second, 0)
        r1 = subset.gather(1, s1[:, None, None].expand(B, 1, 20))[:, 0]
        r2 = subset.gather(1, s2[:, None, None].expand(B, 1, 20))[:, 0]
        membership = ((r1[:, :NUM_PARTS] > 0)
                      & (r2[:, :NUM_PARTS] > 0)).any(1)

        can_new = next_slot < Pp
        seed_miss = cvalid & (found == 0) & c_seed[:, m]
        b_new = seed_miss & can_new
        b_ext1 = cvalid & (found == 1)
        b_ext2 = cvalid & (found == 2) & membership
        b_merge = cvalid & (found == 2) & ~membership
        r1_p2 = r1.gather(1, p2[:, None])
        do_set = b_ext2 | (b_ext1 & (r1_p2[:, 0] != k2[:, 0]))

        is_p1 = cols == p1[:, None]                   # (B, 20)
        is_p2 = cols == p2[:, None]
        new_row = torch.where(is_p1, k1, torch.where(is_p2, k2, -1.0))
        new_row[:, 18] = new_s18[:, m]
        new_row[:, 19] = 2.0
        ext_row = torch.where(is_p2, k2, r1)
        ext_row[:, 18] = r1[:, 18] + ext_s18[:, m]
        ext_row[:, 19] = r1[:, 19] + 1.0
        merged = torch.where(body, r1 + (r2 + 1.0), r1)
        merged[:, 18] = r1[:, 18] + (r2[:, 18] + c_score[:, m])
        merged[:, 19] = r1[:, 19] + r2[:, 19]

        # new / extend / merge are exclusive (found == 0 vs >= 1): one
        # row write covers all three, then the merge kills row s2
        target = torch.where(b_new, next_slot.clamp(max=Pp - 1), s1)
        value = torch.where(b_new[:, None], new_row,
                            torch.where(do_set[:, None], ext_row, merged))
        write = (b_new | do_set | b_merge)[:, None] & \
            (rows == target[:, None])
        subset = torch.where(write[..., None], value[:, None, :], subset)
        kill = b_merge[:, None] & (rows == s2[:, None])
        subset = torch.where(kill[..., None], dead, subset)

        next_slot = next_slot + b_new.long()
        dropped = dropped | (seed_miss & ~can_new)

    count = subset[..., 19]
    ssum = subset[..., 18]
    per_part = ssum / count.clamp(min=1.0)
    person_valid = ((count >= min_part_cnt) & (per_part >= min_human_score)
                    & (count > 0))
    cids = subset[..., :NUM_PARTS].to(torch.int32)  # 1-based or -1
    has = cids > 0
    flat_cid = (cids.long() - 1).clamp(0, NUM_PARTS * K - 1).reshape(B, -1)
    xs = x_flat.gather(1, flat_cid).reshape(has.shape)
    ys = y_flat.gather(1, flat_cid).reshape(has.shape)
    coords = torch.stack([torch.where(has, xs, -1), torch.where(has, ys, -1)],
                         dim=-1).to(torch.int32)
    part_score = torch.where(
        has, score_flat.gather(1, flat_cid).reshape(has.shape), 0.0)
    truncated = peak_truncated | conn_overflow | dropped
    if extra_truncated is not None:
        truncated = truncated | extra_truncated
    return coords, part_score, per_part, person_valid, truncated


def group_people_plain(sorted_scores: torch.Tensor, sorted_idx: torch.Tensor,
                       peak_x: torch.Tensor, peak_y: torch.Tensor,
                       peak_score: torch.Tensor, peak_truncated: torch.Tensor,
                       *, max_candidates: int = 256, max_people: int = 64,
                       max_total_conns: int = 160, min_part_cnt: int = 4,
                       min_human_score: float = 0.3):
    """Plain PyTorch version of :func:`group_people`: the greedy loop, then
    the assembly loop, each bounded by one read-back."""
    *conns, cand_overflow = greedy_plain(sorted_scores, sorted_idx,
                                         peak_x.shape[-1], max_candidates)
    return assemble_plain(*conns, peak_x, peak_y, peak_score, peak_truncated,
                          max_people=max_people, min_part_cnt=min_part_cnt,
                          min_human_score=min_human_score,
                          max_total_conns=max_total_conns,
                          extra_truncated=cand_overflow)


GROUP_MAX_K = 128        # csrc/group_people.cu MAX_K: two 64-bit used sets
GROUP_MAX_PEOPLE = 256   # ... MAX_PEOPLE: four 64-bit words of row mask


def group_smem_bytes(K: int, max_people: int, max_total_conns: int) -> int:
    """Dynamic shared memory a block of the grouping kernel takes for K
    peaks per part, `max_people` rows and `max_total_conns` steps (the
    kernel's own layout; above 48 KB it asks the card for more)."""
    return _library().rtpose_group_smem_bytes(
        K, max_people, min(max_total_conns, NUM_GROUP_PAIRS * K))


def group_people(sorted_scores: torch.Tensor, sorted_idx: torch.Tensor,
                 peak_x: torch.Tensor, peak_y: torch.Tensor,
                 peak_score: torch.Tensor, peak_truncated: torch.Tensor, *,
                 max_candidates: int = 256, max_people: int = 64,
                 max_total_conns: int = 160, min_part_cnt: int = 4,
                 min_human_score: float = 0.3, phase_cycles=None):
    """Greedy 1-1 matching and person assembly, sorted candidates in,
    People fields out.

    sorted_scores: (B, 19, K*K) fp32 criterion scores of every pair's
    candidates, invalid ones -inf, sorted descending and stably (ties to
    the lower flat index ia*K + ib, ``lax.top_k``'s order);
    sorted_idx: (B, 19, K*K) int64, their flat indices.
    peak_x, peak_y: (B, 18, K) int32; peak_score: (B, 18, K) fp32;
    peak_truncated: (B,) bool.
    Returns (coords (B, Pp, 18, 2) int32, part_score (B, Pp, 18) fp32,
    score (B, Pp) fp32, valid (B, Pp) bool, truncated (B,) bool) with Pp
    = `max_people`: the greedy scan over each pair's top
    C = min(max_candidates, K*K) candidates, the assembly over the first
    M = min(max_total_conns, 19*K) accepted connections in (pair, slot)
    order, and `truncated` where peaks, candidates, connections or people
    overflowed a cap.  On the card this is one launch of
    ``csrc/group_people.cu``, for K up to 128 and Pp up to 256; given
    `phase_cycles`, a (B, 4) int64 tensor on the card, each block also
    writes there the SM cycles of its greedy scan, the walk's set-up, the
    assembly chain and the epilogue (for timing; the CPU path rejects it).
    """
    if _route(sorted_scores) == "cpu":
        if phase_cycles is not None:
            raise ValueError("group_people: phase_cycles times the kernel; "
                             "the plain version has no phases")
        return group_people_plain(
            sorted_scores, sorted_idx, peak_x, peak_y, peak_score,
            peak_truncated, max_candidates=max_candidates,
            max_people=max_people, max_total_conns=max_total_conns,
            min_part_cnt=min_part_cnt, min_human_score=min_human_score)
    B, P, KK = sorted_scores.shape
    K = peak_x.shape[-1]
    dev = sorted_scores.device
    _check("sorted_scores", sorted_scores, torch.float32, 3, dev)
    _check("sorted_idx", sorted_idx, torch.int64, 3, dev)
    _check("peak_x", peak_x, torch.int32, 3, dev)
    _check("peak_y", peak_y, torch.int32, 3, dev)
    _check("peak_score", peak_score, torch.float32, 3, dev)
    _check("peak_truncated", peak_truncated, torch.bool, 1, dev)
    if P != NUM_GROUP_PAIRS or KK != K * K \
            or tuple(peak_x.shape) != (B, NUM_PARTS, K) \
            or peak_y.shape != peak_x.shape \
            or peak_score.shape != peak_x.shape \
            or tuple(peak_truncated.shape) != (B,) \
            or sorted_idx.shape != sorted_scores.shape:
        raise ValueError(f"group_people: candidates "
                         f"{tuple(sorted_scores.shape)} / "
                         f"{tuple(sorted_idx.shape)}, peaks "
                         f"{tuple(peak_x.shape)}, truncated "
                         f"{tuple(peak_truncated.shape)} do not match "
                         f"(B,19,K*K), (B,18,K) and (B,)")
    if K > GROUP_MAX_K or not 1 <= max_people <= GROUP_MAX_PEOPLE:
        raise ValueError(f"group_people: the kernel takes K <= {GROUP_MAX_K} "
                         f"peaks per part and 1 to {GROUP_MAX_PEOPLE} people,"
                         f" got K={K}, max_people={max_people}")
    if phase_cycles is not None:
        _check("phase_cycles", phase_cycles, torch.int64, 2, dev)
        if tuple(phase_cycles.shape) != (B, 4):
            raise ValueError(f"group_people: phase_cycles "
                             f"{tuple(phase_cycles.shape)}, not ({B}, 4)")
    C = min(max_candidates, KK)
    M = min(max_total_conns, NUM_GROUP_PAIRS * K)
    coords = torch.empty((B, max_people, NUM_PARTS, 2), dtype=torch.int32,
                         device=dev)
    part_score = torch.empty((B, max_people, NUM_PARTS), dtype=torch.float32,
                             device=dev)
    score = torch.empty((B, max_people), dtype=torch.float32, device=dev)
    valid = torch.empty((B, max_people), dtype=torch.bool, device=dev)
    truncated = torch.empty((B,), dtype=torch.bool, device=dev)
    if B:
        _launch("rtpose_group_people", dev, sorted_scores.data_ptr(),
                sorted_idx.data_ptr(), peak_x.data_ptr(), peak_y.data_ptr(),
                peak_score.data_ptr(), peak_truncated.data_ptr(),
                coords.data_ptr(), part_score.data_ptr(), score.data_ptr(),
                valid.data_ptr(), truncated.data_ptr(), B, K, C, M,
                max_people, min_part_cnt, float(min_human_score),
                None if phase_cycles is None else phase_cycles.data_ptr())
        group_people.launches += 1
    return coords, part_score, score, valid, truncated


group_people.launches = 0

# ---------------------------------------------------------------------------
# video frames: 4:2:0 planes to BGR with a quarter turn (cv2's conversion)
# ---------------------------------------------------------------------------

ROTATIONS = (0, 90, 180, 270)
# swscale's inverse tables (ff_yuv2rgb_coeffs: V->R, U->B, U->G, V->G in
# 1/65536 of limited-range 8-bit values), by the H.273 matrix
# (``matrix_coefficients``, ``AVColorSpace``) as sws_getCoefficients maps it
_BT601 = (104597, 132201, 25675, 53279)
SWS_MATRICES = {1: (117489, 138438, 13975, 34925),     # BT.709
                2: _BT601, 5: _BT601, 6: _BT601,       # unspecified, 601
                4: (104448, 132798, 24759, 53109),     # FCC
                7: (117579, 136230, 16907, 35559),     # SMPTE 240M
                9: (110013, 140363, 12277, 42626)}     # BT.2020 NCL
MATRIX_NAMES = {0: "GBR (identity)", 1: "BT.709", 2: "unspecified (BT.601)",
                3: "reserved", 4: "FCC", 5: "BT.470BG (BT.601)",
                6: "SMPTE 170M (BT.601)", 7: "SMPTE 240M", 8: "YCgCo",
                9: "BT.2020 NCL", 10: "BT.2020 CL", 11: "SMPTE 2085",
                12: "chroma-derived NCL", 13: "chroma-derived CL",
                14: "ICtCp"}


class YuvRule(NamedTuple):
    """swscale's integer constants for one (matrix, range), as
    ``ff_yuv2rgb_c_init_tables`` derives them (contrast and saturation
    1, brightness 0): the 16-bit coefficients of its SIMD paths (luma,
    U->B, U->G, V->G, V->R; ``y_offset`` the luma offset in 8x units) and
    those of its table path (``cy`` the luma step, ``y_base`` the luma
    table's origin, the chroma terms scaled by ``cy``)."""
    matrix: int
    full: bool
    luma: int
    ub: int
    ug: int
    vg: int
    vr: int
    y_offset: int
    cy: int
    y_base: int
    bu: int
    gu: int
    gv: int
    rv: int


def _c_div(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


@functools.lru_cache(maxsize=None)
def yuv_rule(matrix: int = 2, full: bool = False) -> YuvRule:
    """The :class:`YuvRule` of a stream's matrix and range; raises
    ValueError naming a matrix swscale has no table for (cv2 5.0 refuses
    those streams' frames, or converts them as another matrix)."""
    if matrix not in SWS_MATRICES:
        raise ValueError(f"a video stream of colour matrix {matrix} "
                         f"({MATRIX_NAMES.get(matrix, 'unknown')}): BT.601, "
                         f"BT.709, FCC, SMPTE 240M and BT.2020 NCL are "
                         f"converted (ROADMAP.md queue 1 item 4i)")
    crv, cbu, cgu, cgv = SWS_MATRICES[matrix]
    cgu, cgv = -cgu, -cgv
    if full:
        cy, oy = 1 << 16, 0
        crv, cbu, cgu, cgv = (_c_div(c * 224, 255)
                              for c in (crv, cbu, cgu, cgv))
    else:
        cy, oy = (1 << 16) * 255 // 219, 16 << 16

    def simd(c: int, shift: int = 13) -> int:    # roundToInt16(c * 2^shift)
        return ((c << shift) + (1 << 15)) >> 16

    def table(c: int) -> int:                   # scaled by cy
        return _c_div(c * 65536 + 0x8000, cy)

    yoffs = 384 if full else 326
    return YuvRule(matrix, bool(full), simd(cy), simd(cbu), simd(cgu),
                   simd(cgv), simd(crv), simd(oy, 3), cy,
                   yoffs * cy - (384 << 16) - oy, table(cbu), table(cgu),
                   table(cgv), table(crv))


BT601_LIMITED = yuv_rule(2, False)


class _RuleArg(ctypes.Structure):
    """:class:`YuvRule` as the kernels take it, by value."""
    _fields_ = [(name, ctypes.c_int) for name in YuvRule._fields]


def _rule_arg(rule: YuvRule) -> _RuleArg:
    return _RuleArg(*(int(v) for v in rule))


def _turn(bgr: torch.Tensor, rotation: int) -> torch.Tensor:
    turns = {0: 0, 90: -1, 180: 2, 270: 1}[rotation]   # rot90 turns left
    return torch.rot90(bgr, turns, dims=(0, 1)).contiguous()


# chroma formats by their log2 subsampling (horizontal, vertical), as
# FFmpeg's pixel formats state them (log2_chroma_w, log2_chroma_h); 4:0:0
# (gray) has no chroma planes: None
CHROMA_420, CHROMA_422, CHROMA_440, CHROMA_444 = (1, 1), (1, 0), (0, 1), (0, 0)
CHROMA_NAMES = {CHROMA_420: "4:2:0", CHROMA_422: "4:2:2",
                CHROMA_440: "4:4:0", CHROMA_444: "4:4:4", None: "4:0:0"}


def chroma_shape(chroma, height: int, width: int) -> Tuple[int, int]:
    """(rows, columns) of a chroma plane of a height x width picture."""
    sx, sy = chroma
    return -(-height >> sy), -(-width >> sx)


def _check_planes(name: str, y, u, v, width: int, rotation: int,
                  chroma=CHROMA_420) -> int:
    if rotation not in ROTATIONS:
        raise ValueError(f"rotation {rotation} is not one of {ROTATIONS}")
    h = y.shape[0] if y.dim() == 2 else -1
    bad = y.dim() != 2 or width > y.shape[1] or width <= 0 or h <= 0
    if chroma is None:
        bad = bad or u is not None or v is not None
    else:
        rows, cols = chroma_shape(chroma, h, width)
        bad = (bad or u is None or v is None or u.shape != v.shape
               or u.dim() != 2 or u.shape[0] != rows or cols > u.shape[1])
    if bad:
        shapes = ", ".join(str(None if t is None else tuple(t.shape))
                           for t in (y, u, v))
        raise ValueError(f"{name}: planes {shapes} do not hold a "
                         f"{h}x{width} {CHROMA_NAMES.get(chroma)} picture")
    return h


def yuv420_to_bgr_plain(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                        *, width: int, rotation: int = 0,
                        rule: YuvRule = BT601_LIMITED,
                        chroma=CHROMA_420) -> torch.Tensor:
    """The plain version of :func:`yuv420_to_bgr` (int32 arithmetic), and
    with `chroma` :data:`CHROMA_422` of :func:`yuv422_to_bgr` (each luma
    row its own chroma row)."""
    h = y.shape[0]
    rows = 2 if chroma == CHROMA_420 else 1

    def full(c):       # each chroma sample over its 2x2 (2x1) block
        c = c[:, :(width + 1) // 2].to(torch.int32)
        return c.repeat_interleave(rows, 0).repeat_interleave(2, 1)[
            :h, :width]

    luma = ((8 * y[:, :width].to(torch.int32) - rule.y_offset)
            * rule.luma) >> 16
    u8, v8 = 8 * (full(u) - 128), 8 * (full(v) - 128)
    bgr = torch.stack([luma + ((u8 * rule.ub) >> 16),
                       luma + ((u8 * rule.ug) >> 16) + ((v8 * rule.vg) >> 16),
                       luma + ((v8 * rule.vr) >> 16)], dim=-1)
    return _turn(bgr.clamp(0, 255).to(torch.uint8), rotation)


def yuv420_to_bgr(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor, *,
                  width: int, rotation: int = 0,
                  rule: YuvRule = BT601_LIMITED) -> torch.Tensor:
    """A 4:2:0 picture's 8-bit planes to ``(H', W', 3)`` uint8 BGR, turned
    clockwise by `rotation` (0/90/180/270; H' x W' is W x H at a quarter
    turn), exactly as cv2's frames of it: swscale's unscaled path with the
    constants of the stream's matrix and range (`rule`, :func:`yuv_rule`).

    y: (H, pitch) uint8, the picture in its first `width` columns; u, v:
    ((H + 1) // 2, chroma pitch) uint8, the chroma in their first
    (width + 1) // 2 columns, one pitch for both.  All contiguous (the
    pitch is the row stride) and on one device."""
    h = _check_planes("yuv420_to_bgr", y, u, v, width, rotation)
    if _route(y) == "cpu":
        return yuv420_to_bgr_plain(y, u, v, width=width, rotation=rotation,
                                   rule=rule)
    dev = y.device
    for name, t in (("y", y), ("u", u), ("v", v)):
        _check(name, t, torch.uint8, 2, dev)
    quarter = rotation in (90, 270)
    out = torch.empty((width, h, 3) if quarter else (h, width, 3),
                      dtype=torch.uint8, device=dev)
    _launch("rtpose_yuv420_to_bgr", dev, y.data_ptr(), u.data_ptr(),
            v.data_ptr(), y.shape[1], u.shape[1], h, width, rotation,
            _rule_arg(rule), out.data_ptr())
    yuv420_to_bgr.launches += 1
    return out


yuv420_to_bgr.launches = 0

# ---------------------------------------------------------------------------
# swscale's general (scaling) path, as cv2 runs it: 10-bit 4:2:0 at every
# size, 8-bit at odd heights, full internal chroma at odd widths
# ---------------------------------------------------------------------------

CHROMA_LOCATIONS = {0: "unspecified", 1: "left", 2: "center",
                    3: "top left", 4: "top", 5: "bottom left", 6: "bottom"}
SWS_BICUBIC_C = int(0.6 * (1 << 24))   # swscale's default bicubic C (B 0)
GENERAL_MIN_WIDTH, GENERAL_MIN_HEIGHT = 8, 9
DEPTHS = (8, 10, 12)


def frame_route(chroma, depth: int, height: int, width: int,
                packed: Optional[str] = None) -> str:
    """The path swscale (cv2 5.0's conversion of a decoded frame, its
    swscale graph's one legacy pass) takes from a `depth`-bit height x
    width picture of the chroma format `chroma` (a key of
    :data:`CHROMA_NAMES`) to bgr24:

    - ``"unscaled"``: 8-bit 4:2:0 and 4:2:2 at even heights
      (``ff_get_unscaled_swscale``'s yuv2rgb, which takes yuv420p and
      yuv422p at an even output height), odd widths too:
      :func:`yuv420_to_bgr`, :func:`yuv422_to_bgr`;
    - ``"general"``: the scaling path at SWS_BICUBIC, chroma shared by
      each pixel pair, at even widths: 4:2:0 and 4:2:2 of an odd height
      or of more than 8 bits, 4:4:0 (its chroma filtered down to the
      pairs): :func:`yuv420_general_to_bgr`, :func:`yuv420p10_to_bgr`,
      :func:`yuv_planar_general_to_bgr`;
    - ``"full_chroma"``: the scaling path with full internal horizontal
      chroma, which swscale forces at an odd RGB width and for chroma it
      does not subsample (4:4:4): :func:`yuv420_full_chroma_to_bgr`,
      :func:`yuv_planar_full_chroma_to_bgr`;
    - ``"gray"``: 4:0:0, luma alone (:func:`gray_to_bgr`);
    - ``"packed"``: a packed RGB frame (`packed`, a key of
      :data:`PACKED_BYTES`: bgr0, bgra, bgr24, rgb24), swscale's
      unscaled packed-to-packed byte shuffle at any size
      (:func:`packed_to_bgr`).

    Raises ValueError for another depth, and names a picture under
    GENERAL_MIN_HEIGHT rows or GENERAL_MIN_WIDTH columns on a scaling
    route (swscale's two-tap vertical path and narrow filters there)."""
    if packed is not None:
        if packed not in PACKED_BYTES:
            raise ValueError(f"a packed {packed} picture: "
                             f"{', '.join(PACKED_BYTES)} are converted")
        return "packed"
    if depth not in DEPTHS or chroma not in CHROMA_NAMES:
        raise ValueError(f"a {depth}-bit {CHROMA_NAMES.get(chroma, chroma)}"
                         f" picture: 4:2:0, 4:2:2, 4:4:0, 4:4:4 and 4:0:0 "
                         f"of 8, 10 and 12 bits are converted (ROADMAP.md "
                         f"queue 1 item 4i)")
    if depth == 8 and chroma in (CHROMA_420, CHROMA_422) and height % 2 == 0:
        return "unscaled"
    if chroma is None and depth == 8:
        return "gray"              # palToRgb: a copy, at any size
    _check_scaled_size(height, width, depth)
    return ("gray" if chroma is None else
            "full_chroma" if width % 2 or chroma == CHROMA_444 else
            "general")


def _check_scaled_size(height: int, width: int, depth: int) -> None:
    if width < GENERAL_MIN_WIDTH or height < GENERAL_MIN_HEIGHT:
        raise ValueError(f"a {height}x{width} {depth}-bit picture: swscale's "
                         f"scaling path is converted at heights of at least "
                         f"{GENERAL_MIN_HEIGHT} and widths of at least "
                         f"{GENERAL_MIN_WIDTH} (ROADMAP.md queue 1 item 4i "
                         f"(a))")


def _chroma_pos(location: int) -> Tuple[int, int]:
    """(x, y) of a chroma sample in 1/256 of a chroma sample, as
    ``av_chroma_location_enum_to_pos`` gives them (unspecified: -513,
    swscale's default, the centre)."""
    if location == 0:
        return -513, -513
    pos = location - 1
    return (pos & 1) * 128, ((pos >> 1) ^ int(pos < 4)) * 128


def _local_pos(subsample: int, pos: int) -> int:
    """swscale's get_local_pos."""
    if pos == -1 or pos <= -513:
        pos = (128 << subsample) - 128
    return (pos + 128) >> subsample


def _bicubic(d: int) -> int:
    """swscale's fixed-point bicubic (B 0, C 0.6) at distance `d` (1 is
    2^30)."""
    C = SWS_BICUBIC_C
    if d >= 1 << 31:
        return 0
    dd = (d * d) >> 30
    ddd = (dd * d) >> 30
    if d < 1 << 30:
        return ((12 * (1 << 24) - 6 * C) * ddd
                + (-18 * (1 << 24) + 6 * C) * dd + 6 * (1 << 24) * (1 << 30))
    return -6 * C * ddd + 30 * C * dd - 48 * C * d + 24 * C * (1 << 30)


@functools.lru_cache(maxsize=64)
def sws_filter(x_inc: int, src: int, dst: int, align: int, one: int,
               src_pos: int, dst_pos: int) -> Tuple[np.ndarray, np.ndarray]:
    """swscale's initFilter for SWS_BICUBIC with no user filter on x86
    (`align` 4 horizontally, 2 vertically), scaling up, down or keeping
    the size: (first source index of each output, (dst,) int32; the taps,
    (dst, size) int32 summing to `one`)."""
    down = x_inc > 1 << 16
    # fone: 2^54 over the scale's power of two (av_log2(src / dst))
    fone = 1 << (54 - min(max((src // dst).bit_length() - 1, 0), 8))
    if abs(x_inc - 0x10000) < 10 and src_pos == dst_pos:
        return (np.arange(dst, dtype=np.int32),
                np.full((dst, 1), one, np.int32))
    size = 1 + (4 * src + dst - 1) // dst if down else 5
    size = max(min(size, src - 2), 1)
    filt = [[0] * size for _ in range(dst)]
    pos = [0] * dst
    x = ((dst_pos * x_inc) >> 7) - ((src_pos * 0x10000) >> 7)
    for i in range(dst):
        xx = _c_div(x - (size - 2) * (1 << 16), 1 << 17)
        pos[i] = xx
        for j in range(size):
            d = abs((xx + j) * (1 << 17) - x) << 13
            if down:                      # the kernel widened by the scale
                d = d * dst // src
            filt[i][j] = _c_div(_bicubic(d), (1 << 54) // fone)
        x += 2 * x_inc
    # reduce: near-zero taps off the left (keeping the positions
    # monotonic), the size the widest output needs
    cut, need = 0.002 * fone, 0
    for i in range(dst - 1, -1, -1):
        acc = 0
        for _ in range(size):
            acc += abs(filt[i][0])
            if acc > cut or (i < dst - 1 and pos[i] >= pos[i + 1]):
                break
            filt[i] = filt[i][1:] + [0]
            pos[i] += 1
        keep, acc = size, 0
        for j in range(size - 1, 0, -1):
            acc += abs(filt[i][j])
            if acc > cut:
                break
            keep -= 1
        need = max(need, keep)
    if need == 1 and align == 2:
        align = 1
    n = (need + align - 1) & ~(align - 1)
    taps = [[f[j] if j < size else 0 for j in range(n)] for f in filt]
    for i, f in enumerate(taps):              # fold taps outside the source
        if pos[i] < 0:
            for j in range(1, n):
                left = max(j + pos[i], 0)
                f[left] += f[j]
                f[j] = 0
            pos[i] = 0
        if pos[i] + n > src:
            shift = pos[i] + min(n - src, 0)
            acc = 0
            for j in range(n - 1, -1, -1):
                if pos[i] + j >= src:
                    acc += f[j]
                    f[j] = 0
            for j in range(n - 1, -1, -1):
                f[j] = 0 if j < shift else f[j - shift]
            pos[i] -= shift
            f[src - 1 - pos[i]] += acc
    out = np.zeros((dst, n), np.int32)
    for i, f in enumerate(taps):              # to `one`, error carried
        total = max((sum(f) + one // 2) // one, 1)
        err = 0
        for j in range(n):
            val = f[j] + err
            q = _c_div(val + (total >> 1) if val >= 0 else val - (total >> 1),
                       total)
            out[i, j] = q
            err = val - q * total
    return np.asarray(pos, np.int32), out


def general_filters(height: int, width: int, location: int,
                    full_chroma: bool = False, chroma=CHROMA_420):
    """The chroma filters of swscale's general path from a height x width
    picture of the chroma format `chroma` to bgr24 (SWS_BICUBIC, the
    source chroma at `location`): (horizontal first sample (n,), taps
    (n, hs); vertical first row (height,), taps (height, vs)), int32;
    14-bit horizontal, 12-bit vertical taps.  The horizontal filter takes
    the chroma columns to the width // 2 pixel pairs (n = width // 2, the
    width even: kept at 4:2:0 and 4:2:2, halved at 4:4:0); with
    `full_chroma` to n = width columns (scaled up at 4:2:0 and 4:2:2,
    kept at 4:4:0 and 4:4:4).  The vertical filter takes the chroma rows
    to the height (one tap where they are not subsampled).

    The chroma location sets the source position along each subsampled
    axis only, as FFmpeg 8's swscale graph hands it to its legacy pass
    (along an axis of full chroma: swscale's default, -513)."""
    _check_scaled_size(height, width, 10)
    if width % 2 and not full_chroma:
        raise ValueError(f"a {height}x{width} picture: an odd width takes "
                         f"swscale's full-chroma output")
    if location not in CHROMA_LOCATIONS:
        raise ValueError(f"chroma location {location} is not one of "
                         f"{sorted(CHROMA_LOCATIONS)}")
    sx, sy = chroma
    ch, cw = chroma_shape(chroma, height, width)
    x, y = _chroma_pos(location)
    n = width if full_chroma else width // 2
    hpos, htaps = sws_filter(((cw << 16) + (n >> 1)) // n, cw, n, 4, 1 << 14,
                             _local_pos(sx, x if sx else -513),
                             _local_pos(0 if full_chroma else 1, -513))
    v_inc = ((ch << 16) + (height >> 1)) // height
    vpos, vtaps = sws_filter(v_inc, ch, height, 2, 1 << 12,
                             _local_pos(sy, y if sy else -513),
                             _local_pos(0, -513))
    if vtaps.shape[1] == 2:
        raise ValueError(f"a {height}x{width} picture: swscale's two-tap "
                         f"path (ROADMAP.md queue 1 item 4i (a))")
    return hpos, htaps, vpos, vtaps


def _table_bgr(yi, uc, vc, rule: YuvRule) -> torch.Tensor:
    """swscale's table path (yuv2rgb_X_c's bgr24 tables): 8-bit luma and
    chroma indices to BGR."""
    def ytab(k):
        return ((k * rule.cy + rule.y_base + 0x8000) >> 16).clamp(0, 255)

    def term(c, inc):
        return ((c.clamp(0, 255) * inc) >> 16) - (inc >> 9)

    return torch.stack([ytab(yi + term(uc, rule.bu)),
                        ytab(yi + term(uc, rule.gu) + term(vc, rule.gv)),
                        ytab(yi + term(vc, rule.rv))], dim=-1)


def _filtered_chroma(u, v, depth: int, filters):
    """Each chroma plane filtered horizontally (hScale8To15's ``>> 7``,
    hScale16To15's ``>> 9``: 15-bit, at most 32767), then the chroma rows
    each output row's vertical taps read: ((h, vs, n) U, V, (h, vs, 1)
    taps), int64."""
    hpos, htaps, vpos, vtaps = filters
    dev = u.device
    hidx = torch.from_numpy(hpos.astype(np.int64)[:, None]
                            + np.arange(htaps.shape[1])).to(dev)
    hc = torch.from_numpy(htaps.astype(np.int64)).to(dev)
    vidx = torch.from_numpy(vpos.astype(np.int64)[:, None]
                            + np.arange(vtaps.shape[1])).to(dev)
    vc = torch.from_numpy(vtaps.astype(np.int64)).to(dev)

    def horizontal(c):
        c = c.to(torch.int64)
        return ((c[:, hidx] * hc).sum(-1) >> (depth - 1)).clamp(max=32767)

    return horizontal(u)[vidx], horizontal(v)[vidx], vc[:, :, None]


def _y15(y: torch.Tensor, width: int, depth: int) -> torch.Tensor:
    """Luma to swscale's 15-bit intermediate (an identity filter)."""
    return y[:, :width].to(torch.int64) << (15 - depth)


def general_to_bgr_plain(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                         *, width: int, depth: int, rotation: int = 0,
                         rule: YuvRule = BT601_LIMITED,
                         chroma_location: int = 1,
                         chroma=CHROMA_420) -> torch.Tensor:
    """The plain version of :func:`yuv420_general_to_bgr` (8-bit),
    :func:`yuv420p10_to_bgr` (10-bit) and :func:`yuv_planar_general_to_bgr`
    (the other chroma formats, 12-bit 4:2:0) (int64 arithmetic):
    swscale's general path at an even width as cv2 5.0's frames show it.

    - luma: the 15-bit intermediate Y15 = Y << (15 - depth), no filter;
    - chroma: the horizontal filter (14-bit taps, ``>> (depth - 1)``, at
      most 32767), then the vertical one (12-bit taps) to every output
      row (:func:`general_filters`);
    - output: rows above the last two through the MMX ``yuv2bgr24_X``
      (each tap's product's high half, ``+ 4``; then the 16-bit
      coefficients as in the unscaled path, on Y15 >> 4, that is 8 Y at
      8 bits, 2 Y at 10 and Y / 2 at 12, and the chroma less 1024), or,
      where the vertical chroma filter has one tap (chroma not
      subsampled vertically: 4:2:2), through the MMX ``yuv2bgr24_1``
      (the same on C15 >> 4 and Y15 >> 4, no ``+ 4``); the last two rows
      through the C tables (``(1 << 18) + sum >> 19`` to 8-bit indices,
      luma ``((Y15 << 12) + (1 << 18)) >> 19``; ``yuv2rgb_1_c`` at one
      tap gives the same); chroma shared by each pixel pair."""
    h = y.shape[0]
    cw = chroma_shape(chroma, h, width)[1]
    tu, tv, taps = _filtered_chroma(u[:, :cw], v[:, :cw], depth,
                                    general_filters(h, width,
                                                    chroma_location,
                                                    chroma=chroma))
    one_tap = taps.shape[1] == 1
    if one_tap:                    # yuv2bgr24_1
        simd_u, simd_v = (tu[:, 0] >> 4) - 1024, (tv[:, 0] >> 4) - 1024
    else:                          # yuv2bgr24_X
        simd_u = 4 + ((tu * taps) >> 16).sum(1) - 1024
        simd_v = 4 + ((tv * taps) >> 16).sum(1) - 1024
    c_u = ((1 << 18) + (tu * taps).sum(1)) >> 19
    c_v = ((1 << 18) + (tv * taps).sum(1)) >> 19

    def pairs(c):                  # each chroma value to its two pixels
        return c.repeat_interleave(2, 1)[:, :width]

    y15 = _y15(y, width, depth)
    luma = (((0 if one_tap else 4) + (y15 >> 4) - rule.y_offset)
            * rule.luma) >> 16
    su, sv = pairs(simd_u), pairs(simd_v)
    bgr = torch.stack([luma + ((su * rule.ub) >> 16),
                       luma + ((su * rule.ug) >> 16) + ((sv * rule.vg) >> 16),
                       luma + ((sv * rule.vr) >> 16)], dim=-1).clamp(0, 255)
    last = slice(max(h - 2, 0), h)
    bgr[last] = _table_bgr(((y15[last] << 12) + (1 << 18)) >> 19,
                           pairs(c_u[last]), pairs(c_v[last]), rule)
    return _turn(bgr.to(torch.uint8), rotation)


def yuv420p10_to_bgr_plain(y: torch.Tensor, u: torch.Tensor,
                           v: torch.Tensor, *, width: int,
                           rotation: int = 0, rule: YuvRule = BT601_LIMITED,
                           chroma_location: int = 1) -> torch.Tensor:
    """The plain version of :func:`yuv420p10_to_bgr`:
    :func:`general_to_bgr_plain` at 10 bits."""
    return general_to_bgr_plain(y, u, v, width=width, depth=10,
                                rotation=rotation, rule=rule,
                                chroma_location=chroma_location)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 to the int32 that C's unsigned arithmetic leaves."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def full_chroma_to_bgr_plain(y: torch.Tensor, u: torch.Tensor,
                             v: torch.Tensor, *, width: int, depth: int,
                             rotation: int = 0,
                             rule: YuvRule = BT601_LIMITED,
                             chroma_location: int = 1,
                             chroma=CHROMA_420) -> torch.Tensor:
    """The plain version of :func:`yuv420_full_chroma_to_bgr` and of
    :func:`yuv_planar_full_chroma_to_bgr` (int64 arithmetic): swscale's
    general path with full internal horizontal chroma (an odd width, or
    4:4:4) as cv2 5.0's frames show it.

    - luma: Y15 = Y << (15 - depth), no filter;
    - chroma: the horizontal filter takes the chroma columns to `width`
      (4:2:0, 4:2:2: scaled up from (width + 1) // 2; 14-bit taps at
      swscale's chrXInc, ``>> (depth - 1)``, at most 32767), then the
      vertical filter (12-bit taps) to every row
      (:func:`general_filters`); one tap each way at 4:4:4, where
      ``yuv2rgb_full_1_c`` gives what the sums below give;
    - output: yuv2rgb_full_X_c's ``yuv2rgb_write_full`` at every pixel and
      row: Y = ((1 << 9) + 4096 Y15) >> 10 (its one-tap vertical filter),
      U = ((1 << 9) - (128 << 19) + sum_t C15 vtap) >> 10, V the same;
      Y' = (Y - (y_offset << 6)) * luma + (1 << 21); R = Y' + V vr,
      G = Y' + V vg + U ug, B = Y' + U ub in 32-bit unsigned arithmetic,
      read back as int, each clipped to [0, 2^30) and ``>> 22``."""
    h = y.shape[0]
    cw = chroma_shape(chroma, h, width)[1]
    tu, tv, taps = _filtered_chroma(u[:, :cw], v[:, :cw], depth,
                                    general_filters(h, width,
                                                    chroma_location,
                                                    full_chroma=True,
                                                    chroma=chroma))
    cu = ((1 << 9) - (128 << 19) + (tu * taps).sum(1)) >> 10
    cv = ((1 << 9) - (128 << 19) + (tv * taps).sum(1)) >> 10
    luma = (((((1 << 9) + (_y15(y, width, depth) << 12)) >> 10)
             - (rule.y_offset << 6)) * rule.luma + (1 << 21))
    bgr = torch.stack([luma + cu * rule.ub,
                       luma + cv * rule.vg + cu * rule.ug,
                       luma + cv * rule.vr], dim=-1)
    bgr = _wrap32(bgr).clamp(0, (1 << 30) - 1) >> 22
    return _turn(bgr.to(torch.uint8), rotation)


def gray_to_bgr_plain(y: torch.Tensor, *, width: int, depth: int,
                      rotation: int = 0) -> torch.Tensor:
    """The plain version of :func:`gray_to_bgr` (int64 arithmetic): a
    4:0:0 picture as cv2 5.0's frames show it.  Its swscale graph takes
    gray as full range whatever the stream states; 8-bit gray goes
    through swscale's palette copy (B = G = R = Y), deeper gray through
    the full-chroma output with neutral chroma (swscale fills the chroma
    rows of a gray source with 1 << 14), where yuv2rgb_write_full's sums
    at full range come to min((Y15 + 64) >> 7, 255) with Y15 = Y << (15
    - depth): Y itself at 8 bits."""
    g = ((_y15(y, width, depth) + 64) >> 7).clamp(max=255).to(torch.uint8)
    return _turn(g[..., None].expand(-1, -1, 3), rotation)


_GENERAL_TABLES = {}   # (device, h, w, location, full, chroma) -> filters


def _tables_on(device: torch.device, h: int, width: int, location: int,
               full_chroma: bool, chroma=CHROMA_420):
    key = (str(device), h, width, location, full_chroma, chroma)
    if key not in _GENERAL_TABLES:
        _GENERAL_TABLES[key] = tuple(
            torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in general_filters(h, width, location, full_chroma,
                                     chroma))
    return _GENERAL_TABLES[key]


# the most taps the tap classes of csrc/yuv_planar_to_bgr.cu's entries
# hold: horizontal where the vertical filter has one tap, horizontal where
# it has more, vertical
PLANAR_MAX_TAPS = {"rtpose_yuv_planar_general_to_bgr": (4, 8, 4),
                   "rtpose_yuv_planar_full_chroma_to_bgr": (4, 4, 4)}


def check_planar_taps(entry: str, hsize: int, vsize: int) -> None:
    """Raise ValueError, naming the count, for filters that no tap class of
    the planar `entry` holds (the entry refuses them with
    cudaErrorInvalidValue)."""
    one_row, more_rows, most_v = PLANAR_MAX_TAPS[entry]
    most_h = one_row if vsize == 1 else more_rows
    if vsize > most_v:
        raise ValueError(f"{entry}: {vsize} vertical chroma taps; its tap "
                         f"classes hold at most {most_v}")
    if hsize > most_h:
        raise ValueError(f"{entry}: {hsize} horizontal chroma taps at "
                         f"{vsize} vertical; its tap classes hold at most "
                         f"{most_h}")


def _launch_general(entry: str, y, u, v, dtype: torch.dtype, *extra,
                    width: int, rotation: int, rule: YuvRule,
                    chroma_location: int, full_chroma: bool,
                    chroma=CHROMA_420) -> torch.Tensor:
    """Launch a general-path kernel on its planes and its filters."""
    h, dev = y.shape[0], y.device
    for name, t in (("y", y), ("u", u), ("v", v)):
        _check(name, t, dtype, 2, dev)
    hpos, htaps, vpos, vtaps = _tables_on(dev, h, width, chroma_location,
                                          full_chroma, chroma)
    if entry in PLANAR_MAX_TAPS:
        check_planar_taps(entry, htaps.shape[1], vtaps.shape[1])
    quarter = rotation in (90, 270)
    out = torch.empty((width, h, 3) if quarter else (h, width, 3),
                      dtype=torch.uint8, device=dev)
    _launch(entry, dev, y.data_ptr(), u.data_ptr(), v.data_ptr(),
            y.shape[1], u.shape[1], h, width, *extra, rotation,
            hpos.data_ptr(), htaps.data_ptr(), htaps.shape[1],
            vpos.data_ptr(), vtaps.data_ptr(), vtaps.shape[1],
            _rule_arg(rule), out.data_ptr())
    return out


def _check_general(name: str, y, u, v, width: int, rotation: int) -> None:
    h = _check_planes(name, y, u, v, width, rotation)
    if width % 2:
        raise ValueError(f"{name}: a {h}x{width} picture: an odd width "
                         f"takes swscale's full-chroma output "
                         f"(yuv420_full_chroma_to_bgr)")


def yuv420_general_to_bgr(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                          *, width: int, rotation: int = 0,
                          rule: YuvRule = BT601_LIMITED,
                          chroma_location: int = 1) -> torch.Tensor:
    """A 4:2:0 picture's 8-bit planes of an odd height to ``(H', W', 3)``
    uint8 BGR turned clockwise by `rotation`, exactly as cv2 5.0's frames
    of it: swscale's general path at SWS_BICUBIC (chroma filtered from
    `chroma_location`, an ``AVChromaLocation``), with the constants of
    the stream's matrix and range (`rule`); :func:`yuv420_to_bgr` takes
    even heights.

    y: (H, pitch) uint8, the picture in its first `width` columns (even,
    at least 8; H at least 9); u, v: ((H + 1) // 2, chroma pitch) uint8.
    All contiguous and on one device."""
    _check_general("yuv420_general_to_bgr", y, u, v, width, rotation)
    if _route(y) == "cpu":
        return general_to_bgr_plain(y, u, v, width=width, depth=8,
                                    rotation=rotation, rule=rule,
                                    chroma_location=chroma_location)
    out = _launch_general("rtpose_yuv420_general_to_bgr", y, u, v,
                          torch.uint8, width=width, rotation=rotation,
                          rule=rule, chroma_location=chroma_location,
                          full_chroma=False)
    yuv420_general_to_bgr.launches += 1
    return out


yuv420_general_to_bgr.launches = 0


def yuv420p10_to_bgr(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor, *,
                     width: int, rotation: int = 0,
                     rule: YuvRule = BT601_LIMITED,
                     chroma_location: int = 1) -> torch.Tensor:
    """A 4:2:0 picture's 10-bit planes to ``(H', W', 3)`` uint8 BGR turned
    clockwise by `rotation`, exactly as cv2 5.0's frames of it: swscale's
    general path at SWS_BICUBIC (chroma filtered from `chroma_location`,
    an ``AVChromaLocation``), with the constants of the stream's matrix
    and range (`rule`).

    y: (H, pitch) uint16 of values below 1024, the picture in its first
    `width` columns (even, at least 8; H at least 9; odd widths:
    :func:`yuv420_full_chroma_to_bgr`); u, v: ((H + 1) // 2, chroma
    pitch) uint16.  All contiguous and on one device."""
    _check_general("yuv420p10_to_bgr", y, u, v, width, rotation)
    if _route(y) == "cpu":
        return yuv420p10_to_bgr_plain(y, u, v, width=width,
                                      rotation=rotation, rule=rule,
                                      chroma_location=chroma_location)
    out = _launch_general("rtpose_yuv420p10_to_bgr", y, u, v, torch.uint16,
                          width=width, rotation=rotation, rule=rule,
                          chroma_location=chroma_location, full_chroma=False)
    yuv420p10_to_bgr.launches += 1
    return out


yuv420p10_to_bgr.launches = 0


def yuv420_full_chroma_to_bgr(y: torch.Tensor, u: torch.Tensor,
                              v: torch.Tensor, *, width: int, depth: int,
                              rotation: int = 0,
                              rule: YuvRule = BT601_LIMITED,
                              chroma_location: int = 1) -> torch.Tensor:
    """A 4:2:0 picture of an odd width to ``(H', W', 3)`` uint8 BGR turned
    clockwise by `rotation`, exactly as cv2 5.0's frames of it: swscale's
    general path with full internal horizontal chroma, which it forces at
    an odd RGB width (:func:`full_chroma_to_bgr_plain`), at SWS_BICUBIC
    from `chroma_location` with the constants of `rule`.

    y: (H, pitch) uint8 (`depth` 8) or uint16 of values below 1024
    (`depth` 10), the picture in its first `width` columns (at least 8; H
    at least 9); u, v: ((H + 1) // 2, chroma pitch) of the same type.  All
    contiguous and on one device."""
    h = _check_planes("yuv420_full_chroma_to_bgr", y, u, v, width, rotation)
    frame_route(CHROMA_420, depth, h, width)
    if depth not in (8, 10):
        raise ValueError(f"yuv420_full_chroma_to_bgr: {depth}-bit frames "
                         f"take yuv_planar_full_chroma_to_bgr")
    if _route(y) == "cpu":
        return full_chroma_to_bgr_plain(y, u, v, width=width, depth=depth,
                                        rotation=rotation, rule=rule,
                                        chroma_location=chroma_location)
    out = _launch_general("rtpose_yuv420_full_chroma_to_bgr", y, u, v,
                          torch.uint8 if depth == 8 else torch.uint16, depth,
                          width=width, rotation=rotation, rule=rule,
                          chroma_location=chroma_location, full_chroma=True)
    yuv420_full_chroma_to_bgr.launches += 1
    return out


yuv420_full_chroma_to_bgr.launches = 0


# ---------------------------------------------------------------------------
# the other chroma formats (4:2:2, 4:4:0, 4:4:4, 4:0:0) and 12-bit 4:2:0:
# csrc/yuv_planar_to_bgr.cu
# ---------------------------------------------------------------------------

def _sample_type(depth: int) -> torch.dtype:
    return torch.uint8 if depth == 8 else torch.uint16


def yuv422_to_bgr(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor, *,
                  width: int, rotation: int = 0,
                  rule: YuvRule = BT601_LIMITED) -> torch.Tensor:
    """An 8-bit 4:2:2 picture of an even height to ``(H', W', 3)`` uint8
    BGR turned clockwise by `rotation`, exactly as cv2's frames of it:
    swscale's unscaled yuv422p -> bgr24, :func:`yuv420_to_bgr`'s rule with
    each luma row its own chroma row.

    y: (H, pitch) uint8, the picture in its first `width` columns; u, v:
    (H, chroma pitch) uint8, the chroma in their first (width + 1) // 2
    columns.  All contiguous and on one device."""
    h = _check_planes("yuv422_to_bgr", y, u, v, width, rotation, CHROMA_422)
    if _route(y) == "cpu":
        return yuv420_to_bgr_plain(y, u, v, width=width, rotation=rotation,
                                   rule=rule, chroma=CHROMA_422)
    dev = y.device
    for name, t in (("y", y), ("u", u), ("v", v)):
        _check(name, t, torch.uint8, 2, dev)
    quarter = rotation in (90, 270)
    out = torch.empty((width, h, 3) if quarter else (h, width, 3),
                      dtype=torch.uint8, device=dev)
    _launch("rtpose_yuv422_to_bgr", dev, y.data_ptr(), u.data_ptr(),
            v.data_ptr(), y.shape[1], u.shape[1], h, width, rotation,
            _rule_arg(rule), out.data_ptr())
    yuv422_to_bgr.launches += 1
    return out


yuv422_to_bgr.launches = 0


def yuv_planar_general_to_bgr(y: torch.Tensor, u: torch.Tensor,
                              v: torch.Tensor, *, width: int, depth: int,
                              chroma, rotation: int = 0,
                              rule: YuvRule = BT601_LIMITED,
                              chroma_location: int = 1) -> torch.Tensor:
    """A picture of the chroma format `chroma` (4:2:2, 4:4:0, or 4:2:0 of
    12 bits) at an even width to ``(H', W', 3)`` uint8 BGR turned
    clockwise by `rotation`, exactly as cv2 5.0's frames of it: swscale's
    general path, chroma shared by each pixel pair
    (:func:`general_to_bgr_plain`: at 4:2:2 its one-tap output).

    y: (H, pitch) uint8 (`depth` 8) or uint16 of `depth` bits (10, 12),
    the picture in its first `width` columns (even, at least 8; H at least
    9); u, v: the chroma planes (:func:`chroma_shape` rows and at least as
    many columns) of the same type.  All contiguous and on one device."""
    name = "yuv_planar_general_to_bgr"
    h = _check_planes(name, y, u, v, width, rotation, chroma)
    if width % 2:
        raise ValueError(f"{name}: a {h}x{width} picture: an odd width "
                         f"takes swscale's full-chroma output "
                         f"(yuv_planar_full_chroma_to_bgr)")
    frame_route(chroma, depth, h, width)
    if _route(y) == "cpu":
        return general_to_bgr_plain(y, u, v, width=width, depth=depth,
                                    rotation=rotation, rule=rule,
                                    chroma_location=chroma_location,
                                    chroma=chroma)
    out = _launch_general("rtpose_yuv_planar_general_to_bgr", y, u, v,
                          _sample_type(depth), depth, width=width,
                          rotation=rotation, rule=rule,
                          chroma_location=chroma_location, full_chroma=False,
                          chroma=chroma)
    yuv_planar_general_to_bgr.launches += 1
    return out


yuv_planar_general_to_bgr.launches = 0


def yuv_planar_full_chroma_to_bgr(y: torch.Tensor, u: torch.Tensor,
                                  v: torch.Tensor, *, width: int, depth: int,
                                  chroma, rotation: int = 0,
                                  rule: YuvRule = BT601_LIMITED,
                                  chroma_location: int = 1) -> torch.Tensor:
    """A picture of the chroma format `chroma` (4:4:4 at any width; 4:2:2,
    4:4:0 and 12-bit 4:2:0 at odd widths) to ``(H', W', 3)`` uint8 BGR
    turned clockwise by `rotation`, exactly as cv2 5.0's frames of it:
    swscale's general path with full internal horizontal chroma
    (:func:`full_chroma_to_bgr_plain`).  Planes as for
    :func:`yuv_planar_general_to_bgr`, the width any (at least 8)."""
    h = _check_planes("yuv_planar_full_chroma_to_bgr", y, u, v, width,
                      rotation, chroma)
    frame_route(chroma, depth, h, width)
    if _route(y) == "cpu":
        return full_chroma_to_bgr_plain(y, u, v, width=width, depth=depth,
                                        rotation=rotation, rule=rule,
                                        chroma_location=chroma_location,
                                        chroma=chroma)
    out = _launch_general("rtpose_yuv_planar_full_chroma_to_bgr", y, u, v,
                          _sample_type(depth), depth, width=width,
                          rotation=rotation, rule=rule,
                          chroma_location=chroma_location, full_chroma=True,
                          chroma=chroma)
    yuv_planar_full_chroma_to_bgr.launches += 1
    return out


yuv_planar_full_chroma_to_bgr.launches = 0


def gray_to_bgr(y: torch.Tensor, *, width: int, depth: int,
                rotation: int = 0) -> torch.Tensor:
    """A 4:0:0 (gray) picture to ``(H', W', 3)`` uint8 BGR turned
    clockwise by `rotation`, exactly as cv2 5.0's frames of it
    (:func:`gray_to_bgr_plain`: full range whatever the stream states).

    y: (H, pitch) uint8 (`depth` 8) or uint16 of `depth` bits (10, 12),
    the picture in its first `width` columns; contiguous."""
    h = _check_planes("gray_to_bgr", y, None, None, width, rotation, None)
    frame_route(None, depth, h, width)
    if _route(y) == "cpu":
        return gray_to_bgr_plain(y, width=width, depth=depth,
                                 rotation=rotation)
    dev = y.device
    _check("y", y, _sample_type(depth), 2, dev)
    quarter = rotation in (90, 270)
    out = torch.empty((width, h, 3) if quarter else (h, width, 3),
                      dtype=torch.uint8, device=dev)
    _launch("rtpose_gray_to_bgr", dev, y.data_ptr(), y.shape[1], h, width,
            depth, rotation, out.data_ptr())
    gray_to_bgr.launches += 1
    return out


gray_to_bgr.launches = 0


# ---------------------------------------------------------------------------
# csrc/packed_to_bgr.cu
# ---------------------------------------------------------------------------

# the packed RGB formats whose pixel holds R, G, B in that order (else B,
# G, R); PACKED_BYTES, the decoder's formats, gives their bytes a pixel
PACKED_SWAP = frozenset(["rgb24"])


def _check_packed(name: str, frame, width: int, layout: str,
                  rotation: int) -> int:
    if rotation not in ROTATIONS:
        raise ValueError(f"rotation {rotation} is not one of {ROTATIONS}")
    if layout not in PACKED_BYTES:
        raise ValueError(f"{name}: no packed format {layout!r} "
                         f"({', '.join(PACKED_BYTES)} are converted)")
    if (frame.dim() != 2 or width <= 0 or frame.shape[0] <= 0
            or PACKED_BYTES[layout] * width > frame.shape[1]):
        raise ValueError(f"{name}: a frame {tuple(frame.shape)} does not "
                         f"hold a {layout} picture {width} pixels wide")
    return frame.shape[0]


def packed_to_bgr_plain(frame: torch.Tensor, *, width: int, layout: str,
                        rotation: int = 0) -> torch.Tensor:
    """The plain version of :func:`packed_to_bgr`: each pixel's B, G and
    R bytes, picked out and turned."""
    h = frame.shape[0]
    n = PACKED_BYTES[layout]
    px = frame[:, :n * width].reshape(h, width, n)
    bgr = px[..., [2, 1, 0]] if layout in PACKED_SWAP else px[..., :3]
    return _turn(bgr, rotation)


def packed_to_bgr(frame: torch.Tensor, *, width: int, layout: str,
                  rotation: int = 0) -> torch.Tensor:
    """A packed RGB frame to ``(H', W', 3)`` uint8 BGR turned clockwise by
    `rotation`, exactly as cv2's frames of it: swscale's unscaled
    packed-to-packed conversion to bgr24 (``rgb32to24`` for ``bgr0`` and
    ``bgra``, a copy for ``bgr24``, R and B swapped for ``rgb24``).

    frame: (H, pitch) uint8, the picture's `layout` pixels (3 or 4 bytes,
    :data:`PACKED_BYTES`) in the first bytes of each row; contiguous."""
    h = _check_packed("packed_to_bgr", frame, width, layout, rotation)
    if _route(frame) == "cpu":
        return packed_to_bgr_plain(frame, width=width, layout=layout,
                                   rotation=rotation)
    dev = frame.device
    _check("frame", frame, torch.uint8, 2, dev)
    quarter = rotation in (90, 270)
    out = torch.empty((width, h, 3) if quarter else (h, width, 3),
                      dtype=torch.uint8, device=dev)
    _launch("rtpose_packed_to_bgr", dev, frame.data_ptr(), frame.shape[1], h,
            width, PACKED_BYTES[layout], int(layout in PACKED_SWAP),
            rotation, out.data_ptr())
    packed_to_bgr.launches += 1
    return out


packed_to_bgr.launches = 0


def yuv420_frame_to_bgr(y: torch.Tensor, u, v, *, depth: int, width: int,
                        rotation: int = 0, rule: YuvRule = BT601_LIMITED,
                        chroma_location: int = 1,
                        chroma=CHROMA_420,
                        packed: Optional[str] = None) -> torch.Tensor:
    """A decoded frame's planes to BGR as cv2 converts it, for every
    chroma format (`chroma`: a key of :data:`CHROMA_NAMES`; u and v None
    for 4:0:0) and depth, and packed RGB (`packed`, a key of
    :data:`PACKED_BYTES`: y the frame's one plane, u and v None): the
    kernel of the path swscale takes at its format, depth and size
    (:func:`frame_route`)."""
    route = frame_route(chroma, depth, y.shape[0], width, packed)
    if route == "packed":
        return packed_to_bgr(y, width=width, layout=packed,
                             rotation=rotation)
    if route == "gray":
        return gray_to_bgr(y, width=width, depth=depth, rotation=rotation)
    if route == "unscaled":
        convert = yuv420_to_bgr if chroma == CHROMA_420 else yuv422_to_bgr
        return convert(y, u, v, width=width, rotation=rotation, rule=rule)
    kw = dict(width=width, rotation=rotation, rule=rule,
              chroma_location=chroma_location)
    if chroma != CHROMA_420 or depth == 12:
        convert = (yuv_planar_full_chroma_to_bgr if route == "full_chroma"
                   else yuv_planar_general_to_bgr)
        return convert(y, u, v, depth=depth, chroma=chroma, **kw)
    if route == "full_chroma":
        return yuv420_full_chroma_to_bgr(y, u, v, depth=depth, **kw)
    if depth == 8:
        return yuv420_general_to_bgr(y, u, v, **kw)
    return yuv420p10_to_bgr(y, u, v, **kw)


_COUNTED = (connection_scores, bicubic_refine, gt_maps, group_people,
            yuv420_to_bgr, yuv420p10_to_bgr, yuv420_general_to_bgr,
            yuv420_full_chroma_to_bgr, yuv422_to_bgr,
            yuv_planar_general_to_bgr, yuv_planar_full_chroma_to_bgr,
            gray_to_bgr, packed_to_bgr)


def reset_launch_counts() -> None:
    for fn in _COUNTED:
        fn.launches = 0
    bicubic_refine.gaussian_filt_launches = 0


def launch_counts() -> dict:
    """Launches per kernel wrapper, and under ``bicubic_refine_gaussian_filt``
    those of the refine that took the blurred kernel."""
    return {**{fn.__name__: fn.launches for fn in _COUNTED},
            "bicubic_refine_gaussian_filt":
                bicubic_refine.gaussian_filt_launches}
