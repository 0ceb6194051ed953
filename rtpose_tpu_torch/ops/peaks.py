"""Peak NMS with sub-pixel refinement (port of rtpose_tpu/ops/peaks.py).

Batched over a leading image axis (the JAX version is per image and
vmapped).  Local maxima under a 4-connected footprint above threshold,
top-K per part by score with a validity mask, a stable re-sort of each
part's surviving peaks into row-major order (so slot ids, and with them
the greedy tie-breaks downstream, follow the reference's scan order), and
the bicubic sub-pixel refine through the CUDA kernel of ``kernels.py``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..skeleton import NUM_PARTS
from .kernels import bicubic_refine


@dataclasses.dataclass
class Peaks:
    """Fixed-shape per-part peak set: (B, NUM_PARTS, K) fields except
    `truncated`, (B,) bool — True where some part had more local maxima
    than K (raise max_peaks and re-run)."""
    x: torch.Tensor        # int32, upsampled-frame column (truncated)
    y: torch.Tensor        # int32, upsampled-frame row (truncated)
    xf: torch.Tensor       # float32 refined column
    yf: torch.Tensor       # float32 refined row
    score: torch.Tensor    # float32 refined peak score
    valid: torch.Tensor    # bool
    truncated: torch.Tensor


def find_peak_mask(heat: torch.Tensor, thresh: float) -> torch.Tensor:
    """4-connected local-max mask of (..., H, W) maps above `thresh`
    (-inf padding; equivalent to the reference's reflect-padded
    maximum_filter because the centre is in the footprint)."""
    ninf = torch.full_like(heat[..., :1, :], -torch.inf)
    up = torch.cat([ninf, heat[..., :-1, :]], dim=-2)
    down = torch.cat([heat[..., 1:, :], ninf], dim=-2)
    ninf = torch.full_like(heat[..., :, :1], -torch.inf)
    left = torch.cat([ninf, heat[..., :, :-1]], dim=-1)
    right = torch.cat([heat[..., :, 1:], ninf], dim=-1)
    cross = torch.maximum(torch.maximum(up, down), torch.maximum(left, right))
    return (heat >= cross) & (heat > thresh)


def top_k_stable(x: torch.Tensor, k: int):
    """Top-k along the last axis, ties to the lower index (lax.top_k's
    order; torch.topk does not promise one)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def peak_candidates(heat: torch.Tensor, *, thresh: float, max_peaks: int):
    """Integer peaks of (B, P, H, W) maps before refinement.

    Returns (scores, py, px, valid), each (B, P, K) with every part's
    surviving peaks in row-major (y, x) order and invalid slots last, and
    `truncated` (B,): some part had more than K local maxima.
    """
    B, P, H, W = heat.shape
    mask = find_peak_mask(heat, thresh)
    n_found = mask.reshape(B, P, H * W).sum(-1)
    truncated = (n_found > max_peaks).any(-1)
    masked = torch.where(mask, heat, -torch.inf).reshape(B, P, H * W)
    scores, idx = top_k_stable(masked, max_peaks)
    py = torch.div(idx, W, rounding_mode="floor").to(torch.int32)
    px = (idx % W).to(torch.int32)
    valid = scores > thresh
    # stable re-sort into row-major order, as the reference scans
    # (peaks.py:343-352 of the JAX package): slot ids, and with them the
    # greedy tie-breaks downstream, follow the reference
    key = torch.where(valid, py * W + px, H * W)
    order = torch.sort(key, dim=-1, stable=True).indices
    return (scores.gather(-1, order), py.gather(-1, order),
            px.gather(-1, order), valid.gather(-1, order), truncated)


def refine_peaks(heat: torch.Tensor, py: torch.Tensor, px: torch.Tensor,
                 valid: torch.Tensor, *, factor: int = 8,
                 gaussian_filt: bool = False):
    """Sub-pixel refine of integer peaks (B, P, K) on (B, P, H, W) maps
    -> (xf, yf, score) in the upsampled frame, zeros where `valid` is
    False: the JAX package's ``_refine_pallas`` (peaks.py:297-315; with
    `gaussian_filt`, its blurred ``_refine_onehot``, :249-257) and the
    mask of its ``nms`` (:365-367), all in the refine kernel."""
    return bicubic_refine(heat, py, px, valid, factor=factor,
                          gaussian_filt=gaussian_filt)


def nms(heatmaps: torch.Tensor, *, factor: int = 8, thresh: float = 0.1,
        max_peaks: int = 32, refine: bool = True,
        gaussian_filt: bool = False) -> Peaks:
    """Fixed-shape NMS over (B, H, W, C >= NUM_PARTS) heatmaps.

    `gaussian_filt` applies the reference's optional sigma=3 smoothing of
    the upsampled refine window (paf_to_pose.py:121-122, default off
    there too) before the argmax.
    """
    heat = heatmaps[..., :NUM_PARTS].permute(0, 3, 1, 2).float().contiguous()
    scores0, py, px, valid, truncated = peak_candidates(
        heat, thresh=thresh, max_peaks=max_peaks)
    if refine:
        xf, yf, score = refine_peaks(heat, py, px, valid, factor=factor,
                                     gaussian_filt=gaussian_filt)
    else:
        xf = torch.where(valid, (px + 0.5) * factor - 0.5, 0.0)
        yf = torch.where(valid, (py + 0.5) * factor - 0.5, 0.0)
        score = torch.where(valid, scores0, 0.0)
    return Peaks(x=xf.to(torch.int32), y=yf.to(torch.int32), xf=xf, yf=yf,
                 score=score, valid=valid, truncated=truncated)
