"""On-device pose decoding: heatmaps + PAFs -> people (port of
rtpose_tpu/ops/decode.py).  The batch axis is written out where the JAX
package vmaps.  On the card the decode reads nothing back to the host:
:func:`people_to_host` (or :func:`read_back`, with the maps) is its one
readback."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch

from .grouping import People, group_peaks_device
from .peaks import nms

_FIELDS = tuple(f.name for f in dataclasses.fields(People))


def decode_poses_batch(heatmaps: torch.Tensor, pafs: torch.Tensor, *,
                       factor: int = 8, thresh_heatmap: float = 0.1,
                       max_peaks: int = 32, max_people: int = 64,
                       refine: bool = True, max_candidates: int = 256,
                       max_total_conns: int = 160, sampling: str = "auto",
                       gaussian_filt: bool = False) -> People:
    """(B, H, W, 19) heatmaps + (B, H, W, 38) PAFs -> People with a leading
    batch axis on every field.  `People.truncated` marks images that
    overflowed a fixed-shape cap (raise the caps and re-run those)."""
    peaks = nms(heatmaps, factor=factor, thresh=thresh_heatmap,
                max_peaks=max_peaks, refine=refine,
                gaussian_filt=gaussian_filt)
    return group_peaks_device(peaks, pafs, factor=factor,
                              max_people=max_people,
                              max_candidates=max_candidates,
                              max_total_conns=max_total_conns,
                              sampling=sampling)


def decode_poses(heatmaps: torch.Tensor, pafs: torch.Tensor,
                 **kwargs) -> People:
    """One image: (H, W, 19) + (H, W, 38) -> People without a batch axis."""
    return people_row(decode_poses_batch(heatmaps[None], pafs[None],
                                         **kwargs), 0)


def people_row(people: People, i: int) -> People:
    """Image `i` of batched People (tensors or numpy)."""
    return People(*(getattr(people, f)[i] for f in _FIELDS))


def _pack(people: People) -> torch.Tensor:
    """Every field of People in one fp32 buffer (coordinates and flags are
    small integers, exact in fp32)."""
    return torch.cat([getattr(people, f).reshape(-1).float()
                      for f in _FIELDS])


def _unpack(flat: np.ndarray, people: People) -> People:
    out, at = [], 0
    for f in _FIELDS:
        p = getattr(people, f)
        n = p.numel()
        chunk = flat[at:at + n].reshape(tuple(p.shape))
        at += n
        if p.dtype == torch.bool:
            chunk = chunk != 0
        elif not p.dtype.is_floating_point:
            chunk = chunk.astype(np.int32)
        out.append(chunk)
    return People(*out)


def people_to_host(people: People) -> People:
    """Copy People to numpy with one device->host transfer."""
    return _unpack(_pack(people).cpu().numpy(), people)


def read_back(people: People, *tensors: torch.Tensor):
    """People and `tensors` to numpy with one wait -> (People, [arrays]).

    On the card every copy is enqueued into pinned host memory and the
    current stream is synchronised once (the JAX package's one
    ``device_get`` of the people and the maps)."""
    srcs = [_pack(people), *tensors]
    dev = srcs[0].device
    if dev.type == "cuda":
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in srcs]
        for h, t in zip(host, srcs):
            h.copy_(t, non_blocking=True)
        torch.cuda.current_stream(dev).synchronize()
    else:
        host = srcs
    arrays = [t.numpy() for t in host]
    return _unpack(arrays[0], people), arrays[1:]


def people_to_numpy(people: People, width_up: int,
                    height_up: int) -> List[Dict[str, Any]]:
    """One image's People -> [{'parts': {part: (x_norm, y_norm, score)},
    'score': float}], coordinates normalised by the upsampled map size
    (reference paf_to_pose.py:390-404)."""
    if isinstance(people.coords, torch.Tensor):
        people = people_to_host(people)
    coords, pscore = people.coords, people.part_score
    score, valid = people.score, people.valid
    out = []
    for i in range(coords.shape[0]):
        if not valid[i]:
            continue
        parts = {}
        for part in range(coords.shape[1]):
            x, y = coords[i, part]
            if x < 0:
                continue
            parts[part] = (x / width_up, y / height_up,
                           float(pscore[i, part]))
        if parts:
            out.append({"parts": parts, "score": float(score[i])})
    return out
