"""The image->skeletons serving pipeline (port of
rtpose_tpu/infer/pipeline.py:58-474).

One call covers: uint8 BGR frames shipped to the card -> bilinear
scale + zero pad on the card (cv2 INTER_LINEAR parity, ops/resize.py) ->
normalization -> the CNN forward, with flip TTA as a second half of the
batch -> flip-swap averaging -> on-card decode (NMS + refine, PAF scoring,
greedy matching, assembly).  The host reads back fixed-shape people
arrays.  A frame whose decode overflowed a fixed-shape cap
(``People.truncated``) is decoded again from the maps still on the card
at :data:`RETRY_CAPS`; only the truncated frames are decoded again.

Resizing always runs on the card: the JAX package's host resize is
``cv2.resize``, which the port does not depend on.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..models import get_model
from ..models.convert import load_torch_checkpoint, state_dict_from_flax
from ..ops.decode import (decode_poses_batch, people_row, people_to_host,
                          people_to_numpy)
from ..ops.resize import resize_bilinear
from ..skeleton import FLIP_HEAT, FLIP_PAF, NUM_LIMBS
from .preprocess import normalize_device, scale_pad_geometry

_FLIP_PAF_ARR = np.array(FLIP_PAF)
_FLIP_HEAT_ARR = np.array(FLIP_HEAT)
# x-channels (even index into each limb's (x,y) pair) get negated on flip
_PAF_X_NEG = np.ones(2 * NUM_LIMBS, dtype=np.float32)
_PAF_X_NEG[0::2] = -1.0

# Raised decode caps for the automatic truncation retry (the JAX package's
# values, validated there against the unbounded host oracle on crowded
# scenes).
RETRY_CAPS = dict(max_peaks=64, max_candidates=1024,
                  max_total_conns=608, max_people=128)


def average_flip(heat: torch.Tensor, heat_flipped: torch.Tensor,
                 paf: torch.Tensor, paf_flipped: torch.Tensor):
    """Average normal and mirrored predictions, ``(..., H, W, C)`` maps:
    un-mirror W, swap left/right channels, negate PAF x-components
    (reference coco_eval.py:228-240)."""
    dev = heat.device
    hf = heat_flipped.flip(-2)[..., torch.as_tensor(_FLIP_HEAT_ARR,
                                                     device=dev)]
    pf = paf_flipped.flip(-2)[..., torch.as_tensor(_FLIP_PAF_ARR,
                                                    device=dev)]
    pf = pf * torch.as_tensor(_PAF_X_NEG, device=dev)
    return (heat + hf) / 2.0, (paf + pf) / 2.0


def make_infer_fn(model, *, input_size: int = 368,
                  preprocess_mode: str = "vgg", thresh_heatmap: float = 0.1,
                  max_peaks: int = 32, max_people: int = 64,
                  downsample: int = 8, flip: bool = True,
                  max_candidates: int = 256, max_total_conns: int = 160):
    """Build the uint8-frames -> people function.

    Returned fn: raw ``(B, H, W, 3)`` uint8 BGR frames on the model's
    device -> ``(People, heat (B, h, w, 19), paf (B, h, w, 38))``.  The
    frames are scaled so their short side is `input_size`, zero-padded to
    a multiple of `downsample` (the reference crop_with_factor's geometry)
    and normalized, all on their device.
    """

    @torch.inference_mode()
    def infer(images_u8: torch.Tensor):
        h, w = images_u8.shape[1], images_u8.shape[2]
        _, rh, rw, ph, pw = scale_pad_geometry(h, w, input_size, downsample)
        x = resize_bilinear(images_u8.float(), (rh, rw))
        # zero pad in raw pixel space (black), then normalize
        x = F.pad(x, (0, 0, 0, pw - rw, 0, ph - rh))
        image = normalize_device(x, preprocess_mode)
        n = image.shape[0]
        batch = torch.cat([image, image.flip(-2)]) if flip else image
        out = model(batch)
        heat, paf = out.heatmap, out.paf
        if flip:
            heat, paf = average_flip(heat[:n], heat[n:], paf[:n], paf[n:])
        people = decode_poses_batch(
            heat, paf, factor=downsample, thresh_heatmap=thresh_heatmap,
            max_peaks=max_peaks, max_people=max_people,
            max_candidates=max_candidates, max_total_conns=max_total_conns)
        return people, heat, paf

    return infer


def load_pipeline(*, device, torch_weights: Optional[str] = None,
                  flax_params=None, seed: Optional[int] = None,
                  model_name: str = "vgg19", num_stages: int = 6,
                  input_size: int = 368, preprocess_mode: str = "vgg",
                  flip: bool = True, dtype: torch.dtype = torch.bfloat16,
                  **kwargs) -> "PosePipeline":
    """Build a serving pipeline on `device` from one weight source: a
    reference ``.pth``/``.ckpt`` (`torch_weights`), a flax parameter tree
    as numpy (`flax_params`), or N(0, 0.01) weights drawn from `seed`
    (seed 0 when no source is given).  `dtype` is the compute type."""
    if sum(x is not None for x in (torch_weights, flax_params, seed)) > 1:
        raise ValueError("pass one of torch_weights, flax_params or seed")
    dev = resolve_device(device)
    model = get_model(model_name, num_stages=num_stages, dtype=dtype,
                      generator=torch.Generator().manual_seed(seed or 0))
    if torch_weights is not None:
        model.load_state_dict(load_torch_checkpoint(torch_weights),
                              strict=True)
    elif flax_params is not None:
        model.load_state_dict(state_dict_from_flax(flax_params), strict=True)
    # weights stored in the compute type: the same rounding flax applies
    # to its fp32 parameters on every call, paid once
    model = model.to(device=dev, dtype=dtype)
    if dev.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return PosePipeline(model, device=dev, input_size=input_size,
                        preprocess_mode=preprocess_mode, flip=flip, **kwargs)


class PosePipeline:
    """BGR uint8 numpy frames in, lists of people out (the analogue of
    reference evaluate/coco_eval.py:80-114 + paf_to_pose.py:372-406).

    `auto_retry` (default on): a frame that overflowed a fixed-shape decode
    cap is decoded again from its maps, still on the card, at
    `retry_caps` (default :data:`RETRY_CAPS`); meta['retried'] marks it
    and meta['truncated'] reports the state after the retry.
    """

    def __init__(self, model, *, device, input_size: int = 368,
                 downsample: int = 8, preprocess_mode: str = "vgg",
                 flip: bool = True, thresh_heatmap: float = 0.1,
                 max_peaks: int = 32, max_people: int = 64,
                 max_candidates: int = 256, max_total_conns: int = 160,
                 auto_retry: bool = True, retry_caps: Optional[Dict] = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.input_size = input_size
        self.downsample = downsample
        self.preprocess_mode = preprocess_mode
        self.flip = flip
        self._infer = make_infer_fn(
            self.model, input_size=input_size,
            preprocess_mode=preprocess_mode, thresh_heatmap=thresh_heatmap,
            max_peaks=max_peaks, max_people=max_people,
            downsample=downsample, flip=flip, max_candidates=max_candidates,
            max_total_conns=max_total_conns)
        self.auto_retry = auto_retry
        self.retry_caps = {**RETRY_CAPS, **(retry_caps or {})}
        self._retry_kwargs = dict(factor=downsample,
                                  thresh_heatmap=thresh_heatmap,
                                  **self.retry_caps)

    def __call__(self, image_bgr: np.ndarray) -> List[Dict[str, Any]]:
        return self.run(image_bgr)[0]

    def _prep(self, image_bgr: np.ndarray):
        h, w = image_bgr.shape[:2]
        scale, rh, rw, ph, pw = scale_pad_geometry(
            h, w, self.input_size, self.downsample)
        meta = {"scale": scale, "real_shape": (rh, rw, 3),
                "padded_shape": (ph, pw, 3)}
        return np.ascontiguousarray(image_bgr, np.uint8), meta

    def _upload(self, frames) -> torch.Tensor:
        batch = torch.from_numpy(np.stack(frames))
        if self.device.type == "cuda":
            batch = batch.pin_memory()
        return batch.to(self.device, non_blocking=True)

    def _decode_retry(self, heat: torch.Tensor, paf: torch.Tensor):
        with torch.inference_mode():
            return people_to_host(decode_poses_batch(heat, paf,
                                                     **self._retry_kwargs))

    def run(self, image_bgr: np.ndarray):
        """Returns (people list, heat, paf, meta) for one frame.

        people entries: {'parts': {part: (x_norm, y_norm, score)},
        'score': float}, coordinates normalised by the padded upsampled
        frame; meta['scale'] maps them back to the original pixels.
        """
        im, meta = self._prep(image_bgr)
        people_dev, heat, paf = self._infer(self._upload([im]))
        h_up = heat.shape[1] * self.downsample
        w_up = heat.shape[2] * self.downsample
        people_host = people_to_host(people_dev)
        if self.auto_retry and people_host.truncated[0]:
            people_host = self._decode_retry(heat, paf)
            meta["retried"] = True
        meta["truncated"] = bool(people_host.truncated[0])
        meta["upsampled"] = (h_up, w_up)
        people = people_to_numpy(people_row(people_host, 0), w_up, h_up)
        return people, heat[0].cpu().numpy(), paf[0].cpu().numpy(), meta

    def run_batch(self, images_bgr):
        """Batched serving: frames of one shape run as one batch, mixed
        shapes as one batch per shape.  Returns (people lists, metas)."""
        return self.run_batch_collect(self.run_batch_submit(images_bgr))

    def run_batch_submit(self, images_bgr):
        """Enqueue one batch on the card without waiting for it; pair with
        :meth:`run_batch_collect`.  A mixed-shape batch becomes one
        sub-batch per frame shape, all enqueued before any readback."""
        if not images_bgr:
            return ("multi", 0, [])
        ims, metas = zip(*(self._prep(im) for im in images_bgr))
        if len({im.shape for im in ims}) != 1:
            groups: Dict[tuple, list] = {}
            for i, im in enumerate(ims):
                groups.setdefault(im.shape, []).append(i)
            sub = [(idxs, self._submit_stacked([ims[i] for i in idxs],
                                               [metas[i] for i in idxs]))
                   for idxs in groups.values()]
            return ("multi", len(ims), sub)
        return self._submit_stacked(list(ims), list(metas))

    def _submit_stacked(self, ims, metas):
        people_dev, heat, paf = self._infer(self._upload(ims))
        # the maps ride in the ticket so a truncated frame can be decoded
        # again from them at collect time
        return ("async", people_dev, heat, paf, list(metas))

    def run_batch_collect(self, submitted):
        """Wait for a :meth:`run_batch_submit` ticket -> (people, metas)."""
        if submitted[0] == "multi":
            _, n, sub = submitted
            people: List = [None] * n
            metas: List = [None] * n
            for idxs, ticket in sub:
                p, m = self.run_batch_collect(ticket)
                for j, i in enumerate(idxs):
                    people[i] = p[j]
                    metas[i] = m[j]
            return people, metas
        _, people_dev, heat, paf, metas = submitted
        h_up = heat.shape[1] * self.downsample
        w_up = heat.shape[2] * self.downsample
        people_host = people_to_host(people_dev)
        retry_host, retry_pos = None, {}
        if self.auto_retry and people_host.truncated.any():
            # one extra decode of the truncated frames only, from the maps
            # still on the card (no second forward)
            idxs = np.nonzero(people_host.truncated)[0]
            sel = torch.as_tensor(idxs, device=heat.device)
            retry_host = self._decode_retry(heat[sel], paf[sel])
            retry_pos = {int(g): j for j, g in enumerate(idxs)}
        out = []
        for i, meta in enumerate(metas):
            meta["upsampled"] = (h_up, w_up)
            if i in retry_pos:
                meta["retried"] = True
                row = people_row(retry_host, retry_pos[i])
            else:
                row = people_row(people_host, i)
            meta["truncated"] = bool(row.truncated)
            out.append(people_to_numpy(row, w_up, h_up))
        return out, metas

    def keypoints_pixels(self, people, meta):
        """Map normalised part coordinates back to original-image pixels:
        x_pix = x_norm * (W_up / scale) + 0.5 (reference coco_eval.py
        append_result convention)."""
        h_up, w_up = meta["upsampled"]
        scale = meta["scale"]
        out = []
        for person in people:
            parts = {part: (xn * w_up / scale + 0.5, yn * h_up / scale + 0.5,
                            s)
                     for part, (xn, yn, s) in person["parts"].items()}
            out.append({"parts": parts, "score": person["score"]})
        return out
