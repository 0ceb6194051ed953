"""The image->skeletons serving pipeline (port of
rtpose_tpu/infer/pipeline.py:58-708).

One call covers: uint8 BGR frames shipped to the card -> bilinear
scale + zero pad on the card (cv2 INTER_LINEAR parity, ops/resize.py) ->
normalization -> the CNN forward, with flip TTA as a second half of the
batch -> flip-swap averaging -> on-card decode (NMS + refine, PAF scoring,
greedy matching, assembly).  The host reads back fixed-shape people
arrays.  A frame whose decode overflowed a fixed-shape cap
(``People.truncated``) is decoded again from the maps still on the card
at :data:`RETRY_CAPS`; only the truncated frames are decoded again.

On the card nothing is read back between the upload of the frames and
the one readback of ``People``: :meth:`PosePipeline.run_batch_submit`
enqueues a batch and returns while the card works on it.

Multi-scale TTA (:meth:`PosePipeline.run_multiscale`, the batched
:meth:`PosePipeline.run_multiscale_batch`) runs one forward per scale
with flip fused, resizes every scale's maps bicubically to the base grid
(cv2 INTER_CUBIC parity), averages them and decodes once.

Resizing always runs on the card: the JAX package's host resize is
``cv2.resize``, which the port does not depend on.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..models import get_model
from ..models.common import cast_compute
from ..models.convert import (load_strict, load_torch_checkpoint,
                              state_dict_from_flax)
from ..ops.decode import (decode_poses_batch, people_row, people_to_host,
                          people_to_numpy, read_back)
from ..ops.kernels import true_div
from ..ops.resize import resize_bicubic, resize_bilinear
from ..skeleton import FLIP_HEAT, FLIP_PAF, NUM_LIMBS
from ..train.checkpoint import best_model_state
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

MS_SCALES = (0.5, 1.0, 1.5, 2.0)
# Device memory a stacked multi-scale chunk holds, in bytes per frame and
# pixel of its largest scaled (padded) input, for a bf16 VGG19 with flip
# TTA: the peak of the largest scale's batch-2B forward (its conv1
# activations dominate).  Measured with chip_smoke.py (PERF.md §5); the
# cost scales with the compute type's width and halves without flip.  It
# bounds every family of the zoo too (chip_smoke.py's zoo phase measures
# each: 207.6-640.0 on an H100, openpose_v2 the most).
MS_BYTES_PER_PIXEL = 768
MS_MEMORY_SHARE = 0.8      # of the card's available memory a chunk may use
# On the CPU there is no device memory to ask: a stated budget
MS_HOST_MEMORY_BUDGET = 8 * 2 ** 30


@functools.lru_cache(maxsize=None)
def _flip_tables_on(device: torch.device):
    """Heat and PAF channel swaps and the PAF x-sign, copied to `device`
    once."""
    return (torch.as_tensor(_FLIP_HEAT_ARR, device=device),
            torch.as_tensor(_FLIP_PAF_ARR, device=device),
            torch.as_tensor(_PAF_X_NEG, device=device))


def average_flip(heat: torch.Tensor, heat_flipped: torch.Tensor,
                 paf: torch.Tensor, paf_flipped: torch.Tensor):
    """Average normal and mirrored predictions, ``(..., H, W, C)`` maps:
    un-mirror W, swap left/right channels, negate PAF x-components
    (reference coco_eval.py:228-240)."""
    heat_idx, paf_idx, x_neg = _flip_tables_on(heat.device)
    hf = heat_flipped.flip(-2)[..., heat_idx]
    pf = paf_flipped.flip(-2)[..., paf_idx] * x_neg
    return (heat + hf) / 2.0, (paf + pf) / 2.0


def make_infer_fn(model, *, input_size: int = 368,
                  preprocess_mode: str = "vgg", thresh_heatmap: float = 0.1,
                  max_peaks: int = 32, max_people: int = 64,
                  downsample: int = 8, flip: bool = True,
                  max_candidates: int = 256, max_total_conns: int = 160,
                  gaussian_filt: bool = False, decode: bool = True,
                  pad_factor: int = 0):
    """Build the uint8-frames -> people function.

    Returned fn: raw ``(B, H, W, 3)`` uint8 BGR frames on the model's
    device -> ``(People, heat (B, h, w, 19), paf (B, h, w, 38))``, People
    None without `decode`.  The frames are scaled so their short side is
    `input_size`, zero-padded to a multiple of `pad_factor` (default
    `downsample`: the reference crop_with_factor's geometry; hourglass
    needs 64) and normalized, all on their device.  `gaussian_filt` blurs
    each peak's upsampled refine window (sigma 3) before the argmax.
    """

    @torch.inference_mode()
    def infer(images_u8: torch.Tensor):
        h, w = images_u8.shape[1], images_u8.shape[2]
        _, rh, rw, ph, pw = scale_pad_geometry(h, w, input_size,
                                               pad_factor or downsample)
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
        if not decode:
            return None, heat, paf
        people = decode_poses_batch(
            heat, paf, factor=downsample, thresh_heatmap=thresh_heatmap,
            max_peaks=max_peaks, max_people=max_people,
            max_candidates=max_candidates, max_total_conns=max_total_conns,
            gaussian_filt=gaussian_filt)
        return people, heat, paf

    return infer


def load_pipeline(checkpoint_dir: Optional[str] = None, *, device="cuda",
                  torch_weights: Optional[str] = None,
                  flax_params=None, seed: Optional[int] = None,
                  model_name: str = "vgg19", num_stages: int = 6,
                  input_size: int = 368, preprocess_mode: str = "vgg",
                  flip: bool = True, dtype: torch.dtype = torch.bfloat16,
                  **kwargs) -> "PosePipeline":
    """Build a serving pipeline on `device` for the family `model_name`
    (``models.get_model``; `num_stages` is hourglass's stack count) from
    one weight source: the best step of a directory of the port's training
    checkpoints (`checkpoint_dir`, ``train/checkpoint.py``), a reference
    ``.pth``/``.ckpt`` or a port state_dict (`torch_weights`; a JAX
    package checkpoint comes through ``scripts/export_jax_checkpoint.py``
    as one), flax variables as numpy (`flax_params`), or the family's
    initial weights drawn from `seed` (seed 0 when no source is given).
    Every load is strict.  `dtype` is the compute type.  The maps'
    stride is `downsample` (4 for hourglass), passed on to
    :class:`PosePipeline`, which pads to the model's ``pad_multiple``."""
    if sum(x is not None for x in (checkpoint_dir, torch_weights,
                                   flax_params, seed)) > 1:
        raise ValueError(
            "pass one of checkpoint_dir, torch_weights, flax_params or "
            "seed: silently preferring one would evaluate the wrong model")
    dev = resolve_device(device)
    model = get_model(model_name, num_stages=num_stages, dtype=dtype,
                      generator=torch.Generator().manual_seed(seed or 0))
    if checkpoint_dir is not None:
        load_strict(model, best_model_state(checkpoint_dir))
    elif torch_weights is not None:
        load_strict(model, load_torch_checkpoint(torch_weights))
    elif flax_params is not None:
        load_strict(model, state_dict_from_flax(flax_params,
                                                model_name=model_name))
    # weights but BatchNorm's stored in the compute type (cast_compute)
    model = cast_compute(model.to(dev), dtype)
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
    `gaussian_filt` (default off, as in the reference) selects the blurred
    peak refine for the first decode and the retry alike.  `pad_factor`
    (default `downsample`) is the multiple every padded input must have,
    raised to a multiple of the model's ``pad_multiple`` where it states
    one (hourglass 64, atrous_resnet50 16); the maps stay at stride
    `downsample`.
    Multi-scale TTA (:meth:`run_multiscale`, :meth:`run_multiscale_batch`)
    decodes with the same caps and retries the same way.
    """

    def __init__(self, model, *, device="cuda", input_size: int = 368,
                 downsample: int = 8, preprocess_mode: str = "vgg",
                 flip: bool = True, thresh_heatmap: float = 0.1,
                 max_peaks: int = 32, max_people: int = 64,
                 max_candidates: int = 256, max_total_conns: int = 160,
                 auto_retry: bool = True, retry_caps: Optional[Dict] = None,
                 gaussian_filt: bool = False, pad_factor: int = 0):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.input_size = input_size
        self.downsample = downsample
        # a family whose forward needs more than the stride states the
        # multiple its padded input must have (hourglass 64: four 2x2
        # pools at stride 4; atrous_resnet50 16: its stride-16 branch is
        # upsampled 2x onto the stride-8 one)
        self.pad_factor = math.lcm(pad_factor or downsample,
                                   getattr(model, "pad_multiple", 1))
        self.preprocess_mode = preprocess_mode
        self.flip = flip
        self._decode_kwargs = dict(
            thresh_heatmap=thresh_heatmap, max_peaks=max_peaks,
            max_people=max_people, max_candidates=max_candidates,
            max_total_conns=max_total_conns, gaussian_filt=gaussian_filt)
        self._infer = make_infer_fn(
            self.model, input_size=input_size,
            preprocess_mode=preprocess_mode, downsample=downsample,
            flip=flip, pad_factor=self.pad_factor, **self._decode_kwargs)
        self._infer_maps: Dict[int, Any] = {}   # input size -> maps-only fn
        self.auto_retry = auto_retry
        self.retry_caps = {**RETRY_CAPS, **(retry_caps or {})}
        self._retry_kwargs = dict(factor=downsample,
                                  thresh_heatmap=thresh_heatmap,
                                  gaussian_filt=gaussian_filt,
                                  **self.retry_caps)

    def __call__(self, image_bgr: np.ndarray) -> List[Dict[str, Any]]:
        return self.run(image_bgr)[0]

    def _prep(self, image_bgr: np.ndarray):
        h, w = image_bgr.shape[:2]
        scale, rh, rw, ph, pw = scale_pad_geometry(
            h, w, self.input_size, self.pad_factor)
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
        return self._run_one(self._submit_stacked([im], [meta]))

    def _run_one(self, ticket):
        """Collect a one-frame ticket -> (people, heat, paf, meta), with one
        wait for the people and both maps."""
        _, people_dev, heat, paf, _ = ticket
        people_host, (heat_h, paf_h) = read_back(people_dev, heat[0],
                                                 paf[0])
        people, metas = self._collect(ticket, people_host)
        return people[0], heat_h, paf_h, metas[0]

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
        return self._collect(submitted, people_to_host(submitted[1]))

    def _collect(self, ticket, people_host):
        """One sub-batch's people, read back as `people_host`, -> (people,
        metas), its truncated frames decoded again at the retry caps."""
        _, _, heat, paf, metas = ticket
        h_up = heat.shape[1] * self.downsample
        w_up = heat.shape[2] * self.downsample
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

    # -- multi-scale TTA ----------------------------------------------------

    def _scale_sizes(self, h: int, w: int, scales: Sequence[float]):
        """Base grid (h, w) of an (h, w) frame, each scale's input size
        (short side) and the pixels of the largest padded scaled input."""
        _, _, _, ph, pw = scale_pad_geometry(h, w, self.input_size,
                                             self.pad_factor)
        sizes = [max(self.pad_factor, int(round(self.input_size * s)))
                 for s in scales]
        max_px = max(g[3] * g[4] for g in (
            scale_pad_geometry(h, w, size, self.pad_factor)
            for size in sizes))
        return (ph // self.downsample, pw // self.downsample), sizes, max_px

    def _maps_fn(self, size: int):
        fn = self._infer_maps.get(size)
        if fn is None:
            fn = self._infer_maps[size] = make_infer_fn(
                self.model, input_size=size,
                preprocess_mode=self.preprocess_mode,
                downsample=self.downsample, flip=self.flip, decode=False,
                pad_factor=self.pad_factor)
        return fn

    def _submit_multiscale(self, ims, metas, base_hw, sizes):
        """Upload once; per scale, resize on the card and run the forward
        with flip fused; bicubic-resize every scale's maps to the base
        grid, average, decode once.  Nothing is read back."""
        with torch.inference_mode():
            frames = self._upload(ims)
            heat = paf = None
            for size in sizes:
                _, h, p = self._maps_fn(size)(frames)
                h, p = resize_bicubic(h, base_hw), resize_bicubic(p, base_hw)
                heat = h if heat is None else heat + h
                paf = p if paf is None else paf + p
            heat, paf = true_div(heat, len(sizes)), true_div(paf, len(sizes))
            people = decode_poses_batch(heat, paf, factor=self.downsample,
                                        **self._decode_kwargs)
        return ("async", people, heat, paf, list(metas))

    def run_multiscale(self, image_bgr: np.ndarray,
                       scales: Sequence[float] = MS_SCALES):
        """Multi-scale + flip TTA of one frame -> (people, heat, paf, meta)
        with the averaged maps on the base grid (the single-scale frame's
        maps), retried at :data:`RETRY_CAPS` when truncated."""
        im, meta = self._prep(image_bgr)
        base_hw, sizes, _ = self._scale_sizes(*im.shape[:2], scales)
        return self._run_one(self._submit_multiscale([im], [meta], base_hw,
                                                     sizes))

    def ms_chunk_cap(self, max_px: int) -> int:
        """Most frames per stacked multi-scale chunk whose largest scaled
        input has `max_px` pixels: the memory the chunk may use over its
        cost per frame (:data:`MS_BYTES_PER_PIXEL`, scaled by the compute
        type's width and by flip).  On the card the memory is
        :data:`MS_MEMORY_SHARE` of what is free now, the allocator's cached
        blocks included; on the CPU it is :data:`MS_HOST_MEMORY_BUDGET`."""
        dtype = getattr(self.model, "dtype", None)
        if not isinstance(dtype, torch.dtype):
            param = next(self.model.parameters(), None)
            dtype = torch.float32 if param is None else param.dtype
        width = torch.empty((), dtype=dtype).element_size()
        per_frame = (max_px * MS_BYTES_PER_PIXEL * (width / 2)
                     * (1.0 if self.flip else 0.5))
        if self.device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(self.device)
            budget = MS_MEMORY_SHARE * (
                free + torch.cuda.memory_reserved(self.device)
                - torch.cuda.memory_allocated(self.device))
        else:
            budget = MS_HOST_MEMORY_BUDGET
        return max(1, int(budget // per_frame))

    def run_multiscale_batch_submit(self, images_bgr,
                                    scales: Sequence[float] = MS_SCALES):
        """Enqueue a multi-scale TTA batch without waiting; collect with
        :meth:`run_batch_collect`.  Frames of one shape run as stacked
        chunks of at most :meth:`ms_chunk_cap` frames, mixed shapes as one
        group per shape."""
        if not images_bgr:
            return ("multi", 0, [])
        ims, metas = zip(*(self._prep(im) for im in images_bgr))
        groups: Dict[tuple, list] = {}
        for i, im in enumerate(ims):
            groups.setdefault(im.shape, []).append(i)
        sub = []
        for shape, idxs in groups.items():
            base_hw, sizes, max_px = self._scale_sizes(*shape[:2], scales)
            cap = self.ms_chunk_cap(max_px)
            for j in range(0, len(idxs), cap):
                part = idxs[j:j + cap]
                sub.append((part, self._submit_multiscale(
                    [ims[i] for i in part], [metas[i] for i in part],
                    base_hw, sizes)))
        if len(sub) == 1:
            return sub[0][1]
        return ("multi", len(ims), sub)

    def run_multiscale_batch(self, images_bgr,
                             scales: Sequence[float] = MS_SCALES):
        """Batched multi-scale TTA: submit, then collect -> (people lists,
        metas)."""
        return self.run_batch_collect(
            self.run_multiscale_batch_submit(images_bgr, scales))

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
