"""The image->skeletons serving pipeline (port of
rtpose_tpu/infer/pipeline.py:58-708).

One call covers: uint8 BGR frames scaled so their short side is
``input_size`` and zero-padded, on the host (``device_resize=False``, the
JAX package's default: ``infer/preprocess.py`` ``crop_with_factor``, equal
to ``cv2.resize`` to the bit) or on the card (``device_resize=True``:
bilinear with cv2 INTER_LINEAR parity, ops/resize.py; ``"auto"``: the
host when the frame shrinks, the card when it grows, the JAX rule) ->
shipped to the card -> normalization -> the CNN forward, with flip TTA
as a second half of the batch -> flip-swap averaging -> on-card decode
(NMS + refine, PAF scoring, greedy matching, assembly).  The host reads back fixed-shape people
arrays.  A frame whose decode overflowed a fixed-shape cap
(``People.truncated``) is decoded again from the maps still on the card
at :data:`RETRY_CAPS`; only the truncated frames are decoded again.

On the card nothing is read back between the upload of the frames and
the one readback of ``People``: :meth:`PosePipeline.run_batch_submit`
enqueues a batch and returns while the card works on it.

Multi-scale TTA (:meth:`PosePipeline.run_multiscale`, the batched
:meth:`PosePipeline.run_multiscale_batch`) resizes the frame to every
scale on the host, as the JAX package does whatever `device_resize`
says, runs one forward per scale with flip fused, resizes every scale's
maps bicubically to the base grid (cv2 INTER_CUBIC parity), averages
them and decodes once.

Sharded serving (``PosePipeline(mesh=parallel.mesh.make_mesh(devices=
...))``, rtpose_tpu/infer/pipeline.py:202-237): a model replica on each
device of the mesh; a batch (or a multi-scale chunk) is padded to a
multiple of the devices by repeating its last frame and split
contiguously, and every shard's upload, forward and decode is enqueued
before any is read back, so the shards overlap; the frames come back in
order.  A device may repeat.  ``run`` and ``run_multiscale`` of one frame
stay on the first device, as in the JAX package.
"""

from __future__ import annotations

import copy
import functools
import math
import warnings
from typing import Any, Dict, List, Optional, Sequence, Union

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
from .preprocess import (crop_with_factor, normalize_device,
                         scale_pad_geometry)

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
                  pad_factor: int = 0, device_resize: bool = True):
    """Build the uint8-frames -> people function.

    Returned fn: ``(B, H, W, 3)`` uint8 BGR frames on the model's device
    -> ``(People, heat (B, h, w, 19), paf (B, h, w, 38))``, People None
    without `decode`.  With `device_resize` the frames are raw: they are
    scaled so their short side is `input_size`, zero-padded to a multiple
    of `pad_factor` (default `downsample`: the reference crop_with_factor's
    geometry; hourglass needs 64) and normalized, all on their device;
    without it they come resized and padded (``crop_with_factor``) and are
    only normalized.  `gaussian_filt` blurs each peak's upsampled refine
    window (sigma 3) before the argmax.
    """

    @torch.inference_mode()
    def infer(images_u8: torch.Tensor):
        x = images_u8.float()
        if device_resize:
            h, w = images_u8.shape[1], images_u8.shape[2]
            _, rh, rw, ph, pw = scale_pad_geometry(h, w, input_size,
                                                   pad_factor or downsample)
            x = resize_bilinear(x, (rh, rw))
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
    :class:`PosePipeline`, which pads to the model's ``pad_multiple``.
    With a serving ``mesh`` (a keyword of :class:`PosePipeline`) the model
    is built on its first device."""
    if sum(x is not None for x in (checkpoint_dir, torch_weights,
                                   flax_params, seed)) > 1:
        raise ValueError(
            "pass one of checkpoint_dir, torch_weights, flax_params or "
            "seed: silently preferring one would evaluate the wrong model")
    mesh = kwargs.get("mesh")
    dev = resolve_device(mesh.devices[0] if mesh is not None and mesh.devices
                         else device)
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

    `device_resize` picks where a frame is scaled and padded, with the JAX
    package's rule for each value: ``False`` (the default) on the host
    (``crop_with_factor``, ``cv2.resize``'s pixels); ``True`` on the card
    (bilinear, cv2 INTER_LINEAR parity in fp32: the raw frame is shipped);
    ``"auto"`` on the host when the frame shrinks (its short side is at
    least `input_size`, and `input_size` is a multiple of the pad factor),
    else on the card.  A host-prepped frame in ``"auto"`` goes through the
    card's resize as an identity, as in the JAX package.

    `mesh` (``parallel.mesh.make_mesh(devices=[...])``): the model runs
    on the mesh's first device, a replica of it on each other one, and
    ``run_batch*`` / ``run_multiscale_batch*`` split each batch over them
    (the module docstring); `device` is then not read.
    """

    def __init__(self, model, *, device="cuda", input_size: int = 368,
                 downsample: int = 8, preprocess_mode: str = "vgg",
                 flip: bool = True, thresh_heatmap: float = 0.1,
                 max_peaks: int = 32, max_people: int = 64,
                 max_candidates: int = 256, max_total_conns: int = 160,
                 auto_retry: bool = True, retry_caps: Optional[Dict] = None,
                 gaussian_filt: bool = False, pad_factor: int = 0,
                 device_resize: Union[bool, str] = False, mesh=None):
        if device_resize not in (False, True, "auto"):
            raise ValueError(f"device_resize must be False, True or 'auto', "
                             f"got {device_resize!r}")
        if mesh is not None and not mesh.devices:
            raise ValueError("a serving mesh lists its devices "
                             "(parallel.mesh.make_mesh(devices=...)): a "
                             "mesh over a process group is for training")
        self.mesh = mesh
        self.device = resolve_device(mesh.devices[0] if mesh is not None
                                     else device)
        self.device_resize = device_resize
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
        self._infer, self._infer_maps = self._make_infer(self.model)
        self.auto_retry = auto_retry
        self.retry_caps = {**RETRY_CAPS, **(retry_caps or {})}
        self._retry_kwargs = dict(factor=downsample,
                                  thresh_heatmap=thresh_heatmap,
                                  gaussian_filt=gaussian_filt,
                                  **self.retry_caps)
        # (device, infer, infer_maps) of the data shards after the first,
        # which is this pipeline's own model: replicas of it
        self._replicas = [
            (dev, *self._make_infer(copy.deepcopy(self.model).to(dev)))
            for dev in map(resolve_device,
                           mesh.devices[1:] if mesh is not None else ())]

    def _make_infer(self, model):
        """(the frames -> people function, the multi-scale maps function,
        whose every scale comes resized from the host) of `model`."""
        return (make_infer_fn(
                    model, input_size=self.input_size,
                    preprocess_mode=self.preprocess_mode,
                    downsample=self.downsample, flip=self.flip,
                    pad_factor=self.pad_factor,
                    device_resize=bool(self.device_resize),
                    **self._decode_kwargs),
                make_infer_fn(
                    model, preprocess_mode=self.preprocess_mode,
                    downsample=self.downsample, flip=self.flip,
                    decode=False, device_resize=False))

    @property
    def n_data(self) -> int:
        """Data shards a batch splits into (1 without a mesh)."""
        return 1 + len(self._replicas)

    def _shard(self, s: int):
        """(device, infer, infer_maps) of data shard `s`."""
        if s == 0:
            return self.device, self._infer, self._infer_maps
        return self._replicas[s - 1]

    def _split(self, items: list):
        """`items` padded to a multiple of :attr:`n_data` with its last one
        -> [(indices of real items, the shard's items)] per shard."""
        padded = items + items[-1:] * (-len(items) % self.n_data)
        per = len(padded) // self.n_data
        return [(list(range(s * per, min((s + 1) * per, len(items)))),
                 padded[s * per:(s + 1) * per])
                for s in range(self.n_data)]

    def __call__(self, image_bgr: np.ndarray) -> List[Dict[str, Any]]:
        return self.run(image_bgr)[0]

    def _prep(self, image_bgr: np.ndarray):
        """(the frame to ship, meta) under `device_resize`'s rule
        (rtpose_tpu/infer/pipeline.py:295-318)."""
        if self.device_resize:
            h, w = image_bgr.shape[:2]
            if (self.device_resize == "auto"
                    and min(h, w) >= self.input_size
                    and self.input_size % self.pad_factor == 0):
                # the host resize shrinks the frame: fewer bytes to ship
                return self._prep_host(image_bgr)
            scale, rh, rw, ph, pw = scale_pad_geometry(
                h, w, self.input_size, self.pad_factor)
            meta = {"scale": scale, "real_shape": (rh, rw, 3),
                    "padded_shape": (ph, pw, 3)}
            return np.ascontiguousarray(image_bgr, np.uint8), meta
        return self._prep_host(image_bgr)

    def _prep_host(self, image_bgr: np.ndarray):
        im, scale, real_shape = crop_with_factor(
            np.ascontiguousarray(image_bgr, np.uint8), self.input_size,
            factor=self.pad_factor, is_ceil=True)
        meta = {"scale": scale, "real_shape": real_shape,
                "padded_shape": im.shape}
        return im, meta

    def _upload(self, frames, device=None) -> torch.Tensor:
        device = device or self.device
        batch = torch.from_numpy(np.stack(frames))
        if device.type == "cuda":
            batch = batch.pin_memory()
        return batch.to(device, non_blocking=True)

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
        return self._run_one(self._submit_shard(0, [im], [meta]))

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
        if self.n_data > 1:
            return ("multi", len(ims), [
                (idxs, self._submit_shard(s, part, [metas[i] for i in idxs]))
                for s, (idxs, part) in enumerate(self._split(list(ims)))])
        return self._submit_shard(0, ims, metas)

    def _submit_shard(self, shard: int, ims, metas):
        """Enqueue frames on one shard's device; `metas` may be shorter
        than `ims` (the pad frames at the end are computed, not read)."""
        device, infer, _ = self._shard(shard)
        people_dev, heat, paf = infer(self._upload(ims, device))
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
        truncated = people_host.truncated[:len(metas)]
        if self.auto_retry and truncated.any():
            # one extra decode of the truncated frames only, from the maps
            # still on the card (no second forward)
            idxs = np.nonzero(truncated)[0]
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

    def _prep_scales(self, image_bgr: np.ndarray, scales: Sequence[float]):
        """The frame resized and padded on the host for every scale, the
        base grid and meta (rtpose_tpu/infer/pipeline.py:476-495)."""
        h, w = image_bgr.shape[:2]
        scale, rh, rw, ph, pw = scale_pad_geometry(
            h, w, self.input_size, self.pad_factor)
        meta = {"scale": scale, "real_shape": (rh, rw, 3),
                "padded_shape": (ph, pw, 3)}
        base_hw, sizes, _ = self._scale_sizes(h, w, scales)
        frame = np.ascontiguousarray(image_bgr, np.uint8)
        ims = [crop_with_factor(frame, size, factor=self.pad_factor)[0]
               for size in sizes]
        return ims, base_hw, meta

    def _submit_multiscale(self, preps, shard: int = 0, n_real=None):
        """Upload each scale's frames; per scale the forward with flip
        fused; bicubic-resize every scale's maps to the base grid,
        average, decode once.  `preps` are :meth:`_prep_scales` results of
        one per-scale shape, the last ``len(preps) - n_real`` of them pad
        frames.  Nothing is read back."""
        base_hw = preps[0][1]
        device, _, infer_maps = self._shard(shard)
        with torch.inference_mode():
            heat = paf = None
            for k in range(len(preps[0][0])):
                _, h, p = infer_maps(self._upload(
                    [ims[k] for ims, _, _ in preps], device))
                h, p = resize_bicubic(h, base_hw), resize_bicubic(p, base_hw)
                heat = h if heat is None else heat + h
                paf = p if paf is None else paf + p
            n = len(preps[0][0])
            heat, paf = true_div(heat, n), true_div(paf, n)
            people = decode_poses_batch(heat, paf, factor=self.downsample,
                                        **self._decode_kwargs)
        return ("async", people, heat, paf,
                [dict(meta) for _, _, meta in preps[:n_real]])

    def _submit_multiscale_chunk(self, preps):
        """One stacked multi-scale chunk, split over the shards."""
        if self.n_data == 1:
            return self._submit_multiscale(preps)
        return ("multi", len(preps), [
            (idxs, self._submit_multiscale(part, s, len(idxs)))
            for s, (idxs, part) in enumerate(self._split(list(preps)))])

    def run_multiscale(self, image_bgr: np.ndarray,
                       scales: Sequence[float] = MS_SCALES):
        """Multi-scale + flip TTA of one frame -> (people, heat, paf, meta)
        with the averaged maps on the base grid (the single-scale frame's
        maps), retried at :data:`RETRY_CAPS` when truncated."""
        return self._run_one(self._submit_multiscale(
            [self._prep_scales(image_bgr, scales)]))

    def ms_chunk_cap(self, max_px: int) -> int:
        """Most frames per stacked multi-scale chunk whose largest scaled
        input has `max_px` pixels: the memory the chunk may use over its
        cost per frame (:data:`MS_BYTES_PER_PIXEL`, scaled by the compute
        type's width and by flip), times the data shards (a chunk splits
        over them; rtpose_tpu/infer/pipeline.py:654-660).  On the card the
        memory is :data:`MS_MEMORY_SHARE` of what is free now, the
        allocator's cached blocks included; on the CPU it is
        :data:`MS_HOST_MEMORY_BUDGET`."""
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
        cap = int(budget // per_frame)
        if cap < 1:
            # the JAX package's floor of one frame keeps its results; the
            # chunk may not fit, so say which budget it exceeds
            warnings.warn(
                f"ms_chunk_cap: one frame's largest scaled input "
                f"({max_px} px) needs {per_frame / 2**30:.2f} GiB for its "
                f"multi-scale chunk, more than the {budget / 2**30:.2f} GiB "
                f"budget (MS_MEMORY_SHARE of the card's free memory, or "
                f"MS_HOST_MEMORY_BUDGET on the CPU); running it anyway",
                RuntimeWarning, stacklevel=2)
        return max(1, cap) * self.n_data

    def run_multiscale_batch_submit(self, images_bgr,
                                    scales: Sequence[float] = MS_SCALES):
        """Enqueue a multi-scale TTA batch without waiting; collect with
        :meth:`run_batch_collect`.  Frames are grouped by the tuple of
        their per-scale padded shapes (the JAX package's key) and each
        group runs as stacked chunks of at most :meth:`ms_chunk_cap`
        frames."""
        if not images_bgr:
            return ("multi", 0, [])
        preps = [self._prep_scales(im, scales) for im in images_bgr]
        groups: Dict[tuple, list] = {}
        for i, (ims, base_hw, _) in enumerate(preps):
            key = (base_hw,) + tuple(im.shape for im in ims)
            groups.setdefault(key, []).append(i)
        sub = []
        for idxs in groups.values():
            max_px = max(im.shape[0] * im.shape[1]
                         for im in preps[idxs[0]][0])
            cap = self.ms_chunk_cap(max_px)
            for j in range(0, len(idxs), cap):
                part = idxs[j:j + cap]
                sub.append((part, self._submit_multiscale_chunk(
                    [preps[i] for i in part])))
        if len(sub) == 1:
            return sub[0][1]
        return ("multi", len(preps), sub)

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
