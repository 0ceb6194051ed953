"""Training data loader over the native C++ image pipeline (port of
rtpose_tpu/data/native_loader.py).

The PIL :class:`~rtpose_tpu_torch.data.dataset.Loader` spends most of a
worker's time on ``ColorJitter`` (PERF.md §5).  This loader keeps all
pixel work in the C++ worker pool (``native/imgpipe.cpp``, a copy of the
JAX package's: libjpeg decode with Pillow's own libjpeg-turbo, PIL-exact
photometrics, PIL-exact separable bicubic resample, fused crop/pad/
normalize) and does only the cheap parts in Python: augmentation
parameter sampling, keypoint/mask geometry (a few dozen floats per image)
and batch assembly, on one coordinator thread.

Augmentation family = the default reference training stack
(reference train/train_VGG19.py:124-130 order):
ColorJitter -> JpegCompression(p) -> Grayscale(p) -> HFlip(p) ->
RescaleRelative -> Crop -> CenterPad.  ``RandomRotate`` and blur are not
supported here: use the PIL loader for them.  :class:`AugParams`,
:func:`sample_aug` and :func:`apply_geometry` are copies of the JAX
package's; :class:`NativeLoader` yields the JAX ``NativeLoader``'s
batches element for element, as torch tensors, page-locked with
``pin_memory``.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from ..native.imgpipe import ImgPipe, jpeg_size
from .dataset import MAX_PEOPLE_PER_IMAGE
from .transforms import _SWAP17


@dataclasses.dataclass
class AugParams:
    """One image's sampled augmentation, in pipeline order."""
    brightness: float = 1.0
    contrast: float = 1.0
    saturation: float = 1.0
    hue_shift: int = -1      # -1 = no HSV round trip (jitter disabled)
    jpeg_quality: int = 0      # 0 = off
    grayscale: bool = False
    hflip: bool = False
    scale: float = 1.0
    crop_x: int = 0            # sampled only when the scaled image > edge
    crop_y: int = 0


def sample_aug(rng: np.random.Generator, w: int, h: int, *,
               square_edge: int = 368, scale_range=(0.5, 1.0),
               hflip_prob: float = 0.5, color_jitter: float = 0.1,
               hue: float = 0.1, jpeg_prob: float = 0.1,
               jpeg_quality: int = 50,
               grayscale_prob: float = 0.01) -> AugParams:
    """Draws in the exact order of transforms.train_pipeline so the
    augmentation *distribution* matches the PIL path."""
    p = AugParams()
    if color_jitter:
        p.brightness = 1.0 + (rng.random() * 2 - 1) * color_jitter
        p.contrast = 1.0 + (rng.random() * 2 - 1) * color_jitter
        p.saturation = 1.0 + (rng.random() * 2 - 1) * color_jitter
        if hue:
            # hue=0 must keep the -1 sentinel (skip the HSV round trip),
            # matching ColorJitter's `if self.hue:` — a zero-shift round
            # trip is NOT identity under uint8 HSV quantization.  Skipping
            # the draw also keeps the rng stream aligned with the PIL path.
            p.hue_shift = int((rng.random() * 2 - 1) * hue * 255) % 256
    if jpeg_prob and rng.random() <= jpeg_prob:
        p.jpeg_quality = jpeg_quality
    if grayscale_prob and rng.random() <= grayscale_prob:
        p.grayscale = True
    if hflip_prob and rng.random() <= hflip_prob:
        p.hflip = True
    if isinstance(scale_range, tuple):
        lo, hi = scale_range
        p.scale = lo + rng.random() * (hi - lo)
    else:
        p.scale = scale_range
    # Crop offsets (transforms.Crop): need the scaled size
    tw, th = int(w * p.scale), int(h * p.scale)
    pad = int(square_edge / 2.0)
    if tw > square_edge:
        p.crop_x = int(np.clip(rng.integers(-pad, tw - square_edge + pad),
                               0, tw - square_edge))
    if th > square_edge:
        p.crop_y = int(np.clip(rng.integers(-pad, th - square_edge + pad),
                               0, th - square_edge))
    return p


def apply_geometry(kp: np.ndarray, w: int, h: int, p: AugParams,
                   square_edge: int = 368):
    """Map (N, 17, 3) keypoints through the composed geometric pipeline
    using the exact formulas of data/transforms.py (HFlip/_rescale/Crop/
    CenterPad).  Returns (kp', job geometry dict)."""
    kp = np.array(kp, float)
    if p.hflip:
        kp[:, :, 0] = -kp[:, :, 0] - 1.0 + w
        if len(kp):
            kp = kp[:, _SWAP17, :]
    tw, th = int(w * p.scale), int(h * p.scale)
    x_scale, y_scale = tw / w, th / h
    kp[:, :, 0] = (kp[:, :, 0] + 0.5) * x_scale - 0.5
    kp[:, :, 1] = (kp[:, :, 1] + 0.5) * y_scale - 0.5
    new_w = min(square_edge, tw - p.crop_x)
    new_h = min(square_edge, th - p.crop_y)
    kp[:, :, 0] -= p.crop_x
    kp[:, :, 1] -= p.crop_y
    left = max(0, int((square_edge - new_w) / 2.0))
    top = max(0, int((square_edge - new_h) / 2.0))
    kp[:, :, 0] += left
    kp[:, :, 1] += top
    geom = dict(resize_wh=(tw, th), crop_xy=(p.crop_x, p.crop_y),
                content_xywh=(left, top, new_w, new_h))
    return kp, geom


class NativeLoader:
    """Drop-in replacement for :class:`dataset.Loader` (the same batch
    dict) with the pixel work in the C++ pool.  Only the default training
    augmentation family (see the module docstring).

    Batches: ``image`` float32 (B, S, S, 3) ImageNet-normalized with 0
    outside the content window, or with ``uint8_output`` the raw uint8
    canvas and ``valid_xywh`` int32 (B, 4), its content window, which the
    trainer's ``normalize_window`` turns into the float input on the
    card; ``keypoints`` float32 (B, 32, 18, 3); ``mask`` float32
    (B, S/stride, S/stride, 1); ``image_id`` int64.  With ``pin_memory``
    the tensors are page-locked, for an asynchronous copy to the card.

    With ``world > 1`` it yields rank ``rank``'s rows of each batch,
    ``[rank*B/world, (rank+1)*B/world)``, element for element: the
    coordinator samples every row's augmentation (the generator runs
    through the whole batch; that needs only each JPEG's header) and the
    pool decodes only the rank's rows.  A batch ``world`` does not divide
    is refused before the first is built.
    """

    def __init__(self, dataset, batch_size: int,
                 shuffle: bool = True, threads: int = 8, seed: int = 0,
                 drop_last: bool = True, prefetch: int = 4,
                 uint8_output: bool = False, deterministic: bool = False,
                 aug_kwargs: Dict = None, pin_memory: bool = False,
                 rank: int = 0, world: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        # deterministic=True: every __iter__ yields identical batches
        # (epoch not folded into the rng), so val losses stay comparable
        self.deterministic = deterministic
        self.uint8_output = uint8_output
        self.pin_memory = pin_memory
        self.aug_kwargs = dict(aug_kwargs or {})
        self.aug_kwargs.setdefault("square_edge", dataset.input_size)
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} of a world of {world}")
        self.rank = rank
        self.world = world
        self.pipe = ImgPipe(threads)
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else \
            (n + self.batch_size - 1) // self.batch_size

    def _make_batch(self, indices, rng) -> Dict[str, torch.Tensor]:
        edge = self.dataset.input_size
        grid = edge // self.dataset.stride
        B = len(indices) // self.world
        first = self.rank * B
        images = torch.zeros(
            (B, edge, edge, 3),
            dtype=torch.uint8 if self.uint8_output else torch.float32,
            pin_memory=self.pin_memory)
        canvases = images.numpy()     # the C++ workers write in place
        windows = np.zeros((B, 4), np.int32)   # content x, y, w, h
        all_kps = np.zeros((B, MAX_PEOPLE_PER_IMAGE, 18, 3), np.float32)
        masks = np.zeros((B, grid, grid, 1), np.float32)
        img_ids = np.zeros((B,), np.int64)
        finalize = []
        paths = []          # submit order, to name any failing file
        for row, index in enumerate(indices):
            img_id, path, kp17, corners = self.dataset.raw_sample(int(index))
            with open(path, "rb") as f:
                blob = f.read()
            w, h = jpeg_size(blob)
            p = sample_aug(rng, w, h, **self.aug_kwargs)
            bi = row - first
            if not 0 <= bi < B:
                continue        # another rank's row: sampled, not built
            paths.append(path)
            n_people = len(kp17)
            all17 = np.concatenate([kp17, corners], axis=0) \
                if (len(kp17) or len(corners)) else np.zeros((0, 17, 3))
            kp_t, geom = apply_geometry(all17, w, h, p, edge)
            self.pipe.submit(
                blob,
                out=None if self.uint8_output else canvases[bi],
                out_u8=canvases[bi] if self.uint8_output else None,
                brightness=p.brightness, contrast=p.contrast,
                saturation=p.saturation, hue_shift=p.hue_shift,
                jpeg_quality=p.jpeg_quality, grayscale=p.grayscale,
                hflip=p.hflip, **geom)
            finalize.append((bi, kp_t, n_people))
            windows[bi] = geom["content_xywh"]
            img_ids[bi] = img_id
        for bi, kp_t, n_people in finalize:
            padded, mask, _ = self.dataset.finalize_keypoints(kp_t, n_people)
            all_kps[bi] = padded
            masks[bi] = mask
        failed = self.pipe.wait_failed()
        if failed:
            names = [paths[i] for i in failed if i < len(paths)]
            raise RuntimeError(
                f"native loader: {len(failed)} image(s) failed to "
                f"decode/augment: {names[:8]}"
                f"{'...' if len(names) > 8 else ''}")
        batch = {"image": images}
        for key, arr in (("keypoints", all_kps), ("image_id", img_ids),
                         ("mask", masks)) + (
                (("valid_xywh", windows),) if self.uint8_output else ()):
            t = torch.from_numpy(arr)
            batch[key] = t.pin_memory() if self.pin_memory else t
        return batch

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        order = np.arange(len(self.dataset))
        epoch = 0 if self.deterministic else self.epoch
        rng = np.random.Generator(np.random.Philox(self.seed + epoch))
        if self.shuffle:
            rng.shuffle(order)
        self.epoch += 1
        batches = [order[i:i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        ragged = [len(b) for b in batches[:1] + batches[-1:]
                  if len(b) % self.world]
        if ragged:
            raise ValueError(
                f"a batch of {ragged[0]} does not split over {self.world} "
                f"data-parallel ranks")

        # one coordinator thread keeps `prefetch` batches staged; the C++
        # pool inside _make_batch does the pixel work with the GIL released
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                for b in batches:
                    if stop.is_set():
                        return
                    q.put(self._make_batch(b, rng))
            except BaseException as e:  # noqa: BLE001 - re-raised below
                q.put(e)
            finally:
                q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass
                t.join(timeout=0.1)
