"""COCO keypoint dataset and the worker-process batch loader (port of
rtpose_tpu/data/dataset.py).

Decode and augment on host workers; the ground-truth heatmaps and PAFs
are synthesised on the card from the padded keypoints (K4,
``data/gt.py`` ``ground_truth_maps_batch``), so only (B, 32, 18, 3)
keypoints travel with the images.  Host-side synthesis stays available for
parity (``host_gt=True``, the port's copy of the numpy GT oracle).

``add_neck``, ``remove_illegal_joints``, :class:`CocoKeypoints`,
:class:`ConcatKeypoints`, :class:`ImageList` and :class:`PilImageList` are
copies of the JAX package's; :class:`Loader` draws the same batches as the
JAX ``Loader`` but in worker processes (``torch.utils.data.DataLoader``),
as the reference feeds its trainer (reference train/train_VGG19.py:62-64).
"""

from __future__ import annotations

import atexit
import dataclasses
import gc
import multiprocessing
import multiprocessing.forkserver
import multiprocessing.resource_tracker
import multiprocessing.util
import os
from typing import Dict, Iterator, List, Optional

import numpy as np
import PIL.Image
import torch
import torch.utils.data

from ..skeleton import COCO_TO_OURS, NUM_PARTS
from . import transforms as T
from .coco_json import CocoJson
from .gt import ground_truth_maps

MAX_PEOPLE_PER_IMAGE = 32


def add_neck(kp17: np.ndarray) -> np.ndarray:
    """(17, 3) COCO keypoints -> (18, 3) in our part order.

    Neck synthesized as the shoulder midpoint; visible only if both
    shoulders are labeled (reference lib/datasets/datasets.py:227-257,
    including the round() of the synthesized row).
    """
    l_sho, r_sho = kp17[5], kp17[6]
    neck = (l_sho + r_sho) / 2.0
    if l_sho[2] == 2 and r_sho[2] == 2:
        neck[2] = 2
    else:
        neck[2] = l_sho[2] * r_sho[2]
    neck = np.round(neck)
    ext = np.vstack([kp17, neck[None]])
    return ext[list(COCO_TO_OURS), :]


def remove_illegal_joints(kps: np.ndarray, input_x: int,
                          input_y: int) -> np.ndarray:
    """Zero out keypoints outside the crop
    (reference datasets.py:216-225)."""
    kps = kps.copy()
    bad = ((kps[:, :, 0] >= input_x) | (kps[:, :, 0] < 0)
           | (kps[:, :, 1] >= input_y) | (kps[:, :, 1] < 0))
    kps[bad] = (-1.0, -1.0, 0.0)
    return kps


class _ImageRecords:
    """What ``CocoKeypoints.get`` reads of the annotation file, per image
    of `ids`: its file name, its labelled people's (17, 3) keypoints and
    the boxes of its crowd and unlabelled person annotations, in the
    file's order, as flat arrays.  Workers are sent these in place of the
    parsed JSON (segmentations and all), so a worker's start and memory
    grow with the keypoints, not with the file."""

    def __init__(self, coco: CocoJson, ids: List[int], cats: List[int]):
        self.files = [coco.image_info(i)["file_name"] for i in ids]
        kps, boxes = [], []
        kp_off, box_off = [0], [0]
        for img_id in ids:
            for a in coco.annotations(img_id, cats):
                # classify by index: dict-value membership is O(n^2) and
                # misgroups duplicate annotations
                if (not a.get("iscrowd", 0) and any(
                        v > 0 for v in (a.get("keypoints") or [])[2::3])):
                    kps.append(np.asarray(a["keypoints"], float)
                               .reshape(17, 3))
                else:
                    boxes.append(np.asarray(a.get("bbox", (0, 0, 0, 0)),
                                            float))
            kp_off.append(len(kps))
            box_off.append(len(boxes))
        self.kps = (np.stack(kps) if kps else np.zeros((0, 17, 3)))
        self.boxes = (np.stack(boxes) if boxes else np.zeros((0, 4)))
        self.kp_off = np.asarray(kp_off)
        self.box_off = np.asarray(box_off)

    def get(self, index: int):
        """(file name, kp17 (P, 17, 3), boxes (U, 4) as (x, y, w, h))."""
        kp = self.kps[self.kp_off[index]:self.kp_off[index + 1]].copy()
        box = self.boxes[self.box_off[index]:self.box_off[index + 1]]
        return self.files[index], kp, box.tolist()


@dataclasses.dataclass
class CocoKeypoints:
    """Map-style dataset yielding dict samples.

    keys: image (H, W, 3) float32 normalized; keypoints
    (MAX_PEOPLE, 18, 3) float32 padded with v=0; mask (gy, gx, 1);
    image_id; heatmaps/pafs when host_gt.
    """
    image_dir: str
    ann_file: str
    preprocess: Optional[T.Transform] = None
    input_size: int = 368
    stride: int = 8
    sigma: float = 7.0
    host_gt: bool = False
    all_images: bool = False
    n_images: Optional[int] = None

    def __post_init__(self):
        coco = CocoJson(self.ann_file)
        self.person_cats = coco.cat_ids("person")
        if self.all_images:
            self.ids = coco.img_ids()
        else:
            self.ids = coco.ids_with_keypoints(self.person_cats)
        if self.n_images:
            self.ids = self.ids[:self.n_images]
        self._records = _ImageRecords(coco, self.ids, self.person_cats)
        if self.preprocess is None:
            self.preprocess = T.train_pipeline(self.input_size)

    def __len__(self) -> int:
        return len(self.ids)

    def raw_sample(self, index: int):
        """Annotation prep without pixel work: (img_id, path, kp17
        (P, 17, 3), corner_sets (U, 17, 3) fake keypoint sets carrying
        crowd/unlabeled bbox corners for the loss mask)."""
        file_name, kp17, boxes = self._records.get(index)
        path = os.path.join(self.image_dir, file_name)

        # Carry crowd/unlabeled-region bbox corners through the geometric
        # transforms as fake keypoint sets so the loss mask follows the
        # augmentation (the reference's mask_miss analogue).
        corner_sets = []
        for x, y, w, h in boxes:
            c = np.zeros((17, 3))
            c[0] = (x, y, 2)
            c[1] = (x + w, y, 2)
            c[2] = (x, y + h, 2)
            c[3] = (x + w, y + h, 2)
            corner_sets.append(c)
        corners = (np.stack(corner_sets) if corner_sets
                   else np.zeros((0, 17, 3)))
        return self.ids[index], path, kp17, corners

    def finalize_keypoints(self, keypoints: np.ndarray, n_people: int):
        """Post-geometric keypoint finalization: neck synthesis,
        illegal-joint removal, fixed-shape padding, and the
        crowd/unlabeled-region loss mask from the transformed corner sets.
        Returns (padded (MAX, 18, 3), mask (gy, gx, 1), kps18)."""
        people_kp = keypoints[:n_people]
        region_kp = keypoints[n_people:]
        if len(people_kp):
            kps18 = np.stack([add_neck(k) for k in people_kp])
        else:
            kps18 = np.zeros((0, NUM_PARTS, 3))
        kps18 = remove_illegal_joints(kps18, self.input_size,
                                      self.input_size)

        padded = np.zeros((MAX_PEOPLE_PER_IMAGE, NUM_PARTS, 3), np.float32)
        n = min(len(kps18), MAX_PEOPLE_PER_IMAGE)
        padded[:n] = kps18[:n]

        gy = gx = self.input_size // self.stride
        mask = np.ones((gy, gx, 1), np.float32)
        for region in region_kp:
            pts = region[region[:, 2] > 0, :2]
            if not len(pts):
                continue
            x0 = int(np.clip(np.floor(pts[:, 0].min() / self.stride),
                             0, gx))
            x1 = int(np.clip(np.ceil(pts[:, 0].max() / self.stride),
                             0, gx))
            y0 = int(np.clip(np.floor(pts[:, 1].min() / self.stride),
                             0, gy))
            y1 = int(np.clip(np.ceil(pts[:, 1].max() / self.stride),
                             0, gy))
            mask[y0:y1, x0:x1, :] = 0.0
        return padded, mask, kps18

    def get(self, index: int, rng: np.random.Generator) -> Dict:
        img_id, path, kp17, corners = self.raw_sample(index)
        with open(path, "rb") as f:
            image = PIL.Image.open(f).convert("RGB")
        n_people = len(kp17)
        all_kp = np.concatenate([kp17, corners], axis=0) \
            if (len(kp17) or len(corners)) else np.zeros((0, 17, 3))

        sample = T.Sample.new(image, all_kp)
        sample = self.preprocess(sample, rng)

        arr = T.image_to_tensor(sample.image)
        arr = T.mask_valid_area(arr, sample.meta["valid_area"])

        padded, mask, kps18 = self.finalize_keypoints(sample.keypoints,
                                                      n_people)
        out = {"image": arr.astype(np.float32), "keypoints": padded,
               "image_id": img_id, "mask": mask}
        if self.host_gt:
            heat, paf = ground_truth_maps(
                kps18, input_y=self.input_size, input_x=self.input_size,
                stride=self.stride, sigma=self.sigma)
            out["heatmaps"] = heat.astype(np.float32)
            out["pafs"] = paf.astype(np.float32)
        return out


class ConcatKeypoints:
    """Concatenation of map-style keypoint datasets.

    The reference trains on a ``torch.utils.data.ConcatDataset`` over ALL
    of ``args.train_annotations`` (reference train/train_VGG19.py:50-60);
    this exposes the surface :class:`Loader` (``get``) and a native loader
    (``raw_sample``/``finalize_keypoints``/``input_size``/``stride``)
    consume, with global indices mapped to (dataset, local index).
    """

    _SHARED = ("input_size", "stride", "sigma", "host_gt")

    def __init__(self, datasets):
        datasets = list(datasets)
        if not datasets:
            raise ValueError("ConcatKeypoints needs at least one dataset")
        for attr in self._SHARED:
            vals = {getattr(d, attr) for d in datasets}
            if len(vals) != 1:
                raise ValueError(
                    f"ConcatKeypoints datasets disagree on {attr}: {vals}")
            setattr(self, attr, next(iter(vals)))
        self.datasets = datasets
        self._offsets = np.cumsum([0] + [len(d) for d in datasets])

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def _locate(self, index: int):
        if not 0 <= index < len(self):
            raise IndexError(index)
        di = int(np.searchsorted(self._offsets, index, side="right")) - 1
        return self.datasets[di], index - int(self._offsets[di])

    def get(self, index: int, rng: np.random.Generator) -> Dict:
        ds, i = self._locate(index)
        return ds.get(i, rng)

    def raw_sample(self, index: int):
        ds, i = self._locate(index)
        return ds.raw_sample(i)

    def finalize_keypoints(self, keypoints: np.ndarray, n_people: int):
        # pure function of the shared (input_size, stride) geometry
        return self.datasets[0].finalize_keypoints(keypoints, n_people)


class ImageList:
    """Plain image-path dataset for batch inference
    (reference lib/datasets/datasets.py:314-334)."""

    def __init__(self, image_paths, transform=None):
        self.image_paths = list(image_paths)
        self.transform = transform

    def __len__(self):
        return len(self.image_paths)

    def __getitem__(self, index):
        path = self.image_paths[index]
        with open(path, "rb") as f:
            image = PIL.Image.open(f).convert("RGB")
        original = np.asarray(image, np.float32) / 255.0
        arr = (self.transform(image) if self.transform
               else T.image_to_tensor(image))
        return path, original, arr


class PilImageList:
    """In-memory PIL image dataset (reference datasets.py:337-350)."""

    def __init__(self, images, transform=None):
        self.images = list(images)
        self.transform = transform

    def __len__(self):
        return len(self.images)

    def __getitem__(self, index):
        image = self.images[index].copy().convert("RGB")
        original = np.asarray(image, np.float32) / 255.0
        arr = (self.transform(image) if self.transform
               else T.image_to_tensor(image))
        return index, original, arr


# ---------------------------------------------------------------------------
# the loader
# ---------------------------------------------------------------------------

# Workers are forked from the forkserver: a process started fresh, with no
# thread of JAX's (the parity tests) or CUDA's (training on the card), so a
# fork cannot catch a lock another thread holds.  It preloads this module,
# so workers start as forks with torch and PIL imported (torch's import
# alone takes seconds); each re-imports the main module, as under spawn.
_WORKER_MODULE = __name__


def _worker_context():
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload([_WORKER_MODULE])
    atexit.unregister(stop_worker_processes)   # registered once
    atexit.register(stop_worker_processes, at_exit=True)
    return ctx


def stop_worker_processes(at_exit: bool = False) -> None:
    """Stop the processes the workers needed: each process the forkserver
    started and still running, the forkserver, and multiprocessing's
    resource tracker, and wait for each.  Left to themselves the last two
    end only after the program has.  Runs at exit once a ``Loader`` has
    started workers; a later ``Loader`` starts them anew."""
    gc.collect()    # a dropped epoch's DataLoader shuts its workers down
    workers = [p for p in multiprocessing.active_children()
               if isinstance(p, multiprocessing.context.ForkServerProcess)]
    for p in workers:
        p.terminate()
    for p in workers:
        p.join()
    # no public call stops these two (CPython's own tests use _stop)
    multiprocessing.forkserver._forkserver._stop()
    if at_exit:
        # multiprocessing's own exit work needs the tracker: its
        # finalizers release the semaphores of an epoch still open
        multiprocessing.util._exit_function()
    multiprocessing.resource_tracker._resource_tracker._stop()


class _BatchStream(torch.utils.data.IterableDataset):
    """One epoch's batches as the JAX ``Loader``'s workers draw them
    (rtpose_tpu/data/dataset.py:317-349): worker ``w`` of ``streams``
    builds batches ``w, w + streams, ...`` in order with its own
    ``Generator(Philox([seed, epoch, w]))`` and yields ``(bi, batch)``,
    the batch cut to rank ``rank``'s rows of ``world``."""

    def __init__(self, dataset, batches: List[np.ndarray], seed: int,
                 epoch: int, streams: int, rank: int = 0, world: int = 1):
        self.dataset = dataset
        self.batches = batches
        self.seed = seed
        self.epoch = epoch
        self.streams = streams
        self.rank = rank
        self.world = world

    def __iter__(self):
        info = torch.utils.data.get_worker_info()
        worker_id = 0 if info is None else info.id
        rng = np.random.Generator(
            np.random.Philox([self.seed, self.epoch, worker_id]))
        for bi in range(worker_id, len(self.batches), self.streams):
            samples = [self.dataset.get(int(i), rng)
                       for i in self.batches[bi]]
            per = len(samples) // self.world
            samples = samples[self.rank * per:(self.rank + 1) * per]
            yield bi, {k: torch.from_numpy(np.stack([s[k] for s in samples]))
                       for k in samples[0]}


class Loader:
    """Shuffling loader of tensor batches, built in worker processes.

    For the same seed and ``num_workers`` it yields the JAX ``Loader``'s
    batches element for element: the order from ``Philox(seed + epoch)``,
    batch ``bi`` drawn by worker ``bi % num_workers`` from its own
    generator; ``num_workers=0`` draws every batch in this process with
    worker 0's generator (JAX's ``num_workers=1``).  Batches: ``image``
    float32 (B, S, S, 3), ``keypoints`` float32 (B, 32, 18, 3), ``mask``
    float32 (B, S/stride, S/stride, 1), ``image_id`` int64.

    With ``world > 1`` it yields rank ``rank``'s rows of each of those
    batches, ``[rank*B/world, (rank+1)*B/world)``, element for element
    (the data-parallel trainer's share of the global batch ``B``); a batch
    ``world`` does not divide is refused before any worker starts.  The
    generators run through every row in order, so each rank's workers draw
    the whole global batch and keep their rows: world times a rank's share
    of the augmentation work, as in the JAX package, whose processes each
    load the global batch.

    Each epoch starts its own workers, and they stop at its end, when the
    caller leaves it, or on a worker's exception, which is raised here.
    ``prefetch`` batches are in flight in all, at least one a worker;
    ``pin_memory`` puts batches in page-locked memory for an asynchronous
    copy to the card; a worker that delivers nothing for ``timeout``
    seconds raises.  Workers never touch CUDA.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 4, seed: int = 0, drop_last: bool = True,
                 prefetch: int = 4, deterministic: bool = False,
                 pin_memory: bool = False, timeout: float = 300.0,
                 rank: int = 0, world: int = 1):
        # deterministic=True: every __iter__ yields identical batches
        # (epoch is not folded into the rng), so a val loss is comparable
        # across epochs instead of moving with per-epoch crop/jitter noise
        if not 0 < timeout < float("inf"):
            raise ValueError(f"timeout must be finite and > 0, got {timeout}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(0, num_workers)
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.deterministic = deterministic
        self.pin_memory = pin_memory
        self.timeout = timeout
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} of a world of {world}")
        self.rank = rank
        self.world = world
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else \
            (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        epoch = 0 if self.deterministic else self.epoch
        self.epoch += 1
        order = np.arange(len(self.dataset))
        rng = np.random.Generator(np.random.Philox(self.seed + epoch))
        if self.shuffle:
            rng.shuffle(order)
        batches = [order[i:i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        if not batches:
            return
        ragged = [len(b) for b in (batches[0], batches[-1])
                  if len(b) % self.world]
        if ragged:
            raise ValueError(
                f"a batch of {ragged[0]} does not split over {self.world} "
                f"data-parallel ranks")
        # a worker past the last batch would draw nothing; each of the
        # others keeps its id, its generator and its batches
        workers = min(self.num_workers, len(batches))
        stream = _BatchStream(self.dataset, batches, self.seed, epoch,
                              max(1, workers), self.rank, self.world)
        kw = {}
        if workers:
            kw = dict(num_workers=workers, timeout=self.timeout,
                      multiprocessing_context=_worker_context(),
                      prefetch_factor=max(1, -(-self.prefetch // workers)))
        # DataLoader takes the workers' items round robin and skips a
        # worker once it is done, so items arrive in bi order
        for want, (bi, batch) in enumerate(torch.utils.data.DataLoader(
                stream, batch_size=None, pin_memory=self.pin_memory, **kw)):
            if bi != want:
                raise RuntimeError(f"DataLoader delivered batch {bi} where "
                                   f"{want} was due")
            yield batch
