"""Geometric and photometric training augmentation (a copy of
rtpose_tpu/data/transforms.py: numpy, PIL and scipy, which the port may
import; the tests hold every transform equal to the original's, pixels,
keypoints and meta, on the same images and rng).

Functional equivalents of the reference pipeline (reference
lib/datasets/transforms.py): Normalize, RescaleRelative/Absolute, Crop,
CenterPad, HFlip (with part swap), RandomApply, Compose, MultiScale, plus
photometric color jitter, and ``RandomRotate``, whose warp is
``cv2exact.warp_affine_cubic`` where the original calls cv2.

Differences from the reference by design: explicit
``numpy.random.Generator`` state everywhere (the reference mixes
torch/python global RNGs), PIL only for image resizing (same resampling
the reference uses), annotations as plain (N, 17, 3) numpy keypoint
arrays.
Keypoint resize convention: x' = (x + 0.5) * s - 0.5
(reference transforms.py:200-201).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import List, Sequence

import numpy as np
import PIL.Image

from ..skeleton import COCO_PART_NAMES
from .cv2exact import get_rotation_matrix_2d, warp_affine_cubic

# ImageNet statistics (reference transforms.py:41-44)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
PAD_FILL = (124, 116, 104)   # reference transforms.py:353

# COCO-17 left/right swap (by name)
_SWAP17 = np.array([
    COCO_PART_NAMES.index(
        n.replace("left_", "X_").replace("right_", "left_")
        .replace("X_", "right_"))
    for n in COCO_PART_NAMES])


@dataclasses.dataclass
class Sample:
    """image: PIL.Image; keypoints: (N, 17, 3) x,y,v; meta dict."""
    image: PIL.Image.Image
    keypoints: np.ndarray
    meta: dict

    @classmethod
    def new(cls, image: PIL.Image.Image, keypoints: np.ndarray) -> "Sample":
        w, h = image.size
        meta = {
            "offset": np.zeros(2),
            "scale": np.ones(2),
            "valid_area": np.array((0.0, 0.0, w, h)),
            "hflip": False,
            "width_height": np.array((w, h)),
        }
        return cls(image=image, keypoints=np.array(keypoints, float),
                   meta=meta)


class Transform:
    def __call__(self, sample: Sample, rng: np.random.Generator) -> Sample:
        raise NotImplementedError


class Compose(Transform):
    def __init__(self, transforms: Sequence[Transform]):
        self.transforms = list(transforms)

    def __call__(self, sample, rng):
        for t in self.transforms:
            sample = t(sample, rng)
        return sample


class RandomApply(Transform):
    def __init__(self, transform: Transform, probability: float):
        self.transform = transform
        self.probability = probability

    def __call__(self, sample, rng):
        if rng.random() > self.probability:
            return sample
        return self.transform(sample, rng)


class HFlip(Transform):
    """Mirror image + x' = -x - 1 + w + left/right part swap
    (reference transforms.py:365-389)."""

    def __call__(self, sample, rng):
        sample = _shallow(sample)
        w, _ = sample.image.size
        sample.image = sample.image.transpose(PIL.Image.FLIP_LEFT_RIGHT)
        kp = sample.keypoints.copy()
        kp[:, :, 0] = -kp[:, :, 0] - 1.0 + w
        kp = kp[:, _SWAP17, :]
        sample.keypoints = kp
        va = sample.meta["valid_area"].copy()
        va[0] = -(va[0] + va[2]) + w
        sample.meta = dict(sample.meta, hflip=True, valid_area=va)
        return sample


class RescaleRelative(Transform):
    """Random scale in [lo, hi] (reference transforms.py:159-207)."""

    def __init__(self, scale_range=(0.5, 1.0),
                 resample=PIL.Image.BICUBIC):
        self.scale_range = scale_range
        self.resample = resample

    def __call__(self, sample, rng):
        if isinstance(self.scale_range, tuple):
            lo, hi = self.scale_range
            factor = lo + rng.random() * (hi - lo)
        else:
            factor = self.scale_range
        return _rescale(sample, factor, factor, self.resample)


class RescaleAbsolute(Transform):
    """Scale long edge to a target (reference transforms.py:210-260)."""

    def __init__(self, long_edge, resample=PIL.Image.BICUBIC):
        self.long_edge = long_edge
        self.resample = resample

    def __call__(self, sample, rng):
        w, h = sample.image.size
        edge = self.long_edge
        if isinstance(edge, (tuple, list)):
            edge = int(rng.integers(edge[0], edge[1]))
        s = edge / max(h, w)
        return _rescale(sample, s, s, self.resample,
                        target=(edge if w >= h else int(w * s),
                                edge if h > w else int(h * s)))


class Crop(Transform):
    """Random crop to a square window (reference transforms.py:263-313)."""

    def __init__(self, long_edge: int):
        self.long_edge = long_edge

    def __call__(self, sample, rng):
        sample = _shallow(sample)
        w, h = sample.image.size
        pad = int(self.long_edge / 2.0)
        x_off = y_off = 0
        if w > self.long_edge:
            x_off = int(np.clip(rng.integers(-pad, w - self.long_edge + pad),
                                0, w - self.long_edge))
        if h > self.long_edge:
            y_off = int(np.clip(rng.integers(-pad, h - self.long_edge + pad),
                                0, h - self.long_edge))
        new_w = min(self.long_edge, w - x_off)
        new_h = min(self.long_edge, h - y_off)
        ltrb = (x_off, y_off, x_off + new_w, y_off + new_h)
        sample.image = sample.image.crop(ltrb)
        kp = sample.keypoints.copy()
        kp[:, :, 0] -= x_off
        kp[:, :, 1] -= y_off
        sample.keypoints = kp
        meta = dict(sample.meta)
        meta["offset"] = meta["offset"] + np.array((x_off, y_off), float)
        # reference-exact valid-area update (transforms.py:277-281),
        # INCLUDING its quirk: the size row subtracts the crop offset even
        # when the valid-area origin is nonzero, over-shrinking the region
        # if Crop runs after another origin-shifting transform.  Kept
        # verbatim — train-time masking parity beats geometric nicety here.
        va = meta["valid_area"].copy()
        va[:2] = np.maximum(0.0, va[:2] - (x_off, y_off))
        va[2:] = np.maximum(0.0, va[2:] - (x_off, y_off))
        va[2:] = np.minimum(va[2:], (new_w, new_h))
        meta["valid_area"] = va
        sample.meta = meta
        return sample


class CenterPad(Transform):
    """Pad to target with mean-pixel fill (reference transforms.py:316-362)."""

    def __init__(self, target_size: int):
        if isinstance(target_size, int):
            target_size = (target_size, target_size)
        self.target_size = target_size

    def __call__(self, sample, rng):
        sample = _shallow(sample)
        w, h = sample.image.size
        left = int((self.target_size[0] - w) / 2.0)
        top = int((self.target_size[1] - h) / 2.0)
        left = max(0, left)
        top = max(0, top)
        canvas = PIL.Image.new("RGB", self.target_size, PAD_FILL)
        canvas.paste(sample.image, (left, top))
        sample.image = canvas
        kp = sample.keypoints.copy()
        kp[:, :, 0] += left
        kp[:, :, 1] += top
        sample.keypoints = kp
        meta = dict(sample.meta)
        meta["offset"] = meta["offset"] - np.array((left, top), float)
        va = meta["valid_area"].copy()
        va[:2] += (left, top)
        meta["valid_area"] = va
        sample.meta = meta
        return sample


class RandomRotate(Transform):
    """Rotate +-max_degrees with canvas expansion
    (reference transforms.py:403-480).  The JAX package warps with
    ``cv2.warpAffine``; this copy warps with ``cv2exact``'s, which equals
    it to the bit (INTER_CUBIC, BORDER_CONSTANT 128)."""

    def __init__(self, max_degrees: float = 40.0):
        self.max_degrees = max_degrees

    def __call__(self, sample, rng):
        sample = _shallow(sample)
        degree = (rng.random() - 0.5) * 2 * self.max_degrees
        img = np.asarray(sample.image)
        h, w = img.shape[:2]
        cx, cy = w // 2, h // 2
        M = get_rotation_matrix_2d((cx, cy), -degree, 1.0)
        cos, sin = abs(M[0, 0]), abs(M[0, 1])
        nw = int(h * sin + w * cos)
        nh = int(h * cos + w * sin)
        M[0, 2] += nw / 2 - cx
        M[1, 2] += nh / 2 - cy
        rot = warp_affine_cubic(img, M, (nw, nh),
                                border_value=(128, 128, 128))
        sample.image = PIL.Image.fromarray(rot)
        kp = sample.keypoints.copy()
        pts = np.concatenate([kp[:, :, :2],
                              np.ones((*kp.shape[:2], 1))], axis=2)
        kp[:, :, :2] = pts @ M.T
        sample.keypoints = kp
        meta = dict(sample.meta)
        meta["valid_area"] = _rotate_box(meta["valid_area"], M)
        sample.meta = meta
        return sample


def adjust_hue(img: PIL.Image.Image, hue_factor: float) -> PIL.Image.Image:
    """Shift hue by `hue_factor` of the color circle (in [-0.5, 0.5]).

    Replicates torchvision's PIL path: HSV split, uint8 H channel shifted
    with wraparound, merge back (the formula behind the reference's
    ColorJitter hue=0.1, transforms.py:53-58).
    """
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError(f"hue_factor {hue_factor} not in [-0.5, 0.5]")
    h, s, v = img.convert("HSV").split()
    np_h = np.asarray(h, dtype=np.int16)
    # torchvision does uint8 += uint8(hue_factor*255): C-cast truncation
    # toward zero plus mod-256 wraparound on the hue circle
    shift = int(hue_factor * 255) % 256
    np_h = ((np_h + shift) % 256).astype(np.uint8)
    h = PIL.Image.fromarray(np_h, "L")
    return PIL.Image.merge("HSV", (h, s, v)).convert("RGB")


class ColorJitter(Transform):
    """Brightness/contrast/saturation/hue jitter (photometric analogue of
    reference transforms.py:53-65, all four components at strength 0.1).
    Applied in fixed order (torchvision shuffles the order per call — a
    distribution-level, not value-level, difference)."""

    def __init__(self, strength: float = 0.1, hue: float = 0.1):
        self.strength = strength
        self.hue = hue

    def __call__(self, sample, rng):
        from PIL import ImageEnhance
        sample = _shallow(sample)
        img = sample.image
        for enhancer in (ImageEnhance.Brightness, ImageEnhance.Contrast,
                         ImageEnhance.Color):
            f = 1.0 + (rng.random() * 2 - 1) * self.strength
            img = enhancer(img).enhance(f)
        if self.hue:
            img = adjust_hue(img, (rng.random() * 2 - 1) * self.hue)
        sample.image = img
        return sample


class RandomGrayscale(Transform):
    def __init__(self, probability: float = 0.01):
        self.probability = probability

    def __call__(self, sample, rng):
        if rng.random() > self.probability:
            return sample
        sample = _shallow(sample)
        sample.image = sample.image.convert("L").convert("RGB")
        return sample


class Blur(Transform):
    """Random gaussian blur up to max_sigma (reference transforms.py:34-38)."""

    def __init__(self, max_sigma: float = 5.0):
        self.max_sigma = max_sigma

    def __call__(self, sample, rng):
        from scipy.ndimage import gaussian_filter
        sample = _shallow(sample)
        sigma = self.max_sigma * rng.random()
        arr = np.asarray(sample.image)
        arr = gaussian_filter(arr, sigma=(sigma, sigma, 0))
        sample.image = PIL.Image.fromarray(arr)
        return sample


class JpegCompression(Transform):
    """Jpeg artifact augmentation (reference transforms.py:28-31)."""

    def __init__(self, quality: int = 50):
        self.quality = quality

    def __call__(self, sample, rng):
        import io
        sample = _shallow(sample)
        buf = io.BytesIO()
        sample.image.save(buf, "jpeg", quality=self.quality)
        buf.seek(0)
        sample.image = PIL.Image.open(buf).convert("RGB")
        return sample


class MultiScale(Transform):
    """Apply several pipelines, return list of samples
    (reference transforms.py:139-156)."""

    def __init__(self, pipelines: Sequence[Transform]):
        self.pipelines = list(pipelines)

    def __call__(self, sample, rng):
        return [p(copy.deepcopy(sample), rng) for p in self.pipelines]


def keypoint_sets_inverse(keypoint_sets: np.ndarray, meta: dict
                          ) -> np.ndarray:
    """Map predicted keypoint sets back through the augmentation meta to
    original-image coordinates (reference transforms.py:74-90).

    keypoint_sets: (N, parts, 3) [x, y, v] in transformed-image coords.
    meta: a Sample.meta produced by this module's transforms (offset/scale
    accumulated by Crop/CenterPad/Rescale, hflip flag, original
    width_height).  The formula assumes HFlip ran BEFORE the geometric
    transforms, as in the reference training pipeline
    (train_VGG19.py:124-130) and :func:`train_pipeline`; the swap tables
    apply only to 17-keypoint COCO sets.
    """
    kps = np.array(keypoint_sets, float)
    kps[:, :, 0] += meta["offset"][0]
    kps[:, :, 1] += meta["offset"][1]
    kps[:, :, 0] = (kps[:, :, 0] + 0.5) / meta["scale"][0] - 0.5
    kps[:, :, 1] = (kps[:, :, 1] + 0.5) / meta["scale"][1] - 0.5
    if meta.get("hflip"):
        w = meta["width_height"][0]
        kps[:, :, 0] = -kps[:, :, 0] - 1.0 + w
        if kps.shape[1] == len(_SWAP17):
            kps = kps[:, _SWAP17, :]
    return kps


# --- helpers ---------------------------------------------------------------

def _shallow(sample: Sample) -> Sample:
    return Sample(image=sample.image, keypoints=sample.keypoints,
                  meta=dict(sample.meta))


def _rescale(sample, fx, fy, resample, target=None) -> Sample:
    sample = _shallow(sample)
    w, h = sample.image.size
    if target is None:
        target = (int(w * fx), int(h * fy))
    sample.image = sample.image.resize(target, resample)
    x_scale = sample.image.size[0] / w
    y_scale = sample.image.size[1] / h
    kp = sample.keypoints.copy()
    kp[:, :, 0] = (kp[:, :, 0] + 0.5) * x_scale - 0.5
    kp[:, :, 1] = (kp[:, :, 1] + 0.5) * y_scale - 0.5
    sample.keypoints = kp
    meta = dict(sample.meta)
    sf = np.array((x_scale, y_scale))
    meta["offset"] = meta["offset"] * sf
    meta["scale"] = meta["scale"] * sf
    va = meta["valid_area"].copy()
    va[:2] *= sf
    va[2:] *= sf
    meta["valid_area"] = va
    sample.meta = meta
    return sample


def _rotate_box(bbox, M):
    corners = np.array([
        [bbox[0], bbox[1], 1],
        [bbox[0] + bbox[2], bbox[1], 1],
        [bbox[0], bbox[1] + bbox[3], 1],
        [bbox[0] + bbox[2], bbox[1] + bbox[3], 1],
    ])
    pts = corners @ M.T
    x0, y0 = pts[:, 0].min(), pts[:, 1].min()
    x1, y1 = pts[:, 0].max(), pts[:, 1].max()
    return np.array([x0, y0, x1 - x0, y1 - y0])


def image_to_tensor(image: PIL.Image.Image, train: bool = False
                    ) -> np.ndarray:
    """PIL -> HWC float32 ImageNet-normalized (reference transforms.py:47-50
    image_transform, HWC instead of CHW)."""
    arr = np.asarray(image, np.float32) / 255.0
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


def mask_valid_area(image_hwc: np.ndarray, valid_area) -> np.ndarray:
    """Zero the image outside the crop-valid region (integer-snapped like
    reference lib/datasets/utils.py:36-53)."""
    out = image_hwc
    x0 = int(np.clip(np.round(valid_area[0]), 0, out.shape[1]))
    y0 = int(np.clip(np.round(valid_area[1]), 0, out.shape[0]))
    x1 = int(np.clip(np.round(valid_area[0] + valid_area[2]), 0,
                     out.shape[1]))
    y1 = int(np.clip(np.round(valid_area[1] + valid_area[3]), 0,
                     out.shape[0]))
    out[:y0, :, :] = 0
    out[y1:, :, :] = 0
    out[:, :x0, :] = 0
    out[:, x1:, :] = 0
    return out


def train_pipeline(square_edge: int = 368,
                   scale_range=(0.5, 1.0),
                   hflip_prob: float = 0.5,
                   rotate_degrees: float = 0.0,
                   color_jitter: float = 0.1,
                   jpeg_prob: float = 0.1,
                   grayscale_prob: float = 0.01) -> Compose:
    """The reference training augmentation stack
    (reference train/train_VGG19.py:124-130 + transforms.py:53-65)."""
    ts: List[Transform] = []
    if color_jitter:
        ts.append(ColorJitter(color_jitter))
    if jpeg_prob:
        ts.append(RandomApply(JpegCompression(), jpeg_prob))
    if grayscale_prob:
        ts.append(RandomGrayscale(grayscale_prob))
    if hflip_prob:
        ts.append(RandomApply(HFlip(), hflip_prob))
    if rotate_degrees:
        ts.append(RandomRotate(rotate_degrees))
    ts.append(RescaleRelative(scale_range))
    ts.append(Crop(square_edge))
    ts.append(CenterPad(square_edge))
    return Compose(ts)
