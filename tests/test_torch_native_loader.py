"""The port's native loader against the JAX package's, on the CPU.

``native/imgpipe.cpp`` is a copy of the JAX package's; the port builds it
against the vendored libjpeg-turbo headers and links Pillow's bundled
libjpeg.  Here both libraries run on the same JPEGs: ``ImgPipe`` op by op
(decode, photometrics, the hue round trip, recompression, the bicubic
resample, the whole chain, failure indices, buffer retention), each equal
to the JAX pool's output and to PIL's; ``NativeLoader`` batches element
for element against the JAX ``NativeLoader`` (float32 and uint8,
shuffled and deterministic, a ``ConcatKeypoints`` epoch); against the
port's PIL ``Loader`` with augmentation off; and one CPU train step on a
uint8 batch.  The JAX library is built into this module's temporary
directory, so it never races other test files for
``rtpose_tpu/native/libimgpipe.so``.
"""

import io
import json
import os
import subprocess
import sys

import numpy as np
import PIL.Image
import pytest
import torch

from rtpose_tpu.data import dataset as jdataset
from rtpose_tpu.data import native_loader as jnative
from rtpose_tpu.data import transforms as JT
from rtpose_tpu.native import imgpipe as jimgpipe
from rtpose_tpu_torch.data import dataset as tdataset
from rtpose_tpu_torch.data import native_loader as tnative
from rtpose_tpu_torch.data import transforms as TT
from rtpose_tpu_torch.native import imgpipe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EDGE = 64


@pytest.fixture(scope="module", autouse=True)
def _private_jax_library(tmp_path_factory):
    """The JAX binding compiles its own copy of imgpipe.cpp into this
    module's temporary directory."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jimgpipe, "_LIB_PATH",
               str(tmp_path_factory.mktemp("jaxlib") / "libimgpipe.so"))
    mp.setattr(jimgpipe, "_lib", None)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def pipes():
    return imgpipe.ImgPipe(2), jimgpipe.ImgPipe(2)


@pytest.fixture(scope="module")
def jpg():
    rng = np.random.default_rng(0)
    arr = (rng.random((60, 80, 3)) * 255).astype(np.uint8)
    buf = io.BytesIO()
    PIL.Image.fromarray(arr).save(buf, "jpeg", quality=92)
    return buf.getvalue()


def _run(pipe, jpg, ow, oh, **kw):
    out = np.zeros((oh, ow, 3), np.float32)
    u8 = np.zeros((oh, ow, 3), np.uint8)
    kw.setdefault("content_xywh", (0, 0, ow, oh))
    pipe.submit(jpg, out=out, out_u8=u8, **kw)
    pipe.wait()
    return out, u8


def _pil(jpg):
    return PIL.Image.open(io.BytesIO(jpg)).convert("RGB")


def _cases(jpg):
    """(submit kwargs, output (w, h), PIL's pixels) for every op."""
    from PIL import ImageEnhance
    pil = _pil(jpg)
    buf = io.BytesIO()
    pil.save(buf, "jpeg", quality=50)
    chain = ImageEnhance.Brightness(pil).enhance(1.05)
    chain = ImageEnhance.Contrast(chain).enhance(0.95)
    chain = ImageEnhance.Color(chain).enhance(1.02)
    chain = JT.adjust_hue(chain, 0.04).transpose(PIL.Image.FLIP_LEFT_RIGHT)
    chain = np.asarray(chain.resize((60, 45), PIL.Image.BICUBIC))
    canvas = np.zeros((50, 50, 3), np.uint8)
    canvas[1:44, 0:50] = chain[2:45, 5:55]
    return {
        "decode": ({}, (80, 60), np.asarray(pil)),
        "brightness": (dict(brightness=1.08), (80, 60), np.asarray(
            ImageEnhance.Brightness(pil).enhance(1.08))),
        "contrast": (dict(contrast=0.93), (80, 60), np.asarray(
            ImageEnhance.Contrast(pil).enhance(0.93))),
        "saturation": (dict(saturation=0.91), (80, 60), np.asarray(
            ImageEnhance.Color(pil).enhance(0.91))),
        "grayscale": (dict(grayscale=True), (80, 60),
                      np.asarray(pil.convert("L").convert("RGB"))),
        "hue": (dict(hue_shift=int(-0.08 * 255) % 256), (80, 60),
                np.asarray(JT.adjust_hue(pil, -0.08))),
        "hue_zero": (dict(hue_shift=0), (80, 60),
                     np.asarray(JT.adjust_hue(pil, 0.0))),
        "recompress": (dict(jpeg_quality=50), (80, 60),
                       np.asarray(PIL.Image.open(buf).convert("RGB"))),
        "resample": (dict(resize_wh=(117, 93)), (117, 93),
                     np.asarray(pil.resize((117, 93), PIL.Image.BICUBIC))),
        "chain": (dict(brightness=1.05, contrast=0.95, saturation=1.02,
                       hue_shift=int(0.04 * 255) % 256, hflip=True,
                       resize_wh=(60, 45), crop_xy=(5, 2),
                       content_xywh=(0, 1, 50, 43)), (50, 50), canvas),
    }


@pytest.mark.parametrize("op", ["decode", "brightness", "contrast",
                                "saturation", "grayscale", "hue",
                                "hue_zero", "recompress", "resample",
                                "chain"])
def test_imgpipe_op_equals_jax_and_pil(pipes, jpg, op):
    kw, (w, h), want = _cases(jpg)[op]
    got_f, got = _run(pipes[0], jpg, w, h, **kw)
    jax_f, jax_u8 = _run(pipes[1], jpg, w, h, **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_u8)
    np.testing.assert_array_equal(got_f, jax_f)
    assert imgpipe.jpeg_size(jpg) == jimgpipe.jpeg_size(jpg) == (80, 60)


def test_imgpipe_reports_failures_like_jax(pipes, jpg):
    for pipe in pipes:
        outs = [np.zeros((60, 80, 3), np.float32) for _ in range(3)]
        for blob, out in zip((jpg, b"not a jpeg", jpg), outs):
            pipe.submit(blob, out=out, content_xywh=(0, 0, 80, 60))
        assert pipe.wait_failed() == [1]
        assert outs[0].any() and outs[2].any() and not outs[1].any()
        pipe.submit(b"corrupt", out=outs[1], content_xywh=(0, 0, 80, 60))
        with pytest.raises(RuntimeError, match=r"\[0\]"):
            pipe.wait()
        # a window past the canvas fails its job instead of writing past
        pipe.submit(jpg, out=np.zeros((20, 20, 3), np.float32),
                    content_xywh=(10, 10, 20, 20))
        assert pipe.wait_failed_counted() == ([0], 1)
    with pytest.raises(ValueError, match="JPEG"):
        imgpipe.jpeg_size(b"not a jpeg")


def test_imgpipe_keeps_submitted_buffers_alive(jpg):
    """The pipe holds each submitted temporary until wait()."""
    import gc
    pipe = imgpipe.ImgPipe(2)
    outs = []
    for _ in range(6):
        u8 = np.zeros((EDGE, EDGE, 3), np.uint8)
        outs.append(u8)
        pipe.submit(bytes(bytearray(jpg)), out_u8=u8, resize_wh=(EDGE, EDGE),
                    content_xywh=(0, 0, EDGE, EDGE))
        gc.collect()
    pipe.wait()
    for u8 in outs[1:]:
        np.testing.assert_array_equal(u8, outs[0])
    assert outs[0].any()
    pipe.close()


def test_two_processes_build_and_load_at_once(tmp_path):
    """Two processes that find no library build it at once into one
    directory: both load it, and one library is left, no temporary."""
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "from rtpose_tpu_torch.native import imgpipe\n"
        "imgpipe.BUILD_DIR = Path(sys.argv[1])\n"
        "pipe = imgpipe.ImgPipe(1)\n"
        "print(imgpipe.loaded_library())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [e for _, e in outs]
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1
    left = sorted(p.name for p in tmp_path.iterdir())
    assert left == sorted([os.path.basename(paths.pop()), "libimgpipe.lock"])


def test_build_names_what_is_missing(monkeypatch, tmp_path):
    """No bundled libjpeg: the build raises and names it; nothing falls
    back to another decoder."""
    import PIL
    fake = tmp_path / "site" / "PIL"
    fake.mkdir(parents=True)
    (tmp_path / "site" / "pillow.libs").mkdir()
    monkeypatch.setattr(PIL, "__file__", str(fake / "__init__.py"))
    with pytest.raises(RuntimeError, match="pillow.libs holds no libjpeg"):
        imgpipe.pillow_libjpeg()


# ---------------------------------------------------------------------------
# the loader
# ---------------------------------------------------------------------------

def _write_set(root, n, seed, id0=0):
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "img")
    os.makedirs(img_dir, exist_ok=True)
    images, anns, aid = [], [], id0 * 100 + 1
    for i in range(id0, id0 + n):
        h, w = int(rng.integers(50, 130)), int(rng.integers(50, 130))
        arr = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        name = f"{i:06d}.jpg"
        PIL.Image.fromarray(arr).save(os.path.join(img_dir, name),
                                      quality=90)
        images.append({"id": i, "file_name": name, "height": h, "width": w})
        for _ in range(int(rng.integers(1, 3))):
            kp = []
            for _ in range(17):
                kp += [float(rng.uniform(0, w)), float(rng.uniform(0, h)), 2]
            anns.append({"id": aid, "image_id": i, "category_id": 1,
                         "iscrowd": 0, "keypoints": kp, "num_keypoints": 17,
                         "bbox": [0, 0, w, h], "area": w * h})
            aid += 1
        anns.append({"id": aid, "image_id": i, "category_id": 1,
                     "iscrowd": 1, "keypoints": [0] * 51, "num_keypoints": 0,
                     "bbox": [5, 5, 20, 15], "area": 300})
        aid += 1
    ann = os.path.join(root, f"ann{seed}.json")
    with open(ann, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": 1, "name": "person",
                                   "keypoints": [], "skeleton": []}]}, f)
    return img_dir, ann


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    return _write_set(str(tmp_path_factory.mktemp("coco")), 6, seed=1)


def _batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k, v in w.items():
            t = g[k]
            assert isinstance(t, torch.Tensor), k
            assert t.numpy().dtype == v.dtype, k
            np.testing.assert_array_equal(t.numpy(), v, err_msg=k)


OFF = dict(scale_range=0.75, hflip_prob=0.0, color_jitter=0.0,
           jpeg_prob=0.0, grayscale_prob=0.0)


@pytest.mark.parametrize("case", ["float32_shuffled", "uint8_shuffled",
                                  "uint8_deterministic", "float32_off"])
def test_native_loader_equals_jax(coco, case):
    img_dir, ann = coco
    kw = {"float32_shuffled": dict(seed=11),
          "uint8_shuffled": dict(seed=3, uint8_output=True),
          "uint8_deterministic": dict(shuffle=False, uint8_output=True,
                                      deterministic=True, drop_last=False),
          "float32_off": dict(shuffle=False, aug_kwargs=OFF)}[case]
    tl = tnative.NativeLoader(tdataset.CocoKeypoints(img_dir, ann,
                                                     input_size=EDGE),
                              batch_size=4, threads=2, **kw)
    jl = jnative.NativeLoader(jdataset.CocoKeypoints(img_dir, ann,
                                                     input_size=EDGE),
                              batch_size=4, threads=2, **kw)
    for _ in range(2):       # two epochs: the epoch folds into the rng
        _batches_equal(list(tl), list(jl))
    assert tl.epoch == jl.epoch == 2


def test_native_loader_concat_epoch_equals_jax(coco, tmp_path):
    img_dir, ann = coco
    img2, ann2 = _write_set(str(tmp_path), 3, seed=2, id0=50)
    parts = [(img_dir, ann), (img2, ann2)]
    tds = tdataset.ConcatKeypoints([tdataset.CocoKeypoints(
        d, a, input_size=EDGE) for d, a in parts])
    jds = jdataset.ConcatKeypoints([jdataset.CocoKeypoints(
        d, a, input_size=EDGE) for d, a in parts])
    kw = dict(batch_size=3, threads=2, seed=5, uint8_output=True)
    got = list(tnative.NativeLoader(tds, **kw))
    _batches_equal(got, list(jnative.NativeLoader(jds, **kw)))
    ids = {int(i) for b in got for i in b["image_id"]}
    assert ids & set(range(6)) and ids & {50, 51, 52}


def test_native_loader_equals_the_pil_loader_with_augmentation_off(coco):
    """Photometrics off, a fixed scale and images no larger than the crop:
    the native batches are the port's PIL Loader's."""
    img_dir, ann = coco
    pipeline = TT.Compose([TT.RescaleRelative(0.5), TT.Crop(EDGE),
                           TT.CenterPad(EDGE)])
    pil = tdataset.Loader(tdataset.CocoKeypoints(
        img_dir, ann, preprocess=pipeline, input_size=EDGE), batch_size=3,
        shuffle=False, num_workers=0)
    nat = tnative.NativeLoader(tdataset.CocoKeypoints(
        img_dir, ann, input_size=EDGE), batch_size=3, shuffle=False,
        threads=2, aug_kwargs=dict(OFF, scale_range=0.5))
    pairs = list(zip(pil, nat))
    assert len(pairs) == 2
    for bp, bn in pairs:
        np.testing.assert_array_equal(bn["image_id"], bp["image_id"])
        np.testing.assert_allclose(bn["image"], bp["image"], atol=2e-6)
        np.testing.assert_allclose(bn["keypoints"], bp["keypoints"],
                                   atol=1e-9)
        np.testing.assert_array_equal(bn["mask"], bp["mask"])


def test_train_step_on_a_uint8_batch(coco):
    """One CPU train step on a native uint8 batch with its content
    windows gives the loss of the same step on the batch normalized on
    the host, 0 outside each window."""
    from rtpose_tpu_torch.config import Config
    from rtpose_tpu_torch.train.trainer import Trainer
    img_dir, ann = coco
    cfg = Config()
    cfg.model.num_stages, cfg.model.dtype = 1, "float32"
    cfg.dataset.image_size, cfg.train.freeze_base_epochs = EDGE, 0
    batch = next(iter(tnative.NativeLoader(
        tdataset.CocoKeypoints(img_dir, ann, input_size=EDGE), batch_size=4,
        shuffle=False, threads=2, uint8_output=True,
        aug_kwargs=dict(OFF, scale_range=0.6))))
    imgf = (batch["image"].numpy().astype(np.float32) / 255.0
            - TT.IMAGENET_MEAN) / TT.IMAGENET_STD
    for i, (x0, y0, w, h) in enumerate(batch["valid_xywh"].numpy()):
        inside = np.zeros(imgf.shape[1:3], bool)
        inside[y0:y0 + h, x0:x0 + w] = True
        imgf[i][~inside] = 0.0
    logs_u8 = Trainer(cfg, device="cpu").train_step(
        batch["image"], batch["keypoints"], batch["mask"],
        batch["valid_xywh"])
    logs_f32 = Trainer(cfg, device="cpu").train_step(
        imgf, batch["keypoints"], batch["mask"])
    assert np.isfinite(logs_u8["loss"]) and logs_u8["loss"] > 0
    np.testing.assert_allclose(logs_u8["loss"], logs_f32["loss"], rtol=1e-5)
