"""The port's training data path vs the JAX package's, on the CPU: the
transforms, ``CocoKeypoints``, ``ConcatKeypoints``, the image lists, the
keypoint helpers, the worker-process ``Loader`` against the JAX thread
``Loader``, and the ImageNet VGG19 import.

Both sides get the same PIL images, keypoints and rng seed; tolerance 0
everywhere (pixels, keypoints, meta, masks and host GT maps bit for bit).
Fixtures are a few tiny JPEGs with crowd and zero-keypoint annotations;
Loader runs use at most 2 worker processes.
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import PIL.Image
import pytest
import torch

from rtpose_tpu.data import dataset as jdataset
from rtpose_tpu.data import transforms as JT
from rtpose_tpu.models import import_torch
from rtpose_tpu.models.vgg19 import VGG19RTPose as JVGG19RTPose
from rtpose_tpu_torch.data import dataset as tdataset
from rtpose_tpu_torch.data import transforms as TT
from rtpose_tpu_torch.models import get_model
from rtpose_tpu_torch.models.convert import (import_vgg19_imagenet,
                                             state_dict_from_flax)

# (w, h) of the fixture images: landscape, portrait, smaller than the
# 64 px crop and larger, so Crop and CenterPad take every branch
SIZES = ((97, 73), (61, 88), (50, 40), (130, 90), (72, 72), (88, 117))


def _kp17(rng, w, h, margin=0.1):
    """(17, 3) COCO keypoints, some outside the image, v in {0, 1, 2}."""
    kp = np.zeros((17, 3))
    kp[:, 0] = rng.uniform(-margin * w, (1 + margin) * w, 17)
    kp[:, 1] = rng.uniform(-margin * h, (1 + margin) * h, 17)
    kp[:, 2] = rng.choice([0, 1, 2], 17, p=[0.2, 0.2, 0.6])
    return kp


def write_coco(root, sizes=SIZES, seed=0, id0=1):
    """JPEGs and a person_keypoints JSON under `root`: 1-3 labelled people
    an image, plus on some images an ``iscrowd`` region and a person with
    zero keypoints (both go to the loss mask); one image has only a crowd
    region.  -> (image dir, annotation file)."""
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    images, anns = [], []
    for n, (w, h) in enumerate(sizes):
        img_id = id0 + n
        name = f"{img_id:012d}.jpg"
        arr = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        PIL.Image.fromarray(arr).save(os.path.join(img_dir, name),
                                      quality=90)
        images.append({"id": img_id, "file_name": name, "width": w,
                       "height": h})

        def ann(kp, crowd=0, bbox=None):
            anns.append({
                "id": 1000 * img_id + len(anns), "image_id": img_id,
                "category_id": 1, "keypoints": [float(v) for v in kp.ravel()],
                "num_keypoints": int((kp[:, 2] > 0).sum()), "iscrowd": crowd,
                "area": 100.0,
                "bbox": bbox or [float(rng.uniform(0, w / 2)),
                                 float(rng.uniform(0, h / 2)),
                                 float(rng.uniform(5, w / 2)),
                                 float(rng.uniform(5, h / 2))]})

        if n != 2:
            for _ in range(1 + n % 3):
                ann(_kp17(rng, w, h))
        if n % 2 == 0:
            ann(np.zeros((17, 3)), crowd=1)
        if n % 3 == 1:
            ann(np.zeros((17, 3)))
    with open(os.path.join(root, "ann.json"), "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": 1, "name": "person"}]}, f)
    return img_dir, os.path.join(root, "ann.json")


@pytest.fixture
def coco(tmp_path):
    return write_coco(str(tmp_path))


def _image(seed=0, w=97, h=73):
    rng = np.random.RandomState(seed)
    return PIL.Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8))


def _sample(T, seed=0):
    rng = np.random.RandomState(seed + 100)
    kps = np.stack([_kp17(rng, 97, 73) for _ in range(3)])
    return T.Sample.new(_image(seed), kps)


def _flat(out):
    """A transform's output as a list of (name, value) to compare."""
    if isinstance(out, list):
        return [kv for i, s in enumerate(out) for kv in
                [(f"{i}.{k}", v) for k, v in _flat(s)]]
    if isinstance(out, (JT.Sample, TT.Sample)):
        items = [("image", np.asarray(out.image)),
                 ("mode", out.image.mode), ("keypoints", out.keypoints)]
        return items + [(f"meta.{k}", v) for k, v in sorted(out.meta.items())]
    if isinstance(out, PIL.Image.Image):
        return [("image", np.asarray(out)), ("mode", out.mode)]
    return [("array", out)]


def _transforms(T):
    return {
        "HFlip": T.HFlip(),
        "RescaleRelative_range": T.RescaleRelative((0.5, 1.0)),
        "RescaleRelative_fixed": T.RescaleRelative(0.7),
        "RescaleAbsolute": T.RescaleAbsolute(64),
        "RescaleAbsolute_range": T.RescaleAbsolute((40, 90)),
        "Crop": T.Crop(64),
        "Crop_small": T.Crop(32),
        "CenterPad": T.CenterPad(128),
        "ColorJitter": T.ColorJitter(0.1),
        "RandomGrayscale": T.RandomGrayscale(1.0),
        "Blur": T.Blur(3.0),
        "JpegCompression": T.JpegCompression(),
        "RandomApply": T.RandomApply(T.HFlip(), 0.5),
        "Compose": T.Compose([T.HFlip(), T.RescaleRelative((0.5, 1.0)),
                              T.Crop(64), T.CenterPad(64)]),
        "MultiScale": T.MultiScale([T.RescaleRelative(0.5),
                                    T.Compose([T.Crop(48),
                                               T.CenterPad(48)])]),
        "train_pipeline": T.train_pipeline(64),
        "train_pipeline_all": T.train_pipeline(
            64, (0.3, 1.0), hflip_prob=0.9, jpeg_prob=0.9,
            grayscale_prob=0.5),
    }


def _run(T, name, seed):
    rng = np.random.default_rng(seed)
    if name == "adjust_hue":
        out = [T.adjust_hue(_image(seed), f) for f in (-0.5, -0.1, 0.03, 0.5)]
        return [kv for o in out for kv in _flat(o)], rng
    if name == "keypoint_sets_inverse":
        s = T.Compose([T.HFlip(), T.RescaleRelative((0.5, 1.0)), T.Crop(64),
                       T.CenterPad(64)])(_sample(T, seed), rng)
        return [("kps", T.keypoint_sets_inverse(s.keypoints, s.meta))], rng
    if name == "image_to_tensor+mask_valid_area":
        s = T.Compose([T.RescaleRelative(0.5), T.Crop(64),
                       T.CenterPad(64)])(_sample(T, seed), rng)
        arr = T.image_to_tensor(s.image)
        return [("tensor", arr.copy()),
                ("masked", T.mask_valid_area(arr, s.meta["valid_area"]))], rng
    return _flat(_transforms(T)[name](_sample(T, seed), rng)), rng


@pytest.mark.parametrize("name", sorted(_transforms(TT)) + [
    "adjust_hue", "keypoint_sets_inverse", "image_to_tensor+mask_valid_area"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transform_equals_jax(name, seed):
    got, got_rng = _run(TT, name, seed)
    want, want_rng = _run(JT, name, seed)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(a, b, err_msg=f"{name} {k}")
        else:
            assert a == b, (name, k)
    # both consumed the generator alike
    assert got_rng.random() == want_rng.random()


def test_random_rotate_raises_naming_the_roadmap():
    with pytest.raises(NotImplementedError, match="item 10"):
        TT.RandomRotate(40.0)
    with pytest.raises(NotImplementedError, match="warpAffine"):
        TT.train_pipeline(64, rotate_degrees=40.0)


def _assert_samples_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_coco_keypoints_get_equals_jax(coco):
    """Image, keypoints, the crowd / unlabelled loss mask and host GT maps,
    sample for sample with the same generator."""
    img_dir, ann = coco
    kw = dict(image_dir=img_dir, ann_file=ann, input_size=64, host_gt=True)
    port, jax_ds = tdataset.CocoKeypoints(**kw), jdataset.CocoKeypoints(**kw)
    # the image with only a crowd region has no keypoints: left out
    assert len(port) == len(jax_ds) == len(SIZES) - 1
    masked = 0
    for seed in (0, 1):
        rp, rj = np.random.default_rng(seed), np.random.default_rng(seed)
        for i in range(len(port)):
            got, want = port.get(i, rp), jax_ds.get(i, rj)
            _assert_samples_equal(got, want)
            masked += int((want["mask"] == 0).any())
    assert masked > 0            # the fixture reaches the mask path
    all_port = tdataset.CocoKeypoints(img_dir, ann, all_images=True)
    all_jax = jdataset.CocoKeypoints(img_dir, ann, all_images=True)
    assert all_port.ids == all_jax.ids and len(all_port) == len(SIZES)
    for i in range(len(all_port)):          # the crowd-only image too
        got, want = all_port.raw_sample(i), all_jax.raw_sample(i)
        assert got[:2] == want[:2]
        for a, b in zip(got[2:], want[2:]):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    assert tdataset.CocoKeypoints(img_dir, ann, all_images=True,
                                  n_images=4).ids == all_jax.ids[:4]


def test_coco_keypoints_pickles_only_per_image_records(coco, tmp_path):
    """A worker is sent the dataset pickled: it carries what ``get``
    reads, not the annotation file's other fields, and the copy still
    draws the JAX package's samples."""
    img_dir, ann = coco
    with open(ann) as f:
        data = json.load(f)
    for a in data["annotations"]:
        a["segmentation"] = [[float(v) for v in range(400)]]
    ann = str(tmp_path / "annotations.json")
    with open(ann, "w") as f:
        json.dump(data, f)
    kw = dict(image_dir=img_dir, ann_file=ann, input_size=64)
    blob = pickle.dumps(tdataset.CocoKeypoints(**kw))
    assert b"segmentation" not in blob
    port, jax_ds = pickle.loads(blob), jdataset.CocoKeypoints(**kw)
    rp, rj = np.random.default_rng(2), np.random.default_rng(2)
    for i in range(len(jax_ds)):
        _assert_samples_equal(port.get(i, rp), jax_ds.get(i, rj))


def test_concat_image_lists_and_keypoint_helpers(tmp_path):
    a = write_coco(str(tmp_path / "a"), SIZES[:3], seed=1, id0=1)
    b = write_coco(str(tmp_path / "b"), SIZES[3:], seed=2, id0=11)
    sides = {}
    for name, mod in (("port", tdataset), ("jax", jdataset)):
        parts = [mod.CocoKeypoints(d, f, input_size=64) for d, f in (a, b)]
        cat = mod.ConcatKeypoints(parts)
        rng = np.random.default_rng(5)
        sides[name] = (len(cat), [cat.get(i, rng) for i in range(len(cat))],
                       [cat.raw_sample(i)[0] for i in range(len(cat))])
        with pytest.raises(IndexError):
            cat.get(len(cat), rng)
        with pytest.raises(ValueError, match="at least one"):
            mod.ConcatKeypoints([])
        with pytest.raises(ValueError, match="stride"):
            mod.ConcatKeypoints([parts[0], mod.CocoKeypoints(
                *b, input_size=64, stride=4)])
    (n, got, ids), (n_j, want, ids_j) = sides["port"], sides["jax"]
    assert n == n_j and ids == ids_j and len(set(ids)) == n
    for g, w in zip(got, want):
        _assert_samples_equal(g, w)

    paths = sorted(os.path.join(a[0], f) for f in os.listdir(a[0]))
    for i in range(len(paths)):
        for got, want in zip(tdataset.ImageList(paths)[i],
                             jdataset.ImageList(paths)[i]):
            np.testing.assert_array_equal(got, want)
    images = [_image(s, 30 + s, 20 + s) for s in range(3)]
    for i in range(3):
        for got, want in zip(tdataset.PilImageList(images)[i],
                             jdataset.PilImageList(images)[i]):
            np.testing.assert_array_equal(got, want)

    rng = np.random.RandomState(3)
    for _ in range(20):
        kp17 = _kp17(rng, 80, 60)
        kp17[5:7, 2] = rng.choice([0, 1, 2], 2)
        np.testing.assert_array_equal(tdataset.add_neck(kp17),
                                      jdataset.add_neck(kp17))
    kps = rng.uniform(-20, 80, (4, 18, 3))
    np.testing.assert_array_equal(
        tdataset.remove_illegal_joints(kps, 64, 48),
        jdataset.remove_illegal_joints(kps, 64, 48))
    assert tdataset.MAX_PEOPLE_PER_IMAGE == jdataset.MAX_PEOPLE_PER_IMAGE


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert isinstance(g[k], torch.Tensor), k
            np.testing.assert_array_equal(g[k].numpy(), w[k], err_msg=k)
    if got:
        assert got[0]["image"].dtype == torch.float32
        assert got[0]["image_id"].dtype == torch.int64


@pytest.mark.parametrize("opts", [
    dict(drop_last=True), dict(drop_last=False),
    dict(drop_last=False, shuffle=False, deterministic=True)])
def test_loader_with_worker_processes_equals_jax(coco, opts):
    """2 worker processes against the JAX Loader's 2 threads, 2 epochs:
    the same batches element for element (a short last batch and a
    short last round of workers when drop_last is False)."""
    img_dir, ann = coco
    kw = dict(image_dir=img_dir, ann_file=ann, input_size=64)
    port = tdataset.Loader(tdataset.CocoKeypoints(**kw), 2, num_workers=2,
                           seed=7, **opts)
    ref = jdataset.Loader(jdataset.CocoKeypoints(**kw), 2, num_workers=2,
                          seed=7, **opts)
    assert len(port) == len(ref)
    epochs = [list(port), list(port)]
    _assert_batches_equal(epochs[0], list(ref))
    _assert_batches_equal(epochs[1], list(ref))
    assert port.epoch == 2
    same = all(torch.equal(a["image"], b["image"])
               for a, b in zip(*epochs))
    assert same == bool(opts.get("deterministic"))


def test_loader_left_early_restarts_the_next_epoch(coco):
    """An epoch left after one batch stops its workers; the next epoch
    starts new ones and still equals the JAX Loader's next epoch.  Two
    epochs open at once each equal theirs, as the JAX Loader's do."""
    img_dir, ann = coco
    kw = dict(image_dir=img_dir, ann_file=ann, input_size=64)
    port = tdataset.Loader(tdataset.CocoKeypoints(**kw), 2, num_workers=2,
                           seed=4, drop_last=False)
    ref = jdataset.Loader(jdataset.CocoKeypoints(**kw), 2, num_workers=2,
                          seed=4, drop_last=False)
    want = [list(ref) for _ in range(4)]
    first = iter(port)
    _assert_batches_equal([next(first)], want[0][:1])
    del first
    second, third = iter(port), iter(port)
    _assert_batches_equal([next(second)], want[1][:1])
    _assert_batches_equal(list(third), want[2])
    _assert_batches_equal(list(second), want[1][1:])
    _assert_batches_equal(list(port), want[3])


def test_loader_in_process_equals_jax_one_worker(coco):
    img_dir, ann = coco
    kw = dict(image_dir=img_dir, ann_file=ann, input_size=64, host_gt=True)
    port = tdataset.Loader(tdataset.CocoKeypoints(**kw), 4, num_workers=0,
                           seed=3, drop_last=False)
    ref = jdataset.Loader(jdataset.CocoKeypoints(**kw), 4, num_workers=1,
                          seed=3, drop_last=False)
    for _ in range(2):
        _assert_batches_equal(list(port), list(ref))
    with pytest.raises(ValueError, match="timeout"):
        tdataset.Loader(tdataset.CocoKeypoints(**kw), 4, timeout=0)


def test_loader_raises_a_worker_error(coco):
    """A corrupt image fails in a worker process; the error reaches the
    caller as the JAX Loader's does (tests/test_data_pipeline.py:114), and
    the iterator does not hang."""
    img_dir, ann = coco
    bad = sorted(os.listdir(img_dir))[3]
    with open(os.path.join(img_dir, bad), "wb") as f:
        f.write(b"not a jpeg")
    kw = dict(image_dir=img_dir, ann_file=ann, input_size=64)
    for mod, workers in ((tdataset, 2), (jdataset, 2)):
        loader = mod.Loader(mod.CocoKeypoints(**kw), 2, num_workers=workers,
                            seed=1, drop_last=False)
        with pytest.raises(OSError, match="cannot identify image file"):
            for _ in loader:
                pass


_EXIT_CHILD = r"""
import os, sys
from rtpose_tpu_torch.data.dataset import (CocoKeypoints, Loader,
                                           stop_worker_processes)

def children():
    out = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            stat = open(f"/proc/{pid}/stat").read()
        except OSError:
            continue
        if int(stat[stat.rfind(")") + 2:].split()[1]) == os.getpid():
            out.append(int(pid))
    return out

loader = Loader(CocoKeypoints(sys.argv[1], sys.argv[2], input_size=64), 2,
                num_workers=2)
list(loader)
running = len(children())
stop_worker_processes()
print(running, len(children()), flush=True)
held = iter(loader)
next(held)    # an epoch still open when the program ends
"""


def _session(sid):
    """Pids of the processes in session `sid`."""
    out = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        if int(stat[stat.rfind(")") + 2:].split()[3]) == sid:
            out.append(int(pid))
    return out


def test_loader_leaves_no_process_behind(coco):
    """The forkserver and the resource tracker outlive a finished epoch;
    ``stop_worker_processes`` ends them, and at exit every process the
    Loader needed has ended with the program, an open epoch's workers
    too."""
    img_dir, ann = coco
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    child = subprocess.Popen([sys.executable, "-c", _EXIT_CHILD, img_dir,
                              ann], cwd=root, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True,
                             start_new_session=True)
    out, err = child.communicate(timeout=240)
    left = _session(child.pid)
    assert child.returncode == 0, err[-3000:]
    assert out.split() == ["2", "0"], out
    assert not left
    assert "Traceback" not in err, err[-3000:]


def test_vgg19_imagenet_import_equals_jax():
    """A random torchvision-layout vgg19 state dict through JAX's
    import_vgg19_imagenet and models.convert equals the port's import, bit
    for bit; a wrong shape or a short state dict raises before anything
    is written."""
    import jax

    rng = np.random.RandomState(0)
    vgg = {}
    cin = 3
    for i, cout in enumerate((64, 64, 128, 128, 256, 256, 256, 256, 512, 512,
                              512, 512)):
        vgg[f"features.{i}.weight"] = torch.from_numpy(
            rng.normal(0, 0.1, (cout, cin, 3, 3)).astype(np.float32))
        vgg[f"features.{i}.bias"] = torch.from_numpy(
            rng.normal(0, 0.1, cout).astype(np.float32))
        cin = cout
    vgg["classifier.0.weight"] = torch.zeros(4, 8)

    jmodel = JVGG19RTPose(num_stages=1)
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), np.zeros((1, 64, 64, 3), np.float32)))
    want = state_dict_from_flax(import_torch.import_vgg19_imagenet(
        {k: v.numpy() for k, v in vgg.items()}, params))

    model = get_model("vgg19", num_stages=1)
    model.load_state_dict(state_dict_from_flax(params))
    import_vgg19_imagenet(vgg, model)
    got = model.state_dict()
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got["model0.21.weight"], vgg["features.9.weight"])

    before = {k: v.clone() for k, v in got.items()}
    bad = dict(vgg)
    bad["features.4.weight"] = bad["features.4.weight"][:, :64]
    with pytest.raises(ValueError, match="shape"):
        import_vgg19_imagenet(bad, model)
    with pytest.raises(ValueError, match="20 tensors"):
        import_vgg19_imagenet(dict(list(vgg.items())[:19]), model)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
