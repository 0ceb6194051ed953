"""rtpose_tpu_torch stands alone: it imports no jax, flax, cv2 or anything
of the JAX package, serves, takes a train step, builds and runs every
model family, trains a BatchNorm family, draws a loader batch in a worker
process and a native loader batch, rotates a sample, answers the
training CLI's --help, runs the picture and video demos, reads an H.264
MP4, an H.264 TS, an HEVC program stream, an HEVC Main 10 MP4 tagged
BT.2020 and a VP9 profile-2 WebM and answers an HTTP request without
them, runs the webcam loop over a
scripted camera and serves its browser view, imports the workflow
scripts (scripts/torch_*.py), renders a scene and soaks the decode without
them, and its
copies of the JAX package's tables and numpy helpers (the skeleton,
``WIDTH_CONFIGS``, the caffe layer order and prototxt) are equal to the
originals."""

import ast
import importlib
import inspect
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import util_synth
from rtpose_tpu import skeleton as jskeleton
from rtpose_tpu.data import gt as jgt
from rtpose_tpu.models import import_torch
from rtpose_tpu.ops import grouping_ref as jgrouping_ref
from rtpose_tpu.ops import peaks as jpeaks
from rtpose_tpu.ops import resize as jresize
from rtpose_tpu_torch import skeleton
from rtpose_tpu_torch.data import gt as tgt
from rtpose_tpu_torch.models.convert import torch_layout_map
from rtpose_tpu_torch.ops import grouping_ref
from rtpose_tpu_torch.ops.kernels import blur_matrices, interp_matrices
from rtpose_tpu_torch.ops.resize import resize_matrix, resize_matrix_linear
from rtpose_tpu_torch.utils import synth

from util_synth import synth_example

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import importlib, json, os, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "cv2", "rtpose_tpu"):
    sys.modules[name] = None          # any import of these now fails
import numpy as np, PIL.Image, torch
import rtpose_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(rtpose_tpu_torch.__path__,
                                              "rtpose_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
from rtpose_tpu_torch.infer.pipeline import load_pipeline
from rtpose_tpu_torch.ops.decode import decode_poses, people_to_numpy
maps = np.load(sys.argv[1])
people = people_to_numpy(decode_poses(torch.from_numpy(maps["heat"]),
                                      torch.from_numpy(maps["paf"])),
                         368, 368)
pipe = load_pipeline(device="cpu", num_stages=1, input_size=56, seed=0)
found, heat, paf, meta = pipe.run(np.zeros((60, 80, 3), np.uint8))
from rtpose_tpu_torch.config import Config
from rtpose_tpu_torch.train.trainer import Trainer
cfg = Config()
cfg.model.num_stages, cfg.model.dtype, cfg.dataset.image_size = 1, "float32", 32
kps = np.zeros((2, 2, 18, 3), np.float32)
kps[:, 0, :, :2], kps[:, 0, :, 2] = 16.0, 2.0
logs = Trainer(cfg, device="cpu").train_step(
    np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32), kps)
from rtpose_tpu_torch.models import FAMILIES, get_model
zoo = {}
for name in FAMILIES:
    with torch.no_grad():
        out = get_model(name, num_stages=1).eval()(torch.zeros(1, 64, 64, 3))
    zoo[name] = list(out.pafs.shape)
cfg.model.name, cfg.dataset.image_size = "shufflenet_v2", 64
kps[:, 0, :, :2] = 32.0
bn_logs = Trainer(cfg, device="cpu").train_step(
    np.random.RandomState(1).rand(2, 64, 64, 3).astype(np.float32), kps)
import tempfile
from rtpose_tpu_torch.evalx.__main__ import main as evalx_main
from rtpose_tpu_torch.evalx.harness import run_eval_batched
from rtpose_tpu_torch.infer.pipeline import PosePipeline
from rtpose_tpu_torch.utils.synth_coco import (OracleMaps, oracle_maps,
                                               spread_people,
                                               write_synth_coco)
sys.argv = ["evalx", "--help"]
try:
    evalx_main()
except SystemExit as e:
    assert e.code == 0, e.code
person = spread_people(np.random.RandomState(0), 1, 128, 160)
with tempfile.TemporaryDirectory() as root:
    img_dir, ann = write_synth_coco(root, [(128, 160, person)] * 2)
    oracle = OracleMaps(oracle_maps({(128, 160): person}, 128))
    stats = run_eval_batched(img_dir, ann, PosePipeline(
        oracle, device="cpu", input_size=128, flip=False), batch_size=2)
    from rtpose_tpu_torch.data.dataset import CocoKeypoints, Loader
    batch = next(iter(Loader(CocoKeypoints(img_dir, ann, input_size=64), 2,
                             num_workers=1)))
from rtpose_tpu_torch.train.__main__ import main as train_main
sys.argv = ["train", "--help"]
try:
    train_main()
except SystemExit as e:
    assert e.code == 0, e.code
import http.client, io, threading
from rtpose_tpu_torch.data.imwrite import write_bgr
from rtpose_tpu_torch.demo import picture_demo, serve_http, video_demo
from rtpose_tpu_torch.demo.video_io import VideoWriter, open_video
frame = np.random.RandomState(2).randint(0, 256, (60, 80, 3), np.uint8)
small = ["--device", "cpu", "--stages", "1", "--input-size", "56", "--fp32"]
with tempfile.TemporaryDirectory() as root:
    write_bgr(root + "/in.jpg", frame)
    sys.argv = ["picture_demo", "--image", root + "/in.jpg", "--output",
                root + "/out.png"] + small
    picture_demo.main()
    writer = VideoWriter(root + "/in.avi", 10.0, (80, 60))
    for _ in range(3):
        writer.write(frame)
    writer.release()
    sys.argv = ["video_demo", "--video", root + "/in.avi", "--output",
                root + "/out.avi", "--batch", "2"] + small
    video_frames, _ = video_demo.main()
    video_out = open_video(root + "/out.avi", device="cpu").frame_count
    from rtpose_tpu_torch.demo import scripted_video
    scripted_video.write_ipcm_mp4(root + "/in.mp4", [scripted_video.bgr_to_yuv420(
        frame)] * 2 + [None], rotation=90)
    mp4_cap = open_video(root + "/in.mp4", device="cpu")
    mp4_frames = []
    while True:
        ok, f = mp4_cap.read()
        if not ok:
            break
        mp4_frames.append(list(f.shape))
    mp4_cap.release()
    scripted_video.write_ipcm_ts(root + "/in.ts", [scripted_video.bgr_to_yuv420(
        frame)] * 2 + [None], packet_size=192)
    ts_cap = open_video(root + "/in.ts", device="cpu")
    while ts_cap.read()[0]:
        mp4_frames.append(list(ts_cap.size))
    ts_cap.release()
    hevc = scripted_video.encode_hevc_pcm(
        [scripted_video.bgr_to_yuv420(frame)] * 2 + [None])
    scripted_video.write_hevc_ps(root + "/in.mpg", hevc, mpeg2=False)
    ps_cap = open_video(root + "/in.mpg", device="cpu")
    while ps_cap.read()[0]:
        mp4_frames.append([ps_cap.codec] + list(ps_cap.size))
    ps_cap.release()
    planes10 = [tuple(p.astype(np.uint16) << 2
                      for p in scripted_video.bgr_to_yuv420(frame))] * 2
    scripted_video.write_hevc_mp4(root + "/main10.mp4",
                                  scripted_video.encode_hevc_pcm(
        planes10, depth=10, colour=scripted_video.Colour(9)))
    scripted_video.write_vp9(root + "/p2.webm", planes10)
    for path in ("/main10.mp4", "/p2.webm"):
        p10_cap = open_video(root + path, device="cpu")
        while True:
            ok, f = p10_cap.read()
            if not ok:
                break
            mp4_frames.append([p10_cap.codec] + list(f.shape))
        p10_cap.release()
    server = serve_http.serve(pipe, host="127.0.0.1", port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1],
                                      timeout=120)
    conn.request("POST", "/pose", body=open(root + "/in.jpg", "rb").read())
    resp = conn.getresponse()
    http_answer = [resp.status, json.loads(resp.read())["size"]]
    server.shutdown()
    server.server_close()
from rtpose_tpu_torch.demo import camera, web_demo
from rtpose_tpu_torch.demo.frame_view import FrameView
from rtpose_tpu_torch.demo.scripted_camera import (ScriptedDevice,
                                                   ScriptedV4L2)
camera.SYSCALLS = ScriptedV4L2({0: ScriptedDevice([frame] * 3)})
view = FrameView("127.0.0.1", 0)
conn = http.client.HTTPConnection("127.0.0.1", view.server.server_address[1],
                                  timeout=60)
conn.request("GET", "/")
resp = conn.getresponse()
page = [resp.status, b'<img src="/stream"' in resp.read()]
conn.close()
webcam = [web_demo.run_webcam(pipe, camera.open_camera(0), view)[0]] + page
from rtpose_tpu_torch.data.native_loader import NativeLoader
from rtpose_tpu_torch.data import transforms as T
with tempfile.TemporaryDirectory() as root:
    img_dir, ann = write_synth_coco(root, [(96, 128, person)] * 2)
    native = next(iter(NativeLoader(CocoKeypoints(img_dir, ann,
                                                  input_size=64), 2,
                                    threads=2, uint8_output=True)))
    rotated = T.RandomRotate(40.0)(T.Sample.new(
        PIL.Image.open(f"{img_dir}/" + sorted(os.listdir(img_dir))[0]),
        np.zeros((0, 17, 3))), np.random.default_rng(0))
import torch.distributed as dist
from rtpose_tpu_torch.parallel.distributed import (free_port, host_shard,
                                                   sync_hosts)
from rtpose_tpu_torch.parallel.mesh import make_mesh
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}",
                        rank=0, world_size=1)
mesh = make_mesh()
par_logs = Trainer(cfg, device="cpu", mesh=mesh).train_step(
    np.random.RandomState(1).rand(2, 64, 64, 3).astype(np.float32), kps)
sync_hosts()
parallel = [mesh.num_data, mesh.num_model, par_logs["loss"],
            host_shard(list(range(5)))]
dist.destroy_process_group()
sys.path.insert(0, "scripts")
scripts = {}
for name in ("torch_soak_decode", "torch_train_synth",
             "torch_cocoval_rehearsal", "torch_crowded_eval_bench",
             "torch_eval_breakdown", "torch_hg_rescore", "torch_endurance",
             "torch_train_to_eval"):
    scripts[name] = importlib.import_module(name)
scene, scene_kps = scripts["torch_train_synth"].render_scene(
    np.random.RandomState(0), 64, 2, height=50, width=70)
soak = scripts["torch_soak_decode"].main(["--scenes", "3", "--device",
                                          "cpu"])
loaded = sorted(k for k in sys.modules
                if k.split(".")[0] in ("jax", "flax", "cv2", "rtpose_tpu")
                and sys.modules[k] is not None)
print(json.dumps({"modules": mods, "people": len(people),
                  "heat": list(heat.shape), "loaded": loaded,
                  "train_loss": logs["loss"], "eval_ap": stats["AP"],
                  "zoo": zoo, "bn_train_loss": bn_logs["loss"],
                  "loader": {k: list(v.shape) for k, v in batch.items()},
                  "video": [video_frames, video_out], "http": http_answer,
                  "mp4": mp4_frames,
                  "webcam": webcam,
                  "native": {k: [str(v.dtype), list(v.shape)]
                             for k, v in native.items()},
                  "rotated": list(np.asarray(rotated.image).shape),
                  "parallel": parallel, "scripts": sorted(scripts),
                  "scene": list(scene.shape), "soak": soak["count_mismatch"]}))
"""


def test_port_runs_without_jax_flax_cv2_or_the_jax_package(tmp_path):
    _, heat, paf = synth_example(seed=1, n_people=3)
    maps = tmp_path / "maps.npz"
    np.savez(maps, heat=heat, paf=paf)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _CHILD, str(maps)], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "rtpose_tpu_torch.infer.pipeline" in res["modules"]
    assert "rtpose_tpu_torch.ops.kernels" in res["modules"]
    assert "rtpose_tpu_torch.train.trainer" in res["modules"]
    for mod in ("evalx.__main__", "evalx.harness", "evalx.cocoeval",
                "data.imread", "data.coco_json", "demo.picture_demo",
                "data.dataset", "data.transforms", "train.__main__",
                "models.openpose_v2", "models.mobilenet_v2",
                "models.shufflenet_v2", "models.atrous", "models.atrous_cpm",
                "models.hourglass", "models.caffe_interop",
                "demo.serve_http", "demo.video_demo", "demo.video_io",
                "data.imwrite", "utils.draw", "utils.human",
                "utils.profiling", "data.native_loader", "data.cv2exact",
                "native.imgpipe", "parallel.distributed", "parallel.mesh",
                "parallel.sharding", "demo.web_demo", "demo.camera",
                "demo.frame_view", "demo.scripted_camera",
                "utils.text_glyphs", "demo.mp4", "demo.scripted_video",
                "native.avcodec", "demo.mkv", "demo.mpegts",
                "demo.mpegps"):
        assert f"rtpose_tpu_torch.{mod}" in res["modules"], mod
    assert res["eval_ap"] == 1.0
    assert res["train_loss"] > 0 and np.isfinite(res["train_loss"])
    assert res["bn_train_loss"] > 0 and np.isfinite(res["bn_train_loss"])
    assert sorted(res["zoo"]) == sorted(
        ["vgg19", "mobilenet", "hourglass", "shufflenet_v2", "openpose_v2",
         "atrous_resnet50", "atrous_cpm", "atrous_cpm_shared"])
    for name, shape in res["zoo"].items():
        g = 16 if name == "hourglass" else 8
        assert shape[1:] == [1, g, g, 38], name
    assert res["people"] == 3
    assert res["heat"] == [7, 10, 19]
    assert res["loaded"] == []
    assert res["loader"] == {"image": [2, 64, 64, 3],
                             "keypoints": [2, 32, 18, 3],
                             "mask": [2, 8, 8, 1], "image_id": [2]}
    assert res["video"] == [3, 3]
    # turned by its tag; then the sizes of an M2TS's three frames
    assert res["mp4"] == [[80, 60, 3]] * 3 + [[80, 60]] * 3 + [
        ["hevc", 80, 60]] * 3 + [["hevc", 60, 80, 3]] * 2 + [
        ["vp9", 60, 80, 3]] * 2
    assert res["http"] == [200, [60, 80]]
    assert res["webcam"] == [3, 200, True]
    assert res["native"] == {
        "image": ["torch.uint8", [2, 64, 64, 3]],
        "keypoints": ["torch.float32", [2, 32, 18, 3]],
        "mask": ["torch.float32", [2, 8, 8, 1]],
        "image_id": ["torch.int64", [2]],
        "valid_xywh": ["torch.int32", [2, 4]]}
    h, w = res["rotated"][:2]
    assert res["rotated"][2] == 3 and h > 96 and w > 96
    # shufflenet_v2 through a world-1 gloo group: its BatchNorm takes the
    # group's statistics (flax's E[x^2] - E[x]^2), the loss the same step's
    n_data, n_model, loss, shard = res["parallel"]
    assert (n_data, n_model, shard) == (1, 1, [0, 1, 2, 3, 4])
    assert abs(loss - res["bn_train_loss"]) <= 1e-4 * res["bn_train_loss"]
    # the workflow scripts import, render and soak without them too
    assert len(res["scripts"]) == 8
    assert res["scene"] == [50, 70, 3] and res["soak"] == 0


@pytest.mark.parametrize("n,pc", [(23, 4), (3, 4), (0, 2), (9, 3)])
def test_work_split_copies_behave_as_the_originals(tmp_path, n, pc):
    """``parallel.distributed`` ``host_shard`` and ``merge_result_files``
    are copies (the JAX module imports jax): the same splits and merges."""
    from rtpose_tpu.parallel import distributed as jdist
    from rtpose_tpu_torch.parallel import distributed as tdist
    items = list(range(n))
    paths = []
    for pi in range(pc):
        assert tdist.host_shard(items, pi, pc) == \
            jdist.host_shard(items, pi, pc)
        p = tmp_path / f"results.rank{pi}.json"
        p.write_text(json.dumps([{"image_id": i}
                                 for i in tdist.host_shard(items, pi, pc)]))
        paths.append(str(p))
    merged = tdist.merge_result_files(paths)
    assert merged == jdist.merge_result_files(paths)
    assert [r["image_id"] for r in merged] == items


def test_skeleton_copy_equals_the_jax_package():
    names = [n for n in dir(skeleton) if n.isupper()]
    assert len(names) >= 17
    for name in ("COCO_PART_NAMES", "ORDER_COCO", "COCO_SIGMAS"):
        assert name in names
    for name in names:
        got, want = getattr(skeleton, name), getattr(jskeleton, name)
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            assert got == want, name


def _code(module) -> str:
    """The module's code without its docstring, as an AST dump."""
    tree = ast.parse(inspect.getsource(module))
    if ast.get_docstring(tree) is not None:
        tree.body = tree.body[1:]
    return ast.dump(tree)


@pytest.mark.parametrize("name", ["data.coco_json", "evalx.cocoeval",
                                  "utils.human"])
def test_copied_modules_equal_the_jax_package(name):
    """The port's copies of the JAX package's jax-free modules (COCO, the
    Human view of people) have the originals' code (only the docstrings
    differ)."""
    port = importlib.import_module(f"rtpose_tpu_torch.{name}")
    original = importlib.import_module(f"rtpose_tpu.{name}")
    assert _code(port) == _code(original)


def test_copied_numpy_helpers_equal_the_jax_package():
    np.testing.assert_array_equal(interp_matrices(8),
                                  jpeaks._interp_matrices(8))
    np.testing.assert_array_equal(blur_matrices(8), jpeaks._blur_matrices(8))
    for src, dst in ((480, 368), (240, 368), (368, 368), (7, 3), (23, 46),
                     (5, 40)):
        np.testing.assert_array_equal(resize_matrix_linear(src, dst),
                                      jresize.resize_matrix_linear(src, dst))
        np.testing.assert_array_equal(resize_matrix(src, dst),
                                      jresize.resize_matrix(src, dst))
    assert torch_layout_map(6) == import_torch.torch_layout_map()
    assert torch_layout_map(2) == torch_layout_map(6)[:12 + 2 * (5 + 7)]


class _PortCalls(ast.NodeTransformer):
    """Rewrites the JAX package's cv2 calls as the port's cv2exact calls
    (and drops ``import cv2``), so the rest of a function can be held
    equal to its port node for node."""

    def visit_Import(self, node):
        return None if [a.name for a in node.names] == ["cv2"] else node

    def visit_Call(self, node):
        self.generic_visit(node)
        f = node.func
        if not (isinstance(f, ast.Attribute) and isinstance(
                f.value, ast.Name) and f.value.id == "cv2"):
            return node
        kw = {k.arg: k.value for k in node.keywords}
        if f.attr == "resize":       # cv2.resize(im, None, fx=s, fy=s)
            return ast.Call(ast.Name("resize_linear", ast.Load()),
                            [node.args[0], kw["fx"]], [])
        if f.attr == "getRotationMatrix2D":
            return ast.Call(ast.Name("get_rotation_matrix_2d", ast.Load()),
                            node.args, [])
        if f.attr == "warpAffine":
            return ast.Call(ast.Name("warp_affine_cubic", ast.Load()),
                            node.args, [ast.keyword("border_value",
                                                    kw["borderValue"])])
        return node


def _body(obj, port_calls=False) -> str:
    """A function's or class's code without docstrings, as an AST dump."""
    tree = ast.parse(inspect.getsource(obj))
    for node in ast.walk(tree):
        if (isinstance(node, (ast.FunctionDef, ast.ClassDef))
                and ast.get_docstring(node) is not None):
            node.body = node.body[1:]
    if port_calls:
        tree = _PortCalls().visit(tree)
    return ast.dump(tree)


@pytest.mark.parametrize("module,name", [
    ("data.native_loader", "AugParams"), ("data.native_loader", "sample_aug"),
    ("data.native_loader", "apply_geometry"),
    ("data.transforms", "RandomRotate"), ("data.transforms", "_rotate_box"),
    ("infer.preprocess", "crop_with_factor"),
    ("infer.preprocess", "factor_closest")])
def test_loader_and_geometry_copies_equal_the_jax_package(module, name):
    """The native loader's sampling and geometry, the rotation and the
    host resize's geometry are the JAX package's code, the cv2 calls
    replaced by their cv2exact equals."""
    port = getattr(importlib.import_module(f"rtpose_tpu_torch.{module}"),
                   name)
    original = getattr(importlib.import_module(f"rtpose_tpu.{module}"),
                       name)
    assert _body(port) == _body(original, port_calls=True)


def test_native_pipeline_source_equals_the_jax_package():
    """native/imgpipe.cpp is the JAX package's, line for line but the
    include lines."""
    def lines(path):
        with open(path) as f:
            return [ln for ln in f.read().splitlines()
                    if not ln.startswith("#include")]
    assert lines(os.path.join(ROOT, "rtpose_tpu_torch", "native",
                              "imgpipe.cpp")) == \
        lines(os.path.join(ROOT, "rtpose_tpu", "native", "imgpipe.cpp"))


def test_width_configs_copy_equals_the_jax_package():
    from rtpose_tpu.models import shufflenet_v2 as jshuffle
    from rtpose_tpu_torch.models import shufflenet_v2
    assert shufflenet_v2.WIDTH_CONFIGS == jshuffle.WIDTH_CONFIGS


def test_caffe_layer_order_copy_equals_the_jax_package():
    """The port's OpenPose caffe-pickle order is the JAX package's, its
    flax paths read as the port's module names."""
    from rtpose_tpu.models import caffe_interop as jcaffe
    from rtpose_tpu_torch.models import caffe_interop
    from rtpose_tpu_torch.models.convert import _port_module
    want = [(kind, _port_module(list(path)))
            for kind, path in jcaffe.openpose_module_order()]
    assert caffe_interop.openpose_module_order() == want
    assert want[:3] == [("conv", "backbone.conv1_1"),
                        ("conv", "backbone.conv1_2"),
                        ("conv", "backbone.conv2_1")]
    assert ("prelu", "paf_stage0.m0_0.prelu") in want


@pytest.mark.parametrize("width,hw", [(1.0, 368), (0.5, 64)])
def test_prototxt_copy_equals_the_jax_package(width, hw):
    from rtpose_tpu.models import caffe_interop as jcaffe
    from rtpose_tpu_torch.models import caffe_interop
    assert caffe_interop.shufflenet_prototxt(width, hw) == \
        jcaffe.shufflenet_prototxt(width, hw)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """Without CUDA (here) or without the repository beside it, the smoke
    script exits non-zero and prints no result line."""
    import torch
    if torch.cuda.is_available() and not alone:
        pytest.skip("this host has a CUDA card")
    cwd = ROOT
    if alone:
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_scene_generator_copy_equals_the_original():
    for seed, n in ((0, 1), (4, 5)):
        for got, want in zip(synth.synth_example(seed=seed, n_people=n,
                                                 h=46, w=62),
                             util_synth.synth_example(seed=seed, n_people=n,
                                                      h=46, w=62)):
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        synth.grid_people(3, 4, 46, 46, np.random.RandomState(3)),
        util_synth.grid_people(3, 4, 46, 46, np.random.RandomState(3)))


def test_gt_host_oracle_copy_equals_the_original():
    rng = np.random.RandomState(0)
    kps = rng.uniform(-20, 380, (4, 18, 3))
    kps[..., 2] = rng.choice([0, 1, 2], (4, 18))
    for args in ({}, dict(input_y=224, input_x=320, sigma=5.0,
                          limb_width=1.289)):
        for got, want in zip(tgt.ground_truth_maps(kps, **args),
                             jgt.ground_truth_maps(kps, **args)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,n_people", [(0, 1), (3, 4), (5, 6)])
def test_host_grouping_oracle_copy_equals_the_original(seed, n_people):
    """The copy's grouping stage is the original's to the bit; its NMS
    upsamples each patch by matrices instead of cv2: the same peaks, scores
    within 1e-6."""
    _, heat, paf = synth_example(seed=seed, n_people=n_people)
    got, got_scores = grouping_ref.paf_to_people(heat, paf)
    want, want_scores = jgrouping_ref.paf_to_people(heat, paf)
    assert len(got) == len(want) == n_people
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    np.testing.assert_allclose(got[..., 2], want[..., 2], atol=1e-6, rtol=0)
    np.testing.assert_allclose(got_scores, want_scores, atol=1e-6, rtol=0)
    joints = jgrouping_ref.joint_list_from_peaks(
        jgrouping_ref.nms(heat, 8, 0.1))
    paf_up = jgrouping_ref.upsample_nearest(paf, 8)
    shape = (heat.shape[0] * 8, heat.shape[1] * 8)
    for mod in (grouping_ref, jgrouping_ref):
        mod.reset_branch_stats()
    a = grouping_ref.group_peaks(joints, shape, paf_up)
    b = jgrouping_ref.group_peaks(joints, shape, paf_up)
    for f in ("subset", "peak_x", "peak_y", "peak_score", "peak_part"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert grouping_ref.BRANCH_STATS == jgrouping_ref.BRANCH_STATS
