"""The port's video container and video demo against cv2 and the JAX
package's video demo, on the CPU:

- cv2 reads a Motion-JPEG AVI that ``demo.video_io.VideoWriter`` wrote:
  the frame count, size and fps are the written ones, and the frames that
  cv2's own Motion-JPEG backend decodes equal Pillow's decode of the same
  JPEG, pixel for pixel (cv2's FFMPEG backend decodes JPEG with ffmpeg's
  decoder: the same count and size, other pixels);
- ``open_video`` reads ``cv2.VideoWriter(..., 'MJPG')`` files of both of
  cv2's writers, frame for frame equal to ``cv2.VideoCapture``'s frames
  (its Motion-JPEG backend), and refuses other containers and codecs
  with an error naming them and ROADMAP.md queue 1 item 4;
- the video demo's ``main()`` over an oracle-map pipeline finds, frame
  for frame, the people of the JAX video demo's ``main()`` over the same
  maps (part ids equal, pixel coordinates within 1e-4, scores within
  1e-5), and writes an AVI of as many frames of the input's size.
"""

import sys

import cv2
import numpy as np
import pytest
import torch

from rtpose_tpu.demo import video_demo as jvideo_demo
from rtpose_tpu.infer import pipeline as jpipeline
from rtpose_tpu.utils import draw as jdraw
from rtpose_tpu_torch.data import imread_fixtures as fx
from rtpose_tpu_torch.data.imread import decode_bgr
from rtpose_tpu_torch.data.imwrite import JPEG_OPTIONS
from rtpose_tpu_torch.demo import video_demo
from rtpose_tpu_torch.demo.video_io import VideoWriter, open_video
from rtpose_tpu_torch.infer.pipeline import PosePipeline
from rtpose_tpu_torch.utils import draw as tdraw
from rtpose_tpu_torch.utils.synth_coco import (OracleMaps, oracle_maps,
                                               spread_people)

from test_torch_evalx import JaxOracle

KP_TOL = 1e-4              # pixel coordinates, px
SCORE_TOL = 1e-5
SIZE = 128


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def _frames(n, h=48, w=64):
    return [np.ascontiguousarray(fx.render_scene(i, h, w)) for i in range(n)]


def _write(path, frames, fps=12.5):
    writer = VideoWriter(path, fps, (frames[0].shape[1], frames[0].shape[0]))
    for f in frames:
        writer.write(f)
    writer.release()


def _read_cv2(path, api=cv2.CAP_ANY):
    cap = cv2.VideoCapture(path, api)
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        out.append(frame)
    props = (int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
             cap.get(cv2.CAP_PROP_FPS))
    cap.release()
    return out, props


def _read_port(path):
    cap = open_video(path)
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        out.append(frame)
    cap.release()
    return out, cap


def _pillow_jpeg(bgr):
    import io

    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(bgr[..., ::-1])).save(
        buf, "JPEG", **JPEG_OPTIONS)
    return decode_bgr(buf.getvalue())


@pytest.mark.parametrize("api", ["any", "mjpeg"])
def test_cv2_reads_the_port_avi(tmp_path, api):
    frames = _frames(9)
    path = str(tmp_path / "port.avi")
    _write(path, frames)
    got, (count, fps) = _read_cv2(path, {"any": cv2.CAP_ANY,
                                         "mjpeg": cv2.CAP_OPENCV_MJPEG}[api])
    assert count == len(got) == 9 and fps == 12.5
    assert all(f.shape == (48, 64, 3) for f in got)
    if api == "mjpeg":
        for g, f in zip(got, frames):
            np.testing.assert_array_equal(g, _pillow_jpeg(f))
    ours, cap = _read_port(path)
    assert len(ours) == 9 and cap.fps == 12.5 and cap.size == (64, 48)
    for o, f in zip(ours, frames):
        np.testing.assert_array_equal(o, _pillow_jpeg(f))


@pytest.mark.parametrize("api", ["any", "mjpeg"])
def test_port_reads_cv2_mjpg_avi(tmp_path, api):
    frames = _frames(7)
    path = str(tmp_path / "cv2.avi")
    writer = cv2.VideoWriter(path, {"any": cv2.CAP_ANY,
                                    "mjpeg": cv2.CAP_OPENCV_MJPEG}[api],
                             cv2.VideoWriter_fourcc(*"MJPG"), 10, (64, 48))
    assert writer.isOpened()
    for f in frames:
        writer.write(f)
    writer.release()
    want, _ = _read_cv2(path, cv2.CAP_OPENCV_MJPEG)
    got, cap = _read_port(path)
    assert len(got) == len(want) == 7
    assert cap.fps == 10 and cap.size == (64, 48) and cap.frame_count == 7
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_open_video_refuses_other_containers(tmp_path):
    path = str(tmp_path / "v.avi")
    _write(path, _frames(2))
    xvid = str(tmp_path / "xvid.avi")
    open(xvid, "wb").write(open(path, "rb").read().replace(b"MJPG",
                                                           b"XVID"))
    with pytest.raises(ValueError, match="XVID.*item 4"):
        open_video(xvid)
    mp4 = str(tmp_path / "v.mp4")
    open(mp4, "wb").write(b"\0\0\0\x18ftypmp42" + b"\0" * 64)
    with pytest.raises(ValueError, match="not an AVI.*item 4"):
        open_video(mp4)
    with pytest.raises(FileNotFoundError):
        open_video(str(tmp_path / "none.avi"))


def test_video_writer_checks_its_frames(tmp_path):
    writer = VideoWriter(str(tmp_path / "v.avi"), 20.0, (64, 48))
    try:
        with pytest.raises(ValueError, match="48, 64, 3"):
            writer.write(np.zeros((48, 65, 3), np.uint8))
    finally:
        writer.release()
    with pytest.raises(ValueError, match="positive"):
        VideoWriter(str(tmp_path / "w.avi"), 0.0, (64, 48))


def test_iter_batches_takes_the_tail():
    class Cap:
        def __init__(self, n):
            self.left = n

        def read(self):
            self.left -= 1
            return (True, self.left) if self.left >= 0 else (False, None)

    assert [len(b) for b in video_demo.iter_batches(Cap(7), 3)] == [3, 3, 1]


def _recording(module, calls):
    real = module.draw_people

    def draw(frame, people, meta=None, **kw):
        calls.append((people, meta))
        return real(frame, people, meta, **kw)

    return draw


def test_video_demo_people_equal_the_jax_video_demo(tmp_path, monkeypatch,
                                                    capsys):
    """Seven 128x170 frames at --batch 3 (a tail batch of one) through both
    demos' ``main()`` over the same oracle maps (two people a frame)."""
    rng = np.random.RandomState(0)
    maps = oracle_maps({(128, 170): spread_people(rng, 2, 128, 170)}, SIZE)
    video = str(tmp_path / "in.avi")
    _write(video, _frames(7, 128, 170), fps=15.0)
    tpipe = PosePipeline(OracleMaps(maps), device="cpu", input_size=SIZE,
                         flip=False)
    jpipe = jpipeline.PosePipeline(JaxOracle(maps), {}, input_size=SIZE,
                                   flip=False, device_resize=True)
    ours, theirs = [], []
    monkeypatch.setattr(video_demo, "build_pipeline", lambda args: tpipe)
    monkeypatch.setattr(jvideo_demo, "build_pipeline", lambda args: jpipe)
    monkeypatch.setattr(tdraw, "draw_people", _recording(tdraw, ours))
    monkeypatch.setattr(jdraw, "draw_people", _recording(jdraw, theirs))
    out = str(tmp_path / "out.avi")
    monkeypatch.setattr(sys, "argv", [
        "video_demo", "--video", video, "--output", out, "--batch", "3",
        "--device", "cpu", "--no-device-resize"])
    n, _ = video_demo.main()
    assert "processed 7 frames in" in capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", [
        "video_demo", "--video", video, "--output",
        str(tmp_path / "jax.avi"), "--batch", "3"])
    jvideo_demo.main()
    assert n == len(ours) == len(theirs) == 7
    for (got, gmeta), (want, wmeta) in zip(ours, theirs):
        assert len(got) == len(want) == 2
        sx = gmeta["upsampled"][1] / gmeta["scale"]
        sy = gmeta["upsampled"][0] / gmeta["scale"]
        assert (gmeta["upsampled"], gmeta["scale"]) == (
            tuple(wmeta["upsampled"]), wmeta["scale"])
        for a, b in zip(got, want):
            assert a["parts"].keys() == b["parts"].keys()
            assert abs(a["score"] - b["score"]) <= SCORE_TOL
            for part, (x, y, s) in a["parts"].items():
                bx, by, bs = b["parts"][part]
                assert abs(x - bx) * sx <= KP_TOL
                assert abs(y - by) * sy <= KP_TOL
                assert abs(s - bs) <= SCORE_TOL
    written, cap = _read_port(out)
    assert len(written) == 7 and cap.size == (170, 128) and cap.fps == 20.0
    assert _read_cv2(out)[1][0] == 7
