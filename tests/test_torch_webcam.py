"""The port's webcam demo (``demo/web_demo.py`` over ``demo/camera.py``
and ``demo/frame_view.py``) against the JAX package's and against cv2, on
the CPU:

- (a) the port's ``web_demo.main()`` and the JAX ``web_demo.main()`` over
  the same oracle maps, the same six 128x170 YUYV frames (the JAX demo's
  ``cv2.VideoCapture`` yields cv2's conversion of the bytes the port's
  camera reads) and the same scripted clock: both stop on q after the
  fourth frame, every shown frame equal pixel for pixel, the people
  within the video test's tolerances;
- (b) ``utils.draw.put_text`` against ``cv2.putText`` (FONT_HERSHEY_SIMPLEX,
  scale 1.0, thickness 2), bound 0, also on frames that clip the text,
  and its glyph table against one made again from cv2;
- (c) ``camera.yuyv_to_bgr`` against ``cv2.cvtColor(COLOR_YUV2BGR_YUYV)``,
  bound 0;
- (d) ``camera.open_camera`` over scripted V4L2 devices
  (``demo.scripted_camera``): the request codes and struct sizes, YUYV
  before Motion-JPEG, another format refused by name, the frames, and
  ``release``;
- (e) without a device, an error naming ``/dev/video<N>``;
- (f) the browser view: the page, the stream's parts byte for byte, the
  quit, and a client that stops reading;
- ``skeleton.CocoPart`` against the JAX enum.
"""

import http.client
import os
import socket
import sys
import time
import types

import cv2
import numpy as np
import pytest
import torch

from rtpose_tpu import skeleton as jskeleton
from rtpose_tpu.demo import web_demo as jweb_demo
from rtpose_tpu.infer import pipeline as jpipeline
from rtpose_tpu.utils import draw as jdraw
from rtpose_tpu_torch import skeleton
from rtpose_tpu_torch.data import imread_fixtures as fx
from rtpose_tpu_torch.data.imread import decode_bgr
from rtpose_tpu_torch.data.imwrite import encode_bgr
from rtpose_tpu_torch.demo import camera, web_demo
from rtpose_tpu_torch.demo.frame_view import FrameView
from rtpose_tpu_torch.demo.scripted_camera import (ScriptedDevice,
                                                   ScriptedV4L2)
from rtpose_tpu_torch.infer.pipeline import PosePipeline
from rtpose_tpu_torch.utils import draw as tdraw
from rtpose_tpu_torch.utils import text_glyphs
from rtpose_tpu_torch.utils.synth_coco import (OracleMaps, oracle_maps,
                                               spread_people)

from test_torch_evalx import JaxOracle
from test_torch_video import KP_TOL, SCORE_TOL, _recording

SIZE = 128
H, W = 128, 170
# the clock both demos read: before the first frame, then after each
# drawing (fps 20.0, 8.1, about 12500 and 1.3 on the four frames shown)
CLOCK = (100.0, 100.05, 100.1734, 100.17348, 100.9234, 102.9234)


def _bgr(seed, h=H, w=W):
    return np.ascontiguousarray(fx.render_scene(seed, h, w)[..., ::-1])


def _scripted(monkeypatch, devices):
    syscalls = ScriptedV4L2(devices)
    monkeypatch.setattr(camera, "SYSCALLS", syscalls)
    return syscalls


def _read_all(cap):
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            return frames
        frames.append(frame)


# ---------------------------------------------------------------------------
# (a) the demo against the JAX demo
# ---------------------------------------------------------------------------

class _RecordingView:
    """The port's view with the JAX test's window: it keeps each shown
    frame and asks to quit after the fourth."""

    def __init__(self, shown):
        self.shown = shown
        self.url = "http://recording/"
        self.closed = False

    def show(self, frame):
        self.shown.append(frame.copy())
        return len(self.shown) >= 4

    def close(self):
        self.closed = True


def _jax_cv2(frames, shown):
    """cv2 for the JAX demo: the real module but for the capture (it
    yields `frames`), the window (it records) and the key (q after the
    fourth frame); ``destroyAllWindows`` does nothing (no display)."""

    class Capture:
        def __init__(self, index):
            assert index == 0
            self.left = list(frames)

        def isOpened(self):
            return True

        def read(self):
            return (True, self.left.pop(0)) if self.left else (False, None)

        def release(self):
            pass

    proxy = types.ModuleType("cv2")
    proxy.__getattr__ = lambda name: getattr(cv2, name)
    proxy.VideoCapture = Capture
    proxy.imshow = lambda title, img: shown.append(img.copy())
    proxy.waitKey = lambda delay: ord("q") if len(shown) >= 4 else -1
    proxy.destroyAllWindows = lambda: None
    return proxy


def _clock(attr):
    ticks = iter(CLOCK)
    return types.SimpleNamespace(**{attr: lambda: next(ticks)})


def test_webcam_demo_frames_equal_the_jax_demo(monkeypatch, capsys):
    rng = np.random.RandomState(0)
    maps = oracle_maps({(H, W): spread_people(rng, 2, H, W)}, SIZE)
    device = ScriptedDevice([_bgr(i) for i in range(6)], offers=("YUYV",))
    _scripted(monkeypatch, {0: device})
    tpipe = PosePipeline(OracleMaps(maps), device="cpu", input_size=SIZE,
                         flip=False)
    jpipe = jpipeline.PosePipeline(JaxOracle(maps), {}, input_size=SIZE,
                                   flip=False, device_resize=True)
    ours, theirs, shown, jshown = [], [], [], []
    views = []

    def view(host, port):
        assert (host, port) == ("127.0.0.1", 8090)
        views.append(_RecordingView(shown))
        return views[-1]

    monkeypatch.setattr(web_demo, "build_pipeline", lambda args: tpipe)
    monkeypatch.setattr(web_demo, "FrameView", view)
    monkeypatch.setattr(web_demo, "time", _clock("perf_counter"))
    monkeypatch.setattr(tdraw, "draw_people", _recording(tdraw, ours))
    monkeypatch.setattr(sys, "argv", ["web_demo", "--device", "cpu"])
    n, times = web_demo.main()
    printed = capsys.readouterr().out
    assert "camera 0: YUYV 170x128; view at http://recording/" in printed
    assert views[0].closed and not device.open and not device.streaming

    frames = [cv2.cvtColor(np.frombuffer(p, np.uint8).reshape(H, W, 2),
                           cv2.COLOR_YUV2BGR_YUYV)
              for p in device.payloads]
    monkeypatch.setitem(sys.modules, "cv2", _jax_cv2(frames, jshown))
    monkeypatch.setattr(jweb_demo, "build_pipeline", lambda args: jpipe)
    monkeypatch.setattr(jweb_demo, "time", _clock("time"))
    monkeypatch.setattr(jdraw, "draw_people", _recording(jdraw, theirs))
    monkeypatch.setattr(sys, "argv", ["web_demo"])
    jweb_demo.main()

    assert n == len(shown) == len(jshown) == len(ours) == len(theirs) == 4
    assert times == pytest.approx(np.diff(CLOCK[:5]).tolist(), abs=1e-12)
    for got, want in zip(shown, jshown):
        np.testing.assert_array_equal(got, want)
    for (got, gmeta), (want, wmeta) in zip(ours, theirs):
        assert len(got) == len(want) == 2
        sx = gmeta["upsampled"][1] / gmeta["scale"]
        sy = gmeta["upsampled"][0] / gmeta["scale"]
        for a, b in zip(got, want):
            assert a["parts"].keys() == b["parts"].keys()
            assert abs(a["score"] - b["score"]) <= SCORE_TOL
            for part, (x, y, s) in a["parts"].items():
                bx, by, bs = b["parts"][part]
                assert abs(x - bx) * sx <= KP_TOL
                assert abs(y - by) * sy <= KP_TOL
                assert abs(s - bs) <= SCORE_TOL


def test_run_webcam_releases_camera_and_view_when_the_pipeline_fails():
    class Pipe:
        def run(self, frame):
            raise RuntimeError("the card is gone")

    class Cap:
        released = False

        def read(self):
            return True, np.zeros((8, 8, 3), np.uint8)

        def release(self):
            self.released = True

    cap, view = Cap(), _RecordingView([])
    with pytest.raises(RuntimeError, match="the card is gone"):
        web_demo.run_webcam(Pipe(), cap, view)
    assert cap.released and view.closed


def test_webcam_demo_needs_the_card_by_default(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    monkeypatch.setattr(sys, "argv", ["web_demo", "--stages", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        web_demo.main()


# ---------------------------------------------------------------------------
# (b) the FPS text against cv2.putText
# ---------------------------------------------------------------------------

TEXTS = ("0.0 FPS", "7.1 FPS", "29.9 FPS", "444.4 FPS", "12345.6 FPS",
         "1000000000.0 FPS")


@pytest.mark.parametrize("text", TEXTS)
@pytest.mark.parametrize("shape", [(480, 640), (48, 64), (30, 200)])
def test_put_text_equals_cv2(text, shape):
    rng = np.random.RandomState(len(text) + shape[1])
    for org in ((10, 30), (0, 0), (-7, 12), (40, 45), (150, 25), (5, 60)):
        want = rng.randint(0, 256, shape + (3,)).astype(np.uint8)
        color = tuple(int(v) for v in rng.randint(0, 256, 3))
        got = want.copy()
        cv2.putText(want, text, org, cv2.FONT_HERSHEY_SIMPLEX, 1.0, color, 2)
        tdraw.put_text(got, text, org, color, 2)
        np.testing.assert_array_equal(got, want, err_msg=str((org, color)))


def test_put_text_glyph_table_equals_cv2():
    want = text_glyphs.make_table()
    got = text_glyphs.load_table()
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_put_text_refuses_what_it_has_no_glyphs_for():
    img = np.zeros((40, 80, 3), np.uint8)
    with pytest.raises(ValueError, match=r"no glyph for \['x'\]"):
        tdraw.put_text(img, "1.0 xFPS", (10, 30), (0, 255, 0))
    with pytest.raises(ValueError, match="thickness 2"):
        tdraw.put_text(img, "1.0 FPS", (10, 30), (0, 255, 0), 3)
    with pytest.raises(ValueError, match="uint8"):
        tdraw.put_text(img.astype(np.float32), "1", (10, 30), (0, 255, 0))
    assert not img.any()


# ---------------------------------------------------------------------------
# (c) YUYV against cv2.cvtColor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w", [2, 6, 34, 170, 640])
def test_yuyv_to_bgr_equals_cv2(w):
    rng = np.random.RandomState(w)
    for h in (1, 5, 48):
        buf = rng.randint(0, 256, (h, w, 2)).astype(np.uint8)
        want = cv2.cvtColor(buf, cv2.COLOR_YUV2BGR_YUYV)
        np.testing.assert_array_equal(
            camera.yuyv_to_bgr(buf.tobytes(), h, w), want)
        padded = np.zeros((h, 2 * w + 8), np.uint8)
        padded[:, :2 * w] = buf.reshape(h, 2 * w)
        np.testing.assert_array_equal(
            camera.yuyv_to_bgr(padded.tobytes(), h, w, 2 * w + 8), want)
    with pytest.raises(ValueError, match="even width"):
        camera.yuyv_to_bgr(b"\0" * 6, 1, 3)


# ---------------------------------------------------------------------------
# (d) the camera over scripted V4L2 devices
# ---------------------------------------------------------------------------

def test_v4l2_request_codes_and_struct_sizes(monkeypatch):
    """The codes of linux/videodev2.h on x86-64, and each request passes
    a struct of its size."""
    assert (camera.VIDIOC_QUERYCAP, camera.VIDIOC_S_FMT,
            camera.VIDIOC_REQBUFS, camera.VIDIOC_QUERYBUF,
            camera.VIDIOC_QBUF, camera.VIDIOC_DQBUF,
            camera.VIDIOC_STREAMON, camera.VIDIOC_STREAMOFF) == (
        0x80685600, 0xC0D05605, 0xC0145608, 0xC0585609, 0xC058560F,
        0xC0585611, 0x40045612, 0x40045613)
    device = ScriptedDevice([_bgr(0, 16, 20)] * 2)
    _scripted(monkeypatch, {0: device})
    cap = camera.open_camera(0)
    assert len(_read_all(cap)) == 2
    cap.release()
    sizes = {"QUERYCAP": 104, "S_FMT": 208, "REQBUFS": 20, "QUERYBUF": 88,
             "QBUF": 88, "DQBUF": 88, "STREAMON": 4, "STREAMOFF": 4}
    assert all(size == sizes[name] for name, size in device.calls)
    names = [name for name, _ in device.calls]
    assert names[:3] == ["QUERYCAP", "S_FMT", "REQBUFS"]
    assert names.count("QUERYBUF") == camera.BUFFERS
    assert names.count("DQBUF") == 2 and names[-1] == "STREAMOFF"
    # each dequeued buffer was queued again before the next wait
    assert names.count("QBUF") == camera.BUFFERS + 2


@pytest.mark.parametrize("offers,chosen", [
    (("MJPG", "YUYV"), "YUYV"), (("YUYV",), "YUYV"), (("MJPG",), "MJPG")])
def test_camera_reads_yuyv_before_mjpeg(monkeypatch, offers, chosen):
    frames = [_bgr(i, 48, 64) for i in range(3)]
    device = ScriptedDevice(frames, offers=offers)
    _scripted(monkeypatch, {2: device})
    cap = camera.open_camera(2)
    assert cap.isOpened() and cap.fourcc == device.fourcc == chosen
    assert (cap.width, cap.height) == (64, 48)
    got = _read_all(cap)
    assert len(got) == 3
    for frame, payload in zip(got, device.payloads):
        if chosen == "YUYV":
            want = cv2.cvtColor(np.frombuffer(payload, np.uint8).reshape(
                48, 64, 2), cv2.COLOR_YUV2BGR_YUYV)
        else:
            want = decode_bgr(payload)
            np.testing.assert_array_equal(
                want, cv2.imdecode(np.frombuffer(payload, np.uint8),
                                   cv2.IMREAD_COLOR))
        np.testing.assert_array_equal(frame, want)
    cap.release()


def test_camera_refuses_another_format_by_name(monkeypatch):
    device = ScriptedDevice([_bgr(0, 16, 20)], offers=("NV12",))
    _scripted(monkeypatch, {0: device})
    with pytest.raises(RuntimeError, match="YUYV: answered 'NV12', MJPG: "
                                           "answered 'NV12'"):
        camera.open_camera(0)
    assert not device.open


def test_camera_release_stops_unmaps_and_closes(monkeypatch):
    device = ScriptedDevice([_bgr(i, 16, 20) for i in range(5)])
    _scripted(monkeypatch, {0: device})
    cap = camera.open_camera(0)
    assert device.streaming and device.open
    assert device.mapped == set(range(camera.BUFFERS))
    assert cap.read()[0]
    cap.release()
    assert not device.streaming and not device.mapped and not device.open
    assert not cap.isOpened() and cap.read() == (False, None)
    cap.release()
    assert device.calls.count(("STREAMOFF", 4)) == 1


# ---------------------------------------------------------------------------
# (e) no device
# ---------------------------------------------------------------------------

def test_open_camera_without_a_device_names_it():
    n = next(i for i in range(64, 256)
             if not os.path.exists(f"/dev/video{i}"))
    with pytest.raises(RuntimeError,
                       match=f"cannot open camera {n} \\(/dev/video{n}: "):
        camera.open_camera(n)


# ---------------------------------------------------------------------------
# (f) the browser view
# ---------------------------------------------------------------------------

def _get(view, path):
    conn = http.client.HTTPConnection("127.0.0.1",
                                      view.server.server_address[1],
                                      timeout=30)
    conn.request("GET", path)
    return conn, conn.getresponse()


def _part(resp):
    assert resp.readline() == b"--frame\r\n"
    headers = {}
    while True:
        line = resp.readline().decode().strip()
        if not line:
            break
        key, value = line.split(": ", 1)
        headers[key] = value
    assert headers["Content-Type"] == "image/jpeg"
    body = resp.read(int(headers["Content-Length"]))
    assert resp.read(2) == b"\r\n"
    return body


def test_view_serves_page_stream_and_quit():
    view = FrameView("127.0.0.1", 0)
    try:
        conn, resp = _get(view, "/")
        page = resp.read().decode()
        conn.close()
        assert resp.status == 200 and '<img src="/stream"' in page
        assert 'fetch("/quit")' in page and 'e.key === "q"' in page
        frames = [_bgr(i, 48, 64) for i in range(2)]
        assert view.show(frames[0]) is False
        conn, resp = _get(view, "/stream")
        assert resp.status == 200
        assert resp.getheader("Content-Type") == \
            "multipart/x-mixed-replace; boundary=frame"
        assert _part(resp) == encode_bgr(frames[0], ".jpg")
        assert view.show(frames[1]) is False
        assert _part(resp) == encode_bgr(frames[1], ".jpg")
        quit_conn, quit_resp = _get(view, "/quit")
        assert quit_resp.status == 200
        quit_conn.close()
        assert view.show(frames[0]) is True and view.quit_requested
        missing, resp404 = _get(view, "/nothing")
        assert resp404.status == 404
        missing.close()
    finally:
        view.close()
    conn.close()


def test_view_never_waits_on_a_client_that_stops_reading():
    view = FrameView("127.0.0.1", 0)
    client = socket.create_connection(("127.0.0.1",
                                       view.server.server_address[1]))
    try:
        client.sendall(b"GET /stream HTTP/1.1\r\nHost: x\r\n\r\n")
        frame = np.random.RandomState(0).randint(
            0, 256, (480, 640, 3)).astype(np.uint8)
        t0 = time.perf_counter()
        for _ in range(100):
            assert view.show(frame) is False
        assert time.perf_counter() - t0 < 2.0
    finally:
        t0 = time.perf_counter()
        view.close()
        client.close()
    assert time.perf_counter() - t0 < 10.0
    assert not view._thread.is_alive()


def test_view_port_that_cannot_be_bound_raises():
    first = FrameView("127.0.0.1", 0)
    try:
        port = first.server.server_address[1]
        with pytest.raises(RuntimeError, match=f"127.0.0.1:{port}"):
            FrameView("127.0.0.1", port)
    finally:
        first.close()


# ---------------------------------------------------------------------------
# the part enum
# ---------------------------------------------------------------------------

def test_coco_part_equals_the_jax_enum():
    assert [(p.name, p.value) for p in skeleton.CocoPart] == \
        [(p.name, p.value) for p in jskeleton.CocoPart]
    assert skeleton.CocoPart.background == 18
    assert skeleton.CocoPart["left_ear"] == jskeleton.CocoPart.left_ear
