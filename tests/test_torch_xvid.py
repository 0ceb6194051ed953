"""The port's XVID writer against ``cv2.VideoWriter(..., 'XVID')``, on the
CPU:

- ``demo.video_io.VideoWriter(..., fourcc="XVID")`` (over
  ``native.avencode.Encoder``) writes, for the same frames, the packets
  that cv2's FFmpeg writer writes, byte for byte, with the same key
  flags: 16 rendered 480x640 frames and 7 of 128x170 (odd macroblock
  rows and columns), at 20 and 29.97 fps (cv2's packets read by the
  port's own AVI parser);
- cv2 and ``open_video`` read the port's file with its frame count, fps
  and size, and their frames equal each other's;
- cv2's time base and bit rate rules, and the writer's refusals.
"""

import cv2
import numpy as np
import pytest

from rtpose_tpu_torch.data import imread_fixtures as fx
from rtpose_tpu_torch.demo.video_io import AviStream, VideoWriter, open_video
from rtpose_tpu_torch.native import avcodec, avencode

CASES = [(480, 640, 16, 20.0), (480, 640, 16, 29.97), (128, 170, 7, 20.0),
         (128, 170, 7, 29.97)]


def _frames(n, h, w):
    return [np.ascontiguousarray(fx.render_scene(i, h, w)) for i in range(n)]


def _packets(path):
    """(packets, key flags, stream) of an AVI's first video stream."""
    with open(path, "rb") as f:
        stream = AviStream(path, f)
        out = []
        for off, n in stream.frames:
            f.seek(off)
            out.append(f.read(n))
    keys = []
    with open(path, "rb") as f:
        data = f.read()
    at = data.rindex(b"idx1") + 8
    while at + 16 <= len(data):
        keys.append(bool(int.from_bytes(data[at + 4:at + 8], "little")
                         & 0x10))
        at += 16
    return out, keys, stream


def _write_cv2(path, frames, fps):
    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"XVID"), fps,
                             (w, h))
    assert writer.isOpened()
    for f in frames:
        writer.write(f)
    writer.release()


def _write_port(path, frames, fps):
    h, w = frames[0].shape[:2]
    writer = VideoWriter(path, fps, (w, h), fourcc="XVID")
    for f in frames:
        writer.write(f)
    writer.release()
    return writer


def _read(cap):
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            return out
        out.append(frame)


@pytest.mark.parametrize("h,w,n,fps", CASES)
def test_xvid_packets_equal_cv2s(tmp_path, h, w, n, fps):
    frames = _frames(n, h, w)
    _write_cv2(str(tmp_path / "cv2.avi"), frames, fps)
    writer = _write_port(str(tmp_path / "port.avi"), frames, fps)
    want, want_keys, _ = _packets(str(tmp_path / "cv2.avi"))
    got, got_keys, stream = _packets(str(tmp_path / "port.avi"))
    assert len(got) == len(want) == n
    differing = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    assert not differing, f"packets {differing} differ from cv2's"
    assert got_keys == want_keys
    assert got_keys[0] and got_keys.count(True) == -(-n // avencode.GOP)
    assert stream.codec == "mpeg4" and stream.size == (w, h)
    assert set(writer.seconds) == {"convert", "encode", "write"}
    assert all(v > 0 for v in writer.seconds.values())


@pytest.mark.parametrize("h,w,n,fps", CASES[1:3])
def test_cv2_and_open_video_read_the_port_xvid(tmp_path, h, w, n, fps):
    path = str(tmp_path / "port.avi")
    _write_port(path, _frames(n, h, w), fps)
    cap = cv2.VideoCapture(path)
    props = (int(cap.get(cv2.CAP_PROP_FRAME_COUNT)), cap.get(cv2.CAP_PROP_FPS),
             int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
             int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
    want = _read(cap)
    cap.release()
    assert props == (n, fps, w, h) and len(want) == n
    video = open_video(path, device="cpu")
    got = _read(video)
    video.release()
    assert (video.frame_count, video.fps, video.size) == (n, fps, (w, h))
    assert len(got) == n
    for g, f in zip(got, want):
        np.testing.assert_array_equal(g, f)


@pytest.mark.parametrize("fps,base", [(20.0, (1, 20)), (29.97, (100, 2997)),
                                      (23.976, (1000, 23976)),
                                      (12.5, (10, 125)), (30.0, (1, 30))])
def test_time_base_is_cv2s(fps, base):
    assert avencode.time_base(fps) == base


def test_bit_rate_is_cv2s():
    assert avencode.bit_rate(20.0, 640, 480) == 9216000
    assert avencode.bit_rate(29.97, 640, 480) == 13810176
    assert avencode.bit_rate(1000.0, 4096, 4096) == 1610612736


def test_writer_refuses_other_codecs_and_sizes(tmp_path):
    with pytest.raises(ValueError, match="XVID or MJPG AVI, not 'H264'"):
        VideoWriter(str(tmp_path / "a.avi"), 20.0, (64, 48), fourcc="H264")
    writer = VideoWriter(str(tmp_path / "b.avi"), 20.0, (64, 48),
                         fourcc="XVID")
    try:
        with pytest.raises(ValueError, match="48, 64, 3"):
            writer.write(np.zeros((48, 64, 4), np.uint8))
    finally:
        writer.release()


def test_xvid_writer_without_the_libraries_raises(tmp_path, monkeypatch):
    """No quiet fall-back to Motion-JPEG: the first write raises, naming
    where it looked."""
    monkeypatch.setattr(avencode, "_libs", None)
    monkeypatch.setattr(avcodec, "_libs", None)
    monkeypatch.setattr(avcodec, "_library_dirs", lambda: [])
    writer = VideoWriter(str(tmp_path / "c.avi"), 20.0, (64, 48),
                         fourcc="XVID")
    try:
        with pytest.raises(RuntimeError, match="no libavcodec found.*"
                                               "searched no such directory"):
            writer.write(np.zeros((48, 64, 3), np.uint8))
    finally:
        writer.release()
