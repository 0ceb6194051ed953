"""Motion-JPEG and VP8 video read as the JAX demo's bare
``cv2.VideoCapture(path)`` reads it (its FFMPEG backend: libavcodec's
``mjpeg`` and ``vp8`` decoders and swscale), on the CPU: every frame 0
levels apart, the frame count and fps equal.

- Motion-JPEG AVI of cv2's two writers (FFMPEG and its own Motion-JPEG
  backend), of ``demo.video_io.VideoWriter`` and of Pillow's JPEGs at
  4:2:0, 4:2:2, 4:4:4 and gray, with and without Huffman tables (camera
  ``AVI1`` images), at 48x64 and odd sizes; an AVI of each Motion-JPEG tag
  of libavformat's RIFF table (a cv2 file retagged): read where cv2 reads
  it, refused by name (``mjpb``) where cv2 reads nothing;
- Motion-JPEG outside AVI: MOV (``jpeg``, ``mjpa``), MP4 (``mp4v`` of
  objectTypeIndication 0x6C, what cv2 writes for ``MJPG`` in ``.mp4``),
  Matroska (``V_MJPEG`` and a ``V_MS/VFW/FOURCC`` MJPG track), of cv2's
  writer and of the scripted writer; ``mjpb`` refused by name;
- VP8: the committed fixtures (WebM at 48x64, 47x63, 31x47 and 480x640,
  Matroska with BlockGroups, a ``vp08`` MP4, a WebM shaped as a
  browser's ``MediaRecorder`` writes it) and cv2's own VP8 WebM and
  Matroska;
- the JAX package's own ``open_video`` and the port's give the same
  frames of a Motion-JPEG AVI.
"""

import os

import cv2
import numpy as np
import pytest

from rtpose_tpu.demo import video_demo as jvideo_demo
from rtpose_tpu_torch.data import imread_fixtures as fx
from rtpose_tpu_torch.demo import scripted_video as sv
from rtpose_tpu_torch.demo.video_io import (MJPEG_TAGS, VideoWriter,
                                             open_video)

SIZES = [(48, 64), (47, 63), (31, 47)]


def _frames(n, h, w, seed=0):
    return [np.ascontiguousarray(fx.render_scene(seed + i, h, w))
            for i in range(n)]


def _read(cap):
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        out.append(frame)
    cap.release()
    return out


def _assert_reads_as_cv2(path, n=None):
    """The port's frames, frame count and fps are a bare
    ``cv2.VideoCapture(path)``'s; returns the port's reader."""
    cap = cv2.VideoCapture(str(path))
    count, fps = int(cap.get(cv2.CAP_PROP_FRAME_COUNT)), cap.get(
        cv2.CAP_PROP_FPS)
    want = _read(cap)
    port = open_video(str(path), device="cpu")
    got = _read(port)
    assert len(got) == len(want) > 0
    if n is not None:
        assert len(got) == n
    assert (port.frame_count, port.fps) == (count, fps)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, f"frame {i}"
        assert int(np.abs(g.astype(int) - w).max()) == 0, f"frame {i}"
    return port


def _cv2_write(path, fourcc, size, api=cv2.CAP_FFMPEG, n=3, fps=10):
    h, w = size
    writer = cv2.VideoWriter(str(path), api, cv2.VideoWriter_fourcc(*fourcc),
                             fps, (w, h))
    assert writer.isOpened()
    for frame in _frames(n, h, w):
        writer.write(frame)
    writer.release()
    return path


# -- Motion-JPEG AVI ---------------------------------------------------------

@pytest.mark.parametrize("size", SIZES, ids=lambda s: "%dx%d" % s)
@pytest.mark.parametrize("api", ["ffmpeg", "mjpeg"])
def test_cv2_mjpg_avi(tmp_path, api, size):
    """Both of cv2's Motion-JPEG AVI writers (fault F6: the port once
    decoded these with Pillow, up to 73 levels off cv2's read)."""
    path = _cv2_write(tmp_path / "v.avi", "MJPG", size,
                      {"ffmpeg": cv2.CAP_FFMPEG,
                       "mjpeg": cv2.CAP_OPENCV_MJPEG}[api])
    assert _assert_reads_as_cv2(path, 3).codec == "mjpeg"


@pytest.mark.parametrize("size", SIZES, ids=lambda s: "%dx%d" % s)
def test_port_writer_mjpg_avi(tmp_path, size):
    h, w = size
    path = str(tmp_path / "v.avi")
    writer = VideoWriter(path, 12.5, (w, h))
    for frame in _frames(4, h, w, seed=3):
        writer.write(frame)
    writer.release()
    _assert_reads_as_cv2(path, 4)


@pytest.mark.parametrize("huffman", [True, False], ids=["dht", "no_dht"])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: "%dx%d" % s)
@pytest.mark.parametrize("sampling", list(sv.JPEG_SUBSAMPLING))
@pytest.mark.parametrize("container", sv.MJPEG_CONTAINERS)
def test_pillow_jpegs_in_every_container(tmp_path, container, sampling,
                                         size, huffman):
    """Pillow's JPEGs of each chroma format (``yuvj420p``, ``yuvj422p``,
    ``yuvj444p``, ``gray``: the tiled colour kernels' routes at even and
    odd sizes) in AVI, MOV (``jpeg``, ``mjpa``), MP4 (``mp4v`` 0x6C) and
    Matroska (``V_MJPEG``, VFW); without DHT segments too, as cameras'
    ``AVI1`` images come (the decoder's standard tables)."""
    h, w = size
    path = str(tmp_path / f"v.{container}")
    sv.write_mjpeg(path, sv.jpeg_images(_frames(3, h, w, seed=7), sampling,
                                        huffman), (w, h), container)
    _assert_reads_as_cv2(path, 3)


@pytest.mark.parametrize("tag", [t.decode() for t in MJPEG_TAGS] + [
    "dmb1", "mjpa", "jpeg", "AVRn", "mjpg", "mjpb"])
def test_avi_motion_jpeg_tags(tmp_path, tag):
    """cv2's MJPG AVI retagged (strh handler and BITMAPINFOHEADER
    compression): the port reads it where cv2 does, frame for frame
    (``MTSJ`` decodes otherwise: the decoder is handed the tag), and
    refuses it by name where cv2 reads nothing (``mjpb``, Motion-JPEG
    format B)."""
    src = _cv2_write(tmp_path / "v.avi", "MJPG", (48, 64))
    path = tmp_path / f"{tag}.avi"
    path.write_bytes(src.read_bytes().replace(b"MJPG", tag.encode()))
    if not _read(cv2.VideoCapture(str(path))):
        with pytest.raises(ValueError, match=f"{tag}.*item 4"):
            open_video(str(path), device="cpu")
        return
    _assert_reads_as_cv2(path, 3)


# -- Motion-JPEG outside AVI -------------------------------------------------

@pytest.mark.parametrize("ext,fourcc", [(".mov", "MJPG"), (".mov", "jpeg"),
                                        (".mp4", "MJPG"), (".mkv", "MJPG")])
def test_cv2_motion_jpeg_outside_avi(tmp_path, ext, fourcc):
    """cv2's ``MJPG`` in ``.mov`` (a ``jpeg`` entry), in ``.mp4`` (its
    fallback, ``mp4v`` of object type 0x6C) and in ``.mkv``
    (``V_MJPEG``)."""
    path = _cv2_write(tmp_path / f"v{ext}", fourcc, (48, 64), fps=15)
    assert _assert_reads_as_cv2(path, 3).codec == "mjpeg"


@pytest.mark.parametrize("container", ["mov", "mkv"])
def test_motion_jpeg_format_b_refused(tmp_path, container):
    """``mjpb`` (FFmpeg's separate ``mjpegb`` decoder) stays refused by
    name, in a MOV entry and in a VFW Matroska track."""
    path = str(tmp_path / f"v.{container}")
    sv.write_mjpeg(path, sv.jpeg_images(_frames(2, 48, 64)), (64, 48),
                   "mov" if container == "mov" else "vfw",
                   fourcc=b"mjpb")
    if container == "mov":
        with open(path, "rb") as f:
            data = f.read().replace(b"jpeg", b"mjpb")
        with open(path, "wb") as f:
            f.write(data)
    with pytest.raises(ValueError, match="mjpb.*item 4"):
        open_video(path, device="cpu")


# -- VP8 ---------------------------------------------------------------------

@pytest.mark.parametrize("fixture", sv.VP8_FIXTURES, ids=lambda f: f.name)
def test_vp8_fixtures(fixture):
    """The committed VP8 fixtures (the wheel's libvpx): WebM at even and
    odd sizes, Matroska with BlockGroups, a ``vp08`` MP4 with its
    ``vpcC``, the MediaRecorder-shaped WebM (its count cv2's large
    negative one: no ``Duration``; its fps guessed from 33 / 34 ms
    timecodes) and the 480x640 demo file."""
    port = _assert_reads_as_cv2(sv.vp8_path(fixture), fixture.frames)
    assert port.codec == "vp8"
    assert port.size == (fixture.width, fixture.height)
    if fixture.container == "recorder":
        assert port.frame_count < 0 and 29 < port.fps < 31
    if fixture is sv.VP8_DEMO:
        assert fixture.frames >= 16
        assert os.path.getsize(sv.vp8_path(fixture)) <= 150 * 1024


def test_vp8_recorder_fixture_is_shaped_as_mediarecorder_writes():
    """A Segment and Clusters of unknown size, no Duration, no
    DefaultDuration, no Cues, timecodes 33 and 34 ms apart in turn."""
    from rtpose_tpu_torch.demo import mkv
    fixture = next(f for f in sv.VP8_FIXTURES if f.container == "recorder")
    path = sv.vp8_path(fixture)
    with open(path, "rb") as f:
        data = f.read()
        track = mkv.read_track(path, f)
    assert data.count(sv.UNKNOWN_SIZE) == 1 + -(-fixture.frames
                                                // sv.CLUSTER_BLOCKS)
    assert track.duration is None and track.default_duration == 0
    assert b"\x1c\x53\xbb\x6b" not in data            # Cues
    steps = np.diff([b.timecode for b in track.blocks])
    assert set(steps.tolist()) == {33, 34} and not (steps[1:] == steps[:-1]
                                                   ).any()


@pytest.mark.parametrize("ext", [".webm", ".mkv"])
def test_cv2_vp8(tmp_path, ext):
    """cv2's own VP8 (``VP80``) WebM and Matroska."""
    path = _cv2_write(tmp_path / f"v{ext}", "VP80", (48, 64), n=5)
    assert _assert_reads_as_cv2(path, 5).codec == "vp8"


# -- the JAX package's reader ------------------------------------------------

def test_jax_open_video_and_the_ports_give_equal_frames(tmp_path):
    """A Motion-JPEG AVI of the port's writer (phase 12's input) through
    ``rtpose_tpu.demo.video_demo.open_video`` and the port's: the same
    frames, pixel for pixel."""
    path = str(tmp_path / "v.avi")
    writer = VideoWriter(path, 20.0, (170, 128))
    for frame in _frames(5, 128, 170, seed=11):
        writer.write(frame)
    writer.release()
    want = _read(jvideo_demo.open_video(path))
    got = _read(open_video(path, device="cpu"))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
