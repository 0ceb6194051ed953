"""Video of every chroma format and depth as cv2 gives it (ROADMAP.md item
4i (d)): 4:2:2, 4:4:0, 4:4:4 and 4:0:0 at 8, 10 and 12 bits, and 12-bit
4:2:0, on the CPU.

- The reader against the JAX package's (cv2 5.0's ``VideoCapture``,
  ``rtpose_tpu/demo/video_demo.py``): the port's
  ``open_video(path, device="cpu")`` (libavcodec's planes and the
  conversion kernels' plain versions) gives every frame equal, 0 levels
  apart, with cv2's frame count and fps, on the committed lossless VP9
  fixtures of profiles 1-3 (``scripted_video.CHROMA_FIXTURES``: 4:2:2,
  4:4:0, 4:4:4 and 12-bit 4:2:0 of rendered scenes, with Matroska's
  chroma siting and VUI colour), VP9 in MP4 (``vpcC``), PCM HEVC of the
  range extensions (4:2:2, 4:4:4 and 4:0:0 at 8, 10 and 12 bits, Main
  12) in MP4, Matroska and MPEG-TS, I_PCM H.264 High 4:2:2 (10-bit) and
  High 4:4:4, and MPEG-2 4:2:2, at even and odd heights and widths; the
  decoded planes of the PCM streams are the written ones.
- The plain rules against the wheel's libswscale called directly (the
  one legacy pass of cv2 5.0's swscale graph:
  ``scripts/torch_probe_video.py`` ``swscale_bgr24``) on seeded random
  planes: each format x depth x matrix x range x chroma location 0 / 1 x
  size parity, down to 9x8, 0 levels apart; each path (unscaled, the
  general path's one-tap and many-tap output, full chroma, gray) named
  by ``kernels.frame_route``.
- What stays refused names its item: 4:1:1, 16-bit and RGB (``gbrp``:
  matrix 0, item 4i (c)) by the decoder's pixel format, frames under 9
  rows or 8 columns on a scaling path (item 4i (a)).
"""

import importlib
import os
import sys

import cv2
import numpy as np
import pytest
import torch

from rtpose_tpu.demo import video_demo as jvideo_demo
from rtpose_tpu_torch.demo import mp4
from rtpose_tpu_torch.demo import scripted_video as sv
from rtpose_tpu_torch.demo.video_io import open_video
from rtpose_tpu_torch.native import avcodec
from rtpose_tpu_torch.ops import kernels

C = sv.Colour
FORMATS = {"420": kernels.CHROMA_420, "422": kernels.CHROMA_422,
           "440": kernels.CHROMA_440, "444": kernels.CHROMA_444, "400": None}
# every (matrix, range) with a swscale table
PAIRS = [(m, full) for m in (1, 2, 4, 5, 6, 7, 9) for full in (False, True)]
SIZES = [(48, 64), (47, 64), (48, 63), (47, 63), (9, 8), (9, 9), (10, 8)]


def _probe():
    scripts = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    return importlib.import_module("torch_probe_video")


def _planes(chroma, depth, h, w, seed):
    rng = np.random.RandomState(seed)
    dtype = np.uint8 if depth == 8 else np.uint16
    shapes = [(h, w)] + ([] if chroma is None else
                         [kernels.chroma_shape(chroma, h, w)] * 2)
    return [rng.randint(0, 1 << depth, s).astype(dtype) for s in shapes]


@pytest.mark.parametrize("h,w", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
@pytest.mark.parametrize("depth", kernels.DEPTHS)
@pytest.mark.parametrize("fmt", list(FORMATS))
def test_plain_rules_equal_libswscale(fmt, depth, h, w):
    """The dispatcher's plain rule of each path against libswscale at
    every (matrix, range) and chroma location 0 / 1."""
    chroma = FORMATS[fmt]
    planes = _planes(chroma, depth, h, w, seed=h * w + depth)
    y, u, v = (planes + [None, None])[:3]
    tensors = [None if p is None else torch.from_numpy(p) for p in (y, u, v)]
    route = kernels.frame_route(chroma, depth, h, w)
    for (matrix, full), location in [(p, loc) for p in PAIRS
                                     for loc in (0, 1)]:
        rule = kernels.yuv_rule(matrix, full)
        got = kernels.yuv420_frame_to_bgr(
            *tensors, depth=depth, width=w, rule=rule,
            chroma_location=location, chroma=chroma).numpy()
        # gray: full range whatever the stream states (cv2 5.0's graph)
        want = _probe().swscale_bgr24(y, u, v, matrix,
                                      full or chroma is None, location,
                                      depth)
        diff = int(np.abs(got.astype(int) - want).max())
        assert diff == 0, (route, matrix, full, location, diff)


ROUTES = [("422", 8, 48, 64, "unscaled"), ("422", 8, 48, 63, "unscaled"),
          ("422", 8, 47, 64, "general"), ("422", 10, 48, 64, "general"),
          ("422", 12, 47, 63, "full_chroma"), ("440", 8, 48, 64, "general"),
          ("440", 8, 48, 63, "full_chroma"), ("444", 8, 48, 64, "full_chroma"),
          ("444", 12, 9, 8, "full_chroma"), ("420", 12, 48, 64, "general"),
          ("420", 12, 48, 63, "full_chroma"), ("400", 8, 3, 5, "gray"),
          ("400", 12, 47, 63, "gray")]


@pytest.mark.parametrize("fmt,depth,h,w,route", ROUTES)
def test_route_of_each_format(fmt, depth, h, w, route):
    assert kernels.frame_route(FORMATS[fmt], depth, h, w) == route


def test_one_tap_output_where_chroma_rows_are_whole():
    """4:2:2 keeps a chroma row a luma row: the vertical chroma filter has
    one tap, so swscale's general path takes its one-tap output
    (yuv2bgr24_1); 4:4:0 filters its rows up as 4:2:0 does and halves its
    columns with swscale's 2x bicubic down-filter."""
    _, _, _, vtaps = kernels.general_filters(47, 64, 1,
                                             chroma=kernels.CHROMA_422)
    assert vtaps.shape[1] == 1 and (vtaps == 1 << 12).all()
    hpos, htaps, _, vtaps = kernels.general_filters(
        47, 64, 1, chroma=kernels.CHROMA_440)
    assert vtaps.shape[1] > 2 and htaps.shape == (32, 8)
    assert (htaps.sum(1) == 1 << 14).all() and hpos.max() + 8 <= 64


@pytest.mark.parametrize("fmt,depth,h,w", [("422", 8, 7, 16),
                                           ("444", 10, 9, 7),
                                           ("440", 8, 8, 16),
                                           ("400", 10, 8, 8)])
def test_small_frames_of_every_format_are_refused_by_name(fmt, depth, h, w):
    with pytest.raises(ValueError, match=r"item 4i \(a\)"):
        kernels.frame_route(FORMATS[fmt], depth, h, w)


@pytest.mark.parametrize("name,what", [
    ("yuv411p", r"4:1:1 \(yuv411p\)"), ("yuv420p16le", "16-bit 4:2:0"),
    ("yuv444p16le", "16-bit 4:4:4"), ("gray16le", "16-bit 4:0:0"),
    ("yuv420p9le", "9-bit 4:2:0"), ("gbrp", r"RGB \(gbrp: colour matrix 0"),
    ("gbrp10le", r"item 4i \(c\)")])
def test_what_stays_refused_is_named(name, what):
    import re
    assert re.search(what, avcodec._refused_format(name))
    assert name not in avcodec.READ_FORMATS


def test_read_formats_cover_the_chroma_formats():
    formats = avcodec.READ_FORMATS
    for chroma in ("420", "422", "440", "444"):
        assert formats[f"yuv{chroma}p"][1:] == (False, FORMATS[chroma])
        assert formats[f"yuvj{chroma}p"][:2] == (8, True)
        for depth in (10, 12):
            assert formats[f"yuv{chroma}p{depth}le"][0] == depth
    assert formats["gray12le"] == (12, False, None)
    assert mp4.hevc_refusal(2, (12, 12)) is None
    assert mp4.hevc_refusal(0, (10, 8)) is None
    assert "item 4i" in mp4.hevc_refusal(1, (16, 16))
    assert "item 4i" in mp4.hevc_refusal(3, (10, 8))


def _read_jax(path):
    cap = jvideo_demo.open_video(str(path))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    props = (int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
             cap.get(cv2.CAP_PROP_FPS))
    cap.release()
    return frames, props


def _read_port(path):
    cap = open_video(str(path), device="cpu")
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return frames, cap


def _assert_reads_as_jax(path):
    want, (count, fps) = _read_jax(path)
    got, cap = _read_port(path)
    assert len(got) == len(want) > 0
    assert (cap.frame_count, cap.fps) == (count, fps)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, f"frame {i}"
        assert int(np.abs(g.astype(int) - w).max()) == 0, f"frame {i}"
    return got


@pytest.mark.parametrize("fixture", sv.CHROMA_FIXTURES,
                         ids=[f.name for f in sv.CHROMA_FIXTURES])
def test_chroma_fixtures_read_as_cv2(fixture):
    """The committed lossless VP9 files of profiles 1-3 (the card's wheel
    has no VP9 encoder): the frames, and the decoded planes the written
    scenes'."""
    path = sv.chroma_fixture_path(fixture)
    got = _assert_reads_as_jax(path)
    assert len(got) == fixture.frames
    assert got[0].shape == (fixture.height, fixture.width, 3)
    want = sv.scene_frames(range(fixture.frames), fixture.height,
                           fixture.width, fixture.chroma, fixture.depth)
    cap = open_video(path, device="cpu")
    for planes, picture in zip(want, cap._pictures):
        *decoded, width, colour = picture
        assert (width, colour.depth, colour.chroma) == (
            fixture.width, fixture.depth, fixture.chroma)
        for p, plane in zip(planes, decoded):
            np.testing.assert_array_equal(plane[:, :p.shape[1]], p)
    cap.release()


# (kind, chroma_format_idc, depth, h, w): PCM HEVC and I_PCM H.264
PCM = [("hevc_mp4", 2, 8, 48, 64), ("hevc_mp4", 2, 10, 47, 64),
       ("hevc_mkv", 2, 12, 31, 48), ("hevc_ts", 2, 10, 48, 64),
       ("hevc_mp4", 3, 8, 31, 47), ("hevc_mkv", 3, 10, 48, 64),
       ("hevc_ts", 3, 12, 47, 63), ("hevc_mp4", 1, 12, 48, 64),
       ("hevc_ts", 1, 12, 32, 48), ("hevc_mp4", 0, 8, 47, 63),
       ("hevc_mkv", 0, 10, 48, 64), ("hevc_ts", 0, 12, 31, 33),
       ("h264_mp4", 2, 10, 48, 64), ("h264_mkv", 2, 10, 47, 64),
       ("h264_ts", 2, 10, 31, 48), ("h264_mp4", 2, 8, 47, 64),
       ("h264_mp4", 3, 8, 31, 47), ("h264_mkv", 3, 10, 48, 63)]


def _pcm_frames(chroma, depth, h, w, n=3):
    sub = sv.CHROMA_SUBSAMPLING[chroma]
    if depth == 8:
        return sv.yuv_frames(n, h, w, seed=h * w, chroma=sub)
    return sv.yuv_frames10(n, h, w, seed=h * w, depth=depth, chroma=sub)


def _write_pcm(path, kind, chroma, depth, frames, colour=None):
    if kind.startswith("hevc"):
        stream = sv.encode_hevc_pcm(frames, key_every=2, depth=depth,
                                    chroma=chroma, colour=colour)
        {"hevc_mp4": sv.write_hevc_mp4, "hevc_mkv": sv.write_hevc_mkv,
         "hevc_ts": sv.write_hevc_ts}[kind](str(path), stream)
    else:
        write = {"h264_mp4": sv.write_ipcm_mp4, "h264_mkv": sv.write_ipcm_mkv,
                 "h264_ts": sv.write_ipcm_ts}[kind]
        kw = {"sps_colour" if kind == "h264_mkv" else "colour": colour}
        write(str(path), frames, key_every=2, depth=depth, **kw)


@pytest.mark.parametrize("kind,chroma,depth,h,w", PCM,
                         ids=[f"{k}-{c}-{d}bit-{h}x{w}"
                              for k, c, d, h, w in PCM])
def test_pcm_streams_read_as_cv2(tmp_path, kind, chroma, depth, h, w):
    """PCM HEVC of the range extensions and I_PCM H.264 High 4:2:2 / 4:4:4
    (the cameras' intra formats): the decoded planes are the written
    samples, and the frames cv2's."""
    frames = _pcm_frames(chroma, depth, h, w)
    path = tmp_path / "v.bin"
    _write_pcm(path, kind, chroma, depth, frames,
               colour=C(1, True) if h % 2 else None)
    got = _assert_reads_as_jax(path)
    assert len(got) == len(frames)
    cap = open_video(str(path), device="cpu")
    for planes, picture in zip(frames, cap._pictures):
        *decoded, width, colour = picture
        assert width == w and colour.depth == depth
        assert colour.chroma == sv.CHROMA_SUBSAMPLING[chroma]
        for want, plane in zip(planes, decoded):
            np.testing.assert_array_equal(
                plane[:want.shape[0], :want.shape[1]], want)
    cap.release()


VP9 = [("webm", "yuv422p10le", 31, 48), ("mp4", "yuv444p", 32, 47),
       ("mp4", "yuv440p12le", 33, 64), ("mp4", "yuv420p12le", 48, 64),
       ("webm", "yuv444p12le", 9, 8)]


@pytest.mark.parametrize("container,fmt,h,w", VP9,
                         ids=[f"{c}-{f}-{h}x{w}" for c, f, h, w in VP9])
def test_vp9_profiles_1_and_3_read_as_cv2(tmp_path, container, fmt, h, w):
    """VP9 of profiles 1 and 3 and 12-bit profile 2 from the wheel's
    libvpx-vp9 (lossless) in WebM and in MP4 (its ``vpcC`` states the
    profile and depth)."""
    depth = int(fmt[-4:-2]) if fmt.endswith("le") else 8
    chroma = {"yuv420": (1, 1), "yuv422": (1, 0), "yuv440": (0, 1),
              "yuv444": (0, 0)}[fmt[:6]]
    frames = (sv.yuv_frames(2, h, w, seed=w, chroma=chroma) if depth == 8
              else sv.yuv_frames10(2, h, w, seed=w, depth=depth,
                                   chroma=chroma))
    path = tmp_path / f"v.{container}"
    sv.write_vp9(str(path), frames, container=container, depth=depth)
    assert sv.pixel_format(frames[0], depth) == fmt
    _assert_reads_as_jax(path)


def test_mpeg2_422_reads_as_cv2(tmp_path):
    """cv2's MPEG-2 TS with 4:2:2 sequence extensions (the decoder gives
    yuv422p pictures)."""
    from test_torch_mpegts import mpeg2_422
    path = mpeg2_422(tmp_path)
    cap = open_video(str(path), device="cpu")
    picture = next(cap._pictures)
    assert picture[-1].chroma == kernels.CHROMA_422
    cap.release()
    _assert_reads_as_jax(path)


def test_hevc_gray_ignores_the_streams_range(tmp_path):
    """A 10-bit 4:0:0 HEVC stream that states limited range and BT.709:
    cv2 5.0 converts gray as full range whatever the stream states."""
    frames = _pcm_frames(0, 10, 32, 48)
    path = tmp_path / "gray.mp4"
    _write_pcm(path, "hevc_mp4", 0, 10, frames, colour=C(1, False))
    got = _assert_reads_as_jax(path)
    y = frames[0][0].astype(int)
    np.testing.assert_array_equal(got[0][..., 1],
                                  np.minimum((y + 2) >> 2, 255))
