"""The port's video container and video demo against cv2 and the JAX
package's video demo, on the CPU:

- cv2 reads a Motion-JPEG AVI that ``demo.video_io.VideoWriter`` wrote:
  the frame count, size and fps are the written ones, and the frames that
  cv2's own Motion-JPEG backend decodes equal Pillow's decode of the same
  JPEG, pixel for pixel (cv2's FFMPEG backend decodes JPEG with ffmpeg's
  decoder: the same count and size, other pixels);
- ``open_video`` reads ``cv2.VideoWriter(..., 'MJPG')`` files of both of
  cv2's writers, frame for frame equal to ``cv2.VideoCapture``'s frames
  (its Motion-JPEG backend), and refuses what it still does not read
  (HEVC Main 10 in MP4, Matroska or MPEG-TS, AV1, 10-bit VP9, laced
  Matroska blocks, edits of another media rate, MPEG-2 4:2:2) with an
  error naming it and ROADMAP.md queue 1 item 4 (H.264 and MPEG-4 files:
  tests/test_torch_mp4.py; Matroska / WebM and VP9:
  tests/test_torch_mkv.py; MPEG-TS: tests/test_torch_mpegts.py; HEVC:
  tests/test_torch_hevc.py; program streams: tests/test_torch_mpegps.py);
  what it once refused (MPEG-TS, fragmented MP4, ``mvex``, a two-entry
  edit list, HEVC in MP4, Matroska and MPEG-TS, an MPEG program stream)
  it reads as cv2 reads it;
- the video demo's ``main()`` over an oracle-map pipeline finds, frame
  for frame, the people of the JAX video demo's ``main()`` over the same
  maps (part ids equal, pixel coordinates within 1e-4, scores within
  1e-5) on a Motion-JPEG AVI, on cv2's MPEG-2 TS and on PCM HEVC in an
  MP4 and a program stream, and writes an XVID AVI of as many frames of
  the input's size, as the JAX demo does (the packets:
  tests/test_torch_xvid.py).
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
from rtpose_tpu_torch.demo.video_io import (AviStream, VideoWriter,
                                             open_video)
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
    cap = open_video(path, device="cpu")
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


def _still_refused(tmp_path, kind):
    """A file of `kind` that open_video refuses (or None: no file)."""
    from rtpose_tpu_torch.demo import mkv
    from rtpose_tpu_torch.demo import scripted_video as sv
    path = str(tmp_path / f"{kind}.bin")
    if kind == "missing":
        return path
    if kind in ("mkv_av1", "mkv_laced", "webm_vp9_profile1",
                "webm_vp9_profile3", "ebml_other"):
        codec = "V_AV1" if kind == "mkv_av1" else "V_VP9"
        with open(sv.VP9_WEBM, "rb") as f:
            track = mkv.read_track(sv.VP9_WEBM, f)
            packets = [(d, k) for d, k in track.packets(f)][:3]
        if kind == "mkv_laced":
            packets[1] = (b"LACED" + packets[1][0], False)
        if kind.startswith("webm_vp9"):        # profile bits (low, high)
            bits = 0x20 if kind.endswith("1") else 0x30
            packets[0] = (bytes([packets[0][0][0] | bits])
                          + packets[0][0][1:], True)
        data = sv.mux_mkv(codec, packets, (64, 48),
                          doc_type="webm" if kind.startswith("webm")
                          else "matroska")
        if kind == "mkv_laced":                # Xiph lacing in the flags
            at = data.index(b"LACED") - 1
            data = data[:at] + b"\x02" + data[at + 1:]
        if kind == "ebml_other":
            data = data.replace(b"matroska", b"mka-fake")
    elif kind == "mpeg2_422":
        from test_torch_mpegts import mpeg2_422
        return str(mpeg2_422(tmp_path))
    elif kind.startswith(("mp4_rext", "mkv_rext")):   # by hvcC: item 4i
        stream = sv.encode_hevc_pcm(sv.yuv_frames(2, 48, 64))
        chroma = {"422": 2, "444": 3}[kind[-3:]]
        if kind.startswith("mp4"):
            sv.write_hevc_mp4(path, stream, hvcc_chroma=chroma)
        else:
            with open(path, "wb") as f:
                f.write(sv.mux_mkv("V_MPEGH/ISO/HEVC", list(zip(
                    sv.hevc_samples(stream), stream.keys)), stream.size,
                    codec_private=sv.hvcc_record(stream, chroma)))
        return path
    elif kind in ("ts_main12", "ts_gray"):    # by the decoder: item 4i
        if kind == "ts_gray":
            stream = sv.encode_hevc_pcm(sv.yuv_frames(2, 48, 64), chroma=0)
        else:
            stream = sv.encode_hevc_pcm(sv.yuv_frames10(1, 48, 64, depth=12),
                                        depth=12)
        sv.write_hevc_ts(path, stream)
        return path
    elif kind == "wave":
        data = b"RIFF\x24\0\0\0WAVEfmt " + b"\0" * 32
    elif kind == "avi_wmv":
        avi = str(tmp_path / "v.avi")
        _write(avi, _frames(2))
        data = open(avi, "rb").read().replace(b"MJPG", b"WMV3")
    else:
        pics = sv.yuv_frames(2, 48, 64)
        sps, pps, units, keys = sv.encode_ipcm(pics)
        data = sv.mux_mp4(sps, pps, units, keys, (64, 48))
        if kind == "av01":
            data = data.replace(b"avc1", b"av01").replace(b"avcC", b"av1C")
        elif kind == "vp09_12bit":
            data = sv.mux_mp4(sps, pps, [b"\x92\x49\x83\x42\x00"] * 2,
                              keys, (64, 48), entry=sv.vp09_entry(
                                  (64, 48), profile=2, depth=12))
        elif kind == "elst_rate2":
            data = sv.mux_mp4(sps, pps, units, keys, (64, 48),
                              edits=[(80, 0, 2.0)])
        elif kind == "no_moov":
            data = b"\0\0\0\x18ftypmp42" + b"\0" * 64
    with open(path, "wb") as f:
        f.write(data)
    return path


@pytest.mark.parametrize("kind,error", [
    ("mkv_av1", "AV1 video .'V_AV1' CodecID"),
    ("mkv_laced", "laced video block"),
    ("webm_vp9_profile1", r"VP9 profile 1 video \(4:2:2.*item 4i\)"),
    ("webm_vp9_profile3", r"VP9 profile 3 video \(4:2:2.*item 4i\)"),
    ("vp09_12bit", r"VP9 profile 2 video of 12 bits .*item 4i\)"),
    ("ebml_other", "DocType b'mka-fake'"),
    ("mp4_rext_422", r"HEVC of 8 bits, 4:2:2 \(RExt: .*item 4i\) "
                     r"\(hvc1 sample entry\)"),
    ("mkv_rext_444", r"HEVC of 8 bits, 4:4:4 \(RExt: .*item 4i\) "
                     r"\(V_MPEGH/ISO/HEVC CodecPrivate\)"),
    ("ts_main12", r"hevc frames in 12-bit 4:2:0 \(yuv420p12le\): only "
                  r"4:2:0 of 8 or 10 bits .*queue 1 (?=item 4i)"),
    ("ts_gray", r"hevc frames in 4:0:0 \(gray\): only 4:2:0 of 8 or 10 "
                r"bits .*queue 1 (?=item 4i)"),
    ("av01", "AV1 video"),
    ("elst_rate2", "edit of media rate 2"),
    ("mpeg2_422", r"4:2:2 \(yuv422p\)"),
    ("no_moov", "no moov box"), ("wave", "not AVI"),
    ("avi_wmv", "AVI video codec b'WMV3'"), ("missing", None)])
def test_open_video_refuses_other_containers(tmp_path, kind, error):
    """What the port still does not read (ROADMAP.md queue 1 item 4):
    other containers, other codecs (AV1 in Matroska or MP4), HEVC RExt
    (item 4i: 4:2:2 and 4:4:4 by the hvcC of an MP4 or Matroska file,
    12-bit and 4:0:0 by the decoder's first picture in MPEG-TS), VP9 of
    profiles 1 and 3 and of 12 bits, MPEG-2 4:2:2, laced Matroska
    blocks, edits of another media rate;
    each error names it and item 4.  XVID AVI and MP4 are read
    (tests/test_torch_mp4.py), Matroska / WebM and VP9 too
    (tests/test_torch_mkv.py), MPEG-TS too (tests/test_torch_mpegts.py),
    HEVC and program streams too (tests/test_torch_hevc.py,
    tests/test_torch_mpegps.py), and what this list once held
    (test_open_video_reads_what_it_refused)."""
    path = _still_refused(tmp_path, kind)
    if error is None:
        with pytest.raises(FileNotFoundError):
            open_video(path)
        return
    with pytest.raises(ValueError, match=f"{error}.*item 4"):
        open_video(path, device="cpu")


def _once_refused(tmp_path, kind):
    """A file of a kind the reader refused until item 4b / 4c / 4e / 4g /
    4h: cv2's MPEG-2 TS, a fragmented MP4 (a moof a sample), one with
    samples in the moov and an mvex, an edit list of two entries; PCM HEVC
    in Matroska, MPEG-TS and an hvc1 MP4; cv2's MPEG-4 ``.mpg`` (an MPEG
    program stream); PCM HEVC Main 10 in MP4, Matroska and MPEG-TS, VP9
    profile 2 in WebM and MP4."""
    from test_torch_mpegts import _cv2_ts

    from rtpose_tpu_torch.demo import scripted_video as sv
    if kind == "mpegts":
        return str(_cv2_ts(tmp_path / "v.ts", "MPG2", 9))
    if kind == "mpeg_ps":
        return str(_cv2_ts(tmp_path / "v.mpg", "mp4v", 9))
    if kind in ("mkv_hevc", "ts_hevc", "hvc1"):
        path = str(tmp_path / f"{kind}.bin")
        write = {"mkv_hevc": sv.write_hevc_mkv, "ts_hevc": sv.write_hevc_ts,
                 "hvc1": sv.write_hevc_mp4}[kind]
        write(path, sv.encode_hevc_pcm(sv.yuv_frames(5, 48, 64),
                                       key_every=3))
        return path
    if kind.endswith("_main10"):
        path = str(tmp_path / f"{kind}.bin")
        write = {"mkv": sv.write_hevc_mkv, "ts": sv.write_hevc_ts,
                 "mp4": sv.write_hevc_mp4}[kind.split("_")[0]]
        write(path, sv.encode_hevc_pcm(sv.yuv_frames10(2, 48, 64), depth=10))
        return path
    if kind in ("webm_vp9_profile2", "vp09_10bit"):
        path = str(tmp_path / f"{kind}.bin")
        sv.write_vp9(path, sv.yuv_frames10(2, 48, 64),
                     container="webm" if kind.startswith("webm") else "mp4")
        return path
    pics = sv.yuv_frames(6, 48, 64)
    sps, pps, units, keys = sv.encode_ipcm(pics, key_every=3)
    if kind == "elst2":
        data = sv.mux_mp4(sps, pps, units, keys, (64, 48),
                          edits=[(40, 0, 1.0), (80, 2 * 512, 1.0)])
    else:
        data = sv.mux_fmp4(sps, pps, units, keys, (64, 48),
                           moov_samples=3 if kind == "mvex" else 0)
    path = tmp_path / f"{kind}.mp4"
    path.write_bytes(data)
    return str(path)


@pytest.mark.parametrize("kind", ["mpegts", "fragmented", "mvex", "elst2",
                                  "mkv_hevc", "ts_hevc", "mpeg_ps", "hvc1",
                                  "mp4_main10", "mkv_main10", "ts_main10",
                                  "webm_vp9_profile2", "vp09_10bit"])
def test_open_video_reads_what_it_refused(tmp_path, kind):
    """MPEG-TS (item 4b), fragmented MP4 and edit lists of several
    entries (item 4c), HEVC in Matroska, MPEG-TS and MP4 (item 4e), MPEG
    program streams (item 4g), HEVC Main 10 and VP9 profile 2 (item 4h),
    once refused by name, read frame for frame as cv2 reads them, with
    cv2's fps and frame count."""
    path = _once_refused(tmp_path, kind)
    want, (count, fps) = _read_cv2(path)
    got, cap = _read_port(path)
    assert len(got) == len(want) > 0
    assert (cap.frame_count, cap.fps) == (count, fps)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


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


@pytest.mark.parametrize("container", ["avi", "mpeg2_ts", "hevc_mp4",
                                       "hevc_ps"])
def test_video_demo_people_equal_the_jax_video_demo(tmp_path, monkeypatch,
                                                    capsys, container):
    """Seven 128x170 frames at --batch 3 (a tail batch of one) through both
    demos' ``main()`` over the same oracle maps (two people a frame): a
    Motion-JPEG AVI of the port's writer, cv2's MPEG-2 TS, and PCM HEVC in
    an hvc1 MP4 and in an MPEG program stream (the port reads them with
    its demuxers, libavcodec's parsers and decoders, the JAX demo with
    cv2)."""
    rng = np.random.RandomState(0)
    maps = oracle_maps({(128, 170): spread_people(rng, 2, 128, 170)}, SIZE)
    if container == "avi":
        video = str(tmp_path / "in.avi")
        _write(video, _frames(7, 128, 170), fps=15.0)
    elif container == "mpeg2_ts":
        from test_torch_mpegts import _cv2_ts
        video = str(_cv2_ts(tmp_path / "in.ts", "MPG2", 7, 25.0, 128, 170))
        assert open_video(video, device="cpu").codec == "mpeg2video"
    else:
        from rtpose_tpu_torch.demo import scripted_video as sv
        video = str(tmp_path / "in.bin")
        stream = sv.encode_hevc_pcm([sv.bgr_to_yuv420(f) for f in _frames(
            7, 128, 170)], key_every=4)
        (sv.write_hevc_mp4 if container == "hevc_mp4" else sv.write_hevc_ps)(
            video, stream)
        assert open_video(video, device="cpu").codec == "hevc"
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
    # both demos write XVID AVI (MPEG-4 Part 2) that cv2 reads
    for path in (out, str(tmp_path / "jax.avi")):
        with open(path, "rb") as f:
            head = f.read(4096)
            stream = AviStream(path, f)
        assert head.count(b"XVID") == 2 and stream.codec == "mpeg4"
        frames, (count, fps) = _read_cv2(path)
        assert count == len(frames) == 7 and fps == 20.0
