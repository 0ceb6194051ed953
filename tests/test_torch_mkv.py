"""The port's Matroska / WebM reader, VP9 and B-frame H.264 against cv2
(its FFmpeg backend, ``CAP_PROP_ORIENTATION_AUTO`` on) and against known
pixels, on the CPU:

- VP9 in WebM, Matroska and MP4 (``vp09``) and MPEG-4 Part 2 in Matroska,
  written by this machine's cv2: ``open_video``'s frames equal cv2's,
  pixel for pixel, with cv2's fps, size and frame count (5, 16 and 64
  frames, 20 and 29.97 fps); the committed 64x48 WebM fixture; a VP9
  superframe (a hidden frame and a shown one in one block);
- I_PCM H.264 in Matroska (``demo/scripted_video.py``), with known and
  unknown ``Segment`` / ``Cluster`` sizes, with ``BlockGroup`` blocks,
  without ``Duration`` or ``DefaultDuration``, turned by
  ``ProjectionPoseRoll``: the decoded planes equal the written Y, U and V
  exactly, the frames, fps, size and frame count equal cv2's;
- Main-profile H.264 with B pictures (B_Skip between I_PCM anchors: each
  sample the rounded mean of the anchors), in MP4 and in Matroska, with
  and without the VUI's reorder hint, at a picture order count step of 2
  and of 1: cv2's frame order and the known pixels;
- the video demo's ``main()`` on a VP9 MKV finds the people of the JAX
  video demo's ``main()`` on the same file.
"""

import sys

import cv2
import numpy as np
import pytest
import torch

from rtpose_tpu.demo import video_demo as jvideo_demo
from rtpose_tpu.infer import pipeline as jpipeline
from rtpose_tpu.utils import draw as jdraw
from rtpose_tpu_torch.demo import mkv, mp4, video_demo
from rtpose_tpu_torch.demo import scripted_video as sv
from rtpose_tpu_torch.demo.video_io import open_video
from rtpose_tpu_torch.infer.pipeline import PosePipeline
from rtpose_tpu_torch.native import avcodec
from rtpose_tpu_torch.ops.kernels import yuv420_to_bgr
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


def _cv2_read(path):
    cap = cv2.VideoCapture(str(path))
    cap.set(cv2.CAP_PROP_ORIENTATION_AUTO, 1)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    props = dict(count=int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
                 fps=cap.get(cv2.CAP_PROP_FPS),
                 rotation=int(cap.get(cv2.CAP_PROP_ORIENTATION_META)),
                 size=(int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                       int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))))
    cap.release()
    return frames, props


def _port_read(path):
    cap = open_video(str(path), device="cpu")
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return frames, cap


def _assert_reads_as_cv2(path, n=None):
    """open_video's frames, fps, size, frame count and turn are cv2's."""
    want, props = _cv2_read(path)
    got, cap = _port_read(path)
    assert len(got) == len(want) > 0
    if n is not None:
        assert len(got) == n
    assert (cap.frame_count, cap.fps, cap.size, cap.rotation_meta) == (
        props["count"], props["fps"], props["size"], props["rotation"])
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"frame {i}")
    return got, cap


def _bgr(planes, width):
    return yuv420_to_bgr(*[torch.from_numpy(np.ascontiguousarray(c))
                           for c in planes], width=width).numpy()


CV2_FILES = [("webm", "VP90", 5, 20.0), ("webm", "VP90", 16, 29.97),
             ("webm", "VP90", 64, 20.0), ("mkv", "VP90", 5, 29.97),
             ("mkv", "VP90", 16, 20.0), ("mkv", "VP90", 64, 29.97),
             ("mkv", "XVID", 5, 20.0), ("mkv", "XVID", 16, 29.97),
             ("mkv", "XVID", 64, 20.0), ("mp4", "VP90", 16, 20.0),
             ("mp4", "VP90", 64, 29.97)]


@pytest.mark.parametrize("ext,fourcc,n,fps", CV2_FILES)
def test_cv2_files_read_as_cv2_reads_them(tmp_path, ext, fourcc, n, fps):
    path = str(tmp_path / f"v.{ext}")
    sv.write_cv2_video(path, fourcc, n, 48, 64, fps)
    _, cap = _assert_reads_as_cv2(path, n)
    assert cap.codec == ("mpeg4" if fourcc == "XVID" else "vp9")


def test_committed_webm_reads_as_cv2_reads_it():
    """The 64x48 VP9 WebM that cv2 5.0 wrote (``scripted_video.VP9_WEBM``;
    ``chip_smoke.py`` reads it on the card, whose cv2 may have no VP9
    encoder)."""
    with open(sv.VP9_WEBM, "rb") as f:
        track = mkv.read_track(sv.VP9_WEBM, f)
    assert (track.codec_id, track.coded_size, track.fps) == (
        "V_VP9", (64, 48), sv.VP9_WEBM_FPS)
    assert len(track.blocks) == sv.VP9_WEBM_FRAMES
    with open(sv.VP9_WEBM, "rb") as f:
        packets = list(track.packets(f))
    # the blocks' key flags are the key frames of the VP9 headers: cv2's
    # GOP of 12
    assert [k for _, k in packets] == [
        mp4.intra_picture("vp9", d) for d, _ in packets] == [
        i % 12 == 0 for i in range(sv.VP9_WEBM_FRAMES)]
    _assert_reads_as_cv2(sv.VP9_WEBM, sv.VP9_WEBM_FRAMES)


@pytest.mark.parametrize("fps", [29.97, 23.976, 15.0, 60.0])
@pytest.mark.parametrize("n", [5, 16])
def test_vp9_live_recording_reads_as_cv2_reads_it(tmp_path, fps, n):
    """VP9 as ``MediaRecorder`` writes it: unknown Segment and Cluster
    sizes, no Duration, no DefaultDuration (cv2's fps is FFmpeg's guess
    from the block times; its frame count a large negative number)."""
    with open(sv.VP9_WEBM, "rb") as f:
        track = mkv.read_track(sv.VP9_WEBM, f)
        packets = [(d, b.key) for (d, _), b in zip(track.packets(f),
                                                    track.blocks)][:n]
    path = str(tmp_path / "live.webm")
    with open(path, "wb") as f:
        f.write(sv.mux_mkv("V_VP9", packets, (64, 48), fps=fps,
                           unknown_sizes=True, duration=False,
                           default_duration=False, doc_type="webm"))
    _, cap = _assert_reads_as_cv2(path, n)
    assert cap.frame_count < 0


def test_vp9_superframe_gives_one_frame_a_block(tmp_path):
    """The first block holds a hidden key frame and the next frame, shown,
    with a superframe index: FFmpeg's vp9 decoder splits it itself; the
    file gives one frame a block, cv2's frames and count, and the frames
    after it are those of the file it was made from."""
    path = str(tmp_path / "superframe.webm")
    blocks = sv.write_vp9_superframe(sv.VP9_WEBM, path)
    with open(path, "rb") as f:
        track = mkv.read_track(path, f)
        f.seek(track.blocks[0].offset)
        first = f.read(track.blocks[0].size)
    marker = first[-1]
    assert marker & 0xE0 == 0xC0 and (marker & 7) + 1 == 2
    assert first[0] & 0x02 == 0               # the hidden frame
    got, cap = _assert_reads_as_cv2(path, blocks)
    assert blocks == sv.VP9_WEBM_FRAMES - 1 == cap.frame_count
    original, _ = _port_read(sv.VP9_WEBM)
    for g, o in zip(got, original[1:]):
        np.testing.assert_array_equal(g, o)


def _ipcm_sequence(h=48, w=64):
    pics = sv.yuv_frames(6, h, w, seed=4)
    seq = [pics[0], pics[1], None, pics[2], pics[3], None, pics[4], pics[5],
           pics[0], None, pics[1]]
    shown = []
    for p in seq:
        shown.append(shown[-1] if p is None else p)
    return seq, shown


MKV_CASES = {
    "known": {}, "unknown": dict(unknown_sizes=True),
    "unknown_no_duration": dict(unknown_sizes=True, duration=False),
    "block_groups": dict(block_groups=True),
    "no_default_duration": dict(default_duration=False),
    "no_durations": dict(default_duration=False, duration=False),
    "ntsc": dict(fps=29.97), "ntsc_estimated": dict(fps=29.97,
                                                    default_duration=False),
    "film": dict(fps=23.976), "webm": dict(doc_type="webm"),
}


@pytest.mark.parametrize("case", list(MKV_CASES))
def test_h264_mkv_planes_and_frames(tmp_path, case):
    """libavcodec's planes of the Matroska blocks are the written ones
    exactly; open_video's frames are their conversion and cv2's, with
    cv2's fps and frame count (cv2's negative count without Duration
    too)."""
    path = str(tmp_path / "v.mkv")
    seq, shown = _ipcm_sequence()
    sv.write_ipcm_mkv(path, seq, key_every=4, **MKV_CASES[case])
    decoder = avcodec.Decoder("h264")
    planes = []
    with open(path, "rb") as f:
        track = mkv.read_track(path, f)
        assert track.codec == "h264" and len(track.blocks) == len(seq)
        assert [b.key for b in track.blocks] == [i % 4 == 0 for i in
                                                 range(len(seq))]
        for data, key in track.packets(f):
            planes += [[p[:48 if i == 0 else 24, :64 if i == 0 else 32].copy()
                        for i, p in enumerate(pic[:3])]
                       for pic in decoder.decode(data, key)]
        planes += [[p[:48 if i == 0 else 24, :64 if i == 0 else 32].copy()
                    for i, p in enumerate(pic[:3])]
                   for pic in decoder.flush()]
    decoder.close()
    assert len(planes) == len(shown)
    for got, want in zip(planes, shown):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    frames, cap = _assert_reads_as_cv2(path, len(seq))
    if not MKV_CASES[case].get("duration", True):
        assert cap.frame_count < 0          # cv2's count without Duration
    for g, w in zip(frames, shown):
        np.testing.assert_array_equal(g, _bgr(w, 64))


@pytest.mark.parametrize("roll,yaw", [(90.0, 0.0), (-90.0, 0.0),
                                      (180.0, 0.0), (45.0, 0.0),
                                      (90.0, 180.0)])
def test_projection_roll_turns_as_cv2_turns(tmp_path, roll, yaw):
    """``ProjectionPoseRoll`` (yaw 180: FFmpeg's flipped matrix) gives
    cv2's ``CAP_PROP_ORIENTATION_META`` and its turned frames."""
    path = str(tmp_path / "v.mkv")
    seq, _ = _ipcm_sequence()
    sv.write_ipcm_mkv(path, seq, roll=roll, yaw=yaw)
    _, cap = _assert_reads_as_cv2(path, len(seq))
    assert cap.rotation_meta == mkv.projection_rotation(yaw, 0.0, roll)


@pytest.mark.parametrize("container", ["mp4", "mkv"])
@pytest.mark.parametrize("reorder", [1, None])
@pytest.mark.parametrize("poc_step", [2, 1])
def test_bframes_come_in_cv2s_order(tmp_path, container, reorder, poc_step):
    """I B I B ... in display order, coded I I B I B ...: every frame is
    the known picture (the anchors, and their rounded means for the B
    pictures) in display order, as cv2 gives them.  Without the VUI's
    reorder hint and at a POC step of 1 libavcodec alone would drop the
    first B picture; the port probes the stream first as libavformat
    does for cv2."""
    path = str(tmp_path / f"b.{container}")
    anchors = sv.yuv_frames(5, 48, 64, seed=5)
    shown = sv.write_bframes(path, anchors, reorder=reorder,
                             container=container, poc_step=poc_step)
    assert len(shown) == 9
    got, _ = _assert_reads_as_cv2(path, 9)
    for i, (g, w) in enumerate(zip(got, shown)):
        np.testing.assert_array_equal(g, _bgr(w, 64), err_msg=f"frame {i}")


def test_bframe_mp4_samples_carry_their_display_times(tmp_path):
    path = str(tmp_path / "b.mp4")
    sv.write_bframes(path, sv.yuv_frames(3, 32, 32, seed=6), reorder=None)
    with open(path, "rb") as f:
        track = mp4.read_track(path, f)
    assert [s.cts // 640 - 1 for s in track.samples] == [0, 2, 1, 4, 3]
    assert track.shown == [True] * 5      # each picture, in decode order


def _recording(module, calls):
    real = module.draw_people

    def draw(frame, people, meta=None, **kw):
        calls.append((people, meta))
        return real(frame, people, meta, **kw)

    return draw


def test_video_demo_on_vp9_mkv_finds_the_jax_demos_people(tmp_path,
                                                          monkeypatch,
                                                          capsys):
    """Seven 128x170 frames of a VP9 MKV written by cv2 at --batch 3
    through both demos' ``main()`` over the same oracle maps (two people
    a frame): the port reads it with its EBML demuxer, libavcodec's vp9
    and the plain conversion, the JAX demo with cv2."""
    h, w = 128, 170
    rng = np.random.RandomState(0)
    maps = oracle_maps({(h, w): spread_people(rng, 2, h, w)}, SIZE)
    video = str(tmp_path / "in.mkv")
    sv.write_cv2_video(video, "VP90", 7, h, w)
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
    written, cap = _port_read(out)
    assert len(written) == 7 and cap.size == (w, h) and cap.codec == "mpeg4"


@pytest.mark.parametrize("num,den,limit", [
    (10 ** 9, 50000000, 30000), (10 ** 9, 33366667, 30000),
    (10 ** 9, 41708333, 30000), (30000, 1001, 2 ** 31 - 1),
    (240240, 12012, 2 ** 31 - 1), (10 ** 9, 16683333, 30000),
    (1000000, 10 ** 9, 2 ** 31 - 1)])
def test_av_reduce_is_libavutils(num, den, limit):
    """The port's av_reduce against the wheel's own."""
    import ctypes

    lib = avcodec.libraries().avutil
    a, b = ctypes.c_int(), ctypes.c_int()
    lib.av_reduce(ctypes.byref(a), ctypes.byref(b), ctypes.c_int64(num),
                  ctypes.c_int64(den), ctypes.c_int64(limit))
    assert mkv.av_reduce(num, den, limit) == (a.value, b.value)


@pytest.mark.parametrize("colour,siting,want", [
    (sv.Colour(1, True, 1, 1), None, avcodec.StreamColour(
        1, True, None, 1, 1)),
    (sv.Colour(9, False, 9, 16), (1, 2), avcodec.StreamColour(
        9, False, 1, 9, 16)),
    (None, (2, 2), avcodec.StreamColour(2, None, 2, 2, 2)),
    (None, (1, 1), avcodec.StreamColour(2, None, 3, 2, 2))])
def test_colour_element_is_read_as_libavformat_reads_it(tmp_path, colour,
                                                        siting, want):
    """``Video/Colour``: the matrix, ``Range`` (1 broadcast, 2 full),
    primaries, transfer (each by default 2, unspecified), and the chroma
    siting as a location."""
    path = tmp_path / "v.mkv"
    sv.write_ipcm_mkv(str(path), sv.yuv_frames(1, 32, 48), colour=colour,
                      chroma_siting=siting)
    with open(path, "rb") as f:
        track = mkv.read_track(str(path), f)
    assert track.colour == want


@pytest.mark.parametrize("hw", [(48, 64), (36, 50)])
def test_vp9_profile2_webm_reads_as_cv2(tmp_path, hw):
    """VP9 profile 2 (10-bit, the wheel's libvpx, lossless) in WebM."""
    h, w = hw
    path = tmp_path / "v.webm"
    sv.write_vp9(str(path), sv.yuv_frames10(4, h, w, seed=w),
                 colour=sv.Colour(1, True))
    _assert_reads_as_cv2(path, 4)


def test_vp9_profile2_of_odd_width_is_refused_by_name(tmp_path):
    """An odd width takes swscale's full-chroma output, another rule than
    the 10-bit kernel's.  Once refused by name, it is now converted by
    that output's rule (``yuv420_full_chroma_to_bgr``): the frames, count
    and fps read as cv2 reads them, at the size of the old refusal."""
    rng = np.random.RandomState(5)
    frames = [tuple(rng.randint(0, 1024, s).astype(np.uint16)
                    for s in ((32, 47), (16, 24), (16, 24)))]
    path = tmp_path / "v.webm"
    sv.write_vp9(str(path), frames)
    _assert_reads_as_cv2(path, 1)
