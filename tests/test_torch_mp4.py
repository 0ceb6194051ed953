"""The port's video files (MP4/MOV and AVI, H.264 and MPEG-4 Part 2)
against cv2 5.0 and the JAX video demo, on the CPU:

- the demuxer (``demo/mp4.py``, and the AVI stream of
  ``demo/video_io.py``) against cv2's raw packets (``CAP_PROP_FORMAT``
  -1): payloads byte for byte, key flags (``CAP_PROP_LRF_HAS_KEY_FRAME``),
  ``fps``, ``frame_count``, rotation (``CAP_PROP_ORIENTATION_META``) and
  size under ``CAP_PROP_ORIENTATION_AUTO``, on cv2's own ``mp4v`` MP4 and
  XVID / DIVX / FMP4 / DX50 AVI and on I_PCM H.264 MP4s of
  ``demo/scripted_video.py`` (and H.264 AVI, and Annex-B) at
  all four rotations, with several chunks and 64-bit offsets, and with
  composition offsets under an edit list;
- the I_PCM writer: cv2 decodes its streams to the written Y, U and V
  (its frames equal the plain conversion of them), and so does the
  reader's libavcodec (``native/avcodec.py``), plane for plane;
- ``yuv420_to_bgr_plain`` against cv2 on every (Y, U, V) (2^24 triples),
  at odd sizes and at every rotation, to the bit;
- ``open_video`` frame for frame equal to ``cv2.VideoCapture`` with
  ``CAP_PROP_ORIENTATION_AUTO``;
- the video demo's ``main()`` on an H.264 MP4 (``--device cpu``: the real
  demux, libavcodec and the plain conversion) finds, frame for frame, the
  people of the JAX video demo's ``main()`` reading the same MP4 through
  cv2, over the same oracle maps (part ids equal, pixel coordinates
  within 1e-4, scores within 1e-5);
- fragmented MP4 (``scripted_video.mux_fmp4``: a ``moof`` a sample or a
  GOP, default-base-is-moof, an explicit or an implicit base, with and
  without ``tfdt``, ``styp`` / ``sidx`` and ``mfra``, durations and
  flags from ``trex``, ``tfhd`` or each ``trun`` row, samples in the
  ``moov`` ahead of the fragments, ``trun`` version 1 negative
  composition offsets): the written pictures and cv2's frames, fps and
  count;
- edit lists of several entries (a leading empty edit, two media edits
  from a non-key sample, an edit shown twice, an empty edit between
  two, B pictures under two edits): cv2's frames (the known pictures
  FFmpeg's ``mov_fix_index`` shows) and count; a media rate of 2 is
  refused;
- without a card or without the library, opening such a file raises.
"""

import struct
import sys

import cv2
import numpy as np
import pytest
import torch

from rtpose_tpu.demo import video_demo as jvideo_demo
from rtpose_tpu.infer import pipeline as jpipeline
from rtpose_tpu.utils import draw as jdraw
from rtpose_tpu_torch.data import imread_fixtures as fx
from rtpose_tpu_torch.demo import mp4, video_demo
from rtpose_tpu_torch.demo import scripted_video as sv
from rtpose_tpu_torch.demo.video_io import (AviStream, DecodedVideo,
                                             VideoWriter, open_video)
from rtpose_tpu_torch.infer.pipeline import PosePipeline
from rtpose_tpu_torch.native import avcodec
from rtpose_tpu_torch.ops.kernels import yuv420_to_bgr, yuv420_to_bgr_plain
from rtpose_tpu_torch.utils import draw as tdraw
from rtpose_tpu_torch.utils.synth_coco import (OracleMaps, oracle_maps,
                                               spread_people)

from test_torch_evalx import JaxOracle
from test_torch_video import KP_TOL, SCORE_TOL, _recording

SIZE = 128
# an I_PCM sequence: 4 pictures, P-skip repeats, an IDR every 3 frames,
# non-IDR I pictures between
SEQ = (0, 1, None, 2, None, 3)


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def _sequence(h, w, seed=0):
    pics = sv.yuv_frames(4, h, w, seed=seed)
    frames = [None if i is None else pics[i] for i in SEQ]
    shown = []
    for f in frames:
        shown.append(shown[-1] if f is None else f)
    return frames, shown


def _ipcm(path, h=48, w=64, **kw):
    frames, shown = _sequence(h, w)
    sv.write_ipcm_mp4(str(path), frames, key_every=3, **kw)
    return shown


def _cv2_writes(path, fourcc, n=8, h=48, w=64):
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), 10,
                             (w, h))
    assert writer.isOpened()
    for i in range(n):
        writer.write(np.ascontiguousarray(fx.render_scene(i, h, w)))
    writer.release()


def _cv2_raw(path):
    cap = cv2.VideoCapture(str(path), cv2.CAP_FFMPEG,
                           [cv2.CAP_PROP_FORMAT, -1])
    packets = []
    while True:
        ok, data = cap.read()
        if not ok:
            break
        packets.append((data.tobytes(),
                        bool(cap.get(cv2.CAP_PROP_LRF_HAS_KEY_FRAME))))
    cap.release()
    return packets


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


CV2_CASES = ("mp4v", "xvid", "divx", "fmp4", "dx50")
MP4_CASES = {
    "h264": {}, "h264_rot90": dict(rotation=90),
    "h264_rot180": dict(rotation=180), "h264_rot270": dict(rotation=270),
    "h264_chunks_co64": dict(samples_per_chunk=2, co64=True),
    "h264_ctts_elst": dict(composition_shift=512),
    "h264_ntsc": dict(fps_timescale=(30000, 1001)),
}


def _fixture(tmp_path, case):
    """(path, codec) of a fixture: cv2's mp4v MP4 or MPEG-4 AVI of
    CV2_CASES, or an I_PCM H.264 MP4 of MP4_CASES."""
    if case in CV2_CASES:
        path = tmp_path / ("v.mp4" if case == "mp4v" else f"{case}.avi")
        _cv2_writes(path, case.upper() if case != "mp4v" else "mp4v")
        return path, "mpeg4"
    path = tmp_path / f"{case}.mp4"
    kw = dict(MP4_CASES[case])
    frames, _ = _sequence(48, 64)
    fps = kw.pop("fps_timescale", (12800, 512))
    sv.write_ipcm_mp4(str(path), frames, key_every=3, fps_timescale=fps,
                      **kw)
    return path, "h264"


@pytest.mark.parametrize("case", [*CV2_CASES, *MP4_CASES])
def test_demuxer_packets_equal_cv2s(tmp_path, case):
    path, codec = _fixture(tmp_path, case)
    want = _cv2_raw(path)
    _, props = _cv2_read(path)
    with open(path, "rb") as f:
        if path.suffix == ".avi":
            stream = AviStream(str(path), f)
            got = []
            for off, n in stream.frames:
                f.seek(off)
                data = f.read(n)
                got.append((data, mp4.intra_picture(codec, data)))
            assert stream.extradata == b""
            fps, size, count, rotation = (stream.fps, stream.size,
                                          len(stream.frames), 0)
        else:
            track = mp4.read_track(str(path), f)
            got = list(track.packets(f))
            if codec == "mpeg4":
                # cv2's packets are the samples; the decoder is given the
                # DecoderSpecificInfo ahead of the first
                assert got[0][0].startswith(track.decoder_info)
                got[0] = (got[0][0][len(track.decoder_info):], got[0][1])
            fps, size, count, rotation = (track.fps, track.size,
                                          track.frame_count,
                                          track.rotation_meta)
    assert len(got) == len(want) == count == props["count"]
    for i, ((data, key), (cv_data, cv_key)) in enumerate(zip(got, want)):
        assert len(data) == len(cv_data) and data == cv_data, i
        assert key == cv_key, i
    assert fps == props["fps"]
    assert size == props["size"]
    assert rotation == props["rotation"]


@pytest.mark.parametrize("rotation", [0, 90, 180, 270])
def test_sync_samples_and_rotation_are_the_written_ones(tmp_path, rotation):
    path = tmp_path / "v.mp4"
    _ipcm(path, rotation=rotation)
    with open(path, "rb") as f:
        track = mp4.read_track(str(path), f)
    assert [s.key for s in track.samples] == [i % 3 == 0
                                              for i in range(len(SEQ))]
    assert track.codec == "h264" and track.rotation == rotation
    assert track.coded_size == (64, 48)
    assert [s.dts for s in track.samples] == [512 * i
                                              for i in range(len(SEQ))]


@pytest.mark.parametrize("hw", [(48, 64), (50, 70), (34, 18)])
@pytest.mark.parametrize("rotation", [0, 90, 180, 270])
def test_cv2_decodes_the_ipcm_stream_to_the_written_yuv(tmp_path, hw,
                                                        rotation):
    """cv2's frames of the writer's stream are the plain conversion of
    the written planes, turned as the rotation tag says."""
    h, w = hw
    path = tmp_path / "v.mp4"
    shown = _ipcm(path, h, w, rotation=rotation)
    frames, props = _cv2_read(path)
    assert len(frames) == len(shown) and props["rotation"] == rotation
    for frame, planes in zip(frames, shown):
        want = yuv420_to_bgr_plain(*map(torch.from_numpy, planes), width=w,
                                   rotation=rotation).numpy()
        np.testing.assert_array_equal(frame, want)
    # the turn is cv2's: clockwise for 90
    turns = {0: 0, 90: -1, 180: 2, 270: 1}[rotation]
    upright = yuv420_to_bgr_plain(*map(torch.from_numpy, shown[0]), width=w)
    np.testing.assert_array_equal(frames[0],
                                  np.rot90(upright.numpy(), turns))


def test_annexb_stream_reads_as_the_written_pictures(tmp_path):
    """The writer's Annex-B stream, read by cv2's raw H.264 demuxer, holds
    the pictures of its MP4."""
    frames, shown = _sequence(48, 64)
    sps, pps, units, _ = sv.encode_ipcm(frames, key_every=3)
    path = tmp_path / "v.h264"
    path.write_bytes(sv.annexb(sps, pps, units))
    got, _ = _cv2_read(path)
    assert len(got) == len(shown)
    for frame, planes in zip(got, shown):
        want = yuv420_to_bgr_plain(*map(torch.from_numpy, planes), width=64)
        np.testing.assert_array_equal(frame, want.numpy())


class _ChunkWriter(VideoWriter):
    """The AVI writer with its frames given as coded chunks."""

    def write_chunk(self, data: bytes) -> None:
        self._index.append((self._f.tell() - self._movi, len(data)))
        self._max_chunk = max(self._max_chunk, len(data))
        self._f.write(b"00dc" + struct.pack("<I", len(data)) + data
                      + b"\0" * (len(data) & 1))


@pytest.mark.parametrize("fourcc", [b"H264", b"avc1", b"X264"])
def test_h264_avi_reads_as_cv2_reads_it(tmp_path, fourcc):
    """An AVI of Annex-B access units (the parameter sets in the first):
    cv2's frames, which are the written pictures, and its count."""
    frames, shown = _sequence(48, 64)
    sps, pps, units, _ = sv.encode_ipcm(frames, key_every=3)
    path = tmp_path / "v.avi"
    writer = _ChunkWriter(str(path), 10.0, (64, 48))
    for i, unit in enumerate(units):
        writer.write_chunk(sv.annexb(sps, pps, [unit]) if i == 0
                           else b"\x00\x00\x00\x01" + unit)
    writer.release()
    data = path.read_bytes()
    path.write_bytes(data[:512].replace(b"MJPG", fourcc) + data[512:])
    want, props = _cv2_read(path)
    got, cap = _port_read(path)
    assert len(got) == len(want) == len(shown) == cap.frame_count \
        == props["count"]
    assert (cap.fps, cap.size, cap.codec) == (props["fps"], props["size"],
                                              "h264")
    for g, w, planes in zip(got, want, shown):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, yuv420_to_bgr_plain(
            *map(torch.from_numpy, planes), width=64).numpy())


def test_libavcodec_planes_equal_the_written_yuv(tmp_path):
    path = tmp_path / "v.mp4"
    shown = _ipcm(path, 50, 70)
    decoder = avcodec.Decoder("h264")
    got = []
    try:
        with open(path, "rb") as f:
            track = mp4.read_track(str(path), f)
            for data, key in track.packets(f):
                got += [[p.copy() for p in planes] + [width]
                        for *planes, width in decoder.decode(data, key)]
        got += [[p.copy() for p in planes] + [width]
                for *planes, width in decoder.flush()]
    finally:
        decoder.close()
    assert len(got) == len(shown)
    for (y, u, v, width), (wy, wu, wv) in zip(got, shown):
        assert width == 70 and y.shape[0] == 50 and u.shape[0] == 25
        np.testing.assert_array_equal(y[:, :70], wy)
        np.testing.assert_array_equal(u[:, :35], wu)
        np.testing.assert_array_equal(v[:, :35], wv)


def test_plain_conversion_equals_cv2_on_every_yuv(tmp_path):
    """64 I_PCM 512x512 frames hold every (Y, U, V): each chroma sample a
    (U, V) pair, the four luma samples of its block four Y values."""
    uu, vv = np.meshgrid(np.arange(256, dtype=np.uint8),
                         np.arange(256, dtype=np.uint8), indexing="ij")
    frames = []
    for k in range(64):
        y = np.empty((512, 512), np.uint8)
        for j, (dy, dx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
            y[dy::2, dx::2] = 4 * k + j
        frames.append((y, uu, vv))
    path = tmp_path / "all.mp4"
    sv.write_ipcm_mp4(str(path), frames)
    got, _ = _cv2_read(path)
    assert len(got) == 64
    for frame, planes in zip(got, frames):
        want = yuv420_to_bgr_plain(*map(torch.from_numpy, planes), width=512)
        np.testing.assert_array_equal(frame, want.numpy())


@pytest.mark.parametrize("case", [*CV2_CASES, *MP4_CASES])
def test_open_video_frames_equal_cv2s(tmp_path, case):
    path, _ = _fixture(tmp_path, case)
    want, props = _cv2_read(path)
    got, cap = _port_read(path)
    assert len(got) == len(want) == cap.frame_count == props["count"]
    assert (cap.fps, cap.size) == (props["fps"], props["size"])
    assert cap.rotation_meta == props["rotation"]
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"frame {i}")
    assert set(cap.seconds) == {"demux", "decode", "convert"}


@pytest.mark.parametrize("shift,start", [(512, 1024), (0, 1024),
                                         (1024, 512)])
def test_edit_list_drops_what_cv2_drops(tmp_path, shift, start):
    """Pictures shown before the edit's media time, or past its end, are
    decoded and dropped, as cv2 drops them."""
    path = tmp_path / "v.mp4"
    frames, _ = _sequence(48, 64)
    sv.write_ipcm_mp4(str(path), frames, composition_shift=shift,
                      edit_start=start)
    want, props = _cv2_read(path)
    got, cap = _port_read(path)
    assert len(got) == len(want) < len(frames)
    assert cap.frame_count == props["count"] == len(frames)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_yuv420_to_bgr_checks_its_planes():
    y = torch.zeros((6, 8), dtype=torch.uint8)
    c = torch.zeros((3, 4), dtype=torch.uint8)
    assert yuv420_to_bgr(y, c, c, width=8, rotation=90).shape == (8, 6, 3)
    with pytest.raises(ValueError, match="rotation 45"):
        yuv420_to_bgr(y, c, c, width=8, rotation=45)
    with pytest.raises(ValueError, match="4:2:0 picture"):
        yuv420_to_bgr(y, c[:2], c[:2], width=8)
    with pytest.raises(ValueError, match="4:2:0 picture"):
        yuv420_to_bgr(y, c, c, width=10)


def test_open_h264_without_a_card_raises(tmp_path, monkeypatch):
    path = tmp_path / "v.mp4"
    _ipcm(path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        open_video(str(path))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        DecodedVideo(str(path), "cuda")


def test_open_h264_without_libavcodec_raises(tmp_path, monkeypatch):
    path = tmp_path / "v.mp4"
    _ipcm(path)
    monkeypatch.setattr(avcodec, "_libs", None)
    monkeypatch.setattr(avcodec, "_library_dirs", lambda: [])
    with pytest.raises(RuntimeError, match="no libavcodec found"):
        open_video(str(path), device="cpu")


def test_ipcm_writer_checks_its_frames():
    pics = sv.yuv_frames(2, 48, 64)
    with pytest.raises(ValueError, match="first frame"):
        sv.encode_ipcm([None, pics[0]])
    with pytest.raises(ValueError, match="even size"):
        sv.encode_ipcm([tuple(p[:47] for p in pics[0])])
    with pytest.raises(ValueError, match="planes"):
        sv.encode_ipcm([pics[0], sv.yuv_frames(1, 32, 64)[0]])
    with pytest.raises(ValueError, match="rotation"):
        sv.mux_mp4(*sv.encode_ipcm(pics)[:2], [b"\x65"], [True], (64, 48),
                   rotation=45)


def test_emulation_prevention_covers_every_start_code_prefix():
    rbsp = bytes([0, 0, 0, 0, 0, 1, 0, 0, 2, 0, 0, 3, 0, 0, 4, 0, 0])
    unit = sv.nal(1, 0, rbsp)
    assert unit[1:] == bytes([0, 0, 3, 0, 0, 3, 0, 1, 0, 0, 3, 2, 0, 0, 3, 3,
                              0, 0, 4, 0, 0])
    payload = unit[1:]
    for i in range(len(payload) - 2):
        assert not (payload[i] == payload[i + 1] == 0
                    and payload[i + 2] <= 2), i


@pytest.mark.parametrize("rotation", [0, 90])
def test_video_demo_on_h264_finds_the_jax_demos_people(tmp_path, monkeypatch,
                                                       capsys, rotation):
    """Seven 128x170 frames of an I_PCM H.264 MP4 (turned by its tag) at
    --batch 3 through both demos' ``main()`` over the same oracle maps
    (two people a frame): the port reads it with its demuxer, libavcodec
    and the plain conversion, the JAX demo with cv2."""
    h, w = 128, 170
    shape = (w, h) if rotation in (90, 270) else (h, w)
    rng = np.random.RandomState(0)
    maps = oracle_maps({shape: spread_people(rng, 2, *shape)}, SIZE)
    video = str(tmp_path / "in.mp4")
    sv.write_ipcm_mp4(video, [sv.bgr_to_yuv420(np.ascontiguousarray(
        fx.render_scene(i, h, w))) for i in range(7)], rotation=rotation)
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
    assert len(written) == 7 and cap.size == shape[::-1]


# ---------------------------------------------------------------------------
# fragmented MP4 and edit lists of several entries (ROADMAP.md item 4c)
# ---------------------------------------------------------------------------

FMP4_CASES = {
    "per_sample": {}, "per_gop": dict(fragment="gop"),
    "explicit_base": dict(base="explicit"),
    "implicit_base": dict(base="implicit", fragment="gop"),
    "no_tfdt": dict(tfdt=False), "styp_sidx": dict(styp=True, sidx=True),
    "mfra": dict(mfra=True, fragment="gop"),
    "moov_samples": dict(moov_samples=3),
    "moov_gop": dict(moov_samples=4, fragment="gop"),
    "ntsc": dict(timescale=30000, delta=1001),
    "tfhd_defaults": dict(durations="tfhd", fragment="gop"),
    "trun_durations": dict(durations="trun"),
}


@pytest.mark.parametrize("case", list(FMP4_CASES))
def test_fragmented_mp4_reads_as_cv2_reads_it(tmp_path, case):
    frames, shown = _sequence(48, 64)
    sps, pps, units, keys = sv.encode_ipcm(frames, key_every=3)
    path = tmp_path / "f.mp4"
    path.write_bytes(sv.mux_fmp4(sps, pps, units, keys, (64, 48),
                                 **FMP4_CASES[case]))
    want, props = _cv2_read(path)
    got, cap = _port_read(path)
    assert len(got) == len(want) == len(shown)
    assert (cap.frame_count, cap.fps, cap.size) == (
        props["count"], props["fps"], props["size"])
    for i, (g, w, planes) in enumerate(zip(got, want, shown)):
        np.testing.assert_array_equal(g, w, err_msg=f"frame {i}")
        np.testing.assert_array_equal(g, yuv420_to_bgr_plain(
            *map(torch.from_numpy, planes), width=64).numpy())
    with open(path, "rb") as f:
        track = mp4.read_track(str(path), f)
    assert [s.key for s in track.samples] == keys
    assert track.table_samples == FMP4_CASES[case].get("moov_samples", 0)


@pytest.mark.parametrize("version", [0, 1])
def test_fragmented_bframes_read_as_cv2_reads_them(tmp_path, version):
    """B pictures in fragments: ``trun`` version 1 with negative
    composition offsets, or version 0 offsets shifted up one frame under a
    one-frame edit, as muxers write them."""
    anchors = sv.yuv_frames(5, 48, 64, seed=3)
    sps, pps, units, keys, order, shown = sv.encode_ipcm_bframes(anchors)
    shift = 1 - version
    cts = [(d + shift - i) * 512 for i, d in enumerate(order)]
    path = tmp_path / "b.mp4"
    path.write_bytes(sv.mux_fmp4(
        sps, pps, units, keys, (64, 48), trun_version=version,
        composition_offsets=cts,
        edits=[(360, 512, 1.0)] if shift else None))
    want, props = _cv2_read(path)
    got, cap = _port_read(path)
    assert len(got) == len(want) == len(shown) == cap.frame_count \
        == props["count"]
    assert cap.fps == props["fps"]
    for g, w, planes in zip(got, want, shown):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, yuv420_to_bgr_plain(
            *map(torch.from_numpy, planes), width=64).numpy())
    if version:
        with open(path, "rb") as f:
            assert min(s.cts - s.dts for s in mp4.read_track(
                str(path), f).samples) == -512


D = 40                      # ms a frame at 12800 / 512
EDIT_CASES = {              # (edits, the pictures FFmpeg shows)
    "leading_empty": ([(200, -1, 1.0), (400, 0, 1.0)], list(range(10))),
    "two_media_non_key": ([(3 * D, 0, 1.0), (3 * D, 5 * 512, 1.0)],
                          [0, 1, 2, 5, 6, 7]),
    "two_media_key": ([(3 * D, 0, 1.0), (3 * D, 4 * 512, 1.0)],
                      [0, 1, 2, 4, 5, 6]),
    "shown_twice": ([(4 * D, 0, 1.0), (4 * D, 0, 1.0)],
                    [0, 1, 2, 3, 0, 1, 2, 3]),
    "ends_early": ([(3 * D, 0, 1.0)], [0, 1, 2]),
    "empty_then_mid": ([(100, -1, 1.0), (5 * D, 2 * 512, 1.0)],
                       [2, 3, 4, 5, 6]),
    "three": ([(2 * D, 512, 1.0), (2 * D, 6 * 512, 1.0),
               (2 * D, 3 * 512, 1.0)], [1, 2, 6, 7, 3, 4]),
    # FFmpeg takes an empty edit after a media edit for one from time -1
    "empty_between": ([(3 * D, 0, 1.0), (80, -1, 1.0),
                       (3 * D, 5 * 512, 1.0)], [0, 1, 2, 0, 1, 5, 6, 7]),
    "part_frames": ([(int(2.5 * D), 0, 1.0), (3 * D, 5 * 512 + 100, 1.0)],
                    [0, 1, 2, 6, 7, 8]),
}


@pytest.mark.parametrize("case", list(EDIT_CASES))
def test_edit_lists_show_what_cv2_shows(tmp_path, case):
    """Ten distinct I_PCM pictures, an IDR every 4: each edit decodes from
    the key at or before its start and shows its own span."""
    edits, pictures = EDIT_CASES[case]
    pics = sv.yuv_frames(10, 48, 64)
    sps, pps, units, keys = sv.encode_ipcm(pics, key_every=4)
    path = tmp_path / "e.mp4"
    path.write_bytes(sv.mux_mp4(sps, pps, units, keys, (64, 48),
                                edits=edits))
    want, props = _cv2_read(path)
    got, cap = _port_read(path)
    assert len(got) == len(want) == len(pictures)
    assert cap.frame_count == props["count"] == 10
    for g, w, k in zip(got, want, pictures):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, yuv420_to_bgr_plain(
            *map(torch.from_numpy, pics[k]), width=64).numpy())


@pytest.mark.parametrize("case", ["two_edits", "leading_empty"])
def test_bframe_edit_lists_show_what_cv2_shows(tmp_path, case):
    """B pictures (``ctts``) under two media edits: an edit decodes on to
    the second key past its end, for the B pictures that belong to it."""
    anchors = sv.yuv_frames(6, 48, 64, seed=3)
    sps, pps, units, keys, order, shown = sv.encode_ipcm_bframes(anchors)
    cts = [(d + 1 - i) * 512 for i, d in enumerate(order)]
    edits = {"two_edits": [(3 * D, 512, 1.0), (3 * D, 6 * 512, 1.0)],
             "leading_empty": [(120, -1, 1.0), (11 * D, 512, 1.0)]}[case]
    path = tmp_path / "b.mp4"
    path.write_bytes(sv.mux_mp4(sps, pps, units, keys, (64, 48),
                                composition_offsets=cts, edits=edits))
    want, props = _cv2_read(path)
    got, cap = _port_read(path)
    assert len(got) == len(want) > 0 and cap.frame_count == props["count"]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_edit_of_another_media_rate_is_refused(tmp_path):
    """cv2 plays an edit of media rate 2 at rate 1; the reader refuses it
    (ROADMAP.md "Accepted divergences")."""
    pics = sv.yuv_frames(4, 48, 64)
    sps, pps, units, keys = sv.encode_ipcm(pics)
    path = tmp_path / "r.mp4"
    path.write_bytes(sv.mux_mp4(sps, pps, units, keys, (64, 48),
                                edits=[(4 * D, 0, 2.0)]))
    assert len(_cv2_read(path)[0]) == 4
    with pytest.raises(ValueError, match="media rate 2 .*item 4"):
        open_video(str(path), device="cpu")
