"""The port's MPEG program stream reader (``demo/mpegps.py`` over
``demo/mpegts.py``'s PES timing and libavcodec's parsers) against cv2 5.0
(its FFmpeg backend) and against known pixels, on the CPU:

- cv2's own program streams: ``.mpg`` ("MPEG-1 Systems" packs) of
  MPEG-4 Part 2, MPEG-1 and MPEG-2 video and ``.vob`` (MPEG-2 packs,
  padded), at several rates and lengths: frames equal to cv2's, pixel
  for pixel, with cv2's fps, size and frame count (libavformat's
  duration from the file's tail; an MPEG-1 stream at its own rate here);
- I_PCM H.264 and PCM HEVC in program streams of
  ``demo/scripted_video.py`` ``mux_ps``: MPEG-2 and MPEG-1 packs and PES,
  with and without a program stream map, DVD navigation packs, AC-3,
  MPEG audio and padding between the pictures, a frame over several PES,
  no end code, 29.97 fps, two streams joined past an end code: the
  written pictures and cv2's frames, fps and count;
- cv2's MPEG-1/2/4 PES re-muxed with a program stream map: read as cv2
  reads them;
- the parser's frames are cv2's raw packets (``CAP_PROP_FORMAT`` -1),
  byte for byte, with its key flags;
- the codec probe, both PES header syntaxes, the program stream map,
  large frames (the duration's tail window doubled), and the refusals
  (no video, a map's unread type, an unknown codec), each naming what it
  refuses and ROADMAP.md item 4.
"""

import cv2
import numpy as np
import pytest
import torch

from rtpose_tpu_torch.data import imread_fixtures as fx
from rtpose_tpu_torch.demo import mp4, mpegps, mpegts
from rtpose_tpu_torch.demo import scripted_video as sv
from rtpose_tpu_torch.demo.video_io import DecodedVideo, open_video
from rtpose_tpu_torch.ops.kernels import yuv420_to_bgr_plain

from test_torch_mkv import _assert_reads_as_cv2
from test_torch_mp4 import _cv2_raw


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def _cv2_ps(path, fourcc, n=5, fps=25.0, h=48, w=64):
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), fps,
                             (w, h))
    assert writer.isOpened()
    for i in range(n):
        writer.write(np.ascontiguousarray(fx.render_scene(i, h, w)))
    writer.release()
    return path


CV2_PS = {"mpg_mpeg4": ("mpg", "mp4v", 5, 25.0),
          "mpg_mpeg1": ("mpg", "PIM1", 5, 25.0),
          "mpg_mpeg2": ("mpg", "MPG2", 5, 25.0),
          "vob_mpeg4": ("vob", "mp4v", 5, 25.0),
          "vob_mpeg2": ("vob", "MPG2", 12, 60.0),
          "mpg_mpeg1_ntsc": ("mpg", "PIM1", 24, 30000 / 1001),
          "mpg_mpeg1_24": ("mpg", "PIM1", 30, 24.0),
          "mpg_mpeg2_ntsc": ("mpg", "MPG2", 24, 30000 / 1001),
          "vob_mpeg4_ntsc": ("vob", "mp4v", 24, 30000 / 1001),
          "vob_mpeg1_long": ("vob", "PIM1", 70, 25.0)}


@pytest.mark.parametrize("case", list(CV2_PS))
def test_cv2_program_streams_read_as_cv2_reads_them(tmp_path, case):
    ext, fourcc, n, fps = CV2_PS[case]
    path = _cv2_ps(tmp_path / f"v.{ext}", fourcc, n, fps)
    got, cap = _assert_reads_as_cv2(path, n)
    codec = {"MPG2": "mpeg2video", "PIM1": "mpeg1video", "mp4v": "mpeg4"}
    assert cap.codec == codec[fourcc] and cap.size == (64, 48)
    assert cap.fps == fps
    assert set(cap.seconds) == {"demux", "parse", "decode", "convert"}
    with open(path, "rb") as f:
        head = f.read(5)
        track = mpegps.read_track(str(path), f)
    # cv2's .mpg is MPEG-1 Systems, its .vob MPEG-2 packs; neither a map
    assert head[4] >> 4 == (2 if ext == "mpg" else 4)
    assert (track.stream_id, track.stream_type) == (0xE0, None)


def _sequence(h=48, w=64):
    pics = sv.yuv_frames(4, h, w)
    frames = [None if i is None else pics[i]
              for i in (0, 1, None, 2, 3, None, 1, 2, 0, None)]
    shown = []
    for f in frames:
        shown.append(shown[-1] if f is None else f)
    return frames, shown


def _bgr(planes):
    return yuv420_to_bgr_plain(*map(torch.from_numpy, planes),
                               width=planes[0].shape[1]).numpy()


SCRIPTED = {"mpeg2": {}, "psm": dict(psm=True), "mpeg1": dict(mpeg2=False),
            "mpeg1_psm": dict(mpeg2=False, psm=True), "dvd": dict(dvd=True),
            "dvd_mpeg1_psm": dict(dvd=True, mpeg2=False, psm=True),
            "large_pes": dict(pes_bytes=60000),
            "no_end_code": dict(end_code=False),
            "ntsc": dict(fps=(30000, 1001))}


@pytest.mark.parametrize("codec", ["h264", "hevc"])
@pytest.mark.parametrize("case", list(SCRIPTED))
def test_scripted_program_streams_give_the_written_pictures(tmp_path, codec,
                                                            case):
    frames, shown = _sequence()
    path = str(tmp_path / "v.mpg")
    if codec == "h264":
        sv.write_ipcm_ps(path, frames, key_every=4, **SCRIPTED[case])
    else:
        sv.write_hevc_ps(path, sv.encode_hevc_pcm(frames, key_every=4),
                         **SCRIPTED[case])
    got, cap = _assert_reads_as_cv2(path, len(frames))
    assert cap.codec == codec
    for i, (g, planes) in enumerate(zip(got, shown)):
        np.testing.assert_array_equal(g, _bgr(planes), err_msg=f"frame {i}")
    assert cap.fps == (30000 / 1001 if case == "ntsc" else 25.0)
    with open(path, "rb") as f:
        track = mpegps.read_track(path, f)
    assert track.stream_type == (sv.TS_STREAM_TYPES[codec]
                                 if "psm" in case else None)


@pytest.mark.parametrize("fourcc", ["PIM1", "MPG2", "mp4v"])
@pytest.mark.parametrize("mpeg2", [True, False])
def test_remuxed_with_a_map_reads_as_cv2_reads_it(tmp_path, fourcc, mpeg2):
    """cv2's PES re-muxed with a program stream map naming the codec
    (MPEG-1 as type 0x01): cv2 still reports MPEG-1 at its own rate."""
    src = _cv2_ps(tmp_path / "src.mpg", fourcc, 24, 30000 / 1001)
    with open(src, "rb") as f:
        track = mpegps.read_track(str(src), f)
        pes = list(track.pes(f))
    units = [sv.TsUnit(p.payload, p.pts, p.dts) for p in pes]
    keys = [mp4.intra_picture(track.codec, p.payload) for p in pes]
    dst = tmp_path / "dst.mpg"
    dst.write_bytes(sv.mux_ps(track.codec, units, keys, psm=True,
                              mpeg2=mpeg2))
    want, _ = _assert_reads_as_cv2(src, 24)
    got, cap = _assert_reads_as_cv2(dst, 24)
    assert cap.fps == 30000 / 1001
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", ["mpeg2", "hevc_dvd", "h264_mpeg1"])
def test_parser_packets_equal_cv2s(tmp_path, case):
    """cv2's raw packets of a program stream are the parser's frames, byte
    for byte, with the same key flags."""
    path = tmp_path / "v.mpg"
    if case == "mpeg2":
        _cv2_ps(path, "MPG2", 12)
    else:
        frames, _ = _sequence()
        if case == "hevc_dvd":
            sv.write_hevc_ps(str(path), sv.encode_hevc_pcm(frames, 4),
                             dvd=True)
        else:
            sv.write_ipcm_ps(str(path), frames, key_every=4, mpeg2=False)
    want = _cv2_raw(path)
    with open(path, "rb") as f:
        got = list(mpegps.read_track(str(path), f).packets(f))
    assert len(got) == len(want) > 0
    assert got == want


@pytest.mark.parametrize("hw,frames", [((480, 640), 4), ((96, 128), 40)])
def test_large_frames_take_ffmpegs_windows(tmp_path, hw, frames):
    """I_PCM frames of 0.46 MB (480x640) leave no PES start of the stream
    in the file's last 250,000 bytes: the duration comes from a doubled
    window, as for TS; 40 small frames need one window."""
    pics = sv.yuv_frames(2, *hw, seed=1)
    path = tmp_path / "big.mpg"
    sv.write_ipcm_ps(str(path), [pics[k % 2] for k in range(frames)],
                     key_every=1, pes_bytes=65000)
    got, cap = _assert_reads_as_cv2(path, frames)
    assert cap.frame_count == frames


def test_reads_on_past_an_end_code(tmp_path):
    """Two program streams joined (an end code between, as concatenated
    ``.vob`` files hold): cv2 reads on past the end code, and so does the
    port (libavformat's ``mpeg`` demuxer passes over it)."""
    pics = sv.yuv_frames(6, 48, 64)
    first = sv.encode_hevc_pcm(pics[:3])
    second = sv.encode_hevc_pcm(pics[3:])
    path = tmp_path / "joined.mpg"
    path.write_bytes(
        sv.mux_ps("hevc", sv.hevc_ts_units(first), first.keys)
        + sv.mux_ps("hevc", sv.hevc_ts_units(second, start=sv.TS_START
                                              + 3 * 3600), second.keys))
    assert path.read_bytes().count(b"\x00\x00\x01\xb9") == 2
    got, _ = _assert_reads_as_cv2(path, 6)
    for g, planes in zip(got, pics):
        np.testing.assert_array_equal(g, _bgr(planes))


def test_probe_tells_each_codec():
    frames, _ = _sequence()
    s, p, units, _ = sv.encode_ipcm(frames)
    h264 = b"".join(sv.h264_access_units(s, p, units))
    hevc = b"".join(sv.hevc_access_units(sv.encode_hevc_pcm(frames)))
    assert mpegps.probe_codec(h264) == "h264"
    assert mpegps.probe_codec(hevc) == "hevc"
    assert mpegps.probe_codec(b"\x00\x00\x01\xb3" + b"\x00" * 8
                              + b"\x00\x00\x01\xb8") == "mpeg2video"
    assert mpegps.probe_codec(b"\x00\x00\x01\xb0\x01\x00\x00\x01\xb5\x09"
                              b"\x00\x00\x01\x00\x00\x00\x01\x20\x08"
                              b"\x00\x00\x01\xb6\x10") == "mpeg4"
    assert mpegps.probe_codec(b"\x00" * 64) is None


def test_pes_headers_of_both_syntaxes():
    """MPEG-1 (stuffing, STD buffer, PTS, PTS + DTS, 0x0F) and MPEG-2
    PES headers give their times and payloads; other bytes drop it."""
    payload = b"\x00\x00\x01\xb3abc"
    cases = [
        (sv.mpeg1_pes(payload, 900, None, std=True), 900, 900),
        (sv.mpeg1_pes(payload, 900, 600), 900, 600),
        (sv.mpeg1_pes(payload, None, None), None, None),
        (sv.pes_packet(payload, 900, 600, False), 900, 600),
        (sv.pes_packet(payload, None, None, False), None, None)]
    stuffed = bytearray(sv.mpeg1_pes(payload, 900, None))
    stuffed[6:6] = b"\xff\xff\xff"
    stuffed[4:6] = (len(stuffed) - 6).to_bytes(2, "big")
    cases.append((bytes(stuffed), 900, 900))
    for data, pts, dts in cases:
        pes = mpegps.pes_packet(data, 0, len(data))
        assert pes == mpegts.Pes(pts, dts, payload), data[:12]
    bad = b"\x00\x00\x01\xe0\x00\x04\xc0abc"
    assert mpegps.pes_packet(bad, 0, len(bad)) is None


def test_program_stream_map_is_read_as_libavformat_reads_it():
    psm = sv.program_stream_map([(0x24, 0xE0), (0x0F, 0xC0)])
    assert mpegts.crc32_mpeg2(psm) == 0
    assert mpegps.program_stream_map(psm, 0, len(psm)) == {0xE0: 0x24,
                                                           0xC0: 0x0F}
    units = list(mpegps.units(sv.mux_ps("hevc", [sv.TsUnit(
        b"\x00" * 10, 900, None)], [True], psm=True)))
    assert [code for _, code, _ in units] == [mpegps.PSM, 0xE0]


def _ps_with_map(tmp_path, stream_type):
    frames, _ = _sequence()
    s, p, units, keys = sv.encode_ipcm(frames, 4)
    data = sv.mux_ps("h264", [sv.TsUnit(d, sv.TS_START + 3600 * i, None)
                              for i, d in enumerate(sv.h264_access_units(
                                  s, p, units))], keys, psm=True)
    path = tmp_path / "v.mpg"
    path.write_bytes(data.replace(
        sv.program_stream_map([(0x1B, 0xE0)]),
        sv.program_stream_map([(stream_type, 0xE0)])))
    return path


@pytest.mark.parametrize("kind,error", [
    ("no_video", r"an MPEG program stream with no video stream"),
    ("vc1_map", r"VC-1 in an MPEG program stream \(stream type 0xEA"),
    ("unknown_codec", r"whose video \(stream 0xE0\) is none of"),
    ("no_time", r"video stream with no timestamped PES packet")])
def test_program_stream_refusals_name_what_they_refuse(tmp_path, kind, error):
    path = tmp_path / "v.mpg"
    if kind == "no_video":
        path.write_bytes(sv.mux_ps("h264", [sv.TsUnit(
            b"\x00" * 10, 900, None)], [True]).replace(b"\x01\xe0",
                                                       b"\x01\xc0"))
    elif kind == "vc1_map":
        path = _ps_with_map(tmp_path, 0xEA)
    else:
        data = b"\x00" * 64 if kind == "unknown_codec" else \
            b"\x00\x00\x01\xb3" + b"\x00" * 60
        path.write_bytes(sv.mux_ps("h264", [sv.TsUnit(
            data, None if kind == "no_time" else 900, None)], [True]))
    with pytest.raises(ValueError, match=f"{error}.*item 4"):
        open_video(str(path), device="cpu")


def test_open_ps_without_a_card_raises(tmp_path, monkeypatch):
    frames, _ = _sequence()
    path = str(tmp_path / "v.mpg")
    sv.write_ipcm_ps(path, frames)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        open_video(path)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        DecodedVideo(path, "cuda", mpegps.read_track)
