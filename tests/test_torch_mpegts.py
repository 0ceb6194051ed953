"""The port's MPEG transport stream reader (``demo/mpegts.py`` over
libavcodec's parsers, ``native/avcodec.py`` ``Parser``) against cv2 5.0
(its FFmpeg backend) and against known pixels, on the CPU:

- MPEG-2, MPEG-1 and MPEG-4 Part 2 in ``.ts``, and MPEG-2 in ``.m2ts``
  (192-byte packets), written by this machine's cv2 at 64x48: frames equal
  to cv2's, pixel for pixel, with cv2's fps, size and frame count (MPEG-1
  at the rate libavformat reports for it, twice the written one below 59.94
  fps);
- I_PCM H.264 in TS (``demo/scripted_video.py`` ``mux_ts``): 188- and
  192-byte packets, bounded and unbounded PES, two frames in one PES, a
  frame over two PES, a private stream listed first, PAT/PMT in every
  packet, 29.97 fps, timestamps that wrap past 2^33, B pictures, frames
  too large for the 250,000-byte tail or the 5 MB probe: the frames are
  the written pictures and cv2's, with cv2's fps and count;
- cv2's MPEG-2 re-muxed the same ways;
- a lost packet (a continuity counter that skips), mid-PES, at a PES
  start and at the end, and stray bytes between packets: logged, and
  read as cv2 reads it;
- refusals: VVC (stream type 0x33), HEVC Main 10, a private stream only,
  a PMT with no video, no PAT, an MPEG program stream with no video,
  MPEG-2 4:2:2; each names what it refuses and ROADMAP.md item 4 (HEVC
  in TS is read: tests/test_torch_hevc.py);
- the parser splits a stream fed in pieces of any size into the same
  frames; CRC, packet size and timestamp unwrapping as FFmpeg's.

The video demo on an MPEG-2 TS against the JAX video demo is
``test_video_demo_people_equal_the_jax_video_demo`` of
tests/test_torch_video.py.
"""

import logging

import cv2
import numpy as np
import pytest
import torch

from rtpose_tpu_torch.data import imread_fixtures as fx
from rtpose_tpu_torch.demo import mpegts
from rtpose_tpu_torch.demo import scripted_video as sv
from rtpose_tpu_torch.demo.video_io import DecodedVideo, open_video
from rtpose_tpu_torch.native import avcodec
from rtpose_tpu_torch.ops.kernels import yuv420_to_bgr_plain

from test_torch_mkv import _assert_reads_as_cv2


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def _cv2_ts(path, fourcc, n=10, fps=25.0, h=48, w=64):
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), fps,
                             (w, h))
    assert writer.isOpened()
    for i in range(n):
        writer.write(np.ascontiguousarray(fx.render_scene(i, h, w)))
    writer.release()
    return path


CV2_TS = {"mpeg2": ("MPG2", "ts", 10, 25.0),
          "mpeg2_ntsc": ("MPG2", "ts", 24, 30000 / 1001),
          "mpeg1": ("PIM1", "ts", 10, 25.0),
          "mpeg1_60": ("PIM1", "ts", 7, 60.0),
          "mpeg1_24": ("PIM1", "ts", 30, 24.0),
          "mpeg4": ("mp4v", "ts", 10, 25.0),
          "mpeg4_ntsc": ("mp4v", "ts", 24, 30000 / 1001),
          "mpeg2_m2ts": ("MPG2", "m2ts", 10, 25.0)}


@pytest.mark.parametrize("case", list(CV2_TS))
def test_cv2_ts_reads_as_cv2_reads_it(tmp_path, case):
    fourcc, ext, n, fps = CV2_TS[case]
    path = _cv2_ts(tmp_path / f"v.{ext}", fourcc, n, fps)
    got, cap = _assert_reads_as_cv2(path, n)
    codec = {"MPG2": "mpeg2video", "PIM1": "mpeg1video", "mp4v": "mpeg4"}
    assert cap.codec == codec[fourcc] and cap.size == (64, 48)
    assert set(cap.seconds) == {"demux", "parse", "decode", "convert"}
    with open(path, "rb") as f:
        assert mpegts.read_track(str(path), f).packet_size == (
            192 if ext == "m2ts" else 188)


def _ipcm(h=48, w=64):
    pics = sv.yuv_frames(4, h, w)
    frames = [None if i is None else pics[i]
              for i in (0, 1, None, 2, 3, None, 1, 2, 0, None)]
    shown = []
    for f in frames:
        shown.append(shown[-1] if f is None else f)
    return frames, shown


def _bgr(planes, width=64):
    return yuv420_to_bgr_plain(*map(torch.from_numpy, planes),
                               width=width).numpy()


H264_TS = {
    "unbounded": {}, "m2ts": dict(packet_size=192),
    "bounded": dict(unbounded=False), "joined": dict(pes_per_frame=2),
    "joined_bounded": dict(pes_per_frame=2, unbounded=False),
    "split": dict(split=(1, 4, 9)), "split_m2ts": dict(split=(0, 5),
                                                      packet_size=192),
    "ntsc": dict(fps=(30000, 1001)), "wrap": dict(start=(1 << 33) - 3 * 3600),
    "private_first": dict(private_first=True), "psi_every": dict(psi_every=1),
}


@pytest.mark.parametrize("case", list(H264_TS))
def test_ipcm_h264_ts_gives_the_written_pictures(tmp_path, case):
    frames, shown = _ipcm()
    path = tmp_path / "v.ts"
    sv.write_ipcm_ts(str(path), frames, key_every=4, **H264_TS[case])
    got, cap = _assert_reads_as_cv2(path, len(frames))
    assert cap.codec == "h264"
    for i, (g, planes) in enumerate(zip(got, shown)):
        np.testing.assert_array_equal(g, _bgr(planes), err_msg=f"frame {i}")
    # two frames a PES: cv2's r_frame_rate guess sees one time a PES
    assert cap.fps == (12.5 if "joined" in case else
                       30000 / 1001 if case == "ntsc" else 25.0)


@pytest.mark.parametrize("case", ["b", "b_nohint", "b_joined", "b_m2ts"])
def test_bframe_h264_ts_comes_in_cv2s_order(tmp_path, case):
    kw = {"b": {}, "b_nohint": dict(reorder=None, poc_step=1),
          "b_joined": dict(pes_per_frame=2),
          "b_m2ts": dict(packet_size=192)}[case]
    path = tmp_path / "b.ts"
    shown = sv.write_bframes_ts(str(path), sv.yuv_frames(5, 48, 64, seed=3),
                                **kw)
    got, _ = _assert_reads_as_cv2(path, len(shown))
    for i, (g, planes) in enumerate(zip(got, shown)):
        np.testing.assert_array_equal(g, _bgr(planes), err_msg=f"frame {i}")


@pytest.mark.parametrize("case", ["joined", "split", "bounded", "m2ts"])
def test_remuxed_mpeg2_reads_as_cv2_reads_it(tmp_path, case):
    kw = {"joined": dict(pes_per_frame=2), "split": dict(split=(0, 3, 5)),
          "bounded": dict(unbounded=False), "m2ts": dict(packet_size=192)}
    src = _cv2_ts(tmp_path / "src.ts", "MPG2", 24, 30000 / 1001)
    dst = tmp_path / "dst.ts"
    assert sv.remux_ts(str(src), str(dst), **kw[case]) == 24
    want, _ = _assert_reads_as_cv2(src, 24)
    got, _ = _assert_reads_as_cv2(dst, 24)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _video_packets(data, size=188):
    packets = [data[i:i + size] for i in range(0, len(data), size)]
    video = [i for i, p in enumerate(packets)
             if ((p[1] & 0x1F) << 8 | p[2]) == sv.TS_VIDEO_PID]
    return packets, video


@pytest.mark.parametrize("unbounded", [True, False])
@pytest.mark.parametrize("where", ["mid_pes", "pes_start", "last"])
def test_lost_packet_is_logged_and_read_as_cv2_reads_it(tmp_path, caplog,
                                                        unbounded, where):
    frames, _ = _ipcm()
    src = tmp_path / "src.ts"
    sv.write_ipcm_ts(str(src), frames, key_every=4, unbounded=unbounded)
    packets, video = _video_packets(src.read_bytes())
    starts = [i for i in video if packets[i][1] & 0x40]
    lost = {"mid_pes": starts[3] + 2, "pes_start": starts[3],
            "last": video[-1]}[where]
    path = tmp_path / "lost.ts"
    path.write_bytes(b"".join(p for i, p in enumerate(packets)
                              if i != lost))
    with caplog.at_level(logging.WARNING, logger=mpegts.__name__):
        got, _ = _assert_reads_as_cv2(path)
    assert any("continuity check failed" in r.getMessage()
               for r in caplog.records) == (where != "last")
    # a lost PES start loses its frame: the rest is skipped (a PES of
    # stated length) or joins the PES before (length 0), as in FFmpeg
    assert len(got) == (len(frames) if where == "mid_pes"
                        else len(frames) - 1)


@pytest.mark.parametrize("stray", [b"\x11", b"\x47\x00" * 25,
                                   b"\x47" + b"\x00" * 187 + b"\x47"])
def test_sync_is_regained_after_stray_bytes(tmp_path, caplog, stray):
    """Bytes that are no packet between two (one, fifty, a false sync
    byte a packet apart): logged, and read as cv2 reads it."""
    frames, _ = _ipcm()
    src = tmp_path / "src.ts"
    sv.write_ipcm_ts(str(src), frames, key_every=4)
    data = src.read_bytes()
    path = tmp_path / "stray.ts"
    path.write_bytes(data[:188 * 40] + stray + data[188 * 40:])
    with caplog.at_level(logging.WARNING, logger=mpegts.__name__):
        _assert_reads_as_cv2(path, len(frames))
    assert any("sync lost" in r.getMessage() for r in caplog.records)


@pytest.mark.parametrize("hw,frames", [((480, 640), 4), ((1088, 1920), 3)])
def test_large_frames_take_ffmpegs_windows(tmp_path, hw, frames):
    """I_PCM frames of 0.46 MB (480x640) leave no PES start in the file's
    last 250,000 bytes: the duration comes from a doubled window; frames of
    3.1 MB (1088x1920) fill avformat_find_stream_info's 5 MB probe after
    two, too few to guess a rate from: cv2 reports the time base's."""
    pics = sv.yuv_frames(2, *hw, seed=1)
    path = tmp_path / "big.ts"
    sv.write_ipcm_ts(str(path), [pics[k % 2] for k in range(frames)],
                     key_every=1)
    got, cap = _assert_reads_as_cv2(path, frames)
    assert cap.frame_count == (frames if hw[0] == 480 else 7201)
    assert cap.fps == (25.0 if hw[0] == 480 else 90000.0)


def test_timestamps_unwrap_past_2_to_the_33(tmp_path):
    frames, _ = _ipcm()
    path = tmp_path / "wrap.ts"
    start = (1 << 33) - 3 * 3600
    sv.write_ipcm_ts(str(path), frames, start=start)
    with open(path, "rb") as f:
        track = mpegts.read_track(str(path), f)
        pts = [p.pts for p in track.pes(f)]
    assert pts[3] < pts[2]                       # wrapped in the file
    assert track.start_pts == start - (1 << 33)  # ... not when unwrapped
    assert track.end_pts - track.start_pts == 9 * 3600
    assert track.frame_count == 10
    wrap = mpegts.Wrap(1000)                     # early: later ones add
    assert (wrap(5), wrap(1 << 32)) == (5, 1 << 32)
    wrap = mpegts.Wrap(5000)
    assert wrap(1) == 1 and mpegts.Wrap(2 * 60 * 90000)(1) == 1 + (1 << 33)


def _ts_with(tmp_path, codec="h264", **kw):
    frames, _ = _ipcm()
    s, p, units, keys = sv.encode_ipcm(frames, 4)
    data = sv.h264_access_units(s, p, units)
    ts_units = [sv.TsUnit(d, sv.TS_START + i * 3600, None)
                for i, d in enumerate(data)]
    path = tmp_path / f"{codec}.ts"
    path.write_bytes(sv.mux_ts(codec, ts_units, keys, **kw))
    return path


def _no_video_pmt(tmp_path, stream_type):
    """A transport stream whose PMT lists only `stream_type`."""
    path = _ts_with(tmp_path)
    data = bytearray(path.read_bytes())
    pmt = sv.psi_section(0x02, 1, bytes([0xE1, 0x00, 0xF0, 0x00,
                                         stream_type, 0xE1, 0x00, 0xF0,
                                         0x00]))
    packets, _ = _video_packets(bytes(data))
    out = []
    for p in packets:
        pid = (p[1] & 0x1F) << 8 | p[2]
        if pid == sv.TS_PMT_PID:
            body = b"\x00" + pmt
            p = (p[:3] + bytes([0x10 | (p[3] & 0x0F)]) + body
                 + b"\xff" * (184 - len(body)))      # payload only
        out.append(p)
    path.write_bytes(b"".join(out))
    return path


@pytest.mark.parametrize("kind,error", [
    ("vvc", r"VVC video in MPEG-TS \(stream type 0x33\)"),
    ("hevc_main12", r"hevc frames in 12-bit 4:2:0 \(yuv420p12le\): only "
                    r"4:2:0 of 8 or 10 bits .*queue 1 (?=item 4i)"),
    ("private", r"only candidate for video is a private data stream "
                r"\(stream type 0x06\)"),
    ("audio_only", r"an MPEG-TS program with no video stream"),
    ("no_pat", r"an MPEG-TS stream with no PAT"),
    ("program_stream", r"an MPEG program stream with no video stream"),
    ("mpeg2_422", r"mpeg2video frames in 4:2:2 \(yuv422p\)")])
def test_ts_refusals_name_what_they_refuse(tmp_path, kind, error):
    if kind == "vvc":
        path = _no_video_pmt(tmp_path, 0x33)
    elif kind == "hevc_main12":               # Main 10 reads: item 4h
        path = tmp_path / "main12.m2ts"
        sv.write_hevc_ts(str(path), sv.encode_hevc_pcm(
            sv.yuv_frames10(2, 48, 64, depth=12), depth=12), packet_size=192)
    elif kind in ("private", "audio_only"):
        path = _no_video_pmt(tmp_path, 0x06 if kind == "private" else 0x0F)
    elif kind == "no_pat":
        path = tmp_path / "nopat.ts"
        path.write_bytes((b"\x47\x40\x00\x10" + b"\xff" * 184) * 4)
    elif kind == "program_stream":             # padding alone
        path = tmp_path / "v.mpg"
        path.write_bytes(b"\x00\x00\x01\xba\x44" + b"\x00" * 9
                         + b"\x00\x00\x01\xbe\x00\xc8" + b"\xff" * 200)
    else:
        path = mpeg2_422(tmp_path)
    with pytest.raises(ValueError, match=f"{error}.*item 4"):
        open_video(str(path), device="cpu")


def mpeg2_422(tmp_path):
    """cv2's MPEG-2 TS with each sequence extension's chroma_format set to
    4:2:2: the decoder gives yuv422p pictures."""
    src = _cv2_ts(tmp_path / "src.ts", "MPG2", 4)
    with open(src, "rb") as f:
        pes = list(mpegts.read_track(str(src), f).pes(f))
    units = []
    for p in pes:
        data = bytearray(p.payload)
        at = data.find(b"\x00\x00\x01\xb5")
        while at >= 0:
            if data[at + 4] >> 4 == 1:               # sequence extension
                data[at + 5] = (data[at + 5] & ~0x06) | (2 << 1)
            at = data.find(b"\x00\x00\x01\xb5", at + 4)
        units.append(sv.TsUnit(bytes(data), p.pts, p.dts))
    path = tmp_path / "422.ts"
    path.write_bytes(sv.mux_ts("mpeg2video", units,
                               [True] + [False] * (len(units) - 1)))
    return path


@pytest.mark.parametrize("piece", [1, 7, 100, 188, 5000])
def test_parser_splits_any_pieces_into_the_same_frames(tmp_path, piece):
    frames, _ = _ipcm()
    s, p, units, _ = sv.encode_ipcm(frames, 4)
    stream = b"".join(sv.h264_access_units(s, p, units))
    parser = avcodec.Parser("h264")
    got = []
    try:
        for at in range(0, len(stream), piece):
            got += parser.parse(stream[at:at + piece])
        got += parser.flush()
    finally:
        parser.close()
    assert got == sv.h264_access_units(s, p, units)


def test_mpeg2_parser_gives_cv2s_packets(tmp_path):
    """cv2's raw packets (``CAP_PROP_FORMAT`` -1) of an MPEG-2 TS are the
    parser's frames, byte for byte, with the same key flags."""
    path = _cv2_ts(tmp_path / "v.ts", "MPG2", 12)
    cap = cv2.VideoCapture(str(path), cv2.CAP_FFMPEG,
                           [cv2.CAP_PROP_FORMAT, -1])
    want = []
    while True:
        ok, data = cap.read()
        if not ok:
            break
        want.append((data.tobytes(),
                     bool(cap.get(cv2.CAP_PROP_LRF_HAS_KEY_FRAME))))
    cap.release()
    with open(path, "rb") as f:
        got = list(mpegts.read_track(str(path), f).packets(f))
    assert len(got) == len(want) == 12
    assert got == want


def test_packet_layout_and_crc_are_ffmpegs(tmp_path):
    path = _ts_with(tmp_path, packet_size=192)
    data = path.read_bytes()
    assert mpegts.packet_layout(data[:1536]) == (192, 4)
    assert mpegts.packet_layout(b"junk" + data[4:1536]) == (192, 4)
    assert mpegts.packet_layout(b"\x00" * 7 + _ts_with(
        tmp_path).read_bytes()[:1500]) == (188, 7)
    assert mpegts.packet_layout(b"\x47" + b"\x00" * 1000) is None
    assert mpegts.is_mpegts(data) and not mpegts.is_mpegts(data[4:])
    pat = sv.psi_section(0x00, 1, b"\x00\x01\xf0\x00")
    assert mpegts.crc32_mpeg2(pat) == 0
    assert mpegts.crc32_mpeg2(b"123456789") == 0x0376E6E7   # the check value


def test_open_ts_without_a_card_or_library_raises(tmp_path, monkeypatch):
    path = _ts_with(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        open_video(str(path))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        DecodedVideo(str(path), "cuda", mpegts.read_track)
    monkeypatch.setattr(avcodec, "_libs", None)
    monkeypatch.setattr(avcodec, "_library_dirs", lambda: [])
    with pytest.raises(RuntimeError, match="no libavcodec found"):
        open_video(str(path), device="cpu")
    with pytest.raises(RuntimeError, match="no libavcodec found"):
        avcodec.Parser("h264")


@pytest.mark.parametrize("case", ["vui709", "vui2020_full", "high10",
                                  "high10_m2ts", "hevc_main10_240m"])
def test_colour_and_10bit_ts_read_as_cv2(tmp_path, case):
    """A transport stream states no colour: the bitstream's, in the VUI of
    I_PCM H.264 (8-bit and High 10) and PCM HEVC Main 10, is the frame's,
    as cv2 reads it."""
    path = tmp_path / "v.ts"
    if case.startswith("hevc"):
        sv.write_hevc_ts(str(path), sv.encode_hevc_pcm(
            sv.yuv_frames10(3, 48, 64), depth=10,
            colour=sv.Colour(7, False)))
    elif case.startswith("high10"):
        sv.write_ipcm_ts(str(path), sv.yuv_frames10(3, 48, 64), depth=10,
                         colour=sv.Colour(9, True),
                         packet_size=192 if "m2ts" in case else 188)
    else:
        sv.write_ipcm_ts(str(path), sv.yuv_frames(3, 48, 64),
                         colour=sv.Colour(1) if case == "vui709"
                         else sv.Colour(9, True))
    _assert_reads_as_cv2(path, 3)


@pytest.mark.parametrize("colour", [sv.Colour(1, False, 1, 1),
                                    sv.Colour(4, False, 4, 4),
                                    sv.Colour(9, False, 2, 2)],
                         ids=["bt709", "fcc", "bt2020"])
def test_mpeg2_sequence_display_colour_reads_as_cv2(tmp_path, colour):
    """MPEG-2 states its matrix in the sequence display extension (the
    wheel's ``mpeg2video`` encoder writes it from the context): the
    decoder's, cv2's."""
    packets = sv.encode_lavc("mpeg2video", sv.yuv_frames(3, 48, 64),
                             colour, fps=25, qscale=2)
    path = tmp_path / "v.ts"
    path.write_bytes(sv.mux_ts("mpeg2video", [
        sv.TsUnit(d, sv.TS_START + 3600 * i, None)
        for i, (d, _) in enumerate(packets)], [k for _, k in packets]))
    got, _ = _assert_reads_as_cv2(path, 3)
    want = open_video(str(path), device="cpu")
    want.read()
    assert want._decoder.colour.matrix == colour.matrix
    want.release()
