"""The port's HEVC video (``native/avcodec.py``'s ``hevc`` decoder and
parser; ``hvc1`` / ``hev1`` in ``demo/mp4.py``, ``V_MPEGH/ISO/HEVC`` in
``demo/mkv.py``, stream type 0x24 in ``demo/mpegts.py``) against cv2 5.0
and against known pixels, on the CPU:

- the PCM writer (``demo/scripted_video.py`` ``encode_hevc_pcm``: a
  CABAC encoder, PCM coding units, P pictures of skipped CUs, a
  conformance window, pictures out of decode order): libavcodec decodes
  its planes to the written Y, U and V exactly, and cv2 decodes the
  same;
- HEVC in MP4 (``hvc1`` and ``hev1``), Matroska (with and without
  ``DefaultDuration``) and MPEG-TS (188 and 192 bytes, PES joined and
  split, 29.97 fps): ``open_video`` gives cv2's frames, 0 pixels apart,
  the written pictures, cv2's fps, size and frame count; the reordered
  and the cropped streams too, with no probe of the decoder;
- the demuxers' packets are cv2's raw packets (``CAP_PROP_FORMAT`` -1)
  byte for byte, with cv2's key flags: the container's sync flags in MP4
  and Matroska, IRAP pictures in TS (the ``hevc`` parser's);
- HEVC Main 10: the decoder refuses its ``yuv420p10le`` frames naming
  item 4h (the containers' refusals, and the video demo on HEVC against
  the JAX demo: tests/test_torch_video.py).
"""

import numpy as np
import pytest
import torch

from rtpose_tpu_torch.demo import mkv, mp4, mpegts
from rtpose_tpu_torch.demo import scripted_video as sv
from rtpose_tpu_torch.native import avcodec
from rtpose_tpu_torch.ops.kernels import yuv420_to_bgr_plain

from test_torch_mkv import _assert_reads_as_cv2
from test_torch_mp4 import _cv2_raw

# PCM pictures, P-skip repeats, an IDR every 4 frames, intra TRAIL_R
# pictures between
SEQ = (0, 1, None, 2, 3, None, 1, 2, 0, None)


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def _stream(h=48, w=64, seq=SEQ, key_every=4, **kw):
    pics = sv.yuv_frames(4, h, w)
    return sv.encode_hevc_pcm([None if i is None else pics[i] for i in seq],
                              key_every=key_every, **kw)


def _decode(data, codec="hevc"):
    """libavcodec's planes (cropped to the picture) of an Annex-B stream
    split by the parser."""
    decoder, parser = avcodec.Decoder(codec), avcodec.Parser(codec)
    out = []
    try:
        for frame in parser.parse(data) + parser.flush() + [None]:
            pictures = (decoder.flush() if frame is None
                        else decoder.decode(frame))
            for y, u, v, width in pictures:
                h = y.shape[0]
                out.append((y[:, :width].copy(),
                            u[:(h + 1) // 2, :width // 2].copy(),
                            v[:(h + 1) // 2, :width // 2].copy()))
    finally:
        decoder.close()
        parser.close()
    return out


def _bgr(planes):
    return yuv420_to_bgr_plain(*map(torch.from_numpy, planes),
                               width=planes[0].shape[1]).numpy()


STREAMS = {"pcm": {}, "96x128": dict(h=96, w=128),
           "cropped": dict(h=90, w=60, seq=(0, 1, 2, 3), key_every=0),
           "reordered": dict(seq=(0, 1, 2, 3, 0, 1, 2), key_every=0,
                             reorder=True),
           "one_key": dict(key_every=0)}


@pytest.mark.parametrize("case", list(STREAMS))
def test_pcm_planes_decode_to_the_written_yuv(case):
    stream = _stream(**STREAMS[case])
    got = _decode(sv.hevc_annexb(stream))
    assert len(got) == len(stream.shown) == len(STREAMS[case].get(
        "seq", SEQ))
    for i, (g, want) in enumerate(zip(got, stream.shown)):
        for a, b in zip(g, want):
            np.testing.assert_array_equal(a, b, err_msg=f"picture {i}")


def test_cabac_tables_and_contexts_are_the_standards():
    """Table 9-52's and 9-53's shapes and ends, and the contexts the
    writer starts from (9.3.2.2 at SliceQpY 26)."""
    assert len(sv.RANGE_TAB_LPS) == len(sv.TRANS_IDX_LPS) == 64
    assert sv.RANGE_TAB_LPS[0] == (128, 176, 208, 240)
    assert sv.RANGE_TAB_LPS[63] == (2, 2, 2, 2)
    for row, nxt in zip(sv.RANGE_TAB_LPS, sv.RANGE_TAB_LPS[1:62]):
        assert all(a >= b for a, b in zip(row, nxt)) and list(row) == \
            sorted(row)
    assert all(t <= i for i, t in enumerate(sv.TRANS_IDX_LPS[:63]))
    assert sv.cabac_context(sv.HEVC_PART_MODE_I) == [0, 1]
    assert [sv.cabac_context(v) for v in sv.HEVC_CU_SKIP_P] == [
        [15, 0], [8, 1], [16, 1]]


def test_cabac_flush_ends_on_a_one_bit():
    """EncodeFlush writes the stop bit last; the bits before a PCM
    unit's samples are whole bytes."""
    cabac = sv.CabacEncoder()
    ctx = sv.cabac_context(sv.HEVC_PART_MODE_I)
    for _ in range(5):
        cabac.decision(ctx, 1)
        cabac.terminate(0)
    cabac.terminate(1)
    assert cabac.bits[-1] == 1
    data = cabac.take()
    assert data and data[-1] != 0 and cabac.bits == []


def _files(tmp_path, case):
    """(path, stream) of an HEVC file of `case`."""
    stream = _stream(**({"reordered": STREAMS["reordered"],
                         "cropped": STREAMS["cropped"]}.get(
        case.split("_")[0], {})))
    path = str(tmp_path / f"{case}.bin")
    kind = case.split("_")[-1]
    if kind in ("hvc1", "hev1"):
        sv.write_hevc_mp4(path, stream, kind=kind)
    elif kind == "mkv":
        sv.write_hevc_mkv(path, stream)
    else:
        kw = {"ts": {}, "m2ts": dict(packet_size=192),
              "joined": dict(pes_per_frame=2), "split": dict(split=(1, 4)),
              "ntsc": dict(fps=(30000, 1001)), "bounded": dict(
                  unbounded=False)}[kind]
        sv.write_hevc_ts(path, stream, **kw)
    return path, stream


FILES = ["hvc1", "hev1", "mkv", "ts", "m2ts", "ts_joined", "ts_split",
         "ts_ntsc", "ts_bounded", "reordered_hvc1", "reordered_mkv",
         "reordered_ts", "cropped_hvc1", "cropped_mkv", "cropped_ts"]


@pytest.mark.parametrize("case", FILES)
def test_hevc_files_read_as_cv2_reads_them(tmp_path, case):
    path, stream = _files(tmp_path, case)
    got, cap = _assert_reads_as_cv2(path, len(stream.shown))
    assert cap.codec == "hevc"
    h, w = stream.shown[0][0].shape
    assert cap.size == (w, h)
    for i, (g, planes) in enumerate(zip(got, stream.shown)):
        np.testing.assert_array_equal(g, _bgr(planes), err_msg=f"frame {i}")
    if "joined" not in case:
        assert cap.fps == (30000 / 1001 if "ntsc" in case else
                           20.0 if "mkv" in case else 25.0)


@pytest.mark.parametrize("fps", [20.0, 29.97])
@pytest.mark.parametrize("n", [5, 16])
def test_hevc_live_matroska_reads_as_cv2_reads_it(tmp_path, fps, n):
    """No ``DefaultDuration``: cv2's fps is FFmpeg's guess from the block
    times (HEVC's blocks carry times from the first, unlike H.264's)."""
    stream = sv.encode_hevc_pcm(sv.yuv_frames(n, 48, 64), key_every=8)
    path = str(tmp_path / "live.mkv")
    sv.write_hevc_mkv(path, stream, default_duration=False, fps=fps)
    _assert_reads_as_cv2(path, n)


@pytest.mark.parametrize("case", ["hvc1", "hev1", "mkv", "ts", "m2ts"])
def test_demuxer_packets_equal_cv2s(tmp_path, case):
    """cv2's raw packets of each container: Annex-B with the ``hvcC``
    sets ahead of each IDR (twice in ``hev1``, as hevc_mp4toannexb writes
    them), the TS parser's access units; key flags as cv2's."""
    path, stream = _files(tmp_path, case)
    if case in ("hvc1", "hev1", "mkv"):
        # the intra TRAIL_R and the P picture after the IDR marked too
        stream = stream._replace(keys=[True] * 3 + stream.keys[3:])
        if case == "mkv":
            sv.write_hevc_mkv(path, stream)
        else:
            sv.write_hevc_mp4(path, stream, kind=case)
    with open(path, "rb") as f:
        reader = {"mkv": mkv.read_track, "ts": mpegts.read_track,
                  "m2ts": mpegts.read_track}.get(case, mp4.read_track)
        got = list(reader(path, f).packets(f))
    want = _cv2_raw(path)
    assert len(got) == len(want) == len(SEQ)
    for i, ((data, key), (cv_data, cv_key)) in enumerate(zip(got, want)):
        assert data == cv_data, i
        assert key == cv_key, i
    # MP4 and Matroska: the sync samples / key blocks as written (a P
    # picture marked so too); TS: the IRAP pictures, not the intra TRAIL_R
    assert [k for _, k in got] == (
        [i % 4 == 0 for i in range(len(SEQ))] if "ts" in case
        else stream.keys)


def test_intra_picture_is_an_irap_picture():
    stream = _stream()
    units = sv.hevc_access_units(stream)
    assert [mp4.intra_picture("hevc", u) for u in units] == stream.keys
    assert stream.keys == [i % 4 == 0 for i in range(len(SEQ))]
    cra = b"\x00\x00\x01" + bytes([21 << 1, 1]) + b"\xaf"   # CRA_NUT
    assert mp4.intra_picture("hevc", cra)
    assert not mp4.intra_picture("hevc", b"\x00\x00\x01\x4e\x01\x05")


def test_main10_frames_are_refused_by_name():
    """Main 10 is read since item 4h (tests/test_torch_colour.py), Main 12
    and the range extensions since item 4i (d)
    (tests/test_torch_chroma_formats.py): their hvcC passes; HEVC of
    another depth is refused by name, by its hvcC and by the decoder,
    9-bit 4:2:0 here (item 4i)."""
    assert mp4.hevc_refusal(1, (10, 10)) is None
    assert mp4.hevc_refusal(1, (12, 12)) is None
    stream = sv.encode_hevc_pcm(sv.yuv_frames10(2, 48, 64, depth=9),
                                depth=9)
    record = sv.hvcc_record(stream)
    assert mp4.hvcc_config(record, 0, len(record)).depth == (9, 9)
    assert "9 bits, 4:2:0 (only 8, 10 and 12" in mp4.hevc_refusal(1, (9, 9))
    with pytest.raises(ValueError, match=r"hevc frames in 9-bit 4:2:0 "
                                         r"\(yuv420p9le\).*item 4i"):
        _decode(sv.hevc_annexb(stream))


def test_hvcc_record_is_ffmpegs_extradata(tmp_path):
    """The hvcC a reader parses: 4-byte lengths, the VPS, SPS and PPS in
    order, 8-bit 4:2:0; cv2 opens the hvc1 MP4 that carries it."""
    stream = _stream()
    config = mp4.hvcc_config(sv.hvcc_record(stream), 0,
                             len(sv.hvcc_record(stream)))
    assert config == mp4.HevcConfig(4, stream.params, 1, (8, 8))
    assert mp4.hevc_refusal(1, (8, 8)) is None
    assert mp4.hevc_refusal(2, (8, 8)) is None
    assert "4:2:2" in mp4.hevc_refusal(2, (16, 16))


def test_hevc_needs_no_decoder_probe(tmp_path, monkeypatch):
    """The reordered stream reads as cv2 reads it although the decoder is
    not probed first (an HEVC SPS states its reorder delay)."""
    calls = []
    monkeypatch.setattr(avcodec.Decoder, "probe",
                        lambda self, packets: calls.append(self.codec))
    path, stream = _files(tmp_path, "reordered_hvc1")
    _assert_reads_as_cv2(path, len(stream.shown))
    assert calls == []


def _stream10(h=48, w=64, seq=SEQ, key_every=4, **kw):
    pics = sv.yuv_frames10(4, h, w)
    return sv.encode_hevc_pcm([None if i is None else pics[i] for i in seq],
                              key_every=key_every, depth=10, **kw)


def test_main10_pcm_planes_are_the_written_ones():
    """10-bit PCM samples (``pcm_sample_bit_depth`` 10, bit-packed) in
    Main 10 pictures: libavcodec gives back the written 10-bit planes,
    uint16, and the ``hvcC`` states 10 bits."""
    stream = _stream10()
    record = sv.hvcc_record(stream)
    assert mp4.hvcc_config(record, 0, len(record)) == mp4.HevcConfig(
        4, stream.params, 1, (10, 10))
    got = _decode(sv.hevc_annexb(stream))
    assert len(got) == len(stream.shown)
    for planes, want in zip(got, stream.shown):
        for a, b in zip(planes, want):
            assert a.dtype == np.uint16
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["hvc1", "hev1", "mkv", "ts", "m2ts",
                                  "reordered_mp4", "reordered_ts",
                                  "cropped_mkv"])
def test_main10_reads_as_cv2(tmp_path, case):
    """PCM HEVC Main 10 in every container of the 8-bit cases, reordered
    and cropped too (BT.709 in the VUI): cv2's frames, fps, size, count."""
    colour = sv.Colour(1)
    if case.startswith("reordered"):
        stream = sv.encode_hevc_pcm(sv.yuv_frames10(5, 48, 64, seed=3),
                                    reorder=True, depth=10, colour=colour)
    elif case.startswith("cropped"):
        stream = sv.encode_hevc_pcm(sv.yuv_frames10(3, 42, 58, seed=4),
                                    depth=10, colour=colour)
    else:
        stream = _stream10(colour=colour)
    path = str(tmp_path / "v.bin")
    if case in ("hvc1", "hev1", "reordered_mp4"):
        sv.write_hevc_mp4(path, stream, kind="hev1" if case == "hev1"
                          else "hvc1")
    elif case.endswith("mkv"):
        sv.write_hevc_mkv(path, stream)
    else:
        sv.write_hevc_ts(path, stream,
                         packet_size=192 if case == "m2ts" else 188)
    _assert_reads_as_cv2(path, len(stream.shown))
