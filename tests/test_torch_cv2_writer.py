"""The video files cv2's own ``VideoWriter`` writes, and ProRes, read as
the JAX demo's ``cv2.VideoCapture`` reads them (ROADMAP.md item 4j (c),
(d)), on the CPU: every frame 0 levels apart from the JAX package's
reader (``rtpose_tpu/demo/video_demo.py`` ``open_video``, a bare
``cv2.VideoCapture``), the frame count and fps equal.

- every fourcc of cv2's writer whose files the port once refused by name
  (``0`` / ``I420`` / ``IYUV`` / ``Y800`` raw video, ``PIM1``, ``mpg2`` /
  ``MPEG``, ``MP42``, ``DIV3``, ``WMV1``, ``WMV2``, ``FLV1``, ``FFVH``,
  ``HFYU``, ``FFV1``), written by this machine's cv2 in AVI and in
  Matroska at 48x64 from seeded numpy frames, and at odd sizes with
  more frames (MPEG-2's B pictures);
- ProRes 422 (proxy, standard, HQ) and 4444 (with an alpha plane too,
  and XQ) in MOV and Matroska, from the wheel's ``prores`` encoder
  (``demo/scripted_video.py`` ``write_prores``);
- raw packed RGB (``bgr24``, ``rgb24``, ``bgra``, ``bgr0``) in Matroska
  ``V_UNCOMPRESSED``, and the packed route's plain version against the
  machine's libswscale at odd sizes and at each turn;
- the decoder's extradata / size / bits round trip
  (``native/avcodec.py`` ``Decoder.handed``), its refusal of a library
  whose ``AVCodecParameters`` do not read back, and the key flags of the
  new codecs against the AVI index cv2's muxer writes;
- what ROADMAP.md item 4j (e) keeps refused, by name.
"""

import os
import struct
import sys

import cv2
import numpy as np
import pytest
import torch

from rtpose_tpu.demo import video_demo as jvideo_demo
from rtpose_tpu_torch.demo import mkv, mp4
from rtpose_tpu_torch.demo import scripted_video as sv
from rtpose_tpu_torch.demo.video_io import AviStream, open_video
from rtpose_tpu_torch.native import avcodec
from rtpose_tpu_torch.ops import kernels

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
from torch_probe_video import swscale_bgr24  # noqa: E402

# fourcc given to cv2 -> the decoder the port reads it with
WRITER = {"0": "rawvideo", "I420": "rawvideo", "IYUV": "rawvideo",
          "Y800": "rawvideo", "PIM1": "mpeg1video", "mpg2": "mpeg2video",
          "MPEG": "mpeg2video", "MP42": "msmpeg4v2", "DIV3": "msmpeg4",
          "WMV1": "wmv1", "WMV2": "wmv2", "FLV1": "flv", "FFVH": "ffvhuff",
          "HFYU": "huffyuv", "FFV1": "ffv1"}
# (fourcc, (h, w), frames, fps) at odd sizes, over a group of pictures
ODD = [("mpg2", (47, 63), 13, 29.97), ("PIM1", (31, 48), 9, 24.0),
       ("FFV1", (31, 47), 5, 30.0), ("HFYU", (47, 63), 4, 25.0),
       ("FFVH", (47, 64), 4, 25.0), ("WMV2", (31, 48), 7, 15.0),
       ("DIV3", (47, 63), 7, 25.0), ("I420", (47, 63), 3, 10.0),
       ("Y800", (31, 47), 3, 10.0), ("FLV1", (47, 63), 7, 25.0)]
# ProRes profile -> (chroma of the 10-bit input, with an alpha plane)
PRORES = {"proxy": (0, (1, 0), False), "422": (2, (1, 0), False),
          "hq": (3, (1, 0), False), "4444": (4, (0, 0), False),
          "4444_alpha": (4, (0, 0), True), "4444xq": (5, (0, 0), False)}


def _frames(n, h, w, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            for _ in range(n)]


def _read(cap):
    """The frames of `cap`; a port reader keeps its last frame's colour
    as ``last_colour``."""
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        out.append(frame)
        if hasattr(cap, "_decoder"):
            cap.last_colour = cap._decoder.colour
    cap.release()
    return out


def _jax_read(path):
    """The JAX package's reader (cv2): frames, count, fps."""
    cap = jvideo_demo.open_video(str(path))
    props = (int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
             cap.get(cv2.CAP_PROP_FPS))
    return _read(cap), props


def _assert_reads_as_jax(path, codec, n):
    want, props = _jax_read(path)
    port = open_video(str(path), device="cpu")
    got = _read(port)
    assert port.codec == codec
    assert len(got) == len(want) == n
    assert (port.frame_count, port.fps) == props
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, f"frame {i}"
        assert int(np.abs(g.astype(int) - w).max()) == 0, f"frame {i}"
    return port


def _cv2_write(path, fourcc, size, n=3, fps=25.0, seed=0):
    h, w = size
    code = 0 if fourcc == "0" else cv2.VideoWriter_fourcc(*fourcc)
    writer = cv2.VideoWriter(str(path), cv2.CAP_FFMPEG, code, fps, (w, h))
    assert writer.isOpened(), fourcc
    for frame in _frames(n, h, w, seed):
        writer.write(frame)
    writer.release()
    return path


@pytest.mark.parametrize("container", ["avi", "mkv"])
@pytest.mark.parametrize("fourcc", list(WRITER))
def test_cv2_writer_codecs(tmp_path, fourcc, container):
    """Each row of cv2's writer, 3 frames of 48x64, as the JAX reader."""
    path = _cv2_write(tmp_path / f"v.{container}", fourcc, (48, 64))
    _assert_reads_as_jax(path, WRITER[fourcc], 3)


@pytest.mark.parametrize("container", ["avi", "mkv"])
@pytest.mark.parametrize("fourcc,size,n,fps", ODD,
                         ids=[f"{f}-{h}x{w}" for f, (h, w), _, _ in ODD])
def test_cv2_writer_odd_sizes(tmp_path, fourcc, size, n, fps, container):
    """Odd heights and widths (each colour route of the decoded format),
    B pictures (MPEG-1/2), inter pictures (MS-MPEG4, WMV2, Sorenson) and
    NTSC's rate."""
    path = _cv2_write(tmp_path / f"v.{container}", fourcc, size, n, fps, 7)
    _assert_reads_as_jax(path, WRITER[fourcc], n)


@pytest.mark.parametrize("size", [(48, 64), (47, 64)],
                         ids=lambda s: "%dx%d" % s)
@pytest.mark.parametrize("container", ["mov", "mkv"])
@pytest.mark.parametrize("profile", list(PRORES))
def test_prores(tmp_path, profile, container, size):
    """ProRes 422 decodes to 10-bit 4:2:2, 4444 to 12-bit 4:4:4 (its alpha
    plane dropped, as swscale drops it for bgr24): the planar routes."""
    number, chroma, alpha = PRORES[profile]
    h, w = size
    frames = sv.yuv_frames10(3, h, w, seed=number, chroma=chroma)
    if alpha:
        frames = [(*f, np.full((h, w), 1023, np.uint16)) for f in frames]
    path = str(tmp_path / f"v.{container}")
    sv.write_prores(path, frames, profile=number, container=container)
    colour = _assert_reads_as_jax(path, "prores", 3).last_colour
    assert (colour.depth, colour.chroma) == (
        (10, (1, 0)) if number < 4 else (12, (0, 0)))


@pytest.mark.parametrize("layout,tag", [("rgb24", b"RGB\x18"),
                                        ("bgr24", b"BGR\x18"),
                                        ("bgra", b"BGRA"),
                                        ("bgr0", b"BGR\x00")])
def test_raw_packed_rgb_in_matroska(tmp_path, layout, tag):
    """Raw packed RGB (``V_UNCOMPRESSED``, its pixel format from the
    track's ``ColourSpace``) through the packed route."""
    h, w = 31, 47
    rng = np.random.RandomState(len(tag) + tag[0])
    n = kernels.PACKED_BYTES[layout]
    packets = [(rng.randint(0, 256, h * w * n).astype(np.uint8).tobytes(),
                True) for _ in range(3)]
    path = tmp_path / "v.mkv"
    path.write_bytes(sv.mux_mkv("V_UNCOMPRESSED", packets, (w, h),
                                colour_space=tag))
    port = _assert_reads_as_jax(path, "rawvideo", 3)
    assert port.last_colour.packed == layout


def test_packed_formats_but_the_four_are_refused_by_name(tmp_path):
    path = tmp_path / "v.mkv"
    path.write_bytes(sv.mux_mkv("V_UNCOMPRESSED", [(bytes(4 * 64 * 48),
                                                    True)], (64, 48),
                                colour_space=b"RGBA"))
    cap = open_video(str(path), device="cpu")
    with pytest.raises(ValueError, match=r"frames in rgba:.*item 4i"):
        cap.read()
    cap.release()


@pytest.mark.parametrize("rotation", kernels.ROTATIONS)
@pytest.mark.parametrize("size", [(1, 1), (9, 8), (47, 63), (31, 65),
                                  (2, 129)], ids=lambda s: "%dx%d" % s)
@pytest.mark.parametrize("layout", list(kernels.PACKED_BYTES))
def test_packed_plain_equals_libswscale(layout, size, rotation):
    """swscale's unscaled packed-to-packed path (``rgb32to24``, a copy, a
    swap) at odd sizes, then cv2's turn; a padded pitch."""
    h, w = size
    n = kernels.PACKED_BYTES[layout]
    rng = np.random.RandomState(h * w + n)
    frame = rng.randint(0, 256, (h, n * w + 5)).astype(np.uint8)
    want = swscale_bgr24(np.ascontiguousarray(frame[:, :n * w]), None, None,
                         2, False, 0, packed=layout)
    got = kernels.yuv420_frame_to_bgr(torch.from_numpy(frame), None, None,
                                      depth=8, width=w, rotation=rotation,
                                      packed=layout)
    assert kernels.frame_route(None, 8, h, w, layout) == "packed"
    np.testing.assert_array_equal(got.numpy(),
                                  np.rot90(want, -rotation // 90))


def test_packed_wrapper_checks_its_frame():
    with pytest.raises(ValueError, match="does not hold"):
        kernels.packed_to_bgr(torch.zeros(4, 11, dtype=torch.uint8),
                              width=4, layout="bgr24")
    with pytest.raises(ValueError, match="no packed format"):
        kernels.packed_to_bgr(torch.zeros(4, 16, dtype=torch.uint8),
                              width=4, layout="rgba")


@pytest.mark.parametrize("fourcc,extradata", [
    ("WMV2", 4), ("HFYU", 106), ("FFVH", 106), ("FFV1", 42), ("I420", 0),
    ("MP42", 0)])
def test_decoder_hands_the_container_params(tmp_path, fourcc, extradata):
    """The extradata, size and bits of an AVI's BITMAPINFOHEADER (cv2's
    writer's, asked for 47x63: it rounds a 4:2:0 codec's size down to
    even) read back from the codec context
    (``avcodec_parameters_from_context``, its options)."""
    path = str(_cv2_write(tmp_path / "v.avi", fourcc, (47, 63)))
    with open(path, "rb") as f:
        stream = AviStream(path, f)
    params = stream.params
    assert len(params.extradata) == extradata
    assert params.size == stream.size and params.bits in (12, 24)
    assert stream.size in ((63, 47), (62, 46))
    decoder = avcodec.Decoder(stream.codec, tag=stream.tag, params=params)
    try:
        assert decoder.handed() == params
    finally:
        decoder.close()


def test_decoder_refuses_parameters_that_do_not_read_back(monkeypatch):
    """A library whose AVCodecParameters' leading fields lie elsewhere
    (here: a layout read 4 bytes off) is refused, not written to."""
    import ctypes

    class Shifted(ctypes.Structure):
        _fields_ = [("pad", ctypes.c_int), ("codec_type", ctypes.c_int),
                    ("codec_id", ctypes.c_int),
                    ("codec_tag", ctypes.c_uint32),
                    ("extradata", ctypes.c_void_p),
                    ("extradata_size", ctypes.c_int)]

    monkeypatch.setattr(avcodec, "_ParamsHead", Shifted)
    with pytest.raises(RuntimeError, match="layout is not FFmpeg"):
        avcodec.Decoder("wmv2", tag=b"WMV2", params=avcodec.CodecParams(
            b"\xc8\x96\xb4\x80", (64, 48), 24))


def _idx1_keys(path):
    """The key flags of cv2's AVI index (``idx1``), in chunk order."""
    data = open(path, "rb").read()
    at = data.rindex(b"idx1")
    n = struct.unpack_from("<I", data, at + 4)[0] // 16
    return [bool(struct.unpack_from("<4sIII", data, at + 8 + 16 * i)[1]
                 & 0x10) for i in range(n)]


@pytest.mark.parametrize("fourcc", ["mpg2", "PIM1", "MP42", "DIV3", "WMV1",
                                    "WMV2", "FLV1", "FFV1", "HFYU", "I420"])
def test_key_flags_are_the_muxers(tmp_path, fourcc):
    """intra_picture on each packet equals the key flag FFmpeg's encoder
    gave it, which cv2's AVI muxer writes to the index (12 frames: a
    group of pictures and more)."""
    path = str(_cv2_write(tmp_path / "v.avi", fourcc, (48, 64), 12))
    with open(path, "rb") as f:
        stream = AviStream(path, f)
        keys = [key for _, key in stream.packets(f)]
    assert keys == _idx1_keys(path)
    assert keys[0]


def test_a_new_route_on_the_card_without_one_raises(tmp_path):
    """No fallback: an FFV1 AVI (the packed route) opened on "cuda" with
    no card raises before any frame."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    path = _cv2_write(tmp_path / "v.avi", "FFV1", (48, 64))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        open_video(str(path), device="cuda")


def _still_refused(tmp_path, kind):
    """A file of ROADMAP.md item 4j (e), which the port refuses."""
    avi = str(_cv2_write(tmp_path / "v.avi", "MP42", (48, 64)))
    data = open(avi, "rb").read()
    if kind.startswith("avi_"):
        tag = {"avi_wvc1": b"WVC1", "avi_theora": b"THEO",
               "avi_h263": b"H263", "avi_bi_rgb": b"\0\0\0\0"}[kind]
        data = data.replace(b"MP42", tag)
    elif kind == "vfw_wmv3":
        with open(avi, "rb") as f:
            stream = AviStream(avi, f)
            packets = list(stream.packets(f))
        from rtpose_tpu_torch.demo.video_io import bitmap_info
        data = sv.mux_mkv("V_MS/VFW/FOURCC", packets, (64, 48),
                          codec_private=bitmap_info((64, 48), b"WMV3"))
    elif kind == "mkv_theora":
        data = sv.mux_mkv("V_THEORA", [(b"\x80theora", True)], (64, 48))
    elif kind == "mov_s263":
        pics = sv.yuv_frames(2, 48, 64)
        sps, pps, units, keys = sv.encode_ipcm(pics)
        data = sv.mux_mp4(sps, pps, units, keys, (64, 48)).replace(
            b"avc1", b"s263")
    path = tmp_path / f"{kind}.bin"
    path.write_bytes(data)
    return str(path)


@pytest.mark.parametrize("kind,what", [
    ("avi_wvc1", "VC-1"), ("avi_theora", "Theora"), ("avi_h263", "H.263"),
    ("avi_bi_rgb", "BI_RGB DIB"), ("vfw_wmv3", "WMV3 / VC-1"),
    ("mkv_theora", "Theora"), ("mov_s263", "H.263")])
def test_what_item_4j_e_keeps_is_refused_by_name(tmp_path, kind, what):
    with pytest.raises(ValueError, match=rf"{what}.*item 4j \(e\)"):
        open_video(_still_refused(tmp_path, kind), device="cpu")


def test_mp4_prores_entries_take_their_tag(tmp_path):
    """The MOV ProRes entry is the decoder's tag (its depth), and the
    Matroska CodecPrivate too; frames in Matroska get back the 8 bytes of
    size and ``icpf`` that its muxer strips."""
    frames = sv.yuv_frames10(2, 48, 64, chroma=(0, 0))
    for container in ("mov", "mkv"):
        path = str(tmp_path / f"v.{container}")
        packets = sv.write_prores(path, frames, profile=4,
                                  container=container)
        with open(path, "rb") as f:
            read = (mp4 if container == "mov" else mkv).read_track(path, f)
            assert read.tag == b"ap4h"
            assert [d for d, _ in read.packets(f)] == [p for p, _ in packets]
