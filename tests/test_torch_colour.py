"""Video colour as cv2 gives it: the stream's colour matrix and range, and
10-bit 4:2:0 (HEVC Main 10, H.264 High 10, VP9 profile 2), on the CPU.

Each fixture is read by the JAX package's ``open_video`` (cv2 5.0's
``VideoCapture`` with ``CAP_PROP_ORIENTATION_AUTO``) and by the port's
``open_video(path, device="cpu")`` (libavcodec's planes and the
conversion kernels' plain versions): every frame equal, 0 pixels apart,
with cv2's frame count and fps.

- The colour a stream states in its bitstream (the H.264 and HEVC VUI:
  BT.709, BT.2020, FCC, SMPTE 240M, BT.601, limited and full range, the
  range alone) or its container (an MP4 ``colr`` box, ``nclx`` and
  QuickTime's ``nclc``; Matroska ``Colour``), the two disagreeing (the
  bitstream wins; HEVC's decoder drops the container's), and what cv2
  5.0 converts otherwise (other primaries, PQ and HLG, matrices swscale
  has no table for): refused by name (ROADMAP.md item 4i).
- 10-bit 4:2:0: PCM HEVC Main 10 (10-bit samples) in MP4, Matroska,
  MPEG-TS, M2TS and a program stream; I_PCM H.264 High 10 in MP4 and
  Matroska; VP9 profile 2 (the wheel's libvpx, lossless) in WebM and MP4,
  with Matroska's chroma siting.
- The rules themselves: ``yuv420_to_bgr_plain`` for each (matrix, range)
  against cv2 on a seeded sample of 4,096 (Y, U, V) triples, and on all
  2^24 (marked slow); ``yuv420p10_to_bgr_plain`` against cv2 on every Y
  at fixed chroma and on a sample of (U, V) pairs on flat luma (all 2^20
  marked slow), and against the wheel's libswscale itself (the general
  path cv2 5.0 runs: SWS_BICUBIC, the chroma location) at sizes and
  chroma locations cv2's decoders do not give.
- Every frame size (ROADMAP.md item 4i (a), fault F5): swscale picks its
  path by the output's parity (``kernels.frame_route``).  8-bit frames
  of an odd height take its general path (``general_to_bgr_plain`` at 8
  bits) and odd widths its full-chroma output
  (``full_chroma_to_bgr_plain``), each against libswscale at every pixel
  of random fields, every chroma location, and (full chroma) saturated
  fields where its 32-bit sums wrap; the committed odd-size VP9 fixtures
  read as cv2 5.0 reads them; frames under 9 rows or 8 columns on a
  scaling path refused by name.
"""

import cv2
import numpy as np
import pytest
import torch

from rtpose_tpu.demo import video_demo as jvideo_demo
from rtpose_tpu_torch.demo import scripted_video as sv
from rtpose_tpu_torch.demo.video_io import conversion, open_video
from rtpose_tpu_torch.native import avcodec
from rtpose_tpu_torch.ops import kernels
from rtpose_tpu_torch.ops.kernels import (yuv420_to_bgr_plain,
                                          yuv420p10_to_bgr_plain, yuv_rule)

C = sv.Colour
H, W = 32, 48
# every (matrix, range) the conversion has constants for
PAIRS = [(m, full) for m in (2, 1, 4, 7, 9) for full in (False, True)]


def _jax_read(path):
    """The JAX package's reader (cv2): frames, count, fps."""
    cap = jvideo_demo.open_video(str(path))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    props = (int(cap.get(cv2.CAP_PROP_FRAME_COUNT)), cap.get(cv2.CAP_PROP_FPS))
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


def _assert_reads_as_jax(path, n=None):
    """The port's frames, frame count and fps are the JAX package's."""
    want, (count, fps) = _jax_read(path)
    got, cap = _port_read(path)
    assert len(got) == len(want) > 0
    if n is not None:
        assert len(got) == n
    assert (cap.frame_count, cap.fps) == (count, fps)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, f"frame {i}"
        assert int((g != w).any(-1).sum()) == 0, f"frame {i}"
    return got


def _frames(depth=8, n=2, h=H, w=W, seed=19):
    return (sv.yuv_frames(n, h, w, seed=seed) if depth == 8
            else sv.yuv_frames10(n, h, w, seed=seed))


# -- the colour a stream states ---------------------------------------------

VUI = [C(1), C(1, True), C(9), C(9, True), C(4), C(4, True), C(7),
       C(7, True), C(6, True), C(None, True), C(1, False, 1, 1),
       C(9, False, 2, 14),
       # every other transfer and primaries video_io.conversion passes
       # (PLAIN_TRANSFERS, PLAIN_PRIMARIES), and matrices 5 and 6
       *(C(1, False, 1, t) for t in (4, 5, 6, 7, 8, 11, 12, 13, 15, 17)),
       *(C(1, False, p, 1) for p in (4, 5, 6, 7)),
       C(5, False, 5, 5), C(6, False, 6, 6)]


@pytest.mark.parametrize("codec", ["h264", "hevc"])
@pytest.mark.parametrize("colour", VUI, ids=lambda c: f"{c.matrix}-{c.full}"
                         f"-{c.primaries}-{c.transfer}")
def test_vui_colour_reads_as_cv2(tmp_path, codec, colour):
    """BT.709, BT.2020, FCC, SMPTE 240M and BT.601 (matrices 5 and 6) in
    the SPS's VUI, limited and full range (the range alone too), with
    each transfer and primaries that cv2 5.0 leaves to the matrix alone:
    H.264's full range comes out of libavcodec as ``yuvj420p``."""
    path = tmp_path / "v.mp4"
    if codec == "h264":
        sv.write_ipcm_mp4(str(path), _frames(), colour=colour)
    else:
        sv.write_hevc_mp4(str(path), sv.encode_hevc_pcm(_frames(),
                                                        colour=colour))
    _assert_reads_as_jax(path, 2)


def test_unsignalled_and_709_differ_as_cv2s_do(tmp_path):
    """The fault this closes: a BT.709 stream converted as BT.601 was up
    to 55 levels off cv2's; both now read as cv2 reads them, and they
    differ from each other as much."""
    plain, tagged = tmp_path / "a.mp4", tmp_path / "b.mp4"
    sv.write_ipcm_mp4(str(plain), _frames())
    sv.write_ipcm_mp4(str(tagged), _frames(), colour=C(1))
    a, b = _assert_reads_as_jax(plain), _assert_reads_as_jax(tagged)
    assert max(int(np.abs(x.astype(int) - y).max()) for x, y in zip(a, b)) \
        >= 40


COLR = [("nclx_709", C(1, False, 1, 1), b"nclx", None),
        ("nclx_709_full", C(1, True, 1, 1), b"nclx", None),
        ("nclx_170m", C(6, False, 6, 6), b"nclx", None),
        ("nclx_2020_full", C(9, True, 1, 14), b"nclx", None),
        ("nclc_709", C(1, False, 1, 1), b"nclc", None),
        ("nclc_240m", C(7, False, 7, 7), b"nclc", None),
        ("vui_wins", C(9, True, 1, 14), b"nclx", C(1)),
        ("vui_range_wins", C(1, True, 1, 1), b"nclx", C(None, False))]


@pytest.mark.parametrize("case", COLR, ids=[c[0] for c in COLR])
def test_colr_box_reads_as_cv2(tmp_path, case):
    """An ``avc1`` entry's ``colr``: libavformat hands it to the decoder,
    which keeps it where the SPS states none and takes the SPS's where
    the two disagree."""
    _, colour, kind, vui = case
    path = tmp_path / "v.mp4"
    sv.write_ipcm_mp4(str(path), _frames(), colour=vui,
                      colr=sv.colr_box(colour, kind))
    _assert_reads_as_jax(path, 2)


def test_hevc_decoder_drops_the_containers_colour(tmp_path):
    """HEVC's decoder resets the matrix and range where its VUI states
    none: a ``colr`` or ``Colour`` of BT.709 full range reads as BT.601
    limited, as cv2 reads it."""
    frames = _frames()
    mp4_path, mkv_path = tmp_path / "v.mp4", tmp_path / "v.mkv"
    stream = sv.encode_hevc_pcm(frames)
    sv.write_hevc_mp4(str(mp4_path), stream,
                      colr=sv.colr_box(C(1, True, 1, 1)))
    sv.write_hevc_mkv(str(mkv_path), stream, colour=C(1, True, 1, 1))
    for path in (mp4_path, mkv_path):
        got = _assert_reads_as_jax(path, 2)
        want = yuv420_to_bgr_plain(*map(torch.from_numpy, frames[0]),
                                   width=W).numpy()
        np.testing.assert_array_equal(got[0], want)


MKV = [("h264_709", "h264", C(1, False, 1, 1), None),
       ("h264_full", "h264", C(2, True), None),
       ("h264_fcc", "h264", C(4, False), None),
       ("h264_vui_wins", "h264", C(9, True), C(1)),
       ("hevc_vui", "hevc", C(7, True), C(1))]


@pytest.mark.parametrize("case", MKV, ids=[c[0] for c in MKV])
def test_matroska_colour_reads_as_cv2(tmp_path, case):
    """``Video/Colour`` (``MatrixCoefficients``, ``Range``, primaries,
    transfer), alone and beside a VUI that disagrees."""
    _, codec, colour, vui = case
    path = tmp_path / "v.mkv"
    if codec == "h264":
        sv.write_ipcm_mkv(str(path), _frames(), sps_colour=vui,
                          colour=colour)
    else:
        sv.write_hevc_mkv(str(path), sv.encode_hevc_pcm(_frames(),
                                                        colour=vui),
                          colour=colour)
    _assert_reads_as_jax(path, 2)


REFUSED = [("primaries_2020", C(9, False, 9, 14), "colour primaries 9"),
           ("pq", C(1, False, 1, 16), "transfer characteristics 16"),
           ("hlg", C(9, False, 1, 18), "transfer characteristics 18"),
           ("ycgco", C(8), r"colour matrix 8 \(YCgCo\)"),
           ("bt2020_cl", C(10), r"colour matrix 10 \(BT.2020 CL\)"),
           ("gbr", C(0), r"colour matrix 0 \(GBR")]


@pytest.mark.parametrize("case", REFUSED, ids=[c[0] for c in REFUSED])
def test_colour_cv2_converts_otherwise_is_refused(tmp_path, case):
    """What cv2 5.0 converts otherwise than by swscale's matrix alone (its
    swscale graph maps the gamut of other primaries and the tone of PQ
    and HLG, and refuses or misreads matrices without a table) is
    refused by name, not converted as BT.601."""
    _, colour, error = case
    path = tmp_path / "v.mp4"
    sv.write_ipcm_mp4(str(path), _frames(), colour=colour)
    cap = open_video(str(path), device="cpu")
    with pytest.raises(ValueError, match=f"{error}.*item 4i"):
        cap.read()
    cap.release()


# -- 10-bit 4:2:0 -----------------------------------------------------------

MAIN10 = [("mp4", C(9)), ("mp4_full", C(1, True)), ("mkv", None),
          ("ts", C(7)), ("m2ts", C(4, True)), ("mpg", None),
          ("vob", C(9, False, 2, 14))]


@pytest.mark.parametrize("case", MAIN10, ids=[c[0] for c in MAIN10])
def test_hevc_main10_reads_as_cv2(tmp_path, case):
    """PCM HEVC Main 10 (10-bit PCM samples) in MP4, Matroska, MPEG-TS,
    M2TS and program streams, tagged and not."""
    kind, colour = case
    stream = sv.encode_hevc_pcm(_frames(10, 3), depth=10, colour=colour)
    path = tmp_path / f"v.{kind.split('_')[0]}"
    if kind.startswith("mp4"):
        sv.write_hevc_mp4(str(path), stream)
    elif kind == "mkv":
        sv.write_hevc_mkv(str(path), stream)
    elif kind in ("ts", "m2ts"):
        sv.write_hevc_ts(str(path), stream,
                         packet_size=192 if kind == "m2ts" else 188)
    else:
        sv.write_hevc_ps(str(path), stream, psm=kind == "vob",
                         dvd=kind == "vob")
    _assert_reads_as_jax(path, 3)


@pytest.mark.parametrize("container,colour", [("mp4", None),
                                              ("mp4", C(1, True)),
                                              ("mkv", C(9))])
def test_h264_high10_reads_as_cv2(tmp_path, container, colour):
    """I_PCM H.264 High 10 (``profile_idc`` 110, 10-bit PCM samples)."""
    path = tmp_path / f"v.{container}"
    write = sv.write_ipcm_mp4 if container == "mp4" else sv.write_ipcm_mkv
    kw = {"colour": colour} if container == "mp4" else {"sps_colour": colour}
    write(str(path), _frames(10, 3), depth=10, **kw)
    _assert_reads_as_jax(path, 3)


@pytest.mark.parametrize("case", [("webm", None, None),
                                  ("webm", C(9, True), None),
                                  ("mp4", C(1), None),
                                  ("webm", None, (1, 2)),
                                  ("webm", C(4), (1, 1))])
def test_vp9_profile2_reads_as_cv2(tmp_path, case):
    """VP9 profile 2 from the wheel's libvpx (lossless: the decoder gives
    back the written 10-bit planes): its frame header's colour space and
    range; with Matroska's chroma siting (left, top left), which places
    the chroma cv2's swscale filters (VP9 states no location)."""
    container, colour, siting = case
    path = tmp_path / f"v.{container}"
    frames = _frames(10, 3)
    mux = {"chroma_siting": siting} if siting else {}
    sv.write_vp9(str(path), frames, colour=colour, container=container,
                 **mux)
    _assert_reads_as_jax(path, 3)
    decoder = avcodec.Decoder("vp9")
    try:
        from rtpose_tpu_torch.demo import mkv, mp4
        read = mp4.read_track if container == "mp4" else mkv.read_track
        with open(path, "rb") as f:
            track = read(str(path), f)
            data, key = next(track.packets(f))
        y, u, v, width = next(decoder.decode(data, key))
        assert y.dtype == np.uint16 and width == W
        np.testing.assert_array_equal(y[:H, :W], frames[0][0])
        np.testing.assert_array_equal(u[:H // 2, :W // 2], frames[0][1])
        assert decoder.colour.depth == 10
    finally:
        decoder.close()


def test_decoder_reads_back_what_the_stream_states():
    """The codec context's options after a frame: the VUI's matrix,
    range, primaries and transfer, H.264's left chroma, the bits."""
    s, p, units, keys = sv.encode_ipcm(_frames(10, 1), colour=C(9, True, 1,
                                                                14),
                                       depth=10)
    decoder = avcodec.Decoder("h264", avcodec.StreamColour(1, False))
    try:
        got = list(decoder.decode(sv.annexb(s, p, units), True))
        got += list(decoder.flush())
        assert len(got) == 1
        assert decoder.colour == avcodec.FrameColour(9, True, 1, 10, 1, 14)
    finally:
        decoder.close()
    assert conversion(decoder.colour) == (yuv_rule(9, True), 1)


# -- the rules against cv2 and swscale ---------------------------------------

def _triples_frame(y, u, v):
    """A frame whose 2x2 blocks each hold one (Y, U, V): Y over the
    block, (U, V) its chroma sample; the triples in blocks of 64 a row."""
    n = len(y)
    rows = -(-n // 64)
    pad = rows * 64 - n
    y, u, v = (np.concatenate([a, np.full(pad, 128, np.uint8)]).reshape(
        rows, 64) for a in (y, u, v))
    return np.repeat(np.repeat(y, 2, 0), 2, 1), u, v


def _sweep(tmp_path, matrix, full, triples):
    """cv2's frames of I_PCM streams of the triples against the plain
    conversion of the same planes (64 triples a row, 4,096 a frame)."""
    per = 64 * 64
    frames = [_triples_frame(*(c[k:k + per] for c in triples))
              for k in range(0, len(triples[0]), per)]
    path = tmp_path / "sweep.mp4"
    sv.write_ipcm_mp4(str(path), frames, colour=C(matrix, full))
    got, _ = _jax_read(path)
    assert len(got) == len(frames)
    rule = yuv_rule(matrix, full)
    for frame, planes in zip(got, frames):
        want = yuv420_to_bgr_plain(*map(torch.from_numpy, planes),
                                   width=128, rule=rule).numpy()
        np.testing.assert_array_equal(frame, want)


@pytest.mark.parametrize("matrix,full", PAIRS)
def test_plain_8bit_rule_equals_cv2_on_a_sample(tmp_path, matrix, full):
    """4,096 seeded (Y, U, V) triples of each (matrix, range)."""
    rng = np.random.RandomState(4096 + 10 * matrix + full)
    triples = [rng.randint(0, 256, 4096).astype(np.uint8) for _ in range(3)]
    _sweep(tmp_path, matrix, full, triples)


@pytest.mark.slow
@pytest.mark.parametrize("matrix,full", [p for p in PAIRS if p != (2, False)])
def test_plain_8bit_rule_equals_cv2_on_every_triple(tmp_path, matrix, full):
    """All 2^24 (Y, U, V) of each (matrix, range) (BT.601 limited:
    tests/test_torch_mp4.py), in 64 I_PCM 512x512 frames."""
    uu, vv = np.meshgrid(np.arange(256, dtype=np.uint8),
                         np.arange(256, dtype=np.uint8), indexing="ij")
    frames = []
    for k in range(64):
        y = np.empty((512, 512), np.uint8)
        for j, (dy, dx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
            y[dy::2, dx::2] = 4 * k + j
        frames.append((y, uu, vv))
    path = tmp_path / "all.mp4"
    sv.write_ipcm_mp4(str(path), frames, colour=C(matrix, full))
    got, _ = _jax_read(path)
    assert len(got) == 64
    rule = yuv_rule(matrix, full)
    for frame, planes in zip(got, frames):
        want = yuv420_to_bgr_plain(*map(torch.from_numpy, planes),
                                   width=512, rule=rule)
        np.testing.assert_array_equal(frame, want.numpy())


def _p10_against_cv2(tmp_path, frames, colour):
    """cv2's frames of a PCM HEVC Main 10 stream against the 10-bit plain
    conversion of the written planes."""
    path = tmp_path / "p10.mp4"
    sv.write_hevc_mp4(str(path), sv.encode_hevc_pcm(frames, depth=10,
                                                    colour=colour))
    got, _ = _jax_read(path)
    assert len(got) == len(frames)
    rule = yuv_rule(2 if colour is None else colour.matrix,
                    colour is not None and colour.full)
    for frame, planes in zip(got, frames):
        h, w = planes[0].shape
        want = yuv420p10_to_bgr_plain(*map(torch.from_numpy, planes),
                                      width=w, rule=rule).numpy()
        np.testing.assert_array_equal(frame, want)


@pytest.mark.parametrize("matrix,full", PAIRS)
def test_plain_10bit_rule_equals_cv2_on_every_luma(tmp_path, matrix, full):
    """Every 10-bit Y (a ramp of 1,024 across each row) over flat chroma
    at five (U, V), and random chroma under it."""
    y = np.tile(np.arange(1024, dtype=np.uint16), (16, 1))
    frames = [(y, np.full((8, 512), cu, np.uint16),
               np.full((8, 512), cv, np.uint16))
              for cu, cv in ((512, 512), (0, 1023), (1023, 0), (64, 64),
                             (960, 960))]
    rng = np.random.RandomState(matrix)
    frames.append((y, *(rng.randint(0, 1024, (8, 512)).astype(np.uint16)
                        for _ in range(2))))
    _p10_against_cv2(tmp_path, frames, C(matrix, full))


@pytest.mark.parametrize("matrix,full", PAIRS)
def test_plain_10bit_rule_equals_cv2_on_chroma(tmp_path, matrix, full):
    """A seeded sample of 4,096 (U, V) pairs on flat luma, and random
    fields (the chroma filters)."""
    rng = np.random.RandomState(1024 + 10 * matrix + full)
    u = rng.randint(0, 1024, (64, 64)).astype(np.uint16)
    v = rng.randint(0, 1024, (64, 64)).astype(np.uint16)
    frames = [(np.full((128, 128), luma, np.uint16), u, v)
              for luma in (64, 502, 940)]
    frames += sv.yuv_frames10(2, 128, 128, seed=matrix)
    _p10_against_cv2(tmp_path, frames, C(matrix, full))


@pytest.mark.slow
@pytest.mark.parametrize("matrix,full", PAIRS)
def test_plain_10bit_rule_equals_cv2_on_every_chroma_pair(tmp_path, matrix,
                                                          full):
    """All 2^20 (U, V) pairs (a 1024x1024 chroma plane) on flat luma."""
    u, v = np.meshgrid(np.arange(1024, dtype=np.uint16),
                       np.arange(1024, dtype=np.uint16), indexing="ij")
    frames = [(np.full((2048, 2048), luma, np.uint16), u, v)
              for luma in (64, 940)]
    _p10_against_cv2(tmp_path, frames, C(matrix, full))


def _swscale(y, u, v, matrix, full, location, depth=None):
    """The wheel's libswscale on 4:2:0 planes (``yuv420p`` for uint8,
    ``yuv420p10le`` for uint16, of `depth` bits where given), as cv2 5.0
    sets it up: SWS_BICUBIC to bgr24, the source chroma at the frame's
    location, the frame's matrix and range
    (``scripts/torch_probe_video.py`` ``swscale_bgr24``)."""
    import importlib
    import os
    import sys
    scripts = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    probe = importlib.import_module("torch_probe_video")
    return probe.swscale_bgr24(y, u, v, matrix, full, location, depth)


@pytest.mark.parametrize("size", [(9, 8), (31, 64), (48, 66), (120, 160)])
@pytest.mark.parametrize("location", range(7))
def test_plain_10bit_rule_equals_swscale(size, location):
    """Against libswscale itself at odd heights, narrow widths and every
    chroma location (0 unspecified, 1 left, ... 6 bottom), for a few
    (matrix, range): random fields, every pixel."""
    h, w = size
    rng = np.random.RandomState(h * 7 + location)
    y = rng.randint(0, 1024, (h, w)).astype(np.uint16)
    u, v = (rng.randint(0, 1024, ((h + 1) // 2, w // 2)).astype(np.uint16)
            for _ in range(2))
    for matrix, full in ((2, False), (1, True), (9, False)):
        want = _swscale(y, u, v, matrix, full, location)
        got = yuv420p10_to_bgr_plain(*map(torch.from_numpy, (y, u, v)),
                                     width=w, rule=yuv_rule(matrix, full),
                                     chroma_location=location).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rotation", kernels.ROTATIONS)
def test_10bit_turns_as_the_8bit_one(rotation):
    """The turn is cv2's cv::rotate of the upright frame."""
    planes = [torch.from_numpy(p) for p in sv.yuv_frames10(1, 18, 24)[0]]
    upright = yuv420p10_to_bgr_plain(*planes, width=24).numpy()
    turned = kernels.yuv420p10_to_bgr(*planes, width=24, rotation=rotation)
    code = {90: cv2.ROTATE_90_CLOCKWISE, 180: cv2.ROTATE_180,
            270: cv2.ROTATE_90_COUNTERCLOCKWISE}.get(rotation)
    want = upright if code is None else cv2.rotate(upright, code)
    np.testing.assert_array_equal(turned.numpy(), want)


def test_rules_refuse_what_they_do_not_convert():
    """A matrix without a table and a picture too small for the scaling
    path are refused by name; an odd width, refused until swscale's
    full-chroma output was ported, is converted as swscale converts it."""
    with pytest.raises(ValueError, match=r"colour matrix 3 \(reserved\)"):
        yuv_rule(3)
    planes = [torch.from_numpy(p) for p in sv.yuv_frames10(1, 8, 16)[0]]
    with pytest.raises(ValueError, match=r"heights of at least 9.*4i \(a\)"):
        yuv420p10_to_bgr_plain(*planes, width=16)
    planes = _frames(10, 1, 10, 15, seed=15)[0]
    got = kernels.yuv420_frame_to_bgr(*map(torch.from_numpy, planes),
                                      depth=10, width=15, chroma_location=0)
    np.testing.assert_array_equal(got.numpy(),
                                  _swscale(*planes, 2, False, 0))
    assert yuv_rule(2) == kernels.BT601_LIMITED
    assert yuv_rule(2, False)[2:7] == (9539, 16525, -3209, -6660, 13075)
    assert yuv_rule(1, True)[2:8] == (8192, 15201, -1534, -3835, 12901, 0)


# -- every frame size: swscale's path by the output's parity ----------------

SWS_PAIRS = ((2, False), (1, True), (9, False))


@pytest.mark.parametrize("size", [(9, 8), (31, 48), (33, 64), (479, 640)])
@pytest.mark.parametrize("location", range(7))
def test_plain_8bit_general_rule_equals_swscale(size, location):
    """8-bit frames of an odd height take swscale's general path (its
    unscaled yuv420p -> bgr24 wants an even output height): the 10-bit
    rule with the 8-bit shifts, against libswscale at every pixel of
    random fields, each chroma location and three (matrix, range)."""
    h, w = size
    planes = _frames(8, 1, h, w, seed=h * 7 + location)[0]
    assert kernels.frame_route(kernels.CHROMA_420, 8, h, w) == "general"
    for matrix, full in SWS_PAIRS:
        got = kernels.general_to_bgr_plain(
            *map(torch.from_numpy, planes), width=w, depth=8,
            rule=yuv_rule(matrix, full), chroma_location=location)
        np.testing.assert_array_equal(
            got.numpy(), _swscale(*planes, matrix, full, location))


@pytest.mark.parametrize("depth,size", [(8, (9, 9)), (8, (31, 47)),
                                        (8, (31, 65)), (10, (10, 15)),
                                        (10, (32, 47)), (10, (48, 65))])
@pytest.mark.parametrize("location", range(7))
def test_plain_full_chroma_rule_equals_swscale(depth, size, location):
    """An odd width: swscale forces full internal horizontal chroma and
    converts each pixel through yuv2rgb_full_X_c, on every row."""
    h, w = size
    planes = _frames(depth, 1, h, w, seed=h * w + location)[0]
    route = kernels.frame_route(kernels.CHROMA_420, depth, h, w)
    assert route == "full_chroma"
    for matrix, full in SWS_PAIRS:
        got = kernels.full_chroma_to_bgr_plain(
            *map(torch.from_numpy, planes), width=w, depth=depth,
            rule=yuv_rule(matrix, full), chroma_location=location)
        np.testing.assert_array_equal(
            got.numpy(), _swscale(*planes, matrix, full, location))


@pytest.mark.parametrize("depth", kernels.DEPTHS)
def test_full_chroma_wraps_as_swscale_does(depth):
    """Flat fields of the extreme samples at every (matrix, range): the
    full-chroma output sums in 32-bit unsigned arithmetic, so a bright
    pixel of strong chroma wraps (BT.709 limited, Y and U at their top:
    blue 0, not 255), in swscale and in the rule alike."""
    top = (1 << depth) - 1
    dtype = np.uint8 if depth == 8 else np.uint16
    wrapped = 0
    for yv, uv, vv in np.ndindex(2, 2, 2):
        y = np.full((11, 13), top * yv, dtype)
        u, v = (np.full((6, 7), top * c, dtype) for c in (uv, vv))
        for matrix, full in PAIRS:
            want = _swscale(y, u, v, matrix, full, 0, depth)
            got = kernels.full_chroma_to_bgr_plain(
                *map(torch.from_numpy, (y, u, v)), width=13, depth=depth,
                rule=yuv_rule(matrix, full), chroma_location=0)
            np.testing.assert_array_equal(got.numpy(), want)
            wrapped += int(yv == uv == 1 and want[0, 0, 0] == 0)
    assert wrapped > 0


ROUTES = [(8, 32, 48, "unscaled"), (8, 32, 47, "unscaled"),
          (8, 2, 2, "unscaled"), (8, 31, 48, "general"),
          (8, 31, 47, "full_chroma"), (10, 32, 48, "general"),
          (10, 31, 48, "general"), (10, 32, 47, "full_chroma"),
          (10, 9, 9, "full_chroma"), (8, 9, 8, "general")]


@pytest.mark.parametrize("depth,h,w,route", ROUTES)
def test_route_follows_swscales_parity_rules(depth, h, w, route):
    assert kernels.frame_route(kernels.CHROMA_420, depth, h, w) == route


@pytest.mark.parametrize("depth,h,w", [(8, 7, 16), (8, 31, 6), (8, 9, 7),
                                       (10, 8, 16), (10, 16, 7),
                                       (10, 2, 2)])
def test_small_frames_on_a_scaling_route_are_refused_by_name(depth, h, w):
    """Under 9 rows or 8 columns swscale's scaling path takes its two-tap
    vertical filter and narrow horizontal ones: refused, naming ROADMAP
    item 4i (a), by the route and by every conversion."""
    with pytest.raises(ValueError, match=r"item 4i \(a\)"):
        kernels.frame_route(kernels.CHROMA_420, depth, h, w)
    planes = [torch.from_numpy(p) for p in _frames(depth, 1, h, w, 1)[0]]
    with pytest.raises(ValueError, match=r"item 4i \(a\)"):
        kernels.yuv420_frame_to_bgr(*planes, depth=depth, width=w)


def test_small_odd_height_video_is_refused_by_name(tmp_path):
    """An 8-bit VP9 file of 7 rows, which the unscaled rule converted
    wrongly, is refused by the reader."""
    path = tmp_path / "v.webm"
    sv.write_vp9(str(path), sv.yuv_frames(2, 7, 16))
    cap = open_video(str(path), device="cpu")
    with pytest.raises(ValueError, match=r"v\.webm: .*item 4i \(a\)"):
        cap.read()
    cap.release()


@pytest.mark.parametrize("fixture", sv.ODD_SIZE_FIXTURES,
                         ids=[f.name for f in sv.ODD_SIZE_FIXTURES])
def test_odd_size_fixtures_read_as_cv2(fixture):
    """The committed lossless VP9 files of odd sizes (8-bit 31x48, 33x64
    and 31x47, fault F5's; 479x640; 10-bit 32x47 and 31x65, BT.709 full
    range; Matroska chroma siting): frames, count and fps as cv2 5.0
    reads them, and the decoder gives back the written planes."""
    path = sv.odd_size_path(fixture)
    got = _assert_reads_as_jax(path, fixture.frames)
    assert got[0].shape == (fixture.height, fixture.width, 3)
    decoder = avcodec.Decoder("vp9")
    try:
        from rtpose_tpu_torch.demo import mkv
        with open(path, "rb") as f:
            track = mkv.read_track(path, f)
            data, key = next(track.packets(f))
        y, u, v, width = next(decoder.decode(data, key))
        planes = sv.odd_size_frames(fixture)[0]
        h, cw = fixture.height, (fixture.width + 1) // 2
        np.testing.assert_array_equal(y[:h, :width], planes[0])
        np.testing.assert_array_equal(u[:(h + 1) // 2, :cw], planes[1])
        assert decoder.colour.depth == fixture.depth
    finally:
        decoder.close()


def test_odd_height_frames_were_wrong_under_the_unscaled_rule():
    """Fault F5: the unscaled rule that every 8-bit frame took before is
    far from cv2's frames at an odd height; the routed conversion is
    not."""
    fixture = sv.ODD_SIZE_FIXTURES[1]
    assert (fixture.height, fixture.width) == (33, 64)
    want, _ = _jax_read(sv.odd_size_path(fixture))
    planes = [torch.from_numpy(p) for p in sv.odd_size_frames(fixture)[0]]
    old = yuv420_to_bgr_plain(*planes, width=64).numpy()
    assert (old != want[0]).any(-1).mean() > 0.5
    new = kernels.yuv420_frame_to_bgr(*planes, depth=8, width=64,
                                      chroma_location=0).numpy()
    np.testing.assert_array_equal(new, want[0])


@pytest.mark.parametrize("size", [(479, 640), (479, 639), (33, 64),
                                  (31, 47)])
def test_odd_size_mpeg4_reads_as_cv2(tmp_path, size):
    """MPEG-4 Part 2 states any size in its VOL: the wheel's ``mpeg4``
    encoder at an odd height (the general path) and at odd heights and
    widths (full chroma), in Matroska, reads as cv2 5.0 reads it."""
    h, w = size
    path = tmp_path / "v.mkv"
    sv.write_mpeg4_mkv(str(path), sv.scene_frames(range(3), h, w))
    got = _assert_reads_as_jax(path, 3)
    assert got[0].shape == (h, w, 3)
