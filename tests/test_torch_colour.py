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
"""

import ctypes

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
       C(9, False, 2, 14)]


@pytest.mark.parametrize("codec", ["h264", "hevc"])
@pytest.mark.parametrize("colour", VUI, ids=lambda c: f"{c.matrix}-{c.full}"
                         f"-{c.primaries}-{c.transfer}")
def test_vui_colour_reads_as_cv2(tmp_path, codec, colour):
    """BT.709, BT.2020, FCC, SMPTE 240M and BT.601 in the SPS's VUI,
    limited and full range (the range alone too): H.264's full range
    comes out of libavcodec as ``yuvj420p``."""
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


def _swscale_p10(y, u, v, matrix, full, location):
    """The wheel's libswscale on 10-bit planes, as cv2 5.0 sets it up:
    SWS_BICUBIC to bgr24, the source chroma at the frame's location, the
    frame's matrix and range."""
    from rtpose_tpu_torch.native.avencode import encoder_libraries
    libs = encoder_libraries()
    sws, au = libs.swscale, libs.avutil
    P, I = ctypes.c_void_p, ctypes.c_int
    sws.sws_alloc_context.restype = P
    sws.sws_init_context.argtypes = [P, P, P]
    sws.sws_getCoefficients.restype = P
    sws.sws_getCoefficients.argtypes = [I]
    sws.sws_setColorspaceDetails.argtypes = [P, P, I, P, I, I, I, I]
    sws.sws_scale.argtypes = [P, P, P, I, I, P, P]
    sws.sws_freeContext.argtypes = [P]
    h, w = y.shape
    x_pos, y_pos = kernels._chroma_pos(location)
    ctx = sws.sws_alloc_context()
    for name, value in (("srcw", w), ("srch", h), ("dstw", w), ("dsth", h),
                        ("src_format", au.av_get_pix_fmt(b"yuv420p10le")),
                        ("dst_format", au.av_get_pix_fmt(b"bgr24")),
                        ("sws_flags", 4), ("src_h_chr_pos", x_pos),
                        ("src_v_chr_pos", y_pos)):
        assert au.av_opt_set_int(ctx, name.encode(), value, 0) >= 0
    assert sws.sws_init_context(ctx, None, None) >= 0
    assert sws.sws_setColorspaceDetails(
        ctx, sws.sws_getCoefficients(matrix), int(full),
        sws.sws_getCoefficients(1), 1, 0, 1 << 16, 1 << 16) >= 0
    planes = [np.ascontiguousarray(p) for p in (y, u, v)]
    out = np.zeros((h, 3 * w + 64), np.uint8)
    sws.sws_scale(ctx, (P * 4)(*[p.ctypes.data for p in planes], None),
                  (I * 4)(*[p.strides[0] for p in planes], 0), 0, h,
                  (P * 4)(out.ctypes.data, None, None, None),
                  (I * 4)(out.strides[0], 0, 0, 0))
    sws.sws_freeContext(ctx)
    return out[:, :3 * w].reshape(h, w, 3)


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
        want = _swscale_p10(y, u, v, matrix, full, location)
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
    with pytest.raises(ValueError, match=r"colour matrix 3 \(reserved\)"):
        yuv_rule(3)
    planes = [torch.from_numpy(p) for p in sv.yuv_frames10(1, 8, 16)[0]]
    with pytest.raises(ValueError, match="heights of at least 9"):
        yuv420p10_to_bgr_plain(*planes, width=16)
    planes = [torch.zeros(s, dtype=torch.uint16)
              for s in ((10, 15), (5, 8), (5, 8))]
    with pytest.raises(ValueError, match="even widths"):
        kernels.yuv420p10_to_bgr(*planes, width=15)
    assert yuv_rule(2) == kernels.BT601_LIMITED
    assert yuv_rule(2, False)[2:7] == (9539, 16525, -3209, -6660, 13075)
    assert yuv_rule(1, True)[2:8] == (8192, 15201, -1534, -3835, 12901, 0)
