"""Probe the two routes a machine offers the port's video reader.

- NVDEC: whether the driver's ``libnvcuvid.so.1`` loads, and what
  ``cuvidGetDecoderCaps`` answers for H.264 and MPEG-4 Part 2, 8-bit
  4:2:0, on the primary context PyTorch made current (the result code,
  and the caps of a codec it supports: the largest and smallest sizes,
  the decoders, whether 640x480 fits).
- The host: the FFmpeg ``libavcodec`` the OpenCV wheel bundles
  (``rtpose_tpu_torch/native/avcodec.py``, the route the reader takes):
  its path, whether it opens the H.264, HEVC, MPEG-4, VP8, VP9, MPEG-1,
  MPEG-2 and Motion-JPEG decoders (and the AV1 decoder the reader still
  refuses),
  whether the ``mpegvideo``, ``mpeg4video``, ``h264`` and ``hevc``
  parsers initialise, and the libavcodec, libavutil and libswscale
  versions; and what the XVID writer needs
  (``rtpose_tpu_torch/native/avencode.py``): the ``mpeg4`` encoder, its
  options (``av_opt_find``), ``sws_getContext`` and an encoder that
  opens.
- Colour (ROADMAP.md items 4h, 4i): whether the codec context has the
  options the reader sets and reads (``colorspace``, ``color_range``,
  ``chroma_sample_location``, ``color_primaries``, ``color_trc``) and
  the libavutil major; what the decoder settles (``FrameColour``, the
  pixel format: ``yuvj420p`` for full-range H.264) on small fixtures of
  ``demo/scripted_video.py`` that state their colour in the H.264 /
  HEVC VUI, an MP4 ``colr`` (``nclx``, ``nclc``), Matroska ``Colour``
  (one where container and bitstream disagree), and on 10-bit ones
  (PCM HEVC Main 10, I_PCM H.264 High 10, VP9 profile 2); and, where the
  machine has cv2, the largest difference of cv2's frames from the
  port's rule for the colour the decoder settled (``rule``: cv2 5.0's),
  from BT.601 limited (``bt601``: a cv2 that ignores the signalling)
  and, for 10-bit frames, from the rule with the chroma at the centre
  (``centre``) and from the 8-bit rule on the top 8 bits with nearest
  chroma (``nearest8``).
- Odd sizes (ROADMAP.md item 4i (a)): the machine's libswscale (legacy
  ``sws_scale`` with cv2's settings: SWS_BICUBIC to bgr24, the chroma
  location, the matrix and range) on random planes at odd heights and
  widths, 8- and 10-bit, against the port's plain rule of the path
  ``ops.kernels.frame_route`` picks (``rules``: the largest difference
  at each size over three (chroma location, matrix, range): unspecified
  BT.601 limited, left BT.709 full, top left BT.2020 limited);
  and, where the machine has cv2, its frames of the committed odd-size
  fixtures (``demo/scripted_video.py`` ``ODD_SIZE_FIXTURES``) against
  the port's CPU read (``fixtures``).
- Chroma formats (ROADMAP.md item 4i (d), ``formats``): the machine's
  libswscale against the port's rules on 4:2:0, 4:2:2, 4:4:0, 4:4:4 and
  4:0:0 planes at 8, 10 and 12 bits, every parity of height and width
  and 9x8 (``rules``: the route and the largest difference), and, where
  the machine has cv2, its frames of the committed chroma-format VP9
  fixtures and of PCM HEVC RExt / H.264 High 4:2:2 files against the
  port's CPU read (``fixtures``, ``files``).
- Motion-JPEG and VP8 (ROADMAP.md item 4j (a), (b), fault F6,
  ``mjpeg_vp8``): whether the wheel's ``mjpeg`` and ``vp8`` decoders open
  and what each settles on a small file (the pixel format and
  ``FrameColour``); where the machine has cv2, the backend a bare
  ``cv2.VideoCapture(path)`` picks for a Motion-JPEG AVI (``backend``:
  the JAX demo's reader; FFMPEG decodes with libavcodec), and its frames,
  count and fps of the committed VP8 fixtures (``scripted_video``
  ``VP8_FIXTURES``) and of Motion-JPEG files of the repository's writers
  (``mjpeg_files``: Pillow's 4:2:0, 4:2:2, 4:4:4 and gray JPEGs in AVI,
  MOV, MP4 and Matroska, without Huffman tables too) against the port's
  CPU read.
- cv2's writer's codecs and ProRes (ROADMAP.md item 4j (c), (d),
  ``cv2_writer``): whether the wheel's ``rawvideo``, ``msmpeg4v2``,
  ``msmpeg4``, ``wmv1``, ``wmv2``, ``flv``, ``huffyuv``, ``ffvhuff``,
  ``ffv1`` and ``prores`` decoders open and it has the ``prores``
  encoder; where the machine has cv2, its frames, count and fps of the
  files its own ``VideoWriter`` writes of each fourcc in AVI and Matroska
  and of ProRes 422 / 4444 MOV and Matroska (``cv2_writer_files``)
  against the port's CPU read.
- AV1 (ROADMAP.md item 4f): every AV1 decoder the wheel's libavcodec
  registers (``av_codec_iterate``), what each makes of a scripted AV1
  still (``demo/scripted_video.py`` ``av1_still``: a temporal delimiter,
  a reduced still picture sequence header and a frame), and what the
  machine's cv2 reads of it in Matroska (``V_AV1``), where cv2 is
  installed.

    python3 scripts/torch_probe_video.py

Prints ``SUMMARY {...}``.  Needs no card (NVDEC then reads "no CUDA
card").
"""

from __future__ import annotations

import ctypes
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CODECS = {"h264": 4, "mpeg4": 2}      # cudaVideoCodec
CHROMA_420 = 1                        # cudaVideoChromaFormat_420


class DecoderCaps(ctypes.Structure):
    """CUVIDDECODECAPS (cuviddec.h), 88 bytes."""
    _fields_ = [("eCodecType", ctypes.c_int), ("eChromaFormat", ctypes.c_int),
                ("nBitDepthMinus8", ctypes.c_uint),
                ("reserved1", ctypes.c_uint * 3),
                ("bIsSupported", ctypes.c_ubyte),
                ("nNumNVDECs", ctypes.c_ubyte),
                ("nOutputFormatMask", ctypes.c_ushort),
                ("nMaxWidth", ctypes.c_uint), ("nMaxHeight", ctypes.c_uint),
                ("nMaxMBCount", ctypes.c_uint),
                ("nMinWidth", ctypes.c_ushort),
                ("nMinHeight", ctypes.c_ushort),
                ("bIsHistogramSupported", ctypes.c_ubyte),
                ("nCounterBitDepth", ctypes.c_ubyte),
                ("nMaxHistogramBins", ctypes.c_ushort),
                ("reserved3", ctypes.c_uint * 10)]


def probe_nvdec(width: int = 640, height: int = 480) -> dict:
    import torch
    if not torch.cuda.is_available():
        return {"library": None, "error": "no CUDA card"}
    try:
        lib = ctypes.CDLL("libnvcuvid.so.1")
    except OSError as e:
        return {"library": None, "error": str(e)}
    torch.zeros(1, device="cuda")          # the primary context, current
    ctx = ctypes.c_void_p()
    ctypes.CDLL("libcuda.so.1").cuCtxGetCurrent(ctypes.byref(ctx))
    out = {"library": "libnvcuvid.so.1", "context": bool(ctx.value)}
    for name, codec in CODECS.items():
        caps = DecoderCaps(eCodecType=codec, eChromaFormat=CHROMA_420)
        rc = lib.cuvidGetDecoderCaps(ctypes.byref(caps))
        entry = {"result": rc, "supported": bool(caps.bIsSupported)}
        if rc == 0 and caps.bIsSupported:
            entry.update(
                decoders=caps.nNumNVDECs, max=[caps.nMaxWidth,
                                               caps.nMaxHeight],
                min=[caps.nMinWidth, caps.nMinHeight],
                fits=(caps.nMinWidth <= width <= caps.nMaxWidth
                      and caps.nMinHeight <= height <= caps.nMaxHeight))
        out[name] = entry
    return out


def probe_host() -> dict:
    sys.path.insert(0, ROOT)
    from rtpose_tpu_torch.native import avcodec
    try:
        out = {"library": avcodec.libraries().path}
    except (RuntimeError, OSError) as e:
        return {"library": None, "error": str(e)}
    # the decoders that want a container's size or tag first are opened
    # with them by probe_cv2_writer
    for name in (c for c in avcodec.CODECS
                 if c not in avcodec.CONTAINER_PARAMS):
        try:
            avcodec.Decoder(name).close()
            out[name] = "opens"
        except RuntimeError as e:
            out[name] = str(e)
    libs = avcodec.libraries()
    for name in UNREAD_DECODERS:
        out[name] = _opens(libs, name)
    out["parsers"] = {}
    for name, parser in avcodec.PARSERS.items():
        try:
            avcodec.Parser(name).close()
            out["parsers"][name] = f"{parser} initialises"
        except RuntimeError as e:
            out["parsers"][name] = str(e)
    return out


# decoders the reader refuses, probed so that ROADMAP.md item 4f (AV1)
# starts from what the machine's library has
UNREAD_DECODERS = ("av1",)


def _opens(libs, name: str) -> str:
    """Whether the library finds and opens the decoder `name`."""
    av = libs.avcodec
    found = av.avcodec_find_decoder_by_name(name.encode())
    if not found:
        return "no such decoder"
    ctx = ctypes.c_void_p(av.avcodec_alloc_context3(found))
    err = av.avcodec_open2(ctx, found, None)
    av.avcodec_free_context(ctypes.byref(ctx))
    return "opens" if err >= 0 else f"avcodec_open2: {libs.error(err)}"


ENCODER_OPTIONS = ("time_base", "video_size", "pixel_format", "b", "g",
                   "qmin", "bf", "codec_tag")


def _version(v: int) -> str:
    return f"{v >> 16}.{(v >> 8) & 0xFF}.{v & 0xFF}"


def probe_writer() -> dict:
    """The XVID writer's pieces in the wheel's libraries."""
    sys.path.insert(0, ROOT)
    from rtpose_tpu_torch.native import avencode
    try:
        libs = avencode.encoder_libraries()
    except (RuntimeError, OSError) as e:
        return {"error": str(e)}
    av, au, sws = libs.avcodec, libs.avutil, libs.swscale
    for lib, name in ((av, "avcodec_version"), (au, "avutil_version"),
                      (sws, "swscale_version")):
        getattr(lib, name).restype = ctypes.c_uint
    au.av_opt_find.restype = ctypes.c_void_p
    au.av_opt_find.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                               ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    out = {"versions": {"libavcodec": _version(av.avcodec_version()),
                        "libavutil": _version(au.avutil_version()),
                        "libswscale": _version(sws.swscale_version())},
           "sws_getContext": hasattr(sws, "sws_getContext"),
           "mpeg4_encoder": bool(av.avcodec_find_encoder_by_name(b"mpeg4"))}
    if out["mpeg4_encoder"]:
        ctx = ctypes.c_void_p(av.avcodec_alloc_context3(
            av.avcodec_find_encoder_by_name(b"mpeg4")))
        out["options"] = {name: bool(au.av_opt_find(ctx, name.encode(),
                                                    None, 0, 0))
                          for name in ENCODER_OPTIONS}
        av.avcodec_free_context(ctypes.byref(ctx))
        try:
            avencode.Encoder(64, 48, 20.0).close()
            out["encoder"] = "opens"
        except RuntimeError as e:
            out["encoder"] = str(e)
    return out


class _Codec(ctypes.Structure):
    """AVCodec's leading fields (unmoved since FFmpeg 0.x)."""
    _fields_ = [("name", ctypes.c_char_p), ("long_name", ctypes.c_char_p),
                ("type", ctypes.c_int), ("id", ctypes.c_int)]


def _decode_once(libs, codec: int, data: bytes) -> str:
    """What decoder `codec` (an AVCodec pointer) makes of one packet."""
    from rtpose_tpu_torch.native import avcodec
    av, au = libs.avcodec, libs.avutil
    ctx = ctypes.c_void_p(av.avcodec_alloc_context3(codec))
    packet = ctypes.c_void_p(av.av_packet_alloc())
    frame = ctypes.c_void_p(au.av_frame_alloc())
    try:
        err = av.avcodec_open2(ctx, codec, None)
        if err < 0:
            return f"avcodec_open2: {libs.error(err)}"
        buf = ctypes.create_string_buffer(data, len(data))
        pkt = avcodec._Packet.from_address(packet.value)
        pkt.data, pkt.size, pkt.flags = ctypes.addressof(buf), len(data), 1
        sent = av.avcodec_send_packet(ctx, packet)
        pkt.data, pkt.size = None, 0
        av.avcodec_send_packet(ctx, None)
        got = av.avcodec_receive_frame(ctx, frame)
        if got >= 0:
            f = avcodec._Frame.from_address(frame.value)
            return f"decoded a {f.width}x{f.height} frame (format {f.format})"
        return (f"send: {libs.error(sent) if sent < 0 else 'ok'}; receive: "
                f"{libs.error(got)}")
    finally:
        au.av_frame_free(ctypes.byref(frame))
        av.av_packet_free(ctypes.byref(packet))
        av.avcodec_free_context(ctypes.byref(ctx))


def probe_av1() -> dict:
    """ROADMAP.md item 4f: the wheel's AV1 decoders, each one's result on
    a scripted AV1 still, and cv2's read of it in Matroska."""
    import tempfile

    sys.path.insert(0, ROOT)
    from rtpose_tpu_torch.demo import scripted_video as sv
    from rtpose_tpu_torch.native import avcodec
    try:
        libs = avcodec.libraries()
    except (RuntimeError, OSError) as e:
        return {"error": str(e)}
    av = libs.avcodec
    av.av_codec_iterate.restype = ctypes.c_void_p
    av.av_codec_iterate.argtypes = [ctypes.POINTER(ctypes.c_void_p)]
    av.av_codec_is_decoder.argtypes = [ctypes.c_void_p]
    av1_id = ctypes.c_int.from_address(
        av.avcodec_descriptor_get_by_name(b"av1")).value
    unit, _ = sv.av1_still()
    out = {"decoders": {}}
    opaque = ctypes.c_void_p()
    while True:
        codec = av.av_codec_iterate(ctypes.byref(opaque))
        if not codec:
            break
        c = _Codec.from_address(codec)
        if c.id == av1_id and av.av_codec_is_decoder(codec):
            out["decoders"][c.name.decode()] = _decode_once(libs, codec,
                                                            unit)
    try:
        import cv2
    except ImportError:
        out["cv2"] = "no cv2 on this machine"
        return out
    build = os.path.join(ROOT, "rtpose_tpu_torch", "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as work:
        path = os.path.join(work, "av1.mkv")
        sv.write_av1_mkv(path)
        cap = cv2.VideoCapture(path)
        frames = 0
        while cap.isOpened() and cap.read()[0]:
            frames += 1
        out["cv2"] = {"version": cv2.__version__, "opened": cap.isOpened(),
                      "frames_read": frames}
        cap.release()
    return out


COLOUR_OPTIONS = ("colorspace", "color_range", "chroma_sample_location",
                  "color_primaries", "color_trc")


def colour_fixtures(work: str, h: int = 32, w: int = 48) -> list:
    """(name, path) of the colour fixtures, written under `work`."""
    sys.path.insert(0, ROOT)
    from rtpose_tpu_torch.demo import scripted_video as sv
    C = sv.Colour
    f8 = sv.yuv_frames(2, h, w, seed=31)
    f10 = sv.yuv_frames10(2, h, w, seed=31)
    out = []

    def at(name):
        out.append((name, os.path.join(work, name)))
        return out[-1][1]

    sv.write_ipcm_mp4(at("h264_none.mp4"), f8)
    sv.write_ipcm_mp4(at("h264_vui709.mp4"), f8, colour=C(1))
    sv.write_ipcm_mp4(at("h264_vui_full.mp4"), f8, colour=C(None, True))
    sv.write_ipcm_mp4(at("h264_vui2020_full.mp4"), f8, colour=C(9, True))
    sv.write_ipcm_mp4(at("h264_colr709.mp4"), f8,
                      colr=sv.colr_box(C(1, False, 1, 1)))
    sv.write_ipcm_mp4(at("h264_colr709_full.mp4"), f8,
                      colr=sv.colr_box(C(1, True, 1, 1)))
    sv.write_ipcm_mp4(at("h264_nclc240m.mp4"), f8,
                      colr=sv.colr_box(C(7, False, 7, 7), b"nclc"))
    sv.write_ipcm_mp4(at("h264_vui709_colr2020.mp4"), f8, colour=C(1),
                      colr=sv.colr_box(C(9, True, 1, 14)))
    sv.write_ipcm_mkv(at("h264_mkv_colour709_full.mkv"), f8,
                      colour=C(1, True, 1, 1))
    sv.write_ipcm_mkv(at("h264_mkv_colour2020_vui709.mkv"), f8,
                      sps_colour=C(1), colour=C(9, True))
    sv.write_ipcm_ts(at("h264_vui_fcc_full.ts"), f8, colour=C(4, True))
    sv.write_hevc_mp4(at("hevc_vui709.mp4"), sv.encode_hevc_pcm(
        f8, colour=C(1)))
    sv.write_hevc_mp4(at("hevc_colr709.mp4"), sv.encode_hevc_pcm(f8),
                      colr=sv.colr_box(C(1, True, 1, 1)))
    sv.write_hevc_ts(at("hevc_vui240m_full.ts"), sv.encode_hevc_pcm(
        f8, colour=C(7, True)))
    sv.write_hevc_mkv(at("hevc_vui2020_full.mkv"), sv.encode_hevc_pcm(
        f8, colour=C(9, True)))
    sv.write_hevc_mp4(at("hevc10_none.mp4"), sv.encode_hevc_pcm(
        f10, depth=10))
    sv.write_hevc_mp4(at("hevc10_vui2020.mp4"), sv.encode_hevc_pcm(
        f10, depth=10, colour=C(9)))
    sv.write_hevc_mkv(at("hevc10_vui709_full.mkv"), sv.encode_hevc_pcm(
        f10, depth=10, colour=C(1, True)))
    sv.write_ipcm_mp4(at("h264_high10.mp4"), f10, depth=10, colour=C(4))
    try:
        sv.write_vp9(at("vp9_profile2.webm"), f10, colour=C(9, True))
    except RuntimeError:
        out.pop()
    return out


def probe_colour() -> dict:
    """What the machine's libavcodec and cv2 make of colour signalling."""
    import tempfile

    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    from rtpose_tpu_torch.demo import video_io
    from rtpose_tpu_torch.native import avcodec
    from rtpose_tpu_torch.ops import kernels
    try:
        libs = avcodec.libraries()
    except (RuntimeError, OSError) as e:
        return {"error": str(e)}
    au = libs.avutil
    au.av_opt_find.restype = ctypes.c_void_p
    au.av_opt_find.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                               ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    ctx = ctypes.c_void_p(libs.avcodec.avcodec_alloc_context3(None))
    out = {"avutil_major": au.avutil_version() >> 16,
           "options": {name: bool(au.av_opt_find(ctx, name.encode(), None,
                                                 0, 0))
                       for name in COLOUR_OPTIONS}}
    libs.avcodec.avcodec_free_context(ctypes.byref(ctx))
    try:
        import cv2
        out["cv2"] = cv2.__version__
    except ImportError:
        cv2 = None
        out["cv2"] = "no cv2 on this machine"
    build = os.path.join(ROOT, "rtpose_tpu_torch", "build")
    os.makedirs(build, exist_ok=True)
    files = {}
    with tempfile.TemporaryDirectory(dir=build) as work:
        for name, path in colour_fixtures(work):
            entry = files[name] = {}
            try:
                cap = video_io.open_video(path, device="cpu")
                *planes, width, colour = next(cap._pictures)
                planes = [p.copy() for p in planes]   # before the decoder
                cap.release()                         # frees its buffers
            except (ValueError, RuntimeError) as e:
                entry["error"] = str(e)
                continue
            entry["decoder"] = colour._asdict()
            if cv2 is None:
                continue
            cv = cv2.VideoCapture(path)
            ok, frame = cv.read()
            cv.release()
            if not ok:
                entry["cv2"] = "no frame"
                continue
            planes = [torch.from_numpy(np.ascontiguousarray(p))
                      for p in planes]

            def diff(bgr):
                return int(np.abs(bgr.numpy().astype(int) - frame).max())
            rule = kernels.yuv_rule(colour.matrix if colour.matrix in
                                    kernels.SWS_MATRICES else 2,
                                    colour.full)
            if colour.depth == 8:
                entry["rule"] = diff(kernels.yuv420_to_bgr_plain(
                    *planes, width=width, rule=rule))
                entry["bt601"] = diff(kernels.yuv420_to_bgr_plain(
                    *planes, width=width))
            else:
                p10 = kernels.yuv420p10_to_bgr_plain
                entry["rule"] = diff(p10(*planes, width=width, rule=rule,
                                         chroma_location=colour.
                                         chroma_location))
                entry["bt601"] = diff(p10(*planes, width=width,
                                          chroma_location=colour.
                                          chroma_location))
                entry["centre"] = diff(p10(*planes, width=width, rule=rule,
                                           chroma_location=0))
                top8 = [((p.to(torch.int32) + 2) >> 2).clamp(max=255).to(
                    torch.uint8) for p in planes]
                entry["nearest8"] = diff(kernels.yuv420_to_bgr_plain(
                    *top8, width=width, rule=rule))
    out["files"] = files
    return out


PIXEL_FORMATS = {(1, 1): "yuv420p", (1, 0): "yuv422p", (0, 1): "yuv440p",
                 (0, 0): "yuv444p", None: "gray"}


def pixel_format(chroma, depth: int) -> str:
    """FFmpeg's name of the planar format of `chroma` (``ops.kernels``'
    log2 subsampling, None for gray) at `depth` bits."""
    name = PIXEL_FORMATS[chroma]
    return name if depth == 8 else f"{name}{depth}le"


def swscale_bgr24(y, u, v, matrix: int, full: bool, location: int,
                  depth=None, packed=None):
    """The machine's libswscale on planar planes as cv2 5.0 sets it up
    (its swscale graph's one legacy pass): SWS_BICUBIC to bgr24 at the
    same size, the source chroma at `location` (an ``AVChromaLocation``)
    along each subsampled axis (swscale's default, -513, along the
    others), the frame's matrix and range.  The format follows from the
    planes: their chroma subsampling (u and v None: gray) and `depth`
    (default 8 for uint8 planes, 10 for uint16); or it is `packed`, a
    packed RGB format (``bgr0``, ``bgra``, ``bgr24``, ``rgb24``), `y` its
    one plane, (H, W x bytes a pixel) uint8.  -> (H, W, 3) uint8."""
    import numpy as np

    sys.path.insert(0, ROOT)
    from rtpose_tpu_torch.native.avencode import encoder_libraries
    from rtpose_tpu_torch.ops import kernels
    h, w = y.shape
    chroma = None if u is None else next(
        c for c in PIXEL_FORMATS if c is not None
        and kernels.chroma_shape(c, h, w) == u.shape)
    depth = depth or (8 if y.dtype == np.uint8 else 10)
    fmt = pixel_format(chroma, depth).encode()
    if packed is not None:
        w //= kernels.PACKED_BYTES[packed]
        fmt = packed.encode()
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
    x_pos, y_pos = kernels._chroma_pos(location)
    sx, sy = chroma or (0, 0)
    ctx = sws.sws_alloc_context()
    for name, value in (("srcw", w), ("srch", h), ("dstw", w), ("dsth", h),
                        ("src_format", au.av_get_pix_fmt(fmt)),
                        ("dst_format", au.av_get_pix_fmt(b"bgr24")),
                        ("sws_flags", 4),
                        ("src_h_chr_pos", x_pos if sx else -513),
                        ("src_v_chr_pos", y_pos if sy else -513)):
        if au.av_opt_set_int(ctx, name.encode(), value, 0) < 0:
            raise RuntimeError(f"libswscale has no option {name}")
    if sws.sws_init_context(ctx, None, None) < 0 \
            or sws.sws_setColorspaceDetails(
                ctx, sws.sws_getCoefficients(matrix), int(full),
                sws.sws_getCoefficients(1), 1, 0, 1 << 16, 1 << 16) < 0:
        sws.sws_freeContext(ctx)
        raise RuntimeError(f"libswscale refused a {h}x{w} {fmt} context")
    planes = [np.ascontiguousarray(p) for p in (y, u, v) if p is not None]
    ptrs = [p.ctypes.data for p in planes] + [None] * (4 - len(planes))
    pitches = [p.strides[0] for p in planes] + [0] * (4 - len(planes))
    out = np.zeros((h, 3 * w + 64), np.uint8)
    sws.sws_scale(ctx, (P * 4)(*ptrs), (I * 4)(*pitches), 0, h,
                  (P * 4)(out.ctypes.data, None, None, None),
                  (I * 4)(out.strides[0], 0, 0, 0))
    sws.sws_freeContext(ctx)
    return out[:, :3 * w].reshape(h, w, 3)


# (depth, height, width): each route at the sizes of item 4i (a)
ODD_SIZES = ((8, 32, 47), (8, 9, 8), (8, 31, 48), (8, 33, 64),
             (8, 479, 640), (8, 9, 9), (8, 31, 47), (8, 31, 65),
             (8, 479, 639), (10, 31, 64), (10, 10, 15), (10, 32, 47),
             (10, 31, 65), (10, 48, 65), (10, 480, 639))


def probe_odd_sizes() -> dict:
    """libswscale and cv2 at odd frame sizes against the port's rules."""
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    from rtpose_tpu_torch.demo import scripted_video as sv
    from rtpose_tpu_torch.demo import video_io
    from rtpose_tpu_torch.native.avencode import encoder_libraries
    from rtpose_tpu_torch.ops import kernels
    try:
        sws = encoder_libraries().swscale
    except (RuntimeError, OSError) as e:
        return {"error": str(e)}
    out = {"libswscale": _version(sws.swscale_version()), "rules": {},
           "fixtures": {}}
    for depth, h, w in ODD_SIZES:
        rng = np.random.RandomState(h * w + depth)
        dtype = np.uint8 if depth == 8 else np.uint16
        c = ((h + 1) // 2, (w + 1) // 2)
        planes = [rng.randint(0, 1 << depth, s).astype(dtype)
                  for s in ((h, w), c, c)]
        worst = 0
        for location, matrix, full in ((0, 2, False), (1, 1, True),
                                       (3, 9, False)):
            got = kernels.yuv420_frame_to_bgr(
                *map(torch.from_numpy, planes), depth=depth, width=w,
                rule=kernels.yuv_rule(matrix, full),
                chroma_location=location).numpy()
            want = swscale_bgr24(*planes, matrix, full, location)
            worst = max(worst, int(np.abs(got.astype(int) - want).max()))
        out["rules"][f"{depth}-bit {h}x{w}"] = {
            "route": kernels.frame_route(kernels.CHROMA_420, depth, h, w),
            "max_abs_diff": worst}
    try:
        import cv2
        out["cv2"] = cv2.__version__
    except ImportError:
        out["cv2"] = "no cv2 on this machine"
        return out
    for fixture in sv.ODD_SIZE_FIXTURES:
        path = sv.odd_size_path(fixture)
        frames = {}
        for key, cap in (("port", video_io.open_video(path, device="cpu")),
                         ("cv2", cv2.VideoCapture(path))):
            frames[key] = []
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                frames[key].append(frame)
            cap.release()
        out["fixtures"][fixture.name] = {
            "frames": len(frames["port"]), "cv2_frames": len(frames["cv2"]),
            "max_abs_diff": max((int(np.abs(a.astype(int) - b).max())
                                 for a, b in zip(frames["port"],
                                                 frames["cv2"])
                                 if a.shape == b.shape), default=-1),
            "shapes_equal": all(a.shape == b.shape for a, b in
                                zip(frames["port"], frames["cv2"]))}
    return out


# (chroma, depth): every chroma format at 8, 10 and 12 bits
FORMAT_DEPTHS = tuple((chroma, depth) for chroma in PIXEL_FORMATS
                      for depth in (8, 10, 12))
# (h, w): every parity of height and width, and the smallest size
FORMAT_SIZES = ((48, 64), (47, 64), (48, 63), (47, 63), (9, 8))
# (chroma location, matrix, full range): the (matrix, range) pairs and
# chroma locations 0 / 1 the rules are held at here
FORMAT_COLOURS = ((0, 2, False), (1, 1, True), (1, 9, False), (0, 7, True))


def against_cv2(path: str, props: bool = False) -> dict:
    """The port's CPU read of `path` against the machine's cv2 (a bare
    ``cv2.VideoCapture``): frames, the largest difference, whether the
    shapes agree; with `props`, each one's frame count and fps too."""
    import cv2
    import numpy as np

    sys.path.insert(0, ROOT)
    from rtpose_tpu_torch.demo import video_io
    frames = {}
    for key, cap in (("port", video_io.open_video(path, device="cpu")),
                     ("cv2", cv2.VideoCapture(path))):
        frames[key] = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames[key].append(frame)
        if props:
            frames[key + "_props"] = (
                [cap.frame_count, cap.fps] if key == "port" else
                [int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
                 cap.get(cv2.CAP_PROP_FPS)])
        cap.release()
    out = {"frames": len(frames["port"]), "cv2_frames": len(frames["cv2"]),
           "max_abs_diff": max((int(np.abs(a.astype(int) - b).max())
                                for a, b in zip(frames["port"],
                                                frames["cv2"])
                                if a.shape == b.shape), default=-1),
           "shapes_equal": all(a.shape == b.shape for a, b in
                               zip(frames["port"], frames["cv2"]))}
    if props:
        out["count_fps"] = frames["port_props"]
        out["cv2_count_fps"] = frames["cv2_props"]
    return out


def format_files(work: str) -> list:
    """(name, path) of PCM files of the chroma formats (HEVC RExt 4:2:2
    10-bit of an odd height, 4:4:4 12-bit of an odd size, 4:0:0 10-bit
    stating limited range, Main 12; H.264 High 4:2:2 10-bit and 8-bit),
    written under `work`."""
    sys.path.insert(0, ROOT)
    from rtpose_tpu_torch.demo import scripted_video as sv
    out = []

    def at(name):
        out.append((name, os.path.join(work, name)))
        return out[-1][1]

    sv.write_hevc_mp4(at("hevc_422_10bit_47x64.mp4"), sv.encode_hevc_pcm(
        sv.yuv_frames10(2, 47, 64, depth=10, chroma=(1, 0)), depth=10,
        colour=sv.Colour(1, True)))
    sv.write_hevc_mkv(at("hevc_444_12bit_31x47.mkv"), sv.encode_hevc_pcm(
        sv.yuv_frames10(2, 31, 47, depth=12, chroma=(0, 0)), depth=12))
    sv.write_hevc_ts(at("hevc_gray_10bit.ts"), sv.encode_hevc_pcm(
        sv.yuv_frames10(2, 32, 48, depth=10, chroma=None), depth=10,
        colour=sv.Colour(1, False)))
    sv.write_hevc_mp4(at("hevc_main12.mp4"), sv.encode_hevc_pcm(
        sv.yuv_frames10(2, 32, 48, depth=12), depth=12))
    sv.write_ipcm_mp4(at("h264_422_10bit.mp4"),
                      sv.yuv_frames10(2, 48, 64, chroma=(1, 0)), depth=10)
    sv.write_ipcm_mkv(at("h264_422_8bit_47x64.mkv"),
                      sv.yuv_frames(2, 47, 64, chroma=(1, 0)))
    return out


def probe_formats() -> dict:
    """The chroma formats (ROADMAP.md item 4i (d)): the machine's
    libswscale (``swscale_bgr24``) on random planes of each format,
    depth and size parity (``FORMAT_DEPTHS`` x ``FORMAT_SIZES``) against
    the port's plain rule of the path ``ops.kernels.frame_route`` picks
    (``rules``: the route and the largest difference over
    ``FORMAT_COLOURS``; gray taken at full range, as cv2 5.0 takes it);
    and, where the machine has cv2, its frames of the committed
    chroma-format VP9 fixtures (``scripted_video.CHROMA_FIXTURES``) and of
    PCM files written here (``format_files``) against the port's CPU read
    (``fixtures``, ``files``)."""
    import tempfile

    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    from rtpose_tpu_torch.demo import scripted_video as sv
    from rtpose_tpu_torch.native.avencode import encoder_libraries
    from rtpose_tpu_torch.ops import kernels
    try:
        sws = encoder_libraries().swscale
    except (RuntimeError, OSError) as e:
        return {"error": str(e)}
    out = {"libswscale": _version(sws.swscale_version()), "rules": {},
           "fixtures": {}, "files": {}}
    for chroma, depth in FORMAT_DEPTHS:
        for h, w in FORMAT_SIZES:
            rng = np.random.RandomState(h * w + depth)
            dtype = np.uint8 if depth == 8 else np.uint16
            shapes = [(h, w)] + ([] if chroma is None else
                                 [kernels.chroma_shape(chroma, h, w)] * 2)
            planes = [rng.randint(0, 1 << depth, s).astype(dtype)
                      for s in shapes] + [None] * (3 - len(shapes))
            worst = 0
            for location, matrix, full in FORMAT_COLOURS:
                got = kernels.yuv420_frame_to_bgr(
                    *[None if p is None else torch.from_numpy(p)
                      for p in planes], depth=depth, width=w,
                    rule=kernels.yuv_rule(matrix, full),
                    chroma_location=location, chroma=chroma).numpy()
                want = swscale_bgr24(*planes, matrix, full or chroma is None,
                                     location, depth)
                worst = max(worst, int(np.abs(got.astype(int) - want).max()))
            out["rules"][f"{pixel_format(chroma, depth)} {h}x{w}"] = {
                "route": kernels.frame_route(chroma, depth, h, w),
                "max_abs_diff": worst}
    try:
        import cv2
        out["cv2"] = cv2.__version__
    except ImportError:
        out["cv2"] = "no cv2 on this machine"
        return out

    for fixture in sv.CHROMA_FIXTURES:
        out["fixtures"][fixture.name] = against_cv2(
            sv.chroma_fixture_path(fixture))
    with tempfile.TemporaryDirectory() as work:
        for name, path in format_files(work):
            out["files"][name] = against_cv2(path)
    return out


# (chroma format, with Huffman tables, container, (h, w)) of the
# Motion-JPEG files mjpeg_files writes: every format in AVI, MOV and
# Matroska at 48x64, and the rest of the cases at odd sizes
MJPEG_FILES = tuple(
    [(sampling, True, container, (48, 64))
     for sampling in ("420", "422", "444", "gray")
     for container in ("avi", "mov", "mkv")]
    + [("420", False, "avi", (47, 63)), ("422", False, "mov", (31, 47)),
       ("444", True, "mp4", (47, 63)), ("gray", True, "vfw", (31, 47)),
       ("420", True, "mjpa", (31, 47)), ("420", True, "mkv", (47, 64)),
       ("422", True, "avi", (47, 64))])


def mjpeg_files(work: str) -> list:
    """(name, path) of Motion-JPEG files of the repository's writers
    (``scripted_video.jpeg_images`` / ``write_mjpeg``: Pillow's JPEGs of
    rendered scenes, :data:`MJPEG_FILES`), written under `work`."""
    sys.path.insert(0, ROOT)
    from rtpose_tpu_torch.data.imread_fixtures import render_scene
    from rtpose_tpu_torch.demo import scripted_video as sv
    out = []
    for sampling, huffman, container, (h, w) in MJPEG_FILES:
        name = (f"mjpeg_{sampling}_{'dht' if huffman else 'no_dht'}_"
                f"{h}x{w}.{container}")
        path = os.path.join(work, name)
        frames = [render_scene(40 + i, h, w) for i in range(3)]
        sv.write_mjpeg(path, sv.jpeg_images(frames, sampling, huffman),
                       (w, h), container)
        out.append((name, path))
    return out


def probe_mjpeg_vp8() -> dict:
    """Motion-JPEG and VP8 (ROADMAP.md item 4j (a), (b); fault F6): the
    wheel's ``mjpeg`` and ``vp8`` decoders (``decoders``: whether each
    opens, and the pixel format and colour it settles on a small file),
    the backend the machine's cv2 picks for a Motion-JPEG AVI
    (``backend``), and cv2's frames, count and fps of the VP8 fixtures
    (``fixtures``) and of :func:`mjpeg_files` (``files``) against the
    port's CPU read."""
    import tempfile

    sys.path.insert(0, ROOT)
    from rtpose_tpu_torch.demo import scripted_video as sv
    from rtpose_tpu_torch.demo import video_io
    from rtpose_tpu_torch.native import avcodec
    try:
        libs = avcodec.libraries()
    except (RuntimeError, OSError) as e:
        return {"error": str(e)}
    out = {"decoders": {}, "fixtures": {}, "files": {}}
    with tempfile.TemporaryDirectory() as work:
        files = mjpeg_files(work)
        samples = {"vp8": sv.vp8_path(sv.VP8_FIXTURES[0]),
                   "mjpeg": files[0][1]}
        for name, path in samples.items():
            entry = out["decoders"][name] = {"opens": _opens(libs, name)}
            if entry["opens"] != "opens":
                continue
            cap = video_io.open_video(path, device="cpu")
            try:
                cap.read()
                decoder = cap._decoder
                frame = avcodec._Frame.from_address(decoder._frame.value)
                entry.update(colour=decoder.colour._asdict(),
                             pixel_format=libs.avutil.av_get_pix_fmt_name(
                                 frame.format).decode())
            finally:
                cap.release()
        try:
            import cv2
        except ImportError:
            out["cv2"] = "no cv2 on this machine"
            return out
        out["cv2"] = cv2.__version__
        cap = cv2.VideoCapture(files[0][1])
        out["backend"] = {"mjpg_avi": cap.getBackendName()
                          if cap.isOpened() else "does not open"}
        cap.release()
        for fixture in sv.VP8_FIXTURES:
            out["fixtures"][fixture.name] = against_cv2(
                sv.vp8_path(fixture), props=True)
        for name, path in files:
            out["files"][name] = against_cv2(path, props=True)
    return out


# cv2's writer's fourccs (ROADMAP.md item 4j (c)) -> the decoder the port
# reads each with, and ProRes profiles of demo/scripted_video.py's
# write_prores (item 4j (d)) -> (input chroma, alpha plane)
CV2_WRITER_FOURCCS = {"I420": "rawvideo", "IYUV": "rawvideo",
                      "Y800": "rawvideo", "PIM1": "mpeg1video",
                      "mpg2": "mpeg2video", "MP42": "msmpeg4v2",
                      "DIV3": "msmpeg4", "WMV1": "wmv1", "WMV2": "wmv2",
                      "FLV1": "flv", "FFVH": "ffvhuff", "HFYU": "huffyuv",
                      "FFV1": "ffv1"}
PRORES_FILES = {2: ((1, 0), False), 3: ((1, 0), False), 4: ((0, 0), True)}


def cv2_writer_files(work: str, size=(48, 64), frames: int = 3) -> list:
    """(name, path, decoder) of the files of item 4j (c) and (d), written
    under `work`: each of :data:`CV2_WRITER_FOURCCS` by the machine's cv2
    (rendered scenes) in AVI and Matroska, and ProRes 422 standard, HQ
    and 4444 with alpha (:data:`PRORES_FILES`) in MOV and Matroska by the
    wheel's encoder (needs no cv2)."""
    import numpy as np

    sys.path.insert(0, ROOT)
    from rtpose_tpu_torch.demo import scripted_video as sv
    h, w = size
    out = []
    for profile, (chroma, alpha) in PRORES_FILES.items():
        planes = sv.yuv_frames10(frames, h, w, seed=profile, chroma=chroma)
        if alpha:
            planes = [(*p, np.full((h, w), 1023, np.uint16)) for p in planes]
        for container in ("mov", "mkv"):
            name = f"prores{profile}_{h}x{w}.{container}"
            path = os.path.join(work, name)
            sv.write_prores(path, planes, profile=profile,
                            container=container)
            out.append((name, path, "prores"))
    try:
        import cv2  # noqa: F401
    except ImportError:
        return out
    for fourcc, codec in CV2_WRITER_FOURCCS.items():
        for container in ("avi", "mkv"):
            name = f"{fourcc}_{h}x{w}.{container}"
            path = os.path.join(work, name)
            sv.write_cv2_video(path, fourcc, frames, h, w)
            out.append((name, path, codec))
    return out


def probe_cv2_writer() -> dict:
    """cv2's writer's codecs and ProRes (ROADMAP.md item 4j (c), (d)):
    whether the wheel's decoders of them open (``decoders``) and it has
    the ``prores`` encoder (``prores_encoder``); where the machine has
    cv2, its frames, count and fps of :func:`cv2_writer_files` against
    the port's CPU read (``files``)."""
    import tempfile

    sys.path.insert(0, ROOT)
    from rtpose_tpu_torch.native import avcodec
    try:
        libs = avcodec.libraries()
    except (RuntimeError, OSError) as e:
        return {"error": str(e)}
    av = libs.avcodec
    av.avcodec_find_encoder_by_name.restype = ctypes.c_void_p
    av.avcodec_find_encoder_by_name.argtypes = [ctypes.c_char_p]
    tags = {"rawvideo": b"I420", "prores": b"apcn"}

    def opens(name):    # with what an AVI hands it: tag, size, bits
        if not av.avcodec_find_decoder_by_name(name.encode()):
            return "no such decoder"
        try:
            avcodec.Decoder(name, tag=tags.get(name, b""),
                            params=avcodec.CodecParams(size=(64, 48),
                                                       bits=24)).close()
        except RuntimeError as e:
            return str(e)
        return "opens"

    out = {"decoders": {name: opens(name)
                        for name in sorted(avcodec.CONTAINER_PARAMS)},
           "prores_encoder": bool(av.avcodec_find_encoder_by_name(
               b"prores")), "files": {}}
    try:
        import cv2
        out["cv2"] = cv2.__version__
    except ImportError:
        out["cv2"] = "no cv2 on this machine"
        return out
    with tempfile.TemporaryDirectory() as work:
        for name, path, codec in cv2_writer_files(work):
            out["files"][name] = {"codec": codec,
                                  **against_cv2(path, props=True)}
    return out


def probe() -> dict:
    return {"nvdec": probe_nvdec(), "libavcodec": probe_host(),
            "writer": probe_writer(), "av1": probe_av1(),
            "colour": probe_colour(), "odd_sizes": probe_odd_sizes(),
            "formats": probe_formats(), "mjpeg_vp8": probe_mjpeg_vp8(),
            "cv2_writer": probe_cv2_writer()}


if __name__ == "__main__":
    print("SUMMARY " + json.dumps(probe()), flush=True)
