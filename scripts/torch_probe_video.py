"""Probe the two routes a machine offers the port's video reader.

- NVDEC: whether the driver's ``libnvcuvid.so.1`` loads, and what
  ``cuvidGetDecoderCaps`` answers for H.264 and MPEG-4 Part 2, 8-bit
  4:2:0, on the primary context PyTorch made current (the result code,
  and the caps of a codec it supports: the largest and smallest sizes,
  the decoders, whether 640x480 fits).
- The host: the FFmpeg ``libavcodec`` the OpenCV wheel bundles
  (``rtpose_tpu_torch/native/avcodec.py``, the route the reader takes):
  its path, whether it opens the H.264, HEVC, MPEG-4, VP9, MPEG-1 and
  MPEG-2 decoders (and the AV1 decoder the reader still refuses),
  whether the ``mpegvideo``, ``mpeg4video``, ``h264`` and ``hevc``
  parsers initialise, and the libavcodec, libavutil and libswscale
  versions; and what the XVID writer needs
  (``rtpose_tpu_torch/native/avencode.py``): the ``mpeg4`` encoder, its
  options (``av_opt_find``), ``sws_getContext`` and an encoder that
  opens.
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
    for name in avcodec.CODECS:
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


def probe() -> dict:
    return {"nvdec": probe_nvdec(), "libavcodec": probe_host(),
            "writer": probe_writer(), "av1": probe_av1()}


if __name__ == "__main__":
    print("SUMMARY " + json.dumps(probe()), flush=True)
