"""Probe the two routes a machine offers the port's video reader.

- NVDEC: whether the driver's ``libnvcuvid.so.1`` loads, and what
  ``cuvidGetDecoderCaps`` answers for H.264 and MPEG-4 Part 2, 8-bit
  4:2:0, on the primary context PyTorch made current (the result code,
  and the caps of a codec it supports: the largest and smallest sizes,
  the decoders, whether 640x480 fits).
- The host: the FFmpeg ``libavcodec`` the OpenCV wheel bundles
  (``rtpose_tpu_torch/native/avcodec.py``, the route the reader takes):
  its path, whether it opens the H.264, MPEG-4 and VP9 decoders, and
  the libavcodec, libavutil and libswscale versions; and what the XVID
  writer needs (``rtpose_tpu_torch/native/avencode.py``): the ``mpeg4``
  encoder, its options (``av_opt_find``), ``sws_getContext`` and an
  encoder that opens.

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
    return out


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


def probe() -> dict:
    return {"nvdec": probe_nvdec(), "libavcodec": probe_host(),
            "writer": probe_writer()}


if __name__ == "__main__":
    print("SUMMARY " + json.dumps(probe()), flush=True)
