"""Probe the two routes a machine offers the port's video reader.

- NVDEC: whether the driver's ``libnvcuvid.so.1`` loads, and what
  ``cuvidGetDecoderCaps`` answers for H.264 and MPEG-4 Part 2, 8-bit
  4:2:0, on the primary context PyTorch made current (the result code,
  and the caps of a codec it supports: the largest and smallest sizes,
  the decoders, whether 640x480 fits).
- The host: the FFmpeg ``libavcodec`` the OpenCV wheel bundles
  (``rtpose_tpu_torch/native/avcodec.py``, the route the reader takes):
  its path and whether it opens H.264 and MPEG-4 decoders.

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


def probe() -> dict:
    return {"nvdec": probe_nvdec(), "libavcodec": probe_host()}


if __name__ == "__main__":
    print("SUMMARY " + json.dumps(probe()), flush=True)
