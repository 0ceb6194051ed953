"""MPEG-4 Part 2 (XVID) encoding on the host through the OpenCV wheel's
FFmpeg ``libavcodec`` and ``libswscale``, loaded by path as
``native/avcodec.py`` loads the decoders: what ``cv2.VideoWriter(path,
fourcc('X','V','I','D'), fps, (w, h))`` does with each frame, packet for
packet.

cv2's FFmpeg writer (``cap_ffmpeg_impl.hpp``) opens the ``mpeg4``
encoder with the codec tag ``XVID``, ``yuv420p``, a time base of 1/fps
(:func:`time_base`: the rate times the first power of ten that brings it
within 0.001 of `fps`), a GOP of 12, ``qmin`` 3 and a bit rate of
``b + b // 2`` where ``b`` is fps x width x height rounded
(:func:`bit_rate`); it turns each BGR frame into YUV 4:2:0 with
``sws_scale`` (``SWS_BICUBIC``, its rows padded to 32 bytes) and gives
the frames no B-frames and the presentation times 0, 1, 2, ...  The
encoder numbers frames that carry no time 0, 1, 2, ... itself, so the
frames here carry none.  Every setting goes through ``av_opt_set*`` on
the codec context, so no field offset of ``AVCodecContext`` is used; of
``AVFrame`` only its leading ``data`` / ``linesize`` / ``width`` /
``height`` / ``format`` (as the decoder reads them).

The BGR -> YUV step stays on the host, in the same libswscale as cv2's:
its unscaled RGB -> YUV paths differ between versions and SIMD levels, so
matching it in a kernel would be a study of its own, and the writer's
frames are drawn on the host, so a card kernel would add two copies and
save nothing.  (The JAX package leaves this step to cv2's swscale, as it
leaves convolutions to XLA.)

Nothing is loaded at import; without the libraries or the encoder the
first :class:`Encoder` raises, naming where it looked.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from typing import List, Optional, Tuple

import numpy as np

from .avcodec import (AVERROR_EAGAIN, AVERROR_EOF, AV_PIX_FMT_YUV420P,
                      AV_PKT_FLAG_KEY, _Frame, _load, _Packet, find_library,
                      libraries)

AV_PIX_FMT_BGR24 = 3
SWS_BICUBIC = 4
GOP = 12                       # cv2: "one intra frame every twelve frames"
QMIN = 3
STEP_ALIGN = 32                # cv2 pads the BGR rows it hands swscale
INT_MAX = 2 ** 31 - 1


class _Rational(ctypes.Structure):
    _fields_ = [("num", ctypes.c_int), ("den", ctypes.c_int)]


def time_base(fps: float) -> Tuple[int, int]:
    """(num, den) of cv2's encoder time base for `fps`: den/num is fps
    to within 0.001, num a power of ten."""
    rate, base = int(fps + 0.5), 1
    while abs(rate / base - fps) > 0.001:
        base *= 10
        rate = int(fps * base + 0.5)
    return base, rate


def bit_rate(fps: float, width: int, height: int) -> int:
    """cv2's bit rate for the FFmpeg writer: ``b = (int)(min(fps * w * h,
    INT_MAX / 2) + 0.5)``, then ``b + b / 2`` in integers."""
    b = int(min(1 * fps * width * height, INT_MAX / 2) + 0.5)
    return min(b + b // 2, INT_MAX)


class _Libraries:
    def __init__(self):
        base = libraries()
        self.avcodec, self.avutil, self.error = (base.avcodec, base.avutil,
                                                 base.error)
        self.swscale = _load(find_library("swscale"))
        P, I = ctypes.c_void_p, ctypes.c_int
        for lib, name, res, args in (
                (self.avcodec, "avcodec_find_encoder_by_name", P,
                 [ctypes.c_char_p]),
                (self.avcodec, "avcodec_send_frame", I, [P, P]),
                (self.avcodec, "avcodec_receive_packet", I, [P, P]),
                (self.avcodec, "av_packet_unref", None, [P]),
                (self.avutil, "av_opt_set", I, [P, ctypes.c_char_p,
                                                ctypes.c_char_p, I]),
                (self.avutil, "av_opt_set_int", I, [P, ctypes.c_char_p,
                                                    ctypes.c_int64, I]),
                (self.avutil, "av_opt_set_q", I, [P, ctypes.c_char_p,
                                                  _Rational, I]),
                (self.swscale, "sws_getContext", P,
                 [I, I, I, I, I, I, I, P, P, P]),
                (self.swscale, "sws_scale", I, [P, P, P, I, I, P, P]),
                (self.swscale, "sws_freeContext", None, [P])):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = res, args
        self.path = self.avcodec._name


_lock = threading.Lock()
_libs: Optional[_Libraries] = None


def encoder_libraries() -> _Libraries:
    global _libs
    with _lock:
        if _libs is None:
            _libs = _Libraries()
        return _libs


class Encoder:
    """cv2's XVID encoder for ``(height, width, 3)`` uint8 BGR frames at
    `fps`.  :meth:`encode` takes one frame and returns the packets it
    completes, :meth:`flush` the rest; a packet is ``(bytes, key)``.
    ``seconds`` sums the time of ``convert`` (swscale) and ``encode``."""

    def __init__(self, width: int, height: int, fps: float):
        import time

        self._clock = time.perf_counter
        self.width, self.height = width, height
        self.seconds = {"convert": 0.0, "encode": 0.0}
        self._libs = libs = encoder_libraries()
        self._ctx = self._sws = self._frame = self._packet = None
        av, au = libs.avcodec, libs.avutil
        codec = av.avcodec_find_encoder_by_name(b"mpeg4")
        if not codec:
            raise RuntimeError(f"{libs.path} has no mpeg4 encoder")
        self._ctx = ctypes.c_void_p(av.avcodec_alloc_context3(codec))
        self._packet = ctypes.c_void_p(av.av_packet_alloc())
        self._frame = ctypes.c_void_p(au.av_frame_alloc())
        if not (self._ctx and self._packet and self._frame):
            self.close()
            raise MemoryError("libavcodec could not allocate an encoder")
        num, den = time_base(fps)
        for name, value in ((b"b", bit_rate(fps, width, height)),
                            (b"g", GOP), (b"qmin", QMIN), (b"bf", 0),
                            (b"codec_tag",
                             struct.unpack("<I", b"XVID")[0])):
            self._check(au.av_opt_set_int(self._ctx, name, value, 0), name)
        self._check(au.av_opt_set_q(self._ctx, b"time_base",
                                    _Rational(num, den), 0), b"time_base")
        self._check(au.av_opt_set(self._ctx, b"video_size",
                                  f"{width}x{height}".encode(), 0),
                    b"video_size")
        self._check(au.av_opt_set(self._ctx, b"pixel_format", b"yuv420p", 0),
                    b"pixel_format")
        err = av.avcodec_open2(self._ctx, codec, None)
        if err < 0:
            self.close()
            raise RuntimeError(f"avcodec_open2(mpeg4): {libs.error(err)}")
        self._sws = libs.swscale.sws_getContext(
            width, height, AV_PIX_FMT_BGR24, width, height,
            AV_PIX_FMT_YUV420P, SWS_BICUBIC, None, None, None)
        if not self._sws:
            self.close()
            raise RuntimeError(f"sws_getContext refused BGR24 -> YUV420P at "
                               f"{width}x{height}")
        # cv2's buffers: BGR rows padded to 32 bytes; the 4:2:0 planes
        # packed, rows unpadded (av_image_fill_arrays, alignment 1)
        self._step = (3 * width + STEP_ALIGN - 1) & ~(STEP_ALIGN - 1)
        self._bgr = np.zeros(self._step * height + STEP_ALIGN, np.uint8)
        cw, ch = (width + 1) // 2, (height + 1) // 2
        self._yuv = np.zeros(width * height + 2 * cw * ch, np.uint8)
        at = self._yuv.ctypes.data
        planes = (at, at + width * height, at + width * height + cw * ch)
        self._src = ((ctypes.c_void_p * 4)(self._bgr.ctypes.data),
                     (ctypes.c_int * 4)(self._step))
        self._dst = ((ctypes.c_void_p * 4)(*planes),
                     (ctypes.c_int * 4)(width, cw, cw))
        f = _Frame.from_address(self._frame.value)
        f.width, f.height, f.format = width, height, AV_PIX_FMT_YUV420P
        for i in range(3):
            f.data[i], f.linesize[i] = planes[i], self._dst[1][i]

    def _check(self, err: int, name: bytes) -> None:
        if err < 0:
            self.close()
            raise RuntimeError(f"mpeg4 encoder option {name.decode()}: "
                               f"{self._libs.error(err)}")

    def encode(self, frame: np.ndarray) -> List[Tuple[bytes, bool]]:
        if frame.dtype != np.uint8 or frame.shape != (self.height,
                                                      self.width, 3):
            raise ValueError(f"frames of this encoder are ({self.height}, "
                             f"{self.width}, 3) uint8, got {frame.dtype} "
                             f"{frame.shape}")
        t0 = self._clock()
        rows = self._bgr[:self._step * self.height].reshape(self.height,
                                                            self._step)
        rows[:, :3 * self.width] = frame.reshape(self.height, -1)
        self._libs.swscale.sws_scale(self._sws, self._src[0], self._src[1],
                                     0, self.height, self._dst[0],
                                     self._dst[1])
        t1 = self._clock()
        self.seconds["convert"] += t1 - t0
        # not reference-counted: the encoder copies the planes
        out = self._send(self._frame)
        self.seconds["encode"] += self._clock() - t1
        return out

    def flush(self) -> List[Tuple[bytes, bool]]:
        return self._send(None)

    def _send(self, frame) -> List[Tuple[bytes, bool]]:
        av = self._libs.avcodec
        err = av.avcodec_send_frame(self._ctx, frame)
        if err < 0 and err != AVERROR_EOF:
            raise RuntimeError(f"the mpeg4 encoder refused a frame: "
                               f"{self._libs.error(err)}")
        out = []
        while True:
            err = av.avcodec_receive_packet(self._ctx, self._packet)
            if err in (AVERROR_EAGAIN, AVERROR_EOF):
                return out
            if err < 0:
                raise RuntimeError(f"mpeg4 encoding failed: "
                                   f"{self._libs.error(err)}")
            p = _Packet.from_address(self._packet.value)
            out.append((ctypes.string_at(p.data, p.size),
                        bool(p.flags & AV_PKT_FLAG_KEY)))
            av.av_packet_unref(self._packet)

    def close(self) -> None:
        libs = self._libs
        if self._sws:
            libs.swscale.sws_freeContext(self._sws)
            self._sws = None
        for attr, free, lib in (("_frame", "av_frame_free", libs.avutil),
                                ("_packet", "av_packet_free", libs.avcodec),
                                ("_ctx", "avcodec_free_context",
                                 libs.avcodec)):
            handle = getattr(self, attr)
            if handle:
                getattr(lib, free)(ctypes.byref(handle))
            setattr(self, attr, None)

    def __del__(self):
        if getattr(self, "_libs", None) is not None:
            self.close()
