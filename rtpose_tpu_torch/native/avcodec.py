"""H.264, MPEG-4 Part 2 and VP9 decoding on the host through FFmpeg's
``libavcodec``, the one that the machine's OpenCV wheel bundles, loaded
by path with ctypes (as ``native/imgpipe.py`` links Pillow's libjpeg).

Why the host: the card's machine mounts the driver's NVDEC library
(``libnvcuvid.so.1``, driver 580.159.03), but every call of it fails
there, ``cuvidGetDecoderCaps`` included, with CUDA error 2
(``scripts/torch_probe_video.py``).  So the video reader decodes here
and converts the decoded 4:2:0 planes to BGR on the card
(``ops.kernels.yuv420_to_bgr``).

Only version-stable pieces of the API are used: ``avcodec_find_decoder_by_name``,
``avcodec_alloc_context3``, ``avcodec_open2``, ``avcodec_send_packet``,
``avcodec_receive_frame`` and the allocators and destructors of the
context, the packet and the frame, with no option set; of ``AVPacket``
its leading fields (``data``, ``size``, ``flags`` set; ``pts`` and ``dts`` left unset) and
of ``AVFrame`` its ``data``, ``linesize``, ``width``, ``height`` and
``format``, whose places have not moved since FFmpeg 4.  Packets go in
as the demuxer gives them (H.264 as Annex-B with its parameter sets in
the stream; MPEG-4 with its VOL headers ahead of the first frame), so no
field of the codec context is set either.  Frames come out in display
order; an H.264 stream is first probed (:meth:`Decoder.probe`) as
libavformat probes it for cv2, so that a stream whose SPS states no
reorder delay gives its B pictures as cv2 does.  Nothing is loaded at import; without the library the first
decoder raises, naming where it looked.
"""

from __future__ import annotations

import ctypes
import glob
import os
import site
import sys
import threading
from typing import Iterator, List, Optional, Tuple

import numpy as np

CODECS = ("h264", "mpeg4", "vp9")
AV_PIX_FMT_YUV420P = 0
AV_PIX_FMT_YUVJ420P = 12
AV_PKT_FLAG_KEY = 1
AVERROR_EAGAIN = -11
AVERROR_EOF = -0x20464F45          # -MKTAG('E', 'O', 'F', ' ')


class _Packet(ctypes.Structure):
    """AVPacket's leading fields (libavcodec 57 and later)."""
    _fields_ = [("buf", ctypes.c_void_p), ("pts", ctypes.c_int64),
                ("dts", ctypes.c_int64), ("data", ctypes.c_void_p),
                ("size", ctypes.c_int), ("stream_index", ctypes.c_int),
                ("flags", ctypes.c_int)]


class _Frame(ctypes.Structure):
    """AVFrame's leading fields (libavutil 52 and later)."""
    _fields_ = [("data", ctypes.c_void_p * 8), ("linesize", ctypes.c_int * 8),
                ("extended_data", ctypes.c_void_p),
                ("width", ctypes.c_int), ("height", ctypes.c_int),
                ("nb_samples", ctypes.c_int), ("format", ctypes.c_int)]


def _library_dirs() -> List[str]:
    roots = [*sys.path, *site.getsitepackages()]
    if site.ENABLE_USER_SITE:
        roots.append(site.getusersitepackages())
    return sorted({d for r in roots if r and os.path.isdir(r)
                   for d in glob.glob(os.path.join(r, "opencv*.libs"))})


def find_library(name: str) -> str:
    """Path of the OpenCV wheel's bundled ``lib<name>-<hash>.so.<n>``
    (``opencv_python.libs`` or ``opencv_python_headless.libs`` beside
    ``cv2``); raises naming the directories searched."""
    dirs = _library_dirs()
    for d in dirs:
        found = sorted(glob.glob(os.path.join(d, f"lib{name}-*.so*")))
        if found:
            return found[0]
    raise RuntimeError(
        f"no lib{name} found: the video reader and the XVID writer use "
        f"the FFmpeg libraries bundled in the OpenCV wheel's "
        f"opencv*.libs directory (searched {dirs or 'no such directory'} "
        f"under sys.path)")


def _load(path: str, depth: int = 0) -> ctypes.CDLL:
    """dlopen `path`; a bundled library whose own dependencies sit beside
    it but are not found by the loader (the wheel's libraries carry no
    rpath; cv2 loads them in order) gets those loaded first, by path."""
    try:
        return ctypes.CDLL(path)
    except OSError as e:
        missing = str(e).split(":")[0].strip()
        beside = os.path.join(os.path.dirname(path), missing)
        if depth > 16 or missing == os.path.basename(path) \
                or not os.path.exists(beside):
            raise
    _load(beside, depth + 1)
    return _load(path, depth + 1)


class _Libraries:
    def __init__(self):
        self.avcodec = _load(find_library("avcodec"))
        self.avutil = _load(find_library("avutil"))
        P, I = ctypes.c_void_p, ctypes.c_int
        for lib, name, res, args in (
                (self.avcodec, "avcodec_find_decoder_by_name", P,
                 [ctypes.c_char_p]),
                (self.avcodec, "avcodec_alloc_context3", P, [P]),
                (self.avcodec, "avcodec_open2", I, [P, P, P]),
                (self.avcodec, "avcodec_send_packet", I, [P, P]),
                (self.avcodec, "avcodec_receive_frame", I, [P, P]),
                (self.avcodec, "avcodec_free_context", None, [P]),
                (self.avcodec, "avcodec_flush_buffers", None, [P]),
                (self.avcodec, "av_packet_alloc", P, []),
                (self.avcodec, "av_packet_free", None, [P]),
                (self.avutil, "av_frame_alloc", P, []),
                (self.avutil, "av_frame_free", None, [P]),
                (self.avutil, "av_strerror", I,
                 [I, ctypes.c_char_p, ctypes.c_size_t])):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = res, args
        self.path = self.avcodec._name

    def error(self, code: int) -> str:
        buf = ctypes.create_string_buffer(128)
        self.avutil.av_strerror(code, buf, len(buf))
        return f"{buf.value.decode(errors='replace')} ({code})"


_lock = threading.Lock()
_libs: Optional[_Libraries] = None


def libraries() -> _Libraries:
    global _libs
    with _lock:
        if _libs is None:
            _libs = _Libraries()
        return _libs


class Decoder:
    """One libavcodec decoder of `codec` ("h264", "mpeg4" or "vp9").

    :meth:`decode` takes one packet (bytes) and yields the frames it
    completes; :meth:`flush` yields the frames still held at the end of
    the stream.  A frame is ``(y, u, v, width)``: numpy views of the
    decoder's planes, ``(h, linesize)`` and ``((h+1)//2, linesize)``
    uint8, valid until the next frame is taken (the decoder then reuses
    its buffers), and the picture's width (a linesize is padded past
    it).  Frames come out in display order."""

    def __init__(self, codec: str):
        if codec not in CODECS:
            raise ValueError(f"no decoder for {codec!r}: H.264, MPEG-4 "
                             f"Part 2 and VP9 are read (ROADMAP.md queue 1 "
                             f"item 4)")
        self.codec = codec
        self._libs = libs = libraries()
        self._ctx = self._packet = self._frame = None
        av = libs.avcodec
        found = av.avcodec_find_decoder_by_name(codec.encode())
        if not found:
            raise RuntimeError(f"{libs.path} has no {codec} decoder")
        self._ctx = ctypes.c_void_p(av.avcodec_alloc_context3(found))
        self._packet = ctypes.c_void_p(av.av_packet_alloc())
        self._frame = ctypes.c_void_p(libs.avutil.av_frame_alloc())
        if not (self._ctx and self._packet and self._frame):
            self.close()
            raise MemoryError("libavcodec could not allocate a decoder")
        err = av.avcodec_open2(self._ctx, found, None)
        if err < 0:
            self.close()
            raise RuntimeError(f"avcodec_open2({codec}): {libs.error(err)}")

    def _send(self, data: Optional[bytes], key: bool) -> None:
        av = self._libs.avcodec
        if data is None:
            err = av.avcodec_send_packet(self._ctx, None)
        else:
            buf = ctypes.create_string_buffer(data, len(data))
            pkt = _Packet.from_address(self._packet.value)
            # not reference-counted: the decoder copies the bytes
            pkt.data, pkt.size = ctypes.addressof(buf), len(data)
            pkt.flags = AV_PKT_FLAG_KEY if key else 0
            err = av.avcodec_send_packet(self._ctx, self._packet)
            pkt.data, pkt.size = None, 0
        if err < 0 and err != AVERROR_EOF:
            raise RuntimeError(f"{self.codec} decoder refused a packet: "
                               f"{self._libs.error(err)}")

    def _frames(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray,
                                        int]]:
        av = self._libs.avcodec
        while True:
            err = av.avcodec_receive_frame(self._ctx, self._frame)
            if err in (AVERROR_EAGAIN, AVERROR_EOF):
                return
            if err < 0:
                raise RuntimeError(f"{self.codec} decoding failed: "
                                   f"{self._libs.error(err)}")
            yield self._planes()

    def _planes(self):
        f = _Frame.from_address(self._frame.value)
        if f.format != AV_PIX_FMT_YUV420P:
            what = ("full-range 4:2:0 (yuvj420p)"
                    if f.format == AV_PIX_FMT_YUVJ420P else
                    f"pixel format {f.format}")
            raise ValueError(f"{self.codec} frames in {what}: only "
                             f"limited-range 8-bit 4:2:0 (yuv420p) is read "
                             f"(ROADMAP.md queue 1 item 4)")
        h, ch = f.height, (f.height + 1) // 2
        planes = []
        for i, rows in ((0, h), (1, ch), (2, ch)):
            pitch = f.linesize[i]
            buf = (ctypes.c_uint8 * (rows * pitch)).from_address(f.data[i])
            planes.append(np.ctypeslib.as_array(buf).reshape(rows, pitch))
        return (*planes, f.width)

    def probe(self, packets: Iterator[Tuple[bytes, bool]]) -> None:
        """Decode the stream's first pictures and forget them, as
        libavformat's ``avformat_find_stream_info`` does before cv2
        decodes an H.264 stream.  libavcodec's H.264 decoder starts
        with no reorder delay when the SPS states none (no VUI
        ``max_num_reorder_frames``), raises it when a picture comes out of
        order, dropping that picture, and keeps it through
        ``avcodec_flush_buffers``; so after the probe the stream's first
        B pictures come out as cv2 gives them.  Stops where libavformat
        stops (``has_decode_delay_been_guessed``): at 7 pictures out, 18
        when 3 are held back, 20 at 4 or more."""
        sent = got = 0
        for data, key in packets:
            self._send(data, key)
            sent += 1
            got += sum(1 for _ in self._frames())
            held = sent - got
            if got >= (7 if held < 3 else 18 if held < 4 else 20):
                break
        self._libs.avcodec.avcodec_flush_buffers(self._ctx)

    def decode(self, data: bytes, key: bool = False):
        self._send(data, key)
        return self._frames()

    def flush(self):
        self._send(None, False)
        return self._frames()

    def close(self) -> None:
        libs = self._libs
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
