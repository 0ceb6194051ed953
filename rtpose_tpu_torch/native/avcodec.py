"""H.264, HEVC, MPEG-1 / MPEG-2 video, MPEG-4 Part 2 and VP9 decoding on the host
through FFmpeg's ``libavcodec``, the one that the machine's OpenCV wheel
bundles, loaded by path with ctypes (as ``native/imgpipe.py`` links
Pillow's libjpeg); and libavcodec's parsers, which split an elementary
stream into frames where the container does not (MPEG-TS, MPEG program
streams).

Why the host: the card's machine mounts the driver's NVDEC library
(``libnvcuvid.so.1``, driver 580.159.03), but every call of it fails
there, ``cuvidGetDecoderCaps`` included, with CUDA error 2
(``scripts/torch_probe_video.py``).  So the video reader decodes here
and converts the decoded 4:2:0 planes to BGR on the card
(``ops.kernels.yuv420_to_bgr``, ``ops.kernels.yuv420p10_to_bgr``).

Only version-stable pieces of the API are used: ``avcodec_find_decoder_by_name``,
``avcodec_alloc_context3``, ``avcodec_open2``, ``avcodec_send_packet``,
``avcodec_receive_frame`` and the allocators and destructors of the
context, the packet and the frame; of ``AVPacket`` its leading fields
(``data``, ``size``, ``flags`` set; ``pts`` and ``dts`` left unset) and
of ``AVFrame`` its ``data``, ``linesize``, ``width``, ``height`` and
``format``, whose places have not moved since FFmpeg 4.  The colour is
the codec context's, through its options (``av_opt_set_int`` /
``av_opt_get_int``; in ``options_table.h`` since FFmpeg 1.x, no field
offset): the container's ``colorspace``, ``color_range``,
``chroma_sample_location``, ``color_primaries`` and ``color_trc`` are
set before ``avcodec_open2``, as
libavformat copies a stream's parameters into the decoder for cv2, and
read back after each frame, when the decoder has put in their place
what the bitstream states (:class:`FrameColour`).  The parsers
(:class:`Parser`) take ``avcodec_descriptor_get_by_name`` (of whose
``AVCodecDescriptor`` only the leading ``id`` is read),
``av_get_pix_fmt_name`` / ``av_get_pix_fmt`` (the names of pixel
formats), ``av_parser_init``, ``av_parser_parse2`` and
``av_parser_close``, all unchanged since FFmpeg 0.x; no field of
``AVCodecParserContext`` is read.  Packets go in
as the demuxer gives them (H.264 as Annex-B with its parameter sets in
the stream; MPEG-4 with its VOL headers ahead of the first frame).
Frames come out in display
order; an H.264 stream is first probed (:meth:`Decoder.probe`) as
libavformat probes it for cv2, so that a stream whose SPS states no
reorder delay gives its B pictures as cv2 does.  MPEG-1, MPEG-2 and HEVC
streams need no probe: MPEG-1/2 decoders reorder their B pictures from
the first, whatever came before, and an HEVC SPS always states its
reorder delay (``sps_max_num_reorder_pics``), which the decoder follows.
4:2:0 frames of 8 bits (``yuv420p``, full-range ``yuvj420p``) and of 10
bits (``yuv420p10le``: HEVC Main 10, H.264 High 10, VP9 profile 2) are
taken; 4:2:2, 4:4:4, 4:0:0 (gray) and 12-bit frames are refused by name
(ROADMAP.md item 4i), as is any other format.  Nothing is loaded at
import; without the library the first decoder or parser raises, naming
where it looked.
"""

from __future__ import annotations

import ctypes
import glob
import os
import site
import sys
import threading
from typing import Iterator, List, NamedTuple, Optional, Tuple

import numpy as np

CODECS = ("h264", "hevc", "mpeg4", "vp9", "mpeg1video", "mpeg2video")
# libavcodec's parsers, by the decoder they split a stream for: the
# ``mpegvideo`` parser serves both MPEG-1 and MPEG-2
PARSERS = {"mpeg1video": "mpegvideo", "mpeg2video": "mpegvideo",
           "mpeg4": "mpeg4video", "h264": "h264", "hevc": "hevc"}
AV_PIX_FMT_YUV420P = 0
# the frames taken, by pixel format name: (bits a sample, full range)
READ_FORMATS = {"yuv420p": (8, False), "yuvj420p": (8, True),
                "yuv420p10le": (10, False)}
AVCOL_RANGE_MPEG, AVCOL_RANGE_JPEG = 1, 2
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


class StreamColour(NamedTuple):
    """What a container states of its video's colour (None: nothing):
    the H.273 matrix (``colr``, Matroska ``MatrixCoefficients``),
    whether the range is full, the chroma location (``AVChromaLocation``:
    1 left, 2 center, 3 top left, ...), the primaries and the transfer."""
    matrix: Optional[int] = None
    full: Optional[bool] = None
    chroma_location: Optional[int] = None
    primaries: Optional[int] = None
    transfer: Optional[int] = None


class FrameColour(NamedTuple):
    """The colour of a decoded frame as the decoder settled it: the
    matrix (``AVColorSpace``, H.273's numbers: 2 unspecified), full range
    (``color_range`` JPEG, or a ``yuvj420p`` frame), the chroma location
    (``AVChromaLocation``, 0 unspecified), the bits a sample, the
    primaries and the transfer (H.273's numbers)."""
    matrix: int
    full: bool
    chroma_location: int
    depth: int
    primaries: int = 2
    transfer: int = 2


def _refused_format(name: str) -> str:
    """What a frame of pixel format `name` is, for the refusal."""
    if name.startswith("gray"):
        return f"4:0:0 ({name})"
    for tag, what in (("yuv422", "4:2:2"), ("yuvj422", "4:2:2"),
                      ("yuv444", "4:4:4"), ("yuvj444", "4:4:4"),
                      ("yuv440", "4:4:0"), ("yuv411", "4:1:1")):
        if name.startswith(tag):
            return f"{what} ({name})"
    if name.startswith("yuv420p") and name[7:9].isdigit():
        return f"{name[7:9]}-bit 4:2:0 ({name})"
    return name


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
                (self.avcodec, "avcodec_descriptor_get_by_name", P,
                 [ctypes.c_char_p]),
                (self.avcodec, "av_parser_init", P, [I]),
                (self.avcodec, "av_parser_parse2", I,
                 [P, P, P, P, P, I, ctypes.c_int64, ctypes.c_int64,
                  ctypes.c_int64]),
                (self.avcodec, "av_parser_close", None, [P]),
                (self.avcodec, "av_packet_free", None, [P]),
                (self.avutil, "av_frame_alloc", P, []),
                (self.avutil, "av_frame_free", None, [P]),
                (self.avutil, "av_get_pix_fmt_name", ctypes.c_char_p, [I]),
                (self.avutil, "av_get_pix_fmt", I, [ctypes.c_char_p]),
                (self.avutil, "av_opt_set_int", I,
                 [P, ctypes.c_char_p, ctypes.c_int64, I]),
                (self.avutil, "av_opt_get_int", I,
                 [P, ctypes.c_char_p, I, ctypes.POINTER(ctypes.c_int64)]),
                (self.avutil, "avutil_version", ctypes.c_uint, []),
                (self.avutil, "av_strerror", I,
                 [I, ctypes.c_char_p, ctypes.c_size_t])):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = res, args
        self.path = self.avcodec._name
        self.read_formats = {self.avutil.av_get_pix_fmt(name.encode()): v
                             for name, v in READ_FORMATS.items()}

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
    """One libavcodec decoder of `codec` (one of :data:`CODECS`).

    :meth:`decode` takes one packet (bytes) and yields the frames it
    completes; :meth:`flush` yields the frames still held at the end of
    the stream.  A frame is ``(y, u, v, width)``: numpy views of the
    decoder's planes, ``(h, pitch)`` and ``((h+1)//2, pitch)`` uint8
    (uint16 for 10-bit frames: the linesize in bytes halved), valid until
    the next frame is taken (the decoder then reuses its buffers), and
    the picture's width (a linesize is padded past it); ``colour`` is
    then that frame's :class:`FrameColour`.  Frames come out in display
    order.  `colour` is the container's :class:`StreamColour`, which the
    decoder starts from."""

    def __init__(self, codec: str, colour: Optional[StreamColour] = None):
        if codec not in CODECS:
            raise ValueError(f"no decoder for {codec!r}: H.264, HEVC, "
                             f"MPEG-1/2 video, MPEG-4 Part 2 and VP9 are "
                             f"read (ROADMAP.md queue 1 item 4)")
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
        self.colour: Optional[FrameColour] = None
        colour = colour or StreamColour()
        for name, value in (
                ("colorspace", colour.matrix),
                ("color_range", None if colour.full is None else
                 AVCOL_RANGE_JPEG if colour.full else AVCOL_RANGE_MPEG),
                ("chroma_sample_location", colour.chroma_location),
                ("color_primaries", colour.primaries),
                ("color_trc", colour.transfer)):
            if value is not None:
                self._option(name, value)
        err = av.avcodec_open2(self._ctx, found, None)
        if err < 0:
            self.close()
            raise RuntimeError(f"avcodec_open2({codec}): {libs.error(err)}")

    def _option(self, name: str, value: Optional[int] = None) -> int:
        """Set (`value` given) or read the codec context's option `name`;
        raises, naming the library, where it has no such option."""
        avutil = self._libs.avutil
        if value is not None:
            err = avutil.av_opt_set_int(self._ctx, name.encode(), value, 0)
        else:
            out = ctypes.c_int64()
            err = avutil.av_opt_get_int(self._ctx, name.encode(), 0,
                                        ctypes.byref(out))
            value = out.value
        if err < 0:
            self.close()
            raise RuntimeError(f"{self._libs.path}: the codec context's "
                               f"option {name!r}: {self._libs.error(err)}")
        return value

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
        taken = self._libs.read_formats.get(f.format)
        if taken is None:
            name = self._libs.avutil.av_get_pix_fmt_name(f.format)
            name = name.decode() if name else f"pixel format {f.format}"
            raise ValueError(f"{self.codec} frames in "
                             f"{_refused_format(name)}: only 4:2:0 of 8 "
                             f"or 10 bits (yuv420p, yuvj420p, yuv420p10le) "
                             f"is read (ROADMAP.md queue 1 item 4i)")
        depth, full = taken
        self.colour = FrameColour(
            self._option("colorspace"),
            full or self._option("color_range") == AVCOL_RANGE_JPEG,
            self._option("chroma_sample_location"), depth,
            self._option("color_primaries"), self._option("color_trc"))
        h, ch = f.height, (f.height + 1) // 2
        item = np.uint16 if depth > 8 else np.uint8
        size = np.dtype(item).itemsize
        planes = []
        for i, rows in ((0, h), (1, ch), (2, ch)):
            pitch = f.linesize[i]
            buf = (ctypes.c_uint8 * (rows * pitch)).from_address(f.data[i])
            planes.append(np.ctypeslib.as_array(buf).view(item).reshape(
                rows, pitch // size))
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


AV_NOPTS_VALUE = -(1 << 63)


class Parser:
    """libavcodec's parser for `codec` (a key of :data:`PARSERS`): the
    ``mpegvideo``, ``mpeg4video``, ``h264`` or ``hevc`` parser, which
    libavformat runs over a stream whose packets are not frames
    (``need_parsing``, the elementary streams of MPEG-TS and MPEG program
    streams).  :meth:`parse` takes the next bytes of
    the stream and gives the frames they complete; :meth:`flush` gives
    the last.  A frame is bytes as the decoder takes it (the parser keeps
    every start code and header of the stream)."""

    def __init__(self, codec: str):
        if codec not in PARSERS:
            raise ValueError(f"no parser for {codec!r}: the MPEG-1/2, "
                             f"MPEG-4 Part 2, H.264 and HEVC parsers are "
                             f"used")
        self.codec = codec
        self._libs = libs = libraries()
        self._ctx = self._avctx = None
        av = libs.avcodec
        desc = av.avcodec_descriptor_get_by_name(codec.encode())
        if not desc:
            raise RuntimeError(f"{libs.path} knows no codec {codec}")
        codec_id = ctypes.c_int.from_address(desc).value
        self._ctx = ctypes.c_void_p(av.av_parser_init(codec_id))
        if not self._ctx:
            raise RuntimeError(f"{libs.path} has no {PARSERS[codec]} parser "
                               f"(for {codec})")
        self._avctx = ctypes.c_void_p(av.avcodec_alloc_context3(None))
        if not self._avctx:
            self.close()
            raise MemoryError("libavcodec could not allocate a context")

    def _parse(self, data: bytes) -> Iterator[bytes]:
        """av_parser_parse2 over `data` until it is used up (empty data:
        until the parser gives no more, its end-of-stream flush)."""
        av = self._libs.avcodec
        buf = ctypes.create_string_buffer(data, len(data))
        out, out_size = ctypes.c_void_p(), ctypes.c_int()
        at = 0
        while not data or at < len(data):
            used = av.av_parser_parse2(
                self._ctx, self._avctx, ctypes.byref(out),
                ctypes.byref(out_size), ctypes.addressof(buf) + at,
                len(data) - at, AV_NOPTS_VALUE, AV_NOPTS_VALUE, 0)
            if used < 0:
                raise RuntimeError(f"the {PARSERS[self.codec]} parser "
                                   f"failed: {self._libs.error(used)}")
            at += used
            if out_size.value:
                yield ctypes.string_at(out.value, out_size.value)
            elif not data or not used:
                return

    def parse(self, data: bytes) -> List[bytes]:
        return list(self._parse(data)) if data else []

    def flush(self) -> List[bytes]:
        return list(self._parse(b""))

    def close(self) -> None:
        av = self._libs.avcodec
        if self._ctx:
            av.av_parser_close(self._ctx)
        if self._avctx:
            av.avcodec_free_context(ctypes.byref(self._avctx))
        self._ctx = self._avctx = None

    def __del__(self):
        if getattr(self, "_libs", None) is not None:
            self.close()
