"""Video files read and written in pure Python, in place of
``cv2.VideoCapture`` / ``cv2.VideoWriter`` (the JAX package's
rtpose_tpu/demo/video_demo.py:19-42, :78-80).

:func:`open_video` reads what the JAX demo's ``cv2.VideoCapture`` reads
of its users' files, frame for frame as cv2 gives them:

- Motion-JPEG AVI (``MJPG``): each ``00dc`` chunk a JPEG, decoded on the
  host by Pillow (cv2's own AVI writer's and FFmpeg's files, OpenDML
  ``AVIX`` extensions included);
- H.264 and MPEG-4 Part 2 (XVID, DivX, ``mp4v``: what the JAX demo and
  cv2's wheels write) in AVI (``XVID``, ``DIVX``, ``DX50``, ``FMP4``,
  ``MP4V``, ``H264``, ``AVC1``, ``X264`` chunks) or in MP4 / MOV
  (``demo/mp4.py``), with the rotation of the track honoured as
  ``CAP_PROP_ORIENTATION_AUTO`` does: decoded on the host by FFmpeg's
  libavcodec from the OpenCV wheel (``native/avcodec.py``), the planes
  converted to BGR and turned on the card (``ops.kernels.yuv420_to_bgr``,
  cv2's arithmetic to the bit).  ``device="cpu"`` converts with the
  kernel's plain version, for tests; without a card, and without the
  library, opening such a file raises.

Everything else is refused with an error that names the container or
codec and ROADMAP.md queue 1 item 4: Matroska / WebM, MPEG-TS, HEVC, VP9,
AV1, fragmented MP4, multi-entry edit lists.

:class:`VideoWriter` writes Motion-JPEG AVI: a ``hdrl`` list (the
``avih`` main header, one ``strl`` with the ``vids`` / ``MJPG`` stream
header and its BITMAPINFOHEADER), a ``movi`` list of ``00dc`` chunks,
one baseline JPEG a frame, and an ``idx1`` index; the frame counts in
both headers are written when the file is closed.  cv2 reads these
files (its AVI reader needs ``idx1`` to open one).  The JAX demo writes
XVID; the port writes MJPG (another codec, the same feature).
"""

from __future__ import annotations

import io
import struct
import time
from fractions import Fraction
from typing import BinaryIO, Iterator, List, Optional, Tuple

import numpy as np

from ..data.imwrite import JPEG_OPTIONS
from . import mp4

AVIF_HASINDEX = 0x10
AVIIF_KEYFRAME = 0x10
# AVI stream handlers / compressions (upper case) -> the decoder
AVI_CODECS = {b"MJPG": "mjpeg", b"XVID": "mpeg4", b"DIVX": "mpeg4",
              b"DX50": "mpeg4", b"FMP4": "mpeg4", b"MP4V": "mpeg4",
              b"H264": "h264", b"AVC1": "h264", b"X264": "h264"}


def _chunks(f: BinaryIO, end: int) -> Iterator[Tuple[bytes, int, int]]:
    """(fourcc, data offset, size) of the RIFF chunks from here to `end`;
    a LIST chunk's size counts its list type."""
    while f.tell() + 8 <= end:
        head = f.read(8)
        fourcc, size = head[:4], struct.unpack("<I", head[4:])[0]
        start = f.tell()
        yield fourcc, start, size
        f.seek(start + size + (size & 1))


class AviStream:
    """The first video stream of a RIFF AVI file: its codec (a key of
    :data:`AVI_CODECS`' values), fps, (w, h), the codec's extra data
    (BITMAPINFOHEADER past its 40 bytes) and each frame chunk's (offset,
    size) in file order, empty chunks (dropped frames) skipped."""

    def __init__(self, path: str, f: BinaryIO):
        self.path = path
        self.codec: Optional[str] = None
        self.fps: Optional[float] = None
        self.size: Tuple[int, int] = (0, 0)
        self.extradata = b""
        self.frames: List[Tuple[int, int]] = []
        f.seek(0, io.SEEK_END)
        file_end = f.tell()
        stream = None          # the video stream's chunk id prefix, b"00"
        f.seek(0)
        for riff, start, riff_size in _chunks(f, file_end):
            if riff != b"RIFF":
                continue
            riff_end = min(start + riff_size, file_end)
            f.seek(start + 4)                    # past "AVI " / "AVIX"
            for fourcc, off, n in _chunks(f, riff_end):
                if fourcc != b"LIST":
                    continue
                f.seek(off)
                kind = f.read(4)
                if kind == b"hdrl":
                    stream = self._header(f, off + 4, off + n)
                elif kind == b"movi":
                    if stream is None:
                        raise mp4.refusal(path, "an AVI with no video "
                                                "stream")
                    f.seek(off + 4)
                    self.frames += [
                        (o, size) for fourcc, o, size in _chunks(f, off + n)
                        if fourcc[:2] == stream
                        and fourcc[2:] in (b"dc", b"db") and size]
                f.seek(off + n + (n & 1))
        if stream is None:
            raise mp4.refusal(path, "an AVI with no video stream")

    def _header(self, f: BinaryIO, start: int, end: int) -> bytes:
        """Read the first video stream's header; its chunk id prefix."""
        f.seek(start)
        index = 0
        for fourcc, off, n in _chunks(f, end):
            if fourcc != b"LIST":
                continue
            f.seek(off)
            if f.read(4) != b"strl":
                continue
            strh = strf = None
            for sub, soff, sn in _chunks(f, off + n):
                if sub in (b"strh", b"strf"):
                    f.seek(soff)
                    data = f.read(sn)
                    if sub == b"strh":
                        strh = data
                    else:
                        strf = data
            if strh is not None and strh[:4] == b"vids":
                handler = strh[4:8]
                compression = strf[16:20] if strf and len(strf) >= 20 \
                    else b""
                codec = (AVI_CODECS.get(compression.upper())
                         or AVI_CODECS.get(handler.upper()))
                if codec is None:
                    raise mp4.refusal(self.path, f"AVI video codec "
                                                 f"{handler!r}/"
                                                 f"{compression!r}")
                scale, rate = struct.unpack("<II", strh[20:28])
                w, h = struct.unpack("<ii", strf[4:12])
                size = struct.unpack("<I", strf[:4])[0]
                self.codec, self.size = codec, (w, abs(h))
                self.fps = rate / scale if scale else None
                self.extradata = strf[40:size] if size > 40 else b""
                return b"%02d" % index
            index += 1
            f.seek(off + n + (n & 1))
        raise mp4.refusal(self.path, "an AVI with no video stream")


class VideoReader:
    """A Motion-JPEG AVI's frames, decoded one at a time as ``(H, W, 3)``
    uint8 BGR: the part of ``cv2.VideoCapture`` the demo uses (``read``,
    ``release``), with the stream's ``fps``, ``size`` (w, h) and
    ``frame_count``."""

    def __init__(self, path: str, stream: AviStream):
        self.path = path
        self._f = open(path, "rb")
        self._frames, self.fps, self.size = (stream.frames, stream.fps,
                                             stream.size)
        self._next = 0

    @property
    def frame_count(self) -> int:
        return len(self._frames)

    def read(self) -> Tuple[bool, Optional[np.ndarray]]:
        """(True, next frame) or (False, None) after the last one."""
        from ..data.imread import decode_bgr

        if self._f.closed or self._next >= len(self._frames):
            return False, None
        off, n = self._frames[self._next]
        self._next += 1
        self._f.seek(off)
        frame = decode_bgr(self._f.read(n))
        if frame is None:
            raise ValueError(f"{self.path}: frame {self._next - 1} is not "
                             f"a JPEG image")
        return True, frame

    def release(self) -> None:
        self._f.close()


class DecodedVideo:
    """An H.264 or MPEG-4 Part 2 stream of an MP4/MOV or AVI file, read
    as ``cv2.VideoCapture`` with ``CAP_PROP_ORIENTATION_AUTO`` reads it:
    ``read()`` gives each frame in display order as ``(H, W, 3)`` uint8
    BGR, turned by ``rotation``; ``fps``, ``size`` (w, h after the turn)
    and ``frame_count`` are cv2's.

    `avi` is the file's parsed AVI stream; without one the file is read
    as MP4/MOV.  The packets are demuxed on the host, decoded there by
    libavcodec, and each picture's planes are copied to `device` and
    converted by ``ops.kernels.yuv420_to_bgr`` (the plain version for
    ``"cpu"``).  The copy returns once the decoder's buffers have been
    read, before the next picture reuses them.  ``seconds`` sums the time of each step:
    ``demux`` (reading a packet and, for H.264, its Annex-B form),
    ``decode`` (libavcodec) and ``convert`` (copy up, kernel, copy back)."""

    def __init__(self, path: str, device="cuda",
                 avi: Optional[AviStream] = None):
        import torch

        from ..native.avcodec import Decoder
        self.path = path
        self.device = torch.device(device)
        self._f = open(path, "rb")
        self._decoder = None
        try:
            self.seconds = {"demux": 0.0, "decode": 0.0, "convert": 0.0}
            t0 = time.perf_counter()
            if avi is not None:
                self.codec, self.fps, self.size = avi.codec, avi.fps, avi.size
                self.rotation = self.rotation_meta = 0
                self.frame_count = len(avi.frames)
                self._skip, self._left = 0, len(avi.frames)
                self._packets = self._avi_packets(avi)
            else:
                track = mp4.read_track(path, self._f)
                self.codec, self.fps, self.size = (track.codec, track.fps,
                                                   track.size)
                self.rotation, self.rotation_meta = (track.rotation,
                                                     track.rotation_meta)
                self.frame_count = track.frame_count
                # pictures outside the edit list's span are dropped
                self._skip, self._left = track.shown
                self._packets = track.packets(self._f)
            self.seconds["demux"] += time.perf_counter() - t0
            if self.device.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(
                    f"{path}: no CUDA card: decoded frames are converted to "
                    f"BGR on the card (device='cpu' converts on the host, "
                    f"for tests)")
            t0 = time.perf_counter()
            self._decoder = Decoder(self.codec)
            self.seconds["decode"] += time.perf_counter() - t0
        except BaseException:
            self.release()
            raise
        self._pictures = self._decode()

    def _avi_packets(self, avi: AviStream) -> Iterator[Tuple[bytes, bool]]:
        for i, (off, n) in enumerate(avi.frames):
            self._f.seek(off)
            data = self._f.read(n)
            if i == 0:
                data = avi.extradata + data
            yield data, mp4.intra_picture(self.codec, data)

    def _decode(self):
        """The decoder's pictures in display order, as it completes them."""
        while True:
            t0 = time.perf_counter()
            packet = next(self._packets, None)
            t1 = time.perf_counter()
            self.seconds["demux"] += t1 - t0
            pictures = (self._decoder.flush() if packet is None else
                        self._decoder.decode(*packet))
            while True:
                t0 = time.perf_counter()
                picture = next(pictures, None)
                self.seconds["decode"] += time.perf_counter() - t0
                if picture is None:
                    break
                yield picture
            if packet is None:
                return

    def read(self) -> Tuple[bool, Optional[np.ndarray]]:
        """(True, next frame) or (False, None) after the last one."""
        import torch

        from ..ops.kernels import yuv420_to_bgr
        if self._decoder is None or not self._left:
            return False, None
        while True:
            picture = next(self._pictures, None)
            if picture is None:
                return False, None
            if self._skip:
                self._skip -= 1
                continue
            break
        self._left -= 1
        t0 = time.perf_counter()
        *planes, width = picture
        planes = [torch.from_numpy(p).to(self.device) for p in planes]
        frame = yuv420_to_bgr(*planes, width=width,
                              rotation=self.rotation).cpu().numpy()
        self.seconds["convert"] += time.perf_counter() - t0
        return True, frame

    def release(self) -> None:
        if self._decoder is not None:
            self._decoder.close()
            self._decoder = None
        self._f.close()


def open_video(path: str, device="cuda"):
    """Open a video file for reading (``cv2.VideoCapture``'s place in the
    JAX demo): a :class:`VideoReader` for Motion-JPEG AVI, a
    :class:`DecodedVideo` for H.264 and MPEG-4 Part 2 in MP4/MOV or AVI,
    which converts its frames on `device`.  Raises FileNotFoundError
    for a missing file and ValueError, naming the container or codec and
    ROADMAP.md queue 1 item 4, for anything else."""
    with open(path, "rb") as f:
        head = f.read(4096)
        if head[:4] == b"RIFF" and head[8:12] == b"AVI ":
            stream = AviStream(path, f)
            if stream.codec == "mjpeg":
                return VideoReader(path, stream)
            return DecodedVideo(path, device, stream)
    if mp4.is_isobmff(head):
        return DecodedVideo(path, device)
    if head[:4] == b"\x1a\x45\xdf\xa3":
        what = "a Matroska/WebM file"
    elif len(head) >= 377 and head[0] == head[188] == 0x47:
        what = "an MPEG-TS stream"
    elif head[:4] == b"RIFF":
        what = f"a RIFF {head[8:12]!r} file, not AVI"
    else:
        what = f"an unknown container (starts with {head[:12]!r})"
    raise mp4.refusal(path, what)


class VideoWriter:
    """Write ``(H, W, 3)`` uint8 BGR frames of one size as a Motion-JPEG
    AVI at `fps` (``cv2.VideoWriter(path, fourcc('M','J','P','G'), fps,
    (w, h))``'s place): each frame a baseline JPEG at cv2's settings
    (quality 95, 4:2:0, ``data.imwrite.JPEG_OPTIONS``);
    :meth:`release` writes the index and the frame counts."""

    def __init__(self, path: str, fps: float, frame_size: Tuple[int, int]):
        self.path = path
        self.width, self.height = (int(v) for v in frame_size)
        if self.width <= 0 or self.height <= 0 or fps <= 0:
            raise ValueError(f"frame size {frame_size} and fps {fps} must "
                             f"be positive")
        rate = Fraction(fps).limit_denominator(1001)
        self._rate, self._scale = rate.numerator, rate.denominator
        self._index: List[Tuple[int, int]] = []    # (offset, size)
        self._max_chunk = 0
        self._f = open(path, "wb")
        self._write_headers()
        self._movi = self._f.tell() - 4            # the "movi" fourcc

    def _headers(self) -> bytes:
        n, w, h = len(self._index), self.width, self.height
        us_per_frame = round(1e6 * self._scale / self._rate)
        bufsize = self._max_chunk + 8
        max_bytes = int(bufsize * self._rate / self._scale)
        avih = struct.pack("<10I4I", us_per_frame, max_bytes, 0,
                           AVIF_HASINDEX, n, 0, 1, bufsize, w, h, 0, 0, 0, 0)
        strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", b"MJPG", 0, 0, 0,
                           0, self._scale, self._rate, 0, n, bufsize,
                           0xFFFFFFFF, 0, 0, 0, w, h)
        strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG",
                           w * h * 3, 0, 0, 0, 0)
        strl = (b"strl" + _chunk(b"strh", strh) + _chunk(b"strf", strf))
        hdrl = b"hdrl" + _chunk(b"avih", avih) + _chunk(b"LIST", strl)
        return _chunk(b"LIST", hdrl)

    def _write_headers(self) -> None:
        self._f.write(b"RIFF" + struct.pack("<I", 0) + b"AVI ")
        self._f.write(self._headers())
        self._f.write(b"LIST" + struct.pack("<I", 0) + b"movi")

    def write(self, frame: np.ndarray) -> None:
        from PIL import Image

        if frame.dtype != np.uint8 or frame.shape != (self.height,
                                                      self.width, 3):
            raise ValueError(f"frames of this video are ({self.height}, "
                             f"{self.width}, 3) uint8, got {frame.dtype} "
                             f"{frame.shape}")
        buf = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(frame[..., ::-1])).save(
            buf, "JPEG", **JPEG_OPTIONS)
        data = buf.getvalue()
        self._index.append((self._f.tell() - self._movi, len(data)))
        self._max_chunk = max(self._max_chunk, len(data))
        self._f.write(_chunk(b"00dc", data))

    def release(self) -> None:
        """Write the index, the sizes and the frame counts, and close."""
        if self._f.closed:
            return
        f = self._f
        try:
            movi_end = f.tell()
            f.write(_chunk(b"idx1", b"".join(
                struct.pack("<4sIII", b"00dc", AVIIF_KEYFRAME, off, n)
                for off, n in self._index)))
            end = f.tell()
            f.seek(4)
            f.write(struct.pack("<I", end - 8))
            f.write(b"AVI ")
            f.write(self._headers())
            f.write(struct.pack("<4sI", b"LIST", movi_end - self._movi))
        finally:
            f.close()


def _chunk(fourcc: bytes, data: bytes) -> bytes:
    """A RIFF chunk: fourcc, little-endian size, data, pad to even."""
    return fourcc + struct.pack("<I", len(data)) + data + b"\0" * (
        len(data) & 1)
