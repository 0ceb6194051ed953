"""Motion-JPEG AVI files read and written in pure Python over Pillow, in
place of ``cv2.VideoCapture`` / ``cv2.VideoWriter`` (the JAX package's
rtpose_tpu/demo/video_demo.py:19-42, :78-80).

The container is RIFF AVI: a ``hdrl`` list (the ``avih`` main header, one
``strl`` with the ``vids`` / ``MJPG`` stream header and its
BITMAPINFOHEADER), a ``movi`` list of ``00dc`` chunks, one baseline JPEG
a frame, and an ``idx1`` index; the frame counts in both headers are
written when the file is closed.  cv2 reads these files (its AVI reader
needs ``idx1`` to open one), and :func:`open_video` reads cv2's own
``MJPG`` AVI files, OpenDML ``AVIX`` extensions included, frame for
frame.

The JAX demo writes XVID; the port writes MJPG (another codec, the same
feature).  Other containers and codecs (mp4, H.264, XVID, ...) need a
decoder this package does not have: the machine of the card has no
``ffmpeg`` either, so :func:`open_video` refuses them with an error that
names the container (ROADMAP.md queue 1 item 4).
"""

from __future__ import annotations

import io
import struct
from fractions import Fraction
from typing import BinaryIO, Iterator, List, Optional, Tuple

import numpy as np

from ..data.imwrite import JPEG_OPTIONS

AVIF_HASINDEX = 0x10
AVIIF_KEYFRAME = 0x10


def _not_mjpg_avi(path: str, what: str) -> ValueError:
    return ValueError(
        f"{path}: {what}; this reader takes Motion-JPEG AVI files only "
        f"(other containers and codecs need ffmpeg, which the port does "
        f"not use: ROADMAP.md queue 1 item 4)")


def _chunks(f: BinaryIO, end: int) -> Iterator[Tuple[bytes, int, int]]:
    """(fourcc, data offset, size) of the RIFF chunks from here to `end`;
    a LIST chunk's size counts its list type."""
    while f.tell() + 8 <= end:
        head = f.read(8)
        fourcc, size = head[:4], struct.unpack("<I", head[4:])[0]
        start = f.tell()
        yield fourcc, start, size
        f.seek(start + size + (size & 1))


class VideoReader:
    """A Motion-JPEG AVI's frames, decoded one at a time as ``(H, W, 3)``
    uint8 BGR: the part of ``cv2.VideoCapture`` the demo uses (``read``,
    ``release``), with the stream's ``fps``, ``size`` (w, h) and
    ``frame_count``."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        try:
            self._frames, self.fps, self.size = self._parse()
        except BaseException:
            self._f.close()
            raise
        self._next = 0

    def _parse(self):
        f, path = self._f, self.path
        f.seek(0, io.SEEK_END)
        file_end = f.tell()
        f.seek(0)
        head = f.read(12)
        if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"AVI ":
            raise _not_mjpg_avi(path, f"not an AVI file (starts with "
                                      f"{head[:12]!r})")
        frames: List[Tuple[int, int]] = []
        fps: Optional[float] = None
        size = None
        stream = None          # the MJPG stream's chunk id prefix, b"00"
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
                    fps, size, stream = self._header(off + 4, off + n)
                elif kind == b"movi":
                    if stream is None:
                        raise _not_mjpg_avi(path, "no Motion-JPEG video "
                                                  "stream")
                    frames += self._movi(off + 4, off + n, stream)
                f.seek(off + n + (n & 1))
        if stream is None:
            raise _not_mjpg_avi(path, "no Motion-JPEG video stream")
        return frames, fps, size

    def _header(self, start: int, end: int):
        """fps, (w, h) and the chunk id prefix of the first video stream,
        which must be Motion-JPEG."""
        f = self._f
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
                if b"MJPG" not in (handler.upper(), compression.upper()):
                    raise _not_mjpg_avi(self.path, f"video codec "
                                        f"{handler!r}/{compression!r}")
                scale, rate = struct.unpack("<II", strh[20:28])
                w, h = struct.unpack("<ii", strf[4:12])
                fps = rate / scale if scale else None
                return fps, (w, abs(h)), b"%02d" % index
            index += 1
            f.seek(off + n + (n & 1))
        raise _not_mjpg_avi(self.path, "no video stream")

    def _movi(self, start: int, end: int, stream: bytes):
        """(offset, size) of each frame chunk of `stream`, in file order;
        empty chunks (dropped frames) skipped."""
        self._f.seek(start)
        return [(off, n) for fourcc, off, n in _chunks(self._f, end)
                if fourcc[:2] == stream and fourcc[2:] in (b"dc", b"db")
                and n]

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


def open_video(path: str) -> VideoReader:
    """Open a Motion-JPEG AVI for reading (``cv2.VideoCapture``'s place in
    the JAX demo).  Raises FileNotFoundError for a missing file and
    ValueError, naming the container and ROADMAP.md queue 1 item 4, for
    a file that is not Motion-JPEG AVI."""
    return VideoReader(path)


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
