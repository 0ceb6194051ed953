"""A camera read as ``cv2.VideoCapture(index)`` reads it on Linux (the
capture of rtpose_tpu/demo/web_demo.py), without cv2: Video4Linux2 on
``/dev/video<index>`` through ``os.open``, ``fcntl.ioctl``, ``mmap`` and
``select``.

As cv2's V4L2 backend does by default, :func:`open_camera` asks for
640x480 and takes the first pixel format the device keeps, in cv2's
order of the two this module converts: YUYV (4:2:2), then Motion-JPEG;
it maps 4 device buffers and starts the stream.  cv2 4.x tries BGR24,
RGB24, YVU420, YUV420 and YUV411P before YUYV, and UYVY, NV12, NV21 and
two Bayer formats between YUYV and Motion-JPEG (``cap_v4l.cpp``
``autosetup_capture_mode_v4l2``, as far as its source is known here:
neither machine has it or a camera); a camera that offers one of those
besides YUYV or Motion-JPEG is read by cv2 in that format and by this
module in YUYV or Motion-JPEG.

``read()`` waits for a filled buffer (10 s at most, cv2's default),
copies it out, gives the buffer back to the device and converts it:
YUYV by :func:`yuyv_to_bgr`, ``cv2.cvtColor(..., COLOR_YUV2BGR_YUYV)``'s
fixed-point BT.601 to the bit (tests/test_torch_webcam.py), Motion-JPEG
by ``data.imread.decode_bgr`` (``cv2.imdecode``'s pixels).  A device
that keeps another size is read at its size.

Every system call goes through :data:`SYSCALLS`, so a test can put a
device in software there (``demo.scripted_camera``).  The requests and
struct sizes are those of ``linux/videodev2.h`` on x86-64.
"""

from __future__ import annotations

import errno
import fcntl
import mmap
import os
import select
import struct
import time
from typing import Optional, Tuple

import numpy as np


def _ioc(direction: int, nr: int, size: int) -> int:
    """``_IOC(direction, 'V', nr, size)``."""
    return (direction << 30) | (size << 16) | (ord("V") << 8) | nr


_READ, _WRITE = 2, 1
CAPABILITY_SIZE = 104       # struct v4l2_capability
FORMAT_SIZE = 208           # struct v4l2_format (its union 8-aligned)
REQUESTBUFFERS_SIZE = 20    # struct v4l2_requestbuffers
BUFFER_SIZE = 88            # struct v4l2_buffer (timeval of 16 bytes)
VIDIOC_QUERYCAP = _ioc(_READ, 0, CAPABILITY_SIZE)
VIDIOC_S_FMT = _ioc(_READ | _WRITE, 5, FORMAT_SIZE)
VIDIOC_REQBUFS = _ioc(_READ | _WRITE, 8, REQUESTBUFFERS_SIZE)
VIDIOC_QUERYBUF = _ioc(_READ | _WRITE, 9, BUFFER_SIZE)
VIDIOC_QBUF = _ioc(_READ | _WRITE, 15, BUFFER_SIZE)
VIDIOC_DQBUF = _ioc(_READ | _WRITE, 17, BUFFER_SIZE)
VIDIOC_STREAMON = _ioc(_WRITE, 18, 4)
VIDIOC_STREAMOFF = _ioc(_WRITE, 19, 4)

CAP_VIDEO_CAPTURE = 0x1
CAP_STREAMING = 0x04000000
CAP_DEVICE_CAPS = 0x80000000
BUF_TYPE_VIDEO_CAPTURE = 1
MEMORY_MMAP = 1


def fourcc(code: str) -> int:
    return struct.unpack("<I", code.encode("ascii"))[0]


def fourcc_name(value: int) -> str:
    return struct.pack("<I", value).decode("latin-1")


# the formats this module converts, in the order cv2 4.x tries them
FORMATS = ("YUYV", "MJPG")
WIDTH, HEIGHT = 640, 480    # cv2's DEFAULT_V4L_WIDTH / _HEIGHT
BUFFERS = 4                 # cv2's DEFAULT_V4L_BUFFERS
TIMEOUT_S = 10.0            # cv2's select timeout


class OsCalls:
    """The system calls of a real device."""

    def open(self, path: str) -> int:
        return os.open(path, os.O_RDWR | os.O_NONBLOCK)

    def close(self, fd: int) -> None:
        os.close(fd)

    def ioctl(self, fd: int, request: int, buf: bytearray) -> None:
        fcntl.ioctl(fd, request, buf, True)

    def mmap(self, fd: int, length: int, offset: int):
        return mmap.mmap(fd, length, mmap.MAP_SHARED,
                         mmap.PROT_READ | mmap.PROT_WRITE, offset=offset)

    def wait_readable(self, fd: int, timeout: float) -> bool:
        return bool(select.select([fd], [], [], timeout)[0])


SYSCALLS = OsCalls()


def yuyv_to_bgr(buf, h: int, w: int, stride: Optional[int] = None
                ) -> np.ndarray:
    """A YUYV (Y0 U Y1 V per pixel pair) frame of `h` rows of `stride`
    bytes (default ``2 * w``) -> (h, w, 3) uint8 BGR, as
    ``cv2.cvtColor(frame, cv2.COLOR_YUV2BGR_YUYV)``: BT.601 studio range
    in 20-bit fixed point, ``max(Y - 16, 0) * 1220542`` plus the chroma
    terms and a half, shifted down and saturated."""
    if w % 2:
        raise ValueError(f"YUYV frames have an even width, not {w}")
    stride = 2 * w if stride is None else stride
    rows = np.frombuffer(buf, np.uint8, count=h * stride).reshape(h, stride)
    p = rows[:, :2 * w].reshape(h, w // 2, 4).astype(np.int32)
    y = np.maximum(p[..., 0::2] - 16, 0) * 1220542 + (1 << 19)
    u = (p[..., 1] - 128)[..., None]
    v = (p[..., 3] - 128)[..., None]
    bgr = np.stack([y + 2116026 * u, y - 852492 * v - 409993 * u,
                    y + 1673527 * v], axis=-1) >> 20
    return np.clip(bgr, 0, 255).astype(np.uint8).reshape(h, w, 3)


class V4L2Camera:
    """An open, streaming capture device; see :func:`open_camera`."""

    def __init__(self, index: int):
        self.path = f"/dev/video{index}"
        self.index = index
        self._sys = SYSCALLS
        try:
            self._fd: Optional[int] = self._sys.open(self.path)
        except OSError as e:
            raise RuntimeError(f"cannot open camera {index} ({self.path}: "
                               f"{e.strerror or e})") from None
        self._maps: list = []
        self._streaming = False
        try:
            self._start()
        except BaseException:
            self.release()
            raise

    def _ioctl(self, request: int, buf: bytearray, what: str) -> None:
        try:
            self._sys.ioctl(self._fd, request, buf)
        except OSError as e:
            raise RuntimeError(f"camera {self.index} ({self.path}): {what} "
                               f"failed: {e.strerror or e}") from None

    def _start(self) -> None:
        cap = bytearray(CAPABILITY_SIZE)
        self._ioctl(VIDIOC_QUERYCAP, cap, "VIDIOC_QUERYCAP")
        caps, device_caps = struct.unpack_from("<II", cap, 84)
        if caps & CAP_DEVICE_CAPS:
            caps = device_caps
        if not (caps & CAP_VIDEO_CAPTURE and caps & CAP_STREAMING):
            raise RuntimeError(f"camera {self.index} ({self.path}) is not a "
                               f"streaming capture device (capabilities "
                               f"{caps:#x})")
        self.fourcc, self.width, self.height, self.stride = self._set_format()
        req = bytearray(REQUESTBUFFERS_SIZE)
        struct.pack_into("<III", req, 0, BUFFERS, BUF_TYPE_VIDEO_CAPTURE,
                         MEMORY_MMAP)
        self._ioctl(VIDIOC_REQBUFS, req, "VIDIOC_REQBUFS")
        count = struct.unpack_from("<I", req, 0)[0]
        if count < 2:     # cv2 refuses fewer too
            raise RuntimeError(f"camera {self.index} ({self.path}) granted "
                               f"{count} buffers, fewer than 2")
        for i in range(count):
            buf = self._buffer(i)
            self._ioctl(VIDIOC_QUERYBUF, buf, "VIDIOC_QUERYBUF")
            offset, length = (struct.unpack_from("<I", buf, 64)[0],
                              struct.unpack_from("<I", buf, 72)[0])
            self._maps.append(self._sys.mmap(self._fd, length, offset))
            self._ioctl(VIDIOC_QBUF, self._buffer(i), "VIDIOC_QBUF")
        self._ioctl(VIDIOC_STREAMON,
                    bytearray(struct.pack("<i", BUF_TYPE_VIDEO_CAPTURE)),
                    "VIDIOC_STREAMON")
        self._streaming = True

    def _set_format(self) -> Tuple[str, int, int, int]:
        """The first of :data:`FORMATS` the device keeps when asked for it
        at 640x480 (cv2's ``try_palette_v4l2``), and the size and row
        stride it answers with."""
        answered = []
        for name in FORMATS:
            fmt = bytearray(FORMAT_SIZE)
            struct.pack_into("<I", fmt, 0, BUF_TYPE_VIDEO_CAPTURE)
            struct.pack_into("<IIII", fmt, 8, WIDTH, HEIGHT, fourcc(name),
                             0)   # V4L2_FIELD_ANY
            try:
                self._sys.ioctl(self._fd, VIDIOC_S_FMT, fmt)
            except OSError as e:
                answered.append(f"{name}: {e.strerror or e}")
                continue
            width, height, got = struct.unpack_from("<III", fmt, 8)
            stride = struct.unpack_from("<I", fmt, 24)[0]
            if got == fourcc(name):
                return name, width, height, stride or 2 * width
            answered.append(f"{name}: answered {fourcc_name(got)!r}")
        raise RuntimeError(
            f"camera {self.index} ({self.path}) takes neither of the "
            f"formats this port converts ({', '.join(answered)})")

    @staticmethod
    def _buffer(index: int) -> bytearray:
        buf = bytearray(BUFFER_SIZE)
        struct.pack_into("<II", buf, 0, index, BUF_TYPE_VIDEO_CAPTURE)
        struct.pack_into("<I", buf, 60, MEMORY_MMAP)
        return buf

    def isOpened(self) -> bool:
        return self._fd is not None

    def read(self) -> Tuple[bool, Optional[np.ndarray]]:
        """(True, (H, W, 3) uint8 BGR) for the next frame, (False, None)
        when none came within 10 s or the device is released, or the
        Motion-JPEG frame does not decode (``cv2.VideoCapture.read``)."""
        from ..data.imread import decode_bgr

        if self._fd is None:
            return False, None
        deadline = time.monotonic() + TIMEOUT_S
        while True:
            left = deadline - time.monotonic()
            if left <= 0 or not self._sys.wait_readable(self._fd, left):
                return False, None
            buf = self._buffer(0)
            try:
                self._sys.ioctl(self._fd, VIDIOC_DQBUF, buf)
            except OSError as e:
                if e.errno == errno.EAGAIN:
                    continue
                raise RuntimeError(f"camera {self.index} ({self.path}): "
                                   f"VIDIOC_DQBUF failed: "
                                   f"{e.strerror or e}") from None
            break
        index = struct.unpack_from("<I", buf, 0)[0]
        used = struct.unpack_from("<I", buf, 8)[0]
        data = bytes(self._maps[index][:used])
        self._ioctl(VIDIOC_QBUF, self._buffer(index), "VIDIOC_QBUF")
        if self.fourcc == "YUYV":
            if used < self.height * self.stride:
                return False, None
            return True, yuyv_to_bgr(data, self.height, self.width,
                                     self.stride)
        frame = decode_bgr(data)
        return (frame is not None), frame

    def release(self) -> None:
        """Stop the stream, unmap the buffers and close the device; a
        second call does nothing."""
        if self._fd is None:
            return
        try:
            if self._streaming:
                self._streaming = False
                self._ioctl(VIDIOC_STREAMOFF, bytearray(
                    struct.pack("<i", BUF_TYPE_VIDEO_CAPTURE)),
                    "VIDIOC_STREAMOFF")
        finally:
            for m in self._maps:
                m.close()
            self._maps = []
            fd, self._fd = self._fd, None
            self._sys.close(fd)


def open_camera(index: int) -> V4L2Camera:
    """``cv2.VideoCapture(index)`` on Linux: ``/dev/video<index>`` opened,
    set to YUYV or else Motion-JPEG at 640x480, streaming.  Raises
    RuntimeError naming the device when it is missing or refuses a step;
    there is no other source to fall back to."""
    return V4L2Camera(index)
