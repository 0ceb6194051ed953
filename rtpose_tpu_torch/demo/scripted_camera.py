"""Capture devices in software for ``demo.camera``: put a
:class:`ScriptedV4L2` in ``camera.SYSCALLS`` and ``open_camera(i)`` reads
its ``/dev/video<i>`` through the same requests, buffers and conversions
as a real camera's.

A :class:`ScriptedDevice` offers some pixel formats, answers a request
for another with its first (as V4L2 devices do), serves each of its BGR
frames once in the format the camera chose (YUYV by :func:`bgr_to_yuyv`,
Motion-JPEG by ``data.imwrite.encode_bgr``, both made when the format is
set, so a timed read costs what a real one does), and then has no frame
ready.  It records each request and its struct size, and whether the
stream is on, the buffers mapped and the device open.  The tests and
``chip_smoke.py``'s webcam phase drive the demo with it.
"""

from __future__ import annotations

import errno
import re
import struct
from collections import deque
from typing import Dict, Sequence

import numpy as np

from . import camera as C

REQUESTS = {C.VIDIOC_QUERYCAP: "QUERYCAP", C.VIDIOC_S_FMT: "S_FMT",
            C.VIDIOC_REQBUFS: "REQBUFS", C.VIDIOC_QUERYBUF: "QUERYBUF",
            C.VIDIOC_QBUF: "QBUF", C.VIDIOC_DQBUF: "DQBUF",
            C.VIDIOC_STREAMON: "STREAMON", C.VIDIOC_STREAMOFF: "STREAMOFF"}


def bgr_to_yuyv(frame: np.ndarray) -> bytes:
    """(H, W, 3) uint8 BGR, W even -> YUYV bytes: BT.601 studio range,
    the chroma of each pixel pair averaged."""
    f = frame.astype(np.float64)
    b, g, r = f[..., 0], f[..., 1], f[..., 2]
    y = 16 + 0.257 * r + 0.504 * g + 0.098 * b
    u = 128 - 0.148 * r - 0.291 * g + 0.439 * b
    v = 128 + 0.439 * r - 0.368 * g - 0.071 * b
    h, w = y.shape
    out = np.empty((h, w // 2, 4))
    out[..., 0], out[..., 2] = y[:, 0::2], y[:, 1::2]
    out[..., 1] = (u[:, 0::2] + u[:, 1::2]) / 2
    out[..., 3] = (v[:, 0::2] + v[:, 1::2]) / 2
    return np.clip(np.rint(out), 0, 255).astype(np.uint8).tobytes()


class _Mapping:
    """A mapped device buffer: slicing reads it, ``close`` unmaps it."""

    def __init__(self, device: "ScriptedDevice", index: int):
        self.device, self.index = device, index

    def __getitem__(self, s):
        return self.device.buffers[self.index][s]

    def close(self) -> None:
        self.device.mapped.discard(self.index)


class ScriptedDevice:
    """One camera: `frames` (BGR, all of one size) served once each in the
    first of `offers` that the reader asks for."""

    def __init__(self, frames: Sequence[np.ndarray],
                 offers: Sequence[str] = ("YUYV", "MJPG")):
        self.frames = [np.ascontiguousarray(f, np.uint8) for f in frames]
        self.offers = tuple(offers)
        self.height, self.width = self.frames[0].shape[:2]
        self.calls: list = []          # (request, struct size)
        self.fourcc = None
        self.payloads: list = []
        self.buffers: list = []
        self.queued: deque = deque()
        self.mapped: set = set()
        self.served = 0
        self.streaming = False
        self.open = False

    def _payload(self, frame: np.ndarray) -> bytes:
        from ..data.imwrite import encode_bgr
        if self.fourcc == "YUYV":
            return bgr_to_yuyv(frame)
        return encode_bgr(frame, ".jpg")

    def ready(self) -> bool:
        return (self.streaming and bool(self.queued)
                and self.served < len(self.frames))

    def ioctl(self, request: int, buf: bytearray) -> None:
        name = REQUESTS.get(request)
        self.calls.append((name or hex(request), len(buf)))
        if name is None:
            raise OSError(errno.ENOTTY, "Inappropriate ioctl for device")
        getattr(self, "_" + name.lower())(buf)

    def _querycap(self, buf):
        buf[:16] = b"scripted".ljust(16, b"\0")
        struct.pack_into("<III", buf, 84,
                         C.CAP_VIDEO_CAPTURE | C.CAP_STREAMING
                         | C.CAP_DEVICE_CAPS,
                         C.CAP_VIDEO_CAPTURE | C.CAP_STREAMING, 0)

    def _s_fmt(self, buf):
        asked = C.fourcc_name(struct.unpack_from("<I", buf, 16)[0])
        self.fourcc = asked if asked in self.offers else self.offers[0]
        stride = 2 * self.width if self.fourcc == "YUYV" else 0
        struct.pack_into("<IIIIII", buf, 8, self.width, self.height,
                         C.fourcc(self.fourcc), 1, stride,
                         self.width * self.height * 2)
        self.payloads = ([self._payload(f) for f in self.frames]
                         if self.fourcc in C.FORMATS else [])

    def _reqbufs(self, buf):
        count = struct.unpack_from("<I", buf, 0)[0]
        size = max(map(len, self.payloads), default=0)
        self.buffers = [bytearray(size) for _ in range(count)]

    def _querybuf(self, buf):
        index = struct.unpack_from("<I", buf, 0)[0]
        struct.pack_into("<I", buf, 64, index * 4096)
        struct.pack_into("<I", buf, 72, len(self.buffers[index]))

    def _qbuf(self, buf):
        self.queued.append(struct.unpack_from("<I", buf, 0)[0])

    def _dqbuf(self, buf):
        if not self.ready():
            raise OSError(errno.EAGAIN, "Resource temporarily unavailable")
        index = self.queued.popleft()
        data = self.payloads[self.served]
        self.buffers[index][:len(data)] = data
        self.served += 1
        struct.pack_into("<III", buf, 0, index, C.BUF_TYPE_VIDEO_CAPTURE,
                         len(data))

    def _streamon(self, buf):
        self.streaming = True

    def _streamoff(self, buf):
        self.streaming = False
        self.queued.clear()


class ScriptedV4L2:
    """The system calls of ``demo.camera`` over `devices` (index ->
    :class:`ScriptedDevice`); any other ``/dev/video<i>`` is missing."""

    def __init__(self, devices: Dict[int, ScriptedDevice]):
        self.devices = devices
        self._fds: Dict[int, ScriptedDevice] = {}
        self._next_fd = 1000

    def open(self, path: str) -> int:
        m = re.fullmatch(r"/dev/video(\d+)", path)
        device = self.devices.get(int(m.group(1))) if m else None
        if device is None:
            raise FileNotFoundError(errno.ENOENT,
                                    "No such file or directory", path)
        device.open = True
        fd, self._next_fd = self._next_fd, self._next_fd + 1
        self._fds[fd] = device
        return fd

    def close(self, fd: int) -> None:
        self._fds.pop(fd).open = False

    def ioctl(self, fd: int, request: int, buf: bytearray) -> None:
        self._fds[fd].ioctl(request, buf)

    def mmap(self, fd: int, length: int, offset: int) -> _Mapping:
        device = self._fds[fd]
        index = offset // 4096
        if length != len(device.buffers[index]):
            raise OSError(errno.EINVAL, "Invalid argument")
        device.mapped.add(index)
        return _Mapping(device, index)

    def wait_readable(self, fd: int, timeout: float) -> bool:
        return self._fds[fd].ready()
