"""ctypes binding for the native image-pipeline worker pool (imgpipe.cpp;
port of rtpose_tpu/native/imgpipe.py, the same API).

:class:`ImgPipe` wraps the pool: submit decode+augment jobs for a whole
batch, then ``wait()``; all pixel work runs in C++ threads with the GIL
released.

The library is built at first use, never at import:

    g++ -O3 -march=native -shared -fPIC -std=c++17 -I<third_party/libjpeg>
        imgpipe.cpp <pillow.libs>/libjpeg-*.so.62* -Wl,-rpath,<pillow.libs>
        -lpthread

It compiles against the libjpeg-turbo headers in ``third_party/libjpeg``
(ABI 62) and links the libjpeg-turbo that Pillow bundles, so it decodes
with the library Pillow decodes with, on a machine with no libjpeg
headers of its own.  Without a bundled libjpeg, or without ``g++``, the
build raises; nothing falls back to another decoder.  The library lands
in ``rtpose_tpu_torch/build/`` under a name that carries a hash of the
source, the headers, the libjpeg it links, the flags and the CPU's
features.  Concurrent
processes take a file lock, compile to a name of their own and
``os.replace`` it into place, so none loads a half-written library.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "imgpipe.cpp"
_HEADERS = _HERE / "third_party" / "libjpeg"
BUILD_DIR = _HERE.parent / "build"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def pillow_libjpeg() -> Path:
    """The libjpeg-turbo (ABI 62) in Pillow's wheel: ``pillow.libs`` beside
    the ``PIL`` package, its file name carrying a build hash."""
    import PIL
    libs = Path(PIL.__file__).resolve().parent.parent / "pillow.libs"
    found = sorted(glob.glob(str(libs / "libjpeg-*.so.62*")))
    if not found:
        raise RuntimeError(
            f"the native loader links Pillow's bundled libjpeg, and "
            f"{libs} holds no libjpeg-*.so.62*: Pillow must come from its "
            f"manylinux wheel")
    return Path(found[0])


def _cpu_flags() -> bytes:
    """What -march=native compiles for: this CPU's feature flags."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((ln for ln in f if ln.startswith(b"flags")), b"")
    except OSError:
        return b""


def library_path(libjpeg: Path) -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(_cpu_flags())
    h.update(str(libjpeg).encode())   # its place is in the rpath
    for p in [_SRC, *sorted(_HEADERS.glob("*.h"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libimgpipe_{h.hexdigest()[:16]}.so"


def _build(out: Path, libjpeg: Path) -> None:
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *FLAGS, f"-I{_HEADERS}", str(_SRC), "-o", str(tmp),
           str(libjpeg), f"-Wl,-rpath,{libjpeg.parent}", "-lpthread"]
    try:
        done = subprocess.run(cmd, capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"building the native loader failed "
                               f"({done.returncode}):\n{' '.join(cmd)}\n"
                               f"{done.stderr}{done.stdout}")
        os.replace(tmp, out)   # atomic: a loader sees all or nothing
    finally:
        tmp.unlink(missing_ok=True)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        libjpeg = pillow_libjpeg()
        path = library_path(libjpeg)
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            with open(BUILD_DIR / "libimgpipe.lock", "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)   # one build at a time
                if not path.exists():
                    _build(path, libjpeg)
        lib = ctypes.CDLL(str(path))
        lib.imgpipe_create.restype = ctypes.c_void_p
        lib.imgpipe_create.argtypes = [ctypes.c_int]
        lib.imgpipe_destroy.argtypes = [ctypes.c_void_p]
        lib.imgpipe_jpeg_size.restype = ctypes.c_int
        lib.imgpipe_jpeg_size.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.imgpipe_submit.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_float, ctypes.c_float, ctypes.c_float,   # b/c/s
            ctypes.c_int, ctypes.c_int, ctypes.c_int,         # hue/jpeg/q
            ctypes.c_int, ctypes.c_int,                       # gray/flip
            ctypes.c_int, ctypes.c_int,                       # resize w/h
            ctypes.c_int, ctypes.c_int,                       # crop x/y
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,                       # canvas w/h
            ctypes.c_void_p, ctypes.c_void_p,                 # out f32/u8
            ctypes.c_void_p, ctypes.c_void_p]                 # mean/std
        lib.imgpipe_wait_all.restype = ctypes.c_int
        lib.imgpipe_wait_all.argtypes = [ctypes.c_void_p]
        lib.imgpipe_wait_all_failed.restype = ctypes.c_int
        lib.imgpipe_wait_all_failed.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        _lib = lib
        return lib


def loaded_library() -> Path:
    """The path of the library this process loaded (builds it if needed)."""
    _load()
    return library_path(pillow_libjpeg())


def available() -> bool:
    try:
        _load()
        return True
    except (OSError, RuntimeError):
        return False


def jpeg_size(data: bytes):
    """(width, height) from the JPEG header only (~microseconds)."""
    lib = _load()
    w = ctypes.c_int()
    h = ctypes.c_int()
    if lib.imgpipe_jpeg_size(data, len(data), ctypes.byref(w),
                             ctypes.byref(h)):
        raise ValueError("not a decodable JPEG")
    return w.value, h.value


_MEAN_PTR = IMAGENET_MEAN.ctypes.data_as(ctypes.c_void_p)
_STD_PTR = IMAGENET_STD.ctypes.data_as(ctypes.c_void_p)


class ImgPipe:
    """Threaded native decode+augment pool.

    The pipe keeps every submitted byte buffer and output array alive
    until :meth:`wait` returns: the C++ workers dereference their raw
    pointers until then.
    """

    def __init__(self, threads: int = 8):
        self._lib = _load()
        self._ctx = self._lib.imgpipe_create(threads)
        self._live = []

    def submit(self, jpeg: bytes, *, out: Optional[np.ndarray] = None,
               out_u8: Optional[np.ndarray] = None,
               brightness: float = 1.0, contrast: float = 1.0,
               saturation: float = 1.0, hue_shift: int = -1,
               jpeg_quality: int = 0, grayscale: bool = False,
               hflip: bool = False,
               resize_wh=(0, 0), crop_xy=(0, 0),
               content_xywh=(0, 0, 0, 0), normalize: bool = True) -> None:
        """One image job. out: (H, W, 3) float32 C-contiguous canvas;
        out_u8: (H, W, 3) uint8 canvas (raw pixels, pre-normalization).
        Either or both may be given; at least one is required.

        resize_wh: PIL-bicubic target (0 = no resize); crop_xy: window
        origin in the resized image; content_xywh: where the window lands
        in the canvas.
        """
        assert out is not None or out_u8 is not None
        if out is not None:
            assert out.dtype == np.float32 and out.flags["C_CONTIGUOUS"]
        if out_u8 is not None:
            assert out_u8.dtype == np.uint8 and out_u8.flags["C_CONTIGUOUS"]
        ch, cw = (out if out is not None else out_u8).shape[:2]
        self._live.append((jpeg, out, out_u8))
        ox, oy, ow, oh = content_xywh
        rw, rh = resize_wh
        self._lib.imgpipe_submit(
            self._ctx, jpeg, len(jpeg),
            brightness, contrast, saturation,
            int(hue_shift), int(jpeg_quality > 0), int(jpeg_quality),
            int(grayscale), int(hflip),
            int(rw), int(rh), int(crop_xy[0]), int(crop_xy[1]),
            int(ox), int(oy), int(ow), int(oh), cw, ch,
            (out.ctypes.data_as(ctypes.c_void_p)
             if out is not None else None),
            (out_u8.ctypes.data_as(ctypes.c_void_p)
             if out_u8 is not None else None),
            _MEAN_PTR if normalize else None,
            _STD_PTR if normalize else None)

    def wait(self) -> None:
        failed, total = self.wait_failed_counted()
        if failed:
            more = (f" (+{total - len(failed)} more past the report cap)"
                    if total > len(failed) else "")
            raise RuntimeError(
                f"{total} imgpipe job(s) failed "
                f"(corrupt/undecodable JPEG?); submit-order indices "
                f"{failed[:16]}{'...' if len(failed) > 16 else ''}{more}")

    def wait_failed(self, cap: int = 1024) -> list:
        """Wait for all submitted jobs; return the submit-order indices
        (since the previous wait) of jobs that failed, sorted ascending.
        A failed job's output buffer is left zeroed.  At most `cap`
        indices are reported; use wait_failed_counted for the total."""
        return self.wait_failed_counted(cap)[0]

    def wait_failed_counted(self, cap: int = 1024) -> tuple:
        """Like wait_failed, but returns (indices[:cap], total_failed)."""
        buf = (ctypes.c_int * cap)()
        n = self._lib.imgpipe_wait_all_failed(self._ctx, buf, cap)
        self._live.clear()
        return list(buf[:min(n, cap)]), int(n)

    def close(self) -> None:
        if self._ctx:
            self._lib.imgpipe_destroy(self._ctx)
            self._ctx = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
