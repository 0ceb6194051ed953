"""Build and load the hand-written CUDA kernels of ``csrc/``.

The ``.cu`` sources have plain C entry points; at first use ``nvcc``
compiles them, one process per source and all at once, and links the
objects into one shared library, loaded with ``ctypes``.
The library lands in ``rtpose_tpu_torch/build/`` under a name that carries
a hash of the sources and flags, so an edited source is never served by a
stale library.  Nothing is built or imported when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
# -fmad=false: no source may contract a product into an FMA, so each
# kernel rounds exactly as its plain PyTorch version does
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "rtpose_pair_tables": (_P, _P, _P, _P),
    "rtpose_connection_scores": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _F, _I, _P),
    "rtpose_refine_peaks": (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, _I, _P),
    "rtpose_limb_tables": (_P, _P),
    "rtpose_gt_maps": (_P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _P),
    "rtpose_group_tables": (_P, _P),
    "rtpose_group_people": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, _F, _P, _P),
    "rtpose_group_smem_bytes": (_I, _I, _I),
    "rtpose_yuv420_to_bgr": (_P, _P, _P, _I, _I, _I, _I, _I, "rule", _P,
                             _P),
    "rtpose_yuv420p10_to_bgr": (_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _I,
                                _P, _P, _I, "rule", _P, _P),
    "rtpose_yuv420_general_to_bgr": (_P, _P, _P, _I, _I, _I, _I, _I, _P, _P,
                                     _I, _P, _P, _I, "rule", _P, _P),
    "rtpose_yuv420_full_chroma_to_bgr": (_P, _P, _P, _I, _I, _I, _I, _I, _I,
                                         _P, _P, _I, _P, _P, _I, "rule", _P,
                                         _P),
    "rtpose_yuv422_to_bgr": (_P, _P, _P, _I, _I, _I, _I, _I, "rule", _P,
                             _P),
    "rtpose_yuv_planar_general_to_bgr": (_P, _P, _P, _I, _I, _I, _I, _I, _I,
                                         _P, _P, _I, _P, _P, _I, "rule", _P,
                                         _P),
    "rtpose_yuv_planar_full_chroma_to_bgr": (_P, _P, _P, _I, _I, _I, _I, _I,
                                             _I, _P, _P, _I, _P, _P, _I,
                                             "rule", _P, _P),
    "rtpose_gray_to_bgr": (_P, _I, _I, _I, _I, _I, _P, _P),
    "rtpose_packed_to_bgr": (_P, _I, _I, _I, _I, _I, _I, _P, _P),
}


class BuiltLibrary:
    """The loaded kernel library plus what its build reported."""

    def __init__(self, lib: ctypes.CDLL, path: Path, seconds: float,
                 log: str):
        self.lib = lib
        self.path = path
        self.seconds = seconds    # 0.0 when an up-to-date library was found
        self.log = log            # nvcc/ptxas output of this build


_lock = threading.Lock()
_loaded: Optional[BuiltLibrary] = None


def _sources():
    return sorted(p for p in CSRC_DIR.iterdir()
                  if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels of rtpose_tpu_torch "
                       "are built from csrc/ on the machine with the card")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librtpose_kernels_{h.hexdigest()[:16]}.so"


def _run(procs) -> str:
    log = ""
    for cmd, proc in procs:
        stdout, stderr = proc.communicate()
        log += stderr + stdout
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{stderr}{stdout}")
    return log


def _start(cmd):
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)


def _compile(out: Path) -> str:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    tmp = BUILD_DIR / f"{tag}.tmp"
    srcs = [s for s in _sources() if s.suffix == ".cu"]
    objs = [BUILD_DIR / f"{tag}.{s.stem}.o" for s in srcs]
    nvcc = _nvcc()
    try:
        log = _run([_start([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)])
                    for s, o in zip(srcs, objs)])
        log += _run([_start([nvcc, *ARCH, "-shared", "-o", str(tmp),
                             *map(str, objs)])])
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    finally:
        for p in (tmp, *objs):
            p.unlink(missing_ok=True)
    return log


def load() -> BuiltLibrary:
    """Build (if needed) and load the kernel library; cached per process."""
    global _loaded
    with _lock:
        if _loaded is not None:
            return _loaded
        path = library_path()
        seconds, log = 0.0, ""
        if not path.exists():
            t0 = time.perf_counter()
            log = _compile(path)
            seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(path))
        from .kernels import _RuleArg    # csrc/yuv_rule.cuh, by value
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = [_RuleArg if a == "rule" else a for a in argtypes]
            fn.restype = ctypes.c_int
        _loaded = BuiltLibrary(lib, path, seconds, log)
        return _loaded
