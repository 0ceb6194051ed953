"""Build and load the hand-written CUDA kernels of ``csrc/``.

The ``.cu`` sources have plain C entry points; they are compiled by
``nvcc`` into one shared library at first use and loaded with ``ctypes``.
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
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "rtpose_paf_pair_channels": (_P, _P),
    "rtpose_paf_sample": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "rtpose_bicubic_refine": (_P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _P),
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


def _compile(out: Path) -> str:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(s) for s in _sources() if s.suffix == ".cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stderr}{proc.stdout}")
    os.replace(tmp, out)      # atomic: a concurrent loader sees all or none
    return proc.stderr + proc.stdout


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
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _loaded = BuiltLibrary(lib, path, seconds, log)
        return _loaded
