"""ctypes bindings for the native runtime library (``native/psnative.cpp``
at the repository root: the frame ring, a clock and the emitter oracle's
inner loop).

The source is compiled at first use with the host C++ compiler into the
package's ``_build/`` directory, named by a hash of the source and flags,
as ``utils/cuda_build.py`` does for the CUDA kernels; a prebuilt library
elsewhere is never loaded.  Every user has a pure-Python fallback, so the
package works without a compiler or without the source
(:func:`has_native` reports which path is active).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "psnative.cpp"
BUILD_DIR = _PKG / "_build"
# no -march=native and no contraction: the library gives the same floats on
# every machine that shares the build directory
FLAGS = ("-O3", "-fPIC", "-std=c++17", "-ffp-contract=off", "-shared")

_lib: Optional[ctypes.CDLL] = None
_tried = False


class PsPlane(ctypes.Structure):
    _fields_ = [("px", ctypes.c_float), ("py", ctypes.c_float),
                ("pz", ctypes.c_float), ("nx", ctypes.c_float),
                ("ny", ctypes.c_float), ("nz", ctypes.c_float),
                ("restitution", ctypes.c_float), ("friction", ctypes.c_float)]


class PsSphere(ctypes.Structure):
    _fields_ = [("cx", ctypes.c_float), ("cy", ctypes.c_float),
                ("cz", ctypes.c_float), ("radius", ctypes.c_float),
                ("restitution", ctypes.c_float), ("friction", ctypes.c_float)]


def _build() -> Optional[Path]:
    """Path of the built library, compiling it if the current source is not
    built yet; None without the source, a compiler or a clean compile."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not SOURCE.exists() or not cxx:
        return None
    h = hashlib.sha256(" ".join(FLAGS).encode() + SOURCE.read_bytes())
    lib = BUILD_DIR / f"libpsnative_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = BUILD_DIR / f"{lib.stem}.{os.getpid()}.so.tmp"
    try:
        subprocess.run([cxx, *FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, lib)  # atomic: a concurrent build never sees a partial file
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = _build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None

    lib.ps_now.restype = ctypes.c_double
    lib.ps_ring_create.restype = ctypes.c_void_p
    lib.ps_ring_create.argtypes = [ctypes.c_size_t, ctypes.c_size_t]
    lib.ps_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.ps_ring_try_push.restype = ctypes.c_int
    lib.ps_ring_try_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_size_t]
    lib.ps_ring_try_pop.restype = ctypes.c_int
    lib.ps_ring_try_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_size_t]
    lib.ps_ring_fill.restype = ctypes.c_size_t
    lib.ps_ring_fill.argtypes = [ctypes.c_void_p]
    lib.ps_emitter_step.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.POINTER(PsPlane), ctypes.c_int,
        ctypes.POINTER(PsSphere), ctypes.c_int,
    ]
    _lib = lib
    return _lib


def has_native() -> bool:
    return get_lib() is not None
