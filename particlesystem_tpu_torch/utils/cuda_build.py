"""Build and load the package's CUDA kernels.

Every ``*.cu`` file under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` process per source, all started together, and
the objects are linked into one shared library with a plain C interface,
bound with ``ctypes``.  The library lands in ``_build/`` inside the
package, named by a hash of the flags and of every file under ``csrc/``
(the headers the sources include among them), so the first call after a
change builds it and later calls (and processes) reuse it.  Nothing is
built or loaded when the module is imported.

Every kernel wrapper launches through :func:`launch`, which keeps the host's
path to the kernel short: the entry point is looked up once, the stream is
taken as a raw handle, and no device context is entered when the tensors
already lie on the current device.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v")
LINK_FLAGS = (*ARCH, "-shared")

_P = ctypes.c_void_p


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin/ on PATH "
                       "or set CUDA_HOME")


def _library_path() -> Path:
    files = sorted(p for p in CSRC.iterdir() if p.is_file())
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in files:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libps_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float, str]:
    """Compile the kernels unless the current sources are already built.
    Returns (library path, build seconds (0 when reused), nvcc's output)."""
    lib = _library_path()
    if lib.exists():
        return lib, 0.0, ""
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = _nvcc()
    tag = f"{lib.stem}.{os.getpid()}"
    sources = sorted(CSRC.glob("*.cu"))
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    tmp = BUILD_DIR / f"{tag}.so.tmp"
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *COMPILE_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    logs = [(src, proc, proc.communicate()[0])
            for src, proc in zip(sources, procs)]
    link = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp),
                           *map(str, objs)], capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    for obj in objs:
        obj.unlink(missing_ok=True)
    for src, proc, out in logs:
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name} "
                               f"({proc.returncode}):\n{out}")
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                           f"{link.stdout}\n{link.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build never sees a partial file
    return lib, seconds, "".join(out for _, _, out in logs)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare the C entry points."""
    lib = ctypes.CDLL(str(build()[0]))
    fn = lib.ps_cluster_pair
    fn.argtypes = [_P, _P, ctypes.c_longlong, _P, _P, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_float, _P, ctypes.c_longlong, _P, _P]
    fn.restype = ctypes.c_int
    fn = lib.ps_cluster_pair_counts
    fn.argtypes = [_P, _P]
    fn.restype = ctypes.c_int
    fn = lib.ps_physics_step
    fn.argtypes = [_P] * 8 + [ctypes.c_longlong, ctypes.c_int, _P,
                              ctypes.c_int, ctypes.c_int, _P, _P,
                              ctypes.c_int, _P, _P]
    fn.restype = ctypes.c_int
    fn = lib.ps_probe_alu_ops
    fn.argtypes = [_P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, _P]
    fn.restype = ctypes.c_int
    fn = lib.ps_probe_affine
    fn.argtypes = [_P, _P, ctypes.c_longlong, _P]
    fn.restype = ctypes.c_int
    fn = lib.ps_nbody_frame_fields
    fn.argtypes = [_P, ctypes.c_longlong, _P, _P, _P] + [
        ctypes.c_uint32] * 4 + [ctypes.c_float, ctypes.c_float, _P]
    fn.restype = ctypes.c_int
    fn = lib.ps_flat_fields
    fn.argtypes = [_P, ctypes.c_int] + [_P] * 8
    fn.restype = ctypes.c_int
    i, f, n = ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    fn = lib.ps_nbody_cells
    fn.argtypes = [_P] * 5 + [n, i, f, f, _P, _P, _P]
    fn.restype = ctypes.c_int
    fn = lib.ps_cell_starts
    fn.argtypes = [_P, n, i, _P, _P]
    fn.restype = ctypes.c_int
    fn = lib.ps_block_prepare
    fn.argtypes = [_P] * 9 + [n, i, i, i, i, _P, i, f, f, i, i, i, i, i] + [
        _P] * 7
    fn.restype = ctypes.c_int
    fn = lib.ps_nbody_lifecycle
    fn.argtypes = [_P] * 4 + [n] + [_P] * 4 + [n, _P, i, i, _P, _P, _P, _P]
    fn.restype = ctypes.c_int
    fn = lib.ps_nbody_spawn
    fn.argtypes = [_P] * 7 + [n, i, f, _P, _P, _P]
    fn.restype = ctypes.c_int
    fn = lib.ps_empty
    fn.argtypes = [_P]
    fn.restype = ctypes.c_int
    u = ctypes.c_uint32
    fn = lib.ps_emitter_spawn
    fn.argtypes = [_P, _P, i, i, _P, _P, _P, u, u, u, _P, _P, i, i, f, _P]
    fn.restype = ctypes.c_int
    fn = lib.ps_emitter_ring
    fn.argtypes = [_P] * 8 + [i, n, _P, _P, i, _P, _P]
    fn.restype = ctypes.c_int
    fn = lib.ps_emitter_tail
    fn.argtypes = [_P, _P, i, _P, i, n, _P, _P]
    fn.restype = ctypes.c_int
    fn = lib.ps_nbody_fill
    fn.argtypes = [_P] * 9 + [n, n] + [u] * 6 + [f] * 6 + [_P]
    fn.restype = ctypes.c_int
    return lib


def sass_instructions() -> dict:
    """{kernel's mangled name: [SASS mnemonic with its suffixes, ...]} of
    the built library, from ``cuobjdump -sass`` (found beside ``nvcc``
    when it is not on the PATH)."""
    tool = shutil.which("cuobjdump") or str(
        Path(_nvcc()).with_name("cuobjdump"))
    text = subprocess.run([tool, "-sass", str(build()[0])],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for part in text.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        out[name] = re.findall(r"^\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\d+\s+)?"
                               r"([A-Z][A-Z0-9_]*(?:\.[A-Z0-9_]+)*)",
                               part, flags=re.M)
    return out


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    return getattr(load_library(), name)


def current_stream_handle(index: int) -> int:
    """The raw ``cudaStream_t`` of device ``index``'s current stream, without
    a ``torch.cuda.Stream`` object around it."""
    return torch._C._cuda_getCurrentRawStream(index)


def launch(name: str, device: torch.device, *args) -> int:
    """Call the C entry point ``name`` with ``args`` and, as its last
    argument, the current stream of ``device`` (a CUDA device with an
    index, as every CUDA tensor's is).  Returns the launch's CUDA error
    code, 0 on success: the caller raises on anything else."""
    fn = _entry(name)
    index = device.index
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return fn(*args, current_stream_handle(index))
    return fn(*args, current_stream_handle(index))
