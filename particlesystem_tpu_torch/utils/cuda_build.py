"""Build and load the package's CUDA kernels.

Every ``*.cu`` file under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` process per source, all started together, and
the objects are linked into one shared library with a plain C interface,
bound with ``ctypes``.  The library lands in ``_build/`` inside the
package, named by a hash of the flags and of every file under ``csrc/``
(the headers the sources include among them), so the first call after a
change builds it and later calls (and processes) reuse it.  Nothing is
built or loaded when the module is imported.

The kernels' one seam: every wrapper launches through :func:`launch`,
which keeps the host's path to the kernel short (the entry point is looked
up once, the stream is taken as a raw handle, and no device context is
entered when the tensors already lie on the current device), raises on a
failed launch, and counts the launch under the entry point's name
(:func:`launches`).  A launch made while a CUDA graph is captured is not a
launch, only a node of the graph: it goes into the capture's
:class:`Record` (:func:`recording`), and each replay of the graph runs it
again, so the counts still count the kernels' runs on the card.  Each
public op picks its kernel or its plain version by device through
:func:`by_device`.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
import weakref
from pathlib import Path
from typing import Dict, List

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


def by_device(where, op: str, cuda_fn, plain_fn):
    """``cuda_fn`` where ``where`` (a tensor or a device) lies on a CUDA
    device, ``plain_fn`` on the CPU; any other device raises, naming
    ``op``."""
    dev = (where.device if isinstance(where, torch.Tensor)
           else torch.device(where))
    if dev.type == "cuda":
        return cuda_fn
    if dev.type == "cpu":
        return plain_fn
    raise ValueError(f"no {op} for device {dev}")


#: launches made outside a capture, {entry point: launches}
_counts: Dict[str, int] = {}
#: the records of the captures under way, the innermost last
_recording: List["Record"] = []
#: the records whose graphs may still be replayed
_captured: "weakref.WeakSet[Record]" = weakref.WeakSet()


def _fold(counts: Dict[str, int], rec: "Record") -> None:
    for name, n in rec.counts.items():
        counts[name] = counts.get(name, 0) + n * rec.replays


class Record:
    """What a capture recorded: ``counts``, the launches made inside it
    {entry point: launches}, and ``replays``, the replays of its graph,
    which its owner counts: each runs them again.  When the record is freed
    with its graph, what its replays ran joins the counts."""

    __slots__ = ("counts", "replays", "__weakref__")

    def __init__(self):
        self.counts: Dict[str, int] = {}
        self.replays = 0

    # bound here: the module's globals may be gone when the last record is
    # freed at exit
    def __del__(self, fold=_fold, counts=_counts):
        fold(counts, self)


@contextlib.contextmanager
def recording():
    """The launches made inside go into a :class:`Record`, yielded, instead
    of the counts: what a capture records."""
    rec = Record()
    _captured.add(rec)
    _recording.append(rec)
    try:
        yield rec
    finally:
        _recording.pop()


def launches() -> Dict[str, int]:
    """{entry point: launches} of the process: the kernels' runs on the
    card, a replay counting those its graph recorded."""
    out = dict(_counts)
    for rec in list(_captured):
        _fold(out, rec)
    return out


def _call(name: str, device: torch.device, args) -> None:
    if device.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors only: it needs a CUDA "
                         f"device, got {device}")
    fn = _entry(name)
    index = device.index
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            err = fn(*args, current_stream_handle(index))
    else:
        err = fn(*args, current_stream_handle(index))
    if err:
        raise RuntimeError(f"{name} failed: CUDA error {err}")


def launch(name: str, device: torch.device, *args) -> None:
    """Call the C entry point ``name`` with ``args`` and, as its last
    argument, the current stream of ``device`` (a CUDA device with an
    index, as every CUDA tensor's is); raises on a nonzero CUDA error, and
    counts the launch under ``name`` (inside a capture, in its record)."""
    _call(name, device, args)
    counts = _recording[-1].counts if _recording else _counts
    counts[name] = counts.get(name, 0) + 1


def read(name: str, device: torch.device, *args) -> None:
    """Call an entry point that launches no kernel (one that reads the
    card's counters back) as :func:`launch` does, uncounted."""
    _call(name, device, args)
