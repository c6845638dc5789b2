"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and bind them by ctypes.

The kernels have a plain C interface (``extern "C"``, raw pointers, the
stream as ``void*``, an ``int`` return carrying ``cudaGetLastError()``), so
no PyTorch header is compiled and the build takes seconds. Every source is
compiled to an object by its own ``nvcc`` process, all started together,
then one ``nvcc -shared`` links ``libspira_kernels-<hash>.so`` into
``build/kernels/`` at the repository root. The hash covers the sources and
the flags, so an edited source builds a new library and a stale one is
never loaded. Fast math stays off: the segment sum must round every add as
IEEE fp32 does, denormals included.

Nothing is built at import; the first wrapper that launches a kernel calls
:func:`library`, and ``chip_smoke.py`` calls :func:`build` to time it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin; "
                       "the CUDA kernels cannot be built")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(srcs: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile and link the kernel library if this source hash has none
    yet; return its path. Compiler output goes to ``build.log`` beside it
    (``-Xptxas -v``: registers and shared memory per kernel)."""
    srcs = sources()
    lib = BUILD_DIR / f"libspira_kernels-{_digest(srcs)}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in srcs]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(s), "-o", str(o)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(srcs, objs)]
        logs = [p.communicate()[0] for p in procs]
        log = "".join(f"== {s.name}\n{text}" for s, text in zip(srcs, logs))
        (BUILD_DIR / "build.log").write_text(log)
        failed = [s.name for s, p in zip(srcs, procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        part = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             *map(str, objs), "-o", str(part)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(part, lib)   # atomic: a concurrent build sees all or none
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        return _lib


def function(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """A C entry point of the library with its argument types set (every
    pointer and the stream as ``c_void_p``) and an ``int`` return: the
    ``cudaError_t`` of the launch."""
    fn = getattr(library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        name = library().spira_error_string
        name.argtypes = [ctypes.c_int]
        name.restype = ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({name(err).decode()})")
