"""Build the CUDA sources of ``repro_torch/csrc`` at first use and bind them.

Each ``csrc/<name>.cu`` exposes a plain C interface.  It is compiled once
by ``nvcc`` for ``sm_90a`` into a shared library under ``_build/`` (a
directory git ignores), named by the hash of its source, and loaded with
``ctypes``.  Nothing here runs when a module is imported: the CPU paths of
the port never compile anything.

Every C entry point returns ``cudaGetLastError()`` after its launch, so a
launch the CUDA runtime refused surfaces as an exception in the wrapper
(:func:`check`) instead of as silent garbage.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, "csrc")
BUILD_DIR = os.path.join(PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of repro_torch are built from "
            "csrc/ at first use and need the CUDA toolkit (set CUDA_HOME)"
        )
    return found


def library_path(name: str) -> str:
    """Where the library built from ``csrc/<name>.cu`` lives.

    Named by the hash of the source and of every shared header of
    ``csrc/``, so an edited header rebuilds the libraries that include it.
    """
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for f in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(f.encode() + b"\0" + fh.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Start one ``nvcc``; None when the library is already built."""
    out = library_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish(name: str, started) -> str:
    """Wait for one ``nvcc`` and move its library into place; returns the
    compiler's report (``-Xptxas -v``: registers, shared memory, spills)."""
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build_all(names) -> dict[str, str]:
    """Compile every named source at once (one ``nvcc`` each, all started
    together) and wait for them; returns each compiler report."""
    started = {n: _start(n) for n in names}
    return {n: _finish(n, s) for n, s in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The bound library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                _finish(name, _start(name))
                lib = ctypes.CDLL(library_path(name))
                _LIBS[name] = lib
    return lib


def bind(lib: ctypes.CDLL, fn: str, n_ptrs: int, n_ints: int,
         n_floats: int = 0):
    """Declare ``fn(ptr * n_ptrs, int * n_ints, float * n_floats, stream)
    -> int``.

    Every pointer and the stream are ``c_void_p``: left undeclared, ctypes
    would pass them as 32-bit ints and cut them.  A float argument is a C
    ``float``: the caller passes a value that float32 holds exactly.
    """
    f = getattr(lib, fn)
    if f.argtypes is None:
        f.argtypes = (
            [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
            + [ctypes.c_float] * n_floats + [ctypes.c_void_p]
        )
        f.restype = ctypes.c_int
    return f


def check(err: int, fn: str) -> None:
    """Raise if the C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {fn} failed: cudaError {err}")


def ptx(name: str) -> str:
    """The PTX ``nvcc`` emits for ``csrc/<name>.cu`` for the build's target
    at the build's optimisation level (read to check what the compiler made
    of the f32 contract)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f"{name}.{os.getpid()}.ptx")
    proc = subprocess.run(
        [nvcc(), "-arch=compute_90a", "-std=c++17", "-O3", "-ptx", "-o", out,
         os.path.join(CSRC, f"{name}.cu")],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc -ptx failed on csrc/{name}.cu:\n{proc.stderr}")
    with open(out) as fh:
        text = fh.read()
    os.remove(out)
    return text


def ptr(t) -> int | None:
    """Device pointer of a tensor (None for an absent optional input)."""
    return None if t is None else t.data_ptr()
