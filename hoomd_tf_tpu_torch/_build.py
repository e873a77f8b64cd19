"""Build the package's native libraries from ``csrc/`` at first use.

Each ``csrc/<name>.cu`` (a CUDA kernel) compiles with ``nvcc``, and each
``csrc/<name>.cpp`` (host code: the GSD reader and writer) with ``g++``,
into a shared library with a plain C interface (loaded with ``ctypes``)
under ``build/`` in the package directory. The file name carries a hash
of the source, of every ``csrc`` header it includes (``#include "..."``,
followed through the headers), and of the flags, so an edited source or
shared header rebuilds and a stale library is never loaded. A library is
compiled into a temporary file and renamed into place, so processes that
build it at once each load a whole file.
A missing compiler or a compile error raises; there is no fallback.
"""

import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["build_shared_library", "build_host_library",
           "source_digest", "BUILD_LOG"]

_PKG = Path(__file__).resolve().parent
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_HOST_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

#: name -> (seconds, compiler output) of the builds made in this process
BUILD_LOG = {}


def _nvcc():
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = Path(home) / "bin" / "nvcc"
        path = str(cand) if cand.exists() else None
    if path is None:
        raise RuntimeError("nvcc not found (on PATH or under CUDA_HOME): "
                           "the CUDA kernels are built from source")
    return path


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def source_digest(src, flags=_FLAGS):
    """Hash of the source ``src``, of the local headers it includes
    (quoted includes resolved beside the including file, each once, in the
    order first reached) and of ``flags``."""
    h = hashlib.sha256()
    seen, todo = set(), [Path(src)]
    while todo:
        f = todo.pop(0).resolve()
        if f in seen:
            continue
        seen.add(f)
        text = f.read_bytes()
        h.update(f.name.encode() + b"\0" + text + b"\0")
        todo += [f.parent / m.decode() for m in _INCLUDE.findall(text)]
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def _gxx():
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found on PATH: the GSD library is built "
                           "from source")
    return path


def _build(name, src, compiler, flags):
    digest = source_digest(src, flags)
    out_dir = _PKG / "build"
    lib = out_dir / f"lib{name}-{digest}.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([compiler, *flags, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{Path(compiler).name} failed to build "
                               f"{src.name}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    BUILD_LOG[name] = (time.perf_counter() - t0,
                       proc.stdout + proc.stderr)
    return lib


def build_shared_library(name):
    """Path of the compiled ``csrc/<name>.cu`` library, building it if
    no library for this exact source, header set and flag set exists
    yet."""
    return _build(name, _PKG / "csrc" / f"{name}.cu", _nvcc(), _FLAGS)


def build_host_library(name):
    """Path of the compiled ``csrc/<name>.cpp`` host library (``g++``, no
    ``nvcc``), built as :func:`build_shared_library` builds a kernel's."""
    return _build(name, _PKG / "csrc" / f"{name}.cpp", _gxx(), _HOST_FLAGS)
