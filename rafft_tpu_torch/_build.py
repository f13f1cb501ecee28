"""Build the native sources and load them with ctypes.

The CUDA sources in csrc/ compile with nvcc, the host C++ evaluator in
native/ with g++.  Each source compiles on its own into a shared library
with a plain C interface, under build/rafft_tpu_torch/ at the repository
root, named by a hash of the source and the flags: a changed source
rebuilds, an unchanged one loads the cached library.  Nothing here runs
at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG.parent / "build" / "rafft_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
# host C++: no -march=native, the library may outlive the machine it
# was built on (a shared build directory)
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
HOST_SOURCES = {"turner_eval": PKG / "native" / "turner_eval.cpp"}

_LIBS: dict = {}
# name -> (seconds, compiler output) of the builds made by this process
BUILD_LOG: dict = {}


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def gxx() -> str:
    cand = shutil.which(os.environ.get("CXX", "g++"))
    if not cand:
        raise RuntimeError("g++ not found: the native Turner evaluator "
                           "needs a C++ compiler (set CXX)")
    return cand


def build(name: str) -> Path:
    """Compile csrc/<name>.cu (nvcc) or the host source of that name
    (g++) unless the cached library is current."""
    host = name in HOST_SOURCES
    src = HOST_SOURCES[name] if host else CSRC / f"{name}.cu"
    flags = GXX_FLAGS if host else NVCC_FLAGS
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(flags).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}_{digest}.so"
    if lib.exists():
        return lib
    compiler = gxx() if host else nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([compiler, *flags, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{compiler} failed on {src}:\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    BUILD_LOG[name] = (time.perf_counter() - t0, proc.stdout + proc.stderr)
    return lib


def load(name: str) -> ctypes.CDLL:
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build(name)))
    return _LIBS[name]
