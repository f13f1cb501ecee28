"""Build the native sources, load them with ctypes, and launch the hand
kernels.

The CUDA sources in csrc/ compile with nvcc, the host C++ evaluator in
native/ with g++.  Each source compiles on its own into a shared library
with a plain C interface, under build/rafft_tpu_torch/ at the repository
root, named by a hash of the source and the flags: a changed source
rebuilds, an unchanged one loads the cached library.  Nothing is built
at import.

Kernel is the launch path that the hand kernels' wrappers share
(engine/wavefront.py, engine/delta.py); KERNELS lists them, so the
graph layer counts their launches without naming any.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
import sys
from pathlib import Path

import torch

from rafft_tpu_torch import obs

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


# every hand kernel, in the order their wrappers were imported
KERNELS: list = []


class Kernel:
    """One hand kernel's launch path: the function `symbol` of the
    library built from csrc/<name>.cu, whose C arguments are `argtypes`
    (the CUDA stream last) and which returns a cudaError code.

    Its wrapper, the module `module`, keeps the launch counters as its
    globals LAUNCHES (launches made, a graph replay's included) and
    CAPTURED (launches recorded into a CUDA graph capture, which
    launches nothing: whoever replays the graph credits them with
    count_replay); obs.snapshot()["process"] reports them as
    <name>.launches and <name>.captured.  The wrapper keeps its own
    argument checks, C argument list, outputs and plain version, and
    calls on_card, check and launch in that order."""

    def __init__(self, name, module, symbol, argtypes):
        self.name = name
        self.module = sys.modules[module]
        self._symbol, self._argtypes = symbol, argtypes
        self._fn = None
        # argument signatures checked outside a capture
        self._checked = set()
        KERNELS.append(self)
        obs.process_counter(f"{name}.launches", lambda: self.module.LAUNCHES)
        obs.process_counter(f"{name}.captured", lambda: self.module.CAPTURED)

    @property
    def captured(self):
        return self.module.CAPTURED

    def on_card(self, dev) -> bool:
        """Whether tensors on `dev` launch the kernel: CUDA tensors do,
        CPU tensors take the wrapper's plain version, any other device
        raises."""
        if dev.type == "cpu":
            return False
        if dev.type != "cuda":
            raise ValueError(f"{self.name} kernel: unsupported device {dev}")
        return True

    def check(self, sig, checks, *args):
        """checks(*args), the wrapper's argument checks (host metadata
        only), on every call but inside a CUDA graph capture, which
        records the launch only: there raise unless a call of the same
        signature `sig` was checked before the capture."""
        if not torch.cuda.is_current_stream_capturing():
            checks(*args)
            self._checked.add(sig)
        elif sig not in self._checked:
            raise RuntimeError(f"{self.name} kernel: a call of an unchecked "
                               f"signature {sig} inside a CUDA graph "
                               "capture; make one call before the capture")

    def launch(self, dev, *args):
        """Launch the kernel with the C arguments `args` on the current
        stream of `dev`, raise on a launch error, and count the launch
        (CAPTURED inside a capture, else LAUNCHES)."""
        if self._fn is None:
            fn = getattr(load(self.name), self._symbol)
            fn.argtypes, fn.restype = self._argtypes, ctypes.c_int
            self._fn = fn
        capturing = torch.cuda.is_current_stream_capturing()
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            err = self._fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: "
                               f"cudaError {err}")
        if capturing:
            self.module.CAPTURED += 1
        else:
            self.module.LAUNCHES += 1

    def count_replay(self, n):
        """A CUDA graph that holds n launches of the kernel was
        replayed."""
        self.module.LAUNCHES += n
