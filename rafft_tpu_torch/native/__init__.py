"""ctypes binding for the native Turner evaluator (host C++).

Counterpart of rafft_tpu/native/__init__.py.  turner_eval.cpp is built
with g++ at first use into build/rafft_tpu_torch/ (never next to the
source) and initialised with the calibrated tables of
rafft_tpu_torch.energy.params, so the numpy and the native evaluator
share one parameter source.  `native_oracle(temperature)` returns a fast
eval(codes, pt) -> int callable; it raises RuntimeError where no C++
compiler is found (fold_cpu then takes the numpy evaluator and says so).
"""

from __future__ import annotations

import ctypes

import numpy as np

from rafft_tpu_torch import _build
from rafft_tpu_torch.energy.params import dense_special, get_params

_I8P = ctypes.POINTER(ctypes.c_int8)
_I32P = ctypes.POINTER(ctypes.c_int32)
# the temperature the library's tables were last initialised for
_INIT_TEMP = None


def _lib():
    lib = _build.load("turner_eval")
    if not getattr(lib, "_rafft_typed", False):
        lib.turner_eval.restype = ctypes.c_int32
        lib.turner_eval.argtypes = [_I8P, _I32P, ctypes.c_int32]
        lib.turner_init.restype = None
        lib.turner_init.argtypes = ([_I32P] * 4 + [ctypes.c_int32]
                                    + [_I32P] * 14 + [ctypes.c_int32] * 6)
        lib._rafft_typed = True
    return lib


def _init_tables(lib, temperature: float):
    global _INIT_TEMP
    if _INIT_TEMP == temperature:
        return
    p = get_params(temperature)
    keep = []  # the arrays must outlive the call

    def ptr(a):
        a = np.ascontiguousarray(a, dtype=np.int32)
        keep.append(a)
        return a.ctypes.data_as(_I32P)

    lib.turner_init(
        ptr(p.stack), ptr(p.hairpin_ext), ptr(p.bulge_ext),
        ptr(p.internal_ext), len(p.hairpin_ext),
        ptr(p.mismatch_h), ptr(p.mismatch_i), ptr(p.mismatch_1n),
        ptr(p.mismatch_23), ptr(p.mismatch_m), ptr(p.mismatch_ext),
        ptr(p.dangle5), ptr(p.dangle3),
        ptr(p.int11), ptr(p.int21), ptr(p.int22),
        ptr(dense_special(p.tetraloops, 6)),
        ptr(dense_special(p.triloops, 5)),
        ptr(dense_special(p.hexaloops, 8)),
        p.terminal_au, p.ml_closing, p.ml_intern, p.ml_base, p.ninio_m,
        p.ninio_max)
    _INIT_TEMP = temperature


def native_oracle(temperature: float = 37.0):
    """Returns eval(codes int8 [n], pt int32 [n]) -> int (dekacal/mol).

    The library holds one table set: the returned callable re-initialises
    it when another temperature was used in between."""
    lib = _lib()
    _init_tables(lib, temperature)

    def ev(codes: np.ndarray, pt: np.ndarray) -> int:
        if codes.dtype != np.int8 or pt.dtype != np.int32 \
                or len(codes) != len(pt):
            raise ValueError("native evaluator takes int8 codes and an "
                             "int32 pair table of one length")
        _init_tables(lib, temperature)
        codes = np.ascontiguousarray(codes)
        pt = np.ascontiguousarray(pt)
        return lib.turner_eval(codes.ctypes.data_as(_I8P),
                               pt.ctypes.data_as(_I32P), len(codes))

    return ev
