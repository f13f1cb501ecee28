"""Energy-parameter container + temperature scaling.

The reference obtains its energy oracle from ViennaRNA's model-details
(`RNA.md()` with ``temperature`` set, the reference's rafft/utils.py:18-21).
Here parameters live in plain numpy arrays (int32 dekacal) so the same
data backs the CPU oracle, the PyTorch evaluator (device-resident
gathers) and the C++ native oracle.  The port's own copy of
rafft_tpu/energy/params.py.

Temperature scaling follows the standard nearest-neighbour rescale
    dG(T) = dH - (dH - dG37) * (T + K0) / (37 + K0)
with the enthalpy model of energy/_enthalpy.py: published Xia-1998
enthalpies for WC stacks and the terminal-AU penalty, an entropic
(dH = 0) model for loop initiations / multiloop / ninio / lxc, and
athermal (dH = dG37) for terms with no in-environment enthalpy source
(GU stacks, mismatches, dangles).  At T=37 C all parameters are exact
regardless (the frozen parity corpus is entirely at 37 C).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np

from rafft_tpu_torch.energy import _turner2004 as T


@dataclass
class EnergyParams:
    temperature: float = 37.0

    stack: np.ndarray = None
    hairpin: np.ndarray = None
    bulge: np.ndarray = None
    internal: np.ndarray = None
    mismatch_h: np.ndarray = None
    mismatch_i: np.ndarray = None
    mismatch_1n: np.ndarray = None
    mismatch_23: np.ndarray = None
    mismatch_m: np.ndarray = None
    mismatch_ext: np.ndarray = None
    dangle5: np.ndarray = None
    dangle3: np.ndarray = None
    int11: np.ndarray = None
    int21: np.ndarray = None
    int22: np.ndarray = None

    terminal_au: int = T.TERMINAL_AU
    ml_base: int = T.ML_BASE
    ml_closing: int = T.ML_CLOSING
    ml_intern: int = T.ML_INTERN
    ninio_m: int = T.NINIO_M
    ninio_max: int = T.NINIO_MAX
    lxc: float = T.LXC

    tetraloops: dict = field(default_factory=dict)
    triloops: dict = field(default_factory=dict)
    hexaloops: dict = field(default_factory=dict)

    # precomputed log-extrapolation tables: loop sizes up to MAX_EXTRAP
    MAX_EXTRAP: int = 8192
    hairpin_ext: np.ndarray = None
    bulge_ext: np.ndarray = None
    internal_ext: np.ndarray = None

    def finalize(self):
        """Precompute extended (log-extrapolated) loop tables."""
        n = np.arange(self.MAX_EXTRAP + 1)
        with np.errstate(divide="ignore"):
            lxc_term = np.where(
                n > 30, (self.lxc * np.log(np.maximum(n, 1) / 30.0)).astype(np.int64), 0
            ).astype(np.int32)

        def ext(tab):
            out = np.empty(self.MAX_EXTRAP + 1, dtype=np.int32)
            out[:31] = tab
            out[31:] = tab[30] + lxc_term[31:]
            return out

        self.hairpin_ext = ext(self.hairpin)
        self.bulge_ext = ext(self.bulge)
        self.internal_ext = ext(self.internal)
        return self


def _apply_overrides(p: EnergyParams) -> EnergyParams:
    """Apply exact calibrated corrections, if present."""
    import os

    if os.environ.get("RAFFT_NO_CALIB"):  # calibration fits on pristine priors
        return p
    try:
        from rafft_tpu_torch.energy import _calibrated
    except ImportError:
        return p
    _calibrated.apply(p)
    return p


@lru_cache(maxsize=8)
def get_params(temperature: float = 37.0) -> EnergyParams:
    """Build the parameter set at the given temperature (C)."""
    p = EnergyParams(
        temperature=temperature,
        stack=T.STACK.copy(),
        hairpin=T.HAIRPIN.copy(),
        bulge=T.BULGE.copy(),
        internal=T.INTERNAL.copy(),
        mismatch_h=T.MISMATCH_H.copy(),
        mismatch_i=T.MISMATCH_I.copy(),
        mismatch_1n=T.MISMATCH_1N.copy(),
        mismatch_23=T.MISMATCH_23.copy(),
        mismatch_m=T.MISMATCH_M.copy(),
        mismatch_ext=T.MISMATCH_EXT.copy(),
        dangle5=T.DANGLE5.copy(),
        dangle3=T.DANGLE3.copy(),
        int11=T.INT11.copy(),
        int21=T.INT21.copy(),
        int22=T.INT22.copy(),
        tetraloops=dict(T.TETRALOOPS),
        triloops=dict(T.TRILOOPS),
        hexaloops=dict(T.HEXALOOPS),
    )
    p = _apply_overrides(p)
    if temperature != 37.0:
        # dG(T) = dH - (dH - dG37) * T/T37 (rafft/utils.py:18-21 via
        # RNA.md().temperature).  Enthalpy model: WC stacks + terminal
        # AU from Xia 1998; loop initiations / multiloop / ninio / lxc
        # purely entropic (dH = 0, scale with T); everything else
        # athermal -- see energy/_enthalpy.py.  Calibrated dG37
        # overrides are applied BEFORE rescaling so T=37 stays
        # corpus-exact and other temperatures extrapolate from the
        # pinned values.
        from rafft_tpu_torch.energy._enthalpy import (STACK_DH, TERMINAL_AU_DH,
                                                rescale)
        tempf = (temperature + T.K0) / (T.TEMP_MEASURE + T.K0)
        zero = np.int32(0)
        p.stack = rescale(p.stack, STACK_DH, tempf)
        p.hairpin = rescale(p.hairpin, zero, tempf)
        p.bulge = rescale(p.bulge, zero, tempf)
        p.internal = rescale(p.internal, zero, tempf)
        p.terminal_au = int(rescale(p.terminal_au, TERMINAL_AU_DH, tempf))
        p.ml_base = int(rescale(p.ml_base, zero, tempf))
        p.ml_closing = int(rescale(p.ml_closing, zero, tempf))
        p.ml_intern = int(rescale(p.ml_intern, zero, tempf))
        p.ninio_m = int(rescale(p.ninio_m, zero, tempf))
        p.ninio_max = int(rescale(p.ninio_max, zero, tempf))
        p.lxc = T.LXC * tempf
    p.finalize()
    return p


def encode_sequence(seq: str) -> np.ndarray:
    """Encode an RNA string to int codes (N=0, A=1, C=2, G=3, U=4).

    T is accepted as U; unknown IUPAC letters map to N.
    """
    table = np.zeros(256, dtype=np.int8)
    for c, i in T.BASE_INDEX.items():
        table[ord(c)] = i
        table[ord(c.lower())] = i
    table[ord("T")] = T.BASE_INDEX["U"]
    table[ord("t")] = T.BASE_INDEX["U"]
    return table[np.frombuffer(seq.encode("latin-1"), dtype=np.uint8)].astype(np.int32)


INT_MISS = int(np.iinfo(np.int32).min)


def dense_special(table: dict, k: int) -> np.ndarray:
    """dict of k-mer string -> energy  =>  dense base-5 keyed int32 array
    (INT_MISS where the k-mer has no entry); the special-loop tables as
    the PyTorch and the native evaluator index them."""
    arr = np.full(5 ** k, INT_MISS, dtype=np.int32)
    for s, v in table.items():
        key = 0
        for ch in s:
            key = key * 5 + T.BASE_INDEX[ch]
        arr[key] = v
    return arr
