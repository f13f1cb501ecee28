"""Exact integer Turner-2004 energy of a secondary structure, in plain
Python and NumPy: the parameter tables at 37 C and the evaluator.

A frozen copy of the port's energy/params.py (its 37 C branch, with the
calibrated corrections always applied) and energy/eval_np.py, kept
under the benchmark so that the reference a run is judged by cannot
change with the program.  All arithmetic is int32 dekacal/mol.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np

from perfbench.reference import calibrated
from perfbench.reference import turner2004 as T
from perfbench.reference.structs import pair_table


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


@lru_cache(maxsize=8)
def get_params(temperature: float = 37.0) -> EnergyParams:
    """The parameter set at 37 C, the only temperature the benchmark's
    configurations state."""
    if temperature != 37.0:
        raise ValueError(f"the reference holds the 37 C tables only, not {temperature}")
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
    calibrated.apply(p)
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


def _ptype(s, i, j):
    t = T.PAIR_TYPE[s[i], s[j]]
    return 7 if t == 0 else int(t)


def _hairpin(s, seq, i, j, p: EnergyParams):
    size = j - i - 1
    energy = int(p.hairpin_ext[size])
    t = _ptype(s, i, j)
    if size == 4:
        key = seq[i : j + 1]
        if key in p.tetraloops:
            return p.tetraloops[key]
    elif size == 6:
        key = seq[i : j + 1]
        if key in p.hexaloops:
            return p.hexaloops[key]
    elif size == 3:
        key = seq[i : j + 1]
        if key in p.triloops:
            return p.triloops[key]
        return energy + (p.terminal_au if t > 2 else 0)
    energy += int(p.mismatch_h[t, s[i + 1], s[j - 1]])
    return energy


def _int_loop(s, i, j, q, r, p: EnergyParams):
    """Energy of the two-loop closed by (i,j) with inner pair (q,r)."""
    n1 = q - i - 1
    n2 = j - r - 1
    t1 = _ptype(s, i, j)
    t2 = _ptype(s, r, q)  # inner pair reversed
    nl, ns = (n1, n2) if n1 > n2 else (n2, n1)

    if nl == 0:  # stack
        return int(p.stack[t1, t2])

    if ns == 0:  # bulge
        energy = int(p.bulge_ext[nl])
        if nl == 1:
            energy += int(p.stack[t1, t2])
        else:
            if t1 > 2:
                energy += p.terminal_au
            if t2 > 2:
                energy += p.terminal_au
        return energy

    si1, sj1 = s[i + 1], s[j - 1]
    sp1, sq1 = s[q - 1], s[r + 1]

    if ns == 1:
        if nl == 1:  # 1x1
            return int(p.int11[t1, t2, si1, sj1])
        if nl == 2:  # 2x1
            if n1 == 1:
                return int(p.int21[t1, t2, si1, sq1, sj1])
            return int(p.int21[t2, t1, sq1, si1, sp1])
        # 1xn, n > 2
        energy = int(p.internal_ext[nl + 1])
        energy += min(p.ninio_max, (nl - ns) * p.ninio_m)
        energy += int(p.mismatch_1n[t1, si1, sj1]) + int(p.mismatch_1n[t2, sq1, sp1])
        return energy
    if ns == 2:
        if nl == 2:  # 2x2
            return int(p.int22[t1, t2, si1, sp1, sq1, sj1])
        if nl == 3:  # 2x3
            energy = int(p.internal[5]) + p.ninio_m
            energy += int(p.mismatch_23[t1, si1, sj1]) + int(p.mismatch_23[t2, sq1, sp1])
            return energy

    # generic internal loop
    energy = int(p.internal_ext[nl + ns])
    energy += min(p.ninio_max, (nl - ns) * p.ninio_m)
    energy += int(p.mismatch_i[t1, si1, sj1]) + int(p.mismatch_i[t2, sq1, sp1])
    return energy


def _ml_stem(s, n, t, i5, i3, p: EnergyParams):
    """Multiloop stem contribution: mismatch + per-stem + AU penalty."""
    energy = int(p.mismatch_m[t, s[i5], s[i3]])
    if t > 2:
        energy += p.terminal_au
    return energy + p.ml_intern


def _ext_stem(s, n, i, j, p: EnergyParams):
    t = _ptype(s, i, j)
    s5 = s[i - 1] if i > 0 else None
    s3 = s[j + 1] if j < n - 1 else None
    if s5 is not None and s3 is not None:
        energy = int(p.mismatch_ext[t, s5, s3])
    elif s5 is not None:
        energy = int(p.dangle5[t, s5])
    elif s3 is not None:
        energy = int(p.dangle3[t, s3])
    else:
        energy = 0
    if t > 2:
        energy += p.terminal_au
    return energy


def eval_structure_int(seq, pairs, params: EnergyParams | None = None):
    """Exact integer (dekacal) energy of the structure of base pairs
    ``pairs`` ((i, j) tuples) on ``seq``."""
    p = params or get_params()
    s = encode_sequence(seq)
    n = len(seq)
    useq = seq.upper().replace("T", "U")
    pt = pair_table(pairs, n)

    # decompose: children of each closing pair + exterior stems
    ext_stems = []
    children: dict[int, list[int]] = {}
    stack: list[int] = []
    for i in range(n):
        j = pt[i]
        if j > i:
            if stack:
                children[stack[-1]].append(i)
            else:
                ext_stems.append(i)
            children[i] = []
            stack.append(i)
        elif 0 <= j < i:
            stack.pop()

    energy = 0
    for i in ext_stems:
        energy += _ext_stem(s, n, i, pt[i], p)

    for i, kids in children.items():
        j = pt[i]
        if not kids:
            energy += _hairpin(s, useq, i, j, p)
        elif len(kids) == 1:
            q = kids[0]
            energy += _int_loop(s, i, j, q, pt[q], p)
        else:
            # multiloop: closing pair treated as a reversed stem
            tc = _ptype(s, j, i)
            e = p.ml_closing + _ml_stem(s, n, tc, j - 1, i + 1, p)
            unpaired = 0
            prev_end = i
            for q in kids:
                tb = _ptype(s, q, pt[q])
                e += _ml_stem(s, n, tb, q - 1, pt[q] + 1, p)
                unpaired += q - prev_end - 1
                prev_end = pt[q]
            unpaired += j - prev_end - 1
            e += unpaired * p.ml_base
            energy += e

    return energy
