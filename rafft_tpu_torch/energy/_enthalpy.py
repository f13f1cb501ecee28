"""Nearest-neighbour enthalpies for temperature rescaling.

The reference delegates temperature to ViennaRNA's model details
(the reference's rafft/utils.py:18-21, ``RNA.md().temperature``), which
rescales every Turner table as  dG(T) = dH - (dH - dG37) * T/T37.

This environment ships no ViennaRNA parameter files, so the enthalpy
model here is built from the published Watson-Crick nearest-neighbour
measurements plus an explicit physical approximation for the rest:

* WC x WC stacks: duplex enthalpies of Xia et al. 1998 (Biochemistry
  37:14719), the data underlying the Turner-2004 stack table.  The
  mapping duplex -> (pair-type, pair-type) matrix cell is derived by
  decoding each cell's duplex and is self-checked at import time
  against the known dG37 matrix (rounding duplex dG to dekacal must
  reproduce energy._turner2004.STACK exactly).
* terminal AU: dH = +3.72 kcal/mol (same source).
* loop initiations (hairpin/bulge/internal), multiloop penalties and
  the log-extrapolation term: treated as purely entropic (dH = 0), the
  Jacobson-Stockmayer picture -- the penalty scales linearly with T.
* GU-containing stacks, mismatches, dangles: held athermal (dH := dG37)
  because no trustworthy enthalpy source is available in-environment.
  At T = 37 C every parameter is exact regardless.
"""

from __future__ import annotations

import numpy as np

from rafft_tpu_torch.energy import _turner2004 as T

# Xia et al. 1998 Watson-Crick duplex parameters, kcal/mol.
# Key "XY/WZ": top strand 5'-XY-3' stacked on bottom strand 5'-WZ-3'
# (the literature convention; the bottom strand is read 5'->3').
_XIA_DUPLEX = {
    "AA/UU": (-6.82, -0.93),
    "AU/AU": (-9.38, -1.10),
    "UA/UA": (-7.69, -1.33),
    "CU/AG": (-10.48, -2.08),
    "CA/UG": (-10.44, -2.11),
    "GU/AC": (-11.40, -2.24),
    "GA/UC": (-12.44, -2.35),
    "CG/CG": (-10.64, -2.36),
    "GG/CC": (-13.39, -3.26),
    "GC/GC": (-14.88, -3.42),
}

TERMINAL_AU_DH = 370       # Xia 1998: +3.72 kcal/mol

# pair-type order used throughout _turner2004 (index 1..6)
_PAIRS = [None, ("C", "G"), ("G", "C"), ("G", "U"),
          ("U", "G"), ("A", "U"), ("U", "A")]
_WC = {1, 2, 5, 6}


def _duplex_lookup(a, b, c, d):
    """Stack cell (p=(a,b), q=(c,d)) == duplex top 5'-a d-3' over
    bottom 3'-b c-5' (q is the reversed inner pair,
    _turner2004.py:58-60), i.e. key "ad/cb" with the bottom read
    5'->3'.  A duplex and its 180-degree strand swap ("cb/ad") are the
    same measurement."""
    n1 = f"{a}{d}/{c}{b}"
    n2 = f"{c}{b}/{a}{d}"
    if n1 in _XIA_DUPLEX:
        return _XIA_DUPLEX[n1]
    return _XIA_DUPLEX[n2]


def build_stack_dh():
    """STACK_DH[p][q] in dekacal; athermal (== dG37) outside WC x WC."""
    dh = T.STACK.astype(np.int32).copy()
    for p in _WC:
        for q in _WC:
            a, b = _PAIRS[p]
            c, d = _PAIRS[q]
            xh, xg = _duplex_lookup(a, b, c, d)
            # self-check: rounding the duplex dG37 to 0.1 kcal (the
            # Turner-table granularity) must reproduce the shipped
            # stack table, proving the decode is the right convention
            # for this cell
            assert int(round(xg * 10)) * 10 == int(T.STACK[p][q]), \
                (p, q, xg, T.STACK[p][q])
            dh[p][q] = int(round(xh * 10)) * 10
    return dh


STACK_DH = build_stack_dh()


def rescale(dg37, dh, tempf):
    """dG(T) = dH - (dH - dG37) * T/T37 in integer dekacal.

    INF sentinels pass through untouched.  Works elementwise on numpy
    arrays or python ints."""
    dg37 = np.asarray(dg37, dtype=np.int64)
    dh = np.asarray(dh, dtype=np.int64)
    out = dh - np.rint((dh - dg37) * tempf).astype(np.int64)
    out = np.where(np.abs(dg37) >= T.INF, dg37, out)
    return out.astype(np.int32)
