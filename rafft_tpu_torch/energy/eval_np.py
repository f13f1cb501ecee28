"""Exact integer CPU evaluator for the Turner-2004 model.

This is the framework's energy oracle, replacing the reference's
``fold_compound.eval_structure`` call (the reference's rafft/utils.py:135-138).
It evaluates a fixed secondary structure under the standard
nearest-neighbour decomposition with the double-dangle (d2) model used by
the reference's model defaults:

  exterior:   per stem, terminal mismatch of both adjacent nucleotides
  hairpin:    length init + terminal mismatch + special tetra/tri/hexaloops
  two-loop:   stack / bulge / internal (1x1, 2x1, 2x2, 2x3, 1xn, generic)
  multiloop:  affine (closing + per-stem) + per-stem terminal mismatches

All arithmetic is int32 dekacal/mol -> bit-stable across platforms.
"""

from __future__ import annotations

from rafft_tpu_torch.energy.params import EnergyParams, get_params, encode_sequence
from rafft_tpu_torch.energy._turner2004 import PAIR_TYPE
from rafft_tpu_torch.struct import pair_table


def _ptype(s, i, j):
    t = PAIR_TYPE[s[i], s[j]]
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


def eval_structure_int(seq, structure, params: EnergyParams | None = None):
    """Exact integer (dekacal) energy of ``structure`` on ``seq``.

    ``structure`` may be a dot-bracket string, a pair list, or a pair
    table (np array / list with pt[i]=j or -1).
    """
    p = params or get_params()
    s = encode_sequence(seq)
    n = len(seq)
    useq = seq.upper().replace("T", "U")

    if isinstance(structure, str):
        pt = pair_table(structure)
    elif isinstance(structure, (list, tuple)) and structure and isinstance(structure[0], tuple):
        pt = pair_table(structure, n)
    else:
        pt = list(structure)

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


def eval_structure(seq, structure, params: EnergyParams | None = None) -> float:
    """Energy in kcal/mol (float), as the reference's oracle returns."""
    return eval_structure_int(seq, structure, params) / 100.0
