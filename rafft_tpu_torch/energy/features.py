"""Loop-feature extraction: structure -> {parameter key: count} + offset.

Mirrors `eval_np.eval_structure_int` contribution-for-contribution, so

    energy == offset + sum(count * value(key))

A property test asserts this identity against the evaluator.  Used by the
calibration pipeline (tools/calibrate_energy.py) to recover exact table
entries from the reference's frozen (seq, struct, energy) corpus, and by
unit tests to explain any energy as a sum of named parameters.

Feature keys (tuples):
  ("stack", t1, t2)                  ("hairpin", size<=30)
  ("bulge", size<=30)                ("internal", size<=30)
  ("mmh"|"mmi"|"mm1n"|"mm23"|"mmm"|"mmext", t, x, y)
  ("dangle5"|"dangle3", t, x)
  ("int11", t1, t2, x, y)            ("int21", t1, t2, x, y, z)
  ("int22", t1, t2, x1, x2, y1, y2)
  ("TAU",)  ("MLc",)  ("MLi",)  ("MLu",)   [terminal-AU, ML closing/stem/unpaired]
  ("NINIO_M",) weighted by asymmetry (uncapped part), ("NINIO_MAX",)
  ("tri", key5) ("tetra", key6) ("hexa", key8)   [special-hairpin totals]

With specials_as_params=True, *every* size-3/4/6 hairpin is emitted as a
single ("tri"/"tetra"/"hexa", key) feature — the calibration then decides
per key whether it matches the generic decomposition (non-member) or is a
special loop (member).  With False, only keys present in the params'
special tables are emitted as totals; others decompose generically.

The port's own copy of rafft_tpu/energy/features.py; only its imports differ.
"""

from __future__ import annotations

from collections import Counter

from rafft_tpu_torch.energy.params import EnergyParams, get_params, encode_sequence
from rafft_tpu_torch.energy._turner2004 import PAIR_TYPE
from rafft_tpu_torch.struct import pair_table


def _ptype(s, i, j):
    t = PAIR_TYPE[s[i], s[j]]
    return 7 if t == 0 else int(t)


def featurize(seq, structure, params: EnergyParams | None = None,
              specials_as_params: bool = False):
    """Return (features: Counter, offset: int)."""
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

    feats: Counter = Counter()
    offset = 0

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

    def loop_init(kind, size):
        nonlocal offset
        if size <= 30:
            feats[(kind, size)] += 1
        else:
            feats[(kind, 30)] += 1
            offset += int(p.lxc * __import__("math").log(size / 30.0))

    def ninio(nl, ns):
        # one feature per asymmetry value: ("NINIO", d) == min(max, m*d).
        # Keeps the fit linear without assuming the slope/cap up front.
        d = nl - ns
        if d == 0:
            return
        feats[("NINIO", d)] += 1

    def hairpin(i, j):
        size = j - i - 1
        t = _ptype(s, i, j)
        key = useq[i : j + 1]
        if size == 4:
            if specials_as_params:
                feats[("tetra", key)] += 1
                return
            if key in p.tetraloops:
                feats[("tetra", key)] += 1
                return
        elif size == 6:
            if specials_as_params:
                feats[("hexa", key)] += 1
                return
            if key in p.hexaloops:
                feats[("hexa", key)] += 1
                return
        elif size == 3:
            if specials_as_params:
                feats[("tri", key)] += 1
                return
            if key in p.triloops:
                feats[("tri", key)] += 1
                return
            loop_init("hairpin", size)
            if t > 2:
                feats[("TAU",)] += 1
            return
        loop_init("hairpin", size)
        feats[("mmh", t, int(s[i + 1]), int(s[j - 1]))] += 1

    def int_loop(i, j, q, r):
        n1, n2 = q - i - 1, j - r - 1
        t1, t2 = _ptype(s, i, j), _ptype(s, r, q)
        nl, ns = (n1, n2) if n1 > n2 else (n2, n1)
        if nl == 0:
            feats[("stack", t1, t2) if t1 <= t2 else ("stack", t2, t1)] += 1
            return
        if ns == 0:
            loop_init("bulge", nl)
            if nl == 1:
                feats[("stack", t1, t2) if t1 <= t2 else ("stack", t2, t1)] += 1
            else:
                if t1 > 2:
                    feats[("TAU",)] += 1
                if t2 > 2:
                    feats[("TAU",)] += 1
            return
        si1, sj1 = int(s[i + 1]), int(s[j - 1])
        sp1, sq1 = int(s[q - 1]), int(s[r + 1])
        if ns == 1:
            if nl == 1:
                # physical symmetry: int11[t1][t2][x][y] == int11[t2][t1][y][x];
                # canonicalise so both loop orientations share one key
                k1 = ("int11", t1, t2, si1, sj1)
                k2 = ("int11", t2, t1, sj1, si1)
                feats[min(k1, k2)] += 1
                return
            if nl == 2:
                if n1 == 1:
                    feats[("int21", t1, t2, si1, sq1, sj1)] += 1
                else:
                    feats[("int21", t2, t1, sq1, si1, sp1)] += 1
                return
            loop_init("internal", nl + 1)
            ninio(nl, ns)
            feats[("mm1n", t1, si1, sj1)] += 1
            feats[("mm1n", t2, sq1, sp1)] += 1
            return
        if ns == 2:
            if nl == 2:
                # physical symmetry: int22[t1][t2][a][b][c][d] == int22[t2][t1][c][d][a][b]
                k1 = ("int22", t1, t2, si1, sp1, sq1, sj1)
                k2 = ("int22", t2, t1, sq1, sj1, si1, sp1)
                feats[min(k1, k2)] += 1
                return
            if nl == 3:
                feats[("internal", 5)] += 1
                feats[("NINIO", 1)] += 1
                feats[("mm23", t1, si1, sj1)] += 1
                feats[("mm23", t2, sq1, sp1)] += 1
                return
        loop_init("internal", nl + ns)
        ninio(nl, ns)
        feats[("mmi", t1, si1, sj1)] += 1
        feats[("mmi", t2, sq1, sp1)] += 1

    def ml_stem(t, i5, i3):
        feats[("mmm", t, int(s[i5]), int(s[i3]))] += 1
        if t > 2:
            feats[("TAU",)] += 1
        feats[("MLi",)] += 1

    for i in ext_stems:
        j = pt[i]
        t = _ptype(s, i, j)
        if i > 0 and j < n - 1:
            feats[("mmext", t, int(s[i - 1]), int(s[j + 1]))] += 1
        elif i > 0:
            feats[("dangle5", t, int(s[i - 1]))] += 1
        elif j < n - 1:
            feats[("dangle3", t, int(s[j + 1]))] += 1
        if t > 2:
            feats[("TAU",)] += 1

    for i, kids in children.items():
        j = pt[i]
        if not kids:
            hairpin(i, j)
        elif len(kids) == 1:
            q = kids[0]
            int_loop(i, j, q, pt[q])
        else:
            feats[("MLc",)] += 1
            ml_stem(_ptype(s, j, i), j - 1, i + 1)
            unpaired = 0
            prev_end = i
            for q in kids:
                ml_stem(_ptype(s, q, pt[q]), q - 1, pt[q] + 1)
                unpaired += q - prev_end - 1
                prev_end = pt[q]
            unpaired += j - prev_end - 1
            if unpaired:
                feats[("MLu",)] += unpaired

    return feats, offset


_REV = [0, 2, 1, 4, 3, 6, 5, 7]


def _rev(t):
    return _REV[t]


def value_of(key, p: EnergyParams):
    """Current parameter value for a feature key."""
    kind = key[0]
    if kind == "stack":
        return int(p.stack[key[1], key[2]])
    if kind == "hairpin":
        return int(p.hairpin[key[1]])
    if kind == "bulge":
        return int(p.bulge[key[1]])
    if kind == "internal":
        return int(p.internal[key[1]])
    if kind == "mmh":
        return int(p.mismatch_h[key[1], key[2], key[3]])
    if kind == "mmi":
        return int(p.mismatch_i[key[1], key[2], key[3]])
    if kind == "mm1n":
        return int(p.mismatch_1n[key[1], key[2], key[3]])
    if kind == "mm23":
        return int(p.mismatch_23[key[1], key[2], key[3]])
    if kind == "mmm":
        return int(p.mismatch_m[key[1], key[2], key[3]])
    if kind == "mmext":
        return int(p.mismatch_ext[key[1], key[2], key[3]])
    if kind == "dangle5":
        return int(p.dangle5[key[1], key[2]])
    if kind == "dangle3":
        return int(p.dangle3[key[1], key[2]])
    if kind == "int11":
        return int(p.int11[key[1], key[2], key[3], key[4]])
    if kind == "int21":
        return int(p.int21[key[1], key[2], key[3], key[4], key[5]])
    if kind == "int22":
        return int(p.int22[key[1], key[2], key[3], key[4], key[5], key[6]])
    if kind == "TAU":
        return p.terminal_au
    if kind == "MLc":
        return p.ml_closing
    if kind == "MLi":
        return p.ml_intern
    if kind == "MLu":
        return p.ml_base
    if kind == "NINIO":
        return min(p.ninio_max, key[1] * p.ninio_m)
    if kind == "tri":
        return _special_total(key[1], p.triloops, p, 3)
    if kind == "tetra":
        return _special_total(key[1], p.tetraloops, p, 4)
    if kind == "hexa":
        return _special_total(key[1], p.hexaloops, p, 6)
    raise KeyError(key)


def _special_total(loopstr, table, p, size):
    """Total energy of a size-3/4/6 hairpin given its closing-pair-inclusive
    string: the special-table value if present, else the generic sum."""
    if loopstr in table:
        return table[loopstr]
    s = encode_sequence(loopstr)
    t = _ptype(s, 0, len(loopstr) - 1)
    e = int(p.hairpin[size])
    if size == 3:
        return e + (p.terminal_au if t > 2 else 0)
    return e + int(p.mismatch_h[t, s[1], s[-2]])


def energy_from_features(feats, offset, p: EnergyParams | None = None):
    p = p or get_params()
    return offset + sum(cnt * value_of(k, p) for k, cnt in feats.items())
