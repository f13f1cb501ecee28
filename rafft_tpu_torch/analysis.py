"""Analysis helpers — native equivalents of the reference's
utility/utils_analysis.py (ct parsing, ct2db, loop-content statistics)
and the notebook-level statistics of analysis.org.

The ViennaRNA calls used there are replaced:
  RNA.b2Shapiro  -> shapiro() (coarse-grained loop notation)
  ct2db binary   -> ct_to_db()

The port's own copy of rafft_tpu/analysis.py; only its imports differ.
"""

from __future__ import annotations

import math
from collections import Counter

from rafft_tpu_torch.struct import pair_table, dot_bracket


def read_true_struct(infile="benchmark_cleaned.csv"):
    results = {}
    for line in open(infile):
        seq, struct, name = line.strip().split(",")
        results[seq] = (struct, name)
    return results


def read_csv(infile, header=True):
    rows = []
    with open(infile) as fh:
        if header:
            fh.readline()
        for line in fh:
            rows.append(line.strip().split(","))
    return rows


def parse_ct(path):
    """Parse a .ct file -> (sequence, pair list 0-based)."""
    seq = []
    pairs = []
    with open(path) as fh:
        first = fh.readline().split()
        nb = int(first[0])
        for _ in range(nb):
            parts = fh.readline().split()
            idx = int(parts[0]) - 1
            seq.append(parts[1])
            partner = int(parts[4]) - 1
            if partner > idx:
                pairs.append((idx, partner))
    return "".join(seq), pairs


def ct_to_db(path):
    """.ct -> dot-bracket (the reference shells out to ViennaRNA's
    ct2db, utils_analysis.py:76-81); pseudoknotted pairs are dropped
    like ct2db's default."""
    seq, pairs = parse_ct(path)
    keep = []
    for (i, j) in sorted(pairs):
        if all(not (a < i < b < j or i < a < j < b) for a, b in keep):
            keep.append((i, j))
    return seq, dot_bracket(keep, len(seq))


def write_ct(struct, sequence, out_file, name):
    """Write a .ct file (parity with scoring.py:43-60)."""
    from rafft_tpu_torch.struct import paired_positions

    pair_co = {}
    for pi, pj in paired_positions(struct):
        pair_co[pi] = pj
        pair_co[pj] = pi
    with open(out_file, "w") as out:
        out.write(f"{len(sequence)} {name}\n")
        for i, nuc in enumerate(sequence):
            bp_id = pair_co[i] + 1 if i in pair_co else 0
            out.write(f"{i+1} {nuc} {i} {i+2} {bp_id} {i+1}\n")


def shapiro(structure: str) -> str:
    """Coarse-grained (Shapiro) loop notation of a dot-bracket string:
    H hairpin, B bulge, I internal, M multiloop, S stem, E exterior,
    R root — e.g. '((((...)))).' -> '(R(S(H)))'."""
    n = len(structure)
    pt = pair_table(structure)

    def members(i, j):
        out = []
        k = i + 1
        while k < j:
            if pt[k] > k:
                out.append((k, pt[k]))
                k = pt[k] + 1
            else:
                out.append((k, -1))
                k += 1
        return out

    def stem(i, j):
        k1, k2 = i, j
        ln = 1
        while k1 + 1 < k2 and pt[k1 + 1] == k2 - 1:
            k1 += 1
            k2 -= 1
            ln += 1
        return k1, k2, ln

    def loop(i, j):
        mem = members(i, j)
        childs = [(a, b) for a, b in mem if b >= 0]
        un = sum(1 for _a, b in mem if b < 0)
        del un
        if not childs:
            return "(H)"
        inner = "".join(render(a, b) for a, b in childs)
        if len(childs) == 1:
            side5 = childs[0][0] - i - 1
            side3 = j - childs[0][1] - 1
            if side5 == 0 or side3 == 0:
                return f"(B{inner})"
            return f"(I{inner})"
        return f"(M{inner})"

    def render(i, j):
        k1, k2, ln = stem(i, j)
        return f"(S{loop(k1, k2)})"

    top = members(-1, n)
    childs = [(a, b) for a, b in top if b >= 0]
    if not childs:
        return "(E)"
    return "(R" + "".join(render(a, b) for a, b in childs) + ")"


def shapiro_weighted(structure: str) -> str:
    """Size-annotated Shapiro notation (RNA.b2Shapiro semantics,
    utility/utils_analysis.py:84): loop tokens carry the number of
    unpaired bases in the loop (H/B/I/M/E), stems the number of pairs
    (S) — e.g. '((((...)))).' -> '(((H3)S4)E1R)'."""
    n = len(structure)
    pt = pair_table(structure)

    def members(i, j):
        out = []
        k = i + 1
        while k < j:
            if pt[k] > k:
                out.append((k, pt[k]))
                k = pt[k] + 1
            else:
                out.append((k, -1))
                k += 1
        return out

    def stem(i, j):
        k1, k2 = i, j
        ln = 1
        while k1 + 1 < k2 and pt[k1 + 1] == k2 - 1:
            k1 += 1
            k2 -= 1
            ln += 1
        return k1, k2, ln

    def loop(i, j):
        mem = members(i, j)
        childs = [(a, b) for a, b in mem if b >= 0]
        un = sum(1 for _a, b in mem if b < 0)
        if not childs:
            return f"(H{un})"
        inner = "".join(render(a, b) for a, b in childs)
        if len(childs) == 1:
            if un == 0 or (childs[0][0] - i - 1 == 0
                           or j - childs[0][1] - 1 == 0):
                return f"({inner}B{un})" if un else f"({inner}B0)"
            return f"({inner}I{un})"
        return f"({inner}M{un})"

    def render(i, j):
        k1, k2, ln = stem(i, j)
        return f"({loop(k1, k2)}S{ln})"

    top = members(-1, n)
    childs = [(a, b) for a, b in top if b >= 0]
    un = sum(1 for _a, b in top if b < 0)
    inner = "".join(render(a, b) for a, b in childs)
    return f"({inner}E{un}R)"


def loop_content_sized(structure: str):
    """Size-weighted loop composition fractions (I, S, M, H, E, B) —
    the reference's get_loop_content (utils_analysis.py:83-101)."""
    import re

    sh = shapiro_weighted(structure)
    tot = {}
    for t in "ISMHEB":
        tot[t] = sum(int(x) for x in re.findall(t + r"(\d+)", sh))
    s = sum(tot.values())
    if s == 0:
        return (0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
    return tuple(tot[t] / s for t in "ISMHEB")


def loop_content(structure: str) -> Counter:
    """Counts of loop types in the coarse-grained notation
    (analysis.org loop-composition statistics, utils_analysis.py:83-101)."""
    sh = shapiro(structure)
    return Counter(c for c in sh if c in "HBIMSE")


def loop_entropy(structures) -> float:
    """Mean Shannon entropy of per-structure loop-type composition
    (the analysis.org loop-content entropy statistic)."""
    ent = []
    for db in structures:
        c = loop_content(db)
        tot = sum(c.values())
        if tot == 0:
            continue
        e = -sum((v / tot) * math.log(v / tot) for v in c.values() if v)
        ent.append(e)
    return sum(ent) / len(ent) if ent else 0.0
