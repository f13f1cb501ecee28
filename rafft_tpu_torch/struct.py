"""Core structure/dot-bracket utilities.

Behavioural parity targets:
  - dot_bracket            ~ the reference's rafft/utils.py:42-50
  - paired_positions       ~ the reference's rafft/utils.py:53-67
  - merge_pair_list        ~ the reference's rafft/utils.py:155-158
  - read_fasta             ~ the reference's rafft/utils.py:161-169
  - parse_rafft_output     ~ the reference's rafft/utils.py:172-185

All code here is a fresh implementation of the documented behaviour.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Structure:
    """A secondary structure intermediate.

    ``node_list`` holds the unpaired regions still open for helix
    formation (engine-internal); ``pair_list`` the formed base pairs
    as (i, j) 0-based tuples; ``str_struct`` the dot-bracket string.
    """

    node_list: list = field(default_factory=list)
    pair_list: list = field(default_factory=list)
    energy: float = 0.0
    str_struct: str = ""


def dot_bracket(pair_list, len_seq):
    """Render a pair list as a dot-bracket string of length ``len_seq``."""
    chars = ["."] * len_seq
    for pi, pj in pair_list:
        chars[pi] = "("
        chars[pj] = ")"
    return "".join(chars)


def paired_positions(structure):
    """Return the list of (i, j) pairs encoded by a dot-bracket string.

    Supports '<'/'(' and '['-style pseudoknot brackets, in the order the
    closing bracket is encountered (reference order).
    """
    pile_reg, pile_pk = [], []
    pairs = []
    for i, c in enumerate(structure):
        if c in "<(":
            pile_reg.append(i)
        elif c == "[":
            pile_pk.append(i)
        elif c in ">)":
            pairs.append((pile_reg.pop(), i))
        elif c == "]":
            pairs.append((pile_pk.pop(), i))
    return pairs


def pair_table(structure_or_pairs, len_seq=None):
    """Return pt[i] = j (partner) or -1, from dot-bracket or pair list."""
    if isinstance(structure_or_pairs, str):
        pairs = paired_positions(structure_or_pairs)
        len_seq = len(structure_or_pairs)
    else:
        pairs = structure_or_pairs
        assert len_seq is not None
    pt = [-1] * len_seq
    for i, j in pairs:
        pt[i] = j
        pt[j] = i
    return pt


def merge_pair_list(pair_1, pair_2):
    """Append into ``pair_1`` every pair of ``pair_2`` not already present.

    Matches the reference's set-difference append (order of the appended
    pairs follows Python set iteration in the reference; here we preserve
    pair_2 order, which is deterministic — downstream consumers only use
    the pair *set*)."""
    have = set(pair_1)
    for el in pair_2:
        if el not in have:
            pair_1.append(el)
            have.add(el)


def read_fasta(infile):
    """Parse a (multi-)fasta file into {name: sequence}."""
    results = {}
    name = None
    for line in open(infile):
        if line.startswith(">"):
            name = line.strip()[1:]
            results[name] = ""
        else:
            results[name] += line.strip()
    return results


def parse_rafft_output(infile):
    """Parse the rafft text protocol: first line the sequence, then
    per-step blocks delimited by lines starting with '# --', each line
    '<struct> <energy>'. Returns (list-of-steps, sequence)."""
    results = []
    with open(infile) as fh:
        seq = fh.readline().strip()
        for line in fh:
            if line.startswith("# --"):
                results.append([])
            else:
                str_struct, nrj = line.strip().split()
                st = Structure()
                st.str_struct = str_struct
                st.energy = float(nrj)
                results[-1].append(st)
    return results, seq
