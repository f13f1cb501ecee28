"""Structures and dot-brackets: a frozen copy of the port's struct.py
(the parts the reference fold reads)."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Structure:
    """A secondary structure intermediate.

    ``node_list`` holds the unpaired regions still open for helix
    formation; ``pair_list`` the formed base pairs as (i, j) 0-based
    tuples; ``str_struct`` the dot-bracket string."""

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


def pair_table(pairs, len_seq):
    """pt[i] = j (partner) or -1, from a pair list."""
    pt = [-1] * len_seq
    for i, j in pairs:
        pt[i] = j
        pt[j] = i
    return pt


def merge_pair_list(pair_1, pair_2):
    """Append into ``pair_1`` every pair of ``pair_2`` not already there,
    in ``pair_2``'s order."""
    have = set(pair_1)
    for el in pair_2:
        if el not in have:
            pair_1.append(el)
            have.add(el)
