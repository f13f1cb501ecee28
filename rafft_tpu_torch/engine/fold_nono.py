"""Tree-keeping fold engine — the reference's `--nono` test variant.

Behavioural parity with the reference's rafft/rafft_nono.py:
  - candidate stems are kept in *lag order* (not sorted by dE) before
    combination (create_nodes, rafft_nono.py:72-103);
  - every structure keeps an explicit parent->children tree; children
    are sorted and pruned to max_stack per parent (156-158), and
    children that fall out of the global beam are removed with the
    reference's iterate-while-removing semantics (168-171 — a Python
    for/remove loop that skips the element after each removal; mirrored
    here because it shapes the printed tree);
  - inner/outer nodes are appended including None placeholders (143);
  - returns (structures, root); the CLI prints the full tree.

The reference's mutable-default `seen=set()` (rafft_nono.py:108) leaks
across calls within one process; here the set is fresh per fold() — a
deliberate fix (each CLI invocation is a fresh process, so the text
output is identical).

The port's own copy of rafft_tpu/engine/fold_nono.py (numpy, no device):
the fold CLI's --nono engine.  The energy oracle is fold_cpu's (native
evaluator where it builds, else numpy).
"""

from __future__ import annotations

from itertools import product

import numpy as np

from rafft_tpu_torch.energy.params import encode_sequence
from rafft_tpu_torch.engine.fold_cpu import _Oracle
from rafft_tpu_torch.scan.encode import weight_matrix
from rafft_tpu_torch.scan.correlate import correlate_np, top_lags
from rafft_tpu_torch.scan.windows import window_slide_np
from rafft_tpu_torch.struct import dot_bracket, merge_pair_list


class TreeStructure:
    """Structure node of the explicit fold tree."""

    def __init__(self, bpList=None, node_list=None):
        self.energy = 0.0
        self.bpList = bpList if bpList is not None else []
        self.str_struct = ""
        self.children = []
        self.node_list = node_list if node_list is not None else []

    def __str__(self, level=0):
        ret = "\t" * level + repr(self.str_struct) + " level:" + str(level) + " \n"
        for child in self.children:
            ret += child.__str__(level + 1)
        return ret

    def __repr__(self):
        return '<Tree Node representation>'


def _create_nodes(struct, region_pos, codes, W, oracle, nb_mode, min_hp,
                  min_nrj):
    """Improving stems of one region, in lag order (unsorted)."""
    rcodes = codes[region_pos]
    m = len(region_pos)
    if m < 2:
        return []
    cor = correlate_np(rcodes, W)
    nodes = []
    for lag, _c in top_lags(cor, nb_mode):
        nb, ip, jp, _score = window_slide_np(rcodes, region_pos, W, lag, min_hp)
        if nb > 0:
            stem = [(int(region_pos[ip - t]), int(region_pos[jp + t]))
                    for t in range(nb)]
            tmp_energy = oracle(struct.bpList + stem)
            if tmp_energy - struct.energy < min_nrj:
                inner = region_pos[ip + 1: jp] if jp - ip > 1 else None
                if ip - (nb - 1) > 0 or jp + nb < m:
                    outer = np.concatenate(
                        (region_pos[: ip - nb + 1], region_pos[jp + nb:]))
                else:
                    outer = None
                nodes.append((inner, outer, struct.bpList + stem, tmp_energy))
    return nodes


def fold(sequence, nb_mode=100, max_stack=1, max_branch=100, min_hp=3,
         min_nrj=0.0, traj=False, temp=37.0, gc_wei=3.0, au_wei=2.0,
         gu_wei=1.0):
    """Tree-keeping fold; returns (structures, root)."""
    n = len(sequence)
    codes = encode_sequence(sequence)
    W = weight_matrix(gc_wei, au_wei, gu_wei)
    oracle = _Oracle(sequence, temp)

    root = TreeStructure(bpList=[], node_list=[np.arange(n, dtype=np.int64)])
    root.str_struct = "." * n
    structures = [root]
    seen: set[str] = set()

    while True:
        all_children = []
        for struct in structures:
            tmp_children = []
            for node in struct.node_list:
                if node is not None:
                    cur = _create_nodes(struct, node, codes, W, oracle,
                                        nb_mode, min_hp, min_nrj)
                    if len(cur) > 0:
                        tmp_children.append(cur)
            if len(tmp_children) > 0:
                all_children.append((struct, tmp_children))

        nb_branch = 0
        new_structures = []
        for struct, children in all_children:
            new_children = []
            for children_pair in product(*children):
                new_structure = TreeStructure(bpList=[], node_list=[])
                for inner, outer, tmp_pairs, _tmp_nrj in children_pair:
                    merge_pair_list(new_structure.bpList, tmp_pairs)
                    new_structure.node_list += [inner, outer]
                sigma = dot_bracket(new_structure.bpList, n)
                new_nrj = oracle(new_structure.bpList)
                if sigma not in seen:
                    new_structure.str_struct = sigma
                    new_structure.energy = new_nrj
                    new_structures.append(new_structure)
                    new_children.append(new_structure)
                    nb_branch += 1
                    seen.add(sigma)
                if nb_branch >= max_branch:
                    break
            if len(new_children) > 0:
                new_children.sort(key=lambda el: el.energy)
                struct.children = new_children[:max_stack]

        new_structures += structures
        new_structures.sort(key=lambda el: el.energy)
        new_structures = new_structures[:max_stack]

        # reference's iterate-while-removing pruning (skips the element
        # following each removal)
        for struct in structures:
            idx = 0
            lst = struct.children
            while idx < len(lst):
                child = lst[idx]
                if child not in new_structures:
                    lst.remove(child)
                idx += 1

        if [s.str_struct for s in structures] == \
                [s.str_struct for s in new_structures]:
            return structures, root
        structures = new_structures
