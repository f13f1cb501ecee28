"""The plain reference fold: RAFFT's beam search over helix-formation
steps, one sequence at a time, in Python, NumPy and SciPy.

A frozen copy of the port's sequential CPU engine (engine/fold_cpu.py)
with the NumPy energy evaluator, and of the scan helpers it calls
(scan/encode.py, scan/correlate.py, scan/windows.py).  Per step, for
every structure in the beam and every unpaired region:

  (1) rank correlation lags (descending value, descending-lag ties),
  (2) window-slide each of the top nb_mode lags into a candidate stem,
  (3) keep stems that strictly lower the Turner energy, sorted by dE,
  (4) combine candidate stems across the structure's regions (cartesian
      product, capped at max_branch new structures per step, dot-bracket
      dedup across the whole fold),
  (5) pool new structures before old ones, stable-sort by energy,
      truncate to max_stack, stop at the first fixed point.

Energies are exact integers (dekacal/mol) that the search reads as
float32 kcal/mol, as the configurations state.  `precision="bfloat16"`
reads them as bfloat16 instead: the benchmark's control, the nearest
precision below the stated one.
"""

from __future__ import annotations

from itertools import product

import numpy as np
from scipy.signal import convolve

from perfbench.reference.energy import (encode_sequence, eval_structure_int,
                                        get_params)
from perfbench.reference.structs import Structure, dot_bracket, merge_pair_list

# channel order of the one-hot strand: A, G, C, U (codes A=1, C=2, G=3, U=4)
CHANNEL_CODES = np.array([1, 3, 2, 4], dtype=np.int32)


def weight_matrix(gc_wei, au_wei, gu_wei):
    """W[a, b] = correlation weight of bases a, b (0=N, 1=A, 2=C, 3=G, 4=U)."""
    W = np.zeros((5, 5), dtype=np.float64)
    A, C, G, U = 1, 2, 3, 4
    W[A, U] = W[U, A] = au_wei
    W[G, C] = W[C, G] = gc_wei
    W[G, U] = W[U, G] = gu_wei
    return W


def correlate(codes_region, W, pad=1.0):
    """Normalised correlation of one region, float64 [2m - 1] (lag = i + j
    in region-local coordinates): scipy's convolve per channel, with its
    own direct / FFT switch, so tie noise is the reference's."""
    m = codes_region.shape[0]
    fwd = (codes_region[None, :] == CHANNEL_CODES[:, None]).astype(np.float64)
    bwd = W[CHANNEL_CODES[:, None], codes_region[None, ::-1]]
    cor = np.sum(np.array([convolve(fwd[c], bwd[c, ::-1]) for c in range(4)]),
                 axis=0)
    norm = [el + pad for el in list(range(m)) + list(range(m - 1))[::-1]]
    return cor / norm


def top_lags(cor, nb_mode):
    """Stable ascending sort by value, then reversed: descending value,
    ties broken by descending lag."""
    cor_l = [[i, c] for i, c in enumerate(cor)]
    cor_l.sort(key=lambda el: el[1])
    return [int(i) for i, _c in cor_l[::-1][:nb_mode]]


def window_slide(codes_region, pos_list, W, lag, min_hp):
    """(run length, i, j, score) of the best run of consecutive pairs at
    correlation lag `lag`, in region-local indices."""
    m = codes_region.shape[0]
    w = lag + 1 if lag < m else 2 * m - lag - 1
    half = w // 2 + (w % 2)

    def facing(i):
        return (i, lag - i) if lag < m else (lag - m + 1 + i, m - i - 1)

    tot = np.empty(half, dtype=np.float64)
    for i in range(half):
        ip, jp = facing(i)
        tot[i] = W[codes_region[ip], codes_region[jp]]

    max_nb, tmp_max, max_score, max_i, max_j = 0, 0, 0, 0, 0
    for i in range(half):
        ip, jp = facing(i)
        if i > 0 and pos_list[ip] - pos_list[ip - 1] == 1 and \
           pos_list[jp + 1] - pos_list[jp] == 1:
            tot[i] = (tot[i - 1] + tot[i]) * tot[i]
        tmp_max = 0 if tot[i] == 0 else tmp_max + 1
        if tot[i] >= max_score and pos_list[jp] - pos_list[ip] > min_hp:
            max_score = tot[i]
            max_nb = tmp_max
            max_i, max_j = ip, jp
    return max_nb, max_i, max_j, max_score


def _bfloat16(x):
    """x rounded to the nearest bfloat16 (ties to even), as a float."""
    b = np.array([x], np.float32).view(np.uint32).astype(np.uint64)
    b = ((b + 0x7FFF + ((b >> 16) & 1)) >> 16) << 16
    return float(b.astype(np.uint32).view(np.float32)[0])


ROUND = {"float32": lambda x: float(np.float32(x)), "bfloat16": _bfloat16}


class _Oracle:
    """Memoised energy of a pair set on one sequence, in kcal/mol read at
    the given precision."""

    def __init__(self, sequence, temperature, precision):
        self.seq = sequence
        self.params = get_params(temperature)
        self.round = ROUND[precision]
        self._cache = {}

    def __call__(self, pair_list):
        key = frozenset(pair_list)
        e = self._cache.get(key)
        if e is None:
            e = self.round(eval_structure_int(self.seq, list(key),
                                              self.params) / 100.0)
            self._cache[key] = e
        return e


def _candidates(region_pos, struct, codes, W, oracle, nb_mode, min_hp, min_nrj):
    """Candidate stems for one unpaired region, sorted by dE ascending."""
    rcodes = codes[region_pos]
    m = len(region_pos)
    if m < 2:
        return []
    sols = []
    for lag in top_lags(correlate(rcodes, W), nb_mode):
        nb, ip, jp, _score = window_slide(rcodes, region_pos, W, lag, min_hp)
        if nb > 0:
            stem = [(int(region_pos[ip - t]), int(region_pos[jp + t]))
                    for t in range(nb)]
            dnrj = oracle(struct.pair_list + stem) - struct.energy
        else:
            dnrj = min_nrj
        if dnrj < min_nrj:
            sols.append((nb, ip, jp, dnrj, stem))
    sols.sort(key=lambda el: el[3])

    out = []
    for nb, ip, jp, dnrj, stem in sols:
        pairs = stem + list(struct.pair_list)
        inner = region_pos[ip + 1: jp] if jp - ip > 1 else None
        if ip - (nb - 1) > 0 or jp + nb < m:
            outer = np.concatenate((region_pos[: ip - nb + 1],
                                    region_pos[jp + nb:]))
        else:
            outer = None
        out.append((inner, outer, pairs))
    return out


def fold(sequence, nb_mode=100, max_stack=1, max_branch=100, min_hp=3,
         min_nrj=0.0, traj=False, temp=37.0, gc_wei=3.0, au_wei=2.0,
         gu_wei=1.0, precision="float32"):
    """The final beam of Structure (and the trajectory, the beam before
    every step, with traj=True), best first.  The signature is RAFFT's
    `fold`, plus the precision energies are read at."""
    n = len(sequence)
    codes = encode_sequence(sequence)
    W = weight_matrix(gc_wei, au_wei, gu_wei)
    oracle = _Oracle(sequence, temp, precision)

    root = Structure(node_list=[np.arange(n, dtype=np.int64)], pair_list=[])
    root.str_struct = "." * n
    beam = [root]
    trajectory = []
    seen = set()
    while True:
        if traj:
            trajectory.append(beam)
        per_struct = []
        for st in beam:
            regs = [c for c in (_candidates(r, st, codes, W, oracle, nb_mode,
                                            min_hp, min_nrj)
                                for r in st.node_list) if c]
            if regs:
                per_struct.append(regs)

        new_structs = []
        nb_branch = 0
        for regs in per_struct:
            for combo in product(*regs):
                pair_list, node_list = [], []
                for inner, outer, pairs in combo:
                    merge_pair_list(pair_list, pairs)
                    if inner is not None:
                        node_list.append(inner)
                    if outer is not None:
                        node_list.append(outer)
                db = dot_bracket(pair_list, n)
                if db not in seen:
                    st = Structure(node_list=node_list, pair_list=pair_list,
                                   energy=oracle(pair_list), str_struct=db)
                    new_structs.append(st)
                    seen.add(db)
                    nb_branch += 1
                if nb_branch >= max_branch:
                    break

        pool = new_structs + beam
        pool.sort(key=lambda el: el.energy)
        new_beam = pool[:max_stack]
        if [s.str_struct for s in beam] == [s.str_struct for s in new_beam]:
            return (beam, trajectory) if traj else beam
        beam = new_beam
