"""Sequential fold engine — the reference-parity oracle.

Reimplements the reference's beam BFS over helix-formation steps
(the reference's rafft/rafft.py:112-239) from its observable behaviour:

  per step, for every structure in the beam and every unpaired region,
  (1) rank correlation lags (descending value, descending-lag ties),
  (2) window-slide each of the top nb_mode lags into a candidate stem,
  (3) keep stems that strictly lower the Turner energy, sorted by dE,
  (4) combine candidate stems across independent regions (cartesian
      product, capped at max_branch *new* structures per step, global
      dot-bracket dedup across the whole fold),
  (5) pool new structures before old ones, stable-sort by energy,
      truncate to max_stack, stop at the first fixed point.

Numeric parity notes:
  - energies go through float32 like the reference's C-float oracle
    (sort ties / printed values agree bit-for-bit);
  - correlation uses scipy.signal.convolve (same auto FFT/direct switch,
    so tie noise matches);
  - the max_branch cap is checked *after* each accepted combination and
    only breaks the per-structure product loop, exactly like the
    reference's loop structure.

The energy oracle is this package's integer Turner-2004 evaluator — the
reference's in-process ViennaRNA call (rafft/utils.py:135-138) replaced
by rafft_tpu_torch.energy.  The port's own copy of
rafft_tpu/engine/fold_cpu.py: the reference semantics the card's folds
are held to.
"""

from __future__ import annotations

from itertools import product

import numpy as np

from rafft_tpu_torch.energy.eval_np import eval_structure_int
from rafft_tpu_torch.energy.params import get_params, encode_sequence
from rafft_tpu_torch.scan.encode import weight_matrix
from rafft_tpu_torch.scan.correlate import correlate_np, top_lags
from rafft_tpu_torch.scan.windows import window_slide_np
from rafft_tpu_torch.struct import Structure, dot_bracket, merge_pair_list

# which energy evaluator the last fold of this process ran: "native"
# (native/turner_eval.cpp) or "numpy" (energy/eval_np.py, where no C++
# compiler is found); None before the first fold
EVALUATOR = None


def _native_oracle(temperature: float):
    """The native evaluator, or None where it cannot be built."""
    from rafft_tpu_torch.native import native_oracle

    try:
        return native_oracle(temperature)
    except RuntimeError:      # no compiler, or the build failed
        return None


class _Oracle:
    """Memoised full-structure energy evaluation for one sequence.

    Uses the native C++ evaluator when it builds (bit-identical tables,
    far faster than the numpy path), else eval_np; EVALUATOR says which."""

    def __init__(self, sequence: str, temperature: float):
        self.seq = sequence
        self.params = get_params(temperature)
        self.n = len(sequence)
        self._cache: dict[frozenset, float] = {}
        # memoisation is a pure speed cache; bound it so long sequences
        # cannot blow up the host (a 2.9-knt K=200 fold once reached
        # ~60 GB of frozenset keys) — entries scale ~n, so budget ~n^-1
        self._cache_cap = max(20_000, 50_000_000 // max(self.n, 1))
        global EVALUATOR
        self._native = _native_oracle(temperature)
        EVALUATOR = "native" if self._native is not None else "numpy"
        self._codes8 = encode_sequence(sequence).astype(np.int8)

    def __call__(self, pair_list) -> float:
        key = frozenset(pair_list)
        e = self._cache.get(key)
        if e is None:
            if self._native is not None:
                pt = np.full(self.n, -1, np.int32)
                for pi, pj in key:
                    pt[pi] = pj
                    pt[pj] = pi
                e_int = self._native(self._codes8, pt)
            else:
                e_int = eval_structure_int(self.seq, list(key), self.params)
            e = float(np.float32(e_int / 100.0))
            if len(self._cache) >= self._cache_cap:
                self._cache.clear()
            self._cache[key] = e
        return e


def _candidates(region_pos, struct, codes, W, oracle, nb_mode, min_hp, min_nrj):
    """Candidate stems for one unpaired region, sorted by dE ascending."""
    rcodes = codes[region_pos]
    m = len(region_pos)
    if m < 2:
        return []
    cor = correlate_np(rcodes, W)
    sols = []
    for lag, _c in top_lags(cor, nb_mode):
        nb, ip, jp, score = window_slide_np(rcodes, region_pos, W, lag, min_hp)
        if nb > 0:
            stem = [(int(region_pos[ip - t]), int(region_pos[jp + t])) for t in range(nb)]
            dnrj = oracle(struct.pair_list + stem) - struct.energy
        else:
            dnrj = min_nrj
        if dnrj < min_nrj:
            sols.append((nb, score, ip, jp, dnrj, stem))
    sols.sort(key=lambda el: el[4])

    out = []
    for nb, score, ip, jp, dnrj, stem in sols:
        total = dnrj + struct.energy
        pairs = stem + list(struct.pair_list)
        inner = region_pos[ip + 1 : jp] if jp - ip > 1 else None
        if ip - (nb - 1) > 0 or jp + nb < m:
            outer = np.concatenate((region_pos[: ip - nb + 1], region_pos[jp + nb :]))
        else:
            outer = None
        out.append((inner, outer, pairs, total))
    return out


def fold(sequence, nb_mode=100, max_stack=1, max_branch=100, min_hp=3,
         min_nrj=0.0, traj=False, temp=37.0, gc_wei=3.0, au_wei=2.0,
         gu_wei=1.0):
    """Fold a sequence; returns the final beam (and the per-step
    trajectory when traj=True).  Signature mirrors the reference API
    (the reference's rafft/rafft.py:219-227)."""
    n = len(sequence)
    codes = encode_sequence(sequence)
    W = weight_matrix(gc_wei, au_wei, gu_wei)
    oracle = _Oracle(sequence, temp)

    root = Structure(node_list=[np.arange(n, dtype=np.int64)], pair_list=[])
    root.str_struct = "." * n

    beam = [root]
    trajectory = []
    seen: set[str] = set()

    while True:
        if traj:
            trajectory.append(beam)

        per_struct = []
        for st in beam:
            regs = []
            for region_pos in st.node_list:
                cands = _candidates(region_pos, st, codes, W, oracle,
                                    nb_mode, min_hp, min_nrj)
                if cands:
                    regs.append(cands)
            if regs:
                per_struct.append(regs)

        new_structs = []
        nb_branch = 0
        for regs in per_struct:
            for combo in product(*regs):
                pair_list: list = []
                node_list: list = []
                for inner, outer, pairs, _total in combo:
                    merge_pair_list(pair_list, pairs)
                    if inner is not None:
                        node_list.append(inner)
                    if outer is not None:
                        node_list.append(outer)
                db = dot_bracket(pair_list, n)
                if db not in seen:
                    st = Structure(node_list=node_list, pair_list=pair_list)
                    st.energy = oracle(pair_list)
                    st.str_struct = db
                    new_structs.append(st)
                    seen.add(db)
                    nb_branch += 1
                if nb_branch >= max_branch:
                    break

        pool = new_structs + beam
        pool.sort(key=lambda el: el.energy)
        new_beam = pool[:max_stack]

        if [s.str_struct for s in beam] == [s.str_struct for s in new_beam]:
            if traj:
                return beam, trajectory
            return beam
        beam = new_beam
