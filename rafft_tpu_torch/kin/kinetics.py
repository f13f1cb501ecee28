"""Kinetic master equation over the fast-folding graph (parity engine).

The port's own copy of rafft_tpu/kin/kinetics.py, host numpy/scipy as
there.  Semantics mirrored from the reference (its rafft/rafft_kin.py):
  - structures deduplicated across steps in first-seen order (94-115);
  - connectivity: structure S at step i is connected to every structure P
    of step i-1 whose pair set is a subset of S's (48-56); step 0 wraps
    to the *last* step via negative indexing (75) — a quirk kept
    deliberately for output parity;
  - Metropolis rates at KT=0.61 kcal/mol, diagonal = -row sum, stored in
    extended precision (68-91);
  - dp/dt = M^T p solved by dense eigendecomposition; populations taken
    at log-spaced times exp(st*max_time/n_steps - 4), renormalised each
    step (131-141).
"""

from __future__ import annotations

import numpy as np
from scipy.linalg import eig, inv

from rafft_tpu_torch.struct import paired_positions

KT = 0.61


def _pair_ids(db, _cache={}):
    """A structure's base pairs as a flat sorted id array (i*len+j).

    Cached per dot-bracket string: the same structures recur across
    beams, and array containment tests below want ndarray inputs."""
    ids = _cache.get(db)
    if ids is None:
        n = len(db)
        ids = np.sort(np.array([i * n + j for i, j in paired_positions(db)],
                               dtype=np.int64))
        _cache[db] = ids
    return ids


def ancestors_in(beam, target):
    """Indices of `beam` members whose pair sets are contained in
    `target`'s pairs.

    The fast-folding graph only ever *adds* stems from one beam to the
    next, so structure P can precede S iff pairs(P) ⊆ pairs(S) — the
    connectivity rule of the reference graph (rafft_kin.py:48-56)."""
    want = _pair_ids(target.str_struct)
    return [bi for bi, cand in enumerate(beam)
            if np.isin(_pair_ids(cand.str_struct), want).all()]


def get_transition_mat(fast_paths, nb_struct, struct_map):
    """Metropolis rate matrix over the fast-folding graph.

    Edges connect each beam to the one before it; beam 0 wraps around to
    the final beam via Python negative indexing — a reference quirk kept
    deliberately for output parity (rafft_kin.py:75).  Off-diagonal
    rates are min(1, e^{∓ΔE/KT}); each diagonal entry balances its row
    so columns of the generator integrate to conserved probability."""
    rates = np.zeros((nb_struct, nb_struct), dtype=np.longdouble)
    for step_idx in range(len(fast_paths)):
        parents = fast_paths[step_idx - 1]
        for cur in fast_paths[step_idx]:
            dst, e_dst = struct_map[cur.str_struct]
            for bi in ancestors_in(parents, cur):
                src, e_src = struct_map[parents[bi].str_struct]
                if src == dst:
                    continue
                de = e_dst - e_src
                rates[src, dst] = min(1.0, np.exp(-de / KT))
                rates[dst, src] = min(1.0, np.exp(de / KT))
    diag = np.diag_indices(nb_struct)
    rates[diag] = 0.0
    rates[diag] = -rates.sum(axis=1)
    return rates


def _propagate_eig(transition_mat, init_pop, times):
    """Reference propagation path: dense nonsymmetric eigendecomposition.

    Exactly the reference's computation (rafft_kin.py:131-141).  NOTE:
    for very large max_time the result is dominated by eigensolver noise
    (near-zero eigenvalues scaled by t ~ e^35) and is therefore
    LAPACK-build specific — see _propagate_expm for the stable method
    (cross-validated against 40-digit arithmetic)."""
    V, W = eig(transition_mat.T, check_finite=True)
    iW = inv(W)
    out = []
    for t in times:
        tmp = W @ np.diag(np.exp(V * t)) @ (iW @ init_pop)
        out.append(tmp.real / tmp.real.sum())
    return out


def _propagate_expm(transition_mat, init_pop, times):
    """Numerically stable propagation: scaling-and-squaring of the
    transition semigroup.  E(t) = E(t/2)^2 with per-square column
    renormalisation keeps probability mass exact at any horizon."""
    from scipy.linalg import expm

    Q = np.asarray(transition_mat.T, dtype=np.float64)
    p0 = np.asarray(init_pop, dtype=np.float64)
    nrm = np.abs(Q).max()
    out = []
    for t in times:
        if t <= 0:
            out.append(p0.copy())
            continue
        k = max(0, int(np.ceil(np.log2(max(nrm * t, 1e-300)))))
        E = expm(Q * (t / (1 << k)))
        for _ in range(k):
            E = E @ E
            # renormalise columns: each column of expm(Qt) sums to 1
            E /= E.sum(axis=0, keepdims=True)
        p = E @ p0
        p = np.maximum(p, 0.0)
        out.append(p / p.sum())
    return out


def kinetics(fast_paths, max_time, n_steps, initial_pop=None, method="eig"):
    """Solve the master equation over the fast-folding graph.

    method: "eig" (reference-parity eigendecomposition) or "expm"
    (stable squaring propagator, correct at any time horizon).

    Returns (trajectory, times, struct_list, str_equi_pop) with
    str_equi_pop = [(dot_bracket, energy, final_population, id), ...].
    """
    seen = set()
    struct_list = []
    for step in fast_paths:
        for struct in step:
            if struct.str_struct not in seen:
                seen.add(struct.str_struct)
                struct_list.append(struct)

    struct_map = {s.str_struct: (si, s.energy) for si, s in enumerate(struct_list)}
    nb_struct = len(struct_list)
    transition_mat = get_transition_mat(fast_paths, nb_struct, struct_map)

    if initial_pop is None:
        init_pop = np.array([1.0] + [0.0] * (nb_struct - 1), dtype=np.longdouble)
    else:
        init_pop = np.zeros(nb_struct, dtype=np.longdouble)
        for p, w in initial_pop:
            init_pop[p] = w

    trajectory = [init_pop.copy()]

    time_step = max_time / n_steps
    times = [np.exp(-4)]
    step_times = []
    for st in range(n_steps):
        time = np.exp(time_step * st - 4)
        times.append(time)
        step_times.append(time)

    prop = _propagate_eig if method == "eig" else _propagate_expm
    trajectory.extend(prop(transition_mat, init_pop, step_times))

    equi_pop = trajectory[-1]
    str_equi_pop = [
        (s.str_struct, s.energy, ep, struct_map[s.str_struct][0])
        for s, ep in zip(struct_list, equi_pop.real)
    ]
    return trajectory, times, struct_list, str_equi_pop
