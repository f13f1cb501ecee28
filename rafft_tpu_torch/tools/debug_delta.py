"""Hold the fold engine's incremental candidate dE to the exact integer
oracle, for one parent structure (tools/debug_delta.py's counterpart, on
the port's FoldEngine).

    python -m rafft_tpu_torch.tools.debug_delta SEQ PARENT_DB [--device cuda]

The engine runs the first stages of one step (FoldEngine.candidates:
loop analysis, regions, the wavefront tables, the top lags and
_candidate_delta) on the parent at N = 1 << max(5, ceil(log2 n)), K=1,
R=16, V=64, S=256; every candidate stem (a lag with a run) becomes its
pair table by _combo_pt, and its dE is compared with
eval_structure_int(seq, candidate) - eval_structure_int(seq, parent).
Unsupported candidates (a stem across an excised gap, or a loop of more
than 48 children) have no incremental dE: the engine evaluates them in
full, and their `eng` is 0.

Where the JAX tool differs, on purpose: M is min(nb_mode, 2N - 1), as
fold_one takes it, since the engine refuses more lags than an N-long
region has (the JAX tool fails on sequences of at most 32 nt at
nb_mode 100); and the JAX tool's _window_scan is the TPU-side function
the port leaves out: the tables come from the wavefront kernel (its
plain version on the CPU), gathered at the lags.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from rafft_tpu_torch.energy.eval_np import eval_structure_int
from rafft_tpu_torch.energy.eval_torch import analyze_pt
from rafft_tpu_torch.engine.fold_torch import (EngineConfig, FoldEngine,
                                               _combo_pt)
from rafft_tpu_torch.struct import dot_bracket, pair_table


def region_order(pt0, enclose, n, R):
    """The parent's region slots, by the JAX tool's rule (a hand-built
    parent has no engine-given order): the loops that hold unpaired
    positions, in the order a left-to-right scan meets them (-1 is the
    exterior loop), then -2 for the empty slots."""
    labs = []
    for x in range(n):
        if pt0[x] == -1 and int(enclose[x]) not in labs:
            labs.append(int(enclose[x]))
    ror = np.full(R, -2, np.int32)
    ror[:len(labs)] = labs
    return ror


def candidates_for(seq, parent_db, nb_mode=100, K=1, device="cuda"):
    """One row per candidate stem of the parent: r, m (region slot and
    lag rank), run, db (the candidate), true (oracle dE), eng (the
    engine's dE), unsup, ok (true == eng)."""
    n = len(seq)
    N = 1 << max(5, int(np.ceil(np.log2(max(8, n)))))
    cfg = EngineConfig(N=N, K=K, M=min(nb_mode, 2 * N - 1), R=16, V=64,
                       S=256)
    eng = FoldEngine(cfg, B=1, device=device)
    dev = eng.device
    pt0 = pair_table(parent_db)
    e_parent = eval_structure_int(seq, parent_db)
    st = eng.init_state([seq])
    ptv = np.full(N, -1, np.int32)
    ptv[:n] = pt0
    st["pt"] = torch.as_tensor(np.broadcast_to(ptv, (1, K, N)).copy(),
                               device=dev)
    st["energy"] = torch.full((1, K), e_parent, dtype=torch.int32, device=dev)
    st["active"] = torch.ones((1, K), dtype=torch.bool, device=dev)
    enclose = analyze_pt(eng.dp, st["codes"][0], st["pt"][0, 0],
                         st["n"][0])["enclose"].cpu().numpy()
    ror = np.broadcast_to(region_order(pt0, enclose, n, cfg.R), (1, K, cfg.R))
    st["rorder"] = torch.as_tensor(ror.copy(), device=dev)

    c = eng.candidates(st)
    ws = c["ws"]
    lag_ok = c["lag_ok"][0, 0].cpu().numpy()
    run = ws["max_nb"][0, 0].cpu().numpy()
    picks = [(r, m) for r in range(cfg.R) for m in range(cfg.M)
             if lag_ok[r, m] and run[r, m] != 0]
    if not picks:
        return []
    # every candidate's pair table at once: X combinations of beam row 0,
    # each choosing one stem in one region
    rr, mm = (torch.as_tensor(v, device=dev) for v in zip(*picks))
    sel = torch.arange(cfg.R, device=dev) == rr[:, None]
    chosen = lambda f: torch.where(sel, f[0, 0, rr, mm][:, None], 0)[None]
    cand = _combo_pt(cfg, st["pt"], c["rloc"], c["rslot"], c["rpos"],
                     torch.zeros((1, len(picks)), dtype=torch.long, device=dev),
                     chosen(ws["max_i"]), chosen(ws["max_j"]),
                     chosen(ws["max_nb"]), sel[None])[0].cpu().numpy()
    delta = c["delta"][0, 0].cpu().numpy()
    unsup = c["cplx"][0, 0].cpu().numpy()
    out = []
    for x, (r, m) in enumerate(picks):
        pairs = [(i, int(cand[x, i])) for i in range(n) if cand[x, i] > i]
        db = dot_bracket(pairs, n)
        true_d = eval_structure_int(seq, db) - e_parent
        eng_d = int(delta[r, m])
        out.append(dict(r=r, m=m, run=int(run[r, m]), db=db, true=true_d,
                        eng=eng_d, unsup=bool(unsup[r, m]),
                        ok=true_d == eng_d))
    return out


def summary(rows):
    """The JAX tool's printout of candidates_for's rows, as lines."""
    bad = [r for r in rows if not r["ok"] and not r["unsup"]]
    out = [f"{len(rows)} candidates, {len(bad)} wrong fast-path deltas, "
           f"{sum(r['unsup'] for r in rows)} unsupported"]
    for r in bad[:10]:
        out.append(f"r={r['r']} m={r['m']} run={r['run']} true={r['true']} "
                   f"eng={r['eng']}")
        out.append(f"    {r['db']}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("seq")
    ap.add_argument("parent")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print("\n".join(summary(candidates_for(args.seq, args.parent,
                                           device=args.device))))


if __name__ == "__main__":
    main()
