"""Find the first fold step where the batched engine's beam leaves the
sequential CPU parity engine's trajectory (tools/debug_seq.py's
counterpart, on the port's FoldEngine).

    python -m rafft_tpu_torch.tools.debug_seq [IDX] [--seq SEQ] [--csv PATH]
        [--device cuda]

The sequence is row IDX (default 7) of the sequences of at most 120 nt,
in the order of --csv (the reference benchmark CSV) or, without it, of
tools/corpus.py:reference_order(); or --seq.  fold_cpu gives the
trajectory at -n 100 -ms 50 --max_branch 1000; FoldEngine steps the
sequence at the bench configuration (CONFIG), B=1, and its beam before
each step is compared with the trajectory's.  Where the engine is done
before the trajectory, its final beam is also compared with fold_cpu's
final beam (the JAX tool stops at the last stepped beam).  Prints the
first diverging step, the first differing beam entries, the structures
missing and extra, then enum_suspect and cplx_dropped; or "no divergence
in stepped beams".
"""

from __future__ import annotations

import argparse
from typing import NamedTuple

from rafft_tpu_torch.engine import fold_cpu
from rafft_tpu_torch.engine.fold_torch import EngineConfig, FoldEngine
from rafft_tpu_torch.parallel.sweep import load_benchmark_csv
from rafft_tpu_torch.tools.corpus import reference_order, short_rows

CONFIG = EngineConfig(N=128, K=50, R=16, M=100, V=4096, S=16384,
                      max_branch=1000)
CPU_ARGS = dict(nb_mode=100, max_stack=50, max_branch=1000)


class Divergence(NamedTuple):
    step: int | None      # the first step whose beam differs, or None
    got: list             # the engine's beam there (the final beam if None)
    want: list            # the trajectory's beam there
    state: dict           # the engine's state there
    steps: int            # the steps the engine ran


def cpu_trajectory(seq, nb_mode=100, max_stack=50, max_branch=1000):
    """fold_cpu's beam before each step, then its final beam, as lists
    of (dot-bracket, energy)."""
    res, traj = fold_cpu.fold(seq, nb_mode=nb_mode, max_stack=max_stack,
                              max_branch=max_branch, traj=True)
    rows = lambda beam: [(s.str_struct, s.energy) for s in beam]
    return [rows(step) for step in traj] + [rows(res)]


def first_divergence(eng, seq, want) -> Divergence:
    """Step `eng` (B=1) on `seq` and compare its beam before each step
    with want[step] (want[-1] past the trajectory's end), then its final
    beam with want[-1]."""
    state = eng.init_state([seq])
    step = 0
    for step in range(eng.cfg.max_steps):
        if bool(state["done"].all()):
            break
        beams = eng._beams(state, 1)[0]
        w = want[step] if step < len(want) else want[-1]
        if beams != w:
            return Divergence(step, beams, w, state, step)
        state = eng.step(state)
    else:
        step = eng.cfg.max_steps
    beams = eng._beams(state, 1)[0]
    if beams != want[-1]:
        return Divergence(step, beams, want[-1], state, step)
    return Divergence(None, beams, want[-1], state, step)


def report(d: Divergence):
    """The JAX tool's printout of a Divergence, as lines."""
    out = []
    if d.step is None:
        out.append("no divergence in stepped beams")
    else:
        out.append(f"DIVERGED at step {d.step}: engine {len(d.got)} cpu "
                   f"{len(d.want)}")
        for i, (g, w) in enumerate(zip(d.got, d.want)):
            if g != w:
                out += [f"  k={i}", f"   got  {g}", f"   want {w}"]
                if i > 6:
                    break
        sw, sg = set(d.want), set(d.got)
        out.append(f"  missing from engine: {[x for x in d.want if x not in sg][:4]}")
        out.append(f"  extra in engine    : {[x for x in d.got if x not in sw][:4]}")
    out.append(f"suspect: {d.state['enum_suspect'].cpu().numpy()} "
               f"cplx_dropped: {d.state['cplx_dropped'].cpu().numpy()}")
    return out


def pick_sequence(idx=7, seq=None, csv_path=None):
    if seq is not None:
        return seq
    records = load_benchmark_csv(csv_path) if csv_path else reference_order()
    return short_rows(records)[idx]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("idx", nargs="?", type=int, default=7)
    ap.add_argument("--seq")
    ap.add_argument("--csv", help="the reference benchmark CSV (default: "
                    "tools/corpus.py:reference_order())")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    seq = pick_sequence(args.idx, args.seq, args.csv)
    print("len", len(seq))
    want = cpu_trajectory(seq, **CPU_ARGS)
    d = first_divergence(FoldEngine(CONFIG, B=1, device=args.device), seq,
                         want)
    print("\n".join(report(d)))


if __name__ == "__main__":
    main()
