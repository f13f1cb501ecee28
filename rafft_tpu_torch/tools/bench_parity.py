"""Reference-style benchmark fan-out on the CPU parity engine
(benchmarks/bench_parity.py's counterpart, on the port's fold_cpu).

A process pool over sequences, as the reference's bench_fft.py, that
folds in process instead of one interpreter per sequence.  Each output
row holds the reference's --bench fields of every saved structure:
`seq,name,struct,nrj,struct,nrj,...`.  The pool's processes start by
forkserver (the caller may hold a CUDA context).  --csv is the reference
benchmark CSV; without it, tools/corpus.py:reference_order() (the truth
column is not read).

    python -m rafft_tpu_torch.tools.bench_parity NPROC [--csv PATH]
        [--limit N] [--max_len N] [-n 100] [-ms 50] [--out fft_rafft_tpu.csv]
"""

from __future__ import annotations

import argparse
import functools
import multiprocessing as mp
import time

from rafft_tpu_torch.parallel.sweep import load_benchmark_csv
from rafft_tpu_torch.tools.corpus import reference_order


def run_one(rec, n_mode=100, max_stack=50, max_branch=1000):
    """(name, rows) of one record: (seq, len, struct, "%6.1f" energy,
    base pairs) for every saved structure."""
    from rafft_tpu_torch.engine.fold_cpu import fold

    seq, _true, name = rec
    structs = fold(seq, nb_mode=n_mode, max_stack=max_stack,
                   max_branch=max_branch)
    return name, [(seq, len(seq), st.str_struct, f"{st.energy:6.1f}",
                   st.str_struct.count("(")) for st in structs]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("nproc", type=int)
    ap.add_argument("--csv", help="the reference benchmark CSV (default: "
                    "tools/corpus.py:reference_order())")
    ap.add_argument("--limit", type=int)
    ap.add_argument("--max_len", type=int)
    ap.add_argument("-n", "--n_mode", type=int, default=100)
    ap.add_argument("-ms", "--max_stack", type=int, default=50)
    ap.add_argument("--max_branch", type=int, default=1000)
    ap.add_argument("--out", default="fft_rafft_tpu.csv")
    args = ap.parse_args(argv)

    records = load_benchmark_csv(args.csv) if args.csv else reference_order()
    if args.max_len:
        records = [r for r in records if len(r[0]) <= args.max_len]
    if args.limit:
        records = records[: args.limit]

    fold_rec = functools.partial(run_one, n_mode=args.n_mode,
                                 max_stack=args.max_stack,
                                 max_branch=args.max_branch)
    t0 = time.time()
    with mp.get_context("forkserver").Pool(args.nproc) as pool:
        results = pool.map(fold_rec, records)
    dt = time.time() - t0

    with open(args.out, "w") as out:
        for name, rows in results:
            flat = []
            for _seq, _ln, db, nrj, _nbp in rows:
                flat += [db, nrj.strip()]
            out.write(",".join([rows[0][0], name] + flat) + "\n")
    print(f"{len(records)} seqs in {dt:.1f}s "
          f"({len(records)/dt:.2f} seq/s with {args.nproc} procs)")


if __name__ == "__main__":
    main()
