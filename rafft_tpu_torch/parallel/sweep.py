"""Length-bucketed corpus sweep on one card (rafft_tpu/parallel/sweep.py).

Sequences are bucketed by padded length and folded bucket by bucket with
the PyTorch FoldEngine at the JAX sweep's per-bucket configuration.
Folds that the engine flags as possibly inexact are refolded on the
sequential CPU parity engine in a forkserver pool (a CUDA context does
not survive fork).  The outputs keep the JAX sweep's schemas: result
dicts and the results CSV, the bucket checkpoint journal (`_idx`,
`_bucket`), the beams journal ({name, seq, flagged, beam}), the run
manifest and the flag histogram.

Buckets 128 to 1024 are ported.  Longer ones (2048, 4096), and records
that only they would hold (1025 to 4096 nt), raise NotImplementedError:
ROADMAP.md queues them.

CLI:
  python -m rafft_tpu_torch.parallel.sweep --csv <benchmark.csv> \
      --out results.csv [--device cuda] [-n 100 -ms 50] [--limit 200]
"""

from __future__ import annotations

import argparse
import csv
import json
import multiprocessing as mp
import os
import time

import numpy as np

from rafft_tpu_torch.engine.fold_torch import MAX_N, EngineConfig, FoldEngine
from rafft_tpu_torch.scoring import best_of, score_structures

# the buckets of rafft_tpu/parallel/sweep.py (no 64 bucket there either)
JAX_BUCKETS = (128, 256, 512, 1024, 2048, 4096)
DEFAULT_BUCKETS = tuple(b for b in JAX_BUCKETS if b <= MAX_N)

# engine exactness-flag bits -> cause names (fold_torch.FLAG_*)
FLAG_NAMES = {1: "v_window", 2: "r_slots", 4: "seen_set", 8: "hash_check",
              16: "cplx_budget", 32: "step_limit"}


def _cpu_refold(task):
    """Pool worker: re-fold one flagged sequence on the sequential CPU
    parity engine (bit-exact reference semantics).  Imports the port's
    fold_cpu only, so a child holds no CUDA state.  Returns the task's
    index, the beam and the energy evaluator that ran."""
    i, seq, nb_mode, max_stack, max_branch = task
    from rafft_tpu_torch.engine import fold_cpu
    structs = fold_cpu.fold(seq, nb_mode=nb_mode, max_stack=max_stack,
                            max_branch=max_branch)
    return (i, [(s.str_struct, s.energy) for s in structs],
            fold_cpu.EVALUATOR)


def load_benchmark_csv(path):
    """Rows of (seq, true_struct, name)."""
    out = []
    with open(path) as fh:
        for row in csv.reader(fh):
            if len(row) >= 3:
                out.append((row[0], row[1], row[2]))
    return out


def bucket_of(n, buckets):
    for b in buckets:
        if n <= b:
            return b
    return None


def bucket_batch(batch, N):
    """Per-bucket batch size: the engine's working set grows about
    linearly in N, so long buckets shrink the batch."""
    return max(1, batch * 256 // max(N, 256))


def bucket_config(N, nb_mode, max_stack, max_branch) -> EngineConfig:
    """The JAX sweep's engine configuration for bucket N
    (rafft_tpu/parallel/sweep.py:167-186)."""
    if N > MAX_N:
        raise NotImplementedError(
            f"bucket N={N}: rafft_tpu_torch folds buckets up to "
            f"{MAX_N}; the 2048/4096 buckets are queued in ROADMAP.md")
    return EngineConfig(N=N, K=max_stack, M=min(nb_mode, 2 * N - 1),
                        R=16 if N <= 512 else 32, max_branch=max_branch,
                        V=4096, W=8 if N <= 128 else 24,
                        CPLX=512 if N <= 128 else 1024,
                        S=max(16384, 32 * max_stack))


def _result(record, rows, best_of_k):
    """The result dict of one fold: the best-energy structure and the
    best-PPV one among the saved beam (sweep.py:132-150)."""
    seq, true_db, name = record
    db, e = rows[0]
    ppv, sens = score_structures(db, true_db)
    ppv_bk, sens_bk, db_bk = best_of([d for d, _ in rows], true_db)
    emap = dict(rows)
    e_bk = emap.get(db_bk, 0.0)
    if db_bk not in emap:            # best_of's all-dots default
        db_bk, ppv_bk, sens_bk = db, ppv, sens
        e_bk = e
    out = dict(seq=seq, len_seq=len(seq), struct=db, nrj=float(np.float32(e)),
               nbp=db.count("("), pvv=ppv, sens=sens, struct_bk=db_bk,
               nrj_bk=float(np.float32(e_bk)), pvv_bk=ppv_bk,
               sens_bk=sens_bk, name=name)
    if best_of_k:
        out.update(struct=db_bk, nrj=float(np.float32(e_bk)),
                   nbp=db_bk.count("("), pvv=ppv_bk, sens=sens_bk)
    return out


def sweep(records, nb_mode=100, max_stack=50, max_branch=1000,
          buckets=DEFAULT_BUCKETS, batch=16, best_of_k=False, progress=None,
          checkpoint=None, save_beams=None, stats=None, workers=None, *,
          device="cuda"):
    """Fold every record on `device`; returns result dicts in input order.

    The arguments and outputs are those of rafft_tpu.parallel.sweep.sweep
    (without its mesh and engine choice): save_beams appends one jsonl row
    per folded sequence, checkpoint journals finished buckets and skips
    them on restart, stats receives per-bucket timings, the fallback count,
    the flag histogram and, where folds were refolded on the CPU, the
    energy evaluator the refold ran (`refold_evaluator`).  Records longer
    than the largest bucket are skipped, except those of MAX_N+1 to 4096 nt: the JAX sweep folds them
    in its 2048/4096 buckets, so they raise NotImplementedError."""
    for N in buckets:
        bucket_config(N, nb_mode, max_stack, max_branch)   # refuses N > MAX_N
    workers = workers or max(1, mp.cpu_count())

    by_bucket: dict[int, list[int]] = {}
    for i, (seq, _t, _n) in enumerate(records):
        b = bucket_of(len(seq), buckets)
        if b is None and MAX_N < len(seq) <= max(JAX_BUCKETS):
            raise NotImplementedError(
                f"record {i} ({len(seq)} nt): rafft_tpu_torch folds "
                f"sequences of up to {MAX_N} nt; the 2048/4096 buckets are "
                f"queued in ROADMAP.md")
        if b is not None:
            by_bucket.setdefault(b, []).append(i)

    results = [None] * len(records)
    n_fallback = 0
    flag_hist: dict[str, int] = {}
    evaluators: set[str] = set()
    done_buckets = set()
    if checkpoint and os.path.exists(checkpoint):
        with open(checkpoint) as fh:
            for line in fh:
                row = json.loads(line)
                results[row.pop("_idx")] = row
                done_buckets.add(row.pop("_bucket"))

    for N, idxs in sorted(by_bucket.items()):
        if N in done_buckets:
            continue
        t_bucket = time.time()
        beam_fh = open(save_beams, "a") if save_beams else None

        def finish(i, rows, flagged):
            seq = records[i][0]
            if not rows:
                rows = [("." * len(seq), 0.0)]
            if beam_fh is not None:
                beam_fh.write(json.dumps(dict(
                    name=records[i][2], seq=seq, flagged=int(flagged),
                    beam=[[d, float(np.float32(ee))] for d, ee in rows]))
                    + "\n")
            results[i] = _result(records[i], rows, best_of_k)

        n_done = 0
        flag_of: dict[int, int] = {}
        pending = []
        eng = FoldEngine(bucket_config(N, nb_mode, max_stack, max_branch),
                         B=bucket_batch(batch, N), device=device)
        for local_i, rows, flagged in eng.run_stream(
                [records[i][0] for i in idxs]):
            i = idxs[local_i]
            if flagged:
                # the exactness escape hatch: the CPU parity engine
                # refolds what the engine could not guarantee
                n_fallback += 1
                for bit, cause in FLAG_NAMES.items():
                    if flagged & bit:
                        flag_hist[cause] = flag_hist.get(cause, 0) + 1
                flag_of[i] = flagged
                pending.append((i, records[i][0], nb_mode, max_stack,
                                max_branch))
            else:
                finish(i, rows, 0)
            n_done += 1
            if progress:
                progress(N, n_done, len(idxs))
        if pending:
            # forkserver children start from a fresh interpreter: no CUDA
            # context is inherited
            ctx = mp.get_context("forkserver")
            with ctx.Pool(min(len(pending), workers)) as pool:
                for i, rows, evaluator in pool.imap_unordered(
                        _cpu_refold, pending):
                    evaluators.add(evaluator)
                    finish(i, rows, flag_of[i])
        if beam_fh is not None:
            beam_fh.close()
        if checkpoint:
            with open(checkpoint, "a") as fh:
                for i in idxs:
                    if results[i] is not None:
                        row = dict(results[i], _idx=i, _bucket=N)
                        fh.write(json.dumps(row) + "\n")
        if stats is not None:
            stats.setdefault("buckets", {})[str(N)] = dict(
                n=len(idxs), secs=round(time.time() - t_bucket, 1),
                batch=bucket_batch(batch, N))
        if progress:
            progress(N, len(idxs), len(idxs),
                     done=True, secs=time.time() - t_bucket)
    if n_fallback:
        print(f"[sweep] {n_fallback} sequences re-folded on the CPU "
              f"parity engine (enumeration/budget flags: {flag_hist})",
              flush=True)
    if stats is not None:
        stats["n_fallback"] = n_fallback
        stats["flag_causes"] = flag_hist
        if evaluators:
            stats["refold_evaluator"] = "+".join(sorted(evaluators))
    return results


def write_results_csv(results, path, selection="best_nrj"):
    """The reference's result-CSV schema.

    selection: 'best_nrj' = lowest-energy structure, 'best_of_k' =
    best-PPV among the saved beam."""
    with open(path, "w") as fh:
        fh.write("seq,len_seq,struct,nrj,nbp,pvv,sens,name\n")
        for r in results:
            if r is None:
                continue
            if selection == "best_of_k" and "struct_bk" in r:
                r = dict(r, struct=r["struct_bk"], nrj=r["nrj_bk"],
                         nbp=r["struct_bk"].count("("),
                         pvv=r["pvv_bk"], sens=r["sens_bk"])
            fh.write("{seq},{len_seq},{struct},{nrj},{nbp},{pvv},{sens},{name}\n"
                     .format(**r))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--csv", required=True, help="benchmark csv (seq,true,name)")
    ap.add_argument("--out", required=True, help="output results csv")
    ap.add_argument("--device", default="cuda",
                    help="torch device to fold on (default cuda; cuda:1, "
                         "cpu)")
    ap.add_argument("-n", "--n_mode", type=int, default=100)
    ap.add_argument("-ms", "--max_stack", type=int, default=50)
    ap.add_argument("--max_branch", type=int, default=1000)
    ap.add_argument("--limit", type=int, help="only first N records")
    ap.add_argument("--max_len", type=int, help="skip longer sequences")
    ap.add_argument("--min_len", type=int, help="skip shorter sequences")
    ap.add_argument("--buckets", default=",".join(map(str, DEFAULT_BUCKETS)))
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--best_of_k", action="store_true")
    ap.add_argument("--out_bk", help="also write the best-of-k selection CSV")
    ap.add_argument("--checkpoint", help="bucket-resume journal path")
    ap.add_argument("--fallback-workers", dest="workers", type=int,
                    help="CPU-parity refold pool size (default: all cores)")
    ap.add_argument("--save-beams", dest="save_beams",
                    help="jsonl path: full saved beam per sequence, for "
                         "offline best-of-k re-scoring")
    args = ap.parse_args(argv)

    records = load_benchmark_csv(args.csv)
    if args.max_len:
        records = [r for r in records if len(r[0]) <= args.max_len]
    if args.min_len:
        records = [r for r in records if len(r[0]) >= args.min_len]
    if args.limit:
        records = records[: args.limit]

    def progress(N, done_n, total, done=False, secs=None):
        if done:
            print(f"[bucket {N}] {total} seqs in {secs:.1f}s "
                  f"({total/max(secs,1e-9):.2f} seq/s)", flush=True)

    t0 = time.time()
    stats = {}
    results = sweep(records, nb_mode=args.n_mode, max_stack=args.max_stack,
                    max_branch=args.max_branch,
                    buckets=tuple(int(x) for x in args.buckets.split(",")),
                    batch=args.batch, best_of_k=args.best_of_k,
                    progress=progress, checkpoint=args.checkpoint,
                    save_beams=args.save_beams, stats=stats,
                    workers=args.workers, device=args.device)
    dt = time.time() - t0
    manifest = dict(argv=vars(args), n_records=len(records),
                    elapsed_s=round(dt, 1), **stats)
    with open(f"{args.out}.manifest.json", "w") as fh:
        json.dump(manifest, fh, indent=1, sort_keys=True)
        fh.write("\n")
    write_results_csv(results, args.out,
                      "best_of_k" if args.best_of_k else "best_nrj")
    if args.out_bk:
        write_results_csv(results, args.out_bk, "best_of_k")
    ok = [r for r in results if r]
    mean_ppv = np.mean([r["pvv"] for r in ok]) if ok else 0.0
    mean_sens = np.mean([r["sens"] for r in ok]) if ok else 0.0
    print(f"{len(ok)} sequences in {dt:.1f}s ({len(ok)/max(dt,1e-9):.2f} "
          f"seq/s); mean PPV {mean_ppv:.2f} mean sens {mean_sens:.2f}")


if __name__ == "__main__":
    main()
