"""MFE baseline sweep of the port (counterpart of benchmarks/bench_mfe.py).

Folds every record to its MFE structure and writes the reference's
result-CSV schema `seq,len_seq,struct,nrj,nbp,pvv,sens,name` (scored
with the built-in slip-rule scorer).

    python -m rafft_tpu_torch.tools.bench_mfe --csv PATH [--out mfe.csv]
        [--limit N] [--max_len N] [--engine torch|native] [--batch 16]
        [--device cuda]

--engine torch (the default) runs the batched DP (mfe/mfe_torch.py) on
--device, by power-of-two bucket N >= 32 as the JAX sweep does, at
mfe_bucket_batch(--batch, N) sequences a batch; --engine native runs the
C++ DP (rafft_tpu_torch.mfe.mfe_fold) on the host, one sequence at a
time.  `mfe_records` runs the sweep for callers that hold the records.
"""

from __future__ import annotations

import argparse
import csv
import time


def mfe_bucket(n: int) -> int:
    """The MFE bucket of an n-nt sequence: the next power of two, >= 32."""
    return 1 << max(5, (n - 1).bit_length())


def mfe_bucket_batch(batch: int, N: int) -> int:
    """Sequences per batch in bucket N: `batch`, cut so that B * N^2 stays
    within 4 * 1024^2 (the fill holds a few [B, N, N] tensors, and each
    batch's matrices are copied to the host): 16 up to N=512 at --batch
    16, then 4 at 1024 and 1 at 2048 and 4096."""
    return max(1, min(batch, (4 << 20) // (N * N)))


def mfe_records(records, engine="torch", batch=16, device="cuda",
                temperature=37.0, stats=None):
    """(dot_bracket, energy_kcal) for each (seq, struct, name) record.

    `stats`, a dict, receives per bucket {N: {"n", "batch", "batches",
    "secs"}} (torch) with the seconds of each bucket's folds and
    tracebacks, the device synchronised at its end."""
    if engine == "native":
        from rafft_tpu_torch.mfe import mfe_fold
        return [mfe_fold(seq, temperature) for seq, _t, _n in records]
    if engine != "torch":
        raise ValueError(f"unknown engine {engine!r}")
    import torch

    from rafft_tpu_torch.mfe.mfe_torch import MfeEngine

    by_n = {}
    for idx, (seq, _t, _n) in enumerate(records):
        by_n.setdefault(mfe_bucket(len(seq)), []).append(idx)
    results = [None] * len(records)
    for N, idxs in sorted(by_n.items()):
        t0 = time.perf_counter()
        nb = min(mfe_bucket_batch(batch, N), len(idxs))
        eng = MfeEngine(N, temperature, B=nb, device=device)
        for off in range(0, len(idxs), nb):
            chunk = idxs[off: off + nb]
            out = eng.fold([records[i][0] for i in chunk])
            for i, res in zip(chunk, out):
                results[i] = res
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)
        if stats is not None:
            stats[N] = dict(n=len(idxs), batch=nb,
                            batches=-(-len(idxs) // nb),
                            secs=time.perf_counter() - t0)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csv", required=True,
                    help="benchmark CSV: rows of seq,struct,name")
    ap.add_argument("--out", default="mfe_rafft_tpu_torch.csv")
    ap.add_argument("--limit", type=int)
    ap.add_argument("--max_len", type=int)
    ap.add_argument("--engine", choices=("torch", "native"), default="torch",
                    help="the batched DP on --device, or the C++ DP on the "
                         "host")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from rafft_tpu_torch.parallel.sweep import load_benchmark_csv
    from rafft_tpu_torch.scoring import score_structures

    records = load_benchmark_csv(args.csv)
    if args.max_len:
        records = [r for r in records if len(r[0]) <= args.max_len]
    if args.limit:
        records = records[: args.limit]

    t0 = time.time()
    results = mfe_records(records, args.engine, args.batch, args.device)
    dt = time.time() - t0

    with open(args.out, "w") as out:
        w = csv.writer(out)
        w.writerow(["seq", "len_seq", "struct", "nrj", "nbp", "pvv", "sens",
                    "name"])
        for (seq, true_st, name), (db, e) in zip(records, results):
            ppv, sens = score_structures(db, true_st)
            w.writerow([seq, len(seq), db, e, db.count("("),
                        f"{ppv:.2f}", f"{sens:.2f}", name])
    print(f"{len(records)} seqs in {dt:.1f}s "
          f"({len(records) / max(dt, 1e-9):.1f} seq/s) -> {args.out}")


if __name__ == "__main__":
    main()
