"""Length-bucketed corpus sweep (rafft_tpu/parallel/sweep.py).

Sequences are bucketed by padded length and folded bucket by bucket with
the PyTorch FoldEngine at the JAX sweep's per-bucket configuration.
Folds that the engine flags as possibly inexact are refolded on the
sequential CPU parity engine in a forkserver pool (a CUDA context does
not survive fork).  The outputs keep the JAX sweep's schemas: result
dicts and the results CSV, the bucket checkpoint journal (`_idx`,
`_bucket`), the beams journal ({name, seq, flagged, beam}), the run
manifest and the flag histogram.

The buckets are the JAX sweep's, 128 to 4096; records past the largest
bucket are skipped, as there.  With engine="cpu" (--engine cpu) every
bucket is folded by the CPU parity engine through the pool and no
device is touched.

Data parallelism, the JAX sweep's mesh: with a list of k > 1 devices
(`devices=`, --devices k for cards 0 to k-1) each bucket is folded by k
worker processes, one per device, each on its strided share of the
bucket with a batch of ceil(B / k).  Processes, not one thread driving k
engines: a fold step is bound by the host's launches, which one Python
thread would issue for the k devices one after another.  Everything
after the fold (the refold, the journals, the scores) stays in the
calling process.  Multi-process runs (--coordinator, --num_processes,
--process_id; parallel/launch.py starts them on one machine) fold
`records[process_id::num_processes]` in each process, write
`<out>.part<process_id>`, reduce the mean scores over the process group
(parallel/distributed.py) and merge the parts in process 0.  --devices
k combines with them where each process has a machine of its own and the
default --device: it then spreads its share over that machine's cards 0
to k-1.  Beside a --device that names one device, as the launcher gives
every process it starts, --devices is refused: every process of the
machine would take the same k cards.

CLI:
  python -m rafft_tpu_torch.parallel.sweep --csv <benchmark.csv> \
      --out results.csv [--device cuda] [--engine torch|cpu] \
      [-n 100 -ms 50] [--limit 200] [--devices k] \
      [--coordinator HOST:PORT --num_processes P --process_id I]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import csv
import json
import multiprocessing as mp
import os
import time

import numpy as np
import torch

from rafft_tpu_torch import _build
from rafft_tpu_torch.engine import wavefront as WT
from rafft_tpu_torch.engine.fold_torch import (FLAG_NAMES, EngineConfig,
                                               FoldEngine, cplx_budget,
                                               region_slots)
from rafft_tpu_torch.scoring import best_of, score_structures

# the buckets of rafft_tpu/parallel/sweep.py (no 64 bucket there either)
DEFAULT_BUCKETS = (128, 256, 512, 1024, 2048, 4096)


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


def _fold_share(task):
    """Worker process: fold one device's share of a bucket.  Returns
    [(position in the share, rows, flagged)] and the wavefront launches
    this fold made in this process."""
    cfg, B, device, seqs, threads = task
    torch.set_num_threads(threads)
    before = WT.LAUNCHES
    out = list(FoldEngine(cfg, B=B, device=device).run_stream(seqs))
    return out, WT.LAUNCHES - before


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
    (rafft_tpu/parallel/sweep.py:167-186), but for CPLX and, at 512, R:
    the JAX sweep's 512 (N <= 128) or 1024 per 50 beam rows begun
    (cplx_budget), so K <= 50 folds at the JAX sweep's budget and K = 200
    at four times it, with no fold of the 65-128 nt corpus rows over it;
    and region_slots' R, 24 at 512 where the JAX sweep has 16, so no fold
    of the 257-512 nt corpus rows drops regions."""
    return EngineConfig(N=N, K=max_stack, M=min(nb_mode, 2 * N - 1),
                        R=region_slots(N), max_branch=max_branch,
                        V=4096, W=8 if N <= 128 else 24,
                        CPLX=cplx_budget(512 if N <= 128 else 1024, max_stack),
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
          checkpoint=None, save_beams=None, stats=None, workers=None,
          engine="torch", *, device="cuda", devices=None):
    """Fold every record on `device`, or split over `devices`; returns
    result dicts in input order.

    The arguments and outputs are those of rafft_tpu.parallel.sweep.sweep
    (engine is "torch" where that says "jax", `devices` where that takes
    a mesh): save_beams appends one jsonl row per folded sequence,
    checkpoint journals finished buckets and skips them on restart, stats
    receives per-bucket timings, the fallback count, the flag histogram,
    per device the rows it folded and its wavefront launches
    (`devices`), and, where folds ran on the CPU parity engine, the
    energy evaluator they ran (`refold_evaluator`).  devices: a list of
    k > 1 devices (repeats allowed) folds each bucket in k worker
    processes, one per device, `batch` split over them; a worker that
    fails makes the sweep raise.  engine="cpu" folds every bucket on the
    CPU parity engine through the pool and touches no device.  Records
    longer than the largest bucket are skipped."""
    if engine not in ("torch", "cpu"):
        raise ValueError(f"engine must be 'torch' or 'cpu', got {engine!r}")
    workers = workers or max(1, mp.cpu_count())
    devices = list(devices or [device])
    k = len(devices)
    per_device = [dict(device=str(d), rows=0, launches=0) for d in devices]

    by_bucket: dict[int, list[int]] = {}
    for i, (seq, _t, _n) in enumerate(records):
        b = bucket_of(len(seq), buckets)
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

    with contextlib.ExitStack() as stack:
        pools = []
        if engine == "torch" and k > 1:
            if any(torch.device(d).type == "cuda" for d in devices):
                _build.build("wavefront")   # once, before the workers load it
            # spawn: the parent may hold a CUDA context, which a forked
            # child would inherit broken; one pool per device keeps each
            # worker on its own device for the whole sweep
            ctx = mp.get_context("spawn")
            pools = [stack.enter_context(concurrent.futures.ProcessPoolExecutor(
                1, mp_context=ctx)) for _ in devices]
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
            if engine == "cpu":
                # no card: the whole bucket goes to the pool
                stream = ()
                pending = [(i, records[i][0], nb_mode, max_stack, max_branch)
                           for i in idxs]
            else:
                pending = []
                stream = _bucket_stream(
                    bucket_config(N, nb_mode, max_stack, max_branch),
                    bucket_batch(batch, N), [records[i][0] for i in idxs],
                    devices, pools, per_device)
            for local_i, rows, flagged in stream:
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
                # forkserver children start from a fresh interpreter: no
                # CUDA context is inherited
                ctx = mp.get_context("forkserver")
                with ctx.Pool(min(len(pending), workers)) as pool:
                    for i, rows, evaluator in pool.imap_unordered(
                            _cpu_refold, pending):
                        evaluators.add(evaluator)
                        finish(i, rows, flag_of.get(i, 0))
                        if engine == "cpu":
                            n_done += 1
                            if progress:
                                progress(N, n_done, len(idxs))
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
        if engine == "torch":
            stats["devices"] = per_device
        if evaluators:
            stats["refold_evaluator"] = "+".join(sorted(evaluators))
    return results


def _bucket_stream(cfg, B, seqs, devices, pools, per_device):
    """(index in seqs, rows, flagged) of every fold of a bucket at batch
    B: on the one device in this process, or in the device pools'
    workers, each on its strided share at batch ceil(B / k); a worker's
    folds come when it finishes.  Counts each device's rows and
    wavefront launches into per_device."""
    k = len(devices)
    if k == 1:
        before = WT.LAUNCHES
        for out in FoldEngine(cfg, B=B, device=devices[0]).run_stream(seqs):
            per_device[0]["rows"] += 1
            yield out
        per_device[0]["launches"] += WT.LAUNCHES - before
        return
    task = lambda w: (cfg, -(-B // k), devices[w], seqs[w::k],
                      torch.get_num_threads())
    futs = {pool.submit(_fold_share, task(w)): w
            for w, pool in enumerate(pools) if seqs[w::k]}
    for fut in concurrent.futures.as_completed(futs):
        w = futs[fut]
        out, launches = fut.result()
        per_device[w]["rows"] += len(out)
        per_device[w]["launches"] += launches
        for j, rows, flagged in out:
            yield w + j * k, rows, flagged


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
    ap.add_argument("--engine", choices=("torch", "cpu"), default="torch",
                    help="'cpu' folds every bucket on the sequential "
                         "parity engine through the process pool (no card)")
    ap.add_argument("--save-beams", dest="save_beams",
                    help="jsonl path: full saved beam per sequence, for "
                         "offline best-of-k re-scoring")
    ap.add_argument("--devices", type=int,
                    help="data-parallel card count: cards 0 to k-1, one "
                         "worker process each (in place of --device, so "
                         "not with a --device that names one)")
    ap.add_argument("--coordinator",
                    help="host:port of process 0 (multi-process mode)")
    ap.add_argument("--num_processes", type=int, default=1)
    ap.add_argument("--process_id", type=int, default=0)
    args = ap.parse_args(argv)
    if args.devices is not None and args.device != "cuda":
        # --devices k takes cards 0 to k-1 whatever --device says: with a
        # named device (each launched process gets its own) every process
        # of a machine would fold on the same k cards
        ap.error(f"--devices {args.devices} takes cards 0 to "
                 f"{args.devices - 1} in place of --device {args.device}; "
                 f"give one or the other")

    records = load_benchmark_csv(args.csv)
    if args.max_len:
        records = [r for r in records if len(r[0]) <= args.max_len]
    if args.min_len:
        records = [r for r in records if len(r[0]) >= args.min_len]
    if args.limit:
        records = records[: args.limit]

    devices = None
    if args.devices and args.devices > 1:
        from rafft_tpu_torch.parallel.mesh import data_devices
        devices = data_devices(args.devices)

    multihost = args.coordinator is not None
    if multihost:
        from rafft_tpu_torch.parallel.distributed import (init_multihost,
                                                          shard_records)
        pid, pcount, _ld, _gd = init_multihost(
            args.coordinator, args.num_processes, args.process_id,
            devices or [args.device])
        print(f"[multihost] process {pid}/{pcount}: "
              f"{len(_ld)} local / {len(_gd)} global devices", flush=True)
        records = shard_records(records, pid, pcount)

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
                    workers=args.workers, engine=args.engine,
                    device=args.device, devices=devices)
    dt = time.time() - t0
    sel = "best_of_k" if args.best_of_k else "best_nrj"
    manifest = dict(argv=vars(args), n_records=len(records),
                    elapsed_s=round(dt, 1), **stats)
    # one manifest per process: its records, timings and device counts
    where = f"{args.out}.part{pid}" if multihost else args.out
    with open(f"{where}.manifest.json", "w") as fh:
        json.dump(manifest, fh, indent=1, sort_keys=True)
        fh.write("\n")
    if multihost:
        # every process writes its part; process 0 merges them (shared
        # filesystem, the reference's CSV aggregation) and the mean
        # scores reduce over the process group
        from rafft_tpu_torch.parallel.distributed import (global_mean,
                                                          merge_parts,
                                                          shutdown)
        part = f"{args.out}.part{pid}"
        write_results_csv(results, part, sel)
        with open(part, "a") as fh:
            fh.write("#done\n")
        ok = [r for r in results if r]
        mean_ppv = global_mean(
            float(np.mean([r["pvv"] for r in ok])) if ok else 0.0, len(ok))
        mean_sens = global_mean(
            float(np.mean([r["sens"] for r in ok])) if ok else 0.0, len(ok))
        try:
            if pid == 0:
                header = "seq,len_seq,struct,nrj,nbp,pvv,sens,name\n"
                ntot = merge_parts(args.out, pcount, header)
                print(f"{ntot} sequences merged; global mean PPV "
                      f"{mean_ppv:.2f} mean sens {mean_sens:.2f}")
        finally:
            shutdown()
        return
    write_results_csv(results, args.out, sel)
    if args.out_bk:
        write_results_csv(results, args.out_bk, "best_of_k")
    ok = [r for r in results if r]
    mean_ppv = np.mean([r["pvv"] for r in ok]) if ok else 0.0
    mean_sens = np.mean([r["sens"] for r in ok]) if ok else 0.0
    print(f"{len(ok)} sequences in {dt:.1f}s ({len(ok)/max(dt,1e-9):.2f} "
          f"seq/s); mean PPV {mean_ppv:.2f} mean sens {mean_sens:.2f}")


if __name__ == "__main__":
    main()
