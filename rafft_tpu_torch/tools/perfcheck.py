"""Step time, throughput, parity with the CPU parity engine and budget
pressure at the bench configuration (tools/perfcheck.py's counterpart, on
the port's FoldEngine).

    python -m rafft_tpu_torch.tools.perfcheck [NSEQ] [B] [--csv PATH]
        [--device cuda] [--workers W]

Folds the first NSEQ (default 32) sequences of at most 120 nt, in the
order of --csv (the reference benchmark CSV) or, without it, of
tools/corpus.py:reference_order(), at debug_seq.CONFIG with batch B
(default 16), and prints: the first step's seconds (the engine built,
the state loaded, one step), the steady step's ms over 10 steps on a
populated beam, seq/s of FoldEngine.run over the NSEQ rows, the
complex-candidate budget's drops (cplx_dropped: total and most per
sequence) and the enumeration's flags (enum_suspect: sequences and the
sum of their bits), then how many final beams equal fold_cpu's
(-n 100 -ms 50 --max_branch 1000), with the first three mismatches.
fold_cpu runs in a pool of W processes (default: the CPU count) started
by forkserver, since this process holds a CUDA context.  Times on the
card end in a synchronisation.
"""

from __future__ import annotations

import argparse
import multiprocessing as mp
import time

import numpy as np
import torch

from rafft_tpu_torch.engine.fold_torch import FoldEngine
from rafft_tpu_torch.parallel.sweep import _cpu_refold, load_benchmark_csv
from rafft_tpu_torch.tools.corpus import reference_order, short_rows
from rafft_tpu_torch.tools.debug_seq import CONFIG

REP = 10


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def cpu_beams(seqs, cfg, workers=None):
    """fold_cpu's final beam of every sequence at the engine
    configuration's nb_mode (M), max_stack (K) and max_branch, in order."""
    tasks = [(i, s, cfg.M, cfg.K, cfg.max_branch) for i, s in enumerate(seqs)]
    out = [None] * len(seqs)
    ctx = mp.get_context("forkserver")
    with ctx.Pool(min(len(tasks), workers or mp.cpu_count())) as pool:
        for i, rows, _evaluator in pool.imap_unordered(_cpu_refold, tasks):
            out[i] = rows
    return out


def run(seqs, nseq=32, B=16, device="cuda", workers=None, log=print,
        cfg=CONFIG):
    """The tool's measurements on seqs[:nseq] at `cfg`, printed through
    `log` and returned: first_step_s, step_ms, seq_s, cplx_dropped
    (total, most), enum_suspect (sequences, total), parity (exact,
    nseq), mismatches (the index of each)."""
    seqs = seqs[:nseq]
    t0 = time.time()
    eng = FoldEngine(cfg, B=B, device=device)
    state = eng.step(eng.init_state(seqs[:B]))
    _sync(device)
    first = time.time() - t0
    log(f"engine+first step: {first:.1f}s")
    # steady-state step timing on a populated beam
    state = eng.step(state)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(REP):
        state = eng.step(state)
    _sync(device)
    step_ms = (time.perf_counter() - t0) / REP * 1e3
    log(f"steady step: {step_ms:.1f} ms")

    t0 = time.time()
    beams, drops, suspects = [], [], []
    for off in range(0, len(seqs), B):
        got, st = eng.run(seqs[off:off + B])
        n_b = len(got)
        beams += got
        drops.append(st["cplx_dropped"][:n_b].cpu().numpy())
        suspects.append(st["enum_suspect"][:n_b].cpu().numpy())
    dt = time.time() - t0
    log(f"{len(seqs)} seqs in {dt:.1f}s = {len(seqs) / dt:.2f} seq/s")
    drops, suspects = np.concatenate(drops), np.concatenate(suspects)
    log(f"cplx_dropped: {drops.sum()} max/seq: {drops.max()}")
    log(f"enum_suspect: seqs {(suspects > 0).sum()} total {suspects.sum()}")

    t0 = time.time()
    mismatches = []
    for i, (seq, got, want) in enumerate(zip(seqs, beams,
                                             cpu_beams(seqs, cfg, workers))):
        if got != want:
            mismatches.append(i)
            if len(mismatches) <= 3:
                log(f"MISMATCH seq {i} len {len(seq)}")
                for a, b in zip(got, want):
                    if a != b:
                        log(f"  got  {a}")
                        log(f"  want {b}")
                        break
    exact = len(seqs) - len(mismatches)
    log(f"parity: {exact}/{len(seqs)} exact (cpu ref took "
        f"{time.time() - t0:.1f}s)")
    return dict(first_step_s=first, step_ms=step_ms, seq_s=len(seqs) / dt,
                cplx_dropped=(int(drops.sum()), int(drops.max())),
                enum_suspect=(int((suspects > 0).sum()), int(suspects.sum())),
                parity=(exact, len(seqs)), mismatches=mismatches)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("nseq", nargs="?", type=int, default=32)
    ap.add_argument("B", nargs="?", type=int, default=16)
    ap.add_argument("--csv", help="the reference benchmark CSV (default: "
                    "tools/corpus.py:reference_order())")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workers", type=int)
    args = ap.parse_args(argv)
    records = load_benchmark_csv(args.csv) if args.csv else reference_order()
    run(short_rows(records), args.nseq, args.B, args.device, args.workers,
        log=lambda m: print(m, flush=True))


if __name__ == "__main__":
    main()
