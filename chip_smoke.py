"""Drive the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py [--full] [--k200-full [--k200-limit SECONDS]] [--only phase,...]

Phases (each raises on failure; the script exits nonzero and prints no
result line):
  1. device   - a CUDA card is present; print its name and power limit;
  2. build    - build the wavefront, delta and enumerate kernels from
                csrc/ (nvcc)
                and the native Turner evaluator from native/ (g++),
                started together, each timed, with ptxas's registers and
                spills;
  3. kernel   - at the shapes of every bucket's fold step (N=128: 16 x 50
                beam rows, R=16; N=256: 16 x 50, R=16; N=512: 8 x 50,
                R=24; N=1024: 4 x 50, R=32; N=2048: 2 x 50, R=32; N=4096:
                1 x 50, R=32; and N=128 at K=200: 16 x 200, R=16), all seven
                kernel tables equal the plain PyTorch version on seeded
                random and degenerate layouts (two layouts up to N=1024
                and at K=200, one at 2048 and 4096, where the plain
                version takes seconds a call); time both at each shape,
                and print the bytes, cells and bound of the inputs
                (wavefront_work) with the kernel's share of the bound.
                Then the N=128 shape at non-integral pair weights: the six
                integer tables equal, cor_raw within COR_RAW_TOL;
  4. fold_one - the README sequence at max_stack 5 and 20 gives the same
                trajectory and final beam as the sequential CPU oracle;
  4b. oracle  - the port's own fold_cpu, with the native evaluator, gives
                the committed README trajectories and the committed beams
                of journal rows 443, 567, 947 and 1262, and the native
                and the numpy evaluator agree on all those structures;
  4c. weights - fold_one of the README sequence at max_stack 5 and 20 with
                non-integral pair weights (the FFT correlation ranks the
                lags, the kernel's tables give the window slide) on the
                card, on the CPU in the same run and in the committed
                output of the JAX engine on the CPU: equal, or the first
                differing step swaps lags whose correlations differ by
                less than COR_TOL (tools/measure.py:
                first_difference_is_a_tie); _correlate on the card
                against the CPU within COR_TOL at the N=128 step shape;
                and the card against the CPU in lock-step, under the same
                rule, on four repetitive sequences (ties likely) and on a
                journal row of the 512 bucket (tolerance 4 x COR_TOL: the
                sums are larger);
  5. headline - FoldEngine at N=128, K=50, M=100, R=16, V=4096, W=8,
                CPLX=512, S=16384, max_branch=1000, B=16: run_stream over
                the first 64 journal rows of <= 120 nt must reproduce the
                committed beams exactly with flag 0, through the kernel;
                then the kernel alone on the inputs of one real step (the
                4th of the warm-up fold) beside its bound.  Here and in
                phase 7 every step of the warm-up must hand the kernel
                tensors that keep its layout contract (check_layout),
                and on the captured step the kernel's seven tables must
                equal the plain version's;
  6. loops    - eval_pt on [4, 1024, 1024] nested pair tables (the 1024
                bucket's complex-candidate tables at CPLX=1024) equals the
                CPU result on a subset and raises the peak by <= 2 GiB;
  7. buckets  - run_stream at the sweep's configuration of the 256, 512
                and 1024 buckets (bucket_config, bucket_batch(16, N)) over
                the first rows of each bucket and its flagged journal
                rows: unflagged rows equal the journal with flag 0, and
                flagged rows carry the journal's flag bits, but r_slots
                at 512 (_want_flag: the port's R=24 there holds journal
                rows 2268 and 2269, which the JAX sweep's 16 flagged, so
                they fold unflagged to the journal's beams, the JAX
                sweep's CPU refold); the kernel on one real step of each
                bucket beside its bound, and the same checks on one more
                fold of the journal's flagged rows alone;
  7a. b512    - the corpus's 257-512 nt band at -n 100 -ms 50 as the
                sweep folds it: all 252 journal rows of the 512 bucket
                through run_stream at bucket_config(512, 100, 50, 1000)
                (R=24, W=24, CPLX=1024), B=8, graphed: no row flagged,
                every beam the journal's or, on the journal's flagged
                rows, the port's fold_cpu's, folded on the host's cores
                meanwhile; prints seq/s, the peak, and the quantiles of
                r_need and cplx_need beside R and CPLX;
  7b. k200    - run_stream at bucket_config(N, 200, 200, 1000), B =
                bucket_batch(16, N), over the first 16 journal rows of <= 120
                nt (N=128, B=16: 3,200 beam rows), the first 16 of the 256
                bucket (B=16: 3,200 x 256), the first 8 of the 512 bucket
                (B=8: 1,600 x 512) and the first 4 of the 1024 bucket (B=4):
                flags counted by cause (a flagged fold is one the sweep
                refolds on the CPU), none of them cplx_budget at 128 (the
                budget grows with K: cplx_budget); an unflagged row's best
                structure and energy equal the committed K=200 sweep
                (sweep_200n200_tpu.ckpt.jsonl up to 256,
                sweep_200n200_cpu.ckpt.jsonl above: the JAX package's K=200
                sweep of the 512 and 1024 buckets ran on its CPU engine) or,
                where that row differs, its whole beam equals the port's
                fold_cpu; seconds and peak memory of each bucket, and the
                kernel on its 4th step against the plain version's seven
                whole tables, beside its bound;
  7d. delta   - the delta kernel (csrc/delta.cu) against its plain
                version (engine/delta.py:_candidate_delta), all four
                outputs on every lane, on the first four fold steps of
                the first B journal rows of the band at each stream
                cell's shape (65-128 nt at bucket_config(128, 100, 50,
                1000) and (128, 200, 200, 1000), B=16; 257-512 nt at
                (512, 100, 50, 1000), B=8, R=24); on the fourth step the
                kernel's device time (CUDA events, calls enqueued ahead),
                the plain version's,
                and the kernel's bound (delta_work's bytes over 3.35
                TB/s); then the 1,894 rows of 65-128 nt of
                sweep_200n200_tpu.ckpt.jsonl through run_stream at (128,
                200, 200, 1000), graphed: no row flagged, each best row
                the committed one or the whole beam fold_cpu's;
  7e. enumerate - the enumerate kernel (csrc/enumerate.cu) against its
                plain version (engine/enumerate.py:_enumerate_combos),
                every output field on every lane (the seen set, its
                count, mode, rneed, suss, the windows run and the running
                beam, its unused rows included), on the first four fold
                steps at phase delta's three shapes and at the api cell's
                (fold_one_config at -ms 20: B=1, V=2,000, S=4,096); on
                the fourth step the kernel's device time, the plain
                version's, and a byte bound (enumerate_work: the
                candidate entries the decoded slots reach and the seen
                set's passes, over 3.35 TB/s); then 4 x B rows through
                run_stream, graphed, whose enumerate launches are the
                result line's; phase b512 also raises unless the stream
                launched the kernel;
  7c. long    - run_stream at bucket_config(4096, 100, 50, 1000), B=1, on
                the two 23S rRNAs of longtail.ckpt.jsonl (2,915 and 2,968
                nt): a row carries a nonzero flag, printed by cause, or
                gives the committed structure and energy.  At
                bucket_config(2048, 100, 50, 1000), B=2, two seeded
                sequences of 1,100 to 2,000 nt: every beam entry's energy
                equals eval_structure_int, energies ascend, flags printed;
                the same two at the cut configuration -n 20 -ms 3
                --max_branch 100 equal the port's fold_cpu, run here, and
                the committed beams.  Every step keeps the kernel's layout
                contract, and the kernel on one captured step of each
                bucket equals the plain version, timed beside its bound.
                Each timed fold runs graphed; the layout check (one host
                read a step) runs on one more eager fold of its first
                batch;
  8. sweep    - the port's sweep() on the first 16 journal rows writes
                the journal's beams-journal rows;
  9. cli      - `python -m rafft_tpu_torch.cli.fold_cli --device cuda`
                prints what the reference CLI prints with its CPU engine,
                and with --nono the reference's tree-keeping output;
 9b. mfe      - the batched MFE DP (MfeEngine, mfe/mfe_torch.py) on the
                first 16/16/16/16/8/4 journal rows of the MFE buckets
                32/64/128/256/512/1024 (tools/bench_mfe.py's bucketing
                and batch sizes: B=16, 4 at 1024): every structure and
                energy equals the native C++ DP (mfe_fold) run here and,
                on the committed rows (the README sequence and 8 journal
                rows of the 128 bucket), the JAX package's batched DP.
                Prints per bucket the seconds per batch (fill, and the
                host's copies and tracebacks), seq/s, the peak and the
                native DP's seconds on the same rows; and, from one
                profiled batch at N=128 and N=1024, the device ops per
                diagonal and per step of the exterior F loop;
  9c. api     - the package root: rafft_tpu_torch.fold of the README
                sequence at max_stack 5 and 20 with traj=True equals the
                committed fold_cpu trajectories (a fold the engine flags
                is refolded by fold_cpu: the count is printed), and its
                -ms 20 trajectory printed as the fold CLI prints it
                equals the committed JAX CLI output; kinetics() on that
                output and `python -m rafft_tpu_torch.cli.kin_cli` on it
                print the committed JAX kinetics CLI's stdout (expm at
                -mt 30, eig at -mt 10); mfe_fold gives the committed MFE
                rows;
 9d. multi    - the scale-out layer on the one card (runs on several
                cards are not checked here: the machine has one): the dry
                run (parallel/dryrun.py) split over ["cuda:0", "cuda:0"] is
                bit-equal to one engine and to the dry run on the CPU,
                every kernel call it makes (N=32) gives the plain
                version's seven tables, and data_devices(count + 1)
                raises; sweep(devices=["cuda:0", "cuda:0"]) over the first
                32 journal rows of <= 128 nt and 8 of the 256 bucket writes
                the journal's beams-journal rows and the one-device
                sweep's results, each worker launching the kernel; `python
                -m rafft_tpu_torch.parallel.launch` of two gloo processes
                sharing cuda:0 merges to the one-process sweep CLI's rows
                (part 0's, then part 1's) and means, each process
                launching the kernel; then seq/s on the headline rows, one
                process at B=16 against two sharing cuda:0 at B=8 each,
                medians of 3 alternated passes after a warm-up (printed,
                not gated);
 9e. bench    - the port's benchmark entry point, tools/bench.py's run on
                the card at 3 passes a cell (the headline's 256 rows of
                <= 120 nt, and 256/16/8/4 rows of the 128/256/512/1024
                buckets at the sweep's configurations): every fold equals
                the journal (beam, energies and flag 0) or, on journal
                rows 443, 567, 947 and 1262, the committed oracle beam; a
                flagged row carries its flag bits (as in phase 7); the line
                covers the 2,294 journal rows and names the card, and is
                printed prefixed `bench:`.  Then tools/bench_full.py's
                batch scan (the headline rows at B = 16, 32, 64: seq/s and
                peak), its folds held in the same way, and the kernel on
                one real step at each B (800, 1,600 and 3,200 beam rows x
                16 x 128) against the plain version beside its bound;
 9f. tools    - the evaluators' host APIs and the fold engine's tools on
                the card: eval_batch on every beam entry of the first 64
                headline rows equals the journal's energies, eval_pt_scan
                at N=4096 on the two 23S rRNAs' committed structures equals
                eval_structure_int; tools/debug_seq.py finds no divergence
                on row 7 (reference order); tools/debug_delta.py on row 7
                under its journal best structure (N=128) and on the first
                row of <= 32 nt under its own (N=32) finds no wrong dE,
                every kernel call of both held to the layout contract and
                the plain version's seven whole tables; tools/perfcheck.py
                at NSEQ=16, B=16 has parity 16/16; sweep() with the
                committed K=200 manifest's buckets (64 to 4096) over the 44
                rows of sweep_200n200_tpu.ckpt.jsonl's 64 bucket at -n 200
                -ms 200, flagged rows refolded on the CPU: each row equals
                the committed row or, where that differs, fold_cpu's whole
                beam (phase k200's rule); every kernel call of the same
                fold at bucket_config(64, 200, 200, 1000), B=16, held to
                the plain version's whole tables, and its 4th step timed
                beside its bound;
 10. full     - with --full only: sweep() over all 2,294 journal rows,
                the flagged ones refolded on the CPU; every beams-journal
                row equals the committed journal or, on the rows where
                that differs, the sequential CPU parity oracle (the
                reference semantics).  Prints the refold seconds and the
                evaluator the refold ran, which must be the native one.
                Then sweep() over the two 23S rRNAs (the 4096 bucket, the
                CPU refold of what the engine flags): the result rows
                equal longtail.ckpt.jsonl.  Then the MFE DP over all
                2,294 journal rows through tools/bench_mfe.py's
                mfe_records on the card, and over the two 23S rRNAs at
                N=4096, B=1: every row equal to the native DP, run in a
                process pool;
 11. k200-full - with --k200-full only (combine it with --only k200 to run it
                without the rest of the default run): the whole committed
                -n 200 -ms 200 corpus, the 2,294 rows of the two
                sweep_200n200_*.ckpt.jsonl files and the 23S pair of
                longtail_200n200.ckpt.jsonl (k200_plan).  Stage 1, on the
                card: the 64, 128 and 256 buckets through sweep() as users
                run it, its CPU refold of flagged rows included, each
                result's (struct, nrj, nbp) against
                sweep_200n200_tpu.ckpt.jsonl; the 512 and 1024 buckets and
                the 23S pair through the sweep's engine path without the
                refold (run_stream at bucket_config, B = bucket_batch(16,
                N)); per bucket the rows, the flags by cause, the unflagged
                rows equal to and differing from the committed row, seconds,
                seq/s, peak and wavefront launches; the kernel on one real
                step at 3,200 x 16 x 256, 1,600 x 16 x 512, 800 x 32 x 1024
                and 200 x 32 x 4096 against the plain version's whole
                tables.  Stage 2, on the host's cores under --k200-limit
                seconds (default 3,600): fold_cpu in a forkserver pool,
                smallest N first, refolds every row flagged in stage 1
                outside sweep() (it must give the committed struct and nrj)
                and every unflagged row that differs (its whole beam must
                equal fold_cpu's); rows the limit cuts off are printed as
                unchecked with their indices, no failure and never counted
                as equal.  Prints `k200_full: {...}`, the record per bucket;
  12. graph   - the fold engine's CUDA graphs (FoldEngine on a card replays
                one graph per G=4 swap+step rounds in run_stream,
                _advance_graphed): the 64 headline rows, the journal's 6
                rows of <= 32 nt at N=32 and 16 of 33-64 nt at N=64, and
                the first rows of the 128/256/512/1024 buckets
                (32/32/16/4, plus the bucket's flagged rows), each at
                bucket_config(N, 100, 50, 1000), folded through run_stream
                with graphs, each fold held to the journal as phase 7
                holds it;
                then on one batch (the headline configuration, 16 rows and
                16 shadow sequences) the eager engine (graphs=False) and
                the graphed one in lock-step, every key of the state equal
                after every call of G rounds; a replay under
                torch.cuda.set_sync_debug_mode("error") (no call that
                waits for the device); and tools/measure.py:graph_cell at
                the headline: device ops per step and host events that wait
                for the device in one call of each path (profiler), ms per
                step of both paths in turns, the graph pool's bytes, the
                wrapper's host time and the fixed CPLX width's cost.
Every other phase folds with graphs too, the engine's default on a card:
the timed folds of phases 5, 7, 7b and 7c, the sweeps and the CLI; the
folds that hold every step's kernel tensors to the layout contract, or
capture one step's (tools/measure.py:capture_kernel_call), run eagerly
beside them, since a replay calls no wrapper.  A replay counts the
kernel's launches it holds (_build.Kernel.count_replay), one per round.
The default run's earlier phases are uncut; what was cut to keep it short
is in the later ones: one seeded layout and one timed call of the plain
version at N=2048 and 4096, 16, 16, 8 and 4 rows in the k200 phase, one pass
over each long fold, the first rows of each MFE bucket (all of them with
--full), and the MFE profiles to a batch's first 128 diagonals (a
diagonal issues the same ops at every d >= 8).
The oracle's and the reference CLI's outputs come from
rafft_tpu_torch/testdata/chip_smoke_refs.json, which
tests/test_torch_smoke_refs.py holds against the JAX package on the CPU;
this script imports nothing of JAX or of the JAX package, and checks at
its end that neither was loaded.  Each path that runs the fold engine
reads the kernel's launch count, set to 0 just before it.  The bound of
a kernel call is the larger of its bytes over 3.35 TB/s and its
operations over the card's scalar rates (tools/measure.py:kernel_bound).
The last three lines are the kernel summary, the card's name and power
limit, and the device record.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import csv
import io
import json
import multiprocessing
import os
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import rafft_tpu_torch
from rafft_tpu_torch import _build
from rafft_tpu_torch.cli import fold_cli, kin_cli
from rafft_tpu_torch.energy import eval_torch as ET
from rafft_tpu_torch.energy.eval_np import eval_structure_int
from rafft_tpu_torch.energy.params import encode_sequence, get_params
from rafft_tpu_torch.engine import fold_cpu
from rafft_tpu_torch.engine import delta as DL
from rafft_tpu_torch.engine import enumerate as EN
from rafft_tpu_torch.engine import fold_torch as FT
from rafft_tpu_torch.engine import wavefront as WT
from rafft_tpu_torch.engine.fold_torch import (EngineConfig, FoldEngine,
                                               fold_one, fold_one_config,
                                               weight_matrix)
from rafft_tpu_torch.mfe import MfeEngine, mfe_fold
from rafft_tpu_torch.parallel import dryrun, mesh
from rafft_tpu_torch.parallel import sweep as TS
from rafft_tpu_torch.parallel.sweep import bucket_batch, bucket_config, sweep
from rafft_tpu_torch.native import native_oracle
from rafft_tpu_torch.struct import pair_table, parse_rafft_output
from rafft_tpu_torch.tools import (bench, bench_full, debug_delta, debug_seq,
                                   perfcheck)
from rafft_tpu_torch.tools.bench_mfe import mfe_bucket_batch, mfe_records
from rafft_tpu_torch.tools.corpus import journal, reference_order, short_rows
from rafft_tpu_torch.tools.measure import (K200_SWEEP, KERNEL_SHAPES,
                                           MEM_RATE, bucket_rows,
                                           capture_kernel_call,
                                           event_ms, step_calls,
                                           first_difference_is_a_tie,
                                           GRAPH_G, graph_cell, pool_bytes,
                                           kernel_bound, mfe_bucket_rows,
                                           mfe_profile, nested_tables,
                                           quantiles, seeded_kernel_args,
                                           seeded_sequence)

ROOT = os.path.dirname(os.path.abspath(__file__))
ARTIFACTS = os.path.join(ROOT, "benchmarks", "artifacts")
REFS = os.path.join(ROOT, "rafft_tpu_torch", "testdata", "chip_smoke_refs.json")
HEADLINE = EngineConfig(N=128, K=50, M=100, R=16, V=4096, W=8, CPLX=512,
                        S=16384, max_branch=1000)
B = 16
# journal rows folded per bucket in phase 7 (beside its flagged rows)
BUCKET_ROWS = {256: 32, 512: 16, 1024: 4}
GiB = 2 ** 30
# non-integral weights: absolute tolerance on the normalised FFT
# correlation between two transforms at N=128 (values up to about 3; the
# unnormalised sums reach 300 and an edge lag divides by 1), and on the
# kernel's raw diagonal sums against the plain version's
COR_TOL = 1e-4
COR_RAW_TOL = 1e-3
# journal rows folded per MFE bucket in phase mfe
MFE_ROWS = {32: 16, 64: 16, 128: 16, 256: 16, 512: 8, 1024: 4}
# repeats make lags of equal pair content: where ties are likely
TIE_SEQS = ["GCAU" * 11, "GGGAAACCCUUU" * 3 + "GGGAAACC", "GU" * 20,
            "ACGUUGCA" * 5]


def log(msg):
    print(msg, flush=True)


def phase(fn):
    """Run one phase and print its seconds."""
    def run(*a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        log(f"[{fn.__name__[6:]}] phase took {time.perf_counter() - t0:.2f} s")
        return out
    return run


@phase
def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is false)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)}; {smi}")
    return smi


@phase
def phase_build():
    """The native sources, started together; seconds of each."""
    names = ("wavefront", "delta", "enumerate", "turner_eval")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        libs = list(pool.map(_build.build, names))
    wall = time.perf_counter() - t0
    secs = {}
    for name, lib in zip(names, libs):
        secs[name], out = _build.BUILD_LOG.get(name, (0.0, "(cached)"))
        log(f"[build] {lib.name} in {secs[name]:.2f} s")
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] ptxas: {line.strip()}")
    log(f"[build] all in {wall:.2f} s")
    return secs


def _tables_equal(args, what, timed=None):
    """All seven kernel tables equal the plain version on `args`, whole
    tables.  Returns the largest absolute difference (0.0).  `timed`, a
    dict, receives the ms of this one call of the plain version."""
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    want = WT.wavefront_tables_ref(*args)
    t1.record()
    got = WT.wavefront_tables(*args)
    torch.cuda.synchronize()
    if timed is not None:
        timed["plain_ms"] = t0.elapsed_time(t1)
    err = 0.0
    for k in WT.KEYS:
        if got[k].shape != want[k].shape or not torch.equal(got[k], want[k]):
            bad = (got[k] != want[k]).nonzero()[:5].tolist()
            raise AssertionError(f"kernel table {k} differs ({what}) at {bad}")
        err = max(err, (got[k].double() - want[k].double()).abs().max().item())
    return err


def _kernel_vs_bound(tag, args, N, reps=200, real_step=False):
    """Time the kernel on `args` (the wrapper's arguments; device time,
    the calls enqueued ahead) and print it beside the bound of those
    inputs.  The tensors of a real fold step must also keep the kernel's
    layout contract and give the plain version's tables."""
    extra = {}
    if real_step:
        WT.check_layout(*args)
        _tables_equal(args, f"{tag}, N={N}", timed=extra)
        # what the card takes to store the seven tables' bytes alone
        fill = torch.empty(7 * 2 * N * args[4].numel(), dtype=torch.int32,
                           device="cuda")
        extra["zero_ms"] = event_ms(fill.zero_, reps, queued=True)
        del fill
        log(f"[{tag}] N={N}: the step's tensors keep the layout contract; "
            f"7/7 tables equal the plain version ({extra['plain_ms']:.4f} ms "
            f"for its one call); zero_() of the seven tables' bytes "
            f"{extra['zero_ms']:.4f} ms")
    ms = event_ms(lambda: WT.wavefront_tables(*args), reps, queued=True)
    work = WT.wavefront_work(args[4], N)
    bound, by, b_ms, o_ms = kernel_bound(work)
    log(f"[{tag}] N={N} {tuple(args[4].shape)} x {N}: wavefront {ms:.4f} "
        f"ms/call; {work['bytes'] / 1e6:.1f} MB, {work['positions']} "
        f"positions, {work['cells']} cells "
        f"({work['window_cells']} in the half-window); bound {bound:.4f} ms "
        f"by {by} (bytes {b_ms:.4f}, operations {o_ms:.4f}); the kernel runs "
        f"at {bound / ms:.1%} of the bound's rate")
    return dict(N=N, shape=list(args[2].shape), layout=tag, ms=ms,
                bound_ms=bound, bound_by=by, bytes=work["bytes"],
                positions=work["positions"], cells=work["cells"], window_cells=work["window_cells"],
                share_of_bound=bound / ms, **extra)


@phase
def phase_kernel():
    dev = torch.device("cuda")
    W = weight_matrix(3.0, 2.0, 1.0)
    shapes, max_err = [], 0.0
    for N, nb, R, lens, K in KERNEL_SHAPES:
        cfg = EngineConfig(N=N, K=K, R=R)
        tabs = WT.small_tables(ET.device_params(cfg.temp, N, dev), W, dev)
        seeds = (0, 1) if N <= 1024 else (1,)
        for seed in seeds:
            args = (cfg, tabs,
                    *seeded_kernel_args(N, nb, R, lens, seed, dev, K))
            WT.check_layout(*args)
            once = {}
            max_err = max(max_err, _tables_equal(args, f"N={N}, seed {seed}",
                                                 timed=once))
        rec = _kernel_vs_bound("kernel", args, N)
        # past N=1024 the plain version takes seconds: the one call of the
        # comparison is its time
        rec["plain_ms"] = once["plain_ms"] if N > 1024 else event_ms(
            lambda: WT.wavefront_tables_ref(*args), 5 if N <= 256 else 2)
        log(f"[kernel] N={N} K={K}: 7/7 tables equal on {len(seeds)} "
            f"layout(s); plain torch {rec['plain_ms']:.4f} ms/call")
        shapes.append(rec)
    log(f"[kernel] tolerance: exact; max abs err {max_err}")
    # non-integral pair weights at the N=128 step shape: the recurrence is
    # the same float32 operations in the same order, the correlation sums
    # may round differently
    N, nb, R, lens, K = KERNEL_SHAPES[0]
    cfg = EngineConfig(N=N, K=K, R=R, gc_wei=2.5, au_wei=1.7, gu_wei=0.8)
    tabs = WT.small_tables(ET.device_params(cfg.temp, N, dev),
                           weight_matrix(2.5, 1.7, 0.8), dev)
    args = (cfg, tabs, *seeded_kernel_args(N, nb, R, lens, 1, dev, K))
    want, got = WT.wavefront_tables_ref(*args), WT.wavefront_tables(*args)
    for k in WT.KEYS[1:]:
        if not torch.equal(got[k], want[k]):
            raise AssertionError(f"kernel table {k} differs at non-integral "
                                 f"weights")
    cor_err = (got["cor_raw"] - want["cor_raw"]).abs().max().item()
    if not cor_err <= COR_RAW_TOL:
        raise AssertionError(f"cor_raw differs by {cor_err} at non-integral "
                             f"weights (tolerance {COR_RAW_TOL})")
    log(f"[kernel] N={N} at weights 2.5/1.7/0.8: 6/6 integer tables equal "
        f"the plain version; cor_raw max abs err {cor_err} (tolerance "
        f"{COR_RAW_TOL}, sums up to {want['cor_raw'].max().item():.1f})")
    return dict(max_abs_err=max_err, ms=shapes[0]["ms"],
                plain_ms=shapes[0]["plain_ms"], bound_ms=shapes[0]["bound_ms"],
                bound_by=shapes[0]["bound_by"], library_ms=None, shapes=shapes)


def _rows(structs):
    return [[s.str_struct, s.energy] for s in structs]


@phase
def phase_fold_one(refs):
    for ms in (5, 20):
        t0 = time.perf_counter()
        res, traj = fold_one(refs["readme_seq"], nb_mode=100, max_stack=ms,
                             max_branch=1000, traj=True, device="cuda")
        t1 = time.perf_counter()
        ref = refs["fold_one"][str(ms)]
        got = [_rows(s) for s in traj] + [_rows(res)]
        want = ref["traj"] + [ref["final"]]
        if got != want:
            raise AssertionError(f"fold_one ms={ms} differs from fold_cpu")
        log(f"[fold_one] ms={ms}: {len(traj)} steps + final beam equal "
            f"fold_cpu ({t1 - t0:.2f} s on the card)")


@phase
def phase_oracle(refs):
    """The port's own CPU parity engine and its native evaluator."""
    native, params = native_oracle(37.0), get_params(37.0)
    n_eval = 0

    def evaluators_agree(seq, beams):
        nonlocal n_eval
        codes = encode_sequence(seq).astype(np.int8)
        for db, e in {tuple(x) for beam in beams for x in beam}:
            pt = np.asarray(pair_table(db), np.int32)
            e_nat = native(codes, pt)
            e_np = eval_structure_int(seq, db, params)
            if e_nat != e_np or float(np.float32(e_nat / 100.0)) != e:
                raise AssertionError(f"evaluators differ on {db}: native "
                                     f"{e_nat}, numpy {e_np}, committed {e}")
            n_eval += 1

    for ms in (5, 20):
        t0 = time.perf_counter()
        res, traj = fold_cpu.fold(refs["readme_seq"], nb_mode=100, max_stack=ms,
                                  max_branch=1000, traj=True)
        ref = refs["fold_one"][str(ms)]
        if [_rows(s) for s in traj] + [_rows(res)] != ref["traj"] + [ref["final"]]:
            raise AssertionError(f"fold_cpu ms={ms} differs from the "
                                 f"committed trajectory")
        evaluators_agree(refs["readme_seq"], ref["traj"] + [ref["final"]])
        log(f"[oracle] README sequence ms={ms}: {len(traj)} steps + final "
            f"beam equal the committed ones ({time.perf_counter() - t0:.2f} s)")
    for o in refs["oracle"]:
        t0 = time.perf_counter()
        beam = [[s.str_struct, float(np.float32(s.energy))]
                for s in fold_cpu.fold(o["seq"], nb_mode=100, max_stack=50,
                                       max_branch=1000)]
        if beam != o["beam"]:
            raise AssertionError(f"fold_cpu differs from the committed beam "
                                 f"of journal row {o['row']}")
        evaluators_agree(o["seq"], [o["beam"]])
        log(f"[oracle] journal row {o['row']} ({len(o['seq'])} nt): "
            f"{len(beam)} beam entries equal the committed oracle beam "
            f"({time.perf_counter() - t0:.2f} s)")
    if fold_cpu.EVALUATOR != "native":
        raise AssertionError(f"fold_cpu ran the {fold_cpu.EVALUATOR} evaluator")
    log(f"[oracle] evaluator: {fold_cpu.EVALUATOR}; native and numpy agree on "
        f"{n_eval} structures (exact)")


@phase
def phase_weights(refs, rows_all):
    """Non-integral pair weights: the FFT correlation ranks the lags."""
    dev = torch.device("cuda")
    w = refs["weights"]["args"]
    # _correlate on the card against the CPU at the N=128 step shape
    N, nb, R, lens, K = KERNEL_SHAPES[0]
    cfg = EngineConfig(N=N, K=K, R=R, **w)
    W = weight_matrix(w["gc_wei"], w["au_wei"], w["gu_wei"])
    rcodes, _, mlen, _, _ = seeded_kernel_args(N, nb, R, lens, 1, dev, K)
    on_card = FT._correlate(cfg, W, rcodes, mlen, False)
    on_cpu = FT._correlate(cfg, W, rcodes.cpu(), mlen.cpu(), False)
    valid = on_cpu > FT.NEG / 2
    if on_card.shape != (nb, K, R, 2 * N - 1) or not torch.equal(
            on_card.cpu() > FT.NEG / 2, valid):
        raise AssertionError("_correlate: shape or masked lags differ")
    err = (on_card.cpu() - on_cpu)[valid].abs().max().item()
    if not err < COR_TOL:
        raise AssertionError(f"_correlate on the card differs from the CPU by "
                             f"{err} (tolerance {COR_TOL})")
    ms_call = event_ms(lambda: FT._correlate(cfg, W, rcodes, mlen, False), 20)
    log(f"[weights] _correlate {tuple(on_card.shape)}: max abs difference "
        f"card - CPU {err:.3e} over {int(valid.sum())} lags (tolerance "
        f"{COR_TOL}); {ms_call:.3f} ms/call on the card")
    launches = 0
    for ms in (5, 20):
        kw = dict(nb_mode=100, max_stack=ms, max_branch=1000, traj=True, **w)
        WT.LAUNCHES = 0
        t0 = time.perf_counter()
        res, traj = fold_one(refs["readme_seq"], device="cuda", **kw)
        secs = time.perf_counter() - t0
        if WT.LAUNCHES == 0:
            raise AssertionError("the fold never launched the wavefront kernel")
        launches += WT.LAUNCHES
        res_c, traj_c = fold_one(refs["readme_seq"], device="cpu", **kw)
        card = [_rows(x) for x in traj] + [_rows(res)]
        cpu = [_rows(x) for x in traj_c] + [_rows(res_c)]
        ref = refs["weights"]["fold_one"][str(ms)]
        jax_cpu = ref["traj"] + [ref["final"]]
        tie = None
        if card != cpu:
            # legitimate only if the first differing step is a tie of the
            # FFT correlation between the two transforms
            cfg1 = fold_one_config(len(refs["readme_seq"]), 100, ms, 1000,
                                   **w)
            tie = first_difference_is_a_tie(
                FoldEngine(cfg1, 1, device="cuda"),
                FoldEngine(cfg1, 1, device="cpu"), [refs["readme_seq"]],
                COR_TOL)
            if tie is None:
                raise AssertionError(f"weights ms={ms}: the folds differ but "
                                     f"no step does")
            log(f"[weights] ms={ms}: card and CPU differ from step {tie[0]}: "
                f"{tie[1]} lag ranks swapped within {tie[2]:.3e} (a tie)")
        if jax_cpu not in (card, cpu):
            raise AssertionError(f"weights ms={ms}: neither the card's nor "
                                 f"the CPU's fold equals the committed output "
                                 f"of the JAX engine")
        log(f"[weights] ms={ms}: {len(traj)} steps + final beam on the card "
            f"{'equal' if card == cpu else 'tie-equal to'} the CPU's and "
            f"{'equal' if card == jax_cpu else 'differ by that tie from'} the "
            f"committed JAX-engine output ({secs:.2f} s on the card, "
            f"wavefront launches {WT.LAUNCHES})")
    # the card and the CPU in lock-step where ties are likely (repeats)
    # and at a longer N (the first journal row of the 512 bucket), whose
    # sums, and with them the transforms' noise, are larger
    long_row = bucket_rows(rows_all, 512, 1)[0]["seq"]
    for what, seqs, cfg, tol in (
            ("4 repetitive sequences, N=64, K=6", TIE_SEQS,
             EngineConfig(N=64, K=6, R=8, M=24, V=128, CPLX=32, S=512,
                          max_branch=128, max_steps=10, **w), COR_TOL),
            (f"a journal row of {len(long_row)} nt, N=512, K=5", [long_row],
             fold_one_config(len(long_row), 100, 5, 1000, **w), 4 * COR_TOL)):
        WT.LAUNCHES = 0
        tie = first_difference_is_a_tie(
            FoldEngine(cfg, len(seqs), device="cuda"),
            FoldEngine(cfg, len(seqs), device="cpu"), seqs, tol)
        launches += WT.LAUNCHES
        log(f"[weights] lock-step card / CPU, {what} (tolerance {tol:.0e}): "
            + ("every step equal" if tie is None else
               f"first difference at step {tie[0]}: {tie[1]} lag ranks "
               f"swapped, each within {tie[2]:.3e} (a tie)")
            + f"; wavefront launches {WT.LAUNCHES}")
    return launches


def jax_region_slots(N):
    """The region slots of the JAX sweep that wrote the journal
    (rafft_tpu/parallel/sweep.py), which FT.region_slots widens at 512."""
    return 16 if N <= 512 else 32


def _want_flag(r):
    """The flag bits the port's sweep gives journal row `r`: the
    journal's, written by the JAX sweep, but r_slots where the port's
    bucket holds more region slots than that sweep's (region_slots: 24
    at 512 against 16).  A journal row flagged only there folds
    unflagged, and its journal beam, the JAX sweep's CPU refold, is
    fold_cpu's."""
    N = TS.bucket_of(len(r["seq"]), TS.DEFAULT_BUCKETS)
    if FT.region_slots(N) > jax_region_slots(N):
        return r["flagged"] & ~FT.FLAG_RSLOTS
    return r["flagged"]


def _stream_check(rows, out):
    """What run_stream yielded over journal `rows`: every row once, its
    beam the journal's with flag 0, or for a flagged row its flag bits
    (_want_flag; its journal beam came from the CPU refold)."""
    if sorted(i for i, _, _ in out) != list(range(len(rows))):
        raise AssertionError("run_stream did not yield every sequence once")
    bad = []
    for idx, beam, flag in out:
        r = rows[idx]
        want = _want_flag(r)
        if want:
            if flag != want:
                bad.append((idx, flag, want))
        elif flag != 0 or beam != [(db, float(e)) for db, e in r["beam"]]:
            bad.append((idx, flag, 0))
    if bad:
        raise AssertionError(f"{len(bad)}/{len(rows)} rows differ from the "
                             f"journal (index, flag, journal flag): {bad[:8]}")


def _stream(eng, rows, warm):
    """Warm up on `warm` rows (eagerly, then graphed), then run_stream
    over `rows` with the launch count and the peak set to 0 just before;
    check every row against the journal (beam and flag 0, or the
    journal's flag bits for a flagged row).  Every step of the warm-up, and of one more fold
    of the flagged rows after the counted run, must give the kernel
    tensors that keep its layout contract.  Returns (seq/s, seconds,
    peak bytes (allocated, plus the engine's graph pool), launches, the wrapper's arguments at the 4th step of
    the warm-up, and at the 4th step of the flagged rows' fold or
    None)."""
    step_args = capture_kernel_call(eng, [r["seq"] for r in warm],
                                    every=WT.check_layout)
    # the graphed warm-up: the capture stays out of the timed run
    for _ in eng.run_stream([r["seq"] for r in warm]):
        pass
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    WT.LAUNCHES = 0
    t0 = time.perf_counter()
    out = list(eng.run_stream([r["seq"] for r in rows]))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = WT.LAUNCHES
    peak = torch.cuda.max_memory_allocated() + pool_bytes(eng)
    _stream_check(rows, out)
    if launches == 0:
        raise AssertionError("the run never launched the wavefront kernel")
    flagged = [r["seq"] for r in rows if r["flagged"]]
    flag_args = (capture_kernel_call(eng, flagged, every=WT.check_layout)
                 if flagged else None)
    return len(out) / secs, secs, peak, launches, step_args, flag_args


@phase
def phase_headline(rows_all):
    rows = [r for r in rows_all if len(r["seq"]) <= 120][:64]
    eng = FoldEngine(HEADLINE, B=B, device="cuda")
    rate, secs, peak, launches, step_args, _ = _stream(eng, rows, rows[:16])
    log(f"[headline] {len(rows)}/{len(rows)} beams equal the journal, flag 0; "
        f"{rate:.3f} seq/s ({secs:.3f} s); peak {peak / 2**20:.1f} MiB; "
        f"wavefront launches {launches}")
    return launches, _kernel_vs_bound("headline step", step_args, HEADLINE.N,
                                      real_step=True)


@phase
def phase_loops():
    """eval_pt over the 1024 bucket's complex-candidate tables: B=4
    sequences x CPLX=1024 candidates x N=1024."""
    N, Bq, X, distinct = 1024, 4, 1024, 64
    tabs = nested_tables(np.random.default_rng(7), distinct, N, 513, 780)
    # the distinct tables (each with its own sequence) tiled to B x X
    tile = np.arange(Bq * X) % distinct
    dev = torch.device("cuda")
    c, p = (torch.as_tensor(x[tile], device=dev).view(Bq, X, N)
            for x in tabs[:2])
    n = torch.as_tensor(tabs[2][tile], device=dev).view(Bq, X)
    dp = ET.device_params(37.0, N, dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    e = ET.eval_pt(dp, c, p, n)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    ms = event_ms(lambda: ET.eval_pt(dp, c, p, n), 5)
    sub = slice(0, 2 * distinct)
    cpu = ET.eval_pt(ET.device_params(37.0, N, "cpu"),
                     *(x.view(-1, *x.shape[2:])[sub].cpu() for x in (c, p, n)))
    if not torch.equal(e.view(-1)[sub].cpu(), cpu):
        raise AssertionError("eval_pt on the card differs from the CPU")
    if rise > 2 * GiB:
        raise AssertionError(f"eval_pt on {tuple(p.shape)} raised the peak by "
                             f"{rise / GiB:.3f} GiB (> 2 GiB)")
    log(f"[loops] eval_pt {tuple(p.shape)}: equals the CPU on "
        f"{sub.stop} tables; peak rise {rise / 2**20:.1f} MiB (limit 2048 "
        f"MiB); {ms:.3f} ms/call")


@phase
def phase_buckets(rows_all):
    launches, steps = {}, []
    for N, count in BUCKET_ROWS.items():
        sel = bucket_rows(rows_all, N, count)
        nb = bucket_batch(16, N)
        eng = FoldEngine(bucket_config(N, 100, 50, 1000), B=nb, device="cuda")
        rate, secs, peak, n_launch, step_args, flag_args = _stream(
            eng, sel, sel[:nb])
        flags = [_want_flag(r) for r in sel if _want_flag(r)]
        log(f"[buckets] N={N} B={nb}: {len(sel) - len(flags)} unflagged rows "
            f"equal the journal with flag 0, flagged rows carry {flags}; "
            f"{rate:.3f} seq/s ({secs:.3f} s for {len(sel)}); peak "
            f"{peak / 2**20:.1f} MiB; wavefront launches (one per step) "
            f"{n_launch}")
        launches[N] = n_launch
        steps.append(_kernel_vs_bound("bucket step", step_args, N,
                                      real_step=True))
        if flag_args is not None:
            steps.append(_kernel_vs_bound("flagged rows' step", flag_args, N,
                                          real_step=True))
    return launches, steps


@phase
def phase_b512(rows_all, refs):
    """The corpus's 257-512 nt band at -n 100 -ms 50 as the sweep folds
    it: all 252 journal rows of the 512 bucket through run_stream at
    bucket_config(512, 100, 50, 1000), B = bucket_batch(16, 512), graphed,
    no row flagged; every beam the journal's or, where the journal is
    flagged or a TPU-run artifact, fold_cpu's (folded here, on the
    host's cores, while the card folds).  Prints seq/s, the peak, and the
    quantiles of r_need and cplx_need against R and CPLX."""
    N = 512
    index = [i for i, r in enumerate(rows_all)
             if TS.bucket_of(len(r["seq"]), TS.DEFAULT_BUCKETS) == N]
    rows = [rows_all[i] for i in index]
    seqs = [r["seq"] for r in rows]
    oracle = {o["seq"]: o["beam"] for o in refs["oracle"]}
    refold = [k for k, r in enumerate(rows)
              if r["flagged"] or r["seq"] in oracle]
    cfg = bucket_config(N, 100, 50, 1000)
    eng = FoldEngine(cfg, B=bucket_batch(16, N), device="cuda")
    for _ in eng.run_stream(seqs[: eng.B]):          # capture, warm
        pass
    with multiprocessing.get_context("forkserver").Pool(
            max(1, min(os.cpu_count() or 1, len(refold)))) as pool:
        cpu = pool.map_async(TS._cpu_refold, [(k, seqs[k], 100, 50, 1000)
                                              for k in refold], chunksize=1)
        needs = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        WT.LAUNCHES = DL.LAUNCHES = EN.LAUNCHES = 0
        t0 = time.perf_counter()
        out = list(eng.run_stream(seqs, needs=needs))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches, d_launches = WT.LAUNCHES, DL.LAUNCHES
        e_launches = EN.LAUNCHES
        peak = torch.cuda.max_memory_allocated() + pool_bytes(eng)
        cpu = {k: [tuple(x) for x in beam] for k, beam, _ in cpu.get()}
    if sorted(i for i, _, _ in out) != list(range(len(rows))):
        raise AssertionError("run_stream did not yield every sequence once")
    if launches == 0 or d_launches == 0 or e_launches == 0:
        raise AssertionError(f"the run launched the wavefront kernel "
                             f"{launches}, the delta kernel {d_launches} "
                             f"and the enumerate kernel {e_launches} times")
    flagged = {index[k]: FT.flag_names(flag) for k, _, flag in out if flag}
    bad = []
    for k, beam, _flag in out:
        journal = [(db, float(e)) for db, e in rows[k]["beam"]]
        if k in cpu and beam != cpu[k]:
            bad.append((index[k], "fold_cpu"))
        elif k not in cpu and beam != journal:
            bad.append((index[k], "journal"))
    cplx_need, r_need = (quantiles(x) for x in zip(
        *(needs[k] for k in range(len(rows)))))
    log(f"[b512] N={N} R={cfg.R} CPLX={cfg.CPLX} W={cfg.W} B={eng.B}: "
        f"{len(rows)} rows, flagged {flagged or 'none'}; "
        f"{len(rows) - len(refold)} beams held to the journal, {len(refold)} "
        f"to fold_cpu (journal rows {[index[k] for k in refold]}), differ "
        f"{bad or 'none'}; r_need {r_need} of R={cfg.R}; cplx_need "
        f"{cplx_need} of CPLX={cfg.CPLX}; {len(rows) / secs:.3f} seq/s "
        f"({secs:.3f} s); peak {peak / 2**20:.1f} MiB; wavefront launches "
        f"{launches}, delta launches {d_launches}, enumerate.launches "
        f"{e_launches}")
    if flagged or bad:
        raise AssertionError(f"b512: flagged {flagged}, differ {bad}")
    return launches, []


def _fold_once(eng, seqs):
    """One run_stream over `seqs` (graphed on the card) with the launch
    count and the peak set to 0 just before it; then, eagerly, one more
    fold of its first batch in which every step's kernel tensors are held
    to the layout contract (one host read a step) and the 4th step's are
    kept.  Returns (beams and flags by index, seconds, peak bytes
    (allocated, plus the engine's graph pool), launches, the kept
    arguments)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    WT.LAUNCHES = 0
    t0 = time.perf_counter()
    out = list(eng.run_stream(seqs))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = WT.LAUNCHES
    peak = torch.cuda.max_memory_allocated() + pool_bytes(eng)
    if sorted(i for i, _, _ in out) != list(range(len(seqs))):
        raise AssertionError("run_stream did not yield every sequence once")
    if launches == 0:
        raise AssertionError("the run never launched the wavefront kernel")
    step_args = capture_kernel_call(eng, seqs[: eng.B], every=WT.check_layout)
    by_index = {i: (beam, flag) for i, beam, flag in out}
    return by_index, secs, peak, launches, step_args


def _ckpt_list(name):
    with open(os.path.join(ARTIFACTS, name)) as fh:
        return [json.loads(line) for line in fh]


def _ckpt_rows(name):
    return {(r["name"], r["seq"]): r for r in _ckpt_list(name)}


# the committed -n 200 -ms 200 corpus: each checkpoint file and the
# buckets its sweep folded (the JAX engine's up to 256, its CPU engine's
# 512 and 1024, tools/fold_longtail.py's CPU folds of the 23S pair)
K200_TPU = "sweep_200n200_tpu.ckpt.jsonl"
K200_CPU = "sweep_200n200_cpu.ckpt.jsonl"
K200_LONG = "longtail_200n200.ckpt.jsonl"
K200_FILES = ((K200_TPU, (64, 128, 256)), (K200_CPU, (512, 1024)),
              (K200_LONG, (4096,)))
# the buckets --k200-full folds through sweep() itself, refold included
K200_SWEPT = (64, 128, 256)
# phase k200: (bucket, journal rows folded, committed sweep)
K200_ROWS = ((128, 16, K200_TPU), (256, 16, K200_TPU), (512, 8, K200_CPU),
             (1024, 4, K200_CPU))


def _k200_row(beam, committed, what, cpu_beam=None):
    """The rule for a fold at -n 200 -ms 200: its best row equals the
    committed sweep's row (struct, nrj) or, where it does not, its whole
    beam equals fold_cpu's (the committed sweeps hold rows that are
    artifacts of the run that wrote them).  cpu_beam is fold_cpu's beam
    where it was folded already.  Returns whether fold_cpu's beam was
    the one that held; raises where neither does."""
    beam = [tuple(b) for b in beam]
    if beam[0] == (committed["struct"], committed["nrj"]):
        return False
    if cpu_beam is None:
        cpu_beam = [(x.str_struct, x.energy) for x in fold_cpu.fold(
            committed["seq"], nb_mode=200, max_stack=200, max_branch=1000)]
    if beam != [tuple(b) for b in cpu_beam]:
        raise AssertionError(f"{what} differs from the committed sweep and "
                             f"from fold_cpu")
    return True


@phase
def phase_k200(rows_all):
    """-n 200 -ms 200 at full width: 3,200 beam rows at the 128 and 256
    buckets, 1,600 at 512, 800 at 1024."""
    launches, steps = {}, []
    for N, count, ckpt in K200_ROWS:
        t_bucket = time.perf_counter()
        rows = ([r for r in rows_all if len(r["seq"]) <= 120] if N == 128
                else bucket_rows(rows_all, N, count))[:count]
        want = _ckpt_rows(ckpt)
        nb = bucket_batch(16, N)
        eng = FoldEngine(bucket_config(N, 200, 200, 1000), B=nb, device="cuda")
        got, secs, peak, n_launch, step_args = _fold_once(
            eng, [r["seq"] for r in rows])
        flags, refolded, flagged_equal = [], [], 0
        for i, r in enumerate(rows):
            beam, flag = got[i]
            flags.append(flag)
            w = want[(r["name"], r["seq"])]
            if flag:
                # a sweep refolds it on the CPU; say whether it came out
                # right all the same
                flagged_equal += beam[0] == (w["struct"], w["nrj"])
                continue
            if _k200_row(beam, w, f"k200 N={N} row {i} ({r['name']})"):
                refolded.append(i)
        n_flagged = sum(map(bool, flags))
        causes = {}
        for f in flags:
            for bit, cause in FT.FLAG_NAMES.items():
                if f & bit:
                    causes[cause] = causes.get(cause, 0) + 1
        if N == 128 and n_flagged > len(rows) // 2:
            raise AssertionError(f"k200 N={N}: most rows flagged: {flags}")
        if N == 128 and causes.get("cplx_budget"):
            raise AssertionError(f"k200 N={N}: {causes['cplx_budget']} rows "
                                 f"overflowed the complex-candidate budget "
                                 f"CPLX={eng.cfg.CPLX}")
        log(f"[k200] N={N} B={nb} K=200 ({nb * 200} beam rows, CPLX="
            f"{eng.cfg.CPLX}): "
            f"{len(rows) - len(refolded) - n_flagged} unflagged best rows "
            f"equal {ckpt}, {len(refolded)} equal fold_cpu instead (rows "
            f"{refolded}); {n_flagged} flagged, of which {flagged_equal} give "
            f"the committed best row all the same; flags by cause {causes}; "
            f"{len(rows) / secs:.3f} seq/s ({secs:.3f} s for {len(rows)}, "
            f"graphed); peak {peak / 2**20:.1f} MiB; wavefront "
            f"launches {n_launch}")
        launches[N] = n_launch
        steps.append(_kernel_vs_bound("k200 step", step_args, N,
                                      real_step=True))
        del eng, got, step_args
        torch.cuda.empty_cache()
        log(f"[k200] N={N}: {time.perf_counter() - t_bucket:.2f} s for the "
            f"bucket (fold, checks and the kernel's comparison)")
    return launches, steps


# phase delta: the stream cells' step shapes (tag, bucket N, beam width,
# nb_mode, the band of journal rows); B = bucket_batch(16, N)
DELTA_CELLS = (("n100ms50", 128, 50, 100, (65, 128)),
               ("n200ms200", 128, 200, 200, (65, 128)),
               ("n100ms50-b512", 512, 50, 100, (257, 512)))


def _delta_vs_plain(args, what):
    """The delta kernel's four outputs equal the plain version's on every
    lane of `args` (candidate_delta's positional arguments).  Returns the
    lanes with a run and the unsupported ones."""
    got = DL.candidate_delta(*args)
    want = DL._candidate_delta(*args)
    torch.cuda.synchronize()
    for name, g, w in zip(DL.OUT_KEYS, got, want):
        if g.dtype != w.dtype or not torch.equal(g, w):
            bad = (g != w).nonzero()[:5].tolist()
            raise AssertionError(f"delta kernel: {name} differs ({what}) at "
                                 f"{bad}")
    return int(want[2].sum()), int((want[1] & want[2]).sum())


@phase
def phase_delta(rows_all):
    """The delta kernel (csrc/delta.cu) against its plain version on the
    first four steps of the first B journal rows of the band at each
    stream cell's shape (N=128, B=16; K=50, M=100 and K=200, M=200; N=512,
    B=8, K=50, M=100, R=24), every lane of all four outputs; the kernel,
    the plain version and the kernel's byte bound on the fourth step;
    then the whole -n 200 -ms 200 band (the 1,894 rows of
    65-128 nt of the committed K=200 sweep) through run_stream, graphed:
    no row flagged, every best row the committed one or the whole beam
    fold_cpu's."""
    dev = torch.device("cuda")
    out = _build.BUILD_LOG.get("delta", (0.0, "(cached)"))[1]
    ptxas = [line.strip() for line in out.splitlines()
             if "registers" in line or "spill" in line]
    for line in ptxas:
        log(f"[delta] ptxas: {line}")
    shapes = []
    for tag, N, K, nb_mode, (lo, hi) in DELTA_CELLS:
        cfg = bucket_config(N, nb_mode, K, 1000)
        eng = FoldEngine(cfg, B=bucket_batch(16, N), device=dev, graphs=False)
        seqs = [r["seq"] for r in rows_all if lo <= len(r["seq"]) <= hi]
        calls = step_calls("candidate_delta", eng, seqs[: eng.B], 4)
        runs = unsup = 0
        for i, args in enumerate(calls):
            h, u = _delta_vs_plain(args, f"{tag} step {i + 1}")
            runs, unsup = runs + h, unsup + u
        args = calls[-1]
        shape = tuple(args[9]["max_nb"].shape)
        ms = event_ms(lambda: DL.candidate_delta(*args), 200, queued=True)
        plain_ms = event_ms(lambda: DL._candidate_delta(*args), 5)
        work = DL.delta_work(shape, cfg.N, sum(
            getattr(eng.dp, k).numel() for k in ET.TABLES))
        bound = 1e3 * work["bytes"] / MEM_RATE
        log(f"[delta] {tag} {shape}: 4 steps, 4/4 outputs equal the plain "
            f"version on every lane ({runs} lanes with a run, {unsup} "
            f"unsupported); kernel {ms:.4f} ms/call, plain torch "
            f"{plain_ms:.3f} ms/call; {work['bytes'] / 1e6:.1f} MB, bound "
            f"{bound:.4f} ms by bytes: the kernel runs at {bound / ms:.1%} "
            f"of the bound's rate")
        shapes.append(dict(cell=tag, shape=list(shape), ms=ms,
                           plain_ms=plain_ms, bound_ms=bound,
                           bound_by="bytes", bytes=work["bytes"],
                           share_of_bound=bound / ms))
        del eng, calls, args
        torch.cuda.empty_cache()
    with open(K200_SWEEP) as fh:
        band = [r for r in map(json.loads, fh) if r["_bucket"] == 128]
    eng = FoldEngine(bucket_config(128, 200, 200, 1000), B=B, device=dev)
    list(eng.run_stream([r["seq"] for r in band[:B]]))     # capture, warm
    torch.cuda.synchronize()
    before = DL.LAUNCHES
    t0 = time.perf_counter()
    got = {i: (beam, flag) for i, beam, flag in
           eng.run_stream([r["seq"] for r in band])}
    secs = time.perf_counter() - t0
    launches = DL.LAUNCHES - before
    flagged = [i for i, (_, flag) in got.items() if flag]
    if flagged or len(got) != len(band) or launches == 0:
        raise AssertionError(f"delta: the K=200 band flagged {flagged}, "
                             f"folded {len(got)} of {len(band)}, delta "
                             f"launches {launches}")
    refolded = [i for i in range(len(band)) if _k200_row(
        got[i][0], band[i], f"K=200 band row {i}")]
    log(f"[delta] the K=200 band: {len(band)} rows through run_stream in "
        f"{secs:.3f} s ({len(band) / secs:.3f} seq/s, graphed), 0 flagged; "
        f"{len(band) - len(refolded)} best rows equal {os.path.basename(K200_SWEEP)}, "
        f"{len(refolded)} equal fold_cpu's whole beam instead (rows "
        f"{refolded}); delta launches {launches}")
    k200 = next(s for s in shapes if s["cell"] == "n200ms200")
    return dict(ms=k200["ms"], plain_ms=k200["plain_ms"],
                bound_ms=k200["bound_ms"], bound_by="bytes",
                library_ms=None, ptxas=ptxas, shapes=shapes,
                band=dict(rows=len(band), seconds=secs,
                          seq_per_s=len(band) / secs, refolded=refolded,
                          launches=launches))


def _enumerate_vs_plain(args, what):
    """The enumerate kernel's outputs equal the plain version's on every
    lane of `args` (enumerate_combos's positional arguments), every field
    of the seen set, the flags' inputs and the running beam, its unused
    rows included.  Returns the windows the lanes ran."""
    got, got_bm = EN.enumerate_combos(*args)
    want, want_bm = EN._enumerate_combos(*args)
    torch.cuda.synchronize()
    for name, g, w in ([(k, got[k], want[k]) for k in EN.OUT_KEYS]
                       + [(f"bm.{k}", got_bm[k], want_bm[k])
                          for k in EN.BM_KEYS]):
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
            bad = (g != w).nonzero()[:5].tolist() if g.shape == w.shape \
                else (g.shape, w.shape)
            raise AssertionError(f"enumerate kernel: {name} differs ({what}) "
                                 f"at {bad}")
    return want["windows"]


def _graphed_call(fn):
    """fn(), a call of a hand kernel's wrapper checked before, captured
    into a CUDA graph: returns the graph's replay, which runs the call's
    device work (the wrapper's own torch ops and the kernel) with none of
    its host time, as the fold step's graph runs it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


@phase
def phase_enumerate(rows_all):
    """The enumerate kernel (csrc/enumerate.cu) against its plain version
    on the first four steps of the first B journal rows of the band at
    each stream cell's shape (DELTA_CELLS) and at the api cell's
    (fold_one_config at -ms 20: B=1, V=2,000, S=4,096), every lane of
    every output; the kernel (the wrapper's call replayed as a CUDA
    graph: the seen set's sort and the kernel, as the step's graph runs
    them), the plain version and a byte bound (enumerate_work: the
    candidate entries the decoded slots reach and the seen set's passes)
    on the fourth step.  Then the main path's launches: 4 x B rows of the
    first shape's band through run_stream, graphed, counted from zero
    once its graphs are captured."""
    dev = torch.device("cuda")
    out = _build.BUILD_LOG.get("enumerate", (0.0, "(cached)"))[1]
    ptxas = [line.strip() for line in out.splitlines()
             if "registers" in line or "spill" in line]
    for line in ptxas:
        log(f"[enumerate] ptxas: {line}")
    cells = [(tag, bucket_config(N, nb_mode, K, 1000), bucket_batch(16, N),
              (lo, hi)) for tag, N, K, nb_mode, (lo, hi) in DELTA_CELLS]
    cells.append(("ms20traj-api", fold_one_config(128, 100, 20, 1000), 1,
                  (65, 128)))
    shapes = []
    for tag, cfg, batch, (lo, hi) in cells:
        eng = FoldEngine(cfg, B=batch, device=dev, graphs=False)
        seqs = [r["seq"] for r in rows_all if lo <= len(r["seq"]) <= hi]
        calls = step_calls("enumerate_combos", eng, seqs[: eng.B], 4)
        lane_windows = [_enumerate_vs_plain(args, f"{tag} step {i + 1}")
                        for i, args in enumerate(calls)]
        windows = [int(w.sum()) for w in lane_windows]
        args = calls[-1]
        shape = tuple(args[1].shape)
        ms = event_ms(_graphed_call(lambda: EN.enumerate_combos(*args)), 50,
                      queued=True)
        plain_ms = event_ms(lambda: EN._enumerate_combos(*args), 5)
        work = EN.enumerate_work(args[5], lane_windows[-1], cfg.V, cfg.S)
        bound = 1e3 * work["bytes"] / MEM_RATE
        log(f"[enumerate] {tag} {shape} V={cfg.V} W={cfg.W} S={cfg.S}: 4 "
            f"steps, every output equal to the plain version on every lane "
            f"(windows run a step: {windows} of {cfg.W * eng.B}); kernel "
            f"{ms:.4f} ms/call, plain torch {plain_ms:.3f} ms/call; "
            f"{work['bytes'] / 1e6:.1f} MB, bound {bound:.4f} ms by bytes: "
            f"the kernel runs at {bound / ms:.1%} of the bound's rate")
        shapes.append(dict(cell=tag, shape=list(shape), V=cfg.V, W=cfg.W,
                           S=cfg.S, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                           bound_by="bytes", bytes=work["bytes"],
                           share_of_bound=bound / ms, windows=windows))
        del eng, calls, args
        torch.cuda.empty_cache()
    tag, cfg, batch, (lo, hi) = cells[0]
    eng = FoldEngine(cfg, B=batch, device=dev)
    seqs = [r["seq"] for r in rows_all if lo <= len(r["seq"]) <= hi]
    seqs = seqs[: 4 * eng.B]
    list(eng.run_stream(seqs[: eng.B]))                  # capture, warm
    torch.cuda.synchronize()
    EN.LAUNCHES = 0
    got = list(eng.run_stream(seqs))
    torch.cuda.synchronize()
    launches = EN.LAUNCHES
    if sorted(i for i, _, _ in got) != list(range(len(seqs))) \
            or launches == 0:
        raise AssertionError(f"enumerate: run_stream yielded {len(got)} of "
                             f"{len(seqs)} rows and launched the kernel "
                             f"{launches} times")
    log(f"[enumerate] {tag}: {len(seqs)} rows through run_stream, graphed: "
        f"enumerate.launches {launches}")
    k50 = shapes[0]
    return dict(ms=k50["ms"], plain_ms=k50["plain_ms"],
                bound_ms=k50["bound_ms"], bound_by="bytes", library_ms=None,
                ptxas=ptxas, shapes=shapes,
                stream=dict(cell=tag, rows=len(seqs), launches=launches))


@phase
def phase_long(refs):
    """The 4096 and 2048 buckets at the sweep's configurations."""
    launches, steps = {}, []
    # ---- 4096: the two 23S rRNAs of the corpus
    rows = list(_ckpt_rows("longtail.ckpt.jsonl").values())
    eng = FoldEngine(bucket_config(4096, 100, 50, 1000),
                     B=bucket_batch(16, 4096), device="cuda")
    got, secs, peak, launches[4096], step_args = _fold_once(
        eng, [r["seq"] for r in rows])
    for i, r in enumerate(rows):
        beam, flag = got[i]
        if not flag and beam[0] != (r["struct"], r["nrj"]):
            raise AssertionError(f"{r['name']}: flag 0 but the best row "
                                 f"differs from longtail.ckpt.jsonl")
        log(f"[long] N=4096 {r['name']} ({len(r['seq'])} nt): flag {flag} "
            f"({FT.flag_names(flag)}); " + (
                "best row equals longtail.ckpt.jsonl" if not flag else
                f"best {beam[0][1]:.2f} kcal/mol on the card, "
                f"{r['nrj']:.2f} committed (CPU parity engine)"))
    log(f"[long] N=4096 B={eng.B}: {len(rows) / secs:.4f} seq/s ({secs:.3f} s "
        f"for {len(rows)}, {secs / launches[4096]:.3f} s a round, graphed); "
        f"peak {peak / 2**20:.1f} MiB; wavefront launches "
        f"{launches[4096]}")
    steps.append(_kernel_vs_bound("long step", step_args, 4096, reps=50,
                                  real_step=True))
    del eng, got, step_args
    torch.cuda.empty_cache()

    # ---- 2048: two seeded sequences of 1,100 to 2,000 nt
    seqs = [x["seq"] for x in refs["long"]]
    for x in refs["long"]:
        if seeded_sequence(x["seed"], x["nmin"], x["nmax"]) != x["seq"]:
            raise AssertionError(f"seed {x['seed']} gives another sequence")
    eng = FoldEngine(bucket_config(2048, 100, 50, 1000),
                     B=bucket_batch(16, 2048), device="cuda")
    got, secs, peak, launches[2048], step_args = _fold_once(eng, seqs)
    params, n_eval = get_params(37.0), 0
    for i, seq in enumerate(seqs):
        beam, flag = got[i]
        es = [e for _, e in beam]
        if es != sorted(es) or not beam:
            raise AssertionError(f"long seed row {i}: energies do not ascend")
        for db, e in beam:
            want = float(np.float32(eval_structure_int(seq, db, params) / 100.0))
            if len(db) != len(seq) or e != want:
                raise AssertionError(f"long seed row {i}: {e} on the card, "
                                     f"{want} by eval_structure_int")
            n_eval += 1
        log(f"[long] N=2048 seed {refs['long'][i]['seed']} ({len(seq)} nt): "
            f"{len(beam)} beam entries, best {es[0]:.2f} kcal/mol; flag "
            f"{flag} ({FT.flag_names(flag)})")
    log(f"[long] N=2048 B={eng.B}: {n_eval} beam energies equal "
        f"eval_structure_int, ascending; {len(seqs) / secs:.4f} seq/s "
        f"({secs:.3f} s for {len(seqs)}, {secs / launches[2048]:.3f} s a "
        f"round, graphed); peak {peak / 2**20:.1f} MiB; "
        f"wavefront launches {launches[2048]}")
    steps.append(_kernel_vs_bound("long step", step_args, 2048, reps=100,
                                  real_step=True))
    del eng, got, step_args
    torch.cuda.empty_cache()

    # ---- the same two at the cut configuration, against fold_cpu
    cut = refs["long"][0]["cut"]
    eng = FoldEngine(bucket_config(2048, cut["nb_mode"], cut["max_stack"],
                                   cut["max_branch"]),
                     B=bucket_batch(16, 2048), device="cuda")
    got, secs, _, launches["2048cut"], _ = _fold_once(eng, seqs)
    for i, x in enumerate(refs["long"]):
        t0 = time.perf_counter()
        cpu = [[s.str_struct, float(np.float32(s.energy))]
               for s in fold_cpu.fold(x["seq"], **cut)]
        beam, flag = got[i]
        if flag or [list(b) for b in beam] != cpu or cpu != x["beam"]:
            raise AssertionError(f"long seed {x['seed']} at the cut "
                                 f"configuration: flag {flag}, card == "
                                 f"fold_cpu {[list(b) for b in beam] == cpu}, "
                                 f"fold_cpu == committed {cpu == x['beam']}")
        log(f"[long] N=2048 seed {x['seed']} at -n {cut['nb_mode']} -ms "
            f"{cut['max_stack']} --max_branch {cut['max_branch']}: flag 0, "
            f"{len(beam)} beam entries equal fold_cpu "
            f"({time.perf_counter() - t0:.2f} s) and the committed beam")
    log(f"[long] N=2048 cut configuration: {secs:.3f} s for {len(seqs)}; "
        f"wavefront launches {launches['2048cut']}")
    return launches, steps


def _beam_rows(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def _journal_diff(rows, path):
    """Compare a written beams journal with the committed one.  Returns
    {row index: written row} for the rows that differ."""
    got = {r["name"] + r["seq"]: r for r in _beam_rows(path)}
    if len(got) != len(rows):
        raise AssertionError(f"{len(got)} beams-journal rows written for "
                             f"{len(rows)} sequences")
    diff = {}
    for i, r in enumerate(rows):
        g = got.get(r["name"] + r["seq"])
        if g is None:
            raise AssertionError(f"journal row {i} ({r['name']}) not written")
        if g != dict(r, flagged=_want_flag(r)):
            first = next((k for k, (a, b) in enumerate(zip(g["beam"], r["beam"]))
                          if a != b), min(len(g["beam"]), len(r["beam"])))
            log(f"[journal] row {i} ({r['name']}, {len(r['seq'])} nt) differs "
                f"from the journal: flags {g['flagged']} / {r['flagged']}, "
                f"first differing beam entry {first}")
            diff[i] = g
    return diff


def _journal_check(rows, path):
    diff = _journal_diff(rows, path)
    if diff:
        raise AssertionError(f"{len(diff)}/{len(rows)} beams-journal rows "
                             f"differ from the journal")
    return len(rows)


@phase
def phase_sweep(rows_all):
    rows = [r for r in rows_all if len(r["seq"]) <= 128][:16]
    records = [(r["seq"], "." * len(r["seq"]), r["name"]) for r in rows]
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        path = os.path.join(tmp, "beams.jsonl")
        WT.LAUNCHES = 0
        t0 = time.perf_counter()
        sweep(records, save_beams=path, device="cuda")
        secs = time.perf_counter() - t0
        launches = WT.LAUNCHES
        n = _journal_check(rows, path)
    if launches == 0:
        raise AssertionError("sweep() never launched the wavefront kernel")
    log(f"[sweep] {n}/{len(rows)} beams-journal rows equal the journal "
        f"({secs:.2f} s); wavefront launches {launches}")
    return launches


@phase
def phase_cli(refs):
    args = ["-s", refs["readme_seq"], *refs["cli"]["args"]]
    env = dict(os.environ, PYTHONPATH=ROOT)
    got = subprocess.run(
        [sys.executable, "-m", "rafft_tpu_torch.cli.fold_cli", "--device",
         "cuda", *args], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    if got.returncode != 0:
        raise AssertionError(f"the port's CLI failed:\n{got.stderr}")
    if got.stdout != refs["cli"]["stdout"]:
        raise AssertionError("the port's CLI output differs from the "
                             "reference CLI's")
    log(f"[cli] fold_cli --device cuda {' '.join(args[2:])}: "
        f"{len(got.stdout.splitlines())} lines equal the reference CLI's")
    # the tree-keeping engine touches no device: in this process
    nono = ["-s", refs["readme_seq"], *refs["cli_nono"]["args"]]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fold_cli.main(nono)
    if buf.getvalue() != refs["cli_nono"]["stdout"]:
        raise AssertionError("the port's CLI with --nono differs from the "
                             "reference CLI's")
    log(f"[cli] fold_cli {' '.join(nono[2:])}: "
        f"{len(buf.getvalue().splitlines())} lines equal the reference CLI's")


@phase
def phase_mfe(rows_all, refs):
    """The batched MFE DP on the card against the native DP (this
    process) and the committed rows of the JAX package's batched DP."""
    committed = {r["seq"]: (r["struct"], r["nrj"]) for r in refs["mfe"]["rows"]}
    held = 0
    MfeEngine(32, B=1, device="cuda").fold(["GGGAAACCC"])     # warm-up
    for N, count in MFE_ROWS.items():
        seqs = [r["seq"] for r in mfe_bucket_rows(rows_all, N, count)]
        nb = min(mfe_bucket_batch(16, N), len(seqs))
        eng = MfeEngine(N, B=nb, device="cuda")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        timing, got = {}, []
        t0 = time.perf_counter()
        for off in range(0, len(seqs), nb):
            got += eng.fold(seqs[off:off + nb], timing=timing)
        secs = time.perf_counter() - t0
        rise = torch.cuda.max_memory_allocated() - base
        t0 = time.perf_counter()
        want = [mfe_fold(s) for s in seqs]
        native = time.perf_counter() - t0
        bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
        if bad:
            raise AssertionError(f"mfe N={N}: rows {bad} differ from the "
                                 f"native DP")
        for s, res in zip(seqs, got):
            if s in committed:
                if res != committed[s]:
                    raise AssertionError(f"mfe N={N}: a row differs from the "
                                         f"committed JAX DP output")
                held += 1
        batches = -(-len(seqs) // nb)
        log(f"[mfe] N={N} B={nb}: {len(seqs)}/{len(seqs)} rows "
            f"({min(map(len, seqs))}-{max(map(len, seqs))} nt) equal the "
            f"native DP; {secs / batches:.3f} s per batch ({timing['fill'] / batches:.3f} "
            f"fill, {timing['host'] / batches:.3f} copies and tracebacks), "
            f"{len(seqs) / secs:.3f} seq/s; peak rise {rise / 2**20:.1f} MiB "
            f"(device peak {torch.cuda.max_memory_allocated() / 2**20:.1f} "
            f"MiB); native DP {native:.3f} s for the same rows")
        if N in (128, 1024):
            prof = mfe_profile(eng, seqs[:nb], diagonals=128)
            log(f"[mfe] N={N} profiled batch of {nb}, its first "
                f"{prof['steps']} diagonals: {prof['ops_per_diagonal']:.1f} "
                f"device ops per diagonal, {prof['f_ops_per_step']:.1f} per F "
                f"step; kernel {prof['kernel_ms']:.2f} ms, busy share "
                f"{100 * prof['kernel_ms'] / prof['wall_ms']:.1f}% of its "
                f"unprofiled wall ({prof['wall_ms']:.1f} ms)")
        del eng
        torch.cuda.empty_cache()
    readme = refs["readme_seq"]
    got = MfeEngine(128, B=1, device="cuda").fold([readme])[0]
    if got != committed[readme] or got != mfe_fold(readme):
        raise AssertionError("mfe: the README sequence differs")
    held += 1
    if held != len(committed):
        raise AssertionError(f"mfe: {held} of the {len(committed)} committed "
                             f"rows were folded")
    log(f"[mfe] {held}/{len(committed)} committed rows of the JAX DP equal")


def _same_kinetics(what, args, got, want):
    """Kinetics CLI outputs agree: the same lines, each structure with its
    energy, id and population as printed.  The lines are sorted by
    population, so those whose populations print the same (0.000 above
    all) may come in another order where another LAPACK rounds them
    differently, and a population of -0.000 prints for 0.000."""
    def parse(text):
        rows = [line.split() for line in text.splitlines()]
        return {int(r[3]): (r[0], float(r[1]), r[2]) for r in rows}, \
            [float(r[1]) for r in rows]
    (g, g_pops), (w, w_pops) = parse(got), parse(want)
    if g != w or g_pops != w_pops:
        diff = [(i, g.get(i), w[i]) for i in w if g.get(i) != w[i]][:5]
        raise AssertionError(f"kinetics {args} ({what}) differs from the "
                             f"committed JAX kinetics CLI output: "
                             f"{len(g)} / {len(w)} lines; (id, got, want): "
                             f"{diff}; populations in order equal: "
                             f"{g_pops == w_pops}")


def _rafft_text(seq, traj):
    """A trajectory as the fold CLI prints it with --traj."""
    lines = [seq]
    for si, step in enumerate(traj):
        lines.append("# {:-^20}".format(si))
        lines += [f"{s.str_struct} {s.energy:6.1f}" for s in step]
    return "\n".join(lines) + "\n"


@phase
def phase_api(refs):
    """fold, kinetics, the kinetics CLI and mfe_fold of the package root."""
    seq, refolds, texts = refs["readme_seq"], FT.REFOLDS, {}
    WT.LAUNCHES = 0
    for ms in (5, 20):
        t0 = time.perf_counter()
        final, traj = rafft_tpu_torch.fold(seq, 100, ms, 1000, traj=True,
                                           device="cuda")
        ref = refs["fold_one"][str(ms)]
        if [_rows(s) for s in traj] + [_rows(final)] != ref["traj"] + [ref["final"]]:
            raise AssertionError(f"fold ms={ms} differs from fold_cpu")
        texts[ms] = _rafft_text(seq, traj)
        log(f"[api] fold ms={ms} traj=True: {len(traj)} steps + final beam "
            f"equal the committed fold_cpu ones ({time.perf_counter() - t0:.2f} s)")
    launches = WT.LAUNCHES
    if launches == 0:
        raise AssertionError("fold never launched the wavefront kernel")
    log(f"[api] {FT.REFOLDS - refolds} of the 2 fold calls refolded on the "
        f"CPU; wavefront launches {launches}")
    if texts[20] != refs["cli"]["stdout"]:
        raise AssertionError("fold's -ms 20 trajectory differs from the "
                             "committed JAX CLI output")
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        path = os.path.join(tmp, "rafft.out")
        with open(path, "w") as fh:
            fh.write(texts[20])
        paths, _ = parse_rafft_output(path)
        for k in refs["kin"]:
            a = kin_cli.parse_arguments([path, *k["args"]])
            equi = rafft_tpu_torch.kinetics(paths, a.max_time, a.n_steps,
                                            method=a.method)[3]
            equi.sort(key=lambda el: el[2])
            text = "".join(f"{st} {pop:6.3f} {nrj:5.1f} {si:d}\n"
                           for st, nrj, pop, si in equi)
            cli = subprocess.run(
                [sys.executable, "-m", "rafft_tpu_torch.cli.kin_cli", path,
                 *k["args"]], cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                capture_output=True, text=True, timeout=300)
            if cli.returncode != 0:
                raise AssertionError(f"kin_cli failed:\n{cli.stderr}")
            for what, out in (("in process", text), ("kin_cli", cli.stdout)):
                _same_kinetics(what, k["args"], out, k["stdout"])
            log(f"[api] kinetics and kin_cli {' '.join(k['args'])}: "
                f"{len(equi)} lines equal the JAX kinetics CLI's (as text: "
                f"in process {text == k['stdout']}, CLI "
                f"{cli.stdout == k['stdout']})")
    for r in refs["mfe"]["rows"]:
        if mfe_fold(r["seq"]) != (r["struct"], r["nrj"]):
            raise AssertionError(f"mfe_fold differs on {r['name']}")
    log(f"[api] mfe_fold: {len(refs['mfe']['rows'])} committed rows equal")
    return launches


@phase
def phase_multi(rows_all, smi):
    """The scale-out layer on the one card: two workers and two processes
    share cuda:0.  Returns the wavefront launches of the dry run, the
    split sweep's workers and the launched processes."""
    pair = ["cuda:0", "cuda:0"]
    # (a) the dry run over two devices: every kernel call it makes (at
    # N=32, its own shapes) held to the plain version, its gathered state
    # to the dry run on the CPU; and no card is ever invented
    real, calls = FT.wavefront_tables, []

    def spy(*args, **kw):
        calls.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a
                           for a in args))
        return real(*args, **kw)

    FT.wavefront_tables = spy
    WT.LAUNCHES = 0
    try:
        got = dryrun.dryrun_multichip(2, devices=pair)
    finally:
        FT.wavefront_tables = real
    launches = dict(dryrun=WT.LAUNCHES)
    for i, args in enumerate(calls):
        WT.check_layout(*args)
        _tables_equal(args, f"dry run call {i}")
    want = dryrun.dryrun_multichip(2, devices=["cpu", "cpu"])
    for field in dryrun.FIELDS:
        if not torch.equal(got[field].cpu(), want[field]):
            raise AssertionError(f"the dry run on {pair} differs from the "
                                 f"dry run on the CPU in {field}")
    log(f"[multi] dry run: {len(calls)} kernel calls "
        f"{sorted({tuple(a[2].shape) for a in calls})} keep the layout "
        f"contract and give the plain version's 7 tables; pt/energy/active/"
        f"done equal the dry run on the CPU")
    count = torch.cuda.device_count()
    try:
        mesh.data_devices(count + 1)
    except RuntimeError as e:
        log(f"[multi] data_devices({count + 1}) raises: {e}")
    else:
        raise AssertionError(f"data_devices({count + 1}) did not raise")
    # (b) the split sweep against the journal and the one-device sweep
    rows = ([r for r in rows_all if len(r["seq"]) <= 128][:32]
            + [r for r in rows_all if 128 < len(r["seq"]) <= 256][:8])
    # the last beam entry stands in for the true structure: scores that
    # are not all 100
    records = [(r["seq"], r["beam"][-1][0], r["name"]) for r in rows]
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        res, stats = {}, {}
        for tag, kw in (("two", dict(devices=pair)), ("one", dict(device="cuda"))):
            path = os.path.join(tmp, f"{tag}.beams.jsonl")
            stats[tag] = {}
            t0 = time.perf_counter()
            res[tag] = sweep(records, save_beams=path, stats=stats[tag], **kw)
            secs = time.perf_counter() - t0
            n = _journal_check(rows, path)
            log(f"[multi] sweep({tag} device{'s' if tag == 'two' else ''}): "
                f"{n}/{len(rows)} beams-journal rows equal the journal "
                f"({secs:.2f} s); per device {stats[tag]['devices']}")
        if res["two"] != res["one"]:
            raise AssertionError("the two-worker sweep's results differ from "
                                 "the one-device sweep's")
        workers = stats["two"]["devices"]
        if not all(w["launches"] > 0 for w in workers):
            raise AssertionError(f"a worker never launched the wavefront "
                                 f"kernel: {workers}")
        launches["sweep"] = sum(w["launches"] for w in workers)
        # (c) two gloo processes sharing cuda:0 against the one-process CLI
        src = os.path.join(tmp, "bench.csv")
        with open(src, "w", newline="") as fh:
            csv.writer(fh).writerows(records)
        one_csv, two_csv = (os.path.join(tmp, f"{t}.csv") for t in ("one", "two"))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            TS.main(["--csv", src, "--out", one_csv, "--device", "cuda"])
        one_means = buf.getvalue().strip().splitlines()[-1].split("mean PPV ")[1]
        t0 = time.perf_counter()
        # a session of its own: on a timeout the launcher and both of its
        # processes are stopped together
        proc = subprocess.Popen(
            [sys.executable, "-m", "rafft_tpu_torch.parallel.launch",
             "--num_processes", "2", "--device", "cuda", "--",
             "--csv", src, "--out", two_csv], cwd=ROOT, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            start_new_session=True, env=dict(os.environ, PYTHONPATH=ROOT))
        try:
            out, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
            raise AssertionError("launch did not finish in 300 s")
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"launch failed ({proc.returncode}):\n"
                                 f"{err[-3000:]}")
        with open(one_csv) as fh:
            head, *body = fh.readlines()
        with open(two_csv) as fh:
            merged = fh.readlines()
        if merged != [head, *body[0::2], *body[1::2]]:
            raise AssertionError("the merged CSV of two processes differs from "
                                 "the one-process CLI's rows")
        summary = [ln for ln in out.splitlines() if "merged" in ln]
        if summary != [f"{len(body)} sequences merged; global mean PPV "
                       f"{one_means}"]:
            raise AssertionError(f"global means {summary} differ from the one "
                                 f"process's: mean PPV {one_means}")
        parts = []
        for p in range(2):
            with open(f"{two_csv}.part{p}.manifest.json") as fh:
                parts.append(json.load(fh)["devices"])
        if not all(d["launches"] > 0 for part in parts for d in part):
            raise AssertionError(f"a process never launched the wavefront "
                                 f"kernel: {parts}")
        launches["launch"] = sum(d["launches"] for part in parts for d in part)
        log(f"[multi] launch of 2 gloo processes on cuda:0: {len(body)} merged "
            f"rows equal the one-process CLI's in part order, {summary[0]!r} "
            f"({secs:.2f} s); per process {parts}")
    # (d) seq/s on the headline rows: one worker process at B=16 against
    # the sweep's split over two sharing cuda:0 at B=8 each (the same
    # lanes)
    head = [r for r in rows_all if len(r["seq"]) <= 120][:64]
    seqs = [r["seq"] for r in head]
    ctx = multiprocessing.get_context("spawn")
    with contextlib.ExitStack() as stack:
        pools = [stack.enter_context(concurrent.futures.ProcessPoolExecutor(
            1, mp_context=ctx)) for _ in pair]
        threads = torch.get_num_threads()      # what the sweep gives a worker
        task = lambda B, share: (HEADLINE, B, "cuda:0", share, threads)

        def one():
            out, _ = pools[0].submit(TS._fold_share, task(16, seqs)).result()
            return {i: (rows, flag) for i, rows, flag in out}

        def two():                             # the sweep's own split
            per_device = [dict(device=d, rows=0, launches=0) for d in pair]
            return {i: (rows, flag) for i, rows, flag in TS._bucket_stream(
                HEADLINE, 16, seqs, pair, pools, per_device)}

        for pool in pools:                        # warm-up: contexts, kernel
            pool.submit(TS._fold_share, task(8, seqs[:16])).result()
        secs, folds = {"one": [], "two": []}, {}
        for tag in ("one", "two", "two", "one", "one", "two"):
            t0 = time.perf_counter()
            folds[tag] = (one if tag == "one" else two)()
            secs[tag].append(time.perf_counter() - t0)
    want = {i: ([(db, float(e)) for db, e in r["beam"]], 0)
            for i, r in enumerate(head)}
    for tag, got in folds.items():
        if got != want:
            raise AssertionError(f"the timed {tag}-process folds differ from "
                                 f"the journal")
    med = {t: len(seqs) / float(np.median(v)) for t, v in secs.items()}
    log(f"[multi] headline rows ({len(seqs)}, <= 120 nt) on {smi}: one process "
        f"B=16 {med['one']:.3f} seq/s, two processes sharing cuda:0 B=8 each "
        f"{med['two']:.3f} seq/s (medians of {len(secs['one'])} passes each, "
        f"alternated; seconds one {[round(x, 3) for x in secs['one']]}, two "
        f"{[round(x, 3) for x in secs['two']]}); two / one "
        f"{med['two'] / med['one']:.3f}")
    log(f"[multi] wavefront launches: {launches}")
    return sum(launches.values())


def _bench_check(what, folded, want):
    """Every (seq, rows, flagged) of a bench cell against `want`: seq ->
    (beam, flag), the journal's, or the committed oracle's where the
    journal holds a TPU-run artifact.  Unflagged folds must give the beam,
    structures and energies in order, with flag 0; flagged rows carry
    their flag bits only (their beams come from the CPU refold).  Returns
    the counts held to the oracle and to flags only."""
    bad, n_oracle, n_flagged = [], 0, 0
    for i, (seq, rows, flag) in enumerate(folded):
        beam, jflag, oracle = want[seq]
        if jflag:
            n_flagged += 1
            if flag != jflag:
                bad.append((i, len(seq), flag, jflag))
        elif flag != 0 or rows != beam:
            bad.append((i, len(seq), flag, 0))
        n_oracle += oracle
    if bad:
        raise AssertionError(f"bench {what}: {len(bad)}/{len(folded)} folds "
                             f"differ (index in the cell, length, flag, "
                             f"journal flag): {bad[:8]}")
    return n_oracle, n_flagged


@phase
def phase_bench(rows_all, refs):
    """tools/bench.py's run at 3 passes a cell, then bench_full's batch
    scan, every fold held to the journal; the kernel on one real step of
    each B of the scan.  Returns the launches of both and the steps."""
    want = {r["seq"]: ([(db, float(e)) for db, e in r["beam"]],
                       _want_flag(r), False) for r in rows_all}
    for o in refs["oracle"]:
        want[o["seq"]] = ([tuple(x) for x in o["beam"]], 0, True)
    folds = {}
    WT.LAUNCHES = 0
    line = bench.run(device="cuda", passes=3, folds=folds)
    launches = WT.LAUNCHES
    if launches == 0:
        raise AssertionError("the bench never launched the wavefront kernel")
    for cell, folded in folds.items():
        n_oracle, n_flagged = _bench_check(cell, folded, want)
        log(f"[bench] {cell}: {len(folded)}/{len(folded)} folds equal the "
            f"journal ({n_oracle} the oracle, {n_flagged} flagged held to "
            f"their flags)")
    if (line["corpus_covered"] != len(rows_all)
            or line["device"] != torch.cuda.get_device_name(0)):
        raise AssertionError(f"bench line: covered {line['corpus_covered']}, "
                             f"device {line['device']}")
    log(f"[bench] wavefront launches {launches}")
    log("bench: " + json.dumps(line))

    seqs = [seq for seq, _rows, _flag in folds["headline"]]
    scan_folds = {}
    WT.LAUNCHES = 0
    scan = bench_full.batch_scan(seqs, "cuda", folds=scan_folds)
    scan_launches = WT.LAUNCHES
    if scan_launches == 0:
        raise AssertionError("the scan never launched the wavefront kernel")
    steps = []
    for r in scan:
        _bench_check(f"scan B={r['B']}", scan_folds[r["B"]], want)
        log(f"[bench] scan B={r['B']}: {r['n']}/{r['n']} folds equal the "
            f"journal; {r['seq_s']:.3f} seq/s ({r['secs']:.3f} s); peak "
            f"{r['peak_mib']:.1f} MiB")
        args = capture_kernel_call(bench.engine(bench.HEADLINE_N, "cuda",
                                                r["B"]),
                                   seqs[:r["B"]], every=WT.check_layout)
        steps.append(_kernel_vs_bound(f"scan step B={r['B']}", args,
                                      bench.HEADLINE_N, real_step=True))
    log(f"[bench] scan wavefront launches {scan_launches}")
    return {"": launches, "_scan": scan_launches}, steps


# the sweep's buckets in the committed K=200 manifest's argv
K200_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096)


def _tables(rows, N):
    """codes, pair tables and lengths [B, N] of (seq, db) rows."""
    codes = np.zeros((len(rows), N), np.int32)
    pt = np.full((len(rows), N), -1, np.int32)
    n = np.zeros(len(rows), np.int32)
    for b, (seq, db) in enumerate(rows):
        codes[b, :len(seq)] = encode_sequence(seq)
        pt[b, :len(seq)] = pair_table(db)
        n[b] = len(seq)
    return codes, pt, n


@phase
def phase_tools(rows_all):
    """The evaluators' host APIs, the fold engine's exactness tools and
    the sweep's 64 bucket at -n 200 -ms 200 on the card.  Returns the
    wavefront launches of each path that folds and the kernel records of
    the new shapes."""
    launches, steps = {}, []
    ref = reference_order()
    in_journal = {(r["seq"], r["name"]): r for r in rows_all}
    # ---- eval_batch: every beam entry of the first 64 headline rows
    head = [r for r in rows_all if len(r["seq"]) <= 120][:64]
    entries = [(r["seq"], db, e) for r in head for db, e in r["beam"]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = ET.eval_batch(*_tables([x[:2] for x in entries], 128), device="cuda")
    secs = time.perf_counter() - t0
    want = np.array([round(e * 100) for _s, _db, e in entries], np.int32)
    if not np.array_equal(got, want):
        raise AssertionError(f"eval_batch differs from the journal on "
                             f"{int((got != want).sum())} beam entries")
    log(f"[tools] eval_batch [{len(entries)}, 128] on the card: every "
        f"energy equals the journal's ({secs:.3f} s, the tables' upload "
        f"included)")
    # ---- eval_pt_scan: the two 23S rRNAs' committed structures at N=4096
    lt = list(_ckpt_rows("longtail.ckpt.jsonl").values())
    codes, pt, n = (torch.as_tensor(x, device="cuda") for x in _tables(
        [(r["seq"], r["struct"]) for r in lt], 4096))
    dp = ET.device_params(37.0, 4096, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = ET.eval_pt_scan(dp, codes, pt, n).tolist()
    secs = time.perf_counter() - t0
    want = [eval_structure_int(r["seq"], r["struct"]) for r in lt]
    if got != want or want != [round(r["nrj"] * 100) for r in lt]:
        raise AssertionError(f"eval_pt_scan {got}, eval_structure_int {want}")
    log(f"[tools] eval_pt_scan [2, 4096] on the card: {got} equal "
        f"eval_structure_int and longtail.ckpt.jsonl ({secs:.3f} s for the "
        f"4,096-position walk)")

    # ---- debug_seq: row 7 of <= 120 nt, reference order
    seq7 = debug_seq.pick_sequence(7)
    t0 = time.perf_counter()
    want = debug_seq.cpu_trajectory(seq7, **debug_seq.CPU_ARGS)
    cpu_secs = time.perf_counter() - t0
    WT.LAUNCHES = 0
    t0 = time.perf_counter()
    d = debug_seq.first_divergence(
        FoldEngine(debug_seq.CONFIG, B=1, device="cuda"), seq7, want)
    secs = time.perf_counter() - t0
    launches["_debug_seq"] = WT.LAUNCHES
    if d.step is not None:
        raise AssertionError("debug_seq row 7:\n" + "\n".join(
            debug_seq.report(d)))
    log(f"[tools] debug_seq row 7 ({len(seq7)} nt): "
        f"{debug_seq.report(d)[0]} over {d.steps} steps and the final beam "
        f"({secs:.2f} s; fold_cpu's trajectory {cpu_secs:.2f} s); wavefront "
        f"launches {WT.LAUNCHES}")

    # ---- debug_delta: row 7 under its journal best structure (N=128), and
    # the first row of <= 32 nt under its journal best structure (N=32)
    name7 = next(nm for s, _t, nm in ref if s == seq7)
    s32, _t, name32 = next(r for r in ref if len(r[0]) <= 32)
    cases = [(seq7, in_journal[(seq7, name7)]["beam"][0][0], name7),
             (s32, in_journal[(s32, name32)]["beam"][0][0], name32)]
    real, calls = FT.wavefront_tables, []

    def spy(*args, **kw):
        calls.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a
                           for a in args))
        return real(*args, **kw)

    FT.wavefront_tables = spy
    WT.LAUNCHES = 0
    try:
        for seq, parent, name in cases:
            rows = debug_delta.candidates_for(seq, parent, device="cuda")
            bad = [r for r in rows if not r["ok"] and not r["unsup"]]
            if bad or not rows:
                raise AssertionError(f"debug_delta {name}:\n" + "\n".join(
                    debug_delta.summary(rows)))
            log(f"[tools] debug_delta {name} ({len(seq)} nt, N="
                f"{calls[-1][2].shape[-1]}): {debug_delta.summary(rows)[0]}")
    finally:
        FT.wavefront_tables = real
    launches["_debug_delta"] = WT.LAUNCHES
    for args in calls:
        WT.check_layout(*args)
        _tables_equal(args, f"debug_delta, N={args[2].shape[-1]}")
    log(f"[tools] debug_delta: {len(calls)} kernel calls "
        f"{[tuple(a[2].shape) for a in calls]} keep the layout contract and "
        f"give the plain version's 7 whole tables")
    steps.append(_kernel_vs_bound("debug_delta step", calls[1], 32,
                                  real_step=True))

    # ---- perfcheck at NSEQ=16, B=16
    WT.LAUNCHES = 0
    pc = perfcheck.run(short_rows(ref), nseq=16, B=16, device="cuda",
                       log=lambda m: log(f"[tools] perfcheck: {m}"))
    launches["_perfcheck"] = WT.LAUNCHES
    if pc["parity"] != (16, 16):
        raise AssertionError(f"perfcheck parity {pc['parity']}")
    log(f"[tools] perfcheck: wavefront launches {WT.LAUNCHES}")

    # ---- the sweep's 64 bucket at -n 200 -ms 200, flagged rows refolded
    rows64 = sorted((r for r in _ckpt_rows(
        "sweep_200n200_tpu.ckpt.jsonl").values() if r["_bucket"] == 64),
        key=lambda r: r["_idx"])
    records = [(r["seq"], "." * len(r["seq"]), r["name"]) for r in rows64]
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    stats = {}
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        path = os.path.join(tmp, "beams.jsonl")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        WT.LAUNCHES = 0
        t0 = time.perf_counter()
        res = sweep(records, nb_mode=200, max_stack=200, max_branch=1000,
                    buckets=K200_BUCKETS, save_beams=path, stats=stats,
                    device="cuda")
        secs = time.perf_counter() - t0
        launches["_sweep64"] = WT.LAUNCHES
        peak = torch.cuda.max_memory_allocated()
        saved = {(b["name"], b["seq"]): b for b in _beam_rows(path)}
    n_cpu, flags = 0, []
    for i, (r, out) in enumerate(zip(rows64, res)):
        b = saved[(r["name"], r["seq"])]
        if (out["struct"], out["nrj"]) != tuple(b["beam"][0]):
            raise AssertionError(f"64 bucket row {i}: result and saved beam "
                                 f"differ")
        n_cpu += _k200_row(b["beam"], r, f"64 bucket row {i} ({r['name']})")
        flags.append(b["flagged"])
    if list(stats["buckets"]) != ["64"] or launches["_sweep64"] == 0:
        raise AssertionError(f"the 64 bucket did not fold on the card: "
                             f"{stats}")
    log(f"[tools] sweep() 64 bucket at -n 200 -ms 200 (bucket_config(64, 200,"
        f" 200, 1000), B={bucket_batch(16, 64)}): {len(rows64) - n_cpu}/"
        f"{len(rows64)} rows equal sweep_200n200_tpu.ckpt.jsonl, {n_cpu} "
        f"equal fold_cpu's beam instead; {stats['n_fallback']} flagged and "
        f"refolded on the CPU, by cause {stats['flag_causes']} (row flags "
        f"{[FT.flag_names(f) for f in flags if f]}); "
        f"{len(rows64) / secs:.3f} seq/s ({secs:.3f} s, the refold "
        f"included); peak allocated {peak / 2**20:.1f} MiB (the sweep's "
        f"graph pool not counted); wavefront launches "
        f"{launches['_sweep64']}")
    # every call of the same fold, held to the plain version's tables
    eng = FoldEngine(bucket_config(64, 200, 200, 1000),
                     B=bucket_batch(16, 64), device="cuda")
    held = []

    def every(*args):
        WT.check_layout(*args)
        _tables_equal(args, f"64 bucket call {len(held)}")
        held.append(tuple(args[2].shape))

    step_args = capture_kernel_call(eng, [r["seq"] for r in rows64],
                                    every=every)
    log(f"[tools] the 64 bucket's fold: {len(held)} kernel calls "
        f"{sorted(set(held))} keep the layout contract and give the plain "
        f"version's 7 whole tables")
    steps.append(_kernel_vs_bound("sweep64 step", step_args, 64,
                                  real_step=True))
    return launches, steps


# phase graph: journal rows folded per bucket (beside its flagged rows);
# the journal's rows of <= 32 and 33-64 nt (6 and 38) came from the 128
# bucket, and fold alike at N=32 and 64 (every lag of their regions fits M)
GRAPH_ROWS = {128: 32, 256: 32, 512: 16, 1024: 4}
GRAPH_SHORT = {32: (0, 16), 64: (32, 16)}


@phase
def phase_graph(rows_all):
    """The fold engine's CUDA graphs: folds against the journal, the eager
    and the graphed state in lock-step, no host wait in a replay, and the
    graph against the eager step in numbers (module note, phase 12)."""
    launches = {}
    G = GRAPH_G
    head = [r for r in rows_all if len(r["seq"]) <= 120]
    cells = [("headline", HEADLINE, B, head[:64])] + [
        (str(N), bucket_config(N, 100, 50, 1000), bucket_batch(16, N),
         [r for r in rows_all if lo < len(r["seq"]) <= N][:count])
        for N, (lo, count) in GRAPH_SHORT.items()] + [
        (str(N), bucket_config(N, 100, 50, 1000), bucket_batch(16, N),
         bucket_rows(rows_all, N, count)) for N, count in GRAPH_ROWS.items()]
    for tag, cfg, nb, rows in cells:
        eng = FoldEngine(cfg, B=nb, device="cuda")
        if not eng.graphs:
            raise AssertionError("FoldEngine on a card does not default to "
                                 "graphs")
        torch.cuda.synchronize()
        WT.LAUNCHES = 0
        t0 = time.perf_counter()
        out = list(eng.run_stream([r["seq"] for r in rows]))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        _stream_check(rows, out)
        launches[tag] = WT.LAUNCHES
        if launches[tag] == 0 or list(eng._graphs) != [("_advance", G)]:
            raise AssertionError(f"graph {tag}: the fold did not replay one "
                                 f"graph of G={G} rounds: {list(eng._graphs)},"
                                 f" {launches[tag]} launches")
        flags = [_want_flag(r) for r in rows if _want_flag(r)]
        log(f"[graph] {tag} (N={cfg.N}, B={nb}): {len(rows) - len(flags)} "
            f"rows equal the journal with flag 0, flagged rows carry {flags}; "
            f"{len(rows) / secs:.3f} seq/s ({secs:.3f} s, one graph of {G} "
            f"rounds replayed, its capture included); wavefront launches "
            f"{launches[tag]}")
        del eng
    # the eager and the graphed engine in lock-step on one batch with
    # shadow sequences
    seqs = [r["seq"] for r in head[: 2 * B]]
    eager = FoldEngine(HEADLINE, B=B, device="cuda", graphs=False)
    graph = FoldEngine(HEADLINE, B=B, device="cuda")
    sts = []
    for eng in (eager, graph):
        st = eng.init_state(seqs[:B], seqids=list(range(B)))
        codes, n = eng._encode(seqs[B:], B)
        sts.append(eng._drain_load(
            st, *(torch.as_tensor(x, device="cuda") for x in (
                np.zeros(B, bool), np.ones(B, bool), codes, n,
                np.arange(B, 2 * B, dtype=np.int32)))))
    st_e, st_g = sts
    calls = 0
    while True:
        st_e = eager._advance(st_e, G)
        st_g = graph._advance_graphed(st_g, G)
        calls += 1
        diff = [k for k in st_e if not torch.equal(st_e[k], st_g[k])]
        if diff:
            raise AssertionError(f"graph: after call {calls} of {G} rounds "
                                 f"the graphed state differs in {diff}")
        if not bool(eager._runnable(st_e).any()) or calls == 16:
            break
    banked = int(st_e["out_valid"].sum())
    # a replay under the sync debug mode: any call that waits for the
    # device raises (the static state is passed back, so nothing is copied)
    torch.cuda.set_sync_debug_mode("error")
    try:
        graph._advance_graphed(st_g, G)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log(f"[graph] lock-step at the headline configuration, B={B} with {B} "
        f"shadows: eager and graphed states equal in every key after each "
        f"of {calls} calls of {G} rounds ({banked} folds banked); a replay "
        f"ran under set_sync_debug_mode('error') without a synchronising "
        f"call")
    rec = graph_cell(rows_all, 128, 50, passes=2, G=G)
    if rec["syncs_in_call"]["graph"] != 0:
        raise AssertionError(f"a graph replay waited for the device: {rec}")
    log(f"[graph] headline: ops/step eager {rec['ops_per_step']['eager']:.0f}"
        f", graph {rec['ops_per_step']['graph']:.0f}; ms/step eager "
        f"{rec['median_ms_per_step']['eager']:.3f}, graph "
        f"{rec['median_ms_per_step']['graph']:.3f}; host syncs in a replay "
        f"{rec['syncs_in_call']['graph']} (eager call "
        f"{rec['syncs_in_call']['eager']})")
    return launches, []


def _bucket_marks():
    """A sweep() progress callback that keeps, per bucket, the end of its
    stream, its end, and the peak and wavefront launches since the last
    bucket ended (both set to 0 there)."""
    marks, start = {}, [time.perf_counter()]

    def progress(N, done_n, total, done=False, secs=None):
        now = time.perf_counter()
        m = marks.setdefault(N, {})
        if not done:
            m["stream_end"] = now
            return
        m.update(end=now, start=start[0],
                 peak=torch.cuda.max_memory_allocated(), launches=WT.LAUNCHES)
        start[0] = now
        torch.cuda.reset_peak_memory_stats()
        WT.LAUNCHES = 0

    return marks, progress


@phase
def phase_full(rows_all, refs):
    """sweep() over the whole journal, flagged folds refolded on the CPU."""
    records = [(r["seq"], "." * len(r["seq"]), r["name"]) for r in rows_all]
    marks, progress = _bucket_marks()
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    stats = {}
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        path = os.path.join(tmp, "beams.jsonl")
        torch.cuda.reset_peak_memory_stats()
        WT.LAUNCHES = 0
        t0 = time.perf_counter()
        sweep(records, save_beams=path, stats=stats, progress=progress,
              device="cuda")
        secs = time.perf_counter() - t0
        diff = _journal_diff(rows_all, path)
    for N, m in sorted(marks.items()):
        b = stats["buckets"][str(N)]
        stream = m["stream_end"] - m["start"]
        log(f"[full] bucket {N}: {b['n']} seqs, B={b['batch']}; stats "
            f"{b['n'] / b['secs']:.3f} seq/s ({b['secs']} s); stream "
            f"{stream:.3f} s; refold and write {m['end'] - m['stream_end']:.3f} "
            f"s; peak {m['peak'] / 2**20:.1f} MiB; wavefront launches "
            f"{m['launches']}")
        if m["launches"] == 0:
            raise AssertionError(f"bucket {N} never launched the kernel")
    refold = sum(m["end"] - m["stream_end"] for m in marks.values())
    log(f"[full] {len(rows_all)} sequences in {secs:.3f} s "
        f"({len(rows_all) / secs:.3f} seq/s); refolded {stats['n_fallback']} "
        f"on the CPU ({stats['flag_causes']}) in {refold:.3f} s of refold and "
        f"write; refold evaluator: {stats.get('refold_evaluator')}")
    if stats.get("refold_evaluator") != "native":
        raise AssertionError("the CPU refold did not run the native evaluator")
    # a row that differs from the journal must equal the sequential CPU
    # parity oracle, which defines the reference semantics
    oracle = {o["row"]: o for o in refs["oracle"]}
    wrong = [i for i in diff if i not in oracle
             or oracle[i]["name"] != rows_all[i]["name"]
             or diff[i]["beam"] != oracle[i]["beam"]]
    if wrong:
        raise AssertionError(f"rows {wrong} differ from both the journal and "
                             f"the CPU parity oracle")
    log(f"[full] {len(rows_all) - len(diff)}/{len(rows_all)} beams-journal "
        f"rows equal the journal; the other {len(diff)} (rows {sorted(diff)}) "
        f"equal the CPU parity oracle fold_cpu")


@phase
def phase_full_long():
    """sweep() over the two 23S rRNAs: the 4096 bucket with the CPU refold
    of what the engine flags, against longtail.ckpt.jsonl."""
    want = list(_ckpt_rows("longtail.ckpt.jsonl").values())
    records = [(r["seq"], "." * len(r["seq"]), r["name"]) for r in want]
    stats = {}
    WT.LAUNCHES = 0
    t0 = time.perf_counter()
    res = sweep(records, stats=stats, device="cuda")
    secs = time.perf_counter() - t0
    if WT.LAUNCHES == 0:
        raise AssertionError("the 4096 bucket never launched the kernel")
    for r, w in zip(res, want):
        if (r["struct"], r["nrj"], r["nbp"]) != (w["struct"], w["nrj"],
                                                  w["nbp"]):
            raise AssertionError(f"{w['name']}: sweep() differs from "
                                 f"longtail.ckpt.jsonl")
    log(f"[full] 23S pair through sweep(): {len(res)}/{len(want)} rows equal "
        f"longtail.ckpt.jsonl; {secs:.1f} s, {stats['n_fallback']} refolded on "
        f"the CPU ({stats['flag_causes']}, evaluator "
        f"{stats.get('refold_evaluator')}); wavefront launches {WT.LAUNCHES}")


@phase
def phase_full_mfe(rows_all):
    """The MFE DP over the whole journal, then the two 23S rRNAs, against
    the native DP in a process pool."""
    ctx = __import__("multiprocessing").get_context("forkserver")
    long = list(_ckpt_rows("longtail.ckpt.jsonl").values())
    for what, rows in (("journal", rows_all), ("23S pair", long)):
        records = [(r["seq"], "", r["name"]) for r in rows]
        seqs = [r["seq"] for r in rows]
        # the native DP first, so that its processes do not slow the
        # host thread that drives the card
        t0 = time.perf_counter()
        with concurrent.futures.ProcessPoolExecutor(
                os.cpu_count(), mp_context=ctx) as pool:
            want = list(pool.map(mfe_fold, seqs, chunksize=8))
        pool_secs = time.perf_counter() - t0
        stats = {}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = mfe_records(records, "torch", 16, "cuda", stats=stats)
        secs = time.perf_counter() - t0
        bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
        if bad or len(got) != len(rows):
            raise AssertionError(f"mfe {what}: rows {bad[:8]} differ from the "
                                 f"native DP")
        for N, st in sorted(stats.items()):
            log(f"[full] mfe N={N}: {st['n']} rows, B={st['batch']}, "
                f"{st['batches']} batches in {st['secs']:.3f} s "
                f"({st['n'] / st['secs']:.3f} seq/s)")
        log(f"[full] mfe {what}: {len(rows)}/{len(rows)} rows equal the native "
            f"DP; {secs:.3f} s on the card ({len(rows) / secs:.3f} seq/s), "
            f"peak {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; the "
            f"native DP in a pool of {os.cpu_count()} processes: "
            f"{pool_secs:.3f} s")


def k200_plan():
    """The committed -n 200 -ms 200 corpus by bucket: {N: [committed row,
    ...]} in `_idx` order, each row tagged with its file (`_file`): the
    rows of every K200_FILES file in the bucket its sweep folded them at.
    Raises where a row's length or `_bucket` puts it in another bucket,
    or where a (name, seq) comes twice."""
    plan, seen = {}, set()
    for name, buckets in K200_FILES:
        for r in _ckpt_list(name):
            key, N = (r["name"], r["seq"]), r["_bucket"]
            if key in seen:
                raise AssertionError(f"{name}: {r['name']} comes twice")
            if N not in buckets or TS.bucket_of(len(r["seq"]),
                                                K200_BUCKETS) != N:
                raise AssertionError(f"{name}: {r['name']} "
                                     f"({len(r['seq'])} nt) in bucket {N}")
            seen.add(key)
            plan.setdefault(N, []).append(dict(r, _file=name))
    for rows in plan.values():
        rows.sort(key=lambda r: r["_idx"])
    return dict(sorted(plan.items()))


def _refold_timed(task):
    """Pool worker of --k200-full's stage 2: the sweep's refold of one
    row (fold_cpu, native evaluator) and its seconds."""
    t0 = time.perf_counter()
    return (*TS._cpu_refold(task), time.perf_counter() - t0)


def _k200_swept(plan, report, tasks):
    """Stage 1, the 64, 128 and 256 buckets: sweep() as users run it, its
    CPU refold included; each result against sweep_200n200_tpu.ckpt.jsonl.
    An unflagged row that differs goes to stage 2 (`tasks`)."""
    rows = [r for N in K200_SWEPT for r in plan[N]]
    records = [(r["seq"], "." * len(r["seq"]), r["name"]) for r in rows]
    marks, progress = _bucket_marks()
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    stats = {}
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        path = os.path.join(tmp, "beams.jsonl")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        WT.LAUNCHES = 0
        res = sweep(records, nb_mode=200, max_stack=200, max_branch=1000,
                    buckets=K200_BUCKETS, save_beams=path, stats=stats,
                    progress=progress, device="cuda")
        saved = {(b["name"], b["seq"]): b for b in _beam_rows(path)}
    if stats.get("n_fallback") and stats.get("refold_evaluator") != "native":
        raise AssertionError("the sweep's refold did not run the native "
                             "evaluator")
    out = dict(zip(((r["name"], r["seq"]) for r in rows), res))
    for N in K200_SWEPT:
        m, rec = marks[N], report[N]
        causes, equal, ref_equal, ref_cpu = {}, 0, 0, 0
        for r in plan[N]:
            key = (r["name"], r["seq"])
            got, b = out[key], saved[key]
            if (got["struct"], got["nrj"]) != tuple(b["beam"][0]):
                raise AssertionError(f"{r['name']}: result and saved beam "
                                     f"differ")
            same = ((got["struct"], got["nrj"], got["nbp"])
                    == (r["struct"], r["nrj"], r["nbp"]))
            if b["flagged"]:
                name = FT.flag_names(b["flagged"])
                causes[name] = causes.get(name, 0) + 1
                # refolded by the sweep: fold_cpu's own beam
                ref_equal += same
                ref_cpu += not same
            elif same:
                equal += 1
            else:
                tasks.append(dict(N=N, kind="differs", row=r,
                                  beam=[tuple(x) for x in b["beam"]]))
        stream = m["stream_end"] - m["start"]
        rec.update(rows=len(plan[N]), batch=bucket_batch(16, N),
                   flags=causes, unflagged_equal=equal,
                   unflagged_differ=len(plan[N]) - sum(causes.values()) - equal,
                   refolded_in_sweep_equal=ref_equal,
                   refolded_in_sweep_fold_cpu=ref_cpu,
                   card_s=stream, seq_per_s=len(plan[N]) / stream,
                   refold_s=m["end"] - m["stream_end"],
                   seq_per_s_with_refold=len(plan[N]) / (m["end"] - m["start"]),
                   peak_mib=m["peak"] / 2**20, launches=m["launches"])
        if m["launches"] == 0:
            raise AssertionError(f"bucket {N} never launched the kernel")
        log(f"[k200-full] N={N} sweep() B={rec['batch']}: {rec['rows']} rows; "
            f"flagged {causes} (refolded by the sweep: {ref_equal} equal the "
            f"committed row, {ref_cpu} give fold_cpu's other beam); "
            f"unflagged {equal} equal {K200_TPU}, {rec['unflagged_differ']} "
            f"differ (to stage 2); {stream:.3f} s on the card "
            f"({rec['seq_per_s']:.3f} seq/s), refold and write "
            f"{rec['refold_s']:.3f} s ({rec['seq_per_s_with_refold']:.3f} "
            f"seq/s in all); peak {rec['peak_mib']:.1f} MiB; wavefront "
            f"launches {rec['launches']}")


def _k200_engine(N, rows, report, tasks):
    """Stage 1, the 512 and 1024 buckets and the 23S pair: the sweep's
    engine path without the refold.  Returns the launches and the 4th
    step's kernel arguments."""
    rec = report[N]
    eng = FoldEngine(bucket_config(N, 200, 200, 1000), B=bucket_batch(16, N),
                     device="cuda")
    got, secs, peak, n_launch, step_args = _fold_once(
        eng, [r["seq"] for r in rows])
    causes, equal = {}, 0
    for i, r in enumerate(rows):
        beam, flag = got[i]
        if flag:
            name = FT.flag_names(flag)
            causes[name] = causes.get(name, 0) + 1
            tasks.append(dict(N=N, kind="flagged", row=r))
        elif beam[0] == (r["struct"], r["nrj"]):
            equal += 1
        else:
            tasks.append(dict(N=N, kind="differs", row=r,
                              beam=[tuple(x) for x in beam]))
    rec.update(rows=len(rows), batch=eng.B, flags=causes,
               unflagged_equal=equal,
               unflagged_differ=len(rows) - sum(causes.values()) - equal,
               card_s=secs, seq_per_s=len(rows) / secs,
               peak_mib=peak / 2**20, launches=n_launch)
    log(f"[k200-full] N={N} run_stream B={eng.B}: {len(rows)} rows; flagged "
        f"{causes} (to stage 2); unflagged {equal} equal "
        f"{rows[0]['_file']}, {rec['unflagged_differ']} differ (to stage 2); "
        f"{secs:.3f} s on the card ({rec['seq_per_s']:.4f} seq/s, the layout "
        f"check inside); peak {rec['peak_mib']:.1f} MiB; wavefront launches "
        f"{n_launch}")
    del eng, got
    torch.cuda.empty_cache()
    return n_launch, step_args


def _k200_refold(tasks, limit, report):
    """Stage 2: fold_cpu on the host's cores, smallest N first, until
    `limit` seconds have passed; the pool is ended then.  A flagged row
    must give the committed (struct, nrj), an unflagged row that differs
    fold_cpu's whole beam.  Raises after printing every bucket where a
    row gives neither."""
    tasks = sorted(tasks, key=lambda t: (t["N"], t["row"]["_idx"]))
    width = max(1, min(os.cpu_count() or 1, len(tasks)))
    done = {}
    t0 = time.perf_counter()
    if tasks:
        pool = multiprocessing.get_context("forkserver").Pool(width)
        try:
            it = pool.imap_unordered(_refold_timed, [
                (k, t["row"]["seq"], 200, 200, 1000)
                for k, t in enumerate(tasks)])
            for _ in tasks:
                left = t0 + limit - time.perf_counter()
                if left <= 0:
                    break
                try:
                    k, beam, evaluator, secs = it.next(timeout=left)
                except multiprocessing.TimeoutError:
                    break
                done[k] = (beam, evaluator, secs)
        finally:
            pool.terminate()
            pool.join()
    wall = time.perf_counter() - t0
    failed = []
    for N, rec in report.items():
        mine = [(k, t) for k, t in enumerate(tasks) if t["N"] == N]
        res = dict(flagged_equal=0, differ_equal_fold_cpu=0, unchecked=[],
                   wrong=[], refold_s=[])
        for k, t in mine:
            r = t["row"]
            if k not in done:
                res["unchecked"].append(r["_idx"])
                continue
            beam, evaluator, secs = done[k]
            res["refold_s"].append(secs)
            if evaluator != "native":
                raise AssertionError("the refold did not run the native "
                                     "evaluator")
            if t["kind"] == "flagged":
                ok = tuple(beam[0]) == (r["struct"], r["nrj"])
                res["flagged_equal"] += ok
            else:
                try:
                    ok = _k200_row(t["beam"], r, f"N={N} _idx {r['_idx']}",
                                   cpu_beam=beam)
                except AssertionError:
                    ok = False
                res["differ_equal_fold_cpu"] += ok
            if not ok:
                res["wrong"].append((r["_idx"], t["kind"]))
        secs = res.pop("refold_s")
        rec.update(res, refolded=len(secs),
                   refold_row_s_mean=float(np.mean(secs)) if secs else None,
                   refold_row_s_max=max(secs) if secs else None)
        failed += res["wrong"]
        if mine:
            log(f"[k200-full] stage 2 N={N}: {len(mine)} rows; "
                f"{res['flagged_equal']} flagged rows refolded equal the "
                f"committed row, {res['differ_equal_fold_cpu']} differing rows "
                f"equal fold_cpu's whole beam; wrong (_idx, kind) "
                f"{res['wrong']}; unchecked under the limit: "
                f"{len(res['unchecked'])}, _idx {res['unchecked']}; seconds "
                f"a refolded row mean {rec['refold_row_s_mean']}, max "
                f"{rec['refold_row_s_max']}")
    log(f"[k200-full] stage 2: {len(done)}/{len(tasks)} rows refolded in "
        f"{wall:.1f} s by a pool of {width} processes (limit {limit:.0f} s)")
    if failed:
        raise AssertionError(f"rows (_idx, kind) {failed} differ from the "
                             f"committed sweep and from fold_cpu")
    return width, wall


@phase
def phase_k200_full(limit):
    """The whole committed -n 200 -ms 200 corpus: stage 1 on the card,
    stage 2 on the host's cores under `limit` seconds."""
    plan = k200_plan()
    report = {N: {} for N in plan}
    tasks, launches, steps = [], {}, []
    t0 = time.perf_counter()
    _k200_swept(plan, report, tasks)
    for N in K200_SWEPT:
        launches[N] = report[N]["launches"]
    # a real step of the 256 bucket, held to the plain version
    eng = FoldEngine(bucket_config(256, 200, 200, 1000),
                     B=bucket_batch(16, 256), device="cuda")
    args = capture_kernel_call(eng, [r["seq"] for r in plan[256][:eng.B]],
                               every=WT.check_layout)
    steps.append(_kernel_vs_bound("k200-full step", args, 256,
                                  real_step=True))
    del eng, args
    for N in (512, 1024, 4096):
        launches[N], args = _k200_engine(N, plan[N], report, tasks)
        steps.append(_kernel_vs_bound("k200-full step", args, N,
                                      reps=50 if N == 4096 else 200,
                                      real_step=True))
        del args
        torch.cuda.empty_cache()
    card = time.perf_counter() - t0
    log(f"[k200-full] stage 1: {sum(len(r) for r in plan.values())} rows in "
        f"{card:.1f} s; {len(tasks)} rows to stage 2")
    width, wall = _k200_refold(tasks, limit, report)
    log("k200_full: " + json.dumps(dict(
        stage1_s=card, stage2_s=wall, pool=width, limit_s=limit,
        buckets={str(N): rec for N, rec in report.items()})))
    return launches, steps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="also sweep all 2,294 journal rows and the two 23S "
                         "rRNAs (several minutes)")
    ap.add_argument("--k200-full", dest="k200_full", action="store_true",
                    help="also fold the whole committed -n 200 -ms 200 corpus "
                         "(stage 1 on the card, stage 2 on the host's cores)")
    ap.add_argument("--k200-limit", dest="k200_limit", type=float,
                    default=3600.0, help="seconds for --k200-full's stage 2 "
                                         "(default 3600)")
    ap.add_argument("--only", help="comma-separated phases to run after "
                    "device and build (kernel, fold_one, oracle, weights, "
                    "headline, loops, buckets, b512, k200, delta, enumerate, "
                    "long, "
                    "sweep, "
                    "cli, mfe, "
                    "api, multi, bench, tools, graph), then --full and "
                    "--k200-full "
                    "where given: a partial run, which prints no result line")
    args = ap.parse_args(argv)
    smi = phase_device()
    with open(REFS) as fh:
        refs = json.load(fh)
    phase_build()
    rows = journal()
    launches, steps, kern, kern_delta, kern_enum = {}, [], {}, {}, {}

    def counted(name, result):
        n, step = result
        launches.update({f"{name}{k}": v for k, v in n.items()}
                        if isinstance(n, dict) else {name: n})
        steps.extend(step if isinstance(step, list) else [step])

    phases = dict(
        kernel=lambda: kern.update(phase_kernel()),
        fold_one=lambda: phase_fold_one(refs),
        oracle=lambda: phase_oracle(refs),
        weights=lambda: counted("weights", (phase_weights(refs, rows), [])),
        headline=lambda: counted("headline", phase_headline(rows)),
        loops=phase_loops,
        buckets=lambda: counted("bucket", phase_buckets(rows)),
        b512=lambda: counted("b512", phase_b512(rows, refs)),
        k200=lambda: counted("k200_", phase_k200(rows)),
        delta=lambda: kern_delta.update(phase_delta(rows)),
        enumerate=lambda: kern_enum.update(phase_enumerate(rows)),
        long=lambda: counted("long", phase_long(refs)),
        sweep=lambda: counted("sweep", (phase_sweep(rows), [])),
        cli=lambda: phase_cli(refs),
        mfe=lambda: phase_mfe(rows, refs),
        api=lambda: counted("api", (phase_api(refs), [])),
        multi=lambda: counted("multi", (phase_multi(rows, smi), [])),
        bench=lambda: counted("bench", phase_bench(rows, refs)),
        tools=lambda: counted("tools", phase_tools(rows)),
        graph=lambda: counted("graph_", phase_graph(rows)))
    only = args.only.split(",") if args.only else list(phases)
    for name in only:
        phases[name]()
    if args.full:
        phase_full(rows, refs)
        phase_full_long()
        phase_full_mfe(rows)
    if args.k200_full:
        counted("k200full_", phase_k200_full(args.k200_limit))
    if args.only:
        log(f"[partial] ran {only}: wavefront launches {launches}; no result "
            f"line")
        return
    kern["shapes"] += steps
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "rafft_tpu"))
    if loaded:
        raise AssertionError(f"the run imported {loaded}")
    log("[imports] neither jax nor rafft_tpu was imported")
    log(json.dumps({"kernels": [dict(
        name="wavefront", route="cuda",
        source="rafft_tpu_torch/csrc/wavefront.cu",
        replaces="rafft_tpu/engine/wavefront.py:44",
        launches=sum(launches.values()), launches_by_path=launches,
        **kern), dict(
        name="delta", route="cuda", source="rafft_tpu_torch/csrc/delta.cu",
        replaces=None, launches=kern_delta["band"]["launches"],
        **kern_delta), dict(
        name="enumerate", route="cuda",
        source="rafft_tpu_torch/csrc/enumerate.cu", replaces=None,
        launches=kern_enum["stream"]["launches"], **kern_enum)]}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
