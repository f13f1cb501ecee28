"""Drive the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py [--full]

Phases (each raises on failure; the script exits nonzero and prints no
result line):
  1. device   - a CUDA card is present; print its name and power limit;
  2. build    - nvcc-build the wavefront kernel from csrc/ (timed);
  3. kernel   - at the shapes of every bucket's fold step (N=128: 16 x 50
                beam rows, R=16; N=256: 16 x 50, R=16; N=512: 8 x 50,
                R=16; N=1024: 4 x 50, R=32), all seven kernel tables equal
                the plain PyTorch version on seeded random and degenerate
                layouts; time both at each shape;
  4. fold_one - the README sequence at max_stack 5 and 20 gives the same
                trajectory and final beam as the sequential CPU oracle;
  5. headline - FoldEngine at N=128, K=50, M=100, R=16, V=4096, W=8,
                CPLX=512, S=16384, max_branch=1000, B=16: run_stream over
                the first 64 journal rows of <= 120 nt must reproduce the
                committed beams exactly with flag 0, through the kernel;
  6. loops    - eval_pt on [4, 1024, 1024] nested pair tables (the 1024
                bucket's complex-candidate tables at CPLX=1024) equals the
                CPU result on a subset and raises the peak by <= 2 GiB;
  7. buckets  - run_stream at the sweep's configuration of the 256, 512
                and 1024 buckets (bucket_config, bucket_batch(16, N)) over
                the first rows of each bucket and its flagged journal
                rows: unflagged rows equal the journal with flag 0, and
                flagged rows carry the journal's flag bits;
  8. sweep    - the port's sweep() on the first 16 journal rows writes
                the journal's beams-journal rows;
  9. cli      - `python -m rafft_tpu_torch.cli.fold_cli --device cuda`
                prints what the reference CLI prints with its CPU engine;
 10. full     - with --full only: sweep() over all 2,294 journal rows,
                the flagged ones refolded on the CPU; every beams-journal
                row equals the committed journal or, on the rows where
                that differs, the sequential CPU parity oracle (the
                reference semantics).
The oracle's and the reference CLI's outputs come from
rafft_tpu_torch/testdata/chip_smoke_refs.json, which
tests/test_torch_smoke_refs.py holds against the JAX package on the CPU;
this script imports nothing of JAX or of the JAX package.  Each path that
runs the fold engine reads the kernel's launch count, set to 0 just
before it.  The last two lines are the kernel summary and the device
record.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from rafft_tpu_torch import _build
from rafft_tpu_torch.energy import eval_torch as ET
from rafft_tpu_torch.engine import wavefront as WT
from rafft_tpu_torch.engine.fold_torch import (EngineConfig, FoldEngine,
                                               fold_one, weight_matrix)
from rafft_tpu_torch.parallel.sweep import bucket_batch, bucket_config, sweep
from rafft_tpu_torch.tools.measure import bucket_rows, event_ms, nested_tables

ROOT = os.path.dirname(os.path.abspath(__file__))
JOURNAL = os.path.join(ROOT, "benchmarks", "artifacts", "beams_100n50.jsonl.gz")
REFS = os.path.join(ROOT, "rafft_tpu_torch", "testdata", "chip_smoke_refs.json")
HEADLINE = EngineConfig(N=128, K=50, M=100, R=16, V=4096, W=8, CPLX=512,
                        S=16384, max_branch=1000)
B = 16
# journal rows folded per bucket in phase 7 (beside its flagged rows)
BUCKET_ROWS = {256: 32, 512: 16, 1024: 4}
GiB = 2 ** 30


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


def journal():
    return [json.loads(line) for line in gzip.open(JOURNAL, "rt")]


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
    t0 = time.perf_counter()
    lib = _build.build("wavefront")
    secs = time.perf_counter() - t0
    _, out = _build.BUILD_LOG.get("wavefront", (0.0, "(cached)"))
    log(f"[build] {lib.name} in {secs:.2f} s")
    for line in out.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] ptxas: {line.strip()}")
    return secs


def _layouts(rng, rows, R, N, nmin, nmax):
    """Engine-valid region layouts: each beam row's unpaired positions of
    a random sequence of nmin..nmax nt split into up to R ascending
    regions."""
    rpos = np.full((rows, R, N), N, np.int32)
    rcodes = np.zeros((rows, R, N), np.int32)
    mlen = np.zeros((rows, R), np.int32)
    for b in range(rows):
        n = int(rng.integers(nmin, nmax + 1))
        codes = rng.integers(1, 5, size=n)
        keep = np.nonzero(rng.random(n) < rng.uniform(0.2, 1.0))[0]
        nreg = int(rng.integers(1, R + 1))
        slot = rng.integers(0, nreg, size=len(keep))
        if b % 50 == 0:               # the step-0 layout: one whole region
            keep, slot = np.arange(n), np.zeros(n, np.int64)
        for r in range(nreg):
            pos = keep[slot == r]
            rpos[b, r, : len(pos)] = pos
            rcodes[b, r, : len(pos)] = codes[pos]
            mlen[b, r] = len(pos)
    # degenerate rows: beam row 1 has only empty regions, row 2 a
    # single-position region
    rpos[1], rcodes[1], mlen[1] = N, 0, 0
    rpos[2, 0, 0], rcodes[2, 0, 0], mlen[2, 0] = 5, 2, 1
    return rcodes, rpos, mlen


# (N, batch, R, sequence lengths): the fold step's shapes in each bucket
KERNEL_SHAPES = ((128, 16, 16, (60, 120)), (256, 16, 16, (129, 256)),
                 (512, 8, 16, (257, 512)), (1024, 4, 32, (513, 780)))


@phase
def phase_kernel():
    dev = torch.device("cuda")
    W = weight_matrix(3.0, 2.0, 1.0)
    shapes, max_err = [], 0.0
    for N, nb, R, (nmin, nmax) in KERNEL_SHAPES:
        cfg = EngineConfig(N=N, K=50, R=R)
        dp = ET.device_params(cfg.temp, N, dev)
        z1, z2 = np.random.default_rng(0xA5F7).integers(
            1, 2**32 - 1, (2, N + 1), dtype=np.uint64).astype(np.uint32).view(np.int32)
        for seed in (0, 1):
            rc, rp, ml = _layouts(np.random.default_rng(seed), nb * cfg.K, R, N,
                                  nmin, nmax)
            rpc = np.clip(rp, 0, N)
            shape = (nb, cfg.K)
            args = [torch.as_tensor(x.reshape(shape + x.shape[1:]), device=dev)
                    for x in (rc, rp, ml, z1[rpc], z2[rpc])]
            want = WT.wavefront_tables_ref(cfg, dp, W, *args)
            got = WT.wavefront_tables(cfg, dp, W, *args)
            torch.cuda.synchronize()
            for k in WT.KEYS:
                if got[k].shape != want[k].shape or not torch.equal(got[k], want[k]):
                    bad = (got[k] != want[k]).nonzero()[:5].tolist()
                    raise AssertionError(f"kernel table {k} differs (N={N}, "
                                         f"seed {seed}) at {bad}")
                err = (got[k].double() - want[k].double()).abs().max().item()
                max_err = max(max_err, err)
            del want, got
        ms = event_ms(lambda: WT.wavefront_tables(cfg, dp, W, *args), 20)
        plain_ms = event_ms(lambda: WT.wavefront_tables_ref(cfg, dp, W, *args),
                             2 if N > 256 else 5)
        log(f"[kernel] N={N} {tuple(args[0].shape)}: 7/7 tables equal on 2 "
            f"layouts; wavefront {ms:.4f} ms/call, plain torch {plain_ms:.4f} "
            f"ms/call")
        shapes.append(dict(N=N, shape=list(args[0].shape), ms=ms,
                           plain_ms=plain_ms))
    log(f"[kernel] tolerance: exact; max abs err {max_err}")
    return dict(max_abs_err=max_err, ms=shapes[0]["ms"],
                plain_ms=shapes[0]["plain_ms"], shapes=shapes)


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


def _stream(eng, rows, warm):
    """Warm up on `warm` rows, then run_stream over `rows` with the
    launch count and the peak set to 0 just before; check every row
    against the journal (beam and flag 0, or the journal's flag bits
    for a flagged row).  Returns (seq/s, seconds, peak bytes, launches)."""
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
    peak = torch.cuda.max_memory_allocated()
    if sorted(i for i, _, _ in out) != list(range(len(rows))):
        raise AssertionError("run_stream did not yield every sequence once")
    bad = []
    for idx, beam, flag in out:
        r = rows[idx]
        if r["flagged"]:
            # its journal beam came from the CPU refold: compare the flags
            if flag != r["flagged"]:
                bad.append((idx, flag, r["flagged"]))
        elif flag != 0 or beam != [(db, float(e)) for db, e in r["beam"]]:
            bad.append((idx, flag, 0))
    if bad:
        raise AssertionError(f"{len(bad)}/{len(rows)} rows differ from the "
                             f"journal (index, flag, journal flag): {bad[:8]}")
    if launches == 0:
        raise AssertionError("the run never launched the wavefront kernel")
    return len(out) / secs, secs, peak, launches


@phase
def phase_headline(rows_all):
    rows = [r for r in rows_all if len(r["seq"]) <= 120][:64]
    eng = FoldEngine(HEADLINE, B=B, device="cuda")
    rate, secs, peak, launches = _stream(eng, rows, rows[:16])
    log(f"[headline] {len(rows)}/{len(rows)} beams equal the journal, flag 0; "
        f"{rate:.3f} seq/s ({secs:.3f} s); peak {peak / 2**20:.1f} MiB; "
        f"wavefront launches {launches}")
    return launches


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
    launches = {}
    for N, count in BUCKET_ROWS.items():
        sel = bucket_rows(rows_all, N, count)
        nb = bucket_batch(16, N)
        eng = FoldEngine(bucket_config(N, 100, 50, 1000), B=nb, device="cuda")
        rate, secs, peak, n_launch = _stream(eng, sel, sel[:nb])
        flags = [r["flagged"] for r in sel if r["flagged"]]
        log(f"[buckets] N={N} B={nb}: {len(sel) - len(flags)} unflagged rows "
            f"equal the journal with flag 0, flagged rows carry {flags}; "
            f"{rate:.3f} seq/s ({secs:.3f} s for {len(sel)}); peak "
            f"{peak / 2**20:.1f} MiB; wavefront launches (one per step) "
            f"{n_launch}")
        launches[N] = n_launch
    return launches


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
        if g != r:
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


@phase
def phase_full(rows_all, refs):
    """sweep() over the whole journal, flagged folds refolded on the CPU."""
    records = [(r["seq"], "." * len(r["seq"]), r["name"]) for r in rows_all]
    marks = {}
    t_start = [time.perf_counter()]

    def progress(N, done_n, total, done=False, secs=None):
        now = time.perf_counter()
        if not done:
            marks.setdefault(N, {})["stream_end"] = now
            return
        m = marks.setdefault(N, {})
        m.update(end=now, start=t_start[0], peak=torch.cuda.max_memory_allocated(),
                 launches=WT.LAUNCHES)
        t_start[0] = now
        torch.cuda.reset_peak_memory_stats()
        WT.LAUNCHES = 0

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
    log(f"[full] {len(rows_all)} sequences in {secs:.3f} s "
        f"({len(rows_all) / secs:.3f} seq/s); refolded {stats['n_fallback']} "
        f"on the CPU ({stats['flag_causes']})")
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="also sweep all 2,294 journal rows (several minutes)")
    args = ap.parse_args(argv)
    smi = phase_device()
    with open(REFS) as fh:
        refs = json.load(fh)
    phase_build()
    kern = phase_kernel()
    phase_fold_one(refs)
    rows = journal()
    launches = {"headline": phase_headline(rows)}
    phase_loops()
    launches.update(
        {f"bucket{N}": v for N, v in phase_buckets(rows).items()})
    launches["sweep"] = phase_sweep(rows)
    phase_cli(refs)
    if args.full:
        phase_full(rows, refs)
    log(json.dumps({"kernels": [dict(
        name="wavefront", route="cuda",
        source="rafft_tpu_torch/csrc/wavefront.cu",
        replaces="rafft_tpu/engine/wavefront.py:44",
        launches=sum(launches.values()), launches_by_path=launches,
        **kern)]}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
