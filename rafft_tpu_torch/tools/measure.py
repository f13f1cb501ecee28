"""Measure the port's fold path on one CUDA card, layer by layer.

    python -m rafft_tpu_torch.tools.measure [--phases loops,headline,syncs,profile]
                                            [--passes 5] [--out DIR]

Run it from the root of a checkout: it measures the rafft_tpu_torch
package that the checkout holds.  To compare two versions in one call,
copy this file into the other checkout's rafft_tpu_torch/tools/ and run
the same command from there; the loops and headline phases use only the
API that the first port (the N=128 fold path) already had.

Phases (each prints lines tagged with its name):
  loops    - eval_pt and analyze_pt on valid nested pair tables at the
             shapes the step gives them in each bucket: the increase of
             the peak (max_memory_allocated after a reset, over the
             inputs) and ms per call (CUDA events, mean of 10 calls);
  headline - the N=128 headline of chip_smoke.py (the first 64 journal
             rows of <= 120 nt at B=16, after a 16-row warm-up), folded
             `--passes` times by one engine: seconds and seq/s per pass;
             every beam must equal the journal;
  syncs    - per bucket at the sweep's configuration: device-to-host
             reads per step (Tensor.__bool__, __int__ and item on CUDA
             tensors), steps (= wavefront launches) and the share of the
             wall spent in FoldEngine._rows_from;
  profile  - per bucket 256/512/1024, torch.profiler over run_stream
             after a warm-up, with a range around each stage of the step.
             From the Chrome trace: device ops per step, kernel ms, and
             per stage the kernel ms of the ops launched inside its range
             (nested stages count in both) and its host ms.  Busy share is
             printed twice: kernel ms over the profiled wall (a lower
             bound: the profiler slows the host) and over the unprofiled
             wall of the same rows.  Per-bucket key_averages tables go to
             DIR/profile_<N>.txt;
  swap     - with --against DIR (another checkout): this checkout's
             eval_pt/analyze_pt against DIR's, in one process.  Per call at
             [16, 50, 128]: results equal, device ops (profiler), and ms
             (CUDA events, 20 calls) in `--passes` rounds of A, B, B, A.
             Then the N=128 headline with the fold step calling one
             version or the other, in the same order of passes.  Both
             versions share everything else, so the difference is the
             loop analysis alone.
"""

from __future__ import annotations

import argparse
import gzip
import importlib.util
import json
import os
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
JOURNAL = os.path.join(ROOT, "benchmarks", "artifacts", "beams_100n50.jsonl.gz")
BUCKETS = (128, 256, 512, 1024)
# stages of FoldEngine.step, wrapped from outside in the profile phase
STAGES = ("_candidate_delta", "_children", "eval_pt", "analyze_pt", "_regions",
          "_top_lags", "_member", "_first_occurrence", "_combo_pt",
          "wavefront_tables")
MiB = 2 ** 20


def log(msg):
    print(msg, flush=True)


def journal():
    return [json.loads(line) for line in gzip.open(JOURNAL, "rt")]


def bucket_rows(rows_all, N, count):
    """The first `count` journal rows of bucket N plus its flagged rows."""
    rows = [r for r in rows_all
            if next(b for b in BUCKETS if len(r["seq"]) <= b) == N]
    return rows[:count] + [r for r in rows[count:] if r["flagged"]]


def nested_tables(rng, count, N, nmin, nmax):
    """Random nested pair tables with canonical pairs (hairpins >= 3):
    codes [count, N], pt [count, N] (-1 unpaired) and lengths [count]."""
    pairs = [(1, 4), (4, 1), (2, 3), (3, 2), (3, 4), (4, 3)]
    codes = np.zeros((count, N), np.int32)
    pts = np.full((count, N), -1, np.int32)
    ns = rng.integers(nmin, nmax + 1, size=count).astype(np.int32)
    for b in range(count):
        stack = []
        codes[b, : ns[b]] = rng.integers(1, 5, size=ns[b])
        for i in range(ns[b]):
            u = rng.random()
            if stack and i - stack[-1] > 3 and u < 0.35:
                j = stack.pop()
                pts[b, i], pts[b, j] = j, i
                codes[b, j], codes[b, i] = pairs[rng.integers(len(pairs))]
            elif u > 0.7:
                stack.append(i)
    return codes, pts, ns


def event_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


# (function, leading dims, N, sequence lengths): eval_pt on the complex
# candidates [B, CPLX, N] and analyze_pt on the beam [B, K, N]
LOOP_SHAPES = (("eval_pt", (16, 50), 128, (60, 120)),
               ("analyze_pt", (16, 50), 128, (60, 120)),
               ("eval_pt", (8, 1024), 512, (257, 512)),
               ("analyze_pt", (8, 50), 512, (257, 512)),
               ("eval_pt", (4, 1024), 1024, (513, 780)),
               ("analyze_pt", (4, 50), 1024, (513, 780)))


def phase_loops():
    from rafft_tpu_torch.energy import eval_torch as ET
    dev = torch.device("cuda")
    for name, lead, N, (nmin, nmax) in LOOP_SHAPES:
        count = int(np.prod(lead))
        distinct = min(count, 64)
        tabs = nested_tables(np.random.default_rng(7), distinct, N, nmin, nmax)
        tile = np.arange(count) % distinct
        c, p = (torch.as_tensor(x[tile], device=dev).view(*lead, N)
                for x in tabs[:2])
        n = torch.as_tensor(tabs[2][tile], device=dev).view(*lead)
        dp = ET.device_params(37.0, N, dev)
        fn = getattr(ET, name)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn(dp, c, p, n)
        torch.cuda.synchronize()
        rise = torch.cuda.max_memory_allocated() - base
        del out
        ms = event_ms(lambda: fn(dp, c, p, n), 10)
        log(f"[loops] {name} {tuple(p.shape)}: peak rise {rise / MiB:.1f} "
            f"MiB, {ms:.3f} ms/call")
        del c, p, n
        torch.cuda.empty_cache()


HEADLINE = dict(N=128, K=50, M=100, R=16, V=4096, W=8, CPLX=512, S=16384,
                max_branch=1000)


def phase_headline(rows_all, passes):
    from rafft_tpu_torch.engine.fold_torch import EngineConfig, FoldEngine
    rows = [r for r in rows_all if len(r["seq"]) <= 120][:64]
    seqs = [r["seq"] for r in rows]
    eng = FoldEngine(EngineConfig(**HEADLINE), B=16, device="cuda")
    for _ in eng.run_stream(seqs[:16]):
        pass
    for k in range(passes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = list(eng.run_stream(seqs))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        bad = [i for i, beam, flag in out if flag or beam != [
            (db, float(e)) for db, e in rows[i]["beam"]]]
        if bad or len(out) != len(rows):
            raise AssertionError(f"headline rows {bad} differ from the journal")
        log(f"[headline] pass {k}: {secs:.4f} s for {len(rows)} "
            f"({len(rows) / secs:.3f} seq/s)")


def _engine(N):
    from rafft_tpu_torch.engine.fold_torch import FoldEngine
    from rafft_tpu_torch.parallel.sweep import bucket_batch, bucket_config
    return FoldEngine(bucket_config(N, 100, 50, 1000), B=bucket_batch(16, N),
                      device="cuda")


def _fold(eng, rows):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = list(eng.run_stream([r["seq"] for r in rows]))
    torch.cuda.synchronize()
    if len(out) != len(rows):
        raise AssertionError("run_stream did not yield every row")
    return time.perf_counter() - t0


SYNC_ROWS = {128: 32, 256: 32, 512: 16, 1024: 4}


def phase_syncs(rows_all):
    from rafft_tpu_torch.engine import fold_torch as FT
    from rafft_tpu_torch.engine import wavefront as WT
    counts = dict(bool=0, int=0, item=0, rows_from=0.0)
    orig = {k: getattr(torch.Tensor, k) for k in ("__bool__", "__int__", "item")}
    orig_rows = FT.FoldEngine._rows_from

    def counter(key, fn):
        def wrapped(self, *a):
            if self.is_cuda:
                counts[key] += 1
            return fn(self, *a)
        return wrapped

    def rows_from(self, *a):
        t0 = time.perf_counter()
        out = orig_rows(self, *a)
        counts["rows_from"] += time.perf_counter() - t0
        return out

    for N, count in SYNC_ROWS.items():
        rows = bucket_rows(rows_all, N, count)
        eng = _engine(N)
        _fold(eng, rows[: eng.B])
        counts.update(bool=0, int=0, item=0, rows_from=0.0)
        WT.LAUNCHES = 0
        torch.Tensor.__bool__ = counter("bool", orig["__bool__"])
        torch.Tensor.__int__ = counter("int", orig["__int__"])
        torch.Tensor.item = counter("item", orig["item"])
        FT.FoldEngine._rows_from = rows_from
        try:
            secs = _fold(eng, rows)
        finally:
            for k, fn in orig.items():
                setattr(torch.Tensor, k, fn)
            FT.FoldEngine._rows_from = orig_rows
        steps = WT.LAUNCHES
        log(f"[syncs] N={N}: {len(rows)} seqs {secs:.3f} s "
            f"({len(rows) / secs:.3f} seq/s); steps {steps}; bool reads "
            f"{counts['bool']} ({counts['bool'] / steps:.2f}/step), int reads "
            f"{counts['int']}, item reads {counts['item']}; _rows_from "
            f"{counts['rows_from']:.3f} s "
            f"({100 * counts['rows_from'] / secs:.2f}% of wall)")


PROFILE_ROWS = {256: 16, 512: 8, 1024: 4}


def _trace_stats(path):
    """Kernel events and stage ranges of a Chrome trace: total kernel ms,
    device op count, {stage: (kernel ms, host ms, calls)}."""
    with open(path) as fh:
        ev = json.load(fh)["traceEvents"]
    kern = [e for e in ev if e.get("cat") in ("kernel", "gpu_memcpy",
                                                 "gpu_memset")]
    launch = {e["args"]["correlation"]: e["ts"] for e in ev
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    k_ts = np.array([launch.get(e["args"].get("correlation"), -1.0)
                     for e in kern])
    k_dur = np.array([e["dur"] for e in kern], dtype=np.float64)
    stages = {}
    for name in STAGES:
        rng = sorted((e["ts"], e["ts"] + e["dur"]) for e in ev
                     if e.get("cat") == "user_annotation"
                     and e["name"] == f"stage:{name}")
        if not rng:
            continue
        lo, hi = np.array(rng).T
        at = np.searchsorted(lo, k_ts, side="right") - 1
        inside = (at >= 0) & (k_ts < hi[np.clip(at, 0, None)])
        stages[name] = (k_dur[inside].sum() / 1e3, (hi - lo).sum() / 1e3,
                        len(rng))
    return k_dur.sum() / 1e3, len(kern), stages


def phase_profile(rows_all, out_dir):
    from torch.profiler import ProfilerActivity, profile, record_function

    from rafft_tpu_torch.engine import fold_torch as FT
    from rafft_tpu_torch.engine import wavefront as WT
    orig = {name: getattr(FT, name) for name in STAGES}

    def ranged(name, fn):
        def wrapped(*a, **kw):
            with record_function(f"stage:{name}"):
                return fn(*a, **kw)
        return wrapped

    for N, count in PROFILE_ROWS.items():
        rows = bucket_rows(rows_all, N, count)
        eng = _engine(N)
        _fold(eng, rows[: eng.B])
        wall = _fold(eng, rows)
        WT.LAUNCHES = 0
        for name, fn in orig.items():
            setattr(FT, name, ranged(name, fn))
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                pwall = _fold(eng, rows)
        finally:
            for name, fn in orig.items():
                setattr(FT, name, fn)
        steps = WT.LAUNCHES
        build = os.path.join(ROOT, "build")
        os.makedirs(build, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=build) as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            kms, nops, stages = _trace_stats(path)
        if out_dir:
            with open(os.path.join(out_dir, f"profile_{N}.txt"), "w") as fh:
                fh.write(prof.key_averages().table(
                    sort_by="cuda_time_total", row_limit=60))
        log(f"[profile] N={N}: {len(rows)} seqs, {steps} steps; unprofiled "
            f"wall {wall:.3f} s, profiled wall {pwall:.3f} s; kernel "
            f"{kms:.1f} ms; {nops} device ops ({nops / steps:.0f}/step); busy "
            f"share {100 * kms / 1e3 / pwall:.1f}% of the profiled wall, "
            f"{100 * kms / 1e3 / wall:.1f}% of the unprofiled wall")
        for name, (dms, hms, calls) in sorted(stages.items(),
                                              key=lambda kv: -kv[1][0]):
            log(f"[profile] N={N} {name}: kernel {dms:.1f} ms, host "
                f"{hms:.1f} ms, {calls} calls")


def _abba(rounds):
    for _ in range(rounds):
        yield from ("this", "other", "other", "this")


def _median(xs):
    return float(np.median(xs))


def phase_swap(rows_all, against, rounds):
    from torch.profiler import ProfilerActivity, profile

    from rafft_tpu_torch.energy import eval_torch as ET
    from rafft_tpu_torch.engine import fold_torch as FT
    from rafft_tpu_torch.engine.fold_torch import EngineConfig, FoldEngine
    path = os.path.join(against, "rafft_tpu_torch", "energy", "eval_torch.py")
    spec = importlib.util.spec_from_file_location("against_eval_torch", path)
    other = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other)
    log(f"[swap] this: {ET.__file__}; other: {path}")
    versions = {"this": (ET.eval_pt, ET.analyze_pt),
                "other": (other.eval_pt, other.analyze_pt)}

    dev, N, lead = torch.device("cuda"), 128, (16, 50)
    tabs = nested_tables(np.random.default_rng(7), 64, N, 60, 120)
    tile = np.arange(int(np.prod(lead))) % 64
    c, p = (torch.as_tensor(x[tile], device=dev).view(*lead, N)
            for x in tabs[:2])
    n = torch.as_tensor(tabs[2][tile], device=dev).view(*lead)
    dp = ET.device_params(37.0, N, dev)
    for k, name in enumerate(("eval_pt", "analyze_pt")):
        a, b = versions["this"][k](dp, c, p, n), versions["other"][k](dp, c, p, n)
        same = (torch.equal(a, b) if k == 0 else
                all(torch.equal(a[f], b[f]) for f in b))
        if not same:
            raise AssertionError(f"{name} differs between the checkouts")
        ops = {}
        for v in versions:
            fn = versions[v][k]
            fn(dp, c, p, n)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn(dp, c, p, n)
                torch.cuda.synchronize()
            build = os.path.join(ROOT, "build")
            os.makedirs(build, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=build) as tmp:
                prof.export_chrome_trace(os.path.join(tmp, "t.json"))
                ops[v] = _trace_stats(os.path.join(tmp, "t.json"))[1]
        ms = {"this": [], "other": []}
        for v in _abba(rounds):
            fn = versions[v][k]
            ms[v].append(event_ms(lambda: fn(dp, c, p, n), 20))
        log(f"[swap] {name} {tuple(p.shape)}: equal; device ops this "
            f"{ops['this']}, other {ops['other']}; ms/call this median "
            f"{_median(ms['this']):.3f} {[round(x, 3) for x in ms['this']]}, "
            f"other median {_median(ms['other']):.3f} "
            f"{[round(x, 3) for x in ms['other']]}")

    rows = [r for r in rows_all if len(r["seq"]) <= 120][:64]
    seqs = [r["seq"] for r in rows]
    eng = FoldEngine(EngineConfig(**HEADLINE), B=16, device="cuda")
    secs = {"this": [], "other": []}
    try:
        for v in ("this", "other", *_abba(rounds)):
            FT.eval_pt, FT.analyze_pt = versions[v]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = list(eng.run_stream(seqs))
            torch.cuda.synchronize()
            secs[v].append(time.perf_counter() - t0)
            bad = [i for i, beam, flag in out if flag or beam != [
                (db, float(e)) for db, e in rows[i]["beam"]]]
            if bad or len(out) != len(rows):
                raise AssertionError(f"headline rows {bad} differ ({v})")
    finally:
        FT.eval_pt, FT.analyze_pt = versions["this"]
    for v in secs:
        warm = secs[v][1:]      # the first pass of each is a warm-up
        log(f"[swap] headline with {v}'s loop analysis: median "
            f"{_median(warm):.4f} s for 64 ({64 / _median(warm):.3f} seq/s); "
            f"passes {[round(x, 4) for x in warm]}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="loops,headline,syncs,profile")
    ap.add_argument("--passes", type=int, default=5)
    ap.add_argument("--out", help="directory for the profiler tables")
    ap.add_argument("--against", help="another checkout, for the swap phase")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("measure: no CUDA device")
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}; "
        f"package {os.path.dirname(os.path.dirname(os.path.abspath(__file__)))}")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    rows = journal()
    for ph in args.phases.split(","):
        t0 = time.perf_counter()
        if ph == "loops":
            phase_loops()
        elif ph == "headline":
            phase_headline(rows, args.passes)
        elif ph == "syncs":
            phase_syncs(rows)
        elif ph == "profile":
            phase_profile(rows, args.out)
        elif ph == "swap":
            phase_swap(rows, args.against, args.passes)
        else:
            raise SystemExit(f"measure: unknown phase {ph}")
        log(f"[{ph}] took {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
