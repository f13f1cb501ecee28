"""Measure the port's fold path on one CUDA card, layer by layer.

    python -m rafft_tpu_torch.tools.measure [--phases loops,profile,kernel,walk,mfe,graph,obs,tail,kept,cplx,need]
                                            [--passes 5] [--out DIR]
                                            [--max-stack 50] [--profile-buckets 256,512,1024]
                                            [--bucket 512] [--rslots 24,32]

Run it from the root of a checkout: it measures the rafft_tpu_torch
package that the checkout holds.  To compare two versions in one call,
copy this file into the other checkout's rafft_tpu_torch/tools/ and run
the same command from there; the loops phase uses only the API that the
first port (the N=128 fold path) already had.

Phases (each prints lines tagged with its name):
  loops    - eval_pt and analyze_pt on valid nested pair tables at the
             shapes the step gives them in each bucket: the increase of
             the peak (max_memory_allocated after a reset, over the
             inputs) and ms per call (CUDA events, mean of 10 calls);
  profile  - per bucket (--profile-buckets, default 256/512/1024, at
             --max-stack K, default 50, the sweep's configuration, on the
             eager path, FoldEngine(graphs=False), as swap is),
             torch.profiler over run_stream after a warm-up; the step
             marks its stages itself (the ranges rafft.stage.<name> of
             rafft_tpu_torch/obs.py).  Before it, one unprofiled fold
             with every function of STAGES wrapped gives the fold's peak,
             the state's bytes and each function's largest rise of the
             peak over what was allocated at its entry.
             From the Chrome trace: device ops per step, kernel ms, and
             per stage the kernel ms of the ops launched inside its range
             and its host ms.  Busy share is
             printed twice: kernel ms over the profiled wall (a lower
             bound: the profiler slows the host) and over the unprofiled
             wall of the same rows.  Per-bucket key_averages tables go to
             DIR/profile_<N>.txt;
  kernel   - the wavefront kernel alone, device ms per call (CUDA events
             around 200 calls that were enqueued while the device was held
             busy; median and every value of `--passes` such runs) at each
             bucket's step shape (128 to 4096 at K=50, and 128 at K=200)
             on a seeded layout and, where the journal has rows of the
             bucket (up to 1024), on one real step (the inputs of the 4th
             step of a fold of the bucket's first rows), with the bytes,
             cells and the bound of those inputs (wavefront_work); the
             real step's tensors must keep the kernel's layout contract;
             beside them the time of a zero_() of the seven tables' bytes;
  walk     - the wavefront kernel on synthetic layouts that separate its
             costs, device ms per call at the 128, 512 and 1024 shapes:
             every region empty (stores alone), one region of N/4, N/2 and
             N-8 positions in an otherwise empty table (the walk's time per
             position), and 1, 4 or R regions of 8 and 4 of 32 positions in
             every row (the cost per region);
  swap     - with --against DIR (another checkout): this checkout's
             eval_pt/analyze_pt against DIR's, in one process.  Per call at
             [16, 50, 128]: results equal, device ops (profiler), and ms
             (CUDA events, 20 calls) in `--passes` rounds of A, B, B, A.
             Then the N=128 headline with the fold step calling one
             version or the other, in the same order of passes.  Both
             versions share everything else, so the difference is the
             loop analysis alone;
  graph    - the fold step's CUDA graph against the same step run eagerly
             (FoldEngine(graphs=False)), in one process, at the headline
             (N=128, K=50, B=16), the 1024 bucket (K=50, B=4) and K=200 at
             128 (B=16), each at the sweep's configuration: both paths'
             states after G=4 rounds from the same start equal; device ops
             per step and host events that wait for the device
             (SYNC_EVENTS) in one call (torch.profiler); ms per step
             (host clock between synchronisations around one call of 4
             rounds from that start, `--passes` rounds of eager, graph,
             graph, eager); the graph pool's bytes and the
             eager call's peak rise; the wavefront wrapper's host time per
             call, allocating and into fixed tables, and the replay's host
             time per step (one replay, the device idle before it); the
             complex candidates' evaluation (device ms of its CUDA graph,
             graph_ms) at the fixed width CPLX against the longest complex
             prefix of each of the first 8 steps (the width the step used
             to trim to);
  obs      - the cost of the program's own trace (rafft_tpu_torch/obs.py):
             host ns per span with the profiler off and us per span with
             it on; at the headline configuration (bucket_config(128,
             100, 50, 1000), B=16, G=4) the device ms of one graph replay
             captured with the stage clock's timing events and of one
             captured without them (CUDA events around 20 replays,
             `--passes` rounds of without, with, with, without; the two
             graphs' states must be equal); the host ms until replay()
             returns, the device idle before it, with the profiler off, on
             for the CPU and on for the CPU and CUDA (the span
             engine.launch); and the host ms of reading a replay's stage
             clock with the profiler on, beside the sum of its stages'
             device ms;
  tail     - the public fold's slow calls: 100 calls of
             fold(traj=True) at -ms 20 (the CLI's -n 100 --max_branch
             1000) on journal rows of 65-128 nt in a seeded order, after
             two warm-up calls, under a CPU-only torch.profiler; each
             call's wall (host clock to a synchronisation) and its time in
             each of the program's spans (obs.snapshot() after each call;
             the step's stage spans, inside engine.warmup, left out),
             fold.call's self time as unspanned; the slowest tenth of
             calls against the others, span by span;
  kept     - fold_one's kept engines (fold_torch.KEPT_ENGINES) under
             traffic that changes configuration: 120 calls at -ms 20 with
             traj, from an empty store, at bounds 1, 4 and 8, on corpus
             rows in a seeded order and on a bucket drawn uniformly per
             call; the share of calls that found their engine kept, the
             median, mean and p90 wall, the median hit and miss, and the
             bytes the kept engines hold (allocated, and their graph
             pools);
  cplx     - the complex-candidate budget at -n 200 -ms 200 over the
             1,894 rows of 65-128 nt that the committed K=200 sweep
             folded at 128 (sweep_200n200_tpu.ckpt.jsonl): run_stream at
             bucket_config(128, 200, 200, 1000), B=16, G=4, once at the
             JAX sweep's budget (CPLX=512) and once at bucket_config's
             (cplx_budget): each fold's cplx_need (quantiles, the largest,
             the rows over 512, 1024 and 2048), flags by cause, seconds
             and seq/s; at bucket_config's budget every fold unflagged and
             its best row (struct, nrj) the committed one; the whole beam
             of every row flagged at 512 and of every unflagged row whose
             best row differs equal to fold_cpu's (a forkserver pool of
             the host's cores).  Then each budget's graph on one start
             state (the first 16 rows) in `--passes` rounds of 512, rule,
             rule, 512: host ms of a replay of G rounds to a
             synchronisation, and each stage's device ms a round (the
             stage clocks, read under a CPU-only profiler);
  need     - the budgets' need in one corpus band: the journal's rows of
             the --bucket N bucket (default 512) through run_stream at
             bucket_config(N, 100, --max-stack, 1000), B =
             bucket_batch(16, N), G=4, then at each region-slot width R
             of --rslots (default none) with the rest of that
             configuration: per R the flags by cause with the journal
             indices of the flagged rows, each fold's cplx_need and r_need
             (quantiles, the largest, the rows whose r_need is over 16),
             seconds, seq/s and the peak (allocated, plus the graph pool);
  mfe      - the batched MFE DP (mfe/mfe_torch.py) per MFE bucket (32 to
             1024 on a full batch of the bucket's first journal rows at
             bench_mfe's batch size, and 4096 on the longer 23S rRNA,
             B=1): ms per batch (CUDA events around whole fills after a
             warm-up, `--passes` of them; one at 4096), the peak's rise
             over the inputs; from torch.profiler over the first 128
             diagonals of a fill with and one without F: device ops per
             diagonal and per step of the exterior F loop, and the busy
             share (kernel ms over the unprofiled wall of the same cut
             fill; a fill of tens of thousands of launches cannot be
             enqueued ahead of a held device, whose launch queue fills
             up, so the events cannot give its device time alone); the
             host's copy and traceback seconds, and the native C++ DP's
             seconds on the same rows, whose structures and energies the
             card's must equal.
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

from rafft_tpu_torch.engine.fold_torch import region_slots

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
JOURNAL = os.path.join(ROOT, "benchmarks", "artifacts", "beams_100n50.jsonl.gz")
K200_SWEEP = os.path.join(ROOT, "benchmarks", "artifacts",
                          "sweep_200n200_tpu.ckpt.jsonl")
BUCKETS = (128, 256, 512, 1024, 2048, 4096)
# functions FoldEngine.step calls, each wrapped from outside for its rise
# of the peak (_stage_peaks); the profile phase reads the step's own stage
# ranges
STAGES = ("candidate_delta", "eval_pt", "analyze_pt", "_regions",
          "_top_lags", "enumerate_combos", "_combo_pt", "wavefront_tables")
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


def seeded_sequence(seed, nmin, nmax):
    """A random RNA sequence of nmin..nmax nt from numpy's default_rng."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(nmin, nmax + 1))
    return "".join("ACGU"[c] for c in rng.integers(0, 4, n))


def region_layouts(rng, rows, R, N, nmin, nmax):
    """Engine-valid region layouts: each beam row's unpaired positions of
    a random sequence of nmin..nmax nt split into up to R ascending
    regions (rpos N-padded, rcodes 0-padded).  Every 50th row is the
    step-0 layout (one whole region), row 1 has only empty regions and
    row 2 a single-position region."""
    rpos = np.full((rows, R, N), N, np.int32)
    rcodes = np.zeros((rows, R, N), np.int32)
    mlen = np.zeros((rows, R), np.int32)
    for b in range(rows):
        n = int(rng.integers(nmin, nmax + 1))
        codes = rng.integers(1, 5, size=n)
        keep = np.nonzero(rng.random(n) < rng.uniform(0.2, 1.0))[0]
        nreg = int(rng.integers(1, R + 1))
        slot = rng.integers(0, nreg, size=len(keep))
        if b % 50 == 0:
            keep, slot = np.arange(n), np.zeros(n, np.int64)
        for r in range(nreg):
            pos = keep[slot == r]
            rpos[b, r, : len(pos)] = pos
            rcodes[b, r, : len(pos)] = codes[pos]
            mlen[b, r] = len(pos)
    rpos[1], rcodes[1], mlen[1] = N, 0, 0
    rpos[2], rcodes[2], mlen[2] = N, 0, 0
    rpos[2, 0, 0], rcodes[2, 0, 0], mlen[2, 0] = 5, 2, 1
    return rcodes, rpos, mlen


# (N, batch, R, sequence lengths, K): the fold step's shapes in each bucket
# at K=50 (beam rows = batch x K: 800, 800, 400, 200, 100, 50) and in the
# 128 bucket at K=200 (3,200 rows)
K_BEAM = 50
KERNEL_SHAPES = tuple((N, nb, region_slots(N), lens, K) for N, nb, lens, K in (
    (128, 16, (60, 120), K_BEAM), (256, 16, (129, 256), K_BEAM),
    (512, 8, (257, 512), K_BEAM), (1024, 4, (513, 780), K_BEAM),
    (2048, 2, (1100, 2000), K_BEAM), (4096, 1, (2049, 3000), K_BEAM),
    (128, 16, (60, 120), 200)))

# what the bound takes of the card (NVIDIA's H100 SXM data sheet): 3.35
# TB/s of device memory; 67 TFLOP/s float32 counts a fused multiply-add
# as two, and the kernel may not fuse (--fmad=false), so 33.5e12 float32
# operations a second; int32 at half that rate
MEM_RATE = 3.35e12
F32_RATE = 33.5e12
INT_RATE = 16.75e12


def kernel_bound(work):
    """(bound ms, 'bytes' or 'operations', bytes ms, operations ms) of a
    wavefront_work() count."""
    b_ms = work["bytes"] / MEM_RATE * 1e3
    o_ms = (work["f32_ops"] / F32_RATE + work["int_ops"] / INT_RATE) * 1e3
    return max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations", b_ms, o_ms


def seeded_kernel_args(N, nb, R, lens, seed, dev, K=K_BEAM):
    """The wavefront wrapper's five tensors [nb, K, R, ...] on a seeded
    layout, with the engine's Zobrist draws."""
    z1, z2 = np.random.default_rng(0xA5F7).integers(
        1, 2**32 - 1, (2, N + 1), dtype=np.uint64).astype(np.uint32).view(np.int32)
    rc, rp, ml = region_layouts(np.random.default_rng(seed), nb * K, R,
                                N, *lens)
    rpc = np.clip(rp, 0, N)
    shape = (nb, K)
    return [torch.as_tensor(x.reshape(shape + x.shape[1:]), device=dev)
            for x in (rc, rp, ml, z1[rpc], z2[rpc])]


def capture_kernel_call(eng, seqs, call_no=4, every=None, out=None):
    """Fold `seqs` on `eng` and return the arguments (tensors cloned) of
    the call_no-th call of the wavefront wrapper: one real fold step.
    `every`, if given, is called with the arguments of each call (say
    wavefront.check_layout, to hold every step to the layout contract);
    `out`, if given, is a list that receives what run_stream yields.
    The fold runs eagerly (graphs off for its length): a graph replay
    calls no wrapper."""
    from rafft_tpu_torch.engine import fold_torch as FT
    real, calls, kept = FT.wavefront_tables, [], []

    def spy(*args, **kw):
        calls.append(1)
        if every is not None:
            every(*args)
        if len(calls) == call_no:
            kept.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a
                              for a in args))
        return real(*args, **kw)

    FT.wavefront_tables = spy
    graphs, eng.graphs = eng.graphs, False
    try:
        for item in eng.run_stream(seqs):
            if out is not None:
                out.append(item)
    finally:
        FT.wavefront_tables = real
        eng.graphs = graphs
    if not kept:
        raise AssertionError(f"the fold took fewer than {call_no} steps")
    return kept[0]


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_clone(v) for v in x)
    return x


def capture_calls(stage, run):
    """The positional arguments, tensors cloned, of every call of the
    fold step's wrapper fold_torch.<stage> (candidate_delta: (cfg, dp,
    codes, n, keys, pt, loops, rorder, rpos, ws); enumerate_combos: (cfg,
    Dd, Dn, Dh1, Dh2, s_r, energy, ph1, ph2, done, seen_h1, seen_h2,
    seen_cnt)) while run() runs: one per fold step run eagerly (a graph
    replay calls no wrapper)."""
    from rafft_tpu_torch.engine import fold_torch as FT
    real, calls = getattr(FT, stage), []

    def spy(*args, **kw):
        calls.append(_clone(args))
        return real(*args, **kw)

    setattr(FT, stage, spy)
    try:
        run()
    finally:
        setattr(FT, stage, real)
    return calls


def step_calls(stage, eng, seqs, steps):
    """capture_calls of `stage` over the first `steps` fold steps of
    `seqs` (at most eng.B of them) on `eng`, run eagerly from the
    unfolded root."""
    def run():
        st = eng.init_state(seqs[: eng.B])
        for _ in range(steps):
            st = eng.step(st)
    return capture_calls(stage, run)


STEP_KEYS = ("pt", "energy", "active", "rorder", "seen_h1", "seen_h2",
             "seen_cnt", "done", "cplx_dropped", "enum_suspect")


def lag_ranks(eng, state):
    """The lag order that FoldEngine.step gives the regions of `state` at
    non-integral weights: (lags [B,K,R,M], correlation [B,K,R,2N-1]),
    on the engine's device."""
    from rafft_tpu_torch.energy.eval_torch import analyze_pt, take
    from rafft_tpu_torch.engine import fold_torch as FT
    cfg, B = eng.cfg, eng.B
    K, N = cfg.K, cfg.N
    codes, pt, n = state["codes"], state["pt"], state["n"]
    loops = analyze_pt(eng.dp, codes[:, None].expand(B, K, N), pt,
                       n[:, None].expand(B, K))
    rpos, _, _, mlen = FT._regions(cfg, pt, loops["enclose"],
                                   state["rorder"], n)
    rcodes = torch.where(rpos < N, take(codes, rpos.clamp(0, N - 1)), 0)
    cor = FT._correlate(cfg, eng.W, rcodes, mlen, False)
    return FT._top_lags(cfg, cor)[0], cor


def first_difference_is_a_tie(eng_a, eng_b, seqs, tol):
    """Fold `seqs` on two engines of one configuration (say the card and
    the CPU) in lock-step: every step starts both from eng_a's state.
    Returns None when every step gives equal states.  Otherwise the first
    differing step must be explained by the correlation's float32 noise:
    the two engines' lag ranks differ there, and every differing rank
    swaps two lags whose correlations (eng_a's) differ by less than
    `tol`.  Returns (step, ranks swapped, largest gap) then, and raises
    AssertionError for any other difference."""
    st = eng_a.init_state(seqs)
    for step in range(eng_a.cfg.max_steps):
        if bool(st["done"].all()):
            break
        nxt_a = eng_a.step(st)
        st_b = {k: v.to(eng_b.device) for k, v in st.items()}
        nxt_b = eng_b.step(st_b)
        if all(torch.equal(nxt_a[k].cpu(), nxt_b[k].cpu()) for k in STEP_KEYS):
            st = nxt_a
            continue
        lags_a, cor_a = (x.cpu() for x in lag_ranks(eng_a, st))
        lags_b = lag_ranks(eng_b, st_b)[0].cpu()
        swapped = lags_a != lags_b
        if not bool(swapped.any()):
            raise AssertionError(f"step {step} differs between {eng_a.device} "
                                 f"and {eng_b.device} although the lag ranks "
                                 f"agree")
        gap = (cor_a.gather(-1, lags_a.long())
               - cor_a.gather(-1, lags_b.long())).abs()[swapped].max().item()
        if not gap < tol:
            raise AssertionError(f"step {step}: lag ranks differ by {gap}, "
                                 f"not by a tie (tolerance {tol})")
        return step, int(swapped.sum()), gap
    return None


def phase_kernel(rows_all, passes):
    from rafft_tpu_torch.energy import eval_torch as ET
    from rafft_tpu_torch.engine import wavefront as WT
    from rafft_tpu_torch.engine.fold_torch import EngineConfig, weight_matrix
    dev = torch.device("cuda")
    W = weight_matrix(3.0, 2.0, 1.0)
    for N, nb, R, lens, K in KERNEL_SHAPES:
        cfg = EngineConfig(N=N, K=K, R=R)
        dp = ET.device_params(cfg.temp, N, dev)
        tensors = seeded_kernel_args(N, nb, R, lens, 1, dev, K)
        cases = [("seeded", (cfg, WT.small_tables(dp, W, dev), *tensors))]
        # a real step where the journal has rows of the bucket (its
        # longest sequence has 780 nt); chip_smoke.py's long phase times
        # real steps of the 2048 and 4096 buckets
        rows = bucket_rows(rows_all, N, nb)[:nb]
        if rows:
            eng = _engine(N, K)
            cases.append(("real step", capture_kernel_call(
                eng, [r["seq"] for r in rows], every=WT.check_layout)))
            del eng
        # what the card takes to store the tables' bytes and nothing else
        fill = torch.empty(7 * 2 * N * tensors[2].numel(), dtype=torch.int32,
                           device=dev)
        log(f"[kernel] N={N}: zero_() of the seven tables' {fill.numel() * 4 / 1e6:.1f} "
            f"MB: {event_ms(fill.zero_, 200, queued=True):.4f} ms")
        del fill
        for what, args in cases:
            ms = [event_ms(lambda: WT.wavefront_tables(*args), 200, queued=True)
                  for _ in range(passes)]
            host = event_ms(lambda: WT.wavefront_tables(*args), 200)
            work = WT.wavefront_work(args[-3], N)
            bound, by, _, o_ms = kernel_bound(work)
            log(f"[kernel] N={N} {tuple(args[-3].shape)} x {N}, {what}: "
                f"median {_median(ms):.4f} ms/call "
                f"{[round(x, 4) for x in ms]} of device time ({host:.4f} "
                f"ms/call when the host's time per call counts); "
                f"{work['bytes'] / 1e6:.1f} MB, {work['positions']} positions, "
                f"{work['cells']} cells; bound {bound:.4f} ms by {by} "
                f"(operations {o_ms:.4f} ms); {bound / _median(ms):.1%} of the "
                f"bound's rate")


def phase_walk():
    from rafft_tpu_torch.energy import eval_torch as ET
    from rafft_tpu_torch.engine import wavefront as WT
    from rafft_tpu_torch.engine.fold_torch import EngineConfig, weight_matrix
    dev = torch.device("cuda")
    W = weight_matrix(3.0, 2.0, 1.0)
    rng = np.random.default_rng(0)

    def one_region(m):
        return lambda rows, R: [(0, 0, 0, m)]

    def in_every_row(m, per_row):
        return lambda rows, R: [(slice(None), r, r * m, m)
                                for r in range(per_row or R)]

    for N, nb, R, _, _ in (KERNEL_SHAPES[0], *KERNEL_SHAPES[2:4]):
        rows = nb * K_BEAM
        cfg = EngineConfig(N=N, K=K_BEAM, R=R)
        tabs = WT.small_tables(ET.device_params(cfg.temp, N, dev), W, dev)
        z = rng.integers(1, 2**31, (2, N + 1)).astype(np.int32)
        cases = [("every region empty", lambda rows, R: [])]
        cases += [(f"one region of {m}", one_region(m))
                  for m in (N // 4, N // 2, N - 8)]
        cases += [(f"{per or R} regions of {m} in every row",
                   in_every_row(m, per))
                  for m, per in ((8, 1), (8, 4), (8, 0), (32, 4))]
        for name, regions in cases:
            rp = np.full((rows, R, N), N, np.int32)
            rc = np.zeros((rows, R, N), np.int32)
            ml = np.zeros((rows, R), np.int32)
            for row, r, start, m in regions(rows, R):
                rp[row, r, :m] = start + np.arange(m)
                rc[row, r, :m] = rng.integers(1, 5, m)
                ml[row, r] = m
            rpc = np.clip(rp, 0, N)
            args = (cfg, tabs, *(torch.as_tensor(x, device=dev)
                                 for x in (rc, rp, ml, z[0][rpc], z[1][rpc])))
            ms = event_ms(lambda: WT.wavefront_tables(*args), 200, queued=True)
            log(f"[walk] N={N} {rows} x {R}, {name}: {ms:.4f} ms/call")


def event_ms(fn, reps, queued=False):
    """ms per call between two CUDA events around `reps` calls.  With
    `queued`, the device is first held busy (torch.cuda._sleep) so that
    the host enqueues every call before the first one runs: the events
    then bracket device time alone, not the host's time per call.  For
    a kernel shorter than its wrapper.  That the host was ahead is
    checked, not assumed: the first event (recorded behind the sleep)
    must still be pending when the last call has been enqueued; if it
    is not, the sleep is doubled and the run repeated, and after five
    such runs the function raises."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    cycles = int(reps * 0.3e-3 * 1.5e9)    # about 0.3 ms per call at 1.5 GHz
    for _ in range(5 if queued else 1):
        if queued:
            torch.cuda._sleep(cycles)
        t0.record()
        for _ in range(reps):
            fn()
        ahead = not t0.query()
        t1.record()
        torch.cuda.synchronize()
        if ahead or not queued:
            return t0.elapsed_time(t1) / reps
        cycles *= 2
    raise RuntimeError(f"event_ms: the host did not enqueue {reps} calls "
                       f"within a device sleep of {cycles // 2} cycles, so "
                       f"the events would hold the host's time per call")


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


def _engine(N, K=K_BEAM, graphs=False):
    """The sweep's engine of bucket N at -n 100 -ms 50, or -n 200 -ms 200;
    eager unless `graphs` (the profile phase wraps the eager step's
    calls)."""
    from rafft_tpu_torch.engine.fold_torch import FoldEngine
    from rafft_tpu_torch.parallel.sweep import bucket_batch, bucket_config
    return FoldEngine(bucket_config(N, max(100, K), K, 1000), B=bucket_batch(16, N),
                      device="cuda", graphs=graphs)


def _fold(eng, rows):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = list(eng.run_stream([r["seq"] for r in rows]))
    torch.cuda.synchronize()
    if len(out) != len(rows):
        raise AssertionError("run_stream did not yield every row")
    return time.perf_counter() - t0


PROFILE_ROWS = {128: 16, 256: 16, 512: 8, 1024: 4}


def _stage_peaks(eng, rows):
    """One more fold of `rows` with every stage wrapped: per stage the
    largest rise of the allocator's peak over what was allocated when it
    was entered (nested stages count in both), and the fold's peak and
    the state's bytes.  Allocation follows the host's enqueueing, so no
    synchronisation is needed."""
    from rafft_tpu_torch.engine import fold_torch as FT
    orig = {name: getattr(FT, name) for name in STAGES}
    rise = {}
    # per open stage (the fold at the bottom): the largest peak seen in it
    # before the allocator's counter was last reset
    frames = [0]

    def peaked(name, fn):
        def wrapped(*a, **kw):
            base = torch.cuda.memory_allocated()
            frames[-1] = max(frames[-1], torch.cuda.max_memory_allocated())
            frames.append(0)
            torch.cuda.reset_peak_memory_stats()
            try:
                return fn(*a, **kw)
            finally:
                own = max(frames.pop(), torch.cuda.max_memory_allocated())
                rise[name] = max(rise.get(name, 0), own - base)
                frames[-1] = max(frames[-1], own)
                torch.cuda.reset_peak_memory_stats()
        return wrapped

    state = eng.init_state([r["seq"] for r in rows[: eng.B]])
    state_bytes = sum(v.numel() * v.element_size() for v in state.values())
    del state
    for name, fn in orig.items():
        setattr(FT, name, peaked(name, fn))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        _fold(eng, rows)
    finally:
        for name, fn in orig.items():
            setattr(FT, name, fn)
    return rise, max(frames[0], torch.cuda.max_memory_allocated()), state_bytes


STAGE_RANGE = "rafft.stage."


def _trace_stats(path):
    """Kernel events and the step's stage ranges (rafft.stage.<name>) of
    a Chrome trace: total kernel ms, device op count, {stage: (kernel ms,
    host ms, calls)}."""
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
    ranges = {}
    for e in ev:
        if e.get("cat") == "user_annotation" \
                and e["name"].startswith(STAGE_RANGE):
            ranges.setdefault(e["name"][len(STAGE_RANGE):], []).append(
                (e["ts"], e["ts"] + e["dur"]))
    stages = {}
    for name, rng in ranges.items():
        lo, hi = np.array(sorted(rng)).T
        at = np.searchsorted(lo, k_ts, side="right") - 1
        inside = (at >= 0) & (k_ts < hi[np.clip(at, 0, None)])
        stages[name] = (k_dur[inside].sum() / 1e3, (hi - lo).sum() / 1e3,
                        len(rng))
    return k_dur.sum() / 1e3, len(kern), stages


def phase_profile(rows_all, out_dir, K=K_BEAM, buckets=(256, 512, 1024)):
    from torch.profiler import ProfilerActivity, profile

    from rafft_tpu_torch.engine import wavefront as WT

    for N in buckets:
        rows = bucket_rows(rows_all, N, PROFILE_ROWS[N])
        eng = _engine(N, K)
        _fold(eng, rows[: eng.B])
        wall = _fold(eng, rows)
        rise, peak, state_bytes = _stage_peaks(eng, rows)
        WT.LAUNCHES = 0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            pwall = _fold(eng, rows)
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
        log(f"[profile] N={N} K={K} B={eng.B}: {len(rows)} seqs, {steps} "
            f"steps; unprofiled wall {wall:.3f} s, profiled wall {pwall:.3f} "
            f"s; kernel {kms:.1f} ms; {nops} device ops ({nops / steps:.0f}"
            f"/step); busy share {100 * kms / 1e3 / pwall:.1f}% of the "
            f"profiled wall, {100 * kms / 1e3 / wall:.1f}% of the unprofiled "
            f"wall; peak {peak / MiB:.1f} MiB, the state {state_bytes / MiB:.1f}"
            f" MiB")
        for name, (dms, hms, calls) in sorted(stages.items(),
                                              key=lambda kv: -kv[1][0]):
            log(f"[profile] N={N} stage {name}: kernel {dms:.1f} ms, host "
                f"{hms:.1f} ms, {calls} calls")
        for name in STAGES:
            log(f"[profile] N={N} {name}: peak rise "
                f"{rise.get(name, 0) / MiB:.1f} MiB")


# phase graph: (tag, bucket, beam width K) at the sweep's configuration
GRAPH_CELLS = (("headline", 128, 50), ("1024", 1024, 50), ("k200", 128, 200))
GRAPH_G = 4
# host events that wait for the device
SYNC_EVENTS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
               "cudaEventSynchronize", "aten::item", "aten::_local_scalar_dense")


def _profiled(fn):
    """fn() under torch.profiler: (kernel ms, device ops, host events
    inside fn that wait for the device (SYNC_EVENTS))."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("measured_call"):
            fn()
        torch.cuda.synchronize()
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        kms, nops, _ = _trace_stats(path)
        with open(path) as fh:
            ev = json.load(fh)["traceEvents"]
    span = next(e for e in ev if e.get("name") == "measured_call"
                and e.get("cat") == "user_annotation")
    lo, hi = span["ts"], span["ts"] + span["dur"]
    syncs = sum(e.get("name") in SYNC_EVENTS and lo <= e["ts"] <= hi
                for e in ev)
    return kms, nops, syncs


def _synced(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def host_us(fn, reps):
    """Host microseconds per call of fn, with the device held busy so that
    no call waits for it (the host's cost of enqueueing alone)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(reps * 1e-3 * 1.5e9))   # about 1 ms a call
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return secs / reps * 1e6


def pool_bytes(eng):
    """Bytes of the segments of `eng`'s CUDA graph pool (0 before its
    first capture).  What the graphs hold there is free between replays,
    so max_memory_allocated does not count it: add it to the peak."""
    if eng._pool is None:
        return 0
    pool = tuple(eng._pool)
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == pool)


def graph_ms(fn, reps):
    """Device ms of fn() captured as a CUDA graph (after one eager call)
    and replayed `reps` times between two events: a call of hundreds of
    small ops would fill the launch queue before a held device, so
    event_ms(queued=True) cannot give its device time."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    return event_ms(g.replay, reps)


def graph_cell(rows_all, N, K, passes, G=GRAPH_G):
    """The graphed and the eager fold path of one configuration, in one
    process: see the module note (phase graph).  Returns the numbers as a
    dict and prints them."""
    from rafft_tpu_torch.engine import wavefront as WT
    from rafft_tpu_torch.engine.fold_torch import FoldEngine
    from rafft_tpu_torch.parallel.sweep import bucket_batch, bucket_config
    cfg = bucket_config(N, max(100, K), K, 1000)
    B = bucket_batch(16, N)
    rows = ([r for r in rows_all if len(r["seq"]) <= 120] if N == 128
            else bucket_rows(rows_all, N, B))[:B]
    seqs = [r["seq"] for r in rows]
    eager = FoldEngine(cfg, B=B, device="cuda", graphs=False)
    graph = FoldEngine(cfg, B=B, device="cuda")
    start = eager.init_state(seqs, seqids=list(range(len(seqs))))
    eager._advance(start, G)
    # the graph's pool: what its capture keeps reserved beyond the static
    # state and the kernel's tables (the allocator's cache emptied around)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    r0 = torch.cuda.memory_reserved()
    t_capture = _synced(lambda: graph._advance_graphed(start, G))
    torch.cuda.empty_cache()
    kept = sum(v.numel() * v.element_size()
               for v in (*graph._static.values(),
                         *graph._tables_out.values()))
    pool = torch.cuda.memory_reserved() - r0 - kept
    by_snapshot = pool_bytes(graph)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    want = eager._advance(start, G)
    eager_rise = torch.cuda.max_memory_allocated() - base
    got = graph._advance_graphed(start, G)
    diff = [k for k in want if not torch.equal(want[k], got[k])]
    if diff:
        raise AssertionError(f"graph {N}/{K}: states differ in {diff}")
    del want, got
    # ms per step from the same start state, in turns
    ms = {"eager": [], "graph": []}
    for _ in range(passes):
        for who in ("eager", "graph", "graph", "eager"):
            fn = (eager._advance if who == "eager"
                  else graph._advance_graphed)
            ms[who].append(_synced(lambda: fn(start, G)) * 1e3 / G)
    prof = {who: _profiled(lambda: fn(start, G)) for who, fn in
            (("eager", eager._advance), ("graph", graph._advance_graphed))}
    # the wrapper's host time on a real step's arguments (the 4th)
    args = capture_kernel_call(eager, seqs)
    out = WT.empty_tables(args[2].shape, args[2].device)
    wrap_alloc = host_us(lambda: WT.wavefront_tables(*args), 200)
    wrap_fixed = host_us(lambda: WT.wavefront_tables(*args, out=out), 200)
    # one replay's host time, the device idle before it (replays queued
    # behind each other wait for the launch queue: that is device time)
    replay = graph._graphs[("_advance", G)][0]
    replay_step = min(host_us(replay.replay, 1) for _ in range(3)) / G
    # the complex candidates at the fixed width CPLX against the longest
    # complex prefix of each step (the width the eager step trimmed to)
    st, widths, fixed_ms, trimmed_ms = start, [], 0.0, 0.0
    for _ in range(8):
        c = eager.candidates(st)
        n_on = int((c["cplx"] & c["lag_ok"]).sum((1, 2, 3)).max())
        widths.append(min(n_on, cfg.CPLX))
        fixed_ms += graph_ms(lambda: eager.complex_delta(st, c), 5)
        trimmed_ms += graph_ms(lambda: eager.complex_delta(
            st, c, width=widths[-1]), 5)
        st = eager.step(st)
    rec = dict(
        N=N, K=K, B=B, G=G, ops_per_step={w: prof[w][1] / G for w in prof},
        ms_per_step={w: ms[w] for w in ms},
        median_ms_per_step={w: _median(ms[w]) for w in ms},
        kernel_ms_per_step={w: prof[w][0] / G for w in prof},
        syncs_in_call={w: prof[w][2] for w in prof},
        capture_s=t_capture, pool_bytes=pool, pool_bytes_snapshot=by_snapshot,
        eager_peak_rise=eager_rise, static_bytes=kept,
        wrapper_host_us=dict(allocating=wrap_alloc, fixed_tables=wrap_fixed),
        replay_host_us_per_step=replay_step,
        cplx=dict(width=cfg.CPLX, longest_prefix=widths,
                  fixed_ms=fixed_ms / len(widths),
                  trimmed_ms=trimmed_ms / len(widths)))
    log(f"[graph] N={N} K={K} B={B} G={G}: device ops/step eager "
        f"{rec['ops_per_step']['eager']:.0f}, graph "
        f"{rec['ops_per_step']['graph']:.0f}; ms/step (median of {passes * 2}"
        f", in turns) eager {rec['median_ms_per_step']['eager']:.3f}, graph "
        f"{rec['median_ms_per_step']['graph']:.3f} (all: eager "
        f"{[round(x, 3) for x in ms['eager']]}, graph "
        f"{[round(x, 3) for x in ms['graph']]}); kernel ms/step eager "
        f"{rec['kernel_ms_per_step']['eager']:.3f}, graph "
        f"{rec['kernel_ms_per_step']['graph']:.3f}; host syncs in a call: "
        f"eager {rec['syncs_in_call']['eager']}, graph "
        f"{rec['syncs_in_call']['graph']}")
    log(f"[graph] N={N} K={K}: capture (warm-up round included) "
        f"{t_capture:.3f} s; graph pool {pool / MiB:.1f} MiB (reserved, less "
        f"the {kept / MiB:.1f} MiB of static state and kernel tables; "
        f"segments of the pool {by_snapshot / MiB:.1f} MiB); eager "
        f"_advance's peak rise {eager_rise / MiB:.1f} MiB; wrapper host "
        f"{wrap_alloc:.1f} us/call allocating, {wrap_fixed:.1f} us/call into "
        f"fixed tables, none in a replay (replay host {replay_step:.1f} "
        f"us/step)")
    log(f"[graph] N={N} K={K}: complex candidates at CPLX={cfg.CPLX}, device "
        f"{rec['cplx']['fixed_ms']:.3f} ms/step against "
        f"{rec['cplx']['trimmed_ms']:.3f} at the longest prefix (widths "
        f"{widths} over the first {len(widths)} steps)")
    return rec


def phase_graph(rows_all, passes):
    out = []
    for tag, N, K in GRAPH_CELLS:
        out.append(dict(cell=tag, **graph_cell(rows_all, N, K, passes)))
        torch.cuda.empty_cache()
    return out


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
    eng = FoldEngine(EngineConfig(**HEADLINE), B=16, device="cuda",
                     graphs=False)
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


MFE_BUCKETS = (32, 64, 128, 256, 512, 1024, 4096)


class _SilentStages:
    """A stage clock that marks nothing."""
    idle = True

    def to(self, name):
        pass

    round = resume = lambda self: None


def phase_obs(rows_all, passes, G=GRAPH_G):
    from torch.profiler import ProfilerActivity, profile

    from rafft_tpu_torch import obs
    from rafft_tpu_torch.engine.fold_torch import FoldEngine
    from rafft_tpu_torch.parallel.sweep import bucket_batch, bucket_config

    def span_s(reps):
        t0 = time.perf_counter()
        for _ in range(reps):
            with obs.span("measure.probe"):
                pass
        return (time.perf_counter() - t0) / reps

    off_ns = min(span_s(100_000) for _ in range(3)) * 1e9
    with profile(activities=[ProfilerActivity.CPU]):
        on_us = min(span_s(10_000) for _ in range(3)) * 1e6
    obs.clear()
    log(f"[obs] a span: {off_ns:.0f} ns with the profiler off, {on_us:.2f} "
        f"us with it on")

    cfg = bucket_config(128, 100, K_BEAM, 1000)
    B = bucket_batch(16, 128)
    seqs = [r["seq"] for r in rows_all if len(r["seq"]) <= 120][:B]
    timed = FoldEngine(cfg, B=B, device="cuda")
    plain = FoldEngine(cfg, B=B, device="cuda")
    start = timed.init_state(seqs, seqids=list(range(len(seqs))))
    want = {k: v.clone() for k, v in timed._advance_graphed(start, G).items()}
    # a capture with no timing event: a stage clock that records nothing
    graph_stages = obs.GraphStages
    obs.GraphStages = _SilentStages
    try:
        got = plain._advance_graphed(start, G)
    finally:
        obs.GraphStages = graph_stages
    diff = [k for k in want if not torch.equal(want[k], got[k])]
    if diff:
        raise AssertionError(f"obs: the graphs' states differ in {diff}")
    key = ("_advance", G)
    marks = len(timed._graphs[key][2].marks)
    ms = {"without": [], "with": []}
    for _ in range(passes):
        for who in ("without", "with", "with", "without"):
            eng = timed if who == "with" else plain
            ms[who].append(event_ms(eng._graphs[key][0].replay, 20))
    graph = timed._graphs[key][0]

    def launch_ms(reps=5):
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            graph.replay()
            out.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
        return out

    launch = {"off": launch_ms()}
    for tag, acts in (("cpu", [ProfilerActivity.CPU]),
                      ("cpu+cuda", [ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA])):
        with profile(activities=acts):
            launch[tag] = launch_ms()
    log("[obs] host ms until replay() returns (device idle before): "
        + "; ".join(f"profiler {k} {_median(v):.3f} {[round(x, 3) for x in v]}"
                    for k, v in launch.items()))
    obs.clear()
    reps = 20
    read_s = 0.0
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(reps):
            timed._graphs[key][0].replay()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            timed._graphs[key][2].read()
            read_s += time.perf_counter() - t0
    snap = obs.snapshot()
    obs.clear()
    stages = {k: v / reps for k, v in snap["stage_ms"].items()}
    log(f"[obs] headline B={B} G={G}: {marks} timing events a replay; "
        f"device ms a replay with them {_median(ms['with']):.3f} "
        f"{[round(x, 3) for x in ms['with']]}, without "
        f"{_median(ms['without']):.3f} "
        f"{[round(x, 3) for x in ms['without']]}; reading a replay's stage "
        f"clock {1e3 * read_s / reps:.3f} ms on the host; its stages "
        f"{sum(stages.values()):.3f} ms on the device: "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    return dict(span_off_ns=off_ns, span_on_us=on_us, marks=marks,
                replay_ms=ms, launch_ms=launch, read_ms=1e3 * read_s / reps,
                stage_ms=stages)


def quantiles(xs):
    xs = np.sort(np.asarray(xs))
    return {f"p{q}": int(xs[min(len(xs) - 1, int(q / 100 * len(xs)))])
            for q in (50, 90, 99)} | {"max": int(xs[-1])}


def phase_cplx(passes, G=GRAPH_G):
    import dataclasses
    import multiprocessing

    from torch.profiler import ProfilerActivity, profile

    from rafft_tpu_torch import obs
    from rafft_tpu_torch.engine.fold_torch import (FLAG_CPLX, FoldEngine,
                                                   flag_names)
    from rafft_tpu_torch.parallel.sweep import (_cpu_refold, bucket_batch,
                                                bucket_config)
    with open(K200_SWEEP) as fh:
        rows = [r for r in map(json.loads, fh) if r["_bucket"] == 128]
    seqs = [r["seq"] for r in rows]
    rule = bucket_config(128, 200, 200, 1000)
    cfgs = {"jax": dataclasses.replace(rule, CPLX=512), "rule": rule}
    B = bucket_batch(16, 128)
    rec, engines, beams = {}, {}, {}
    for tag, cfg in cfgs.items():
        eng = engines[tag] = FoldEngine(cfg, B=B, device="cuda")
        list(eng.run_stream(seqs[:B], G))          # capture, warm
        needs, got = {}, {}
        t0 = time.perf_counter()
        for i, beam, flag in eng.run_stream(seqs, G, needs=needs):
            got[i] = (beam, flag)
        secs = time.perf_counter() - t0
        need = [needs[i][0] for i in range(len(seqs))]
        causes = {}
        for _, flag in got.values():
            if flag:
                causes[flag_names(flag)] = causes.get(flag_names(flag), 0) + 1
        over = {w: sum(n > w for n in need) for w in (512, 1024, 2048)}
        rec[tag] = dict(CPLX=cfg.CPLX, rows=len(seqs), seconds=secs,
                        seq_per_s=len(seqs) / secs, flags=causes,
                        need=quantiles(need), over=over,
                        cplx_flagged=[i for i, (_, f) in got.items()
                                      if f & FLAG_CPLX],
                        needs=need)
        beams[tag] = got
        log(f"[cplx] CPLX={cfg.CPLX}: {len(seqs)} rows in {secs:.3f} s "
            f"({len(seqs) / secs:.3f} seq/s); flags {causes}; cplx_need "
            f"{rec[tag]['need']}, rows over 512/1024/2048 {over}; "
            f"histogram (bins of 256) "
            f"{np.bincount(np.asarray(need) // 256).tolist()}")
    got = beams["rule"]
    flagged = [i for i, (_, f) in got.items() if f]
    differ = [i for i, (beam, f) in got.items() if not f and tuple(
        beam[0]) != (rows[i]["struct"], rows[i]["nrj"])]
    refold = sorted(set(rec["jax"]["cplx_flagged"]) | set(differ))
    t0 = time.perf_counter()
    with multiprocessing.get_context("forkserver").Pool(
            min(os.cpu_count() or 1, max(1, len(refold)))) as pool:
        cpu = {i: beam for i, beam, _ in pool.map(
            _cpu_refold, [(i, seqs[i], 200, 200, 1000) for i in refold],
            chunksize=1)}
    wrong = [i for i in refold
             if [tuple(x) for x in got[i][0]] != [tuple(x) for x in cpu[i]]]
    rec["check"] = dict(flagged=flagged, best_row_differs=differ,
                        refolded=refold, refold_s=time.perf_counter() - t0,
                        beam_differs_from_fold_cpu=wrong)
    log(f"[cplx] CPLX={rule.CPLX}: {len(flagged)} flagged; "
        f"{len(seqs) - len(flagged) - len(differ)} best rows equal the "
        f"committed sweep, {len(differ)} differ (rows {differ}); fold_cpu "
        f"refolded {len(refold)} rows (flagged at 512 or differing) in "
        f"{rec['check']['refold_s']:.1f} s: whole beams differ in {wrong}")
    if flagged or wrong:
        raise AssertionError(f"cplx: flagged {flagged}, beams that differ "
                             f"from fold_cpu {wrong}")
    # one start state, each budget's graph in turns
    nb = engines["jax"].B
    start = engines["jax"].init_state(seqs[:nb], seqids=list(range(nb)))
    host = {tag: [] for tag in cfgs}
    stage = {tag: {} for tag in cfgs}
    for _ in range(passes):
        for tag in ("jax", "rule", "rule", "jax"):
            eng = engines[tag]
            host[tag].append(1e3 * _synced(
                lambda: eng._advance_graphed(start, G)))
            obs.clear()
            with profile(activities=[ProfilerActivity.CPU]):
                eng._advance_graphed(start, G)
                torch.cuda.synchronize()
                eng._read_stages()
            for k, v in obs.snapshot()["stage_ms"].items():
                stage[tag].setdefault(k, []).append(v / G)
            obs.clear()
    for tag in cfgs:
        rec[tag].update(replay_host_ms=host[tag], stage_ms_per_round={
            k: _median(v) for k, v in stage[tag].items()})
        st = rec[tag]["stage_ms_per_round"]
        log(f"[cplx] CPLX={cfgs[tag].CPLX}: a replay of {G} rounds "
            f"{_median(host[tag]):.3f} ms ({[round(x, 3) for x in host[tag]]}"
            f"); stages a round (medians) {sum(st.values()):.3f} ms: "
            + ", ".join(f"{k} {v:.3f}" for k, v in st.items()))
    return rec


def phase_need(rows_all, N, K, rslots, G=GRAPH_G):
    import dataclasses

    from rafft_tpu_torch.engine.fold_torch import FoldEngine, flag_names
    from rafft_tpu_torch.parallel.sweep import bucket_batch, bucket_config
    index = [i for i, r in enumerate(rows_all)
             if next(b for b in BUCKETS if len(r["seq"]) <= b) == N]
    seqs = [rows_all[i]["seq"] for i in index]
    rule = bucket_config(N, 100, K, 1000)
    B = bucket_batch(16, N)
    rec = []
    for R in [rule.R] + [R for R in rslots if R != rule.R]:
        cfg = dataclasses.replace(rule, R=R)
        eng = FoldEngine(cfg, B=B, device="cuda")
        list(eng.run_stream(seqs[:B], G))          # capture, warm
        needs, causes = {}, {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for i, _beam, flag in eng.run_stream(seqs, G, needs=needs):
            if flag:
                causes.setdefault(flag_names(flag), []).append(index[i])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() + pool_bytes(eng)
        cplx, rn = zip(*(needs[i] for i in range(len(seqs))))
        r = dict(N=N, K=K, R=R, CPLX=cfg.CPLX, B=B, rows=len(seqs),
                 seconds=secs, seq_per_s=len(seqs) / secs,
                 peak_mib=peak / MiB, flags=causes,
                 cplx_need=quantiles(cplx), r_need=quantiles(rn),
                 r_need_over_16={index[i]: n for i, n in enumerate(rn)
                                 if n > 16},
                 r_need_histogram=np.bincount(rn).tolist())
        rec.append(r)
        log(f"[need] N={N} K={K} R={R} CPLX={cfg.CPLX} B={B}: {len(seqs)} "
            f"rows in {secs:.3f} s ({r['seq_per_s']:.3f} seq/s), peak "
            f"{r['peak_mib']:.1f} MiB; flags by cause (journal rows) "
            f"{causes}; cplx_need {r['cplx_need']}; r_need {r['r_need']}, "
            f"over 16 (journal row: need) {r['r_need_over_16']}, histogram "
            f"{r['r_need_histogram']}")
        del eng
        torch.cuda.empty_cache()
    return rec


TAIL_CALLS = 100


def phase_tail(rows_all, calls=TAIL_CALLS):
    from torch.profiler import ProfilerActivity, profile

    from rafft_tpu_torch import obs
    from rafft_tpu_torch.engine import fold_torch as FT
    seqs = [r["seq"] for r in rows_all if 65 <= len(r["seq"]) <= 128]
    order = np.random.default_rng(15).permutation(len(seqs))[: calls + 2]
    kw = dict(nb_mode=100, max_stack=20, max_branch=1000, traj=True,
              device="cuda")
    for i in order[:2]:
        FT.fold(seqs[i], **kw)
    torch.cuda.synchronize()
    walls, per = [], []           # per call: {span: ms}
    with profile(activities=[ProfilerActivity.CPU]):
        for i in order[2:]:
            obs.clear()
            t0 = time.perf_counter()
            FT.fold(seqs[i], **kw)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            spans = obs.snapshot()["spans"]
            d = {k: 1e3 * v["total_s"] for k, v in spans.items()
                 if not k.startswith("stage.")}
            d["unspanned"] = 1e3 * spans["fold.call"]["self_s"]
            per.append(d)
    obs.clear()
    reqs = sorted(range(len(per)), key=lambda r: per[r]["fold.call"])
    cut = len(reqs) - len(reqs) // 10
    slow, rest = reqs[cut:], reqs[:cut]
    names = sorted({n for d in per for n in d} - {"fold.call"})

    def mean(group, n):
        return sum(per[r].get(n, 0.0) for r in group) / len(group)
    excess = {n: mean(slow, n) - mean(rest, n) for n in names}
    ms = np.asarray(walls) * 1e3
    log(f"[tail] {len(walls)} calls: wall median {np.median(ms):.1f} ms, p90 "
        f"{np.percentile(ms, 90):.1f}; fold.call of the slowest tenth "
        f"{mean(slow, 'fold.call'):.1f} ms against {mean(rest, 'fold.call'):.1f}"
        " for the others")
    for n in sorted(names, key=lambda n: -excess[n]):
        log(f"[tail] {n}: slowest tenth {mean(slow, n):.1f} ms, others "
            f"{mean(rest, n):.1f} ms, excess {excess[n]:+.1f} ms")
    return dict(walls_ms=ms.tolist(), per_call=[per[r] for r in reqs],
                excess_ms=excess)


KEPT_CALLS = 120
KEPT_BOUNDS = (1, 4, 8)


def phase_kept(calls=KEPT_CALLS, bounds=KEPT_BOUNDS):
    """fold_one's kept engines under traffic that changes configuration:
    for each bound (fold_torch.KEPT_ENGINES set to it), the same seeded
    calls from empty store, at -ms 20 with traj (the api cell's
    settings).  Two orders: `corpus`, rows of the whole corpus
    (tools/corpus.py, every bucket 32-4096 at its share of the rows),
    and `buckets`, a bucket drawn uniformly, then one of its rows.
    fold_one shares fold's store and does not refold a flagged fold on
    the CPU (a 23S refold takes minutes)."""
    from rafft_tpu_torch.engine import fold_torch as FT
    from rafft_tpu_torch.tools.corpus import corpus
    seqs = [s for s, _ in corpus()]
    kw = dict(nb_mode=100, max_stack=20, max_branch=1000, traj=True,
              device="cuda")
    cfg = lambda s: FT.fold_one_config(len(s), 100, 20, 1000)
    by_n = {}
    for s in seqs:
        by_n.setdefault(cfg(s).N, []).append(s)
    rng = np.random.default_rng(16)
    orders = dict(corpus=[seqs[i] for i in rng.integers(len(seqs), size=calls)])
    ns = sorted(by_n)
    orders["buckets"] = [by_n[n][rng.integers(len(by_n[n]))]
                         for n in rng.choice(ns, size=calls)]
    saved = FT.KEPT_ENGINES
    FT.fold_one("GGGAAACCC", **kw)       # the process's first-call costs
    recs = {}
    try:
        for name, order in orders.items():
            for bound in bounds:
                FT.KEPT_ENGINES = bound
                FT.release_engines()
                torch.cuda.empty_cache()
                base = torch.cuda.memory_allocated()
                hits, walls = [], []
                for s in order:
                    hits.append(FT._engine_key(cfg(s), "cuda") in FT._kept)
                    t0 = time.perf_counter()
                    FT.fold_one(s, **kw)
                    torch.cuda.synchronize()
                    walls.append(1e3 * (time.perf_counter() - t0))
                ms, hit = np.asarray(walls), np.asarray(hits)
                rec = dict(
                    hit_pct=float(100.0 * hit.mean()), p50_ms=float(np.median(ms)),
                    mean_ms=float(ms.mean()),
                    p90_ms=float(np.percentile(ms, 90)),
                    hit_ms=float(np.median(ms[hit])) if hit.any() else None,
                    miss_ms=float(np.median(ms[~hit])) if (~hit).any()
                    else None,
                    kept=len(FT._kept),
                    held_bytes=torch.cuda.memory_allocated() - base,
                    pool_bytes=sum(pool_bytes(e) for e in FT._kept.values()))
                recs[f"{name}.{bound}"] = rec
                log(f"[kept] {name} bound {bound}: {rec}")
        log(f"[kept] buckets {{N: rows}}: "
            f"{ {n: len(v) for n, v in sorted(by_n.items())} }")
    finally:
        FT.KEPT_ENGINES = saved
        FT.release_engines()
    return recs


def mfe_bucket_rows(rows_all, N, count):
    """The first `count` journal rows of MFE bucket N (bench_mfe's
    bucketing); at 4096 the longer of the corpus' two 23S rRNAs."""
    from rafft_tpu_torch.tools.bench_mfe import mfe_bucket
    if N == 4096:
        with open(os.path.join(ROOT, "benchmarks", "artifacts",
                               "longtail.ckpt.jsonl")) as fh:
            long = [json.loads(line) for line in fh]
        return sorted(long, key=lambda r: -len(r["seq"]))[:count]
    return [r for r in rows_all if mfe_bucket(len(r["seq"])) == N][:count]


def mfe_profile(eng, seqs, diagonals=None):
    """torch.profiler (device activity) over one fill of `seqs`, after an
    unprofiled one, without and with the exterior F loop.  With
    `diagonals` the fill is cut to its first that many diagonals (and as
    many F steps): a diagonal issues the same ops at every d >= 8, N and
    B, and the trace of a whole long fill costs minutes.  Returns the
    diagonals run, device ops per diagonal (the set-up before the loop
    counted in), device ops per F step, the kernel ms of the fill, and
    the host-clock ms of the unprofiled fill (synchronised), over which
    the kernel ms are the device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    from rafft_tpu_torch.mfe import mfe_torch as MT
    codes, n, n_max = eng._encode(seqs)
    if diagonals:
        n_max = min(n_max, diagonals + 4)
    steps = max(n_max - 4, 1)
    stats = {}
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    for with_f in (False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        MT._mfe_fill(eng.dp, codes, n, with_f=with_f, n_max=n_max)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            MT._mfe_fill(eng.dp, codes, n, with_f=with_f, n_max=n_max)
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory(dir=build) as tmp:
            prof.export_chrome_trace(os.path.join(tmp, "t.json"))
            stats[with_f] = _trace_stats(os.path.join(tmp, "t.json"))[:2]
    return dict(steps=steps, ops_per_diagonal=stats[False][1] / steps,
                f_ops_per_step=(stats[True][1] - stats[False][1]) / steps,
                kernel_ms=stats[True][0], wall_ms=wall * 1e3)


def phase_mfe(rows_all, passes):
    from rafft_tpu_torch.mfe import mfe_fold
    from rafft_tpu_torch.mfe import mfe_torch as MT
    from rafft_tpu_torch.tools.bench_mfe import mfe_bucket_batch
    for N in MFE_BUCKETS:
        rows = mfe_bucket_rows(rows_all, N, mfe_bucket_batch(16, N))
        seqs = [r["seq"] for r in rows]
        eng = MT.MfeEngine(N, B=len(seqs), device="cuda")
        codes, n, n_max = eng._encode(seqs)

        def fill():
            return MT._mfe_fill(eng.dp, codes, n, n_max=n_max)

        if N <= 1024:
            fill()                  # warm-up (4096 comes after 1024's)
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ms, walls = [], []
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(passes if N <= 1024 else 1):
            w0 = time.perf_counter()
            t0.record()
            out = fill()
            t1.record()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - w0)
            ms.append(t0.elapsed_time(t1))
            del out
        rise = torch.cuda.max_memory_allocated() - base
        wall = _median(walls)
        prof = mfe_profile(eng, seqs, diagonals=128)
        timing = {}
        got = eng.fold(seqs, timing=timing)
        t0 = time.perf_counter()
        want = [mfe_fold(s) for s in seqs]
        native = time.perf_counter() - t0
        if got != want:
            bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
            raise AssertionError(f"mfe N={N}: rows {bad} differ from the "
                                 f"native DP")
        log(f"[mfe] N={N} B={len(seqs)} ({min(map(len, seqs))}-"
            f"{max(map(len, seqs))} nt, {n_max - 4} diagonals): fill median "
            f"{_median(ms):.3f} ms per batch {[round(x, 3) for x in ms]} "
            f"(events; host clock {wall * 1e3:.1f} ms); peak rise "
            f"{rise / MiB:.1f} MiB; profile of the first {prof['steps']} "
            f"diagonals: {prof['ops_per_diagonal']:.1f} device ops per "
            f"diagonal and {prof['f_ops_per_step']:.1f} per F step, kernel "
            f"{prof['kernel_ms']:.2f} ms, busy share "
            f"{100 * prof['kernel_ms'] / prof['wall_ms']:.1f}% of its "
            f"unprofiled wall ({prof['wall_ms']:.1f} ms); fold "
            f"{timing['fill']:.3f} s fill + "
            f"{timing['host']:.3f} s copies and tracebacks; native DP "
            f"{native:.3f} s for the same rows; {len(seqs)}/{len(seqs)} "
            f"equal it")
        del eng, codes, n
        torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="loops,profile")
    ap.add_argument("--passes", type=int, default=5)
    ap.add_argument("--out", help="directory for the profiler tables")
    ap.add_argument("--against", help="another checkout, for the swap phase")
    ap.add_argument("--max-stack", dest="max_stack", type=int, default=K_BEAM,
                    help="the profile and need phases' beam width K (default "
                         "50; 200 for the -n 200 -ms 200 configuration)")
    ap.add_argument("--profile-buckets", dest="profile_buckets",
                    default="256,512,1024",
                    help="the profile phase's buckets, of 128/256/512/1024")
    ap.add_argument("--bucket", type=int, default=512,
                    help="the need phase's bucket (default 512)")
    ap.add_argument("--rslots", default="",
                    help="the need phase's further region-slot widths R, "
                         "comma-separated (default none)")
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
        elif ph == "profile":
            phase_profile(rows, args.out, args.max_stack,
                          [int(b) for b in args.profile_buckets.split(",")])
        elif ph == "kernel":
            phase_kernel(rows, args.passes)
        elif ph == "walk":
            phase_walk()
        elif ph == "swap":
            phase_swap(rows, args.against, args.passes)
        elif ph == "mfe":
            phase_mfe(rows, args.passes)
        elif ph == "tail":
            rec = phase_tail(rows)
            if args.out:
                with open(os.path.join(args.out, "tail.json"), "w") as fh:
                    json.dump(rec, fh, indent=1)
        elif ph == "cplx":
            rec = phase_cplx(args.passes)
            if args.out:
                with open(os.path.join(args.out, "cplx.json"), "w") as fh:
                    json.dump(rec, fh)
        elif ph == "need":
            rec = phase_need(rows, args.bucket, args.max_stack,
                             [int(R) for R in args.rslots.split(",") if R])
            if args.out:
                with open(os.path.join(args.out, "need.json"), "w") as fh:
                    json.dump(rec, fh, indent=1)
        elif ph == "kept":
            rec = phase_kept()
            if args.out:
                with open(os.path.join(args.out, "kept.json"), "w") as fh:
                    json.dump(rec, fh, indent=1)
        elif ph == "obs":
            rec = phase_obs(rows, args.passes)
            if args.out:
                with open(os.path.join(args.out, "obs.json"), "w") as fh:
                    json.dump(rec, fh, indent=1)
        elif ph == "graph":
            recs = phase_graph(rows, args.passes)
            if args.out:
                with open(os.path.join(args.out, "graph.json"), "w") as fh:
                    json.dump(recs, fh, indent=1)
        else:
            raise SystemExit(f"measure: unknown phase {ph}")
        log(f"[{ph}] took {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
