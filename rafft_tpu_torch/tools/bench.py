"""The port's benchmark entry point (counterpart of the root bench.py).

Folds the in-repo corpus (tools/corpus.py) with the port's FoldEngine at
-n 100 -ms 50 --max_branch 1000 and prints ONE JSON line with bench.py's
keys:

  metric, value, unit  fold_throughput_n100_ms50_le120nt, in seq/s: the
                       headline, the first 256 corpus sequences of at most
                       120 nt at N=128, K=50, B=16 after a warm-up on the
                       first 16;
  vs_baseline          value over baseline_seqs_per_s, the port's CPU
                       baseline (testdata/baseline_cpu.json, written by
                       tools/measure_baseline.py);
  n_seqs, gcups        the headline's folds, and its sum of squared
                       lengths over its seconds, in 1e9 a second;
  per_bucket           {N: {seqs_per_s, sampled, corpus_n}} for each
                       (N, sample) of BUCKET_SAMPLES: the first `sample`
                       sequences of bucket N at the sweep's configuration
                       (parallel/sweep.py: bucket_config(N, 100, 50, 1000),
                       B = bucket_batch(16, N)) after a warm-up on the
                       first B;
  corpus_seqs_per_s    the whole-corpus rate the bucket rates imply: the
                       corpus's bucket counts over the sum of count / rate;
  corpus_covered       the corpus sequences of those buckets (2,294);
  corpus_excluded_gt1024nt  the rest (the two 23S rRNAs);

plus `device`, the name of the card (or "cpu"), and `passes`, the
seconds of each timed pass of each cell.  A cell's rate is its count
over the median of its passes; with one pass (the default) that is
bench.py's own reading.  Numbers are not rounded.

Where this differs from bench.py: every bucket runs at the sweep's
configuration, which takes CPLX=1024 above N=128 (bench.py builds its
own with CPLX=512); the corpus is the in-repo one (bench.py reads a CSV
that is absent here, then folds 64 random sequences); the device is a
CUDA card unless the caller names another, with no fallback; and a
missing baseline raises (bench.py divides by 1.0).

    python -m rafft_tpu_torch.tools.bench [--device cuda] [--passes 1]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time
from typing import NamedTuple

import torch

from rafft_tpu_torch.engine.fold_torch import FoldEngine
from rafft_tpu_torch.parallel.sweep import bucket_batch, bucket_config
from rafft_tpu_torch.tools.corpus import by_bucket, corpus, headline_rows

BASELINE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "testdata", "baseline_cpu.json")
METRIC = "fold_throughput_n100_ms50_le120nt"
# (bucket N, sequences timed) as in bench.py; sequences of at most 64 nt
# fold at N=128
BUCKET_SAMPLES = ((128, 256), (256, 16), (512, 8), (1024, 4))
HEADLINE_N = 128


class Cell(NamedTuple):
    """One timed cell: seq/s, the count folded, what run_stream yielded
    in the last pass ((index, rows, flagged)), each pass's seconds."""
    rate: float | None
    n: int
    out: list
    secs: list


def load_baseline(path):
    """seq/s of the port's CPU baseline artifact; raises if it is missing."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} is missing: measure the CPU baseline with "
            f"python -m rafft_tpu_torch.tools.measure_baseline")
    with open(path) as fh:
        return float(json.load(fh)["seqs_per_s"])


def engine(N, device, B=None):
    """FoldEngine at the sweep's configuration of bucket N, at B (by
    default the sweep's batch, bucket_batch(16, N))."""
    return FoldEngine(bucket_config(N, 100, 50, 1000),
                      B=B or bucket_batch(16, N), device=device)


def device_name(device):
    """The card's name for a CUDA device, else the device's own; raises
    for a CUDA device where there is none (no fallback)."""
    device = torch.device(device)
    if device.type != "cuda":
        return str(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is "
                           "false); name another device to fold there")
    return torch.cuda.get_device_name(device)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed(eng, seqs, device, passes=1):
    """Warm `eng` up on its first B sequences, then time `passes` runs
    of run_stream over `seqs`, each ending with the device idle."""
    for _ in eng.run_stream(seqs[:eng.B]):
        pass
    secs = []
    for _ in range(passes):
        _sync(device)
        t0 = time.perf_counter()
        out = list(eng.run_stream(seqs))
        _sync(device)
        secs.append(time.perf_counter() - t0)
    return Cell(len(out) / statistics.median(secs), len(out), out, secs)


def bucket_rate(N, sample, seqs_by_bucket, device, passes=1):
    """The first `sample` sequences of bucket N at the sweep's
    configuration and batch (bench.py:bucket_rate)."""
    seqs = seqs_by_bucket.get(N, [])
    if not seqs:
        return Cell(None, 0, [], [])
    return timed(engine(N, device), seqs[:sample], device, passes)


def headline(seqs, device, passes=1):
    """The headline cell (bench.py:107-121): `seqs` at N=128, B=16."""
    return timed(engine(HEADLINE_N, device), seqs, device, passes)


def folded(seqs, out):
    """(seq, rows, flagged) of each folded sequence, in input order."""
    return [(seqs[i], rows, flagged) for i, rows, flagged in sorted(out)]


def run(device="cuda", passes=1, folds=None):
    """Fold the corpus's cells on `device` and return the JSON line as a
    dict.  `folds`, a dict, receives for each cell ("headline", "128",
    ...) the (seq, rows, flagged) of its last pass, in sample order."""
    device = torch.device(device)
    name = device_name(device)
    base = load_baseline(BASELINE)
    records = corpus()
    seqs_by_bucket, counts, n_longtail = by_bucket(
        records, [N for N, _ in BUCKET_SAMPLES])
    per_bucket, pass_secs = {}, {}
    agg_time, agg_n = 0.0, 0
    for N, sample in BUCKET_SAMPLES:
        cell = bucket_rate(N, sample, seqs_by_bucket, device, passes)
        if cell.rate is None:
            continue
        per_bucket[str(N)] = dict(seqs_per_s=cell.rate, sampled=cell.n,
                                  corpus_n=counts.get(N, 0))
        pass_secs[str(N)] = cell.secs
        agg_time += counts.get(N, 0) / cell.rate
        agg_n += counts.get(N, 0)
        if folds is not None:
            folds[str(N)] = folded(seqs_by_bucket[N][:sample], cell.out)

    head_seqs = headline_rows(records)
    cell = headline(head_seqs, device, passes)
    pass_secs["headline"] = cell.secs
    if folds is not None:
        folds["headline"] = folded(head_seqs, cell.out)
    t_head = statistics.median(cell.secs)
    return {
        "metric": METRIC,
        "value": cell.rate,
        "unit": "seq/s",
        "vs_baseline": cell.rate / base,
        "n_seqs": cell.n,
        "gcups": sum(len(s) ** 2 for s in head_seqs) / t_head / 1e9,
        "per_bucket": per_bucket,
        "corpus_seqs_per_s": agg_n / agg_time if agg_time else 0.0,
        "corpus_covered": agg_n,
        "corpus_excluded_gt1024nt": n_longtail,
        "baseline_seqs_per_s": base,
        "device": name,
        "passes": pass_secs,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to fold on (default cuda)")
    ap.add_argument("--passes", type=int, default=1,
                    help="timed passes per cell; a cell's rate is its count "
                         "over the median pass (default 1, bench.py's)")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device, args.passes)))


if __name__ == "__main__":
    main()
