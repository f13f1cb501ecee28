"""Whole-corpus report of the port: sections 1 and 2 of
benchmarks/bench_full.py.

1. Corpus sweep throughput, read from the port's sweep manifest
   (`<out>.manifest.json`, written by parallel/sweep.py's CLI): n, batch,
   wall seconds and seq/s per length bucket and for the whole run, the
   flagged folds refolded on the CPU and the devices that folded.
2. Batch-size scan: run_stream throughput at the headline configuration
   (tools/bench.py: N=128, bucket_config(128, 100, 50, 1000)) for B in
   {16, 32, 64} over the headline rows (tools/corpus.py), one pass each
   after a warm-up on the first B, on --device; on a card with the peak
   device memory of each B.

Section 3 of bench_full.py, scaling over a forced 8-device host mesh of
JAX, is not ported (ROADMAP.md).

    python -m rafft_tpu_torch.tools.bench_full --out report.md
        [--manifest <out>.manifest.json] [--skip-scan] [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import torch

from rafft_tpu_torch.tools import bench
from rafft_tpu_torch.tools.corpus import corpus, headline_rows

SCAN_BATCHES = (16, 32, 64)


def manifest_table(m):
    """Section 1: markdown lines for a sweep manifest."""
    buckets = sorted(m.get("buckets", {}).items(), key=lambda kv: int(kv[0]))
    total_n = sum(v["n"] for _N, v in buckets)
    total_s = sum(v["secs"] for _N, v in buckets)
    a = m["argv"]
    devices = [d["device"] for d in m.get("devices", [])] or [a.get("device")]
    lines = ["## Corpus sweep throughput (sweep manifest)", "",
             f"Config: `-n {a.get('n_mode')} -ms {a.get('max_stack')}`, batch "
             f"{a.get('batch')}, engine {a.get('engine')} on "
             f"{', '.join(map(str, devices))}; a bucket's wall seconds "
             f"include its engine's start and the CPU refold of its flagged "
             f"folds.", "",
             "| bucket (nt) | n seqs | batch | wall s | seq/s |",
             "|---|---|---|---|---|"]
    for N, v in buckets:
        lines.append(f"| {N} | {v['n']} | {v['batch']} | {v['secs']} | "
                     f"{v['n'] / max(v['secs'], 1e-9):.2f} |")
    lines += [f"| **all** | {total_n} | — | {total_s:.1f} | "
              f"{total_n / max(total_s, 1e-9):.2f} |", "",
              f"CPU-fallback folds (flagged sequences): "
              f"{m.get('n_fallback', 0)}", ""]
    return lines


def batch_scan(seqs, device="cuda", bs=SCAN_BATCHES, folds=None):
    """Section 2: seq/s of one run_stream pass over `seqs` at each B,
    after a warm-up on the first B.  `folds`, a dict, receives per B the
    (seq, rows, flagged) of each fold, in input order."""
    device = torch.device(device)
    out = []
    for B in bs:
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        cell = bench.timed(bench.engine(bench.HEADLINE_N, device, B), seqs,
                           device)
        peak = (torch.cuda.max_memory_allocated(device) / 2 ** 20
                if device.type == "cuda" else None)
        out.append(dict(B=B, n=cell.n, secs=cell.secs[0], seq_s=cell.rate,
                        peak_mib=peak))
        if folds is not None:
            folds[B] = bench.folded(seqs, cell.out)
        print(f"  B={B}: {cell.n} seqs {cell.secs[0]:.3f} s "
              f"({cell.rate:.3f} seq/s)", flush=True)
    return out


def scan_table(scan, device):
    lines = ["## Batch-size scan (N=128 bucket, <=120-nt corpus slice, "
             f"steady state, {device})", "",
             "| B | seqs | secs | seq/s | peak MiB |", "|---|---|---|---|---|"]
    for r in scan:
        peak = "not measured" if r["peak_mib"] is None else f"{r['peak_mib']:.1f}"
        lines.append(f"| {r['B']} | {r['n']} | {r['secs']:.3f} | "
                     f"{r['seq_s']:.3f} | {peak} |")
    return lines + [""]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--manifest", help="sweep run manifest json")
    ap.add_argument("--skip-scan", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the scan (default cuda)")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    lines = ["# Whole-corpus benchmark report", ""]
    if args.manifest:
        with open(args.manifest) as fh:
            lines += manifest_table(json.load(fh))
    if not args.skip_scan:
        name = bench.device_name(args.device)
        print(f"[bench_full] batch scan on {name}", flush=True)
        lines += scan_table(batch_scan(headline_rows(corpus()), args.device),
                            name)
    with open(args.out, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
